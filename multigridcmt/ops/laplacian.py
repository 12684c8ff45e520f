"""Matrix-free Poisson (negative Laplacian) operators on padded grids.

Capability parity: the reference assembles the 1D tridiagonal
``(1/h^2)[-1, 2, -1]`` and the 2D 5-point ``(1/h^2)[-1; -1, 4, -1; -1]``
operators as SciPy CSR/COO matrices (SURVEY.md §2, assembly rows). Here
the form is a matrix-free stencil on a dense grid: every apply is a handful
of shifted adds that XLA fuses into a single pass bound by device-memory
bandwidth. Explicit CSR/COO assembly (for the generality capability and the SpMV
benchmark) lives in `ops/sparse.py`.

Convention: grids are padded arrays (ghost boundary = 0, homogeneous
Dirichlet); operators read the padding and write zeros back to it, so the
invariant "ghost cells are zero" is preserved through every op.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def _is_zero(sigma) -> bool:
    """True iff sigma is a static Python zero (lets XLA skip the shift)."""
    return isinstance(sigma, (int, float)) and sigma == 0


def apply_poisson(u: jax.Array, h: float, sigma=0.0) -> jax.Array:
    """y = (A - sigma*I) u with A the (negative) Laplacian; padded in/out.

    ``sigma`` supports the eigensolver's shifted solves (inverse iteration /
    Rayleigh-quotient iteration, SURVEY.md §3.3); it may be a traced scalar.
    """
    if u.ndim == 1:
        y = _apply_1d(u, h)
    elif u.ndim == 2:
        y = _apply_2d(u, h)
    elif u.ndim == 3:
        y = _apply_3d(u, h)
    else:
        raise ValueError(f"expected 1D/2D/3D padded grid, got ndim={u.ndim}")
    if _is_zero(sigma):
        return y
    shift = jnp.asarray(sigma, dtype=u.dtype) * u
    # Keep ghosts zero: u's ghosts are zero by invariant, so shift's are too.
    return y - shift


def _apply_1d(u: jax.Array, h: float) -> jax.Array:
    inv_h2 = jnp.asarray(1.0 / (h * h), dtype=u.dtype)
    core = (2.0 * u[1:-1] - u[:-2] - u[2:]) * inv_h2
    return jnp.pad(core, 1)


def _apply_2d(u: jax.Array, h: float) -> jax.Array:
    inv_h2 = jnp.asarray(1.0 / (h * h), dtype=u.dtype)
    core = (
        4.0 * u[1:-1, 1:-1]
        - u[:-2, 1:-1]
        - u[2:, 1:-1]
        - u[1:-1, :-2]
        - u[1:-1, 2:]
    ) * inv_h2
    return jnp.pad(core, 1)


def _apply_3d(u: jax.Array, h: float) -> jax.Array:
    """7-point stencil (1/h^2)[6 center, -1 each face neighbor]."""
    inv_h2 = jnp.asarray(1.0 / (h * h), dtype=u.dtype)
    core = (
        6.0 * u[1:-1, 1:-1, 1:-1]
        - u[:-2, 1:-1, 1:-1] - u[2:, 1:-1, 1:-1]
        - u[1:-1, :-2, 1:-1] - u[1:-1, 2:, 1:-1]
        - u[1:-1, 1:-1, :-2] - u[1:-1, 1:-1, 2:]
    ) * inv_h2
    return jnp.pad(core, 1)


def residual(u: jax.Array, b: jax.Array, h: float, sigma=0.0) -> jax.Array:
    """r = b - (A - sigma*I) u, padded in, padded out (ghosts stay zero)."""
    inv_h2 = jnp.asarray(1.0 / (h * h), dtype=u.dtype)
    if u.ndim == 1:
        core = b[1:-1] - (2.0 * u[1:-1] - u[:-2] - u[2:]) * inv_h2
        if not _is_zero(sigma):
            core = core + jnp.asarray(sigma, dtype=u.dtype) * u[1:-1]
        return jnp.pad(core, 1)
    if u.ndim == 3:
        core = b[1:-1, 1:-1, 1:-1] - (
            6.0 * u[1:-1, 1:-1, 1:-1]
            - u[:-2, 1:-1, 1:-1] - u[2:, 1:-1, 1:-1]
            - u[1:-1, :-2, 1:-1] - u[1:-1, 2:, 1:-1]
            - u[1:-1, 1:-1, :-2] - u[1:-1, 1:-1, 2:]
        ) * inv_h2
        if not _is_zero(sigma):
            core = core + jnp.asarray(sigma, dtype=u.dtype) * u[1:-1, 1:-1,
                                                                1:-1]
        return jnp.pad(core, 1)
    core = b[1:-1, 1:-1] - (
        4.0 * u[1:-1, 1:-1]
        - u[:-2, 1:-1]
        - u[2:, 1:-1]
        - u[1:-1, :-2]
        - u[1:-1, 2:]
    ) * inv_h2
    if not _is_zero(sigma):
        core = core + jnp.asarray(sigma, dtype=u.dtype) * u[1:-1, 1:-1]
    return jnp.pad(core, 1)


def diag_value(ndim: int, h: float, sigma=0.0):
    """Diagonal entry of A - sigma*I (constant across the grid): 2d/h^2."""
    d = (2.0 * ndim) / (h * h)
    if _is_zero(sigma):
        return d
    return d - sigma


def dense_operator(n: int, ndim: int, h: float) -> np.ndarray:
    """Dense float64 NumPy operator for the coarsest-level inverse and tests.

    1D: tridiag(-1, 2, -1)/h^2 of size n.
    2D: 5-point Kronecker sum of size n^2 (row-major interior ordering),
    mirroring the reference's `scipy.sparse.kron` assembly (SURVEY.md §2).
    3D: 7-point Kronecker sum of size n^3.
    """
    t = (np.diag(2.0 * np.ones(n)) - np.diag(np.ones(n - 1), 1)
         - np.diag(np.ones(n - 1), -1))
    if ndim == 1:
        return t / (h * h)
    eye = np.eye(n)
    if ndim == 2:
        a2 = np.kron(t, eye) + np.kron(eye, t)
        return a2 / (h * h)
    eye2 = np.eye(n * n)
    a3 = (np.kron(t, eye2) + np.kron(eye, np.kron(t, eye))
          + np.kron(eye2, t))
    return a3 / (h * h)


def eigenvalue_1d(k: int, n: int, h: float) -> float:
    """Exact k-th eigenvalue of the discrete 1D operator: (2/h^2)(1-cos(k*pi*h))."""
    return (2.0 / (h * h)) * (1.0 - np.cos(k * np.pi * h))


def eigenvalue_2d(kx: int, ky: int, n: int, h: float) -> float:
    """Exact eigenvalue of the discrete 2D operator (sum of 1D eigenvalues)."""
    return eigenvalue_1d(kx, n, h) + eigenvalue_1d(ky, n, h)


def eigenvalue_3d(kx: int, ky: int, kz: int, n: int, h: float) -> float:
    """Exact eigenvalue of the discrete 3D operator (sum of 1D eigenvalues)."""
    return (eigenvalue_1d(kx, n, h) + eigenvalue_1d(ky, n, h)
            + eigenvalue_1d(kz, n, h))
