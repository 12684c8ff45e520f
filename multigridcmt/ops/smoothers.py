"""Smoothers: weighted Jacobi, red-black Gauss-Seidel, and Chebyshev.

Capability parity with the reference's two smoothers (SURVEY.md §2):
  * weighted Jacobi  x <- x + omega * D^-1 (b - A x), omega default 2/3 (1D)
    / 4/5 (2D);
  * red-black Gauss-Seidel: update all red points (interior coordinate sum
    (i+j) even, 1-based), then all black points, each half-sweep fully
    parallel.

Both smoothers are whole-grid vectorized stencil updates. RB-GS computes
the GS update at every point and selects by a color mask — twice the
(cheap) FLOPs of a strided implementation, but each half-sweep is one
coalesced memory pass, which is what matters on a bandwidth-bound stencil.
On the GPU, float32 levels >= 1023 run the sweep as one two-colour kernel
(`kernels/rbgs2d.py`, chosen in `solvers.cycles.smooth`); this module stays
its reference.

Beyond reference parity, a **Chebyshev polynomial smoother** is provided
(`chebyshev` / `chebyshev_generic`): degree-``d`` Chebyshev acceleration of
Jacobi, targeting the oscillatory upper part ``[lmax/4, lmax]`` of the
spectrum of ``D^-1 A``. It needs only operator applies (no color ordering,
no sequential dependence), which makes it the natural smoother for the
distributed runtime — each application is one halo exchange, identical to
Jacobi — while smoothing markedly better per residual evaluation.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from . import laplacian


def default_omega(ndim: int) -> float:
    """Textbook-optimal Jacobi damping 2d/(2d+1): 2/3, 4/5, 6/7."""
    return (2.0 * ndim) / (2.0 * ndim + 1.0)


def jacobi(u: jax.Array, b: jax.Array, h: float, omega: float,
           sigma=0.0) -> jax.Array:
    """One weighted-Jacobi sweep on a padded grid: x + omega*D^-1*(b - Ax).

    ``sigma`` shifts the operator to A - sigma*I (eigensolver inner solves).
    """
    ndim = u.ndim
    d = laplacian.diag_value(ndim, h, sigma)
    r = laplacian.residual(u, b, h, sigma)
    return u + (jnp.asarray(omega, dtype=u.dtype)
                / jnp.asarray(d, dtype=u.dtype)) * r


def _color_mask(shape, parity: int, row_offset: int = 0, dtype=jnp.bool_):
    """Mask of padded-grid points whose coordinate sum has given parity.

    Interior point (i, j) (1-based padded indices) is *red* iff (i+j) even.
    ``row_offset`` shifts the row index — used by the sharded path where a
    local tile starts at a global row other than 0.
    """
    if len(shape) == 1:
        idx = jax.lax.broadcasted_iota(jnp.int32, (shape[0], 1), 0)[:, 0]
        return (idx + row_offset) % 2 == parity
    s = jax.lax.broadcasted_iota(jnp.int32, shape, 0) + row_offset
    for dim in range(1, len(shape)):
        s = s + jax.lax.broadcasted_iota(jnp.int32, shape, dim)
    return s % 2 == parity


def _gs_update(u: jax.Array, b: jax.Array, h: float, sigma=0.0) -> jax.Array:
    """Gauss-Seidel pointwise update value at every interior point.

    x_ij = (h^2 b_ij + sum of neighbor values) / (diag*h^2), computed from
    the *current* u everywhere (the color mask makes it a proper
    half-sweep). With a shift, the denominator becomes 2|4 - sigma*h^2.
    """
    h2 = jnp.asarray(h * h, dtype=u.dtype)
    if u.ndim == 1:
        den = 2.0 - jnp.asarray(sigma, dtype=u.dtype) * h2
        core = (h2 * b[1:-1] + u[:-2] + u[2:]) / den
        return jnp.pad(core, 1)
    if u.ndim == 3:
        den = 6.0 - jnp.asarray(sigma, dtype=u.dtype) * h2
        core = (
            h2 * b[1:-1, 1:-1, 1:-1]
            + u[:-2, 1:-1, 1:-1] + u[2:, 1:-1, 1:-1]
            + u[1:-1, :-2, 1:-1] + u[1:-1, 2:, 1:-1]
            + u[1:-1, 1:-1, :-2] + u[1:-1, 1:-1, 2:]
        ) / den
        return jnp.pad(core, 1)
    den = 4.0 - jnp.asarray(sigma, dtype=u.dtype) * h2
    core = (
        h2 * b[1:-1, 1:-1]
        + u[:-2, 1:-1] + u[2:, 1:-1] + u[1:-1, :-2] + u[1:-1, 2:]
    ) / den
    return jnp.pad(core, 1)


def rbgs_half_sweep(u: jax.Array, b: jax.Array, h: float, parity: int,
                    row_offset: int = 0, sigma=0.0) -> jax.Array:
    """Update only the points of one color; ghosts remain untouched (zero)."""
    upd = _gs_update(u, b, h, sigma)
    mask = _color_mask(u.shape, parity, row_offset)
    # Interior-only write: _gs_update already zeroed the ghosts of `upd`,
    # but keep u's ghosts whatever they are by masking on the interior mask.
    imask = jnp.zeros(u.shape, dtype=bool)
    imask = imask.at[(slice(1, -1),) * u.ndim].set(True)
    return jnp.where(mask & imask, upd, u)


def rbgs(u: jax.Array, b: jax.Array, h: float, row_offset: int = 0,
         sigma=0.0) -> jax.Array:
    """One full red-black Gauss-Seidel sweep: red (parity 0) then black."""
    u = rbgs_half_sweep(u, b, h, parity=0, row_offset=row_offset, sigma=sigma)
    u = rbgs_half_sweep(u, b, h, parity=1, row_offset=row_offset, sigma=sigma)
    return u


# --- Chebyshev polynomial smoother ----------------------------------------
#
# The eigenvalues of D^-1 A for the model operators lie in (0, 2):
# 1D mu = 1 - cos(k pi h), 2D mu = 1 - (cos(kx pi h) + cos(ky pi h))/2.
# A smoother only needs to damp the oscillatory half, so the polynomial is
# optimized over [CHEB_LMIN_FRAC * lmax, lmax] with lmax = 2 (the exact
# supremum). The error after one application is p(D^-1 A) e with
# p(t) = T_d((theta - t)/delta) / T_d(theta/delta): equioscillating and
# <= 1/T_d(theta/delta) in magnitude over the whole smoothing range.

CHEB_LMAX = 2.0
CHEB_LMIN_FRAC = 0.25


def chebyshev_generic(u, b, degree: int, diag, residual_fn,
                      lmax: float = CHEB_LMAX,
                      lmin_frac: float = CHEB_LMIN_FRAC):
    """Degree-``degree`` Chebyshev smoother from operator applies only.

    ``residual_fn(u, b)`` must return ``b - A u`` in the caller's native
    layout; ``diag`` is the (constant) diagonal of A. This generic driver is
    shared by the single-device path and the sharded runtime (residual_fn =
    the halo-exchanging ``s_residual``) — the recurrence is pure
    elementwise algebra, so only the residual differs.

    Standard three-term recurrence (e.g. Adams et al., "Parallel multigrid
    smoothing: polynomial versus Gauss-Seidel", JCP 188 (2003)):
        d_0 = (1/theta) z_0,            u_1 = u_0 + d_0
        d_k = rho_k rho_{k-1} d_{k-1} + (2 rho_k / delta) z_k,
        u_{k+1} = u_k + d_k,   z_k = D^-1 (b - A u_k),
    with theta = (lmax+lmin)/2, delta = (lmax-lmin)/2, sigma1 = theta/delta,
    rho_0 = 1/sigma1, rho_k = 1/(2 sigma1 - rho_{k-1}).
    """
    if degree <= 0:
        # A degree-0 polynomial is the identity: no smoothing. Without this,
        # sweeps=0 would still apply the first (pre-loop) Jacobi-like step.
        return u
    lmin = lmax * lmin_frac
    theta = 0.5 * (lmax + lmin)
    delta = 0.5 * (lmax - lmin)
    sigma1 = theta / delta
    inv_diag = 1.0 / diag
    rho = 1.0 / sigma1
    r = residual_fn(u, b)
    d = (inv_diag / theta) * r
    u = u + d
    for _ in range(degree - 1):
        rho_new = 1.0 / (2.0 * sigma1 - rho)
        r = residual_fn(u, b)
        d = (rho_new * rho) * d + (2.0 * rho_new / delta) * (inv_diag * r)
        u = u + d
        rho = rho_new
    return u


def chebyshev(u: jax.Array, b: jax.Array, h: float, degree: int,
              sigma=0.0) -> jax.Array:
    """Chebyshev smoother on a padded grid (jnp stencil residuals)."""
    diag = laplacian.diag_value(u.ndim, h, sigma)
    return chebyshev_generic(
        u, b, degree, diag,
        lambda uu, bb: laplacian.residual(uu, bb, h, sigma=sigma))


def smooth(u: jax.Array, b: jax.Array, h: float, *, kind: str, omega: float,
           sweeps: int, sigma=0.0) -> jax.Array:
    """Apply ``sweeps`` smoothing sweeps of the requested kind.

    For ``kind="chebyshev"`` the whole call is ONE polynomial of degree
    ``sweeps`` (a degree-d polynomial smooths strictly better than d
    degree-1 applications).
    """
    if kind == "chebyshev":
        return chebyshev(u, b, h, degree=sweeps, sigma=sigma)
    for _ in range(sweeps):
        if kind == "jacobi":
            u = jacobi(u, b, h, omega, sigma=sigma)
        elif kind == "rbgs":
            u = rbgs(u, b, h, sigma=sigma)
        else:
            raise ValueError(f"unknown smoother {kind!r}")
    return u
