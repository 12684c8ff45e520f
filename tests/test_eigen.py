"""Eigensolver tests — oracles: the exact discrete spectrum and
scipy.sparse.linalg.eigsh (SURVEY.md §4.3, BASELINE config 4 CPU-sized)."""
import jax.numpy as jnp
import numpy as np
import pytest

import multigridcmt as mg
from multigridcmt.ops import laplacian

import reference_impl as ref


def _exact_smallest(n, h, count):
    """Smallest `count` eigenvalues of the discrete 2D operator."""
    lams = sorted(laplacian.eigenvalue_2d(kx, ky, n, h)
                  for kx in range(1, 6) for ky in range(1, 6))
    return np.array(lams[:count])


@pytest.mark.parametrize("method", ["ii", "rqi"])
def test_smallest_eigenpair_2d(method):
    prob = mg.poisson2d(k=5, dtype=jnp.float64, smoother="rbgs")
    solver = mg.MultigridSolver(prob)
    res = solver.eigensolve(k=1, method=method, tol=1e-9)
    assert bool(res.converged)
    n, h = prob.config.n, prob.config.h
    want = laplacian.eigenvalue_1d(1, n, h) * 2
    np.testing.assert_allclose(np.asarray(res.eigenvalues), [want],
                               rtol=1e-8)


def test_smallest_eigenvalue_matches_eigsh():
    prob = mg.poisson2d(k=5, dtype=jnp.float64)
    res = mg.MultigridSolver(prob).eigensolve(k=1, tol=1e-9)
    want = ref.eigsh_oracle(prob.config.n, 2, prob.config.h, k=1)
    np.testing.assert_allclose(np.asarray(res.eigenvalues), want, rtol=1e-7)


def test_k3_eigenpairs_2d():
    """Block inverse iteration resolves the (degenerate) next eigenvalues."""
    prob = mg.poisson2d(k=5, dtype=jnp.float64, smoother="rbgs")
    res = mg.MultigridSolver(prob).eigensolve(k=3, tol=1e-9, max_iters=200)
    assert bool(res.converged)
    n, h = prob.config.n, prob.config.h
    want = _exact_smallest(n, h, 3)
    np.testing.assert_allclose(np.sort(np.asarray(res.eigenvalues)), want,
                               rtol=1e-7)


def test_eigenvector_is_ground_state():
    """The smallest eigenvector is the particle-in-a-box ground state
    sin(pi x) sin(pi y) (up to sign/scale) — the reference's CMT payload."""
    prob = mg.poisson2d(k=5, dtype=jnp.float64)
    res = mg.MultigridSolver(prob).eigensolve(k=1, tol=1e-9)
    v = np.array(mg.interior(res.eigenvectors[0]))   # writable copy
    n, h = prob.config.n, prob.config.h
    x = np.arange(1, n + 1) * h
    want = np.outer(np.sin(np.pi * x), np.sin(np.pi * x))
    want /= np.linalg.norm(want)
    v /= np.linalg.norm(v)
    if np.vdot(v, want) < 0:
        v = -v
    np.testing.assert_allclose(v, want, atol=5e-4)


def test_eigenvalue_continuum_limit():
    """lambda_1 -> 2 pi^2 with O(h^2) error (BASELINE config 4 semantics)."""
    prob = mg.poisson2d(k=6, dtype=jnp.float64)
    res = mg.MultigridSolver(prob).eigensolve(k=1, tol=1e-9)
    lam = float(res.eigenvalues[0])
    h = prob.config.h
    assert abs(lam - 2 * np.pi ** 2) < 2.0 * np.pi ** 4 * h * h


def test_1d_eigensolve():
    prob = mg.poisson1d(k=7, dtype=jnp.float64)
    res = mg.MultigridSolver(prob).eigensolve(k=2, tol=1e-9)
    n, h = prob.config.n, prob.config.h
    want = np.array([laplacian.eigenvalue_1d(1, n, h),
                     laplacian.eigenvalue_1d(2, n, h)])
    np.testing.assert_allclose(np.sort(np.asarray(res.eigenvalues)), want,
                               rtol=1e-8)


# ---------------------------------------------------------------------------
# LOBPCG (beyond-reference accelerator: one V-cycle per vector per step).
# ---------------------------------------------------------------------------

def test_lobpcg_smallest_eigenpair_2d():
    prob = mg.poisson2d(k=5, dtype=jnp.float64, smoother="rbgs")
    res = mg.MultigridSolver(prob).eigensolve(k=1, method="lobpcg",
                                              tol=1e-9)
    assert bool(res.converged)
    n, h = prob.config.n, prob.config.h
    want = laplacian.eigenvalue_1d(1, n, h) * 2
    np.testing.assert_allclose(np.asarray(res.eigenvalues), [want],
                               rtol=1e-8)


def test_lobpcg_k3_degenerate_pair():
    """LOBPCG resolves the degenerate lambda_2 = lambda_3 pair, sorted."""
    prob = mg.poisson2d(k=5, dtype=jnp.float64, smoother="rbgs")
    res = mg.MultigridSolver(prob).eigensolve(k=3, method="lobpcg",
                                              tol=1e-9)
    assert bool(res.converged)
    n, h = prob.config.n, prob.config.h
    want = _exact_smallest(n, h, 3)
    np.testing.assert_allclose(np.asarray(res.eigenvalues), want, rtol=1e-8)
    # eigenvalues come out ascending from the Ritz step
    lams = np.asarray(res.eigenvalues)
    assert np.all(np.diff(lams) >= -1e-10)


def test_lobpcg_fewer_vcycles_than_inverse_iteration():
    """The point of LOBPCG: far fewer V-cycles per digit. II spends up to
    inner_cycles V-cycles per vector per outer step; LOBPCG exactly one."""
    prob = mg.poisson2d(k=6, dtype=jnp.float64, smoother="rbgs")
    s = mg.MultigridSolver(prob)
    r_lob = s.eigensolve(k=1, method="lobpcg", tol=1e-9)
    assert bool(r_lob.converged)
    # one V-cycle per outer iteration (plus the iteration-0 prestep)
    assert int(r_lob.iters) <= 12


def test_lobpcg_1d_and_3d():
    for ndim, kgrid in ((1, 7), (3, 4)):
        prob = mg.poisson(kgrid, ndim=ndim, dtype=jnp.float64,
                          smoother="chebyshev")
        res = mg.MultigridSolver(prob).eigensolve(k=1, method="lobpcg",
                                                  tol=1e-9)
        assert bool(res.converged)
        n, h = prob.config.n, prob.config.h
        want = laplacian.eigenvalue_1d(1, n, h) * ndim
        np.testing.assert_allclose(np.asarray(res.eigenvalues), [want],
                                   rtol=1e-8)


def test_lobpcg_eigenvector_quality():
    """Returned eigenvectors are orthonormal and satisfy the residual tol."""
    prob = mg.poisson2d(k=5, dtype=jnp.float64, smoother="rbgs")
    res = mg.MultigridSolver(prob).eigensolve(k=2, method="lobpcg",
                                              tol=1e-9)
    v = np.asarray(res.eigenvectors)[:, 1:-1, 1:-1].reshape(2, -1)
    gram = v @ v.T
    np.testing.assert_allclose(gram, np.eye(2), atol=1e-9)
    h = prob.config.h
    from multigridcmt.ops import laplacian as lap
    for i in range(2):
        av = np.asarray(lap.apply_poisson(
            jnp.asarray(res.eigenvectors[i]), h))[1:-1, 1:-1].ravel()
        lam = float(res.eigenvalues[i])
        assert np.linalg.norm(av - lam * v[i]) / lam < 1e-8
