"""MG-preconditioned CG tests — oracle: SciPy direct solve + the stationary
V-cycle solver it accelerates (solvers/krylov.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse
import scipy.sparse.linalg

import multigridcmt as mg
from multigridcmt.grids import interior


def _scipy_solution(prob):
    c = prob.config
    n, h = c.n, c.h
    lap1 = scipy.sparse.diags([-1.0, 2.0, -1.0], [-1, 0, 1],
                              shape=(n, n)) / (h * h)
    if c.ndim == 1:
        a = lap1.tocsr()
        b = np.asarray(interior(prob.b))
        return scipy.sparse.linalg.spsolve(a, b)
    eye = scipy.sparse.identity(n)
    a = (scipy.sparse.kron(lap1, eye) + scipy.sparse.kron(eye, lap1)).tocsr()
    b = np.asarray(interior(prob.b)).reshape(-1)
    return scipy.sparse.linalg.spsolve(a, b).reshape(n, n)


@pytest.mark.parametrize("ndim,k,smoother", [
    (1, 9, "jacobi"),
    (2, 5, "jacobi"),
    (2, 5, "rbgs"),
    (2, 5, "chebyshev"),
])
def test_pcg_matches_scipy(ndim, k, smoother):
    prob = mg.poisson(k=k, ndim=ndim, dtype=jnp.float64, smoother=smoother,
                      tol=1e-10)
    res = mg.solve_pcg(prob.hierarchy, prob.b, prob.config)
    assert bool(res.converged)
    want = _scipy_solution(prob)
    np.testing.assert_allclose(np.asarray(interior(res.x)), want,
                               rtol=1e-7, atol=1e-9)


def test_pcg_not_slower_than_stationary():
    """CG acceleration must not take more iterations than plain V-cycles
    (the CG polynomial is optimal over the same Krylov space)."""
    prob = mg.poisson2d(k=6, dtype=jnp.float64, smoother="rbgs", tol=1e-9)
    solver = mg.MultigridSolver(prob)
    stat = solver.solve()
    pcg = solver.solve(method="pcg")
    assert bool(pcg.converged)
    assert int(pcg.iters) <= int(stat.iters)


def test_pcg_residual_history_monotone_tail():
    """res_history is populated and ends below tol; entries past iters are
    backfilled with the final value (same contract as cycles.solve)."""
    prob = mg.poisson2d(k=5, dtype=jnp.float64, tol=1e-9)
    res = mg.solve_pcg(prob.hierarchy, prob.b, prob.config)
    hist = np.asarray(res.res_history)
    it = int(res.iters)
    # Zero initial guess => r0 = b => relative residual exactly 1.
    assert np.isclose(hist[0], 1.0)
    assert hist[it] < 1e-9
    np.testing.assert_array_equal(hist[it:], hist[it])


def test_pcg_nonzero_initial_guess():
    prob = mg.poisson2d(k=5, dtype=jnp.float64, tol=1e-9)
    rng = np.random.default_rng(0)
    x0 = mg.pad_interior(jnp.asarray(rng.standard_normal((prob.config.n,) * 2)))
    res = mg.solve_pcg(prob.hierarchy, prob.b, prob.config, x0=x0)
    assert bool(res.converged)
    want = _scipy_solution(prob)
    np.testing.assert_allclose(np.asarray(interior(res.x)), want,
                               rtol=1e-7, atol=1e-9)


def test_api_method_dispatch():
    prob = mg.poisson1d(k=8, dtype=jnp.float64, tol=1e-9)
    solver = mg.MultigridSolver(prob)
    res = solver.solve(method="pcg")
    assert bool(res.converged)
    with pytest.raises(ValueError):
        solver.solve(method="gmres")
