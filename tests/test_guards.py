"""In-loop failure-detection tests (SURVEY.md §5: divergence guard).

A diverging solve must abort within a couple of outer iterations with
``converged=False`` — not spin to ``max_iters`` accumulating overflow.
Divergence is induced through public API knobs: an unstable Jacobi
``omega`` (iteration matrix spectral radius > 1) for the linear solvers,
and a deliberately *indefinite* RQI shift (``rqi_backoff`` > 1 puts
sigma above lambda_min) for the eigensolver.
"""
import jax.numpy as jnp
import numpy as np

from multigridcmt.config import SolverConfig
from multigridcmt.grids import build_hierarchy, pad_interior
from multigridcmt.parallel import sharded
from multigridcmt.solvers import cycles, eigen


def _rhs(n, seed=0):
    rng = np.random.default_rng(seed)
    return pad_interior(jnp.asarray(rng.standard_normal((n, n))))


_BAD = dict(ndim=2, k=5, dtype=jnp.float64, smoother="jacobi", omega=2.5,
            tol=1e-10, max_iters=50)


def test_solve_aborts_on_divergence():
    cfg = SolverConfig(**_BAD)
    hier = build_hierarchy(cfg)
    res = cycles.solve(hier, _rhs(cfg.n), cfg)
    assert not bool(res.converged)
    # DIVERGE_PATIENCE consecutive 10x growths -> abort almost at once.
    assert int(res.iters) <= cycles.DIVERGE_PATIENCE + 2
    assert np.all(np.isfinite(np.asarray(res.res_history)))


def test_sharded_solve_aborts_on_divergence():
    cfg = SolverConfig(**{**_BAD, "agglom_rows": 4})
    solver = sharded.ShardedSolver(cfg, sharded.make_mesh())
    res = solver.solve(np.asarray(_rhs(cfg.n)))
    assert not bool(res.converged)
    assert int(res.iters) <= cycles.DIVERGE_PATIENCE + 2
    assert np.all(np.isfinite(np.asarray(res.res_history)))


def test_good_solve_unaffected_by_guard():
    cfg = SolverConfig(ndim=2, k=5, dtype=jnp.float64, smoother="rbgs",
                       tol=1e-10, max_iters=50)
    hier = build_hierarchy(cfg)
    res = cycles.solve(hier, _rhs(cfg.n), cfg)
    assert bool(res.converged)


def test_eigensolve_aborts_on_indefinite_shift():
    """rqi_backoff=4: once the shift activates, sigma = 4*lambda sits far
    above lambda_min, the inner MG operator goes indefinite, and the
    eigen-residual oscillates up/down by orders of magnitude (measured:
    0.007 <-> 2.96 forever). The cumulative guard must abort well before
    max_iters with converged=False."""
    cfg = SolverConfig(ndim=2, k=5, dtype=jnp.float64, smoother="rbgs")
    hier = build_hierarchy(cfg)
    res = eigen.eigensolve(hier, cfg, k=1, method="rqi", tol=1e-12,
                           max_iters=60, rqi_backoff=4.0)
    assert not bool(res.converged)
    assert int(res.iters) < 60
    assert np.all(np.isfinite(np.asarray(res.res_history)))


def test_eigensolve_good_shift_unaffected():
    """The default backed-off shift converges with zero/rare growth
    events — the cumulative guard must not fire."""
    cfg = SolverConfig(ndim=2, k=5, dtype=jnp.float64, smoother="rbgs")
    hier = build_hierarchy(cfg)
    res = eigen.eigensolve(hier, cfg, k=1, method="rqi", tol=1e-12,
                           max_iters=60)
    assert bool(res.converged)
    lam = float(res.eigenvalues[0])
    n = cfg.n
    h = 1.0 / (n + 1)
    exact = 2.0 * (2.0 / h ** 2) * (1.0 - np.cos(np.pi * h))
    assert abs(lam - exact) / exact < 1e-10
