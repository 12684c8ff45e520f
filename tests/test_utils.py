"""Aux-subsystem tests: metrics JSONL, divergence guard, checkpoint/resume
(SURVEY.md §5)."""
import io
import json

import jax.numpy as jnp
import numpy as np
import pytest

import multigridcmt as mg
from multigridcmt.utils import checkpoint, metrics


def test_metrics_logger_jsonl():
    buf = io.StringIO()
    m = metrics.MetricsLogger(buf)
    m.log("iteration", iter=1, residual=1e-3, rho=0.1)
    rec = json.loads(buf.getvalue().strip())
    assert rec["event"] == "iteration"
    assert rec["residual"] == 1e-3
    assert "t" in rec


def test_metrics_solve_result():
    prob = mg.poisson1d(k=6, dtype=jnp.float64, tol=1e-8)
    res = mg.MultigridSolver(prob).solve()
    buf = io.StringIO()
    metrics.MetricsLogger(buf).log_solve_result(res, prob.config)
    lines = [json.loads(ln) for ln in buf.getvalue().splitlines()]
    assert lines[-1]["event"] == "solve_done"
    assert lines[-1]["converged"] is True
    assert lines[-1]["iters"] == int(res.iters)
    # per-iteration records count matches
    assert sum(1 for r in lines if r["event"] == "iteration") == \
        int(res.iters) + 1


def test_divergence_guard():
    hist = np.array([1.0, 0.5, 1.2, 2.9])
    assert metrics.divergence_guard(hist, 3)
    hist2 = np.array([1.0, 0.1, 0.01, 0.001])
    assert not metrics.divergence_guard(hist2, 3)


def test_checkpoint_roundtrip(tmp_path):
    pytest.importorskip("orbax.checkpoint")
    prob = mg.poisson2d(k=5, dtype=jnp.float64, tol=1e-10, max_iters=3)
    solver = mg.MultigridSolver(prob)
    partial = solver.solve()          # stops at max_iters=3, unconverged
    assert not bool(partial.converged)
    path = str(tmp_path / "ckpt")
    checkpoint.save_state(path, partial.x, partial.res_history,
                          partial.iters)
    state = checkpoint.load_state(path)
    np.testing.assert_array_equal(state["x"], np.asarray(partial.x))
    assert int(state["iters"]) == 3

    # Resume: a fresh solver continues from the snapshot to convergence.
    prob2 = mg.poisson2d(k=5, dtype=jnp.float64, tol=1e-9, max_iters=50)
    solver2 = mg.MultigridSolver(prob2)
    resumed = checkpoint.resume_solve(solver2, path)
    assert bool(resumed.converged)
    # The resumed solve starts from the partial solution: it needs fewer
    # cycles than a cold solve.
    cold = solver2.solve()
    assert int(resumed.iters) < int(cold.iters)


def test_sharded_checkpoint_resume(tmp_path):
    """Distributed checkpoint/resume (SURVEY.md §5): a ShardedSolver warm-starts from a snapshot on the 8-device
    mesh and beats the cold solve."""
    pytest.importorskip("orbax.checkpoint")
    import dataclasses

    from multigridcmt.parallel import sharded

    prob = mg.poisson2d(k=5, dtype=jnp.float64, smoother="rbgs",
                        tol=1e-10, max_iters=3, agglom_rows=4)
    mesh = sharded.make_mesh()                  # 8 virtual CPU devices
    solver = sharded.ShardedSolver(prob.config, mesh)
    part = solver.solve(prob.b)
    assert not bool(part.converged)
    path = str(tmp_path / "ckpt")
    checkpoint.save_state(path, part.x, part.res_history, part.iters,
                          extra={"b": prob.b})

    cfg2 = dataclasses.replace(prob.config, tol=1e-9, max_iters=50)
    solver2 = sharded.ShardedSolver(cfg2, mesh)
    resumed = checkpoint.resume_solve(solver2, path)   # b from snapshot
    assert bool(resumed.converged)
    cold = solver2.solve(prob.b)
    assert int(resumed.iters) < int(cold.iters)
    # Warm start through the PCG path too (cg_loop from x0).
    rpcg = solver2.solve(prob.b, x0=part.x, method="pcg")
    assert bool(rpcg.converged)


def test_sharded_fmg_resume_skips_fmg():
    """Resuming an fmg-cycle ShardedSolver polishes from x0 with V-cycles
    (static skip_fmg branch) instead of redoing FMG from scratch."""
    import dataclasses

    from multigridcmt.parallel import sharded

    prob = mg.poisson2d(k=5, dtype=jnp.float64, smoother="rbgs",
                        cycle="fmg", tol=1e-10, max_iters=40,
                        agglom_rows=4)
    mesh = sharded.make_mesh()
    solver = sharded.ShardedSolver(prob.config, mesh)
    cold = solver.solve(prob.b)
    assert bool(cold.converged)
    warm = solver.solve(prob.b, x0=cold.x)
    assert bool(warm.converged)
    # x0 is already converged: the warm start needs at most one cycle.
    assert int(warm.iters) <= 1


def test_debug_checked_catches_nan():
    import jax.numpy as jnp
    import pytest
    from jax.experimental import checkify

    from multigridcmt.utils import debug

    def bad(x):
        y = jnp.sqrt(x)  # NaN for negative input
        debug.check_finite(y, "y")
        return y

    safe = debug.checked(bad)
    assert float(safe(jnp.float32(4.0))) == 2.0
    with pytest.raises(checkify.JaxRuntimeError):
        safe(jnp.float32(-1.0))


def test_debug_mode_restores_flag():
    import jax

    from multigridcmt.utils import debug

    before = jax.config.jax_debug_nans
    with debug.debug_mode():
        assert jax.config.jax_debug_nans is True
    assert jax.config.jax_debug_nans == before


def test_eigensolve_resume_beats_cold(tmp_path):
    """Eigensolver warm-start + checkpoint resume: resuming from a partially converged eigenvector block on
    the 8-device mesh takes fewer outer iterations than a cold start,
    and reaches the same eigenvalue; resume_solve dispatches on the
    eigen snapshot."""
    import jax

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    from multigridcmt.config import SolverConfig
    from multigridcmt.parallel import sharded

    base = dict(ndim=2, k=6, dtype=jnp.float64, smoother="rbgs",
                agglom_rows=8)
    mesh = sharded.make_mesh(jax.devices()[:8])
    solver = sharded.ShardedSolver(SolverConfig(**base), mesh)
    cold = solver.eigensolve(k=2, tol=1e-9, max_iters=40)
    # "Interrupt" after a loose-tolerance run and snapshot the block.
    part = solver.eigensolve(k=2, tol=1e-4, max_iters=40)
    path = str(tmp_path / "eig")
    checkpoint.save_state(path, part.eigenvectors, part.res_history,
                          part.iters,
                          extra={"eigenvalues": part.eigenvalues})
    resumed = checkpoint.resume_solve(solver, path, k=2, tol=1e-9,
                                      max_iters=40)
    assert bool(resumed.converged)
    assert int(resumed.iters) < int(cold.iters)
    np.testing.assert_allclose(np.asarray(resumed.eigenvalues),
                               np.asarray(cold.eigenvalues),
                               rtol=1e-8)
    # Single-device warm start path too (lobpcg + ii).
    prob = mg.poisson2d(k=5, dtype=jnp.float64, smoother="rbgs")
    ms = mg.MultigridSolver(prob)
    cold1 = ms.eigensolve(k=2, tol=1e-9, max_iters=40)
    warm1 = ms.eigensolve(k=2, tol=1e-9, max_iters=40,
                          v0=cold1.eigenvectors)
    assert int(warm1.iters) <= 2
    coldl = ms.eigensolve(k=2, method="lobpcg", tol=1e-8, max_iters=40)
    warml = ms.eigensolve(k=2, method="lobpcg", tol=1e-8, max_iters=40,
                          v0=coldl.eigenvectors)
    assert int(warml.iters) <= int(coldl.iters)


def test_sharded_resume_without_b_raises(tmp_path):
    """ShardedSolver resume with no RHS raises the contract error, not
    an opaque TypeError."""
    import jax

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    from multigridcmt.config import SolverConfig
    from multigridcmt.parallel import sharded

    solver = sharded.ShardedSolver(
        SolverConfig(ndim=2, k=6, dtype=jnp.float64, agglom_rows=8),
        sharded.make_mesh(jax.devices()[:8]))
    path = str(tmp_path / "snap")
    checkpoint.save_state(path, np.zeros((33, 33)), np.zeros(3), 1)
    with pytest.raises(ValueError, match="needs the RHS"):
        checkpoint.resume_solve(solver, path)
