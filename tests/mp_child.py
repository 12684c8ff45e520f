"""Child process for the multi-process `jax.distributed` CPU test.

Launched (twice) by tests/test_multiprocess.py. Each process owns 4
virtual CPU devices; together they form the 8-device global mesh the rest
of the suite fakes in one process. Exercises the process-safe host I/O of
``ShardedSolver`` (``_to_global`` / ``_to_host``): a global
``device_put``/``device_get`` of the old code throws on non-addressable
shards under ``jax.distributed``, which is exactly what this run guards
against (SURVEY.md §4.4).

Usage: python mp_child.py <coordinator_port> <num_processes> <process_id>
"""
import os
import sys

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=4")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    port, nproc, pid = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    jax.distributed.initialize(coordinator_address=f"localhost:{port}",
                               num_processes=nproc, process_id=pid)
    assert jax.process_count() == nproc, jax.process_count()
    assert len(jax.devices()) == 4 * nproc, len(jax.devices())

    import jax.numpy as jnp

    from multigridcmt.config import SolverConfig
    from multigridcmt.grids import build_hierarchy, pad_interior
    from multigridcmt.parallel import sharded
    from multigridcmt.solvers import cycles, eigen

    # agglom_rows=4 at k=5 on 8 row-devices: level 0 (4 local rows)
    # sharded, level 1 (2 local rows) agglomerated — both regimes crossed,
    # same shape as the single-process tests in test_sharded.py.
    cfg = SolverConfig(ndim=2, k=5, dtype=jnp.float64, smoother="rbgs",
                       tol=1e-10, max_iters=30, agglom_rows=4)
    n, h = cfg.n, cfg.h
    xs = np.arange(1, n + 1) * h
    b = np.asarray(pad_interior(jnp.asarray(
        2 * np.pi ** 2 * np.outer(np.sin(np.pi * xs), np.sin(np.pi * xs)))))

    mesh = sharded.make_mesh()          # rows over all 8 global devices
    solver = sharded.ShardedSolver(cfg, mesh)
    res = solver.solve(b)               # shard_rhs -> shard_map -> unshard
    assert bool(res.converged), float(res.res_history[-1])

    # Single-controller reference on this process's local devices only.
    hier = build_hierarchy(cfg)
    ref = cycles.solve(hier, jnp.asarray(b), cfg)
    err = float(np.max(np.abs(np.asarray(res.x) - np.asarray(ref.x))))
    assert err < 1e-9, err

    # Resume path under real jax.distributed:
    # a capped partial solve warm-starts to convergence in fewer cycles.
    import dataclasses

    cfg3 = dataclasses.replace(cfg, max_iters=3)
    part = sharded.ShardedSolver(cfg3, mesh).solve(b)
    assert not bool(part.converged)
    resumed = solver.solve(b, x0=part.x)
    assert bool(resumed.converged)
    assert int(resumed.iters) < int(res.iters), (int(resumed.iters),
                                                 int(res.iters))

    # Eigensolver I/O path (_to_global of the coarse init, _to_host of the
    # eigenvector block).
    eres = solver.eigensolve(k=1, method="lobpcg", tol=1e-6, max_iters=30)
    assert bool(eres.converged)
    lam = float(eres.eigenvalues[0])
    eref = eigen.lobpcg(hier, cfg, k=1, tol=1e-6, max_iters=30)
    lam_ref = float(eref.eigenvalues[0])
    assert abs(lam - lam_ref) / lam_ref < 1e-6, (lam, lam_ref)

    print(f"MP_OK pid={pid} err={err:.3e} lam={lam:.12f}", flush=True)


if __name__ == "__main__":
    main()
