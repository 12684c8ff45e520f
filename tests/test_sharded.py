"""Distributed-path tests on the 8-virtual-device CPU mesh (SURVEY.md §4.4).

The binding property: the sharded V-cycle is numerically the SAME algorithm
as the single-device one — identical residual histories to fp tolerance —
including RB-GS sweep order across shard boundaries (SURVEY.md §7 hard
part #1) and the agglomerated coarse levels.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

import multigridcmt as mg
from multigridcmt.config import SolverConfig
from multigridcmt.grids import interior, pad_interior
from multigridcmt.parallel import sharded


needs_8 = pytest.mark.skipif(len(jax.devices()) < 8,
                             reason="needs 8 (virtual) devices")


def _mesh(ndev=8):
    return sharded.make_mesh(jax.devices()[:ndev])


@needs_8
def test_halo_extend_roundtrip():
    mesh = _mesh()
    n = 15                    # padded rows 17; sharded rows 16, m=2
    rows = jnp.arange(16.0 * 4).reshape(16, 4)

    def f(u):
        return sharded.halo_extend(u, "row", 8)

    got = jax.jit(jax.shard_map(f, mesh=mesh, in_specs=P("row", None),
                                out_specs=P("row", None),
                                check_vma=False))(rows)
    got = np.asarray(got).reshape(8, 4, 4)   # per-device (m+2, c)
    full = np.asarray(rows)
    for d in range(8):
        want_top = full[d * 2 - 1] if d > 0 else np.zeros(4)
        np.testing.assert_array_equal(got[d, 0], want_top)
        np.testing.assert_array_equal(got[d, 1:3], full[d * 2:d * 2 + 2])
        want_bot = full[d * 2 + 2] if d < 7 else np.zeros(4)
        np.testing.assert_array_equal(got[d, 3], want_bot)


@needs_8
@pytest.mark.parametrize("smoother", ["jacobi", "rbgs", "chebyshev"])
def test_sharded_solve_matches_unsharded(smoother):
    """Identical residual history and solution, sharded vs single-device.

    k=6 with 8 devices and agglom_rows=8 exercises BOTH regimes: level 0
    sharded (m=8), levels 1+ agglomerated/replicated."""
    cfg = SolverConfig(ndim=2, k=6, dtype=jnp.float64, smoother=smoother,
                      tol=1e-8, agglom_rows=8)
    prob = mg.poisson2d(k=6, dtype=jnp.float64, smoother=smoother, tol=1e-8)
    ref = mg.MultigridSolver(prob).solve()

    s = sharded.ShardedSolver(cfg, _mesh())
    got = s.solve(prob.b)

    assert int(got.iters) == int(ref.iters)
    np.testing.assert_allclose(np.asarray(got.res_history),
                               np.asarray(ref.res_history),
                               rtol=1e-6, atol=1e-11)
    np.testing.assert_allclose(np.asarray(got.x), np.asarray(ref.x),
                               rtol=1e-8, atol=1e-12)


@needs_8
def test_sharded_multiple_sharded_levels():
    """k=7, agglom_rows=4: levels 0 (m=16), 1 (m=8), 2 (m=4) sharded,
    deeper levels replicated — exercises sharded restrict/prolong chains."""
    cfg = SolverConfig(ndim=2, k=7, dtype=jnp.float64, smoother="rbgs",
                      tol=1e-8, agglom_rows=4)
    prob = mg.poisson2d(k=7, dtype=jnp.float64, smoother="rbgs", tol=1e-8)
    ref = mg.MultigridSolver(prob).solve()
    got = sharded.ShardedSolver(cfg, _mesh()).solve(prob.b)
    assert int(got.iters) == int(ref.iters)
    np.testing.assert_allclose(np.asarray(got.x), np.asarray(ref.x),
                               rtol=1e-8, atol=1e-12)


@needs_8
def test_sharded_w_cycle():
    cfg = SolverConfig(ndim=2, k=6, dtype=jnp.float64, smoother="rbgs",
                      cycle="w", tol=1e-8, agglom_rows=8)
    prob = mg.poisson2d(k=6, dtype=jnp.float64, smoother="rbgs", cycle="w",
                        tol=1e-8)
    ref = mg.MultigridSolver(prob).solve()
    got = sharded.ShardedSolver(cfg, _mesh()).solve(prob.b)
    assert int(got.iters) == int(ref.iters)
    np.testing.assert_allclose(np.asarray(got.x), np.asarray(ref.x),
                               rtol=1e-8, atol=1e-12)


@needs_8
@pytest.mark.parametrize("ndev", [2, 4, 8])
def test_mesh_size_degrades(ndev):
    """Any power-of-two mesh size works (SNIPPETS degrading-mesh pattern)."""
    cfg = SolverConfig(ndim=2, k=5, dtype=jnp.float64, smoother="rbgs",
                      tol=1e-8, agglom_rows=4)
    prob = mg.poisson2d(k=5, dtype=jnp.float64, smoother="rbgs", tol=1e-8)
    ref = mg.MultigridSolver(prob).solve()
    got = sharded.ShardedSolver(cfg, _mesh(ndev)).solve(prob.b)
    assert int(got.iters) == int(ref.iters)
    np.testing.assert_allclose(np.asarray(got.x), np.asarray(ref.x),
                               rtol=1e-8, atol=1e-12)


@needs_8
def test_solution_accuracy_sharded():
    cfg = SolverConfig(ndim=2, k=6, dtype=jnp.float64, smoother="rbgs",
                      tol=1e-10, agglom_rows=4)
    prob = mg.poisson2d(k=6, dtype=jnp.float64)
    got = sharded.ShardedSolver(cfg, _mesh()).solve(prob.b)
    err = np.abs(np.asarray(interior(got.x))
                 - np.asarray(interior(prob.u_exact))).max()
    assert err < 1e-3   # discretization-level accuracy at k=6


@needs_8
def test_sharded_fmg_matches_unsharded():
    """Distributed FMG == single-device FMG (same cycle="fmg" solve)."""
    cfg = SolverConfig(ndim=2, k=6, dtype=jnp.float64, smoother="rbgs",
                      cycle="fmg", tol=1e-10, agglom_rows=4)
    prob = mg.poisson2d(k=6, dtype=jnp.float64, smoother="rbgs",
                        cycle="fmg", tol=1e-10)
    ref = mg.MultigridSolver(prob).solve()
    got = sharded.ShardedSolver(cfg, _mesh()).solve(prob.b)
    assert int(got.iters) == int(ref.iters)
    np.testing.assert_allclose(np.asarray(got.x), np.asarray(ref.x),
                               rtol=1e-8, atol=1e-12)
    # FMG alone reaches discretization accuracy: first recorded residual
    # (post-FMG) is already small.
    assert float(got.res_history[0]) < 1e-3


@needs_8
@pytest.mark.parametrize("method,kk", [("ii", 3), ("rqi", 1)])
def test_sharded_eigensolve_matches_unsharded(method, kk):
    """Distributed eigensolver: same eigenvalues as the single-device path
    and the analytic spectrum (psum Rayleigh quotients, sharded inner
    V-cycles). RQI at k=1 only — per-vector shifts near lambda_2 make
    A - sigma*I indefinite, outside MG's contract (same as the
    single-device path, tests/test_eigen.py)."""
    k_grid = 5
    cfg = SolverConfig(ndim=2, k=k_grid, dtype=jnp.float64, smoother="rbgs",
                      agglom_rows=4)
    prob = mg.poisson2d(k=k_grid, dtype=jnp.float64, smoother="rbgs")
    ref = mg.MultigridSolver(prob).eigensolve(k=kk, method=method, tol=1e-9)
    got = sharded.ShardedSolver(cfg, _mesh()).eigensolve(
        k=kk, method=method, tol=1e-9)
    assert bool(got.converged)
    np.testing.assert_allclose(np.sort(np.asarray(got.eigenvalues)),
                               np.sort(np.asarray(ref.eigenvalues)),
                               rtol=1e-8)
    # Analytic check: lambda_{ij} = (2/h^2)(2 - cos(i pi h) - cos(j pi h)).
    n = 2 ** k_grid - 1
    h = 1.0 / (n + 1)
    ij = [(1, 1), (1, 2), (2, 1)][:kk]
    want = np.sort([2.0 / h ** 2 * (2 - np.cos(i * np.pi * h)
                                    - np.cos(j * np.pi * h))
                    for i, j in ij])
    np.testing.assert_allclose(np.sort(np.asarray(got.eigenvalues)), want,
                               rtol=1e-9)


@needs_8
@pytest.mark.parametrize("smoother", ["rbgs", "chebyshev"])
def test_sharded_pcg_matches_unsharded(smoother):
    """Distributed MG-PCG == single-device MG-PCG: same iteration count,
    same residual history, same solution (psum dots are exact reductions
    of the whole-array dots)."""
    from multigridcmt.solvers import krylov

    cfg = SolverConfig(ndim=2, k=6, dtype=jnp.float64, smoother=smoother,
                       tol=1e-9, agglom_rows=8)
    prob = mg.poisson2d(k=6, dtype=jnp.float64, smoother=smoother, tol=1e-9)
    ref = krylov.solve_pcg(prob.hierarchy, prob.b, cfg)

    s = sharded.ShardedSolver(cfg, _mesh())
    got = s.solve(prob.b, method="pcg")

    assert bool(got.converged)
    assert int(got.iters) == int(ref.iters)
    np.testing.assert_allclose(np.asarray(got.res_history),
                               np.asarray(ref.res_history),
                               rtol=1e-6, atol=1e-11)
    np.testing.assert_allclose(np.asarray(got.x), np.asarray(ref.x),
                               rtol=1e-8, atol=1e-12)


@needs_8
def test_eigensolve_fns_cached_no_retrace():
    """Repeated eigensolve() calls reuse the cached jitted fn: rebuilding
    jit(shard_map(...)) per call costs a full retrace and compile."""
    cfg = SolverConfig(ndim=2, k=5, dtype=jnp.float64, smoother="rbgs",
                       agglom_rows=4)
    s = sharded.ShardedSolver(cfg, _mesh())
    r1 = s.eigensolve(k=1, method="ii", tol=1e-8)
    n_fns = len(s._solve_fns)
    fns = dict(s._solve_fns)
    r2 = s.eigensolve(k=1, method="ii", tol=1e-8)
    assert len(s._solve_fns) == n_fns
    for key, fn in s._solve_fns.items():
        assert fns[key] is fn
    np.testing.assert_allclose(np.asarray(r1.eigenvalues),
                               np.asarray(r2.eigenvalues), rtol=1e-10)
    # LOBPCG path caches too.
    s.eigensolve(k=1, method="lobpcg", tol=1e-7)
    n_fns2 = len(s._solve_fns)
    s.eigensolve(k=1, method="lobpcg", tol=1e-7)
    assert len(s._solve_fns) == n_fns2


def test_coarsest_level_never_sharded():
    """The coarsest level's direct solve is always replicated: a small
    mesh with small agglom_rows must not leave the last level "sharded"
    (the cycle would recurse past the hierarchy — caught by the driver
    dryrun at 4 devices on a 2x2 mesh)."""
    cfg = SolverConfig(ndim=2, k=5, dtype=jnp.float64, agglom_rows=2)
    mesh = sharded.make_block_mesh((2, 2))
    dec = sharded.decomp_from_mesh(mesh, 2)
    last = len(cfg.level_sizes()) - 1
    assert not sharded._is_sharded(cfg, dec, last)
    # ... while earlier levels with enough local rows still are.
    assert sharded._is_sharded(cfg, dec, 0)
