"""Block / plane / pencil decomposition tests (SURVEY.md §2 "per-level
row/block partitioning", §4.4 virtual-mesh strategy).

The binding property is the same as tests/test_sharded.py: every
decomposition runs numerically the SAME algorithm as the single device —
identical iteration counts, residual histories, and solutions to fp
tolerance — including RB-GS sweep order across BOTH shard axes and the
corner halos that sequential per-axis extension must get right.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

import multigridcmt as mg
from multigridcmt.config import SolverConfig
from multigridcmt.grids import interior
from multigridcmt.parallel import sharded


needs_8 = pytest.mark.skipif(len(jax.devices()) < 8,
                             reason="needs 8 (virtual) devices")


def _block_mesh(shape=(4, 2)):
    return sharded.make_block_mesh(shape, jax.devices())


def _mesh1d(ndev=8):
    return sharded.make_mesh(jax.devices()[:ndev])


# ---------------------------------------------------------------------------
# Primitive equivalence on a 2D block mesh: the corner-halo property.
# ---------------------------------------------------------------------------

def _run_blocked(fn, mesh, decomp, *arrays):
    """shard_map a tile->tile function and return the global padded result."""
    f = jax.jit(jax.shard_map(
        fn, mesh=mesh, in_specs=tuple(decomp.spec() for _ in arrays),
        out_specs=decomp.spec(), check_vma=False))
    tiles = [sharded.shard_rhs(a, mesh, decomp) for a in arrays]
    return np.asarray(sharded.unshard(f(*tiles), decomp))


@needs_8
@pytest.mark.parametrize("shape", [(4, 2), (2, 4), (2, 2)])
def test_block_residual_matches(shape):
    from multigridcmt.ops import laplacian

    k = 4
    n = 2 ** k - 1
    h = 1.0 / (n + 1)
    rng = np.random.default_rng(0)
    u = np.zeros((n + 2, n + 2))
    u[1:-1, 1:-1] = rng.standard_normal((n, n))
    b = np.zeros_like(u)
    b[1:-1, 1:-1] = rng.standard_normal((n, n))
    want = np.asarray(laplacian.residual(jnp.asarray(u), jnp.asarray(b), h))

    mesh = _block_mesh(shape)
    decomp = sharded.decomp_from_mesh(mesh, 2)
    got = _run_blocked(
        lambda ut, bt: sharded.s_residual(ut, bt, n, h, decomp),
        mesh, decomp, jnp.asarray(u), jnp.asarray(b))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


@needs_8
def test_block_rbgs_sweep_matches():
    """RB-GS across both shard axes == single-device sweep (corner halos
    and inter-color halo refresh must both be right)."""
    from multigridcmt.ops import smoothers

    k = 4
    n = 2 ** k - 1
    h = 1.0 / (n + 1)
    rng = np.random.default_rng(1)
    u = np.zeros((n + 2, n + 2))
    u[1:-1, 1:-1] = rng.standard_normal((n, n))
    b = np.zeros_like(u)
    b[1:-1, 1:-1] = rng.standard_normal((n, n))
    want = np.asarray(smoothers.rbgs(jnp.asarray(u), jnp.asarray(b), h))

    mesh = _block_mesh((2, 4))
    decomp = sharded.decomp_from_mesh(mesh, 2)
    got = _run_blocked(
        lambda ut, bt: sharded.s_rbgs(ut, bt, n, h, decomp),
        mesh, decomp, jnp.asarray(u), jnp.asarray(b))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


@needs_8
def test_block_transfer_matches():
    from multigridcmt.ops import transfer

    k = 4
    n = 2 ** k - 1
    nc = (n - 1) // 2
    rng = np.random.default_rng(2)
    r = np.zeros((n + 2, n + 2))
    r[1:-1, 1:-1] = rng.standard_normal((n, n))
    e = np.zeros((nc + 2, nc + 2))
    e[1:-1, 1:-1] = rng.standard_normal((nc, nc))

    mesh = _block_mesh((2, 2))
    decomp = sharded.decomp_from_mesh(mesh, 2)

    got_r = _run_blocked(lambda rt: sharded.s_restrict(rt, n, decomp),
                         mesh, decomp, jnp.asarray(r))
    np.testing.assert_allclose(got_r, np.asarray(transfer.restrict(
        jnp.asarray(r))), rtol=1e-12, atol=1e-12)

    got_p = _run_blocked(lambda et: sharded.s_prolong(et, nc, decomp),
                         mesh, decomp, jnp.asarray(e))
    np.testing.assert_allclose(got_p, np.asarray(transfer.prolong(
        jnp.asarray(e))), rtol=1e-12, atol=1e-12)


# ---------------------------------------------------------------------------
# End-to-end solves on every decomposition.
# ---------------------------------------------------------------------------

@needs_8
@pytest.mark.parametrize("smoother", ["jacobi", "rbgs", "chebyshev"])
def test_block_solve_matches_unsharded(smoother):
    """2D block decomposition (4x2): identical history and solution."""
    cfg = SolverConfig(ndim=2, k=6, dtype=jnp.float64, smoother=smoother,
                       tol=1e-8, agglom_rows=4)
    prob = mg.poisson2d(k=6, dtype=jnp.float64, smoother=smoother, tol=1e-8)
    ref = mg.MultigridSolver(prob).solve()

    got = sharded.ShardedSolver(cfg, _block_mesh((4, 2))).solve(prob.b)
    assert int(got.iters) == int(ref.iters)
    np.testing.assert_allclose(np.asarray(got.res_history),
                               np.asarray(ref.res_history),
                               rtol=1e-6, atol=1e-11)
    np.testing.assert_allclose(np.asarray(got.x), np.asarray(ref.x),
                               rtol=1e-8, atol=1e-12)


@needs_8
def test_block_fmg_matches_unsharded():
    cfg = SolverConfig(ndim=2, k=6, dtype=jnp.float64, smoother="rbgs",
                       cycle="fmg", tol=1e-10, agglom_rows=4)
    prob = mg.poisson2d(k=6, dtype=jnp.float64, smoother="rbgs",
                        cycle="fmg", tol=1e-10)
    ref = mg.MultigridSolver(prob).solve()
    got = sharded.ShardedSolver(cfg, _block_mesh((2, 2))).solve(prob.b)
    assert int(got.iters) == int(ref.iters)
    np.testing.assert_allclose(np.asarray(got.x), np.asarray(ref.x),
                               rtol=1e-8, atol=1e-12)


@needs_8
def test_block_pcg_matches_unsharded():
    from multigridcmt.solvers import krylov

    cfg = SolverConfig(ndim=2, k=6, dtype=jnp.float64, smoother="chebyshev",
                       tol=1e-9, agglom_rows=4)
    prob = mg.poisson2d(k=6, dtype=jnp.float64, smoother="chebyshev",
                        tol=1e-9)
    ref = krylov.solve_pcg(prob.hierarchy, prob.b, cfg)
    got = sharded.ShardedSolver(cfg, _block_mesh((4, 2))).solve(
        prob.b, method="pcg")
    assert int(got.iters) == int(ref.iters)
    np.testing.assert_allclose(np.asarray(got.x), np.asarray(ref.x),
                               rtol=1e-8, atol=1e-12)


@needs_8
def test_block_eigensolve_matches_unsharded():
    k_grid = 5
    cfg = SolverConfig(ndim=2, k=k_grid, dtype=jnp.float64, smoother="rbgs",
                       agglom_rows=4)
    prob = mg.poisson2d(k=k_grid, dtype=jnp.float64, smoother="rbgs")
    ref = mg.MultigridSolver(prob).eigensolve(k=2, method="ii", tol=1e-9)
    got = sharded.ShardedSolver(cfg, _block_mesh((2, 2))).eigensolve(
        k=2, method="ii", tol=1e-9)
    assert bool(got.converged)
    np.testing.assert_allclose(np.sort(np.asarray(got.eigenvalues)),
                               np.sort(np.asarray(ref.eigenvalues)),
                               rtol=1e-8)


@needs_8
@pytest.mark.parametrize("smoother", ["rbgs", "chebyshev"])
def test_3d_plane_solve_matches_unsharded(smoother):
    """3D slab decomposition over a 1D mesh."""
    cfg = SolverConfig(ndim=3, k=4, dtype=jnp.float64, smoother=smoother,
                       tol=1e-8, agglom_rows=2)
    prob = mg.poisson3d(k=4, dtype=jnp.float64, smoother=smoother, tol=1e-8)
    ref = mg.MultigridSolver(prob).solve()
    got = sharded.ShardedSolver(cfg, _mesh1d(4)).solve(prob.b)
    assert int(got.iters) == int(ref.iters)
    np.testing.assert_allclose(np.asarray(got.res_history),
                               np.asarray(ref.res_history),
                               rtol=1e-6, atol=1e-11)
    np.testing.assert_allclose(np.asarray(got.x), np.asarray(ref.x),
                               rtol=1e-8, atol=1e-12)


@needs_8
def test_3d_pencil_solve_matches_unsharded():
    """3D pencil decomposition over a 2D (2x4) mesh."""
    cfg = SolverConfig(ndim=3, k=4, dtype=jnp.float64, smoother="rbgs",
                       tol=1e-8, agglom_rows=2)
    prob = mg.poisson3d(k=4, dtype=jnp.float64, smoother="rbgs", tol=1e-8)
    ref = mg.MultigridSolver(prob).solve()
    got = sharded.ShardedSolver(cfg, _block_mesh((2, 4))).solve(prob.b)
    assert int(got.iters) == int(ref.iters)
    np.testing.assert_allclose(np.asarray(got.x), np.asarray(ref.x),
                               rtol=1e-8, atol=1e-12)


@needs_8
def test_3d_plane_eigensolve():
    """Smallest 3D eigenvalue on the slab decomposition vs analytic."""
    from multigridcmt.ops import laplacian

    k_grid = 4
    cfg = SolverConfig(ndim=3, k=k_grid, dtype=jnp.float64, smoother="rbgs",
                       agglom_rows=2)
    got = sharded.ShardedSolver(cfg, _mesh1d(4)).eigensolve(
        k=1, method="ii", tol=1e-9)
    assert bool(got.converged)
    n = 2 ** k_grid - 1
    h = 1.0 / (n + 1)
    want = laplacian.eigenvalue_3d(1, 1, 1, n, h)
    np.testing.assert_allclose(np.asarray(got.eigenvalues)[0], want,
                               rtol=1e-9)


@needs_8
def test_1d_row_solve_matches_unsharded():
    """Even the 1D problem runs under the generic decomposition."""
    cfg = SolverConfig(ndim=1, k=8, dtype=jnp.float64, smoother="jacobi",
                       tol=1e-8, agglom_rows=8)
    prob = mg.poisson1d(k=8, dtype=jnp.float64, smoother="jacobi", tol=1e-8)
    ref = mg.MultigridSolver(prob).solve()
    got = sharded.ShardedSolver(cfg, _mesh1d(8)).solve(prob.b)
    assert int(got.iters) == int(ref.iters)
    np.testing.assert_allclose(np.asarray(got.x), np.asarray(ref.x),
                               rtol=1e-8, atol=1e-12)


@needs_8
@pytest.mark.parametrize("mesh_kind", ["row", "block"])
def test_sharded_lobpcg_matches_unsharded(mesh_kind):
    """Distributed LOBPCG == single-device LOBPCG: same eigenvalues and
    iteration counts (psum grams are exact reductions of the whole dots)."""
    k_grid = 5
    cfg = SolverConfig(ndim=2, k=k_grid, dtype=jnp.float64, smoother="rbgs",
                       agglom_rows=4)
    prob = mg.poisson2d(k=k_grid, dtype=jnp.float64, smoother="rbgs")
    ref = mg.MultigridSolver(prob).eigensolve(k=2, method="lobpcg", tol=1e-9)
    mesh = _mesh1d(8) if mesh_kind == "row" else _block_mesh((2, 2))
    got = sharded.ShardedSolver(cfg, mesh).eigensolve(
        k=2, method="lobpcg", tol=1e-9)
    assert bool(got.converged)
    assert int(got.iters) == int(ref.iters)
    np.testing.assert_allclose(np.asarray(got.eigenvalues),
                               np.asarray(ref.eigenvalues), rtol=1e-8)
    from multigridcmt.ops import laplacian
    n = 2 ** k_grid - 1
    h = 1.0 / (n + 1)
    want = sorted(laplacian.eigenvalue_2d(i, j, n, h)
                  for i, j in [(1, 1), (1, 2)])
    np.testing.assert_allclose(np.asarray(got.eigenvalues), want, rtol=1e-8)
