"""End-to-end solves on the masked jnp sharded tier against the unsharded
solve: rows, blocks, slabs and pencils; RB-GS, Jacobi and Chebyshev; MG
and PCG; W-cycles and FMG; the eigensolvers (II, RQI with its shifted
cycles, LOBPCG); and multi-level sharding with deep local tiles. The
binding property: the same iteration count and the single-device
solution to float64 rounding.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import multigridcmt as mg
from multigridcmt.config import SolverConfig
from multigridcmt.parallel import sharded

MESHES = {"rows": (4,), "blocks": (2, 2)}


def _mesh(shape):
    devs = jax.devices()
    if len(devs) < int(np.prod(shape)):
        pytest.skip(f"needs {int(np.prod(shape))} (virtual) devices")
    if len(shape) == 1:
        return sharded.make_mesh(devs[:shape[0]])
    return sharded.make_block_mesh(shape, devs)


def _compare(got, want, rtol=1e-8, atol=1e-11):
    assert int(got.iters) == int(want.iters)
    np.testing.assert_allclose(np.asarray(got.x), np.asarray(want.x),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("method", ["mg", "pcg"])
@pytest.mark.parametrize("smoother", ["rbgs", "jacobi", "chebyshev"])
@pytest.mark.parametrize("mesh_kind", list(MESHES))
def test_sharded_solve_2d(mesh_kind, smoother, method):
    base = dict(k=6, dtype=jnp.float64, smoother=smoother, tol=1e-9,
                agglom_rows=4)
    prob = mg.poisson2d(**base)
    want = mg.MultigridSolver(prob).solve(method=method)
    s = sharded.ShardedSolver(SolverConfig(ndim=2, **base),
                              _mesh(MESHES[mesh_kind]))
    got = s.solve(prob.b, method=method)
    assert bool(got.converged)
    _compare(got, want)
    if method == "mg":
        np.testing.assert_allclose(np.asarray(got.res_history),
                                   np.asarray(want.res_history),
                                   rtol=1e-6, atol=1e-11)


@pytest.mark.parametrize("smoother", ["rbgs", "jacobi"])
@pytest.mark.parametrize("decomp", ["slabs", "pencils"])
def test_sharded_solve_3d(decomp, smoother):
    base = dict(k=5, dtype=jnp.float64, smoother=smoother, tol=1e-9,
                agglom_rows=4)
    prob = mg.poisson3d(**base)
    want = mg.MultigridSolver(prob).solve()
    shape = (4,) if decomp == "slabs" else (2, 2)
    got = sharded.ShardedSolver(SolverConfig(ndim=3, **base),
                                _mesh(shape)).solve(prob.b)
    assert bool(got.converged)
    _compare(got, want)


@pytest.mark.parametrize("cycle", ["w", "fmg"])
@pytest.mark.parametrize("mesh_kind", list(MESHES))
def test_sharded_wcycle_fmg(mesh_kind, cycle):
    base = dict(k=6, dtype=jnp.float64, smoother="rbgs", cycle=cycle,
                tol=1e-9, agglom_rows=4)
    prob = mg.poisson2d(**base)
    want = mg.MultigridSolver(prob).solve()
    got = sharded.ShardedSolver(SolverConfig(ndim=2, **base),
                                _mesh(MESHES[mesh_kind])).solve(prob.b)
    _compare(got, want)


@pytest.mark.parametrize("method", ["ii", "rqi", "lobpcg"])
@pytest.mark.parametrize("mesh_kind", list(MESHES))
def test_sharded_eigensolve(mesh_kind, method):
    """lambda_1 matches the single-device eigensolver; RQI runs the
    shifted (sigma != 0) sharded cycles."""
    base = dict(k=5, dtype=jnp.float64, smoother="rbgs", agglom_rows=4)
    prob = mg.poisson2d(**base)
    want = mg.MultigridSolver(prob).eigensolve(k=1, method=method,
                                               tol=1e-8, max_iters=40)
    got = sharded.ShardedSolver(
        SolverConfig(ndim=2, **base), _mesh(MESHES[mesh_kind])).eigensolve(
            k=1, method=method, tol=1e-8, max_iters=40)
    assert bool(got.converged) and bool(want.converged)
    lam, lam_ref = float(got.eigenvalues[0]), float(want.eigenvalues[0])
    assert abs(lam - lam_ref) / lam_ref < 1e-8


@pytest.mark.parametrize("shape,k", [((8,), 9), ((4, 2), 8)])
def test_sharded_multi_level_deep_tiles(shape, k):
    """Several sharded levels with deep local tiles (k=9 on 8 rows: 64
    rows per device on the fine level) — a few V-cycles match the
    unsharded residual history and iterate."""
    base = dict(k=k, dtype=jnp.float64, smoother="rbgs", tol=1e-10,
                max_iters=4, agglom_rows=4)
    prob = mg.poisson2d(**base)
    want = mg.MultigridSolver(prob).solve()
    got = sharded.ShardedSolver(SolverConfig(ndim=2, **base),
                                _mesh(shape)).solve(prob.b)
    _compare(got, want)
    np.testing.assert_allclose(np.asarray(got.res_history),
                               np.asarray(want.res_history),
                               rtol=1e-6, atol=1e-12)
