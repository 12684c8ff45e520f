"""Shard-local stencil ops of the masked jnp tier against the unsharded ops,
on every decomposition the runtime supports: 2D rows and blocks, 3D slabs
and pencils (SURVEY.md §2 "per-level row/block partitioning"). Each op runs
on owned tiles inside shard_map and must give the single-device result to
rounding (float64, 1e-12 relative to the output's scale) — RB-GS sweep
order across shard boundaries, corner halos and the one-sided transfer
halos included.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from multigridcmt.ops import laplacian, smoothers, transfer
from multigridcmt.parallel import sharded

# name -> (ndim, mesh shape, grid exponent)
DECOMPS = {
    "rows8": (2, (8,), 5),
    "rows4": (2, (4,), 5),
    "blocks4x2": (2, (4, 2), 5),
    "blocks2x4": (2, (2, 4), 5),
    "blocks2x2": (2, (2, 2), 5),
    "slabs4": (3, (4,), 4),
    "slabs8": (3, (8,), 4),
    "pencils2x2": (3, (2, 2), 4),
}
OPS = ["rbgs", "jacobi", "chebyshev", "residual_shifted", "restrict",
       "prolong"]


def _mesh(shape):
    devs = jax.devices()
    if len(devs) < int(np.prod(shape)):
        pytest.skip(f"needs {int(np.prod(shape))} (virtual) devices")
    if len(shape) == 1:
        return sharded.make_mesh(devs[:shape[0]])
    return sharded.make_block_mesh(shape, devs)


def _padded(n, ndim, seed):
    rng = np.random.default_rng(seed)
    return jnp.pad(jnp.asarray(rng.standard_normal((n,) * ndim)), 1)


def _run(fn, mesh, decomp, *arrays):
    f = jax.jit(jax.shard_map(
        fn, mesh=mesh, in_specs=tuple(decomp.spec() for _ in arrays),
        out_specs=decomp.spec(), check_vma=False))
    tiles = [sharded.shard_rhs(a, mesh, decomp) for a in arrays]
    return np.asarray(sharded.unshard(f(*tiles), decomp))


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("decomp_name", list(DECOMPS))
def test_sharded_op_matches_unsharded(decomp_name, op):
    ndim, shape, k = DECOMPS[decomp_name]
    mesh = _mesh(shape)
    dec = sharded.decomp_from_mesh(mesh, ndim)
    n, nc = 2 ** k - 1, 2 ** (k - 1) - 1
    h = 1.0 / (n + 1)
    omega = smoothers.default_omega(ndim)
    u, b = _padded(n, ndim, 1), _padded(n, ndim, 2)
    if op in ("rbgs", "jacobi", "chebyshev"):
        sweeps = 3 if op == "chebyshev" else 2
        want = smoothers.smooth(u, b, h, kind=op, omega=omega,
                                sweeps=sweeps)
        got = _run(lambda ut, bt: sharded.s_smooth(
            ut, bt, n, h, kind=op, omega=omega, sweeps=sweeps,
            decomp=dec), mesh, dec, u, b)
    elif op == "residual_shifted":
        want = laplacian.residual(u, b, h, sigma=7.5)
        got = _run(lambda ut, bt: sharded.s_residual(ut, bt, n, h, dec,
                                                     sigma=7.5),
                   mesh, dec, u, b)
    elif op == "restrict":
        want = transfer.restrict(u)
        got = _run(lambda ut: sharded.s_restrict(ut, n, dec), mesh, dec, u)
    else:
        e = _padded(nc, ndim, 3)
        want = transfer.prolong(e)
        got = _run(lambda et: sharded.s_prolong(et, nc, dec), mesh, dec, e)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-12,
                               atol=1e-12 * np.abs(want).max())


@pytest.mark.parametrize("op", ["restrict", "prolong"])
def test_pencil_transfers_mixed_regime(op, monkeypatch):
    """Pencils with the minor-axis matmul passes engaged on the unsharded
    axis: the sharded row axis keeps the halo'd slice pass, so the result
    equals the single-device transfer to rounding order."""
    monkeypatch.setattr(transfer, "_MM_MIN_N", 8)
    mesh = _mesh((2, 2))
    dec = sharded.decomp_from_mesh(mesh, 3)
    k = 4
    n, nc = 2 ** k - 1, 2 ** (k - 1) - 1
    if op == "restrict":
        u = _padded(n, 3, 4)
        want = np.asarray(transfer.restrict(u))
        got = _run(lambda ut: sharded.s_restrict(ut, n, dec), mesh, dec, u)
    else:
        e = _padded(nc, 3, 5)
        want = np.asarray(transfer.prolong(e))
        got = _run(lambda et: sharded.s_prolong(et, nc, dec), mesh, dec, e)
    np.testing.assert_allclose(got, want, rtol=1e-12,
                               atol=1e-12 * np.abs(want).max())
