"""Communication-structure audit: the ppermute count of one sharded
cycle, read off the traced jaxpr, must equal the structural minimum the
runtime is designed to emit — the machine-checkable stand-in for "halo
exchange overlapped and not duplicated".

Derivation for the masked jnp tier (one "eqn" = one ppermute of one slab
along one sharded axis), S sharded levels, rbgs nu1 = nu2 = nu: each
half-sweep is one overlapped exchange (a near and a far slab per axis: 2
eqns per axis), so the 2*nu sweeps of a level cost 8*nu eqns per axis;
the residual 2; restriction reads only the far halo (1) and prolongation
only the near halo (1); the last sharded level's prolongation is replaced
by the agglomeration gather/scatter (0). Total per axis
S*(8nu + 3) + (S - 1); the agglomeration crossing is one all_gather per
axis.
"""
import jax
import jax.numpy as jnp
import pytest

from multigridcmt.config import SolverConfig
from multigridcmt.parallel import sharded
from multigridcmt.utils import comm_audit

needs_8 = pytest.mark.skipif(len(jax.devices()) < 8,
                             reason="needs 8 (virtual) devices")


def _audit_cycle(cfg, mesh):
    s = sharded.ShardedSolver(cfg, mesh)
    b = jnp.zeros((cfg.n + 2,) * 2, dtype=cfg.dtype)
    b_sh = sharded.shard_rhs(b, mesh, s.decomp)
    return comm_audit.audit(s.v_cycle_fn(), jnp.zeros_like(b_sh), b_sh)


def _sharded_levels(cfg, mesh):
    dec = sharded.decomp_from_mesh(mesh, cfg.ndim)
    lev = 0
    while sharded._is_sharded(cfg, dec, lev):
        lev += 1
    return lev


@needs_8
@pytest.mark.parametrize("mesh_kind,naxes", [("rows", 1), ("block", 2)])
def test_leg_path_ppermute_minimum(mesh_kind, naxes):
    """Masked jnp tier at k=8 with four sharded levels on a rows (4,) and
    a blocks (2, 2) mesh: S*(8nu+3) + (S-1) eqns per sharded axis, one
    all_gather per axis at the agglomeration crossing, nothing else."""
    if mesh_kind == "rows":
        mesh = sharded.make_mesh(jax.devices()[:4])
        agglom = 8        # levels 0..3 sharded, level 4 agglomerated
    else:
        mesh = sharded.make_block_mesh((2, 2))
        agglom = 16       # same S on the 2-axis mesh
    cfg = SolverConfig(ndim=2, k=8, dtype=jnp.float64, smoother="rbgs",
                       agglom_rows=agglom)
    s_lev = _sharded_levels(cfg, mesh)
    assert s_lev == 4
    res = _audit_cycle(cfg, mesh)
    per_axis = s_lev * (8 * cfg.nu1 + 3) + (s_lev - 1)
    assert res["counts"]["ppermute"] == per_axis * naxes, res
    assert res["counts"]["all_gather"] == naxes, res
    assert "all_to_all" not in res["counts"]


@needs_8
def test_jnp_path_ppermute_minimum():
    """jnp tile-stencil path: S*(8nu+3) + (S-1) ppermutes (S = 2
    sharded levels at k=6 on 4 devices, nu = 2)."""
    mesh = sharded.make_mesh(jax.devices()[:4])
    cfg = SolverConfig(ndim=2, k=6, dtype=jnp.float64, smoother="rbgs",
                       agglom_rows=8)
    dec = sharded.decomp_from_mesh(mesh, 2)
    s_lev = 0
    while sharded._is_sharded(cfg, dec, s_lev):
        s_lev += 1
    assert s_lev == 2
    res = _audit_cycle(cfg, mesh)
    expect = s_lev * (8 * 2 + 3) + (s_lev - 1)
    assert res["counts"]["ppermute"] == expect, res
    assert res["counts"]["all_gather"] == 1, res


@needs_8
def test_leg_path_exchanged_bytes_reported():
    """The audit's byte accounting matches the derivation: on a rows mesh
    every slab is one padded row of its level (width 2^(k-l) + 1), and
    level l's prolongation exchanges a row of the coarser level l+1."""
    mesh = sharded.make_mesh(jax.devices()[:4])
    cfg = SolverConfig(ndim=2, k=8, dtype=jnp.float64, smoother="rbgs",
                       agglom_rows=8)
    s_lev = _sharded_levels(cfg, mesh)
    res = _audit_cycle(cfg, mesh)
    item = 8
    want = 0
    for lev in range(s_lev):
        width = 2 ** (cfg.k - lev) + 1
        want += (8 * cfg.nu1 + 3) * width * item     # sweeps, residual,
        if lev < s_lev - 1:                          # restriction
            want += (2 ** (cfg.k - lev - 1) + 1) * item  # prolongation
    assert res["bytes"]["ppermute"] == want, res
