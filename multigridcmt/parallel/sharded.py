"""Distributed multigrid: shard_map domain decomposition with ppermute halos.

This is the build-side L7 runtime of SURVEY.md §1/§3.5 (the reference is
single-process SciPy — BASELINE.json:5 frames all distribution as build
work). The grid is partitioned over a device mesh — **any prefix of the
array axes may be sharded over a mesh axis**, giving every decomposition
SURVEY.md §2 names ("per-level row/block partitioning"):

* 1D mesh over axis 0 → *row* partitioning in 2D, *plane* (slab) in 3D;
* 2D mesh over axes 0 and 1 → *block* partitioning in 2D, *pencil* in 3D.

Block/pencil decompositions halve the halo surface-to-volume ratio versus
rows at the same device count, which is what carries weak scaling to large
meshes (SURVEY.md §6). Every stencil op exchanges a one-cell halo with its
mesh neighbors along each sharded axis via ``jax.lax.ppermute``; once a
level's local tile gets too small to amortize latency the level is
*agglomerated* — all-gathered over every mesh axis and computed replicated
on all devices (BASELINE.json config 5: "halo ppermute + coarse-level
agglomeration").

Partitioning invariants (vertex-centered 2^k - 1 grids), per sharded axis:

* The padded fine grid has 2^k + 1 entries along the axis: ghost 0,
  interior 1..n, ghost n+1. Entries 1..2^k (interior plus the far ghost)
  are sharded: with D (a power of two <= 2^(k-1)) devices along the axis,
  device d owns m = 2^k / D entries, global entries d*m+1 .. (d+1)*m. The
  far ghost lands on the last device as a "dead" entry that masks keep
  zero; the near ghost 0 is never stored — it reappears as device 0's
  all-zero halo (ppermute edge semantics: non-receiving devices get
  zeros — exactly the homogeneous Dirichlet boundary).

* Coarsening halves m per level (coarse point j sits at fine point 2j), so
  the same ownership formula holds on every sharded level; restriction
  needs only the far halo, prolongation only the near halo.

* Halo handling is **overlapped with compute**: every op issues its
  ppermutes first, runs the stencil/transfer on local data with zero
  edges, and folds the arriving halo slabs into the boundary slices as
  additive fixups (``_neighbor_sum_dd``) — XLA's latency-hiding scheduler
  can then run the bulk of the stencil while the collectives are in
  flight (SURVEY.md §7 hard part #2). The face stencils and the
  *separable* per-axis transfer passes never read corner ghosts, so no
  diagonal-neighbor communication is needed at all.

* Red-black Gauss-Seidel re-exchanges halos between the two half-sweeps
  (the updated red halo feeds the black sweep) — this is what keeps the
  distributed sweep *exactly* equal to the single-device sweep
  (SURVEY.md §7 hard part #1), which the tests assert to fp tolerance.

Multi-host note: the same code runs unchanged on a multi-host mesh built
from ``jax.distributed.initialize`` + all processes' devices (SURVEY.md
§5). On the GPU, XLA hands the ppermutes to NCCL.

Local tiles are *owned-entries only* along sharded axes and full padded
extent along unsharded axes — e.g. (m, n+2) for 2D rows, (m0, m1) for 2D
blocks, (m, n+2, n+2) for 3D slabs. Each op builds its halo-extended view
on the fly; unsharded-axis parts of the transfer stencils reuse the
single-device separable passes from ``ops/transfer.py``.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import SolverConfig
from ..grids import Hierarchy, build_hierarchy, interior, pad_interior
from ..ops import laplacian, smoothers, transfer
from ..solvers import cycles


def make_mesh(devices=None, axis: str = "row") -> Mesh:
    """1D device mesh: row (2D) / slab (3D) partitioning (SURVEY.md §3.5)."""
    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(devices), (axis,))


def make_block_mesh(shape: Tuple[int, int], devices=None,
                    axes: Tuple[str, str] = ("row", "col")) -> Mesh:
    """2D device mesh: block (2D) / pencil (3D) partitioning.

    ``shape = (D_row, D_col)`` splits array axis 0 over ``axes[0]`` and
    axis 1 over ``axes[1]``. The four GPUs of one host are joined all to
    all, so the mesh shape follows the algorithm alone.
    """
    if devices is None:
        devices = jax.devices()
    nd = int(np.prod(shape))
    return Mesh(np.asarray(devices[:nd]).reshape(shape), axes)


@dataclasses.dataclass(frozen=True)
class Decomp:
    """Which array axes are sharded over which mesh axes.

    ``axes`` maps array axis -> (mesh axis name, devices along it); array
    axes are always a prefix 0..len(axes)-1 (leading axes sharded first).
    ``ndim`` is the grid dimensionality.
    """

    ndim: int
    axes: Tuple[Tuple[int, str, int], ...]

    @property
    def mesh_axes(self) -> Tuple[str, ...]:
        return tuple(ma for _, ma, _ in self.axes)

    def info(self, arr_axis: int) -> Optional[Tuple[str, int]]:
        for a, ma, nd in self.axes:
            if a == arr_axis:
                return ma, nd
        return None

    def spec(self, leading_none: int = 0) -> P:
        """PartitionSpec for a grid array (optionally with leading batch
        axes that stay replicated)."""
        entries = [None] * leading_none
        for a in range(self.ndim):
            i = self.info(a)
            entries.append(i[0] if i is not None else None)
        return P(*entries)


def decomp_from_mesh(mesh: Mesh, ndim: int) -> Decomp:
    """Shard the leading array axes over the mesh axes, in order."""
    names = mesh.axis_names
    if len(names) > ndim:
        raise ValueError(f"mesh has {len(names)} axes but the grid only "
                         f"{ndim} — at most one mesh axis per grid axis")
    sizes = mesh.devices.shape
    return Decomp(ndim=ndim,
                  axes=tuple((a, names[a], int(sizes[a]))
                             for a in range(len(names))))


# ---------------------------------------------------------------------------
# Halo exchange and local (per-shard) stencil ops. All run inside shard_map.
# ---------------------------------------------------------------------------

def _perm_down(d: int):
    """src -> src+1 (deliver my last entry as my next neighbor's near halo)."""
    return [(i, i + 1) for i in range(d - 1)]


def _perm_up(d: int):
    return [(i + 1, i) for i in range(d - 1)]


def _halo_extend_axis(u: jax.Array, arr_axis: int, mesh_axis: str,
                      ndev: int) -> jax.Array:
    """Extend one array axis by its neighbors' edge slabs: m -> m+2.

    Edge devices receive zeros — the Dirichlet ghosts — for free from
    ppermute's no-source semantics.
    """
    v = jnp.moveaxis(u, arr_axis, 0)
    near = jax.lax.ppermute(v[-1:], mesh_axis, _perm_down(ndev))
    far = jax.lax.ppermute(v[:1], mesh_axis, _perm_up(ndev))
    v = jnp.concatenate([near, v, far], axis=0)
    return jnp.moveaxis(v, 0, arr_axis)


def halo_extend(u: jax.Array, axis: str, ndev: int) -> jax.Array:
    """(m, ...) owned tile -> (m+2, ...) with neighbor halos on axis 0."""
    return _halo_extend_axis(u, 0, axis, ndev)


def _neighbor_sum(ext: jax.Array) -> jax.Array:
    """Sum of the 2*ndim face neighbors at every core point of a (locally)
    padded tile."""
    nd = ext.ndim
    out = None
    for a in range(nd):
        lo = tuple(slice(0, -2) if i == a else slice(1, -1)
                   for i in range(nd))
        hi = tuple(slice(2, None) if i == a else slice(1, -1)
                   for i in range(nd))
        t = ext[lo] + ext[hi]
        out = t if out is None else out + t
    return out


def _slice_unsharded(x: jax.Array, decomp: Decomp) -> jax.Array:
    """Take the interior 1:-1 along unsharded (padded) axes only."""
    idx = tuple(slice(None) if decomp.info(a) is not None else slice(1, -1)
                for a in range(x.ndim))
    return x[idx]


def _neighbor_sum_dd(u: jax.Array, decomp: Decomp) -> jax.Array:
    """Face-neighbor sum with compute/comm overlap (SURVEY.md §5, §7 hard
    part #2).

    The halo ``ppermute``s are issued FIRST and their contributions are
    ADDED to the boundary slices after the local stencil sum — so the bulk
    of the stencil work depends only on local data and XLA's latency-hiding
    scheduler can run it while the collective permutes are in flight. (The
    ``halo_extend_all``-then-stencil form serializes: every output element
    depends on the concatenated halo.) Numerically identical up to fp
    summation order on the boundary slices.
    """
    nd = u.ndim
    # 1. Kick off every halo exchange (2 slabs per sharded axis).
    slabs = []
    for a, ma, ndev in decomp.axes:
        v = jnp.moveaxis(u, a, 0)
        near = jax.lax.ppermute(v[-1:], ma, _perm_down(ndev))
        far = jax.lax.ppermute(v[:1], ma, _perm_up(ndev))
        slabs.append((a, jnp.moveaxis(near, 0, a), jnp.moveaxis(far, 0, a)))
    # 2. Local stencil sum with zero edges along sharded axes (unsharded
    #    axes already carry their ghost padding).
    pads = [(1, 1) if decomp.info(a) is not None else (0, 0)
            for a in range(nd)]
    total = _neighbor_sum(jnp.pad(u, pads))
    # 3. Fold the halo slabs into the boundary slices when they arrive.
    for a, near, far in slabs:
        nearc = _slice_unsharded(near, decomp)
        farc = _slice_unsharded(far, decomp)
        m = total.shape[a]
        first = tuple(slice(0, 1) if i == a else slice(None)
                      for i in range(nd))
        last = tuple(slice(m - 1, m) if i == a else slice(None)
                     for i in range(nd))
        total = total.at[first].add(nearc)
        total = total.at[last].add(farc)
    return total


def _pad_unsharded(x: jax.Array, decomp: Decomp) -> jax.Array:
    """Re-add the zero ghost ring along unsharded axes only."""
    pads = [(0, 0) if decomp.info(a) is not None else (1, 1)
            for a in range(x.ndim)]
    return jnp.pad(x, pads)


def _global_ids(shape, decomp: Decomp, arr_axis: int) -> jax.Array:
    """Global padded-grid index of every local entry along one axis.

    Sharded axis: d*m + 1 + i (the near ghost 0 is never stored).
    Unsharded axis: the local index itself (0 = ghost .. n+1 = ghost).
    """
    ids = jax.lax.broadcasted_iota(jnp.int32, shape, arr_axis)
    info = decomp.info(arr_axis)
    if info is not None:
        ma, _ = info
        ids = ids + jax.lax.axis_index(ma) * shape[arr_axis] + 1
    return ids


def _interior_mask(n: int, shape, decomp: Decomp) -> jax.Array:
    mask = None
    for a in range(len(shape)):
        ids = _global_ids(shape, decomp, a)
        if decomp.info(a) is not None:
            cond = ids <= n          # ids >= 1 always on sharded axes
        else:
            cond = (ids >= 1) & (ids <= n)
        mask = cond if mask is None else mask & cond
    return mask


def _coord_sum(shape, decomp: Decomp) -> jax.Array:
    """Sum of global coordinates — the red/black color of each point."""
    s = None
    for a in range(len(shape)):
        ids = _global_ids(shape, decomp, a)
        s = ids if s is None else s + ids
    return s


def s_residual(u, b, n, h, decomp: Decomp, sigma=0.0):
    """r = b - (A - sigma I) u on owned tiles (one overlapped halo
    exchange round per axis)."""
    nbr = _neighbor_sum_dd(u, decomp)
    ctr = _slice_unsharded(u, decomp)
    inv_h2 = 1.0 / (h * h)
    au = (2.0 * decomp.ndim * ctr - nbr) * inv_h2
    r = _slice_unsharded(b, decomp) - au + sigma * ctr
    return jnp.where(_interior_mask(n, u.shape, decomp),
                     _pad_unsharded(r, decomp), jnp.zeros_like(u))


def s_jacobi(u, b, n, h, omega, decomp: Decomp, sigma=0.0):
    r = s_residual(u, b, n, h, decomp, sigma)
    d = laplacian.diag_value(decomp.ndim, h, sigma)
    return u + (omega / d) * r


def s_rbgs(u, b, n, h, decomp: Decomp, sigma=0.0):
    """One full RB-GS sweep == the single-device sweep, exactly.

    Halos are re-exchanged between the red and black half-sweeps so black
    updates see red-updated neighbor cells across shard boundaries.
    """
    h2 = h * h
    den = 2.0 * decomp.ndim - sigma * h2
    colors = _coord_sum(u.shape, decomp) % 2
    imask = _interior_mask(n, u.shape, decomp)
    bcore = _slice_unsharded(b, decomp)
    for parity in (0, 1):
        vals = _pad_unsharded(
            (h2 * bcore + _neighbor_sum_dd(u, decomp)) / den, decomp)
        u = jnp.where(imask & (colors == parity), vals, u)
    return u


def s_smooth(u, b, n, h, *, kind, omega, sweeps, decomp: Decomp,
             sigma=0.0):
    if kind == "chebyshev":
        # Apply-only smoother: the generic Chebyshev recurrence over the
        # halo-exchanging residual — one ppermute round per application,
        # identical comm cost to Jacobi, RB-GS-class smoothing. No sweep-
        # order coupling across shards, so sharded == unsharded exactly.
        diag = laplacian.diag_value(decomp.ndim, h, sigma)
        return smoothers.chebyshev_generic(
            u, b, sweeps, diag,
            lambda uu, bb: s_residual(uu, bb, n, h, decomp, sigma))
    for _ in range(sweeps):
        if kind == "jacobi":
            u = s_jacobi(u, b, n, h, omega, decomp, sigma)
        elif kind == "rbgs":
            u = s_rbgs(u, b, n, h, decomp, sigma)
        else:
            raise ValueError(f"unknown smoother {kind!r}")
    return u


def s_restrict(r, n, decomp: Decomp):
    """Full-weighting to the coarse owned tile — d separable axis passes.

    Sharded axis (owned entries, m -> m/2): coarse owned entry q (global
    jc = d*mc + 1 + q) reads fine extended entries 2q+1, 2q+2, 2q+3 —
    i.e. only the far halo. Unsharded axes reuse the single-device pass.
    """
    nc = (n - 1) // 2
    for a in transfer._axis_order(r.ndim):
        info = decomp.info(a)
        if info is None:
            r = transfer._restrict_axis(r, a)
        else:
            ma, nd = info
            v = jnp.moveaxis(r, a, 0)
            m = v.shape[0]
            mc = m // 2
            # Only the FAR halo is read (coarse q reads fine 2q+1..2q+3,
            # i.e. owned entries plus the next neighbor's first row for
            # q = mc-1). Issue the ppermute first and fold it in as an
            # additive fixup so the bulk sum overlaps the exchange.
            far = jax.lax.ppermute(v[:1], ma, _perm_up(nd))
            third = jnp.pad(v[2::2], [(0, 1)] + [(0, 0)] * (v.ndim - 1))
            w = 0.25 * (v[0:m - 1:2] + 2.0 * v[1:m:2] + third)
            w = w.at[mc - 1:mc].add(0.25 * far)
            r = jnp.moveaxis(w, 0, a)
    mask = _interior_mask(nc, r.shape, decomp)
    return jnp.where(mask, r, jnp.zeros_like(r))


def s_prolong(e, nc, decomp: Decomp):
    """(Bi/tri)linear interpolation to the fine owned tile — d separable
    axis passes.

    Sharded axis (mc -> 2*mc owned entries): fine owned entry i (global
    f = d*m + 1 + i): even f -> coarse entry f/2 (extended index (i+1)/2),
    odd f -> average of its two coarse neighbors — i.e. only the near halo.
    """
    n = 2 * nc + 1
    for a in transfer._axis_order(e.ndim):
        info = decomp.info(a)
        if info is None:
            e = transfer._prolong_axis(e, a)
        else:
            ma, nd = info
            v = jnp.moveaxis(e, a, 0)
            mc = v.shape[0]
            # Only the NEAR halo is read (fine owned entry 0 is odd and
            # averages coarse entries on both sides of the boundary);
            # overlapped additive fixup as in s_restrict.
            near = jax.lax.ppermute(v[-1:], ma, _perm_down(nd))
            prev = jnp.pad(v[: mc - 1],
                           [(1, 0)] + [(0, 0)] * (v.ndim - 1))
            odd_f = 0.5 * (prev + v)                   # fine i = 0, 2, ...
            odd_f = odd_f.at[0:1].add(0.5 * near)
            # Interleave via stack+reshape — contiguous, no strided
            # scatter.
            out = jnp.stack([odd_f, v], axis=1).reshape(
                (2 * mc,) + v.shape[1:])
            e = jnp.moveaxis(out, 0, a)
    mask = _interior_mask(n, e.shape, decomp)
    return jnp.where(mask, e, jnp.zeros_like(e))


# Static-unroll block map and the full-precision matrix product, single-
# sourced in solvers.eigen next to the shared drivers.
from ..solvers.eigen import HIGHEST, _stack_map, mm


def _psum_sq(x, decomp: Decomp):
    return jax.lax.psum(jnp.sum(x * x), decomp.mesh_axes)


# ---------------------------------------------------------------------------
# The sharded cycle: sharded fine levels, replicated (agglomerated) coarse
# levels, all inside one shard_map region.
# ---------------------------------------------------------------------------

def _level_rows(k: int, level: int) -> int:
    """Sharded entry count (interior + far ghost) at a level: 2^(k-level)."""
    return 2 ** (k - level)


def _is_sharded(cfg: SolverConfig, decomp: Decomp, level: int) -> bool:
    # The coarsest level is ALWAYS replicated (its direct solve runs on
    # every device) — without this, a small mesh with small agglom_rows
    # could leave the last level "sharded" and the cycle would recurse
    # past the hierarchy (e.g. k=5 on a 2x2 mesh: the 4-row coarsest
    # level splits 2/device >= agglom_rows).
    if level >= len(cfg.level_sizes()) - 1:
        return False
    rows = _level_rows(cfg.k, level)
    for _, _, nd in decomp.axes:
        if rows % nd != 0 or rows // nd < max(cfg.agglom_rows, 2):
            return False
    return True


def _gather_full(u_local, decomp: Decomp):
    """Owned tiles -> replicated full padded grid (the agglomeration step)."""
    for a, ma, _ in decomp.axes:
        u_local = jax.lax.all_gather(u_local, ma, axis=a, tiled=True)
    pads = [(1, 0) if decomp.info(a) is not None else (0, 0)
            for a in range(u_local.ndim)]
    return jnp.pad(u_local, pads)       # re-add the near ghosts


def _scatter_local(full, decomp: Decomp):
    """Replicated full padded grid -> my owned tile."""
    for a, ma, nd in decomp.axes:
        m = (full.shape[a] - 1) // nd
        d = jax.lax.axis_index(ma)
        full = jax.lax.dynamic_slice_in_dim(full, d * m + 1, m, axis=a)
    return full


def _sharded_v_cycle(hier: Hierarchy, cfg: SolverConfig, decomp: Decomp,
                     x, b, level: int, gamma: int = 1, sigma=0.0):
    """Recursive cycle; per-level arrays are owned tiles while the level is
    sharded and full replicated grids below the agglomeration cutoff.
    ``sigma`` shifts the operator to A - sigma*I (eigensolver inner
    solves, SURVEY.md §3.3)."""
    spec = hier.levels[level]
    n, h = spec.n, spec.h
    omega = cfg.effective_omega()
    if not _is_sharded(cfg, decomp, level):
        # Replicated region: identical unsharded cycle on every device.
        return cycles.v_cycle(hier, x, b, cfg, level=level,
                              gamma=gamma, sigma=sigma)
    x = s_smooth(x, b, n, h, kind=cfg.smoother, omega=omega,
                 sweeps=cfg.nu1, decomp=decomp, sigma=sigma)
    r = s_residual(x, b, n, h, decomp, sigma)
    rc = s_restrict(r, n, decomp)
    x = x + _coarse_correction(hier, cfg, decomp, rc, level, gamma, sigma)
    return s_smooth(x, b, n, h, kind=cfg.smoother, omega=omega,
                    sweeps=cfg.nu2, decomp=decomp, sigma=sigma)


def _coarse_correction(hier, cfg, decomp, rc, level, gamma, sigma):
    """gamma coarse cycles on the restricted RHS, prolonged back to this
    level's owned tiles."""
    nc = hier.levels[level + 1].n
    if not _is_sharded(cfg, decomp, level + 1):
        # Agglomerate: gather the coarse RHS, recurse replicated, scatter.
        rc_full = _gather_full(rc, decomp)
        ec_full = jnp.zeros_like(rc_full)
        for _ in range(gamma):
            ec_full = cycles.v_cycle(hier, ec_full, rc_full, cfg,
                                     level=level + 1, gamma=gamma,
                                     sigma=sigma)
        return _scatter_local(transfer.prolong(ec_full), decomp)
    ec = jnp.zeros_like(rc)
    for _ in range(gamma):
        ec = _sharded_v_cycle(hier, cfg, decomp, ec, rc,
                              level + 1, gamma, sigma)
    return s_prolong(ec, nc, decomp)


def _sharded_fmg(hier: Hierarchy, cfg: SolverConfig, decomp: Decomp,
                 b, gamma: int = 1, n_vcycles: int = 1):
    """Distributed full multigrid (SURVEY.md §3.2 on the §3.5 runtime).

    The RHS is restricted down through the sharded levels (halo ppermute),
    gathered at the agglomeration cutoff, direct-solved replicated on the
    coarsest level, and the solution walked back up — scattered into owned
    tiles when it re-enters the sharded region — with ``n_vcycles``
    distributed V-cycles per level.
    """
    bs = [b]
    for lev in range(hier.num_levels - 1):
        if _is_sharded(cfg, decomp, lev):
            if _is_sharded(cfg, decomp, lev + 1):
                bs.append(s_restrict(bs[-1], hier.levels[lev].n, decomp))
            else:  # crossing the agglomeration cutoff
                full = _gather_full(bs[-1], decomp)
                bs.append(transfer.restrict(full))
        else:
            bs.append(transfer.restrict(bs[-1]))
    # The coarsest level is always replicated (agglom_rows >= 2 guarantees
    # tiny levels fail _is_sharded).
    x = cycles.coarse_solve(hier, bs[-1])
    for level in range(hier.num_levels - 2, -1, -1):
        if _is_sharded(cfg, decomp, level):
            if _is_sharded(cfg, decomp, level + 1):
                x = s_prolong(x, hier.levels[level + 1].n, decomp)
            else:  # re-entering the sharded region
                xf_full = transfer.prolong(x)
                x = _scatter_local(xf_full, decomp)
        else:
            x = transfer.prolong(x)
        for _ in range(n_vcycles):
            x = _sharded_v_cycle(hier, cfg, decomp, x, bs[level],
                                 level, gamma)
    return x


# ---------------------------------------------------------------------------
# Host-side driver
# ---------------------------------------------------------------------------

def _to_global(host_array, sharding: NamedSharding) -> jax.Array:
    """Process-safe ``device_put``: build a global sharded array from a
    host array that every process holds in full (SPMD replicated input).

    ``jax.make_array_from_callback`` asks each process for the data of its
    *addressable* shards only, so this works identically under the
    single-controller runtime here and under true multi-process
    ``jax.distributed`` (where a global ``device_put`` would throw on
    non-addressable devices)."""
    arr = np.asarray(host_array)
    return jax.make_array_from_callback(arr.shape, sharding,
                                        lambda idx: arr[idx])


def _to_host(x: jax.Array) -> np.ndarray:
    """Process-safe ``device_get`` of a global sharded array.

    Fully-addressable arrays (single-process runs) fetch directly;
    otherwise the value is assembled by an across-process allgather
    (every host ends up with the full array, matching the single-process
    contract of ``unshard``)."""
    if x.is_fully_addressable:
        return np.asarray(jax.device_get(x))
    from jax.experimental import multihost_utils

    return np.asarray(multihost_utils.process_allgather(x, tiled=True))


def shard_rhs(b_padded: jax.Array, mesh: Mesh,
              decomp: Optional[Decomp] = None):
    """Global padded RHS -> device-sharded owned tiles.

    Along each sharded axis the near ghost (index 0) is dropped; entries
    1..n+1 are laid out contiguously over the mesh so each device holds
    its m owned entries. Unsharded axes keep the full padded extent.
    ``b_padded`` is host data every process holds in full.
    """
    if decomp is None:
        decomp = decomp_from_mesh(mesh, b_padded.ndim)
    sl = tuple(slice(1, None) if decomp.info(a) is not None else slice(None)
               for a in range(b_padded.ndim))
    return _to_global(np.asarray(b_padded)[sl],
                      NamedSharding(mesh, decomp.spec()))


def unshard(x_tiles: jax.Array, decomp: Optional[Decomp] = None):
    """Sharded owned tiles -> global padded array (re-adds near ghosts)."""
    x = _to_host(x_tiles)
    if decomp is None:         # legacy row layout: first axis sharded
        pads = [(1, 0)] + [(0, 0)] * (x.ndim - 1)
    else:
        pads = [(1, 0) if decomp.info(a) is not None else (0, 0)
                for a in range(x.ndim)]
    return jnp.pad(jnp.asarray(x), pads)


class ShardedSolver:
    """Distributed MultigridSolver: domain-decomposed V-cycles to tolerance.

    The decomposition follows the mesh: a 1D mesh shards axis 0 (rows /
    slabs), a 2D mesh shards axes 0 and 1 (blocks / pencils).

    >>> mesh = make_mesh()                       # rows
    >>> s = ShardedSolver(SolverConfig(ndim=2, k=12, smoother="rbgs"), mesh)
    >>> result = s.solve(b_padded)               # b as a plain padded array

    >>> mesh = make_block_mesh((4, 2))           # 4x2 blocks
    >>> s = ShardedSolver(SolverConfig(ndim=2, k=12, smoother="rbgs"), mesh)
    """

    def __init__(self, config: SolverConfig, mesh: Mesh,
                 hierarchy: Optional[Hierarchy] = None):
        self.config = config
        self.mesh = mesh
        self.decomp = decomp_from_mesh(mesh, config.ndim)
        self.ndev = int(np.prod(mesh.devices.shape))
        for _, ma, nd in self.decomp.axes:
            if (2 ** config.k) % nd != 0:
                raise ValueError(f"2^k must be divisible by the mesh size "
                                 f"along {ma!r} ({nd})")
        if not _is_sharded(config, self.decomp, 0):
            raise ValueError(
                f"fine level would be agglomerated: local tile of "
                f"{_level_rows(config.k, 0)} rows over the mesh is below "
                f"agglom_rows={config.agglom_rows}; raise k, shrink the "
                f"mesh, or lower agglom_rows")
        self.hierarchy = (hierarchy if hierarchy is not None
                          else build_hierarchy(config))
        # Jitted solve entry points, built once and cached (a retrace
        # recompiles the whole solve). Keys: ("mg", skip_fmg) / ("pcg",).
        self._solve_fns = {}

    def _build_solve(self, skip_fmg: bool = False):
        cfg = self.config
        hier = self.hierarchy
        decomp = self.decomp
        gamma = 2 if cfg.cycle == "w" else 1

        def local_solve(b, x0):
            if cfg.cycle == "fmg" and not skip_fmg:
                # FMG is a direct method (cycles.solve semantics): run it
                # once, then polish with V-cycles if tol asks for more.
                x = _sharded_fmg(hier, cfg, decomp, b)
            else:
                # Warm start (checkpoint resume): the V-cycle iteration is
                # a fixed-point map, so restarting from a saved x is the
                # same algorithm the uninterrupted solve runs. A resumed
                # FMG solve skips the (already-done) FMG leg and keeps
                # polishing with V-cycles from x0.
                x = x0
            n, h = hier.fine.n, hier.fine.h
            b_norm = jnp.sqrt(_psum_sq(b, decomp))
            b_norm = jnp.where(b_norm == 0, 1.0, b_norm)

            def res_rel(xx):
                return jnp.sqrt(_psum_sq(s_residual(xx, b, n, h, decomp),
                                         decomp)) / b_norm

            r0 = res_rel(x)
            hist0 = jnp.full((cfg.max_iters + 1,), r0, dtype=b.dtype)

            # Stall + divergence guards, as in cycles.solve.
            def cond(st):
                _, k_it, _, rel, stall, div = st
                return ((rel >= cfg.tol) & (k_it < cfg.max_iters)
                        & cycles.guards_ok(stall, div))

            def body(st):
                x, k_it, hist, rel, stall, div = st
                x = _sharded_v_cycle(hier, cfg, decomp, x, b, 0, gamma)
                new_rel = res_rel(x)
                stall, div = cycles.step_guards(new_rel, rel, stall, div)
                hist = hist.at[k_it + 1].set(new_rel)
                return x, k_it + 1, hist, new_rel, stall, div

            x, iters, hist, rel, _, _ = jax.lax.while_loop(
                cond, body, (x, 0, hist0, r0, 0, 0))
            idx = jnp.arange(cfg.max_iters + 1)
            hist = jnp.where(idx <= iters, hist, rel)
            return x, iters, hist, rel < cfg.tol

        from jax import shard_map

        sharded = shard_map(
            local_solve, mesh=self.mesh,
            in_specs=(decomp.spec(), decomp.spec()),
            out_specs=(decomp.spec(), P(), P(), P()),
            check_vma=False,
        )
        return jax.jit(sharded)

    def _build_pcg(self):
        """Distributed MG-PCG (the sharded twin of solvers/krylov.py):
        one distributed V-cycle per iteration as the preconditioner, all
        dot products psum-ed over the mesh, flexible (Polak-Ribiere) beta
        for the not-exactly-symmetric RB-GS cycle."""
        cfg = self.config
        hier = self.hierarchy
        decomp = self.decomp
        gamma = 2 if cfg.cycle == "w" else 1
        n, h = hier.fine.n, hier.fine.h

        from ..solvers.krylov import cg_loop

        def local_pcg(b, x0):
            def pdot(u, v):
                return jax.lax.psum(jnp.sum(u * v), decomp.mesh_axes)

            def apply_a(p):
                return -s_residual(p, jnp.zeros_like(p), n, h, decomp)

            def precond(r):
                return _sharded_v_cycle(hier, cfg, decomp, jnp.zeros_like(r),
                                        r, 0, gamma)

            x, iters, hist, rel = cg_loop(
                x0, b, dot=pdot, apply_a=apply_a,
                precond=precond,
                residual=lambda xx, bb: s_residual(xx, bb, n, h, decomp),
                tol=cfg.tol, max_iters=cfg.max_iters)
            return x, iters, hist, rel < cfg.tol

        from jax import shard_map

        sharded = shard_map(
            local_pcg, mesh=self.mesh,
            in_specs=(decomp.spec(), decomp.spec()),
            out_specs=(decomp.spec(), P(), P(), P()),
            check_vma=False,
        )
        return jax.jit(sharded)

    def solve(self, b_padded: jax.Array, x0: Optional[jax.Array] = None,
              method: str = "mg") -> cycles.SolveResult:
        """Solve A x = b on the mesh.

        ``x0`` (a plain padded array, like ``b_padded``) warm-starts the
        iteration — the checkpoint/resume entry point for long multi-host
        runs (``utils.checkpoint.resume_solve``; SURVEY.md §5). With
        ``cycle="fmg"`` a warm start skips the FMG leg and polishes from
        ``x0`` with V-cycles.
        """
        if method == "pcg":
            key = ("pcg",)
            build = self._build_pcg
        elif method == "mg":
            # The FMG skip is a static branch: a separate trace only when
            # an fmg config is actually resumed.
            skip_fmg = x0 is not None and self.config.cycle == "fmg"
            key = ("mg", skip_fmg)
            build = partial(self._build_solve, skip_fmg)
        else:
            raise ValueError(f"unknown solve method {method!r}")
        fn = self._solve_fns.get(key)
        if fn is None:
            fn = self._solve_fns[key] = build()
        b_sh = shard_rhs(jnp.asarray(b_padded, dtype=self.config.dtype),
                         self.mesh, self.decomp)
        if x0 is None:
            x0_sh = jnp.zeros_like(b_sh)
        else:
            # Sanitize like cycles.solve: the ops rely on the zero-ghost
            # invariant, so strip whatever boundary the caller supplied.
            x0p = pad_interior(interior(
                jnp.asarray(x0, dtype=self.config.dtype)))
            x0_sh = shard_rhs(x0p, self.mesh, self.decomp)
        x, iters, hist, conv = fn(b_sh, x0_sh)
        return cycles.SolveResult(
            x=jnp.asarray(unshard(x, self.decomp)), iters=iters,
            res_history=hist, converged=conv)

    def eigensolve(self, k: int = 1, method: str = "ii", tol: float = 1e-8,
                   max_iters: int = 100, inner_cycles: int = 30,
                   inner_tol: Optional[float] = None,
                   v0: Optional[jax.Array] = None):
        """Distributed MG eigensolver: k smallest eigenpairs (SURVEY.md
        §3.3 on the §3.5 runtime).

        Same algorithm as solvers.eigen.eigensolve — nested-iteration
        coarse init, block inverse iteration (or RQI shifts) with the
        inner solves done by distributed V-cycles, Rayleigh-Ritz per
        outer step — with every inner product ``psum``-ed over the mesh
        (BASELINE.json:5 "psum for ... Rayleigh quotients"). Eigenvector
        tiles stay domain-partitioned end-to-end.
        """
        from ..solvers import eigen as seigen

        if method == "lobpcg":
            return self._eigensolve_lobpcg(k=k, tol=tol,
                                           max_iters=max_iters, v0=v0)
        if method not in ("ii", "rqi"):
            raise ValueError(f"unknown eigensolver method {method!r}")
        cfg, hier, decomp = self.config, self.hierarchy, self.decomp
        mesh_axes = decomp.mesh_axes
        n, h = hier.fine.n, hier.fine.h
        dtype = cfg.dtype
        if inner_tol is None:
            inner_tol = 200.0 * float(jnp.finfo(dtype).eps)

        def apply_local(u):
            """A u on owned tiles (one halo exchange round)."""
            return -s_residual(u, jnp.zeros_like(u), n, h, decomp)

        def psum_dots(f, g):
            """(k, k) Gram-type matrix of flattened local tiles."""
            return jax.lax.psum(
                jnp.einsum("iX,jX->ij", f, g, precision=HIGHEST,
                           preferred_element_type=dtype), mesh_axes)

        def flat(v):
            return v.reshape(v.shape[0], -1)

        def rayleigh(v):
            av = _stack_map(apply_local, v)
            fv, fav = flat(v), flat(av)
            num = jax.lax.psum(jnp.sum(fv * fav, axis=1), mesh_axes)
            den = jax.lax.psum(jnp.sum(fv * fv, axis=1), mesh_axes)
            lam = num / den
            rr = fav - lam[:, None] * fv
            res = jnp.sqrt(jax.lax.psum(jnp.sum(rr * rr, axis=1),
                                        mesh_axes)) / jnp.abs(lam)
            return lam, jnp.max(res)

        def inner_solve(v, sigma):
            def one(rhs, sg):
                rn = jnp.sqrt(jax.lax.psum(jnp.sum(rhs * rhs), mesh_axes))
                rn = jnp.where(rn == 0, 1.0, rn)

                def cond(st):
                    w, i, rel = st
                    return (rel >= inner_tol) & (i < inner_cycles)

                def body(st):
                    w, i, rel = st
                    w = _sharded_v_cycle(hier, cfg, decomp, w, rhs, 0,
                                         sigma=sg)
                    r = s_residual(w, rhs, n, h, decomp, sg)
                    rel = jnp.sqrt(jax.lax.psum(jnp.sum(r * r),
                                                mesh_axes)) / rn
                    return w, i + 1, rel

                w, _, _ = jax.lax.while_loop(
                    cond, body,
                    (jnp.zeros_like(rhs), 0, jnp.ones((), dtype=dtype)))
                return w

            return _stack_map(one, v, sigma)

        def ritz(w):
            """Generalized Rayleigh-Ritz on the (non-orthonormal) block:
            H s = theta G s via Cholesky of the psum-ed Gram matrix.
            Rows are pre-normalized: RQI inner solves return vectors of
            wildly different magnitudes (1/|lambda - sigma| growth), and
            an unequilibrated Gram matrix wrecks the Cholesky."""
            nrm0 = jnp.sqrt(jax.lax.psum(
                jnp.sum(flat(w) * flat(w), axis=1), mesh_axes))
            scale = jnp.where(nrm0 == 0, 1.0, nrm0)
            w = w / scale.reshape((k,) + (1,) * (w.ndim - 1))
            f = flat(w)
            aw = flat(_stack_map(apply_local, w))
            g = psum_dots(f, f)
            hm = psum_dots(f, aw)
            hm = 0.5 * (hm + hm.T)
            ell = jnp.linalg.cholesky(g)
            li = jax.scipy.linalg.solve_triangular(
                ell, jnp.eye(k, dtype=dtype), lower=True)
            ht = mm(mm(li, hm), li.T)
            lam, s = jnp.linalg.eigh(0.5 * (ht + ht.T))
            rot = mm(li.T, s).T                    # (k, k): rows are Ritz
            f2 = mm(rot, f)
            # Normalize rows (Ritz vectors of a symmetric pencil come out
            # G-orthonormal, i.e. already unit — this guards roundoff).
            nrm = jnp.sqrt(jax.lax.psum(jnp.sum(f2 * f2, axis=1),
                                        mesh_axes))
            f2 = f2 / nrm[:, None]
            return f2.reshape(w.shape), lam

        def local_eigen(v):
            # Outer recurrence + RQI shift schedule live in the shared
            # driver (solvers.eigen.ii_loop — single source of
            # RQI_ACTIVE_TOL/RQI_POLISH_TOL/RQI_BACKOFF).
            def inner(vv, sigma):
                if sigma is None:
                    sigma = jnp.zeros((k,), dtype=dtype)
                return inner_solve(vv, sigma)

            v, lam, iters, hist, res = seigen.ii_loop(
                v, rayleigh=rayleigh, inner_solve=inner, ritz=ritz,
                method=method, tol=tol, max_iters=max_iters, dtype=dtype)
            return v, lam, iters, hist, res < tol

        from jax import shard_map

        key = ("eigen", method, k, tol, max_iters, inner_cycles,
               inner_tol)
        fn = self._solve_fns.get(key)
        if fn is None:
            fn = self._solve_fns[key] = jax.jit(shard_map(
                local_eigen, mesh=self.mesh,
                in_specs=decomp.spec(leading_none=1),
                out_specs=(decomp.spec(leading_none=1), P(), P(), P(),
                           P()),
                check_vma=False,
            ))

        # Nested-iteration start (replicated, host-side setup as in the
        # single-device path) — or a caller-supplied warm start
        # (checkpoint resume) — sharded into owned tiles. The block is
        # re-orthonormalized by the first Ritz step, so any spanning set
        # works; ghosts are sanitized per the zero-ghost invariant.
        if v0 is None:
            v0 = seigen.coarse_init(self.hierarchy, k, dtype)
        else:
            v0 = jax.vmap(lambda u: pad_interior(interior(u)))(
                jnp.asarray(v0, dtype))
        sl = (slice(None),) + tuple(
            slice(1, None) if decomp.info(a) is not None else slice(None)
            for a in range(cfg.ndim))
        v0_sh = _to_global(
            np.asarray(v0)[sl],
            NamedSharding(self.mesh, decomp.spec(leading_none=1)))
        v, lam, iters, hist, conv = fn(v0_sh)
        pads = [(0, 0)] + [(1, 0) if decomp.info(a) is not None else (0, 0)
                           for a in range(cfg.ndim)]
        v_full = np.pad(_to_host(v), pads)
        return seigen.EigenResult(
            eigenvalues=lam, eigenvectors=jnp.asarray(v_full), iters=iters,
            res_history=hist, converged=conv)

    def _eigensolve_lobpcg(self, k: int, tol: float, max_iters: int,
                           precond_cycles: int = 1,
                           v0: Optional[jax.Array] = None):
        """Distributed MG-preconditioned LOBPCG (the sharded twin of
        solvers/eigen.lobpcg): Rayleigh-Ritz on span{X, T R, P} with T one
        distributed V-cycle, every Gram matrix psum-ed over the mesh, the
        tiny (3k)^2 eigenproblem solved replicated on every device.
        """
        from ..solvers import eigen as seigen

        cfg, hier, decomp = self.config, self.hierarchy, self.decomp
        mesh_axes = decomp.mesh_axes
        n, h = hier.fine.n, hier.fine.h
        dtype = cfg.dtype
        lam_shape = (k,) + (1,) * cfg.ndim

        def apply_local(u):
            return -s_residual(u, jnp.zeros_like(u), n, h, decomp)

        def flat(v):
            return v.reshape(v.shape[0], -1)

        def gram(f, g):
            return jax.lax.psum(
                jnp.einsum("iX,jX->ij", flat(f), flat(g), precision=HIGHEST,
                           preferred_element_type=dtype), mesh_axes)

        def rownorms(v):
            return jnp.sqrt(jax.lax.psum(
                jnp.sum(flat(v) * flat(v), axis=1), mesh_axes))

        def rq_res(v):
            """Rayleigh quotients + residual tiles of an orthonormal
            block."""
            av = _stack_map(apply_local, v)
            lam = jax.lax.psum(jnp.sum(flat(v) * flat(av), axis=1),
                               mesh_axes)
            r = av - lam.reshape(lam_shape) * v
            res = rownorms(r) / jnp.abs(lam)
            return lam, r, jnp.max(res)

        def tcycle(r):
            def one(rhs):
                w = jnp.zeros_like(rhs)
                for _ in range(precond_cycles):
                    w = _sharded_v_cycle(hier, cfg, decomp, w, rhs, 0)
                return w

            return _stack_map(one, r)

        def project_out(f, basis):
            for _ in range(2):
                f = f - jnp.einsum("ij,j...->i...", gram(f, basis), basis,
                                   precision=HIGHEST)
            return f

        def safe_rownorm(v, salt):
            """Normalize rows over the mesh; replace dead rows by a
            deterministic global pseudo-random interior field (identical
            on every device by construction from global coordinates)."""
            nrm = rownorms(v)
            eps = jnp.finfo(dtype).eps
            gsum = _coord_sum(v.shape[1:], decomp).astype(dtype)
            rows = jnp.arange(k, dtype=dtype).reshape(lam_shape)
            imask = _interior_mask(n, v.shape[1:], decomp)
            fb = jnp.sin((salt + 1.0) * (rows + 1.0)
                         + 0.7391 * gsum) * imask.astype(dtype)
            fb = fb / rownorms(fb).reshape(lam_shape)
            good = (nrm > eps * eps).reshape(lam_shape)
            return jnp.where(good, v / jnp.where(
                good, nrm.reshape(lam_shape), 1.0), fb)

        def rr(s, nkeep):
            m = s.shape[0]
            g = gram(s, s)
            hm = gram(s, _stack_map(apply_local, s))
            hm = 0.5 * (hm + hm.T)
            eps = jnp.asarray(jnp.finfo(dtype).eps, dtype)
            jit_g = g + (100.0 * eps * jnp.trace(g)) * jnp.eye(m,
                                                               dtype=dtype)
            ell = jnp.linalg.cholesky(jit_g)
            li = jax.scipy.linalg.solve_triangular(
                ell, jnp.eye(m, dtype=dtype), lower=True)
            ht = mm(mm(li, hm), li.T)
            theta, y = jnp.linalg.eigh(0.5 * (ht + ht.T))
            c = mm(li.T, y[:, :nkeep])
            return c, theta[:nkeep]

        def combine(c, s):
            """Rows of c^T s as tiles: (m, nkeep)^T x (m, *tile)."""
            return jnp.einsum("mi,m...->i...", c, s, precision=HIGHEST)

        def local_lobpcg(v):
            # orthonormalize the prolonged coarse start over the mesh;
            # the recurrence itself is the shared driver
            # (solvers.eigen.lobpcg_loop).
            g0 = gram(v, v)
            ell0 = jnp.linalg.cholesky(
                g0 + 100.0 * jnp.finfo(dtype).eps * jnp.trace(g0)
                * jnp.eye(k, dtype=dtype))
            li0 = jax.scipy.linalg.solve_triangular(
                ell0, jnp.eye(k, dtype=dtype), lower=True)
            x = combine(li0.T, v)

            x, lam, iters, hist, res = seigen.lobpcg_loop(
                x, k=k, rq_res=rq_res, tcycle=tcycle,
                project_out=project_out, safe_rownorm=safe_rownorm,
                rr=rr, combine=combine, tol=tol, max_iters=max_iters,
                dtype=dtype)
            return x, lam, iters, hist, res < tol

        from jax import shard_map

        key = ("lobpcg", k, tol, max_iters, precond_cycles)
        fn = self._solve_fns.get(key)
        if fn is None:
            fn = self._solve_fns[key] = jax.jit(shard_map(
                local_lobpcg, mesh=self.mesh,
                in_specs=decomp.spec(leading_none=1),
                out_specs=(decomp.spec(leading_none=1), P(), P(), P(),
                           P()),
                check_vma=False,
            ))

        if v0 is None:
            v0 = seigen.coarse_init(self.hierarchy, k, dtype)
        else:
            v0 = jax.vmap(lambda u: pad_interior(interior(u)))(
                jnp.asarray(v0, dtype))
        sl = (slice(None),) + tuple(
            slice(1, None) if decomp.info(a) is not None else slice(None)
            for a in range(cfg.ndim))
        v0_sh = _to_global(
            np.asarray(v0)[sl],
            NamedSharding(self.mesh, decomp.spec(leading_none=1)))
        v, lam, iters, hist, conv = fn(v0_sh)
        pads = [(0, 0)] + [(1, 0) if decomp.info(a) is not None else (0, 0)
                           for a in range(cfg.ndim)]
        v_full = np.pad(_to_host(v), pads)
        return seigen.EigenResult(
            eigenvalues=lam, eigenvectors=jnp.asarray(v_full), iters=iters,
            res_history=hist, converged=conv)

    def v_cycle_fn(self):
        """The jitted sharded cycle (for benchmarking): tiles -> tiles."""
        cfg, hier, decomp = self.config, self.hierarchy, self.decomp
        gamma = 2 if cfg.cycle == "w" else 1

        def one_cycle(x, b):
            return _sharded_v_cycle(hier, cfg, decomp, x, b, 0, gamma)

        from jax import shard_map

        return jax.jit(shard_map(
            one_cycle, mesh=self.mesh,
            in_specs=(decomp.spec(), decomp.spec()),
            out_specs=decomp.spec(), check_vma=False))

    def v_cycles_fn(self):
        """jitted fn(x_tiles, b_tiles, m) -> x_tiles: m CHAINED cycles in
        one dispatch — what the solve loop actually runs per iteration."""
        cfg, hier, decomp = self.config, self.hierarchy, self.decomp
        gamma = 2 if cfg.cycle == "w" else 1

        def many(x, b, mreps):
            def body(i, xx):
                return _sharded_v_cycle(hier, cfg, decomp, xx, b, 0,
                                        gamma)

            return jax.lax.fori_loop(0, mreps, body, x)

        from jax import shard_map

        return jax.jit(shard_map(
            many, mesh=self.mesh,
            in_specs=(decomp.spec(), decomp.spec(), P()),
            out_specs=decomp.spec(), check_vma=False))
