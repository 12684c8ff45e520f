"""Inter-grid transfer operators: full-weighting restriction and
(bi)linear interpolation.

Capability parity with the reference's transfer operators (SURVEY.md §2):
  * full-weighting restriction — 1D stencil ``[1, 2, 1]/4``, 2D 9-point
    ``[1,2,1; 2,4,2; 1,2,1]/16`` — mapping a ``2^k - 1`` interior grid to
    ``2^(k-1) - 1``;
  * linear (1D) / bilinear (2D) prolongation, the transpose relation being
    ``P = 2^d R^T`` (exploited by the tests).

Both operators are separable, so the 2D versions are two 1D passes (axis 0
then axis 1). Each 1D pass is a strided gather-free shift-and-add over the
padded array, which XLA fuses into one pass over device memory. Grids are padded with a one-cell zero
ghost boundary (see `grids.py`); restriction and prolongation both consume
the padding, which makes every formula branch-free (the ghost zeros ARE the
homogeneous Dirichlet boundary values the stencil needs).

Index convention (1-based over the padded array): fine interior 1..n maps to
coarse interior 1..nc with n = 2*nc + 1; coarse point j sits at fine point
2j (vertex-centered coarsening, matching the reference's 1023 → 511 → ...
level sizes).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp


def _restrict_axis0_1d(f: jax.Array) -> jax.Array:
    """Full-weighting along a 1D padded array: (n+2,) -> (nc+2,)."""
    # Fine interior values, 0-based index i <-> 1-based fine point i+1.
    core = f[1:-1]                      # length n = 2*nc + 1
    centers = core[1::2]                # fine points 2, 4, ..., 2*nc
    edges = core[0::2]                  # fine points 1, 3, ..., 2*nc + 1
    rc = 0.25 * (edges[:-1] + 2.0 * centers + edges[1:])
    return jnp.pad(rc, 1)


# Minor-axis transfer passes on LARGE 3D grids run as banded-matrix
# matmuls instead of stride-2 slice arithmetic, which spends ~n flops per
# useful element to avoid a strided relayout of the minor axes. Whether
# this beats plain strided slicing on the GPU has not been measured yet
# (an open item). Gated to ndim == 3 so the pinned 2D numerics
# (tests/reference_impl.py step-for-step) are untouched; axis 0 (major)
# stays on the sliced path everywhere, which also keeps sharded-axis and
# unsharded-axis arithmetic identical (the sharded == unsharded exactness
# tests).
_MM_MIN_N = 64


def _restrict_matrix(n: int, dtype):
    """(nc+2, n+2) full-weighting matrix over PADDED axes: coarse j reads
    fine 2j-1..2j+1 with weights [1,2,1]/4; ghost rows are zero."""
    nc = (n - 1) // 2
    j = jax.lax.broadcasted_iota(jnp.int32, (nc + 2, n + 2), 0)
    i = jax.lax.broadcasted_iota(jnp.int32, (nc + 2, n + 2), 1)
    interior = (j >= 1) & (j <= nc)
    w = (jnp.where(i == 2 * j, 0.5, 0.0)
         + jnp.where((i == 2 * j - 1) | (i == 2 * j + 1), 0.25, 0.0))
    return jnp.where(interior, w, 0.0).astype(dtype)


def _prolong_matrix(nc: int, dtype):
    """(n+2, nc+2) linear-interpolation matrix over PADDED axes: fine 2j
    reads coarse j; odd fine rows average their neighbors (padded ghost
    zeros supply the boundary halves); ghost rows are zero."""
    n = 2 * nc + 1
    i = jax.lax.broadcasted_iota(jnp.int32, (n + 2, nc + 2), 0)
    j = jax.lax.broadcasted_iota(jnp.int32, (n + 2, nc + 2), 1)
    interior = (i >= 1) & (i <= n)
    w = (jnp.where(i == 2 * j, 1.0, 0.0)
         + jnp.where((i == 2 * j - 1) | (i == 2 * j + 1), 0.5, 0.0))
    return jnp.where(interior, w, 0.0).astype(dtype)


def _use_mm(f: jax.Array, axis: int) -> bool:
    return f.ndim == 3 and axis != 0 and f.shape[axis] - 2 >= _MM_MIN_N


def _axis_mm(f: jax.Array, axis: int, mat: jax.Array) -> jax.Array:
    """Contract ``mat`` (out, in) against one minor axis of (p, r, c).

    axis 1: (q,r) x per-plane (r,c) — a batch matmul with the contraction
    on the adjacent dim, no transpose; axis 2: (pr, c) x (c, d).
    HIGHEST precision: a float32 matmul may otherwise run in a reduced
    precision (TF32 on the GPU), and the coarse-grid correction needs
    full float32 accuracy."""
    if axis == 1:
        return jnp.einsum("qr,prc->pqc", mat, f,
                          precision=jax.lax.Precision.HIGHEST)
    return jnp.einsum("prc,dc->prd", f, mat,
                      precision=jax.lax.Precision.HIGHEST)


def _restrict_axis(f: jax.Array, axis: int) -> jax.Array:
    """Full-weighting [1,2,1]/4 + coarsening along ONE axis of a padded
    array; other axes untouched. The d-dimensional full-weighting stencil
    is the tensor product of this 1D stencil (9-point/16 in 2D, 27-point/64
    in 3D), so restriction is d sequential axis passes."""
    if _use_mm(f, axis):
        return _axis_mm(f, axis, _restrict_matrix(f.shape[axis] - 2,
                                                  f.dtype))
    f = jnp.moveaxis(f, axis, 0)
    core = f[1:-1]
    centers = core[1::2]
    edges = core[0::2]
    rc = 0.25 * (edges[:-1] + 2.0 * centers + edges[1:])
    rc = jnp.pad(rc, [(1, 1)] + [(0, 0)] * (rc.ndim - 1))
    return jnp.moveaxis(rc, 0, axis)


def _axis_order(ndim: int):
    """Separable-pass order. 3D runs MINOR-FIRST (last axis first), so
    the matmul passes shrink the array 4x before the plane-sliced pass.
    1D/2D keep ascending order — their numerics are pinned
    step-for-step against the reference oracle. parallel.sharded
    mirrors this order; a SHARDED minor axis (3D pencils) still runs the
    halo'd slice pass while the unsharded twin runs the matmul, so
    pencil transfers agree with the unsharded solve to ~1e-13 relative
    (rounding order), not bit-exactly — within every pinned test
    tolerance, and tested explicitly (tests/test_sharded_jnp.py pencil
    case with _MM_MIN_N patched low)."""
    return range(ndim) if ndim < 3 else reversed(range(ndim))


def restrict(r: jax.Array) -> jax.Array:
    """Full-weighting restriction, padded fine grid -> padded coarse grid
    (any ndim: 1D [1,2,1]/4, 2D 9-point/16, 3D 27-point/64)."""
    if r.ndim == 1:
        return _restrict_axis0_1d(r)
    for ax in _axis_order(r.ndim):
        r = _restrict_axis(r, ax)
    return r


def _interleave(evens: jax.Array, odds: jax.Array, n: int) -> jax.Array:
    """rows [e0, o0, e1, o1, ...][:n] via stack+reshape — contiguous, no
    strided scatter.
    After the stack the shape is (m, 2) + tail; the reshape flattens the
    pair axis into interleaved rows."""
    out = jnp.stack([evens, odds], axis=1)
    return out.reshape((2 * evens.shape[0],) + evens.shape[1:])[:n]


def _prolong_axis0_1d(c: jax.Array) -> jax.Array:
    """Linear interpolation along a 1D padded array: (nc+2,) -> (n+2,)."""
    nc = c.shape[0] - 2
    n = 2 * nc + 1
    # 1-based fine point 2j takes the coarse value c_j; odd fine points
    # 2j+1 (j = 0..nc) average c_j and c_{j+1} — the padded ghosts
    # c[0] = c[nc+1] = 0 supply the boundary halves. Interleaved as
    # (avg_j, c_{j+1}) pairs; the trailing ghost pair is sliced off.
    fine = _interleave(0.5 * (c[:-1] + c[1:]), c[1:], n)
    return jnp.pad(fine, 1)


def _prolong_axis(c: jax.Array, axis: int) -> jax.Array:
    """Linear interpolation along ONE axis of a padded array."""
    if _use_mm(c, axis):
        return _axis_mm(c, axis, _prolong_matrix(c.shape[axis] - 2,
                                                 c.dtype))
    c = jnp.moveaxis(c, axis, 0)
    nc = c.shape[0] - 2
    n = 2 * nc + 1
    fine = _interleave(0.5 * (c[:-1] + c[1:]), c[1:], n)
    fine = jnp.pad(fine, [(1, 1)] + [(0, 0)] * (fine.ndim - 1))
    return jnp.moveaxis(fine, 0, axis)


def prolong(e: jax.Array) -> jax.Array:
    """(Bi/tri)linear prolongation, padded coarse grid -> padded fine grid
    (any ndim; the transpose relation P = 2^d R^T holds per dimension)."""
    if e.ndim == 1:
        return _prolong_axis0_1d(e)
    for ax in _axis_order(e.ndim):
        e = _prolong_axis(e, ax)
    return e


def _fmg_prolong_axis(c: jax.Array, axis: int) -> jax.Array:
    """Cubic interpolation along ONE axis of a padded array.

    FMG-order prolongation (SURVEY.md §3.2 "fmg_prolong — higher-order
    interpolation"): the coarse-to-fine *solution* walk of full multigrid
    should interpolate at higher order than the discretization so the
    interpolation error does not pollute the O(h^2) discrete solution the
    final V-cycle is meant to reach. Odd fine points take the 4-point
    cubic ``(-1, 9, 9, -1)/16``; at the domain ends the stencil's
    out-of-domain value is supplied by the *odd reflection*
    ``u(-h) = -u(h)`` that continues a homogeneous-Dirichlet solution
    smoothly through the boundary.
    """
    c = jnp.moveaxis(c, axis, 0)
    nc = c.shape[0] - 2
    n = 2 * nc + 1
    # ext[j] == c[j-1] for j = 0..nc+3, with the reflected values at the
    # two out-of-domain slots: c[-1] := -c[1] and c[nc+2] := -c[nc].
    ext = jnp.concatenate([-c[1:2], c, -c[nc:nc + 1]], axis=0)
    # Even fine points 2j coincide with coarse j (injection); odd fine
    # point 2j+1 (j = 0..nc) sits between coarse j and j+1: cubic
    # through coarse j-1, j, j+1, j+2 (via ext: j-1 -> ext[j],
    # j+2 -> ext[j+3]).
    odd = (-ext[0:nc + 1] + 9.0 * c[0:nc + 1] + 9.0 * c[1:nc + 2]
           - ext[3:nc + 4]) / 16.0
    fine = _interleave(odd, c[1:], n)
    fine = jnp.pad(fine, [(1, 1)] + [(0, 0)] * (fine.ndim - 1))
    return jnp.moveaxis(fine, 0, axis)


def fmg_prolong(e: jax.Array) -> jax.Array:
    """Cubic (FMG-order) prolongation, padded coarse -> padded fine grid,
    any ndim (tensor-product of the 1D cubic)."""
    for ax in range(e.ndim):
        e = _fmg_prolong_axis(e, ax)
    return e
