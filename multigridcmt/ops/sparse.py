"""Sparse Laplacian assembly (CSR/COO) and device SpMV.

Capability parity: the reference assembles its 1D/2D Poisson operators as
`scipy.sparse` CSR/COO matrices and applies them with the library SpMV
(SURVEY.md §2 "Laplacian assembly" / "Sparse formats / SpMV" rows). Here the
same formats exist as explicit JAX pytrees:

  * assembly runs once on the host in NumPy (setup path, outside jit);
  * `spmv` runs on device — the CSR path is a gather + segment-sum (general
    matrices), and the structured Poisson path uses the fixed-bandwidth
    DIA layout, a handful of shifted multiply-adds (no gathers) that XLA
    fuses into one pass.

The hot solver path stays matrix-free (`ops/laplacian.py`); these matrices
serve the generality capability and cross-checks against `scipy.sparse`.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class CSR:
    """Compressed-sparse-row matrix as a JAX pytree.

    Mirrors `scipy.sparse.csr_matrix`'s (data, indices, indptr) triple, plus
    a precomputed `row_ids` (COO row index per nonzero) so the device SpMV
    is a single segment-sum without an indptr walk.
    """

    data: jax.Array      # (nnz,)
    indices: jax.Array   # (nnz,) column index per nonzero
    indptr: jax.Array    # (nrows + 1,)
    row_ids: jax.Array   # (nnz,) row index per nonzero
    shape: Tuple[int, int]

    def tree_flatten(self):
        return (self.data, self.indices, self.indptr, self.row_ids), (self.shape,)

    @classmethod
    def tree_unflatten(cls, aux, children):
        data, indices, indptr, row_ids = children
        (shape,) = aux
        return cls(data, indices, indptr, row_ids, shape)

    @property
    def nnz(self) -> int:
        return self.data.shape[0]


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class COO:
    """Coordinate-format sparse matrix as a JAX pytree."""

    data: jax.Array   # (nnz,)
    row: jax.Array    # (nnz,)
    col: jax.Array    # (nnz,)
    shape: Tuple[int, int]

    def tree_flatten(self):
        return (self.data, self.row, self.col), (self.shape,)

    @classmethod
    def tree_unflatten(cls, aux, children):
        data, row, col = children
        (shape,) = aux
        return cls(data, row, col, shape)

    @property
    def nnz(self) -> int:
        return self.data.shape[0]


def _kron_chain(mats):
    import scipy.sparse as sp

    out = mats[0]
    for m in mats[1:]:
        out = sp.kron(out, m)
    return out


def _laplacian_coo_numpy(n: int, ndim: int, h: float):
    """Host-side COO triplets of the 1D/2D/3D Poisson operator (float64)."""
    inv_h2 = 1.0 / (h * h)
    if ndim == 3:
        # Kronecker sum in the same row-major interior ordering as
        # laplacian.dense_operator: kron(t,I,I) + kron(I,t,I) + kron(I,I,t).
        import scipy.sparse as sp

        t = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(n, n))
        eye = sp.identity(n)
        a = sum(
            _kron_chain([t if ax == d else eye for ax in range(3)])
            for d in range(3)
        )
        a = (a * inv_h2).tocoo()
        order = np.lexsort((a.col, a.row))
        return (a.row[order], a.col[order], a.data[order], a.shape)
    if ndim == 1:
        rows, cols, vals = [], [], []
        idx = np.arange(n)
        rows.append(idx); cols.append(idx); vals.append(np.full(n, 2.0 * inv_h2))
        rows.append(idx[1:]); cols.append(idx[1:] - 1); vals.append(np.full(n - 1, -inv_h2))
        rows.append(idx[:-1]); cols.append(idx[:-1] + 1); vals.append(np.full(n - 1, -inv_h2))
        return (np.concatenate(rows), np.concatenate(cols),
                np.concatenate(vals), (n, n))
    # 2D: row-major interior ordering p = i * n + j, 5-point stencil.
    ii, jj = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    p = (ii * n + jj).ravel()
    rows, cols, vals = [p], [p], [np.full(n * n, 4.0 * inv_h2)]
    for di, dj in ((-1, 0), (1, 0), (0, -1), (0, 1)):
        ni, nj = ii + di, jj + dj
        ok = ((ni >= 0) & (ni < n) & (nj >= 0) & (nj < n)).ravel()
        q = (ni * n + nj).ravel()
        rows.append(p[ok]); cols.append(q[ok])
        vals.append(np.full(ok.sum(), -inv_h2))
    return (np.concatenate(rows), np.concatenate(cols),
            np.concatenate(vals), (n * n, n * n))


def laplacian_coo(n: int, ndim: int, h: float, dtype=jnp.float32) -> COO:
    """Assemble the Poisson operator in COO format (sorted by row, col)."""
    row, col, val, shape = _laplacian_coo_numpy(n, ndim, h)
    order = np.lexsort((col, row))
    return COO(
        data=jnp.asarray(val[order], dtype=dtype),
        row=jnp.asarray(row[order], dtype=jnp.int32),
        col=jnp.asarray(col[order], dtype=jnp.int32),
        shape=shape,
    )


def laplacian_csr(n: int, ndim: int, h: float, dtype=jnp.float32) -> CSR:
    """Assemble the Poisson operator in CSR format."""
    row, col, val, shape = _laplacian_coo_numpy(n, ndim, h)
    order = np.lexsort((col, row))
    row, col, val = row[order], col[order], val[order]
    indptr = np.zeros(shape[0] + 1, dtype=np.int64)
    np.add.at(indptr, row + 1, 1)
    indptr = np.cumsum(indptr)
    return CSR(
        data=jnp.asarray(val, dtype=dtype),
        indices=jnp.asarray(col, dtype=jnp.int32),
        indptr=jnp.asarray(indptr, dtype=jnp.int32),
        row_ids=jnp.asarray(row, dtype=jnp.int32),
        shape=shape,
    )


def coo_to_csr(a: COO) -> CSR:
    """Convert (host-side) a COO matrix to CSR."""
    row = np.asarray(a.row)
    col = np.asarray(a.col)
    val = np.asarray(a.data)
    order = np.lexsort((col, row))
    row, col, val = row[order], col[order], val[order]
    indptr = np.zeros(a.shape[0] + 1, dtype=np.int64)
    np.add.at(indptr, row + 1, 1)
    indptr = np.cumsum(indptr)
    return CSR(
        data=jnp.asarray(val, dtype=a.data.dtype),
        indices=jnp.asarray(col, dtype=jnp.int32),
        indptr=jnp.asarray(indptr, dtype=jnp.int32),
        row_ids=jnp.asarray(row, dtype=jnp.int32),
        shape=a.shape,
    )


def csr_to_scipy(a: CSR):
    """Export to scipy.sparse.csr_matrix (tests / oracles only)."""
    import scipy.sparse as sp

    return sp.csr_matrix(
        (np.asarray(a.data), np.asarray(a.indices), np.asarray(a.indptr)),
        shape=a.shape,
    )


@jax.jit
def spmv(a: CSR, x: jax.Array) -> jax.Array:
    """y = A @ x for a general CSR matrix (gather + segment-sum)."""
    prods = a.data * x[a.indices]
    return jax.ops.segment_sum(prods, a.row_ids, num_segments=a.shape[0])


@jax.jit
def spmv_coo(a: COO, x: jax.Array) -> jax.Array:
    """y = A @ x for a general COO matrix."""
    prods = a.data * x[a.col]
    return jax.ops.segment_sum(prods, a.row, num_segments=a.shape[0])


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class DIA:
    """Diagonal (DIA) storage: the gather-free layout for banded operators.

    `offsets` are static Python ints; `diags` is (ndiag, nrows) with
    out-of-range entries zero. SpMV is ndiag shifted multiply-adds — fully
    vectorized and gather-free.
    """

    diags: jax.Array            # (ndiag, n)
    offsets: Tuple[int, ...]    # static
    shape: Tuple[int, int]

    def tree_flatten(self):
        return (self.diags,), (self.offsets, self.shape)

    @classmethod
    def tree_unflatten(cls, aux, children):
        offsets, shape = aux
        (diags,) = children
        return cls(diags, offsets, shape)

    @property
    def nnz(self) -> int:
        """Structural nonzeros (matches scipy's count: explicit zeros that
        pad the fixed-bandwidth diagonals are not counted)."""
        return int(np.count_nonzero(np.asarray(self.diags)))


def laplacian_dia(n: int, ndim: int, h: float, dtype=jnp.float32) -> DIA:
    """Assemble the Poisson operator in DIA format.

    1D: offsets (-1, 0, 1). 2D row-major: offsets (-n, -1, 0, 1, n), with the
    +-1 diagonals zeroed at interior-row boundaries (j = 0 / j = n-1 wrap).
    3D: offsets (-n^2, -n, -1, 0, 1, n, n^2), analogous zeroing per axis.
    """
    inv_h2 = 1.0 / (h * h)
    if ndim == 3:
        m = n ** 3
        offsets = (-n * n, -n, -1, 0, 1, n, n * n)
        d = np.full((7, m), -inv_h2)
        d[3, :] = 6.0 * inv_h2
        idx = np.arange(m)
        ax = [idx // (n * n), (idx // n) % n, idx % n]   # (i, j, k)
        for axis, (lo_row, hi_row) in enumerate(((0, 6), (1, 5), (2, 4))):
            d[lo_row, ax[axis] == 0] = 0.0       # no neighbor below axis min
            d[hi_row, ax[axis] == n - 1] = 0.0   # no neighbor past axis max
        return DIA(diags=jnp.asarray(d, dtype=dtype), offsets=offsets,
                   shape=(m, m))
    if ndim == 1:
        d = np.zeros((3, n))
        d[0, :] = -inv_h2   # offset -1: stored aligned to row index
        d[1, :] = 2.0 * inv_h2
        d[2, :] = -inv_h2
        d[0, 0] = 0.0       # row 0 has no left neighbor
        d[2, -1] = 0.0      # row n-1 has no right neighbor
        offsets = (-1, 0, 1)
        shape = (n, n)
    else:
        m = n * n
        d = np.zeros((5, m))
        d[0, :] = -inv_h2                   # offset -n (up neighbor)
        d[1, :] = -inv_h2                   # offset -1 (left)
        d[2, :] = 4.0 * inv_h2              # main
        d[3, :] = -inv_h2                   # offset +1 (right)
        d[4, :] = -inv_h2                   # offset +n (down)
        idx = np.arange(m)
        d[0, idx // n == 0] = 0.0           # first block row: no up
        d[4, idx // n == n - 1] = 0.0       # last block row: no down
        d[1, idx % n == 0] = 0.0            # first column of block: no left
        d[3, idx % n == n - 1] = 0.0        # last column: no right
        offsets = (-n, -1, 0, 1, n)
        shape = (m, m)
    return DIA(diags=jnp.asarray(d, dtype=dtype), offsets=offsets, shape=shape)


@jax.jit
def spmv_dia(a: DIA, x: jax.Array) -> jax.Array:
    """y = A @ x for DIA storage: one shifted multiply-add per diagonal.

    Convention: diags[k, i] holds A[i, i + offsets[k]], so
    y[i] += diags[k, i] * x[i + offsets[k]].
    """
    y = jnp.zeros_like(x)
    n = a.shape[0]
    for k, off in enumerate(a.offsets):
        dk = a.diags[k]
        if off == 0:
            y = y + dk * x
        elif off > 0:
            y = y.at[: n - off].add(dk[: n - off] * x[off:])
        else:
            o = -off
            y = y.at[o:].add(dk[o:] * x[: n - o])
    return y


# ---------------------------------------------------------------------------
# Explicit transfer matrices and Galerkin coarse operators.
#
# The geometric hierarchy (grids.py) re-discretizes each level, which for
# constant-coefficient Poisson with full-weighting/bilinear transfers is the
# reference's choice (SURVEY.md §2 "Coarse-grid hierarchy" row). These
# routines provide the *algebraic* alternative named in the same row,
# A_c = R A P, as setup-time host computations — useful for
# variable-coefficient or externally supplied operators, and as oracles for
# the stencil transfers (P = 2^d R^T identity, §4.1).
# ---------------------------------------------------------------------------


def _prolongation_scipy_1d(nc: int):
    import scipy.sparse as sp

    nf = 2 * nc + 1
    rows, cols, vals = [], [], []
    for j in range(nc):           # coarse interior point j ↔ fine 2j+1
        i = 2 * j + 1
        rows += [i, i - 1, i + 1]
        cols += [j, j, j]
        vals += [1.0, 0.5, 0.5]
    return sp.csr_matrix(
        (np.array(vals), (np.array(rows), np.array(cols))), shape=(nf, nc))


def prolongation_csr(nc: int, ndim: int, dtype=jnp.float32) -> CSR:
    """Linear/bilinear interpolation matrix P: (2nc+1)^d x nc^d interior
    points (vertex-centered, Dirichlet boundaries eliminated)."""
    import scipy.sparse as sp

    p1 = _prolongation_scipy_1d(nc)
    p = _kron_chain([p1] * ndim).tocsr()
    return scipy_to_csr(p, dtype)


def restriction_csr(nc: int, ndim: int, dtype=jnp.float32) -> CSR:
    """Full-weighting restriction matrix R = P^T / 2^d: nc^d x (2nc+1)^d."""
    import scipy.sparse as sp

    p1 = _prolongation_scipy_1d(nc)
    p = _kron_chain([p1] * ndim).tocsr()
    return scipy_to_csr((p.T / 2.0 ** ndim).tocsr(), dtype)


def scipy_to_csr(a, dtype=jnp.float32) -> CSR:
    """Import a scipy.sparse matrix as a device CSR pytree."""
    import scipy.sparse as sp

    a = sp.csr_matrix(a)
    a.sum_duplicates()
    coo = a.tocoo()
    return coo_to_csr(COO(
        data=jnp.asarray(coo.data, dtype=dtype),
        row=jnp.asarray(coo.row, dtype=jnp.int32),
        col=jnp.asarray(coo.col, dtype=jnp.int32),
        shape=a.shape))


def galerkin_coarse(a: CSR, nc: int, ndim: int, drop_tol: float = 0.0) -> CSR:
    """A_c = R A P with full-weighting R and (bi)linear P (host, setup-time).

    For the constant-coefficient Laplacian in 1D this reproduces the
    re-discretized coarse operator exactly; in 2D it yields the standard
    9-point Galerkin stencil whose action the tests cross-check against
    restrict(A(prolong(.))) composed from the stencil operators.
    """
    import scipy.sparse as sp

    p1 = _prolongation_scipy_1d(nc)
    p = _kron_chain([p1] * ndim).tocsr()
    r = (p.T / 2.0 ** ndim).tocsr()
    ac = (r @ csr_to_scipy(a) @ p).tocsr()
    if drop_tol > 0.0:
        ac.data[np.abs(ac.data) < drop_tol] = 0.0
        ac.eliminate_zeros()
    return scipy_to_csr(ac, a.data.dtype)
