"""Sparse format tests — oracle: scipy.sparse (SURVEY.md §4.2)."""
import jax.numpy as jnp
import numpy as np
import pytest

from multigridcmt.ops import sparse

from reference_impl import laplacian_matrix


@pytest.mark.parametrize("ndim,n", [(1, 31), (2, 15)])
def test_csr_matches_scipy(ndim, n):
    h = 1.0 / (n + 1)
    a = sparse.laplacian_csr(n, ndim, h, dtype=jnp.float64)
    want = laplacian_matrix(n, ndim, h)
    got = sparse.csr_to_scipy(a)
    assert (got != want).nnz == 0


@pytest.mark.parametrize("ndim,n", [(1, 31), (2, 15)])
def test_spmv_csr(ndim, n):
    h = 1.0 / (n + 1)
    a = sparse.laplacian_csr(n, ndim, h, dtype=jnp.float64)
    rng = np.random.default_rng(0)
    x = rng.standard_normal(a.shape[1])
    want = laplacian_matrix(n, ndim, h) @ x
    got = sparse.spmv(a, jnp.asarray(x))
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-12)


@pytest.mark.parametrize("ndim,n", [(1, 31), (2, 15)])
def test_spmv_coo(ndim, n):
    h = 1.0 / (n + 1)
    a = sparse.laplacian_coo(n, ndim, h, dtype=jnp.float64)
    rng = np.random.default_rng(1)
    x = rng.standard_normal(a.shape[1])
    want = laplacian_matrix(n, ndim, h) @ x
    got = sparse.spmv_coo(a, jnp.asarray(x))
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-12)


@pytest.mark.parametrize("ndim,n", [(1, 31), (2, 15)])
def test_spmv_dia(ndim, n):
    h = 1.0 / (n + 1)
    a = sparse.laplacian_dia(n, ndim, h, dtype=jnp.float64)
    rng = np.random.default_rng(2)
    x = rng.standard_normal(a.shape[1])
    want = laplacian_matrix(n, ndim, h) @ x
    got = sparse.spmv_dia(a, jnp.asarray(x))
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-12)
    # nnz bookkeeping matches scipy's count
    assert a.nnz == laplacian_matrix(n, ndim, h).nnz


def test_coo_to_csr_roundtrip():
    n, h = 15, 1.0 / 16
    coo = sparse.laplacian_coo(n, 2, h, dtype=jnp.float64)
    csr = sparse.coo_to_csr(coo)
    want = laplacian_matrix(n, 2, h)
    assert (sparse.csr_to_scipy(csr) != want).nnz == 0


# Single-tile and multi-thousand lengths, non-multiple-of-128 sizes, and a
# 2D size whose +-n offsets are not powers of two.
DIA_CASES = [(1023, 1), (4097, 1), (31, 2), (63, 2), (100, 2)]


@pytest.mark.parametrize("n,ndim", DIA_CASES)
@pytest.mark.parametrize("dtype,rtol", [(jnp.float64, 1e-12),
                                        (jnp.float32, 1e-5)])
def test_spmv_dia_sizes_match_scipy(n, ndim, dtype, rtol):
    """DIA SpMV (the XLA version) against scipy.sparse, relative to the
    output's scale (entries scale with 1/h^2)."""
    h = 1.0 / (n + 1)
    a = sparse.laplacian_dia(n, ndim, h, dtype=dtype)
    rng = np.random.default_rng(n)
    x = rng.standard_normal(a.shape[1]).astype(np.dtype(dtype))
    want = laplacian_matrix(n, ndim, h) @ x.astype(np.float64)
    got = np.asarray(sparse.spmv_dia(a, jnp.asarray(x)), dtype=np.float64)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


@pytest.mark.parametrize("dtype,rtol", [(jnp.float64, 1e-12),
                                        (jnp.float32, 1e-4)])
def test_spmv_dia_chained(dtype, rtol):
    """y = A(A(x)) through two DIA SpMVs == scipy's A @ (A @ x)."""
    n, ndim = 63, 2
    h = 1.0 / (n + 1)
    a = sparse.laplacian_dia(n, ndim, h, dtype=dtype)
    x = np.random.default_rng(3).standard_normal(a.shape[1]) * (h * h)
    a_sp = laplacian_matrix(n, ndim, h)
    want = a_sp @ (a_sp @ x)
    got = np.asarray(sparse.spmv_dia(a, sparse.spmv_dia(
        a, jnp.asarray(x, dtype))), dtype=np.float64)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.abs(want).max())
