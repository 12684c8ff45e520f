"""Galerkin coarse-operator and explicit transfer-matrix tests.

Oracles (SURVEY.md §4.1): the P = 2^d R^T transpose identity, 1D exactness
of Galerkin vs re-discretization, and action-equivalence of the algebraic
R A P against the composed stencil operators restrict/apply/prolong."""
import jax.numpy as jnp
import numpy as np
import pytest

from multigridcmt.ops import laplacian, sparse, transfer


def _dense(a):
    return sparse.csr_to_scipy(a).toarray()


@pytest.mark.parametrize("ndim", [1, 2])
def test_transpose_identity(ndim):
    nc = 15
    p = _dense(sparse.prolongation_csr(nc, ndim, dtype=jnp.float64))
    r = _dense(sparse.restriction_csr(nc, ndim, dtype=jnp.float64))
    np.testing.assert_allclose(p, (2.0 ** ndim) * r.T, atol=1e-14)
    # Row sums: interpolation reproduces constants away from the boundary.
    mid = p.shape[0] // 2
    assert abs(p[mid].sum() - 1.0) < 1e-14


@pytest.mark.parametrize("ndim", [1, 2])
def test_transfer_matrices_match_stencil_ops(ndim):
    nc = 7
    nf = 2 * nc + 1
    rng = np.random.default_rng(0)
    p = sparse.prolongation_csr(nc, ndim, dtype=jnp.float64)
    r = sparse.restriction_csr(nc, ndim, dtype=jnp.float64)

    ec = rng.standard_normal((nc,) * ndim)
    ec_pad = np.zeros((nc + 2,) * ndim)
    ec_pad[(slice(1, -1),) * ndim] = ec
    want_p = np.asarray(transfer.prolong(jnp.asarray(ec_pad)))
    got_p = np.asarray(sparse.spmv(p, jnp.asarray(ec.ravel())))
    np.testing.assert_allclose(
        got_p, want_p[(slice(1, -1),) * ndim].ravel(), atol=1e-13)

    rf = rng.standard_normal((nf,) * ndim)
    rf_pad = np.zeros((nf + 2,) * ndim)
    rf_pad[(slice(1, -1),) * ndim] = rf
    want_r = np.asarray(transfer.restrict(jnp.asarray(rf_pad)))
    got_r = np.asarray(sparse.spmv(r, jnp.asarray(rf.ravel())))
    np.testing.assert_allclose(
        got_r, want_r[(slice(1, -1),) * ndim].ravel(), atol=1e-13)


def test_galerkin_1d_exact():
    """R A_f P equals the re-discretized tridiagonal on the coarse grid."""
    nc, nf = 31, 63
    hf = 1.0 / (nf + 1)
    af = sparse.laplacian_csr(nf, 1, hf, dtype=jnp.float64)
    ac = sparse.galerkin_coarse(af, nc, 1)
    want = _dense(sparse.laplacian_csr(nc, 1, 2 * hf, dtype=jnp.float64))
    np.testing.assert_allclose(_dense(ac), want, atol=1e-9)


def test_galerkin_2d_action_matches_stencil_composition():
    """A_c v == restrict(A_f(prolong v)) for the 2D 5-point operator."""
    nc, nf = 15, 31
    hf = 1.0 / (nf + 1)
    af = sparse.laplacian_csr(nf, 2, hf, dtype=jnp.float64)
    ac = sparse.galerkin_coarse(af, nc, 2)

    rng = np.random.default_rng(1)
    v = rng.standard_normal((nc, nc))
    vp = np.zeros((nc + 2, nc + 2))
    vp[1:-1, 1:-1] = v
    fine = transfer.prolong(jnp.asarray(vp))
    av = laplacian.apply_poisson(fine, hf)
    want = np.asarray(transfer.restrict(av))[1:-1, 1:-1].ravel()
    got = np.asarray(sparse.spmv(ac, jnp.asarray(v.ravel())))
    np.testing.assert_allclose(got, want, atol=1e-9)


def test_galerkin_2d_properties():
    """9-point symmetric M-matrix-like stencil with h^-2 scaling."""
    nc, nf = 7, 15
    hf = 1.0 / (nf + 1)
    af = sparse.laplacian_csr(nf, 2, hf, dtype=jnp.float64)
    ac = _dense(sparse.galerkin_coarse(af, nc, 2))
    np.testing.assert_allclose(ac, ac.T, atol=1e-9)
    # interior row: 9 nonzeros
    mid = (nc // 2) * nc + nc // 2
    assert np.count_nonzero(np.abs(ac[mid]) > 1e-12) == 9
    # smallest eigenvalue close to the re-discretized 5-point one
    w_g = np.linalg.eigvalsh(ac)[0]
    a5 = _dense(sparse.laplacian_csr(nc, 2, 2 * hf, dtype=jnp.float64))
    w_5 = np.linalg.eigvalsh(a5)[0]
    assert abs(w_g - w_5) / w_5 < 0.05
