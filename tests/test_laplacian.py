"""Assembly/operator tests — oracle: closed forms and SciPy (SURVEY.md §4.1-2)."""
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp

from multigridcmt.grids import interior, pad_interior
from multigridcmt.ops import laplacian

from reference_impl import laplacian_matrix


@pytest.mark.parametrize("ndim,n", [(1, 15), (1, 63), (2, 15), (2, 31)])
def test_apply_matches_scipy(ndim, n):
    h = 1.0 / (n + 1)
    rng = np.random.default_rng(0)
    u = rng.standard_normal((n,) * ndim)
    a = laplacian_matrix(n, ndim, h)
    want = (a @ u.reshape(-1)).reshape(u.shape)
    got = interior(laplacian.apply_poisson(
        pad_interior(jnp.asarray(u)), h))
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-12)


@pytest.mark.parametrize("ndim,n", [(1, 31), (2, 15)])
def test_shifted_apply(ndim, n):
    h = 1.0 / (n + 1)
    sigma = 7.5
    rng = np.random.default_rng(1)
    u = rng.standard_normal((n,) * ndim)
    a = laplacian_matrix(n, ndim, h) - sigma * sp.identity(n ** ndim)
    want = (a @ u.reshape(-1)).reshape(u.shape)
    got = interior(laplacian.apply_poisson(
        pad_interior(jnp.asarray(u)), h, sigma=jnp.float64(sigma)))
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-12)


def test_dense_operator_matches_scipy():
    for ndim, n in [(1, 7), (2, 7)]:
        h = 1.0 / (n + 1)
        want = laplacian_matrix(n, ndim, h).toarray()
        got = laplacian.dense_operator(n, ndim, h)
        np.testing.assert_allclose(got, want, rtol=1e-14)


def test_residual_is_b_minus_ax():
    n = 31
    h = 1.0 / (n + 1)
    rng = np.random.default_rng(2)
    u = rng.standard_normal((n, n))
    b = rng.standard_normal((n, n))
    a = laplacian_matrix(n, 2, h)
    want = b - (a @ u.reshape(-1)).reshape(n, n)
    got = interior(laplacian.residual(
        pad_interior(jnp.asarray(u)), pad_interior(jnp.asarray(b)), h))
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-12)


def test_eigenvalue_formulas():
    """Discrete eigenvalues: (2/h^2)(1 - cos(k pi h)); eigenvectors sin(k pi x)."""
    n, h = 63, 1.0 / 64
    x = np.arange(1, n + 1) * h
    for k in (1, 2, 5):
        v = np.sin(k * np.pi * x)
        av = np.asarray(interior(laplacian.apply_poisson(
            pad_interior(jnp.asarray(v)), h)))
        lam = laplacian.eigenvalue_1d(k, n, h)
        # atol guards the near-zero samples (sin(k pi x) ~ 1e-16 at x=1/2)
        np.testing.assert_allclose(av, lam * v, rtol=1e-10,
                                   atol=1e-9 * lam)
    lam2d = laplacian.eigenvalue_2d(1, 1, n, h)
    assert lam2d == pytest.approx(2 * laplacian.eigenvalue_1d(1, n, h))
    # Continuum limit: smallest eigenvalue -> 2 pi^2.
    assert lam2d == pytest.approx(2 * np.pi ** 2, rel=2e-3)
