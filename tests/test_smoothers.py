"""Smoother tests — explicit-formula and sweep-order oracles (SURVEY.md §4.1).

The RB-GS color/order tests are the guard against the #1 hard part in
SURVEY.md §7: silently turning Gauss-Seidel into Jacobi.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from multigridcmt.grids import interior, pad_interior
from multigridcmt.ops import smoothers

import reference_impl as ref


def _pad(a):
    return pad_interior(jnp.asarray(a))


@pytest.mark.parametrize("ndim,n", [(1, 31), (2, 15)])
def test_jacobi_matches_reference(ndim, n):
    h = 1.0 / (n + 1)
    omega = ref.default_omega(ndim)
    rng = np.random.default_rng(0)
    u = rng.standard_normal((n,) * ndim)
    b = rng.standard_normal((n,) * ndim)
    want = ref.jacobi(u, b, h, omega)
    got = interior(smoothers.jacobi(_pad(u), _pad(b), h, omega))
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-13)


@pytest.mark.parametrize("ndim,n", [(1, 31), (2, 15), (2, 16 - 1)])
def test_rbgs_matches_reference(ndim, n):
    h = 1.0 / (n + 1)
    rng = np.random.default_rng(1)
    u = rng.standard_normal((n,) * ndim)
    b = rng.standard_normal((n,) * ndim)
    want = ref.rbgs(u, b, h)
    got = interior(smoothers.rbgs(_pad(u), _pad(b), h))
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-13)


def test_rbgs_half_sweep_touches_only_one_color():
    n = 15
    h = 1.0 / (n + 1)
    rng = np.random.default_rng(2)
    u = rng.standard_normal((n, n))
    b = rng.standard_normal((n, n))
    red = np.asarray(interior(smoothers.rbgs_half_sweep(
        _pad(u), _pad(b), h, parity=0)))
    ii, jj = np.meshgrid(np.arange(1, n + 1), np.arange(1, n + 1),
                         indexing="ij")
    black_mask = ((ii + jj) % 2) == 1
    # Black points unchanged by the red half-sweep.
    np.testing.assert_array_equal(red[black_mask], u[black_mask])
    # At least the red points changed.
    assert not np.allclose(red[~black_mask], u[~black_mask])


def test_rbgs_black_sweep_sees_updated_red():
    """The black half-sweep must consume red values written by the red
    half-sweep — i.e. RB-GS is Gauss-Seidel, not two-color Jacobi."""
    n = 15
    h = 1.0 / (n + 1)
    rng = np.random.default_rng(3)
    u = rng.standard_normal((n, n))
    b = rng.standard_normal((n, n))
    got = np.asarray(interior(smoothers.rbgs(_pad(u), _pad(b), h)))
    # Two-color *Jacobi* (both colors from the old u) gives a different
    # answer; make sure we do NOT match it.
    upd_old = np.asarray(interior(smoothers._gs_update(_pad(u), _pad(b), h)))
    assert not np.allclose(got, upd_old)
    np.testing.assert_allclose(got, ref.rbgs(u, b, h), rtol=1e-13)


def test_jacobi_explicit_formula():
    """One sweep equals x + omega/d * (b - Ax) element-wise."""
    n = 7
    h = 1.0 / (n + 1)
    omega = 0.5
    rng = np.random.default_rng(4)
    u = rng.standard_normal(n)
    b = rng.standard_normal(n)
    d = 2.0 / (h * h)
    r = ref.residual(u, b, h)
    want = u + (omega / d) * r
    got = interior(smoothers.jacobi(_pad(u), _pad(b), h, omega))
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-13)


def test_smoother_reduces_error():
    """Smoothing drives the error of a random guess toward the solution."""
    n = 31
    h = 1.0 / (n + 1)
    rng = np.random.default_rng(5)
    x_true = rng.standard_normal((n, n))
    b = -ref.residual(x_true, np.zeros((n, n)), h)   # b = A x_true
    u = jnp.zeros((n + 2, n + 2))
    bp = _pad(b)
    e0 = float(jnp.linalg.norm(interior(u) - x_true))
    for kind in ("jacobi", "rbgs"):
        uu = smoothers.smooth(u, bp, h, kind=kind,
                              omega=ref.default_omega(2), sweeps=20)
        e = float(jnp.linalg.norm(interior(uu) - jnp.asarray(x_true)))
        assert e < e0


# --- Chebyshev polynomial smoother -----------------------------------------

def _cheb_poly(degree):
    """The smoother's error polynomial p(t) = T_d((theta-t)/delta)/T_d(sigma1).

    This is the minimax polynomial on [lmin, lmax] with p(0) = 1 — the
    analytic oracle for what chebyshev() must do to each eigencomponent.
    """
    lmax = smoothers.CHEB_LMAX
    lmin = lmax * smoothers.CHEB_LMIN_FRAC
    theta, delta = 0.5 * (lmax + lmin), 0.5 * (lmax - lmin)
    td = np.polynomial.chebyshev.Chebyshev.basis(degree)
    return lambda t: td((theta - t) / delta) / td(theta / delta)


def test_chebyshev_degree1_is_jacobi():
    """Degree 1 collapses to weighted Jacobi with omega = 1/theta = 0.8."""
    n = 15
    h = 1.0 / (n + 1)
    rng = np.random.default_rng(6)
    u = _pad(rng.standard_normal((n, n)))
    b = _pad(rng.standard_normal((n, n)))
    got = smoothers.chebyshev(u, b, h, degree=1)
    lmax = smoothers.CHEB_LMAX
    theta = 0.5 * (lmax + lmax * smoothers.CHEB_LMIN_FRAC)
    want = smoothers.jacobi(u, b, h, omega=1.0 / theta)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-13)


@pytest.mark.parametrize("degree", [1, 2, 3, 4])
def test_chebyshev_damps_each_mode_by_its_polynomial(degree):
    """Per-eigenmode damping equals p(mu_k) exactly (1D, b = 0).

    With b = 0 the exact solution is 0, so the iterate IS the error; in
    the sin(k pi x) eigenbasis of D^-1 A each coefficient must shrink by
    exactly p(mu_k), mu_k = 1 - cos(k pi h). This pins the whole
    three-term recurrence, not just a norm bound.
    """
    n = 31
    h = 1.0 / (n + 1)
    rng = np.random.default_rng(7)
    e0 = rng.standard_normal(n)
    out = np.asarray(interior(smoothers.chebyshev(
        _pad(e0), _pad(np.zeros(n)), h, degree=degree)))
    x = np.arange(1, n + 1) * h
    modes = np.array([np.sin(k * np.pi * x) for k in range(1, n + 1)])
    c0 = modes @ e0 / (modes * modes).sum(axis=1)
    c1 = modes @ out / (modes * modes).sum(axis=1)
    mu = 1.0 - np.cos(np.arange(1, n + 1) * np.pi * h)
    want = _cheb_poly(degree)(mu) * c0
    np.testing.assert_allclose(c1, want, rtol=1e-10, atol=1e-12)


def test_chebyshev_smoothing_factor_beats_jacobi():
    """Max damping over the oscillatory range [lmax/4, lmax] at degree 2
    beats two sweeps of optimally damped Jacobi (whose factor is 0.6^2 in
    2D terms; Chebyshev's is 1/T_2(5/3) ~ 0.22)."""
    p = _cheb_poly(2)
    mu = np.linspace(0.5, 2.0, 1001)
    cheb_factor = np.abs(p(mu)).max()
    jac = lambda t: 1.0 - 0.8 * t
    jac_factor = (np.abs(jac(mu)) ** 2).max()
    assert cheb_factor < 0.25
    assert cheb_factor < jac_factor


def test_chebyshev_vcycle_converges_grid_independent():
    """V(2,2) with the Chebyshev smoother: rho < 0.25, iteration count
    independent of grid size (the defining multigrid property)."""
    import multigridcmt as mg

    iters = []
    for k in (5, 6):
        prob = mg.poisson2d(k=k, dtype=jnp.float64, smoother="chebyshev",
                            tol=1e-8)
        res = mg.MultigridSolver(prob).solve()
        assert bool(res.converged)
        rho = float(mg.convergence_factor(res))
        assert rho < 0.25
        iters.append(int(res.iters))
    assert abs(iters[0] - iters[1]) <= 1


def test_chebyshev_degree_zero_is_identity():
    """sweeps=0 must be a no-op for every smoother kind (the chebyshev
    recurrence once applied one step before its degree loop)."""
    n = 31
    h = 1.0 / (n + 1)
    rng = np.random.default_rng(3)
    u = _pad(np.asarray(rng.standard_normal((n, n))))
    b = _pad(np.asarray(rng.standard_normal((n, n))))
    for kind in ("jacobi", "rbgs", "chebyshev"):
        out = smoothers.smooth(u, b, h, kind=kind, omega=0.8, sweeps=0)
        np.testing.assert_array_equal(np.asarray(out), np.asarray(u))
