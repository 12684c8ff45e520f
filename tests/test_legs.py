"""The two legs of a V-cycle level on the jnp tier against the NumPy oracle
(tests/reference_impl.py): down leg smooth -> residual -> restrict, up leg
prolong -> add -> smooth. Odd sizes whose coarsening is exact (n = 2 nc + 1),
both smoothers, 0-4 sweeps, float64 at 1e-12 and float32 at 2e-5
(relative to the largest value of each output: the residual scales with
1/h^2, so float32 rounding is relative to that scale).
"""
import jax.numpy as jnp
import numpy as np
import pytest

import reference_impl as ref
from multigridcmt.config import SolverConfig
from multigridcmt.grids import interior, pad_interior
from multigridcmt.ops import laplacian, transfer
from multigridcmt.solvers import cycles

SIZES = [15, 63, 127, 191, 255]
SMOOTHERS = [("rbgs", 1.0), ("jacobi", 0.8)]
DTYPES = [(jnp.float64, 1e-12), (jnp.float32, 2e-5)]


def _rand(n, seed, dtype):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, n)).astype(np.dtype(dtype))


def _cfg(kind, omega, sweeps, dtype):
    return SolverConfig(ndim=2, k=4, dtype=dtype, smoother=kind,
                        omega=omega, nu1=sweeps, nu2=sweeps)


def _close(got, want, tol):
    got = np.asarray(got, dtype=np.float64)
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * max(np.abs(want).max(), 1.0))


def _down(u, b, h, cfg, sigma=0.0):
    us = cycles.smooth(u, b, h, cfg, cfg.nu1, sigma)
    return us, transfer.restrict(laplacian.residual(us, b, h, sigma=sigma))


def _up(x, e, b, h, cfg, sigma=0.0):
    return cycles.smooth(x + transfer.prolong(e), b, h, cfg, cfg.nu2, sigma)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("kind,omega", SMOOTHERS)
@pytest.mark.parametrize("sweeps", [0, 1, 2, 3])
@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_down_leg_matches_oracle(n, kind, omega, sweeps, dtype, tol):
    h = 1.0 / (n + 1)
    u0, b0 = _rand(n, n, dtype), _rand(n, n + 1, dtype)
    cfg = _cfg(kind, omega, sweeps, dtype)
    us, rc = _down(pad_interior(jnp.asarray(u0)), pad_interior(
        jnp.asarray(b0)), h, cfg)
    want_u = ref.smooth(u0.astype(np.float64), b0.astype(np.float64), h,
                        kind, omega, sweeps)
    want_rc = ref.restrict(ref.residual(want_u, b0.astype(np.float64), h))
    assert us.dtype == dtype and rc.dtype == dtype
    _close(interior(us), want_u, tol)
    _close(interior(rc), want_rc, tol)
    # Ghost invariant: both outputs keep a zero boundary ring.
    for out in (us, rc):
        ring = np.asarray(out).copy()
        ring[1:-1, 1:-1] = 0.0
        assert np.abs(ring).max() == 0.0


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("kind,omega", SMOOTHERS)
@pytest.mark.parametrize("sweeps", [0, 2, 4])
@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_up_leg_matches_oracle(n, kind, omega, sweeps, dtype, tol):
    h = 1.0 / (n + 1)
    nc = (n - 1) // 2
    x0, b0 = _rand(n, n + 2, dtype), _rand(n, n + 3, dtype)
    e0 = _rand(nc, n + 4, dtype)
    cfg = _cfg(kind, omega, sweeps, dtype)
    got = _up(pad_interior(jnp.asarray(x0)), pad_interior(jnp.asarray(e0)),
              pad_interior(jnp.asarray(b0)), h, cfg)
    want = ref.smooth(x0.astype(np.float64) + ref.prolong(
        e0.astype(np.float64)), b0.astype(np.float64), h, kind, omega,
        sweeps)
    assert got.dtype == dtype
    _close(interior(got), want, tol)
    ring = np.asarray(got).copy()
    ring[1:-1, 1:-1] = 0.0
    assert np.abs(ring).max() == 0.0


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_shifted_legs_match_oracle(n, dtype, tol):
    """sigma != 0 (the eigensolver's shifted inner solves) through both
    legs: RB-GS down, Jacobi up."""
    h, sigma = 1.0 / (n + 1), 11.5
    nc = (n - 1) // 2
    u0, b0 = _rand(n, 5, dtype), _rand(n, 6, dtype)
    e0 = _rand(nc, 7, dtype)
    u, b = pad_interior(jnp.asarray(u0)), pad_interior(jnp.asarray(b0))
    us, rc = _down(u, b, h, _cfg("rbgs", 1.0, 2, dtype), sigma)
    u64, b64 = u0.astype(np.float64), b0.astype(np.float64)
    want_u = ref.smooth(u64, b64, h, "rbgs", 1.0, 2, sigma)
    _close(interior(us), want_u, tol)
    _close(interior(rc), ref.restrict(ref.residual(want_u, b64, h, sigma)),
           tol)
    got = _up(u, pad_interior(jnp.asarray(e0)), b,
              h, _cfg("jacobi", 0.8, 2, dtype), sigma)
    want = ref.smooth(u64 + ref.prolong(e0.astype(np.float64)), b64, h,
                      "jacobi", 0.8, 2, sigma)
    _close(interior(got), want, tol)
