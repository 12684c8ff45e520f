"""The two-colour RB-GS Triton kernel (kernels/rbgs2d.py) in the Pallas
interpreter against ops.smoothers, and the choice of kernel by platform,
size and dtype. The compiled kernel runs only on the card (chip_smoke.py
and the ``gpu``-marked tests/test_chip.py).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from multigridcmt.config import SolverConfig
from multigridcmt.kernels import rbgs2d
from multigridcmt.ops import smoothers
from multigridcmt.solvers import cycles

interpreted = functools.partial(rbgs2d.rbgs_sweep, interpret=True)


def _pair(n, dtype, seed):
    rng = np.random.default_rng(seed)
    return [jnp.pad(jnp.asarray(rng.standard_normal((n, n)), dtype), 1)
            for _ in range(2)]


# n = 15 is one tile; 127 and 200 span several tiles along both axes
# (tiles are BLOCK_ROWS x BLOCK_COLS), 200 with a ragged last tile.
@pytest.mark.parametrize("n", [15, 63, 127, 200])
@pytest.mark.parametrize("sweeps", [1, 2, 3, 4])
@pytest.mark.parametrize("sigma", [0.0, 7.5])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.float64])
def test_sweeps_match_smoothers(n, sweeps, sigma, dtype):
    """Same values as the reference sweep (the same operations in the
    same order, to an ulp or so: the compiler may contract a multiply-add
    differently — float32 to 1e-6, float64 to 1e-12), ghosts left zero."""
    u, b = _pair(n, dtype, n + sweeps)
    h = 1.0 / (n + 1)
    got, want = u, u
    for _ in range(sweeps):
        got = interpreted(got, b, h, sigma)
        want = smoothers.rbgs(want, b, h, sigma=sigma)
    assert got.dtype == dtype and got.shape == u.shape
    tol = 1e-6 if dtype == jnp.float32 else 1e-12
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=tol, atol=tol)
    ring = np.asarray(got).copy()
    ring[1:-1, 1:-1] = 0.0
    assert np.abs(ring).max() == 0.0


def test_traced_shift_does_not_retrace():
    """sigma is a runtime operand of the kernel (eigensolver RQI shifts)."""
    u, b = _pair(31, jnp.float64, 1)
    f = jax.jit(lambda s: interpreted(u, b, 1.0 / 32, s))
    for s in (0.0, 3.0, 9.0):
        np.testing.assert_allclose(
            np.asarray(f(s)), np.asarray(smoothers.rbgs(u, b, 1.0 / 32,
                                                        sigma=s)),
            rtol=1e-12, atol=1e-12)
    assert f._cache_size() == 1


@pytest.mark.parametrize("platform,n,dtype,ndim,want", [
    ("gpu", 4095, jnp.float32, 2, True),
    ("gpu", rbgs2d.MIN_N, jnp.float32, 2, True),
    ("gpu", rbgs2d.MIN_N - 2, jnp.float32, 2, False),
    ("gpu", 4095, jnp.float64, 2, False),
    ("gpu", 63, jnp.float32, 3, False),
    ("cpu", 4095, jnp.float32, 2, False),
])
def test_use_kernel_by_platform_size_dtype(platform, n, dtype, ndim, want,
                                           monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    u = jax.ShapeDtypeStruct((n + 2,) * ndim, dtype)
    assert rbgs2d.use_kernel(u) is want


def test_cycle_smooth_runs_the_kernel_when_chosen(monkeypatch):
    """cycles.smooth hands RB-GS levels to the kernel when use_kernel says
    so (the GPU path), and jacobi never."""
    calls = []

    def fake_sweep(u, b, h, sigma=0.0):
        calls.append(u.shape)
        return interpreted(u, b, h, sigma)

    monkeypatch.setattr(rbgs2d, "use_kernel", lambda u: True)
    monkeypatch.setattr(rbgs2d, "rbgs_sweep", fake_sweep)
    u, b = _pair(63, jnp.float64, 3)
    h = 1.0 / 64
    cfg = SolverConfig(ndim=2, k=6, dtype=jnp.float64, smoother="rbgs")
    got = cycles.smooth(u, b, h, cfg, 2)
    want = smoothers.smooth(u, b, h, kind="rbgs", omega=1.0, sweeps=2)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-12, atol=1e-12)
    assert calls == [u.shape, u.shape]
    cycles.smooth(u, b, h, SolverConfig(ndim=2, k=6, dtype=jnp.float64,
                                        smoother="jacobi"), 2)
    assert len(calls) == 2


def test_vcycle_with_kernel_matches_jnp(monkeypatch):
    """A whole V(2,2) cycle with every RB-GS level on the (interpreted)
    kernel equals the plain jnp cycle."""
    import multigridcmt as mg

    prob = mg.poisson2d(k=6, dtype=jnp.float64, smoother="rbgs")
    want = cycles.cycle(prob.hierarchy, jnp.zeros_like(prob.b), prob.b,
                        prob.config)
    monkeypatch.setattr(rbgs2d, "use_kernel", lambda u: u.shape[0] > 8)
    monkeypatch.setattr(rbgs2d, "rbgs_sweep", interpreted)
    got = cycles.cycle(prob.hierarchy, jnp.zeros_like(prob.b), prob.b,
                       prob.config)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-12, atol=1e-12)
