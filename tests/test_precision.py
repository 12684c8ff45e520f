"""Precision pins and the compile-cache placement.

float32 matrix products may run in TF32 on the GPU (about three decimal
digits); the coarse solve and the eigensolvers' Gram / Rayleigh-Ritz
products ask for HIGHEST precision. On the CPU these tests check that the
request is in the compiled program and that float32 results match a
float64 computation at float32 accuracy.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np

import multigridcmt as mg
import reference_impl as ref
from multigridcmt.config import SolverConfig
from multigridcmt.grids import build_hierarchy, interior, pad_interior
from multigridcmt.solvers import cycles, eigen

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_coarse_solve_f32_matches_f64():
    """A 15^2 coarsest level (225 x 225 dense inverse): the float32 solve
    agrees with a float64 solve to 1e-5 relative (float32 rounding times
    the coarse operator's condition number ~100), and the product asks for
    HIGHEST precision."""
    cfg = SolverConfig(ndim=2, k=5, dtype=jnp.float32, min_coarse=15)
    hier = build_hierarchy(cfg)
    nc = hier.coarsest.n
    assert nc == 15
    rng = np.random.default_rng(0)
    r = rng.standard_normal((nc, nc))
    got = np.asarray(interior(cycles.coarse_solve(
        hier, pad_interior(jnp.asarray(r, jnp.float32)))))
    a = ref.laplacian_matrix(nc, 2, hier.coarsest.h).toarray()
    want = np.linalg.solve(a, r.reshape(-1)).reshape(nc, nc)
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
    hlo = jax.jit(lambda b: cycles.coarse_solve(hier, b)).lower(
        pad_interior(jnp.asarray(r, jnp.float32))).as_text()
    assert "HIGHEST" in hlo


def test_lobpcg_rayleigh_ritz_f32_matches_f64():
    """float32 LOBPCG (Gram and Rayleigh-Ritz products at HIGHEST) finds
    the same lambda_1 as scipy's float64 eigsh to 1e-5 relative."""
    prob = mg.poisson2d(k=5, dtype=jnp.float32, smoother="rbgs")
    res = mg.MultigridSolver(prob).eigensolve(k=2, method="lobpcg",
                                              tol=1e-4, max_iters=60)
    n = prob.config.n
    want = ref.eigsh_oracle(n, 2, 1.0 / (n + 1), k=2)
    np.testing.assert_allclose(np.asarray(res.eigenvalues, np.float64),
                               want, rtol=1e-5)
    s = jnp.asarray(np.random.default_rng(1).standard_normal((4, 64)),
                    jnp.float32)
    assert "HIGHEST" in jax.jit(lambda x: eigen.mm(x, x.T)).lower(
        s).as_text()


def _cache_dir_in_child(env_dir):
    """enable_compile_cache() in a fresh process; returns (reported dir,
    jax's configured dir, files written there by one compile)."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    if env_dir is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_dir
    code = (
        "import os, jax, jax.numpy as jnp\n"
        "from multigridcmt.utils.cache import enable_compile_cache\n"
        "p = enable_compile_cache()\n"
        "jax.config.update('jax_persistent_cache_min_compile_time_secs', 0)\n"
        "before = set(os.listdir(p))\n"
        "jax.jit(lambda x: jnp.sin(x) * %r)(jnp.ones(7)).block_until_ready()\n"
        "print(p)\n"
        "print(jax.config.jax_compilation_cache_dir)\n"
        "print(len(set(os.listdir(p)) - before))\n" % os.getpid())
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    path, configured, new = out.stdout.split()
    return path, configured, int(new)


def test_compile_cache_follows_env(tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, no directory is set in code and
    the cache lands there."""
    path, configured, new = _cache_dir_in_child(str(tmp_path))
    assert path == configured == str(tmp_path)
    assert new > 0


def test_compile_cache_default_is_checkout(tmp_path):
    """Without it, the cache lands in <checkout>/.jax_cache."""
    path, configured, new = _cache_dir_in_child(None)
    assert path == configured == os.path.join(ROOT, ".jax_cache")
    assert new > 0
