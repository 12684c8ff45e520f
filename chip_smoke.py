"""Smoke test of the solver's main path on the GPU.

Drives every phase once through the entry points a user calls
(``MultigridSolver``, ``ShardedSolver``), checks each result against the
repo's own references, and prints one line per phase with its check,
tolerance and precision, then the card's name and power limit, and as the
last line one JSON object naming the device:

    python chip_smoke.py              # one GPU: every single-card phase
    python chip_smoke.py --devices 4  # four GPUs: the sharded path only

It exits non-zero, printing no result, when JAX finds no GPU; every phase
runs compiled for the card (no interpreter anywhere).
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))


def require_gpus(count: int):
    """The GPU devices, or exit non-zero: no phase runs on the CPU."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        sys.exit(f"chip_smoke: no GPU (JAX found {devs[0].platform})")
    if len(devs) < count:
        sys.exit(f"chip_smoke: {count} GPUs asked for, {len(devs)} found")
    return devs


def _setup():
    import jax

    sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]
    jax.config.update("jax_enable_x64", True)
    from multigridcmt.utils.cache import enable_compile_cache

    enable_compile_cache()


def _card_line() -> str:
    if shutil.which("nvidia-smi") is None:
        return "nvidia-smi not found"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    return out.stdout.strip()


def _check(cond: bool, msg: str):
    if not cond:
        raise AssertionError(msg)


# ---------------------------------------------------------------------------
# Single-card phases. Each takes the grid exponent, so the CPU tests can run
# it at a tiny size; the defaults are the sizes the card runs.
# ---------------------------------------------------------------------------

def phase_mg2d_f64(k: int = 12) -> str:
    """2D RB-GS V(2,2) in float64 to tol 1e-8."""
    import jax.numpy as jnp

    import multigridcmt as mg

    prob = mg.poisson2d(k=k, dtype=jnp.float64, smoother="rbgs", tol=1e-8)
    res = mg.MultigridSolver(prob).solve()
    rho = float(mg.convergence_factor(res))
    _check(bool(res.converged), f"not converged: {res.res_history}")
    _check(rho <= 0.22, f"convergence factor {rho} > 0.22")
    return f"n={prob.config.n}^2 f64 iters={int(res.iters)} rho={rho:.4f} <= 0.22"


def phase_mg2d_f32(k: int = 13) -> str:
    """2D RB-GS V(2,2) in float32; on the GPU its fine sweeps run the
    Triton kernel. Finite, shaped, max error vs the analytic solution
    below 1e-2. The residual norm is not checked: its float32 evaluation
    at 1/h^2 = 6.7e7 floors near 0.5 relative at 8191^2."""
    import jax.numpy as jnp
    import numpy as np

    import multigridcmt as mg

    prob = mg.poisson2d(k=k, dtype=jnp.float32, smoother="rbgs", tol=1e-6)
    res = mg.MultigridSolver(prob).solve()
    x = np.asarray(res.x)
    n = prob.config.n
    _check(x.shape == (n + 2, n + 2), f"shape {x.shape}")
    _check(bool(np.isfinite(x).all()), "non-finite solution")
    err = float(np.abs(x - np.asarray(prob.u_exact)).max())
    _check(err < 1e-2, f"max error vs analytic {err} >= 1e-2")
    return (f"n={n}^2 f32 iters={int(res.iters)} max_err={err:.2e} "
            f"< 1e-2")


def phase_rbgs_kernel(k: int = 12, dtype_name: str = "float32") -> str:
    """The Triton RB-GS sweep, compiled for the card (its HLO holds the
    Triton custom call: not interpreted), against ops.smoothers.smooth on
    random u, b: max difference within 1e-5 (float32) / 1e-12 (float64)
    of the largest value (the GPU may contract h2*b + u into an FMA)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from multigridcmt.kernels import rbgs2d
    from multigridcmt.ops import smoothers

    dtype = jnp.dtype(dtype_name)
    n = 2 ** k - 1
    h = 1.0 / (n + 1)
    rng = np.random.default_rng(k)
    u, b = (jnp.pad(jnp.asarray(rng.standard_normal((n, n)), dtype), 1)
            for _ in range(2))
    sweep = jax.jit(rbgs2d.rbgs_sweep, static_argnums=2)
    hlo = sweep.lower(u, b, h).as_text()
    _check("triton" in hlo.lower(), "no Triton call in the compiled sweep")
    got = np.asarray(sweep(u, b, h))
    want = np.asarray(jax.jit(
        lambda uu, bb: smoothers.smooth(uu, bb, h, kind="rbgs", omega=1.0,
                                        sweeps=1))(u, b))
    tol = 1e-5 if dtype == jnp.float32 else 1e-12
    err = float(np.abs(got - want).max() / np.abs(want).max())
    _check(err <= tol, f"kernel vs smoothers.smooth: {err} > {tol}")
    return f"n={n}^2 {dtype_name} compiled Triton, rel_diff={err:.1e} <= {tol}"


def phase_pcg(k: int = 12) -> str:
    """MG-preconditioned CG in float64 to tol 1e-8."""
    import jax.numpy as jnp

    import multigridcmt as mg

    prob = mg.poisson2d(k=k, dtype=jnp.float64, smoother="rbgs", tol=1e-8)
    res = mg.MultigridSolver(prob).solve(method="pcg")
    _check(bool(res.converged), f"not converged: {res.res_history}")
    return f"n={prob.config.n}^2 f64 iters={int(res.iters)} converged"


def phase_fmg(k: int = 10) -> str:
    """FMG (one V(2,2) per level) at k-2..k in float64: the discrete L2
    error falls by 4 per level (O(h^2)), ratio within [3.5, 4.5]."""
    import jax.numpy as jnp

    import multigridcmt as mg

    errs = []
    for kk in (k - 2, k - 1, k):
        prob = mg.poisson2d(k=kk, dtype=jnp.float64, smoother="rbgs",
                            cycle="fmg")
        s = mg.MultigridSolver(prob)
        errs.append(float(s.discrete_l2_error(s.fmg())))
    ratios = [errs[i] / errs[i + 1] for i in range(2)]
    _check(all(3.5 <= r <= 4.5 for r in ratios), f"ratios {ratios}")
    return (f"n={2 ** k - 1}^2 f64 err={errs[-1]:.3e} ratios="
            f"{ratios[0]:.3f},{ratios[1]:.3f} in [3.5, 4.5]")


def phase_eigen(k: int = 9, method: str = "ii") -> str:
    """lambda_1 of the 2D Laplacian by the MG eigensolver (float64,
    tol 1e-8) within 1e-8 relative of scipy's eigsh."""
    import jax.numpy as jnp

    import multigridcmt as mg
    import reference_impl as ref

    prob = mg.poisson2d(k=k, dtype=jnp.float64, smoother="rbgs")
    res = mg.MultigridSolver(prob).eigensolve(k=1, method=method, tol=1e-8)
    n = prob.config.n
    want = float(ref.eigsh_oracle(n, 2, 1.0 / (n + 1), k=1)[0])
    got = float(res.eigenvalues[0])
    rel = abs(got - want) / want
    _check(bool(res.converged), "eigensolve did not converge")
    _check(rel < 1e-8, f"lambda_1 {got} vs scipy {want}: rel {rel}")
    return (f"{method} n={n}^2 f64 lambda_1={got:.10f} rel_err={rel:.1e} "
            f"< 1e-8")


def phase_mg3d(k: int = 9) -> str:
    """3D 7-point RB-GS V(2,2) in float64 to tol 1e-8."""
    import jax.numpy as jnp

    import multigridcmt as mg

    prob = mg.poisson3d(k=k, dtype=jnp.float64, smoother="rbgs", tol=1e-8)
    res = mg.MultigridSolver(prob).solve()
    rho = float(mg.convergence_factor(res))
    _check(bool(res.converged), f"not converged: {res.res_history}")
    _check(rho <= 0.22, f"convergence factor {rho} > 0.22")
    return f"n={prob.config.n}^3 f64 iters={int(res.iters)} rho={rho:.4f} <= 0.22"


def phase_history(k: int = 9) -> str:
    """float64 residual history == tests/reference_impl.solve step for
    step (rtol 1e-6, atol 1e-11, as tests/test_cycles.py pins it)."""
    import jax.numpy as jnp
    import numpy as np

    import multigridcmt as mg
    import reference_impl as ref

    prob = mg.poisson2d(k=k, dtype=jnp.float64, smoother="rbgs", tol=1e-8)
    res = mg.MultigridSolver(prob).solve()
    _, want = ref.solve(np.asarray(mg.interior(prob.b)), prob.config.h,
                        kind="rbgs", tol=1e-8)
    got = np.asarray(res.res_history)[:len(want)]
    _check(int(res.iters) == len(want) - 1,
           f"iters {int(res.iters)} vs reference {len(want) - 1}")
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-11)
    return (f"n={prob.config.n}^2 f64 {len(want) - 1} cycles match "
            f"rtol 1e-6")


def phase_sharded1(k: int = 12) -> str:
    """ShardedSolver on a mesh of one card == MultigridSolver (float64:
    same iteration count, x within rtol 1e-9, atol 1e-11)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    import multigridcmt as mg
    from multigridcmt.parallel import sharded

    prob = mg.poisson2d(k=k, dtype=jnp.float64, smoother="rbgs", tol=1e-8)
    want = mg.MultigridSolver(prob).solve()
    s = sharded.ShardedSolver(prob.config,
                              sharded.make_mesh(jax.devices()[:1]))
    got = s.solve(prob.b)
    _check(int(got.iters) == int(want.iters),
           f"iters {int(got.iters)} vs {int(want.iters)}")
    np.testing.assert_allclose(np.asarray(got.x), np.asarray(want.x),
                               rtol=1e-9, atol=1e-11)
    return f"n={prob.config.n}^2 f64 mesh (1,) iters={int(got.iters)} == single card"


PHASES = (
    ("rbgs_kernel_4095_f32", lambda: phase_rbgs_kernel(12, "float32")),
    ("rbgs_kernel_8191_f32", lambda: phase_rbgs_kernel(13, "float32")),
    ("rbgs_kernel_4095_f64", lambda: phase_rbgs_kernel(12, "float64")),
    ("rbgs_kernel_8191_f64", lambda: phase_rbgs_kernel(13, "float64")),
    ("mg2d_f64", phase_mg2d_f64),
    ("mg2d_f32", phase_mg2d_f32),
    ("pcg_f64", phase_pcg),
    ("fmg_f64", phase_fmg),
    ("eigen_ii", lambda: phase_eigen(method="ii")),
    ("eigen_lobpcg", lambda: phase_eigen(method="lobpcg")),
    ("mg3d_f64", phase_mg3d),
    ("history_f64", phase_history),
    ("sharded_mesh1", phase_sharded1),
)


# ---------------------------------------------------------------------------
# Four-card phases: ShardedSolver against the single-card solve, float64.
# ---------------------------------------------------------------------------

def phase_sharded(k: int, ndim: int, mesh_shape, method: str,
                  ndev: int) -> str:
    """ShardedSolver on ``mesh_shape`` == MultigridSolver on one card
    (float64: same iteration count, x within rtol 1e-9, atol 1e-10)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    import multigridcmt as mg
    from multigridcmt.parallel import sharded

    prob = mg.poisson(k, ndim=ndim, dtype=jnp.float64, smoother="rbgs",
                      tol=1e-8)
    want = mg.MultigridSolver(prob).solve(method=method)
    devs = jax.devices()[:ndev]
    mesh = (sharded.make_block_mesh(mesh_shape, devs)
            if len(mesh_shape) == 2 else sharded.make_mesh(devs))
    got = sharded.ShardedSolver(prob.config, mesh).solve(prob.b,
                                                          method=method)
    _check(bool(got.converged), "sharded solve did not converge")
    _check(int(got.iters) == int(want.iters),
           f"iters {int(got.iters)} vs {int(want.iters)}")
    np.testing.assert_allclose(np.asarray(got.x), np.asarray(want.x),
                               rtol=1e-9, atol=1e-10)
    return (f"n={prob.config.n}^{ndim} f64 {method} mesh {mesh_shape} "
            f"iters={int(got.iters)} == single card")


def four_card_phases(k2: int = 13, k3: int = 9, ndev: int = 4):
    return (
        ("rows_mg", lambda: phase_sharded(k2, 2, (ndev,), "mg", ndev)),
        ("rows_pcg", lambda: phase_sharded(k2, 2, (ndev,), "pcg", ndev)),
        ("blocks_mg", lambda: phase_sharded(k2, 2, (2, ndev // 2), "mg",
                                            ndev)),
        ("blocks_pcg", lambda: phase_sharded(k2, 2, (2, ndev // 2), "pcg",
                                             ndev)),
        ("slabs3d_mg", lambda: phase_sharded(k3, 3, (ndev,), "mg", ndev)),
    )


def run(phases) -> bool:
    ok = True
    for name, fn in phases:
        t0 = time.perf_counter()
        try:
            detail = fn()
            status = "ok"
        except Exception as e:      # reported, and fails the run below
            detail, status, ok = f"{type(e).__name__}: {e}", "FAILED", False
        print(f"phase {name}: {status} ({time.perf_counter() - t0:.1f} s) "
              f"{detail}", flush=True)
    return ok


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--devices", type=int, default=1, choices=(1, 4),
                   help="4: run only the four-card sharded phases")
    args = p.parse_args(argv)
    devs = require_gpus(args.devices)
    _setup()
    phases = PHASES if args.devices == 1 else four_card_phases()
    ok = run(phases)
    print(_card_line(), flush=True)
    if not ok:
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
