"""Headline benchmark: the 2D Poisson RB-GS V(2,2) cycle at 4095^2 on the GPU.

Prints ONE JSON line on stdout: {"metric", "value", "unit", "vs_baseline",
"device", ...}. ``value`` is the median wall time of one V(2,2) cycle in
float32 after warm-up, each timed run fenced with ``block_until_ready``.
``vs_baseline`` is the speedup over the SciPy mini-reference
(tests/reference_impl.py) running the same cycle on the host's CPU. Rates
are given against a same-size copy measured in the same run, not against a
published peak.

    python bench.py         # the headline line
    python bench.py --ab    # also: cycle with and without the Triton RB-GS
                            # kernel, 4095^2 and 8191^2, float32 and float64

Detail (per-size timings, the A/B table) goes to stderr. Exits non-zero
when JAX finds no GPU.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
K = 12          # 4095^2 — the BASELINE.json config-5 grid size
CHAIN = 10      # cycles (or copies) chained in one dispatch per timed run
REPS = 15


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def median_time(fn, *args, reps=REPS) -> float:
    """Median seconds of ``fn(*args)`` after one warm-up call, each run
    fenced with ``block_until_ready``."""
    import jax

    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts)


def copy_seconds(x) -> float:
    """Seconds per read+write pass over ``x`` (a chained ``x + 1``)."""
    import jax

    f = jax.jit(lambda v: jax.lax.fori_loop(0, CHAIN, lambda i, w: w + 1,
                                            v))
    return median_time(f, x) / CHAIN


def cycle_seconds(k: int, dtype) -> float:
    """Seconds per V(2,2) RB-GS cycle at (2^k - 1)^2 on the main path."""
    import jax
    import jax.numpy as jnp

    import multigridcmt as mg
    from multigridcmt.solvers import cycles

    prob = mg.poisson2d(k=k, dtype=dtype, smoother="rbgs")
    hier, cfg = prob.hierarchy, prob.config
    f = jax.jit(lambda x, b: jax.lax.fori_loop(
        0, CHAIN, lambda i, v: cycles.cycle(hier, v, b, cfg), x))
    return median_time(f, jnp.zeros_like(prob.b), prob.b) / CHAIN


def sweep_seconds(k: int, dtype) -> float:
    """Seconds per fine-level RB-GS sweep, as the cycle runs it."""
    import jax
    import jax.numpy as jnp

    from multigridcmt.config import SolverConfig
    from multigridcmt.grids import pad_interior
    from multigridcmt.solvers import cycles

    n = 2 ** k - 1
    h = 1.0 / (n + 1)
    cfg = SolverConfig(ndim=2, k=k, dtype=dtype, smoother="rbgs")
    b = pad_interior(jnp.ones((n, n), dtype))
    f = jax.jit(lambda u: cycles.smooth(u, b, h, cfg, CHAIN))
    return median_time(f, jnp.zeros_like(b)) / CHAIN


def kernel_ab():
    """Cycle time with and without the Triton sweep, in the order
    XLA, kernel, kernel, XLA, at 4095^2 and 8191^2 in both dtypes."""
    import jax.numpy as jnp

    from multigridcmt.kernels import rbgs2d

    rows = []
    saved = (rbgs2d.MIN_N, rbgs2d.DTYPES)
    try:
        for k in (12, 13):
            for dt in (jnp.float32, jnp.float64):
                name = jnp.dtype(dt).name
                row = {"n": 2 ** k - 1, "dtype": name, "xla_ms": [],
                       "kernel_ms": []}
                for arm in ("xla", "kernel", "kernel", "xla"):
                    # The kernel on every level >= 1023, or on none.
                    rbgs2d.MIN_N = 1023 if arm == "kernel" else 1 << 30
                    rbgs2d.DTYPES = (name,)
                    row[f"{arm}_ms"].append(cycle_seconds(k, dt) * 1e3)
                log(f"[bench] A/B {json.dumps(row)}")
                rows.append(row)
    finally:
        rbgs2d.MIN_N, rbgs2d.DTYPES = saved
    return rows


def scipy_reference_ms() -> float:
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import reference_impl as ref

    n = 2 ** K - 1
    h = 1.0 / (n + 1)
    x = np.arange(1, n + 1) * h
    b = 2 * np.pi ** 2 * np.outer(np.sin(np.pi * x), np.sin(np.pi * x))
    t0 = time.perf_counter()
    ref.v_cycle(np.zeros_like(b), b, h, 2, 2, "rbgs", 0.8)
    return (time.perf_counter() - t0) * 1e3


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--ab", action="store_true",
                   help="also time the cycle with and without the kernel")
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    import jax
    import jax.numpy as jnp

    devs = jax.devices()
    if devs[0].platform != "gpu":
        sys.exit(f"bench: no GPU (JAX found {devs[0].platform})")
    jax.config.update("jax_enable_x64", True)
    from multigridcmt.utils.cache import enable_compile_cache

    enable_compile_cache()
    n = 2 ** K - 1
    fine = jnp.zeros((n + 2, n + 2), jnp.float32)
    t_copy = copy_seconds(fine)
    copy_gbps = 2 * fine.nbytes / t_copy / 1e9
    t_sweep = sweep_seconds(K, jnp.float32)
    sweep_gbps = 3 * fine.nbytes / t_sweep / 1e9
    t_cycle = cycle_seconds(K, jnp.float32)
    log(f"[bench] {devs[0].device_kind}: copy {t_copy * 1e3:.4f} ms "
        f"({copy_gbps:.0f} GB/s); fine RB-GS sweep {t_sweep * 1e3:.4f} ms "
        f"({sweep_gbps:.0f} GB/s at 3N bytes); V(2,2) cycle "
        f"{t_cycle * 1e3:.4f} ms = {t_cycle / t_copy:.1f} fine-grid copies")
    if args.ab:
        kernel_ab()
    ref_ms = scipy_reference_ms()
    log(f"[bench] SciPy reference V(2,2) cycle at {n}x{n}: {ref_ms:.0f} ms")
    print(json.dumps({
        "metric": "poisson2d_4095_rbgs_vcycle_wall",
        "value": t_cycle * 1e3,
        "unit": "ms",
        "vs_baseline": ref_ms / (t_cycle * 1e3),
        "device": {"platform": devs[0].platform,
                   "kind": devs[0].device_kind, "count": len(devs)},
        "copy_GBps": copy_gbps,
        "sweep_GBps": sweep_gbps,
        "sweep_vs_copy": sweep_gbps / copy_gbps,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
