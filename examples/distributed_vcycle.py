"""BASELINE config 5: 4096^2-scale Poisson V-cycle domain-decomposed across
a device mesh with ppermute halos and coarse-level agglomeration.

--mesh ROWSxCOLS picks the decomposition: a 1D mesh gives row (2D) / slab
(3D) partitioning, a 2D mesh gives block / pencil partitioning (half the
halo surface per device at the same device count). --ndim 3 runs the 3D
7-point problem on the same runtime.

Single host: uses all local devices (or a virtual CPU mesh via
XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu).
Multi-host: launch one process per host with --multihost; the code path is
identical (jax.distributed + the same mesh over all processes' devices).
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from multigridcmt.utils.cache import enable_compile_cache

enable_compile_cache()

import argparse

import jax
import jax.numpy as jnp
import numpy as np

import multigridcmt as mg
from multigridcmt.config import SolverConfig
from multigridcmt.parallel import sharded


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--k", type=int, default=12, help="grid: (2^k - 1)^d")
    p.add_argument("--ndim", type=int, default=2, choices=[2, 3])
    p.add_argument("--mesh", default=None, metavar="RxC",
                   help="device mesh shape, e.g. '8' (rows/slabs) or "
                        "'4x2' (blocks/pencils); default: all devices, 1D")
    p.add_argument("--tol", type=float, default=1e-6)
    p.add_argument("--cycle", default="v", choices=["v", "w", "fmg"])
    p.add_argument("--eigen", type=int, default=0, metavar="K",
                   help="instead of solving, find the K smallest "
                        "eigenpairs with the distributed eigensolver")
    p.add_argument("--eigen-method", default="ii",
                   choices=["ii", "rqi", "lobpcg"])
    p.add_argument("--f64", action="store_true")
    p.add_argument("--multihost", action="store_true",
                   help="call jax.distributed.initialize() first")
    args = p.parse_args()

    if args.multihost:
        jax.distributed.initialize()

    dtype = jnp.float64 if args.f64 else jnp.float32
    if args.mesh and "x" in args.mesh:
        r, c = (int(v) for v in args.mesh.split("x"))
        mesh = sharded.make_block_mesh((r, c))
        max_dev = max(r, c)
    elif args.mesh:
        mesh = sharded.make_mesh(jax.devices()[:int(args.mesh)])
        max_dev = int(args.mesh)
    else:
        mesh = sharded.make_mesh()
        max_dev = len(jax.devices())
    # Keep the fine level sharded on small demo grids: the default
    # agglomeration cutoff (64 rows/device — config.py) can exceed a toy
    # problem's whole per-device extent.
    agglom = max(2, min(64, 2 ** args.k // (2 * max_dev)))
    cfg = SolverConfig(ndim=args.ndim, k=args.k, dtype=dtype,
                       smoother="rbgs", cycle=args.cycle, tol=args.tol,
                       agglom_rows=agglom)
    solver = sharded.ShardedSolver(cfg, mesh)

    if args.eigen:
        res = solver.eigensolve(k=args.eigen, method=args.eigen_method,
                                tol=max(args.tol, 1e-9))
        if jax.process_index() == 0:
            lam = np.sort(np.asarray(res.eigenvalues))
            print(f"n={cfg.n}^{args.ndim} on {solver.ndev} devices "
                  f"(mesh {mesh.devices.shape}): iters={int(res.iters)} "
                  f"converged={bool(res.converged)}")
            print(f"eigenvalues: {lam}  (lambda_1 -> {args.ndim}*pi^2 = "
                  f"{args.ndim * np.pi ** 2:.6f} as h -> 0)")
        return

    prob = mg.poisson(args.k, ndim=args.ndim, dtype=dtype)
    res = solver.solve(prob.b)
    if jax.process_index() == 0:
        rho = float(mg.convergence_factor(res))
        print(f"n={cfg.n}^{args.ndim} on {solver.ndev} devices "
              f"(mesh {mesh.devices.shape}): iters={int(res.iters)}"
              f"  converged={bool(res.converged)}  rho={rho:.4f}")
        err = np.abs(np.asarray(mg.interior(res.x))
                     - np.asarray(mg.interior(prob.u_exact))).max()
        print(f"max error vs analytic solution: {err:.3e}")


if __name__ == "__main__":
    main()
