"""BASELINE config 2: 2D Poisson 255^2, red-black Gauss-Seidel V-cycle,
5 levels (min_coarse picked so the hierarchy has exactly 5 levels)."""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from multigridcmt.utils.cache import enable_compile_cache

enable_compile_cache()

import argparse

import jax.numpy as jnp

import multigridcmt as mg
from multigridcmt.utils.metrics import MetricsLogger


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--k", type=int, default=8, help="grid: (2^k - 1)^2")
    p.add_argument("--levels", type=int, default=5)
    p.add_argument("--tol", type=float, default=1e-8)
    p.add_argument("--plot", metavar="FILE", default=None,
                   help="write a residual-history PNG (reference-style)")
    p.add_argument("--method", choices=("mg", "pcg"), default="mg",
                   help="stationary V-cycles or MG-preconditioned CG")
    args = p.parse_args()

    min_coarse = 2 ** (args.k - args.levels + 1) - 1
    prob = mg.poisson2d(k=args.k, smoother="rbgs", tol=args.tol,
                        min_coarse=min_coarse, dtype=jnp.float32)
    assert prob.hierarchy.num_levels == args.levels
    res = mg.MultigridSolver(prob).solve(method=args.method)
    if args.plot:
        from multigridcmt.utils.plots import plot_residual_history
        plot_residual_history(
            {f"V(2,2) RBGS, n={prob.config.n}^2": res.res_history},
            args.plot, title="2D Poisson V-cycle residual history")
    MetricsLogger().log_solve_result(res, prob.config)
    print(f"n={prob.config.n}^2  levels={args.levels}  "
          f"iters={int(res.iters)}  rho={float(mg.convergence_factor(res)):.4f}")


if __name__ == "__main__":
    main()
