"""3D Poisson demo (capability extension beyond the reference's 1D/2D):
solve -laplace(u) = f on the unit cube, (2^k - 1)^3 interior grid, with any
smoother/cycle and optional MG-preconditioned CG; reports the convergence
factor and the discrete-L2 error vs the analytic u = prod sin(pi x_i)."""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from multigridcmt.utils.cache import enable_compile_cache

enable_compile_cache()

import argparse

import numpy as np
import jax.numpy as jnp

import multigridcmt as mg


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--k", type=int, default=6, help="grid: (2^k - 1)^3")
    p.add_argument("--smoother", choices=["jacobi", "rbgs", "chebyshev"],
                   default="chebyshev")
    p.add_argument("--method", choices=["mg", "pcg"], default="mg")
    p.add_argument("--cycle", choices=["v", "w", "fmg"], default="v")
    p.add_argument("--tol", type=float, default=1e-9)
    p.add_argument("--f32", action="store_true", help="float32 (default f64)")
    args = p.parse_args()

    prob = mg.poisson3d(k=args.k, smoother=args.smoother, cycle=args.cycle,
                        tol=args.tol,
                        dtype=jnp.float32 if args.f32 else jnp.float64)
    solver = mg.MultigridSolver(prob)
    res = solver.solve(method=args.method)
    rho = float(mg.convergence_factor(res))
    err = float(solver.discrete_l2_error(res.x))
    n = prob.config.n
    print(f"n={n}^3 ({n ** 3:,} unknowns)  smoother={args.smoother}  "
          f"method={args.method}")
    print(f"  iters={int(res.iters)}  converged={bool(res.converged)}  "
          f"rho={rho:.4f}")
    print(f"  discrete-L2 error vs analytic: {err:.3e}  "
          f"(h^2 = {prob.config.h ** 2:.3e})")


if __name__ == "__main__":
    main()
