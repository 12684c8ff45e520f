"""BASELINE config 3: 2D 1023^2 FMG solve; discrete-L2 error vs the
analytic solution u = sin(pi x) sin(pi y), and the error-halving ratio
(~4 = second order) across grid sizes."""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from multigridcmt.utils.cache import enable_compile_cache

enable_compile_cache()

import argparse

import jax.numpy as jnp

import multigridcmt as mg


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--k", type=int, default=10, help="finest grid exponent")
    p.add_argument("--f64", action="store_true")
    p.add_argument("--plot", metavar="FILE", default=None,
                   help="write an error-vs-h PNG with an O(h^2) guide")
    p.add_argument("--cubic", action="store_true",
                   help="FMG-order (cubic) solution-walk interpolation "
                        "(config.fmg_prolong='cubic')")
    args = p.parse_args()

    dtype = jnp.float64 if args.f64 else jnp.float32
    prev = None
    ns, errs = [], []
    for k in range(max(5, args.k - 2), args.k + 1):
        prob = mg.poisson2d(k=k, smoother="rbgs", dtype=dtype,
                            fmg_prolong="cubic" if args.cubic
                            else "linear")
        solver = mg.MultigridSolver(prob)
        err = float(solver.discrete_l2_error(solver.fmg()))
        ratio = "" if prev is None else f"  ratio={prev / err:.2f}"
        print(f"n={prob.config.n:5d}  discrete-L2 error={err:.3e}{ratio}")
        ns.append(prob.config.n)
        errs.append(err)
        prev = err
    if args.plot:
        from multigridcmt.utils.plots import plot_error_convergence
        plot_error_convergence(ns, errs, args.plot)


if __name__ == "__main__":
    main()
