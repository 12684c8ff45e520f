"""Multigrid-preconditioned conjugate gradients (MG-PCG).

Beyond reference parity (AndyMN/MultigridCMT iterates plain V-cycles —
SURVEY.md §3.1): wrapping the V-cycle in a Krylov accelerator is the
standard production upgrade for SPD problems. One V-cycle per iteration is
the preconditioner ``z = M^-1 r``; CG then minimizes the A-norm of the
error over the generated Krylov space, which

  * squeezes the convergence factor below the stationary V-cycle's rho
    (the CG polynomial is optimal, the stationary iteration's is fixed), and
  * rescues configurations where the stationary cycle is slow or stalls
    (strong shifts, low-precision arithmetic).

The entire iteration — V-cycle preconditioner, matrix-free operator
applies, dot products, residual history — runs on device inside one
``lax.while_loop``, so the hot path is the same compiled cycle as the
stationary solve.

The Polak-Ribiere (flexible-CG) beta ``z'(r_new - r_old) / z'r`` is used
instead of the textbook Fletcher-Reeves form: the RB-GS-smoothed V-cycle is
not an exactly symmetric operator (red-then-black ordering), and flexible
CG stays convergent for such slightly nonsymmetric preconditioners at the
cost of one extra dot product.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..config import SolverConfig
from ..grids import Hierarchy, interior, pad_interior
from ..ops import laplacian
from . import cycles


def _dot(a: jax.Array, b: jax.Array) -> jax.Array:
    # Whole-array dots are interior dots: ghost cells are zero by
    # invariant.
    return jnp.sum(a * b)


def cg_loop(x, b, *, dot, apply_a, precond, residual, tol, max_iters):
    """Flexible (Polak-Ribiere) preconditioned-CG iteration driver.

    The single source of the CG recurrence, shared by the single-device
    solver below and the distributed solver (``parallel.sharded``) — the
    two differ only in their primitives, which come in as callables:

      dot(a, b)      inner product (plain ``jnp.sum`` or mesh ``psum``)
      apply_a(p)     operator apply in the caller's tile layout
      precond(r)     one V-cycle from a zero guess
      residual(x, b) r = b - A x (one fused stencil pass — cheaper than
                     ``b - apply_a(x)``)

    Runs entirely inside one ``lax.while_loop`` with the same stall and
    divergence guards as ``cycles.solve`` (``cycles.step_guards``).
    Returns ``(x, iters, hist, rel)`` where ``hist`` has static length
    ``max_iters + 1``, entries past ``iters`` backfilled with the final
    relative residual.
    """
    b_norm = jnp.sqrt(dot(b, b))
    b_norm = jnp.where(b_norm == 0, 1.0, b_norm)

    r = residual(x, b)
    rel0 = jnp.sqrt(dot(r, r)) / b_norm
    z = precond(r)
    p = z
    rz = dot(r, z)
    hist0 = jnp.full((max_iters + 1,), rel0, dtype=b.dtype)

    def cond(state):
        x, r, z, p, rz, k, hist, rel, stall, div = state
        return ((rel >= tol) & (k < max_iters)
                & cycles.guards_ok(stall, div))

    def body(state):
        x, r, z, p, rz, k, hist, rel, stall, div = state
        ap = apply_a(p)
        pap = dot(p, ap)
        alpha = rz / jnp.where(pap == 0, 1.0, pap)
        x = x + alpha * p
        r_new = r - alpha * ap
        new_rel = jnp.sqrt(dot(r_new, r_new)) / b_norm
        z_new = precond(r_new)
        rz_new = dot(r_new, z_new)
        beta = (rz_new - dot(z_new, r)) / jnp.where(rz == 0, 1.0, rz)
        p = z_new + beta * p
        stall, div = cycles.step_guards(new_rel, rel, stall, div)
        hist = hist.at[k + 1].set(new_rel)
        return x, r_new, z_new, p, rz_new, k + 1, hist, new_rel, stall, div

    x, r, z, p, rz, iters, hist, rel, _, _ = jax.lax.while_loop(
        cond, body, (x, r, z, p, rz, 0, hist0, rel0, 0, 0))
    idx = jnp.arange(max_iters + 1)
    hist = jnp.where(idx <= iters, hist, rel)
    return x, iters, hist, rel


@partial(jax.jit, static_argnames=("config",))
def solve_pcg(hier: Hierarchy, b: jax.Array, config: SolverConfig,
              x0: jax.Array | None = None) -> cycles.SolveResult:
    """Solve A x = b by CG preconditioned with one V-cycle per iteration.

    Same contract as ``cycles.solve``: iterate until
    ``||r|| / ||b|| < config.tol`` or ``config.max_iters``, returning a
    ``SolveResult`` whose ``res_history`` holds the relative residual after
    each iteration (CG iterations play the role of cycles).
    """
    h = hier.fine.h
    b = pad_interior(interior(b))
    x = (jnp.zeros_like(b) if x0 is None else pad_interior(interior(x0)))

    zeros = jnp.zeros_like(b)

    def apply_a(p):
        # A p = -(b' - A p) with b' = 0: the residual stencil.
        return -laplacian.residual(p, zeros, h)

    def precond(r):
        return cycles.cycle(hier, jnp.zeros_like(r), r, config)

    x, iters, hist, rel = cg_loop(
        x, b, dot=_dot, apply_a=apply_a, precond=precond,
        residual=lambda xx, bb: laplacian.residual(xx, bb, h),
        tol=config.tol, max_iters=config.max_iters)
    return cycles.SolveResult(x=x, iters=iters, res_history=hist,
                              converged=rel < config.tol)
