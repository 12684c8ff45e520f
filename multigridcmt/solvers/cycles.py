"""Multigrid cycle drivers: V-cycle, W-cycle, FMG, and the outer solve loop.

Capability parity with the reference's recursive cycle drivers
(SURVEY.md §3.1/§3.2): pre-smooth, restrict residual, recurse, prolong and
correct, post-smooth, with a direct solve on the coarsest level, plus the
full-multigrid (FMG) driver that walks the hierarchy coarse-to-fine.

The reference's Python recursion is unrolled at trace time over the
*static* level list (`grids.Hierarchy`), so a whole V-cycle — and in fact
the whole outer iteration via `lax.while_loop` — compiles to a single XLA
program: one host->device dispatch per solve, not per smoothing sweep. The
coarsest solve is a tiny dense matmul against a precomputed inverse instead
of the reference's `spsolve`.

All grid arrays are padded with a one-cell zero ghost boundary (`grids.py`)
and every op is the plain `jax.numpy` stencil from `ops/`, except the 2D
RB-GS sweep, which `smooth` hands to the two-colour GPU kernel where that
kernel wins (`kernels/rbgs2d.py`).
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import SolverConfig
from ..grids import Hierarchy, interior, pad_interior
from ..kernels import rbgs2d
from ..ops import laplacian, smoothers, transfer
from ..utils import profiling


def smooth(u: jax.Array, b: jax.Array, h: float, config: SolverConfig,
           sweeps: int, sigma=0.0) -> jax.Array:
    """``sweeps`` sweeps of the configured smoother on one level."""
    if config.smoother == "rbgs" and rbgs2d.use_kernel(u):
        for _ in range(sweeps):
            u = rbgs2d.rbgs_sweep(u, b, h, sigma)
        return u
    return smoothers.smooth(u, b, h, kind=config.smoother,
                            omega=config.effective_omega(), sweeps=sweeps,
                            sigma=sigma)


def coarse_solve(hier: Hierarchy, b: jax.Array, sigma=0.0) -> jax.Array:
    """Direct solve on the coarsest level.

    sigma == 0 (static): single small matmul against the precomputed dense
    inverse, at HIGHEST precision (a float32 product may otherwise run in
    TF32 on the GPU). Shifted (traced sigma, eigensolver path): dense
    ``jnp.linalg.solve`` on (A_c - sigma*I) — the coarsest operator is tiny.
    """
    nc = hier.coarsest.n
    r = interior(b).reshape(-1)
    if laplacian._is_zero(sigma):
        x = jnp.matmul(hier.coarse_inv, r.astype(hier.coarse_inv.dtype),
                       precision=jax.lax.Precision.HIGHEST).astype(r.dtype)
    else:
        cd = hier.coarse_dense
        a = cd - jnp.asarray(sigma, dtype=cd.dtype) * jnp.eye(
            cd.shape[0], dtype=cd.dtype)
        x = jnp.linalg.solve(a, r.astype(cd.dtype)).astype(r.dtype)
    shape = (nc,) * hier.ndim
    return pad_interior(x.reshape(shape))


def v_cycle(hier: Hierarchy, x: jax.Array, b: jax.Array,
            config: SolverConfig, level: int = 0, sigma=0.0,
            gamma: int = 1) -> jax.Array:
    """One multigrid cycle starting at ``level`` (gamma=1: V, gamma=2: W).

    Mirrors the reference's recursive driver (SURVEY.md §3.1); the Python
    recursion unrolls at trace time because the hierarchy is static.
    """
    spec = hier.levels[level]
    if level == hier.num_levels - 1:
        with profiling.level_scope(level):
            return coarse_solve(hier, b, sigma)
    with profiling.level_scope(level):
        x = smooth(x, b, spec.h, config, config.nu1, sigma)
        rc = transfer.restrict(laplacian.residual(x, b, spec.h, sigma=sigma))
        ec = jnp.zeros_like(rc)
    for _ in range(gamma):
        ec = v_cycle(hier, ec, rc, config, level=level + 1, sigma=sigma,
                     gamma=gamma)
    with profiling.level_scope(level):
        x = x + transfer.prolong(ec)
        x = smooth(x, b, spec.h, config, config.nu2, sigma)
    return x


def cycle(hier: Hierarchy, x: jax.Array, b: jax.Array,
          config: SolverConfig, sigma=0.0) -> jax.Array:
    """One cycle of the configured type from the finest level."""
    gamma = 2 if config.cycle == "w" else 1
    return v_cycle(hier, x, b, config, level=0, sigma=sigma, gamma=gamma)


def fmg(hier: Hierarchy, b: jax.Array, config: SolverConfig,
        n_vcycles: int = 1) -> jax.Array:
    """Full multigrid (SURVEY.md §3.2): O(N) solve to discretization accuracy.

    Restrict b through the whole hierarchy, direct-solve the coarsest, then
    walk up: prolong the current solution as the initial guess and run
    ``n_vcycles`` V-cycles at each level.
    """
    bs = [b]
    for _ in range(hier.num_levels - 1):
        bs.append(transfer.restrict(bs[-1]))
    x = coarse_solve(hier, bs[-1])
    for level in range(hier.num_levels - 2, -1, -1):
        if config.fmg_prolong == "cubic":
            # FMG-order interpolation for the solution walk (SURVEY.md
            # §3.2); the within-cycle correction prolongation stays
            # (bi)linear.
            x = transfer.fmg_prolong(x)
        else:
            x = transfer.prolong(x)
        for _ in range(n_vcycles):
            x = v_cycle(hier, x, bs[level], config, level=level)
    return x


class SolveResult(NamedTuple):
    x: jax.Array             # padded solution
    iters: jax.Array         # number of cycles taken (scalar int)
    res_history: jax.Array   # (max_iters + 1,) relative residual norms;
                             # entries past `iters` hold the final value
    converged: jax.Array     # bool scalar


def _norm(v: jax.Array) -> jax.Array:
    return jnp.sqrt(jnp.sum(v * v))


# In-loop failure detection (SURVEY.md §5: "divergence guard on the
# residual history (abort if rho >= 1)"). Two cheap counters folded into
# every outer while_loop, so a diverging solve — e.g. a bad eigensolver
# shift making a level indefinite, or an unstable smoother omega — aborts
# within a couple of iterations with converged=False instead of spinning
# to max_iters and returning an overflow/NaN field:
#   stall: residual not improving (>= 0.9x) — the dtype roundoff floor.
#   diverge: residual GREW by more than DIVERGE_FACTOR in one iteration,
#            DIVERGE_PATIENCE times in a row. rho slightly above 1 is
#            indistinguishable from a stall (and the stall guard gets it);
#            10x-per-cycle growth twice is unambiguous divergence.
STALL_PATIENCE = 3
DIVERGE_FACTOR = 10.0
DIVERGE_PATIENCE = 2


def step_guards(new_rel, rel, stall, div):
    """Updated (stall, diverge) counters after one outer iteration."""
    stall = jnp.where(new_rel >= 0.9 * rel, stall + 1, 0)
    div = jnp.where(new_rel > DIVERGE_FACTOR * rel, div + 1, 0)
    return stall, div


def guards_ok(stall, div):
    return (stall < STALL_PATIENCE) & (div < DIVERGE_PATIENCE)


# Eigensolver outers use a CUMULATIVE growth counter instead: a broken
# shift (indefinite operator) typically makes the eigen-residual
# *oscillate* — up 10x, down, up again — because the Ritz step
# renormalizes every iteration, so a consecutive counter never fires.
# Legitimate runs bump at most once or twice (shift activation), far
# below this total.
EIGEN_DIVERGE_TOTAL = 4


def eigen_guard(new_res, res, div):
    """Cumulative count of >DIVERGE_FACTOR eigen-residual growths."""
    return div + jnp.where(new_res > DIVERGE_FACTOR * res, 1, 0)


@partial(jax.jit, static_argnames=("config",))
def solve(hier: Hierarchy, b: jax.Array, config: SolverConfig,
          x0: jax.Array | None = None) -> SolveResult:
    """Iterate cycles until ||r|| / ||b|| < config.tol (SURVEY.md §3.1).

    The whole loop — including residual-history bookkeeping — runs on
    device inside one ``lax.while_loop``; the history has static length
    ``max_iters + 1`` (XLA needs static shapes).
    """
    h = hier.fine.h
    # Sanitize: every op relies on the zero-ghost invariant, and the norms
    # below are whole-array — zero the ghost boundary of user inputs.
    b = pad_interior(interior(b))
    if config.cycle == "fmg":
        # FMG is a direct method: run it once, then report its residual and
        # polish with V-cycles if the tolerance asks for more.
        x = fmg(hier, b, config)
    else:
        x = (jnp.zeros_like(b) if x0 is None
             else pad_interior(interior(x0)))
    # Full-array norms are interior norms: ghosts are zero by invariant.
    b_norm = _norm(b)
    b_norm = jnp.where(b_norm == 0, 1.0, b_norm)

    def res_norm(x):
        return _norm(laplacian.residual(x, b, h))

    r0 = res_norm(x) / b_norm
    hist0 = jnp.full((config.max_iters + 1,), r0, dtype=b.dtype)

    # Stall guard: when the residual hits the dtype's roundoff floor (fp32
    # stalls near ~1e-4 relative for fine grids — 1/h^2 cancellation), the
    # iteration stops improving; exit after 3 non-improving cycles instead
    # of spinning to max_iters with rho ~ 1. Divergence guard: see
    # step_guards above.
    def cond(state):
        x, k, hist, rel, stall, div = state
        return ((rel >= config.tol) & (k < config.max_iters)
                & guards_ok(stall, div))

    def body(state):
        x, k, hist, rel, stall, div = state
        x = cycle(hier, x, b, config)
        new_rel = res_norm(x) / b_norm
        stall, div = step_guards(new_rel, rel, stall, div)
        hist = hist.at[k + 1].set(new_rel)
        return x, k + 1, hist, new_rel, stall, div

    x, iters, hist, rel, _, _ = jax.lax.while_loop(
        cond, body, (x, 0, hist0, r0, 0, 0))
    # Entries past `iters` were never written; backfill them with the final
    # residual so downstream convergence-factor code can mask cleanly.
    idx = jnp.arange(config.max_iters + 1)
    hist = jnp.where(idx <= iters, hist, rel)
    return SolveResult(x=x, iters=iters, res_history=hist,
                       converged=rel < config.tol)


def convergence_factor(result: SolveResult) -> jax.Array:
    """Geometric-mean residual reduction per cycle over the iterations run.

    rho = (r_final / r_0) ** (1 / iters) — the metric the reference reports
    and BASELINE.json bounds (match within <= 0.1).
    """
    r0 = result.res_history[0]
    rk = result.res_history[result.iters]
    iters = jnp.maximum(result.iters, 1)
    return (rk / r0) ** (1.0 / iters)
