"""Multigrid-accelerated eigensolver for the smallest Laplacian eigenpairs.

Capability parity with the reference's eigensolver (SURVEY.md §2/§3.3):
inverse iteration and Rayleigh-quotient iteration with the inner solves done
by multigrid V-cycles, plus coarse-grid correction — here realized as a
nested-iteration initialization: the coarsest-level eigenproblem is solved
densely and the eigenvectors are prolonged up the hierarchy, so the fine-
level iteration starts from an O(h²)-accurate guess.

Supports k >= 1 eigenpairs via block (subspace) inverse iteration with
Rayleigh-Ritz projection. Everything after setup runs on device inside one
jitted ``lax.while_loop``; the k inner MG solves unroll statically over
the block (``_stack_map``).

Every block product (Gram, Rayleigh-Ritz, projections) asks for HIGHEST
precision: a float32 matrix product may otherwise run in TF32 on the GPU,
which keeps about three decimal digits.

Physics payload of the reference ("CMT"): the smallest eigenpair of the 2D
Dirichlet Laplacian is the particle-in-a-box ground state, lambda_1 -> 2*pi^2
as h -> 0 (SURVEY.md §0).
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import SolverConfig
from ..grids import Hierarchy, interior, pad_interior
from ..ops import laplacian, transfer
from . import cycles

HIGHEST = jax.lax.Precision.HIGHEST


def mm(a: jax.Array, b: jax.Array) -> jax.Array:
    """Matrix product at full precision (no TF32 for float32)."""
    return jnp.matmul(a, b, precision=HIGHEST)


class EigenResult(NamedTuple):
    eigenvalues: jax.Array    # (k,)
    eigenvectors: jax.Array   # (k, *padded_shape), interior-normalized
    iters: jax.Array          # outer iterations taken
    res_history: jax.Array    # (max_iters + 1,) max eigen-residual per iter
    converged: jax.Array


def _stack_map(fn, *arrs):
    """Apply ``fn`` over the leading (block-vector) axis by STATIC python
    unrolling. The block size is small and static; a batched (``vmap``)
    version is an open item."""
    kk = arrs[0].shape[0]
    return jnp.stack([fn(*(a[i] for a in arrs)) for i in range(kk)])


def _flat(v: jax.Array, ndim: int) -> jax.Array:
    """(k, *padded) -> (k, N) interior-flattened."""
    core = v[(slice(None),) + (slice(1, -1),) * ndim]
    return core.reshape(core.shape[0], -1)


def _unflat(f: jax.Array, n: int, ndim: int) -> jax.Array:
    """(k, N) -> (k, *padded)."""
    shape = (f.shape[0],) + (n,) * ndim
    return jax.vmap(pad_interior)(f.reshape(shape))


def _orthonormalize(f: jax.Array) -> jax.Array:
    """Row-orthonormalize (k, N) via QR of the transpose."""
    q, _ = jnp.linalg.qr(f.T)          # (N, k)
    return q.T


# ---------------------------------------------------------------------------
# Shared outer-iteration drivers (the cg_loop pattern, krylov.py): the
# single source of the II/RQI and LOBPCG recurrences and their tuning
# constants, used by the single-device solvers below AND the distributed
# twins in parallel/sharded.py — the two differ only in the primitives
# they inject (plain jnp dots vs mesh psums, vmapped MG solves vs
# distributed cycles).
# ---------------------------------------------------------------------------

# RQI shift schedule (see the eigensolve docstring for the derivation):
# shifts activate once inverse iteration has localized the eigenvalues,
# and drop again in the endgame so plain II polishes to tol.
RQI_ACTIVE_TOL = 1e-2
RQI_POLISH_TOL = 1e-5
# Back-off floor: the re-discretized coarse operators see lambda_1 with
# O(h_coarse^2) error (~5% on the 3^2 coarsest grid); a 10% relative gap
# keeps every level SPD so the shifted MG inner solves converge.
RQI_BACKOFF = 0.9


def ii_loop(v, *, rayleigh, inner_solve, ritz, method: str, tol: float,
            max_iters: int, dtype, rqi_backoff: float = RQI_BACKOFF):
    """Block inverse-iteration / RQI outer driver.

    Injected primitives (each in the caller's native block layout):
      rayleigh(v)        -> (lam (k,), max residual scalar)
      inner_solve(v, s)  -> MG-solve (A - s_i I) w_i = v_i per row; s is
                           None for plain II (lets the caller keep the
                           shift statically zero -> fast coarse solve)
      ritz(w)            -> (Ritz block, Ritz values)

    Runs inside one lax.while_loop with the cumulative eigen divergence
    guard (cycles.eigen_guard). Returns (v, lam, iters, hist, res) with
    hist of static length max_iters + 1, backfilled past iters.
    """
    lam0, res0 = rayleigh(v)
    hist0 = jnp.full((max_iters + 1,), res0, dtype=dtype)

    def cond(st):
        _, _, it, _, res, div = st
        return ((res >= tol) & (it < max_iters)
                & (div < cycles.EIGEN_DIVERGE_TOTAL))

    def body(st):
        v, lam, it, hist, res, div = st
        if method == "rqi":
            shift_on = (res < RQI_ACTIVE_TOL) & (res > RQI_POLISH_TOL)
            sigma = jnp.where(shift_on, lam * rqi_backoff,
                              jnp.zeros_like(lam))
            w = inner_solve(v, sigma)
        else:
            w = inner_solve(v, None)
        v2, _ = ritz(w)
        lam2, res2 = rayleigh(v2)
        div = cycles.eigen_guard(res2, res, div)
        hist = hist.at[it + 1].set(res2)
        return v2, lam2, it + 1, hist, res2, div

    v, lam, iters, hist, res, _ = jax.lax.while_loop(
        cond, body, (v, lam0, 0, hist0, res0, 0))
    idx = jnp.arange(max_iters + 1)
    hist = jnp.where(idx <= iters, hist, res)
    return v, lam, iters, hist, res


def lobpcg_loop(x, *, k: int, rq_res, tcycle, project_out, safe_rownorm,
                rr, combine, tol: float, max_iters: int, dtype):
    """LOBPCG outer driver (Knyazev 2001, "ortho" variant).

    Injected primitives (x is an ORTHONORMAL block in the caller's native
    layout; rows are block vectors):
      rq_res(x)            -> (lam, residual block, max residual scalar)
      tcycle(r)            -> preconditioner (V-cycle(s)) per row
      project_out(f, base) -> f minus its components along base's rows
      safe_rownorm(v, salt)-> row-normalize, dead rows -> pseudo-random
      rr(s, nkeep)         -> Rayleigh-Ritz coefficients (m, nkeep), values
      combine(c, s)        -> the Ritz block c^T s in the native layout

    Iteration 0 does a RR on [X, W]; the main lax.while_loop on
    [X, W, P]. Returns (x, lam, iters, hist, res).
    """
    lam, r, res0 = rq_res(x)
    hist = jnp.full((max_iters + 1,), res0, dtype=dtype)
    w = safe_rownorm(project_out(tcycle(r), x), jnp.asarray(0.0, dtype))
    s = jnp.concatenate([x, w], axis=0)
    c, _ = rr(s, k)
    # Ritz vectors are G-orthonormal by construction (c^T G c = I); a QR
    # here would scramble the eigenpair ordering, so only row-normalize.
    x1 = safe_rownorm(combine(c, s), jnp.asarray(0.5, dtype))
    p1 = safe_rownorm(combine(c[k:, :], w), jnp.asarray(1.0, dtype))
    lam1, _, res1 = rq_res(x1)
    hist = hist.at[1].set(res1)

    def cond(st):
        _, _, _, it, _, res, div = st
        return ((res >= tol) & (it < max_iters)
                & (div < cycles.EIGEN_DIVERGE_TOTAL))

    def body(st):
        x, p, lam, it, hist, res, div = st
        _, r, _ = rq_res(x)
        salt = it.astype(dtype)
        w = safe_rownorm(project_out(tcycle(r), x), 2.0 * salt + 2.0)
        p = safe_rownorm(
            project_out(p, jnp.concatenate([x, w], axis=0)),
            2.0 * salt + 3.0)
        s = jnp.concatenate([x, w, p], axis=0)
        c, _ = rr(s, k)
        xn = safe_rownorm(combine(c, s), 2.0 * salt + 4.0)
        pn = combine(c[k:, :], s[k:])     # the W+P contribution (Knyazev)
        lam2, _, res2 = rq_res(xn)
        div = cycles.eigen_guard(res2, res, div)
        hist = hist.at[it + 1].set(res2)
        return xn, pn, lam2, it + 1, hist, res2, div

    x, p, lam, iters, hist, res, _ = jax.lax.while_loop(
        cond, body, (x1, p1, lam1, 1, hist, res1, 0))
    idx = jnp.arange(max_iters + 1)
    hist = jnp.where(idx <= iters, hist, res)
    return x, lam, iters, hist, res


def coarse_init(hier: Hierarchy, k: int, dtype) -> jax.Array:
    """Nested-iteration start: dense eigh on the coarsest level, prolong up.

    This is the coarse-grid-correction leg of the reference's eigensolver
    (SURVEY.md §3.3): the eigenproblem is solved exactly on the coarse grid
    and the eigenvectors are interpolated to the fine grid.
    """
    a = hier.coarse_dense.astype(dtype)
    _, vecs = jnp.linalg.eigh(a)
    nc = hier.coarsest.n
    v = vecs[:, :k].T.reshape((k,) + (nc,) * hier.ndim)
    v = jax.vmap(pad_interior)(v)
    for _ in range(hier.num_levels - 1):
        v = jax.vmap(transfer.prolong)(v)
    return v


@partial(jax.jit, static_argnames=("config", "k", "method", "inner_cycles",
                                   "max_iters", "inner_tol", "rqi_backoff"))
def eigensolve(hier: Hierarchy, config: SolverConfig, k: int = 1,
               method: str = "ii", tol: float = 1e-8, max_iters: int = 100,
               inner_cycles: int = 30, inner_tol: float | None = None,
               rqi_backoff: float = RQI_BACKOFF,
               v0: jax.Array | None = None) -> EigenResult:
    """Find the k smallest eigenpairs of the discrete Laplacian.

    ``v0`` (a (k, *padded) block, e.g. a previous run's ``eigenvectors``)
    warm-starts the iteration in place of the nested-iteration coarse
    init — the checkpoint/resume entry point
    (``utils.checkpoint.resume_solve``); the block is re-orthonormalized,
    so any spanning set works.

    method="ii": block inverse iteration — each outer step MG-solves
    A w_i = v_i, then Rayleigh-Ritz. method="rqi": after an
    inverse-iteration warmup, shift the inner solves by the current
    Rayleigh quotient (sigma = lambda_i per vector) for cubic local
    convergence; the MG smoothers/coarse solve take the traced shift.

    The inner solves run V-cycles to relative residual ``inner_tol``
    (default: near the dtype's roundoff floor), capped at ``inner_cycles``
    cycles. A tolerance-driven inner solve is essential: with a *fixed*
    cycle count the iteration converges to an eigenvector of the
    approximate inverse (the fixed linear operator "m cycles of MG"), and
    the eigen-residual stalls at the inner-solver error instead of
    reaching ``tol``.

    Convergence: max_i ||A v_i - lambda_i v_i|| / lambda_i < tol.
    """
    if method not in ("ii", "rqi"):
        raise ValueError(f"unknown eigensolver method {method!r}")
    ndim, n, h = hier.ndim, hier.fine.n, hier.fine.h
    dtype = config.dtype

    if v0 is None:
        v = coarse_init(hier, k, dtype)        # (k, *padded)
    else:
        # Sanitize ghosts (the ops rely on the zero-ghost invariant).
        v = jax.vmap(lambda u: pad_interior(interior(u)))(
            jnp.asarray(v0, dtype))
    v = _unflat(_orthonormalize(_flat(v, ndim)), n, ndim)

    apply_v = jax.vmap(lambda u: laplacian.apply_poisson(u, h))

    def rayleigh(vv):
        av = apply_v(vv)
        fv, fav = _flat(vv, ndim), _flat(av, ndim)
        lam = jnp.sum(fv * fav, axis=1) / jnp.sum(fv * fv, axis=1)
        res = jnp.linalg.norm(fav - lam[:, None] * fv, axis=1) / jnp.abs(lam)
        return lam, jnp.max(res)

    if inner_tol is None:
        inner_tol = 200.0 * float(jnp.finfo(dtype).eps)

    def inner_solve(vv, sigma=None):
        """MG-solve (A - sigma I) w = v to inner_tol, per block vector.

        sigma=None keeps the shift *statically* zero so the coarsest solve
        stays the fast precomputed-inverse matmul (cycles.coarse_solve)."""
        def one(rhs, sg=0.0):
            rhs_norm = jnp.sqrt(jnp.sum(rhs * rhs))
            rhs_norm = jnp.where(rhs_norm == 0, 1.0, rhs_norm)

            def cond(st):
                w, i, rel = st
                return (rel >= inner_tol) & (i < inner_cycles)

            def body(st):
                w, i, rel = st
                w = cycles.v_cycle(hier, w, rhs, config, sigma=sg)
                r = laplacian.residual(w, rhs, h, sigma=sg)
                rel = jnp.sqrt(jnp.sum(r * r)) / rhs_norm
                return w, i + 1, rel

            w, _, _ = jax.lax.while_loop(
                cond, body,
                (jnp.zeros_like(rhs), 0, jnp.ones((), dtype=dtype)))
            return w
        if sigma is None:
            return _stack_map(one, vv)
        return _stack_map(one, vv, sigma)

    def ritz(vv):
        """Rayleigh-Ritz: orthonormalize, project, rotate to Ritz vectors."""
        f = _orthonormalize(_flat(vv, ndim))
        vv = _unflat(f, n, ndim)
        fav = _flat(apply_v(vv), ndim)
        hmat = mm(f, fav.T)                     # (k, k), symmetric
        lam, s = jnp.linalg.eigh(0.5 * (hmat + hmat.T))
        return _unflat(mm(s.T, f), n, ndim), lam

    # RQI shift schedule (ii_loop): shifts activate once inverse
    # iteration has localized the eigenvalues (res < RQI_ACTIVE_TOL) —
    # the backed-off sigma = rqi_backoff * lam sits strictly BELOW
    # lambda_min (the Rayleigh quotient overestimates it by O(res^2) and
    # the re-discretized coarse operators see it with ~5% O(h_coarse^2)
    # error), so (A - sigma I) stays SPD on every level and multigrid on
    # it converges, giving superlinear convergence without the
    # indefinite-operator breakdown of a textbook sigma = lambda shift.
    # Near convergence (res < RQI_POLISH_TOL) the shifted inner solves
    # can't reach inner_tol within the cycle cap (the nearly-null mode
    # converges slowly), which would floor the eigen-residual at the
    # inner error — the endgame drops the shift and lets plain inverse
    # iteration polish to tol.
    def inner(vv, sigma):
        return inner_solve(vv) if sigma is None else inner_solve(vv, sigma)

    v, lam, iters, hist, res = ii_loop(
        v, rayleigh=rayleigh, inner_solve=inner, ritz=ritz, method=method,
        tol=tol, max_iters=max_iters, dtype=dtype, rqi_backoff=rqi_backoff)
    return EigenResult(eigenvalues=lam, eigenvectors=v, iters=iters,
                       res_history=hist, converged=res < tol)


# ---------------------------------------------------------------------------
# LOBPCG: locally optimal block preconditioned conjugate gradients.
# ---------------------------------------------------------------------------

def _safe_rownorm(f: jax.Array, salt: jax.Array) -> jax.Array:
    """Normalize block rows; replace (near-)zero rows by a deterministic
    pseudo-random direction so the Rayleigh-Ritz Gram matrix never picks
    up a spurious zero eigenvalue from a dead search direction (happens
    when one eigenpair converges to roundoff while others lag)."""
    nrm = jnp.linalg.norm(f, axis=1, keepdims=True)
    eps = jnp.finfo(f.dtype).eps
    rows = jnp.arange(f.shape[0], dtype=f.dtype)[:, None]
    cols = jnp.arange(f.shape[1], dtype=f.dtype)[None, :]
    fallback = jnp.sin((salt + 1.0) * (rows + 1.0) + 0.7391 * cols)
    fallback = fallback / jnp.linalg.norm(fallback, axis=1, keepdims=True)
    good = nrm > eps * eps
    return jnp.where(good, f / jnp.where(good, nrm, 1.0), fallback)


@partial(jax.jit, static_argnames=("config", "k", "max_iters",
                                   "precond_cycles"))
def lobpcg(hier: Hierarchy, config: SolverConfig, k: int = 1,
           tol: float = 1e-8, max_iters: int = 100,
           precond_cycles: int = 1,
           v0: jax.Array | None = None) -> EigenResult:
    """MG-preconditioned LOBPCG for the k smallest eigenpairs.

    Locally optimal block PCG (Knyazev, SIAM J. Sci. Comput. 23(2), 2001):
    each step does a Rayleigh-Ritz on span{X, T R, P} where T is the
    preconditioner — here ``precond_cycles`` multigrid V-cycle(s) — and P
    carries the previous step's update direction (the "conjugate" term
    that upgrades preconditioned steepest descent to a CG-like method).

    Beats the reference-parity inverse iteration (``eigensolve``) on work
    per digit: one V-cycle per block vector per outer step, versus a full
    MG *solve* (many cycles to near roundoff) per step — LOBPCG only needs
    the preconditioner to be a fixed SPD approximate inverse, not an exact
    solve, because the Ritz step re-projects on the true operator A.

    Stability follows the "ortho" variant (Hetmaniuk & Lehoucq, JCP 2006):
    W is orthogonalized against X, P against [X, W], so the 3k x 3k Gram
    matrix stays near identity and its (jittered) Cholesky is safe; the
    new P is assembled from the exact W/P contributions of the Ritz
    vectors, keeping the three-term structure.
    """
    ndim, n, h = hier.ndim, hier.fine.n, hier.fine.h
    dtype = config.dtype

    apply_v = jax.vmap(lambda u: laplacian.apply_poisson(u, h))

    def apply_flat(f):
        """(m, N) interior-flattened block -> A applied row-wise."""
        return _flat(apply_v(_unflat(f, n, ndim)), ndim)

    def tcycle(r_flat):
        """Preconditioner: precond_cycles V-cycles from a zero guess."""
        rp = _unflat(r_flat, n, ndim)

        def one(rhs):
            w = jnp.zeros_like(rhs)
            for _ in range(precond_cycles):
                w = cycles.v_cycle(hier, w, rhs, config)
            return w

        return _flat(_stack_map(one, rp), ndim)

    def rq_res(x):
        """Rayleigh quotients + residual rows of an orthonormal block."""
        ax = apply_flat(x)
        lam = jnp.sum(x * ax, axis=1)
        r = ax - lam[:, None] * x
        res = jnp.linalg.norm(r, axis=1) / jnp.abs(lam)
        return lam, r, jnp.max(res)

    def project_out(f, basis):
        """Remove the components of f's rows along basis's rows (basis
        rows orthonormal); applied twice for fp-grade orthogonality."""
        for _ in range(2):
            f = f - mm(mm(f, basis.T), basis)
        return f

    def rr(s, nkeep):
        """Rayleigh-Ritz on the row-basis s: coefficient matrix c
        (m, nkeep) with S^T c columns the Ritz vectors, plus values."""
        m = s.shape[0]
        g = mm(s, s.T)
        hm = mm(s, apply_flat(s).T)
        hm = 0.5 * (hm + hm.T)
        eps = jnp.asarray(jnp.finfo(dtype).eps, dtype)
        jit_g = g + (100.0 * eps * jnp.trace(g)) * jnp.eye(m, dtype=dtype)
        ell = jnp.linalg.cholesky(jit_g)
        li = jax.scipy.linalg.solve_triangular(
            ell, jnp.eye(m, dtype=dtype), lower=True)
        ht = mm(mm(li, hm), li.T)
        theta, y = jnp.linalg.eigh(0.5 * (ht + ht.T))
        c = mm(li.T, y[:, :nkeep])
        return c, theta[:nkeep]

    # Nested-iteration start (or a caller-supplied warm start — see
    # eigensolve's v0); lobpcg_loop does iteration 0's RR on [X, W] and
    # the main loop on [X, W, P].
    if v0 is None:
        v_init = coarse_init(hier, k, dtype)
    else:
        v_init = jax.vmap(lambda u: pad_interior(interior(u)))(
            jnp.asarray(v0, dtype))
    x = _orthonormalize(_flat(v_init, ndim))
    x, lam, iters, hist, res = lobpcg_loop(
        x, k=k, rq_res=rq_res, tcycle=tcycle, project_out=project_out,
        safe_rownorm=_safe_rownorm, rr=rr,
        combine=lambda c, s: mm(c.T, s),
        tol=tol, max_iters=max_iters, dtype=dtype)
    # eigh returns ascending Ritz values; lam is already sorted.
    return EigenResult(eigenvalues=lam, eigenvectors=_unflat(x, n, ndim),
                       iters=iters, res_history=hist, converged=res < tol)
