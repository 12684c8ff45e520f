"""User-facing API: problem builders and the MultigridSolver facade.

Mirrors the reference's public surface (SURVEY.md §1 "Public interface"):
``assemble -> A, b``, ``smooth``, ``restrict``, ``prolong``, ``v_cycle``,
``fmg``, ``eigensolve`` — organized here as a problem-builder (`poisson1d` /
`poisson2d`) plus a `MultigridSolver` that owns the static hierarchy and
exposes `solve` / `eigensolve`.

Model problem (the reference's): -Δu = f on the unit interval/square with
homogeneous Dirichlet boundary, discretized on 2^k - 1 interior points per
axis. The default RHS is the one with the analytic solution
u = sin(pi x) (* sin(pi y)), used by the FMG accuracy benchmark
(BASELINE.json config 3).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import jax
import jax.numpy as jnp

from .config import SolverConfig
from .grids import (Hierarchy, build_hierarchy, grid_coords, interior,
                    pad_interior)
from .ops import laplacian, sparse
from .solvers import cycles, eigen, krylov


@dataclasses.dataclass(frozen=True)
class Problem:
    """An assembled Poisson problem: config + hierarchy + padded RHS."""

    config: SolverConfig
    hierarchy: Hierarchy
    b: jax.Array                       # padded RHS
    u_exact: Optional[jax.Array]       # padded analytic solution, if known


def _default_f(ndim: int):
    """RHS whose exact solution is u = prod sin(pi x_i)."""
    def f(*coords):
        out = ndim * jnp.pi ** 2
        for c in coords:
            out = out * jnp.sin(jnp.pi * c)
        return out
    return f


def _default_u(ndim: int):
    def u(*coords):
        out = 1.0
        for c in coords:
            out = out * jnp.sin(jnp.pi * c)
        return out
    return u


def poisson(k: int, ndim: int,
            f: Optional[Callable] = None,
            config: Optional[SolverConfig] = None,
            **config_overrides) -> Problem:
    """Assemble a Poisson problem on the 2^k - 1 interior grid.

    ``f`` maps interior coordinates to the RHS; None selects the model
    problem with known analytic solution. Extra kwargs override
    `SolverConfig` fields.
    """
    if config is None:
        config = SolverConfig(ndim=ndim, k=k, **config_overrides)
    else:
        config = dataclasses.replace(config, ndim=ndim, k=k,
                                     **config_overrides)
    hier = build_hierarchy(config)
    coords = grid_coords(config.n, ndim, config.dtype)
    exact = None
    if f is None:
        f = _default_f(ndim)
        exact = pad_interior(_default_u(ndim)(*coords).astype(config.dtype))
    b = pad_interior(f(*coords).astype(config.dtype))
    return Problem(config=config, hierarchy=hier, b=b, u_exact=exact)


def poisson1d(k: int, **kw) -> Problem:
    return poisson(k, ndim=1, **kw)


def poisson2d(k: int, **kw) -> Problem:
    return poisson(k, ndim=2, **kw)


def poisson3d(k: int, **kw) -> Problem:
    """7-point 3D Poisson on a (2^k - 1)^3 grid — capability extension
    beyond the reference's 1D/2D (the sharded runtime covers 3D via
    slab/pencil decompositions)."""
    return poisson(k, ndim=3, **kw)


class MultigridSolver:
    """Facade over the cycle drivers and the eigensolver.

    >>> prob = poisson2d(k=8, smoother="rbgs")
    >>> solver = MultigridSolver(prob)
    >>> result = solver.solve()
    >>> lam, vec = solver.eigensolve(k=1)
    """

    def __init__(self, problem: Problem):
        self.problem = problem
        self.config = problem.config
        self.hierarchy = problem.hierarchy

    def solve(self, b: Optional[jax.Array] = None,
              x0: Optional[jax.Array] = None,
              method: str = "mg") -> cycles.SolveResult:
        """Solve A x = b. method="mg": stationary cycles (reference
        semantics); method="pcg": V-cycle-preconditioned conjugate
        gradients (solvers/krylov.py)."""
        b = self.problem.b if b is None else b
        if method == "pcg":
            return krylov.solve_pcg(self.hierarchy, b, self.config, x0=x0)
        if method != "mg":
            raise ValueError(f"unknown solve method {method!r}")
        return cycles.solve(self.hierarchy, b, self.config, x0=x0)

    def v_cycle(self, x: jax.Array, b: jax.Array) -> jax.Array:
        """One cycle on padded arrays."""
        return cycles.cycle(self.hierarchy, x, b, self.config)

    def fmg(self, b: Optional[jax.Array] = None,
            n_vcycles: int = 1) -> jax.Array:
        """O(N) full-multigrid solve; ``n_vcycles`` V-cycles per level
        (1 suffices for 1D/2D discretization accuracy; 3D wants 2)."""
        b = self.problem.b if b is None else b
        return cycles.fmg(self.hierarchy, b, self.config,
                          n_vcycles=n_vcycles)

    def eigensolve(self, k: int = 1, method: str = "ii", tol: float = 1e-8,
                   max_iters: int = 100, inner_cycles: int = 30,
                   inner_tol: float | None = None,
                   v0: Optional[jax.Array] = None) -> eigen.EigenResult:
        """k smallest eigenpairs. method="ii" (block inverse iteration,
        reference parity), "rqi" (Rayleigh-quotient shifts), or "lobpcg"
        (MG-preconditioned LOBPCG — one V-cycle per vector per step
        instead of a full inner solve; the fastest of the three).
        ``v0`` (a (k, *padded) block) warm-starts the iteration —
        checkpoint resume (``utils.checkpoint.resume_solve``)."""
        if method == "lobpcg":
            return eigen.lobpcg(self.hierarchy, self.config, k=k, tol=tol,
                                max_iters=max_iters, v0=v0)
        return eigen.eigensolve(self.hierarchy, self.config, k=k,
                                method=method, tol=tol, max_iters=max_iters,
                                inner_cycles=inner_cycles,
                                inner_tol=inner_tol, v0=v0)

    def as_csr(self) -> sparse.CSR:
        """The fine-level operator as an explicit CSR matrix (parity with
        the reference's scipy.sparse assembly)."""
        c = self.config
        return sparse.laplacian_csr(c.n, c.ndim, c.h, dtype=c.dtype)

    def as_coo(self) -> sparse.COO:
        c = self.config
        return sparse.laplacian_coo(c.n, c.ndim, c.h, dtype=c.dtype)

    def discrete_l2_error(self, x: jax.Array) -> jax.Array:
        """h^(d/2)-weighted L2 error vs the analytic solution (BASELINE.json
        config 3 metric). Requires the model problem."""
        if self.problem.u_exact is None:
            raise ValueError("problem has no analytic solution attached")
        c = self.config
        diff = interior(x) - interior(self.problem.u_exact)
        return jnp.sqrt(jnp.sum(diff * diff)) * (c.h ** (c.ndim / 2.0))
