"""Solver configuration.

Single frozen dataclass holding every knob of the framework, per the
config-system plan in SURVEY.md §5 ("Config / flag system"). The reference
(AndyMN/MultigridCMT, a single-process SciPy code — see SURVEY.md §0) keeps
these as script constants; here they form the static (hashable) part of the
jit cache key.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import jax.numpy as jnp


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Static configuration for a multigrid solve.

    Attributes:
      ndim: spatial dimension (1, 2, or 3; the reference covers 1/2 — 3D
        7-point Poisson is a capability extension on the jnp path).
      k: grid exponent — the fine grid has ``n = 2**k - 1`` interior points
        per axis (vertex-centered coarsening, Dirichlet boundary points
        eliminated; matches the reference's 1023 / 255² / 1023² / 511²
        configs, see SURVEY.md §1).
      dtype: compute dtype (float32 default; float64 runs natively on the
        GPU and matches the SciPy oracle step for step).
      nu1, nu2: pre-/post-smoothing sweeps per V-cycle level.
      smoother: "jacobi" (weighted Jacobi), "rbgs" (red-black Gauss-Seidel),
        or "chebyshev" (polynomial smoother; nu1/nu2 become the polynomial
        degree per leg — apply-only, the best fit for the sharded runtime).
      omega: Jacobi damping; None selects the textbook optimum 2/3 (1D) or
        4/5 (2D) used by the reference (SURVEY.md §2, smoother rows).
      cycle: "v", "w", or "fmg".
      min_coarse: coarsest-level interior size (per axis); the hierarchy
        coarsens 2^j-1 → 2^(j-1)-1 until n <= min_coarse, then solves
        directly with a precomputed dense inverse.
      tol: relative residual tolerance ||r|| / ||b||.
      max_iters: outer-cycle iteration cap (also the residual-history length).
      mesh_axis: name of the mesh axis used for row partitioning when the
        solver runs under ``parallel.shard_cycle``.
      agglom_rows: once a level's *local* row count would drop below this,
        the level is agglomerated (replicated on all devices) rather than
        kept sharded — SURVEY.md §3.5 / BASELINE.json config 5. Small
        sharded levels run a latency-bound masked-stencil path (a fixed
        cost per op regardless of size), while the crossing's all_gather
        is a one-off of < agglom_rows*D rows. The default 64 has not been
        re-measured on the GPU (an open item). Lower it (tests use 4-8)
        to keep more levels sharded on tiny grids.
      fmg_prolong: interpolation order of FMG's coarse-to-fine *solution*
        walk (SURVEY.md §3.2): "linear" ((bi/tri)linear — the reference's
        choice, and the default so residual histories match the oracle
        step-for-step) or "cubic" (FMG-order 4-point interpolation with
        odd boundary reflection; reaches discretization accuracy with a
        smaller constant — tests/test_cycles.py). The within-cycle
        correction prolongation is always (bi)linear.
    """

    ndim: int = 2
    k: int = 8
    dtype: Any = jnp.float32
    nu1: int = 2
    nu2: int = 2
    smoother: str = "jacobi"
    omega: Optional[float] = None
    cycle: str = "v"
    min_coarse: int = 3
    tol: float = 1e-8
    max_iters: int = 100
    mesh_axis: str = "row"
    agglom_rows: int = 64
    fmg_prolong: str = "linear"

    def __post_init__(self):
        if jnp.dtype(self.dtype) == jnp.float64:
            # Without this, jax silently truncates every f64 request to f32
            # and the solver stalls at the f32 roundoff floor (~1e-4
            # relative residual) instead of reaching tight tolerances.
            import jax

            if not jax.config.jax_enable_x64:
                jax.config.update("jax_enable_x64", True)
        if self.ndim not in (1, 2, 3):
            raise ValueError(f"ndim must be 1, 2, or 3, got {self.ndim}")
        if self.k < 2:
            raise ValueError(f"k must be >= 2, got {self.k}")
        if self.smoother not in ("jacobi", "rbgs", "chebyshev"):
            raise ValueError(f"unknown smoother {self.smoother!r}")
        if self.cycle not in ("v", "w", "fmg"):
            raise ValueError(f"unknown cycle {self.cycle!r}")
        if self.fmg_prolong not in ("linear", "cubic"):
            raise ValueError(f"unknown fmg_prolong {self.fmg_prolong!r}")

    @property
    def n(self) -> int:
        """Interior points per axis on the finest grid."""
        return 2 ** self.k - 1

    @property
    def h(self) -> float:
        """Mesh spacing on the finest grid (unit domain)."""
        return 1.0 / (self.n + 1)

    def effective_omega(self) -> float:
        if self.omega is not None:
            return self.omega
        return (2.0 * self.ndim) / (2.0 * self.ndim + 1.0)   # 2/3, 4/5, 6/7

    def level_sizes(self) -> Tuple[int, ...]:
        """Interior sizes fine→coarse: 2^k-1, 2^(k-1)-1, ..., <= min_coarse."""
        sizes = []
        kk = self.k
        while True:
            n = 2 ** kk - 1
            sizes.append(n)
            if n <= self.min_coarse or kk <= 1:
                break
            kk -= 1
        return tuple(sizes)
