"""multigridcmt — a JAX geometric-multigrid framework for the GPU.

A from-scratch JAX re-design of the capabilities of AndyMN/MultigridCMT
(Python/SciPy geometric multigrid + MG-accelerated eigensolver; see
SURVEY.md): Poisson assembly (matrix-free stencils plus CSR/COO/DIA),
weighted-Jacobi and red-black Gauss-Seidel smoothers, full-weighting/
bilinear transfers, V/W/FMG cycle drivers, the eigensolver, and a
shard_map-based multi-device runtime with ppermute halo exchange and
coarse-level agglomeration.
"""

from .api import (MultigridSolver, Problem, poisson, poisson1d,  # noqa: F401
                  poisson2d, poisson3d)
from .config import SolverConfig  # noqa: F401
from .grids import Hierarchy, build_hierarchy, interior, pad_interior  # noqa: F401
from .solvers.cycles import (SolveResult, convergence_factor, fmg,  # noqa: F401
                             solve, v_cycle)
from .solvers.eigen import EigenResult, eigensolve  # noqa: F401
from .solvers.krylov import solve_pcg  # noqa: F401

__version__ = "0.1.0"
