"""Grid hierarchy for vertex-centered geometric multigrid.

Design (SURVEY.md §7): grids are dense jnp arrays carrying a
one-cell ghost boundary of zeros (homogeneous Dirichlet). A 1D level with
``n`` interior points is stored as shape ``(n+2,)``; a 2D level as
``(n+2, n+2)``. All stencil operators read the full padded array and write
only the interior, so applications are pure shift-and-adds with no edge
conditionals — exactly what XLA fuses well and what the sharded path can
feed with `ppermute` halos.

The hierarchy is *static*: level sizes are Python ints fixed at trace time,
so the recursive V-cycle of the reference (SURVEY.md §3.1) unrolls into a
straight-line XLA program. Constant-coefficient Poisson is re-discretized
per level (h_l = 2^l h), which for full-weighting/bilinear transfers is the
standard textbook choice the reference uses (SURVEY.md §2, "Coarse-grid
hierarchy" row).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .config import SolverConfig
from .ops import laplacian


@dataclasses.dataclass(frozen=True)
class LevelSpec:
    """Static description of one multigrid level."""

    n: int      # interior points per axis
    h: float    # mesh spacing

    @property
    def padded_shape_1d(self) -> Tuple[int, ...]:
        return (self.n + 2,)

    def padded_shape(self, ndim: int) -> Tuple[int, ...]:
        return (self.n + 2,) * ndim


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class Hierarchy:
    """Static level specs plus the precomputed dense coarsest-level inverse.

    ``coarse_inv`` is the dense inverse of the coarsest Poisson operator
    (tiny: min_coarse^ndim square), computed once at setup on the host. The
    coarsest solve inside the cycle is then a single small matmul in place
    of the reference's `scipy.sparse.linalg.spsolve` (SURVEY.md §2
    "Coarsest solve" row).
    """

    ndim: int
    levels: Tuple[LevelSpec, ...]   # fine → coarse
    coarse_inv: jax.Array
    coarse_dense: jax.Array         # dense A_coarsest, for shifted solves

    def tree_flatten(self):
        return (self.coarse_inv, self.coarse_dense), (self.ndim, self.levels)

    @classmethod
    def tree_unflatten(cls, aux, children):
        ndim, levels = aux
        coarse_inv, coarse_dense = children
        return cls(ndim=ndim, levels=levels, coarse_inv=coarse_inv,
                   coarse_dense=coarse_dense)

    @property
    def num_levels(self) -> int:
        return len(self.levels)

    @property
    def fine(self) -> LevelSpec:
        return self.levels[0]

    @property
    def coarsest(self) -> LevelSpec:
        return self.levels[-1]


def build_hierarchy(config: SolverConfig) -> Hierarchy:
    """Build the static level list and the dense coarsest inverse.

    Runs once, outside jit (SURVEY.md §3.4). The coarsest inverse is built
    with NumPy in float64 and cast to the compute dtype, so its accuracy
    doesn't depend on the compute dtype.
    """
    sizes = config.level_sizes()
    levels = tuple(
        LevelSpec(n=n, h=1.0 / (n + 1)) for n in sizes
    )
    nc = levels[-1].n
    hc = levels[-1].h
    a_dense = laplacian.dense_operator(nc, config.ndim, hc)  # float64 numpy
    inv = np.linalg.inv(a_dense)
    coarse_inv = jnp.asarray(inv, dtype=config.dtype)
    coarse_dense = jnp.asarray(a_dense, dtype=config.dtype)
    return Hierarchy(ndim=config.ndim, levels=levels, coarse_inv=coarse_inv,
                     coarse_dense=coarse_dense)


def zeros_like_level(level: LevelSpec, ndim: int, dtype) -> jax.Array:
    return jnp.zeros(level.padded_shape(ndim), dtype=dtype)


def pad_interior(interior: jax.Array) -> jax.Array:
    """Wrap an interior-only array in a one-cell zero ghost boundary."""
    return jnp.pad(interior, 1)


def interior(u: jax.Array) -> jax.Array:
    """View of the interior of a padded grid array (any ndim)."""
    return u[(slice(1, -1),) * u.ndim]


def interior_coords_1d(n: int, dtype=jnp.float64) -> jax.Array:
    """x-coordinates of the n interior points of the unit interval."""
    h = 1.0 / (n + 1)
    return (jnp.arange(1, n + 1, dtype=dtype)) * h


def grid_coords(n: int, ndim: int, dtype):
    """Interior coordinates; 1D → (x,), 2D/3D → 'ij' meshgrid tuple."""
    x = jnp.arange(1, n + 1, dtype=dtype) / (n + 1)
    if ndim == 1:
        return (x,)
    return tuple(jnp.meshgrid(*([x] * ndim), indexing="ij"))
