"""Two-colour red-black Gauss-Seidel sweep as one Pallas kernel (Triton).

``ops.smoothers.rbgs`` runs a sweep as two masked passes, one per colour,
each reading u and b and writing u; the black pass reads red values the
same sweep has just written. This kernel does both colours in one pass
(read u, read b, write u: 3N values). On the card it makes the float32
V(2,2) cycle 27-29% faster (PERF.md).

Design, for the GPU: one program per (BLOCK_ROWS, BLOCK_COLS) tile of the
logical padded ``(n+2, n+2)`` grid, with no layout change. A program loads
the tile's u at 13 offsets (centre, +-1 and +-2 along each axis, the four
diagonals) and b at 5, and recomputes the red update on the tile's four
shifted copies — a tile one cell wider on each side — so the black update
never needs a value another program writes. The shifted loads overlap and
are served mostly by the L1/L2 caches. Indices are clamped into the array;
a clamped value only ever reaches a point that is not interior, whose output
is the unchanged input. The output is a new array (programs read the
pre-sweep u only), so there is no ordering between programs.

Semantics match ``ops.smoothers.rbgs`` exactly (red = even coordinate sum,
same operation order; ghosts are copied unchanged), to rounding: the GPU
may contract ``h2*b + u`` into one fused multiply-add.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

# Tile and warps: of twelve shapes measured on an H100 in float32, the
# fastest at 8191^2 and within 5% of the fastest at 4095^2 (PERF.md).
# Larger tiles spill registers: each program holds 18 loaded tiles.
BLOCK_ROWS = 8
BLOCK_COLS = 128
NUM_WARPS = 4

# Where the kernel makes the V(2,2) cycle faster end to end on the card
# (PERF.md): float32 levels of at least MIN_N interior points per axis. In
# float64 the kernel's sweep is slower than XLA's (register pressure
# doubles) and so is the cycle at 4095^2 and 8191^2, so float64 keeps the
# XLA sweep.
MIN_N = 1023
DTYPES = ("float32",)


def use_kernel(u: jax.Array) -> bool:
    """Whether a level's RB-GS sweep runs this kernel: a 2D grid on the
    GPU, in a dtype and at a size where the kernel wins."""
    return (u.ndim == 2 and u.shape[0] - 2 >= MIN_N
            and jnp.dtype(u.dtype).name in DTYPES
            and jax.default_backend() == "gpu")


# u offsets the kernel reads: the red update at the centre and at its four
# neighbours needs the centre, +-1 and +-2 along each axis and the corners.
_U_OFFSETS = ((0, 0), (-1, 0), (1, 0), (0, -1), (0, 1), (-2, 0), (2, 0),
              (0, -2), (0, 2), (-1, -1), (-1, 1), (1, -1), (1, 1))
_B_OFFSETS = ((0, 0), (-1, 0), (1, 0), (0, -1), (0, 1))


def _kernel(coef_ref, u_ref, b_ref, o_ref, *, p: int, br: int, bc: int):
    n = p - 2
    h2 = plgpu.load(coef_ref.at[0])
    den = plgpu.load(coef_ref.at[1])
    rows = pl.program_id(0) * br + jnp.arange(br, dtype=jnp.int32)[:, None]
    cols = pl.program_id(1) * bc + jnp.arange(bc, dtype=jnp.int32)[None, :]

    def load(ref, di, dj):
        r = jnp.clip(rows + di, 0, p - 1)
        c = jnp.clip(cols + dj, 0, p - 1)
        return plgpu.load(ref.at[r, c])

    def interior(di, dj):
        r, c = rows + di, cols + dj
        return (r >= 1) & (r <= n) & (c >= 1) & (c <= n)

    u = {d: load(u_ref, *d) for d in _U_OFFSETS}
    b = {d: load(b_ref, *d) for d in _B_OFFSETS}

    def red(di, dj):
        # The red update at (di, dj), in _gs_update's operation order; a
        # ghost keeps its value.
        v = (h2 * b[di, dj] + u[di - 1, dj] + u[di + 1, dj]
             + u[di, dj - 1] + u[di, dj + 1]) / den
        return jnp.where(interior(di, dj), v, u[di, dj])

    # Black points read their four (red) neighbours after the red pass.
    black = (h2 * b[0, 0] + red(-1, 0) + red(1, 0) + red(0, -1)
             + red(0, 1)) / den
    is_red = (rows + cols) % 2 == 0
    out = jnp.where(interior(0, 0), jnp.where(is_red, red(0, 0), black),
                    u[0, 0])
    plgpu.store(o_ref.at[rows, cols], out, mask=(rows < p) & (cols < p))


@functools.partial(jax.jit, static_argnames=("interpret",))
def _sweep(u, b, coef, *, interpret: bool):
    p = u.shape[0]
    kernel = functools.partial(_kernel, p=p, br=BLOCK_ROWS, bc=BLOCK_COLS)
    return pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct(u.shape, u.dtype),
        grid=(pl.cdiv(p, BLOCK_ROWS), pl.cdiv(p, BLOCK_COLS)),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS),
        interpret=interpret,
        name="rbgs2d_sweep",
    )(coef, u, b)


def rbgs_sweep(u: jax.Array, b: jax.Array, h: float, sigma=0.0, *,
               interpret: bool = False) -> jax.Array:
    """One full red-black sweep of a padded ``(n+2, n+2)`` grid.

    Same contract as ``ops.smoothers.rbgs(u, b, h, sigma=sigma)``; sigma
    may be traced (eigensolver shifts). ``interpret=True`` runs the kernel
    in the Pallas interpreter (CPU tests)."""
    h2 = jnp.asarray(h * h, dtype=u.dtype)
    den = 4.0 - jnp.asarray(sigma, dtype=u.dtype) * h2
    coef = jnp.stack([h2, den]).astype(u.dtype)
    return _sweep(u, b, coef, interpret=interpret)
