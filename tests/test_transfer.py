"""Transfer-operator tests — oracle: stencil definitions + P = 2^d R^T
(SURVEY.md §4.1)."""
import jax.numpy as jnp
import numpy as np
import pytest

from multigridcmt.grids import interior, pad_interior
from multigridcmt.ops import transfer

import reference_impl as ref


def _restrict_np(r):
    return np.asarray(interior(transfer.restrict(pad_interior(jnp.asarray(r)))))


def _prolong_np(e):
    return np.asarray(interior(transfer.prolong(pad_interior(jnp.asarray(e)))))


@pytest.mark.parametrize("ndim,n", [(1, 15), (1, 63), (2, 15), (2, 31)])
def test_restrict_matches_reference(ndim, n):
    rng = np.random.default_rng(0)
    r = rng.standard_normal((n,) * ndim)
    np.testing.assert_allclose(_restrict_np(r), ref.restrict(r), rtol=1e-13)


@pytest.mark.parametrize("ndim,nc", [(1, 7), (1, 31), (2, 7), (2, 15)])
def test_prolong_matches_reference(ndim, nc):
    rng = np.random.default_rng(1)
    e = rng.standard_normal((nc,) * ndim)
    np.testing.assert_allclose(_prolong_np(e), ref.prolong(e), rtol=1e-13)


def _as_matrix(op, n_in, shape_out, ndim):
    """Materialize a linear grid operator as a dense matrix."""
    cols = []
    for i in range(n_in ** ndim):
        e = np.zeros(n_in ** ndim)
        e[i] = 1.0
        cols.append(op(e.reshape((n_in,) * ndim)).reshape(-1))
    return np.stack(cols, axis=1)


@pytest.mark.parametrize("ndim", [1, 2])
def test_transpose_relation(ndim):
    """Full weighting and bilinear interpolation satisfy P = 2^d R^T."""
    nc, n = 3, 7
    r_mat = _as_matrix(_restrict_np, n, nc, ndim)       # (nc^d, n^d)
    p_mat = _as_matrix(_prolong_np, nc, n, ndim)        # (n^d, nc^d)
    np.testing.assert_allclose(p_mat, (2 ** ndim) * r_mat.T, rtol=1e-13)


def test_restrict_preserves_smooth_functions():
    """restrict(prolong(v)) ~ v, and restriction of a smooth sample is its
    coarse sample to O(h^2)."""
    nc = 31
    hc = 1.0 / (nc + 1)
    x = np.arange(1, nc + 1) * hc
    v = np.sin(np.pi * x)
    rt = _restrict_np(_prolong_np(v))
    np.testing.assert_allclose(rt, v, atol=2e-3)


def test_restrict_1d_stencil_values():
    """Coarse point j = (f[2j-1] + 2 f[2j] + f[2j+1]) / 4 exactly."""
    n = 7
    f = np.arange(1.0, n + 1)          # fine interior values 1..7
    rc = _restrict_np(f)
    want = np.array([(1 + 2 * 2 + 3) / 4, (3 + 2 * 4 + 5) / 4,
                     (5 + 2 * 6 + 7) / 4])
    np.testing.assert_allclose(rc, want, rtol=1e-15)


def test_3d_minor_axis_matmul_passes_match_sliced(monkeypatch):
    """The large-3D minor-axis matmul transfer passes compute exactly the
    sliced passes' values."""
    from multigridcmt.ops import transfer

    rng = np.random.default_rng(3)
    f = jnp.asarray(rng.standard_normal((17, 33, 65)))
    e = jnp.asarray(rng.standard_normal((9, 17, 33)))

    monkeypatch.setattr(transfer, "_MM_MIN_N", 10 ** 9)
    r_sliced = transfer.restrict(f)
    p_sliced = transfer.prolong(e)
    monkeypatch.setattr(transfer, "_MM_MIN_N", 4)
    assert transfer._use_mm(f, 1) and transfer._use_mm(f, 2)
    r_mm = transfer.restrict(f)
    p_mm = transfer.prolong(e)

    np.testing.assert_allclose(np.asarray(r_mm), np.asarray(r_sliced),
                               rtol=1e-13, atol=1e-14)
    np.testing.assert_allclose(np.asarray(p_mm), np.asarray(p_sliced),
                               rtol=1e-13, atol=1e-14)
