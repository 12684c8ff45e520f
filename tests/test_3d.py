"""3D (7-point) Poisson tests — capability extension beyond the reference's
1D/2D. Oracles: dense Kronecker-sum operator, explicit transfer matrices
(P = 8 R^T), SciPy direct solve, and analytic eigenvalues (lambda_1 -> 3pi^2).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse
import scipy.sparse.linalg

import multigridcmt as mg
from multigridcmt.grids import interior, pad_interior
from multigridcmt.ops import laplacian, smoothers, transfer


def _pad(a):
    return pad_interior(jnp.asarray(a))


def test_apply_matches_dense_kron():
    n = 5
    h = 1.0 / (n + 1)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((n, n, n))
    a = laplacian.dense_operator(n, 3, h)
    want = (a @ x.reshape(-1)).reshape(n, n, n)
    got = np.asarray(interior(laplacian.apply_poisson(_pad(x), h)))
    np.testing.assert_allclose(got, want, rtol=1e-12)
    # Diagonal entry is 6/h^2.
    assert laplacian.diag_value(3, h) == pytest.approx(6.0 / (h * h))


def _op_matrix(fn, n_in, n_out):
    """Materialize a padded-grid linear op as a dense (n_out^3, n_in^3)."""
    cols = []
    for j in range(n_in ** 3):
        e = np.zeros(n_in ** 3)
        e[j] = 1.0
        out = np.asarray(interior(fn(_pad(e.reshape((n_in,) * 3)))))
        cols.append(out.reshape(-1))
    return np.stack(cols, axis=1)


def test_transfer_transpose_relation_3d():
    """P = 2^d R^T with d = 3, and R rows sum to 1 (consistency)."""
    nc, nf = 3, 7
    r = _op_matrix(transfer.restrict, nf, nc)
    p = _op_matrix(transfer.prolong, nc, nf)
    np.testing.assert_allclose(p, 8.0 * r.T, rtol=1e-13)
    np.testing.assert_allclose(r.sum(axis=1), np.ones(nc ** 3), rtol=1e-13)


def test_rbgs_3d_half_sweep_touches_one_color():
    n = 7
    h = 1.0 / (n + 1)
    rng = np.random.default_rng(1)
    u = rng.standard_normal((n, n, n))
    b = rng.standard_normal((n, n, n))
    out = np.asarray(interior(smoothers.rbgs_half_sweep(
        _pad(u), _pad(b), h, parity=0)))
    ii, jj, kk = np.meshgrid(*[np.arange(1, n + 1)] * 3, indexing="ij")
    black = ((ii + jj + kk) % 2) == 1
    np.testing.assert_array_equal(out[black], u[black])
    assert not np.allclose(out[~black], u[~black])


@pytest.mark.parametrize("smoother", ["jacobi", "rbgs", "chebyshev"])
def test_vcycle_3d_converges(smoother):
    prob = mg.poisson3d(k=4, dtype=jnp.float64, smoother=smoother, tol=1e-8)
    res = mg.MultigridSolver(prob).solve()
    assert bool(res.converged)
    assert float(mg.convergence_factor(res)) < 0.3


def test_solution_accuracy_3d():
    """Solved solution hits discretization accuracy vs u = prod sin(pi x)."""
    prob = mg.poisson3d(k=4, dtype=jnp.float64, tol=1e-10)
    solver = mg.MultigridSolver(prob)
    res = solver.solve()
    err = float(solver.discrete_l2_error(res.x))
    assert err < prob.config.h ** 2


def test_fmg_3d_error_halving_ratio():
    """FMG discrete-L2 error is O(h^2): halving h divides error by ~4."""
    errs = []
    for k in (3, 4):
        prob = mg.poisson3d(k=k, dtype=jnp.float64)
        solver = mg.MultigridSolver(prob)
        x = solver.fmg(n_vcycles=2)
        errs.append(float(solver.discrete_l2_error(x)))
    ratio = errs[0] / errs[1]
    # ~4 asymptotically; the k=3 grid (7^3) is pre-asymptotic, so allow a
    # generous band around it.
    assert 3.0 < ratio < 7.0


def test_pcg_3d_matches_scipy():
    prob = mg.poisson3d(k=3, dtype=jnp.float64, tol=1e-10)
    res = mg.solve_pcg(prob.hierarchy, prob.b, prob.config)
    assert bool(res.converged)
    n, h = prob.config.n, prob.config.h
    a = scipy.sparse.csr_matrix(laplacian.dense_operator(n, 3, h))
    want = scipy.sparse.linalg.spsolve(
        a, np.asarray(interior(prob.b)).reshape(-1)).reshape((n,) * 3)
    np.testing.assert_allclose(np.asarray(interior(res.x)), want,
                               rtol=1e-7, atol=1e-9)


def test_eigensolve_3d_ground_state():
    """lambda_1 equals the exact discrete eigenvalue (-> 3pi^2 as h -> 0)."""
    prob = mg.poisson3d(k=4, dtype=jnp.float64)
    res = mg.MultigridSolver(prob).eigensolve(k=1, tol=1e-8)
    assert bool(res.converged)
    n, h = prob.config.n, prob.config.h
    want = laplacian.eigenvalue_3d(1, 1, 1, n, h)
    assert float(res.eigenvalues[0]) == pytest.approx(want, rel=1e-7)
    assert abs(want - 3.0 * np.pi ** 2) < 3.0 * np.pi ** 2 * 0.05


def test_sparse_formats_3d_match_dense():
    from multigridcmt.ops import sparse

    n, h = 4, 1.0 / 5.0
    a_dense = laplacian.dense_operator(n, 3, h)
    rng = np.random.default_rng(2)
    x = rng.standard_normal(n ** 3)
    want = a_dense @ x
    csr = sparse.laplacian_csr(n, 3, h, dtype=jnp.float64)
    coo = sparse.laplacian_coo(n, 3, h, dtype=jnp.float64)
    dia = sparse.laplacian_dia(n, 3, h, dtype=jnp.float64)
    xj = jnp.asarray(x)
    np.testing.assert_allclose(np.asarray(sparse.spmv(csr, xj)), want,
                               rtol=1e-12)
    np.testing.assert_allclose(np.asarray(sparse.spmv_coo(coo, xj)), want,
                               rtol=1e-12)
    np.testing.assert_allclose(np.asarray(sparse.spmv_dia(dia, xj)), want,
                               rtol=1e-12)


def test_transfer_matrices_3d():
    """Explicit CSR P/R agree with the stencil ops and P = 8 R^T."""
    from multigridcmt.ops import sparse

    nc = 3
    p = sparse.csr_to_scipy(sparse.prolongation_csr(nc, 3, jnp.float64))
    r = sparse.csr_to_scipy(sparse.restriction_csr(nc, 3, jnp.float64))
    np.testing.assert_allclose(p.toarray(), 8.0 * r.T.toarray(), rtol=1e-13)
    rng = np.random.default_rng(3)
    e = rng.standard_normal(nc ** 3)
    want = np.asarray(interior(transfer.prolong(
        _pad(e.reshape((nc,) * 3))))).reshape(-1)
    np.testing.assert_allclose(p @ e, want, rtol=1e-12)
