"""Pure NumPy/SciPy mini-reference implementation — the oracle.

The reference repo (AndyMN/MultigridCMT) could not be mounted this round
(SURVEY.md §0: the reference repo was not available), so per SURVEY.md §4.3 this module
is the stand-in oracle: a straightforward single-process SciPy geometric
multigrid with exactly the algorithmic choices the reference's capability
spec pins down (BASELINE.json:5) — weighted Jacobi (omega 2/3 / 4/5),
red-black Gauss-Seidel (red = even coordinate-sum first), full-weighting
restriction, bilinear prolongation, recursive V-cycle / FMG with a direct
coarsest solve, and an inverse-iteration eigensolver.

The JAX build must reproduce this oracle's residual histories step-for-step
at float64 (same omega, same sweep order) — that is the "match the reference
Python/SciPy results" contract of BASELINE.json.

Arrays here are *interior-only* (no ghost padding), matching how a plain
SciPy code would be written.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla


def laplacian_matrix(n: int, ndim: int, h: float) -> sp.csr_matrix:
    """SciPy CSR Poisson operator: tridiagonal (1D) / 5-point kron-sum (2D)."""
    t = sp.diags([-np.ones(n - 1), 2 * np.ones(n), -np.ones(n - 1)],
                 [-1, 0, 1], format="csr")
    if ndim == 1:
        return (t / (h * h)).tocsr()
    eye = sp.identity(n, format="csr")
    return ((sp.kron(t, eye) + sp.kron(eye, t)) / (h * h)).tocsr()


def default_omega(ndim: int) -> float:
    return 2.0 / 3.0 if ndim == 1 else 4.0 / 5.0


def jacobi(u, b, h, omega, sigma=0.0):
    """One weighted-Jacobi sweep on an interior-only array."""
    ndim = u.ndim
    d = (2.0 if ndim == 1 else 4.0) / (h * h) - sigma
    return u + (omega / d) * residual(u, b, h, sigma)


def residual(u, b, h, sigma=0.0):
    """r = b - (A - sigma I) u on interior-only arrays (zero Dirichlet)."""
    up = np.pad(u, 1)
    if u.ndim == 1:
        au = (2.0 * up[1:-1] - up[:-2] - up[2:]) / (h * h)
    else:
        au = (4.0 * up[1:-1, 1:-1] - up[:-2, 1:-1] - up[2:, 1:-1]
              - up[1:-1, :-2] - up[1:-1, 2:]) / (h * h)
    return b - au + sigma * u


def rbgs(u, b, h, sigma=0.0):
    """Red-black Gauss-Seidel: red = (i+j) even in 1-based interior coords."""
    u = u.copy()
    h2 = h * h
    for parity in (0, 1):
        up = np.pad(u, 1)
        if u.ndim == 1:
            idx = np.arange(1, u.shape[0] + 1)
            mask = (idx % 2) == parity
            den = 2.0 - sigma * h2
            new = (h2 * b + up[:-2] + up[2:]) / den
            u[mask] = new[mask]
        else:
            ii, jj = np.meshgrid(np.arange(1, u.shape[0] + 1),
                                 np.arange(1, u.shape[1] + 1), indexing="ij")
            mask = ((ii + jj) % 2) == parity
            den = 4.0 - sigma * h2
            new = (h2 * b + up[:-2, 1:-1] + up[2:, 1:-1]
                   + up[1:-1, :-2] + up[1:-1, 2:]) / den
            u[mask] = new[mask]
    return u


def restrict(r):
    """Full weighting: [1,2,1]/4 per axis (9-point in 2D)."""
    if r.ndim == 1:
        return 0.25 * (r[0:-2:2] + 2.0 * r[1:-1:2] + r[2::2])
    r = 0.25 * (r[0:-2:2, :] + 2.0 * r[1:-1:2, :] + r[2::2, :])
    r = 0.25 * (r[:, 0:-2:2] + 2.0 * r[:, 1:-1:2] + r[:, 2::2])
    return r


def prolong(e):
    """(Bi)linear interpolation, nc -> 2*nc + 1 per axis."""
    ep = np.pad(e, 1)
    if e.ndim == 1:
        n = 2 * e.shape[0] + 1
        f = np.zeros(n)
        f[1::2] = e
        f[0::2] = 0.5 * (ep[:-1] + ep[1:])
        return f
    n0 = 2 * e.shape[0] + 1
    f = np.zeros((n0, e.shape[1]))
    f[1::2, :] = e
    f[0::2, :] = 0.5 * (ep[:-1, 1:-1] + ep[1:, 1:-1])
    n1 = 2 * e.shape[1] + 1
    g = np.zeros((n0, n1))
    fp = np.pad(f, ((0, 0), (1, 1)))
    g[:, 1::2] = f
    g[:, 0::2] = 0.5 * (fp[:, :-1] + fp[:, 1:])
    return g


def smooth(u, b, h, kind, omega, sweeps, sigma=0.0):
    for _ in range(sweeps):
        u = jacobi(u, b, h, omega, sigma) if kind == "jacobi" \
            else rbgs(u, b, h, sigma)
    return u


def v_cycle(u, b, h, nu1, nu2, kind, omega, min_coarse=3, sigma=0.0,
            gamma=1):
    """Recursive V(nu1,nu2) / W cycle on interior-only arrays."""
    n = u.shape[0]
    if n <= min_coarse:
        ndim = u.ndim
        a = laplacian_matrix(n, ndim, h).toarray()
        if sigma:
            a = a - sigma * np.eye(a.shape[0])
        return np.linalg.solve(a, b.reshape(-1)).reshape(b.shape)
    u = smooth(u, b, h, kind, omega, nu1, sigma)
    r = residual(u, b, h, sigma)
    rc = restrict(r)
    ec = np.zeros_like(rc)
    for _ in range(gamma):
        ec = v_cycle(ec, rc, 2 * h, nu1, nu2, kind, omega, min_coarse,
                     sigma, gamma)
    u = u + prolong(ec)
    u = smooth(u, b, h, kind, omega, nu2, sigma)
    return u


def solve(b, h, nu1=2, nu2=2, kind="jacobi", omega=None, tol=1e-8,
          max_iters=100, min_coarse=3, gamma=1):
    """V-cycle iteration to ||r||/||b|| < tol; returns (x, history)."""
    if omega is None:
        omega = default_omega(b.ndim)
    x = np.zeros_like(b)
    bn = np.linalg.norm(b)
    hist = [np.linalg.norm(residual(x, b, h)) / bn]
    for _ in range(max_iters):
        if hist[-1] < tol:
            break
        x = v_cycle(x, b, h, nu1, nu2, kind, omega, min_coarse, gamma=gamma)
        hist.append(np.linalg.norm(residual(x, b, h)) / bn)
    return x, np.array(hist)


def fmg(b, h, nu1=2, nu2=2, kind="jacobi", omega=None, min_coarse=3,
        n_vcycles=1):
    """Full multigrid on interior-only arrays."""
    if omega is None:
        omega = default_omega(b.ndim)
    bs = [b]
    hs = [h]
    while bs[-1].shape[0] > min_coarse:
        bs.append(restrict(bs[-1]))
        hs.append(2 * hs[-1])
    n = bs[-1].shape[0]
    a = laplacian_matrix(n, b.ndim, hs[-1]).toarray()
    x = np.linalg.solve(a, bs[-1].reshape(-1)).reshape(bs[-1].shape)
    for lev in range(len(bs) - 2, -1, -1):
        x = prolong(x)
        for _ in range(n_vcycles):
            x = v_cycle(x, bs[lev], hs[lev], nu1, nu2, kind, omega,
                        min_coarse)
    return x


def eigensolve(n, ndim, h, k=1, tol=1e-8, max_iters=100, inner_cycles=2,
               nu1=2, nu2=2, kind="jacobi", omega=None, seed=0):
    """Smallest eigenpair(s) by MG-preconditioned inverse iteration."""
    if omega is None:
        omega = default_omega(ndim)
    shape = (n,) * ndim
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((k,) + shape)

    def flat(vv):
        return vv.reshape(k, -1)

    def apply_a(u):
        return -residual(u, np.zeros_like(u), h)

    for _ in range(max_iters):
        w = np.empty_like(v)
        for i in range(k):
            x = np.zeros(shape)
            for _ in range(inner_cycles):
                x = v_cycle(x, v[i], h, nu1, nu2, kind, omega)
            w[i] = x
        q, _ = np.linalg.qr(flat(w).T)
        v = q.T.reshape((k,) + shape)
        av = np.stack([apply_a(v[i]) for i in range(k)])
        hmat = flat(v) @ flat(av).T
        lam, s = np.linalg.eigh(0.5 * (hmat + hmat.T))
        v = (s.T @ flat(v)).reshape((k,) + shape)
        av = np.stack([apply_a(v[i]) for i in range(k)])
        res = np.linalg.norm(flat(av) - lam[:, None] * flat(v),
                             axis=1) / np.abs(lam)
        if res.max() < tol:
            break
    return lam, v


def eigsh_oracle(n, ndim, h, k=1):
    """scipy.sparse.linalg.eigsh smallest-eigenvalue oracle (shift-invert
    about 0: the operator is SPD, so the eigenvalues nearest 0 are the
    smallest, found in seconds even at 511^2)."""
    a = laplacian_matrix(n, ndim, h).tocsc()
    vals = spla.eigsh(a, k=k, sigma=0, which="LM",
                      return_eigenvectors=False)
    return np.sort(vals)
