"""LOBPCG and shift-invert inverse iteration for SPD pencils.

Counterpart of the reference's ``solver/power.py`` (``lobpcg_smallest``,
``lobpcg_smallest_pc``, ``lobpcg_block``, ``lobpcg_block_pc``,
``shift_invert_power``).  The operators are duck-typed: anything with a
``matvec`` (the stencil operators of :mod:`~lsafw_tpu_torch.ops.stencil`
and :mod:`~lsafw_tpu_torch.ops.stencil_nd`, a BCSR operator), or a
:class:`~lsafw_tpu_torch.ops.sparse.CSRMatrix`, whose products run
through S (:func:`~lsafw_tpu_torch.ops.bcsr.matvec_of`).  A
preconditioner is an object with ``apply`` (the multigrid V-cycles,
:class:`~lsafw_tpu_torch.solver.pmg.PMGPreconditioner`).

The numerical design is the reference's: the basis [x, w, p] is
M-orthonormalised at the vector level (CGS2), and the K and M products are
recomputed fresh on the final columns every iteration, so the Ritz
problem is a standard symmetric one and its Gram matrix is the exact
Gram matrix of the basis (:func:`_lobpcg_core` says why tracked products
stall).  The reference solves its 3x3 and 3m x 3m Ritz problems by Jacobi
sweeps because the TPU's emulated-f64 ``eigh`` is inaccurate; here they
are ``torch.linalg.eigh`` in f64 on the host (one synchronisation an
iteration, which the convergence test takes anyway).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from lsafw_tpu_torch.ops.bcsr import matvec_of
from lsafw_tpu_torch.ops.sparse import CSRMatrix


class PowerResult(NamedTuple):
    eigenvalue: float
    eigenvector: torch.Tensor  # the operators' layout (packed for a stencil)
    iterations: int
    residual: float  # |K x - lam M x| / |M x| (LOBPCG), |K x - lam M x| (inverse iteration)


class BlockPowerResult(NamedTuple):
    eigenvalues: torch.Tensor  # (m,) ascending
    eigenvectors: torch.Tensor  # (m, n) rows
    iterations: int
    residuals: torch.Tensor  # (m,) |K x - lam M x| / |M x|


def _mv(op):
    """x -> op x: the operator's ``matvec``, or S for a CSRMatrix."""
    return matvec_of(op) if isinstance(op, CSRMatrix) else op.matvec


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.dot(a, b)


def _mnorm(v, Mv) -> torch.Tensor:
    return torch.sqrt(torch.clamp(_dot(v, Mv), min=0.0))


def _orthonormalize_col(K, M, v, against):
    """M-orthonormalize ``v`` against M-orthonormal ``(u, Ku, Mu)``
    columns: CGS2 with the tracked M v for the coefficients, then fresh
    K v and M v products on the normalised vector and one fresh-product
    touch-up pass.  Returns (v, Kv, Mv, ok); a dead column (rank-deficient
    after projection) comes back as zeros with ok False, and zeros project
    to zero, so dead columns are safe to keep in ``against``.  ``K`` and
    ``M`` are product callables; everything stays on the device."""
    Mv = M(v)
    n0 = _mnorm(v, Mv)
    for _ in range(2):
        for u, Ku, Mu in against:
            a = _dot(u, Mv)
            v, Mv = v - a * u, Mv - a * Mu
    n1 = _mnorm(v, Mv)
    ok = n1 > 1e-8 * n0
    one = torch.ones_like(n1)
    v = v * torch.where(ok, 1.0 / torch.where(ok, n1, one), 0.0 * one)
    Kv, Mv = K(v), M(v)
    for u, Ku, Mu in against:
        a = _dot(u, Mv)
        v, Kv, Mv = v - a * u, Kv - a * Ku, Mv - a * Mu
    n2 = _mnorm(v, Mv)
    ok = ok & (n2 > 0.5)
    s2 = torch.where(ok, 1.0 / torch.where(ok, n2, one), 0.0 * one)
    return v * s2, Kv * s2, Mv * s2, ok


class _Stall:
    """The reference's stop rule beside tol and max_iter: 25 iterations
    without a 2% gain on the best residual, armed only within 4 decades
    of tol."""

    def __init__(self, tol: float) -> None:
        self.tol, self.best, self.stall = tol, float("inf"), 0

    def update(self, res: float) -> None:
        self.stall = 0 if res < 0.98 * self.best else self.stall + 1
        self.best = min(self.best, res)

    def stagnated(self, res: float) -> bool:
        return self.stall >= 25 and res <= 1e4 * self.tol


def _ritz(A: torch.Tensor, dead: torch.Tensor, device) -> torch.Tensor:
    """Eigenvectors (ascending eigenvalues) of the symmetric Ritz matrix
    ``A`` with dead columns pushed past every live value, by
    ``torch.linalg.eigh`` in f64 on the host."""
    A = (A + torch.diag(torch.where(dead, 1e30, 0.0).to(A.dtype))).cpu()
    _, Y = torch.linalg.eigh(A)
    return Y.to(device)


def _lobpcg_core(K, M, x0: torch.Tensor, apply_pc, tol: float, max_iter: int) -> PowerResult:
    """Single-vector LOBPCG over span{x, T r, p} with the basis
    M-orthonormalised (the Hetmaniuk-Lehoucq stabilisation).

    Whitening the 3x3 Gram matrix instead (the textbook form) amplifies
    any Ritz-solver error by its condition number near convergence;
    orthonormalising [x, w, p] in the M inner product at the vector level
    makes it the identity to roundoff.  K and M products are recomputed
    fresh on the orthonormalised columns every iteration: tracking them
    through the projections drifts once the w column is renormalised by
    1/|w| ~ 1e9 near convergence, and the iteration stalls on a spurious
    fixed point (the reference measured it).  The returned eigenvalue is
    the fresh Rayleigh quotient of the new iterate, not the Ritz value."""
    K, M = _mv(K), _mv(M)
    dev = x0.device
    x = x0
    Kx, Mx = K(x), M(x)
    nx = _mnorm(x, Mx)
    x, Kx, Mx = x / nx, Kx / nx, Mx / nx
    lam = _dot(x, Kx)
    p = torch.zeros_like(x)
    res, it, stop = float("inf"), 0, _Stall(tol)
    while res > tol and it < max_iter and not stop.stagnated(res):
        r = Kx - lam * Mx
        w, Kw, Mw, ok_w = _orthonormalize_col(K, M, apply_pc(r), [(x, Kx, Mx)])
        p, Kp, Mp, ok_p = _orthonormalize_col(K, M, p, [(x, Kx, Mx), (w, Kw, Mw)])
        a = torch.stack([_dot(x, Kx), _dot(x, Kw), _dot(x, Kp),
                         _dot(w, Kw), _dot(w, Kp), _dot(p, Kp)])
        A3 = torch.stack([a[[0, 1, 2]], a[[1, 3, 4]], a[[2, 4, 5]]])
        dead = torch.stack([torch.zeros_like(ok_w), ~ok_w, ~ok_p])
        y = _ritz(A3, dead, dev)[:, 0]
        p = w * y[1] + p * y[2]
        x = x * y[0] + p
        Kx, Mx = K(x), M(x)
        nrm = _mnorm(x, Mx)
        x, Kx, Mx = x / nrm, Kx / nrm, Mx / nrm
        lam = _dot(x, Kx)
        res = float(torch.linalg.vector_norm(Kx - lam * Mx)
                    / torch.clamp(torch.linalg.vector_norm(Mx), min=1e-30))
        stop.update(res)
        it += 1
    return PowerResult(eigenvalue=float(lam), eigenvector=x, iterations=it, residual=res)


def lobpcg_smallest(K, M, x0: torch.Tensor, inv_diag: torch.Tensor, tol: float = 1e-10,
                    max_iter: int = 500) -> PowerResult:
    """The smallest eigenpair of the SPD pencil K x = lam M x by
    single-vector LOBPCG with a Jacobi preconditioner ``inv_diag``: each
    iteration Rayleigh-Ritzes over span{x, T r, p}."""
    return _lobpcg_core(K, M, x0, lambda r: inv_diag * r, tol, max_iter)


def lobpcg_smallest_pc(K, M, x0: torch.Tensor, pc, tol: float = 1e-10,
                       max_iter: int = 500) -> PowerResult:
    """LOBPCG with a preconditioner object exposing ``pc.apply(r)`` (for
    instance :class:`~lsafw_tpu_torch.solver.multigrid.MultigridPC`)."""
    return _lobpcg_core(K, M, x0, pc.apply, tol, max_iter)


def _lobpcg_block_core(K, M, X0: torch.Tensor, apply_pc, tol: float,
                       max_iter: int) -> BlockPowerResult:
    """Blocked LOBPCG: Rayleigh-Ritz over the 3m-column basis [X, W, P]
    each iteration, with the single-vector core's design (vector-level
    CGS2 M-orthonormalisation of the whole basis, fresh products, fresh
    Rayleigh quotients).  Dead basis columns (converged W directions, the
    first iteration's zero P) carry a 1e30 diagonal so that they sort past
    every live Ritz value.  Convergence is on the largest residual of the
    pairs, with the single-vector core's stagnation rule."""
    K, M = _mv(K), _mv(M)
    dev = X0.device
    m = X0.shape[0]
    cols = []
    for i in range(m):
        v, Kv, Mv, _ = _orthonormalize_col(K, M, X0[i], cols)
        cols.append((v, Kv, Mv))
    X = torch.stack([c[0] for c in cols])
    KX = torch.stack([c[1] for c in cols])
    MX = torch.stack([c[2] for c in cols])
    lams = (X * KX).sum(dim=1)
    P = torch.zeros_like(X)
    res = torch.full((m,), float("inf"), dtype=X.dtype, device=dev)
    maxres, it, stop = float("inf"), 0, _Stall(tol)
    k = 3 * m
    while maxres > tol and it < max_iter and not stop.stagnated(maxres):
        basis, dead = [], []
        sources = [X[i] for i in range(m)] + \
            [apply_pc(KX[i] - lams[i] * MX[i]) for i in range(m)] + [P[i] for i in range(m)]
        for v in sources:
            v, Kv, Mv, ok = _orthonormalize_col(K, M, v, basis)
            basis.append((v, Kv, Mv))
            dead.append(~ok)
        V = torch.stack([b[0] for b in basis])
        G = V @ torch.stack([b[1] for b in basis]).T
        A = torch.triu(G) + torch.triu(G, 1).T
        Y = _ritz(A, torch.stack(dead), dev)[:, :m]
        Pn = Y[m:].T @ V[m:]
        Xn = Y[:m].T @ V[:m] + Pn
        KXn, MXn = torch.stack([K(x) for x in Xn]), torch.stack([M(x) for x in Xn])
        nrm = torch.sqrt(torch.clamp((Xn * MXn).sum(dim=1), min=1e-30))[:, None]
        X, KX, MX, P = Xn / nrm, KXn / nrm, MXn / nrm, Pn
        lams = (X * KX).sum(dim=1)
        res = (torch.linalg.vector_norm(KX - lams[:, None] * MX, dim=1)
               / torch.clamp(torch.linalg.vector_norm(MX, dim=1), min=1e-30))
        maxres = float(res.max())
        stop.update(maxres)
        it += 1
    order = torch.argsort(lams)
    return BlockPowerResult(eigenvalues=lams[order], eigenvectors=X[order], iterations=it,
                            residuals=res[order])


def lobpcg_block(K, M, X0: torch.Tensor, inv_diag: torch.Tensor, tol: float = 1e-10,
                 max_iter: int = 500) -> BlockPowerResult:
    """The smallest m eigenpairs of the SPD pencil K x = lam M x by
    blocked LOBPCG with a Jacobi preconditioner; ``X0`` is (m, n), m
    start vectors as rows."""
    return _lobpcg_block_core(K, M, X0, lambda r: inv_diag * r, tol, max_iter)


def lobpcg_block_pc(K, M, X0: torch.Tensor, pc, tol: float = 1e-10,
                    max_iter: int = 500) -> BlockPowerResult:
    """Blocked LOBPCG with a preconditioner object exposing ``pc.apply(r)``."""
    return _lobpcg_block_core(K, M, X0, pc.apply, tol, max_iter)


def _cg_fixed(matvec, b: torch.Tensor, x0: torch.Tensor, iters: int,
              inv_diag: torch.Tensor) -> torch.Tensor:
    """Fixed-iteration Jacobi-preconditioned CG (no host synchronisation)."""
    x = x0
    r = b - matvec(x0)
    z = inv_diag * r
    p, rz = z, _dot(r, z)
    for _ in range(iters):
        Ap = matvec(p)
        alpha = rz / _dot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        z = inv_diag * r
        rz_new = _dot(r, z)
        p = z + (rz_new / rz) * p
        rz = rz_new
    return x


def shift_invert_power(K, M, sigma: float, x0: torch.Tensor, inv_diag: torch.Tensor,
                       tol: float = 1e-10, max_outer: int = 100,
                       cg_iters: int = 200) -> PowerResult:
    """The eigenpair of K x = lam M x nearest ``sigma`` by inverse
    iteration, each inner solve of (K - sigma M) y = M x a fixed
    ``cg_iters``-step Jacobi CG.  K and M are stencil operators on one
    structure (one sparsity pattern), so K - sigma M is a combination of
    their coefficients; it must be SPD (sigma below the spectrum of an SPD
    pencil)."""
    C = type(K)(K.structure, K.coeffs - sigma * M.coeffs, K.bc_mask, K.bc_diag)

    def rayleigh(x):
        Kx, Mx = K.matvec(x), M.matvec(x)
        return _dot(x, Kx) / _dot(x, Mx), Kx, Mx

    x = x0 / torch.linalg.vector_norm(x0)
    lam, _, _ = rayleigh(x)
    dl, it = float("inf"), 0
    while dl > tol and it < max_outer:
        y = _cg_fixed(C.matvec, M.matvec(x), x, cg_iters, inv_diag)
        x = y / torch.linalg.vector_norm(y)
        lam_new, _, _ = rayleigh(x)
        dl = float(torch.abs(lam_new - lam))
        lam, it = lam_new, it + 1
    _, Kx, Mx = rayleigh(x)
    return PowerResult(eigenvalue=float(lam), eigenvector=x, iterations=it,
                       residual=float(torch.linalg.vector_norm(Kx - lam * Mx)))
