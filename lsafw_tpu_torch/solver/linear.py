"""Krylov linear solvers: the reference's KSP menu.

Counterpart of the reference's ``solver/linear.py``: CG, restarted
GMRES / FGMRES / LGMRES / GCR, BiCG / BiCGStab / CGS, MINRES, LSQR,
Richardson, Chebyshev, QCG and PREONLY (inside :func:`solve`), and
:func:`solve_csr`, a sparse solve with a named preconditioner.  Each
solver is a plain torch loop on the vectors' device (f64 or complex128
on the card) over a ``matvec`` closure; its stopping test reads one
residual norm on the host per iteration.  GMRES and FGMRES keep their
basis on the device and their small Hessenberg least-squares problem on
the host (Givens rotations, so the residual estimate is known after
every step).  The inner products conjugate their first argument, so the
GMRES family, GCR and CG also run on complex vectors (the inexact
shift-invert of ``solver/eigen.py`` runs GMRES on complex128).

With ``group=`` (a ``torch.distributed`` process group) every solver
runs on the rows one rank holds: ``matvec`` and ``M`` map the rank's
rows to its rows, and every inner product and norm is summed over the
group's ranks (:mod:`lsafw_tpu_torch.parallel.collectives`), so that
all ranks take the same steps.  Without a group nothing is reduced.

``SolveResult.iterations`` counts matvec steps (Arnoldi steps for the
restarted methods, where the reference counts whole cycles);
``residual`` is the final relative residual each method monitors.
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import Enum
from typing import Callable

import numpy as np
import torch

Matvec = Callable[[torch.Tensor], torch.Tensor]


class KSPType(Enum):
    """Solver types (the reference's ``KSPType``; direct LU lives in
    :mod:`lsafw_tpu_torch.solver.direct`)."""

    CG = "cg"
    GMRES = "gmres"
    FGMRES = "fgmres"
    BICGSTAB = "bcgs"
    MINRES = "minres"
    RICHARDSON = "richardson"
    CHEBYSHEV = "chebyshev"
    PREONLY = "preonly"
    BICG = "bicg"
    CGS = "cgs"
    GCR = "gcr"
    LGMRES = "lgmres"
    LSQR = "lsqr"
    QCG = "qcg"

    @classmethod
    def from_string(cls, value: str) -> "KSPType":
        return cls(value.lower().strip())


@dataclass
class SolveResult:
    x: torch.Tensor
    iterations: int
    residual: float  # final relative residual (the one the method monitors)
    converged: bool
    history: list[float] | None = None
    cycles: int = 0  # restart cycles (GMRES family, GCR); 0 for the others


def _identity(x):
    return x


def _reduce(t: torch.Tensor, group=None) -> torch.Tensor:
    """``t`` summed over the ranks of ``group`` (None: ``t`` itself)."""
    if group is None:
        return t
    from lsafw_tpu_torch.parallel.collectives import all_reduce

    return all_reduce(t, group)


def _dot(a: torch.Tensor, b: torch.Tensor, group=None, *, conj: bool = True) -> torch.Tensor:
    """a^H b (``conj``) or a^T b, over the group's rows."""
    return _reduce(torch.vdot(a, b) if conj else torch.dot(a, b), group)


def _vnorm(x: torch.Tensor, group=None) -> torch.Tensor:
    """||x||_2 over the group's rows, as a device scalar."""
    if group is None:
        return torch.linalg.vector_norm(x)
    return _reduce(torch.vdot(x, x).real, group).sqrt()


def _norm(x: torch.Tensor, group=None) -> float:
    return float(_vnorm(x, group))


def _start(b: torch.Tensor, x0: torch.Tensor | None) -> torch.Tensor:
    return torch.zeros_like(b) if x0 is None else x0.clone()


def _result(x, k, res, tol, **kw) -> SolveResult:
    return SolveResult(x, int(k), float(res), bool(res <= tol), **kw)


def power_norm(matvec: Matvec, v: torch.Tensor, its: int) -> float:
    """||A v|| after ``its`` normalised power iterations from ``v``: the
    largest eigenvalue's magnitude of a Hermitian A, from below."""
    v = v / torch.linalg.vector_norm(v)
    lam = 0.0
    for _ in range(its):
        w = matvec(v)
        lam = float(torch.linalg.vector_norm(w))
        v = w / lam
    return lam


# ---------------------------------------------------------------------------
# CG
# ---------------------------------------------------------------------------


def cg(matvec: Matvec, b: torch.Tensor, x0: torch.Tensor | None = None, *,
       tol: float = 1e-10, maxiter: int = 1000, M: Matvec | None = None,
       group=None) -> SolveResult:
    """Preconditioned conjugate gradients for a symmetric (Hermitian)
    positive definite ``matvec``; ``M`` applies the preconditioner's
    inverse."""
    M = M or _identity
    x = _start(b, x0)
    bnorm = _norm(b, group) or 1.0
    r = b - matvec(x)
    z = M(r)
    p = z
    rz = _dot(r, z, group)
    k = 0
    res = _norm(r, group) / bnorm
    while res > tol and k < maxiter:
        Ap = matvec(p)
        alpha = rz / _dot(p, Ap, group)
        x = x + alpha * p
        r = r - alpha * Ap
        z = M(r)
        rz_new = _dot(r, z, group)
        p = z + (rz_new / rz) * p
        rz = rz_new
        k += 1
        res = _norm(r, group) / bnorm
    return _result(x, k, res, tol)


# ---------------------------------------------------------------------------
# GMRES(restart) and FGMRES
# ---------------------------------------------------------------------------


def _givens(a: complex, b: complex) -> tuple[complex, complex, complex]:
    """(c, s, r) with [[c, s], [-conj(s), c]] [a, b] = [r, 0], c real."""
    if b == 0:
        return 1.0, 0.0, a
    if a == 0:
        return 0.0, np.conj(b) / abs(b), abs(b)
    t = np.hypot(abs(a), abs(b))
    c = abs(a) / t
    phase = a / abs(a)
    s = phase * np.conj(b) / t
    return c, s, phase * t


def _cgs2(Vj: torch.Tensor, w: torch.Tensor, group=None):
    """CGS2: ``w`` orthogonalized twice against the rows of ``Vj``.
    Returns (the projections h1 + h2, the orthogonalized w, its norm), on
    the device.  With a ``group`` (rows distributed) a step makes two
    reductions: the second projection travels with ||w||^2, and the norm
    is ||w - Vj^T h2||^2 = ||w||^2 - |h2|^2 (h2 a rounding-level
    correction), unless the projections cancelled more than half of
    ||w||^2; then it is reduced explicitly.  Krylov-Schur and the GMRES
    family share it."""
    h1 = _reduce(Vj.conj() @ w, group)
    w = w - Vj.T @ h1
    if group is None:
        h2 = Vj.conj() @ w
        w = w - Vj.T @ h2
        return h1 + h2, w, torch.linalg.vector_norm(w)
    red = _reduce(torch.cat([Vj.conj() @ w, torch.vdot(w, w).reshape(1)]), group)
    h2, ww = red[:-1], red[-1].real
    w = w - Vj.T @ h2
    nn = ww - h2.abs().square().sum()
    return h1 + h2, w, nn.sqrt() if bool(nn >= 0.5 * ww) else _vnorm(w, group)


def _arnoldi_cycle(matvec: Matvec, M: Matvec, r: torch.Tensor, beta: float, m: int,
                   floor: float, *, flexible: bool, hist: list, maxsteps: int, group=None):
    """One restart cycle from the (preconditioned, for left GMRES)
    residual ``r`` of norm ``beta``: up to ``m`` Arnoldi steps with CGS2
    as basis products on the device, the Hessenberg column read to the
    host each step and reduced by Givens rotations, stopping once the
    least-squares residual is under ``floor``.  Returns (the correction,
    steps taken)."""
    n = r.shape[0]
    V = torch.zeros((m + 1, n), dtype=r.dtype, device=r.device)
    Z = torch.zeros((m, n), dtype=r.dtype, device=r.device) if flexible else None
    V[0] = r / beta
    R = np.zeros((m + 1, m), dtype=np.complex128)
    cs, sn = np.zeros(m), np.zeros(m, dtype=np.complex128)
    g = np.zeros(m + 1, dtype=np.complex128)
    g[0] = beta
    j = 0
    while j < min(m, maxsteps):
        if flexible:
            z = M(V[j])
            Z[j] = z
            w = matvec(z)
        else:
            w = M(matvec(V[j]))
        h, w, hj1 = _cgs2(V[: j + 1], w, group)
        col = torch.cat([h.to(torch.complex128), hj1.reshape(1).to(torch.complex128)])
        h = col.cpu().numpy()  # the Hessenberg column, read to the host
        hn = float(h[-1].real)
        V[j + 1] = w / max(hn, 1e-300)
        for i in range(j):  # earlier rotations on the new column
            a, c = h[i], h[i + 1]
            h[i] = cs[i] * a + sn[i] * c
            h[i + 1] = -np.conj(sn[i]) * a + cs[i] * c
        cs[j], sn[j], h[j] = _givens(h[j], h[j + 1])
        h[j + 1] = 0.0
        R[: j + 2, j] = h[: j + 2]
        g[j + 1] = -np.conj(sn[j]) * g[j]
        g[j] = cs[j] * g[j]
        j += 1
        hist.append(abs(g[j]))
        if abs(g[j]) <= floor or hn <= 1e-300:
            break
    if j == 0:
        return torch.zeros_like(r), 0
    Rj = R[:j, :j]
    d = np.diagonal(Rj).copy()
    safe = np.where(np.abs(d) > 1e-300, d, 1.0)
    Rj = Rj + np.diag(safe - d)
    y = np.linalg.solve(np.triu(Rj), g[:j])
    if not r.is_complex():
        y = y.real
    yt = torch.as_tensor(y, dtype=r.dtype, device=r.device)
    basis = Z[:j] if flexible else V[:j]
    return basis.T @ yt, j


def _gmres(matvec: Matvec, b: torch.Tensor, x0, *, tol: float, restart: int, maxiter: int,
           M: Matvec | None, flexible: bool, group=None) -> SolveResult:
    M = M or _identity
    x = _start(b, x0)
    hist: list[float] = []
    if flexible:
        bnorm = _norm(b, group) or 1.0
        r = b - matvec(x) if x0 is not None else b.clone()
    else:
        Mb = M(b)
        bnorm = _norm(Mb, group) or 1.0
        r = M(b - matvec(x)) if x0 is not None else Mb
    beta = _norm(r, group)
    res = beta / bnorm
    its = cycles = 0
    while res > tol and its < maxiter and np.isfinite(res):
        dx, steps = _arnoldi_cycle(matvec, M, r, beta, restart, tol * bnorm,
                                   flexible=flexible, hist=hist, maxsteps=maxiter - its,
                                   group=group)
        its += steps
        cycles += 1
        x = x + dx
        r = b - matvec(x)
        if not flexible:
            r = M(r)
        beta = _norm(r, group)
        res = beta / bnorm
        if steps == 0:
            break
    return _result(x, its, res, tol, history=[h / bnorm for h in hist], cycles=cycles)


def gmres(matvec: Matvec, b: torch.Tensor, x0: torch.Tensor | None = None, *,
          tol: float = 1e-10, restart: int = 30, maxiter: int = 1000,
          M: Matvec | None = None, group=None) -> SolveResult:
    """Left-preconditioned restarted GMRES (restart 30 by default, as
    PETSc's).  The residual is the preconditioned one, ||M(b - A x)|| /
    ||M b||, checked on the true residual at the end of every cycle.  With
    x0 = None a solve applies ``M`` once for M b, once per Arnoldi step and
    once per cycle."""
    return _gmres(matvec, b, x0, tol=tol, restart=restart, maxiter=maxiter, M=M,
                  flexible=False, group=group)


def fgmres(matvec: Matvec, b: torch.Tensor, x0: torch.Tensor | None = None, *,
           tol: float = 1e-10, restart: int = 30, maxiter: int = 1000,
           M: Matvec | None = None, group=None) -> SolveResult:
    """Flexible (right-preconditioned) restarted GMRES: the residual
    minimized and reported is the true ||b - A x|| / ||b||, and ``M`` may
    change between applies.  Keeps the preconditioned basis Z besides V."""
    return _gmres(matvec, b, x0, tol=tol, restart=restart, maxiter=maxiter, M=M,
                  flexible=True, group=group)


# ---------------------------------------------------------------------------
# BiCGStab
# ---------------------------------------------------------------------------


def bicgstab(matvec: Matvec, b: torch.Tensor, x0: torch.Tensor | None = None, *,
             tol: float = 1e-10, maxiter: int = 1000, M: Matvec | None = None,
             group=None) -> SolveResult:
    """Preconditioned BiCGStab (PETSc's ``bcgs``)."""
    M = M or _identity
    x = _start(b, x0)
    bnorm = _norm(b, group) or 1.0
    r = b - matvec(x)
    rhat = r.clone()
    one = torch.ones((), dtype=b.dtype, device=b.device)
    rho = alpha = omega = one
    v = p = torch.zeros_like(b)
    k = 0
    res = _norm(r, group) / bnorm
    while res > tol and k < maxiter:
        rho_new = _dot(rhat, r, group)
        beta = (rho_new / rho) * (alpha / omega)
        p = r + beta * (p - omega * v)
        phat = M(p)
        v = matvec(phat)
        alpha = rho_new / _dot(rhat, v, group)
        s = r - alpha * v
        shat = M(s)
        t = matvec(shat)
        omega = _dot(t, s, group) / _dot(t, t, group)
        x = x + alpha * phat + omega * shat
        r = s - omega * t
        rho = rho_new
        k += 1
        res = _norm(r, group) / bnorm
    return _result(x, k, res, tol)


# ---------------------------------------------------------------------------
# MINRES (symmetric indefinite)
# ---------------------------------------------------------------------------


def minres(matvec: Matvec, b: torch.Tensor, x0: torch.Tensor | None = None, *,
           tol: float = 1e-10, maxiter: int = 1000, M: Matvec | None = None,
           group=None) -> SolveResult:
    """Preconditioned MINRES (Paige-Saunders) for a real symmetric
    indefinite ``matvec`` with a symmetric positive definite ``M``.  The
    monitored residual is the preconditioned estimate phibar relative to
    its start; ``residual`` reports the true ||b - A x|| / ||b||, and
    ``converged`` the monitored test, as the reference does.  A negative
    r^T M r proves ``M`` indefinite: the iteration stops there as a
    breakdown, unconverged (the reference clamps it to 0, which ends the
    loop as converged)."""
    M = M or _identity
    x = _start(b, x0)
    r1 = b - matvec(x)
    y = M(r1)
    rMr = float(_dot(r1, y, group, conj=False))
    beta1 = float(np.sqrt(max(rMr, 0.0)))
    floor = max(beta1, 1e-300)
    breakdown = rMr < 0
    r2 = r1
    oldb, beta = 0.0, beta1
    dbar = epsln = 0.0
    phibar = beta1
    cs, sn = -1.0, 0.0
    w = torch.zeros_like(b)
    w2 = torch.zeros_like(b)
    k = 0
    while phibar > tol * floor and k < maxiter and not breakdown:
        v = y / max(beta, 1e-300)
        y2 = matvec(v)
        if k >= 1:
            y2 = y2 - (beta / max(oldb, 1e-300)) * r1
        alfa_t = _dot(v, y2, group, conj=False)
        y2 = y2 - (alfa_t / max(beta, 1e-300)) * r2
        r1, r2 = r2, y2
        y = M(r2)
        oldb = beta
        alfa, rMr = torch.stack([alfa_t, _dot(r2, y, group, conj=False)]).tolist()
        if rMr < 0:
            breakdown = True
            break
        beta = float(np.sqrt(rMr))
        oldeps = epsln
        delta = cs * dbar + sn * alfa
        gbar = sn * dbar - cs * alfa
        epsln = sn * beta
        dbar = -cs * beta
        gamma = max(float(np.hypot(gbar, beta)), 1e-300)
        cs, sn = gbar / gamma, beta / gamma
        phi = cs * phibar
        phibar = sn * phibar
        w1 = w2
        w2 = w
        w = (v - oldeps * w1 - delta * w2) / gamma
        x = x + phi * w
        k += 1
    bnorm = max(_norm(b, group), 1e-300)
    res = _norm(b - matvec(x), group) / bnorm
    return SolveResult(x, k, res, bool(phibar <= tol * floor and not breakdown))


# ---------------------------------------------------------------------------
# Richardson / Chebyshev (the PETSc smoother-type KSPs)
# ---------------------------------------------------------------------------


def richardson(matvec: Matvec, b: torch.Tensor, x0: torch.Tensor | None = None, *,
               omega: float = 1.0, tol: float = 1e-10, maxiter: int = 1000,
               M: Matvec | None = None, group=None) -> SolveResult:
    """Damped preconditioned Richardson: x += omega M(b - A x)."""
    M = M or _identity
    x = _start(b, x0)
    bnorm = max(_norm(b, group), 1e-300)
    r = b - matvec(x)
    k = 0
    res = _norm(r, group) / bnorm
    while res > tol and k < maxiter:
        x = x + omega * M(r)
        r = b - matvec(x)
        k += 1
        res = _norm(r, group) / bnorm
    return _result(x, k, res, tol)


def chebyshev(matvec: Matvec, b: torch.Tensor, x0: torch.Tensor | None = None, *,
              lmin: float, lmax: float, tol: float = 1e-10, maxiter: int = 1000,
              M: Matvec | None = None, group=None) -> SolveResult:
    """Chebyshev iteration on the (preconditioned) spectrum [lmin, lmax]:
    no inner products beyond the stopping test."""
    M = M or _identity
    x = _start(b, x0)
    bnorm = max(_norm(b, group), 1e-300)
    d = 0.5 * (lmax + lmin)
    c = 0.5 * (lmax - lmin)
    r = b - matvec(x)
    p = torch.zeros_like(b)
    alpha = 0.0
    k = 0
    res = _norm(r, group) / bnorm
    while res > tol and k < maxiter:
        z = M(r)
        beta = 0.0 if k == 0 else (0.5 * (c * alpha) ** 2 if k == 1 else (0.5 * c * alpha) ** 2)
        alpha = 1.0 / d if k == 0 else 1.0 / (d - beta / alpha)
        p = z + beta * p
        x = x + alpha * p
        r = r - alpha * matvec(p)
        k += 1
        res = _norm(r, group) / bnorm
    return _result(x, k, res, tol)


# ---------------------------------------------------------------------------
# BiCG, CGS, GCR, LGMRES, LSQR, QCG
# ---------------------------------------------------------------------------


def bicg(matvec: Matvec, b: torch.Tensor, x0: torch.Tensor | None = None, *,
         rmatvec: Matvec, tol: float = 1e-10, maxiter: int = 1000,
         M: Matvec | None = None, group=None) -> SolveResult:
    """Preconditioned BiCG for a real operator.  ``rmatvec`` applies the
    transpose; the preconditioner is taken as symmetric (as the diagonal
    and block-diagonal ones are), so the adjoint chain reuses ``M``."""
    M = M or _identity
    x = _start(b, x0)
    bnorm = max(_norm(b, group), 1e-300)
    r = b - matvec(x)
    rt = r.clone()
    z, zt = M(r), M(rt)
    p, pt = z, zt
    rho = _dot(z, rt, group, conj=False)
    k = 0
    res = _norm(r, group) / bnorm
    while res > tol and k < maxiter:
        q = matvec(p)
        qt = rmatvec(pt)
        alpha = rho / _dot(pt, q, group, conj=False)
        x = x + alpha * p
        r = r - alpha * q
        rt = rt - alpha * qt
        z, zt = M(r), M(rt)
        rho_new = _dot(z, rt, group, conj=False)
        beta = rho_new / rho
        p = z + beta * p
        pt = zt + beta * pt
        rho = rho_new
        k += 1
        res = _norm(r, group) / bnorm
    return _result(x, k, res, tol)


def cgs(matvec: Matvec, b: torch.Tensor, x0: torch.Tensor | None = None, *,
        tol: float = 1e-10, maxiter: int = 1000, M: Matvec | None = None,
        group=None) -> SolveResult:
    """Conjugate gradient squared, the transpose-free BiCG variant."""
    M = M or _identity
    x = _start(b, x0)
    bnorm = max(_norm(b, group), 1e-300)
    r = b - matvec(x)
    rt = r.clone()
    rho = torch.ones((), dtype=b.dtype, device=b.device)
    u = p = q = torch.zeros_like(b)
    k = 0
    res = _norm(r, group) / bnorm
    while res > tol and k < maxiter:
        rho_new = _dot(rt, r, group)
        beta = 0.0 if k == 0 else rho_new / rho
        u = r + beta * q
        p = u + beta * (q + beta * p)
        phat = M(p)
        v = matvec(phat)
        alpha = rho_new / _dot(rt, v, group)
        q = u - alpha * v
        uq = M(u + q)
        x = x + alpha * uq
        r = r - alpha * matvec(uq)
        rho = rho_new
        k += 1
        res = _norm(r, group) / bnorm
    return _result(x, k, res, tol)


def _gcr_cycle(matvec: Matvec, M: Matvec, x, r, seeds: list, restart: int, floor: float,
               maxsteps: int, group=None):
    """One GCR cycle: minimize ||r|| over up to ``restart`` directions,
    first the ``seeds`` (augmentation vectors), then preconditioned
    residuals; each new image is orthogonalized (CGS2) against the kept
    ones.  Stops early once ||r|| <= ``floor``.  Returns (x, r, steps)."""
    n = r.shape[0]
    D = torch.zeros((restart, n), dtype=r.dtype, device=r.device)
    AD = torch.zeros_like(D)
    j = 0
    while j < min(restart, maxsteps):
        d = seeds[j] if j < len(seeds) else M(r)
        Ad = matvec(d)
        for _ in range(2):
            c = _reduce(AD[:j].conj() @ Ad, group)
            d = d - D[:j].T @ c
            Ad = Ad - AD[:j].T @ c
        nrm = _vnorm(Ad, group)
        inv = torch.where(nrm > 1e-300, 1.0 / nrm.clamp_min(1e-300), torch.zeros_like(nrm))
        d, Ad = d * inv, Ad * inv
        alpha = _dot(Ad, r, group)
        x = x + alpha * d
        r = r - alpha * Ad
        D[j], AD[j] = d, Ad
        j += 1
        if _norm(r, group) <= floor:
            break
    return x, r, j


def gcr(matvec: Matvec, b: torch.Tensor, x0: torch.Tensor | None = None, *,
        tol: float = 1e-10, restart: int = 30, maxiter: int = 1000,
        M: Matvec | None = None, group=None) -> SolveResult:
    """Restarted generalized conjugate residual; flexible, as FGMRES."""
    M = M or _identity
    x = _start(b, x0)
    bnorm = max(_norm(b, group), 1e-300)
    r = b - matvec(x)
    res = _norm(r, group) / bnorm
    its = cycles = 0
    while res > tol and its < maxiter:
        x, r, steps = _gcr_cycle(matvec, M, x, r, [], restart, tol * bnorm, maxiter - its,
                                 group)
        its += steps
        cycles += 1
        res = _norm(r, group) / bnorm
    return _result(x, its, res, tol, cycles=cycles)


def lgmres(matvec: Matvec, b: torch.Tensor, x0: torch.Tensor | None = None, *,
           tol: float = 1e-10, restart: int = 30, aug: int = 2, maxiter: int = 1000,
           M: Matvec | None = None, group=None) -> SolveResult:
    """LGMRES-style augmented restart (Baker-Jessup-Manteuffel) in GCR
    form: each cycle's subspace is seeded with the previous ``aug``
    cycles' error approximations z = x_new - x_old."""
    M = M or _identity
    x = _start(b, x0)
    bnorm = max(_norm(b, group), 1e-300)
    r = b - matvec(x)
    res = _norm(r, group) / bnorm
    seeds: list = []
    its = cycles = 0
    while res > tol and its < maxiter:
        x_new, r, steps = _gcr_cycle(matvec, M, x, r, seeds, restart, tol * bnorm,
                                     maxiter - its, group)
        seeds = ([x_new - x] + seeds)[: max(aug, 1)]
        x = x_new
        its += steps
        cycles += 1
        res = _norm(r, group) / bnorm
    return _result(x, its, res, tol, cycles=cycles)


def lsqr(matvec: Matvec, b: torch.Tensor, x0: torch.Tensor | None = None, *,
         rmatvec: Matvec, tol: float = 1e-10, maxiter: int = 1000, group=None) -> SolveResult:
    """LSQR, Golub-Kahan bidiagonalization, unpreconditioned (PETSc's
    default).  Monitors phibar (the least-squares residual estimate);
    ``residual`` reports the true one."""
    x = _start(b, x0)
    bnorm = max(_norm(b, group), 1e-300)
    u = b - matvec(x)
    beta = _norm(u, group)
    u = u / max(beta, 1e-300)
    v = rmatvec(u)
    alpha = _norm(v, group)
    v = v / max(alpha, 1e-300)
    w = v
    phibar, rhobar = beta, alpha
    k = 0
    while phibar / bnorm > tol and k < maxiter:
        u = matvec(v) - alpha * u
        beta = _norm(u, group)
        u = u / max(beta, 1e-300)
        v_new = rmatvec(u) - beta * v
        alpha = _norm(v_new, group)
        v_new = v_new / max(alpha, 1e-300)
        rho = float(np.hypot(rhobar, beta))
        c, s = rhobar / rho, beta / rho
        theta = s * alpha
        rhobar = -c * alpha
        phi = c * phibar
        phibar = s * phibar
        x = x + (phi / rho) * w
        w = v_new - (theta / rho) * w
        v = v_new
        k += 1
    res = _norm(b - matvec(x), group) / bnorm
    return _result(x, k, res, tol)


def qcg(matvec: Matvec, b: torch.Tensor, x0: torch.Tensor | None = None, *,
        tol: float = 1e-10, maxiter: int = 1000, M: Matvec | None = None,
        radius: float | None = None, group=None) -> SolveResult:
    """Trust-region preconditioned CG (Steihaug-Toint): PCG until the
    iterate would leave the ball ||x|| <= radius, then a step exactly to
    the boundary and stop.  ``radius=None`` is CG."""
    M = M or _identity
    rad = float("inf") if radius is None else float(radius)
    x = _start(b, x0)
    bnorm = max(_norm(b, group), 1e-300)
    r = b - matvec(x)
    z = M(r)
    p = z
    rz = _dot(r, z, group, conj=False)
    k = 0
    res = _norm(r, group) / bnorm
    on_boundary = False
    while res > tol and k < maxiter and not on_boundary:
        Ap = matvec(p)
        alpha = rz / _dot(p, Ap, group, conj=False)
        step = alpha
        if np.isfinite(rad):
            xx, xp, pp, a = torch.stack([_dot(x, x, group, conj=False),
                                         _dot(x, p, group, conj=False),
                                         _dot(p, p, group, conj=False), alpha]).tolist()
            disc = max(xp**2 + pp * (rad**2 - xx), 0.0)
            tau = (-xp + np.sqrt(disc)) / max(pp, 1e-300)
            if a > tau:
                step, on_boundary = tau, True
        x = x + step * p
        r = r - step * Ap
        z = M(r)
        rz_new = _dot(r, z, group, conj=False)
        p = z + (rz_new / rz) * p
        rz = rz_new
        k += 1
        res = _norm(r, group) / bnorm
    return _result(x, k, res, tol)


# ---------------------------------------------------------------------------
# Front ends
# ---------------------------------------------------------------------------


def solve(matvec: Matvec, b: torch.Tensor, *, ksp_type: KSPType | str = KSPType.GMRES,
          x0: torch.Tensor | None = None, tol: float = 1e-10, maxiter: int = 1000,
          restart: int = 30, M: Matvec | None = None, rmatvec: Matvec | None = None,
          lmin: float | None = None, lmax: float | None = None,
          radius: float | None = None, group=None) -> SolveResult:
    """Dispatch on ``ksp_type`` (a :class:`KSPType` or its name); ``group``
    distributes the rows over a process group (module docstring)."""
    ksp = KSPType.from_string(ksp_type) if isinstance(ksp_type, str) else ksp_type
    if ksp is KSPType.CG:
        return cg(matvec, b, x0, tol=tol, maxiter=maxiter, M=M, group=group)
    if ksp is KSPType.GMRES:
        return gmres(matvec, b, x0, tol=tol, restart=restart, maxiter=maxiter, M=M, group=group)
    if ksp is KSPType.FGMRES:
        return fgmres(matvec, b, x0, tol=tol, restart=restart, maxiter=maxiter, M=M, group=group)
    if ksp is KSPType.BICGSTAB:
        return bicgstab(matvec, b, x0, tol=tol, maxiter=maxiter, M=M, group=group)
    if ksp is KSPType.MINRES:
        return minres(matvec, b, x0, tol=tol, maxiter=maxiter, M=M, group=group)
    if ksp is KSPType.RICHARDSON:
        return richardson(matvec, b, x0, tol=tol, maxiter=maxiter, M=M, group=group)
    if ksp is KSPType.CHEBYSHEV:
        if lmin is None or lmax is None:
            raise ValueError("CHEBYSHEV requires lmin/lmax spectrum bounds.")
        return chebyshev(matvec, b, x0, lmin=lmin, lmax=lmax, tol=tol, maxiter=maxiter, M=M,
                         group=group)
    if ksp is KSPType.CGS:
        return cgs(matvec, b, x0, tol=tol, maxiter=maxiter, M=M, group=group)
    if ksp is KSPType.GCR:
        return gcr(matvec, b, x0, tol=tol, restart=restart, maxiter=maxiter, M=M, group=group)
    if ksp is KSPType.LGMRES:
        return lgmres(matvec, b, x0, tol=tol, restart=restart, maxiter=maxiter, M=M, group=group)
    if ksp is KSPType.QCG:
        return qcg(matvec, b, x0, tol=tol, maxiter=maxiter, M=M, radius=radius, group=group)
    if ksp in (KSPType.BICG, KSPType.LSQR):
        if rmatvec is None:
            raise ValueError(f"{ksp.name} requires rmatvec (transpose apply).")
        if ksp is KSPType.BICG:
            return bicg(matvec, b, x0, rmatvec=rmatvec, tol=tol, maxiter=maxiter, M=M,
                        group=group)
        return lsqr(matvec, b, x0, rmatvec=rmatvec, tol=tol, maxiter=maxiter, group=group)
    if ksp is KSPType.PREONLY:
        if M is None:
            raise ValueError("PREONLY requires a preconditioner.")
        x = M(b)
        res = _norm(b - matvec(x), group) / max(_norm(b, group), 1e-300)
        return SolveResult(x, 1, res, res < 1.0)
    raise ValueError(ksp)


def solve_csr(A, b: torch.Tensor, M: Callable | None = None, *, ksp_type: str = "gmres",
              tol: float = 1e-10, maxiter: int = 1000, restart: int = 30) -> SolveResult:
    """Sparse solve of the CSRMatrix ``A`` with the preconditioner apply
    ``M`` (a closure of :mod:`~lsafw_tpu_torch.solver.precond`, or None);
    BiCG and LSQR take A's transpose.  The products with A (and A^T) run
    through S (:func:`~lsafw_tpu_torch.ops.bcsr.matvec_of`)."""
    from lsafw_tpu_torch.ops.bcsr import matvec_of

    rmatvec = None
    if KSPType.from_string(ksp_type) in (KSPType.BICG, KSPType.LSQR):
        rmatvec = matvec_of(A.transpose())
    return solve(matvec_of(A), b, ksp_type=ksp_type, tol=tol, maxiter=maxiter,
                 restart=restart, M=M, rmatvec=rmatvec)
