"""Krylov-Schur eigensolver with the shift-invert and Cayley spectral
transforms.

The Krylov basis lives on the device as a complex128 (ncv+1, n)
tensor; orthogonalization is CGS2 as dense basis products.  The
shift-invert apply y = (A - sigma M)^-1 M v (Cayley: (A - sigma M)^-1
(A + nu M) v) is, with ``method="banded"``, the band factor of
:mod:`lsafw_tpu_torch.solver.band` (``factor_auto``: pivoted complex64
within ``LSAFW_PIVOT_MEM_GB``, else pivot-free with the K1/K2 kernels;
a real shift takes the real factors) with f64 GCR refinement, whose
C = A - sigma M and M applies run through the S kernel on the permuted
CSR of (A, M) (``ops/bcsr.py`` ``BCSRShiftedOp``, sigma a kernel
argument).  At a real shift a real f64 vector stays real throughout
(the real factor's one-column substitution, S on an f64 x).  With
``method="lu"`` (asked for only) one host SuperLU of C serves every
solve, the vectors crossing to the host and back.  The (ncv x ncv)
Hessenberg bookkeeping, sorted Schur restarts and Ritz extraction run
on the host in numpy/scipy complex128.

Eigenvalue back-transform: theta = 1/(lambda - sigma), so
lambda = sigma + 1/theta; Cayley: lambda = (sigma theta + nu)/(theta - 1).
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from enum import Enum
from typing import Callable

import numpy as np
import scipy.linalg as sla
import scipy.sparse as sp
import torch

from lsafw_tpu_torch import resolve_device
from lsafw_tpu_torch.ops.bcsr import BCSRShiftedOp, plan_for_pattern
from lsafw_tpu_torch.ops.sparse import CSRMatrix, spmv
from lsafw_tpu_torch.solver.band import factor_auto, plan_for_csr
from lsafw_tpu_torch.solver.direct import SparseLU
from lsafw_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


class STType(Enum):
    """Spectral transforms; the port runs SINVERT and CAYLEY."""

    SHIFT = "shift"
    SINVERT = "sinvert"
    CAYLEY = "cayley"
    PRECOND = "precond"
    FILTER = "filter"
    SHELL = "shell"


class EpsWhich(Enum):
    LARGEST_MAGNITUDE = "largest_magnitude"
    SMALLEST_MAGNITUDE = "smallest_magnitude"
    LARGEST_REAL = "largest_real"
    SMALLEST_REAL = "smallest_real"
    TARGET_MAGNITUDE = "target_magnitude"
    TARGET_REAL = "target_real"


@dataclass
class EigensolverConfig:
    num_eig: int = 5
    atol: float = 1e-8
    max_it: int = 500
    ncv: int = 80


# ---------------------------------------------------------------------------
# Shift-invert operator
# ---------------------------------------------------------------------------


@dataclass(eq=False)
class BandedSIOp:
    """Shift-invert operator state: the CSR pair, the band factor of
    C = A - sigma M (any factor of :mod:`~lsafw_tpu_torch.solver.band`),
    the shift, ``Cop``, the fused (A, M) operator of the refinement
    matvecs (None: the CSR pair applies them), and ``nu``, the Cayley
    antishift (None: the shift-invert right-hand side M v)."""

    A: CSRMatrix
    M: CSRMatrix
    blu: object
    sigma: complex
    Cop: BCSRShiftedOp | None = None
    nu: complex | None = None


def _coef(z: complex, x: torch.Tensor):
    """The scalar z for products with x: a float where x is real and z
    has no imaginary part, so that a real vector stays real."""
    return z.real if not x.is_complex() and z.imag == 0.0 else z


def _si_apply_C(op: BandedSIOp, x: torch.Tensor) -> torch.Tensor:
    """(A - sigma M) x."""
    if op.Cop is not None:
        return op.Cop.matvec_pair(x)
    return spmv(op.A, x) - _coef(op.sigma, x) * spmv(op.M, x)


def _si_apply_M(op: BandedSIOp, x: torch.Tensor) -> torch.Tensor:
    """M x, from Cop's storage where there is a Cop."""
    if op.Cop is not None:
        return op.Cop.mass_pair(x)
    return spmv(op.M, x)


def _si_rhs(op: BandedSIOp, v: torch.Tensor) -> torch.Tensor:
    """The transformed apply's right-hand side: M v (shift-invert), or
    A v + nu M v = C v + (sigma + nu) M v (Cayley), whose C v and M v
    come from one pass of the fused operator."""
    if op.nu is None:
        return _si_apply_M(op, v)
    if op.Cop is not None:
        Cv, Mv = op.Cop.matvec_pair(v, mass=True)
    else:
        Mv = spmv(op.M, v)
        Cv = spmv(op.A, v) - _coef(op.sigma, v) * Mv
    return Cv + _coef(op.sigma + op.nu, Cv) * Mv


def banded_solve_raw(op: BandedSIOp, b: torch.Tensor, *, tol: float = 1e-9,
                     max_its: int = 16, m: int = 8) -> torch.Tensor:
    """x ~= (A - sigma M)^-1 b for a raw right-hand side (no M
    premultiply) by truncated GCR(m) refinement, preconditioned by the
    band factor: each correction's image is orthogonalized against the
    last ``m`` kept images.  Complex in complex128; an f64 b at a real
    shift stays f64 (the real factor's one-column substitution)."""
    return _refine(op, b, tol=tol, max_its=max_its, m=m)[0]


def _refine(op: BandedSIOp, b: torch.Tensor, *, tol: float, max_its: int,
            m: int = 8) -> tuple[torch.Tensor, int, float]:
    """:func:`banded_solve_raw`'s GCR(m), returning (x, iterations, the
    last relative residual norm it saw)."""
    bnorm = torch.linalg.vector_norm(b)
    floor = max(float(bnorm), 1e-300)
    x = op.blu.solve(b)
    r = b - _si_apply_C(op, x)
    D = torch.zeros((m, b.shape[0]), dtype=b.dtype, device=b.device)
    CD = torch.zeros_like(D)
    k = 0
    while k < max_its:
        rn = float(torch.linalg.vector_norm(r))
        if not (np.isfinite(rn) and rn > tol * floor):
            break
        d = op.blu.solve(r)
        Cd = _si_apply_C(op, d)
        beta = CD.conj() @ Cd  # complex CGS against the kept images
        Cd = Cd - CD.T @ beta
        d = d - D.T @ beta
        nrm = torch.linalg.vector_norm(Cd).clamp_min(1e-300)
        d, Cd = d / nrm, Cd / nrm
        alpha = torch.vdot(Cd, r)
        x = x + alpha * d
        r = r - alpha * Cd
        D[k % m] = d
        CD[k % m] = Cd
        k += 1
    rn = float(torch.linalg.vector_norm(r))
    return x, k, rn / floor


def banded_si_apply(op: BandedSIOp, v: torch.Tensor, *, tol: float = 1e-9,
                    max_its: int = 16) -> torch.Tensor:
    """y ~= (A - sigma M)^-1 (M v), or (A - sigma M)^-1 (A + nu M) v with
    a Cayley antishift."""
    return banded_solve_raw(op, _si_rhs(op, v), tol=tol, max_its=max_its)


def _free_device_bytes(device: torch.device, held: int) -> float:
    """Device memory the operators may still take, ``held`` bytes of a
    just-made factor included in what is gone: env ``LSAFW_HBM_GB`` less
    ``held`` where set; on a card, what it has free (``cudaMemGetInfo``'s
    free memory and what PyTorch's allocator holds unused), so that every
    factor alive, another operator's too, is counted; the host's memory
    less ``held`` for the CPU."""
    if "LSAFW_HBM_GB" in os.environ:
        return float(os.environ["LSAFW_HBM_GB"]) * 1e9 - held
    if device.type == "cuda":
        free, _ = torch.cuda.mem_get_info(device)
        return float(free + torch.cuda.memory_reserved(device)
                     - torch.cuda.memory_allocated(device))
    return float(os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")) - held


class FactorUnusable(RuntimeError):
    """The band factor at a shift is non-finite or preconditions too weakly
    (for instance a shift on an exact eigenvalue, where C is singular to
    working precision)."""


class ShiftInvertOperator:
    """y = (A - sigma M)^-1 (M v) with real A, M and complex sigma, or with
    ``antishift`` nu the Cayley apply y = (A - sigma M)^-1 (A + nu M) v on
    the same factor.

    ``method="banded"`` (the device path): the band factor + f64
    refinement.  The refinement depth is calibrated from the factor's
    measured contraction rho (one refinement step's residual on a unit
    vector from a seed, real at a real shift), as the reference does: the
    Richardson bound 2 log(tol) / log(rho) iterations, within a cap of
    300.  Where that bound refuses (rho near or above 1, as a bf16 band of
    the 175k production operator gives), the refinement itself is run on
    the same vector: GCR(8) reaches the tolerance in a few iterations
    where a few directions alone are amplified, and the factor is kept if
    it does so within ``_TRIAL_CAP`` iterations, with a cap of four times
    as many (at most 300).  A factor that is non-finite or fails both
    raises :class:`FactorUnusable` (the reference falls back to a host
    LU; nothing here does).

    ``method="lu"``: one host SuperLU of C = A - sigma M (A - sigma I
    where M is None), real at a real shift, as the reference's host path
    (``lsafw_tpu/solver/eigen.py:792-799``); right-hand sides are formed
    on the vector's device, cross to the host for the solve and come
    back.  It runs only when asked for.

    ``elements`` (the reference's per-cell element matrices for
    matrix-free refinement matvecs) is accepted and ignored: S carries the
    refinement matvecs on the assembled CSR, and the element operator is
    not ported."""

    _CAP = 300
    _TRIAL_CAP = 60

    def __init__(self, A: CSRMatrix, M: CSRMatrix | None, sigma: complex, *,
                 method: str = "banded", inner_tol: float = 1e-10, elements=None,
                 antishift: complex | None = None) -> None:
        if method not in ("banded", "lu"):
            raise NotImplementedError(f"shift-invert method {method!r} is not ported")
        self.A, self.M = A, M
        self.sigma = complex(sigma)
        self.antishift = None if antishift is None else complex(antishift)
        self.method = method
        self._n = A.shape[0]
        self._inner_tol = inner_tol
        self.applies = 0
        self.pivoted = False
        self.device_op = None
        self.rho = self.refine_its = None
        self.trial_its = None  # GCR iterations of the trial solve, where one ran
        t0 = time.time()
        if method == "lu":
            self._lu = SparseLU(self._host_C())
            self.factor_seconds = time.time() - t0
            return
        blu = self._factor_banded()
        self.factor_seconds = time.time() - t0
        band_bytes = sum(t.numel() * t.element_size() for t in vars(blu).values()
                         if isinstance(t, torch.Tensor))
        self.device_op = BandedSIOp(A, M, blu, self.sigma, self._build_bcsr_ops(band_bytes),
                                    self.antishift)
        rng = np.random.default_rng(11)
        b0 = rng.standard_normal(self._n)
        b0 /= np.linalg.norm(b0)
        real = self.sigma.imag == 0.0
        b0 = torch.as_tensor(b0, dtype=torch.float64 if real else torch.complex128,
                             device=A.device)
        x0 = blu.solve(b0)
        rho = float(torch.linalg.vector_norm(b0 - _si_apply_C(self.device_op, x0)))
        self.rho = rho
        if not np.isfinite(rho):
            raise FactorUnusable(f"band factor is not usable: calibration contraction {rho}")
        rho_c = min(max(rho, 1e-14), 0.999)
        needed = int(2 * np.ceil(np.log(inner_tol) / np.log(rho_c)))
        if needed <= self._CAP:
            self.refine_its = int(np.clip(needed, 4, self._CAP))
        else:
            _, its, res = _refine(self.device_op, b0, tol=inner_tol, max_its=self._TRIAL_CAP)
            if not res <= inner_tol:
                raise FactorUnusable(
                    f"band factor preconditions too weakly: contraction {rho:.3e} needs "
                    f"~{needed} refinement iterations for tol {inner_tol:.0e} (cap {self._CAP}), "
                    f"and a trial GCR solve reached {res:.1e} in {its}")
            self.trial_its = its
            self.refine_its = int(min(4 * max(its, 1), self._CAP))
        logger.info("Banded shift-invert: contraction %.2e%s -> refinement cap %d for tol %.0e",
                    rho, "" if self.trial_its is None else
                    f" (trial GCR solve: {self.trial_its} iterations)", self.refine_its, inner_tol)

    def _host_C(self) -> sp.csc_matrix:
        """C = A - sigma M (A - sigma I without M) on the host: real at a
        real shift, else complex."""
        As = self.A.to_scipy()
        Ms = self.M.to_scipy() if self.M is not None else sp.identity(self._n, format="csr")
        if self.sigma.imag == 0.0:
            return (As - self.sigma.real * Ms).tocsc()
        return (As.astype(np.complex128) - self.sigma * Ms).tocsc()

    def _host_solve(self, b: torch.Tensor) -> torch.Tensor:
        """C^-1 b by the host LU, back on b's device in b's dtype (a complex
        b on a real factor as two real columns)."""
        bh = b.detach().cpu().numpy()
        if np.iscomplexobj(bh) and not np.issubdtype(self._lu.dtype, np.complexfloating):
            xs = self._lu.solve(np.stack([bh.real, bh.imag], axis=1))
            x = xs[:, 0] + 1j * xs[:, 1]
        else:
            x = self._lu.solve(bh)
        return torch.as_tensor(x, device=b.device)

    def _csr_rhs(self, v: torch.Tensor) -> torch.Tensor:
        """The right-hand side of the host method, on v's device: M v (v
        without M), or A v + nu M v."""
        Mv = spmv(self.M, v) if self.M is not None else v
        if self.antishift is None:
            return Mv
        return spmv(self.A, v) + _coef(self.antishift, v) * Mv

    def _factor_banded(self):
        """Factor C = A - sigma M on the shared pattern of A and M through
        ``factor_auto``: pivoted within its memory budget, else pivot-free
        with the saddle regularization of the zero pressure diagonals.  A
        real shift factors one real band."""
        A, M = self.A, self.M
        if M is None or M.pattern is not A.pattern:
            raise NotImplementedError("A and M must share one sparsity pattern")
        dre = A.data - self.sigma.real * M.data
        if self.sigma.imag == 0.0:
            blu, self.pivoted = factor_auto(plan_for_csr(A, real=True), dre,
                                            diag_slots=A.pattern.diag_slots)
            return blu
        dim = (-self.sigma.imag) * M.data
        blu, self.pivoted = factor_auto(plan_for_csr(A), dre, dim, diag_slots=A.pattern.diag_slots)
        return blu

    def _build_bcsr_ops(self, band_bytes: int = 0) -> BCSRShiftedOp | None:
        """The fused (A, M) operator of the refinement matvecs, or None (the
        CSR pair applies them) when its values do not fit beside the
        factors: the budget is min(``LSAFW_BCSR_MEM_GB``, default 6, the
        device's free memory less a 3.5 GB margin), where the free memory
        already excludes this factor and any other alive (two at once in a
        resolvent frequency or a transient horizon)."""
        A, M = self.A, self.M
        plan = plan_for_pattern(A)
        budget = min(float(os.environ.get("LSAFW_BCSR_MEM_GB", "6")) * 1e9,
                     _free_device_bytes(A.device, band_bytes) - 3.5e9)
        need = 2 * plan.bytes_per_matrix + plan.index_bytes
        if need > budget:
            logger.info("CSR (A, M) operator (%.2f GB) over budget %.1f GB; applying the CSR pair.",
                        need / 1e9, budget / 1e9)
            return None
        logger.info("Refinement matvecs on the permuted CSR of (A, M): %.3f GB", need / 1e9)
        return BCSRShiftedOp.from_csr(A, M, self.sigma, plan)

    def figures(self) -> dict:
        """The operator's figures: factor seconds, contraction, trial GCR
        iterations, refinement cap, applies, pivoted, fused matvecs."""
        return dict(factor_s=self.factor_seconds, rho=self.rho, trial_its=self.trial_its,
                    refine_its=self.refine_its, applies=self.applies, pivoted=self.pivoted,
                    fused=self.device_op is not None and self.device_op.Cop is not None)

    def apply(self, v: torch.Tensor) -> torch.Tensor:
        """One transformed apply: (A - sigma M)^-1 M v, or the Cayley apply."""
        self.applies += 1
        if self.method == "lu":
            return self._host_solve(self._csr_rhs(v))
        return banded_si_apply(self.device_op, v, tol=self._inner_tol, max_its=self.refine_its)

    def solve_raw(self, b: torch.Tensor) -> torch.Tensor:
        """x = (A - sigma M)^-1 b for a raw right-hand side (no M
        premultiply, no Cayley right-hand side): the building block of
        the non-modal analyses (:mod:`lsafw_tpu_torch.transient`)."""
        if self.method == "lu":
            return self._host_solve(b)
        return banded_solve_raw(self.device_op, b, tol=self._inner_tol, max_its=self.refine_its)

    def back_transform(self, theta: np.ndarray) -> np.ndarray:
        """theta -> lambda = sigma + 1/theta; Cayley: lambda = (sigma theta
        + nu) / (theta - 1)."""
        if self.antishift is not None:
            den = theta - 1.0
            den = np.where(np.abs(den) < 1e-300, 1e-300, den)
            return (self.sigma * theta + self.antishift) / den
        return self.sigma + 1.0 / theta


# ---------------------------------------------------------------------------
# Krylov-Schur
# ---------------------------------------------------------------------------


@dataclass
class KrylovSchurResult:
    eigenvalues: np.ndarray  # (nconv,) complex, sorted by selection
    eigenvectors: np.ndarray  # (nconv, n) complex
    residuals: np.ndarray  # Ritz residual estimates |beta e_m^T y|
    iterations: int
    converged: bool
    nconv: int = 0


def _sort_key(which: EpsWhich, target: complex | None):
    """Scalar sort key (ascending = more wanted) for each selection."""
    t = target or 0.0
    return {
        EpsWhich.LARGEST_MAGNITUDE: lambda z: -np.abs(z),
        EpsWhich.SMALLEST_MAGNITUDE: lambda z: np.abs(z),
        EpsWhich.LARGEST_REAL: lambda z: -np.real(z),
        EpsWhich.SMALLEST_REAL: lambda z: np.real(z),
        EpsWhich.TARGET_MAGNITUDE: lambda z: np.abs(z - t),
        EpsWhich.TARGET_REAL: lambda z: np.abs(np.real(z) - np.real(t)),
    }[which]


def _select_order(theta: np.ndarray, which: EpsWhich, target: complex | None) -> np.ndarray:
    return np.argsort(_sort_key(which, target)(theta), kind="stable")


def _arnoldi_step(V: torch.Tensor, w: torch.Tensor, j: int):
    """CGS2: orthogonalize w against V[0..j]; returns (h, beta, w/beta)."""
    Vj = V[: j + 1]
    h1 = Vj.conj() @ w
    w = w - Vj.T @ h1
    h2 = Vj.conj() @ w
    w = w - Vj.T @ h2
    beta = float(torch.linalg.vector_norm(w))
    return (h1 + h2).cpu().numpy(), beta, w / max(beta, 1e-300)


def krylov_schur(
    apply_op: Callable[[torch.Tensor], torch.Tensor],
    n: int,
    *,
    nev: int,
    ncv: int | None = None,
    which: EpsWhich = EpsWhich.LARGEST_MAGNITUDE,
    target: complex | None = None,
    tol: float = 1e-10,
    max_restarts: int = 200,
    v0: np.ndarray | None = None,
    seed: int = 7,
    device="cuda",
) -> KrylovSchurResult:
    """Krylov-Schur iteration (Stewart 2002) with a device basis and host
    Schur bookkeeping."""
    ncv = min(ncv or min(max(2 * nev + 1, 20), n), n)
    if ncv <= nev:
        raise ValueError(f"ncv={ncv} must exceed nev={nev}")
    rng = np.random.default_rng(seed)
    if v0 is None:
        v0 = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    v0 = np.asarray(v0, dtype=np.complex128)
    v0 = v0 / np.linalg.norm(v0)
    device = resolve_device(device)
    V = torch.zeros((ncv + 1, n), dtype=torch.complex128, device=device)
    V[0] = torch.as_tensor(v0, device=device)
    H = np.zeros((ncv + 1, ncv), dtype=np.complex128)

    k = 0
    n_ops = 0
    for restart in range(max_restarts):
        for j in range(k, ncv):
            h, beta, V[j + 1] = _arnoldi_step(V, apply_op(V[j]), j)
            H[: j + 1, j] = h
            H[j + 1, j] = beta
            H[j + 2:, j] = 0.0
        n_ops += ncv - k

        Hm = H[:ncv, :ncv]
        beta_m = H[ncv, ncv - 1].real
        # sorted Schur form: the selection predicate is a threshold on the
        # sort key (LAPACK's reordering re-derives eigenvalues)
        theta_all = sla.eigvals(Hm)
        keep = min(max(nev + (ncv - nev) // 2, nev + 1), ncv - 1)
        key_fn = _sort_key(which, target)
        sorted_keys = np.sort(key_fn(theta_all))
        thresh = (0.5 * (sorted_keys[keep - 1] + sorted_keys[keep])
                  if keep < ncv else sorted_keys[-1] + 1.0)
        T, Q, sdim = sla.schur(
            Hm, output="complex", sort=lambda z: bool(key_fn(np.asarray([z]))[0] <= thresh))
        if sdim == 0:
            T, Q = sla.schur(Hm, output="complex")
            sdim = keep
        sdim = min(sdim, ncv - 1)
        b = beta_m * Q[ncv - 1, :]

        # Ritz pairs of the selected block, explicitly ordered
        evals_s, evecs_s = sla.eig(T[:sdim, :sdim])
        ord_s = _select_order(evals_s, which, target)
        evals_s = evals_s[ord_s]
        Y = Q[:, :sdim] @ evecs_s[:, ord_s]
        Y = Y / np.linalg.norm(Y, axis=0, keepdims=True)
        resid = np.abs(beta_m) * np.abs(Y[ncv - 1, :])
        conv_mask = resid <= tol * np.maximum(np.abs(evals_s), 1e-30)
        nconv = int(np.argmin(conv_mask)) if not conv_mask.all() else len(conv_mask)

        if nconv >= nev or restart == max_restarts - 1:
            m_ext = min(max(nconv, nev), sdim)
            Yd = torch.as_tensor(Y[:, :m_ext], device=device)
            X = (V[:ncv].T @ Yd).T.cpu().numpy()
            X = X / np.maximum(np.linalg.norm(X, axis=1, keepdims=True), 1e-300)
            logger.info("Krylov-Schur: %d/%d converged after %d restarts (%d op applies)",
                        nconv, nev, restart + 1, n_ops)
            return KrylovSchurResult(
                eigenvalues=evals_s[:m_ext], eigenvectors=X, residuals=resid[:m_ext],
                iterations=n_ops, converged=nconv >= nev, nconv=nconv,
            )

        # restart: keep the leading k-block, V_new[:k] = Qk^T V[:ncv]
        k = min(max(sdim, nconv + 1), ncv - 1)
        Qk = torch.as_tensor(np.ascontiguousarray(Q[:, :k].T), device=device)
        last = V[ncv].clone()
        V[:k] = Qk @ V[:ncv]
        V[k] = last
        V[k + 1:] = 0.0
        H[:, :] = 0.0
        H[:k, :k] = T[:k, :k]
        H[k, :k] = b[:k]
    raise RuntimeError("Krylov-Schur failed to converge (unreachable)")


# ---------------------------------------------------------------------------
# EigenSolver front-end
# ---------------------------------------------------------------------------


class EigenSolver:
    """Generalized eigensolver front-end over (A, M); the port runs the
    shift-invert and Cayley transforms.  The st_pc defaults to
    ``"banded"``, the device band factor (the reference defaults to its
    host ``"lu"``, which runs here only when ``set_st_pc_type("lu")`` asks
    for it)."""

    def __init__(self, A: CSRMatrix, M: CSRMatrix | None,
                 config: EigensolverConfig | None = None) -> None:
        if A.shape[0] != A.shape[1]:
            raise ValueError("A must be square.")
        if M is not None and M.shape != A.shape:
            raise ValueError("A and M must have matching shapes.")
        self.A, self.M = A, M
        self.config = config or EigensolverConfig()
        self._st_type = STType.SHIFT
        self._target: complex | None = None
        self._antishift: complex | None = None
        self._si_method = "banded"
        self._v0: np.ndarray | None = None

    def set_st_type(self, st: STType | str) -> None:
        self._st_type = STType(st) if isinstance(st, str) else st

    def set_target(self, target: complex) -> None:
        self._target = complex(target)

    def set_cayley_antishift(self, nu: complex) -> None:
        """Antishift of the CAYLEY transform (SLEPc's
        ``ST.setCayleyAntishift``); it defaults to the target."""
        self._antishift = complex(nu)

    def set_st_pc_type(self, pc) -> None:
        name = getattr(pc, "value", str(pc)).lower()
        self._si_method = name if name in ("lu", "banded") else "gmres"

    def set_initial_vector(self, v0: np.ndarray) -> None:
        self._v0 = np.asarray(v0, dtype=np.complex128).copy()

    def _run(self, target: complex):
        cfg = self.config
        n = self.A.shape[0]
        nu = None
        if self._st_type is STType.CAYLEY:  # SLEPc: the antishift defaults to the shift
            nu = self._antishift if self._antishift is not None else target
        op = ShiftInvertOperator(self.A, self.M, target, method=self._si_method,
                                 inner_tol=min(cfg.atol * 1e-2, 1e-10), antishift=nu)
        result = krylov_schur(
            op.apply, n, nev=cfg.num_eig, ncv=min(cfg.ncv, n),
            which=EpsWhich.LARGEST_MAGNITUDE,  # largest theta = closest to the shift
            tol=cfg.atol, max_restarts=cfg.max_it, v0=self._v0, device=self.A.device,
        )
        self.operator = op
        return op, result

    def solve(self) -> list[tuple[complex, np.ndarray]]:
        """Eigenpairs nearest the target, nearest first."""
        if self._st_type not in (STType.SINVERT, STType.CAYLEY):
            raise NotImplementedError(f"spectral transform {self._st_type.name} is not ported")
        if self._target is None:
            raise ValueError(f"{self._st_type.name} requires a target (set_target).")
        cfg = self.config
        t0 = time.time()
        # a shift on an exact eigenvalue makes the factor numerically
        # singular: the band factor's calibration refuses it, or the
        # eigenvalues look right but the vectors are polluted (detected by
        # the true residuals); either way the solve is retried once at an
        # offset shift (where the reference, after its host-LU fallback,
        # ends as well)
        offset = 1e-3 * (1.0 + abs(self._target))
        try:
            op, result = self._run(self._target)
        except FactorUnusable as e:  # retried below, once the refused factor is freed
            logger.info("%s at the target; retrying with offset shift %.1e.", e, offset)
            op = None
        if op is None:
            op, result = self._run(self._target + offset)
        lam = op.back_transform(result.eigenvalues)
        pairs = list(zip([complex(v) for v in lam], result.eigenvectors))
        if op.sigma == self._target and (eigen_residuals(self.A, self.M, pairs)
                                         / (np.abs(lam) + 1.0)
                                         > 10.0 * max(cfg.atol, 1e-12)).any():
            logger.info("Shift-invert eigenvectors polluted; retrying with offset shift %.1e.",
                        offset)
            op, result = self._run(self._target + offset)
            lam = op.back_transform(result.eigenvalues)
        if not result.converged:
            logger.warning("Eigensolver returned %d converged of %d requested.",
                           result.nconv, cfg.num_eig)
        logger.info("Eigensolve completed in %.2f s.", time.time() - t0)
        pairs = list(zip([complex(v) for v in lam], result.eigenvectors))
        order = np.argsort(np.abs(lam - self._target))
        return [pairs[i] for i in order][: cfg.num_eig]


def eigen_residuals(A: CSRMatrix, M: CSRMatrix | None,
                    pairs: list[tuple[complex, np.ndarray]]) -> np.ndarray:
    """||A x - lambda M x|| / ||x|| (host scipy)."""
    As = A.to_scipy().astype(np.complex128)
    Ms = M.to_scipy().astype(np.complex128) if M is not None else None
    out = []
    for lam, x in pairs:
        r = As @ x - lam * (Ms @ x if Ms is not None else x)
        out.append(np.linalg.norm(r) / max(np.linalg.norm(x), 1e-300))
    return np.asarray(out)
