"""Krylov-Schur eigensolver with the reference's spectral transforms.

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
``method="gmres"`` (the inexact shift-invert; STPRECOND forces it) the
same factor preconditions restarted GMRES(40) on complex128 n-vectors
to ``inner_tol`` (:func:`~lsafw_tpu_torch.solver.linear.gmres`): one
band solve per GMRES step, one per solve for M b and one per cycle.
With ``method="lu"`` (asked for only) one host SuperLU of C serves every
solve, the vectors crossing to the host and back.  The (ncv x ncv)
Hessenberg bookkeeping, sorted Schur restarts and Ritz extraction run
on the host in numpy/scipy complex128.

The other transforms: SHIFT (:class:`PlainOperator`, op v = M^-1 A v with
A v through S and M^-1 a real band factor of M with the checked
refinement; M must be invertible: a zero row of M, as the pressure block
of a Navier-Stokes pencil has, raises :class:`FactorUnusable`), SHELL
(:class:`ShellOperator`, the caller's apply and back-transform) and
FILTER (:class:`ChebyshevFilterOperator`, a Chebyshev polynomial of a
Hermitian A, eigenvalues as Rayleigh quotients).

With M = None the operator is C = A - sigma I.  At a real shift (the
theta-stepper's and the Floquet trip's implicit matrices, at sigma = 0)
the band factor is real, the refinement matvecs run through S on A's
own values (one real matrix; a complex x takes S's real-on-complex
mode), and a complex128 right-hand side goes through the real factor as
two f32 columns in one band pass.  At a complex shift it is the pencil
(A, I) with I on A's diagonal slots.  A and M on two patterns are put on
one first (:func:`~lsafw_tpu_torch.ops.sparse.shared_pattern`).

Eigenvalue back-transform: theta = 1/(lambda - sigma), so
lambda = sigma + 1/theta; Cayley: lambda = (sigma theta + nu)/(theta - 1).
"""

from __future__ import annotations

import dataclasses
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
from lsafw_tpu_torch.ops import spmv_cuda
from lsafw_tpu_torch.ops.bcsr import (
    BCSROperator,
    BCSRShiftedOp,
    matvec_of,
    operator_for_budget,
    plan_for_pattern,
)
from lsafw_tpu_torch.ops.sparse import CSRMatrix, identity_mass, shared_pattern, spmv
from lsafw_tpu_torch.solver.band import factor_auto, plan_for_csr
from lsafw_tpu_torch.solver.direct import SparseLU
from lsafw_tpu_torch.solver.linear import _cgs2, _norm, _reduce, gmres, power_norm
from lsafw_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


class EpsProblemType(Enum):
    """Problem types (SLEPc's ``EPSProblemType``)."""

    HEP = "hep"
    NHEP = "nhep"
    GHEP = "ghep"
    GNHEP = "gnhep"
    PGNHEP = "pgnhep"
    GHIEP = "ghiep"

    @property
    def is_generalized(self) -> bool:
        return self in (EpsProblemType.GHEP, EpsProblemType.GNHEP, EpsProblemType.PGNHEP,
                        EpsProblemType.GHIEP)


class STType(Enum):
    """Spectral transforms: SINVERT and CAYLEY (the factor), PRECOND (the
    inexact shift-invert, GMRES preconditioned by the factor), SHIFT
    (no transform), FILTER (a Chebyshev filter) and SHELL (the caller's)."""

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
    problem_type: EpsProblemType = EpsProblemType.GNHEP
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
    antishift (None: the shift-invert right-hand side M v).  ``M = None``
    stands for the identity (C = A - sigma I, sigma real); ``Cop`` is then
    A's own :class:`~lsafw_tpu_torch.ops.bcsr.BCSROperator`."""

    A: CSRMatrix
    M: CSRMatrix | None
    blu: object
    sigma: complex
    Cop: BCSRShiftedOp | BCSROperator | None = None
    nu: complex | None = None
    Mop: object | None = None  # an element M operator beside an element Cop


def _coef(z: complex, x: torch.Tensor):
    """The scalar z for products with x: a float where x is real and z
    has no imaginary part, so that a real vector stays real."""
    return z.real if not x.is_complex() and z.imag == 0.0 else z


def _si_apply_C(op: BandedSIOp, x: torch.Tensor) -> torch.Tensor:
    """(A - sigma M) x; A x - sigma x where M is None.  Where ``op.Cop`` is
    None and the preconditioner holds the C apply (a multiplicative
    :class:`TwoGridSIPC`), that one serves."""
    if op.M is None:
        Ax = op.Cop.matvec(x) if op.Cop is not None else spmv(op.A, x)
        return Ax - op.sigma.real * x if op.sigma != 0 else Ax
    Cop = op.Cop if op.Cop is not None else getattr(op.blu, "Cop", None)
    if Cop is not None:
        return Cop.matvec_pair(x)
    return spmv(op.A, x) - _coef(op.sigma, x) * spmv(op.M, x)


def _si_apply_M(op: BandedSIOp, x: torch.Tensor) -> torch.Tensor:
    """M x: the element M operator where there is one, else from Cop's
    storage where there is a fused Cop (x where M is None)."""
    if op.M is None:
        return x
    if op.Mop is not None:
        return op.Mop.matvec_pair(x)
    if op.Cop is not None and hasattr(op.Cop, "mass_pair"):
        return op.Cop.mass_pair(x)
    return spmv(op.M, x)


def _si_rhs(op: BandedSIOp, v: torch.Tensor) -> torch.Tensor:
    """The transformed apply's right-hand side: M v (shift-invert), or
    A v + nu M v = C v + (sigma + nu) M v (Cayley), whose C v and M v
    come from one pass of the fused operator."""
    if op.nu is None:
        return _si_apply_M(op, v)
    if op.M is None:
        Cv, Mv = _si_apply_C(op, v), v
    elif isinstance(op.Cop, BCSRShiftedOp):
        Cv, Mv = op.Cop.matvec_pair(v, mass=True)
    elif op.Cop is not None or op.Mop is not None:
        Cv, Mv = _si_apply_C(op, v), _si_apply_M(op, v)
    else:
        Mv = spmv(op.M, v)
        Cv = spmv(op.A, v) - _coef(op.sigma, v) * Mv
    return Cv + _coef(op.sigma + op.nu, Cv) * Mv


def banded_solve_raw(op: BandedSIOp | None, b: torch.Tensor, *, tol: float = 1e-9,
                     max_its: int = 16, m: int = 8, proj=None, x0_zero: bool = False,
                     apply_fn=None, pc_fn=None) -> torch.Tensor:
    """x ~= (A - sigma M)^-1 b for a raw right-hand side (no M
    premultiply) by truncated GCR(m) refinement, preconditioned by the
    band factor: each correction's image is orthogonalized against the
    last ``m`` kept images.  Complex in complex128; an f64 b at a real
    shift stays f64 (the real factor's one-column substitution).  A
    refinement that misses ``tol`` raises :class:`FactorUnusable`.
    ``proj``, ``x0_zero``, ``apply_fn`` and ``pc_fn`` are :func:`_refine`'s."""
    return refine_checked(op, b, tol=tol, max_its=max_its, m=m, proj=proj, x0_zero=x0_zero,
                          apply_fn=apply_fn, pc_fn=pc_fn)[0]


def refine_checked(op: BandedSIOp | None, b: torch.Tensor, *, tol: float, max_its: int,
                   m: int = 8, what: str = "banded solve", **options) -> tuple[torch.Tensor, int]:
    """:func:`_refine`'s (x, iterations), raising :class:`FactorUnusable`
    with the relative residual and the iteration count where the last
    residual misses ``tol``: no banded solve returns past its tolerance.
    The one exception is the inexact correction solves of the nested
    refinement (:func:`nested_eigenpair`, :class:`TwoGridSIPC`), whose
    ``inner_tol`` is a target: they call :func:`_refine` unjudged."""
    x, its, res = _refine(op, b, tol=tol, max_its=max_its, m=m, **options)
    if not res <= tol:
        raise FactorUnusable(f"{what}: the refinement reached {res:.2e} in {its} iterations "
                             f"(tol {tol:.0e}, contraction of the factor too weak)")
    return x, its


def _projections(proj):
    """The Jacobi-Davidson projections of ``proj`` = (v, M v), v
    M-normalised: on the right d - v (v^H M d) (M symmetric: (M v)^H d),
    on the left w - M v (v^H w); identities where ``proj`` is None."""
    if proj is None:
        return (lambda d: d), (lambda w: w)
    v, Mv = proj
    return (lambda d: d - torch.vdot(Mv, d) * v), (lambda w: w - torch.vdot(v, w) * Mv)


def _refine(op: BandedSIOp | None, b: torch.Tensor, *, tol: float, max_its: int, m: int = 8,
            proj=None, x0_zero: bool = False, apply_fn=None,
            pc_fn=None) -> tuple[torch.Tensor, int, float]:
    """:func:`banded_solve_raw`'s GCR(m), returning (x, iterations, the
    last relative residual norm it saw) without judging it (the callers
    do: :func:`refine_checked`, the calibration's trial solve, and the
    nested refinement, whose solves are inexact by design).  One host
    synchronisation per iteration and one before the first.

    ``proj`` = (v, M v), v M-normalised: solve the Jacobi-Davidson
    projected system (I - M v v^H) C (I - v v^H M), with the search
    directions right-projected after the preconditioner and the images
    left-projected (without it an exact solve of C t = r returns t = v
    and the nested correction annihilates).  ``x0_zero``: start from x = 0
    (a weak preconditioner's first apply can leave ||C x0 - b|| > ||b||,
    which GCR, monotone only from its start, does not undo).
    ``apply_fn`` / ``pc_fn``: the operator and the preconditioner in place
    of ``op``'s C and band factor (``op`` may then be None): the Galerkin
    coarse apply of :class:`TwoGridSIPC`."""
    applyC = apply_fn if apply_fn is not None else (lambda x: _si_apply_C(op, x))
    pcsolve = pc_fn if pc_fn is not None else op.blu.solve
    right, left = _projections(proj)
    if x0_zero:
        x, r = torch.zeros_like(b), b
    else:
        x = right(pcsolve(b))
        r = b - left(applyC(x))
    bnorm, rn = torch.stack([torch.linalg.vector_norm(b), torch.linalg.vector_norm(r)]).tolist()
    floor = max(bnorm, 1e-300)
    D = torch.zeros((m, b.shape[0]), dtype=b.dtype, device=b.device)
    CD = torch.zeros_like(D)
    k = 0
    while k < max_its and np.isfinite(rn) and rn > tol * floor:
        d = right(pcsolve(r))
        Cd = left(applyC(d))
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
    a Cayley antishift; a refinement that misses ``tol`` raises."""
    return banded_solve_raw(op, _si_rhs(op, v), tol=tol, max_its=max_its)


# ---------------------------------------------------------------------------
# Nested (two-grid) eigen refinement
# ---------------------------------------------------------------------------


def _with_sigma(op: BandedSIOp, sigma: complex) -> BandedSIOp:
    """The shift-invert state retargeted at a new shift.  A fused S
    operator takes the shift as an argument; an element C operator bakes
    the shift into its values and cannot be retargeted, so it is dropped
    and the C apply falls back to the CSR pair (or to the preconditioner's
    C).  A multiplicative :class:`TwoGridSIPC` holds the one C apply
    inside the preconditioner; it is retargeted there.  Both an ``op.Cop``
    and a retargetable ``op.blu.Cop`` is refused (the reference retargets
    only the first and leaves the second at a stale shift)."""
    sigma = complex(sigma)
    Cop = op.Cop
    if Cop is not None:
        Cop = dataclasses.replace(Cop, sigma=sigma) if hasattr(Cop, "sigma") else None
    blu = op.blu
    bcop = getattr(blu, "Cop", None)
    if bcop is not None and hasattr(bcop, "sigma"):
        if op.Cop is not None:
            raise AssertionError("_with_sigma: op.Cop and the preconditioner's Cop are both "
                                 "set; the preconditioner's would keep a stale shift")
        blu = dataclasses.replace(blu, Cop=dataclasses.replace(bcop, sigma=sigma))
    return dataclasses.replace(op, sigma=sigma, Cop=Cop, blu=blu)


@dataclass(eq=False)
class DiagSIPC:
    """Regularized complex Jacobi of C = A - sigma M: a memory-free fine
    term for :class:`TwoGridSIPC` (a pure coarse-grid preconditioner keeps
    GCR's search directions in range(P) and cannot converge; Jacobi spans
    the whole space)."""

    inv: torch.Tensor  # (n,) complex128

    @classmethod
    def from_pair(cls, A: CSRMatrix, M: CSRMatrix, sigma: complex, *,
                  press_reg: float = 1.0) -> "DiagSIPC":
        """``press_reg``: the magnitude, in units of the RMS diagonal, put on
        the zero diagonals of saddle rows.  The reference's default is 1.0
        (a Jacobi inverse of 1e-3 would amplify pressure residuals a
        thousandfold, which neither the M-normalisation nor the
        Jacobi-Davidson projection can see on the zero pressure block of M);
        the port keeps it."""
        ds = A.idx()["diag_slots"]
        sigma = complex(sigma)
        dre = A.data[ds] - sigma.real * M.data[ds]
        dim = (-sigma.imag) * M.data[ds]
        mag2 = dre * dre + dim * dim
        scale = torch.sqrt(torch.clamp(mag2.mean(), min=1e-300))
        bad = mag2 < (1e-10 * scale) ** 2
        dre = torch.where(bad, -press_reg * scale, dre)
        mag2 = torch.where(bad, (press_reg * scale) ** 2, mag2)
        return cls(torch.complex(dre / mag2, -dim / mag2))

    def solve(self, b: torch.Tensor) -> torch.Tensor:
        return self.inv * b


def ell_of_csr(S, *, device="cuda") -> tuple[torch.Tensor, torch.Tensor]:
    """Padded-ELL (data f64, columns int32) of a scipy CSR ``S`` on
    ``device`` (the P of :class:`TwoGridSIPC`)."""
    device = resolve_device(device)
    S = sp.csr_matrix(S)
    S.sort_indices()
    n = S.shape[0]
    cnt = np.diff(S.indptr)
    w = max(1, int(cnt.max()) if cnt.size else 1)
    r = np.repeat(np.arange(n, dtype=np.int64), cnt)
    p = np.arange(S.nnz, dtype=np.int64) - np.repeat(S.indptr[:-1].astype(np.int64), cnt)
    cols = np.zeros((n, w), np.int32)
    dat = np.zeros((n, w))
    cols[r, p] = S.indices
    dat[r, p] = S.data
    return torch.as_tensor(dat, device=device), torch.as_tensor(cols, device=device)


def galerkin_pair(P, A: CSRMatrix, M: CSRMatrix) -> tuple[CSRMatrix, CSRMatrix]:
    """The Galerkin coarse pair (P^T A P, P^T M P) of a scipy prolongation
    ``P`` as CSRMatrices on one shared pattern, on A's device: the union
    of the two products' patterns and the diagonal.  The union is built
    from indicator patterns, so an entry where the two products cancel
    exactly keeps its slot (the reference forms it from Ag + Mg, where such
    an entry drops out and its values land in the wrong slots)."""
    from lsafw_tpu_torch.interop import csr_from_numpy

    P = sp.csr_matrix(P)
    Ag = (P.T @ (A.to_scipy() @ P)).tocsr()
    Mg = (P.T @ (M.to_scipy() @ P)).tocsr()
    n, ncol = Ag.shape

    def ones(S):
        S = S.tocsr()
        return sp.csr_matrix((np.ones(S.nnz), S.indices, S.indptr), shape=S.shape)

    U = (ones(Ag) + ones(Mg) + sp.identity(n, format="csr")).tocsr()
    U.sort_indices()
    keyU = np.repeat(np.arange(n, dtype=np.int64), np.diff(U.indptr)) * ncol + U.indices

    def put(S):
        S = S.tocsr()
        S.sort_indices()
        keyS = np.repeat(np.arange(n, dtype=np.int64), np.diff(S.indptr)) * ncol + S.indices
        out = np.zeros(U.nnz)
        out[np.searchsorted(keyU, keyS)] = S.data
        return out

    A_g = csr_from_numpy(U.indptr, U.indices, put(Ag), U.shape, device=A.device)
    return A_g, CSRMatrix(A_g.pattern, torch.as_tensor(put(Mg), device=A.device))


@dataclass(eq=False)
class TwoGridSIPC:
    """Two-grid preconditioner of the shift-invert inner solves past the
    exact-factor memory wall: a coarse shift-invert correction through the
    prolongation P (``P_data``/``P_cols``, padded ELL over the fine rows;
    the restriction is P^T as a segmented sum through the same ELL) and a
    fine term (``fine_blu``: a budget-truncated band factor, a
    :class:`DiagSIPC`, or None):

        additive (``Cop`` None):   z = P C_c^-1 R r + fine^-1 r
        multiplicative (``Cop``):  z = P C_c^-1 R r, then ``smooth_steps``
                                   of z += omega fine^-1 (r - C z)

    ``coarse_op`` is a :class:`BandedSIOp` on the coarse mesh (its exact
    band factor and its own C), or a bare band factor of the Galerkin pair
    (:func:`galerkin_pair`), in which case the coarse GCR applies the
    Galerkin operator as the sandwich P^T C P through ``Cop`` at the fixed
    shift ``sig0`` and preconditions by that factor; without a ``Cop`` it
    has no operator and raises ``ValueError``.  ``cproj`` = (x_c, M x_c)
    deflates the coarse solve against the coarse eigenvector
    (:meth:`coarse_deflation`).  Duck-typed as a band factor (``solve``):
    ``BandedSIOp(blu=TwoGridSIPC(...))`` serves :func:`nested_eigenpair`.
    The coarse solve is an inexact GCR to ``coarse_tol`` within
    ``coarse_its`` and is not judged."""

    coarse_op: object
    fine_blu: object
    P_data: torch.Tensor  # (nf, wp) f64
    P_cols: torch.Tensor  # (nf, wp) int -> coarse indices
    Cop: object | None = None
    cproj: tuple | None = None
    sig0: complex | None = None  # the fixed shift of the Galerkin sandwich
    nc: int = 0
    coarse_tol: float = 1e-6
    coarse_its: int = 20
    smooth_steps: int = 1
    omega: float = 1.0
    # P's gather index (int32) and P^T's fixed-order segmented sum, made once
    # (``dataclasses.replace`` carries them over)
    _cols32: torch.Tensor | None = None
    _psum: object = None

    def __post_init__(self) -> None:
        if not hasattr(self.coarse_op, "blu") and self.Cop is None:
            raise ValueError("TwoGridSIPC: a bare band factor as the coarse operator needs the "
                             "fine C apply (Cop=...) for the Galerkin sandwich P^T C P")
        if self._psum is None:
            from lsafw_tpu_torch.ops.elementop import SegmentSum

            self._cols32 = self.P_cols.to(torch.int32).contiguous()
            self._psum = SegmentSum.build(self.P_cols, self.nc)

    @staticmethod
    def coarse_deflation(x_c, M_c: CSRMatrix) -> tuple[torch.Tensor, torch.Tensor]:
        """``cproj`` from the coarse eigenvector and the coarse mass matrix,
        on M_c's device: the coarse solve runs deflated against its own
        eigenpair.  C_c is factored near its eigenvalue, so an undeflated
        solve amplifies the x_c direction by 1/|sigma - lambda_c|, and what
        it amplifies is the interpolation error of P x_c."""
        x_c = np.asarray(x_c, dtype=np.complex128)
        Mx = M_c.to_scipy() @ x_c
        nrm = np.sqrt(max(np.real(np.vdot(x_c, Mx)), 1e-300))
        return (torch.as_tensor(x_c / nrm, device=M_c.device),
                torch.as_tensor(Mx / nrm, device=M_c.device))

    def _restrict(self, v: torch.Tensor) -> torch.Tensor:
        return self._psum(self.P_data * v[:, None])

    def _prolong(self, v: torch.Tensor) -> torch.Tensor:
        return (self.P_data * spmv_cuda.gather(v.contiguous(), self._cols32)).sum(1)

    def _coarse_apply(self, z: torch.Tensor) -> torch.Tensor:
        """G z = P^T (C (P z)), the Galerkin coarse operator as a sandwich
        through the fine C, held at the fixed shift ``sig0`` (as theta
        converges, G(theta) would become singular)."""
        Cop = self.Cop
        if self.sig0 is not None and hasattr(Cop, "sigma"):
            Cop = dataclasses.replace(Cop, sigma=complex(self.sig0))
        return self._restrict(Cop.matvec_pair(self._prolong(z)))

    def solve(self, b: torch.Tensor) -> torch.Tensor:
        rc = self._restrict(b)
        if hasattr(self.coarse_op, "blu"):
            zc = _refine(self.coarse_op, rc, tol=self.coarse_tol, max_its=self.coarse_its,
                         proj=self.cproj)[0]
        else:
            zc = _refine(None, rc, tol=self.coarse_tol, max_its=self.coarse_its,
                         proj=self.cproj, apply_fn=self._coarse_apply,
                         pc_fn=self.coarse_op.solve)[0]
        z = self._prolong(zc)
        if self.fine_blu is None:
            return z
        if self.Cop is None:
            return z + self.fine_blu.solve(b)
        for _ in range(self.smooth_steps):
            z = z + self.omega * self.fine_blu.solve(b - self.Cop.matvec_pair(z))
        return z


def _nested_prepare(op: BandedSIOp, v: torch.Tensor, theta: complex):
    """M-normalise v, form r = (A - theta M) v, take the Rayleigh update
    where the residual is already small (rel < 0.1: a rough guess's
    high-mode noise dominates v^H A v, and the caller's shift is the
    better one until the corrections have smoothed v), and return (v, M v,
    r, theta, rel) with rel = |r| / sqrt(|r|^2 + |theta|^2 |M v|^2)."""
    Mv = _si_apply_M(op, v)
    nrm = torch.sqrt(torch.clamp(torch.vdot(v, Mv).real, min=1e-300))
    v, Mv = v / nrm, Mv / nrm
    r = _si_apply_C(_with_sigma(op, theta), v)
    rn0, mn = torch.stack([torch.linalg.vector_norm(r), torch.linalg.vector_norm(Mv)]).tolist()
    rel0 = rn0 / max(np.sqrt(rn0 ** 2 + abs(theta) ** 2 * mn ** 2), 1e-300)
    if rel0 < 0.1:
        d = torch.vdot(v, r)
        theta = theta + complex(d)
        r = r - d * Mv
    rn = float(torch.linalg.vector_norm(r))
    rel = rn / max(np.sqrt(rn ** 2 + abs(theta) ** 2 * mn ** 2), 1e-300)
    return v, Mv, r, theta, rel


def _nested_correct(op: BandedSIOp, v, Mv, r, theta: complex, *, inner_tol: float,
                    inner_its: int, m: int):
    """The Jacobi-Davidson correction: the projected system against the
    shrinking residual, solved inexactly (unjudged :func:`_refine` from
    zero).  Returns (t, the achieved projected linear residual, |t|)."""
    opt = _with_sigma(op, theta)
    t = _refine(opt, r, tol=inner_tol, max_its=inner_its, m=m, proj=(v, Mv), x0_zero=True)[0]
    Ct = _si_apply_C(opt, t)
    Ct = Ct - torch.vdot(v, Ct) * Mv
    lin, rn, tn = torch.stack([torch.linalg.vector_norm(r - Ct), torch.linalg.vector_norm(r),
                               torch.linalg.vector_norm(t)]).tolist()
    return t, lin / max(rn, 1e-300), tn


def nested_eigenpair(op: BandedSIOp, v0: np.ndarray, sigma0: complex, *, tol: float = 1e-8,
                     max_outer: int = 20, inner_tol: float = 1e-3, inner_its: int = 300,
                     m: int = 8, bc_mask: np.ndarray | None = None,
                     resid_op: BandedSIOp | None = None):
    """Refine an eigenpair guess (typically interpolated from a coarser
    mesh) to solver grade with inexact correction solves: the reference's
    eigen path past the exact-factor memory wall.

    Each outer step updates the Rayleigh quotient, forms r = (A - theta M)
    v and solves the Jacobi-Davidson correction equation C(theta) t = r by
    GCR preconditioned by ``op.blu`` (a band factor made once at a nearby
    shift, a truncated band, a :class:`TwoGridSIPC`), the operator applied
    at theta.  These solves are inexact by design (``inner_tol`` is a
    target) and do not raise: they are the one exception to the rule that
    no banded solve returns past its tolerance.  The outer loop judges them
    through the true residual: a correction is accepted at the largest
    damping in {1, 1/4, 1/16, 1/64} that lowers the relative residual, and
    where none does the loop stops with the best iterate (a stalled
    refinement returns, as the reference's does).

    ``bc_mask`` zeroes the guess on the Dirichlet rows.  ``resid_op``: the
    operator of the once-per-outer residual (the reference evaluates it in
    f64 where ``op`` carries f32-grade matvecs; S is f64, so it may be
    ``op`` itself).  The guess and the operators share ``op.A``'s device.

    Returns ``(theta, v, rel, n_outer)``: v a complex numpy vector of unit
    norm and rel the relative residual |r| / sqrt(|r|^2 + |theta|^2 |M v|^2)
    of the returned pair."""
    rop = op if resid_op is None else resid_op
    v0 = np.asarray(v0, dtype=np.complex128)
    if bc_mask is not None:
        v0 = np.where(np.asarray(bc_mask), 0.0, v0)
    v = torch.as_tensor(v0, device=op.A.device)
    prep = _nested_prepare(rop, v, complex(sigma0))
    rel = prep[-1]
    if not np.isfinite(rel):
        raise FloatingPointError("nested refinement diverged")
    it = 0
    for it in range(1, max_outer + 1):
        v, Mv, r, theta, _ = prep
        logger.info("nested_eigenpair: outer %d rel resid %.2e theta %.6f%+.6fj", it, rel,
                    theta.real, theta.imag)
        if rel < tol:
            break
        t, lin, tnorm = _nested_correct(op, v, Mv, r, theta, inner_tol=inner_tol,
                                        inner_its=inner_its, m=m)
        logger.info("nested_eigenpair: inner solve rel %.2e, |t| %.2e", lin, tnorm)
        damp, accepted = 1.0, False
        for _ in range(4):
            cand = _nested_prepare(rop, v - damp * t, theta)
            if np.isfinite(cand[-1]) and cand[-1] < rel:
                prep, rel, accepted = cand, cand[-1], True
                break
            logger.info("nested_eigenpair: correction rejected at damp %.3g (rel %.2e -> %.2e)",
                        damp, rel, cand[-1])
            damp *= 0.25
        if not accepted:
            logger.warning("nested_eigenpair: no damp improved the residual at outer %d (rel "
                           "%.2e); stopping with the best iterate", it, rel)
            break
    v, theta = prep[0], prep[3]
    v = v.cpu().numpy()
    return theta, v / np.linalg.norm(v), rel, it


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


def bcsr_budget(device: torch.device, held: int = 0) -> float:
    """Device bytes the refinement matvecs' values may take:
    min(``LSAFW_BCSR_MEM_GB``, default 6, the free memory of
    :func:`_free_device_bytes` less a 3.5 GB margin)."""
    return min(float(os.environ.get("LSAFW_BCSR_MEM_GB", "6")) * 1e9,
               _free_device_bytes(device, held) - 3.5e9)


# the refinement's iteration cap, and the trial GCR's where the Richardson
# bound refuses (:func:`calibrate`)
REFINE_CAP, TRIAL_CAP = 300, 60


class FactorUnusable(RuntimeError):
    """The band factor at a shift is non-finite or preconditions too weakly
    (for instance a shift on an exact eigenvalue, where C is singular to
    working precision): refused by the calibration, or found out by a
    refinement that misses its tolerance (:func:`refine_checked`)."""


def calibrate(op: BandedSIOp, n: int, inner_tol: float, *, real: bool, cap: int = REFINE_CAP,
              trial_cap: int = TRIAL_CAP) -> tuple[float, int, int | None]:
    """(rho, refinement cap, trial GCR iterations or None) of the band
    factor of ``op``: rho, the contraction of one refinement step on a
    unit vector from a seed (real where ``real``), gives the Richardson
    bound 2 log(tol) / log(rho) iterations, within ``cap``.  Where that
    bound refuses, the refinement itself is run on the same vector, and
    the factor is kept if it reaches ``inner_tol`` within ``trial_cap``
    iterations, with a cap of four times as many.  A non-finite or
    refused factor raises :class:`FactorUnusable`."""
    rng = np.random.default_rng(11)
    b0 = rng.standard_normal(n)
    b0 /= np.linalg.norm(b0)
    b0 = torch.as_tensor(b0, dtype=torch.float64 if real else torch.complex128,
                         device=op.A.device)
    x0 = op.blu.solve(b0)
    rho = float(torch.linalg.vector_norm(b0 - _si_apply_C(op, x0)))
    if not np.isfinite(rho):
        raise FactorUnusable(f"band factor is not usable: calibration contraction {rho}")
    rho_c = min(max(rho, 1e-14), 0.999)
    needed = int(2 * np.ceil(np.log(inner_tol) / np.log(rho_c)))
    trial_its = None
    if needed <= cap:
        refine_its = int(np.clip(needed, 4, cap))
    else:
        _, its, res = _refine(op, b0, tol=inner_tol, max_its=trial_cap)
        if not res <= inner_tol:
            raise FactorUnusable(
                f"band factor preconditions too weakly: contraction {rho:.3e} needs "
                f"~{needed} refinement iterations for tol {inner_tol:.0e} (cap {cap}), "
                f"and a trial GCR solve reached {res:.1e} in {its}")
        trial_its = its
        refine_its = int(min(4 * max(its, 1), cap))
    logger.info("Banded factor: contraction %.2e%s -> refinement cap %d for tol %.0e",
                rho, "" if trial_its is None else f" (trial GCR solve: {trial_its} iterations)",
                refine_its, inner_tol)
    return rho, refine_its, trial_its


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
    LU; nothing here does), and so does every apply and raw solve whose
    refinement misses ``inner_tol`` within the cap.

    ``method="lu"``: one host SuperLU of C = A - sigma M (A - sigma I
    where M is None), real at a real shift, as the reference's host path
    (``lsafw_tpu/solver/eigen.py:792-799``); right-hand sides are formed
    on the vector's device, cross to the host for the solve and come
    back.  It runs only when asked for.

    ``method="gmres"``: the inexact shift-invert.  The same band factor of
    C (``factor_auto``, not calibrated) preconditions restarted GMRES(40)
    on complex128 n-vectors (the reference solves the equivalent real 2n
    system) to ``inner_tol`` within ``inner_maxiter`` steps; a solve that
    misses raises :class:`FactorUnusable`.  ``gmres_its`` and
    ``gmres_cycles`` record each solve.

    The banded and GMRES methods factor C on one pattern shared by A and
    M (:func:`~lsafw_tpu_torch.ops.sparse.shared_pattern`): an M whose
    pattern equals A's in content (a pair read from two ``.mtx`` files)
    is taken on A's pattern object, so that A's cached plans serve;
    otherwise both are scattered onto their union pattern with every
    diagonal slot.  M = None at a complex shift is the pencil (A, I), I on
    A's diagonal slots (S's shifted mode carries its refinement matvecs);
    at a real shift it stays the real factor of A - sigma I.

    ``elements``: optional ``(cell_dofs, A_el, M_el, bc_mask)``, the
    per-cell element matrices of (A, M).  Where the fused operator's
    values do not fit :func:`bcsr_budget`, the banded and GMRES methods
    take the element operators of :mod:`~lsafw_tpu_torch.ops.elementop`
    as their refinement matvecs (C = A - sigma M as a
    :class:`~lsafw_tpu_torch.ops.elementop.CElementOperator`, M as an
    :class:`~lsafw_tpu_torch.ops.elementop.ElementOperator`), as the
    reference does; without them the CSR pair applies them."""

    _CAP = REFINE_CAP
    _TRIAL_CAP = TRIAL_CAP

    def __init__(self, A: CSRMatrix, M: CSRMatrix | None, sigma: complex, *,
                 method: str = "banded", inner_tol: float = 1e-10, inner_maxiter: int = 2000,
                 elements=None, antishift: complex | None = None) -> None:
        if method not in ("banded", "lu", "gmres"):
            raise NotImplementedError(f"shift-invert method {method!r} is not ported")
        self.sigma = complex(sigma)
        if method != "lu" and M is not None:
            A, M = shared_pattern(A, M)
        elif method != "lu" and self.sigma.imag != 0.0:
            A, M = identity_mass(A)
        self.A, self.M = A, M
        self.antishift = None if antishift is None else complex(antishift)
        self.method = method
        self._n = A.shape[0]
        self._inner_tol = inner_tol
        self._inner_maxiter = inner_maxiter
        self.applies = 0
        self.pivoted = False
        self.device_op = None
        self.rho = self.refine_its = None
        self.trial_its = None  # GCR iterations of the trial solve, where one ran
        self.gmres_its: list[int] = []  # per GMRES solve: its steps (method "gmres")
        self.gmres_cycles: list[int] = []  # and its restart cycles
        t0 = time.time()
        if method == "lu":
            self._lu = SparseLU(self._host_C())
            self.factor_seconds = time.time() - t0
            return
        blu = self._factor_banded()
        self.factor_seconds = time.time() - t0
        band_bytes = sum(t.numel() * t.element_size() for t in vars(blu).values()
                         if isinstance(t, torch.Tensor))
        Cop = self._build_bcsr_ops(band_bytes)
        Mop = None
        if Cop is None and elements is not None and M is not None:
            Cop, Mop = self._element_ops(elements)
        self.device_op = BandedSIOp(A, M, blu, self.sigma, Cop, self.antishift, Mop)
        if method == "gmres":  # GMRES judges the factor itself: no calibration
            return
        self.rho, self.refine_its, self.trial_its = calibrate(
            self.device_op, self._n, inner_tol, real=self.sigma.imag == 0.0, cap=self._CAP,
            trial_cap=self._TRIAL_CAP)

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
        real shift factors one real band (M = None: A - sigma I)."""
        A, M = self.A, self.M
        if M is None:  # a real shift: __init__ gave a complex one the identity M
            dre = A.data.clone()
            dre[A.idx()["diag_slots"]] -= self.sigma.real
            blu, self.pivoted = factor_auto(plan_for_csr(A, real=True), dre,
                                            diag_slots=A.pattern.diag_slots)
            return blu
        dre = A.data - self.sigma.real * M.data
        if self.sigma.imag == 0.0:
            blu, self.pivoted = factor_auto(plan_for_csr(A, real=True), dre,
                                            diag_slots=A.pattern.diag_slots)
            return blu
        dim = (-self.sigma.imag) * M.data
        blu, self.pivoted = factor_auto(plan_for_csr(A), dre, dim, diag_slots=A.pattern.diag_slots)
        return blu

    def _build_bcsr_ops(self, band_bytes: int = 0) -> BCSRShiftedOp | BCSROperator | None:
        """The fused (A, M) operator of the refinement matvecs (A's own
        operator where M is None), or None (the CSR pair applies them) when
        its values do not fit beside the factors: the budget is
        :func:`bcsr_budget`, whose free memory already excludes this factor
        and any other alive (two at once in a resolvent frequency or a
        transient horizon)."""
        A, M = self.A, self.M
        plan = plan_for_pattern(A)
        budget = bcsr_budget(A.device, band_bytes)
        need = (1 if M is None else 2) * plan.bytes_per_matrix + plan.index_bytes
        if need > budget:
            logger.info("CSR (A, M) operator (%.2f GB) over budget %.1f GB; applying the CSR pair.",
                        need / 1e9, budget / 1e9)
            return None
        logger.info("Refinement matvecs on the permuted CSR of (A, M): %.3f GB", need / 1e9)
        if M is None:
            return BCSROperator.from_csr(A, plan)
        return BCSRShiftedOp.from_csr(A, M, self.sigma, plan)

    def _element_ops(self, elements):
        """(C, M) element operators of the refinement matvecs from
        ``(cell_dofs, A_el, M_el, bc_mask)``: C's rows at the Dirichlet
        DOFs the identity (A's diagonal 1, M's 0), M's zero."""
        from lsafw_tpu_torch.ops.elementop import CElementOperator, ElementOperator

        dofs, A_el, M_el, bc_mask = elements
        dev = self.A.device
        A_el, M_el = A_el.to(dev), M_el.to(dev)
        dofs = torch.as_tensor(dofs, device=dev)
        mask = torch.as_tensor(np.asarray(bc_mask, dtype=bool) if not isinstance(
            bc_mask, torch.Tensor) else bc_mask, device=dev)
        El_im = None if self.sigma.imag == 0.0 else (-self.sigma.imag) * M_el
        logger.info("Refinement matvecs on the element operators (%d cells, %d DOFs each)",
                    A_el.shape[0], A_el.shape[1])
        return (CElementOperator(A_el - self.sigma.real * M_el, El_im, dofs, self._n, mask, 1.0),
                ElementOperator(M_el, dofs, self._n, mask, 0.0))

    def figures(self) -> dict:
        """The operator's figures: factor seconds, contraction, trial GCR
        iterations, refinement cap, applies, pivoted, fused matvecs (the
        S operator or, with ``elements``, the element operators), and for
        ``"gmres"`` the GMRES steps and cycles of all its solves."""
        return dict(factor_s=self.factor_seconds, rho=self.rho, trial_its=self.trial_its,
                    refine_its=self.refine_its, applies=self.applies, pivoted=self.pivoted,
                    fused=self.device_op is not None and self.device_op.Cop is not None,
                    elements=self.device_op is not None and self.device_op.Mop is not None,
                    gmres_its=sum(self.gmres_its), gmres_cycles=sum(self.gmres_cycles),
                    gmres_solves=len(self.gmres_its))

    def _gmres_solve(self, b: torch.Tensor) -> torch.Tensor:
        """C^-1 b by GMRES(40) on C = A - sigma M, preconditioned by the band
        factor, to ``inner_tol``; a solve that misses it raises
        :class:`FactorUnusable`."""
        op = self.device_op
        res = gmres(lambda x: _si_apply_C(op, x), b, tol=self._inner_tol, restart=40,
                    maxiter=self._inner_maxiter, M=op.blu.solve)
        self.gmres_its.append(res.iterations)
        self.gmres_cycles.append(res.cycles)
        if not res.converged:
            raise FactorUnusable(f"GMRES shift-invert solve: {res.residual:.2e} after "
                                 f"{res.iterations} iterations (tol {self._inner_tol:.0e})")
        return res.x

    def apply(self, v: torch.Tensor) -> torch.Tensor:
        """One transformed apply: (A - sigma M)^-1 M v, or the Cayley apply."""
        self.applies += 1
        if self.method == "lu":
            return self._host_solve(self._csr_rhs(v))
        if self.method == "gmres":
            return self._gmres_solve(_si_rhs(self.device_op, v))
        return banded_si_apply(self.device_op, v, tol=self._inner_tol, max_its=self.refine_its)

    def solve_raw(self, b: torch.Tensor) -> torch.Tensor:
        """x = (A - sigma M)^-1 b for a raw right-hand side (no M
        premultiply, no Cayley right-hand side): the building block of
        the non-modal analyses (:mod:`lsafw_tpu_torch.transient`)."""
        if self.method == "lu":
            return self._host_solve(b)
        if self.method == "gmres":
            return self._gmres_solve(b)
        return banded_solve_raw(self.device_op, b, tol=self._inner_tol, max_its=self.refine_its)

    def back_transform(self, theta: np.ndarray) -> np.ndarray:
        """theta -> lambda = sigma + 1/theta; Cayley: lambda = (sigma theta
        + nu) / (theta - 1)."""
        if self.antishift is not None:
            den = theta - 1.0
            den = np.where(np.abs(den) < 1e-300, 1e-300, den)
            return (self.sigma * theta + self.antishift) / den
        return self.sigma + 1.0 / theta


def zero_rows(M: CSRMatrix) -> int:
    """The number of rows of M without a nonzero value."""
    rows = M.idx()["row_ids"]
    mag = torch.zeros(M.shape[0], dtype=torch.float64, device=M.device).index_add_(
        0, rows, M.data.abs())
    return int((mag == 0).sum())


class PlainOperator:
    """op v = A v, or M^-1 A v: the SHIFT transform (no spectral transform).

    A v runs through S.  M^-1 is a real band factor of M on M's device
    (``factor_auto`` on its own real plan, without the saddle
    regularization) with the checked refinement of the shift-invert
    operator (:func:`calibrate`, :func:`refine_checked`): a refused factor,
    or a refinement that misses ``inner_tol``, raises
    :class:`FactorUnusable`.  An M with a zero row is singular and raises
    before any factor work (the reference's host LU of M raises there as
    well).  No host LU runs."""

    _CAP = REFINE_CAP
    _TRIAL_CAP = TRIAL_CAP

    def __init__(self, A: CSRMatrix, M: CSRMatrix | None = None, *,
                 inner_tol: float = 1e-10) -> None:
        self.A, self.M = A, M
        self._A = matvec_of(A)
        self._inner_tol = inner_tol
        self.applies = 0
        self.mop = None
        self.rho = self.refine_its = self.trial_its = None
        self.factor_seconds = 0.0
        if M is None:
            return
        nz = zero_rows(M)
        if nz:
            raise FactorUnusable(
                f"SHIFT needs M^-1, and M is singular: {nz} of its {M.shape[0]} rows are zero "
                f"(a Navier-Stokes pencil's pressure block and Dirichlet rows); use SINVERT")
        t0 = time.time()
        blu, _ = factor_auto(plan_for_csr(M, real=True), M.data)
        self.factor_seconds = time.time() - t0
        self.mop = BandedSIOp(M, None, blu, 0j, operator_for_budget(M))
        self.rho, self.refine_its, self.trial_its = calibrate(
            self.mop, M.shape[0], inner_tol, real=True, cap=self._CAP, trial_cap=self._TRIAL_CAP)

    def figures(self) -> dict:
        """M's factor seconds, contraction, trial GCR iterations, refinement
        cap, and the applies."""
        return dict(factor_s=self.factor_seconds, rho=self.rho, trial_its=self.trial_its,
                    refine_its=self.refine_its, applies=self.applies)

    def apply(self, v: torch.Tensor) -> torch.Tensor:
        self.applies += 1
        w = self._A(v)
        if self.mop is None:
            return w
        return refine_checked(self.mop, w, tol=self._inner_tol, max_its=self.refine_its,
                              what="M^-1 solve")[0]

    def back_transform(self, theta: np.ndarray) -> np.ndarray:
        return theta


class ShellOperator:
    """The SHELL transform: the caller's apply (a complex128 tensor in and
    out) and its eigenvalue back-transform (identity when None)."""

    def __init__(self, apply_fn, back_fn=None) -> None:
        self._apply = apply_fn
        self._back = back_fn or (lambda t: t)
        self.applies = 0

    def apply(self, v: torch.Tensor) -> torch.Tensor:
        self.applies += 1
        return self._apply(v)

    def back_transform(self, theta: np.ndarray) -> np.ndarray:
        return np.asarray([self._back(t) for t in np.asarray(theta)])


class ChebyshevFilterOperator:
    """The FILTER transform: the degree-d Chebyshev polynomial T_d(g(A)) of
    a Hermitian A, the unwanted window affinely mapped onto [-1, 1] by g,
    so that the wanted eigenvalues (below ``cutoff``, or above it with
    ``smallest=False``) are amplified without a factor.  The spectral
    bound comes from ``bound_its`` power iterations from a seed (times
    1.05); the apply is the three-term recurrence, d matvecs through S.
    Its Ritz values carry no eigenvalue: the caller takes Rayleigh
    quotients.  Standard problems only (M = None)."""

    def __init__(self, A: CSRMatrix, cutoff: float, *, degree: int = 30, smallest: bool = True,
                 bound_its: int = 30) -> None:
        self.A = A
        self.degree = int(degree)
        self._A = matvec_of(A)
        self.applies = 0
        v = torch.as_tensor(np.random.default_rng(5).standard_normal(A.shape[0]),
                            device=A.device)
        lam_max = 1.05 * power_norm(self._A, v, bound_its)
        lo, hi = (float(cutoff), lam_max) if smallest else (-lam_max, float(cutoff))
        self.lam_max = lam_max
        self._e = (hi + lo) / 2.0
        self._c = (hi - lo) / 2.0

    def apply(self, v: torch.Tensor) -> torch.Tensor:
        """T_d(g(A)) v (no normalization: the operator stays linear)."""
        self.applies += 1
        e, c = self._e, self._c

        def g(x):
            return (self._A(x) - e * x) / c

        t0, t1 = v, g(v)
        for _ in range(self.degree - 1):
            t0, t1 = t1, 2.0 * g(t1) - t0
        return t1

    def back_transform(self, theta: np.ndarray) -> np.ndarray:
        raise RuntimeError("filter Ritz values carry no eigenvalue information; use Rayleigh "
                           "quotients (EigenSolver does)")


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
    restarts: int = 0  # Krylov-Schur cycles run (the first one included)


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


def _arnoldi_step(V: torch.Tensor, w: torch.Tensor, j: int, group=None):
    """CGS2 (:func:`~lsafw_tpu_torch.solver.linear._cgs2`): orthogonalize
    w against V[0..j]; returns (h, beta, w/beta).  With ``group`` the rows
    are distributed and the products summed."""
    h, w, beta = _cgs2(V[: j + 1], w, group)
    beta = float(beta)
    return h.cpu().numpy(), beta, w / max(beta, 1e-300)


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
    group=None,
) -> KrylovSchurResult:
    """Krylov-Schur iteration (Stewart 2002) with a device basis and host
    Schur bookkeeping.

    ``group`` (a ``torch.distributed`` process group; the reference's
    ``basis_sharding``) distributes the basis by rows: ``n``, ``v0`` and
    ``apply_op``'s vectors are this rank's rows, the Gram-Schmidt
    projections and norms are summed over the group's ranks, the Schur
    bookkeeping is replicated on every rank, and the eigenvectors
    returned are this rank's rows of the globally normalised vectors.
    Without ``v0`` every rank draws its rows from the same seed."""
    device = resolve_device(device)
    n_all = n if group is None else int(_reduce(torch.tensor(n, device=device), group))
    ncv = min(ncv or min(max(2 * nev + 1, 20), n_all), n_all)
    if ncv <= nev:
        raise ValueError(f"ncv={ncv} must exceed nev={nev}")
    rng = np.random.default_rng(seed)
    if v0 is None:
        v0 = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    v0 = np.asarray(v0, dtype=np.complex128)
    v0 = v0 / (np.linalg.norm(v0) if group is None
               else _norm(torch.as_tensor(v0, device=device), group))
    V = torch.zeros((ncv + 1, n), dtype=torch.complex128, device=device)
    V[0] = torch.as_tensor(v0, device=device)
    H = np.zeros((ncv + 1, ncv), dtype=np.complex128)

    k = 0
    n_ops = 0
    for restart in range(max_restarts):
        for j in range(k, ncv):
            h, beta, V[j + 1] = _arnoldi_step(V, apply_op(V[j]), j, group)
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
            Xd = (V[:ncv].T @ Yd).T
            X = Xd.cpu().numpy()
            if group is None:
                norms = np.linalg.norm(X, axis=1, keepdims=True)
            else:
                norms = _reduce((Xd.abs() ** 2).sum(1), group).sqrt().cpu().numpy()[:, None]
            X = X / np.maximum(norms, 1e-300)
            logger.info("Krylov-Schur: %d/%d converged after %d restarts (%d op applies)",
                        nconv, nev, restart + 1, n_ops)
            return KrylovSchurResult(
                eigenvalues=evals_s[:m_ext], eigenvectors=X, residuals=resid[:m_ext],
                iterations=n_ops, converged=nconv >= nev, nconv=nconv, restarts=restart + 1,
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
    """Generalized eigensolver front-end over (A, M).  The st_pc defaults
    to ``"banded"``, the device band factor (the reference defaults to its
    host ``"lu"``, which runs here only when ``set_st_pc_type("lu")`` asks
    for it); any other st_pc name selects the inexact GMRES shift-invert,
    as in the reference.  ``check_hermitian`` logs a warning where A or M
    is not numerically symmetric."""

    def __init__(self, A: CSRMatrix, M: CSRMatrix | None,
                 config: EigensolverConfig | None = None, *,
                 check_hermitian: bool = False) -> None:
        if A.shape[0] != A.shape[1]:
            raise ValueError("A must be square.")
        if M is not None and M.shape != A.shape:
            raise ValueError("A and M must have matching shapes.")
        self.A, self.M = A, M
        self.config = config or EigensolverConfig()
        if check_hermitian:
            self._warn_if_not_hermitian()
        self._st_type = STType.SHIFT
        self._target: complex | None = None
        self._antishift: complex | None = None
        self._which = EpsWhich.LARGEST_MAGNITUDE
        self._si_method = "banded"
        self._filter_degree = 30
        self._shell: tuple | None = None
        self._v0: np.ndarray | None = None
        self._elements = None
        self._norms: tuple[float, float] | None = None  # :meth:`backward_errors`' scale

    def _warn_if_not_hermitian(self) -> None:
        for name, mat in (("A", self.A), ("M", self.M)):
            if mat is None:
                continue
            s = mat.to_scipy()
            if abs(s - s.T).max() > 1e-10:
                logger.warning("Operator %s is not numerically symmetric/Hermitian.", name)

    def set_st_type(self, st: STType | str) -> None:
        self._st_type = STType(st) if isinstance(st, str) else st

    def set_target(self, target: complex) -> None:
        self._target = complex(target)

    def set_cayley_antishift(self, nu: complex) -> None:
        """Antishift of the CAYLEY transform (SLEPc's
        ``ST.setCayleyAntishift``); it defaults to the target."""
        self._antishift = complex(nu)

    def set_st_shell(self, apply, back_transform=None) -> None:
        """The SHELL transform: ``apply(v)`` maps a complex128 tensor to the
        transformed operator's image, ``back_transform(theta)`` maps its
        eigenvalues back (identity when omitted).  Sets ``STType.SHELL``."""
        self._shell = (apply, back_transform or (lambda t: t))
        self._st_type = STType.SHELL

    def set_which_eigenpairs(self, which: EpsWhich | str) -> None:
        """The selection of SHIFT, SHELL and FILTER (the shift-invert
        transforms take the largest theta, the pairs nearest the target)."""
        self._which = EpsWhich(which) if isinstance(which, str) else which

    def set_st_pc_type(self, pc) -> None:
        name = getattr(pc, "value", str(pc)).lower()
        self._si_method = name if name in ("lu", "banded") else "gmres"

    def set_elements(self, ctx, A_el, M_el, bc_mask, dofs=None) -> None:
        """The per-cell element matrices of (A, M) (for instance
        ``LinearizedNavierStokesAssembler.element_matrices()``): the
        shift-invert transforms take them as their refinement matvecs where
        the fused S operator does not fit its budget
        (:class:`ShiftInvertOperator`'s ``elements``).  ``dofs`` defaults to
        the context's mixed cell DOF map; pass the extended map where facet
        blocks are appended."""
        if dofs is None:
            dofs = ctx.mixed_cell_dofs
        self._elements = (dofs, A_el, M_el, bc_mask)

    def set_filter_degree(self, degree: int) -> None:
        """The Chebyshev filter's degree (FILTER)."""
        self._filter_degree = int(degree)

    def set_initial_vector(self, v0: np.ndarray) -> None:
        self._v0 = np.asarray(v0, dtype=np.complex128).copy()

    def _run(self, target: complex):
        cfg = self.config
        n = self.A.shape[0]
        nu = None
        if self._st_type is STType.CAYLEY:  # SLEPc: the antishift defaults to the shift
            nu = self._antishift if self._antishift is not None else target
        method = "gmres" if self._st_type is STType.PRECOND else self._si_method
        op = ShiftInvertOperator(self.A, self.M, target, method=method,
                                 inner_tol=min(cfg.atol * 1e-2, 1e-10),
                                 elements=self._elements, antishift=nu)
        result = krylov_schur(
            op.apply, n, nev=cfg.num_eig, ncv=min(cfg.ncv, n),
            which=EpsWhich.LARGEST_MAGNITUDE,  # largest theta = closest to the shift
            tol=cfg.atol, max_restarts=cfg.max_it, v0=self._v0, device=self.A.device,
        )
        self.operator, self.result = op, result
        return op, result

    def _solve_plain(self, t0: float) -> list[tuple[complex, np.ndarray]]:
        """SHIFT (:class:`PlainOperator`) and SHELL: Krylov-Schur on the
        operator with the chosen selection; pairs in selection order."""
        cfg = self.config
        n = self.A.shape[0]
        if self._st_type is STType.SHELL:
            op = ShellOperator(*self._shell)
        else:
            op = PlainOperator(self.A, self.M, inner_tol=min(cfg.atol * 1e-2, 1e-10))
        result = krylov_schur(op.apply, n, nev=cfg.num_eig, ncv=min(cfg.ncv, n),
                              which=self._which, target=self._target, tol=cfg.atol,
                              max_restarts=cfg.max_it, v0=self._v0, device=self.A.device)
        self.operator, self.result = op, result
        if not result.converged:
            logger.warning("Eigensolver returned %d converged of %d requested.", result.nconv,
                           cfg.num_eig)
        lam = op.back_transform(result.eigenvalues)
        logger.info("Eigensolve completed in %.2f s.", time.time() - t0)
        return list(zip([complex(v) for v in lam], result.eigenvectors))[: cfg.num_eig]

    def _solve_filtered(self, t0: float) -> list[tuple[complex, np.ndarray]]:
        """FILTER: Krylov-Schur on the Chebyshev-filtered A, eigenvalues as
        Rayleigh quotients of the converged vectors; the target is the
        window's cutoff.  Hermitian standard problems only."""
        if self.M is not None:
            raise ValueError("FILTER supports standard Hermitian problems; generalized pairs "
                             "go through SINVERT/CAYLEY.")
        cfg = self.config
        n = self.A.shape[0]
        smallest = self._which in (EpsWhich.SMALLEST_REAL, EpsWhich.SMALLEST_MAGNITUDE,
                                   EpsWhich.LARGEST_MAGNITUDE)  # the default: the lowest window
        op = ChebyshevFilterOperator(self.A, float(np.real(self._target)),
                                     degree=self._filter_degree, smallest=smallest)
        result = krylov_schur(op.apply, n, nev=cfg.num_eig, ncv=min(cfg.ncv, n),
                              which=EpsWhich.LARGEST_MAGNITUDE, tol=cfg.atol,
                              max_restarts=cfg.max_it, device=self.A.device)
        self.operator, self.result = op, result
        X = torch.as_tensor(np.ascontiguousarray(result.eigenvectors), device=self.A.device)
        X = (X / torch.linalg.vector_norm(X, dim=1, keepdim=True)).contiguous()
        AX = torch.stack([op._A(x) for x in X])
        lam = (X.conj() * AX).sum(dim=1).cpu().numpy()
        pairs = [(complex(l), x) for l, x in zip(lam, X.cpu().numpy())]
        pairs.sort(key=lambda p: p[0].real if smallest else -p[0].real)
        logger.info("Filtered eigensolve completed in %.2f s.", time.time() - t0)
        return pairs[: cfg.num_eig]

    def solve(self) -> list[tuple[complex, np.ndarray]]:
        """Eigenpairs: nearest the target, nearest first (SINVERT, CAYLEY,
        PRECOND); in the selection's order (SHIFT, SHELL); lowest (or
        highest) Rayleigh quotient first (FILTER)."""
        if self._st_type is STType.SHELL and self._shell is None:
            raise ValueError("SHELL requires set_st_shell(apply, back_transform).")
        if self._st_type not in (STType.SHIFT, STType.SHELL) and self._target is None:
            raise ValueError(f"{self._st_type.name} requires a target (set_target).")
        cfg = self.config
        t0 = time.time()
        if self._st_type is STType.FILTER:
            return self._solve_filtered(t0)
        if self._st_type in (STType.SHIFT, STType.SHELL):
            return self._solve_plain(t0)
        # a shift on an exact eigenvalue makes the factor numerically
        # singular: the band factor's calibration refuses it, a refinement
        # misses its tolerance, or the eigenvalues look right but the
        # vectors are polluted (detected by their backward errors); each way
        # the solve is retried once at an offset shift (where the
        # reference, after its host-LU fallback, ends as well), whose
        # pairs are held to the same limit: a miss there raises
        offset = 1e-3 * (1.0 + abs(self._target))
        limit = 10.0 * max(cfg.atol, 1e-12)
        try:
            op, result = self._run(self._target)
        except FactorUnusable as e:  # retried below, once the refused factor is freed
            logger.info("%s at the target; retrying with offset shift %.1e.", e, offset)
            op = result = self.operator = self.result = None
        if op is not None:
            lam = op.back_transform(result.eigenvalues)
            worst = self._worst_residual(lam, result)
            if worst > limit:
                logger.info("Shift-invert eigenvectors polluted (backward error %.2e); retrying "
                            "with offset shift %.1e.", worst, offset)
                # the polluted factor is freed before the retry's is made:
                # two bands of a wide system do not fit the card side by side
                op = result = self.operator = self.result = None
        if op is None:
            op, result = self._run(self._target + offset)
            lam = op.back_transform(result.eigenvalues)
            worst = self._worst_residual(lam, result)
            if worst > limit:
                self.operator = self.result = None
                raise FactorUnusable(
                    f"eigenpairs at the offset shift {self._target + offset:.6g} miss atol: "
                    f"backward error {worst:.2e} (limit {limit:.0e}); {result.nconv} of "
                    f"{cfg.num_eig} converged")
        if not result.converged:
            logger.warning("Eigensolver returned %d converged of %d requested.",
                           result.nconv, cfg.num_eig)
        logger.info("Eigensolve completed in %.2f s.", time.time() - t0)
        pairs = list(zip([complex(v) for v in lam], result.eigenvectors))
        order = np.argsort(np.abs(lam - self._target))
        return [pairs[i] for i in order][: cfg.num_eig]

    def _worst_residual(self, lam: np.ndarray, result: KrylovSchurResult) -> float:
        """The largest :meth:`backward_errors` of the pairs :meth:`solve`
        returns (the ``num_eig`` nearest the target)."""
        near = np.argsort(np.abs(lam - self._target))[: self.config.num_eig]
        return float(self.backward_errors(
            [(complex(lam[i]), result.eigenvectors[i]) for i in near]).max())

    def backward_errors(self, pairs: list[tuple[complex, np.ndarray]]) -> np.ndarray:
        """||A x - lambda M x|| / ((a + |lambda| m) ||x||) of each pair, in
        2-norms, where a and m are the largest row 2-norms of A and M (M =
        None: m = 1).  A row's 2-norm is at most the matrix's, so each value
        is at least the pair's normwise backward error in the 2-norm (the
        measure of SLEPc's ``EPS_CONV_NORM``): it never understates it.  It
        is invariant under a scaling of the pencil, as a residual relative
        to |lambda| + 1 (the reference's test) is not: on the NAFEMS plate's
        coarsest mesh (||K|| about 2.7e12 in SI units) a pair that
        Krylov-Schur has converged to atol in the shift-inverted operator
        keeps a residual near eps ||K||, 1e-4 to 1e-3 of |lambda| + 1, at
        its rigid-body and far modes, where its backward error is about
        1e-12; a polluted pair (a target on an eigenvalue) misses by orders
        of magnitude either way.  The two row norms are reckoned once per
        solver, on A's device."""
        if self._norms is None:
            self._norms = (largest_row_norm(self.A),
                           1.0 if self.M is None else largest_row_norm(self.M))
        norm_a, norm_m = self._norms
        lam = np.abs(np.array([p[0] for p in pairs], dtype=np.complex128))
        return eigen_residuals(self.A, self.M, pairs) / (norm_a + lam * norm_m)


def largest_row_norm(A: CSRMatrix) -> float:
    """max_i ||A[i, :]||_2, a lower bound of ||A||_2 (on A's device)."""
    ix = A.idx()
    sq = torch.zeros(A.shape[0], dtype=torch.float64, device=A.device)
    sq.index_add_(0, ix["row_ids"], A.data.abs().to(torch.float64) ** 2)
    return float(sq.max().sqrt())


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
