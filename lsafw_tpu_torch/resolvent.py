"""Resolvent analysis: optimal harmonic forcing / response gains.

Counterpart of the reference's ``resolvent`` module: the largest energy
amplification a harmonic body forcing can achieve,

    sigma_1(omega)^2 = max_f  ||q||_E^2 / ||f||_E^2,
    (i omega M - A) q = M P f,

with (A, M) the linearized Navier-Stokes pair, P the restriction of the
forcing to free velocity DOFs and ||q||_E^2 = q^H M q.  The gains are
the eigenvalues of the Hermitian operator T = P^T M C^-H M C^-1 M P,
C = i omega M - A, generalized against W = P^T M P.  With sigma = i omega,
C^-1 M v = -(A - sigma M)^-1 M v and C^-H M v = -(A^T - conj(sigma)
M^T)^-1 M v, so one T apply is two shift-invert applies of
:class:`~lsafw_tpu_torch.solver.eigen.ShiftInvertOperator`: the direct
operator on (A, M) and the adjoint one on the transposed pair
(:func:`~lsafw_tpu_torch.ops.sparse.transpose_pair`, which keeps a
Taylor-Hood pattern, so the adjoint factor shares its band plan and
permuted CSR).  Both factors are alive at once, one pair per frequency.

On the card the two applies run on vectors that stay there (band
solves through K1/K2 and G, refinement matvecs and the M product of
``_apply_T`` through S); only the forcing-subspace vector (one entry
per forced DOF) crosses to the host, where scipy's ARPACK runs the
W-weighted Lanczos iteration.  ARPACK starts from a random vector:
compare gains, not vectors.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch
from scipy.linalg import eigh

from lsafw_tpu_torch import resolve_device
from lsafw_tpu_torch.ops.bcsr import operator_for_budget
from lsafw_tpu_torch.ops.sparse import CSRMatrix, spmv, transpose_pair
from lsafw_tpu_torch.solver.eigen import ShiftInvertOperator
from lsafw_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


def _real_inverse(W: sp.spmatrix, dtype) -> spla.LinearOperator:
    """W^-1 for the real SPD W as one real SuperLU factor, ordered by
    minimum degree on W + W^T (W's pattern is symmetric); a complex vector
    takes it as two real columns.  The same operator as the complex,
    column-ordered factor ``eigsh`` makes of ``M`` by itself, with less
    fill and real arithmetic."""
    lu = spla.splu(sp.csc_matrix(W, dtype=np.float64), permc_spec="MMD_AT_PLUS_A")

    def solve(x):
        if np.iscomplexobj(x):
            y = lu.solve(np.stack([x.real, x.imag], axis=1))
            return y[:, 0] + 1j * y[:, 1]
        return lu.solve(x)

    return spla.LinearOperator(W.shape, matvec=solve, dtype=dtype)


def w_weighted_gains(apply_T, W: sp.spmatrix, k: int, *, tol: float = 1e-8,
                     dtype=np.complex128):
    """Leading eigenpairs of the Hermitian PSD operator ``apply_T``
    generalized against SPD ``W``: gamma_j, F[:, j] descending.  A dense
    solve on tiny subspaces (Lanczos is breakdown-prone there); ``k`` is
    clamped to the subspace size."""
    nf = W.shape[0]
    k = min(int(k), nf)
    T = spla.LinearOperator((nf, nf), matvec=lambda fc: apply_T(np.asarray(fc, dtype)),
                            dtype=dtype)
    if nf <= max(4 * k, 40):
        gam, F = eigh(T @ np.eye(nf, dtype=dtype), W.toarray())
    else:
        ncv = min(nf - 1, max(2 * k + 1, 20))
        gam, F = spla.eigsh(T, k=k, M=W.astype(dtype), Minv=_real_inverse(W, dtype),
                            which="LA", tol=tol, ncv=ncv)
    order = np.argsort(gam)[::-1][:k]  # ARPACK's order is not guaranteed
    return gam[order], F[:, order]


@dataclass
class ResolventModes:
    """One frequency: ``gains[j]`` is sigma_j (amplitude, not energy),
    with forcing and response modes as full-length mixed vectors of unit
    energy (f^H M f = q^H M q = 1)."""

    omega: float
    gains: np.ndarray  # (k,) descending
    forcings: np.ndarray  # (k, n) complex
    responses: np.ndarray  # (k, n) complex


class _EnergyPair:
    """What the resolvent and transient solvers share: (A, M) on one
    device, the free velocity DOFs (velocity block [0, nu) of the mixed
    layout, less the Dirichlet ones) where a forcing or an initial state
    lives, W = P^T M P on the host, M's product on the device and the
    transposed pair of the adjoint operators."""

    def __init__(self, A: CSRMatrix, M: CSRMatrix, num_velocity_dofs: int, dirichlet_mask,
                 method: str, device) -> None:
        device = resolve_device(device)
        if device.type != A.device.type:
            raise ValueError(f"device {device} is not the operators' {A.device}")
        self.A, self.M = A, M
        self.method = method
        self._n = A.shape[0]
        fmask = np.zeros(self._n, dtype=bool)
        fmask[:num_velocity_dofs] = True
        fmask &= ~np.asarray(dirichlet_mask, dtype=bool)
        self._fdofs = np.nonzero(fmask)[0]
        if self._fdofs.size == 0:
            raise ValueError("no free velocity DOFs")
        self._fd = torch.as_tensor(self._fdofs, device=A.device)
        Ms = M.to_scipy().tocsr()
        self._W = Ms[self._fdofs][:, self._fdofs].tocsc()  # SPD: the gain problem's mass
        self._Mop = operator_for_budget(M)
        self._At, self._Mt = transpose_pair(A, M)
        self.operators: dict = {}
        self.applies = 0

    def _mass(self, v: torch.Tensor) -> torch.Tensor:
        """M v on the device (one S launch where M's operator fits)."""
        return self._Mop.matvec(v) if self._Mop is not None else spmv(self.M, v)

    def _energy(self, v: torch.Tensor) -> float:
        return float(torch.vdot(v, self._mass(v)).real)


class ResolventSolver(_EnergyPair):
    """Optimal-gain solver over the (A, M) eigensystem pair.

    Args:
        A, M: the assembled eigensystem (real CSR on one device; BC rows
            of A identity, of M zero).
        num_velocity_dofs: the velocity block size of the mixed layout.
        dirichlet_mask: (n,) bool, the constrained DOFs.
        method: the shift-invert method, ``"banded"`` (the device band
            factor; the default) or ``"lu"`` (a host SuperLU, asked for
            only; the reference's default).
        elements: optional ``(cell_dofs, A_el, M_el, bc_mask)``, the
            element matrices of (A, M): the direct operator takes them as
            its refinement matvecs where the fused S operator does not fit
            (``ShiftInvertOperator``'s ``elements``); the adjoint has none.
        device: the device A and M live on; the default ``"cuda"``
            raises without a usable GPU unless ``"cpu"`` is passed.

    After :meth:`solve`, ``operators`` holds the figures of the two
    shift-invert operators of the last frequency (factor seconds,
    contraction, applies, pivoted) and ``applies`` its T applies.
    """

    def __init__(self, A: CSRMatrix, M: CSRMatrix, num_velocity_dofs: int, dirichlet_mask, *,
                 method: str = "banded", elements=None, device="cuda") -> None:
        super().__init__(A, M, num_velocity_dofs, dirichlet_mask, method, device)
        self._elements = elements

    def _si_pair(self, sigma: complex):
        """(direct, adjoint) shift-invert operators for C = sigma M - A
        (harmonic forcing: sigma = i omega; pseudospectra: any z)."""
        sigma = complex(sigma)
        si1 = ShiftInvertOperator(self.A, self.M, sigma, method=self.method,
                                  elements=self._elements)
        si2 = ShiftInvertOperator(self._At, self._Mt, np.conj(sigma), method=self.method)
        return si1, si2

    def _note(self, si1, si2) -> None:
        self.operators = {"direct": si1.figures(), "adjoint": si2.figures()}

    def _apply_T(self, si1, si2, fc: np.ndarray) -> np.ndarray:
        """T fc over the forcing subspace: the two minus signs of the
        shift-invert rewrites cancel, T fc = P^T M si2(si1(P fc))."""
        x = torch.zeros(self._n, dtype=torch.complex128, device=self.A.device)
        x[self._fd] = torch.as_tensor(fc, dtype=torch.complex128, device=x.device)
        d = si2.apply(si1.apply(x))
        self.applies += 1
        return self._mass(d)[self._fd].cpu().numpy()

    def _response(self, si1, f: torch.Tensor) -> torch.Tensor:
        """q = C^-1 M f = -si1(f) (a full-length forcing vector)."""
        return -si1.apply(f)

    def _gains(self, sigma: complex, k: int, tol: float):
        si1, si2 = self._si_pair(sigma)
        self.applies = 0
        gam, F = w_weighted_gains(lambda fc: self._apply_T(si1, si2, fc), self._W, k, tol=tol)
        return si1, si2, gam, F

    def solve(self, omega: float, k: int = 1, *, tol: float = 1e-8) -> ResolventModes:
        """The leading ``k`` gains and modes at frequency ``omega``
        (clamped to the forcing-subspace size)."""
        k = min(int(k), self._fdofs.size)
        si1, si2, gam, F = self._gains(1j * float(omega), k, tol)
        gains = np.sqrt(np.maximum(gam, 0.0))
        forcings = np.zeros((k, self._n), dtype=np.complex128)
        responses = np.zeros((k, self._n), dtype=np.complex128)
        for j in range(k):
            f = torch.zeros(self._n, dtype=torch.complex128, device=self.A.device)
            f[self._fd] = torch.as_tensor(F[:, j], device=f.device)
            f = f / np.sqrt(self._energy(f))  # unit forcing energy
            q = self._response(si1, f)
            eq = self._energy(q)
            if eq > 0:
                q = q / np.sqrt(eq)
            forcings[j], responses[j] = f.cpu().numpy(), q.cpu().numpy()
        self._note(si1, si2)
        logger.info("Resolvent omega=%.4f: gains %s (%d T applies)", omega,
                    np.array2string(gains, precision=4), self.applies)
        return ResolventModes(float(omega), gains, forcings, responses)

    def gain_curve(self, omegas, k: int = 1, *, tol: float = 1e-8) -> list[ResolventModes]:
        """Gains over a frequency sweep (one factor pair per omega)."""
        return [self.solve(float(w), k=k, tol=tol) for w in omegas]

    def resolvent_norm(self, z: complex, *, tol: float = 1e-6) -> float:
        """||R(z)||_E, the energy-norm resolvent norm at a complex point z
        (sigma_1 of the forced problem at sigma = z), whose level sets
        bound the epsilon-pseudospectra; it diverges as z approaches an
        eigenvalue of the pencil."""
        si1, si2, gam, _ = self._gains(z, 1, tol)
        self._note(si1, si2)
        return float(np.sqrt(max(gam[0], 0.0)))

    def pseudospectrum(self, re_pts, im_pts, *, tol: float = 1e-6) -> np.ndarray:
        """Grid of ||R(z)||_E: entry [i, j] is the resolvent norm at
        ``re_pts[j] + 1j * im_pts[i]`` (one factor pair per point)."""
        G = np.empty((len(im_pts), len(re_pts)))
        for i, b in enumerate(im_pts):
            for j, a in enumerate(re_pts):
                G[i, j] = self.resolvent_norm(complex(a, b), tol=tol)
            logger.info("pseudospectrum row %d/%d done", i + 1, len(im_pts))
        return G
