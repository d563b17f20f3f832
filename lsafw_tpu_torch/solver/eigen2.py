"""ARPACK shift-invert eigensolver: a host cross-check.

Counterpart of the reference's ``solver/eigen2.py`` (``ShiftInvertConfig``,
``ArpackEigenSolver``): the generalized shift-invert problem wrapped as a
scipy LinearOperator over one host SuperLU factor of A - sigma M, solved
by ARPACK, with an optional velocity-subspace projection, a residual
check and the mu -> lambda back-transform.  It runs entirely on the host
and serves as an independent check of the Krylov-Schur solver of
:mod:`lsafw_tpu_torch.solver.eigen`.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla

from lsafw_tpu_torch.ops.sparse import CSRMatrix
from lsafw_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


@dataclass
class ShiftInvertConfig:
    sigma: complex = 0.0
    num_eig: int = 5
    ncv: int | None = None
    tol: float = 1e-10
    max_it: int = 2000
    residual_warn: float = 1e-6


def _host(A) -> sp.csr_matrix:
    """A CSRMatrix or scipy matrix as a complex128 scipy CSR matrix."""
    mat = A.to_scipy() if isinstance(A, CSRMatrix) else sp.csr_matrix(A)
    return mat.astype(np.complex128)


class ArpackEigenSolver:
    """Generalized shift-invert Arnoldi through scipy's ARPACK."""

    def __init__(self, A: CSRMatrix | sp.spmatrix, M: CSRMatrix | sp.spmatrix | None,
                 config: ShiftInvertConfig | None = None, *,
                 velocity_dofs: np.ndarray | None = None) -> None:
        self.cfg = config or ShiftInvertConfig()
        self._A = _host(A)
        self._M = _host(M) if M is not None else None
        self._vel = velocity_dofs
        n = self._A.shape[0]
        eye = sp.identity(n, format="csr", dtype=np.complex128)
        C = self._A - self.cfg.sigma * (self._M if self._M is not None else eye)
        self._lu = spla.splu(C.tocsc())  # one factorization, many applies

    def _op_mv(self, x: np.ndarray) -> np.ndarray:
        """y = (A - sigma M)^-1 M x, restricted to the velocity DOFs where
        they are given."""
        y = self._lu.solve(self._M @ x if self._M is not None else x)
        if not np.isfinite(y).all():
            raise FloatingPointError("Non-finite values in shift-invert apply.")
        if self._vel is not None:
            mask = np.zeros_like(y)
            mask[self._vel] = 1.0
            y = y * mask
        return y

    def solve(self) -> list[tuple[complex, np.ndarray]]:
        """Eigenpairs nearest sigma, nearest first."""
        cfg = self.cfg
        n = self._A.shape[0]
        op = spla.LinearOperator((n, n), matvec=self._op_mv, dtype=np.complex128)
        mu, vecs = spla.eigs(op, k=cfg.num_eig, which="LM", ncv=cfg.ncv, tol=cfg.tol,
                             maxiter=cfg.max_it)
        lam = self._mu_to_lambda(mu)
        pairs = [(complex(lam[i]), vecs[:, i]) for i in range(len(lam))]
        self._check_residuals(pairs)
        order = np.argsort(np.abs(lam - cfg.sigma))
        return [pairs[i] for i in order]

    def _mu_to_lambda(self, mu: np.ndarray) -> np.ndarray:
        return self.cfg.sigma + 1.0 / mu

    def _check_residuals(self, pairs) -> None:
        """Warn about any pair whose relative residual exceeds
        ``residual_warn``."""
        for lam, x in pairs:
            Mx = self._M @ x if self._M is not None else x
            r = np.linalg.norm(self._A @ x - lam * Mx) / max(np.linalg.norm(x), 1e-300)
            if r > self.cfg.residual_warn:
                logger.warning("ARPACK eigenpair residual %.2e exceeds %.1e (lambda=%s)",
                               r, self.cfg.residual_warn, lam)
