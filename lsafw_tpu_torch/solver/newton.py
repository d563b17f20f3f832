"""Damped Newton for stationary Navier-Stokes.

The state ``w`` always satisfies the Dirichlet data exactly, so the
update solves J(w) dw = -F(w) with identity BC rows and F[bc] = 0.
Residual and Jacobian are assembled on the device; the inner solve is
the host SuperLU factorization (``linear_solver="lu"``).  The banded
device Newton of the reference package is not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from lsafw_tpu_torch.models.navier_stokes import StationaryNavierStokesAssembler
from lsafw_tpu_torch.solver.direct import SparseLU
from lsafw_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


@dataclass
class NewtonResult:
    w: np.ndarray
    iterations: int
    residual_norm: float
    converged: bool
    history: list[float]


class NewtonSolver:
    """Newton with adjustable damping and a host LU inner solve."""

    def __init__(
        self,
        assembler: StationaryNavierStokesAssembler,
        *,
        damping: float = 1.0,
        linear_solver: str = "lu",
    ) -> None:
        if linear_solver != "lu":
            raise NotImplementedError(
                f"linear_solver={linear_solver!r}: only the host 'lu' solve is ported")
        self._asm = assembler
        self._damping = damping

    def _masked_residual(self, w: torch.Tensor, re: float) -> torch.Tensor:
        F = self._asm.residual(w, re)
        return torch.where(self._asm.bc_mask, torch.zeros_like(F), F)

    def solve(self, w0, re: float, *, max_it: int = 50, tol: float = 1e-6) -> NewtonResult:
        """Iterate to the steady state (divergence -> warning + partial
        result instead of raising)."""
        asm = self._asm
        w = torch.where(asm.bc_mask, asm.bc_values, asm._state(w0))
        history: list[float] = []
        converged = False
        it = 0
        for it in range(1, max_it + 1):
            F = self._masked_residual(w, re)
            rnorm = float(torch.linalg.norm(F))
            history.append(rnorm)
            if not np.isfinite(rnorm):
                logger.warning("Newton residual is not finite; aborting at it %d", it)
                break
            if rnorm < tol:
                converged = True
                break
            J = asm.jacobian(w, re)
            dw = SparseLU(J).solve(-F.cpu().numpy())
            if not np.isfinite(dw).all():
                logger.warning("Newton update is not finite; aborting at it %d", it)
                break
            w = w + self._damping * torch.as_tensor(dw, device=w.device)
            logger.debug("Newton it %d: |F| = %.3e", it, rnorm)
        else:
            it = max_it
        rfinal = float(torch.linalg.norm(self._masked_residual(w, re)))
        if rfinal < tol:
            converged = True
        if not converged:
            logger.warning(
                "Newton did not converge in %d iterations (|F| = %.3e); "
                "returning partial result", it, rfinal,
            )
        return NewtonResult(w=w.cpu().numpy(), iterations=it, residual_norm=rfinal,
                            converged=converged, history=history)
