"""Krylov linear solvers (subset): preconditioned conjugate gradients.

Counterpart of the reference's ``solver/linear.py`` ``cg`` and
``SolveResult``: a plain torch loop on the vectors' device (f64 on the
card), whose stopping test reads the residual norm on the host once per
iteration.  The rest of the reference's KSP menu is not ported.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

Matvec = Callable[[torch.Tensor], torch.Tensor]


@dataclass
class SolveResult:
    x: torch.Tensor
    iterations: int
    residual: float  # final ||b - A x|| / ||b||
    converged: bool
    history: list[float] | None = None


def cg(matvec: Matvec, b: torch.Tensor, x0: torch.Tensor | None = None, *,
       tol: float = 1e-10, maxiter: int = 1000, M: Matvec | None = None) -> SolveResult:
    """Preconditioned conjugate gradients for a symmetric positive definite
    ``matvec``; ``M`` applies the preconditioner's inverse."""
    M = M or (lambda r: r)
    x = torch.zeros_like(b) if x0 is None else x0.clone()
    bnorm = float(torch.linalg.vector_norm(b)) or 1.0
    r = b - matvec(x)
    z = M(r)
    p = z
    rz = torch.dot(r, z)
    k = 0
    res = float(torch.linalg.vector_norm(r)) / bnorm
    while res > tol and k < maxiter:
        Ap = matvec(p)
        alpha = rz / torch.dot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        z = M(r)
        rz_new = torch.dot(r, z)
        p = z + (rz_new / rz) * p
        rz = rz_new
        k += 1
        res = float(torch.linalg.vector_norm(r)) / bnorm
    return SolveResult(x, k, res, res <= tol)
