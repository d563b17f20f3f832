"""Hill's method: Floquet exponents of a periodic orbit in the frequency
domain.

Counterpart of the reference's ``hill`` module.  Given a
harmonic-balance representation of the cycle,
v(t) = U + Re(q1 e^{i w t}) + Re(q2 e^{2 i w t}) + ..., perturbations
w(t) = e^{lambda t} sum_k w_k e^{i k w t} satisfy the block-coupled
generalized eigenproblem (the Hill matrix)

  lambda M w_k = (A(U) - i k w M) w_k
                 + 1/2 sum_m [ C(q_m) w_{k-m} + C(q_m*) w_{k+m} ],

with A the linearized operator about the mean and C(b) the
convective-linearization matrix (the block the coupled SCM Newton uses,
:func:`~lsafw_tpu_torch.models.navier_stokes.convective_linearization_data`).
Exponents relate to the monodromy's multipliers by mu = exp(lambda T),
T = 2 pi / w.  Every true exponent appears as lambda + i m w for each m
the truncation represents; the exponents are folded into the principal
strip and de-duplicated, and the harmonic-energy centroid of each
vector is kept as a diagnostic (Lazarus & Thomas 2010).

Solved on the card (``method="banded"``, the default; the reference
runs scipy's ``eigs`` on the host, which ``method="lu"`` keeps, asked
for only).  The Hill matrix H of a real flow commutes with the
conjugate reversal (w_k) -> (conj w_{-k}), so in the coordinates

  w_0 = a_0,  w_p = (a_p + i b_p) / sqrt 2,  w_{-p} = (a_p - i b_p) / sqrt 2

(a unitary change of basis, p = 1..K) it is a real matrix H', and
B = diag(M) stays diag(M).  H' and B' are assembled on the device on one
pattern (:class:`~lsafw_tpu_torch.ops.sparse.BlockPattern` over the
assembly pattern, B' embedded in H''s pattern) from A, M and the C(q_m)
blocks, and the port's shift-invert eigensolver runs on them at the
reference's shift ``target + 1e-4 + 1e-4j``: the complex band factor of
H' - sigma B', its refinement matvecs through S's shifted mode.  The
eigenvalues are those of H; the vectors are carried back to the w_k for
the centroids.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

from lsafw_tpu_torch import resolve_device
from lsafw_tpu_torch.models.navier_stokes import convective_linearization_data
from lsafw_tpu_torch.ops.sparse import BlockPattern, CSRMatrix, rows_kept
from lsafw_tpu_torch.solver.eigen import EigenSolver, EigensolverConfig, STType
from lsafw_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


@dataclass
class HillResult:
    exponents: np.ndarray  # (k,) complex principal Floquet exponents
    multipliers: np.ndarray  # exp(lambda T)
    omega: float
    centroids: np.ndarray  # harmonic-energy centroid of each vector
    raw: np.ndarray  # all converged eigenvalues before deduplication


def _cmatrix(ctx, b) -> sp.csr_matrix:
    """C(b) for a complex field b as a complex scipy CSR (host)."""
    b = torch.as_tensor(np.asarray(b) if not isinstance(b, torch.Tensor) else b)
    b = b.to(torch.complex128)

    def part(x):
        data = convective_linearization_data(ctx, x.contiguous())
        return CSRMatrix(ctx.pattern, data).to_scipy()

    Cr = part(b.real)
    if bool((b.imag != 0).any()):
        return Cr + 1j * part(b.imag)
    return Cr.astype(complex)


def _host_hill(ctx, A: CSRMatrix, M: CSRMatrix, harmonics, omega: float, K: int,
               bc_mask) -> tuple[sp.csc_matrix, sp.csc_matrix]:
    """The complex Hill pair (H, B) on the host, as the reference builds it."""
    Acx = A.to_scipy().astype(complex)
    Mcx = M.to_scipy().astype(complex)
    Cs = [_cmatrix(ctx, q) for q in harmonics]
    Cconj = [_cmatrix(ctx, torch.as_tensor(np.asarray(q)).conj()) for q in harmonics]
    if bc_mask is not None:
        Z = sp.diags(np.where(np.asarray(bc_mask, bool), 0.0, 1.0))
        Cs = [Z @ C for C in Cs]
        Cconj = [Z @ C for C in Cconj]
    ks = list(range(-K, K + 1))
    nb = len(ks)
    blocks = [[None] * nb for _ in range(nb)]
    for i, k in enumerate(ks):
        blocks[i][i] = Acx - 1j * k * omega * Mcx
        for m, (Cm, Cmc) in enumerate(zip(Cs, Cconj), start=1):
            if i - m >= 0:  # couples to w_{k-m}
                blocks[i][i - m] = (blocks[i][i - m] + 0.5 * Cm
                                    if blocks[i][i - m] is not None else 0.5 * Cm)
            if i + m < nb:  # couples to w_{k+m}
                blocks[i][i + m] = (blocks[i][i + m] + 0.5 * Cmc
                                    if blocks[i][i + m] is not None else 0.5 * Cmc)
    return sp.bmat(blocks, format="csc"), sp.block_diag([Mcx] * nb, format="csc")


def hill_matrices(ctx, A: CSRMatrix, M: CSRMatrix, harmonics, omega: float, K: int,
                  bc_mask=None) -> tuple[CSRMatrix, CSRMatrix]:
    """(H', B'): the Hill pair in the real coordinates (a_0, a_1, b_1, ...,
    a_K, b_K) of the module docstring, on one block pattern of the
    assembly pattern, assembled on the device from A, M and the masked
    C(q_m) data.  With H_{kj} the Hill blocks and p, q >= 1:

      H'[a_p, a_q] = Re(H_pq + H_p,-q)    H'[a_p, b_q] = Im(H_p,-q - H_pq)
      H'[b_p, a_q] = Im(H_pq + H_p,-q)    H'[b_p, b_q] = Re(H_pq - H_p,-q)
      H'[a_0, a_q] = sqrt2 Re H_0q        H'[a_0, b_q] = -sqrt2 Im H_0q
      H'[a_p, a_0] = sqrt2 Re H_p0        H'[b_p, a_0] = sqrt2 Im H_p0

    and H'[a_0, a_0] = A.  B' = diag(M)."""
    dev = A.device
    keep = (rows_kept(torch.as_tensor(np.asarray(bc_mask, bool), device=dev), ctx.pattern, dev)
            if bc_mask is not None else None)
    Cr, Ci = {}, {}
    for m, q in enumerate(harmonics, start=1):
        q = torch.as_tensor(np.asarray(q) if not isinstance(q, torch.Tensor) else q,
                            device=dev).to(torch.complex128)
        Cr[m] = convective_linearization_data(ctx, q.real.contiguous())
        Ci[m] = convective_linearization_data(ctx, q.imag.contiguous())
        if keep is not None:
            Cr[m], Ci[m] = keep * Cr[m], keep * Ci[m]
    Mh = len(harmonics)

    def H(k: int, j: int):
        """(Re, Im) of the Hill block H_kj; None for a zero part."""
        if k == j:
            return A.data, (None if k == 0 else (-k * omega) * M.data)
        if 1 <= k - j <= Mh:  # 1/2 C(q_m), m = k - j
            return 0.5 * Cr[k - j], 0.5 * Ci[k - j]
        if 1 <= j - k <= Mh:  # 1/2 C(q_m*), m = j - k
            return 0.5 * Cr[j - k], -0.5 * Ci[j - k]
        return None, None

    def comb(*terms):
        """sum c * x over (c, x) with x not None; None where all are None."""
        live = [c * x for c, x in terms if x is not None]
        return None if not live else sum(live[1:], live[0])

    coords = [(0, "a")] + [(p, ab) for p in range(1, K + 1) for ab in ("a", "b")]
    r2 = float(np.sqrt(2.0))
    data = {}
    for I, (p, x) in enumerate(coords):
        for J, (q, y) in enumerate(coords):
            if p == 0 and q == 0:
                blk = A.data
            elif p == 0:
                re, im = H(0, q)
                blk = comb((r2, re)) if y == "a" else comb((-r2, im))
            elif q == 0:
                re, im = H(p, 0)
                blk = comb((r2, re)) if x == "a" else comb((r2, im))
            else:
                (re1, im1), (re2, im2) = H(p, q), H(p, -q)
                blk = {("a", "a"): comb((1.0, re1), (1.0, re2)),
                       ("a", "b"): comb((-1.0, im1), (1.0, im2)),
                       ("b", "a"): comb((1.0, im1), (1.0, im2)),
                       ("b", "b"): comb((1.0, re1), (-1.0, re2))}[(x, y)]
            if blk is not None:
                data[(I, J)] = blk
    structure = np.zeros((len(coords), len(coords)), dtype=bool)
    for I, J in data:
        structure[I, J] = True
    bp = BlockPattern(ctx.pattern, structure)
    return bp.fill(data), bp.fill({(I, I): M.data for I in range(len(coords))})


def _to_harmonics(z: np.ndarray, K: int, n: int) -> np.ndarray:
    """Real-coordinate vectors (columns) back to the w_k blocks, k = -K..K."""
    a0 = z[:n]
    w = [None] * (2 * K + 1)
    w[K] = a0
    for p in range(1, K + 1):
        a = z[(2 * p - 1) * n:2 * p * n]
        b = z[2 * p * n:(2 * p + 1) * n]
        w[K + p] = (a + 1j * b) / np.sqrt(2.0)
        w[K - p] = (a - 1j * b) / np.sqrt(2.0)
    return np.concatenate(w, axis=0)


def hill_floquet(
    ctx,
    A: CSRMatrix,
    M: CSRMatrix,
    harmonics,
    omega: float,
    *,
    n_blocks: int | None = None,
    num: int = 8,
    target: complex = 0.0 + 0.0j,
    bc_mask=None,
    tol: float = 1e-9,
    method: str = "banded",
    device="cuda",
) -> HillResult:
    """Principal Floquet exponents of the cycle by Hill's method.

    ``ctx``: assembly context (supplies the C(b) blocks).  ``A``/``M``:
    the linearized operator and mass about the mean on the context's
    pattern (Dirichlet convention: A identity rows, M zero rows, as
    :class:`~lsafw_tpu_torch.models.navier_stokes.LinearizedNavierStokesAssembler`
    makes them).  ``harmonics``: [q1, q2, ...] complex fields,
    v = U + sum Re(q_m E^m).  ``num``: eigenpairs requested near
    ``target`` (the exponent plane: near 0 for the dominant multipliers),
    relative accuracy ``tol``.  ``bc_mask``: optional Dirichlet mask;
    C-block rows there are zeroed.  ``method``: ``"banded"`` (the real
    pair on the card, above) or ``"lu"`` (the reference's host ``eigs``
    on the complex pair).  ``device`` must be the context's; the default
    ``"cuda"`` raises without a usable GPU unless ``device="cpu"``."""
    device = resolve_device(device)
    if device.type != ctx.device.type:
        raise ValueError(f"device {device} is not the assembly context's {ctx.device}")
    if method not in ("banded", "lu"):
        raise NotImplementedError(f"Hill method {method!r} is not ported")
    K = n_blocks if n_blocks is not None else len(harmonics) + 1
    n = A.shape[0]
    ks = list(range(-K, K + 1))
    nb = len(ks)
    # a small complex offset keeps the factor away from an exact exponent
    sigma = complex(target) + 1e-4 + 1e-4j
    if method == "lu":
        H, B = _host_hill(ctx, A, M, harmonics, omega, K, bc_mask)
        vals, vecs = spla.eigs(H, k=num, M=B, sigma=sigma, tol=tol, maxiter=300)
    else:
        Hp, Bp = hill_matrices(ctx, A, M, harmonics, omega, K, bc_mask)
        es = EigenSolver(Hp, Bp, EigensolverConfig(num_eig=num, atol=tol,
                                                   ncv=max(2 * num + 1, 20)))
        es.set_st_type(STType.SINVERT)
        es.set_target(sigma)
        pairs = es.solve()
        vals = np.array([p[0] for p in pairs])
        vecs = _to_harmonics(np.stack([p[1] for p in pairs], axis=1), K, n)
        del es
    # Floquet exponents are defined modulo i omega; Hill's redundancy gives
    # each as lambda + i m omega for every representable m.  Fold all into
    # the principal strip Im in (-w/2, w/2] and de-duplicate by proximity;
    # the centroid is a diagnostic only.
    order = np.argsort(-vals.real)
    vals, vecs = vals[order], vecs[:, order]
    centroids = np.empty(len(vals))
    for j in range(len(vals)):
        e = np.array([np.linalg.norm(vecs[i * n:(i + 1) * n, j]) ** 2 for i in range(nb)])
        centroids[j] = float(np.dot(ks, e) / max(e.sum(), 1e-300))
    T = 2.0 * np.pi / omega
    principal = []
    for lam in vals:
        im = (lam.imag + 0.5 * omega) % omega - 0.5 * omega
        lam_f = complex(lam.real, im)
        tol_d = 1e-6 * max(1.0, abs(lam_f))
        if any(abs(lam_f - s) < tol_d
               # strip-boundary wraparound of a folded copy
               or (abs(abs(lam_f.imag - s.imag) - omega) < tol_d
                   and abs(lam_f.real - s.real) < tol_d)
               for s in principal):
            continue
        principal.append(lam_f)  # conjugate partners are distinct physical exponents
    principal = np.array(principal)
    logger.info("Hill: %d raw eigenvalues -> %d principal exponents (leading %s)", len(vals),
                len(principal), np.array2string(principal[:3], precision=4))
    return HillResult(principal, np.exp(principal * T), float(omega), centroids, vals)
