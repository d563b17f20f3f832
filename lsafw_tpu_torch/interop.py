"""Carry state of the JAX package (as numpy arrays) into the port.

Nothing here imports JAX: a caller turns JAX arrays into numpy with
``np.asarray`` and hands them over.  Used by the parity tests, so that
both packages run from one mesh, one RCM ordering, one factor.  A bf16
band arrives as numpy arrays of a 2-byte bfloat16 dtype (``ml_dtypes``,
which JAX uses); their bits are carried over as they are, without
importing that package.
"""

from __future__ import annotations

import numpy as np
import torch

from lsafw_tpu_torch.meshing.mesh import CellType, Mesh
from lsafw_tpu_torch.ops.sparse import CSRMatrix, SparsityPattern
from lsafw_tpu_torch.solver.band import (
    BandedLU,
    BandPlan,
    PivotedBandedLU,
    RealBandedLU,
    RealPivotedBandedLU,
    fold_pivot_free,
    fold_pivoted,
)


def csr_from_numpy(indptr, indices, data, shape, *, device="cuda") -> CSRMatrix:
    """A CSRMatrix on ``device`` from CSR arrays (data as f64)."""
    indptr = np.asarray(indptr, dtype=np.int64)
    pattern = SparsityPattern(
        shape=tuple(int(s) for s in shape),
        indptr=indptr,
        indices=np.asarray(indices, dtype=np.int32),
        slots=np.arange(int(indptr[-1]), dtype=np.int32),
    )
    return CSRMatrix(pattern, torch.as_tensor(np.asarray(data, dtype=np.float64), device=device))


def band_plan_from_numpy(csr, perm, n: int, nb: int, B: int, nblk_pad: int, chunk: int, *,
                         band_dtype: str = "f32", max_bytes: int | None = None,
                         real: bool = False, force_f32: bool = False) -> BandPlan:
    """The port's plan of ``csr`` (scipy) under a given RCM ``perm`` and
    budget, checked against the geometry and storage the other side
    planned."""
    plan = BandPlan.build(csr, nb=nb, chunk=chunk, perm=np.asarray(perm), max_bytes=max_bytes,
                          real=real, force_f32=force_f32)
    got = (plan.n, plan.B, plan.nblk_pad, plan.band_dtype)
    if got != (n, B, nblk_pad, band_dtype):
        raise ValueError(f"plan (n, B, nblk_pad, band_dtype) = {got}, expected "
                         f"{(n, B, nblk_pad, band_dtype)}")
    return plan


def _c64(re, im, device) -> torch.Tensor:
    z = np.asarray(re, np.float32) + 1j * np.asarray(im, np.float32)
    return torch.as_tensor(z.astype(np.complex64), device=device)


def _int(a, dtype, device) -> torch.Tensor:
    return torch.as_tensor(np.array(a, dtype=dtype), device=device)


def _is_bf16(a) -> bool:
    return np.asarray(a).dtype.name == "bfloat16"


def _bf16(a, device) -> torch.Tensor:
    """A numpy bfloat16 array as a torch bfloat16 tensor, bit for bit."""
    bits = np.ascontiguousarray(np.asarray(a)).view(np.int16)
    return torch.from_numpy(bits.copy()).view(torch.bfloat16).to(device)


def band_to_numpy(band: torch.Tensor) -> np.ndarray:
    """A band as numpy, a bf16 one as a bfloat16 array bit for bit (the
    ``ml_dtypes`` type JAX uses, imported only here)."""
    if band.dtype != torch.bfloat16:
        return band.detach().cpu().numpy()
    import ml_dtypes

    return band.detach().cpu().view(torch.int16).numpy().view(ml_dtypes.bfloat16)


def banded_lu_from_numpy(band_re, band_im, dinv_r, dinv_i, perm, iperm, n: int, nb: int,
                         B: int, *, device="cuda") -> BandedLU:
    """A factored (re, im) pair band as the port's BandedLU, its U blocks
    folded as the port stores them: complex64, or, for a bf16 pair, a
    bf16 band of (re, im) pairs whose folded U blocks are rounded once
    from their f32 products (the other slots keep their bits)."""
    dinv = _c64(dinv_r, dinv_i, device)
    if _is_bf16(band_re):
        band = torch.stack([_bf16(band_re, device), _bf16(band_im, device)], dim=-1)
    else:
        band = _c64(band_re, band_im, device)
    return BandedLU(fold_pivot_free(band, dinv), dinv, _int(perm, np.int32, device),
                    _int(iperm, np.int32, device), int(n), int(nb), int(B))


def real_banded_lu_from_numpy(band, dinv, perm, iperm, n: int, nb: int, B: int, *,
                              device="cuda") -> RealBandedLU:
    """A factored real band (f32 or bf16) as the port's RealBandedLU,
    folded as :func:`banded_lu_from_numpy` folds."""
    dinv = torch.as_tensor(np.array(dinv, dtype=np.float32), device=device)
    band = _bf16(band, device) if _is_bf16(band) else torch.as_tensor(
        np.array(band, dtype=np.float32), device=device)
    return RealBandedLU(fold_pivot_free(band, dinv), dinv, _int(perm, np.int32, device),
                        _int(iperm, np.int32, device), int(n), int(nb), int(B))


def pivoted_lu_from_numpy(band_re, band_im, L2r, L2i, L1inv_r, L1inv_i, Uinv_r, Uinv_i, perms,
                          perm, iperm, n: int, nb: int, B: int, *,
                          device="cuda") -> PivotedBandedLU:
    """The leaves of a panel-pivoted (re, im) pair factor as the port's
    complex64 PivotedBandedLU, folded as the port stores them."""
    L1inv, Uinv = _c64(L1inv_r, L1inv_i, device), _c64(Uinv_r, Uinv_i, device)
    band, L2 = fold_pivoted(_c64(band_re, band_im, device), _c64(L2r, L2i, device), L1inv, Uinv)
    return PivotedBandedLU(
        band, L2, L1inv, Uinv, _int(perms, np.int64, device),
        _int(perm, np.int32, device), _int(iperm, np.int32, device), int(n), int(nb), int(B))


def real_pivoted_lu_from_numpy(band, L2, L1inv, Uinv, perms, perm, iperm, n: int, nb: int,
                               B: int, *, device="cuda") -> RealPivotedBandedLU:
    """The leaves of a real panel-pivoted factor as the port's f32
    RealPivotedBandedLU, folded as the port stores them."""
    def f32(a):
        return torch.as_tensor(np.array(a, dtype=np.float32), device=device)

    L1inv, Uinv = f32(L1inv), f32(Uinv)
    band, L2 = fold_pivoted(f32(band), f32(L2), L1inv, Uinv)
    return RealPivotedBandedLU(
        band, L2, L1inv, Uinv, _int(perms, np.int64, device),
        _int(perm, np.int32, device), _int(iperm, np.int32, device), int(n), int(nb), int(B))


def mesh_from_numpy(vertices, cells, cell_type: str, facet_tags=None) -> Mesh:
    """A port Mesh from vertex/cell arrays and optional (num_facets,)
    facet markers of the same mesh (facets are numbered from the cells,
    so both packages number them alike)."""
    mesh = Mesh(np.asarray(vertices, dtype=np.float64), np.asarray(cells, dtype=np.int64),
                CellType(cell_type))
    if facet_tags is not None:
        mesh.facet_tags = np.asarray(facet_tags)
    return mesh


def state_from_numpy(w, *, device="cuda") -> torch.Tensor:
    """A mixed (velocity, pressure) state vector, e.g. a baseflow, as f64."""
    return torch.as_tensor(np.asarray(w, dtype=np.float64), device=device)


def complex_state_from_numpy(v, *, device="cuda") -> torch.Tensor:
    """A complex mixed vector, e.g. an eigenvector, as complex128."""
    return torch.as_tensor(np.asarray(v, dtype=np.complex128), device=device)
