"""Boundary facet integrals.

A :class:`FacetContext` precomputes, per tagged facet: the parent cell,
the cell-basis tabulation at facet quadrature points (host numpy: the
boundary is O(n^(1/2)) of the mesh), the facet Jacobian and the outward
normal.  Boundary kernels are then the same batched einsum + scatter as
cell assembly.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from lsafw_tpu_torch.fem.assembly import AssemblyContext, expand_vector_diag
from lsafw_tpu_torch.fem.quadrature import quadrature_rule
from lsafw_tpu_torch.meshing.mesh import CellType, Mesh
from lsafw_tpu_torch.meshing.tags import facets_with_marker
from lsafw_tpu_torch.ops.sparse import SparsityPattern


@dataclass(eq=False)
class FacetContext:
    """Precomputed boundary-integral data for one facet set (marker)."""

    marker: int
    parent_cells: np.ndarray  # (nf,)
    w: torch.Tensor  # (nqf,)
    detJf: torch.Tensor  # (nf,)
    normals: torch.Tensor  # (nf, gdim) outward unit normals
    phi_u: torch.Tensor  # (nf, nqf, nu_el) velocity basis at facet qps
    gphi_u: torch.Tensor  # (nf, nqf, nu_el, gdim) physical gradients
    phi_p: torch.Tensor  # (nf, nqf, np_el)
    cell_dofs: torch.Tensor  # (nf, ndofs_el) int64 mixed dofs of parent cells
    slots: torch.Tensor  # (nf * ndofs_el**2,) int64 nnz slots into the mixed pattern


def build_facet_context(
    ctx: AssemblyContext, mesh: Mesh, marker: int, quad_degree: int | None = None
) -> FacetContext:
    spaces = ctx.spaces
    facet_ids = facets_with_marker(mesh, marker)
    if facet_ids.size == 0:
        raise ValueError(
            f"No boundary facets tagged with marker {marker}; check the "
            "facet rules against the mesh boundary coordinates."
        )
    if mesh.tdim != 2:
        raise NotImplementedError("facet integrals are ported for 2D meshes only")
    cells = mesh.facet_to_cells[facet_ids, 0]
    fverts = mesh.vertices[mesh.facets[facet_ids]]  # (nf, 2, gdim)
    nf = facet_ids.size

    frule = quadrature_rule(CellType.INTERVAL, quad_degree or spaces.quad_degree)
    xi = frule.points  # (nqf, 1)

    # physical quadrature points on each facet: x = v0 + xi (v1 - v0)
    e = fverts[:, 1:] - fverts[:, :1]  # (nf, 1, gdim)
    phys = fverts[:, None, 0, :] + np.einsum("qk,fkd->fqd", xi, e)

    detJf = np.linalg.norm(e[:, 0], axis=1)
    normals = np.stack([e[:, 0, 1], -e[:, 0, 0]], axis=1)
    normals = normals / np.linalg.norm(normals, axis=1, keepdims=True)
    # orient outward: away from the parent cell centroid
    centroids = mesh.vertices[mesh.cells[cells]].mean(axis=1)
    flip = np.einsum("fd,fd->f", normals, fverts.mean(axis=1) - centroids) < 0
    normals[flip] *= -1.0

    # map physical points to parent-cell reference coordinates
    v = mesh.vertices[mesh.cells[cells]]
    Jinv = np.linalg.inv(np.transpose(v[:, 1:] - v[:, :1], (0, 2, 1)))
    Xref = np.einsum("ftd,fqd->fqt", Jinv, phys - v[:, None, 0, :])

    tab_u = [spaces.velocity.element.tabulate(Xref[f]) for f in range(nf)]
    tab_p = [spaces.pressure.element.tabulate(Xref[f]) for f in range(nf)]
    phi_u = np.stack([t.phi for t in tab_u])
    gphi_u = np.einsum("fqit,ftd->fqid", np.stack([t.grad for t in tab_u]), Jinv)
    phi_p = np.stack([t.phi for t in tab_p])

    cell_dofs = spaces.mixed_cell_dofs[cells]
    dev = ctx.device

    def f64(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float64), device=dev)

    return FacetContext(
        marker=marker,
        parent_cells=cells,
        w=f64(frule.weights),
        detJf=f64(detJf),
        normals=f64(normals),
        phi_u=f64(phi_u),
        gphi_u=f64(gphi_u),
        phi_p=f64(phi_p),
        cell_dofs=torch.as_tensor(cell_dofs.astype(np.int64), device=dev),
        slots=torch.as_tensor(_pair_slots(ctx.pattern, cell_dofs), device=dev),
    )


def _pair_slots(pattern: SparsityPattern, cell_dofs: np.ndarray) -> np.ndarray:
    """nnz slot of every (row, col) pair of the given per-facet dof sets."""
    nf, nd = cell_dofs.shape
    rows = np.broadcast_to(cell_dofs[:, :, None], (nf, nd, nd)).ravel().astype(np.int64)
    cols = np.broadcast_to(cell_dofs[:, None, :], (nf, nd, nd)).ravel().astype(np.int64)
    m1 = pattern.shape[1] + 1
    key = pattern.row_ids.astype(np.int64) * m1 + pattern.indices
    want = rows * m1 + cols
    slots = np.searchsorted(key, want)
    if not (key[np.minimum(slots, key.size - 1)] == want).all():
        raise RuntimeError("Facet dof pair missing from sparsity pattern.")
    return slots.astype(np.int64)


# ---------------------------------------------------------------------------
# Boundary kernels
# ---------------------------------------------------------------------------


def neumann_velocity_load(fc: FacetContext, ctx: AssemblyContext, g) -> torch.Tensor:
    """Global load vector of integral g . v over the facet set."""
    gvec = torch.as_tensor(np.asarray(g, dtype=np.float64), device=ctx.device)
    r = torch.einsum("q,f,fqi,d->fid", fc.w, fc.detJf, fc.phi_u, gvec)
    el = torch.zeros((fc.cell_dofs.shape[0], ctx.ndofs_el), dtype=r.dtype, device=ctx.device)
    el[:, : ctx.nu_el * ctx.gdim] = r.reshape(r.shape[0], -1)
    return _scatter_facet_vector(fc, ctx, el)


def neumann_pressure_load(fc: FacetContext, ctx: AssemblyContext, h: float) -> torch.Tensor:
    """Global load of integral h * q over the facet set."""
    r = h * torch.einsum("q,f,fqk->fk", fc.w, fc.detJf, fc.phi_p)
    el = torch.zeros((fc.cell_dofs.shape[0], ctx.ndofs_el), dtype=r.dtype, device=ctx.device)
    el[:, ctx.nu_el * ctx.gdim:] = r
    return _scatter_facet_vector(fc, ctx, el)


def robin_matrix_data(fc: FacetContext, ctx: AssemblyContext, alpha: float) -> torch.Tensor:
    """nnz-data contribution of -alpha * integral u . v."""
    s = -alpha * torch.einsum("q,f,fqi,fqj->fij", fc.w, fc.detJf, fc.phi_u, fc.phi_u)
    return _scatter_vv_block(fc, ctx, expand_vector_diag(s, ctx.gdim))


def viscous_outlet_matrix_data(fc: FacetContext, ctx: AssemblyContext, re: float) -> torch.Tensor:
    """nnz data of +(1/re) integral (grad(u) n) . v on outlet facets."""
    gn = torch.einsum("fqjd,fd->fqj", fc.gphi_u, fc.normals)
    s = (1.0 / re) * torch.einsum("q,f,fqi,fqj->fij", fc.w, fc.detJf, fc.phi_u, gn)
    return _scatter_vv_block(fc, ctx, expand_vector_diag(s, ctx.gdim))


def _scatter_vv_block(fc: FacetContext, ctx: AssemblyContext, vv: torch.Tensor) -> torch.Tensor:
    """Place (nf, nud, nud) facet blocks into full nnz-sized data."""
    nud = ctx.nu_el * ctx.gdim
    full = torch.zeros((vv.shape[0], ctx.ndofs_el, ctx.ndofs_el), dtype=vv.dtype, device=vv.device)
    full[:, :nud, :nud] = vv
    out = torch.zeros(ctx.pattern.nnz, dtype=vv.dtype, device=vv.device)
    return out.index_add_(0, fc.slots, full.reshape(-1))


def _scatter_facet_vector(fc: FacetContext, ctx: AssemblyContext, el: torch.Tensor) -> torch.Tensor:
    out = torch.zeros(ctx.spaces.num_dofs, dtype=el.dtype, device=el.device)
    return out.index_add_(0, fc.cell_dofs.reshape(-1), el.reshape(-1))
