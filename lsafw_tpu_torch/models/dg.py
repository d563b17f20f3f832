"""Discontinuous-Galerkin (SIPG) scalar discretization.

The reference's DG ``FunctionSpaceType`` is an unimplemented stub
(``FEM/spaces.py:103-179`` raises); this module goes beyond parity
with a working symmetric interior-penalty Galerkin
(SIPG) discretization of the Laplacian on simplicial meshes — the
standard DG formulation (Arnold 1982):

    a(u, v) = sum_K (grad u, grad v)_K
            - sum_F ({grad u}.n [v] + {grad v}.n [u])_F
            + sum_F (eta / h_F) ([u][v])_F

with boundary faces entering through Nitsche terms (Dirichlet).  P1
basis gradients are constant per cell, so the face integrals reduce to
closed-form facet quadrature — everything assembles as batched array
arithmetic + one scatter, like the CG path.

Host assembly (the per-entity arithmetic is vectorized over all
cells/faces at once, numpy), CSR output on the caller's device.  P1 on
triangles and tetrahedra.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from lsafw_tpu_torch.meshing.mesh import CellType, Mesh
from lsafw_tpu_torch.ops.sparse import CSRMatrix


def _cell_geometry(mesh: Mesh):
    v = mesh.vertices[mesh.cells]  # (nc, d+1, d)
    d = mesh.gdim
    J = np.stack([v[:, k] - v[:, 0] for k in range(1, d + 1)], axis=2)
    detJ = np.linalg.det(J)
    measure = np.abs(detJ) / (2.0 if d == 2 else 6.0)
    Jinv = np.linalg.inv(J)
    # P1 reference gradients -> physical: rows of Jinv^T @ gref
    gref = np.vstack([-np.ones((1, d)), np.eye(d)])  # (d+1, d)
    gphys = np.einsum("kd,cde->cke", gref, Jinv)  # (nc, d+1, d)
    return v, measure, gphys


def _phi_at(points_ref: np.ndarray) -> np.ndarray:
    """P1 barycentric basis at reference points (nq, d) -> (nq, d+1)."""
    return np.concatenate(
        [1.0 - points_ref.sum(axis=1, keepdims=True), points_ref], axis=1)


def assemble_dg_poisson(
    mesh: Mesh, *, eta: float = 10.0, device="cuda"
) -> tuple[CSRMatrix, CSRMatrix]:
    """Assemble the SIPG stiffness K (with Dirichlet Nitsche boundary
    terms) and the block-diagonal DG mass matrix M over the broken P1
    space (d+1 DOFs per cell, global id = (d+1)*cell + local), as
    CSRMatrices on ``device``."""
    if mesh.cell_type not in (CellType.TRIANGLE, CellType.TETRAHEDRON):
        raise NotImplementedError("SIPG DG: simplicial meshes only.")
    d = mesh.gdim
    nloc = d + 1
    nc = mesh.num_cells
    n = nloc * nc
    verts, measure, gphys = _cell_geometry(mesh)

    rows, cols, vals = [], [], []

    # volume: (grad u, grad v) * |K| — constant gradients
    Ke = np.einsum("cid,cjd->cij", gphys, gphys) * measure[:, None, None]
    ci = (nloc * np.arange(nc))[:, None, None]
    rr = ci + np.broadcast_to(np.arange(nloc)[:, None], (nc, nloc, nloc))
    cc = ci + np.broadcast_to(np.arange(nloc)[None, :], (nc, nloc, nloc))
    rows.append(rr.ravel())
    cols.append(cc.ravel())
    vals.append(Ke.ravel())

    # exact P1 simplex mass: M_ij = |K| (1 + delta_ij) / ((d+1)(d+2))
    Mref = (np.ones((nloc, nloc)) + np.eye(nloc)) / ((d + 1) * (d + 2))
    Me = Mref[None] * measure[:, None, None]

    facets = mesh.facets  # (nf, d) vertex ids
    f2c = mesh.facet_to_cells  # (nf, 2)
    fv = mesh.vertices[facets]  # (nf, d, d)
    if d == 2:
        tvec = fv[:, 1] - fv[:, 0]
        fmeas = np.linalg.norm(tvec, axis=1)  # edge length
        nrm = np.stack([tvec[:, 1], -tvec[:, 0]], axis=1) / fmeas[:, None]
        hF = fmeas
        # 2-point Gauss (exact for the quadratic [u][v] products)
        qp = np.array([[0.5 - 0.5 / np.sqrt(3.0)], [0.5 + 0.5 / np.sqrt(3.0)]])
        qw = np.array([0.5, 0.5])
        pts = fv[:, None, 0, :] + qp[None, :, 0, None] * tvec[:, None, :]
    else:
        e1 = fv[:, 1] - fv[:, 0]
        e2 = fv[:, 2] - fv[:, 0]
        cr = np.cross(e1, e2)
        fmeas = 0.5 * np.linalg.norm(cr, axis=1)  # triangle area
        nrm = cr / np.linalg.norm(cr, axis=1, keepdims=True)
        # length scale for the penalty: face diameter
        hF = np.max(
            np.stack(
                [np.linalg.norm(e1, axis=1), np.linalg.norm(e2, axis=1),
                 np.linalg.norm(e2 - e1, axis=1)], axis=1),
            axis=1,
        )
        # edge-midpoint rule: exact for quadratics on the triangle
        qp = np.array([[0.5, 0.0], [0.5, 0.5], [0.0, 0.5]])
        qw = np.array([1.0, 1.0, 1.0]) / 3.0
        pts = (
            fv[:, None, 0, :]
            + qp[None, :, 0, None] * e1[:, None, :]
            + qp[None, :, 1, None] * e2[:, None, :]
        )

    # orient normals outward from cell 0 (away from its centroid)
    cent0 = verts[f2c[:, 0]].mean(axis=1)
    mid = fv.mean(axis=1)
    flip = np.einsum("fd,fd->f", nrm, mid - cent0) < 0
    nrm[flip] *= -1.0

    def _phi_cell_at(cells_id, pts_f):
        """P1 basis of each cell evaluated at (nf, nq, d) physical pts."""
        vc = verts[cells_id]  # (nf, d+1, d)
        v0 = vc[:, 0]
        Jl = np.stack([vc[:, k] - v0 for k in range(1, d + 1)], axis=2)
        inv = np.linalg.inv(Jl)
        ref = np.einsum("fde,fqe->fqd", inv, pts_f - v0[:, None, :])
        return _phi_at(ref.reshape(-1, d)).reshape(pts_f.shape[0], -1, nloc)

    interior = f2c[:, 1] >= 0
    loc = np.arange(nloc)
    for kind in ("interior", "boundary"):
        if kind == "interior":
            fsel = np.flatnonzero(interior)
            if fsel.size == 0:
                continue
            cL, cR = f2c[fsel, 0], f2c[fsel, 1]
            phiL = _phi_cell_at(cL, pts[fsel])  # (nf, nq, nloc)
            phiR = _phi_cell_at(cR, pts[fsel])
            gnL = np.einsum("fkd,fd->fk", gphys[cL], nrm[fsel])
            gnR = np.einsum("fkd,fd->fk", gphys[cR], nrm[fsel])
            w = qw[None, :] * fmeas[fsel][:, None]  # physical weights
            # jump/average over the 2*nloc composite dofs
            jump = np.concatenate([phiL, -phiR], axis=2)
            avg = 0.5 * np.concatenate([gnL, gnR], axis=1)
            pen = (eta / hF[fsel])[:, None, None]
            Kf = pen * np.einsum("fq,fqi,fqj->fij", w, jump, jump)
            cons = np.einsum("fq,fqi,fj->fij", w, jump, avg)
            Kf -= cons + np.transpose(cons, (0, 2, 1))
            dof = np.concatenate(
                [nloc * cL[:, None] + loc, nloc * cR[:, None] + loc], axis=1)
            m = 2 * nloc
        else:
            fsel = np.flatnonzero(~interior)
            if fsel.size == 0:
                continue
            cL = f2c[fsel, 0]
            jump = _phi_cell_at(cL, pts[fsel])
            avg = np.einsum("fkd,fd->fk", gphys[cL], nrm[fsel])
            w = qw[None, :] * fmeas[fsel][:, None]
            pen = (eta / hF[fsel])[:, None, None]
            Kf = pen * np.einsum("fq,fqi,fqj->fij", w, jump, jump)
            cons = np.einsum("fq,fqi,fj->fij", w, jump, avg)
            Kf -= cons + np.transpose(cons, (0, 2, 1))
            dof = nloc * cL[:, None] + loc
            m = nloc
        rows.append(np.repeat(dof, m, axis=1).ravel())
        cols.append(np.tile(dof, (1, m)).ravel())
        vals.append(Kf.ravel())

    K = sp.csr_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
        shape=(n, n),
    )
    K.sum_duplicates()
    M = sp.csr_matrix((Me.ravel(), (rr.ravel(), cc.ravel())), shape=(n, n))
    return CSRMatrix.from_scipy(K, device=device), CSRMatrix.from_scipy(M, device=device)
