"""Baseflow-driven mesh adaptation.

Counterpart of ``Meshing/adapt.py:215-265``: the reference projects the
baseflow velocity magnitude to P1, scales/clamps it into a target
element-size field, writes a GMSH POS background field and remeshes
through gmsh.  Natively, the same size field drives a distmesh
regeneration: |u| is sampled at old-mesh vertices, mapped to sizes in
[min_size, max_size] (fast flow -> fine cells), and interpolated as the
``fh`` field of :func:`lsafw_tpu_torch.meshing.geometries.distmesh2d`
(triangles) or :func:`~lsafw_tpu_torch.meshing.geometries.distmesh3d` (tets,
the counterpart of the reference's 4-faces/tet POS background fields,
``Meshing/adapt.py:102-138``).  Host code (numpy, scipy); the baseflow
may be a device tensor.
"""

from __future__ import annotations

import numpy as np
from scipy.spatial import cKDTree

from lsafw_tpu_torch.fem.spaces import FunctionSpaces
from lsafw_tpu_torch.meshing.geometries import SDF, distmesh2d
from lsafw_tpu_torch.meshing.mesh import CellType, Mesh
from lsafw_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


def velocity_magnitude_p1(spaces: FunctionSpaces, baseflow) -> np.ndarray:
    """|u| at mesh vertices (parity: ``_project_velocity_magnitude``,
    ``Meshing/adapt.py:55-88`` — nodal evaluation replaces the
    lumped-mass L2 projection; identical for Lagrange velocity spaces).
    ``baseflow`` is a host array or a device tensor."""
    if hasattr(baseflow, "detach"):
        baseflow = baseflow.detach().cpu().numpy()
    u, _ = spaces.split(np.real(baseflow))
    mag = np.linalg.norm(u, axis=1)
    nv = spaces.velocity.mesh.num_vertices
    return mag[:nv]  # velocity nodes are ordered vertices-first


def scale_and_clamp(
    mag: np.ndarray, min_size: float, max_size: float
) -> np.ndarray:
    """Map velocity magnitude to target sizes: fastest flow -> finest
    cells (parity: ``_scale_and_clamp_velocity``, ``Meshing/adapt.py:91-99``)."""
    lo, hi = float(mag.min()), float(mag.max())
    t = (mag - lo) / (hi - lo) if hi > lo else np.zeros_like(mag)
    return np.clip(max_size - t * (max_size - min_size), min_size, max_size)


def _boundary_edges_2d(mesh: Mesh) -> np.ndarray:
    """Boundary edges of a 2D triangle mesh, in triangle orientation
    (edges that belong to exactly one triangle)."""
    c = np.asarray(mesh.cells)
    e = np.concatenate([c[:, [0, 1]], c[:, [1, 2]], c[:, [2, 0]]])
    es = np.sort(e, axis=1)
    _, inv, cnt = np.unique(es, axis=0, return_inverse=True, return_counts=True)
    return e[cnt[inv] == 1]


def boundary_corners_2d(mesh: Mesh, angle_deg: float = 20.0) -> np.ndarray:
    """Boundary vertices where the boundary turns by more than
    ``angle_deg`` (default pfix of :func:`adapt_mesh`: domain corners
    survive the remesh exactly)."""
    edges = _boundary_edges_2d(mesh)
    v = np.asarray(mesh.vertices)
    # boundary loops are vertex-disjoint chains: succ[a] = b per edge
    succ = {int(a): int(b) for a, b in edges}
    pred = {int(b): int(a) for a, b in edges}
    corners = []
    cos_thresh = np.cos(np.deg2rad(angle_deg))
    for b in succ:
        a, c = pred.get(b), succ.get(b)
        if a is None or c is None:
            corners.append(b)
            continue
        t1 = v[b] - v[a]
        t2 = v[c] - v[b]
        n1 = np.linalg.norm(t1)
        n2 = np.linalg.norm(t2)
        if n1 == 0 or n2 == 0:
            continue
        if np.dot(t1, t2) / (n1 * n2) < cos_thresh:
            corners.append(b)
    return v[np.array(sorted(corners), dtype=np.int64)] if corners else np.zeros((0, 2))


def boundary_sdf(mesh: Mesh) -> SDF:
    """Signed distance of the mesh's own boundary — the safe default
    ``fd`` for :func:`adapt_mesh` on domains with holes (the bounding
    box silently FILLS a cylinder hole; parity note: the reference
    remeshes the true geometry through gmsh, ``Meshing/adapt.py:215``).

    2D: exact point-segment distance to the k nearest boundary edges,
    sign by even-odd ray crossing against ALL boundary edges (handles
    any number of holes).  3D: distance to the nearest boundary-face
    sample, sign from that face's outward pseudonormal (approximate
    within ~h of edges/corners — adequate for the distmesh projector).
    """
    v = np.asarray(mesh.vertices, dtype=np.float64)
    if mesh.tdim == 2:
        edges = _boundary_edges_2d(mesh)
        a = v[edges[:, 0]]
        b = v[edges[:, 1]]
        mid = 0.5 * (a + b)
        tree = cKDTree(mid)
        k = min(16, len(edges))
        ab = b - a
        ab2 = np.maximum((ab * ab).sum(1), 1e-300)

        def fd(p: np.ndarray) -> np.ndarray:
            p = np.atleast_2d(np.asarray(p, dtype=np.float64))
            _, idx = tree.query(p, k=k)
            idx = idx.reshape(len(p), -1)
            pa = p[:, None, :] - a[idx]  # (np, k, 2)
            t = np.clip((pa * ab[idx]).sum(-1) / ab2[idx], 0.0, 1.0)
            d = pa - t[..., None] * ab[idx]
            dist = np.sqrt((d * d).sum(-1)).min(axis=1)
            # even-odd crossings of the +x ray (chunked over points)
            inside = np.zeros(len(p), dtype=bool)
            ay, by = a[:, 1], b[:, 1]
            ax, bx = a[:, 0], b[:, 0]
            dy = by - ay
            dy_safe = np.where(dy == 0.0, 1.0, dy)
            for s in range(0, len(p), 4096):
                px = p[s:s + 4096, 0:1]
                py = p[s:s + 4096, 1:2]
                straddle = (ay > py) != (by > py)
                xcross = ax + (py - ay) * (bx - ax) / dy_safe
                inside[s:s + 4096] = ((straddle & (px < xcross)).sum(1) % 2) == 1
            return np.where(inside, -dist, dist)

        return fd
    # ---- 3D: boundary faces of a tet mesh ----
    c = np.asarray(mesh.cells)
    faces = np.concatenate([
        c[:, [0, 1, 2]], c[:, [0, 1, 3]], c[:, [0, 2, 3]], c[:, [1, 2, 3]],
    ])
    owner = np.tile(np.arange(len(c)), 4)
    fs = np.sort(faces, axis=1)
    _, inv, cnt = np.unique(fs, axis=0, return_inverse=True, return_counts=True)
    bmask = cnt[inv] == 1
    bf, bown = faces[bmask], owner[bmask]
    p0, p1, p2 = v[bf[:, 0]], v[bf[:, 1]], v[bf[:, 2]]
    cent = (p0 + p1 + p2) / 3.0
    nrm = np.cross(p1 - p0, p2 - p0)
    nrm /= np.maximum(np.linalg.norm(nrm, axis=1, keepdims=True), 1e-300)
    tet_cent = v[c[bown]].mean(axis=1)
    flip = ((cent - tet_cent) * nrm).sum(1) < 0
    nrm[flip] *= -1.0  # outward
    # sample cloud: centroids + face vertices (sign rides the centroid)
    cloud = np.concatenate([cent, p0, p1, p2])
    cloud_face = np.tile(np.arange(len(bf)), 4)
    tree3 = cKDTree(cloud)
    ctree = cKDTree(cent)

    def fd3(p: np.ndarray) -> np.ndarray:
        p = np.atleast_2d(np.asarray(p, dtype=np.float64))
        dist, _ = tree3.query(p)
        _, ci = ctree.query(p)
        sgn = np.sign(((p - cent[ci]) * nrm[ci]).sum(1))
        return np.where(sgn == 0, -dist, sgn * dist)

    _ = cloud_face  # sample-to-face map kept for future exact projection
    return fd3


def adapt_mesh(
    mesh: Mesh,
    spaces: FunctionSpaces,
    baseflow: np.ndarray,
    *,
    min_size: float,
    max_size: float,
    fd: SDF | None = None,
    pfix: np.ndarray | None = None,
    max_iter: int = 120,
    seed: int = 0,
) -> Mesh:
    """Remesh with a baseflow-magnitude size field
    (parity: ``adapt_mesh``, ``Meshing/adapt.py:215-265``).

    Args:
        fd: signed distance of the domain; defaults to
            :func:`boundary_sdf` of the current mesh, so domains with
            holes (the flagship cylinder) keep their holes.  Pass the
            analytic SDF when available — it is cheaper and exact at
            corners.
        pfix: fixed points; defaults to the mesh's own boundary corners
            (2D) / the bounding-box corners (3D).
    """
    if mesh.tdim not in (2, 3):
        raise NotImplementedError("Native adaptation supports 2D/3D simplex meshes.")
    mag = velocity_magnitude_p1(spaces, baseflow)
    sizes = scale_and_clamp(mag, min_size, max_size)
    tree = cKDTree(mesh.vertices)

    def fh(p: np.ndarray) -> np.ndarray:
        _, idx = tree.query(p)
        return sizes[idx]

    lo = mesh.vertices.min(axis=0)
    hi = mesh.vertices.max(axis=0)
    if mesh.tdim == 2:
        if fd is None:
            fd = boundary_sdf(mesh)
            if pfix is None:
                pfix = boundary_corners_2d(mesh)
        bbox = (float(lo[0]), float(hi[0]), float(lo[1]), float(hi[1]))
        pts, cells = distmesh2d(
            fd, fh, min_size, bbox, pfix, max_iter=max_iter, seed=seed
        )
        new = Mesh(pts, cells, CellType.TRIANGLE)
    else:
        # 3D: graded tet regeneration through distmesh3d (parity:
        # the reference's 4-faces/tet POS background remeshing,
        # ``Meshing/adapt.py:102-138`` — here the size field drives the
        # tet smoother directly, no POS round-trip needed)
        from lsafw_tpu_torch.meshing.geometries import distmesh3d

        if fd is None:
            fd = boundary_sdf(mesh)
            if pfix is None:
                (x0, y0, z0), (x1, y1, z1) = lo, hi
                pfix = np.array(
                    [[x, y, z] for x in (x0, x1) for y in (y0, y1) for z in (z0, z1)]
                )
        bbox = (
            float(lo[0]), float(hi[0]),
            float(lo[1]), float(hi[1]),
            float(lo[2]), float(hi[2]),
        )
        pts, cells = distmesh3d(
            fd, fh, min_size, bbox, pfix, max_iter=max_iter, seed=seed
        )
        new = Mesh(pts, cells, CellType.TETRAHEDRON)
    logger.info(
        "Adapted mesh: %d -> %d cells (h in [%.3g, %.3g])",
        mesh.num_cells, new.num_cells, min_size, max_size,
    )
    return new
