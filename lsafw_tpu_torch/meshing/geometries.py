"""Benchmark geometry generators: cylinder-in-channel and backward-facing
step, in 2D (triangles) and 3D (tetrahedra).

The reference builds these with the gmsh C++ kernel plus
Distance/Threshold refinement fields (``Meshing/geometries.py:29-273``).
Here they are generated natively with a force-equilibrium
(distmesh-style, Persson & Strang 2004) smoother over scipy Delaunay
triangulations, with the same graded size fields (fine
``resolution_around_cylinder`` near the body, ramping to ``resolution``
over ``influence_radius``: the gmsh Threshold-field semantics of
``Meshing/geometries.py:75-110``).  The code is the JAX package's, so
that one seed gives the same points in both packages.

Meshing is host-side preprocessing: the mesh is input data for the
device numerics.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
from scipy.spatial import Delaunay, cKDTree

from lsafw_tpu_torch.config import CylinderFlowGeometryConfig, StepFlowGeometryConfig
from lsafw_tpu_torch.meshing.mesh import CellType, Mesh
from lsafw_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

SDF = Callable[[np.ndarray], np.ndarray]
SizeFn = Callable[[np.ndarray], np.ndarray]


# ---------------------------------------------------------------------------
# Signed distance primitives
# ---------------------------------------------------------------------------


def d_rectangle(p: np.ndarray, x0: float, x1: float, y0: float, y1: float) -> np.ndarray:
    """Signed distance to an axis-aligned rectangle (negative inside).

    Exact outside-corner distance, so boundary projection is well
    behaved at corners.
    """
    dx = np.maximum(x0 - p[:, 0], p[:, 0] - x1)
    dy = np.maximum(y0 - p[:, 1], p[:, 1] - y1)
    inside = np.maximum(dx, dy)
    ox = np.maximum(dx, 0.0)
    oy = np.maximum(dy, 0.0)
    outside = np.hypot(ox, oy)
    return np.where(inside < 0.0, inside, outside)


def d_circle(p: np.ndarray, cx: float, cy: float, r: float) -> np.ndarray:
    return np.hypot(p[:, 0] - cx, p[:, 1] - cy) - r


def d_diff(d1: np.ndarray, d2: np.ndarray) -> np.ndarray:
    """Set difference A \\ B of signed distances."""
    return np.maximum(d1, -d2)


def d_union(d1: np.ndarray, d2: np.ndarray) -> np.ndarray:
    return np.minimum(d1, d2)


# ---------------------------------------------------------------------------
# distmesh-style smoother
# ---------------------------------------------------------------------------


def _initial_points(fd: SDF, fh: SizeFn, h0: float, bbox, pfix: np.ndarray, seed: int):
    x0, x1, y0, y1 = bbox
    xs = np.arange(x0, x1 + h0, h0)
    ys = np.arange(y0, y1 + h0 * np.sqrt(3) / 2, h0 * np.sqrt(3) / 2)
    X, Y = np.meshgrid(xs, ys, indexing="xy")
    X[1::2, :] += h0 / 2  # equilateral-ish offset rows
    p = np.column_stack([X.ravel(), Y.ravel()])
    p = p[fd(p) < 0.0]
    # density rejection against the size field
    r0 = 1.0 / fh(p) ** 2
    rng = np.random.default_rng(seed)
    p = p[rng.random(p.shape[0]) < r0 / r0.max()]
    if pfix.size:
        # drop generated points that collide with fixed points
        tree = cKDTree(pfix)
        d, _ = tree.query(p)
        p = p[d > 1e-3 * h0]
        p = np.vstack([pfix, p])
    return p


def _unique_edges(tris: np.ndarray) -> np.ndarray:
    e = np.vstack([tris[:, [0, 1]], tris[:, [1, 2]], tris[:, [0, 2]]])
    e.sort(axis=1)
    return np.unique(e, axis=0)


def distmesh2d(
    fd: SDF,
    fh: SizeFn,
    h0: float,
    bbox: tuple[float, float, float, float],
    pfix: np.ndarray | None = None,
    *,
    max_iter: int = 200,
    seed: int = 0,
) -> tuple[np.ndarray, np.ndarray]:
    """Generate a graded 2D triangle mesh of the region {fd < 0}.

    Force-equilibrium mesh smoothing over repeated Delaunay
    retriangulations; ``fh`` is the relative target edge-length field.
    Own implementation of the public distmesh algorithm.
    """
    geps = 1e-3 * h0
    deps = np.sqrt(np.finfo(float).eps) * h0
    Fscale, deltat, ttol, ptol = 1.2, 0.2, 0.1, 1e-3

    pfix = np.zeros((0, 2)) if pfix is None else np.asarray(pfix, dtype=float)
    nfix = pfix.shape[0]
    p = _initial_points(fd, fh, h0, bbox, pfix, seed)
    pold = np.full_like(p, np.inf)
    tris = np.zeros((0, 3), dtype=np.int64)
    bars = np.zeros((0, 2), dtype=np.int64)

    for it in range(max_iter):
        if np.max(np.hypot(*(p - pold).T)) / h0 > ttol:
            pold = p.copy()
            tri = Delaunay(p)
            cent = p[tri.simplices].mean(axis=1)
            keep = fd(cent) < -geps
            tris = tri.simplices[keep]
            bars = _unique_edges(tris)

        vec = p[bars[:, 0]] - p[bars[:, 1]]
        L = np.hypot(vec[:, 0], vec[:, 1])
        mid = 0.5 * (p[bars[:, 0]] + p[bars[:, 1]])
        hb = fh(mid)
        L0 = hb * Fscale * np.sqrt((L**2).sum() / (hb**2).sum())
        F = np.maximum(L0 - L, 0.0)
        Fvec = (F / np.maximum(L, 1e-300))[:, None] * vec
        force = np.zeros_like(p)
        np.add.at(force, bars[:, 0], Fvec)
        np.add.at(force, bars[:, 1], -Fvec)
        force[:nfix] = 0.0
        p = p + deltat * force

        # project escaped points back onto the boundary
        d = fd(p)
        out = d > 0.0
        if out.any():
            po = p[out]
            dgx = (fd(po + [deps, 0.0]) - d[out]) / deps
            dgy = (fd(po + [0.0, deps]) - d[out]) / deps
            norm2 = dgx**2 + dgy**2
            norm2 = np.where(norm2 < 1e-30, 1.0, norm2)
            p[out] = po - np.column_stack([d[out] * dgx, d[out] * dgy]) / norm2[:, None]

        interior = d < -geps
        if interior.any():
            move = np.hypot(*(deltat * force[interior]).T).max()
            if move / h0 < ptol:
                break

    # final clean triangulation
    tri = Delaunay(p)
    cent = p[tri.simplices].mean(axis=1)
    tris = tri.simplices[fd(cent) < -geps]
    # drop unused points and remap
    used = np.unique(tris)
    remap = -np.ones(p.shape[0], dtype=np.int64)
    remap[used] = np.arange(used.size)
    p = p[used]
    tris = remap[tris]
    # enforce CCW orientation
    v = p[tris]
    area2 = (v[:, 1, 0] - v[:, 0, 0]) * (v[:, 2, 1] - v[:, 0, 1]) - (
        v[:, 1, 1] - v[:, 0, 1]
    ) * (v[:, 2, 0] - v[:, 0, 0])
    flip = area2 < 0
    tris[flip] = tris[flip][:, [0, 2, 1]]
    logger.info("distmesh2d: %d points, %d triangles after %d iters", p.shape[0], tris.shape[0], it + 1)
    return p, tris


# ---------------------------------------------------------------------------
# 3D: signed distances and tet distmesh
# ---------------------------------------------------------------------------


def d_box(p: np.ndarray, x0, x1, y0, y1, z0, z1) -> np.ndarray:
    """Signed distance to an axis-aligned box (negative inside), exact
    outside-corner distance."""
    dx = np.maximum(x0 - p[:, 0], p[:, 0] - x1)
    dy = np.maximum(y0 - p[:, 1], p[:, 1] - y1)
    dz = np.maximum(z0 - p[:, 2], p[:, 2] - z1)
    inside = np.maximum(np.maximum(dx, dy), dz)
    out = np.sqrt(
        np.maximum(dx, 0.0) ** 2 + np.maximum(dy, 0.0) ** 2 + np.maximum(dz, 0.0) ** 2
    )
    return np.where(inside < 0.0, inside, out)


def d_cylinder_z(p: np.ndarray, cx: float, cy: float, r: float) -> np.ndarray:
    """Infinite cylinder along z (the reference's 3D flow obstacle,
    ``Meshing/geometries.py:112-151`` box-minus-cylinder)."""
    return np.hypot(p[:, 0] - cx, p[:, 1] - cy) - r


def d_extrude(d2: np.ndarray, p: np.ndarray, z0: float, z1: float) -> np.ndarray:
    """Extrude a 2D signed distance along z in [z0, z1] (the reference's
    3D step extrusion, ``Meshing/geometries.py:203-224``)."""
    dz = np.maximum(z0 - p[:, 2], p[:, 2] - z1)
    inside = np.maximum(d2, dz)
    out = np.sqrt(np.maximum(d2, 0.0) ** 2 + np.maximum(dz, 0.0) ** 2)
    return np.where((d2 < 0.0) & (dz < 0.0), inside, out)


def _unique_edges_tet(tets: np.ndarray) -> np.ndarray:
    e = np.vstack([
        tets[:, [0, 1]], tets[:, [0, 2]], tets[:, [0, 3]],
        tets[:, [1, 2]], tets[:, [1, 3]], tets[:, [2, 3]],
    ])
    e.sort(axis=1)
    return np.unique(e, axis=0)


def distmesh3d(
    fd: SDF,
    fh: SizeFn,
    h0: float,
    bbox: tuple[float, float, float, float, float, float],
    pfix: np.ndarray | None = None,
    *,
    max_iter: int = 120,
    seed: int = 0,
) -> tuple[np.ndarray, np.ndarray]:
    """Graded tetrahedral mesh of {fd < 0}: the 3D force-equilibrium
    smoother over repeated 3D Delaunay retriangulations (Persson &
    Strang 2004 extended to tets; own implementation).  Closes the
    reference's 3D unstructured capability
    (``Meshing/geometries.py:112-151, 203-224``) without gmsh.
    """
    x0, x1, y0, y1, z0, z1 = bbox
    geps = 1e-3 * h0
    deps = np.sqrt(np.finfo(float).eps) * h0
    Fscale, deltat, ttol, ptol = 1.1, 0.1, 0.1, 2e-3

    pfix = np.zeros((0, 3)) if pfix is None else np.asarray(pfix, dtype=float)
    nfix = pfix.shape[0]

    xs = np.arange(x0, x1 + h0, h0)
    ys = np.arange(y0, y1 + h0, h0)
    zs = np.arange(z0, z1 + h0, h0)
    X, Y, Z = np.meshgrid(xs, ys, zs, indexing="ij")
    p = np.column_stack([X.ravel(), Y.ravel(), Z.ravel()])
    p = p[fd(p) < 0.0]
    r0 = 1.0 / fh(p) ** 3
    rng = np.random.default_rng(seed)
    p = p[rng.random(p.shape[0]) < r0 / r0.max()]
    if pfix.size:
        tree = cKDTree(pfix)
        d, _ = tree.query(p)
        p = p[d > 1e-3 * h0]
        p = np.vstack([pfix, p])

    pold = np.full_like(p, np.inf)
    tets = np.zeros((0, 4), dtype=np.int64)
    bars = np.zeros((0, 2), dtype=np.int64)

    for it in range(max_iter):
        if np.max(np.linalg.norm(p - pold, axis=1)) / h0 > ttol:
            pold = p.copy()
            tri = Delaunay(p)
            cent = p[tri.simplices].mean(axis=1)
            keep = fd(cent) < -geps
            tets = tri.simplices[keep]
            bars = _unique_edges_tet(tets)

        vec = p[bars[:, 0]] - p[bars[:, 1]]
        L = np.linalg.norm(vec, axis=1)
        mid = 0.5 * (p[bars[:, 0]] + p[bars[:, 1]])
        hb = fh(mid)
        L0 = hb * Fscale * (np.sum(L**3) / np.sum(hb**3)) ** (1.0 / 3.0)
        F = np.maximum(L0 - L, 0.0)
        Fvec = (F / np.maximum(L, 1e-300))[:, None] * vec
        force = np.zeros_like(p)
        np.add.at(force, bars[:, 0], Fvec)
        np.add.at(force, bars[:, 1], -Fvec)
        force[:nfix] = 0.0
        p = p + deltat * force

        d = fd(p)
        out = d > 0.0
        if out.any():
            po = p[out]
            grad = np.column_stack([
                (fd(po + [deps, 0.0, 0.0]) - d[out]) / deps,
                (fd(po + [0.0, deps, 0.0]) - d[out]) / deps,
                (fd(po + [0.0, 0.0, deps]) - d[out]) / deps,
            ])
            norm2 = (grad**2).sum(axis=1)
            norm2 = np.where(norm2 < 1e-30, 1.0, norm2)
            p[out] = po - (d[out] / norm2)[:, None] * grad

        interior = d < -geps
        if interior.any():
            move = np.linalg.norm(deltat * force[interior], axis=1).max()
            if move / h0 < ptol:
                break

    tri = Delaunay(p)
    cent = p[tri.simplices].mean(axis=1)
    tets = tri.simplices[fd(cent) < -geps]
    # drop slivers (volume below 1e-4 of the target-size cell volume):
    # scipy Delaunay keeps near-degenerate tets near curved boundaries
    v = p[tets]
    J = np.stack([v[:, 1] - v[:, 0], v[:, 2] - v[:, 0], v[:, 3] - v[:, 0]], axis=2)
    vol = np.abs(np.linalg.det(J)) / 6.0
    hloc = fh(p[tets].mean(axis=1))
    tets = tets[vol > 1e-4 * hloc**3]
    # drop unused points, remap, and orient positively
    used = np.unique(tets)
    remap = -np.ones(p.shape[0], dtype=np.int64)
    remap[used] = np.arange(used.size)
    p = p[used]
    tets = remap[tets]
    v = p[tets]
    J = np.stack([v[:, 1] - v[:, 0], v[:, 2] - v[:, 0], v[:, 3] - v[:, 0]], axis=2)
    flip = np.linalg.det(J) < 0
    tets[flip] = tets[flip][:, [0, 2, 1, 3]]
    logger.info(
        "distmesh3d: %d points, %d tets after %d iters", p.shape[0], tets.shape[0], it + 1
    )
    return p, tets


# ---------------------------------------------------------------------------
# Benchmark geometries
# ---------------------------------------------------------------------------


def cylinder_flow_mesh(cfg: CylinderFlowGeometryConfig, *, max_iter: int = 200, seed: int = 0) -> Mesh:
    """Cylinder-in-channel mesh (parity: ``Meshing/geometries.py:29-151``).

    ``dim=2``: graded triangles.  ``dim=3``: the box-minus-cylinder of
    the reference's OCC boolean (``Meshing/geometries.py:112-151``) as
    graded tets via :func:`distmesh3d` (``z_range`` required).
    Size field reproduces the gmsh Threshold semantics: ``hc`` inside
    ``r``..``influence_radius`` ramping linearly to the base resolution.
    """
    (x0, x1), (y0, y1) = cfg.x_range, cfg.y_range
    cx, cy = cfg.cylinder_center[:2]
    r = cfg.cylinder_radius
    hb, hc, R = cfg.resolution, cfg.resolution_around_cylinder, cfg.influence_radius

    def fh2(p: np.ndarray) -> np.ndarray:
        d = np.hypot(p[:, 0] - cx, p[:, 1] - cy) - r
        t = np.clip(d / max(R - r, 1e-12), 0.0, 1.0)
        return hc + (hb - hc) * t

    if cfg.dim == 3:
        if cfg.z_range is None:
            raise ValueError("3D cylinder flow needs z_range in the geometry config.")
        z0, z1 = cfg.z_range

        def fd3(p: np.ndarray) -> np.ndarray:
            return d_diff(
                d_box(p, x0, x1, y0, y1, z0, z1), d_cylinder_z(p, cx, cy, r)
            )

        corners3 = np.array(
            [[x, y, z] for x in (x0, x1) for y in (y0, y1) for z in (z0, z1)]
        )
        pts, tets = distmesh3d(
            fd3, fh2, hc, (x0, x1, y0, y1, z0, z1), corners3,
            max_iter=max_iter, seed=seed,
        )
        return Mesh(pts, tets, CellType.TETRAHEDRON)

    def fd(p: np.ndarray) -> np.ndarray:
        return d_diff(d_rectangle(p, x0, x1, y0, y1), d_circle(p, cx, cy, r))

    corners = np.array([[x0, y0], [x1, y0], [x0, y1], [x1, y1]])
    pts, tris = distmesh2d(fd, fh2, hc, (x0, x1, y0, y1), corners, max_iter=max_iter, seed=seed)
    return Mesh(pts, tris, CellType.TRIANGLE)


def step_flow_mesh(cfg: StepFlowGeometryConfig, *, max_iter: int = 150, seed: int = 0) -> Mesh:
    """Backward-facing step mesh (parity: ``Meshing/geometries.py:154-224``).

    Geometry: inlet channel x in [-inlet_length, 0], y in [0, channel_height];
    outlet x in [0, outlet_length], y in [-step_height, channel_height].
    Optional refinement (by ``refinement_factor``) around the step corner.
    ``dim=3`` extrudes the 2D profile over z in [0, width] as graded
    tets (the reference's extrusion, ``Meshing/geometries.py:203-224``).
    """
    Li, Lo = cfg.inlet_length, cfg.outlet_length
    H, s = cfg.channel_height, cfg.step_height
    hb = cfg.resolution
    factor = cfg.refinement_factor or 1.0
    hc = hb / max(factor, 1.0)

    def fd(p: np.ndarray) -> np.ndarray:
        return d_union(
            d_rectangle(p, -Li, 0.0, 0.0, H),
            d_rectangle(p, 0.0, Lo, -s, H),
        )

    def fh(p: np.ndarray) -> np.ndarray:
        if factor <= 1.0:
            return np.full(p.shape[0], hb)
        d = np.hypot(p[:, 0], p[:, 1])  # distance from step corner (0, 0)
        influence = 3.0 * s
        t = np.clip(d / influence, 0.0, 1.0)
        return hc + (hb - hc) * t

    if cfg.dim == 3:
        w = cfg.width
        if w is None:
            raise ValueError("3D step flow needs width in the geometry config.")

        def fd2(p2: np.ndarray) -> np.ndarray:
            return d_union(
                d_rectangle(p2, -Li, 0.0, 0.0, H),
                d_rectangle(p2, 0.0, Lo, -s, H),
            )

        def fd3(p: np.ndarray) -> np.ndarray:
            return d_extrude(fd2(p[:, :2]), p, 0.0, w)

        corners2 = [
            (-Li, 0.0), (-Li, H), (0.0, 0.0), (0.0, -s), (Lo, -s), (Lo, H), (0.0, H)
        ]
        corners3 = np.array([[x, y, z] for x, y in corners2 for z in (0.0, w)])
        pts, tets = distmesh3d(
            fd3, fh, hc, (-Li, Lo, -s, H, 0.0, w), corners3,
            max_iter=max_iter, seed=seed,
        )
        return Mesh(pts, tets, CellType.TETRAHEDRON)

    corners = np.array(
        [[-Li, 0.0], [-Li, H], [0.0, 0.0], [0.0, -s], [Lo, -s], [Lo, H], [0.0, H]]
    )
    pts, tris = distmesh2d(fd, fh, hc, (-Li, Lo, -s, H), corners, max_iter=max_iter, seed=seed)
    return Mesh(pts, tris, CellType.TRIANGLE)
