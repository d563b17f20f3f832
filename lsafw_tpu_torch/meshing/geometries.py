"""Benchmark geometry generator: the 2D cylinder-in-channel mesh.

The reference builds these with the gmsh C++ kernel plus
Distance/Threshold refinement fields (``Meshing/geometries.py:29-273``).
gmsh is a preprocessing-time dependency the TPU framework does not
carry; instead these meshes are generated natively with a
force-equilibrium (distmesh-style, Persson & Strang 2004) smoother over
scipy Delaunay triangulations, with the same graded size fields
(fine ``resolution_around_cylinder`` near the body, ramping to
``resolution`` over ``influence_radius`` — the gmsh Threshold-field
semantics of ``Meshing/geometries.py:75-110``).

Meshing is host-side preprocessing: the mesh is *input data* for the
jitted TPU numerics, not device compute.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
from scipy.spatial import Delaunay, cKDTree

from lsafw_tpu_torch.config import CylinderFlowGeometryConfig
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
# Benchmark geometries
# ---------------------------------------------------------------------------


def cylinder_flow_mesh(cfg: CylinderFlowGeometryConfig, *, max_iter: int = 200, seed: int = 0) -> Mesh:
    """2D cylinder-in-channel mesh of graded triangles (parity:
    ``Meshing/geometries.py:29-111``; the 3D box-minus-cylinder is not
    ported).  Size field reproduces the gmsh Threshold semantics: ``hc``
    inside ``r``..``influence_radius`` ramping linearly to the base
    resolution.
    """
    if cfg.dim != 2:
        raise NotImplementedError("only the 2D cylinder mesh is ported")
    (x0, x1), (y0, y1) = cfg.x_range, cfg.y_range
    cx, cy = cfg.cylinder_center[:2]
    r = cfg.cylinder_radius
    hb, hc, R = cfg.resolution, cfg.resolution_around_cylinder, cfg.influence_radius

    def fh2(p: np.ndarray) -> np.ndarray:
        d = np.hypot(p[:, 0] - cx, p[:, 1] - cy) - r
        t = np.clip(d / max(R - r, 1e-12), 0.0, 1.0)
        return hc + (hb - hc) * t

    def fd(p: np.ndarray) -> np.ndarray:
        return d_diff(d_rectangle(p, x0, x1, y0, y1), d_circle(p, cx, cy, r))

    corners = np.array([[x0, y0], [x1, y0], [x0, y1], [x1, y1]])
    pts, tris = distmesh2d(fd, fh2, hc, (x0, x1, y0, y1), corners, max_iter=max_iter, seed=seed)
    return Mesh(pts, tris, CellType.TRIANGLE)
