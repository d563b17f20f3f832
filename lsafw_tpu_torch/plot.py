"""Host-side plots of meshes, sparsity, fields, mode shapes, residual
histories and pseudospectra.

Counterpart of the reference's ``plot`` module: matplotlib alone, with
the Agg backend, on host arrays (a tensor argument is copied to the
host first).  Every function takes an optional ``path`` to save the
figure to instead of returning it.  Nothing on the card's path imports
this module: it is loaded by the command line's ``--plot`` only.
"""

from __future__ import annotations

from enum import Enum
from pathlib import Path

import numpy as np

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402
import matplotlib.tri as mtri  # noqa: E402

from lsafw_tpu_torch.fem.spaces import FunctionSpaces  # noqa: E402
from lsafw_tpu_torch.io import to_host  # noqa: E402
from lsafw_tpu_torch.meshing.mesh import Mesh  # noqa: E402
from lsafw_tpu_torch.ops.sparse import CSRMatrix  # noqa: E402


class PlotMode(Enum):
    """Static file output; ``INTERACTIVE`` falls back to it."""

    STATIC = "static"
    INTERACTIVE = "interactive"  # falls back to static file output


def _finish(fig, path: Path | str | None):
    if path is not None:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        fig.savefig(path, dpi=150, bbox_inches="tight")
        plt.close(fig)
        return path
    return fig


def plot_mesh(mesh: Mesh, *, show_tags: bool = True, path=None, title=None):
    """The mesh with its tagged boundary facets colored by marker: in 2D
    the triangulation and the facet segments, in 3D the boundary
    surface."""
    if mesh.tdim == 3:
        return _plot_mesh_3d(mesh, show_tags=show_tags, path=path, title=title)
    fig, ax = plt.subplots(figsize=(9, 6))
    ax.triplot(
        mesh.vertices[:, 0], mesh.vertices[:, 1], mesh.cells,
        lw=0.3, color="0.6",
    )
    if show_tags and mesh.facet_tags is not None:
        tagged = np.nonzero(mesh.facet_tags)[0]
        markers = mesh.facet_tags[tagged]
        cmap = plt.get_cmap("tab10")
        for m in np.unique(markers):
            fs = mesh.facets[tagged[markers == m]]
            segs = mesh.vertices[fs]
            for s in segs:
                ax.plot(s[:, 0], s[:, 1], color=cmap(int(m) % 10), lw=1.8)
            ax.plot([], [], color=cmap(int(m) % 10), label=f"marker {m}")
        ax.legend(loc="upper right", fontsize=8)
    ax.set_aspect("equal")
    ax.set_title(title or mesh.summary())
    return _finish(fig, path)


def _plot_mesh_3d(mesh: Mesh, *, show_tags: bool = True, path=None,
                  title=None):
    from mpl_toolkits.mplot3d.art3d import Poly3DCollection

    btris = mesh.facets[mesh.boundary_facets]
    fig = plt.figure(figsize=(9, 7))
    ax = fig.add_subplot(projection="3d")
    polys = Poly3DCollection(mesh.vertices[btris], linewidths=0.1,
                             edgecolors="0.4", alpha=1.0)
    tags = mesh.facet_tags
    if show_tags and tags is not None and np.any(tags):
        cmap = plt.get_cmap("tab10")
        fvals = tags[mesh.boundary_facets].astype(int)
        polys.set_facecolor(cmap(fvals % 10))
        for m in np.unique(fvals[fvals > 0]):
            ax.plot([], [], color=cmap(int(m) % 10), label=f"marker {m}")
        ax.legend(loc="upper right", fontsize=8)
    else:
        polys.set_facecolor("0.8")
    ax.add_collection3d(polys)
    lo, hi = mesh.vertices.min(axis=0), mesh.vertices.max(axis=0)
    ax.set_xlim(lo[0], hi[0]); ax.set_ylim(lo[1], hi[1]); ax.set_zlim(lo[2], hi[2])
    ax.set_box_aspect(hi - lo + 1e-12)
    ax.set_title(title or mesh.summary())
    return _finish(fig, path)


def spy(mat: CSRMatrix, *, path=None, title=None, markersize: float = 0.2):
    """Sparsity plot of a CSR matrix."""
    fig, ax = plt.subplots(figsize=(6, 6))
    s = mat.to_scipy().tocoo()
    ax.plot(s.col, s.row, ",", markersize=markersize)
    ax.invert_yaxis()
    ax.set_aspect("equal")
    ax.set_title(title or f"nnz = {s.nnz}")
    return _finish(fig, path)


def plot_mixed_function(
    w: np.ndarray,
    spaces: FunctionSpaces,
    mode: PlotMode = PlotMode.STATIC,
    *,
    scale: float = 1.0,
    title: str | None = None,
    path=None,
):
    """Velocity magnitude with streamlines, and the pressure, of a mixed
    (u, p) vector (its vertex values, the P1 interpolant of the P2
    field); in 3D the boundary surface colored by |u| with velocity
    glyphs inside."""
    mesh = spaces.velocity.mesh
    if mesh.tdim == 3:
        return _plot_mixed_function_3d(
            w, spaces, scale=scale, title=title, path=path)
    u, p = spaces.split(np.real(to_host(w)))
    nv = mesh.num_vertices
    tri = mtri.Triangulation(mesh.vertices[:, 0], mesh.vertices[:, 1], mesh.cells)
    fig, axes = plt.subplots(2, 1, figsize=(9, 8))
    tc = axes[0].tripcolor(tri, np.linalg.norm(u[:nv], axis=1), shading="gouraud")
    fig.colorbar(tc, ax=axes[0], label="|u|")
    # streamlines on a regular grid through the P1 (vertex) interpolant;
    # points outside the domain come back masked and break the lines
    try:
        gx = np.linspace(mesh.vertices[:, 0].min(), mesh.vertices[:, 0].max(), 120)
        gy = np.linspace(mesh.vertices[:, 1].min(), mesh.vertices[:, 1].max(), 80)
        GX, GY = np.meshgrid(gx, gy)
        iu = mtri.LinearTriInterpolator(tri, u[:nv, 0])
        iv = mtri.LinearTriInterpolator(tri, u[:nv, 1])
        U, V = iu(GX, GY), iv(GX, GY)
        axes[0].streamplot(GX, GY, U.filled(0.0), V.filled(0.0),
                           density=1.2, color="w", linewidth=0.5,
                           arrowsize=0.6)
    except Exception:  # degenerate fields: keep the magnitude plot
        step = max(1, nv // 1500)
        axes[0].quiver(
            mesh.vertices[::step, 0], mesh.vertices[::step, 1],
            u[:nv:step, 0], u[:nv:step, 1],
            scale=None if scale == 1.0 else 1.0 / scale, width=0.002,
        )
    axes[0].set_aspect("equal")
    axes[0].set_title(title or "velocity")
    pc = axes[1].tripcolor(tri, p[:nv] if p.size >= nv else np.resize(p, nv), shading="gouraud")
    fig.colorbar(pc, ax=axes[1], label="p")
    axes[1].set_aspect("equal")
    axes[1].set_title("pressure")
    return _finish(fig, path)


def _plot_mixed_function_3d(w, spaces, *, scale=1.0, title=None, path=None):
    from mpl_toolkits.mplot3d.art3d import Poly3DCollection

    mesh = spaces.velocity.mesh
    u, _ = spaces.split(np.real(to_host(w)))
    nv = mesh.num_vertices
    mag = np.linalg.norm(u[:nv], axis=1)
    btris = mesh.facets[mesh.boundary_facets]
    fig = plt.figure(figsize=(9, 7))
    ax = fig.add_subplot(projection="3d")
    polys = Poly3DCollection(mesh.vertices[btris], linewidths=0.05,
                             edgecolors="none", alpha=0.25)
    polys.set_array(mag[btris].mean(axis=1))
    ax.add_collection3d(polys)
    # interior velocity glyphs on a vertex subsample
    step = max(1, nv // 800)
    vs = mesh.vertices[::step]
    us = u[:nv:step]
    ax.quiver(vs[:, 0], vs[:, 1], vs[:, 2], us[:, 0], us[:, 1], us[:, 2],
              length=scale * 0.05 * float(np.linalg.norm(
                  mesh.vertices.max(0) - mesh.vertices.min(0))),
              normalize=True, linewidth=0.4, color="k")
    lo, hi = mesh.vertices.min(axis=0), mesh.vertices.max(axis=0)
    ax.set_xlim(lo[0], hi[0]); ax.set_ylim(lo[1], hi[1]); ax.set_zlim(lo[2], hi[2])
    ax.set_box_aspect(hi - lo + 1e-12)
    fig.colorbar(polys, ax=ax, label="|u|", shrink=0.7)
    ax.set_title(title or "velocity")
    return _finish(fig, path)


def plot_displacement(
    v: np.ndarray,
    space,
    *,
    scale: float = 1.0,
    part: str = "real",
    title: str | None = None,
    path=None,
):
    """Deformed mode shape of a vector field on ``space``: the deformed
    triangulation in 2D, the deformed boundary surface colored by |d| in
    3D."""
    mesh = space.mesh
    comp = {"real": np.real, "imag": np.imag, "abs": np.abs}[part]
    d = comp(to_host(v)).reshape(space.num_nodes, space.bs)
    nv = mesh.num_vertices
    if mesh.tdim == 2:
        coords = mesh.vertices[:, :2] + scale * d[:nv, :2]
        fig, ax = plt.subplots(figsize=(8, 6))
        ax.triplot(coords[:, 0], coords[:, 1], mesh.cells, lw=0.4)
        ax.set_aspect("equal")
    else:
        from mpl_toolkits.mplot3d.art3d import Poly3DCollection

        deformed = mesh.vertices + scale * d[:nv, : mesh.gdim]
        btris = mesh.facets[mesh.boundary_facets]
        mag = np.linalg.norm(d[:nv], axis=1)
        face_val = mag[btris].mean(axis=1)
        fig = plt.figure(figsize=(8, 6))
        ax = fig.add_subplot(projection="3d")
        polys = Poly3DCollection(
            deformed[btris], linewidths=0.1, edgecolors="k", alpha=1.0
        )
        polys.set_array(face_val)
        ax.add_collection3d(polys)
        lo, hi = deformed.min(axis=0), deformed.max(axis=0)
        ax.set_xlim(lo[0], hi[0])
        ax.set_ylim(lo[1], hi[1])
        ax.set_zlim(lo[2], hi[2])
        ax.set_box_aspect(hi - lo + 1e-12)
        fig.colorbar(polys, ax=ax, label="|d|", shrink=0.7)
    ax.set_title(title or f"mode shape ({part}, scale={scale:g})")
    return _finish(fig, path)


def plot_residuals(history, *, path=None, title: str | None = None):
    """Semilog residual history."""
    fig, ax = plt.subplots(figsize=(6, 4))
    history = to_host(history)
    ax.semilogy(np.arange(1, len(history) + 1), history, "o-")
    ax.set_xlabel("iteration")
    ax.set_ylabel("residual norm")
    ax.grid(True, which="both", alpha=0.3)
    ax.set_title(title or "convergence history")
    return _finish(fig, path)


def plot_pseudospectrum(
    re_pts, im_pts, norms, *, eigenvalues=None, path=None, title=None
):
    """Contour map of log10 ||R(z)||_E over the complex plane (the
    output of ``ResolventSolver.pseudospectrum``); level -log10(eps)
    bounds the eps-pseudospectrum.  Optional pencil eigenvalues are
    overlaid as markers."""
    re_pts = np.asarray(re_pts)
    im_pts = np.asarray(im_pts)
    G = np.log10(np.maximum(np.asarray(norms), 1e-300))
    fig, ax = plt.subplots(figsize=(6, 4.5))
    cs = ax.contour(re_pts, im_pts, G, levels=10, colors="tab:blue",
                    linewidths=0.8)
    ax.clabel(cs, fmt="%.1f", fontsize=7)
    ax.axvline(0.0, color="0.6", lw=0.8, ls="--")
    if eigenvalues is not None:
        ev = np.asarray(eigenvalues)
        ax.plot(ev.real, ev.imag, "rx", ms=6, label="eigenvalues")
        ax.legend(loc="best", fontsize=8)
    ax.set_xlabel("Re z")
    ax.set_ylabel("Im z")
    ax.set_title(title or r"$\log_{10}\,\|R(z)\|_E$")
    return _finish(fig, path)
