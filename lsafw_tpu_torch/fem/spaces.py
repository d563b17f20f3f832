"""Function spaces and dofmaps.

Counterpart of ``FEM/spaces.py`` (FunctionSpaces container,
``define_spaces:103``): spaces are plain index arrays mapping cells to
global DOFs.  Layout decisions made for the TPU:

  * vector DOFs are interleaved per node (node-major, component-minor),
    so a velocity vector at a node is a contiguous gather;
  * the mixed space is block-ordered: all velocity DOFs [0, nu) then
    all pressure DOFs [nu, nu+np).  This makes the constant-pressure
    nullspace, velocity-subspace projection and block extraction
    (``FEM/operators.py:534-562``) trivial slices instead of index sets.

Functions on a space are flat jnp/np arrays of length ``num_dofs``.
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import Enum
from functools import cached_property
from typing import Callable

import numpy as np

from lsafw_tpu_torch.fem.elements import ElementFamily, ReferenceElement, make_element
from lsafw_tpu_torch.meshing.mesh import CellType, Mesh


class FunctionSpaceType(Enum):
    """Velocity/pressure pairs (parity: ``FEM/spaces.py:62-100``)."""

    TAYLOR_HOOD = "taylor_hood"  # P2 / P1
    MINI = "mini"  # (P1 + bubble) / P1
    SIMPLE = "simple"  # P1 / P1 (not inf-sup stable)
    DG = "dg"  # unsupported, kept for parity

    @classmethod
    def from_string(cls, value: str) -> "FunctionSpaceType":
        return cls(value.lower().strip().replace(" ", "_"))


@dataclass(frozen=True, eq=False)
class FunctionSpace:
    """A (possibly blocked) Lagrange-type space over a mesh.

    ``cell_nodes`` maps cells to scalar node indices; blocked DOF ids
    are ``node * bs + component``.
    """

    mesh: Mesh
    element: ReferenceElement
    bs: int
    cell_nodes: np.ndarray  # (num_cells, ndofs_el) int32
    num_nodes: int
    node_coords: np.ndarray  # (num_nodes, gdim)

    @property
    def num_dofs(self) -> int:
        return self.num_nodes * self.bs

    @cached_property
    def cell_dofs(self) -> np.ndarray:
        """Blocked per-cell DOF map, (num_cells, ndofs_el * bs) int32."""
        if self.bs == 1:
            return self.cell_nodes
        comp = np.arange(self.bs, dtype=np.int32)
        return (self.cell_nodes[:, :, None] * self.bs + comp).reshape(
            self.cell_nodes.shape[0], -1
        )

    @cached_property
    def dof_coords(self) -> np.ndarray:
        """(num_dofs, gdim) coordinate of every DOF (repeated per component)."""
        return np.repeat(self.node_coords, self.bs, axis=0)

    def interpolate(self, fn: Callable[[np.ndarray], np.ndarray]) -> np.ndarray:
        """Nodal interpolation: ``fn`` maps (n, gdim) points to (n,) values
        (bs == 1) or (n, bs) values (parity: ``dfem.Function.interpolate``)."""
        vals = np.asarray(fn(self.node_coords), dtype=np.float64).reshape(
            self.num_nodes, self.bs
        )
        if self.element.family is ElementFamily.P1_BUBBLE:
            # enriched basis is not nodal at the centroid: the P1 part
            # already contributes mean(vertex values) there, so the
            # bubble coefficient is the residual
            cells = self.mesh.cells
            interior = self.num_nodes - self.mesh.num_cells + np.arange(self.mesh.num_cells)
            vals[interior] -= vals[cells].mean(axis=1)
        if self.bs == 1:
            return vals.reshape(self.num_nodes)
        return vals.ravel()

    def nodes_on_facets(self, facet_indices: np.ndarray) -> np.ndarray:
        """Scalar node ids supported on the given facets
        (parity: ``dfem.locate_dofs_topological``)."""
        mesh = self.mesh
        fverts = mesh.facets[facet_indices]
        nodes = [np.unique(fverts)]
        if self.element.num_edge_dofs:
            nv = mesh.num_vertices
            if mesh.tdim == 2:
                # facets are the edges
                nodes.append(nv + np.asarray(facet_indices, dtype=np.int64))
            else:
                edge_ids = _facet_edge_ids(mesh, facet_indices)
                nodes.append(nv + edge_ids)
        # interior (bubble) DOFs never sit on facets
        return np.unique(np.concatenate(nodes)).astype(np.int32)

    def dofs_on_facets(
        self, facet_indices: np.ndarray, component: int | None = None
    ) -> np.ndarray:
        """Blocked DOF ids on facets, optionally for a single component
        (component-pinning supports SYMMETRY BCs, ``FEM/bcs.py:178-182``)."""
        nodes = self.nodes_on_facets(facet_indices)
        if self.bs == 1:
            return nodes
        if component is None:
            comp = np.arange(self.bs, dtype=np.int64)
            return (nodes[:, None] * self.bs + comp).reshape(-1).astype(np.int32)
        return (nodes * self.bs + component).astype(np.int32)


def _facet_edge_ids(mesh: Mesh, facet_indices: np.ndarray) -> np.ndarray:
    """Global edge ids of all edges of the given (triangular) facets."""
    fverts = np.sort(mesh.facets[facet_indices], axis=1)  # (nf, 3)
    pairs = np.concatenate(
        [fverts[:, [0, 1]], fverts[:, [0, 2]], fverts[:, [1, 2]]], axis=0
    )
    edges = mesh.edges  # (ne, 2), lexicographically sorted rows
    # locate each pair by binary search over the sorted unique edge rows
    key = edges[:, 0].astype(np.int64) * (mesh.num_vertices + 1) + edges[:, 1]
    query = pairs[:, 0].astype(np.int64) * (mesh.num_vertices + 1) + pairs[:, 1]
    pos = np.searchsorted(key, query)
    if not (key[pos] == query).all():
        raise RuntimeError("Facet edge lookup failed (non-conforming mesh?).")
    return np.unique(pos)


# ---------------------------------------------------------------------------
# Space constructors
# ---------------------------------------------------------------------------


def make_scalar_space(mesh: Mesh, family: ElementFamily | str) -> FunctionSpace:
    """Build a scalar space of the given family over the mesh."""
    family = ElementFamily.from_string(family) if isinstance(family, str) else family
    elem = make_element(family, mesh.cell_type)
    nv = mesh.num_vertices
    parts = []
    coords = [mesh.vertices]
    num = nv
    if elem.num_vertex_dofs:
        parts.append(mesh.cells.astype(np.int64))
    if elem.num_edge_dofs:
        if mesh.cell_type is CellType.INTERVAL:
            # midpoint DOF per cell
            parts.append(nv + np.arange(mesh.num_cells, dtype=np.int64)[:, None])
            coords.append(mesh.vertices[mesh.cells].mean(axis=1))
            num += mesh.num_cells
        else:
            parts.append(num + mesh.cell_to_edges.astype(np.int64))
            coords.append(mesh.vertices[mesh.edges].mean(axis=1))
            num += mesh.edges.shape[0]
    if elem.num_interior_dofs:
        parts.append(num + np.arange(mesh.num_cells, dtype=np.int64)[:, None])
        coords.append(mesh.vertices[mesh.cells].mean(axis=1))
        num += mesh.num_cells
    cell_nodes = np.concatenate(parts, axis=1).astype(np.int32)
    if cell_nodes.shape[1] != elem.ndofs:
        raise AssertionError("dofmap width mismatch")
    return FunctionSpace(
        mesh=mesh,
        element=elem,
        bs=1,
        cell_nodes=cell_nodes,
        num_nodes=num,
        node_coords=np.concatenate(coords, axis=0),
    )


def make_vector_space(mesh: Mesh, family: ElementFamily | str, bs: int | None = None) -> FunctionSpace:
    s = make_scalar_space(mesh, family)
    return FunctionSpace(
        mesh=mesh,
        element=s.element,
        bs=bs or mesh.gdim,
        cell_nodes=s.cell_nodes,
        num_nodes=s.num_nodes,
        node_coords=s.node_coords,
    )


@dataclass(frozen=True, eq=False)
class FunctionSpaces:
    """Velocity/pressure/mixed container (parity: ``FEM/spaces.py:27-59``).

    The mixed space is implicit: velocity DOFs occupy [0, nu), pressure
    [nu, nu + np_).  ``mixed_cell_dofs`` concatenates per-cell velocity
    and (offset) pressure DOFs.
    """

    velocity: FunctionSpace
    pressure: FunctionSpace

    @property
    def num_velocity_dofs(self) -> int:
        return self.velocity.num_dofs

    @property
    def num_pressure_dofs(self) -> int:
        return self.pressure.num_dofs

    @property
    def num_dofs(self) -> int:
        return self.velocity.num_dofs + self.pressure.num_dofs

    @cached_property
    def dofs_u(self) -> np.ndarray:
        """Velocity DOF ids in the mixed layout (parity: sub(0).collapse())."""
        return np.arange(self.velocity.num_dofs, dtype=np.int32)

    @cached_property
    def dofs_p(self) -> np.ndarray:
        """Pressure DOF ids in the mixed layout (parity: sub(1).collapse())."""
        return self.velocity.num_dofs + np.arange(self.pressure.num_dofs, dtype=np.int32)

    @cached_property
    def mixed_cell_dofs(self) -> np.ndarray:
        """(num_cells, n_el_u + n_el_p) mixed-space per-cell DOF map."""
        return np.concatenate(
            [
                self.velocity.cell_dofs,
                self.velocity.num_dofs + self.pressure.cell_dofs,
            ],
            axis=1,
        ).astype(np.int32)

    @property
    def quad_degree(self) -> int:
        """Quadrature degree covering all linearized-NS terms exactly:
        convection u_b . grad(u) . v with P2 coefficients has total
        degree 2 + 1 + 2 = 5 on affine cells (the reference lets FFCx
        estimate this; ``FEM/spaces.py:38-43`` records max degree + 1)."""
        vdeg = self.velocity.element.degree
        pdeg = self.pressure.element.degree
        return max(2 * vdeg + max(vdeg - 1, 0), vdeg + pdeg, 2 * pdeg)

    def split(self, w: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Split a mixed vector into (velocity (nodes, bs), pressure (np,))."""
        w = np.asarray(w)
        u = w[: self.velocity.num_dofs].reshape(self.velocity.num_nodes, self.velocity.bs)
        p = w[self.velocity.num_dofs :]
        return u, p

    def combine(self, u: np.ndarray, p: np.ndarray) -> np.ndarray:
        return np.concatenate([np.asarray(u).ravel(), np.asarray(p).ravel()])


def define_spaces(
    mesh: Mesh, type: FunctionSpaceType | str = FunctionSpaceType.TAYLOR_HOOD
) -> FunctionSpaces:
    """Define velocity/pressure spaces (parity: ``FEM/spaces.py:103-179``)."""
    type = FunctionSpaceType.from_string(type) if isinstance(type, str) else type
    from lsafw_tpu_torch.meshing.mesh import CellType as _CT

    on_quads = mesh.cell_type is _CT.QUADRILATERAL
    if type is FunctionSpaceType.TAYLOR_HOOD:
        # tensor-product cells take the tensor Taylor-Hood pair Q2/Q1
        # (basix does the same per cell type in the reference)
        vel = make_vector_space(
            mesh, ElementFamily.Q2 if on_quads else ElementFamily.P2)
        pres = make_scalar_space(
            mesh, ElementFamily.Q1 if on_quads else ElementFamily.P1)
    elif type is FunctionSpaceType.MINI:
        vel = make_vector_space(mesh, ElementFamily.P1_BUBBLE)
        pres = make_scalar_space(mesh, ElementFamily.P1)
    elif type is FunctionSpaceType.SIMPLE:
        vel = make_vector_space(
            mesh, ElementFamily.Q1 if on_quads else ElementFamily.P1)
        pres = make_scalar_space(
            mesh, ElementFamily.Q1 if on_quads else ElementFamily.P1)
    elif type is FunctionSpaceType.DG:
        # mixed DG velocity/pressure is a stub in the reference too
        # (FEM/spaces.py)
        raise NotImplementedError("Mixed DG function spaces are not supported.")
    else:
        raise ValueError(type)
    return FunctionSpaces(velocity=vel, pressure=pres)
