"""XDMF / HDF5 mesh and field export.

Counterpart of the reference's ``io.xdmf``, in the same layout (the mesh
under ``mesh/topology`` and ``mesh/geometry``, fields under ``point/``
and ``cell/``), so that either package reads the other's files.  Output
opens in ParaView.  It runs on the host and imports ``h5py`` inside the
functions: nothing on the card's path needs it.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from lsafw_tpu_torch.meshing.mesh import CellType, Mesh

_XDMF_TOPOLOGY = {
    CellType.TRIANGLE: "Triangle",
    CellType.QUADRILATERAL: "Quadrilateral",
    CellType.TETRAHEDRON: "Tetrahedron",
    CellType.HEXAHEDRON: "Hexahedron",
    CellType.INTERVAL: "Polyline",
}

# XDMF's hexahedron (bottom quad counter-clockwise, then the top one) and
# quadrilateral orders, from box_mesh's binary (di, dj, dk) numbering
_CELL_PERMUTE = {
    CellType.HEXAHEDRON: [0, 4, 6, 2, 1, 5, 7, 3],
    CellType.QUADRILATERAL: [0, 1, 3, 2],
}


def write_xdmf(path: Path | str, mesh: Mesh, *, point_data: dict | None = None,
               cell_data: dict | None = None) -> Path:
    """Write ``path``.xdmf and ``path``.h5: the mesh and optional fields,
    ``point_data`` (num_vertices,) scalars or (num_vertices, k) vectors at
    the vertices and ``cell_data`` per-cell values (host arrays).  Returns
    the ``.xdmf`` path."""
    import h5py

    path = Path(path)
    if path.suffix == ".xdmf":
        path = path.with_suffix("")
    h5path, xdmfpath = path.with_suffix(".h5"), path.with_suffix(".xdmf")
    cells = mesh.cells
    perm = _CELL_PERMUTE.get(mesh.cell_type)
    if perm is not None:
        cells = cells[:, perm]
    verts = mesh.vertices
    geom_type = "XY" if verts.shape[1] == 2 else "XYZ"
    with h5py.File(h5path, "w") as h5:
        h5.create_dataset("mesh/topology", data=cells.astype(np.int64))
        h5.create_dataset("mesh/geometry", data=verts.astype(np.float64))
        for name, arr in (point_data or {}).items():
            h5.create_dataset(f"point/{name}", data=np.asarray(arr, dtype=np.float64))
        for name, arr in (cell_data or {}).items():
            h5.create_dataset(f"cell/{name}", data=np.asarray(arr))

    def attr(name: str, arr, center: str, group: str) -> str:
        arr = np.asarray(arr)
        if arr.ndim == 1:
            atype, dims = "Scalar", f"{arr.shape[0]}"
        else:
            atype = "Vector" if arr.shape[1] in (2, 3) else "Matrix"
            dims = f"{arr.shape[0]} {arr.shape[1]}"
        dtype = "Float" if np.issubdtype(arr.dtype, np.floating) else "Int"
        return (
            f'      <Attribute Name="{name}" AttributeType="{atype}" Center="{center}">\n'
            f'        <DataItem Dimensions="{dims}" NumberType="{dtype}" Format="HDF">'
            f"{h5path.name}:/{group}/{name}</DataItem>\n"
            f"      </Attribute>\n"
        )

    attrs = "".join(attr(n, a, "Node", "point") for n, a in (point_data or {}).items()) + \
        "".join(attr(n, a, "Cell", "cell") for n, a in (cell_data or {}).items())
    topo = _XDMF_TOPOLOGY[mesh.cell_type]
    xdmfpath.write_text(f"""<?xml version="1.0"?>
<Xdmf Version="3.0">
  <Domain>
    <Grid Name="mesh" GridType="Uniform">
      <Topology TopologyType="{topo}" NumberOfElements="{cells.shape[0]}">
        <DataItem Dimensions="{cells.shape[0]} {cells.shape[1]}" NumberType="Int" Format="HDF">{h5path.name}:/mesh/topology</DataItem>
      </Topology>
      <Geometry GeometryType="{geom_type}">
        <DataItem Dimensions="{verts.shape[0]} {verts.shape[1]}" Format="HDF">{h5path.name}:/mesh/geometry</DataItem>
      </Geometry>
{attrs}    </Grid>
  </Domain>
</Xdmf>
""")
    return xdmfpath


def read_xdmf(path: Path | str) -> tuple[Mesh, dict, dict]:
    """(mesh, point_data, cell_data) of a file :func:`write_xdmf` wrote."""
    import h5py

    with h5py.File(Path(path).with_suffix(".h5"), "r") as h5:
        cells = np.asarray(h5["mesh/topology"])
        verts = np.asarray(h5["mesh/geometry"])
        point_data = {k: np.asarray(v) for k, v in h5.get("point", {}).items()}
        cell_data = {k: np.asarray(v) for k, v in h5.get("cell", {}).items()}
    cell_type = {
        (3, 2): CellType.TRIANGLE,
        (4, 2): CellType.QUADRILATERAL,
        (4, 3): CellType.TETRAHEDRON,
        (8, 3): CellType.HEXAHEDRON,
    }[(cells.shape[1], verts.shape[1])]
    perm = _CELL_PERMUTE.get(cell_type)
    if perm is not None:
        cells = cells[:, np.argsort(perm)]
    return Mesh(verts, cells, cell_type), point_data, cell_data
