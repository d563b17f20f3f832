"""Mesh file import and export.

Counterpart of the reference's ``meshing.io``: a parser and writer of
gmsh's ASCII MSH format (read: v2.2 and v4.1; write: v2.2, with the
tagged boundary facets as lower-dimensional physical elements), the
``.xdmf`` files of :mod:`lsafw_tpu_torch.io.xdmf`, and the ``.npz``
container of :mod:`lsafw_tpu_torch.utils.cache`.  Host numpy only.
Vertices are written with 16 significant digits (``%.16g``, the
reference's format): a coordinate reads back within 6.2e-16 of itself,
relative; cells and facet tags read back exactly.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from lsafw_tpu_torch.meshing.mesh import CellType, Mesh
from lsafw_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

# gmsh element type id -> (CellType, nodes)
_GMSH_TYPES = {
    1: (CellType.INTERVAL, 2),
    2: (CellType.TRIANGLE, 3),
    3: (CellType.QUADRILATERAL, 4),
    4: (CellType.TETRAHEDRON, 4),
    5: (CellType.HEXAHEDRON, 8),
}
_TO_GMSH = {v[0]: k for k, v in _GMSH_TYPES.items()}


def read_msh(path: Path | str) -> Mesh:
    """Read a gmsh ASCII .msh file (v2.2 or v4.1), keeping the
    highest-dimensional cell block and facet physical tags when present.

    Raises ``ValueError`` with the file name and a parse-stage hint on
    malformed input (binary .msh, truncated sections, unknown element
    types) instead of a bare index/unpack error."""
    try:
        text = Path(path).read_text()
    except UnicodeDecodeError as exc:
        raise ValueError(
            f"{path}: binary .msh files are not supported — re-export "
            "with gmsh's ASCII format (`gmsh -format msh2` / save-ascii)."
        ) from exc
    lines = text.splitlines()
    try:
        return _read_msh_lines(path, lines)
    except (IndexError, KeyError, ValueError) as exc:
        if isinstance(exc, ValueError) and str(exc).startswith(str(path)):
            raise
        raise ValueError(
            f"{path}: malformed .msh content ({type(exc).__name__}: {exc}) — "
            "supported formats are ASCII v2.2 and v4.1 with simplex/"
            "tensor cells."
        ) from exc


def _read_msh_lines(path, lines) -> Mesh:
    it = iter(enumerate(lines))
    version = None
    nodes: dict[int, np.ndarray] = {}
    elements: list[tuple[int, int, list[int]]] = []  # (gmsh_type, phys_tag, node_ids)

    i = 0
    while i < len(lines):
        line = lines[i].strip()
        if line == "$MeshFormat":
            version = float(lines[i + 1].split()[0])
            i += 1
        elif line == "$Nodes":
            if version and version >= 4.0:
                i = _read_nodes_v4(lines, i + 1, nodes)
            else:
                i = _read_nodes_v2(lines, i + 1, nodes)
        elif line == "$Elements":
            if version and version >= 4.0:
                i = _read_elements_v4(lines, i + 1, elements)
            else:
                i = _read_elements_v2(lines, i + 1, elements)
        i += 1

    if not nodes or not elements:
        raise ValueError(f"No mesh data found in {path}")
    # keep the highest-dimensional block as cells, one lower as tagged facets
    dims = {t: _GMSH_TYPES[t][0].dim for t, _, _ in elements if t in _GMSH_TYPES}
    top = max(dims.values())
    cell_types = {t for t in dims if dims[t] == top}
    if len(cell_types) != 1:
        raise ValueError("Mixed top-dimension cell types are not supported.")
    gmsh_t = cell_types.pop()
    cell_type = _GMSH_TYPES[gmsh_t][0]

    node_ids = sorted(nodes)
    remap = {nid: k for k, nid in enumerate(node_ids)}
    gdim = 3 if any(abs(nodes[n][2]) > 1e-12 for n in node_ids) else cell_type.dim
    verts = np.array([nodes[n][:gdim] for n in node_ids])

    cells = np.array(
        [[remap[n] for n in conn] for t, _, conn in elements if t == gmsh_t],
        dtype=np.int32,
    )
    mesh = Mesh(verts, cells, cell_type)

    # facet tags from (top-1)-dimensional physical groups
    facet_elems = [
        (tag, sorted(remap[n] for n in conn))
        for t, tag, conn in elements
        if t in _GMSH_TYPES and _GMSH_TYPES[t][0].dim == top - 1 and tag != 0
    ]
    if facet_elems:
        key = {tuple(f): k for k, f in enumerate(np.sort(mesh.facets, axis=1).tolist())}
        tags = np.zeros(mesh.facets.shape[0], dtype=np.int32)
        for tag, conn in facet_elems:
            k = key.get(tuple(conn))
            if k is not None:
                tags[k] = tag
        mesh.facet_tags = tags
    logger.info("Imported %s: %s", path, mesh.summary())
    return mesh


def _read_nodes_v2(lines, i, nodes):
    n = int(lines[i])
    for k in range(1, n + 1):
        parts = lines[i + k].split()
        nodes[int(parts[0])] = np.array([float(x) for x in parts[1:4]])
    return i + n


def _read_nodes_v4(lines, i, nodes):
    counts = lines[i].split()
    num_blocks = int(counts[0])
    i += 1
    for _ in range(num_blocks):
        _, _, parametric, num = lines[i].split()
        num = int(num)
        ids = [int(lines[i + 1 + k]) for k in range(num)]
        for k in range(num):
            parts = lines[i + 1 + num + k].split()
            nodes[ids[k]] = np.array([float(x) for x in parts[:3]])
        i += 1 + 2 * num
    return i - 1


def _read_elements_v2(lines, i, elements):
    n = int(lines[i])
    for k in range(1, n + 1):
        parts = [int(x) for x in lines[i + k].split()]
        etype = parts[1]
        ntags = parts[2]
        phys = parts[3] if ntags >= 1 else 0
        conn = parts[3 + ntags :]
        elements.append((etype, phys, conn))
    return i + n


def _read_elements_v4(lines, i, elements):
    counts = lines[i].split()
    num_blocks = int(counts[0])
    i += 1
    for _ in range(num_blocks):
        _, ent_tag, etype, num = (int(x) for x in lines[i].split())
        for k in range(num):
            parts = [int(x) for x in lines[i + 1 + k].split()]
            elements.append((etype, ent_tag, parts[1:]))
        i += 1 + num
    return i - 1


def write_msh(mesh: Mesh, path: Path | str) -> None:
    """Write a gmsh v2.2 ASCII .msh with the tagged boundary facets as
    lower-dimensional physical elements."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    out = ["$MeshFormat", "2.2 0 8", "$EndMeshFormat", "$Nodes", str(mesh.num_vertices)]
    for k, v in enumerate(mesh.vertices, start=1):
        coords = list(v) + [0.0] * (3 - mesh.gdim)
        out.append(f"{k} {coords[0]:.16g} {coords[1]:.16g} {coords[2]:.16g}")
    out += ["$EndNodes", "$Elements"]
    facet_rows = []
    if mesh.facet_tags is not None:
        ft = _TO_GMSH[mesh.cell_type.facet_type]
        tagged = np.nonzero(mesh.facet_tags)[0]
        for f in tagged:
            conn = " ".join(str(v + 1) for v in mesh.facets[f])
            facet_rows.append((ft, int(mesh.facet_tags[f]), conn))
    ct = _TO_GMSH[mesh.cell_type]
    ne = len(facet_rows) + mesh.num_cells
    out.append(str(ne))
    eid = 1
    for ft, tag, conn in facet_rows:
        out.append(f"{eid} {ft} 2 {tag} {tag} {conn}")
        eid += 1
    for c in mesh.cells:
        conn = " ".join(str(v + 1) for v in c)
        out.append(f"{eid} {ct} 2 0 0 {conn}")
        eid += 1
    out += ["$EndElements", ""]
    path.write_text("\n".join(out))
    logger.info("Exported mesh to %s", path)


def from_file(path: Path | str) -> Mesh:
    """Import a mesh by extension: ``.msh``, ``.xdmf`` or the ``.npz``
    container of :class:`~lsafw_tpu_torch.utils.cache.CacheStore`."""
    path = Path(path)
    if path.suffix == ".msh":
        return read_msh(path)
    if path.suffix == ".xdmf":
        from lsafw_tpu_torch.io.xdmf import read_xdmf

        mesh, _, _ = read_xdmf(path)
        return mesh
    if path.suffix == ".npz":
        z = np.load(path, allow_pickle=False)
        mesh = Mesh(z["vertices"], z["cells"], CellType(str(z["cell_type"])))
        if "facet_tags" in z:
            mesh.facet_tags = z["facet_tags"]
        return mesh
    raise ValueError(f"Unsupported mesh format: {path.suffix}")
