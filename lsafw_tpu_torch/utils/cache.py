"""SHA-256-keyed disk cache of meshes, arrays and CSR matrices.

Counterpart of the reference's ``utils.cache.CacheStore``, with the same
file names (``<kind>_<hash>.npz``, the key's SHA-256 cut to 32 hex
digits) and the same ``.npz`` keys, so that either package reads the
other's cache.  Meshes and arrays come back as host numpy; a matrix
comes back on the caller's device.
"""

from __future__ import annotations

import hashlib
from pathlib import Path

import numpy as np
import scipy.sparse as sp

from lsafw_tpu_torch import resolve_device
from lsafw_tpu_torch.io import to_host
from lsafw_tpu_torch.meshing.mesh import CellType, Mesh
from lsafw_tpu_torch.ops.sparse import CSRMatrix
from lsafw_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


def _hash(key: str) -> str:
    return hashlib.sha256(key.encode()).hexdigest()[:32]


class CacheStore:
    """Artifacts under ``root``, one compressed ``.npz`` each."""

    def __init__(self, root: Path | str) -> None:
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)

    def _path(self, kind: str, key: str) -> Path:
        return self.root / f"{kind}_{_hash(key)}.npz"

    def save_mesh(self, key: str, mesh: Mesh) -> None:
        data = dict(vertices=mesh.vertices, cells=mesh.cells,
                    cell_type=np.array(mesh.cell_type.value))
        if mesh.facet_tags is not None:
            data["facet_tags"] = mesh.facet_tags
        if mesh.cell_tags is not None:
            data["cell_tags"] = mesh.cell_tags
        np.savez_compressed(self._path("mesh", key), **data)
        logger.debug("Cached mesh under %s", key)

    def load_mesh(self, key: str) -> Mesh | None:
        p = self._path("mesh", key)
        if not p.exists():
            return None
        z = np.load(p, allow_pickle=False)
        mesh = Mesh(vertices=z["vertices"], cells=z["cells"],
                    cell_type=CellType(str(z["cell_type"])))
        if "facet_tags" in z:
            mesh.facet_tags = z["facet_tags"]
        if "cell_tags" in z:
            mesh.cell_tags = z["cell_tags"]
        return mesh

    def save_array(self, key: str, arr) -> None:
        """An array, or a tensor copied to the host."""
        np.savez_compressed(self._path("fn", key), data=to_host(arr))
        logger.debug("Cached array under %s", key)

    def load_array(self, key: str) -> np.ndarray | None:
        p = self._path("fn", key)
        if not p.exists():
            return None
        return np.load(p, allow_pickle=False)["data"]

    def save_matrix(self, key: str, mat: CSRMatrix) -> None:
        np.savez_compressed(self._path("mat", key), data=to_host(mat.data),
                            indices=mat.pattern.indices, indptr=mat.pattern.indptr,
                            shape=np.asarray(mat.shape))
        logger.debug("Cached matrix under %s", key)

    def load_matrix(self, key: str, *, device="cuda") -> CSRMatrix | None:
        """The cached matrix on a pattern of its own, its data on ``device``."""
        device = resolve_device(device)
        p = self._path("mat", key)
        if not p.exists():
            return None
        z = np.load(p, allow_pickle=False)
        m = sp.csr_matrix((z["data"], z["indices"], z["indptr"]), shape=tuple(z["shape"]))
        return CSRMatrix.from_scipy(m, device=device)
