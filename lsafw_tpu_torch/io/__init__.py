"""Artifact I/O: mixed-function export and load, MatrixMarket matrices,
eigenvector export.

Counterpart of the reference's ``io`` module, in the same file formats,
so that a file written by either package reads back in the other: a
mixed (u, p) vector as ``<name>_npz.npz`` (real and imaginary parts of
its velocity and pressure DOFs beside the DOF maps), a matrix as a
MatrixMarket ``.mtx`` coordinate file, an eigenvector as an ``.npz`` of
its real and imaginary parts.  Arrays are written from the host; loaded
arrays go to the caller's device (``"cuda"`` unless ``device="cpu"``).

``export_matrix`` writes every stored entry, explicit zeros included, in
the ``general`` symmetry at 17 significant digits: scipy's symmetry
detection would write a structurally unsymmetric pattern whose values
look symmetric (explicit zeros) as its lower triangle and read it back
on another pattern, and fewer digits would not give the values back
bit for bit.  So A.mtx and M.mtx of one assembly read back on one
structure.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import scipy.io as sio
import scipy.sparse as sp
import torch

from lsafw_tpu_torch import resolve_device
from lsafw_tpu_torch.fem.spaces import FunctionSpaces
from lsafw_tpu_torch.ops.sparse import CSRMatrix
from lsafw_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


def to_host(v) -> np.ndarray:
    """An array or tensor as a host numpy array."""
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def export_function(w, spaces: FunctionSpaces, output_folder: Path | str, *,
                    name: str = "baseflow") -> None:
    """Write a mixed (u, p) vector, real or complex, with its subspace DOF
    maps as ``<output_folder>/<name>_npz.npz``."""
    out = Path(output_folder)
    out.mkdir(parents=True, exist_ok=True)
    w = to_host(w)
    np.savez(
        out / f"{name}_npz.npz",
        u=np.real(w[spaces.dofs_u]),
        p=np.real(w[spaces.dofs_p]),
        u_imag=np.imag(w[spaces.dofs_u]),
        p_imag=np.imag(w[spaces.dofs_p]),
        dofs_u=spaces.dofs_u,
        dofs_p=spaces.dofs_p,
    )
    logger.info("Function '%s' exported to '%s'", name, out)


def load_function(input_folder: Path | str, spaces: FunctionSpaces, *, name: str = "baseflow",
                  device="cuda") -> torch.Tensor:
    """The vector :func:`export_function` wrote, on ``device``: f64, or
    complex128 where its imaginary part is nonzero."""
    device = resolve_device(device)
    folder = Path(input_folder)
    if not folder.is_dir():
        raise ValueError(f"Input path {str(folder)!r} is not a valid folder.")
    z = np.load(folder / f"{name}_npz.npz", allow_pickle=False)
    has_imag = "u_imag" in z and (np.abs(z["u_imag"]).max() > 0 or np.abs(z["p_imag"]).max() > 0)
    w = np.zeros(spaces.num_dofs, dtype=np.complex128 if has_imag else np.float64)
    w[z["dofs_u"]] = z["u"] + (1j * z["u_imag"] if has_imag else 0.0)
    w[z["dofs_p"]] = z["p"] + (1j * z["p_imag"] if has_imag else 0.0)
    logger.info("Function '%s' loaded from '%s'", name, folder)
    return torch.as_tensor(w, device=device)


def export_matrix(mat: CSRMatrix, path: Path | str) -> None:
    """MatrixMarket export of every stored entry (the reference's
    real-to-complex hand-off format)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    sio.mmwrite(str(path), mat.to_scipy().tocoo(), symmetry="general", precision=17)
    logger.info("Matrix exported to '%s'", path)


def import_matrix(path: Path | str, *, device="cuda") -> CSRMatrix:
    """A ``.mtx`` matrix on a pattern of its own, its data on ``device``."""
    device = resolve_device(device)
    return CSRMatrix.from_scipy(sp.csr_matrix(sio.mmread(str(path))), device=device)


def export_eigenvector(vec, path: Path | str) -> None:
    """An eigenvector as ``.npz`` of its real and imaginary parts."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    vec = to_host(vec)
    np.savez(path, re=np.real(vec), im=np.imag(vec))


def import_eigenvector(path: Path | str, *, device="cuda") -> torch.Tensor:
    """An eigenvector :func:`export_eigenvector` wrote, as complex128 on
    ``device``."""
    device = resolve_device(device)
    z = np.load(Path(path), allow_pickle=False)
    return torch.as_tensor(z["re"] + 1j * z["im"], device=device)
