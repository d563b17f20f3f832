"""Build a CUDA source of the port into a shared library with ``nvcc``.

Each ``csrc/*.cu`` file has a plain C interface and is loaded with
ctypes.  It is compiled for ``sm_90a`` on first use into
``build/kernels/`` (keyed by the source's hash, so an edited source
builds anew), never when a module is imported.  ``BUILD_LOGS`` keeps
ptxas's ``-v`` report (registers, shared memory, spills) of each build
made by this process.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
BUILD_LOGS: dict[str, str] = {}


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def compile_library(src: Path, defines: tuple[str, ...] = ()) -> Path:
    """Compile ``src`` for sm_90a with the macros ``defines`` (``"NAME=value"``;
    once per source version and macros) and return the shared library's
    path; a failed build raises with nvcc's output."""
    code = src.read_bytes() + "\0".join(defines).encode()
    tag = "".join(f"_{d.replace('=', '')}" for d in defines)
    out = BUILD_DIR / f"lib{src.stem}{tag}_{hashlib.sha256(code).hexdigest()[:12]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [
        nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
        "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", *(f"-D{d}" for d in defines),
        "-o", tmp, str(src),
    ]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    BUILD_LOGS[src.name + "".join(f" -D{d}" for d in defines)] = proc.stderr
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed on {src.name} {' '.join(defines)}:\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def raise_on(err: int, what: str) -> None:
    """Raise if a kernel launch returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed with CUDA error {err}")


def stream() -> ctypes.c_void_p:
    """PyTorch's current CUDA stream, for a kernel launch."""
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
