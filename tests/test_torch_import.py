"""The PyTorch port stands alone: importing it loads neither JAX nor the
JAX package, no module of it imports them, and its entry points run on
the CPU only when asked to."""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import lsafw_tpu_torch
from lsafw_tpu_torch.fem.assembly import AssemblyContext
from lsafw_tpu_torch.fem.bcs import BoundaryConditions
from lsafw_tpu_torch.fem.spaces import define_spaces
from lsafw_tpu_torch.meshing.mesh import unit_square
from lsafw_tpu_torch.ops.sparse import CSRMatrix
from lsafw_tpu_torch.resolvent import ResolventSolver
from lsafw_tpu_torch.sensitivity import EigenSensitivitySolver
from lsafw_tpu_torch.solver.eigen import krylov_schur
from lsafw_tpu_torch.transient import TransientGrowthSolver

torch.set_num_threads(1)

PKG = Path(lsafw_tpu_torch.__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "lsafw_tpu")


def _forbidden(module: str) -> bool:
    """True for jax*, and for lsafw_tpu / lsafw_tpu.* (not lsafw_tpu_torch)."""
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


def test_forbidden_matches_exact_names():
    assert _forbidden("lsafw_tpu") and _forbidden("lsafw_tpu.solver.band")
    assert _forbidden("jax.numpy") and _forbidden("jaxlib")
    assert not _forbidden("lsafw_tpu_torch") and not _forbidden("lsafw_tpu_torch.solver")


def test_import_loads_no_jax_and_no_jax_package():
    """In a fresh interpreter (this process already holds jax)."""
    code = (
        "import sys, lsafw_tpu_torch, lsafw_tpu_torch.interop, lsafw_tpu_torch.solver.eigen, "
        "lsafw_tpu_torch.solver.baseflow, lsafw_tpu_torch.sensitivity, lsafw_tpu_torch.resolvent, "
        "lsafw_tpu_torch.transient, lsafw_tpu_torch.solver.eigen2, lsafw_tpu_torch.models.membrane\n"
        "print('\\n'.join(sorted(sys.modules)))"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=PKG.parent, check=True, timeout=120).stdout.split()
    assert "lsafw_tpu_torch.solver.band_cuda" in out
    assert {"lsafw_tpu_torch.solver.linear", "lsafw_tpu_torch.solver.precond"} <= set(out)
    assert [m for m in out if _forbidden(m)] == []


@pytest.mark.parametrize("path", sorted(p.relative_to(PKG).as_posix() for p in PKG.rglob("*.py")))
def test_no_module_imports_jax_or_the_jax_package(path):
    tree = ast.parse((PKG / path).read_text())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.append(node.module)
    assert [n for n in names if _forbidden(n)] == []


def test_default_device_entry_points_refuse_the_cpu(monkeypatch):
    """Without a usable GPU, the default device is an error, not the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lsafw_tpu_torch.resolve_device()
    spaces = define_spaces(unit_square(2))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        AssemblyContext.build(spaces)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        krylov_schur(lambda v: v, 8, nev=1, ncv=4)
    ctx = AssemblyContext.build(spaces, device="cpu")
    assert ctx.device == torch.device("cpu")
    res = krylov_schur(lambda v: torch.arange(1.0, 9.0, dtype=torch.float64) * v, 8, nev=1, ncv=6,
                       device="cpu")
    assert res.converged and abs(res.eigenvalues[0] - 8.0) < 1e-10
    assert np.isfinite(res.eigenvectors).all()


def test_sensitivity_refuses_the_cpu_by_default(monkeypatch):
    """``EigenSensitivitySolver`` defaults to the card: without one it
    raises unless ``device="cpu"`` is passed; the reference's host-LU
    ``si_method`` runs when asked for, and other methods raise."""
    spaces = define_spaces(unit_square(2))
    ctx = AssemblyContext.build(spaces, device="cpu")
    n = spaces.num_dofs
    bcs = BoundaryConditions(num_dofs=n, dirichlet_mask=np.zeros(n, bool),
                             dirichlet_values=np.zeros(n))
    args = (ctx, spaces.velocity.mesh, bcs, np.zeros(n), 10.0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        EigenSensitivitySolver(*args)
    with pytest.raises(NotImplementedError, match="banded"):
        EigenSensitivitySolver(*args, si_method="gmres", device="cpu")
    assert EigenSensitivitySolver(*args, si_method="lu", device="cpu")._si_method == "lu"
    solver = EigenSensitivitySolver(*args, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP item 11"):
        solver.solve_direct_mode()


def test_nonmodal_solvers_refuse_the_cpu_by_default(monkeypatch):
    """``ResolventSolver`` and ``TransientGrowthSolver`` default to the card
    and to the banded method: without a card they raise unless
    ``device="cpu"`` is passed."""
    spaces = define_spaces(unit_square(2))
    ctx = AssemblyContext.build(spaces, device="cpu")
    n = spaces.num_dofs
    A = ctx.pattern
    M = CSRMatrix(A, torch.ones(A.nnz, dtype=torch.float64))
    args = (M, M, spaces.num_velocity_dofs, np.zeros(n, bool))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cls in (ResolventSolver, TransientGrowthSolver):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cls(*args)
        assert cls(*args, device="cpu").method == "banded"
