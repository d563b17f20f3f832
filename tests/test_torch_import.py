"""The PyTorch port stands alone: importing it loads neither JAX nor the
JAX package, no module of it imports them, and its entry points run on
the CPU only when asked to."""

import ast
import functools
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
from lsafw_tpu_torch.floquet import FloquetSolver
from lsafw_tpu_torch.hill import hill_floquet
from lsafw_tpu_torch.ops.sparse import CSRMatrix
from lsafw_tpu_torch.resolvent import ResolventSolver
from lsafw_tpu_torch.scm import SelfConsistentModel, scm_continuation
from lsafw_tpu_torch.sensitivity import EigenSensitivitySolver
from lsafw_tpu_torch.models.navier_stokes import StationaryNavierStokesAssembler
from lsafw_tpu_torch.solver import eigen as teigen
from lsafw_tpu_torch.solver.eigen import (
    EigenSolver,
    EigensolverConfig,
    FactorUnusable,
    STType,
    krylov_schur,
)
from lsafw_tpu_torch.solver.newton import NewtonSolver
from lsafw_tpu_torch.solver.precond import make_preconditioner
from lsafw_tpu_torch.solver.timestepping import UnsteadySolver
from lsafw_tpu_torch.span import SpanwiseStability, spanwise_floquet
from lsafw_tpu_torch.transient import TransientGrowthSolver
from lsafw_tpu_torch.wnl import find_critical_re, weakly_nonlinear

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


@functools.cache
def _fresh_modules() -> list[str]:
    """``sys.modules`` of a fresh interpreter (this process already holds
    jax) that imported the port's entry modules, the command line and its
    I/O: one interpreter for both import tests below."""
    code = (
        "import sys, lsafw_tpu_torch, lsafw_tpu_torch.interop, lsafw_tpu_torch.solver.eigen, "
        "lsafw_tpu_torch.solver.baseflow, lsafw_tpu_torch.sensitivity, lsafw_tpu_torch.resolvent, "
        "lsafw_tpu_torch.transient, lsafw_tpu_torch.solver.eigen2, "
        "lsafw_tpu_torch.models.membrane, lsafw_tpu_torch.span, lsafw_tpu_torch.wnl, "
        "lsafw_tpu_torch.solver.timestepping, lsafw_tpu_torch.floquet, lsafw_tpu_torch.scm, "
        "lsafw_tpu_torch.hill, lsafw_tpu_torch.solver.ilu, lsafw_tpu_torch.solver.amg, "
        "lsafw_tpu_torch.solver.pmg, lsafw_tpu_torch.ops.stencil, lsafw_tpu_torch.ops.stencil_nd, "
        "lsafw_tpu_torch.ops.elementop, lsafw_tpu_torch.solver.power, "
        "lsafw_tpu_torch.solver.multigrid, lsafw_tpu_torch.solver.multigrid_nd, "
        "lsafw_tpu_torch.cli, lsafw_tpu_torch.io, lsafw_tpu_torch.meshing.io, "
        "lsafw_tpu_torch.utils.cache, lsafw_tpu_torch.utils.capture, lsafw_tpu_torch.diagnose, "
        "lsafw_tpu_torch.models, lsafw_tpu_torch.models.dg, lsafw_tpu_torch.meshing.adapt, "
        "lsafw_tpu_torch.parallel, lsafw_tpu_torch.solver.band_sharded\n"
        "print('\\n'.join(sorted(sys.modules)))"
    )
    return subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=PKG.parent, check=True, timeout=120).stdout.split()


def test_import_loads_no_jax_and_no_jax_package():
    """In a fresh interpreter (this process already holds jax)."""
    out = _fresh_modules()
    assert "lsafw_tpu_torch.solver.band_cuda" in out
    assert {"lsafw_tpu_torch.solver.linear", "lsafw_tpu_torch.solver.precond",
            "lsafw_tpu_torch.solver.ilu", "lsafw_tpu_torch.solver.amg",
            "lsafw_tpu_torch.solver.pmg", "lsafw_tpu_torch.ops.stencil",
            "lsafw_tpu_torch.ops.stencil_nd", "lsafw_tpu_torch.ops.elementop",
            "lsafw_tpu_torch.solver.power", "lsafw_tpu_torch.solver.multigrid",
            "lsafw_tpu_torch.solver.multigrid_nd"} <= set(out)
    assert [m for m in out if _forbidden(m)] == []


def test_cli_and_io_load_no_jax_nor_the_optional_libraries():
    """The command line and its I/O load no JAX, nothing of the JAX package,
    and neither matplotlib nor h5py (only ``--plot`` and ``.xdmf`` files
    import them, and the card's machine has neither), in a fresh
    interpreter (with the port's other entry modules)."""
    out = _fresh_modules()
    assert {"lsafw_tpu_torch.cli", "lsafw_tpu_torch.io", "lsafw_tpu_torch.meshing.io",
            "lsafw_tpu_torch.utils.cache", "lsafw_tpu_torch.utils.capture",
            "lsafw_tpu_torch.diagnose"} <= set(out)
    assert [m for m in out if _forbidden(m)] == []
    assert [m for m in out if m.split(".")[0] in ("matplotlib", "h5py")] == []


def test_tensor_cells_elasticity_dg_and_adapt_load_no_jax():
    """The elasticity model, SIPG DG, mesh adaptation and the periodic
    folds load no JAX and nothing of the JAX package, in a fresh
    interpreter (with the port's other entry modules)."""
    out = _fresh_modules()
    assert {"lsafw_tpu_torch.models.elasticity", "lsafw_tpu_torch.models.dg",
            "lsafw_tpu_torch.meshing.adapt", "lsafw_tpu_torch.fem.bcs"} <= set(out)
    assert [m for m in out if _forbidden(m)] == []


def test_parallel_loads_no_jax():
    """``import lsafw_tpu_torch.parallel`` (the scale-out layer, with the
    SPIKE solvers) loads no JAX and nothing of the JAX package, in a fresh
    interpreter (with the port's other entry modules)."""
    out = _fresh_modules()
    assert {"lsafw_tpu_torch.parallel", "lsafw_tpu_torch.parallel.launch",
            "lsafw_tpu_torch.parallel.partition", "lsafw_tpu_torch.parallel.sharded",
            "lsafw_tpu_torch.parallel.collectives",
            "lsafw_tpu_torch.solver.band_sharded"} <= set(out)
    assert [m for m in out if _forbidden(m)] == []


def test_parallel_refuses_the_cpu_by_default(monkeypatch, tmp_path):
    """The mesh and the process group default to the card and raise
    without one, before any group is joined."""
    import torch.distributed as dist

    from lsafw_tpu_torch.parallel import device_mesh, initialize_distributed

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        device_mesh()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        initialize_distributed(f"file://{tmp_path}/store", 1, 0)
    assert not dist.is_initialized()


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


def test_tensor_cells_elasticity_and_dg_refuse_the_cpu_by_default(monkeypatch):
    """A hex space's context, the elasticity assembler, SIPG DG and the
    band plan's host entry default to the card: without one they raise
    unless ``device="cpu"`` is passed."""
    import scipy.sparse as sp

    from lsafw_tpu_torch.fem.assembly import SpaceContext
    from lsafw_tpu_torch.fem.spaces import make_vector_space
    from lsafw_tpu_torch.meshing.mesh import CellType, box_mesh
    from lsafw_tpu_torch.models import ElasticityEigenAssembler
    from lsafw_tpu_torch.models.dg import assemble_dg_poisson
    from lsafw_tpu_torch.solver.band import BandedLU, PivotedBandedLU

    space = make_vector_space(box_mesh((0, 0, 0), (1, 1, 1), 1, 1, 1, CellType.HEXAHEDRON), "q1")
    C = sp.identity(4, dtype=np.complex128, format="csr") * (2 + 1j)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: SpaceContext.build(space),
                 lambda: ElasticityEigenAssembler(space, young_modulus=1.0, poisson_ratio=0.3,
                                                  density=1.0),
                 lambda: assemble_dg_poisson(unit_square(2)),
                 lambda: BandedLU.from_complex_csr(C, nb=4, chunk=1),
                 lambda: PivotedBandedLU.from_complex_csr(C, nb=4, chunk=1)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    K = ElasticityEigenAssembler(space, young_modulus=1.0, poisson_ratio=0.3, density=1.0,
                                 device="cpu").assemble_stiffness()
    assert K.device == torch.device("cpu")
    x = BandedLU.from_complex_csr(C, nb=4, chunk=1, device="cpu").solve(
        torch.ones(4, dtype=torch.complex128))
    assert torch.allclose(x, torch.full((4,), 1 / (2 + 1j), dtype=torch.complex128))


def test_sensitivity_refuses_the_cpu_by_default(monkeypatch):
    """``EigenSensitivitySolver`` defaults to the card: without one it
    raises unless ``device="cpu"`` is passed; the reference's host-LU
    ``si_method`` runs when asked for, the inexact ``"gmres"`` is taken,
    other methods raise; without a target the direct mode takes SHIFT,
    which on this Navier-Stokes pencil (M zero on the pressure block)
    raises ``FactorUnusable`` naming the singular M."""
    spaces = define_spaces(unit_square(2))
    ctx = AssemblyContext.build(spaces, device="cpu")
    n = spaces.num_dofs
    bcs = BoundaryConditions(num_dofs=n, dirichlet_mask=np.zeros(n, bool),
                             dirichlet_values=np.zeros(n))
    args = (ctx, spaces.velocity.mesh, bcs, np.zeros(n), 10.0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        EigenSensitivitySolver(*args)
    assert EigenSensitivitySolver(*args, si_method="gmres", device="cpu")._si_method == "gmres"
    with pytest.raises(NotImplementedError, match="banded"):
        EigenSensitivitySolver(*args, si_method="arnoldi", device="cpu")
    assert EigenSensitivitySolver(*args, si_method="lu", device="cpu")._si_method == "lu"
    solver = EigenSensitivitySolver(*args, device="cpu")
    with pytest.raises(FactorUnusable, match="M is singular"):
        solver.solve_direct_mode()


def test_krylov_newton_and_transforms_are_taken(monkeypatch):
    """The Krylov ``linear_solver`` names of the Newton solver and the
    SHIFT, SHELL, FILTER and PRECOND transforms run; an unknown solver or
    PC name raises.  Host LU stays off: SHIFT's M^-1 is a band factor."""
    spaces = define_spaces(unit_square(2))
    ctx = AssemblyContext.build(spaces, device="cpu")
    n = spaces.num_dofs
    bcs = BoundaryConditions(num_dofs=n, dirichlet_mask=np.zeros(n, bool),
                             dirichlet_values=np.zeros(n))
    asm = StationaryNavierStokesAssembler(ctx, spaces.velocity.mesh, bcs)
    for name in ("gmres", "bcgs", "fgmres"):
        assert NewtonSolver(asm, linear_solver=name)._linear_solver == name
    with pytest.raises(ValueError):
        NewtonSolver(asm, linear_solver="cholmod")
    with pytest.raises(ValueError):
        make_preconditioner(CSRMatrix(ctx.pattern, torch.ones(ctx.pattern.nnz,
                                                              dtype=torch.float64)), "mumps")
    monkeypatch.setattr(teigen, "SparseLU", None)
    d = np.arange(1.0, 9.0)
    A = _diag(d)
    M = CSRMatrix(A.pattern, torch.full((8,), 2.0, dtype=torch.float64))
    for st in (STType.SHIFT, STType.SHELL, STType.FILTER, STType.PRECOND):
        es = EigenSolver(A, None if st is STType.FILTER else M,
                         EigensolverConfig(num_eig=1, atol=1e-10, ncv=6))
        es.set_st_type(st)
        if st is STType.SHELL:
            es.set_st_shell(lambda v: A.data[:8] * v)
        if st is STType.FILTER:
            es.set_target(2.5)
            es.set_filter_degree(20)
        if st is STType.PRECOND:
            es.set_target(4.2)
        lam = es.solve()[0][0]
        want = {STType.SHIFT: 4.0, STType.SHELL: 8.0, STType.FILTER: 1.0,
                STType.PRECOND: 4.0}[st]
        assert abs(lam - want) < 1e-8, (st, lam)
    with pytest.raises(ValueError, match="SHELL requires"):
        es = EigenSolver(A, M)
        es.set_st_type(STType.SHELL)
        es.solve()


def _diag(d) -> CSRMatrix:
    n = len(d)
    from lsafw_tpu_torch.interop import csr_from_numpy

    return csr_from_numpy(np.arange(n + 1), np.arange(n), d, (n, n), device="cpu")


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


def test_span_and_wnl_refuse_the_cpu_by_default(monkeypatch):
    """``SpanwiseStability``, ``weakly_nonlinear``, ``find_critical_re``,
    ``UnsteadySolver``, ``FloquetSolver`` (both constructors) and
    ``spanwise_floquet`` default to the card: without one they raise
    unless ``device="cpu"`` is passed."""
    spaces = define_spaces(unit_square(2))
    ctx = AssemblyContext.build(spaces, device="cpu")
    mesh = spaces.velocity.mesh
    n = spaces.num_dofs
    bcs = BoundaryConditions(num_dofs=n, dirichlet_mask=np.zeros(n, bool),
                             dirichlet_values=np.zeros(n))
    snaps = np.zeros((2, n))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SpanwiseStability(ctx, np.zeros(n), 10.0, bcs, mesh)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        weakly_nonlinear(ctx, mesh, bcs, bcs, 10.0, np.zeros(n))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        find_critical_re(ctx, mesh, bcs, bcs, 40.0, 50.0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        UnsteadySolver(ctx, mesh, bcs, 10.0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FloquetSolver(ctx, mesh, bcs, 10.0, snaps, 0.1)
    span = SpanwiseStability(ctx, np.zeros(n), 10.0, bcs, mesh, device="cpu")
    assert span.num_dofs == n + spaces.num_velocity_dofs // 2
    Md = torch.zeros(span.pattern.nnz, dtype=torch.float64)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FloquetSolver.from_operator_data(span.pattern, Md, [Md, Md], np.zeros(span.num_dofs), 0.1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        spanwise_floquet(span, snaps, 0.1, 1.0)
    assert UnsteadySolver(ctx, mesh, bcs, 10.0, device="cpu").method == "banded"


def test_scm_and_hill_refuse_the_cpu_by_default(monkeypatch):
    """``SelfConsistentModel`` (so ``scm_continuation``) and ``hill_floquet``
    default to the card: without one they raise unless ``device="cpu"`` is
    passed; the model's solvers default to ``"banded"``, and Hill's method
    takes ``"banded"`` or the host ``"lu"`` alone."""
    spaces = define_spaces(unit_square(2))
    ctx = AssemblyContext.build(spaces, device="cpu")
    mesh = spaces.velocity.mesh
    n = spaces.num_dofs
    bcs = BoundaryConditions(num_dofs=n, dirichlet_mask=np.zeros(n, bool),
                             dirichlet_values=np.zeros(n))
    M = CSRMatrix(ctx.pattern, torch.ones(ctx.pattern.nnz, dtype=torch.float64))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SelfConsistentModel(ctx, mesh, bcs, bcs, 10.0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        scm_continuation(ctx, mesh, bcs, bcs, [10.0], lambda re: np.zeros(n))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        hill_floquet(ctx, M, M, [np.zeros(n)], 1.0)
    with pytest.raises(NotImplementedError, match="gmres"):
        hill_floquet(ctx, M, M, [np.zeros(n)], 1.0, method="gmres", device="cpu")
    model = SelfConsistentModel(ctx, mesh, bcs, bcs, 10.0, mass=M, device="cpu")
    assert model.linear_solver == model.si_method == "banded"


def test_structured_constructors_refuse_the_cpu_by_default(monkeypatch):
    """The functions that make device state from numpy (the stencil
    operators from numpy CSR data, ``ell_of_csr``) default to the card:
    without one they raise unless ``device="cpu"`` is passed; given
    tensors they follow the tensors' device."""
    from lsafw_tpu_torch.fem.spaces import make_scalar_space
    from lsafw_tpu_torch.meshing.mesh import rectangle_mesh, unit_cube
    from lsafw_tpu_torch.models.membrane import assemble_membrane_evp
    from lsafw_tpu_torch.ops.stencil import build_stencil_operator
    from lsafw_tpu_torch.ops.stencil_nd import build_stencil_nd
    import scipy.sparse as sp

    mesh, mesh3 = rectangle_mesh((0.0, 0.0), (1.0, 1.0), 2, 2), unit_cube(1)
    (K, _, _), (K3, _, _) = (assemble_membrane_evp(m, device="cpu") for m in (mesh, mesh3))
    blocks = [(make_scalar_space(mesh, "p2"), 1)]
    blocks3 = [(make_scalar_space(mesh3, "p2"), 1)]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_stencil_operator(K.pattern, K.data.numpy(), blocks)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_stencil_nd(K3.pattern, K3.data.numpy(), blocks3)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        teigen.ell_of_csr(sp.identity(3, format="csr"))
    assert build_stencil_operator(K.pattern, K.data.numpy(), blocks,
                                  device="cpu").coeffs.device.type == "cpu"
    assert build_stencil_nd(K3.pattern, K3.data, blocks3).coeffs.device.type == "cpu"
    assert teigen.ell_of_csr(sp.identity(3, format="csr"), device="cpu")[0].device.type == "cpu"
