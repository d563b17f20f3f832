"""The port's command line and its I/O (``lsafw_tpu_torch.cli``, ``io``,
``io.xdmf``, ``meshing.io``, ``utils.cache``, ``utils.capture``) against
the JAX package's, on the CPU (``--platform cpu``).

The case is the reference tests' (``tests/unit/test_cli_solvers.py``):
the 6 x 6 unit square, an inlet at x = 0, a pressure outlet at x = 1,
walls elsewhere, Re = 20 (387 Taylor-Hood DOFs).  Each package's CLI runs
``assemble`` (its baseflow, A.mtx, M.mtx) once, in a module fixture, then
``eigen`` at -0.5+0.5j on the JAX package's A.mtx and M.mtx (the JAX side
on its host LU, the port on its band factor, nb = 32 through
``LSAFW_BAND_NB``, unpadded): the baseflows agree to rel 1e-10, (A, M) in
structure exactly and in values to rel 1e-12, sigma to 1e-8, and each
package reads the other's ``.npz``, ``.mtx``, ``.msh``, ``.xdmf`` and
cache files to the same values.

The shift-invert on A and M read from two files (two pattern objects of
one structure: the port's ``eigen`` above), on an M whose explicit zeros
were pruned (another pattern: the union), and on M = None at a complex
shift (the pencil (A, I)): sigma within 1e-8 of the JAX package's on the
same matrices.
The banded Newton miss inside a self-consistent-model trial fails that
trial (the ladder's next rung runs) and still raises in ``NewtonSolver``.
The other subcommands are checked as the reference's tests check them.
"""

import json
import logging
import os

import numpy as np
import pytest
import scipy.io as sio
import scipy.sparse as sp
import torch

from lsafw_tpu import cli as jcli
from lsafw_tpu import io as jio
from lsafw_tpu.fem.spaces import define_spaces as jdefine_spaces
from lsafw_tpu.io.xdmf import read_xdmf as jread_xdmf
from lsafw_tpu.meshing.io import read_msh as jread_msh
from lsafw_tpu.meshing.mesh import unit_square as junit_square
from lsafw_tpu.ops.sparse import CSRMatrix as JCSRMatrix
from lsafw_tpu.solver.eigen import EigenSolver as JEigenSolver
from lsafw_tpu.solver.eigen import EigensolverConfig as JConfig
from lsafw_tpu.utils.cache import CacheStore as JCacheStore
from lsafw_tpu_torch import cli, io as tio
from lsafw_tpu_torch.config import BoundaryConditionsConfig
from lsafw_tpu_torch.fem.assembly import AssemblyContext
from lsafw_tpu_torch.fem.bcs import define_bcs
from lsafw_tpu_torch.fem.spaces import define_spaces
from lsafw_tpu_torch.io.xdmf import read_xdmf, write_xdmf
from lsafw_tpu_torch.meshing.io import from_file, read_msh, write_msh
from lsafw_tpu_torch.meshing.mesh import CellType, box_mesh, rectangle_mesh, unit_cube, unit_square
from lsafw_tpu_torch.meshing.tags import mark_boundary_facets
from lsafw_tpu_torch.ops.sparse import CSRMatrix
from lsafw_tpu_torch.scm import SelfConsistentModel
from lsafw_tpu_torch.solver import band as tband
from lsafw_tpu_torch.solver import newton as tnewton
from lsafw_tpu_torch.solver.eigen import EigenSolver, EigensolverConfig, STType
from lsafw_tpu_torch.solver.linear import SolveResult
from lsafw_tpu_torch.utils.cache import CacheStore
from lsafw_tpu_torch.utils.capture import capture_c_streams
from tests.test_torch_fem import one_blas_thread  # noqa: F401

torch.set_num_threads(1)

TARGET = "-0.5+0.5j"
EIG = ["--target=" + TARGET, "--num-eig", "2", "--ncv", "20"]


@pytest.fixture(scope="module", autouse=True)
def nb32():
    """Band plans at nb = 32, unpadded (chunk 1), as in the other port
    tests: padded to 128 block rows, the CPU's plain loops would take ten
    times the steps of these 13 block rows."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LSAFW_BAND_NB", "32")
        mp.setitem(tband.plan_for_csr.__kwdefaults__, "chunk", 1)
        yield


@pytest.fixture(scope="module")
def configs(tmp_path_factory):
    d = tmp_path_factory.mktemp("cfg")
    (d / "facets.toml").write_text("""
[[FaceTag]]
marker = 1
when = { axis = "x", equals = 0.0 }
[[FaceTag]]
marker = 2
when = { axis = "x", equals = 1.0 }
[[FaceTag]]
marker = 3
otherwise = true
""")
    (d / "bcs.toml").write_text("""
[[BC]]
marker = 1
type = "dirichlet_velocity"
value = [1.0, 0.0]
[[BC]]
marker = 3
type = "dirichlet_velocity"
value = [0.0, 0.0]
[[BC]]
marker = 2
type = "dirichlet_pressure"
value = 0.0
""")
    (d / "bcs_pert.toml").write_text("""
[[BC]]
marker = 1
type = "dirichlet_velocity"
value = [0.0, 0.0]
[[BC]]
marker = 3
type = "dirichlet_velocity"
value = [0.0, 0.0]
""")
    # a coarse cousin of config_files/2D/cylinder/geometry_small.toml
    (d / "geometry.toml").write_text("""
dim = 2
cylinder_radius = 0.5
cylinder_center = [0.0, 0.0]
x_range = [-3.0, 6.0]
y_range = [-3.0, 3.0]
resolution = 1.0
resolution_around_cylinder = 0.4
influence_radius = 2.0
""")
    return d


def _case(configs):
    return ["--shape", "unit_square", "--n", "6", "6",
            "--facet-config", str(configs / "facets.toml"),
            "--bc-config", str(configs / "bcs.toml")]


def _run(argv):
    return cli.main(["--platform", "cpu", *argv])


@pytest.fixture(scope="module")
def runs(configs, tmp_path_factory):
    """Both packages' ``assemble`` and ``eigen`` on the reference tests'
    case, and each one's ``mesh --export`` of the unit square."""
    out = {}
    for name, main in (("jax", jcli.main), ("port", _run)):
        d = tmp_path_factory.mktemp(name)
        assert main(["assemble", *_case(configs), "--perturbation-bc-config",
                     str(configs / "bcs_pert.toml"), "--re", "20", "--outdir", str(d)]) == 0
        assert main(["mesh", *_case(configs), "--export", str(d / "m.msh")]) == 0
        out[name] = dict(dir=d)
    # both eigensolves on the JAX package's A.mtx, M.mtx: the port reads
    # them on two pattern objects of one structure
    for name, main in (("jax", jcli.main), ("port", _run)):
        modes = out[name]["dir"] / "modes"
        assert main(["eigen", "--matdir", str(out["jax"]["dir"]), *EIG, "--outdir",
                     str(modes)]) == 0
        out[name]["sigma"] = [complex(*p) for p in json.loads(
            (modes / "eigenvalues.json").read_text())]
    return out


def _rel(a, b) -> float:
    return float(np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(np.asarray(b)).max())


def test_baseflow_npz_matches_jax(runs):
    got, want = (np.load(runs[k]["dir"] / "baseflow_npz.npz") for k in ("port", "jax"))
    assert sorted(got.files) == sorted(want.files)
    for key in ("dofs_u", "dofs_p"):
        assert np.array_equal(got[key], want[key])
    assert _rel(got["u"], want["u"]) < 1e-10 and _rel(got["p"], want["p"]) < 1e-10
    assert not got["u_imag"].any() and not got["p_imag"].any()


@pytest.mark.parametrize("name", ["A", "M"])
def test_assemble_mtx_matches_jax(runs, name):
    got, want = (sp.csr_matrix(sio.mmread(runs[k]["dir"] / f"{name}.mtx"))
                 for k in ("port", "jax"))
    assert got.shape == want.shape == (387, 387)
    assert np.array_equal(got.indptr, want.indptr) and np.array_equal(got.indices, want.indices)
    assert _rel(got.data, want.data) < 1e-12


def test_eigen_sigma_matches_jax(runs):
    """The port's ``eigen`` (banded) on the JAX package's A.mtx and M.mtx
    against the JAX package's (host LU) on the same files."""
    got, want = runs["port"]["sigma"], runs["jax"]["sigma"]
    assert len(got) == len(want) == 2
    assert max(abs(g - w) for g, w in zip(got, want)) < 1e-8
    modes = runs["port"]["dir"] / "modes"
    x = tio.import_eigenvector(modes / "eigvec_0.npz", device="cpu").numpy()
    As, Ms = (sp.csr_matrix(sio.mmread(runs["jax"]["dir"] / f"{k}.mtx")) for k in ("A", "M"))
    assert np.linalg.norm(As @ x - got[0] * (Ms @ x)) / np.linalg.norm(x) < 1e-8


def test_each_package_reads_the_others_files(runs):
    """``.mtx``, the baseflow ``.npz`` and ``.msh`` of one package read back
    in the other to the same values (the mesh's facet tags exactly)."""
    jd, pd = runs["jax"]["dir"], runs["port"]["dir"]
    for name in ("A", "M"):
        a = tio.import_matrix(jd / f"{name}.mtx", device="cpu").to_scipy()
        b = jio.import_matrix(pd / f"{name}.mtx").to_scipy()
        assert (a != sp.csr_matrix(sio.mmread(jd / f"{name}.mtx"))).nnz == 0
        assert (b != sp.csr_matrix(sio.mmread(pd / f"{name}.mtx"))).nnz == 0
    tspaces, jspaces = define_spaces(unit_square(6)), jdefine_spaces(junit_square(6))
    w_port_of_jax = tio.load_function(jd, tspaces, device="cpu").numpy()
    w_jax_of_port = np.asarray(jio.load_function(pd, jspaces))
    assert np.array_equal(w_port_of_jax, np.asarray(jio.load_function(jd, jspaces)))
    assert np.array_equal(w_jax_of_port, tio.load_function(pd, tspaces, device="cpu").numpy())
    for got, other in ((read_msh(jd / "m.msh"), jread_msh(pd / "m.msh")),):
        assert np.array_equal(got.vertices, other.vertices)
        assert np.array_equal(got.cells, other.cells)
        assert np.array_equal(got.facet_tags, other.facet_tags)
        assert set(np.unique(got.facet_tags)) == {0, 1, 2, 3}


@pytest.mark.parametrize("mesh_of", ["2d", "3d"])
def test_msh_roundtrip(tmp_path, mesh_of):
    if mesh_of == "2d":
        mesh = unit_square(4)
        mark_boundary_facets(mesh, lambda x: np.where(np.isclose(x[:, 0], 0.0), 7, 3)
                             .astype(np.int32))
    else:
        mesh = unit_cube(2)
        mark_boundary_facets(mesh, lambda x: np.ones(x.shape[0], dtype=np.int32))
    write_msh(mesh, tmp_path / "m.msh")
    for m2 in (read_msh(tmp_path / "m.msh"), from_file(tmp_path / "m.msh"),
               jread_msh(tmp_path / "m.msh")):
        assert np.array_equal(m2.vertices, mesh.vertices)
        assert np.array_equal(m2.cells, mesh.cells)
        assert np.array_equal(m2.facet_tags, mesh.facet_tags)
    if mesh_of == "3d":
        assert np.isclose(read_msh(tmp_path / "m.msh").cell_volumes.sum(), 1.0)


def test_from_file_bad_extension(tmp_path):
    with pytest.raises(ValueError, match="Unsupported"):
        from_file(tmp_path / "mesh.xyz")


def test_xdmf_roundtrip(tmp_path):
    for mesh in (rectangle_mesh((0, 0), (1, 1), 3, 3),
                 rectangle_mesh((0, 0), (1, 1), 3, 3, cell_type=CellType.QUADRILATERAL),
                 box_mesh((0, 0, 0), (1, 1, 1), 2, 2, 2, cell_type=CellType.HEXAHEDRON)):
        rng = np.random.default_rng(0)
        pd = {"u": rng.standard_normal((mesh.num_vertices, mesh.gdim)),
              "p": rng.standard_normal(mesh.num_vertices)}
        cd = {"marker": np.arange(mesh.num_cells, dtype=np.int32)}
        out = write_xdmf(tmp_path / f"m_{mesh.cell_type.value}", mesh, point_data=pd,
                         cell_data=cd)
        assert out.exists() and out.with_suffix(".h5").exists()
        for m2, pd2, cd2 in (read_xdmf(out), jread_xdmf(out)):
            assert m2.cell_type.value == mesh.cell_type.value
            assert np.array_equal(m2.vertices, mesh.vertices)
            assert np.array_equal(m2.cells, mesh.cells)
            assert np.array_equal(pd2["u"], pd["u"]) and np.array_equal(pd2["p"], pd["p"])
            assert np.array_equal(cd2["marker"], cd["marker"])
        assert np.array_equal(from_file(out).cells, mesh.cells)


def test_cache_roundtrip(tmp_path):
    cache = CacheStore(tmp_path)
    mesh = unit_square(4)
    mark_boundary_facets(mesh, lambda x: np.ones(x.shape[0], dtype=np.int32))
    cache.save_mesh("m", mesh)
    for m2 in (cache.load_mesh("m"), JCacheStore(tmp_path).load_mesh("m")):
        assert np.array_equal(m2.vertices, mesh.vertices)
        assert np.array_equal(m2.cells, mesh.cells)
        assert np.array_equal(m2.facet_tags, mesh.facet_tags)
    assert cache.load_mesh("missing") is None
    arr = np.linspace(0, 1, 17)
    cache.save_array("a", torch.as_tensor(arr))
    assert np.array_equal(cache.load_array("a"), arr)
    A = CSRMatrix.from_scipy(sp.random(20, 20, 0.3, format="csr", random_state=0),
                             device="cpu")
    cache.save_matrix("A", A)
    for A2 in (cache.load_matrix("A", device="cpu"), JCacheStore(tmp_path).load_matrix("A")):
        assert (A2.to_scipy() != A.to_scipy()).nnz == 0


def test_function_and_eigenvector_roundtrip(tmp_path):
    spaces = define_spaces(unit_square(4))
    w = np.random.default_rng(0).standard_normal(spaces.num_dofs)
    for v in (w, w + 1j * w[::-1]):
        tio.export_function(torch.as_tensor(v), spaces, tmp_path, name="f")
        assert np.array_equal(tio.load_function(tmp_path, spaces, name="f", device="cpu").numpy(),
                              v)
        tio.export_eigenvector(v, tmp_path / "v.npz")
        assert np.array_equal(tio.import_eigenvector(tmp_path / "v.npz", device="cpu").numpy(),
                              v + 0j)
    with pytest.raises(ValueError):
        tio.load_function(tmp_path / "nope", spaces, device="cpu")


def test_export_matrix_keeps_every_stored_entry(tmp_path):
    """Explicit zeros on a structurally unsymmetric pattern whose values
    look symmetric stay where they are (scipy's symmetry detection would
    read them back on another pattern); values come back bit for bit."""
    a = sp.csr_matrix((np.array([1.0, 0.0, 2.0, 0.0, 1 / 3]), np.array([0, 1, 1, 0, 2]),
                       np.array([0, 2, 3, 5])), shape=(3, 3))
    tio.export_matrix(CSRMatrix.from_scipy(a, device="cpu"), tmp_path / "a.mtx")
    for b in (tio.import_matrix(tmp_path / "a.mtx", device="cpu").to_scipy(),
              jio.import_matrix(tmp_path / "a.mtx").to_scipy()):
        assert b.nnz == 5
        assert np.array_equal(b.indptr, a.indptr) and np.array_equal(b.indices, a.indices)
        assert np.array_equal(b.data, a.data)


def test_capture_c_streams(caplog):
    with caplog.at_level(logging.DEBUG, logger="lsafw_tpu_torch"):
        with capture_c_streams():
            os.write(1, b"native says hi\n")
            os.write(2, b"and on stderr\n")
    msgs = [r.message for r in caplog.records]
    assert any("native says hi" in m for m in msgs) and any("and on stderr" in m for m in msgs)


def test_cli_error_exit():
    assert _run(["eigen", "--matdir", "/nonexistent"]) == 1


def test_cli_names_the_missing_device(configs, caplog, monkeypatch):
    """Without ``--platform cpu`` and without a GPU a command exits 1 and
    names the device, with ``--distributed`` too (the device check comes
    before the process group is joined)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with caplog.at_level(logging.ERROR, logger="lsafw_tpu_torch"):
        assert cli.main(["mesh", "--shape", "unit_square", "--n", "2", "2"]) == 1
        assert cli.main(["--distributed", "mesh", "--shape", "unit_square", "--n", "2",
                         "2"]) == 1
    msgs = [r.message for r in caplog.records]
    assert len(msgs) == 2 and all("no CUDA device" in m and "--platform cpu" in m for m in msgs)


def test_cli_mesh_export_import_plot_and_cache(configs, tmp_path):
    msh, xdmf, png = tmp_path / "m.msh", tmp_path / "m.xdmf", tmp_path / "m.png"
    assert _run(["mesh", *_case(configs), "--export", str(msh)]) == 0
    assert _run(["mesh", "--from-file", str(msh), "--export", str(xdmf), "--plot", str(png),
                 "--outdir", str(tmp_path / "cache"), "--key", "sq"]) == 0
    assert png.exists() and xdmf.exists()
    cached = CacheStore(tmp_path / "cache").load_mesh("sq")
    ref = read_msh(msh)
    assert np.array_equal(cached.cells, ref.cells)
    assert np.array_equal(cached.facet_tags, ref.facet_tags)
    assert np.array_equal(read_xdmf(xdmf)[0].cells, ref.cells)


def test_cli_benchmark_geometry(configs, tmp_path):
    out = tmp_path / "bench.msh"
    assert _run(["benchmark", "--geometry", "cylinder_flow", "--config",
                 str(configs / "geometry.toml"), "--facet-config",
                 "config_files/2D/cylinder/facets_small.toml", "--export", str(out)]) == 0
    assert out.exists() and read_msh(out).num_cells > 0


def test_cli_baseflow(configs, tmp_path, runs):
    assert _run(["baseflow", *_case(configs), "--re", "20", "--steps", "2", "--ramp", "--tol",
                 "1e-8", "--outdir", str(tmp_path), "--key", "bf"]) == 0
    got = np.load(tmp_path / "bf_npz.npz")
    want = np.load(runs["jax"]["dir"] / "baseflow_npz.npz")
    assert _rel(got["u"], want["u"]) < 1e-10 and _rel(got["p"], want["p"]) < 1e-10


# ---------------------------------------------------------------------------
# Shift-invert on A and M of two patterns, and on M = None at a complex shift
# ---------------------------------------------------------------------------


def _sigma(A, M, target=complex(TARGET)):
    es = EigenSolver(A, M, EigensolverConfig(num_eig=2, atol=1e-8, ncv=20))
    es.set_st_type(STType.SINVERT)
    es.set_target(target)
    return [p[0] for p in es.solve()], es


def test_banded_sigma_on_two_patterns(runs):
    """A and M on two patterns of one structure (the port's ``eigen`` on
    two files: ``test_eigen_sigma_matches_jax``), here with M's explicit
    zeros pruned: both go onto their union pattern."""
    d = runs["jax"]["dir"]
    A = tio.import_matrix(d / "A.mtx", device="cpu")
    Ms = sp.csr_matrix(sio.mmread(d / "M.mtx"))
    Ms.eliminate_zeros()
    M = CSRMatrix.from_scipy(Ms, device="cpu")
    assert M.pattern.nnz < A.pattern.nnz
    sigma, es = _sigma(A, M)
    op = es.operator
    assert op.M.pattern is op.A.pattern and op.A is not A
    assert op.A.pattern.nnz == A.pattern.nnz  # M's pattern lies in A's, which has the diagonal
    assert max(abs(g - w) for g, w in zip(sigma, runs["jax"]["sigma"])) < 1e-8


def test_shared_pattern_forms(runs):
    """M of A's structure on another pattern object is taken on A's; the
    union keeps every slot of both and the diagonal, even where values
    cancel."""
    from lsafw_tpu_torch.ops.sparse import shared_pattern

    d = runs["jax"]["dir"]
    A = tio.import_matrix(d / "A.mtx", device="cpu")
    M = tio.import_matrix(d / "M.mtx", device="cpu")
    A2, M2 = shared_pattern(A, M)
    assert A2 is A and M2.pattern is A.pattern and M2.data is M.data
    a = sp.csr_matrix(np.array([[1.0, 2.0, 0.0], [0.0, 0.0, 3.0], [0.0, 0.0, 0.0]]))
    m = sp.csr_matrix(np.array([[-1.0, 0.0, 0.0], [4.0, 0.0, -3.0], [0.0, 5.0, 0.0]]))
    A3, M3 = shared_pattern(CSRMatrix.from_scipy(a, device="cpu"),
                            CSRMatrix.from_scipy(m, device="cpu"))
    assert A3.pattern is M3.pattern and A3.pattern.nnz == 7
    assert (A3.to_scipy() != a).nnz == 0 and (M3.to_scipy() != m).nnz == 0
    assert A3.pattern.diag_slots.size == 3


def test_banded_sigma_with_m_none_at_a_complex_shift(runs):
    """The port's M = None against the JAX package's host-LU shift-invert
    of the pencil (A, I) on the same A (the identity as M: the same
    eigenvalues, and its jitted Krylov-Schur is the CLI's, compiled once)."""
    d = runs["jax"]["dir"]
    target = -0.25 + 0.09j  # A's standard spectrum is clustered; -0.2535+0.0765j stands apart
    jA = jio.import_matrix(d / "A.mtx")
    jI = JCSRMatrix.from_scipy(sp.identity(387, format="csr"))
    jes = JEigenSolver(jA, jI, JConfig(num_eig=2, atol=1e-8, ncv=20))
    jes.set_st_type("sinvert")
    jes.set_target(target)
    want = [p[0] for p in jes.solve()]
    sigma, es = _sigma(tio.import_matrix(d / "A.mtx", device="cpu"), None, target)
    assert es.operator.M is not None and es.operator.M.pattern is es.operator.A.pattern
    assert max(abs(g - w) for g, w in zip(sigma, want)) < 1e-8


# ---------------------------------------------------------------------------
# ROADMAP fault 7: a banded miss inside a self-consistent-model trial
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def scm_model():
    """A self-consistent model on the 3 x 3 unit square at Re = 10."""
    mesh = unit_square(3)
    mark_boundary_facets(mesh, lambda x: np.select(
        [np.isclose(x[:, 0], 0.0), np.isclose(x[:, 0], 1.0)], [1, 2], 3).astype(np.int32))
    spaces = define_spaces(mesh)
    C = BoundaryConditionsConfig
    bcs = define_bcs(mesh, spaces, [C(marker=1, type="dirichlet_velocity", value=(1.0, 0.0)),
                                    C(marker=3, type="dirichlet_velocity", value=(0.0, 0.0)),
                                    C(marker=2, type="dirichlet_pressure", value=0.0)])
    ctx = AssemblyContext.build(spaces, device="cpu")
    model = SelfConsistentModel(ctx, mesh, bcs, bcs.homogeneous(), 10.0, device="cpu")
    return model


def test_banded_miss_fails_the_scm_trial_not_the_run(scm_model, monkeypatch, caplog):
    """The first banded Newton step is forced to miss (relative residual
    0.5 after one refinement iteration): the undamped trial fails, the
    damping ladder's next rung (0.5) converges; ``NewtonSolver`` itself
    still raises on the same miss."""
    model = scm_model
    spaces = model.ctx.spaces
    solve = tnewton.banded_solve
    misses = []

    def missing_once(A, b, plan, **kw):
        if not misses:
            misses.append(1)
            return SolveResult(torch.zeros_like(b), 1, 0.5, False)
        return solve(A, b, plan, **kw)

    monkeypatch.setattr(tnewton, "banded_solve", missing_once)
    zero = torch.zeros(spaces.num_dofs, dtype=torch.float64)
    with caplog.at_level(logging.INFO, logger="lsafw_tpu_torch"):
        w = model._mean_solve(zero, np.zeros(spaces.num_dofs), tol=1e-6)
    assert misses and w is not None and np.isfinite(w).all()
    assert any("damping 1.00" in r.message and "5.00e-01 after 1" in r.message
               for r in caplog.records)
    res = tnewton.NewtonSolver(model._base_asm, linear_solver="banded").solve(w, 10.0, tol=1e-6)
    assert res.converged and res.iterations == 1
    misses.clear()
    with pytest.raises(tnewton.BandedStepMissed, match="relative residual 5.00e-01"):
        tnewton.NewtonSolver(model._base_asm, linear_solver="banded").solve(np.zeros_like(w),
                                                                            10.0)


# ---------------------------------------------------------------------------
# The other subcommands, checked as the reference's tests check them
# ---------------------------------------------------------------------------


def test_cli_sensitivity(configs, tmp_path):
    """On the host LU (named): the banded sensitivity has its parity tests
    in test_torch_slice.py."""
    assert _run(["sensitivity", *_case(configs), "--re", "20", "--target=" + TARGET, "--tol",
                 "1e-8", "--si-method", "lu", "--wavemaker", "--outdir", str(tmp_path)]) == 0
    assert (tmp_path / "wavemaker_npz.npz").exists()


def test_cli_resolvent(configs, tmp_path):
    assert _run(["resolvent", *_case(configs), "--perturbation-bc-config",
                 str(configs / "bcs_pert.toml"), "--re", "20", "--omega", "0.8", "--k", "2",
                 "--outdir", str(tmp_path)]) == 0
    rows = json.loads((tmp_path / "resolvent_gains.json").read_text())
    assert len(rows) == 1 and len(rows[0]["gains"]) == 2
    assert rows[0]["gains"][0] >= rows[0]["gains"][1] > 0


def test_cli_transient(configs, tmp_path):
    """On the host LU (named): 2,300 band solves of the CPU's plain loops
    would take 35 s; the banded transient has its parity tests in
    test_torch_nonmodal.py."""
    assert _run(["transient", *_case(configs), "--perturbation-bc-config",
                 str(configs / "bcs_pert.toml"), "--re", "20", "--horizons", "1.0", "2.0",
                 "--n-steps", "8", "--si-method", "lu", "--outdir", str(tmp_path)]) == 0
    rows = json.loads((tmp_path / "transient_gains.json").read_text())
    assert len(rows) == 2 and all(r["gains"][0] > 0 for r in rows)


def test_cli_span(configs, tmp_path):
    assert _run(["span", *_case(configs), "--perturbation-bc-config",
                 str(configs / "bcs_pert.toml"), "--re", "20", "--betas", "0.5",
                 "--target=" + TARGET, "--outdir", str(tmp_path)]) == 0
    rows = json.loads((tmp_path / "span_sigma.json").read_text())
    assert [r["beta"] for r in rows] == [0.5] and np.isfinite(rows[0]["sigma"]).all()


def test_cli_scm(configs, tmp_path):
    """SCM on a stable case: A = 0 at once, converged."""
    assert _run(["scm", *_case(configs), "--perturbation-bc-config",
                 str(configs / "bcs_pert.toml"), "--re", "20", "--outdir", str(tmp_path)]) == 0
    d = json.loads((tmp_path / "scm.json").read_text())
    assert d["converged"] and d["amplitude"] == 0.0


def test_cli_wnl(configs, tmp_path, monkeypatch):
    """``wnl``'s wiring and its file, on stand-ins for ``find_critical_re``
    and ``weakly_nonlinear`` (the unit square has no Hopf point, and both
    have their parity tests in test_torch_slice.py)."""
    from lsafw_tpu_torch import wnl

    seen = {}

    class Result:
        omega_c, lambda_p, mu = 0.7, 0.01 + 0.02j, 0.5 - 0.1j

        def amplitude(self, re):
            return float(np.sqrt((re - 45.0) / 10.0))

        def frequency(self, re):
            return 0.7 + 0.001 * (re - 45.0)

    def critical(ctx, mesh, bcs, pert, re_lo, re_hi, *, device):
        seen["bracket"], seen["device"] = (re_lo, re_hi), device
        return 45.0, np.zeros(ctx.spaces.num_dofs), 1e-5 + 0.7j

    monkeypatch.setattr(wnl, "find_critical_re", critical)
    monkeypatch.setattr(wnl, "weakly_nonlinear", lambda *a, device: Result())
    assert _run(["wnl", *_case(configs), "--perturbation-bc-config",
                 str(configs / "bcs_pert.toml"), "--re", "20", "--re-lo", "40", "--re-hi", "50",
                 "--res", "46", "50", "--outdir", str(tmp_path)]) == 0
    d = json.loads((tmp_path / "wnl.json").read_text())
    assert seen == {"bracket": (40.0, 50.0), "device": torch.device("cpu")}
    assert d["re_c"] == 45.0 and d["supercritical"] and d["mu"] == [0.5, -0.1]
    assert [p["re"] for p in d["points"]] == [46.0, 50.0]
    assert d["points"][0]["amplitude"] < d["points"][1]["amplitude"]


def test_plots_write_their_files(tmp_path, runs):
    """Each plot function of the port on the port's mesh, spaces, CSR and
    tensors writes its image (matplotlib, host only)."""
    from lsafw_tpu_torch import plot
    from lsafw_tpu_torch.fem.spaces import make_vector_space

    mesh2, mesh3 = unit_square(3), unit_cube(1)
    for m in (mesh2, mesh3):
        mark_boundary_facets(m, lambda x: np.where(np.isclose(x[:, 0], 0.0), 1, 2)
                             .astype(np.int32))
    spaces2, spaces3 = define_spaces(mesh2), define_spaces(mesh3)
    rng = np.random.default_rng(0)
    A = tio.import_matrix(runs["jax"]["dir"] / "A.mtx", device="cpu")
    figs = {
        "mesh2": lambda p: plot.plot_mesh(mesh2, path=p),
        "mesh3": lambda p: plot.plot_mesh(mesh3, path=p),
        "spy": lambda p: plot.spy(A, path=p),
        "mixed2": lambda p: plot.plot_mixed_function(
            torch.as_tensor(rng.standard_normal(spaces2.num_dofs)), spaces2, path=p),
        "mixed3": lambda p: plot.plot_mixed_function(rng.standard_normal(spaces3.num_dofs),
                                                     spaces3, path=p),
        "displacement": lambda p: plot.plot_displacement(
            rng.standard_normal(make_vector_space(mesh2, "p1").num_dofs),
            make_vector_space(mesh2, "p1"), path=p),
        "residuals": lambda p: plot.plot_residuals(torch.logspace(0, -8, 9), path=p),
        "pseudospectrum": lambda p: plot.plot_pseudospectrum(
            np.linspace(-1, 0, 5), np.linspace(0, 1, 4), rng.random((4, 5)) + 1.0,
            eigenvalues=[-0.5 + 0.5j], path=p),
    }
    for name, draw in figs.items():
        assert draw(tmp_path / f"{name}.png") == tmp_path / f"{name}.png"
        assert (tmp_path / f"{name}.png").stat().st_size > 0


def test_pencils_without_diagonal_slots():
    """Outside matrices may lack stored diagonal entries: a pair of one
    such structure, and A alone at a complex shift, get every diagonal
    slot, which the factor's saddle regularization needs."""
    from lsafw_tpu_torch.ops.sparse import identity_mass, shared_pattern

    a = sp.csr_matrix(np.array([[0.0, 2.0], [3.0, 0.0]]))
    a.eliminate_zeros()
    A = CSRMatrix.from_scipy(a, device="cpu")
    A2, M2 = shared_pattern(A, CSRMatrix.from_scipy(a, device="cpu"))
    assert A2.pattern is M2.pattern and A2.pattern.nnz == 4 and (A2.to_scipy() != a).nnz == 0
    A3, I3 = identity_mass(A)
    assert A3.pattern is I3.pattern and (I3.to_scipy() != sp.identity(2)).nnz == 0
    assert (A3.to_scipy() != a).nnz == 0


def test_stalled_bordered_solve_restarts_once(scm_model, monkeypatch, caplog):
    """A bordered coupled-Newton solve whose GCR stops above the 1e-8
    acceptance (here capped at 3 iterations: 3.3e-6) takes one more pass on
    its true residual and is accepted when that reaches it; where the
    second pass misses too (capped at 1 iteration), it still raises."""
    from lsafw_tpu_torch import scm as tscm
    from lsafw_tpu_torch.solver.eigen import FactorUnusable

    model = scm_model
    spaces = model.ctx.spaces
    n = spaces.num_dofs
    K0 = model._base_asm.jacobian(torch.zeros(n, dtype=torch.float64), 10.0)
    rng = np.random.default_rng(0)
    c, r = (torch.as_tensor(rng.standard_normal(n)) for _ in range(2))
    F = torch.as_tensor(rng.standard_normal(n + 1))
    K = sp.bmat([[K0.to_scipy(), sp.csr_matrix(c.numpy()[:, None])],
                 [sp.csr_matrix(r.numpy()[None, :]), None]]).tocsr()
    monkeypatch.setitem(tscm._bordered_gcr.__kwdefaults__, "max_its", 3)
    with caplog.at_level(logging.INFO, logger="lsafw_tpu_torch"):
        dz = model._bordered_solve(K0, c, r, F).numpy()
    assert np.linalg.norm(K @ dz - F.numpy()) / np.linalg.norm(F.numpy()) < 1e-8
    assert any("a restart on the true residual took 3 more" in m.message for m in caplog.records)
    monkeypatch.setitem(tscm._bordered_gcr.__kwdefaults__, "max_its", 1)
    with pytest.raises(FactorUnusable, match="bordered GCR stalled"):
        model._bordered_solve(K0, c, r, F)
