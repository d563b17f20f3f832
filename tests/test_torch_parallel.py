"""Parity of the port's scale-out layer (``lsafw_tpu_torch.parallel``,
``solver/band_sharded.py``) with the JAX package's, on the CPU.

The port runs as two ranks of a gloo process group, spawned once for the
module (``tests/torch_parallel_ranks.py``, a ``file://`` store in a
temporary folder, one torch and one BLAS thread a rank); the JAX package
runs on a two-device ``Mesh`` of the virtual CPU devices, once, in the
module fixture ``jax_side``, which first writes the inputs the ranks
read and starts them, so that they run while the JAX package compiles
its comparisons.  Both run at the reference tests' sizes and block size (nb = 16;
the plain versions take any nb).
"""

import ast
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from lsafw_tpu_torch import cli
from lsafw_tpu_torch.meshing.mesh import unit_square as t_unit_square
from lsafw_tpu_torch.parallel import partition_cells as t_partition_cells
from lsafw_tpu_torch.parallel import launch as t_launch
from lsafw_tpu_torch.parallel.partition import renumber_dofs_by_partition as t_renumber
from lsafw_tpu_torch.parallel.sharded import _ell_of
from tests import torch_parallel_ranks as ranks
from tests.test_torch_fem import one_blas_thread  # noqa: F401  (autouse)

torch.set_num_threads(1)

NB, CHUNK = ranks.NB, ranks.CHUNK
SIGMA = 2.0 + 0.1j  # test_parallel.py's membrane shift


def _banded_complex(n, bw, seed=0):
    """tests/unit/test_band_sharded.py's random banded matrix."""
    rng = np.random.default_rng(seed)
    diags, offs = [], range(-bw, bw + 1)
    for o in offs:
        m = n - abs(o)
        diags.append((rng.standard_normal(m) + 1j * rng.standard_normal(m)) * 0.2)
    A = sp.diags(diags, list(offs), format="csr").astype(np.complex128)
    return (A + sp.identity(n, format="csr") * (2.0 * bw * 0.2 + 1.0)).tocsr()


def _put(d: dict, name: str, S) -> None:
    S = sp.csr_matrix(S)
    d.update({f"{name}_data": S.data, f"{name}_indices": S.indices,
              f"{name}_indptr": S.indptr, f"{name}_shape": np.array(S.shape)})


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """The JAX package's sharded results on a two-device mesh, the inputs
    of the ranks (written to ``folder``) and the ranks, started on them."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from lsafw_tpu.fem.assembly import SpaceContext, stiffness_scalar
    from lsafw_tpu.fem.spaces import make_scalar_space
    from lsafw_tpu.meshing.mesh import rectangle_mesh
    from lsafw_tpu.models.membrane import assemble_membrane_evp
    from lsafw_tpu.ops.sparse import CSRMatrix
    from lsafw_tpu.parallel.sharded import shard_csr, shard_vector, sharded_si_eigensolve
    from lsafw_tpu.solver.band_sharded import ShardedSpikeSolver

    folder = tmp_path_factory.mktemp("parallel")
    mesh2 = Mesh(np.asarray(jax.devices("cpu")[:2]), ("dof",))
    rng = np.random.default_rng(0)
    d, out = {}, {}

    S = sp.random(101, 101, 0.1, format="csr", random_state=3) + sp.eye(101)
    x = rng.standard_normal(101)
    _put(d, "spmv", S)
    d["spmv_x"] = x

    C = _banded_complex(600, 9)
    b = rng.standard_normal(600) + 1j * rng.standard_normal(600)
    _put(d, "band", C)
    d["band_b"] = b
    sol = ShardedSpikeSolver.build(C, 2, nb=NB, chunk=CHUNK)
    pc = sol.pc  # the truncated SPIKE: the segment factors alone
    d.update(jf_band_re=np.asarray(pc.band_re), jf_band_im=np.asarray(pc.band_im),
             jf_dinv_r=np.asarray(pc.dinv_r), jf_dinv_i=np.asarray(pc.dinv_i), jf_B=pc.B)

    _put(d, "wide", _banded_complex(64, 40, seed=11))  # bw 40 over the 32-row segments of nb 16

    n = 96
    _put(d, "tri", sp.diags([-1.0, 4.0, -1.0], [-1, 0, 1], shape=(n, n)).tocsr())
    d["tri_b"] = np.ones(n)

    gm = rectangle_mesh((0.0, 0.0), (2.0, 1.0), 10, 5)
    space = make_scalar_space(gm, "p2")
    ctx = SpaceContext.build(space)
    _put(d, "stiff", ctx.scatter(stiffness_scalar(ctx)).to_scipy())
    d.update(stiff_vertices=gm.vertices, stiff_cells=gm.cells,
             stiff_cell_dofs=np.asarray(space.cell_dofs))

    K, M, _ = assemble_membrane_evp(rectangle_mesh((0, 0), (2.0, 4.0), 10, 10))
    _put(d, "memK", K.to_scipy())
    _put(d, "memM", M.to_scipy())
    d["mem_sigma"] = SIGMA
    np.savez(folder / "inputs.npz", **d)
    procs = ranks.start(folder)
    try:
        out["spmv_y"] = np.asarray(shard_csr(CSRMatrix.from_scipy(sp.csr_matrix(S)), mesh2)
                                   .matvec(shard_vector(x, mesh2)))[:101]
        for name, (re, im) in dict(R=("Rr", "Ri"), L=("Lr", "Li"), Sinv=("Sinv_r", "Sinv_i"),
                                   Msub=("Msub_r", "Msub_i"), Sup=("Sup_r", "Sup_i")).items():
            out[f"spike_{name}"] = np.asarray(getattr(sol, re)) + 1j * np.asarray(getattr(sol, im))
        pad = np.zeros(pc.npad - 600)
        with mesh2:
            xr, xi = pc.solve_pair_sharded(jnp.asarray(np.concatenate([b.real, pad])),
                                           jnp.asarray(np.concatenate([b.imag, pad])), mesh2)
        out["pc_x"] = np.asarray(xr)[:600] + 1j * np.asarray(xi)[:600]
        out["pc_perm"] = np.asarray(pc.perm)
        r = sharded_si_eigensolve(K, M, SIGMA, mesh2, nev=2, ncv=12, tol=1e-10, nb=NB,
                                  chunk=CHUNK, spike="truncated")
        out["si_lam"] = np.asarray(r.eigenvalues[:2])
        yield dict(folder=folder, inputs=d, procs=procs, **out)
    finally:
        ranks.stop(procs)


@pytest.fixture(scope="module")
def port(jax_side):
    """Both ranks' outputs of the one two-rank spawn."""
    return ranks.collect(jax_side["folder"], jax_side["procs"])


def _csr(d, name):
    return ranks._csr(d, name)


def _rel(a, b) -> float:
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b)) / np.linalg.norm(np.asarray(b)))


def test_partition_matches_jax():
    from lsafw_tpu.meshing.mesh import unit_square
    from lsafw_tpu.parallel import partition_cells
    from lsafw_tpu.parallel.partition import renumber_dofs_by_partition

    mesh, tmesh = unit_square(8), t_unit_square(8)
    for k in (2, 4, 8):
        parts = partition_cells(mesh, k)
        np.testing.assert_array_equal(t_partition_cells(tmesh, k), parts)
        np.testing.assert_array_equal(
            t_renumber(tmesh.cells, tmesh.num_vertices, parts, k),
            renumber_dofs_by_partition(mesh.cells, mesh.num_vertices, parts, k))


def test_sharded_matvec_and_rows_match_jax(jax_side, port):
    d = jax_side["inputs"]
    S, x = _csr(d, "spmv"), d["spmv_x"]
    for out in port:  # every rank holds the gathered product
        assert _rel(out["spmv_y"], jax_side["spmv_y"]) <= 1e-12
    npad = 102  # 101 rows padded to two ranks
    xp = np.concatenate([x, [0.0]])
    y = np.concatenate([_ell_of(S, npad, identity_pad=False, rows=(r * 51, (r + 1) * 51)) @ xp
                        for r in range(2)])
    assert _rel(y[:101], jax_side["spmv_y"]) <= 1e-12
    ident = _ell_of(S, npad, identity_pad=True, rows=(51, 102))
    assert ident[50, 101] == 1.0 and ident[50].nnz == 1


def test_segment_solve_matches_jax(jax_side, port):
    """The truncated-SPIKE segment solve (the port's own factors, and the
    JAX package's carried over) against the JAX ``solve_pair_sharded``,
    on tests/unit/test_band_sharded.py's matrix (n 600, bw 9, nb 16,
    chunk 2, two segments)."""
    out = port[0]
    np.testing.assert_array_equal(out["pc_perm"], jax_side["pc_perm"])
    assert _rel(out["pc_x"], jax_side["pc_x"]) <= 5e-5
    assert _rel(out["pcj_x"], jax_side["pc_x"]) <= 1e-6


def test_spike_solver_matches_jax_and_splu(jax_side, port):
    """The exact SPIKE on the same matrix: its reduced blocks against the
    JAX package's, one solve against splu at factor grade and, after two
    defect corrections on the host, at f64 grade; a bandwidth over the
    segments is refused."""
    d = jax_side["inputs"]
    out = port[0]
    for name in ("R", "L", "Sinv", "Msub", "Sup"):
        ref = jax_side[f"spike_{name}"]
        err = np.abs(out[f"spike_{name}"] - ref).max() / max(np.abs(ref).max(), 1.0)
        assert err <= 1e-5, (name, err)
    x_ref = sp.linalg.splu(_csr(d, "band").tocsc()).solve(d["band_b"])
    assert _rel(out["spike_x0"], x_ref) <= 5e-5
    assert _rel(out["spike_x"], x_ref) <= 1e-9
    assert all(o["spike_refused"] for o in port)


def test_exact_spike_degrades_where_the_bandwidth_exceeds_the_segments(jax_side, port):
    """Where the exact SPIKE is refused (the bandwidth over the segments),
    the shift-invert degrades to the truncated SPIKE, as the reference
    does, and records it; its eigenvalue is still the pencil's."""
    W = _csr(jax_side["inputs"], "wide").real.toarray()
    lam = np.linalg.eigvals(W)
    dist = np.abs(lam - 2.5)
    nearest = lam[dist <= dist.min() * (1 + 1e-12)]  # a real matrix: a conjugate pair ties
    for out in port:
        assert str(out["wide_path"]) == "truncated" and out["wide_degraded"]
        assert np.isnan(out["wide_calibration"])
        assert np.abs(nearest - out["wide_lam"]).min() <= 1e-8 * abs(out["wide_lam"])


@pytest.mark.parametrize("ksp", ranks.KSPS)
def test_sharded_solve_solves(jax_side, port, ksp):
    """Every Krylov type runs on the distributed rows (test_parallel.py's
    sharded GMRES, on each type the reference's ``sharded_solve`` takes)."""
    d = jax_side["inputs"]
    T = _csr(d, "tri")
    for out in port:
        assert out[f"ksp_{ksp}_converged"]
        x = out[f"ksp_{ksp}_x"]
        assert np.linalg.norm(T @ x - d["tri_b"]) / np.linalg.norm(d["tri_b"]) <= 1e-11


def test_sharded_krylov_schur_matches_single_device(jax_side, port):
    d = jax_side["inputs"]
    out = port[0]
    np.testing.assert_allclose(np.sort(out["ks_lam"].real), np.sort(out["ks_ref"].real),
                               rtol=1e-10, atol=1e-10)
    K, x, lam = _csr(d, "stiff"), out["ks_x"], out["ks_lam"][0]
    assert np.linalg.norm(K @ x - lam * x) / np.linalg.norm(x) < 1e-8 * abs(lam)


@pytest.mark.parametrize("path", ["exact", "truncated"])
def test_sharded_shift_invert_matches_jax(jax_side, port, path):
    d = jax_side["inputs"]
    out = port[0]
    assert str(out[f"si_{path}_path"]) == path and not out[f"si_{path}_degraded"]
    np.testing.assert_allclose(np.sort_complex(out[f"si_{path}_lam"][:2]),
                               np.sort_complex(jax_side["si_lam"]), rtol=1e-8, atol=1e-8)
    np.testing.assert_array_equal(port[1][f"si_{path}_lam"], out[f"si_{path}_lam"])
    K, M = _csr(d, "memK"), _csr(d, "memM")
    lam, v = out[f"si_{path}_lam"][0], out[f"si_{path}_x"]
    assert np.linalg.norm(K @ v - lam * (M @ v)) / np.linalg.norm(K @ v) <= 1e-7


@pytest.fixture
def launcher_world_of_one(monkeypatch):
    """The environment a launcher sets for a world of one rank (a free
    port on the loopback); the process group is left as it was found."""
    import socket
    import torch.distributed as dist

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port_no = s.getsockname()[1]
    for k, v in dict(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port_no), RANK="0",
                     WORLD_SIZE="1").items():
        monkeypatch.setenv(k, v)
    try:
        yield
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        t_launch._DEVICE.clear()


def test_distributed_cli_on_a_world_of_one(launcher_world_of_one):
    """``--distributed`` joins a process group of one rank from the
    launcher's environment and runs the command."""
    import torch.distributed as dist

    assert cli.main(["--platform", "cpu", "--distributed", "mesh", "--shape", "unit_square",
                     "--n", "2", "2"]) == 0
    assert dist.is_initialized() and dist.get_world_size() == 1
    assert dist.get_backend() == "gloo" and t_launch.is_rank0()


def test_distributed_cli_writes_from_rank_0_alone(launcher_world_of_one, monkeypatch, tmp_path):
    """Under ``--distributed`` a rank other than 0 joins the group and
    returns 0 without running the subcommand, so that only rank 0 writes
    its files."""
    import lsafw_tpu_torch.parallel as t_parallel

    argv = ["--platform", "cpu", "--distributed", "mesh", "--shape", "unit_square", "--n", "2",
            "2", "--export"]
    with monkeypatch.context() as m:
        m.setattr(t_parallel, "is_rank0", lambda: False)
        assert cli.main(argv + [str(tmp_path / "other.msh")]) == 0
    assert not (tmp_path / "other.msh").exists()
    assert cli.main(argv + [str(tmp_path / "rank0.msh")]) == 0
    assert (tmp_path / "rank0.msh").exists()


def test_cgs2_reduces_the_norm_where_the_projections_cancel(tmp_path, monkeypatch):
    """With a group, CGS2 takes the norm from ||w||^2 - |h2|^2 while that
    keeps over half of ||w||^2, and reduces it explicitly where the
    projections cancel more: w in the span of the basis, and w in the
    span of a basis that lost its orthogonality (rows off by 1e-6), where
    ||w||^2 - |h2|^2 is off by orders of magnitude.  The norm returned is
    that of the vector returned, never NaN, and the same as without a
    group to rounding."""
    import torch.distributed as dist

    from lsafw_tpu_torch.solver import linear

    rng = np.random.default_rng(5)
    Q, _ = np.linalg.qr(rng.standard_normal((40, 6)) + 1j * rng.standard_normal((40, 6)))
    V = torch.as_tensor(Q.T.copy())
    Vp = V + 1e-6 * torch.as_tensor(rng.standard_normal((6, 40)))
    c = torch.as_tensor(rng.standard_normal(6) + 1j * rng.standard_normal(6))
    generic = torch.as_tensor(rng.standard_normal(40) + 1j * rng.standard_normal(40))
    explicit = []
    vnorm = linear._vnorm
    monkeypatch.setattr(linear, "_vnorm",
                        lambda x, group=None: explicit.append(1) or vnorm(x, group))
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store", world_size=1,
                            rank=0)
    try:
        for Vj, w, reduced in ((V, generic, 0), (V, V.T @ c, 1), (Vp, Vp.T @ c, 1)):
            explicit.clear()
            h, wo, nrm = linear._cgs2(Vj, w, dist.group.WORLD)
            h0, wo0, nrm0 = linear._cgs2(Vj, w)
            assert len(explicit) == reduced
            true = float(torch.linalg.vector_norm(wo))
            assert np.isfinite(float(nrm)) and abs(float(nrm) - true) <= 1e-12 * max(true, 1e-300)
            assert float((h - h0).abs().max()) <= 1e-14 * float(h0.abs().max())
            assert abs(float(nrm) - float(nrm0)) <= 1e-13 * float(torch.linalg.vector_norm(w))
    finally:
        dist.destroy_process_group()


def test_rank_helper_imports_no_jax():
    tree = ast.parse(Path(ranks.__file__).read_text())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module]
    assert [m for m in names if m.split(".")[0] in ("jax", "jaxlib", "lsafw_tpu")] == []
