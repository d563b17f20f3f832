"""Parity of the port's elasticity model with the JAX package.

Three small cases built by both packages: the NAFEMS FV52 plate of
``tests/benchmark/test_elasticity.py`` (10 x 10 x 1, E = 200 GPa, nu =
0.3, rho = 8000, u_z pinned on the four side faces) at 3 x 3 x 1 on P2
tetrahedra and on Q1 hexahedra (the reference's own element), and the
2D Q1 cantilever of ``tests/unit/test_nonaffine.py`` (x = 0 clamped) at
6 x 3.  Tolerances: BC masks and values exact; (K, M) rel 1e-12 (f64 in
another summation order); frequencies 1e-8 (the port's banded
shift-invert against scipy's on the JAX package's pencil, both through
their ``process_modes``); sensitivities 1e-10 on the same eigenvector.
Band plans at nb = 32, unpadded.
"""

import math

import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

from lsafw_tpu.fem.spaces import make_vector_space as jvector
from lsafw_tpu.meshing import mesh as jmesh
from lsafw_tpu.meshing.tags import mark_boundary_facets as jmark
from lsafw_tpu.models import elasticity as je
from lsafw_tpu_torch.fem.spaces import make_vector_space
from lsafw_tpu_torch.meshing import mesh as tmesh
from lsafw_tpu_torch.meshing.tags import mark_boundary_facets
from lsafw_tpu_torch.models import ElasticityEigenAssembler
from lsafw_tpu_torch.models import elasticity as te
from lsafw_tpu_torch.ops.sparse import CSRMatrix
from lsafw_tpu_torch.solver import band as tband
from lsafw_tpu_torch.solver import eigen as teigen
from lsafw_tpu_torch.solver.eigen import EigenSolver, EigensolverConfig, STType
from tests.test_torch_fem import one_blas_thread  # noqa: F401

torch.set_num_threads(1)
CPU = "cpu"
L, H = 10.0, 1.0
E, NU, RHO = 200e9, 0.3, 8000.0
PLATE_TARGET = (2 * math.pi * 40.0) ** 2  # test_elasticity.py's solve_modes
NEV = 6


@pytest.fixture(scope="module", autouse=True)
def nb32():
    """Band plans at nb = 32, unpadded (chunk 1), as in the other port tests."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LSAFW_BAND_NB", "32")
        mp.setitem(tband.plan_for_csr.__kwdefaults__, "chunk", 1)
        yield


def _plate_marker(x):
    out = np.full(x.shape[0], 9, dtype=np.int32)
    out[np.isclose(x[:, 0], 0.0)] = 1
    out[np.isclose(x[:, 0], L)] = 2
    out[np.isclose(x[:, 1], 0.0)] = 3
    out[np.isclose(x[:, 1], L)] = 4
    return out


def _clamp_marker(x):
    out = np.full(x.shape[0], 2, dtype=np.int32)
    out[np.isclose(x[:, 0], 0.0)] = 1
    return out


def _build(mod, mark, vector, ela, case: str, **kw):
    """(assembler, target) of ``case`` through one package."""
    if case == "cantilever_q1":
        mesh = mod.rectangle_mesh((0.0, 0.0), (1.0, 0.4), 6, 3,
                                  cell_type=mod.CellType.QUADRILATERAL)
        mark(mesh, _clamp_marker)
        space = vector(mesh, "q1")
        bcs = ela.define_bcs(mesh, space, component=[
            ela.ComponentDirichlet(tags=(1,), components=(0, 1), value=0.0)])
        target = 1e5
    else:
        cell = mod.CellType.TETRAHEDRON if case == "plate_p2" else mod.CellType.HEXAHEDRON
        mesh = mod.box_mesh((0, 0, 0), (L, L, H), 3, 3, 1, cell)
        mark(mesh, _plate_marker)
        space = ela.define_space(mesh, degree=2) if case == "plate_p2" else vector(mesh, "q1")
        bcs = ela.define_bcs(mesh, space, axis_normal=(
            ela.AxisNormalBc(tags=(1, 2), axis=2, value=0.0),
            ela.AxisNormalBc(tags=(3, 4), axis=2, value=0.0)))
        target = PLATE_TARGET
    return ela.ElasticityEigenAssembler(space, young_modulus=E, poisson_ratio=NU, density=RHO,
                                        bcs=bcs, **kw), target


CASES = ("plate_p2", "plate_q1hex", "cantilever_q1")


@pytest.fixture(scope="module")
def cases():
    """Per case: both packages' assemblers and (M, K), the JAX pencil's NEV
    pairs nearest the target from scipy's shift-invert and their modes
    through the JAX package's ``process_modes``."""
    out = {}
    for case in CASES:
        ja_, target = _build(jmesh, jmark, jvector, je, case)
        ta_, _ = _build(tmesh, mark_boundary_facets, make_vector_space, te, case, device=CPU)
        Mj, Kj = ja_.assemble_eigensystem()
        lam, vec = spla.eigsh(Kj.to_scipy().tocsc(), k=NEV, M=Mj.to_scipy().tocsc(),
                              sigma=target)
        pairs = list(zip(lam, vec.T))
        out[case] = dict(ja=ja_, ta=ta_, Mj=Mj, Kj=Kj, target=target, pairs=pairs,
                         modes=je.process_modes(pairs, Kj, Mj, skip_below_hz=0.2))
    return out


@pytest.mark.parametrize("case", CASES)
def test_bc_masks_match_jax(cases, case):
    jb, tb = cases[case]["ja"].bcs, cases[case]["ta"].bcs
    assert jb.dirichlet_mask.any()
    assert np.array_equal(tb.dirichlet_mask, jb.dirichlet_mask)
    assert np.array_equal(tb.dirichlet_values, jb.dirichlet_values)


@pytest.mark.parametrize("case", CASES)
def test_stiffness_and_mass_match_jax(cases, case):
    """(K, M) with the Dirichlet rows 1 in K and 0 in M, rel 1e-12; the
    assembler caches them."""
    c = cases[case]
    Mt, Kt = c["ta"].assemble_eigensystem()
    assert c["ta"].assemble_stiffness() is Kt
    for got, want in ((Kt, c["Kj"]), (Mt, c["Mj"])):
        a, b = got.to_scipy(), want.to_scipy()
        assert abs(a - b).max() <= 1e-12 * abs(b).max()


@pytest.mark.parametrize("case", CASES)
def test_frequencies_match_jax(cases, case):
    """The port's banded shift-invert at the case's real target, through
    its ``process_modes`` (the rigid-body modes of the plates, at 0 Hz,
    dropped below 0.2 Hz as the benchmark does), against the JAX pencil's
    modes: frequencies 1e-8, mass normalisation, Rayleigh quotients 1e-8."""
    c = cases[case]
    Mt, Kt = c["ta"].assemble_eigensystem()
    es = EigenSolver(Kt, Mt, EigensolverConfig(num_eig=NEV, atol=1e-9, ncv=30))
    es.set_st_type(STType.SINVERT)
    es.set_target(c["target"])
    modes = te.process_modes(es.solve(), Kt, Mt, skip_below_hz=0.2)
    want = c["modes"]
    assert len(modes) == len(want) >= 1
    got_fn, want_fn = np.array([m.fn for m in modes]), np.array([m.fn for m in want])
    assert np.abs(got_fn - want_fn).max() <= 1e-8 * want_fn.max()
    assert all(m.mass_chk for m in modes)
    for m in modes:
        assert abs(m.rq_omega2 - m.wn**2) <= 1e-8 * m.wn**2


@pytest.mark.parametrize("case", CASES)
def test_process_modes_and_sensitivity_match_jax(cases, case):
    """On the JAX pencil's eigenpairs (host vectors, and the same as device
    tensors): ``process_modes`` (frequencies, Rayleigh quotients, the
    mass-normalised vectors), ``compute_sensitivity`` in rho and E,
    ``compute_density_sensitivity_analytical`` with the unit-density mass,
    and the centred finite difference of a given lambda(rho): rel 1e-10.
    The sensitivities in rho and E of a mass-normalised mode of a uniform
    material are -lambda / rho and lambda / E (M is linear in rho, K in
    E, the mode zero on the Dirichlet rows): every case is held to them
    (the unit-density mass's -lambda v^T M1 v too), the P2 plate to the
    JAX package's as well (its jitted forms compile once a case, and the
    identities cover the others)."""
    c = cases[case]
    Mt, Kt = c["ta"].assemble_eigensystem()
    tensors = [(lam, torch.as_tensor(v)) for lam, v in c["pairs"]]
    for pairs in (c["pairs"], tensors):
        got = te.process_modes(pairs, Kt, Mt, skip_below_hz=0.2)
        for g, w in zip(got, c["modes"]):
            assert abs(g.fn - w.fn) <= 1e-12 * w.fn
            assert abs(g.rq_omega2 - w.rq_omega2) <= 1e-10 * w.rq_omega2
            assert np.abs(g.function - w.function).max() <= 1e-10 * np.abs(w.function).max()
    m0 = c["modes"][0]
    lam0 = m0.wn**2
    identity = {"rho": -lam0 / RHO, "young_modulus": m0.rq_omega2 / E}
    for param in ("rho", "young_modulus"):
        got = c["ta"].compute_sensitivity(torch.as_tensor(m0.function), lam0, param=param)
        assert abs(got - identity[param]) <= 1e-10 * abs(identity[param])
        if case == "plate_p2":
            want = c["ja"].compute_sensitivity(m0.function, lam0, param=param)
            assert abs(got - want) <= 1e-10 * abs(want)
    ones = np.ones(c["ta"].space.mesh.num_cells)
    got = te.compute_density_sensitivity_analytical(
        lam0, v=m0.function, M1=c["ta"].assemble_mass(rho=ones))
    assert abs(got + lam0 / RHO) <= 1e-10 * lam0 / RHO
    if case == "plate_p2":
        want = je.compute_density_sensitivity_analytical(
            lam0, v=m0.function, M1=c["ja"].assemble_mass(rho=ones))
        assert abs(got - want) <= 1e-10 * abs(want)
    dfn = je.process_sensitivity(got, m0.fn)
    assert abs(te.process_sensitivity(got, m0.fn) - dfn) <= 1e-10 * abs(dfn) and dfn < 0
    line = (lambda rho: 3.0 * rho**2 - rho)
    assert te.compute_density_sensitivity_fd(line, RHO, 40.0) == je.compute_density_sensitivity_fd(
        line, RHO, 40.0)


def test_elasticity_assembler_is_exported():
    assert ElasticityEigenAssembler is te.ElasticityEigenAssembler


def test_offset_retry_catches_a_target_on_an_eigenvalue(monkeypatch):
    """A target 1e-13 from the eigenvalue 5 of A = diag(1, ..., 40), M = I:
    the real factor is usable, but the pairs beside 5 come back polluted.
    Their backward error (and the reference's residual relative to
    |lambda| + 1) misses the limit 10 atol by orders of magnitude, the
    solve is retried once at the offset shift, and its pairs are 4, 5, 6
    to 1e-12 with backward errors under the limit."""
    n, target, atol = 40, 5.0 + 1e-13, 1e-10
    sA = sp.diags([np.zeros(n - 1), np.arange(1.0, n + 1), np.zeros(n - 1)], [-1, 0, 1],
                  format="csr")
    A = CSRMatrix.from_scipy(sA, device=CPU)
    M = CSRMatrix(A.pattern, torch.as_tensor((sA.indices == A.pattern.row_ids) * 1.0))
    es = EigenSolver(A, M, EigensolverConfig(num_eig=3, atol=atol, ncv=12))
    es.set_st_type(STType.SINVERT)
    es.set_target(target)
    seen, worst = [], teigen.EigenSolver._worst_residual

    def spy(self, lam, result):
        pairs = list(zip([complex(v) for v in lam], result.eigenvectors))
        reference = (teigen.eigen_residuals(A, M, pairs) / (np.abs(lam) + 1.0)).max()
        seen.append((self.operator.sigma, worst(self, lam, result), reference))
        return seen[-1][1]

    monkeypatch.setattr(teigen.EigenSolver, "_worst_residual", spy)
    pairs = es.solve()
    limit = 10 * atol
    assert [s for s, _, _ in seen] == [target, target + 1e-3 * (1 + target)]
    assert seen[0][1] > 1e3 * limit and seen[0][2] > 1e3 * limit
    assert seen[1][1] <= limit
    assert np.abs(np.sort([p[0].real for p in pairs]) - [4.0, 5.0, 6.0]).max() <= 1e-12
    assert es.backward_errors(pairs).max() <= limit
