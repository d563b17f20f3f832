"""The Krylov and preconditioner menu and the eigensolver's other
spectral transforms against the JAX package, on the CPU at small sizes.

* Every KSP type x {none, jacobi, bjacobi, ilu, sor} on
  ``tests/unit/test_ksp_extra.py``'s seeded systems, each type on the
  system class the reference's own tests give it (MINRES: symmetric
  indefinite; CG, QCG, Chebyshev: SPD; Richardson: the dispatch test's
  SPD system; the rest: nonsymmetric).  A converged solve is held to
  ``numpy.linalg.solve`` (rel 1e-6 in x, true residual 1e-8); a pairing
  that does not converge (a nonsymmetric ILU or SSOR under BiCG or
  MINRES, ILU on the random SPD system, Richardson without a
  preconditioner) must say so: its flag agrees with its true residual.
* The GMRES shift-invert and STPRECOND pairs on
  ``tests/unit/test_eigen_si_paths.py``'s ``ns_case`` (Re = 50 saddle
  pencil) against the JAX package's pairs from its host-LU shift-invert,
  1e-8 (the JAX package's own GMRES route costs about 55 s of CPU an
  eigensolve here, three 40-step cycles an apply; its own test holds it
  to its LU route at 1e-6); the band solves counted against the GMRES
  steps, cycles and solves.
* ILU(0): the plan's triples exactly, the Chow-Patel values rel 1e-12.
* SA-AMG on test_amg.py's 24 x 24 Laplacian: P, R and the coarse
  operators exactly (both built on the host by the same scipy steps),
  one V-cycle rel 1e-12.
* p-MG on a P2 membrane: the coarse Galerkin operator exactly, one
  V-cycle against the JAX package's on an f32 band at nb = 128, rel 1e-5
  (two f32 factors of the coarse operator: the reference's and the
  port's pivoted one agree to f32 rounding, about 1e-6).
* The Chebyshev filter apply against the JAX package's, rel 1e-12;
  FILTER, SHIFT and SHELL on test_eigen.py's cases against their exact
  or dense answers (the answers the reference's own tests hold it to),
  1e-8 or tighter.
* Without a target the sensitivity's direct mode takes SHIFT: on a
  Navier-Stokes pencil M is singular, the JAX package's host LU of M
  raises, and the port raises ``FactorUnusable`` naming that reason.
* The Krylov-Newton baseflow (GMRES + block-Jacobi) on
  test_stokes_e2e.py's channel from a zero start, 1e-8 against the exact
  discrete flow (the JAX package's answer too).

The JAX side of an eigensolve or a Newton solve costs seconds of compiles
at every new size, so the file runs the JAX package where the parity
needs its numbers (its LU pairs of ns_case, ILU(0), AMG, p-MG, the
filter apply, the singular-M refusal) and holds the rest to exact
answers.

Band plans are unpadded (``chunk=1``), as in the other port tests.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg as sla
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

from lsafw_tpu.fem.bcs import BoundaryConditions as JBCs
from lsafw_tpu.fem.spaces import make_scalar_space as jmake_scalar_space
from lsafw_tpu.meshing.mesh import rectangle_mesh as jrectangle_mesh
from lsafw_tpu.ops.sparse import CSRMatrix as JCSR
from lsafw_tpu.sensitivity import EigenSensitivitySolver as JSensitivity
from lsafw_tpu.solver import amg as jamg
from lsafw_tpu.solver import band as jband
from lsafw_tpu.solver import eigen as jeigen
from lsafw_tpu.solver import ilu as jilu
from lsafw_tpu.solver import pmg as jpmg
from lsafw_tpu_torch import interop
from lsafw_tpu_torch.config import BoundaryConditionsConfig
from lsafw_tpu_torch.fem.assembly import AssemblyContext
from lsafw_tpu_torch.fem.bcs import define_bcs
from lsafw_tpu_torch.fem.spaces import define_spaces, make_scalar_space
from lsafw_tpu_torch.meshing.mesh import rectangle_mesh
from lsafw_tpu_torch.meshing.tags import facets_with_marker, mark_boundary_facets
from lsafw_tpu_torch.models.membrane import assemble_membrane_evp
from lsafw_tpu_torch.models.navier_stokes import LinearizedNavierStokesAssembler
from lsafw_tpu_torch.ops.sparse import CSRMatrix, spmv
from lsafw_tpu_torch.sensitivity import EigenSensitivitySolver
from lsafw_tpu_torch.solver import amg as tamg
from lsafw_tpu_torch.solver import band as tband
from lsafw_tpu_torch.solver import eigen as teigen
from lsafw_tpu_torch.solver import ilu as tilu
from lsafw_tpu_torch.solver import pmg as tpmg
from lsafw_tpu_torch.solver.baseflow import BaseFlowSolver
from lsafw_tpu_torch.solver.linear import KSPType, solve
from lsafw_tpu_torch.solver.precond import make_preconditioner
from tests.test_torch_fem import one_blas_thread  # noqa: F401
from tests.unit import test_amg as ref_amg
from tests.unit import test_ksp_extra as ref_ksp
from tests.unit import test_stokes_e2e as ref_stokes

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def small_plans():
    """Band plans of these small systems unpadded (chunk 1)."""
    mp = pytest.MonkeyPatch()
    mp.setitem(tband.plan_for_csr.__kwdefaults__, "chunk", 1)
    yield
    mp.undo()


def _port_csr(S: sp.spmatrix) -> CSRMatrix:
    S = sp.csr_matrix(S)
    S.sort_indices()
    return interop.csr_from_numpy(S.indptr, S.indices, S.data.copy(), S.shape, device="cpu")


def _dense_csr(D: np.ndarray) -> CSRMatrix:
    """A CSRMatrix of a dense matrix on its nonzeros and its diagonal
    (zero diagonal entries stored)."""
    P = sp.csr_matrix((D != 0) | np.eye(D.shape[0], dtype=bool))
    P.sort_indices()
    rows = np.repeat(np.arange(D.shape[0]), np.diff(P.indptr))
    return interop.csr_from_numpy(P.indptr, P.indices, D[rows, P.indices], D.shape, device="cpu")


# ---------------------------------------------------------------------------
# The KSP x PC menu
# ---------------------------------------------------------------------------

SYSTEMS = {"symmetric indefinite": lambda: ref_ksp._sym_indefinite(),
           "spd": lambda: ref_ksp._spd(), "spd80": lambda: ref_ksp._spd(80, seed=6),
           "nonsymmetric": lambda: ref_ksp._nonsym()}
SYSTEM_OF = {"minres": "symmetric indefinite", "cg": "spd", "qcg": "spd", "chebyshev": "spd",
             "richardson": "spd80"}
PCS = ("none", "jacobi", "bjacobi", "ilu", "sor")
# pairings that do not converge here, by design of the method or the PC
NOT_EXPECTED = {("bicg", "ilu"), ("bicg", "sor"), ("minres", "ilu"), ("cg", "ilu"),
                ("qcg", "ilu"), ("chebyshev", "ilu"), ("richardson", "none")}


@pytest.fixture(scope="module")
def ksp_systems():
    out = {}
    for name, make in SYSTEMS.items():
        D = make()
        b = D @ np.random.default_rng(2).standard_normal(D.shape[0])
        A = _dense_csr(D)
        out[name] = (D, b, A, A.transpose(), np.linalg.solve(D, b),
                     np.linalg.eigvalsh(0.5 * (D + D.T)))
    return out


@pytest.mark.parametrize("pc", PCS)
@pytest.mark.parametrize("ksp", [k.value for k in KSPType])
def test_ksp_menu_against_numpy(ksp_systems, ksp, pc):
    D, b, A, At, x_ref, w = ksp_systems[SYSTEM_OF.get(ksp, "nonsymmetric")]
    M = make_preconditioner(A, pc, block_size=32)
    bt = torch.as_tensor(b)
    # Chebyshev takes A's spectral bounds, also under a PC: slower there
    kw = dict(ksp_type=ksp, tol=1e-10, maxiter=1000 if ksp == "chebyshev" else 300, M=M,
              rmatvec=lambda v: spmv(At, v), lmin=float(w[0]), lmax=float(w[-1]))
    if ksp == "preonly":  # one PC apply
        if M is None:
            with pytest.raises(ValueError, match="PREONLY"):
                solve(lambda v: spmv(A, v), bt, **kw)
            return
        res = solve(lambda v: spmv(A, v), bt, **kw)
        assert torch.equal(res.x, M(bt)) and res.iterations == 1
        true = np.linalg.norm(D @ res.x.numpy() - b) / np.linalg.norm(b)
        assert res.residual == pytest.approx(true, rel=1e-10) and res.converged == (true < 1.0)
        return
    res = solve(lambda v: spmv(A, v), bt, **kw)
    x = res.x.numpy()
    true = np.linalg.norm(D @ x - b) / np.linalg.norm(b)
    if (ksp, pc) in NOT_EXPECTED:
        assert res.converged == bool(true <= 1e-8), (res.converged, true)
        return
    assert res.converged, (ksp, pc, res.residual, res.iterations)
    assert true <= 1e-8, true
    assert np.abs(x - x_ref).max() <= 1e-6 * np.abs(x_ref).max()


# ---------------------------------------------------------------------------
# GMRES shift-invert and STPRECOND on the saddle pencil
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ns():
    """ns_case (``tests/unit/test_eigen_si_paths.py``: the 10 x 10 unit
    square, walls, a pressure outlet at x = 1, Re = 50 about a zero
    baseflow) assembled by the port, and the JAX package's two pairs near
    0.5 from its host-LU shift-invert on the same (A, M) (ncv 20)."""
    mesh = rectangle_mesh((0.0, 0.0), (1.0, 1.0), 10, 10)

    def marker(x):
        out = np.ones(x.shape[0], np.int32)
        out[np.isclose(x[:, 0], 1.0)] = 2
        return out

    mark_boundary_facets(mesh, marker)
    spaces = define_spaces(mesh)
    bcs = define_bcs(mesh, spaces, [
        BoundaryConditionsConfig(marker=1, type="dirichlet_velocity", value=(0.0, 0.0)),
        BoundaryConditionsConfig(marker=2, type="dirichlet_pressure", value=0.0)])
    ctx = AssemblyContext.build(spaces, device="cpu")
    A, M = LinearizedNavierStokesAssembler(np.zeros(spaces.num_dofs), ctx, 50.0, bcs,
                                           mesh).assemble_eigensystem()
    JA, JM = JCSR.from_scipy(A.to_scipy()), JCSR.from_scipy(M.to_scipy())
    es = jeigen.EigenSolver(JA, JM, jeigen.EigensolverConfig(num_eig=2, atol=1e-9, ncv=20))
    es.set_st_type(jeigen.STType.SINVERT)
    es.set_target(0.5)
    es.set_st_pc_type("lu")
    jpairs = es.solve()
    return JA, JM, A, M, sorted(jpairs, key=lambda p: -p[0].real), (ctx, bcs)


def _counted_solves(mp):
    seen = {"n": 0}
    solve_ = tband._PermutedSolve.solve

    def counted(self, b):
        seen["n"] += 1
        return solve_(self, b)

    mp.setattr(tband._PermutedSolve, "solve", counted)
    return seen


@pytest.mark.parametrize("route", ["gmres", "precond"])
def test_gmres_shift_invert_matches_jax(ns, route, monkeypatch):
    """``set_st_pc_type("gmres")`` at the real target 0.5 (a real band
    factor, complex vectors as two columns) and STPRECOND at 0.4 + 0.05j
    (a complex factor): the pairs near 0.393 and -0.296 against the JAX
    package's, 1e-8; one band solve per GMRES preconditioner apply (M b
    once a solve, one a step, one a cycle), no host LU."""
    _, _, A, M, jpairs, _ = ns
    monkeypatch.setattr(teigen, "SparseLU", None)  # no host LU
    seen = _counted_solves(monkeypatch)
    es = teigen.EigenSolver(A, M, teigen.EigensolverConfig(num_eig=2, atol=1e-9, ncv=20))
    if route == "gmres":
        es.set_st_type(teigen.STType.SINVERT)
        es.set_target(0.5)
        es.set_st_pc_type("gmres")
    else:
        es.set_st_type(teigen.STType.PRECOND)
        es.set_target(0.4 + 0.05j)
    pairs = es.solve()
    f = es.operator.figures()
    assert es.operator.method == "gmres" and f["gmres_solves"] == f["applies"] > 0
    assert seen["n"] == f["gmres_its"] + f["gmres_cycles"] + f["gmres_solves"]
    lam = sorted((p[0] for p in pairs), key=lambda z: -z.real)
    for got, (ref, _) in zip(lam, jpairs):
        assert abs(got - ref) <= 1e-8, (got, ref)
    res = teigen.eigen_residuals(A, M, pairs)
    assert (res / (np.abs([p[0] for p in pairs]) + 1.0) < 1e-8).all()


# ---------------------------------------------------------------------------
# ILU(0), SA-AMG, p-MG
# ---------------------------------------------------------------------------


def test_ilu0_factor_values_match_jax(ns):
    """The Chow-Patel plan of ns_case's A (zero pressure diagonals: unit
    pivots) exactly, its eight sweeps rel 1e-12."""
    JA, _, A, _, _, _ = ns
    pattern = sp.csr_matrix((np.ones(A.pattern.nnz), A.pattern.indices, A.pattern.indptr),
                            shape=A.shape)
    jplan = jilu.ILU0Plan.build(pattern)
    tplan = tilu.ILU0Plan.build(pattern)
    for name in ("tr_e", "tr_p", "tr_q", "is_lower", "diag_of_col", "diag_slots"):
        assert np.array_equal(np.asarray(getattr(jplan, name)), getattr(tplan, name)), name
    jv = np.asarray(jilu.ilu0_factor_values(jplan, JA.data, sweeps=8))
    tv = tilu.ilu0_factor_values(tplan, A.data, sweeps=8).numpy()
    assert np.abs(tv - jv).max() <= 1e-12 * np.abs(jv).max()


def test_ilu0_sweep_is_a_segmented_sum(ns):
    """``tr_len`` counts each slot's run of triples in ``tr_e``; one sweep
    equals the scatter-add of the same products onto their slots (rel
    1e-14), and eight sweeps are bit-identical on a second call."""
    _, _, A, _, _, _ = ns
    plan = tilu.ILU0Plan.build(sp.csr_matrix(
        (np.ones(A.pattern.nnz), A.pattern.indices, A.pattern.indptr), shape=A.shape))
    assert np.array_equal(plan.tr_len, np.bincount(plan.tr_e, minlength=plan.nnz))
    a = A.data.clone()
    d = a[plan.diag_slots]
    a[plan.diag_slots] = torch.where(d.abs() > 0, d, torch.ones_like(d))
    tr_e, tr_p, tr_q = (torch.as_tensor(getattr(plan, k)) for k in ("tr_e", "tr_p", "tr_q"))
    new = a - torch.zeros_like(a).index_add_(0, tr_e, a[tr_p] * a[tr_q])
    ujj = a[plan.diag_of_col]
    ujj = torch.where(ujj.abs() > 1e-300, ujj, torch.ones_like(ujj))
    ref = torch.where(torch.as_tensor(plan.is_lower), new / ujj, new)
    got = tilu.ilu0_factor_values(plan, A.data, sweeps=1)
    assert float((got - ref).abs().max()) <= 1e-14 * float(ref.abs().max())
    assert torch.equal(tilu.ilu0_factor_values(plan, A.data),
                       tilu.ilu0_factor_values(plan, A.data))


def test_square_products_go_through_s(ns, monkeypatch):
    """ILU(0), SSOR, ``solve_csr`` (A and A^T), the AMG levels' smoothing
    and residuals and the pMG fine operator apply their square operators
    through S (``spmv_cuda.csr_spmv``); the CSR product serves AMG's
    rectangular transfers alone."""
    from lsafw_tpu_torch.ops import bcsr, spmv_cuda
    from lsafw_tpu_torch.solver.linear import solve_csr

    calls = {"S": 0, "csr": []}
    csr_spmv = spmv_cuda.csr_spmv

    def s_counted(*args, **kw):
        calls["S"] += 1
        return csr_spmv(*args, **kw)

    def csr_counted(M, x):
        calls["csr"].append(M.shape)
        return M.torch_csr() @ x

    monkeypatch.setattr(spmv_cuda, "csr_spmv", s_counted)
    for mod in (bcsr, tamg):
        monkeypatch.setattr(mod, "spmv", csr_counted)
    _, _, A, _, _, _ = ns
    b = torch.as_tensor(np.random.default_rng(3).standard_normal(A.shape[0]))
    tilu.ilu0(A, apply_sweeps=2)(b)
    tilu.ssor(A, sweeps=2)(b)
    assert calls["S"] == 8  # two sweeps with L and two with U, each
    res = solve_csr(A, b, ksp_type="bicg", maxiter=3)
    assert calls["S"] >= 8 + 2 * res.iterations and not calls["csr"]
    S = ref_amg._laplacian_2d(24)
    h = tamg.build_amg(_port_csr(S), coarse_size=100)
    calls["S"] = 0
    tamg._vcycle(h, torch.as_tensor(np.random.default_rng(4).standard_normal(S.shape[0])))
    assert calls["S"] == 5 * len(h.levels)  # 2 + 2 smoothing steps and 1 residual a level
    assert calls["csr"] and all(m != n for m, n in calls["csr"])
    mesh = rectangle_mesh((0.0, 0.0), (1.0, 1.0), 4, 4)
    K, _, mask = assemble_membrane_evp(mesh, device="cpu")
    pc = tpmg.build_pmg_pc(make_scalar_space(mesh, "p2"), K, mask, nb=128)
    calls["S"] = 0
    pc.apply(torch.as_tensor(np.where(mask, 0.0, 1.0)))
    assert calls["S"] == 2 * pc.smooth_steps + 1


def _same(a: sp.spmatrix, b: sp.spmatrix) -> bool:
    a, b = sp.csr_matrix(a), sp.csr_matrix(b)
    return a.shape == b.shape and (abs(a - b).max() == 0 if (a.nnz or b.nnz) else True)


def test_amg_hierarchy_matches_jax():
    """test_amg.py's 5-point Laplacian at 24 x 24, coarse size 100: each
    level's operator, P and R exactly; one V-cycle rel 1e-12."""
    S = ref_amg._laplacian_2d(24)
    jh = jamg.build_amg(JCSR.from_scipy(S), coarse_size=100)
    A = _port_csr(S)
    th = tamg.build_amg(A, coarse_size=100)
    assert len(jh.levels) == len(th.levels) >= 2
    for jl, tl in zip(jh.levels, th.levels):
        for name in ("A", "P", "R"):
            assert _same(getattr(jl, name).to_scipy(), getattr(tl, name).to_scipy()), name
    assert np.array_equal(np.asarray(jh.coarse_inv), th.coarse_inv.numpy())
    r = np.random.default_rng(4).standard_normal(S.shape[0])
    jy = np.asarray(jamg.amg_preconditioner(JCSR.from_scipy(S), coarse_size=100)(jnp.asarray(r)))
    ty = tamg._vcycle(th, torch.as_tensor(r)).numpy()
    assert np.abs(ty - jy).max() <= 1e-12 * np.abs(jy).max()


def test_pmg_matches_jax(monkeypatch):
    """A P2 membrane on a 10 x 10 unit square (the port's K carried into
    the JAX package): the coarse Galerkin operator and Dirichlet mask
    exactly; one V-cycle against the JAX package's, both on an unpadded
    f32 band at nb = 128, rel 1e-5."""
    monkeypatch.setitem(jband.plan_for_csr.__kwdefaults__, "chunk", 1)
    jmesh = jrectangle_mesh((0.0, 0.0), (1.0, 1.0), 10, 10)
    mesh = rectangle_mesh((0.0, 0.0), (1.0, 1.0), 10, 10)
    K, _, mask = assemble_membrane_evp(mesh, device="cpu")
    JK = JCSR.from_scipy(K.to_scipy())
    jpc = jpmg.build_pmg_pc(jmake_scalar_space(jmesh, "p2"), JK, mask, nb=128)
    tpc = tpmg.build_pmg_pc(make_scalar_space(mesh, "p2"), K, mask, nb=128)
    nv, ne = mesh.num_vertices, mesh.edges.shape[0]
    e0, e1 = mesh.edges[:, 0], mesh.edges[:, 1]
    assert np.array_equal(jmesh.edges, mesh.edges)
    jA1, jbc1 = jpmg._coarse_galerkin(JK, nv, ne, 1, e0, e1, mask)
    tA1, tbc1 = tpmg._coarse_galerkin(K, nv, ne, 1, e0, e1, mask)
    assert _same(jA1, tA1) and _same(tpc.coarse_matrix.to_scipy(), tA1)
    assert np.array_equal(jbc1, tbc1)
    r = np.where(mask, 0.0, np.random.default_rng(5).standard_normal(K.shape[0]))
    jy = np.asarray(jax.jit(lambda pc, v: pc.apply(v))(jpc, jnp.asarray(r)))
    ty = tpc.apply(torch.as_tensor(r)).numpy()
    assert np.abs(ty - jy).max() <= 1e-5 * np.abs(jy).max()


# ---------------------------------------------------------------------------
# FILTER, SHIFT, SHELL
# ---------------------------------------------------------------------------


def _laplacian_1d(n=120):
    return sp.csr_matrix(sp.diags([2.0 * np.ones(n), -np.ones(n - 1), -np.ones(n - 1)],
                                  [0, -1, 1]))


def test_chebyshev_filter_matches_jax():
    """test_eigen.py's FILTER case (the 1D Laplacian, n = 120, cutoff twice
    the third eigenvalue): the degree-20 filter apply against the JAX
    package's, rel 1e-12; at degree 60 the port's three lowest eigenvalues against the
    exact ones, 1e-8 (the reference's own test holds its FILTER to them at
    rel 1e-6)."""
    S = _laplacian_1d()
    JA, A = JCSR.from_scipy(S), _port_csr(S)
    exact = 2.0 - 2.0 * np.cos(np.arange(1, 4) * np.pi / 121)
    v = np.random.default_rng(6).standard_normal((2, S.shape[0]))
    jop = jeigen.ChebyshevFilterOperator(JA, float(2 * exact[-1]), degree=20)
    top = teigen.ChebyshevFilterOperator(A, float(2 * exact[-1]), degree=20)
    assert top.lam_max == pytest.approx(jop._c + jop._e, rel=1e-13)
    jw = jop.apply((jnp.asarray(v[0]), jnp.asarray(v[1])))
    jw = np.asarray(jw[0]) + 1j * np.asarray(jw[1])
    tw = top.apply(torch.as_tensor(v[0] + 1j * v[1])).numpy()
    assert np.abs(tw - jw).max() <= 1e-12 * np.abs(jw).max()
    es = teigen.EigenSolver(A, None, teigen.EigensolverConfig(num_eig=3, atol=1e-10, ncv=20))
    es.set_st_type(teigen.STType.FILTER)
    es.set_target(float(exact[-1] * 2.0))
    es.set_which_eigenpairs(teigen.EpsWhich.SMALLEST_REAL)
    es.set_filter_degree(60)
    got = np.sort([p[0].real for p in es.solve()])
    assert np.abs(got - exact).max() <= 1e-8


@pytest.mark.parametrize("case", ["diagonal", "generalized"])
def test_shift(case, monkeypatch):
    """SHIFT, largest magnitude, on test_eigen.py's diagonal 1..20 (M =
    None) and on its random SPD pencil with a diagonal M (M^-1 a real band
    factor with the checked refinement, no host LU): the three largest
    eigenvalues against the dense answer, 1e-8, and the residuals."""
    if case == "diagonal":
        Ad, Md = np.diag(np.arange(1.0, 21.0)), None
        ref = np.arange(20.0, 17.0, -1.0)
    else:
        rng = np.random.default_rng(3)
        Q = rng.standard_normal((40, 40))
        Ad, Md = Q @ Q.T + 40 * np.eye(40), np.diag(rng.uniform(1.0, 2.0, 40))
        ref = np.sort(sla.eigh(Ad, Md, eigvals_only=True))[::-1][:3]
    monkeypatch.setattr(teigen, "SparseLU", None)
    A, M = _dense_csr(Ad), None if Md is None else _dense_csr(Md)
    es = teigen.EigenSolver(A, M, teigen.EigensolverConfig(num_eig=3, atol=1e-10, ncv=12))
    es.set_which_eigenpairs(teigen.EpsWhich.LARGEST_MAGNITUDE)
    pairs = es.solve()
    got = np.array([p[0].real for p in pairs])
    assert np.abs(got - ref).max() <= 1e-8 * ref[0]  # in the selection's order
    assert (teigen.eigen_residuals(A, M, pairs) <= 1e-8 * (np.abs(got) + 1.0)).all()
    if M is not None:
        f = es.operator.figures()
        assert f["applies"] > 0 and f["refine_its"] >= 4


def test_shell():
    """test_eigen.py's SHELL case: a hand-rolled shift-invert (the caller's
    host LU) with its back-transform gives the two eigenvalues nearest
    4.03, against the dense answer, rel 1e-9."""
    rng = np.random.default_rng(6)
    n = 60
    D = np.sort(rng.uniform(1.0, 10.0, n))
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    Ad = Q @ np.diag(D) @ Q.T
    sigma = 4.03
    lu = spla.splu(sp.csc_matrix((Ad - sigma * np.eye(n)).astype(np.complex128)))
    es = teigen.EigenSolver(_dense_csr(Ad), None,
                            teigen.EigensolverConfig(num_eig=2, atol=1e-10, ncv=20))
    es.set_st_shell(lambda v: torch.as_tensor(lu.solve(v.numpy())),
                    back_transform=lambda t: sigma + 1.0 / t)
    assert es._st_type is teigen.STType.SHELL
    got = np.sort([p[0].real for p in es.solve()])
    ref = np.sort(D[np.argsort(np.abs(D - sigma))[:2]])
    assert np.abs(got - ref).max() <= 1e-9 * ref.max()


def test_untargeted_direct_mode_on_a_navier_stokes_pencil(ns):
    """Without a target both packages take SHIFT (M^-1 A) and the pair of
    largest real part.  ns_case's M is zero on its pressure block and its
    Dirichlet rows: the JAX package's host LU of M fails, and the port
    raises ``FactorUnusable`` naming the singular M before any factor."""
    JA, JM, A, M, _, (ctx, bcs) = ns
    n = A.shape[0]
    jbcs = JBCs(num_dofs=n, dirichlet_mask=bcs.dirichlet_mask, dirichlet_values=np.zeros(n))
    jsolver = JSensitivity(None, None, jbcs, np.zeros(n), 50.0, A=JA, M=JM)
    with pytest.raises(RuntimeError, match="singular"):
        jsolver.solve_direct_mode()
    tsolver = EigenSensitivitySolver(ctx, None, bcs, np.zeros(n), 50.0, A=A, M=M, device="cpu")
    assert teigen.zero_rows(M) > 0
    with pytest.raises(teigen.FactorUnusable, match="M is singular"):
        tsolver.solve_direct_mode()


# ---------------------------------------------------------------------------
# The Krylov Newton baseflow
# ---------------------------------------------------------------------------


def test_krylov_newton_baseflow():
    """test_stokes_e2e.py's channel (a Poiseuille inlet, walls, a free
    outlet, Re = 10) from a zero start: Newton with GMRES + block-Jacobi(64)
    inner solves (and the Stokes guess by the same Krylov solve, no host
    LU) reaches the exact discrete flow, 1e-8 (Poiseuille is in the
    Taylor-Hood space, so it is the JAX package's answer as well)."""
    mesh = rectangle_mesh((0.0, 0.0), (2.0, 1.0), 12, 6)

    def marker(x):
        out = np.full(x.shape[0], ref_stokes.WALL, dtype=np.int32)
        out[np.isclose(x[:, 0], 0.0)] = ref_stokes.INLET
        out[np.isclose(x[:, 0], 2.0)] = ref_stokes.OUTLET
        return out

    mark_boundary_facets(mesh, marker)
    spaces = define_spaces(mesh)
    bcs = define_bcs(mesh, spaces, [BoundaryConditionsConfig(
        marker=ref_stokes.WALL, type="dirichlet_velocity", value=(0.0, 0.0))])
    dofs = spaces.velocity.dofs_on_facets(facets_with_marker(mesh, ref_stokes.INLET))
    y = spaces.velocity.dof_coords[dofs][:, 1]
    bcs.dirichlet_mask[dofs] = True
    bcs.dirichlet_values[dofs] = np.where(dofs % 2 == 0, y * (1.0 - y), 0.0)
    u = spaces.velocity.interpolate(
        lambda p: np.stack([p[:, 1] * (1 - p[:, 1]), np.zeros(p.shape[0])], axis=1))
    p = spaces.pressure.interpolate(lambda x: 2.0 * (2.0 - x[:, 0]) / ref_stokes.RE)
    exact = np.concatenate([u, p])
    solver = BaseFlowSolver(AssemblyContext.build(spaces, device="cpu"), mesh, bcs,
                            re=ref_stokes.RE)
    solver._initial_guess = np.zeros(spaces.num_dofs)
    w = solver.solve(tol=1e-10, linear_solver="gmres")
    assert solver.newton_results[-1].iterations >= 2 and solver.stats["krylov_its"] > 0
    assert np.abs(w - exact).max() <= 1e-8
    with pytest.raises(ValueError):
        BaseFlowSolver(solver._ctx, mesh, bcs, re=ref_stokes.RE).solve(linear_solver="nope")
