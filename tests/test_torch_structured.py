"""The structured stencil / multigrid / LOBPCG path and the element
operator of the port against the JAX package, on the CPU at small sizes.

* Stencil structures (``build_stencil_operator`` on the 9-class
  Taylor-Hood 4 x 4 rectangle and the scalar P2 8 x 16 membrane,
  ``build_stencil_nd`` on the P2 2^3 box): ``perm``, ``inv_perm``, the
  buckets and ``nnz_slot`` exactly equal to the JAX package's (its
  structure routine is numpy, called directly); the products rel 1e-13 against
  the JAX package's (one jitted matvec each; with Dirichlet rows, the
  CSR product with the rows and columns eliminated) and the CSR product.
* One V-cycle of ``MultigridPC`` and of ``MultigridNDPC`` (2D) on the
  8 x 16 membrane, rel 1e-12 against the JAX package's V-cycle on the
  same hierarchy (its stencil construction on the port's level data).
* LOBPCG on that membrane: ``lobpcg_smallest`` (Jacobi) against the JAX
  package's, lambda rel 1e-10, residual <= tol, iterations within 2;
  ``lobpcg_smallest_pc`` with the port's multigrid against that lambda
  (rel 1e-10) and scipy's, residual <= tol, fewer than 60 iterations;
  ``lobpcg_block_pc`` (m = 2) against scipy's ``eigsh``, 1e-8;
  ``shift_invert_power`` against the JAX package's, 1e-10.  The Ritz
  solver differs by design (``torch.linalg.eigh``, the reference's
  Jacobi sweeps), so only values are held to the JAX package.
* ``ElementOperator`` / ``CElementOperator`` against the JAX package's
  and the assembled CSR, 1e-12, bit-identical on a second apply.
* ``ell_of_csr`` exactly; ``galerkin_pair`` against scipy's triple
  products with every diagonal present, and with an exactly cancelling
  entry, which keeps its slot (the JAX package's union pattern loses it:
  a reference fault this test does not enshrine); ``DiagSIPC.from_pair``
  with ``press_reg`` passed explicitly against the JAX package's.
* The reference faults' repairs: ``TwoGridSIPC`` with a bare band and no
  ``Cop`` raises ``ValueError``; ``_with_sigma`` refuses an ``op.Cop``
  beside a retargetable preconditioner ``Cop``.

The JAX side compiles its programs on first use (seconds each), so the
file calls each JAX function once, jitted where the call is a product.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

from lsafw_tpu.fem.spaces import define_spaces as jdefine_spaces
from lsafw_tpu.fem.spaces import make_scalar_space as jmake_scalar_space
from lsafw_tpu.meshing.mesh import box_mesh as jbox_mesh
from lsafw_tpu.meshing.mesh import rectangle_mesh as jrectangle_mesh
from lsafw_tpu.ops import elementop as jelementop
from lsafw_tpu.ops import sparse as jsparse
from lsafw_tpu.ops import stencil as jstencil
from lsafw_tpu.ops import stencil_nd as jstencil_nd
from lsafw_tpu.solver import eigen as jeigen
from lsafw_tpu.solver import multigrid as jmultigrid
from lsafw_tpu.solver import multigrid_nd as jmultigrid_nd
from lsafw_tpu.solver import power as jpower
from lsafw_tpu_torch.fem.spaces import define_spaces, make_scalar_space
from lsafw_tpu_torch.interop import csr_from_numpy
from lsafw_tpu_torch.meshing.mesh import box_mesh, rectangle_mesh
from lsafw_tpu_torch.models.membrane import analytic_eigenvalues, assemble_membrane_evp
from lsafw_tpu_torch.ops.elementop import CElementOperator, ElementOperator
from lsafw_tpu_torch.ops.sparse import CSRMatrix, build_sparsity, spmv
from lsafw_tpu_torch.ops.stencil import build_stencil_operator
from lsafw_tpu_torch.ops.stencil_nd import build_stencil_nd
from lsafw_tpu_torch.solver import eigen as teigen
from lsafw_tpu_torch.solver.multigrid import build_multigrid_pc
from lsafw_tpu_torch.solver.multigrid_nd import build_multigrid_nd_pc
from lsafw_tpu_torch.solver.power import (lobpcg_block_pc, lobpcg_smallest, lobpcg_smallest_pc,
                                          shift_invert_power)
from tests.test_torch_fem import one_blas_thread  # noqa: F401

torch.set_num_threads(1)

REL = 1e-13


def _rel(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _t(a) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a))


def _structures_equal(js, ts) -> None:
    """The port's stencil structure equals the JAX package's exactly."""
    assert (ts.n, ts.num_classes, ts.pad, ts.coeff_size) == (js.n, js.num_classes, js.pad,
                                                            js.coeff_size)
    assert ts.class_shapes == js.class_shapes and ts.class_bases == js.class_bases
    assert ts.buckets == js.buckets and ts.bucket_slices == js.bucket_slices
    for name in ("perm", "inv_perm", "nnz_slot"):
        np.testing.assert_array_equal(getattr(ts, name), getattr(js, name))


def _jcsr(pattern, data) -> jsparse.CSRMatrix:
    """The JAX package's CSRMatrix of the same arrays."""
    return jsparse.CSRMatrix(jsparse.SparsityPattern(
        shape=pattern.shape, indptr=pattern.indptr, indices=pattern.indices,
        slots=pattern.slots), jnp.asarray(np.asarray(data)))


@pytest.fixture(scope="module")
def th():
    """The 9-class Taylor-Hood 4 x 4 rectangle in both packages, random
    values on its pattern and a random Dirichlet mask (numpy seeds)."""
    mesh = rectangle_mesh((0.0, 0.0), (2.0, 1.0), 4, 4)
    jmesh = jrectangle_mesh((0.0, 0.0), (2.0, 1.0), 4, 4)
    spaces, jspaces = define_spaces(mesh), jdefine_spaces(jmesh)
    n = spaces.num_dofs
    pat = build_sparsity(spaces.mixed_cell_dofs, shape=(n, n))
    jpat = jsparse.build_sparsity(jspaces.mixed_cell_dofs, shape=(n, n))
    np.testing.assert_array_equal(pat.indices, jpat.indices)
    rng = np.random.default_rng(0)
    return dict(spaces=spaces, jspaces=jspaces, pat=pat, jpat=jpat,
                data=rng.standard_normal(pat.nnz), x=rng.standard_normal(n),
                mask=rng.random(n) < 0.2, Ael=rng.standard_normal((mesh.num_cells, 15, 15)),
                Eim=rng.standard_normal((mesh.num_cells, 15, 15)),
                z=rng.standard_normal(n) + 1j * rng.standard_normal(n))


@pytest.fixture(scope="module")
def membrane():
    """The scalar P2 membrane of the 2 x 4 rectangle on an 8 x 16 grid: the
    port's (K, M) (the JAX package's assembly is the same numbers) and both
    packages' spaces."""
    mesh = rectangle_mesh((0.0, 0.0), (2.0, 4.0), 8, 16)
    K, M, mask = assemble_membrane_evp(mesh, device="cpu")
    jmesh = jrectangle_mesh((0.0, 0.0), (2.0, 4.0), 8, 16)
    return dict(mesh=mesh, jmesh=jmesh, K=K, M=M, mask=mask,
                space=make_scalar_space(mesh, "p2"), jspace=jmake_scalar_space(jmesh, "p2"),
                JK=_jcsr(K.pattern, K.data.numpy()), JM=_jcsr(K.pattern, M.data.numpy()),
                r=np.where(mask, 0.0, np.random.default_rng(3).standard_normal(K.shape[0])))


@pytest.mark.parametrize("bc", [False, True])
def test_taylor_hood_stencil_matches_jax_and_csr(th, bc):
    mask = th["mask"] if bc else None
    op = build_stencil_operator(th["pat"], th["data"], th["spaces"], bc_mask=mask, device="cpu")
    jop = jstencil.build_stencil_operator(th["jpat"], th["data"], th["jspaces"], bc_mask=mask)
    _structures_equal(jop.structure, op.structure)
    assert op.structure.num_classes == 9
    x = th["x"]
    y = op.unpack(op.matvec(op.pack(_t(x)))).numpy()
    A = sp.csr_matrix((th["data"], th["pat"].indices, th["pat"].indptr), shape=th["pat"].shape)
    if bc:  # Dirichlet elimination: BC columns zeroed, BC rows the identity (the JAX
        # package's matvec is held to the same product by tests/unit/test_stencil.py)
        keep = sp.diags((~mask).astype(float))
        A = keep @ A @ keep + sp.diags(mask.astype(float))
    else:
        jy = jax.jit(lambda o, v: o.unpack(o.matvec(o.pack(v))))(jop, jnp.asarray(x))
        assert _rel(y, jy) < REL
    assert _rel(y, A @ x) < REL


def test_p2_and_3d_stencils_match_jax_and_csr(membrane):
    K, space = membrane["K"], membrane["space"]
    op = build_stencil_operator(K.pattern, K.data, [(space, 1)])
    jop = jstencil.build_stencil_operator(membrane["JK"].pattern, np.asarray(membrane["JK"].data),
                                          [(membrane["jspace"], 1)])
    _structures_equal(jop.structure, op.structure)
    x = membrane["r"]
    y = op.unpack(op.matvec(op.pack(_t(x)))).numpy()
    jy = np.asarray(jax.jit(lambda o, v: o.unpack(o.matvec(o.pack(v))))(jop, jnp.asarray(x)))
    assert _rel(y, jy) < REL and _rel(y, K.to_scipy() @ x) < REL
    mesh3 = box_mesh((0, 0, 0), (1, 1, 1), 2, 2, 2)
    jmesh3 = jbox_mesh((0, 0, 0), (1, 1, 1), 2, 2, 2)
    K3, _, mask3 = assemble_membrane_evp(mesh3, device="cpu")
    sp3, jsp3 = make_scalar_space(mesh3, "p2"), jmake_scalar_space(jmesh3, "p2")
    o3 = build_stencil_nd(K3.pattern, K3.data, [(sp3, 1)], bc_mask=mask3)
    jK3 = _jcsr(K3.pattern, K3.data.numpy())
    jo3 = jstencil_nd.build_stencil_nd(jK3.pattern, np.asarray(jK3.data), [(jsp3, 1)],
                                       bc_mask=mask3)
    _structures_equal(jo3.structure, o3.structure)
    assert o3.structure.ndim == 3 and o3.structure.num_classes == 8
    x3 = np.random.default_rng(4).standard_normal(K3.shape[0])
    y3 = o3.unpack(o3.matvec(o3.pack(_t(x3)))).numpy()
    jy3 = np.asarray(jax.jit(lambda o, v: o.unpack(o.matvec(o.pack(v))))(jo3, jnp.asarray(x3)))
    assert _rel(y3, jy3) < REL and _rel(y3, K3.to_scipy() @ x3) < REL


def _jax_pc(pc, membrane, nd: bool):
    """The JAX package's V-cycle on the port's hierarchy: its stencil
    construction on the same P2 and P1 level data (the level structures
    held equal to the port's), the port's Jacobi diagonals and coarse
    inverse (its P1 assembly is the same numbers, and costs a compile a
    level)."""
    from lsafw_tpu_torch.solver.multigrid import p1_level

    build, jbuild = ((build_stencil_nd, jstencil_nd.build_stencil_nd) if nd else
                     (build_stencil_operator, jstencil.build_stencil_operator))
    K, mask, (x0, y0), (x1, y1) = (membrane["K"], membrane["mask"],
                                   membrane["mesh"].vertices.min(axis=0),
                                   membrane["mesh"].vertices.max(axis=0))
    jop2 = jbuild(membrane["JK"].pattern, K.data.numpy(), [(membrane["jspace"], 1)],
                  bc_mask=mask, bc_diag=1.0)
    jops1 = []
    for op1 in pc.ops1:
        nx, ny = (s - 1 for s in op1.structure.class_shapes[0])
        K1, space1, _ = p1_level(rectangle_mesh((x0, y0), (x1, y1), nx, ny), "cpu")
        jspace1 = jmake_scalar_space(jrectangle_mesh((x0, y0), (x1, y1), nx, ny), "p1")
        jops1.append(jbuild(_jcsr(K1.pattern, K1.data).pattern, K1.data.numpy(),
                            [(jspace1, 1)]))
        _structures_equal(jops1[-1].structure, op1.structure)
        np.testing.assert_array_equal(np.asarray(jops1[-1].coeffs), op1.coeffs.numpy())
    kw = dict(op2=jop2, inv_diag2=jnp.asarray(pc.inv_diag2.numpy()), ops1=tuple(jops1),
              inv_diags1=tuple(jnp.asarray(d.numpy()) for d in pc.inv_diags1),
              coarse_inv=jnp.asarray(pc.coarse_inv.numpy()), omega=pc.omega,
              smooth_steps=pc.smooth_steps)
    if nd:
        return jmultigrid_nd.MultigridNDPC(dirs=pc.dirs, **kw)
    return jmultigrid.MultigridPC(**kw)


@pytest.mark.parametrize("nd", [False, True])
def test_vcycle_matches_jax(membrane, nd):
    """One V-cycle (one smoothing step of omega 0.7 a level, two P1 levels:
    the JAX side's compile grows with the unrolled steps) on the packed
    layout, rel 1e-12."""
    pc = (build_multigrid_nd_pc if nd else build_multigrid_pc)(
        membrane["mesh"], membrane["K"], membrane["mask"], smooth_steps=1)
    jpc = _jax_pc(pc, membrane, nd)
    assert len(pc.ops1) == 2
    r = pc.op2.pack(_t(membrane["r"]))
    y = pc.apply(r).numpy()
    jy = np.asarray(jax.jit(lambda p, v: p.apply(v))(jpc, jnp.asarray(r.numpy())))
    assert _rel(y, jy) < 1e-12


@pytest.fixture(scope="module")
def mg_ops(membrane):
    K, M, space, mask = membrane["K"], membrane["M"], membrane["space"], membrane["mask"]
    Kop = build_stencil_operator(K.pattern, K.data, [(space, 1)], bc_mask=mask, bc_diag=1.0)
    Mop = build_stencil_operator(K.pattern, M.data, [(space, 1)], bc_mask=mask, bc_diag=0.0)
    jKop = jstencil.build_stencil_operator(membrane["JK"].pattern, np.asarray(membrane["JK"].data),
                                           [(membrane["jspace"], 1)], bc_mask=mask, bc_diag=1.0)
    jMop = jstencil.build_stencil_operator(membrane["JK"].pattern, np.asarray(membrane["JM"].data),
                                           [(membrane["jspace"], 1)], bc_mask=mask, bc_diag=0.0)
    perm = Kop.structure.perm
    lam = np.sort(spla.eigsh(K.to_scipy(), k=2, M=M.to_scipy(), sigma=2.0,
                             return_eigenvectors=False))
    return dict(Kop=Kop, Mop=Mop, jKop=jKop, jMop=jMop, perm=perm, lam=lam)


def _inv(d: np.ndarray) -> np.ndarray:
    return np.where(np.abs(d) > 0, 1.0 / np.where(d == 0, 1, d), 1.0)


def test_lobpcg_matches_jax(membrane, mg_ops):
    """Jacobi LOBPCG: lambda rel 1e-10 against the JAX package's, residual
    <= tol, iterations within 2; LOBPCG with the port's multigrid: lambda
    rel 1e-10 against both, fewer than 60 iterations."""
    K, perm = membrane["K"], mg_ops["perm"]
    inv = _inv(K.diagonal().numpy()[perm])
    x0 = np.random.default_rng(1).standard_normal(K.shape[0])
    tol = 1e-10
    res = lobpcg_smallest(mg_ops["Kop"], mg_ops["Mop"], _t(x0), _t(inv), tol=tol, max_iter=2000)
    jres = jpower.lobpcg_smallest(mg_ops["jKop"], mg_ops["jMop"], jnp.asarray(x0),
                                  jnp.asarray(inv), tol=tol, max_iter=2000)
    jlam = float(jres.eigenvalue)
    assert abs(res.eigenvalue - jlam) / jlam < 1e-10
    assert res.residual <= tol and abs(res.iterations - int(jres.iterations)) <= 2
    assert abs(jlam - mg_ops["lam"][0]) / jlam < 1e-10
    pc = build_multigrid_pc(membrane["mesh"], K, membrane["mask"])
    r = lobpcg_smallest_pc(pc.op2, mg_ops["Mop"], pc.op2.pack(_t(membrane["r"])), pc, tol=tol,
                           max_iter=100)
    assert abs(r.eigenvalue - jlam) / jlam < 1e-10 and r.residual <= tol and r.iterations < 60


def test_block_lobpcg_and_power_iteration(membrane, mg_ops):
    """``lobpcg_block_pc`` (m = 2, multigrid) against scipy's eigsh, 1e-8,
    every residual <= tol; ``shift_invert_power`` (60 Jacobi-CG steps a
    solve at this size) against the JAX package's, rel 1e-10, and the
    analytic value within the grid's P2 error."""
    K, M, mask, perm = membrane["K"], membrane["M"], membrane["mask"], mg_ops["perm"]
    pc = build_multigrid_pc(membrane["mesh"], K, mask)
    rng = np.random.default_rng(2)
    X0 = torch.stack([pc.op2.pack(_t(np.where(mask, 0.0, rng.standard_normal(K.shape[0]))))
                      for _ in range(2)])
    rb = lobpcg_block_pc(pc.op2, mg_ops["Mop"], X0, pc, tol=1e-9, max_iter=200)
    np.testing.assert_allclose(rb.eigenvalues.numpy(), mg_ops["lam"], rtol=1e-8)
    assert (rb.residuals <= 1e-9).all()
    d = (K.diagonal() - M.diagonal()).numpy()[perm]
    x0 = np.random.default_rng(0).standard_normal(K.shape[0])
    kw = dict(tol=1e-10, max_outer=50, cg_iters=60)
    r = shift_invert_power(mg_ops["Kop"], mg_ops["Mop"], 1.0, _t(x0), _t(_inv(d)), **kw)
    jr = jpower.shift_invert_power(mg_ops["jKop"], mg_ops["jMop"], 1.0, jnp.asarray(x0),
                                   jnp.asarray(_inv(d)), **kw)
    assert abs(r.eigenvalue - float(jr.eigenvalue)) / r.eigenvalue < 1e-10
    exact = analytic_eigenvalues(2.0, 4.0, 1)[0]
    assert abs(r.eigenvalue - exact) / exact < 1e-4 and r.residual < 1e-6


def test_element_operators_match_jax_and_csr(th):
    """``ElementOperator`` on a real and a complex x and ``CElementOperator``
    (with Dirichlet rows) against the JAX package's and the assembled CSR,
    rel 1e-12; the segmented sums give the same bits on a second apply."""
    spaces, mask = th["spaces"], th["mask"]
    n, dofs = spaces.num_dofs, spaces.mixed_cell_dofs.astype(np.int64)
    Ael, Eim, x, z = th["Ael"], th["Eim"], th["x"], th["z"]
    rows = np.repeat(dofs, dofs.shape[1], axis=1).ravel()
    cols = np.tile(dofs, (1, dofs.shape[1])).ravel()

    def assembled(E):
        return sp.csr_matrix((E.ravel(), (rows, cols)), shape=(n, n))

    op = ElementOperator(_t(Ael), _t(dofs), n)
    jop = jelementop.ElementOperator(jnp.asarray(Ael), jnp.asarray(dofs.astype(np.int32)), n)
    y = op.matvec(_t(x)).numpy()
    assert _rel(y, np.asarray(jop.matvec(jnp.asarray(x)))) < 1e-12
    assert _rel(y, assembled(Ael) @ x) < 1e-12
    assert _rel(op.matvec_pair(_t(z)).numpy(), assembled(Ael) @ z) < 1e-12
    assert torch.equal(op.matvec(_t(x)), op.matvec(_t(x)))
    cop = CElementOperator(_t(Ael), _t(Eim), _t(dofs), n, _t(mask))
    jcop = jelementop.CElementOperator(jnp.asarray(Ael), jnp.asarray(Eim),
                                       jnp.asarray(dofs.astype(np.int32)), n, jnp.asarray(mask))
    yc = cop.matvec_pair(_t(z)).numpy()
    jr, ji = jcop.matvec_pair(jnp.asarray(z.real), jnp.asarray(z.imag))
    assert _rel(yc, np.asarray(jr) + 1j * np.asarray(ji)) < 1e-12
    keep = sp.diags((~mask).astype(float))
    C = keep @ (assembled(Ael) + 1j * assembled(Eim)) @ keep + sp.diags(mask.astype(float))
    assert _rel(yc, C @ z) < 1e-12


def test_ell_of_csr_matches_jax():
    rng = np.random.default_rng(5)
    S = sp.random(40, 17, density=0.15, random_state=rng, format="csr")
    S[3] = 0.0  # an empty row
    S.eliminate_zeros()
    d, c = teigen.ell_of_csr(S, device="cpu")
    jd, jc = jeigen.ell_of_csr(S)
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
    assert c.dtype == torch.int32 and (sp.csr_matrix(S).getnnz(axis=1).max() == d.shape[1])


def test_galerkin_pair_union_pattern(membrane):
    """P^T A P and P^T M P on one pattern with every diagonal, against
    scipy's triple products, 1e-12; and where the two products cancel
    exactly (A = -M), every slot of the union survives (the JAX package
    builds the union from Ag + Mg, which loses them: not enshrined)."""
    from lsafw_tpu_torch.solver.baseflow import point_interpolation_matrix

    K, M = membrane["K"], membrane["M"]
    coarse = make_scalar_space(rectangle_mesh((0.0, 0.0), (2.0, 4.0), 4, 8), "p2")
    P = point_interpolation_matrix(coarse.node_coords, membrane["space"].node_coords)
    A_g, M_g = teigen.galerkin_pair(P, K, M)
    assert A_g.pattern is M_g.pattern and A_g.pattern.diag_slots.shape[0] == A_g.shape[0]
    ref_A = (P.T @ (K.to_scipy() @ P)).toarray()
    ref_M = (P.T @ (M.to_scipy() @ P)).toarray()
    scale = np.abs(ref_A).max()
    assert np.abs(A_g.to_scipy().toarray() - ref_A).max() < 1e-12 * scale
    assert np.abs(M_g.to_scipy().toarray() - ref_M).max() < 1e-12 * np.abs(ref_M).max()
    negM = CSRMatrix(M.pattern, -M.data)
    A_c, M_c = teigen.galerkin_pair(P, negM, M)
    Mg = (P.T @ (M.to_scipy() @ P)).tocsr()
    Mg.eliminate_zeros()
    assert A_c.pattern.nnz >= Mg.nnz > A_c.shape[0]
    np.testing.assert_allclose(A_c.to_scipy().toarray(), -Mg.toarray(), atol=1e-15)
    np.testing.assert_allclose(M_c.to_scipy().toarray(), Mg.toarray(), atol=1e-15)


@pytest.mark.parametrize("press_reg", [1.0, 1e-3])
def test_diag_sipc_press_reg_matches_jax(th, press_reg):
    """``DiagSIPC.from_pair`` on a saddle pair (zero diagonals: random
    values with the pressure block's diagonal zeroed) with ``press_reg``
    passed explicitly (the JAX package's default moved from 1e-3 to 1.0;
    the port's default is 1.0)."""
    pat, n = th["pat"], th["spaces"].num_dofs
    rng = np.random.default_rng(6)
    a, m = rng.standard_normal(pat.nnz), rng.standard_normal(pat.nnz)
    ds = pat.diag_slots
    p = th["spaces"].dofs_p
    a[ds[p]], m[ds[p]] = 0.0, 0.0
    A = csr_from_numpy(pat.indptr, pat.indices, a, (n, n), device="cpu")
    M = CSRMatrix(A.pattern, torch.as_tensor(m))
    sigma = 0.3 + 0.7j
    got = teigen.DiagSIPC.from_pair(A, M, sigma, press_reg=press_reg).inv.numpy()
    jd = jeigen.DiagSIPC.from_pair(_jcsr(pat, a), _jcsr(pat, m), sigma, press_reg=press_reg)
    np.testing.assert_allclose(got, np.asarray(jd.inv_re) + 1j * np.asarray(jd.inv_im),
                               rtol=1e-14, atol=0)
    assert teigen.DiagSIPC.from_pair(A, M, sigma).inv.numpy() == pytest.approx(
        teigen.DiagSIPC.from_pair(A, M, sigma, press_reg=1.0).inv.numpy())


def test_reference_faults_are_refused(membrane):
    """A bare band factor as TwoGridSIPC's coarse operator without the
    fine C raises a clear ValueError (the reference fails while tracing);
    ``_with_sigma`` refuses an ``op.Cop`` beside a preconditioner holding a
    retargetable ``Cop`` (the reference leaves the second at a stale
    shift)."""
    from lsafw_tpu_torch.ops.bcsr import BCSRShiftedOp

    K, M = membrane["K"], membrane["M"]
    n = K.shape[0]
    Pd = torch.ones((n, 1), dtype=torch.float64)
    Pc = torch.zeros((n, 1), dtype=torch.int32)
    jac = teigen.DiagSIPC.from_pair(K, M, 2.0 + 0.1j)
    with pytest.raises(ValueError, match="Cop"):
        teigen.TwoGridSIPC(jac, None, Pd, Pc, nc=1)
    Cop = BCSRShiftedOp.from_csr(K, M, 2.0 + 0.1j)
    pc = teigen.TwoGridSIPC(jac, jac, Pd, Pc, Cop=Cop, nc=1)
    teigen._with_sigma(teigen.BandedSIOp(K, M, pc, 2.0 + 0.1j), 3.0)  # Cop inside the PC only
    with pytest.raises(AssertionError, match="stale shift"):
        teigen._with_sigma(teigen.BandedSIOp(K, M, pc, 2.0 + 0.1j, Cop), 3.0)
