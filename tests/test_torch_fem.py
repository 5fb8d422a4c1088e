"""The port's gather-path linear FEM against tpufem's, on the CPU (where
kernels D and E run their plain versions), on the same numpy inputs.

- tet4_setup, pressure loads, the Jacobi diagonal and the operator (kernel
  D's plain version: the mask, the per-tet forces, kernel E's plain sum, the
  Dirichlet identity) equal tpufem's to 1e-12 relative in f64 and 1e-5 in
  f32, on the structured wing, the same mesh renumbered by a seeded
  permutation and a mesh with a node that no tet touches, masked and not;
  E's plain version gives tpufem's segment_sum loads to 1e-15;
- the incidence plan (CSR rows, kernel D's blocks and their tet lists)
  against a brute-force numpy incidence;
- the plain versions of kernels B, D and E differentiate (their CUDA
  wrappers refuse a tensor that requires_grad);
- the float64 rung reports the TRUE residual, against a numpy recomputation;
- element_stress, nodal_stress and von_mises to 1e-12; dirichlet_mask
  exactly;
- line_blocks to 1e-10 in f64; rbm_coarse_inverse applied to a vector to
  1e-8 (tpufem's Newton-Schulz inverse against the port's Cholesky);
- pcg / pcg_fixed against tpufem's on a Jacobi-preconditioned wing system;
- solve_wing_case at COARSE in f64 (tol 1e-10) equals tpufem's to 1e-7 on u
  and vm; the f32 line + RBM default with refinement meets the direct-solve
  bars of tests/test_fem.py and tests/test_driver_two_level.py, and the RBM
  level cuts the iterations;
- the hard spec case's f32 line + RBM rung fails finite where tpufem's
  gives nan;
- a patch test: uniform traction reproduces the exact constant stress.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpufem.fem import WingSolveConfig as JWingSolveConfig
from tpufem.fem import solve_wing_case as jsolve_wing_case
from tpufem.fem.assembly import elastic_force as jelastic_force
from tpufem.fem.assembly import stiffness_diagonal as jstiffness_diagonal
from tpufem.fem.assembly import stiffness_operator as jstiffness_operator
from tpufem.fem.bc import dirichlet_mask as jdirichlet_mask
from tpufem.fem.driver import residual64_core as jresidual64_core
from tpufem.fem.elements import tet4_setup as jtet4_setup
from tpufem.fem.loads import pressure_loads as jpressure_loads
from tpufem.fem.precond import build_line_plan as jbuild_line_plan
from tpufem.fem.precond import build_rbm_groups as jbuild_rbm_groups
from tpufem.fem.precond import line_blocks as jline_blocks
from tpufem.fem.precond import rbm_coarse_inverse as jrbm_coarse_inverse
from tpufem.fem.refsolve import direct_solve
from tpufem.fem.solver import pcg as jpcg
from tpufem.fem.vonmises import element_stress as jelement_stress
from tpufem.fem.vonmises import nodal_stress as jnodal_stress
from tpufem.fem.vonmises import von_mises as jvon_mises
from tpufem.mesher import COARSE as JCOARSE
from tpufem.mesher import WingMeshResolution as JWingMeshResolution
from tpufem.mesher import structured_wing_mesh as jstructured_wing_mesh
from tpufem.mesher import wing_topology as jwing_topology
from tpufem.sets import build_boundary_sets as jbuild_boundary_sets
from tpufem_torch.fem import assembly as tas
from tpufem_torch.fem import stencil as tst
from tpufem_torch.fem.assembly import (
    build_incidence,
    elastic_force,
    stiffness_apply,
    stiffness_diagonal,
    stiffness_operator,
    tet4_element_force_plain,
)
from tpufem_torch.fem.bc import dirichlet_mask
from tpufem_torch.fem.driver import (
    WingSolveConfig,
    mesh_plans,
    residual64_core,
    solve_core,
    solve_wing_case,
)
from tpufem_torch.fem.elements import tet4_setup
from tpufem_torch.fem.loads import pressure_loads
from tpufem_torch.fem.material import Material, lame_params
from tpufem_torch.fem.precond import (
    build_line_plan,
    build_rbm_groups,
    build_rbm_plan,
    line_blocks,
    plan_device_arrays,
    rbm_coarse_inverse,
)
from tpufem_torch.fem.solver import pcg, pcg_fixed
from tpufem_torch.fem.vonmises import element_stress, nodal_stress, von_mises
from tpufem_torch.mesh_types import Mesh
from tpufem_torch.mesher import (
    COARSE,
    WingMeshResolution,
    boundary_faces,
    structured_wing_mesh,
    wing_topology,
)
from tpufem_torch.ops.csr_segment_sum import csr_plan, csr_segment_sum
from tpufem_torch.profile_gather_operator import permuted
from tpufem_torch.sets import build_boundary_sets

MAT = Material(E=69e9, nu=0.33)
LAM, MU = lame_params(MAT)
F64 = torch.float64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The CG loops here are thousands of small ops; under the suite's
    parallel workers, torch's intra-op threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.fixture(scope="module")
def wing():
    """COARSE wing (sweep 10) in both packages, f64 gradients, a seeded u."""
    m = structured_wing_mesh(1.2, 0.35, 10.0, 0.10, COARSE)
    jm = jstructured_wing_mesh(1.2, 0.35, 10.0, 0.10, JCOARSE)
    np.testing.assert_array_equal(m.nodes, jm.nodes)
    nodes = torch.as_tensor(m.nodes)
    tets = torch.as_tensor(m.tets)
    grads, vols = tet4_setup(nodes, tets)
    jg, jv = jtet4_setup(jnp.asarray(m.nodes), jnp.asarray(m.tets))
    u = np.random.default_rng(0).normal(size=(m.num_nodes, 3))
    return m, jm, tets, grads, vols, np.asarray(jg), np.asarray(jv), u


def test_tet4_setup_matches_tpufem(wing):
    m, _, tets, grads, vols, jg, jv, _ = wing
    assert _rel(grads, jg) <= 1e-12 and _rel(vols, jv) <= 1e-12
    # masked and degenerate tets get zero gradients and volume, as in tpufem
    nodes = np.vstack([m.nodes, m.nodes[:1]])  # node N duplicates node 0
    bad = np.array([[0, 1, 2, m.num_nodes]], dtype=np.int32)
    t2 = np.vstack([m.tets[:5], bad])
    mask = np.array([1, 1, 0, 1, 1, 1], np.float64)
    g, v = tet4_setup(torch.as_tensor(nodes), torch.as_tensor(t2), torch.as_tensor(mask))
    jg2, jv2 = jtet4_setup(jnp.asarray(nodes), jnp.asarray(t2), jnp.asarray(mask))
    np.testing.assert_allclose(g.numpy(), np.asarray(jg2), rtol=1e-12, atol=0)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv2), rtol=1e-12, atol=0)
    assert (g[2] == 0).all() and (g[5] == 0).all() and v[2] == 0 and v[5] == 0


def test_pressure_loads_match_tpufem_segment_sum(wing):
    m, *_ = wing
    bs = build_boundary_sets(m)
    faces = m.surf_faces[bs.surf_upper_faces]
    plan = csr_plan(faces, m.num_nodes)
    f = pressure_loads(torch.as_tensor(m.nodes), torch.as_tensor(faces), 5e3, plan).numpy()
    jf = np.asarray(jpressure_loads(jnp.asarray(m.nodes), jnp.asarray(faces), 5e3, m.num_nodes))
    assert _rel(f, jf) <= 1e-15


@pytest.mark.parametrize("C", [1, 3, 6, 7])
def test_csr_segment_sum_plain_matches_segment_sum(C):
    import jax

    rng = np.random.default_rng(C)
    ids = rng.integers(0, 50, size=400)
    ids[ids == 7] = 8  # an empty segment
    vals = rng.normal(size=(400, C))
    out = csr_segment_sum(torch.as_tensor(vals), csr_plan(ids, 50)).numpy()
    ref = np.asarray(jax.ops.segment_sum(jnp.asarray(vals), jnp.asarray(ids), num_segments=50))
    assert _rel(out, ref) <= 1e-15 and (out[7] == 0).all()
    with pytest.raises(ValueError):
        csr_plan(np.array([0, 50]), 50)


def test_operator_and_diagonal_match_tpufem(wing):
    m, _, tets, grads, vols, jg, jv, u = wing
    bs = build_boundary_sets(m)
    inc = build_incidence(m.tets, m.num_nodes)
    y = elastic_force(grads, vols, tets, torch.as_tensor(u), LAM, MU, inc).numpy()
    jy = np.asarray(jelastic_force(jnp.asarray(jg), jnp.asarray(jv), jnp.asarray(m.tets),
                                   jnp.asarray(u), LAM, MU, m.num_nodes))
    assert _rel(y, jy) <= 1e-12
    free = dirichlet_mask(m.num_nodes, bs.nroot_nodes, dtype=F64)
    jfree = jdirichlet_mask(m.num_nodes, bs.nroot_nodes, dtype=jnp.float64)
    A = stiffness_operator(grads, vols, tets, LAM, MU, inc, free)
    jA = jstiffness_operator(jnp.asarray(jg), jnp.asarray(jv), jnp.asarray(m.tets), LAM, MU,
                             m.num_nodes, jfree)
    assert _rel(A(torch.as_tensor(u.reshape(-1))).numpy(), np.asarray(jA(jnp.asarray(u.reshape(-1))))) <= 1e-12
    d = stiffness_diagonal(grads, vols, LAM, MU, inc, free).numpy()
    jd = np.asarray(jstiffness_diagonal(jnp.asarray(jg), jnp.asarray(jv), jnp.asarray(m.tets),
                                        LAM, MU, m.num_nodes, jfree))
    assert _rel(d, jd) <= 1e-12
    # the per-tet half of kernel D's plain version: its rows sum to y
    fe = tet4_element_force_plain(grads, vols, tets, torch.as_tensor(u), LAM, MU)
    assert fe.shape == (m.num_tets * 4, 3)
    assert _rel(csr_segment_sum(fe, inc).numpy(), y) <= 1e-15


MESH_CASES = ["structured", "permuted", "untouched-node"]


def _mesh_case(name):
    """(nodes, tets, root nodes) of the COARSE wing: as meshed; renumbered by
    a seeded permutation; with one more node, which no tet touches, in the
    middle of the numbering."""
    m = structured_wing_mesh(1.2, 0.35, 10.0, 0.10, COARSE)
    nodes, tets, root = m.nodes, m.tets, build_boundary_sets(m).nroot_nodes
    if name == "permuted":
        nodes, tets, root = permuted(nodes, tets, root, seed=1)
    if name == "untouched-node":
        k = len(nodes) // 2
        nodes = np.insert(nodes, k, [9.0, 9.0, 9.0], axis=0)
        tets, root = tets + (tets >= k), root + (root >= k)
    return nodes, tets.astype(np.int32), root


@pytest.mark.parametrize("dtype", ["f64", "f32"])
@pytest.mark.parametrize("masked", [True, False], ids=["masked", "unmasked"])
@pytest.mark.parametrize("case", MESH_CASES)
def test_stiffness_apply_matches_tpufem(case, masked, dtype):
    """Kernel D's plain version, the whole operator apply, against tpufem's
    stiffness_operator (masked) and elastic_force (unmasked)."""
    nodes, tets, root = _mesh_case(case)
    N = len(nodes)
    tdt, jdt, bar = ((F64, jnp.float64, 1e-12) if dtype == "f64"
                     else (torch.float32, jnp.float32, 1e-5))
    grads, vols = tet4_setup(torch.as_tensor(nodes), torch.as_tensor(tets))
    jg, jv = jtet4_setup(jnp.asarray(nodes), jnp.asarray(tets))
    grads, vols, jg, jv = grads.to(tdt), vols.to(tdt), jg.astype(jdt), jv.astype(jdt)
    x = np.random.default_rng(7).normal(size=(N, 3))
    plan = build_incidence(tets, N)
    free = dirichlet_mask(N, root, dtype=tdt)
    xt = torch.as_tensor(x, dtype=tdt)
    if masked:
        y = stiffness_apply(grads, vols, torch.as_tensor(tets), xt, LAM, MU, plan,
                            free.reshape(-1, 3)).numpy()
        A = stiffness_operator(grads, vols, torch.as_tensor(tets), LAM, MU, plan, free)
        np.testing.assert_array_equal(A(xt.reshape(-1)).numpy(), y.reshape(-1))
        jA = jstiffness_operator(jg, jv, jnp.asarray(tets), LAM, MU, N,
                                 jdirichlet_mask(N, root, dtype=jdt))
        jy = np.asarray(jA(jnp.asarray(x.reshape(-1), dtype=jdt))).reshape(N, 3)
        np.testing.assert_array_equal(y[root], x.astype(y.dtype)[root])  # the identity rows
    else:
        y = elastic_force(grads, vols, torch.as_tensor(tets), xt, LAM, MU, plan).numpy()
        jy = np.asarray(jelastic_force(jg, jv, jnp.asarray(tets), jnp.asarray(x, dtype=jdt),
                                       LAM, MU, N))
    assert y.dtype == jy.dtype and _rel(y, jy) <= bar
    if case == "untouched-node":
        untouched = np.setdiff1d(np.arange(N), tets)
        assert len(untouched) == 1 and (y[untouched] == 0).all()


@pytest.mark.parametrize("case", MESH_CASES + ["high-valence"])
def test_incidence_plan_matches_brute_force(case, monkeypatch):
    """The CSR rows and kernel D's blocks against a brute-force incidence,
    with few slots per block so that the small mesh has many blocks."""
    monkeypatch.setattr(tas, "SLOTS", 64)
    if case == "high-valence":  # a fan of 40 tets round node 0: more rows than SLOTS
        tets = np.array([[0, 3 * i + 1, 3 * i + 2, 3 * i + 3] for i in range(40)], np.int32)
        tets = np.concatenate([tets, tets[:, [1, 0, 2, 3]], tets[:, [1, 2, 0, 3]]])
        N = 125  # nodes 121..124 untouched
    else:
        nodes, tets, _ = _mesh_case(case)
        N = len(nodes)
    T = len(tets)
    p = build_incidence(tets, N)
    flat = tets.reshape(-1)
    order, starts, pos = p.order.numpy(), p.starts.numpy(), p.pos.numpy()
    assert p.order.dtype == p.starts.dtype == p.pos.dtype == torch.int32
    for n in range(N):  # node n's rows: its (tet, corner) entries in ascending t*4+a
        rows = order[starts[n]:starts[n + 1]]
        np.testing.assert_array_equal(rows, np.nonzero(flat == n)[0])
        np.testing.assert_array_equal(tets[rows >> 2, rows & 3], n)
    np.testing.assert_array_equal(order[pos], np.arange(4 * T))
    np.testing.assert_array_equal(p.seg.numpy(), flat[order])
    bnode, bt_start, btet = p.bnode.numpy(), p.bt_start.numpy(), p.btet.numpy()
    assert bnode[0] == 0 and bnode[-1] == N and (np.diff(bnode) > 0).all()
    valence = np.bincount(flat, minlength=N)
    assert p.slots == max(64, valence.max())
    assert (starts[bnode[1:]] - starts[bnode[:-1]] <= p.slots).all() and len(bnode) > 3
    for b in range(len(bnode) - 1):  # the tets with a corner in the block's range, ascending
        touches = ((tets >= bnode[b]) & (tets < bnode[b + 1])).any(axis=1)
        np.testing.assert_array_equal(btet[bt_start[b]:bt_start[b + 1]], np.nonzero(touches)[0])
    assert p.overlap == len(btet) / T and 1.0 <= p.overlap <= 4.0
    if case == "high-valence":
        assert p.slots == 120 and valence[0] == 120
        monkeypatch.setattr(tas, "SLOT_LIMIT", 100)
        with pytest.raises(ValueError, match="incident tets"):
            build_incidence(tets, N)


def test_plain_versions_of_the_hand_kernels_differentiate(wing):
    """Kernels B, D and E have no backward, so their CUDA wrappers refuse a
    tensor that requires_grad; on the CPU the same calls run the plain
    versions, and autograd goes through them."""
    m, _, tets, grads, vols, _, _, u = wing
    bs = build_boundary_sets(m)
    plan = build_incidence(m.tets, m.num_nodes)
    free = dirichlet_mask(m.num_nodes, bs.nroot_nodes, dtype=F64).reshape(-1, 3)
    x = torch.tensor(u, requires_grad=True)
    w = torch.as_tensor(np.random.default_rng(1).normal(size=u.shape))
    (stiffness_apply(grads, vols, tets, x, LAM, MU, plan, free) * w).sum().backward()
    # the operator is symmetric: d/dx (w . A x) = A w
    Aw = stiffness_apply(grads, vols, tets, w, LAM, MU, plan, free)
    assert _rel(x.grad.numpy(), Aw.numpy()) <= 1e-12
    vals = torch.tensor(u, requires_grad=True)
    csr_segment_sum(vals[m.tets.reshape(-1)], plan).sum().backward()
    np.testing.assert_allclose(vals.grad.numpy()[:, 0],
                               np.bincount(m.tets.reshape(-1), minlength=m.num_nodes))
    res = WingMeshResolution(4, 4, 2, te_floor_frac=0.006, spacing="le")
    X = tst.nodes_grid(res, torch.tensor([[1.2, 0.35, 10.0, 0.10]], dtype=F64), F64)
    ug = torch.randn(X.shape, dtype=F64, generator=torch.Generator().manual_seed(0),
                     requires_grad=True)
    fmask = torch.ones((1, 1, 1, 1, res.n_span + 1), dtype=F64)
    tst.strain_apply(res, tst.cell_geometry(res, X), ug, fmask, LAM, MU).sum().backward()
    assert ug.grad is not None and bool(ug.grad.abs().max() > 0)
    for check, args in ((tst.check_strain_apply_inputs, (res, tst.cell_geometry(res, X), ug, fmask)),
                        (tas.check_stiffness_apply_inputs,
                         (grads, vols, tets.to(torch.int32), x, plan, free))):
        with pytest.raises(ValueError, match="no backward"):
            check(*args)
        with torch.no_grad():
            check(*args)


def test_float64_rung_reports_true_residual():
    """An f64 solve without refinement reports the TRUE residual of the u it
    returns (numpy: per-tet forces added per node, the loads added per face
    corner), and `converged` says that this is at or under tol; the
    recurrence alone leaves the TRUE residual above tol here."""
    m = structured_wing_mesh(1.2, 0.35, 0.0, 0.10, COARSE)
    bs = build_boundary_sets(m)
    tol = 1e-9
    sol = solve_wing_case(m, bs, WingSolveConfig(pressure=100.0, dtype=F64, tol=tol,
                                                 maxiter=50000), device="cpu")
    g, vol = (t.numpy() for t in tet4_setup(torch.as_tensor(m.nodes), torch.as_tensor(m.tets)))
    H = np.einsum("tad,tae->tde", g, sol.u[m.tets])
    sig = MU * (H + H.transpose(0, 2, 1)) + LAM * np.trace(H, axis1=1, axis2=2)[:, None, None] * np.eye(3)
    Ku = np.zeros_like(m.nodes)
    np.add.at(Ku, m.tets.reshape(-1), (vol[:, None, None] * np.einsum("tde,tae->tad", sig, g)).reshape(-1, 3))
    faces = m.surf_faces[bs.surf_upper_faces]
    v = m.nodes[faces]
    b = np.zeros_like(m.nodes)
    for c in range(3):
        np.add.at(b, faces[:, c], (-100.0 / 3.0) * 0.5 * np.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0]))
    b[bs.nroot_nodes] = 0.0
    r = b - Ku
    r[bs.nroot_nodes] = -sol.u[bs.nroot_nodes]  # the identity rows: b - u = -u
    rel = np.linalg.norm(r) / np.linalg.norm(b)
    assert sol.converged and rel <= tol
    assert abs(sol.rel_residual - rel) <= 1e-3 * rel + 1e-16
    # the recurrence alone would have stopped above tol: the reported count holds the
    # refinement's correction solve
    plans = mesh_plans(m, bs, "cpu")
    free = dirichlet_mask(m.num_nodes, bs.nroot_nodes, dtype=F64)
    nodes, tets, upper = torch.as_tensor(m.nodes), torch.as_tensor(m.tets), torch.as_tensor(faces)
    one = solve_core(nodes, tets, upper, free, plans, 100.0, LAM, MU, tol, 50000, dtype=F64,
                     refine_steps=1)
    assert sol.iters == one[3]
    # beyond what f64 can certify on this mesh the rung says so
    low = solve_wing_case(m, bs, WingSolveConfig(pressure=100.0, dtype=F64, tol=1e-11,
                                                 maxiter=50000), device="cpu")
    assert not low.converged and 1e-11 < low.rel_residual < 1e-9


def test_stress_recovery_matches_tpufem(wing):
    m, _, tets, grads, vols, jg, jv, u = wing
    u = u * 1e-4
    sig = element_stress(grads, vols, tets, torch.as_tensor(u), LAM, MU)
    jsig = jelement_stress(jnp.asarray(jg), jnp.asarray(jv), jnp.asarray(m.tets),
                           jnp.asarray(u), LAM, MU)
    assert _rel(sig.numpy(), np.asarray(jsig)) <= 1e-12
    s6 = nodal_stress(sig, vols, build_incidence(m.tets, m.num_nodes))
    js6 = jnodal_stress(jsig, jnp.asarray(jv), jnp.asarray(m.tets), m.num_nodes)
    assert _rel(s6.numpy(), np.asarray(js6)) <= 1e-12
    assert _rel(von_mises(s6).numpy(), np.asarray(jvon_mises(js6))) <= 1e-12
    vm = von_mises(torch.tensor([[100.0, 0, 0, 0, 0, 0], [0, 0, 0, 50.0, 0, 0]], dtype=F64))
    np.testing.assert_allclose(vm.numpy(), [100.0, 50.0 * np.sqrt(3)], rtol=1e-15)


def test_dirichlet_mask_matches_tpufem():
    m = dirichlet_mask(5, np.array([1, 3]), node_mask=torch.tensor([1.0, 1, 1, 1, 0]))
    jm = jdirichlet_mask(5, np.array([1, 3]), node_mask=jnp.asarray([1.0, 1, 1, 1, 0]))
    assert m.dtype == torch.float32
    np.testing.assert_array_equal(m.numpy(), np.asarray(jm))


def test_line_blocks_match_tpufem(wing):
    m, jm, tets, grads, vols, jg, jv, _ = wing
    bs = build_boundary_sets(m)
    plan = build_line_plan(wing_topology(COARSE))
    jplan = jbuild_line_plan(jwing_topology(JCOARSE))
    np.testing.assert_array_equal(plan.pair_seg, jplan.pair_seg)
    free = dirichlet_mask(m.num_nodes, bs.nroot_nodes, dtype=F64)
    jfree = jdirichlet_mask(m.num_nodes, bs.nroot_nodes, dtype=jnp.float64)
    Binv = line_blocks(plan_device_arrays(plan), grads, vols, LAM, MU, free)
    jBinv = jline_blocks(jplan, jnp.asarray(jg), jnp.asarray(jv), LAM, MU, jfree)
    assert _rel(Binv.numpy(), np.asarray(jBinv)) <= 1e-10


def test_rbm_coarse_inverse_matches_tpufem(wing):
    m, _, tets, grads, vols, jg, jv, u = wing
    bs = build_boundary_sets(m)
    meta = m.meta
    nj = meta["num_span_stations"]
    ni = meta["num_stations"] // nj
    group, G = build_rbm_groups(meta["station_id"], meta["slot"], ni, nj)
    jgroup, jG = jbuild_rbm_groups(meta["station_id"], meta["slot"], ni, nj)
    np.testing.assert_array_equal(group, jgroup)
    assert G == jG
    free = dirichlet_mask(m.num_nodes, bs.nroot_nodes, dtype=F64)
    jfree = jdirichlet_mask(m.num_nodes, bs.nroot_nodes, dtype=jnp.float64)
    rbm = build_rbm_plan(group, G, m.tets)
    Ac_inv, dvec = rbm_coarse_inverse(rbm, tets, torch.as_tensor(m.nodes), grads, vols, LAM, MU,
                                      free)
    jAc_inv, jdvec = jrbm_coarse_inverse(jnp.asarray(jgroup), G, jnp.asarray(m.tets),
                                         jnp.asarray(m.nodes), jnp.asarray(jg), jnp.asarray(jv),
                                         LAM, MU, jfree)
    assert _rel(dvec.numpy(), np.asarray(jdvec)) <= 1e-12
    v = np.random.default_rng(5).normal(size=6 * G)
    assert _rel(Ac_inv.numpy() @ v, np.asarray(jAc_inv) @ v) <= 1e-8


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rbm_two_level_apply_matches_tpufem(wing, seed):
    """The two-level apply M of make_rbm_two_level, whose group sum is kernel
    E's once per f64 gather CG iteration (its plain version here), against
    tpufem's with its two segment_sums, on the same Ac_inv, dvec and line
    apply (a fixed diagonal scaling)."""
    from tpufem.fem.precond import make_rbm_two_level as jmake_rbm_two_level
    from tpufem_torch.fem.precond import make_rbm_two_level

    m, _, tets, grads, vols, *_ = wing
    bs = build_boundary_sets(m)
    meta = m.meta
    nj = meta["num_span_stations"]
    ni = meta["num_stations"] // nj
    group, G = build_rbm_groups(meta["station_id"], meta["slot"], ni, nj)
    free = dirichlet_mask(m.num_nodes, bs.nroot_nodes, dtype=F64)
    rbm = build_rbm_plan(group, G, m.tets)
    Ac_inv, dvec = rbm_coarse_inverse(rbm, tets, torch.as_tensor(m.nodes), grads, vols, LAM, MU,
                                      free)
    rng = np.random.default_rng(seed)
    line, r = rng.normal(size=(2, 3 * m.num_nodes))
    M = make_rbm_two_level(lambda x: x * torch.as_tensor(line), Ac_inv, rbm, dvec, free)
    jM = jmake_rbm_two_level(lambda x: x * jnp.asarray(line), jnp.asarray(Ac_inv.numpy()),
                             jnp.asarray(group), G, jnp.asarray(dvec.numpy()),
                             jnp.asarray(free.numpy()))
    assert _rel(M(torch.as_tensor(r)).numpy(), np.asarray(jM(jnp.asarray(r)))) <= 1e-12


def test_pcg_matches_tpufem(wing):
    m, _, tets, grads, vols, jg, jv, _ = wing
    bs = build_boundary_sets(m)
    inc = build_incidence(m.tets, m.num_nodes)
    free = dirichlet_mask(m.num_nodes, bs.nroot_nodes, dtype=F64)
    jfree = jdirichlet_mask(m.num_nodes, bs.nroot_nodes, dtype=jnp.float64)
    A = stiffness_operator(grads, vols, tets, LAM, MU, inc, free)
    d = stiffness_diagonal(grads, vols, LAM, MU, inc, free)
    b = np.random.default_rng(2).normal(size=3 * m.num_nodes) * free.numpy()
    jA = jstiffness_operator(jnp.asarray(jg), jnp.asarray(jv), jnp.asarray(m.tets), LAM, MU,
                             m.num_nodes, jfree)
    jd = jstiffness_diagonal(jnp.asarray(jg), jnp.asarray(jv), jnp.asarray(m.tets), LAM, MU,
                             m.num_nodes, jfree)
    # 25 steps: the stopping rule, and iterates equal to rounding (longer
    # runs of an ill-conditioned Jacobi CG amplify the last-bit differences)
    res = pcg(A, torch.as_tensor(b), d, tol=1e-8, maxiter=25)
    jres = jpcg(jA, jnp.asarray(b), jd, tol=1e-8, maxiter=25)
    assert res.iters == int(jres.iters) == 25 and not res.converged
    assert _rel(res.x.numpy(), np.asarray(jres.x)) <= 1e-9
    assert abs(float(res.rel_residual) / float(jres.rel_residual) - 1) <= 1e-9
    x, rel = pcg_fixed(A, torch.as_tensor(b), d, n_iters=25)
    assert _rel(x.numpy(), res.x.numpy()) <= 1e-12
    assert abs(float(rel) / float(res.rel_residual) - 1) <= 1e-12
    # a loose tol stops early, where tpufem's loop stops
    res = pcg(A, torch.as_tensor(b), d, tol=0.5, maxiter=1000)
    jres = jpcg(jA, jnp.asarray(b), jd, tol=0.5, maxiter=1000)
    assert res.converged and res.iters == int(jres.iters) < 1000


def test_solve_wing_case_f64_matches_tpufem():
    m = structured_wing_mesh(1.2, 0.35, 0.0, 0.10, COARSE)
    jm = jstructured_wing_mesh(1.2, 0.35, 0.0, 0.10, JCOARSE)
    jsol = jsolve_wing_case(jm, jbuild_boundary_sets(jm),
                            JWingSolveConfig(pressure=100.0, dtype=jnp.float64, tol=1e-10,
                                             maxiter=50000))
    assert jsol.converged
    # the port's float64 solve reports and certifies the TRUE residual, whose f64 floor
    # on this mesh is ~1.3e-10: at tol 1e-9 it converges by its own contract; at tpufem's
    # 1e-10, which tpufem's recurred residual meets, it may not, and gives the same
    # solution all the same
    for tol in (1e-9, 1e-10):
        sol = solve_wing_case(m, build_boundary_sets(m),
                              WingSolveConfig(pressure=100.0, dtype=F64, tol=tol, maxiter=50000),
                              device="cpu")
        assert sol.converged == (sol.rel_residual <= tol)
        assert sol.converged or tol == 1e-10
        assert np.linalg.norm(sol.u - jsol.u) <= 1e-7 * np.linalg.norm(jsol.u)
        assert np.abs(sol.vm - jsol.vm).max() <= 1e-7 * np.abs(jsol.vm).max()
    # the TRUE f64 residual of one solution, in both packages (f64 CG at tol
    # 1e-10 on the recurrence leaves a TRUE ~1e-9: the drift refinement removes)
    bs = build_boundary_sets(m)
    upper = m.surf_faces[bs.surf_upper_faces]
    free = dirichlet_mask(m.num_nodes, bs.nroot_nodes, dtype=F64)
    r, rel = residual64_core(torch.as_tensor(m.nodes), torch.as_tensor(m.tets),
                             torch.as_tensor(upper), free, mesh_plans(m, bs, "cpu"), 100.0, LAM, MU,
                             torch.tensor(jsol.u.reshape(-1)))
    jr, jrel = jresidual64_core(jnp.asarray(m.nodes), jnp.asarray(m.tets), jnp.asarray(upper),
                                jnp.asarray(free.numpy()), 100.0, LAM, MU,
                                jnp.asarray(jsol.u.reshape(-1)), num_nodes=m.num_nodes)
    # r = b - Ax cancels ~9 of 16 digits: the two sums agree to ~1e-3
    assert float(rel) <= 1e-8 and abs(float(rel) - float(jrel)) <= 1e-2 * float(jrel)


def test_f32_refined_solve_meets_direct_solve_bar():
    """The f32 line + RBM default with refine_steps=2 (tests/test_fem.py's
    bar: u < 1e-6, vm < 1e-5 against an independent direct solve)."""
    m = structured_wing_mesh(1.2, 0.35, 15.0, 0.10, COARSE)
    cfg = WingSolveConfig(pressure=5000.0, tol=1e-6, maxiter=10000, refine_steps=2)
    sol = solve_wing_case(m, build_boundary_sets(m), cfg, device="cpu")
    assert sol.converged and sol.u.dtype == np.float32
    jm = jstructured_wing_mesh(1.2, 0.35, 15.0, 0.10, JCOARSE)
    u_ref, _, vm_ref = direct_solve(jm, jbuild_boundary_sets(jm), pressure=5000.0)
    assert np.linalg.norm(sol.u - u_ref) / np.linalg.norm(u_ref) < 1e-6
    assert np.abs(sol.vm - vm_ref).max() / vm_ref.max() < 1e-5


RES2 = WingMeshResolution(24, 16, 3, te_floor_frac=0.006, spacing="le")


@pytest.fixture(scope="module")
def blunt_te():
    m = structured_wing_mesh(1.6, 0.30, 25.0, 0.07, RES2)
    jm = jstructured_wing_mesh(1.6, 0.30, 25.0, 0.07, JWingMeshResolution(*RES2.key))
    return m, build_boundary_sets(m), jm


def test_two_level_f32_refined_matches_direct(blunt_te):
    """tests/test_driver_two_level.py's bar (u < 1e-7, vm < 200 Pa) at
    refine_steps=2: one step lands at 1.1e-7 to 2.7e-7 on the CPU, depending
    on its f32 summation order (torch's thread count)."""
    m, bs, jm = blunt_te
    cfg = WingSolveConfig(pressure=5000.0, tol=1e-6, maxiter=8000, two_level=True,
                          refine_steps=2)
    sol = solve_wing_case(m, bs, cfg, device="cpu")
    assert sol.converged
    u_ref, _, vm_ref = direct_solve(jm, jbuild_boundary_sets(jm), pressure=5000.0)
    assert np.linalg.norm(sol.u - u_ref) / np.linalg.norm(u_ref) < 1e-7
    assert np.abs(sol.vm - vm_ref).max() < 200.0


def test_two_level_cuts_iterations(blunt_te):
    m, bs, _ = blunt_te
    base = dict(pressure=5000.0, tol=1e-6, maxiter=12000)
    two = solve_wing_case(m, bs, WingSolveConfig(**base, two_level=True), device="cpu")
    one = solve_wing_case(m, bs, WingSolveConfig(**base, two_level=False), device="cpu")
    assert two.converged
    assert two.iters < one.iters * 0.7, (two.iters, one.iters)


def test_hard_case_f32_rung_fails_finite_where_tpufem_blows_up():
    """The hard spec case (2.0, 0.2, 30 deg, 0.05) at tests/test_pipeline.py's
    WingMeshResolution(32, 16, 3), f32 line + RBM: tpufem's Newton-Schulz
    coarse inverse gives nan after one iteration; the port's ridged Cholesky
    stays finite, but the rung still fails to converge, so the FEM stage's
    ladder still moves on to its refined and float64 rungs."""
    res = (32, 16, 3)
    m = structured_wing_mesh(2.0, 0.2, 30.0, 0.05, WingMeshResolution(*res))
    cfg = dict(pressure=5e3, tol=1e-6, maxiter=300, two_level=True)
    sol = solve_wing_case(m, build_boundary_sets(m), WingSolveConfig(**cfg), device="cpu")
    jm = jstructured_wing_mesh(2.0, 0.2, 30.0, 0.05, JWingMeshResolution(*res))
    jsol = jsolve_wing_case(jm, jbuild_boundary_sets(jm),
                            JWingSolveConfig(**cfg, dtype=jnp.float32))
    assert not jsol.converged and jsol.iters == 1 and not np.isfinite(jsol.u).all()
    assert not sol.converged and sol.iters == 300 and sol.rel_residual > 1e-6
    assert np.isfinite(sol.u).all() and np.isfinite(sol.vm).all()


def _box_mesh(nx, ny, nz, L):
    from tpufem_torch.mesher import _HEX_CORNERS, _KUHN_TETS

    xs = [np.linspace(0, L[d], n + 1) for d, n in enumerate((nx, ny, nz))]
    X, Y, Z = np.meshgrid(*xs, indexing="ij")
    nodes = np.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=1)
    ci, cj, ck = (a.ravel() for a in np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz),
                                                  indexing="ij"))
    corners = np.stack([((ci + di) * (ny + 1) + cj + dj) * (nz + 1) + ck + dk
                        for (di, dj, dk) in _HEX_CORNERS], axis=1)
    tets = corners[:, _KUHN_TETS].reshape(-1, 4)
    v = nodes[tets]
    flip = np.einsum("ti,ti->t", v[:, 1] - v[:, 0],
                     np.cross(v[:, 2] - v[:, 0], v[:, 3] - v[:, 0])) < 0
    tets[flip] = tets[flip][:, [0, 1, 3, 2]]
    return Mesh(nodes=nodes, tets=tets.astype(np.int32),
                surf_faces=boundary_faces(tets).astype(np.int32))


def test_patch_uniaxial_stress():
    """Uniform end traction with roller BCs: tet4 reproduces the exact
    constant stress (sigma_xx = t) and linear displacement."""
    m = _box_mesh(3, 2, 2, (2.0, 1.0, 1.0))
    n, traction = m.num_nodes, 1e6
    free = np.ones((n, 3))
    for d in range(3):
        free[m.nodes[:, d] < 1e-12, d] = 0
    free = torch.as_tensor(free.reshape(-1))
    end = np.abs(m.nodes[m.surf_faces][:, :, 0].mean(axis=1) - 2.0) < 1e-9
    v = m.nodes[m.surf_faces[end]]
    area_vec = 0.5 * np.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0])
    f = np.zeros((n, 3))
    for k in range(3):
        np.add.at(f, m.surf_faces[end][:, k], traction / 3.0 * area_vec)
    tets = torch.as_tensor(m.tets)
    grads, vols = tet4_setup(torch.as_tensor(m.nodes), tets)
    inc = build_incidence(m.tets, n)
    A = stiffness_operator(grads, vols, tets, LAM, MU, inc, free)
    d = stiffness_diagonal(grads, vols, LAM, MU, inc, free)
    res = pcg(A, torch.as_tensor(f.reshape(-1)) * free, d, tol=1e-12, maxiter=5000)
    assert res.converged
    u = res.x.reshape(-1, 3)
    exact = np.stack([traction / MAT.E * m.nodes[:, 0],
                      -MAT.nu * traction / MAT.E * m.nodes[:, 1],
                      -MAT.nu * traction / MAT.E * m.nodes[:, 2]], axis=1)
    np.testing.assert_allclose(u.numpy(), exact, rtol=1e-8, atol=1e-15)
    sig = element_stress(grads, vols, tets, u, LAM, MU).numpy()
    np.testing.assert_allclose(sig[:, 0, 0], traction, rtol=1e-7)
    np.testing.assert_allclose(sig[:, [1, 2], [1, 2]], 0.0, atol=traction * 1e-7)
    np.testing.assert_allclose(sig[:, 0, 1], 0.0, atol=traction * 1e-7)
