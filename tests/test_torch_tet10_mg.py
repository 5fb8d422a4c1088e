"""Port parity: the tet10 gather engine of tpufem_torch (fem/tet10_mg.py and
the gather pieces of fem/tet10.py) against tpufem's, live, on the CPU, on a
6x4x2 sharp-TE and a 6x4x2 floored wing, P4 (1.4, 0.3, 15, 0.09), f64:

- build_incidence at k = 4 gives kernel D the plan it had before it took k
  corners, array for array, and at k = 10 the tet10 connectivity's rows and
  blocks against a brute-force incidence;
- tet10_diagonal and the raw tet10_line_blocks (before masking) to 1e-12 of
  the largest entry, the inverted blocks to 1e-10;
- prolong and restrict equal tpufem's, exact transposes of each other and
  prolong exact on linear fields;
- one apply_M (the p-MG V-cycle) to 1e-10;
- Tet10MGSolver.solve at tol 1e-9: u and vm to 1e-7 (iterations printed;
  tpufem's 142 on the floored wing); the outer_f64 branch (the f32 V-cycle
  inside the f64 CG) against tpufem's outer_f64 solve, u to 1e-7; the
  refinement branch (f32, 6 rounds)
  and the f64 polish branch (refine_steps=1) converged on the TRUE residual
  at tol 5e-7, u within 1e-6 of tpufem's f64 solve;
- solve_tet10_case (line + RBM two-level) at tol 1e-9: u to 1e-7, and the
  p-MG needs fewer iterations, the two claims of tpufem's own test.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpufem.fem.tet10 as jt10
import tpufem.mesher as jmesher
import tpufem_torch.fem.tet10 as tt10
import tpufem_torch.mesher as tmesher
from tpufem.fem.tet10_mg import Tet10MGSolver as JSolver
from tpufem_torch.fem import assembly as asm
from tpufem_torch.fem.material import Material, lame_params
from tpufem_torch.fem.tet10_mg import Tet10MGSolver
from tpufem_torch.ops.csr_segment_sum import csr_arrays
from tpufem_torch.sets import build_boundary_sets

P4 = (1.4, 0.3, 15.0, 0.09)
LAM, MU = lame_params(Material())
GRIDS = {"6x4x2 sharp TE": (6, 4, 2, 0.0), "6x4x2 floored": (6, 4, 2, 0.006)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The CG loops here are thousands of small ops; under the suite's
    parallel workers, torch's intra-op threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Case:
    """One grid in both packages: the meshes, the f64 solvers and, made on
    first use, tpufem's solves."""

    def __init__(self, grid):
        nc, ns, nt, te = GRIDS[grid]
        self.jres = jmesher.WingMeshResolution(nc, ns, nt, te, "le")
        self.res = tmesher.WingMeshResolution(nc, ns, nt, te, "le")
        self.jt10 = jt10.tet10_from_tet4(jmesher.structured_wing_mesh(*P4, self.jres))
        mesh = tmesher.structured_wing_mesh(*P4, self.res)
        self.bs = build_boundary_sets(mesh)
        self.t10 = tt10.tet10_from_tet4(mesh)
        self.js = JSolver(self.jres, self.jt10, dtype=jnp.float64)
        self.ts = Tet10MGSolver(self.res, self.t10, dtype=torch.float64, device="cpu")
        self._solves = {}

    def tpufem(self, name):
        if name not in self._solves:
            if name == "mg":
                self._solves[name] = self.js.solve(P4, self.bs.surf_upper_faces, pressure=5e3,
                                                   tol=1e-9, maxiter=2000)
            else:
                self._solves[name] = jt10.solve_tet10_case(
                    self.jt10, jt10.tet10_root_nodes(self.jt10), self.upper_t6(), pressure=5e3,
                    tol=1e-9, maxiter=8000, dtype=jnp.float64, nj2=2 * self.res.n_span + 1)
        return self._solves[name]

    def upper_t6(self):
        return tt10.tet10_upper_t6(self.t10, self.bs.surf_upper_faces)

    def geometry(self):
        """(jax (Jinv, vols), torch (Jinv, vols)) of the f64 tet10 geometry."""
        n10 = self.t10.nodes10(self.t10.mesh4.nodes)
        ja = jt10.tet10_setup(jnp.asarray(n10), jnp.asarray(self.jt10.tet10))
        tb = tt10.tet10_setup(torch.as_tensor(n10), self.ts.conn)
        return ja, tb


@pytest.fixture(scope="module")
def cases():
    return {}


def _case(cases, grid) -> Case:
    if grid not in cases:
        cases[grid] = Case(grid)
    return cases[grid]


def _close(b, a, rtol):
    a = np.asarray(a)
    np.testing.assert_allclose(np.asarray(b), a, rtol=0, atol=rtol * np.abs(a).max())


def _parent_build_incidence(tets, num_nodes):
    """build_incidence as kernel D had it before it took (T,k) connectivity
    (the (T,4) reshape): (order, starts, pos, bnode, bt_start, btet, slots,
    overlap)."""
    tets = np.asarray(tets).reshape(-1, 4)
    order, starts, flat = csr_arrays(tets, num_nodes)
    slots = max(asm.SLOTS, int(np.diff(starts).max(initial=0)))
    pos = np.empty(len(order), np.int32)
    pos[order] = np.arange(len(order), dtype=np.int32)
    bnode = [0]
    while bnode[-1] < num_nodes:
        bnode.append(int(np.searchsorted(starts, starts[bnode[-1]] + slots, side="right")) - 1)
    bnode = np.asarray(bnode, np.int64)
    n_blocks = len(bnode) - 1
    blocks = np.sort(np.repeat(np.arange(n_blocks), np.diff(bnode))[flat].reshape(-1, 4), axis=1)
    first = np.ones(blocks.shape, bool)
    first[:, 1:] = blocks[:, 1:] != blocks[:, :-1]
    pair_tet, pair_block = np.nonzero(first)[0], blocks[first]
    by_block = np.argsort(pair_block, kind="stable")
    bt_start = np.zeros(n_blocks + 1, np.int64)
    np.cumsum(np.bincount(pair_block, minlength=n_blocks), out=bt_start[1:])
    return (order, starts, pos, bnode, bt_start, pair_tet[by_block], slots,
            len(pair_tet) / len(tets))


@pytest.mark.parametrize("slots", [None, 64])
def test_build_incidence_at_k4_is_kernel_D_plan(slots, monkeypatch):
    """The tet4 wing's plan, at SLOTS and at 64 rows a block (many blocks)."""
    if slots:
        monkeypatch.setattr(asm, "SLOTS", slots)
    mesh = tmesher.structured_wing_mesh(*P4, tmesher.WingMeshResolution(8, 6, 2, 0.006, "le"))
    p = asm.build_incidence(torch.as_tensor(mesh.tets.astype(np.int32)), mesh.num_nodes)
    order, starts, pos, bnode, bt_start, btet, want_slots, overlap = _parent_build_incidence(
        mesh.tets, mesh.num_nodes)
    for got, want in ((p.order, order), (p.starts, starts), (p.pos, pos), (p.bnode, bnode),
                      (p.bt_start, bt_start), (p.btet, btet)):
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(p.starts_host, starts)
    assert (p.slots, p.overlap, p.num_segments) == (want_slots, overlap, mesh.num_nodes)
    assert len(bnode) > (3 if slots else 1)


def test_build_incidence_tet10_matches_brute_force():
    """The tet10 connectivity at 37 rows a block: each node's rows are its
    (tet, node) entries in ascending t*10+m, each block lists the tets with
    a node in its range, ascending, and a tet is evaluated 1 to 10 times."""
    t10 = tt10.tet10_from_tet4(
        tmesher.structured_wing_mesh(*P4, tmesher.WingMeshResolution(6, 4, 2, 0.0, "le")))
    tets, N = t10.tet10, t10.num_nodes
    p = asm.build_incidence(tets, N, slots=37)
    flat = tets.reshape(-1)
    order, starts = p.order.numpy(), p.starts.numpy()
    for n in range(N):
        np.testing.assert_array_equal(order[starts[n]:starts[n + 1]], np.nonzero(flat == n)[0])
    np.testing.assert_array_equal(order[p.pos.numpy()], np.arange(10 * len(tets)))
    bnode, bt_start, btet = p.bnode.numpy(), p.bt_start.numpy(), p.btet.numpy()
    assert (starts[bnode[1:]] - starts[bnode[:-1]] <= p.slots).all() and len(bnode) > 10
    for b in range(len(bnode) - 1):
        touches = ((tets >= bnode[b]) & (tets < bnode[b + 1])).any(axis=1)
        np.testing.assert_array_equal(btet[bt_start[b]:bt_start[b + 1]], np.nonzero(touches)[0])
    assert p.overlap == len(btet) / len(tets) and 1.0 <= p.overlap <= 10.0


def _tpufem_raw_line_blocks(Jinv, vols, t10, free_mask):
    """tpufem's tet10_line_blocks up to its flat (S,D,D) sum, before the
    masking and the inversion (tpufem/fem/tet10.py:243-279), on its own
    _quad_grads and segment sums."""
    import jax

    S, K = t10.num_stations, t10.slots_per_station
    g = jt10._quad_grads(Jinv, Jinv.dtype)
    w = jt10.GAUSS_WEIGHT * vols
    eye = jnp.eye(3, dtype=Jinv.dtype)
    D = 3 * K
    conn = jnp.asarray(t10.tet10)
    st, sl = jnp.asarray(t10.station_id)[conn], jnp.asarray(t10.slot)[conn]
    flat = jnp.zeros((S * D * D,), Jinv.dtype)
    offs = jnp.arange(3)
    for a in range(10):
        ga = g[:, :, a]
        for b in range(10):
            gb = g[:, :, b]
            wv = w * (st[:, a] == st[:, b]).astype(Jinv.dtype)
            outer_ab = (ga[:, :, :, None] * gb[:, :, None, :]).sum(axis=1)
            dot = (ga * gb).sum(axis=(1, 2))
            kab = wv[:, None, None] * (LAM * outer_ab + MU * jnp.swapaxes(outer_ab, 1, 2))
            kab = kab + (wv * MU * dot)[:, None, None] * eye
            base = st[:, a].astype(jnp.int64) * (D * D) + (3 * sl[:, a]) * D + 3 * sl[:, b]
            idx = (base[:, None, None] + offs[None, :, None] * D + offs[None, None, :]).reshape(-1)
            flat = flat + jax.ops.segment_sum(kab.reshape(-1), idx, num_segments=S * D * D)
    return flat.reshape(S, D, D)


@pytest.mark.parametrize("grid", list(GRIDS))
def test_diagonal_and_line_blocks_match(cases, grid):
    c = _case(cases, grid)
    (Ja, va), (Jb, vb) = c.geometry()
    N = c.t10.num_nodes
    free = c.ts.free.reshape(-1)
    da = jt10.tet10_diagonal(Ja, va, jnp.asarray(c.jt10.tet10), LAM, MU, N, jnp.asarray(free))
    _close(tt10.tet10_diagonal(Jb, vb, c.ts.conn, LAM, MU, N, free), da, 1e-12)
    raw = tt10.tet10_line_blocks_raw(Jb, vb, LAM, MU, c.ts.line_plan)
    _close(raw, _tpufem_raw_line_blocks(Ja, va, c.jt10, free), 1e-12)
    S, K = c.t10.num_stations, c.t10.slots_per_station
    Ba = jt10.tet10_line_blocks(Ja, va, jnp.asarray(c.jt10.tet10), jnp.asarray(c.t10.station_id),
                                jnp.asarray(c.t10.slot), LAM, MU, jnp.asarray(free), S=S, K=K)
    for plan in (c.ts.line_plan, None):  # the solver's plan, and one built from the arrays
        Bb = tt10.tet10_line_blocks(Jb, vb, c.ts.conn, c.t10.station_id, c.t10.slot, LAM, MU,
                                    free, S=S, K=K, plan=plan)
        _close(Bb, Ba, 1e-10)


@pytest.mark.parametrize("grid", list(GRIDS))
def test_p_transfers_match(cases, grid):
    c = _case(cases, grid)
    rng = np.random.default_rng(0)
    u4 = rng.normal(size=(c.ts.N4, 3))
    r10 = rng.normal(size=(c.ts.N10, 3))
    pb = c.ts.prolong(torch.as_tensor(u4))
    rb = c.ts.restrict(torch.as_tensor(r10))
    _close(pb, c.js.prolong(jnp.asarray(u4)), 1e-15)
    _close(rb, c.js.restrict(jnp.asarray(r10)), 1e-14)
    lhs = float((torch.as_tensor(r10) * pb).sum())
    rhs = float((rb * torch.as_tensor(u4)).sum())
    assert np.isclose(lhs, rhs, rtol=1e-12)
    coef = np.array([[0.3, -1.1, 2.0], [0.5, 0.1, -0.7], [1.0, 0.0, 0.2]])
    nodes4 = c.t10.mesh4.nodes
    ref = c.t10.nodes10(nodes4) @ coef
    err = np.abs((c.ts.prolong(torch.as_tensor(nodes4 @ coef)).numpy() - ref)
                 * c.ts.free.numpy()).max()
    assert err < 1e-12 * np.abs(ref).max()  # exact away from the clamp mask


@pytest.mark.parametrize("grid", list(GRIDS))
def test_apply_M_matches(cases, grid):
    c = _case(cases, grid)
    n10 = c.t10.nodes10(c.t10.mesh4.nodes)
    ja = c.js._jit_setup(jnp.asarray(n10), jnp.asarray(P4), jnp.asarray(5e3), LAM, MU)
    Jinv, vols, Binv, lmax, smg_state = ja
    smg_state = c.js.smg.finalize(smg_state, np.asarray(P4)[None, :], LAM, MU)
    tb = c.ts._setup(torch.as_tensor(n10), np.asarray(P4), LAM, MU)
    assert abs(float(tb[3]) - float(lmax)) <= 1e-10 * float(lmax)
    r = np.random.default_rng(5).normal(size=(c.t10.num_nodes, 3)) * np.asarray(c.ts.free)
    za = c.js.apply_M(Jinv, vols, Binv, lmax, smg_state, LAM, MU, jnp.asarray(r))
    zb = c.ts.apply_M(*tb, LAM, MU, torch.as_tensor(r))
    _close(zb, za, 1e-10)


@pytest.mark.parametrize("grid", list(GRIDS))
def test_solve_f64_matches(cases, grid):
    c = _case(cases, grid)
    ref = c.tpufem("mg")
    out = c.ts.solve(P4, c.bs.surf_upper_faces, pressure=5e3, tol=1e-9, maxiter=2000)
    print(f"{grid}: Tet10MGSolver f64 {out.iters} iterations (tpufem {ref.iters}), rel "
          f"{out.rel_residual:.3e}")
    assert out.converged and out.rel_residual <= 1e-9 and out.u.dtype == np.float64
    _close(out.u, ref.u, 1e-7)
    _close(out.vm, ref.vm, 1e-7)


@pytest.mark.parametrize("grid", list(GRIDS))
def test_outer_f64_matches(cases, grid):
    """The f64 CG with the f32 V-cycle as preconditioner (its geometry the f64
    one cast to f32), against tpufem's same branch."""
    c = _case(cases, grid)
    js = JSolver(c.jres, c.jt10, dtype=jnp.float32)
    ref = js.solve(P4, c.bs.surf_upper_faces, pressure=5e3, tol=1e-9, maxiter=2000,
                   outer_f64=True)
    solver = Tet10MGSolver(c.res, c.t10, dtype=torch.float32, device="cpu")
    out = solver.solve(P4, c.bs.surf_upper_faces, pressure=5e3, tol=1e-9, maxiter=2000,
                       outer_f64=True)
    print(f"{grid}: outer_f64 {out.iters} iterations (tpufem {ref.iters}), rel "
          f"{out.rel_residual:.3e}")
    assert out.converged and out.rel_residual <= 1e-9 and out.u.dtype == np.float64
    _close(out.u, ref.u, 1e-7)
    _close(out.u, c.tpufem("mg").u, 1e-7)


@pytest.mark.parametrize("refine_steps", [6, 1])
@pytest.mark.parametrize("grid", list(GRIDS))
def test_refine_and_polish_reach_the_true_residual(cases, grid, refine_steps):
    """refine_steps=6 converges by refinement; refine_steps=1 leaves the
    TRUE residual far above tol, so the f64 polish and the final pass run."""
    c = _case(cases, grid)
    solver = Tet10MGSolver(c.res, c.t10, dtype=torch.float32, device="cpu")
    out = solver.solve(P4, c.bs.surf_upper_faces, pressure=5e3, tol=5e-7, maxiter=8000,
                       chunk_iters=200, refine_steps=refine_steps, inner_tol=1e-4)
    print(f"{grid} refine_steps={refine_steps}: {out.iters} iterations, TRUE rel "
          f"{out.rel_residual:.3e}")
    assert out.converged and out.rel_residual <= 5e-7 and out.u.dtype == np.float64
    _close(out.u, c.tpufem("mg").u, 1e-6)
    assert np.isfinite(out.vm).all() and out.vm.dtype == np.float32


@pytest.mark.parametrize("grid", list(GRIDS))
def test_solve_tet10_case_matches_and_is_slower_than_pmg(cases, grid):
    c = _case(cases, grid)
    ua, vma, it_a, rel_a, conv_a = c.tpufem("case")
    ub, vmb, it_b, rel_b, conv_b = tt10.solve_tet10_case(
        c.t10, tt10.tet10_root_nodes(c.t10), c.upper_t6(), pressure=5e3, tol=1e-9, maxiter=8000,
        dtype=torch.float64, nj2=2 * c.res.n_span + 1, device="cpu")
    print(f"{grid}: solve_tet10_case {it_b} iterations (tpufem {it_a}), rel {rel_b:.3e}")
    assert conv_a and conv_b and rel_b <= 1e-9
    _close(ub, ua, 1e-7)
    _close(vmb, vma, 1e-7)
    mg = c.ts.solve(P4, c.bs.surf_upper_faces, pressure=5e3, tol=1e-9, maxiter=2000)
    assert mg.iters < it_b  # p-MG must beat the tet10 two-level
    _close(mg.u, ub, 1e-7)
