"""The port's trailing-batch multigrid (tpufem_torch/fem/multigrid.py)
against tpufem's on the same inputs, on the CPU, at tpufem's test grid
16x16x4 (LE spacing, TE floor) with two wings:

- build_hierarchy: the levels' resolutions, line plans, masks and node maps,
  and every transfer's parents, children and weights equal tpufem's
  exactly; restriction is the exact transpose of prolongation, and
  prolongation reproduces linear fields;
- nodes_t / grads_vols_t to 1e-14; force_t (kernel O's plain version) to
  1e-12 of the largest entry in f64 and 1e-5 in f32;
- line_blocks_t / line_apply_t and rbm_setup_t / rbm_apply_t to 1e-9 of the
  largest entry: the port inverts by batched Cholesky, tpufem by
  Newton-Schulz iterations (both after symmetric Jacobi scaling, the RBM
  operator with the same ridge 3e-4), which agree to ~1e-11 here;
- dense_stiffness_t to 1e-12; one WingMGT.apply (the V-cycle) on the same
  residual, f64, to 1e-9.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpufem.fem import multigrid as jmg
from tpufem.fem.batched_t import WingBatchT as JWingBatchT
from tpufem.mesher import WingMeshResolution as JRes
from tpufem.mesher import _nodes_np
from tpufem_torch.fem import multigrid as tmg
from tpufem_torch.fem.assembly import stiffness_apply_t_plain
from tpufem_torch.fem.material import Material, lame_params
from tpufem_torch.fem.precond import build_rbm_groups, build_rbm_plan
from tpufem_torch.mesher import WingMeshResolution

RES = WingMeshResolution(16, 16, 4, te_floor_frac=0.006, spacing="le")
JRES = JRes(16, 16, 4, te_floor_frac=0.006, spacing="le")
P4 = np.array([[1.2, 0.35, 10.0, 0.10], [1.8, 0.25, 25.0, 0.07]])
LAM, MU = lame_params(Material())


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def hiers():
    return tmg.build_hierarchy(RES), jmg.build_hierarchy(JRES)


@pytest.fixture(scope="module")
def level0():
    """(port WingMGT f64 on the CPU, tpufem WingMGT f64, port (nodes, grads,
    vols) of the batch, and a seeded residual (N,3,B) in numpy)."""
    mg = tmg.WingMGT(tmg.build_hierarchy(RES), dtype=torch.float64, device="cpu")
    jm = jmg.WingMGT(jmg.build_hierarchy(JRES), dtype=jnp.float64)
    lv = mg.levels[0]
    nodes = tmg.nodes_t(lv["basis"], lv["te_floor"], torch.as_tensor(P4), torch.float64)
    grads, vols = tmg.grads_vols_t(nodes, lv["tets"].long())
    r = np.random.default_rng(3).normal(size=(lv["num_nodes"], 3, len(P4)))
    return mg, jm, (nodes, grads, vols), r


def _close(a, b, tol):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    err = np.abs(a - b).max()
    assert err <= tol * np.abs(b).max(), (err, np.abs(b).max())


def test_hierarchy_equals_tpufem(hiers):
    h, j = hiers

    def keys(hier):
        return [(r.n_chord, r.n_span, r.n_thick, r.te_floor_frac, r.spacing)
                for r in (lv.res for lv in hier.levels)]

    assert keys(h) == keys(j)
    assert len(h.levels) == 3
    for a, b in zip(h.levels, j.levels):
        np.testing.assert_array_equal(a.free3, b.free3)
        for f in ("pair_t", "pair_a", "pair_b", "pair_seg", "station_nodes", "slot_valid",
                  "node_station", "node_slot"):
            np.testing.assert_array_equal(getattr(a.plan, f), getattr(b.plan, f))
        np.testing.assert_array_equal(a.topo.tets, b.topo.tets)
        assert a.incidence.num_segments == a.topo.num_nodes
    for a, b in zip(h.transfers, j.transfers):
        for f in ("parents", "pweights", "children", "cweights"):
            x, y = getattr(a, f), getattr(b, f)
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)


def test_restriction_is_exact_transpose(hiers):
    h, _ = hiers
    for i, tr in enumerate(h.transfers):
        rng = np.random.default_rng(i)
        xc = rng.normal(size=(h.levels[i + 1].topo.num_nodes, 3))
        yf = rng.normal(size=(h.levels[i].topo.num_nodes, 3))
        Pxc = (xc[tr.parents] * tr.pweights[:, :, None]).sum(axis=1)
        Ptyf = (yf[tr.children] * tr.cweights[:, :, None]).sum(axis=1)
        assert np.isclose((yf * Pxc).sum(), (xc * Ptyf).sum(), rtol=1e-12)


def test_prolongation_reproduces_linear_fields(hiers):
    h, _ = hiers
    tr, fine, coarse = h.transfers[0], h.levels[0], h.levels[1]
    args = dict(span_m=1.2, chord_m=0.35, sweep_deg=10.0, thickness_ratio=0.10,
                te_floor=RES.te_floor_frac)
    xf, xc = _nodes_np(fine.topo.node_basis, **args), _nodes_np(coarse.topo.node_basis, **args)
    coef = np.array([0.3, -1.1, 2.0])
    interp = ((xc @ coef)[tr.parents] * tr.pweights).sum(axis=1)
    u_f = xf @ coef
    assert np.abs(interp - u_f).max() / np.abs(u_f).max() < 0.02
    interp_y = (xc[:, 1][tr.parents] * tr.pweights).sum(axis=1)
    assert np.abs(interp_y - xf[:, 1]).max() / np.abs(xf[:, 1]).max() < 1e-6  # f32 weights


def test_geometry_matches(level0):
    mg, jm, (nodes, grads, vols), _ = level0
    jl = jm.levels[0]
    jn = jmg.nodes_t(jl["basis"], jl["te_floor"], jnp.asarray(P4), jnp.float64)
    jg, jv = jmg.grads_vols_t(jn, jl["tets"])
    _close(nodes, jn, 1e-14)
    _close(grads, jg, 1e-13)
    _close(vols, jv, 1e-13)


@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_force_t_matches(level0, dtype):
    mg, jm, (nodes, grads, vols), r = level0
    lv, jl = mg.levels[0], jm.levels[0]
    td, jd, tol = ((torch.float64, jnp.float64, 1e-12) if dtype == "f64"
                   else (torch.float32, jnp.float32, 1e-5))
    g, v, u = grads.to(td), vols.to(td), torch.as_tensor(r).to(td)
    y = tmg.force_t(g, v, lv["tets"], lv["plans"], u, LAM, MU)
    yj = jmg.force_t(jnp.asarray(g.numpy()), jnp.asarray(v.numpy()), jl["tets"], jl["inc"],
                     jl["incm"].astype(jd), jnp.asarray(u.numpy()), jd(LAM), jd(MU))
    _close(y.numpy(), yj, tol)
    # the masked apply is the plain version of kernel O with `free`
    free = lv["free"].to(td)
    ym = stiffness_apply_t_plain(g, v, lv["tets"], u, LAM, MU, lv["plans"](2, td), free)
    fr = free[:, :, None]
    assert torch.equal(ym, tmg.force_t(g, v, lv["tets"], lv["plans"], u * fr, LAM, MU) * fr
                       + u * (1.0 - fr))


def test_line_blocks_and_apply_match(level0):
    mg, jm, (nodes, grads, vols), r = level0
    lv, jl = mg.levels[0], jm.levels[0]
    Binv = tmg.line_blocks_t(lv, grads, vols, LAM, MU, lv["free"])
    jB = jmg.line_blocks_t(jl, jnp.asarray(grads.numpy()), jnp.asarray(vols.numpy()), LAM, MU,
                           jl["free"], jnp.float64)  # (S,D,D,B)
    _close(Binv.permute(0, 2, 3, 1).numpy(), jB, 1e-9)
    z = tmg.line_apply_t(lv, Binv, torch.as_tensor(r))
    _close(z.numpy(), jmg.line_apply_t(jl, jB, jnp.asarray(r)), 1e-9)


def test_rbm_setup_and_apply_match(level0, hiers):
    mg, jm, (nodes, grads, vols), r = level0
    lv, jl = mg.levels[0], jm.levels[0]
    topo = hiers[0].levels[0].topo
    ng, n_groups = build_rbm_groups(topo.station_id, topo.slot, RES.n_chord + 1, RES.n_span + 1)
    rbm = build_rbm_plan(ng, n_groups, topo.tets, "cpu")
    Ac_inv, dvec = tmg.rbm_setup_t(lv, rbm, nodes, grads, vols, LAM, MU)
    jAc, jd = jmg.rbm_setup_t(jl, jnp.asarray(ng), n_groups, jnp.asarray(nodes.numpy()),
                              jnp.asarray(grads.numpy()), jnp.asarray(vols.numpy()), LAM, MU,
                              jnp.float64)
    _close(dvec.numpy(), jd, 1e-13)
    _close(Ac_inv.numpy(), jAc, 1e-9)
    z = tmg.rbm_apply_t(lv, rbm, Ac_inv, dvec, torch.as_tensor(r))
    _close(z.numpy(), jmg.rbm_apply_t(jl, jnp.asarray(ng), n_groups, jAc, jd, jnp.asarray(r)),
           1e-9)


def test_dense_stiffness_matches(level0):
    mg, jm, _, _ = level0
    lv, jl = mg.levels[-1], jm.levels[-1]
    nodes = tmg.nodes_t(lv["basis"], lv["te_floor"], torch.as_tensor(P4), torch.float64)
    grads, vols = tmg.grads_vols_t(nodes, lv["tets"].long())
    Kd = tmg.dense_stiffness_t(lv, grads, vols, LAM, MU)
    jK = jmg.dense_stiffness_t(jl, jnp.asarray(grads.numpy()), jnp.asarray(vols.numpy()), LAM, MU,
                               jnp.float64)
    _close(Kd.numpy(), jK, 1e-12)


def test_vcycle_apply_matches(level0):
    mg, _, (nodes, grads, vols), r = level0
    state = mg.setup(torch.as_tensor(P4), LAM, MU, level0=(nodes, grads, vols))
    state = mg.finalize(state, P4, LAM, MU)
    z = mg.apply(state, torch.as_tensor(r))
    jbt = JWingBatchT(JRES, dtype=jnp.float64, mg_levels=None)
    _, _, _, _, jstate = jbt._jit_setup_mg(jnp.asarray(P4), jnp.float64(5e3), jnp.float64(LAM),
                                           jnp.float64(MU))
    jstate = jbt.mg.finalize(jstate, P4, LAM, MU)
    for st, js in zip(state[:-1], jstate[:-1]):
        _close(st["lmax"].numpy(), js["lmax"], 1e-9)
    _close(z.numpy(), jbt.mg.apply(jstate, jnp.asarray(r)), 1e-9)
    # symmetric positive: <v, Vu> == <u, Vv>, <u, Vu> > 0
    v = torch.as_tensor(np.random.default_rng(4).normal(size=r.shape))
    u = torch.as_tensor(r)
    Vv = mg.apply(state, v)
    assert np.allclose((v * z).sum(dim=(0, 1)).numpy(), (u * Vv).sum(dim=(0, 1)).numpy(),
                       rtol=1e-10)
    assert bool(((u * z).sum(dim=(0, 1)) > 0).all())
