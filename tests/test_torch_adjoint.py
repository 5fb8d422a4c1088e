"""Port parity: tpufem_torch.fem.adjoint.DifferentiableWingFEM, its pieces
and the optimize_wing CLI against tpufem, on the CPU.

tpufem's whole adjoint gradient costs ~80 s here (its jit compile); so its
pieces, which need no CG, are held to tpufem's jax.vjp on the same seeded
inputs, and the port's whole gradient to the port's own central
differences:
- kernel K's plain version against jax.vjp of tpufem's strain_apply with
  respect to the cell geometry (8x10x2, LE and sharp TE): 1e-12 of the
  largest entry;
- the VJP of F(p) = strain_apply(geo(p), u) - b(p) at fixed u (the adjoint's
  last step), of the loads b(p) alone, and of the objectives' recovery
  (volume, smooth-max von Mises) against tpufem's at 8x12x2, two lanes:
  1e-12 of the largest entry;
- the backwards of kernels B's and E's autograd Functions (StrainApplyGeo:
  kernel K; CsrSegmentSum: the row gather) against autograd of the plain
  versions, called with the CPU stand-ins of their kernels;
- the compliance and smooth-max gradients of DifferentiableWingFEM(device
  "cpu") against central differences (chord and thickness of both lanes):
  1e-5 relative;
- torch.optim.Adam against optax.adam over 3 steps of a fixed gradient
  sequence (optax only here: the port never imports it);
- the optimize_wing CLI with --device cpu at a tiny size writes tpufem's
  keys (those of results/wing_optimization.json).
"""

import json
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import tpufem.fem.stencil as jst
from tpufem.fem.material import Material as JMaterial
from tpufem.fem.material import lame_params as jlame
from tpufem.fem.stencil_mg import WingStencilT as JWingStencilT
from tpufem.mesher import WingMeshResolution as JRes
from tpufem_torch.fem import stencil as tst
from tpufem_torch.fem.adjoint import DifferentiableWingFEM
from tpufem_torch.mesher import WingMeshResolution
from tpufem_torch.ops import csr_segment_sum as tcs
from tpufem_torch.scripts import optimize_wing

REPO = Path(__file__).resolve().parents[1]
LAM, MU = jlame(JMaterial())
PRESSURE = 5e3
P0 = np.array([[1.2, 0.35, 10.0, 0.10], [1.7, 0.25, 22.0, 0.08]])
RES, JRES = WingMeshResolution(8, 12, 2, 0.006, "le"), JRes(8, 12, 2, 0.006, "le")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The CG loops here are thousands of small ops; under the suite's
    parallel workers, torch's intra-op threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def fem():
    return DifferentiableWingFEM(RES, P0, pressure=PRESSURE, tol=1e-11, maxiter=4000,
                                 device="cpu")


@pytest.fixture(scope="module")
def jwing():
    """tpufem's loads and recovery machinery at RES in f64 (nothing is
    compiled). tpufem's DifferentiableWingFEM reads the node basis of its f32
    WingStencilT in volume and smooth_max_vm (the node map rounded to f32,
    ~1e-8); the port's reads the f64 basis, and so does this reference."""
    return JWingStencilT(JRES, dtype=jnp.float64)


def _close(got, ref, bar=1e-12):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    err = np.abs(got - ref).max()
    assert err <= bar * np.abs(ref).max(), (err, np.abs(ref).max())


def _fields(shape, active, seeds):
    rng = [np.random.default_rng(s) for s in seeds]
    return [r.standard_normal(shape) * active for r in rng]


@pytest.mark.parametrize("te", [0.006, 0.0], ids=["le", "sharp-te"])
def test_geometry_vjp_matches_tpufem(te):
    """Kernel K's plain version: the cotangents of (g, vol) of w . strain_apply."""
    res, jres = WingMeshResolution(8, 10, 2, te, "le"), JRes(8, 10, 2, te, "le")
    p4 = P0[:1]
    geo = tst.cell_geometry(res, tst.nodes_grid(res, torch.as_tensor(p4), torch.float64))
    jgeo = jst.cell_geometry(jres, jst.nodes_grid(jres, jnp.asarray(p4), jnp.float64))
    free = np.ones((1, 1, 1, 1, 11))
    free[..., 0] = 0.0
    u, w = _fields((3, 1, 9, 3, 11), free, (1, 2))
    u = u * 1e-3

    def sa(gg):
        return jst.strain_apply(jres, gg, jnp.asarray(u), jnp.asarray(free), LAM, MU)

    ((jg, jv),) = jax.jit(lambda gg, c: jax.vjp(sa, gg)[1](c))(jgeo, jnp.asarray(w))
    g, v = tst.strain_apply_geo_vjp(res, geo, *(torch.as_tensor(a) for a in (u, w, free)),
                                    LAM, MU)
    _close(g.numpy(), jg)
    _close(v.numpy(), jv)


def _j_system(jwing, p4):
    X = jst.nodes_grid(JRES, p4, jnp.float64)
    nodes = jst.from_grid(JRES, X)
    return jst.cell_geometry(JRES, X), jwing._loads_grid(nodes, PRESSURE, jnp.float64)


@pytest.mark.parametrize("part", ["residual form", "loads"])
def test_residual_form_vjp_matches_tpufem(fem, jwing, part):
    """The VJP of F(p) = K(p) u - b(p) at fixed u (tpufem/fem/adjoint.py:147-158),
    and of b(p) alone, for a seeded cotangent."""
    active = fem._active64.numpy()
    u, lam_adj = _fields((3, 2, 9, 3, 13), active, (3, 4))
    u = u * 1e-4
    jfree = jwing.smg.free_masks[0].astype(jnp.float64)

    def F(p):
        geo, bg = _j_system(jwing, p)
        if part == "loads":
            return bg
        return jst.strain_apply(JRES, geo, jnp.asarray(u), jfree, LAM, MU) - bg

    (ref,) = jax.jit(lambda p, c: jax.vjp(F, p)[1](c))(jnp.asarray(P0), jnp.asarray(lam_adj))
    p = torch.tensor(P0, requires_grad=True)
    geo, bg = fem._system(p)
    out = bg if part == "loads" else tst.strain_apply(
        RES, geo, torch.as_tensor(u), fem._free64, LAM, MU) - bg
    (got,) = torch.autograd.grad(out, p, grad_outputs=torch.as_tensor(lam_adj))
    _close(got.numpy(), ref)


@pytest.mark.parametrize("objective", ["volume", "smooth_max_vm"])
def test_objective_vjp_matches_tpufem(fem, jwing, objective):
    """The recovery chain of the objectives (tpufem/fem/adjoint.py:178-198,
    tpufem's code below) against the port's, in p4 and in u."""
    u = _fields((3, 2, 9, 3, 13), fem._active64.numpy(), (5,))[0] * 1e-4
    bt = jwing.bt
    lam64, mu64 = jnp.float64(LAM), jnp.float64(MU)

    def j_obj(p4, u_grid):
        nodes = bt._nodes(p4)
        grads, vols = bt._grads_vols(nodes)
        if objective == "volume":
            return vols.sum(axis=0)
        _, _, vm = bt._recover(grads, vols, jst.from_grid(JRES, u_grid), lam64, mu64)
        scale = vm.mean(axis=0) + 1e-30
        return scale / 30.0 * jax.scipy.special.logsumexp(30.0 * vm / scale[None, :], axis=0)

    cot = np.array([0.7, -1.3])
    val, (ref_p, ref_u) = jax.jit(lambda p, x, c: (j_obj(p, x), jax.vjp(j_obj, p, x)[1](c)))(
        jnp.asarray(P0), jnp.asarray(u), jnp.asarray(cot))
    p, ut = torch.tensor(P0, requires_grad=True), torch.tensor(u, requires_grad=True)
    got = fem.volume(p) if objective == "volume" else fem.smooth_max_vm(p, ut)
    _close(got.detach().numpy(), val)
    gp, gu = torch.autograd.grad(got, (p, ut), grad_outputs=torch.as_tensor(cot),
                                 allow_unused=True)
    _close(gp.numpy(), ref_p)
    if objective == "smooth_max_vm":
        _close(gu.numpy(), ref_u)


def test_function_backwards_match_plain_autograd(fem):
    """StrainApplyGeo.backward (kernel K) and CsrSegmentSum.backward (the row
    gather), run with their kernels' CPU stand-ins, against autograd of the
    plain versions."""
    p = torch.tensor(P0)
    geo, _ = fem._system(p)
    g, vol = (t.clone().requires_grad_() for t in geo)
    u, w = (torch.as_tensor(a) for a in _fields((3, 2, 9, 3, 13), fem._active64.numpy(), (6, 7)))
    y = tst.strain_apply_plain(RES, (g, vol), u, fem._free64, LAM, MU)
    ref = torch.autograd.grad(y, (g, vol), grad_outputs=w)
    ctx = SimpleNamespace(res=RES, lam=LAM, mu=MU,
                          saved_tensors=(g.detach(), vol.detach(), u, fem._free64))
    _, gb, vb, *rest = tst.StrainApplyGeo.backward(ctx, w)
    assert all(r is None for r in rest)
    _close(gb.numpy(), ref[0].numpy())
    _close(vb.numpy(), ref[1].numpy())

    plan = fem.st.bt.tet_plan
    vals = torch.randn((plan.order.shape[0], 5), dtype=torch.float64, requires_grad=True)
    cot = torch.randn((plan.num_segments, 5), dtype=torch.float64)
    (ref_v,) = torch.autograd.grad(tcs.csr_segment_sum_plain(vals, plan), vals, cot)
    got, none = tcs.CsrSegmentSum.backward(SimpleNamespace(plan=plan), cot)
    assert none is None and torch.equal(got, ref_v)


def test_gradients_match_central_differences(fem):
    """dJ/dp of the compliance and of the smooth-max von Mises through the
    adjoint solve against central differences of the same objectives, for
    chord and thickness of both lanes; the thicker wing is stiffer."""
    p = torch.tensor(P0, requires_grad=True)
    u = fem.solve(p)
    comp, smax = fem.compliance(p, u).sum(), fem.smooth_max_vm(p, u).sum()
    g_c = torch.autograd.grad(comp, p, retain_graph=True)[0].numpy()
    g_s = torch.autograd.grad(smax, p)[0].numpy()
    for label in ("primal", "adjoint"):
        assert float(fem.true_residual(label).max()) < 1e-7
    eps = {1: 1e-5, 3: 1e-6}
    for b in range(2):
        for i, e in eps.items():
            vals = []
            for sign in (1, -1):
                pp = P0.copy()
                pp[b, i] += sign * e
                with torch.no_grad():
                    ui = fem.solve(pp)
                    vals.append((float(fem.compliance(pp, ui).sum()),
                                 float(fem.smooth_max_vm(pp, ui).sum())))
            for g, k in ((g_c, 0), (g_s, 1)):
                fd = (vals[0][k] - vals[1][k]) / (2 * e)
                assert abs(g[b, i] - fd) <= 1e-5 * abs(fd), (b, i, k, g[b, i], fd)
    assert (g_c[:, 3] < 0).all(), "d(compliance)/d(thickness) must be negative"


def test_adam_matches_optax():
    """torch.optim.Adam with optax.adam's settings takes optax's steps."""
    rng = np.random.default_rng(8)
    grads = [rng.standard_normal((4, 2)) for _ in range(3)]
    opt = optax.adam(0.05)
    theta_j = jnp.zeros((4, 2), jnp.float64)
    state = opt.init(theta_j)
    theta = torch.zeros((4, 2), dtype=torch.float64, requires_grad=True)
    topt = torch.optim.Adam([theta], lr=0.05, betas=(0.9, 0.999), eps=1e-8)
    for g in grads:
        upd, state = opt.update(jnp.asarray(g), state)
        theta_j = optax.apply_updates(theta_j, upd)
        theta.grad = torch.as_tensor(g)
        topt.step()
        np.testing.assert_allclose(theta.detach().numpy(), np.asarray(theta_j), rtol=1e-12,
                                   atol=1e-15)


def test_optimize_cli_writes_tpufem_keys(tmp_path):
    out = tmp_path / "opt.json"
    rc = optimize_wing.main(["--n_chord", "8", "--n_span", "12", "--n_thick", "2", "--steps",
                             "2", "--out", str(out), "--device", "cpu"])
    assert rc == 0
    rep = json.loads(out.read_text())
    ref = json.loads((REPO / "results/wing_optimization.json").read_text())
    assert set(rep) == set(ref) and rep["device"] == "cpu"
    assert [h["step"] for h in rep["history"]] == [0, 1]
    assert set(rep["history"][0]) == set(ref["history"][0])
    # the first step starts mid-box at the reference volumes; the loss falls
    assert rep["history"][0]["volume_ratio"] == [1.0] * 4
    assert rep["history"][1]["loss"] < rep["history"][0]["loss"]
