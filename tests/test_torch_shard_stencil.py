"""The port's span-sharded stencil multigrid (tpufem_torch.parallel.shard_stencil)
against tpufem and against the port's single-device engines, on the CPU
under gloo:

- host only: make_plan equals tpufem's (DOF1M_TET10 over 8 ranks: n_shard 5,
  cells (16,8,4,2,1); 16x16x2 over 2 and 4); the span transfers
  _restrict_span_local / _interp_span_local and a slab's
  nodes_grid(yfrac=...) equal tpufem's to 1e-15 (the slab also equals the
  full grid's slice);
- sharded tet4 at 16x16x2, f64, tol 1e-8, at world 1, 2 and 4: u within 1e-8
  (of the largest displacement) of the port's WingStencilT(dtype=float64),
  which test_torch_keywords holds to tpufem's, iterations within 2, the same
  u on every rank;
- sharded tet10 at 16x16x2, world 2: u within 1e-8 of the port's
  Tet10StencilT(dtype=float64), iterations within 2.

Each world size spawns its ranks once (a module-scoped fixture runs every
case of that size in one run_ranks call); every collective times out, so a
fault fails its test instead of hanging the suite. A slow test mirrors
tests/test_shard_stencil.py: the port's sharded tet4 and tet10 at 8 ranks
against tpufem's ShardedStencilSolver on 8 virtual devices.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpufem_torch.fem.stencil import nodes_grid
from tpufem_torch.fem.stencil_mg import WingStencilT
from tpufem_torch.fem.tet10_stencil import Tet10StencilT
from tpufem_torch.mesher import DOF1M_TET10, WingMeshResolution, structured_wing_mesh
from tpufem_torch.parallel.launch import run_all, run_ranks
from tpufem_torch.parallel.meshes import make_mesh
from tpufem_torch.parallel.shard_stencil import (
    _interp_span_local,
    _restrict_span_local,
    make_plan,
    sharded_solve,
    slab_yfrac,
)
from tpufem_torch.sets import build_boundary_sets

RES = WingMeshResolution(16, 16, 2, 0.006, "le")
PARAMS = (1.2, 0.35, 10.0, 0.10)
TIMEOUT = 240.0  # seconds a spawn (and each of its collectives) may take


def _tpufem_res(r):
    from tpufem.mesher import WingMeshResolution as JR

    return JR(r.n_chord, r.n_span, r.n_thick, r.te_floor_frac, r.spacing)


# ------------------------------------------------------------- host only


@pytest.mark.parametrize("res,n", [(DOF1M_TET10, 8), (RES, 2), (RES, 4)],
                         ids=["flagship-8", "16x16x2-2", "16x16x2-4"])
def test_make_plan_equals_tpufem(res, n):
    from tpufem.parallel.shard_stencil import make_plan as jplan

    plan, levels = make_plan(res, n)
    jp, jlevels = jplan(_tpufem_res(res), n)
    assert (plan.n_shard, plan.cells, plan.n_devices) == (jp.n_shard, jp.cells, jp.n_devices)
    assert [(r.n_chord, r.n_span, r.n_thick) for r in levels] == [
        (r.n_chord, r.n_span, r.n_thick) for r in jlevels]
    if res is DOF1M_TET10:
        assert plan.n_shard == 5 and plan.cells == (16, 8, 4, 2, 1)
        assert levels[plan.n_shard].n_span == 4  # the replicated tail


def test_span_transfers_equal_tpufem():
    from tpufem.parallel import shard_stencil as js

    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 1, 5, 3, 9))
    got = _restrict_span_local(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(js._restrict_span_local(jnp.asarray(x))),
                               rtol=0, atol=1e-15)
    xc = rng.standard_normal((3, 1, 5, 3, 5))
    got = _interp_span_local(torch.as_tensor(xc)).numpy()
    np.testing.assert_allclose(got, np.asarray(js._interp_span_local(jnp.asarray(xc))),
                               rtol=0, atol=1e-15)


@pytest.mark.parametrize("rank", [0, 1, 3])
def test_slab_nodes_grid_equals_tpufem(rank):
    from tpufem.fem.stencil import nodes_grid as jgrid

    c = RES.n_span // 4
    yf = slab_yfrac(rank, c, RES.n_span)
    p4 = np.array([PARAMS, (1.8, 0.25, 25.0, 0.07)])
    got = nodes_grid(RES, torch.as_tensor(p4), torch.float64, yfrac=yf).numpy()
    want = np.asarray(jgrid(_tpufem_res(RES), jnp.asarray(p4), jnp.float64, yfrac=yf))
    assert got.shape == (3, 2, RES.n_chord + 1, RES.n_thick + 1, c + 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-15)
    full = nodes_grid(RES, torch.as_tensor(p4), torch.float64).numpy()
    np.testing.assert_array_equal(got, full[..., rank * c: rank * c + c + 1])


# ------------------------------------------------------------- the solves


def _case(element, tol=1e-8, maxiter=600):
    return (sharded_solve, (RES, element, torch.float64, PARAMS, 5e3, tol, maxiter))


@pytest.fixture(scope="module")
def ref_tet4():
    out = WingStencilT(RES, dtype=torch.float64, device="cpu").solve(
        np.array([PARAMS]), pressure=5e3, tol=1e-8, maxiter=400)
    return out.u.numpy()[:, :, 0], out.iters


@pytest.fixture(scope="module")
def ref_tet10():
    wm = structured_wing_mesh(*PARAMS, RES)
    bs = build_boundary_sets(wm)
    out = Tet10StencilT(RES, dtype=torch.float64, device="cpu").solve(
        np.array([PARAMS]), bs.surf_upper_faces, pressure=5e3, tol=1e-8, maxiter=600)
    return out.u[:, :, 0], out.iters


@pytest.fixture(scope="module")
def runs():
    """Every rank's results, by world size: tet4 at 1 (this process, no
    group), 2 and 4 ranks, tet10 at 2 (one spawn per world size)."""
    out = {1: [run_all(make_mesh(1, "gloo", "cpu"), [_case("tet4")])]}
    for w, c in {2: [_case("tet4"), _case("tet10")], 4: [_case("tet4")]}.items():
        out[w] = run_ranks(run_all, w, "gloo", "cpu", args=(c,), timeout_s=TIMEOUT)
    return out


@pytest.mark.parametrize("world", [1, 2, 4])
def test_sharded_tet4_matches_single_device(runs, ref_tet4, world):
    u1, it1 = ref_tet4
    outs = [r[0] for r in runs[world]]
    assert all(o["rel"] <= 1e-8 for o in outs)
    assert abs(outs[0]["iters"] - it1) <= 2, (outs[0]["iters"], it1)
    assert np.abs(outs[0]["u"] - u1).max() <= 1e-8 * np.abs(u1).max()
    for o in outs[1:]:  # every rank holds the same solution and count
        assert o["iters"] == outs[0]["iters"]
        np.testing.assert_array_equal(o["u"], outs[0]["u"])
    assert outs[0]["cells"] == tuple(RES.n_span // (2**k * world)
                                     for k in range(outs[0]["n_shard"]))


def test_sharded_tet10_matches_single_device(runs, ref_tet10):
    u1, it1 = ref_tet10
    outs = [r[1] for r in runs[2]]
    assert all(o["rel"] <= 1e-8 for o in outs)
    assert abs(outs[0]["iters"] - it1) <= 2, (outs[0]["iters"], it1)
    assert np.abs(outs[0]["u"] - u1).max() <= 1e-8 * np.abs(u1).max()
    np.testing.assert_array_equal(outs[1]["u"], outs[0]["u"])


@pytest.mark.slow
def test_sharded_8_ranks_match_tpufem_8_devices():
    """tests/test_shard_stencil.py's solves, the port at 8 ranks against
    tpufem's ShardedStencilSolver on 8 virtual devices: u within 1e-8,
    iterations within 2."""
    from jax.sharding import Mesh

    from tpufem.parallel.shard_stencil import ShardedStencilSolver as JS

    devs = jax.devices()
    if len(devs) < 8:
        pytest.skip("needs 8 (virtual) devices")
    mesh = Mesh(np.array(devs[:8]), ("mesh",))
    outs = run_ranks(run_all, 8, "gloo", "cpu", timeout_s=900.0,
                     args=([_case("tet4", maxiter=400), _case("tet10")],))[0]
    for out, element, maxiter in ((outs[0], "tet4", 400), (outs[1], "tet10", 600)):
        ju, jit_, jrel = JS(_tpufem_res(RES), 8, element=element, dtype=jnp.float64).solve(
            PARAMS, mesh, pressure=5e3, tol=1e-8, maxiter=maxiter, chunk_iters=None)
        assert out["rel"] <= 1e-8 and jrel <= 1e-8
        assert abs(out["iters"] - jit_) <= 2, (element, out["iters"], jit_)
        assert np.abs(out["u"] - ju).max() <= 1e-8 * np.abs(ju).max(), element
