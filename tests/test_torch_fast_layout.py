"""WingBatchT.solve(fast_layout=True), tpufem's EXPERIMENTAL element-minor
layout, against tpufem's on the same inputs, on the CPU. The port runs the
branch as what it computes: the two-level CG with every lane dot summed in
f64, on the default layout's (N,3,B) states and kernel O's operator.

- the operator: WingBatchT._apply_A (kernel O's wrapper, its plain version
  here), and force_t unmasked, against tpufem's _apply_A_fast / _force_fast
  on the same data in tpufem's layout, at COARSE with B = 3 and at 12x10x3
  (LE spacing, TE floor) with B = 2: f64 within 1e-12 and f32 within 1e-5 of
  the largest entry;
- the solve at COARSE: f32 at tol 1e-5 (both converged, u within 2e-5 of
  tpufem's fast-layout u, the bar test_f32_engines_match_tpufem holds the
  default layout to; the f64 dots change the f32 iterates) and f64 at tol
  1e-10 (u within 1e-8); on the CPU no launch counter moves;
- in f64 the flag changes nothing (an f64 sum of f64 products is the
  default dot): the default solve's bits, as tpufem's two layouts agree in
  f64;
- under mg_levels=None the flag is ignored: the multigrid solve's bits.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpufem.fem.batched_t import WingBatchT as JWingBatchT
from tpufem.mesher import WingMeshResolution as JRes
from tpufem_torch.fem import assembly as asm
from tpufem_torch.fem import multigrid as mgt
from tpufem_torch.fem.batched_t import WingBatchT
from tpufem_torch.fem.material import Material, lame_params
from tpufem_torch.fem.multigrid import grads_vols_t, nodes_t
from tpufem_torch.mesher import COARSE, WingMeshResolution, wing_topology

P4 = np.array([[1.2, 0.35, 10.0, 0.10], [1.6, 0.42, 25.0, 0.07], [1.0, 0.20, 0.0, 0.15]])
LAM, MU = lame_params(Material())
# grid -> (port resolution, tpufem resolution, lanes)
GRIDS = {"COARSE": (COARSE, JRes(12, 8, 2, 0.0, "cosine"), 3),
         "12x10x3": (WingMeshResolution(12, 10, 3, 0.006, "le"), JRes(12, 10, 3, 0.006, "le"), 2)}
DTYPES = {"f64": (torch.float64, jnp.float64, 1e-12), "f32": (torch.float32, jnp.float32, 1e-5)}
F32 = {"tol": 1e-5, "u": 2e-5}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _maxrel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


def operator_inputs(res, B, seed=0):
    """(grads64 (T,4,3,B), vols64 (T,B), x64 (N,3,B)) of the first B rows of
    P4 at res."""
    topo = wing_topology(res)
    nodes = nodes_t(torch.as_tensor(topo.node_basis), topo.te_floor, torch.as_tensor(P4[:B]),
                    torch.float64)
    grads, vols = grads_vols_t(nodes, torch.as_tensor(topo.tets.astype(np.int64)))
    x = torch.as_tensor(np.random.default_rng(seed).normal(size=(topo.num_nodes, 3, B)) * 1e-3)
    return grads, vols, x


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("grid", list(GRIDS))
def test_operator_matches_tpufem(grid, dtype, masked):
    res, jres, B = GRIDS[grid]
    tdt, jdt, tol = DTYPES[dtype]
    g, v, x = (t.to(tdt) for t in operator_inputs(res, B))
    bt = WingBatchT(res, dtype=tdt, device="cpu")
    launches = asm.stiffness_apply_t.launches
    if masked:
        y = bt._apply_A(g, v, x, LAM, MU)
    else:
        y = mgt.force_t(g, v, bt.tets32, bt.force_plans, x, LAM, MU)
    assert asm.stiffness_apply_t.launches == launches
    assert y.shape == x.shape and y.dtype == tdt
    jbt = JWingBatchT(jres, dtype=jdt)
    # tpufem's element-minor operands: (4,3,B,T), (B,T), (3,B,N), free (3,1,N)
    ja = [jnp.asarray(t.numpy()) for t in (g.permute(1, 2, 3, 0).contiguous(),
                                             v.T.contiguous(), x.permute(1, 2, 0).contiguous())]
    if masked:
        fr = bt.free.T[:, None, :].contiguous()
        assert np.array_equal(np.asarray(jbt.free).T[:, None, :], fr.numpy())
        ref = jbt._apply_A_fast(*ja, jdt(LAM), jdt(MU), jnp.asarray(fr.numpy()))
    else:
        ref = jbt._force_fast(ja[0], ja[1], ja[2], jdt(LAM), jdt(MU))
    ref = np.asarray(ref).transpose(2, 0, 1)
    assert ref.dtype == np.dtype(dtype.replace("f", "float"))
    err = np.abs(y.numpy().astype(np.float64) - ref).max()
    assert err <= tol * np.abs(ref).max(), err
    if masked:  # the Dirichlet rows are x itself
        rows = np.broadcast_to((bt.free.numpy() == 0)[:, :, None], x.shape)
        assert np.array_equal(rows * y.numpy(), rows * x.numpy())


@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_fast_layout_solve_matches_tpufem(dtype):
    tdt, jdt, _ = DTYPES[dtype]
    tol, bar = (F32["tol"], F32["u"]) if dtype == "f32" else (1e-10, 1e-8)
    kw = dict(pressure=5000.0, tol=tol, maxiter=20000)
    launches = (asm.stiffness_apply_t.launches, asm.stiffness_apply.launches)
    bt = WingBatchT(COARSE, dtype=tdt, device="cpu")
    out = bt.solve(P4, fast_layout=True, **kw)
    assert (asm.stiffness_apply_t.launches, asm.stiffness_apply.launches) == launches
    ref = JWingBatchT(GRIDS["COARSE"][1], dtype=jdt).solve(P4, chunk_iters=20000,
                                                          fast_layout=True, **kw)
    u, ur = out.u.numpy(), np.asarray(ref.u)
    assert out.u.dtype == tdt and ur.dtype == u.dtype
    assert bool(out.converged.all()) and bool(np.all(np.asarray(ref.converged)))
    assert _maxrel(u, ur) < bar, _maxrel(u, ur)
    assert (out.rel_residual <= tol).all() and out.iters > 0
    default = bt.solve(P4, **kw)  # the default layout on the same solver
    assert bool(default.converged.all())
    assert _maxrel(u, default.u.numpy()) < bar
    if dtype == "f32":  # the f64 dots round otherwise than f32 sums
        assert not torch.equal(out.u, default.u)


def test_fast_layout_f64_is_the_default_solve():
    kw = dict(pressure=5000.0, tol=1e-10, maxiter=20000)
    bt = WingBatchT(GRIDS["12x10x3"][0], dtype=torch.float64, device="cpu")
    fast = bt.solve(P4[:2], fast_layout=True, **kw)
    plain = bt.solve(P4[:2], **kw)
    assert fast.iters == plain.iters and bool(fast.converged.all())
    for a, b in zip(fast, plain):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)


def test_fast_layout_ignored_under_multigrid():
    kw = dict(pressure=5000.0, tol=1e-8, maxiter=500)
    bt = WingBatchT(GRIDS["12x10x3"][0], dtype=torch.float64, mg_levels=None, device="cpu")
    fast = bt.solve(P4[:2], fast_layout=True, **kw)
    plain = bt.solve(P4[:2], **kw)
    assert fast.iters == plain.iters
    for a, b in zip(fast, plain):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)
    assert type(bt.mg) is mgt.WingMGT and len(bt.mg.levels) == 2
