"""The CUDA kernels of tpufem_torch against their plain PyTorch versions, on
the card. Every test here is marked gpu and skips without CUDA.

This file imports neither jax nor tpufem, so it also runs on a machine
without them; there run it without the JAX conftest:
    python -m pytest --noconftest -m gpu tests/test_torch_kernels.py -q
"""

import numpy as np
import pytest
import torch

from tpufem_torch.fem import assembly as tas
from tpufem_torch.fem import buckling as tbk
from tpufem_torch.fem import nonlinear as tnl
from tpufem_torch.fem.adjoint import DifferentiableWingFEM
from tpufem_torch.fem import stencil as tst
from tpufem_torch.fem.driver import WingSolveConfig, solve_wing_case
from tpufem_torch.fem.elements import tet4_setup
from tpufem_torch.fem.modal import WingModal
from tpufem_torch.fem.material import Material, lame_params
from tpufem_torch.fem.stencil_mg import WingStencilT
from tpufem_torch.mesher import (
    COARSE,
    DOF100K,
    MEDIUM,
    WingMeshResolution,
    structured_wing_mesh,
)
from tpufem_torch.ops import csr_segment_sum as tcs
from tpufem_torch.ops import gather_scatter as tgs
from tpufem_torch.profile_gather_operator import operator_inputs, permuted
from tpufem_torch.profile_geometric import geometric_inputs, measure as measure_geometric
from tpufem_torch.profile_nonlinear import (
    EDGE_RES,
    EDGE_ROWS_RES,
    KERNEL_NAMES,
    check_and_time,
    launch_tile,
    measure as measure_nonlinear,
    measure_vjp,
    nl_calls,
    nl_inputs,
    vjp_inputs,
)
from tpufem_torch.profile_solve import seeded_batch
from tpufem_torch.sets import build_boundary_sets
from tpufem_torch.utils.profiling import device_time

pytestmark = pytest.mark.gpu
LAM, MU = lame_params(Material())
P4 = np.array([[1.2, 0.35, 10.0, 0.10], [1.8, 0.25, 25.0, 0.07]])


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


WIDTHS = [1, 3, 8, 128, 130]  # 8 and 128 take the float4 route when aligned


def _rows(rng, shape, dev, offset):
    """A contiguous f32 tensor of `shape` whose storage starts `offset`
    floats past a 16-byte boundary (offset 1: the kernels' scalar route)."""
    n = int(np.prod(shape))
    buf = torch.zeros(n + 4, dtype=torch.float32, device=dev)
    view = buf[offset:offset + n].view(shape)
    view.copy_(torch.as_tensor(rng.normal(size=shape).astype(np.float32)))
    assert view.is_contiguous() and (view.data_ptr() % 16 == 0) == (offset % 4 == 0)
    return view


def _sorted_ids(rng, E, N, dump=40):
    """E sorted ids over N segments: a third of the segments empty, a long
    run of empty ones at the end, `dump` rows in the dump segment."""
    live = rng.choice(N - 50, size=2 * N // 3, replace=False)
    return np.sort(np.concatenate([rng.choice(live, size=E - dump), np.full(dump, N)])
                   ).astype(np.int32)


ROWPTR_CASES = {
    "random": lambda rng: (_sorted_ids(rng, 5000, 700), 700),
    "gaps": lambda rng: (np.array([0, 0, 5, 5, 5, 60, 61, 61, 64, 64], np.int32), 64),
    "all-dump": lambda rng: (np.full(300, 1000, np.int32), 1000),
    "empty": lambda rng: (np.zeros(0, np.int32), 17),
    "ids-out-of-range": lambda rng: (np.array([-3, -1, 0, 2, 2, 9, 9], np.int32), 5),
}


@pytest.mark.parametrize("case", list(ROWPTR_CASES))
def test_segment_rowptr_kernel_matches_plain(cuda, case):
    seg, N = ROWPTR_CASES[case](np.random.default_rng(0))
    seg_t = torch.as_tensor(seg, device=cuda)
    before = tgs.segment_rowptr.launches
    out = tgs.segment_rowptr(seg_t, N)
    torch.cuda.synchronize()
    assert tgs.segment_rowptr.launches == before + 1
    assert out.dtype == torch.int32 and out.shape == (N + 1,)
    assert torch.equal(out, tgs.segment_rowptr_plain(seg_t, N))
    np.testing.assert_array_equal(out.cpu().numpy(), np.searchsorted(seg, np.arange(N + 1)))


@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "unaligned"])
@pytest.mark.parametrize("C", WIDTHS)
def test_segment_sum_kernel_matches_plain(cuda, C, offset):
    rng = np.random.default_rng(0)
    E, N = 5000, 700
    seg = torch.as_tensor(_sorted_ids(rng, E, N), device=cuda)
    msgs = _rows(rng, (E, C), cuda, offset)
    before = tgs.sorted_segment_sum.launches
    out = tgs.sorted_segment_sum(msgs, seg, N)
    out2 = tgs.sorted_segment_sum(msgs, seg, N, tgs.segment_rowptr(seg, N))
    torch.cuda.synchronize()
    assert tgs.sorted_segment_sum.launches == before + 2
    assert torch.equal(out, out2)  # no atomics: the same bits every run
    ref = tgs.sorted_segment_sum_plain(msgs.double(), seg, N)
    err = (out.double() - ref).abs().max().item()
    assert err <= 1e-5 * ref.abs().max().item(), err
    empty = torch.bincount(seg.long(), minlength=N + 1)[:N] == 0
    assert empty.sum().item() > 50 and out[empty].abs().max().item() == 0.0


@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "unaligned"])
@pytest.mark.parametrize("C", WIDTHS)
def test_segment_gather_kernel_matches_plain(cuda, C, offset):
    rng = np.random.default_rng(1)
    E, N = 5001, 700  # E is no multiple of the rows a lane group copies
    seg = torch.as_tensor(rng.permutation(_sorted_ids(rng, E, N)), device=cuda)
    g = _rows(rng, (N, C), cuda, offset)
    before = tgs.segment_gather.launches
    out = tgs.segment_gather(g, seg, N)
    out2 = tgs.segment_gather(g, seg, N)
    torch.cuda.synchronize()
    assert tgs.segment_gather.launches == before + 2
    assert torch.equal(out, out2)
    # a copy: bitwise equal to the plain version; dump rows are zero
    assert torch.equal(out, tgs.segment_gather_plain(g, seg, N))
    assert out[seg == N].abs().max().item() == 0.0 and (seg == N).sum().item() == 40


def _graph(rng, N, E, frac_mask=False):
    """Random directed edges; a fifth masked out, nodes >= N - 20 isolated."""
    ei = rng.integers(0, N - 20, size=(2, E)).astype(np.int32)
    em = (rng.uniform(size=E) > 0.2).astype(np.float32)
    if frac_mask:
        em *= rng.uniform(0.25, 1.0, size=E).astype(np.float32)
    return ei, em


@pytest.mark.parametrize("mode", ["mean", "weighted-sum", "backward"])
@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "unaligned"])
@pytest.mark.parametrize("C", WIDTHS)
def test_gather_row_sum_kernel_matches_plain(cuda, C, offset, mode):
    """Kernel A entry (b) on a plan's rows: the forward mean, the weighted
    sum, and the backward's form (the transposed plan, weights divided by the
    gathered row's degree)."""
    rng = np.random.default_rng(4)
    N, E = 300, 2500
    ei, em = _graph(rng, N, E, frac_mask=True)
    plan = tgs.aggregation_plan(torch.as_tensor(ei, device=cuda),
                                torch.as_tensor(em, device=cuda), N)
    x = _rows(rng, (N, C), cuda, offset)
    if mode == "backward":
        t = plan.transposed()
        rowdiv = torch.as_tensor(rng.uniform(0.0, 6.0, size=N).astype(np.float32), device=cuda)
        args = (x, t.dst, t.w, t.rowptr, rowdiv, False)
    else:
        args = (x, plan.src, plan.w, plan.rowptr, None, mode == "mean")
    before = tgs.gather_row_sum.launches
    out, deg = tgs.gather_row_sum(*args)
    out2, deg2 = tgs.gather_row_sum(*args)
    torch.cuda.synchronize()
    assert tgs.gather_row_sum.launches == before + 2
    assert torch.equal(out, out2) and torch.equal(deg, deg2)
    dbl = [a.double() if a is not None and a.is_floating_point() else a for a in args[:5]]
    ref, ref_deg = tgs.gather_row_sum_plain(*dbl, args[5])
    assert (out.double() - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()
    assert (deg.double() - ref_deg).abs().max().item() <= 1e-5 * ref_deg.abs().max().item()
    assert out[N - 20:].abs().max().item() == 0.0  # isolated nodes: empty segments


def test_gather_row_sum_without_weights(cuda):
    rng = np.random.default_rng(5)
    N, E, C = 300, 2500, 128
    ei, em = _graph(rng, N, E)
    plan = tgs.aggregation_plan(torch.as_tensor(ei, device=cuda),
                                torch.as_tensor(em, device=cuda), N)
    t = plan.transposed()
    g = _rows(rng, (E, C), cuda, 0)
    out, _ = tgs.gather_row_sum(g, t.perm, None, t.rowptr)
    ref, _ = tgs.gather_row_sum_plain(g.double(), t.perm, None, t.rowptr)
    assert (out.double() - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()


@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "offset"])
@pytest.mark.parametrize("C", [1, 3, 8, 128, 300])
def test_gather_row_sum_kernel_at_the_host_regimes(cuda, C, offset):
    """Kernel A entry (b) over the row-pointer kernel's pointers at the regimes
    of tests/test_torch_segment_sum_host.py (isolated nodes, dump rows, short
    segments, a segment longer than a warp's rows, one huge segment, no
    rows), under weights, unit weights, rowdiv and normalize: the pointers
    equal to the plain version's, the sums within 1e-5 of the plain f64
    version, twice the same bits."""
    from test_torch_segment_sum_host import MODES, REGIMES, case_inputs, mode_args

    for regime in REGIMES:
        rng = np.random.default_rng(C + 10 * REGIMES.index(regime))
        x, idx, w, seg, N, rowdiv = case_inputs(regime, C, offset, rng)
        idx, w, seg, rowdiv = (t.to(cuda) for t in (idx, w, seg, rowdiv))
        x = _rows(rng, tuple(x.shape), cuda, offset)
        rowptr = tgs.segment_rowptr(seg, N)
        assert torch.equal(rowptr, tgs.segment_rowptr_plain(seg, N)), regime
        for mode in MODES:
            wm, rd, normalize = mode_args(mode, w, rowdiv)
            out, deg = tgs.gather_row_sum(x, idx, wm, rowptr, rd, normalize)
            again = tgs.gather_row_sum(x, idx, wm, rowptr, rd, normalize)
            assert torch.equal(out, again[0]) and torch.equal(deg, again[1]), (regime, mode)
            dbl = [None if a is None else a.double() for a in (x, wm, rd)]
            ref, ref_deg = tgs.gather_row_sum_plain(dbl[0], idx, dbl[1], rowptr, dbl[2],
                                                    normalize)
            scale = max(ref.abs().max().item(), 1.0)
            assert (out.double() - ref).abs().max().item() <= 1e-5 * scale, (regime, mode)
            assert torch.allclose(deg.double(), ref_deg, rtol=1e-6, atol=1e-6), (regime, mode)


AGGREGATES = {"segment": tgs.segment_mean_aggregate, "pallas": tgs.gather_mean_aggregate}


@pytest.mark.parametrize("impl", list(AGGREGATES))
def test_sorted_segment_sum_gradients_on_cuda_match_cpu(cuda, impl):
    """Both aggregations on a CUDA tensor are differentiable (the fused
    kernel over the transposed plan; kernels C and A), the gradients equal
    the CPU plain path's, and two backward passes give the same bits."""
    rng = np.random.default_rng(2)
    N, E, C = 300, 2000, 32
    h = rng.normal(size=(N, C)).astype(np.float32)
    ei, em = _graph(rng, N, E, frac_mask=True)
    w = rng.normal(size=(N, C)).astype(np.float32)
    grads = []
    for dev in (cuda, cuda, torch.device("cpu")):
        ht = torch.tensor(h, device=dev, requires_grad=True)
        out = AGGREGATES[impl](ht, tgs.aggregation_plan(
            torch.as_tensor(ei, device=dev), torch.as_tensor(em, device=dev), N))
        assert out.grad_fn is not None
        (out * torch.as_tensor(w, device=dev)).sum().backward()
        grads.append(ht.grad.cpu())
    assert torch.equal(grads[0], grads[1])
    assert (grads[0] - grads[2]).abs().max().item() <= 1e-5 * grads[2].abs().max().item()
    before = tgs.segment_gather.launches
    msgs = torch.ones((4, 2), device=cuda, requires_grad=True)
    seg = torch.tensor([0, 0, 1, 2], dtype=torch.int32, device=cuda)
    tgs.sorted_segment_sum(msgs, seg, 2).sum().backward()
    assert tgs.segment_gather.launches == before + 1
    assert msgs.grad.cpu().tolist() == [[1, 1], [1, 1], [1, 1], [0, 0]]


@pytest.mark.parametrize("impl", ["segment", "pallas"])
def test_model_gradients_on_cuda_match_cpu(cuda, impl):
    """Every parameter gradient of a small GraphSAGE on the card (dropout
    off) against the CPU's plain path, and the entries each route launches."""
    from tpufem_torch.models.sage import GraphSAGE, SAGEConfig

    rng = np.random.default_rng(6)
    N, E = 400, 2400
    x = rng.normal(size=(N, 10)).astype(np.float32)
    ei, em = _graph(rng, N, E)
    cfg = SAGEConfig(hidden=32, encoder_hidden=16, decoder_hidden=16, num_layers=3,
                     dropout=0.0, aggregate_impl=impl)
    counters = (tgs.gather_row_sum, tgs.sorted_segment_sum, tgs.segment_gather,
                tgs.segment_rowptr)
    before = [c.launches for c in counters]
    grads = {}
    for dev in (cuda, torch.device("cpu")):
        model = GraphSAGE(cfg, generator=torch.Generator().manual_seed(0), device=dev).train()
        out = model(torch.as_tensor(x, device=dev), torch.as_tensor(ei, device=dev),
                    torch.as_tensor(em, device=dev))
        (out * out).mean().backward()
        grads[dev.type] = {n: p.grad.cpu() for n, p in model.named_parameters()}
    fused, seg_sum, gather, rowptr = (c.launches - b for c, b in zip(counters, before))
    # per layer: fused forward + backward | 2 sums, a gather forward and one backward
    want = (6, 0, 0, 2) if impl == "segment" else (3, 6, 6, 2)
    assert (fused, seg_sum, gather, rowptr) == want
    for name, g_cpu in grads["cpu"].items():
        err = (grads["cuda"][name] - g_cpu).abs().max().item()
        assert err <= 1e-4 * g_cpu.abs().max().item(), name


def test_fused_mean_is_one_device_kernel_each_way(cuda):
    """The fused route's forward and backward are one device activity each
    (kernel A entry (b)), call no library kernel and allocate no (E, C)
    tensor."""
    rng = np.random.default_rng(7)
    N, E, C = 2000, 40000, 128
    ei, em = _graph(rng, N, E)
    plan = tgs.aggregation_plan(torch.as_tensor(ei, device=cuda),
                                torch.as_tensor(em, device=cuda), N)
    plan.transposed()
    h = torch.tensor(rng.normal(size=(N, C)).astype(np.float32), device=cuda, requires_grad=True)
    g = torch.as_tensor(rng.normal(size=(N, C)).astype(np.float32), device=cuda)
    tgs.segment_mean_aggregate(h, plan).backward(g)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    # device_time takes an empty profiler window again
    r = device_time(lambda: tgs.segment_mean_aggregate(h, plan).backward(g), "row_sum_kernel")
    # beside the two launches autograd may accumulate h.grad (one add)
    assert r["launches"] == 2 and r["activities"] <= 3, r
    assert torch.cuda.max_memory_allocated() - base < E * C * 4


def test_segment_sum_kernel_rejects_bad_input(cuda):
    msgs = torch.zeros((4, 2), dtype=torch.float64, device=cuda)
    seg = torch.zeros(4, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        tgs.sorted_segment_sum(msgs, seg, 3)
    with pytest.raises(TypeError):
        tgs.sorted_segment_sum(msgs.float(), seg.long(), 3)
    with pytest.raises(ValueError):  # not contiguous
        tgs.sorted_segment_sum(torch.zeros((2, 4), device=cuda).T, seg, 3)
    with pytest.raises(ValueError):  # ids on another device
        tgs.sorted_segment_sum(msgs.float(), seg.cpu(), 3)
    with pytest.raises(ValueError):  # row pointers of another segment count
        tgs.sorted_segment_sum(msgs.float(), seg, 3, tgs.segment_rowptr(seg, 5))
    with pytest.raises(ValueError):
        tgs.segment_gather(torch.zeros((3, 2), device=cuda), seg, 4)
    with pytest.raises(TypeError):
        tgs.segment_rowptr(seg.long(), 3)


def test_fused_mean_rejects_bad_input(cuda):
    N, C = 6, 4
    ei = torch.tensor([[1, 2, 3, 4], [0, 0, 5, 5]], dtype=torch.int32, device=cuda)
    em = torch.ones(4, device=cuda)
    h = torch.zeros((N, C), device=cuda)
    plan = tgs.aggregation_plan(ei, em, N)
    with pytest.raises(ValueError):  # a gradient tpufem would give is never dropped silently
        tgs.segment_mean_aggregate(h, tgs.aggregation_plan(ei, em.clone().requires_grad_(), N))
    with pytest.raises(TypeError):
        tgs.segment_mean_aggregate(h.double(), plan)
    with pytest.raises(ValueError):
        tgs.segment_mean_aggregate(torch.zeros((C, N), device=cuda).T, plan)
    with pytest.raises(ValueError):  # a plan of another graph size
        tgs.segment_mean_aggregate(h, tgs.aggregation_plan(ei, em, N + 1))
    with pytest.raises(TypeError):  # edges are never converted silently
        tgs.aggregation_plan(ei.long(), em, N)
    with pytest.raises(ValueError):
        tgs.gather_row_sum(h, plan.src, plan.w[:2], plan.rowptr)
    with pytest.raises(TypeError):
        tgs.gather_row_sum(h, plan.src.long(), plan.w, plan.rowptr)


STRAIN_GRIDS = {
    "12x10x3-le-weld": WingMeshResolution(12, 10, 3, te_floor_frac=0.006, spacing="le"),
    "medium-sharp-te": MEDIUM,
    # 13 node rows and 38 node columns leave ragged tiles along chord and
    # span, and odd span rows take the kernel's scalar copies
    "13x37x5-ragged": WingMeshResolution(13, 37, 5, te_floor_frac=0.0, spacing="le"),
}


def _strain_inputs(res, B, dev):
    X = tst.nodes_grid(res, torch.as_tensor(seeded_batch(8)[:B], device=dev), torch.float64)
    geo = tst.cell_geometry(res, X)
    gen = torch.Generator(device=dev).manual_seed(0)
    u = torch.randn(X.shape, generator=gen, dtype=torch.float64, device=dev)
    free = torch.ones((1, 1, 1, 1, res.n_span + 1), dtype=torch.float64, device=dev)
    free[..., 0] = 0.0
    return geo, u, free


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("B", [1, 8])
@pytest.mark.parametrize("grid", list(STRAIN_GRIDS))
def test_strain_apply_kernel_matches_plain(cuda, grid, B, dtype):
    res = STRAIN_GRIDS[grid]
    geo, u, free = _strain_inputs(res, B, cuda)
    ref = tst.strain_apply_plain(res, geo, u, free, LAM, MU)
    geo_d, u_d, free_d = tuple(t.to(dtype) for t in geo), u.to(dtype), free.to(dtype)
    before = tst.strain_apply.launches
    y = tst.strain_apply(res, geo_d, u_d, free_d, LAM, MU)
    assert tst.strain_apply.launches == before + 1
    assert torch.equal(y, tst.strain_apply(res, geo_d, u_d, free_d, LAM, MU))  # no atomics
    err = (y.double() - ref).abs().max().item()
    if dtype == torch.float64:
        assert err <= 1e-12 * ref.abs().max().item()
    else:
        # the kernel's error against the f64 result is no worse than 2x the
        # plain f32 version's
        p32 = tst.strain_apply_plain(res, geo_d, u_d, free_d, LAM, MU)
        assert err <= 2.0 * (p32.double() - ref).abs().max().item()


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_strain_apply_is_one_device_kernel(cuda, dtype):
    """One apply on the card, weld spread/reduce, mask and Dirichlet identity
    included, is exactly one device activity: kernel B."""
    res = STRAIN_GRIDS["medium-sharp-te"]
    geo, u, free = _strain_inputs(res, 8, cuda)
    geo, u, free = tuple(t.to(dtype) for t in geo), u.to(dtype), free.to(dtype)
    r = device_time(lambda: tst.strain_apply(res, geo, u, free, LAM, MU), "strain_apply")
    assert r["launches"] == 1 and r["activities"] == 1, r


@pytest.mark.parametrize("bad", ["shape", "dtype", "device"])
def test_strain_apply_kernel_rejects_bad_free(cuda, bad):
    res = STRAIN_GRIDS["12x10x3-le-weld"]
    geo, u, free = _strain_inputs(res, 1, cuda)
    wrong = {"shape": free.reshape(1, 1, 1, res.n_span + 1, 1),
             "dtype": free.float(), "device": free.cpu()}[bad]
    with pytest.raises((ValueError, TypeError)):
        tst.strain_apply(res, geo, u, wrong, LAM, MU)


@pytest.mark.parametrize("B", [1, 8])
def test_solve_on_cuda_matches_cpu(cuda, B):
    """The whole solve on the card at B=1 and B=8 agrees with the CPU's.
    Kernel B raises on an operand that is not contiguous, so this also holds
    that every vector the V-cycle and the CG hand the operator is contiguous."""
    res = WingMeshResolution(12, 10, 3, te_floor_frac=0.006, spacing="le")
    p4 = seeded_batch(8)[:B]
    out_c = WingStencilT(res, device=cuda).solve(p4, tol=1e-8, maxiter=2000, outer_f64=True)
    out_h = WingStencilT(res, device="cpu").solve(p4, tol=1e-8, maxiter=2000, outer_f64=True)
    assert bool(out_c.converged.all()) and bool(out_h.converged.all())
    u_c, u_h = out_c.u.cpu(), out_h.u
    assert (u_c - u_h).abs().max().item() <= 1e-7 * u_h.abs().max().item()


def _tet_mesh():
    return structured_wing_mesh(1.6, 0.30, 25.0, 0.07, WingMeshResolution(24, 16, 3, 0.006, "le"))


def _tet_inputs(dev, dtype):
    m = _tet_mesh()
    nodes = torch.as_tensor(m.nodes, dtype=torch.float64, device=dev)
    tets = torch.as_tensor(m.tets, device=dev)
    grads, vols = tet4_setup(nodes, tets)
    u = torch.as_tensor(np.random.default_rng(3).normal(size=(m.num_nodes, 3)), device=dev)
    return m, grads.to(dtype), vols.to(dtype), tets, u.to(dtype)


MESH_CASES = ["structured", "permuted", "untouched-node", "small-blocks"]


def _operator_case(name, dev, monkeypatch):
    """kernel D's f64 inputs (grads, vols, tets, x, free, plan) on the 24x16x3
    wing: as meshed; renumbered by a seeded permutation; with one more node,
    which no tet touches, in the middle of the numbering; as meshed, cut into
    blocks of at most 64 rows (the nodes of valence above that get a block
    each)."""
    m = _tet_mesh()
    nodes, tets, root = m.nodes, m.tets, build_boundary_sets(m).nroot_nodes
    if name == "permuted":
        nodes, tets, root = permuted(nodes, tets, root, seed=1)
    if name == "untouched-node":
        k = len(nodes) // 2
        nodes = np.insert(nodes, k, [9.0, 9.0, 9.0], axis=0)
        tets, root = tets + (tets >= k), root + (root >= k)
    if name == "small-blocks":
        monkeypatch.setattr(tas, "SLOTS", 64)
    return operator_inputs(nodes, tets, root, torch.float64, dev)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("masked", [True, False], ids=["masked", "unmasked"])
@pytest.mark.parametrize("case", MESH_CASES)
def test_tet4_force_kernel_matches_plain(cuda, case, masked, dtype, monkeypatch):
    """Kernel D, the whole operator apply in one launch, against the plain
    composition; the same bits twice."""
    g64, v64, tets, x64, f64, plan = _operator_case(case, cuda, monkeypatch)
    ref = tas.stiffness_apply_plain(g64, v64, tets, x64, LAM, MU, plan, f64 if masked else None)
    g, v, x = g64.to(dtype), v64.to(dtype), x64.to(dtype)
    free = f64.to(dtype) if masked else None
    before = tas.stiffness_apply.launches
    y = tas.stiffness_apply(g, v, tets, x, LAM, MU, plan, free)
    torch.cuda.synchronize()
    assert tas.stiffness_apply.launches == before + 1
    assert torch.equal(y, tas.stiffness_apply(g, v, tets, x, LAM, MU, plan, free))  # no atomics
    err = (y.double() - ref).abs().max().item()
    if dtype == torch.float64:
        assert err <= 1e-12 * ref.abs().max().item()
    else:
        # no worse than 2x the plain f32 version's error against f64
        p32 = tas.stiffness_apply_plain(g, v, tets, x, LAM, MU, plan, free)
        assert err <= 2.0 * (p32.double() - ref).abs().max().item()
    if masked:  # the identity on the constrained rows, bit for bit
        fixed = free == 0
        assert fixed.any() and torch.equal(y[fixed], x[fixed])
    if case == "untouched-node":
        untouched = (plan.starts[1:] == plan.starts[:-1]).nonzero().reshape(-1)
        assert untouched.numel() == 1 and (y[untouched] == 0).all()
    if case == "small-blocks":
        assert plan.slots == 64 and plan.bnode.numel() > 400
    if masked and dtype == torch.float64:  # the flat operator and elastic_force are the kernel
        A = tas.stiffness_operator(g, v, tets, LAM, MU, plan, free.reshape(-1))
        assert torch.equal(A(x.reshape(-1)), y.reshape(-1))
    if not masked:
        assert torch.equal(tas.elastic_force(g, v, tets, x, LAM, MU, plan), y)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("masked", [True, False], ids=["masked", "unmasked"])
def test_stiffness_apply_is_one_device_kernel(cuda, masked, dtype, monkeypatch):
    """One gather operator apply on the card, mask and Dirichlet identity
    included, is exactly one device activity: kernel D."""
    g, v, tets, x, free, plan = (t.to(dtype) if torch.is_tensor(t) and t.is_floating_point() else t
                                 for t in _operator_case("structured", cuda, monkeypatch))
    free = free if masked else None
    r = device_time(lambda: tas.stiffness_apply(g, v, tets, x, LAM, MU, plan, free),
                    "stiffness_apply")
    assert r["launches"] == 1 and r["activities"] == 1, r


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("masked", [True, False], ids=["masked", "unmasked"])
def test_stiffness_apply_t_matches_plain(cuda, masked, dtype):
    """Kernel O, the trailing-batch operator, against its plain version at
    COARSE B=3 and 16x16x4 B=8 (f64 1e-12, f32 1e-5 of the plain f32
    version; check_apply_t raises otherwise), bitwise repeatable, one launch
    and one device activity per apply."""
    from tpufem_torch.profile_batched import check_apply_t, operator_inputs_t

    for res, B in ((COARSE, 3), (WingMeshResolution(16, 16, 4, 0.006, "le"), 8)):
        g64, v64, tets, x64, f64, plan64 = operator_inputs_t(res, seeded_batch(8)[:B],
                                                              torch.float64, cuda)
        ref = tas.stiffness_apply_t_plain(g64, v64, tets, x64, LAM, MU, plan64,
                                          f64 if masked else None)
        g, v, x = g64.to(dtype), v64.to(dtype), x64.to(dtype)
        free = f64.to(dtype) if masked else None
        plan = operator_inputs_t(res, seeded_batch(8)[:B], dtype, cuda)[-1]
        check_apply_t(g, v, tets, x, free, plan, LAM, MU, ref)
        r = device_time(lambda: tas.stiffness_apply_t(g, v, tets, x, LAM, MU, plan, free),
                        "stiffness_apply_t")
        assert r["launches"] == 1 and r["activities"] == 1, r


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("lanes", [1, 5, 8])
def test_stiffness_apply_t_at_every_level(cuda, lanes, dtype):
    """Kernel O on the plan force_plan_t cuts at every level of DOF100K's
    hierarchy that applies it and at MEDIUM (the two-level engine), masked
    and unmasked, against its plain version (check_apply_t: f64 1e-12, f32
    1e-5 of the plain f32 version, two applies bitwise equal), and equal to
    itself bit for bit over a plan of one-column tiles (another cut, the
    same order)."""
    from tpufem_torch.fem.multigrid import node_columns
    from tpufem_torch.fem.stencil_mg import hierarchy_resolutions
    from tpufem_torch.mesher import wing_topology
    from tpufem_torch.profile_batched import check_apply_t, operator_inputs_t

    for res in (*hierarchy_resolutions(DOF100K)[:-1], MEDIUM):
        g64, v64, tets, x64, f64, _ = operator_inputs_t(res, seeded_batch(8)[:lanes],
                                                         torch.float64, cuda)
        g, v, x, fr = g64.to(dtype), v64.to(dtype), x64.to(dtype), f64.to(dtype)
        plan = operator_inputs_t(res, seeded_batch(8)[:lanes], dtype, cuda)[-1]
        topo = wing_topology(res)
        column = tas.force_plan_t(topo.tets, topo.num_nodes, lanes, dtype, cuda,
                                  columns=node_columns(topo, res), tile=(1, 1))
        for masked in (True, False):
            ref = tas.stiffness_apply_t_plain(g64, v64, tets, x64, LAM, MU, plan,
                                              f64 if masked else None)
            free = fr if masked else None
            check_apply_t(g, v, tets, x, free, plan, LAM, MU, ref)
            assert torch.equal(tas.stiffness_apply_t(g, v, tets, x, LAM, MU, plan, free),
                               tas.stiffness_apply_t(g, v, tets, x, LAM, MU, column, free))


def test_stiffness_apply_at_the_valence_cap(cuda):
    """A node with as many incident tets as one block's shared memory holds
    (a fan of SLOT_LIMIT tets round node 0) against the plain composition, in
    both dtypes; one tet more and the plan is refused."""
    n = tas.SLOT_LIMIT
    fan = np.array([[0, 3 * i + 1, 3 * i + 2, 3 * i + 3] for i in range(n + 1)], np.int32)
    nodes = np.random.default_rng(3).normal(size=(3 * n + 4, 3))
    with pytest.raises(ValueError, match="incident tets"):
        tas.build_incidence(fan, len(nodes), cuda)
    g64, v64, tets, x64, f64, plan = operator_inputs(nodes[:-3], fan[:-1], np.array([1, 2]),
                                                     torch.float64, cuda)
    assert plan.slots == n and int(plan.starts[1]) == n
    ref = tas.stiffness_apply_plain(g64, v64, tets, x64, LAM, MU, plan, f64)
    y = tas.stiffness_apply(g64, v64, tets, x64, LAM, MU, plan, f64)
    assert (y - ref).abs().max().item() <= 1e-12 * ref.abs().max().item()
    g, v, x, free = g64.float(), v64.float(), x64.float(), f64.float()
    y32 = tas.stiffness_apply(g, v, tets, x, LAM, MU, plan, free)
    p32 = tas.stiffness_apply_plain(g, v, tets, x, LAM, MU, plan, free)
    assert (y32.double() - ref).abs().max().item() <= 2.0 * (p32.double() - ref).abs().max().item()


def test_stiffness_apply_rejects_bad_input(cuda, monkeypatch):
    g, v, tets, x, free, plan = _operator_case("structured", cuda, monkeypatch)
    ok = (g, v, tets, x, LAM, MU, plan, free)
    tas.stiffness_apply(*ok)

    def call(**kw):
        names = ("grads", "vols", "tets", "x", "lam", "mu", "plan", "free")
        return tas.stiffness_apply(*[kw.get(n, a) for n, a in zip(names, ok)])

    with pytest.raises(TypeError):
        call(x=x.float())
    with pytest.raises(TypeError):
        call(free=free.float())
    with pytest.raises(TypeError):
        call(x=x.half(), grads=g.half(), vols=v.half(), free=free.half())
    with pytest.raises(TypeError):
        call(tets=tets.long())
    with pytest.raises(ValueError):
        call(x=x.reshape(-1))
    with pytest.raises(ValueError):
        call(free=free[:-1])
    with pytest.raises(ValueError):
        call(grads=g[:-1])
    with pytest.raises(ValueError):  # a plan of another mesh
        call(plan=tas.build_incidence(tets[:-1].cpu(), x.shape[0], cuda))
    with pytest.raises(ValueError):  # the plan on another device
        call(plan=tas.build_incidence(tets.cpu(), x.shape[0], "cpu"))
    with pytest.raises(ValueError):
        call(vols=v.cpu())
    with pytest.raises(ValueError):  # not contiguous: never copied silently
        call(x=torch.stack([x, x], dim=1)[:, 0])
    with pytest.raises(ValueError):
        call(free=free.T.contiguous().T)
    shifted = torch.empty(g.numel() + 1, dtype=g.dtype, device=cuda)[1:].view(g.shape).copy_(g)
    with pytest.raises(ValueError, match="aligned"):
        call(grads=shifted)


@pytest.mark.parametrize("kernel", ["B", "D", "F", "G"])
def test_hand_kernels_refuse_requires_grad(cuda, kernel, monkeypatch):
    """Kernels B (to u), D, F and G have no backward: a CUDA tensor that
    requires_grad raises instead of coming back detached; under no_grad it
    runs. (Kernel E has one since the adjoint: test_csr_segment_sum_gradient_on_cuda.)"""
    if kernel in ("F", "G"):
        res = STRAIN_GRIDS["12x10x3-le-weld"]
        geo, u0, sig, x, free = geometric_inputs(res, 2, cuda)
        (u0 if kernel == "F" else x).requires_grad_()
        run = ((lambda: tbk.element_stress(res, geo, u0, LAM, MU)) if kernel == "F"  # noqa: E731
               else (lambda: tbk.geom_apply(res, geo, sig, x, free)))
    elif kernel == "B":
        res = STRAIN_GRIDS["12x10x3-le-weld"]
        geo, u, free = _strain_inputs(res, 1, cuda)
        u.requires_grad_()
        run = lambda: tst.strain_apply(res, geo, u, free, LAM, MU)  # noqa: E731
    elif kernel == "D":
        g, v, tets, x, free, plan = _operator_case("structured", cuda, monkeypatch)
        x.requires_grad_()
        run = lambda: tas.stiffness_apply(g, v, tets, x, LAM, MU, plan, free)  # noqa: E731
    else:
        m, *_ = _tet_inputs(cuda, torch.float64)
        plan = tcs.csr_plan(m.tets, m.num_nodes, cuda)
        vals = torch.ones((m.tets.size, 3), dtype=torch.float64, device=cuda, requires_grad=True)
        run = lambda: tcs.csr_segment_sum(vals, plan)  # noqa: E731
    with pytest.raises(ValueError, match="no backward"):
        run()
    with torch.no_grad():
        assert not run().requires_grad


def _csr_regime(regime, cuda, rng):
    """(segment ids, num_segments) of a plan of one of kernel E's regimes."""
    if regime == "incidence":  # many short segments: a mesh's per-node sums
        m, *_ = _tet_inputs(cuda, torch.float64)
        return m.tets, m.num_nodes
    if regime == "mostly empty":  # the loads
        hot = rng.choice(50_000, 3000, replace=False)
        return rng.permutation(np.repeat(hot, rng.integers(1, 4, 3000))), 50_000
    if regime == "few long":  # the RBM group sum
        return rng.permutation(np.repeat(np.arange(300), rng.integers(90, 113, 300))), 300
    # two segments longer than a block stages at once (48 KB of rows) at every C here
    ids = np.concatenate([np.full(13_000, 3), np.full(7_000, 11), rng.integers(0, 40, 500)])
    return rng.permutation(ids), 40


@pytest.mark.parametrize("regime", ["incidence", "mostly empty", "few long",
                                    "one longer than a chunk"])
@pytest.mark.parametrize("C", [1, 3, 6, 24])
def test_csr_segment_sum_kernel_matches_plain(cuda, C, regime):
    """Kernel E gives the CPU plain version's bits, f64 and f32, the same
    bits every run (no atomics), one launch per call."""
    rng = np.random.default_rng(C)
    ids, N = _csr_regime(regime, cuda, rng)
    plan = tcs.csr_plan(ids, N, cuda)
    plan_cpu = tcs.csr_plan(ids, N, "cpu")
    vals = torch.as_tensor(rng.normal(size=(np.asarray(ids).size, C)), device=cuda)
    for v in (vals, vals.float()):
        before = tcs.csr_segment_sum.launches
        out = tcs.csr_segment_sum(v, plan)
        assert tcs.csr_segment_sum.launches == before + 1
        assert torch.equal(out.cpu(), tcs.csr_segment_sum_plain(v.cpu(), plan_cpu))
        assert torch.equal(out, tcs.csr_segment_sum(v, plan))


def test_stencil_solves_are_bitwise_repeatable(cuda):
    """Kernel E in the loads and the stress recovery: two solves of one batch
    take the same iterations and give the same bits."""
    res = WingMeshResolution(12, 10, 3, te_floor_frac=0.006, spacing="le")
    solver = WingStencilT(res, device=cuda)
    a = solver.solve(P4, tol=1e-8, maxiter=2000, outer_f64=True)
    b = solver.solve(P4, tol=1e-8, maxiter=2000, outer_f64=True)
    assert a.iters == b.iters
    for f in ("u", "stress6", "vm"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def test_gather_solve_on_cuda_matches_cpu(cuda):
    m = structured_wing_mesh(1.2, 0.35, 0.0, 0.10, COARSE)
    bs = build_boundary_sets(m)
    # the float64 rung certifies the TRUE residual, whose f64 floor here is ~1.3e-10: at
    # tol 1e-9 both devices converge; at 1e-10 they may not, and agree all the same
    for tol in (1e-9, 1e-10):
        cfg = WingSolveConfig(pressure=100.0, dtype=torch.float64, tol=tol, maxiter=50000)
        d0, e0 = tas.stiffness_apply.launches, tcs.csr_segment_sum.launches
        sc = solve_wing_case(m, bs, cfg, device=cuda)
        assert tas.stiffness_apply.launches > d0 and tcs.csr_segment_sum.launches > e0
        again = solve_wing_case(m, bs, cfg, device=cuda)  # kernel D's fixed order: the same bits
        assert again.iters == sc.iters and np.array_equal(again.u, sc.u)
        assert np.array_equal(again.vm, sc.vm)
        sh = solve_wing_case(m, bs, cfg, device="cpu")
        for sol in (sc, sh):
            assert sol.converged == (sol.rel_residual <= tol)
            assert sol.converged or tol == 1e-10
        assert np.linalg.norm(sc.u - sh.u) <= 1e-7 * np.linalg.norm(sh.u)
        assert np.abs(sc.vm - sh.vm).max() <= 1e-7 * np.abs(sh.vm).max()


GEOMETRIC_GRIDS = {"dof100k": DOF100K, "medium-sharp-te": MEDIUM,
                   "12x10x3-le-weld": STRAIN_GRIDS["12x10x3-le-weld"],
                   "13x37x5-ragged": STRAIN_GRIDS["13x37x5-ragged"]}


@pytest.mark.parametrize("sigma", ["symmetric", "non-symmetric"])
@pytest.mark.parametrize("q", [1, 12, 16])
@pytest.mark.parametrize("grid", list(GEOMETRIC_GRIDS))
def test_geometric_kernels_match_plain(cuda, grid, q, sigma):
    """Kernels F (element_stress) and G (geom_apply) against their plain
    versions at q lanes, f64 within 1e-12 and f32 within 1e-5 of the largest
    plain f64 entry, one launch per call, the same bits twice (measure
    raises otherwise). The grids take kernel G's 8- and 4-row tiles, ragged
    tiles, its scalar copies and both weld settings; a non-symmetric sigma
    holds G to tpufem's g_a^T sigma g_b."""
    out = measure_geometric(GEOMETRIC_GRIDS[grid], q, cuda, timed=False,
                            symmetric=sigma == "symmetric")
    assert sorted(out) == ["element_stress f32", "element_stress f64", "geom_apply f32",
                           "geom_apply f64"]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("kernel", ["element_stress", "geom_apply"])
def test_geometric_kernels_are_one_device_kernel(cuda, kernel, dtype):
    """One call on the card, welds and mask included, is exactly one device
    activity."""
    res = MEDIUM
    geo, u0, sig, x, free = geometric_inputs(res, 12, cuda)
    geo = tuple(t.to(dtype) for t in geo)
    u0, sig, x, free = (t.to(dtype) for t in (u0, sig, x, free))
    fn = ((lambda: tbk.element_stress(res, geo, u0, LAM, MU)) if kernel == "element_stress"
          else (lambda: tbk.geom_apply(res, geo, sig, x, free)))
    r = device_time(fn, kernel)
    assert r["launches"] == 1 and r["activities"] == 1, r


def test_geom_apply_rejects_bad_input(cuda):
    res = STRAIN_GRIDS["12x10x3-le-weld"]
    geo, u0, sig, x, free = geometric_inputs(res, 2, cuda)

    def call(**kw):
        a = {"geo": geo, "sig": sig, "u": x, "free": free, **kw}
        return tbk.geom_apply(res, a["geo"], a["sig"], a["u"], a["free"])

    with pytest.raises(TypeError):
        call(sig=sig.float())
    with pytest.raises(ValueError):
        call(sig=sig[:, :, :, :1].contiguous())
    with pytest.raises(ValueError):
        call(free=free.cpu())
    with pytest.raises(ValueError):
        call(sig=sig.transpose(1, 2))  # symmetric, but not contiguous: never copied
    with pytest.raises(ValueError):
        tbk.element_stress(res, (geo[0][:, :, :, :1].contiguous(), geo[1]), u0, LAM, MU)


def test_modal_on_cuda_matches_cpu(cuda):
    """A small WingModal on the card (kernel B in the block CG) agrees with
    the CPU's."""
    res = WingMeshResolution(8, 10, 2, 0.006, "le")
    p4 = (1.2, 0.35, 10.0, 0.10)
    a = WingModal(res, p4, device=cuda).solve(n_modes=4)
    b = WingModal(res, p4, device="cpu").solve(n_modes=4)
    assert a.converged and b.converged
    np.testing.assert_allclose(a.freqs_hz, b.freqs_hz, rtol=1e-8)


def test_buckling_on_cuda_matches_cpu(cuda):
    """A small WingBuckling and WingPrestressedModal on the card (kernels B,
    E, F and G) agree with the CPU's."""
    res = WingMeshResolution(8, 10, 2, 0.006, "le")
    p4 = (1.2, 0.35, 10.0, 0.10)
    f0, g0 = tbk.element_stress.launches, tbk.geom_apply.launches
    a = tbk.WingBuckling(res, p4, device=cuda).solve(n_modes=2, tol=1e-7)
    b = tbk.WingBuckling(res, p4, device="cpu").solve(n_modes=2, tol=1e-7)
    assert a.converged and b.converged
    np.testing.assert_allclose(a.factors, b.factors, rtol=1e-6)
    assert tbk.element_stress.launches == f0 + 1 and tbk.geom_apply.launches > g0
    c = tbk.WingPrestressedModal(res, p4, device=cuda).solve(n_modes=4, load_factor=4000.0)
    d = tbk.WingPrestressedModal(res, p4, device="cpu").solve(n_modes=4, load_factor=4000.0)
    np.testing.assert_allclose(c.freqs_hz, d.freqs_hz, rtol=1e-8)


# with 13x37x5-ragged and 12x10x3-le-weld, the edges of H's and I's tiles:
# node counts that fill no tile evenly, welded TEs, nt = 2 (EDGE_TILES)
DESIGN_GRIDS = {**STRAIN_GRIDS, "13x37x2-sharp-te": EDGE_RES,
                "64x24x2-sharp-te": WingMeshResolution(64, 24, 2, 0.0, "le"),
                "64x80x6-sharp-te": EDGE_ROWS_RES, "dof100k": DOF100K}
# the tile each edge grid must take on the card: (owned node columns, chord
# rows), 0 for more than one chord row that does not divide the grid's; the
# span tile is left partly empty at all three, the last chord tile (its last
# row the welded trailing edge) at 64x24x2 and 64x80x6
EDGE_TILES = {"13x37x2-sharp-te": (8, 1), "64x24x2-sharp-te": (8, 0),
              "64x80x6-sharp-te": (16, 0)}


@pytest.mark.parametrize("u", ["random", "zero"])
@pytest.mark.parametrize("grid", list(DESIGN_GRIDS))
def test_nonlinear_kernels_match_plain(cuda, grid, u):
    """Kernels H (stvk_internal_force), I (stvk_tangent_apply) and J
    (stvk_energy) against their plain versions in f64 within 1e-12 of the
    largest plain entry (or of error_scales where that is larger), one
    launch per call, the same bits twice (measure raises otherwise), and H
    and I one device activity per call, at max |grad u| = 1e-2; and at u = 0
    (where I is kernel B's operator). The edge grids take the tiles they are
    named for on this card (EDGE_TILES)."""
    res = DESIGN_GRIDS[grid]
    if grid in EDGE_TILES:
        NI, NJ = res.n_chord + 1, res.n_span + 1
        own_j, own_i = launch_tile(res)
        want_j, want_i = EDGE_TILES[grid]
        assert own_j == want_j and NJ % own_j != 0, (own_j, own_i)
        assert own_i == want_i if want_i else own_i > 1 and NI % own_i != 0, (own_j, own_i)
    zero = None if u == "random" else torch.zeros((3, 1, res.n_chord + 1, res.n_thick + 1,
                                                   res.n_span + 1), dtype=torch.float64)
    if zero is None:
        out = measure_nonlinear(grid, res, P4[0], cuda, timed=False)
        calls = nl_calls(res, *nl_inputs(res, P4[0], cuda))
        for name in ("stvk_internal_force", "stvk_tangent_apply"):
            r = device_time(calls[name][0], KERNEL_NAMES[name])
            assert r["launches"] == 1 and r["activities"] == 1, (name, r)
    else:
        geo, _, x, free = nl_inputs(res, P4[0], cuda)
        y = tnl.stvk_tangent_apply(res, geo, zero.to(cuda), x, free, LAM, MU)
        ref = tst.strain_apply(res, geo, x, free, LAM, MU)
        assert (y - ref).abs().max().item() <= 1e-12 * ref.abs().max().item()
        out = {"tangent at u = 0": None}
    assert out


@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("grid", list(DESIGN_GRIDS))
def test_geometry_vjp_kernel_matches_plain(cuda, grid, B):
    """Kernel K (strain_apply_geo_vjp) against its plain version in f64
    within 1e-12, one launch per call, the same bits twice; DOF100K at B=4
    is the adjoint's largest launch."""
    rec = measure_vjp(grid, DESIGN_GRIDS[grid], seeded_batch(8)[:B], cuda, timed=False)
    assert rec["rel_err"] <= 1e-12


def _energy_calls(res, p4, dev, seed=0):
    """(kernel J, its plain version, operands) on vjp_inputs' geometry and u."""
    geo, u, _, free = vjp_inputs(res, p4, dev, seed)
    return (lambda: tnl.stvk_energy(res, geo, u, free, LAM, MU),
            lambda: tnl.stvk_energy_plain(res, geo, u, free, LAM, MU), (*geo, u, free))


@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("grid", list(DESIGN_GRIDS))
def test_energy_kernel_matches_plain(cuda, grid, B):
    """Kernel J (stvk_energy) on B lanes against its plain version in f64
    within 1e-12 relative, one launch per call, the same bits twice."""
    res = DESIGN_GRIDS[grid]
    fn, plain, ops = _energy_calls(res, seeded_batch(8)[:B], cuda)
    rec = check_and_time("stvk_energy", grid, fn, plain, ops, ops[1].numel(), timed=False)
    assert rec["rel_err"] <= 1e-12


def test_energy_kernel_at_two_shapes_in_turn(cuda):
    """Kernel J called at shapes of other block sizes and partial counts in
    turn gives each shape its own bits (a ticket or partials sized for the
    wrong shape would not), and leaves the device's ticket at 0."""
    shapes = [(STRAIN_GRIDS["12x10x3-le-weld"], 1), (DOF100K, 1), (MEDIUM, 4)]
    calls = [_energy_calls(res, seeded_batch(8)[:B], cuda, seed=k)
             for k, (res, B) in enumerate(shapes)]
    first = [fn().clone() for fn, _, _ in calls]
    for (fn, plain, _), want in zip(calls[::-1] + calls, first[::-1] + first):
        got = fn()
        assert torch.equal(got, want)
        ref = plain()
        assert abs(got.item() - ref.item()) <= 1e-12 * abs(ref.item())
    assert tnl._TICKETS[torch.device("cuda", torch.cuda.current_device())].item() == 0


@pytest.mark.parametrize("kernel", list(KERNEL_NAMES))
def test_design_kernels_are_one_device_kernel(cuda, kernel):
    """One call on the card is exactly one device activity (kernel J's
    fixed-order sum included)."""
    res = MEDIUM
    geo, u, x, free = nl_inputs(res, P4[0], cuda)
    if kernel == "strain_apply_geo_vjp":
        fn = lambda: tst.strain_apply_geo_vjp(res, geo, u, x, free, LAM, MU)  # noqa: E731
    else:
        fn = nl_calls(res, geo, u, x, free)[kernel][0]
    r = device_time(fn, KERNEL_NAMES[kernel])
    assert r["launches"] == 1 and r["activities"] == 1, r


def test_design_kernels_reject_bad_input(cuda):
    """H, I, J and K take f64 only: a CUDA f32 operand raises, as do a wrong
    shape and an operand that wants a gradient."""
    res = STRAIN_GRIDS["12x10x3-le-weld"]
    geo, u, x, free = nl_inputs(res, P4[0], cuda)
    geo32, u32, x32, free32 = tuple(t.float() for t in geo), u.float(), x.float(), free.float()
    for call in (lambda: tnl.stvk_internal_force(res, geo32, u32, free32, LAM, MU),
                 lambda: tnl.stvk_tangent_apply(res, geo32, u32, x32, free32, LAM, MU),
                 lambda: tnl.stvk_energy(res, geo32, u32, free32, LAM, MU),
                 lambda: tst.strain_apply_geo_vjp(res, geo32, u32, x32, free32, LAM, MU)):
        with pytest.raises(TypeError, match="f64"):
            call()
    with pytest.raises(TypeError):
        tnl.stvk_tangent_apply(res, geo, u, x32, free, LAM, MU)
    with pytest.raises(ValueError):
        tnl.stvk_internal_force(res, (geo[0][..., :1].contiguous(), geo[1]), u, free, LAM, MU)
    with pytest.raises(ValueError, match="no backward"):
        tnl.stvk_energy(res, geo, u.clone().requires_grad_(), free, LAM, MU)
    g32 = (geo[0].float().requires_grad_(), geo[1].float())
    with pytest.raises(TypeError, match="f64"):  # kernel K, B's geometry gradient, is f64 only
        tst.strain_apply(res, g32, u32, free32, LAM, MU)
    with pytest.raises(ValueError, match="no backward"):  # B has no backward to u
        tst.strain_apply(res, (geo[0].clone().requires_grad_(), geo[1]),
                         u.clone().requires_grad_(), free, LAM, MU)


def test_csr_segment_sum_gradient_on_cuda(cuda):
    """Kernel E with a gradient (CsrSegmentSum): the forward is the kernel's
    bits, the backward the row gather, equal to autograd of the plain
    version on the CPU."""
    m, *_ = _tet_inputs(cuda, torch.float64)
    plan = tcs.csr_plan(m.tets, m.num_nodes, cuda)
    plan_cpu = tcs.csr_plan(m.tets, m.num_nodes, "cpu")
    rng = np.random.default_rng(3)
    vals = torch.as_tensor(rng.normal(size=(m.tets.size, 3)), device=cuda).requires_grad_()
    cot = torch.as_tensor(rng.normal(size=(m.num_nodes, 3)), device=cuda)
    before = tcs.csr_segment_sum.launches
    out = tcs.csr_segment_sum(vals, plan)
    assert tcs.csr_segment_sum.launches == before + 1 and out.requires_grad
    with torch.no_grad():
        assert torch.equal(out, tcs.csr_segment_sum(vals, plan))
    (g,) = torch.autograd.grad(out, vals, cot)
    vc = vals.detach().cpu().requires_grad_()
    (gc,) = torch.autograd.grad(tcs.csr_segment_sum_plain(vc, plan_cpu), vc, cot.cpu())
    assert torch.equal(g.cpu(), gc)


def test_adjoint_gradient_on_cuda_matches_cpu(cuda):
    """DifferentiableWingFEM on the card (kernel B forward, K backward, E's
    gradient in the loads and the recovery) gives the CPU's gradients of the
    compliance and of the smooth-max von Mises."""
    res = WingMeshResolution(8, 12, 2, 0.006, "le")
    grads = []
    for dev in (cuda, "cpu"):
        fem = DifferentiableWingFEM(res, P4, tol=1e-11, maxiter=4000, device=dev)
        p = torch.tensor(P4, device=dev, requires_grad=True)
        u = fem.solve(p)
        obj = fem.compliance(p, u).sum() + 1e-7 * fem.smooth_max_vm(p, u).sum()
        grads.append(torch.autograd.grad(obj, p)[0].cpu().numpy())
    np.testing.assert_allclose(grads[0], grads[1], rtol=1e-7)
    assert tst.strain_apply_geo_vjp.launches > 0


def test_nonlinear_on_cuda_matches_cpu(cuda):
    """A small WingNonlinear on the card (kernels H, I, J in the Newton loop)
    agrees with the CPU's."""
    res = WingMeshResolution(8, 10, 2, 0.006, "le")
    p4 = (1.6, 0.3, 0.0, 0.08)
    counts = [tnl.stvk_internal_force.launches, tnl.stvk_tangent_apply.launches,
              tnl.stvk_energy.launches]
    a = tnl.WingNonlinear(res, p4, pressure=3e5, device=cuda).solve(n_steps=2)
    b = tnl.WingNonlinear(res, p4, pressure=3e5, device="cpu").solve(n_steps=2)
    assert a.converged and b.converged
    assert np.linalg.norm(a.u - b.u) <= 1e-7 * np.linalg.norm(b.u)
    assert all(n > c for n, c in zip([tnl.stvk_internal_force.launches,
                                      tnl.stvk_tangent_apply.launches,
                                      tnl.stvk_energy.launches], counts))


# ------------------------------------------------- kernels L and M (tet10)

# the last two: L's last chord tile is the sharp trailing edge's lone cell row
# (its weld rows, its low face shared) at 9x9x4; at 4x3x2 one tile of L holds
# the grid and M's last row tile holds the trailing edge's weld row alone
TET10_GRIDS = {"8x6x2-floored": WingMeshResolution(8, 6, 2, 0.006, "le"),
               "6x4x2-sharp-te": WingMeshResolution(6, 4, 2, 0.0, "le"),
               "10x18x8-tiles": WingMeshResolution(10, 18, 8, 0.006, "le"),
               "9x9x4-sharp-te-tile-edges": WingMeshResolution(9, 9, 4, 0.0, "le"),
               "4x3x2-sharp-te-one-tile": WingMeshResolution(4, 3, 2, 0.0, "le")}


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("B", [1, 12])
@pytest.mark.parametrize("grid", list(TET10_GRIDS))
def test_strain_apply10_kernel_matches_plain(cuda, grid, B, dtype):
    """Kernel L against strain_apply10_plain (f64 1e-12, f32 1e-5 of the
    largest entry), one launch, the same bits twice, one device activity."""
    from tpufem_torch.fem import tet10_stencil as tts
    from tpufem_torch.profile_tet10 import l_inputs

    res = TET10_GRIDS[grid]
    geo, u, free2 = l_inputs(res, np.tile(P4[:1], (B, 1)), dtype, cuda, seed=B)
    ref = tts.strain_apply10_plain(res, geo, u, free2, LAM, MU)
    before = tts.strain_apply10.launches
    y = tts.strain_apply10(res, geo, u, free2, LAM, MU)
    assert tts.strain_apply10.launches == before + 1
    assert torch.equal(y, tts.strain_apply10(res, geo, u, free2, LAM, MU))  # no atomics
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    assert (y - ref).abs().max().item() <= tol * ref.abs().max().item()
    r = device_time(lambda: tts.strain_apply10(res, geo, u, free2, LAM, MU), "strain_apply10")
    assert r["launches"] == 1 and r["activities"] == 1, r


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("B", [1, 12])
@pytest.mark.parametrize("grid", list(TET10_GRIDS))
def test_p_transfer_kernels_match_plain(cuda, grid, B, dtype):
    """Kernel M's prolongation and restriction against their plain versions
    (f64 1e-14, f32 1e-6 of the largest entry: the weld rows' column sums run
    in another order), one launch each, the same bits twice."""
    from tpufem_torch.fem import tet10_stencil as tts

    res = TET10_GRIDS[grid]
    NI, NK, NJ = res.n_chord + 1, res.n_thick + 1, res.n_span + 1
    gen = torch.Generator(device=cuda).manual_seed(B)
    x4 = torch.randn((3, B, NI, NK, NJ), generator=gen, device=cuda, dtype=dtype)
    r2 = torch.randn((3, B, *tts._doubled(res)), generator=gen, device=cuda, dtype=dtype)
    dup2, free2 = tts.dup_mask2(res, dtype, cuda), tts.free_mask2(res, dtype, cuda)
    free4 = torch.ones((1, 1, 1, 1, NJ), dtype=dtype, device=cuda)
    free4[..., 0] = 0.0
    for fn, plain, counter in (
            (lambda: tts.prolong_p(res, x4, dup2, free2),
             lambda: tts.prolong_p_plain(res, x4, dup2, free2), tts.prolong_p),
            (lambda: tts.restrict_p(res, r2, free4),
             lambda: tts.restrict_p_plain(res, r2, free4), tts.restrict_p)):
        before = counter.launches
        y = fn()
        assert counter.launches == before + 1
        assert torch.equal(y, fn())
        ref = plain()
        tol = 1e-14 if dtype == torch.float64 else 1e-6
        assert (y - ref).abs().max().item() <= tol * ref.abs().max().item()


def test_tet10_kernels_reject_bad_input(cuda):
    from tpufem_torch.fem import tet10_stencil as tts
    from tpufem_torch.profile_tet10 import l_inputs

    res = TET10_GRIDS["8x6x2-floored"]
    geo, u, free2 = l_inputs(res, P4[:1], torch.float64, cuda)
    for bad in (u.float(), u.transpose(3, 4), u[:, :, :-1]):
        with pytest.raises((ValueError, TypeError)):
            tts.strain_apply10(res, geo, bad, free2, LAM, MU)
    with pytest.raises(ValueError):
        tts.strain_apply10(res, geo, u, free2.cpu(), LAM, MU)
    with pytest.raises(ValueError):
        tts.prolong_p(res, u, tts.dup_mask2(res, torch.float64, cuda), free2)


def test_tet10_solve_on_cuda_matches_cpu(cuda):
    """Tet10StencilT's f64-outer solve on the card (kernels L, M and B)
    agrees with the CPU's at B = 2."""
    from tpufem_torch.fem.tet10_stencil import Tet10StencilT

    res = TET10_GRIDS["8x6x2-floored"]
    bs = build_boundary_sets(structured_wing_mesh(*P4[0], res))
    p4 = np.array([P4[0], [1.5, 0.3, 5.0, 0.12]])
    outs = [Tet10StencilT(res, device=d).solve(p4, bs.surf_upper_faces, tol=1e-7,
                                               maxiter=2000, outer_f64=True)
            for d in (cuda, "cpu")]
    assert all(o.converged.all() for o in outs)
    assert np.abs(outs[0].u - outs[1].u).max() <= 1e-7 * np.abs(outs[1].u).max()


# ------------------------------------------------- kernel N (the tet10 gather operator)


@pytest.mark.parametrize("masked", [True, False], ids=["masked", "unmasked"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("tile", [None, 7], ids=["TILE_TETS", "7-tet-tiles"])
@pytest.mark.parametrize("grid", ["8x6x2-floored", "6x4x2-sharp-te"])
def test_tet10_force_kernel_matches_plain(cuda, grid, tile, dtype, masked):
    """Kernel N against tet10_force_plain (f64 1e-12 of the largest entry;
    f32 against the f64 result no worse than 2x the plain f32 version), one
    count, the same bits twice, two launches and device activities (its
    tiles and its halo nodes; one where a single block holds every tet),
    the Dirichlet rows the identity; at the plan's own tiles and at odd
    7-tet tiles (most nodes halo nodes), with the same bits."""
    from tpufem_torch.fem import tet10 as tt10
    from tpufem_torch.profile_tet10 import n_inputs

    J64, v64, conn, x64, f64, own, t10 = n_inputs(TET10_GRIDS[grid], P4[0], cuda)
    plan = own if tile is None else tt10.force_plan(t10, cuda, tile_tets=tile)
    ref64 = tt10.tet10_force_plain(J64, v64, conn, x64, LAM, MU, plan, f64 if masked else None)
    J, v, x = J64.to(dtype), v64.to(dtype), x64.to(dtype)
    free = f64.to(dtype) if masked else None
    call = lambda p=plan: tt10.tet10_force(J, v, conn, x, LAM, MU, x.shape[0],  # noqa: E731
                                           plan=p, free=free)
    before = tt10.tet10_force.launches
    y = call()
    assert tt10.tet10_force.launches == before + 1
    assert torch.equal(y, call())  # no atomics
    assert torch.equal(y, call(own))  # each node's sum in the same order at any tiles
    scale = ref64.abs().max().item()
    if dtype == torch.float64:
        assert (y - ref64).abs().max().item() <= 1e-12 * scale
    else:
        plain = tt10.tet10_force_plain(J, v, conn, x, LAM, MU, plan, free)
        assert ((y.double() - ref64).abs().max().item()
                <= 2 * (plain.double() - ref64).abs().max().item())
    if masked:
        root = f64[:, 0] == 0
        assert torch.equal(y[root], x[root])
    r = device_time(call, "tet10_force")
    n = 1 + (plan.hnode.numel() > 0)  # no halo launch where one block holds every tet
    assert r["launches"] == n and r["activities"] == n, r


def test_tet10_force_rejects_bad_input(cuda):
    from tpufem_torch.fem import tet10 as tt10
    from tpufem_torch.profile_tet10 import n_inputs

    J, v, conn, x, free, plan, t10 = n_inputs(TET10_GRIDS["8x6x2-floored"], P4[0], cuda)
    N = x.shape[0]
    for bad in (dict(x=x.float()), dict(x=x.t().contiguous().t()), dict(conn=conn.long()),
                dict(free=free.cpu()), dict(plan=tt10.connectivity_plan(t10.tet10, N, cuda)),
                dict(plan=None), dict(x=x.clone().requires_grad_())):
        kw = {"J": J, "v": v, "conn": conn, "x": x, "free": free, "plan": plan, **bad}
        with pytest.raises((ValueError, TypeError)):
            tt10.tet10_force(kw["J"], kw["v"], kw["conn"], kw["x"], LAM, MU, N, plan=kw["plan"],
                             free=kw["free"])


def test_tet10_gather_solves_on_cuda_match_cpu(cuda):
    """Tet10MGSolver's refinement solve and solve_tet10_case on the card
    (kernels N, E and B) agree with the CPU's."""
    from tpufem_torch.fem.tet10 import (
        solve_tet10_case,
        tet10_from_tet4,
        tet10_root_nodes,
        tet10_upper_t6,
    )
    from tpufem_torch.fem.tet10_mg import Tet10MGSolver

    res = TET10_GRIDS["8x6x2-floored"]
    mesh = structured_wing_mesh(*P4[0], res)
    bs = build_boundary_sets(mesh)
    t10 = tet10_from_tet4(mesh)
    outs = [Tet10MGSolver(res, t10, device=d).solve(P4[0], bs.surf_upper_faces, tol=1e-7,
                                                    maxiter=4000, refine_steps=8)
            for d in (cuda, "cpu")]
    assert all(o.converged for o in outs)
    assert np.abs(outs[0].u - outs[1].u).max() <= 1e-6 * np.abs(outs[1].u).max()
    cases = [solve_tet10_case(t10, tet10_root_nodes(t10), tet10_upper_t6(t10, bs.surf_upper_faces),
                              5e3, tol=1e-9, maxiter=8000, dtype=torch.float64,
                              nj2=2 * res.n_span + 1, device=d) for d in (cuda, "cpu")]
    assert cases[0][4] and cases[1][4]
    assert np.abs(cases[0][0] - cases[1][0]).max() <= 1e-7 * np.abs(cases[1][0]).max()


# ------------------------------------------------- the multi-device layer's shapes


def _slab(res, c, rank, p4, dtype, dev, tet10=False):
    """(slab res, geo, u, free) of rank's slab of c span cells (its geometry
    from its span fractions: parallel.shard_stencil's slabs), u seeded."""
    from tpufem_torch.fem import tet10_stencil as tts
    from tpufem_torch.parallel.shard_stencil import slab_res, slab_yfrac

    rs = slab_res(res, c)
    p4t = torch.as_tensor(np.asarray([p4]), dtype=torch.float64, device=dev)
    yf = slab_yfrac(rank, c, res.n_span)
    if tet10:
        X = tts.nodes_grid2(res, p4t, torch.float64, yfrac=yf)
        geo = tts.cell_geometry2(rs, X)
    else:
        X = tst.nodes_grid(res, p4t, torch.float64, yfrac=yf)
        geo = tst.cell_geometry(rs, X)
    gen = torch.Generator(device=dev).manual_seed(rank)
    u = torch.randn(X.shape, generator=gen, device=dev, dtype=torch.float64) * 1e-3
    free = torch.ones((1, 1, 1, 1, X.shape[-1]), dtype=torch.float64, device=dev)
    if rank == 0:
        free[..., 0] = 0.0
    return rs, tuple(t.to(dtype) for t in geo), u.to(dtype), free.to(dtype)


@pytest.mark.parametrize("rank", [0, 1])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_kernels_B_L_M_at_slab_shapes(cuda, rank, dtype):
    """Kernel B on a DOF100K slab and L, M on a 32x40x4 doubled slab of 2
    ranks (rank 0 holds the root, rank 1 not) against their plain versions."""
    from tpufem_torch.fem import tet10_stencil as tts

    tol = 1e-12 if dtype == torch.float64 else 1e-5
    rs, geo, u, free = _slab(DOF100K, 40, rank, (1.2, 0.35, 10.0, 0.10), dtype, cuda)
    y, ref = tst.strain_apply(rs, geo, u, free, LAM, MU), tst.strain_apply_plain(
        rs, geo, u, free, LAM, MU)
    assert (y - ref).abs().max() <= tol * ref.abs().max()
    res10 = WingMeshResolution(32, 40, 4, 0.006, "le")
    rs, geo, u2, free2 = _slab(res10, 20, rank, (1.6, 0.4, 20.0, 0.10), dtype, cuda, tet10=True)
    y, ref = (tts.strain_apply10(rs, geo, u2, free2, LAM, MU),
              tts.strain_apply10_plain(rs, geo, u2, free2, LAM, MU))
    assert (y - ref).abs().max() <= tol * ref.abs().max()
    dup2 = tts.dup_mask2(res10, dtype, cuda)[..., :41].contiguous()
    x4 = u2[:, :, ::2, ::2, ::2].contiguous()
    free4 = free2[..., ::2].contiguous()
    mtol = 1e-14 if dtype == torch.float64 else 1e-6  # profile_tet10.M_TOL
    for got, want in ((tts.prolong_p(rs, x4, dup2, free2),
                       tts.prolong_p_plain(rs, x4, dup2, free2)),
                      (tts.restrict_p(rs, u2, free4), tts.restrict_p_plain(rs, u2, free4))):
        assert (got - want).abs().max() <= mtol * want.abs().max()


@pytest.mark.parametrize("element", ["tet4", "tet10"])
def test_kernels_D_N_on_a_halo_extended_mesh(cuda, element):
    """Kernel D (tet4) and N (tet10) on rank 0's extended local mesh of the
    halo PCG's partition (owned nodes, then the next rank's ghosts), without
    a mask, against their plain versions in f64."""
    from tpufem_torch.fem import tet10 as tt10
    from tpufem_torch.parallel.halo_pcg import build_halo_partition, extended_nodes

    part = build_halo_partition(WingMeshResolution(12, 18, 2), 4, 1.2, 0.35, 10.0, 0.10,
                                dtype=np.float64, element=element)
    n_el = int(part.elem_mask[0].sum())
    elems_h = part.elems[0, :n_el]
    nodes = torch.as_tensor(extended_nodes(part, 0), device=cuda)
    elems = torch.as_tensor(elems_h, device=cuda).contiguous()
    gen = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(nodes.shape, generator=gen, device=cuda, dtype=torch.float64)
    if element == "tet4":
        grads, vols = tet4_setup(nodes, elems.long())
        plan = tas.build_incidence(elems_h, nodes.shape[0], cuda)
        y = tas.stiffness_apply(grads, vols, elems, x, LAM, MU, plan)
        ref = tas.stiffness_apply_plain(grads, vols, elems, x, LAM, MU, plan)
    else:
        Jinv, vols = tt10.tet10_setup(nodes, elems)
        mesh = tt10.Tet10Mesh(mesh4=None, tet10=elems_h.astype(np.int64),
                              edge_endpoints=np.zeros((0, 2)), surf_t6=np.zeros((0, 6)),
                              num_nodes=nodes.shape[0])
        plan = tt10.force_plan(mesh, cuda)
        y = tt10.tet10_force(Jinv, vols, elems, x, LAM, MU, nodes.shape[0], plan=plan)
        ref = tt10.tet10_force_plain(Jinv, vols, elems, x, LAM, MU, plan)
    assert (y - ref).abs().max() <= 1e-12 * ref.abs().max()
