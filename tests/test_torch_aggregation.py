"""Port parity: the aggregation plan, the row pointers and the fused neighbour
mean of tpufem_torch.ops.gather_scatter (their plain versions, as on the CPU)
against numpy references and against tpufem's two aggregations:
``segment_mean_aggregate`` (XLA) and ``gather_mean_aggregate`` (the Pallas
kernel in interpret mode, as tests/test_pallas_ops.py runs it). Inputs come
from numpy seeds; tolerances are those of tests/test_pallas_ops.py (rtol 2e-4,
atol 2e-5) unless stated.

The CUDA kernels are held against these plain versions in the gpu-marked
tests of tests/test_torch_kernels.py and in chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpufem.models.sage import segment_mean_aggregate as j_segment_mean
from tpufem.ops.gather_scatter import gather_mean_aggregate as j_gather_mean
from tpufem_torch.models.sage import SAGEConfig, SAGEConv
from tpufem_torch.ops import gather_scatter as tgs


def _graph(seed, N, E, mask):
    """Random directed edges among the first N - 5 nodes (the last 5 are
    isolated); `mask` is "binary" (a fifth of the edges masked out),
    "fraction" (kept edges weigh 0.25-1) or "none" (all kept)."""
    rng = np.random.default_rng(seed)
    ei = rng.integers(0, N - 5, size=(2, E)).astype(np.int32)
    em = np.ones(E, np.float32)
    if mask != "none":
        em = (rng.uniform(size=E) > 0.2).astype(np.float32)
    if mask == "fraction":
        em *= rng.uniform(0.25, 1.0, size=E).astype(np.float32)
    return rng, ei, em


def _plan(ei, em, N):
    return tgs.aggregation_plan(torch.as_tensor(ei), torch.as_tensor(em), N)


# ------------------------------------------------------------ row pointers

ROWPTR_CASES = {
    "random-with-empty-segments": (np.sort(np.random.default_rng(0).choice(
        np.arange(0, 90, 3), size=400)).astype(np.int32), 100),
    "large-gaps": (np.array([0, 0, 5, 5, 5, 60, 61, 61, 64, 64], np.int32), 64),
    "all-rows-dumped": (np.full(30, 17, np.int32), 17),
    "no-rows": (np.zeros(0, np.int32), 9),
    "ids-out-of-range": (np.array([-3, -1, 0, 2, 2, 9, 9], np.int32), 5),
}


@pytest.mark.parametrize("case", list(ROWPTR_CASES))
def test_segment_rowptr_matches_searchsorted(case):
    seg, N = ROWPTR_CASES[case]
    before = tgs.segment_rowptr.launches
    out = tgs.segment_rowptr(torch.as_tensor(seg), N)
    assert tgs.segment_rowptr.launches == before  # the CPU takes the plain version
    assert out.dtype == torch.int32 and out.shape == (N + 1,)
    np.testing.assert_array_equal(out.numpy(), np.searchsorted(seg, np.arange(N + 1)))
    # segment s owns [rowptr[s], rowptr[s+1]); dump rows lie past rowptr[N]
    np.testing.assert_array_equal(np.diff(out.numpy()), [(seg == s).sum() for s in range(N)])
    assert len(seg) - out[-1].item() == int((seg >= N).sum())


# ---------------------------------------------------------------- the plan


@pytest.mark.parametrize("mask", ["binary", "fraction"])
def test_aggregation_plan_matches_numpy(mask):
    N, E = 40, 300
    _, ei, em = _graph(3, N, E, mask)
    plan = tgs.aggregation_plan(torch.as_tensor(ei), torch.as_tensor(em), N)
    dst_eff = np.where(em > 0, ei[1], N)
    order = np.argsort(dst_eff, kind="stable")
    np.testing.assert_array_equal(plan.src.numpy(), ei[0][order])
    np.testing.assert_array_equal(plan.w.numpy(), em[order])
    np.testing.assert_array_equal(plan.seg.numpy(), dst_eff[order])
    np.testing.assert_array_equal(plan.rowptr.numpy(),
                                  np.searchsorted(dst_eff[order], np.arange(N + 1)))
    assert plan.src.dtype == plan.seg.dtype == plan.rowptr.dtype == torch.int32
    # the transposed plan: the kept edges in stable order by source
    assert plan._transposed is None  # built only when a gradient asks
    t = plan.transposed()
    assert plan.transposed() is t
    key = np.where(dst_eff[order] < N, ei[0][order], N)
    perm = np.argsort(key, kind="stable")
    np.testing.assert_array_equal(t.perm.numpy(), perm)
    np.testing.assert_array_equal(t.dst.numpy(), dst_eff[order][perm])
    np.testing.assert_array_equal(t.w.numpy(), em[order][perm])
    np.testing.assert_array_equal(t.rowptr.numpy(), np.searchsorted(key[perm], np.arange(N + 1)))
    kept = int((em > 0).sum())
    assert t.rowptr[-1].item() == plan.rowptr[-1].item() == kept


def test_plan_names_no_row_outside_the_graph():
    """Edges whose destination is out of range are dropped like masked ones
    and sources are clamped, so the kernels, which read unchecked, stay
    inside the graph; where tpufem defines the result (ids >= N) it agrees."""
    N, C = 6, 3
    ei = np.array([[1, 2, 9, 4, 3, 0], [0, 0, 5, 7, -2, 5]], np.int32)
    em = np.ones(6, np.float32)
    plan = tgs.aggregation_plan(torch.as_tensor(ei), torch.as_tensor(em), N)
    assert plan.rowptr[-1].item() == 4  # the edges into 7 and -2 are dumped
    assert 0 <= plan.src.min().item() and plan.src.max().item() == N - 1
    t = plan.transposed()
    assert t.dst[:t.rowptr[-1]].max().item() < N and t.dst.min().item() >= 0
    h = np.random.default_rng(0).normal(size=(N, C)).astype(np.float32)
    out = tgs.segment_mean_aggregate(torch.as_tensor(h), plan).numpy()
    np.testing.assert_allclose(out[0], (h[1] + h[2]) / 2, rtol=1e-6)
    np.testing.assert_allclose(out[5], (h[5] + h[0]) / 2, rtol=1e-6)  # source 9 reads row 5
    ok = ei[1] >= 0  # a negative id has no defined place in tpufem's gather
    ref = np.asarray(j_segment_mean(jnp.asarray(h), jnp.asarray(ei[:, ok]), jnp.asarray(em[ok]), N))
    np.testing.assert_allclose(out, ref, rtol=2e-4, atol=2e-5)


# -------------------------------------------------- entry (b), plain version


def _row_sum_reference(x, idx, w, rowptr, rowdiv, normalize):
    """gather_row_sum by its definition, one segment and one row at a time."""
    N = len(rowptr) - 1
    sums, deg = np.zeros((N, x.shape[1])), np.zeros(N)
    for s in range(N):
        for r in range(rowptr[s], rowptr[s + 1]):
            wr = 1.0 if w is None else float(w[r])
            if rowdiv is not None:
                wr /= max(float(rowdiv[idx[r]]), 1.0)
            sums[s] += wr * x[idx[r]]
            deg[s] += wr
        if normalize:
            sums[s] /= max(deg[s], 1.0)
    return sums, deg


@pytest.mark.parametrize("mode", ["mean", "weighted-sum", "unweighted", "backward-form"])
def test_gather_row_sum_plain_matches_definition(mode):
    N, E, C = 30, 200, 5
    rng, ei, em = _graph(4, N, E, "fraction")
    plan = tgs.aggregation_plan(torch.as_tensor(ei), torch.as_tensor(em), N)
    x = rng.normal(size=(N, C))
    rowdiv = rng.uniform(0.0, 6.0, size=N) if mode == "backward-form" else None
    idx, w, rowptr = plan.src, plan.w.double(), plan.rowptr
    if mode == "backward-form":
        t = plan.transposed()
        idx, w, rowptr = t.dst, t.w.double(), t.rowptr
    if mode == "unweighted":
        w = None
    before = tgs.gather_row_sum.launches
    out, deg = tgs.gather_row_sum(torch.as_tensor(x), idx, w, rowptr,
                                  None if rowdiv is None else torch.as_tensor(rowdiv),
                                  normalize=mode == "mean")
    assert tgs.gather_row_sum.launches == before
    ref, ref_deg = _row_sum_reference(x, idx.numpy(), None if w is None else w.numpy(),
                                      rowptr.numpy(), rowdiv, mode == "mean")
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(deg.numpy(), ref_deg, rtol=1e-12, atol=1e-12)


# ----------------------------------------- the fused mean against tpufem's


@pytest.mark.parametrize("C", [1, 8, 128])
@pytest.mark.parametrize("mask", ["binary", "fraction", "none"])
def test_fused_mean_matches_tpufem(mask, C):
    """Masked edges, isolated nodes (the last 5) and fractional masks, against
    both of tpufem's aggregations."""
    N, E = 50, 400
    rng, ei, em = _graph(1, N, E, mask)
    h = rng.normal(size=(N, C)).astype(np.float32)
    args = (jnp.asarray(h), jnp.asarray(ei), jnp.asarray(em), N)
    ref = np.asarray(j_segment_mean(*args))
    pallas = np.asarray(j_gather_mean(*args))
    plan = _plan(ei, em, N)
    out = tgs.segment_mean_aggregate(torch.as_tensor(h), plan).numpy()
    np.testing.assert_allclose(out, ref, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(out, pallas, rtol=2e-4, atol=2e-5)
    assert np.abs(out[N - 5:]).max() == 0.0  # isolated nodes aggregate to zero
    # the message route, on the same plan
    msg = tgs.gather_mean_aggregate(torch.as_tensor(h), plan).numpy()
    np.testing.assert_allclose(msg, out, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("mask", ["binary", "fraction"])
def test_fused_mean_gradient_matches_jax_grad(mask):
    """d/dh through FusedGatherMean (entry (b) over the transposed plan, its
    plain version here) against jax.grad of tpufem's segment_mean_aggregate,
    rtol 1e-4."""
    N, E, C = 50, 400, 8
    rng, ei, em = _graph(2, N, E, mask)
    h = rng.normal(size=(N, C)).astype(np.float32)
    cot = rng.normal(size=(N, C)).astype(np.float32)

    def jloss(hh):
        return jnp.sum(j_segment_mean(hh, jnp.asarray(ei), jnp.asarray(em), N) * jnp.asarray(cot))

    ref = np.asarray(jax.grad(jloss)(jnp.asarray(h)))
    ht = torch.tensor(h, requires_grad=True)
    out = tgs.segment_mean_aggregate(ht, _plan(ei, em, N))
    assert out.grad_fn is not None and "FusedGatherMean" in type(out.grad_fn).__name__
    (out * torch.as_tensor(cot)).sum().backward()
    np.testing.assert_allclose(ht.grad.numpy(), ref, rtol=1e-4, atol=1e-4 * np.abs(ref).max())
    # and against autograd through the message route on the same inputs
    hm = torch.tensor(h, requires_grad=True)
    msg = tgs.gather_mean_aggregate(hm, _plan(ei, em, N))
    (msg * torch.as_tensor(cot)).sum().backward()
    np.testing.assert_allclose(ht.grad.numpy(), hm.grad.numpy(), rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())


def test_fused_mean_gradcheck_f64():
    N, E, C = 12, 60, 3
    rng, ei, em = _graph(5, N, E, "fraction")
    plan = tgs.aggregation_plan(torch.as_tensor(ei), torch.as_tensor(em).double(), N)
    h = torch.tensor(rng.normal(size=(N, C)), requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda x: tgs.segment_mean_aggregate(x, plan), (h,))
    assert torch.autograd.gradcheck(
        lambda x: tgs.gather_mean_aggregate(x, plan), (h,))


def test_message_route_gives_the_mask_gradient_tpufem_gives():
    """gather_mean_aggregate differentiates in edge_mask as tpufem's Pallas
    route does; the fused mean refuses such a mask instead of dropping it."""
    N, E, C = 30, 150, 4
    rng, ei, em = _graph(6, N, E, "fraction")
    h = rng.normal(size=(N, C)).astype(np.float32)
    cot = rng.normal(size=(N, C)).astype(np.float32)

    def jloss(mm):
        return jnp.sum(j_gather_mean(jnp.asarray(h), jnp.asarray(ei), mm, N) * jnp.asarray(cot))

    ref = np.asarray(jax.grad(jloss)(jnp.asarray(em)))
    mt = torch.tensor(em, requires_grad=True)
    plan = tgs.aggregation_plan(torch.as_tensor(ei), mt, N)
    out = tgs.gather_mean_aggregate(torch.as_tensor(h), plan)
    (out * torch.as_tensor(cot)).sum().backward()
    np.testing.assert_allclose(mt.grad.numpy(), ref, rtol=1e-4, atol=1e-5 * np.abs(ref).max())
    with pytest.raises(ValueError, match="edge_mask"):
        tgs.segment_mean_aggregate(torch.as_tensor(h), plan)


def test_aggregations_reject_a_plan_of_another_graph():
    N = 10
    ei = torch.tensor([[1, 2, 3, 4], [0, 0, 5, 5]], dtype=torch.int32)
    plan = tgs.aggregation_plan(ei, torch.ones(4), N + 1)
    for aggregate in (tgs.segment_mean_aggregate, tgs.gather_mean_aggregate):
        with pytest.raises(ValueError, match="plan of 11 nodes"):
            aggregate(torch.zeros((N, 3)), plan)


def test_aggregation_plan_rejects_bad_edges():
    """Like the kernels' wrappers, the plan converts nothing silently."""
    ei = torch.tensor([[1, 2, 3, 4], [0, 0, 5, 5]])
    with pytest.raises(TypeError, match="int32"):
        tgs.aggregation_plan(ei, torch.ones(4), 10)
    with pytest.raises(ValueError, match="mask"):
        tgs.aggregation_plan(ei.to(torch.int32), torch.ones(5), 10)
    with pytest.raises(ValueError, match="edges"):
        tgs.aggregation_plan(ei.to(torch.int32).T.contiguous(), torch.ones(2), 10)


def test_unknown_aggregate_impl_raises():
    with pytest.raises(ValueError, match="aggregate_impl"):
        SAGEConv(8, 8, "scatter")
    from tpufem_torch.models.sage import GraphSAGE

    with pytest.raises(ValueError, match="aggregate_impl"):
        GraphSAGE(SAGEConfig(aggregate_impl="xla"), device="cpu")
