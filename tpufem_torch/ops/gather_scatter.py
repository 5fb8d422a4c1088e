"""Differentiable sorted segment sums (CUDA kernels A and C) and GraphSAGE's
mean aggregation, planned once per graph.

Port of ``tpufem/ops/gather_scatter.py``. The TPU kernel there
(``_seg_sum_kernel`` via ``sorted_segment_sum_pallas``) and its VJP
(``_seg_sum_bwd``, a row gather of the cotangent inside the ``custom_vjp``)
are replaced by hand-written CUDA kernels in ``csrc/segment_sum.cu`` (see
that file for their design):

  - ``segment_rowptr``: sorted ids -> row pointers, once per graph;
  - kernel A entry (a), ``sorted_segment_sum``: the sum of the rows of msgs
    between two row pointers, the direct counterpart of
    ``sorted_segment_sum_pallas``; kernel C, ``segment_gather``, is its
    backward (``SortedSegmentSum``);
  - kernel A entry (b), ``gather_row_sum``: the same sum with row r read as
    ``x[idx[r]] * w[r]`` straight from the node features, the degree in the
    same launch. ``FusedGatherMean`` runs it forward, and again over the edges
    sorted by source backward, so no (E, C) tensor exists in either
    direction and no sum uses atomics.

Two aggregations share one ``AggregationPlan``: ``segment_mean_aggregate``
(the fused mean, counterpart of tpufem's XLA-fused function of that name) and
``gather_mean_aggregate`` (messages materialised, then two segment sums, as
tpufem's Pallas route does). On a CPU tensor every wrapper runs its plain
PyTorch version; on a CUDA tensor it launches its kernel or raises.

Dropped TPU workarounds: the ``MAX_SEGMENTS`` VMEM cap on the output rows and
``gather_mean_aggregate``'s fallback to XLA segment_sum above it existed only
because the Pallas kernel kept its whole output resident in VMEM. The CUDA
kernels have no such limit, so every graph size takes the same path.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from tpufem_torch.ops.kernels import check, load_kernels, wants_grad

_MAX_ELEMENTS = 2**31  # the kernels index with 32 bits


def _check_rows(name: str, x: torch.Tensor, rows: int | None = None) -> None:
    """x is an f32 (rows, C) contiguous matrix small enough for the kernels."""
    if x.dtype != torch.float32:
        raise TypeError(f"{name} takes f32 values, got {x.dtype}")
    if x.dim() != 2 or x.shape[1] < 1 or (rows is not None and x.shape[0] != rows):
        raise ValueError(f"{name}: bad value shape {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: values must be contiguous")
    if x.numel() >= _MAX_ELEMENTS:
        raise ValueError(f"{name}: {x.numel()} elements do not fit 32-bit indices")


def _check_vector(name: str, what: str, v: torch.Tensor, dtype, like: torch.Tensor,
                  length: int | None = None) -> None:
    """v is a contiguous 1-D tensor of `dtype` on like's device."""
    if v.dtype != dtype:
        raise TypeError(f"{name} takes {dtype} {what}, got {v.dtype}")
    if v.dim() != 1 or (length is not None and v.shape[0] != length):
        raise ValueError(f"{name}: bad {what} shape {tuple(v.shape)}")
    if v.device != like.device or not v.is_contiguous():
        raise ValueError(f"{name}: {what} must be contiguous on {like.device}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


# ------------------------------------------------------------ row pointers


def segment_rowptr_plain(seg: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Plain PyTorch version: rowptr[s] = the first row whose id is >= s, for
    s in [0, num_segments], as int32."""
    ids = torch.arange(num_segments + 1, dtype=seg.dtype, device=seg.device)
    return torch.searchsorted(seg, ids).to(torch.int32)


def segment_rowptr(seg: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Row pointers (num_segments + 1,) int32 of SORTED int32 ids seg (E,):
    segment s owns the rows [rowptr[s], rowptr[s+1]); dump rows (id ==
    num_segments) lie past rowptr[num_segments]. A CPU tensor takes the plain
    version; a CUDA tensor launches the row-pointer kernel."""
    if not seg.is_cuda:
        return segment_rowptr_plain(seg, num_segments)
    _check_vector("segment_rowptr", "ids", seg, torch.int32, seg)
    rowptr = torch.empty(num_segments + 1, dtype=torch.int32, device=seg.device)
    status = load_kernels().tpufem_segment_rowptr_i32(
        seg.data_ptr(), rowptr.data_ptr(), seg.shape[0], num_segments, _stream(seg))
    check(status, "segment_rowptr")
    segment_rowptr.launches += 1
    return rowptr


segment_rowptr.launches = 0


# ------------------------------------------- entry (a) and its backward, C


def sorted_segment_sum_plain(msgs: torch.Tensor, seg: torch.Tensor, num_segments: int):
    """Plain PyTorch version: sum rows of msgs (E,C) by segment id into
    (num_segments, C); rows with id num_segments (padding) are dropped."""
    out = torch.zeros((num_segments + 1, msgs.shape[1]), dtype=msgs.dtype, device=msgs.device)
    out.index_add_(0, seg.long(), msgs)
    return out[:num_segments]


def _sorted_segment_sum_fwd(msgs, seg, num_segments: int, rowptr):
    """Forward of the segment sum: kernel A entry (a) on a CUDA tensor (after
    the row-pointer kernel, unless the caller has the pointers), the plain
    version on a CPU tensor."""
    if not msgs.is_cuda:
        return sorted_segment_sum_plain(msgs, seg, num_segments)
    _check_vector("kernel A", "ids", seg, torch.int32, msgs)
    _check_rows("kernel A", msgs, seg.shape[0])
    if rowptr is None:
        rowptr = segment_rowptr(seg, num_segments)
    _check_vector("kernel A", "row pointers", rowptr, torch.int32, msgs, num_segments + 1)
    E, C = msgs.shape
    out = torch.empty((num_segments, C), dtype=msgs.dtype, device=msgs.device)
    status = load_kernels().tpufem_sorted_segment_sum_f32(
        msgs.data_ptr(), rowptr.data_ptr(), out.data_ptr(), E, C, num_segments, _stream(msgs))
    check(status, "sorted_segment_sum")
    sorted_segment_sum.launches += 1
    return out


def segment_gather_plain(g: torch.Tensor, seg: torch.Tensor, num_segments: int):
    """Plain PyTorch version of the segment sum's VJP (tpufem's
    ``_seg_sum_bwd``): row e of the result is g[seg[e]], and 0 for dump rows
    (seg == num_segments)."""
    g_pad = torch.cat([g, torch.zeros((1, g.shape[1]), dtype=g.dtype, device=g.device)])
    return g_pad[torch.clamp(seg.long(), 0, num_segments)]


def segment_gather(g: torch.Tensor, seg: torch.Tensor, num_segments: int):
    """The segment sum's VJP, a row gather: g (num_segments, C) f32 and int32
    ids seg (E,), in any order -> (E, C), out[e] = g[seg[e]] and 0 where
    seg[e] == num_segments. A CPU tensor takes the plain version; a CUDA
    tensor launches kernel C."""
    if not g.is_cuda:
        return segment_gather_plain(g, seg, num_segments)
    _check_rows("kernel C", g, num_segments)
    _check_vector("kernel C", "ids", seg, torch.int32, g)
    E, C = seg.shape[0], g.shape[1]
    if E * C >= _MAX_ELEMENTS:
        raise ValueError(f"kernel C: {E * C} elements do not fit 32-bit indices")
    out = torch.empty((E, C), dtype=g.dtype, device=g.device)
    status = load_kernels().tpufem_segment_gather_f32(
        g.data_ptr(), seg.data_ptr(), out.data_ptr(), E, C, num_segments, _stream(g))
    check(status, "segment_gather")
    segment_gather.launches += 1
    return out


segment_gather.launches = 0


class SortedSegmentSum(torch.autograd.Function):
    """Segment sum over sorted ids with its VJP (tpufem's ``custom_vjp``
    pair ``_seg_sum_fwd`` / ``_seg_sum_bwd``): kernels A (entry (a)) and C on
    the card, the plain versions on the CPU. No gradient flows to the ids."""

    @staticmethod
    def forward(ctx, msgs, seg, num_segments: int, rowptr):
        ctx.save_for_backward(seg)
        ctx.num_segments = num_segments
        return _sorted_segment_sum_fwd(msgs, seg, num_segments, rowptr)

    @staticmethod
    def backward(ctx, g):
        if not ctx.needs_input_grad[0]:
            return None, None, None, None
        (seg,) = ctx.saved_tensors
        return segment_gather(g.contiguous(), seg, ctx.num_segments), None, None, None


def sorted_segment_sum(msgs: torch.Tensor, seg: torch.Tensor, num_segments: int, rowptr=None):
    """Segment sum of msgs (E,C) f32 over SORTED int32 ids seg (E,) into
    (num_segments, C); rows with id num_segments land nowhere. Differentiable
    in msgs. `rowptr` is ``segment_rowptr(seg, num_segments)`` where the
    caller already has it (an ``AggregationPlan`` does).

    A CPU tensor takes the plain versions; a CUDA tensor launches kernel A
    (forward) and kernel C (backward), or raises.
    """
    if not wants_grad(msgs):  # spare the host the autograd Function's bookkeeping
        return _sorted_segment_sum_fwd(msgs, seg, num_segments, rowptr)
    return SortedSegmentSum.apply(msgs, seg, num_segments, rowptr)


sorted_segment_sum.launches = 0


# --------------------------------------------------------------- entry (b)


def gather_row_sum_plain(x, idx, w, rowptr, rowdiv=None, normalize=False):
    """Plain PyTorch version of ``gather_row_sum``."""
    E, N = idx.shape[0], rowptr.shape[0] - 1
    rows = torch.arange(E, device=x.device)
    seg = torch.bucketize(rows, rowptr[1:].long(), right=True)  # N for the dump rows
    i = idx.long().clamp(0, x.shape[0] - 1)
    wr = torch.ones(E, dtype=x.dtype, device=x.device) if w is None else w
    if rowdiv is not None:
        wr = wr / rowdiv[i].clamp(min=1.0)
    sums = torch.zeros((N + 1, x.shape[1]), dtype=x.dtype, device=x.device)
    sums.index_add_(0, seg, x[i] * wr[:, None])
    deg = torch.zeros(N + 1, dtype=x.dtype, device=x.device).index_add_(0, seg, wr)
    sums, deg = sums[:N], deg[:N]
    if normalize:
        sums = sums / deg.clamp(min=1.0)[:, None]
    return sums, deg


def gather_row_sum(x, idx, w, rowptr, rowdiv=None, normalize=False):
    """Kernel A entry (b), the fused gather and row sum. Segment s owns the
    rows [rowptr[s], rowptr[s+1]) and row r is ``x[idx[r], :] * w[r]`` (w
    None: 1), the weight divided by ``max(rowdiv[idx[r]], 1)`` where rowdiv
    is given. Returns (sums, deg) with ``deg[s]`` the sum of the segment's
    weights; with `normalize`, sums is divided by ``max(deg, 1)``. Rows past
    rowptr[-1] are never read.

    x (R, C) f32; idx (E,) int32 with values in [0, R); w (E,) f32; rowptr
    (N+1,) int32, non-decreasing within [0, E]; rowdiv (R,) f32 -> (N, C),
    (N,). Dtypes, shapes and devices are checked; the VALUES of idx and
    rowptr are trusted: the kernel reads the rows they name unchecked, so a
    value out of range reads out of bounds (``aggregation_plan`` builds only
    plans that keep this promise). Rows are summed in order, without atomics. A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel or raises. Not differentiable by itself
    (``FusedGatherMean`` and ``RowGather`` pair it into autograd Functions).
    """
    if not x.is_cuda:
        return gather_row_sum_plain(x, idx, w, rowptr, rowdiv, normalize)
    name = "kernel A (fused)"
    _check_rows(name, x)
    _check_vector(name, "row indices", idx, torch.int32, x)
    if w is not None:
        _check_vector(name, "row weights", w, torch.float32, x, idx.shape[0])
    if rowdiv is not None:
        _check_vector(name, "row divisors", rowdiv, torch.float32, x, x.shape[0])
    _check_vector(name, "row pointers", rowptr, torch.int32, x)
    N, C = rowptr.shape[0] - 1, x.shape[1]
    if N < 0 or N * C >= _MAX_ELEMENTS:
        raise ValueError(f"{name}: bad output shape ({N}, {C})")
    out = torch.empty((N, C), dtype=x.dtype, device=x.device)
    deg = torch.empty(N, dtype=x.dtype, device=x.device)
    status = load_kernels().tpufem_gather_row_sum_f32(
        x.data_ptr(), idx.data_ptr(), None if w is None else w.data_ptr(),
        None if rowdiv is None else rowdiv.data_ptr(), rowptr.data_ptr(), out.data_ptr(),
        deg.data_ptr(), x.shape[0], C, N, int(bool(normalize)), _stream(x))
    check(status, "gather_row_sum")
    gather_row_sum.launches += 1
    return out, deg


gather_row_sum.launches = 0


# ---------------------------------------------------------------- the plan


@dataclass
class TransposedPlan:
    """The kept edges of an ``AggregationPlan`` in stable order by source:
    row r' is the plan's row perm[r']; node j owns [rowptr[j], rowptr[j+1])."""

    perm: torch.Tensor  # (E,) int32 positions in the plan's order
    dst: torch.Tensor  # (E,) int32 destinations (num_nodes past rowptr[-1])
    w: torch.Tensor  # (E,) f32 edge weights
    rowptr: torch.Tensor  # (num_nodes + 1,) int32


@dataclass
class AggregationPlan:
    """What every mean aggregation over one graph needs, built once: the
    directed edges (src -> dst) in stable order by effective destination
    (masked-out edges, edge_mask <= 0, go to the dump segment num_nodes)."""

    num_nodes: int
    src: torch.Tensor  # (E,) int32 sources, in the stable order
    w: torch.Tensor  # (E,) edge_mask, in that order
    seg: torch.Tensor  # (E,) int32 effective destinations, sorted
    rowptr: torch.Tensor  # (num_nodes + 1,) int32
    _transposed: TransposedPlan | None = field(default=None, repr=False)

    def transposed(self) -> TransposedPlan:
        """The plan of the backward pass, built when a gradient first asks
        for it: the same edges in stable order by source."""
        if self._transposed is None:
            with torch.no_grad():
                w = self.w.detach()
                key = torch.where(self.seg < self.num_nodes, self.src,
                                  torch.full_like(self.src, self.num_nodes))
                perm = torch.argsort(key, stable=True)
                self._transposed = TransposedPlan(
                    perm=perm.to(torch.int32), dst=self.seg[perm].contiguous(),
                    w=w[perm].contiguous(),
                    rowptr=segment_rowptr(key[perm].contiguous(), self.num_nodes))
        return self._transposed


def aggregation_plan(edge_index, edge_mask, num_nodes: int) -> AggregationPlan:
    """The plan of edge_index (2,E) int32 rows (src, dst) under edge_mask (E,)
    on a graph of num_nodes nodes. The kernels read the rows a plan names
    unchecked, so the plan names none outside the graph: an edge whose
    destination is out of range is dropped like a masked one (as
    jax.ops.segment_sum drops it) and a source is clamped into range (as a
    JAX gather clamps it)."""
    if edge_index.dtype != torch.int32:
        raise TypeError(f"aggregation_plan takes int32 edges, got {edge_index.dtype}")
    if edge_index.dim() != 2 or edge_index.shape[0] != 2 or \
            edge_mask.shape != edge_index.shape[1:]:
        raise ValueError(f"aggregation_plan: edges {tuple(edge_index.shape)}, "
                         f"mask {tuple(edge_mask.shape)}")
    src, dst = edge_index[0].clamp(0, num_nodes - 1), edge_index[1]
    keep = (edge_mask > 0) & (dst >= 0) & (dst < num_nodes)
    dst_eff = torch.where(keep, dst, torch.full_like(dst, num_nodes))
    order = torch.argsort(dst_eff, stable=True)
    seg = dst_eff[order].contiguous()
    return AggregationPlan(num_nodes=num_nodes, src=src[order].contiguous(),
                           w=edge_mask[order].contiguous(), seg=seg,
                           rowptr=segment_rowptr(seg, num_nodes))


# ------------------------------------------------------- the aggregations


class FusedGatherMean(torch.autograd.Function):
    """mean_{j in N(i)} h_j in one launch of kernel A entry (b), and its VJP
    in h, ``grad_h[j] = sum_{r: src[r]=j} w[r] / max(deg[dst[r]], 1) *
    g[dst[r]]``, in one more over the transposed plan. No gradient flows to
    the plan."""

    @staticmethod
    def forward(ctx, h, plan: AggregationPlan):
        out, deg = gather_row_sum(h, plan.src, plan.w, plan.rowptr, normalize=True)
        ctx.plan = plan
        ctx.save_for_backward(deg)
        return out

    @staticmethod
    def backward(ctx, g):
        (deg,) = ctx.saved_tensors
        t = ctx.plan.transposed()
        grad_h, _ = gather_row_sum(g.contiguous(), t.dst, t.w, t.rowptr, rowdiv=deg)
        return grad_h, None


class RowGather(torch.autograd.Function):
    """h[plan.src] as an (E, C) tensor: kernel C forward; backward the sum of
    the cotangent rows of each source, kernel A entry (b) over the transposed
    plan (dump rows, whose messages reach no sum, get no gradient)."""

    @staticmethod
    def forward(ctx, h, plan: AggregationPlan):
        ctx.plan = plan
        return segment_gather(h, plan.src, h.shape[0])

    @staticmethod
    def backward(ctx, g):
        t = ctx.plan.transposed()
        grad_h, _ = gather_row_sum(g.contiguous(), t.perm, None, t.rowptr)
        return grad_h, None


def _check_plan(h, plan: AggregationPlan) -> None:
    if h.shape[0] != plan.num_nodes:
        raise ValueError(f"plan of {plan.num_nodes} nodes, h {tuple(h.shape)}")


def segment_mean_aggregate(h, plan: AggregationPlan):
    """mean_{j in N(i)} h_j over the directed edges (src -> dst) of `plan`
    (``aggregation_plan(edge_index, edge_mask, num_nodes)``), fused: the
    neighbour rows are read from h inside the sum (tpufem's
    ``segment_mean_aggregate``, which XLA fuses). Differentiable in h only:
    raises if edge_mask asks for a gradient, which tpufem would give."""
    _check_plan(h, plan)
    if plan.w.requires_grad:
        raise ValueError("segment_mean_aggregate gives no gradient to edge_mask; use "
                         "gather_mean_aggregate")
    if not wants_grad(h):
        return gather_row_sum(h, plan.src, plan.w, plan.rowptr, normalize=True)[0]
    return FusedGatherMean.apply(h, plan)


def gather_mean_aggregate(h, plan: AggregationPlan):
    """mean_{j in N(i)} h_j over the directed edges (src -> dst) of `plan`,
    through the sorted segment sum as tpufem's Pallas route runs it: the
    messages ``h[src] * w`` are materialised in the plan's order, and sums
    and degrees are two segment sums. Differentiable in h and edge_mask."""
    _check_plan(h, plan)
    num_nodes = plan.num_nodes
    w = plan.w[:, None]
    rows = RowGather.apply(h, plan) if wants_grad(h) else segment_gather(h, plan.src, num_nodes)
    msgs = rows * w
    sums = sorted_segment_sum(msgs, plan.seg, num_nodes, plan.rowptr)
    deg = sorted_segment_sum(w.contiguous(), plan.seg, num_nodes, plan.rowptr)
    return sums / torch.clamp(deg, min=1.0)
