"""Differentiable sorted segment sum (CUDA kernels A and C) and GraphSAGE mean
aggregation.

Port of ``tpufem/ops/gather_scatter.py``. The TPU kernel there
(``_seg_sum_kernel`` via ``sorted_segment_sum_pallas``) and its VJP
(``_seg_sum_bwd``, a row gather of the cotangent inside the ``custom_vjp``)
are replaced by two hand-written CUDA kernels in ``csrc/segment_sum.cu``:
kernel A (forward) and kernel C (backward), joined by the
``torch.autograd.Function`` ``SortedSegmentSum``. See that file for their
design.

Dropped TPU workarounds: the ``MAX_SEGMENTS`` VMEM cap on the output rows and
``gather_mean_aggregate``'s fallback to XLA segment_sum above it existed only
because the Pallas kernel kept its whole output resident in VMEM. The CUDA
kernels have no such limit, so every graph size takes the same path.
"""

from __future__ import annotations

import torch

from tpufem_torch.ops.kernels import check, load_kernels


def _check_kernel_inputs(name: str, x: torch.Tensor, seg: torch.Tensor, rows: int) -> None:
    if x.dtype != torch.float32 or seg.dtype != torch.int32:
        raise TypeError(f"{name} takes f32 values and int32 ids, got {x.dtype}/{seg.dtype}")
    if x.dim() != 2 or x.shape[0] != rows or seg.dim() != 1 or seg.device != x.device:
        raise ValueError(f"{name}: bad shapes {tuple(x.shape)} / seg {tuple(seg.shape)}")


def sorted_segment_sum_plain(msgs: torch.Tensor, seg: torch.Tensor, num_segments: int):
    """Plain PyTorch version: sum rows of msgs (E,C) by segment id into
    (num_segments, C); rows with id num_segments (padding) are dropped."""
    out = torch.zeros((num_segments + 1, msgs.shape[1]), dtype=msgs.dtype, device=msgs.device)
    out.index_add_(0, seg.long(), msgs)
    return out[:num_segments]


def _sorted_segment_sum_fwd(msgs: torch.Tensor, seg: torch.Tensor, num_segments: int):
    """Forward of the segment sum: kernel A on a CUDA tensor, the plain
    version on a CPU tensor."""
    if not msgs.is_cuda:
        return sorted_segment_sum_plain(msgs, seg, num_segments)
    _check_kernel_inputs("kernel A", msgs, seg, seg.shape[0])
    msgs = msgs.contiguous()
    seg = seg.contiguous()
    E, C = msgs.shape
    out = torch.empty((num_segments, C), dtype=msgs.dtype, device=msgs.device)
    status = load_kernels().tpufem_sorted_segment_sum_f32(
        msgs.data_ptr(), seg.data_ptr(), out.data_ptr(), E, C, num_segments,
        torch.cuda.current_stream(msgs.device).cuda_stream,
    )
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
    """The segment sum's VJP: g (num_segments, C) f32 and int32 ids seg (E,)
    -> (E, C). A CPU tensor takes the plain version; a CUDA tensor launches
    kernel C."""
    if not g.is_cuda:
        return segment_gather_plain(g, seg, num_segments)
    _check_kernel_inputs("kernel C", g, seg, num_segments)
    g = g.contiguous()
    seg = seg.contiguous()
    E, C = seg.shape[0], g.shape[1]
    out = torch.empty((E, C), dtype=g.dtype, device=g.device)
    status = load_kernels().tpufem_segment_gather_f32(
        g.data_ptr(), seg.data_ptr(), out.data_ptr(), E, C, num_segments,
        torch.cuda.current_stream(g.device).cuda_stream,
    )
    check(status, "segment_gather")
    segment_gather.launches += 1
    return out


segment_gather.launches = 0


class SortedSegmentSum(torch.autograd.Function):
    """Segment sum over sorted ids with its VJP (tpufem's ``custom_vjp``
    pair ``_seg_sum_fwd`` / ``_seg_sum_bwd``): kernels A and C on the card,
    the plain versions on the CPU. No gradient flows to the ids."""

    @staticmethod
    def forward(ctx, msgs, seg, num_segments: int):
        ctx.save_for_backward(seg)
        ctx.num_segments = num_segments
        return _sorted_segment_sum_fwd(msgs, seg, num_segments)

    @staticmethod
    def backward(ctx, g):
        if not ctx.needs_input_grad[0]:
            return None, None, None
        (seg,) = ctx.saved_tensors
        return segment_gather(g, seg, ctx.num_segments), None, None


def sorted_segment_sum(msgs: torch.Tensor, seg: torch.Tensor, num_segments: int):
    """Segment sum of msgs (E,C) f32 over SORTED int32 ids seg (E,) into
    (num_segments, C); rows with id num_segments land nowhere. Differentiable
    in msgs.

    A CPU tensor takes the plain versions; a CUDA tensor launches kernel A
    (forward) and kernel C (backward), or raises.
    """
    return SortedSegmentSum.apply(msgs, seg, num_segments)


sorted_segment_sum.launches = 0


def gather_mean_aggregate(h, edge_index, edge_mask, num_nodes: int):
    """mean_{j in N(i)} h_j over directed edges (src -> dst), through the
    sorted segment sum: edges are sorted by destination, masked-out edges go
    to the dump segment, and sums and degrees are two segment sums."""
    src, dst = edge_index[0], edge_index[1]
    dst_eff = torch.where(edge_mask > 0, dst.to(torch.int32),
                          torch.full_like(dst, num_nodes, dtype=torch.int32))
    order = torch.argsort(dst_eff, stable=True)
    w = edge_mask[order][:, None]
    msgs = h[src[order].long()] * w
    seg = dst_eff[order].contiguous()
    sums = sorted_segment_sum(msgs, seg, num_nodes)
    deg = sorted_segment_sum(w.contiguous(), seg, num_nodes)
    return sums / torch.clamp(deg, min=1.0)
