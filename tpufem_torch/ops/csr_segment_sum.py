"""Deterministic segment sum over a fixed index list (CUDA kernel E).

tpufem sums per-row values into segments with ``jax.ops.segment_sum`` over
index lists that never change for a topology: element forces and the Jacobi
diagonal per node, pressure loads per node, nodal stress averages, the
preconditioners' block and group sums. On CUDA, ``index_add_`` does the same
with atomics, whose order changes from run to run, so the same solve can take
a different number of iterations twice. The port sorts each index list once
on the host into a CSR plan (a stable argsort ``order`` and the row offsets
``starts`` of each segment) and sums each segment's rows in that fixed order:
kernel E (``csrc/csr_segment_sum.cu``) on a CUDA tensor, the plain version on
a CPU tensor. Both give the same bits run to run.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from tpufem_torch.ops.kernels import check, load_kernels, wants_grad


class CsrPlan(NamedTuple):
    """Rows of one fixed index list, grouped by segment."""

    order: torch.Tensor  # (R,) int32: stable argsort of the rows' segment ids
    starts: torch.Tensor  # (N+1,) int32: rows order[starts[s]:starts[s+1]] belong to s
    seg: torch.Tensor  # (R,) int64: the segment ids in `order` (plain version)
    num_segments: int


def csr_arrays(ids, num_segments: int):
    """(order, starts, ids) of a CSR plan as int64 numpy arrays: the stable
    argsort of the flattened `ids`, each segment's row offsets in it, and the
    flattened ids. Raises on an id outside [0, num_segments)."""
    if isinstance(ids, torch.Tensor):
        ids = ids.cpu().numpy()
    ids = np.asarray(ids).reshape(-1).astype(np.int64)
    if ids.size and (ids.min() < 0 or ids.max() >= num_segments):
        raise ValueError(f"segment ids outside [0, {num_segments})")
    if ids.size >= 2**31:
        raise ValueError("csr_plan: more rows than int32 order and starts can index")
    # numpy sorts 16-bit keys by radix, several times faster than its merge sort
    order = np.argsort(ids.astype(np.uint16) if num_segments <= 2**16 else ids, kind="stable")
    starts = np.zeros(num_segments + 1, dtype=np.int64)
    np.cumsum(np.bincount(ids, minlength=num_segments), out=starts[1:])
    return order, starts, ids


def csr_plan(ids, num_segments: int, device="cpu") -> CsrPlan:
    """CSR plan of the segment ids `ids` (any shape, flattened row-major) over
    `num_segments` segments, on `device`. Built on the host once per
    topology; raises on an id outside [0, num_segments)."""
    order, starts, ids = csr_arrays(ids, num_segments)
    return CsrPlan(
        order=torch.as_tensor(order.astype(np.int32), device=device),
        starts=torch.as_tensor(starts.astype(np.int32), device=device),
        seg=torch.as_tensor(ids[order], device=device),
        num_segments=int(num_segments),
    )


def csr_segment_sum_plain(vals: torch.Tensor, plan: CsrPlan) -> torch.Tensor:
    """Plain PyTorch version: out (N, C) with out[s] the sum of the rows
    vals[plan.order[r]] of segment s, added in `order` from zero."""
    out = torch.zeros((plan.num_segments, vals.shape[1]), dtype=vals.dtype, device=vals.device)
    return out.index_add_(0, plan.seg, vals[plan.order])


def _launch(vals: torch.Tensor, plan) -> torch.Tensor:
    """Kernel E on CUDA values the wrapper has checked."""
    vals = vals.contiguous()
    N, C = plan.num_segments, vals.shape[1]
    out = torch.empty((N, C), dtype=vals.dtype, device=vals.device)
    fn = (load_kernels().tpufem_csr_segment_sum_f64 if vals.dtype == torch.float64
          else load_kernels().tpufem_csr_segment_sum_f32)
    status = fn(vals.data_ptr(), plan.order.data_ptr(), plan.starts.data_ptr(),
                out.data_ptr(), N, C, torch.cuda.current_stream(vals.device).cuda_stream)
    check(status, "csr_segment_sum")
    csr_segment_sum.launches += 1
    return out


class CsrSegmentSum(torch.autograd.Function):
    """Kernel E with a gradient: the backward gives each row its segment's
    cotangent, grad_vals[plan.order[r]] = grad_out[plan.seg[r]]. That row
    gather is plain torch indexing: tpufem's segment_sum VJP is an XLA gather,
    and it runs once per backward (the adjoint's loads and stress recovery),
    not per iteration."""

    @staticmethod
    def forward(ctx, vals, plan):
        ctx.plan = plan
        return _launch(vals, plan)

    @staticmethod
    def backward(ctx, grad_out):
        plan = ctx.plan
        grad_vals = torch.empty((plan.order.shape[0], grad_out.shape[1]), dtype=grad_out.dtype,
                                device=grad_out.device)
        grad_vals[plan.order.long()] = grad_out[plan.seg]
        return grad_vals, None


def csr_segment_sum(vals: torch.Tensor, plan: CsrPlan) -> torch.Tensor:
    """Sum the rows of vals (R, C), f32 or f64, into (plan.num_segments, C)
    in the plan's fixed order. A CPU tensor takes the plain version; a CUDA
    tensor launches kernel E, or raises; where it requires a gradient, through
    CsrSegmentSum (the same launch, and a row gather backward). `plan` is read
    by its field names (order, starts, seg, num_segments), so a tuple that
    carries a CsrPlan's fields among others (fem.assembly.IncidencePlan)
    serves as one."""
    if vals.dim() != 2 or vals.shape[0] != plan.order.shape[0]:
        raise ValueError(f"csr_segment_sum: vals {tuple(vals.shape)} against a plan of "
                         f"{plan.order.shape[0]} rows")
    if not vals.is_cuda:
        return csr_segment_sum_plain(vals, plan)
    if vals.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"kernel E takes f32 or f64 values, got {vals.dtype}")
    if plan.order.device != vals.device or plan.starts.device != vals.device:
        raise ValueError("kernel E: the plan lies on another device than the values")
    if wants_grad(vals):
        return CsrSegmentSum.apply(vals, plan)
    return _launch(vals, plan)


csr_segment_sum.launches = 0
