"""Deterministic segment sum over a fixed index list (CUDA kernel E).

tpufem sums per-row values into segments with ``jax.ops.segment_sum`` over
index lists that never change for a topology: element forces and the Jacobi
diagonal per node, pressure loads per node, nodal stress averages, the
preconditioners' block and group sums. On CUDA, ``index_add_`` does the same
with atomics, whose order changes from run to run, so the same solve can take
a different number of iterations twice. The port sorts each index list once
on the host into a CSR plan (a stable argsort ``order`` and the row offsets
``starts`` of each segment) and sums each segment's rows in that fixed order,
from zero: kernel E (``csrc/csr_segment_sum.cu``) on a CUDA tensor, the plain
version on a CPU tensor. Both give the same bits run to run, and the same
bits as each other.

Kernel E runs a block per range of consecutive segments. The ranges are cut
on the host (``csr_ranges``) once per plan and per row width (channels and
dtype), at the first launch at that width, and written with each range's
first row indices (and, in a mostly empty plan, its segments with rows)
into a table on the device (``range_table``), kept in the plan's ``launch``
dict.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from tpufem_torch.ops.kernels import check, load_kernels, wants_grad


STAGE_BYTES = 32768  # the row bytes a range of several segments stages, at most
STAGE_ROWS = 2048  # and its rows, at most
MAX_RANGE_OUT = 256 * 8  # the outputs of a range: kOut for each of a block's threads
MAX_CHUNK_BYTES = 48 * 1024  # the row bytes a block stages at once, at most
MIN_RANGES = 2 * 132  # ranges enough for two blocks on each of an H100's SMs
MAX_SMEM = 232448  # a Hopper block's most shared memory


class CsrPlan(NamedTuple):
    """Rows of one fixed index list, grouped by segment."""

    order: torch.Tensor  # (R,) int32: stable argsort of the rows' segment ids
    starts: torch.Tensor  # (N+1,) int32: rows order[starts[s]:starts[s+1]] belong to s
    seg: torch.Tensor  # (R,) int64: the segment ids in `order` (plain version)
    num_segments: int
    starts_host: np.ndarray  # (N+1,) int64: `starts` on the host, for csr_ranges
    launch: dict  # {(C, itemsize): CsrLaunch}: kernel E's ranges, filled at first use


class CsrLaunch(NamedTuple):
    """Kernel E's cut of one plan at one row width (csr_ranges), on the
    plan's device."""

    tab: torch.Tensor  # (n_ranges, table_stride) int32: range_table, a block's first read
    n_ranges: int
    chunk_rows: int  # the rows a block stages at once
    range_segs: int  # the most segments in a range
    list_len: int  # the most segments with rows a row of tab lists (0: a dense plan's)


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
        starts_host=starts,
        launch={},
    )


def plan_on(plan, device) -> CsrPlan:
    """A CsrPlan with `plan`'s order, starts and segment ids on `device` (its
    launch cuts are made anew there): e.g. a CPU copy of a card's plan, for
    the plain version."""
    return CsrPlan(order=plan.order.to(device), starts=plan.starts.to(device),
                   seg=plan.seg.to(device), num_segments=plan.num_segments,
                   starts_host=plan.starts_host, launch={})


def csr_ranges(starts, C: int, itemsize: int, stage_bytes: int = STAGE_BYTES,
               min_ranges: int = MIN_RANGES):
    """Kernel E's cut of the segments with row offsets `starts` (N+1,) at
    rows of C values of `itemsize` bytes: (ranges (n+1, 2) int64, each
    range's first segment and first row, then (N, R); chunk_rows, the rows a
    block stages at once; range_segs, the most segments in a range).

    Greedy, in segment order: a range takes segments while its rows stay
    within stage_bytes of rows and STAGE_ROWS and its outputs within
    MAX_RANGE_OUT (C <= MAX_RANGE_OUT), both fewer where that leaves under
    `min_ranges` ranges, so that a plan of few segments still
    gives every SM blocks; a segment with more rows than that is a range of
    its own, which the kernel streams through shared memory in chunks of at
    most MAX_CHUNK_BYTES."""
    starts = np.asarray(starts, np.int64)
    N, R = len(starts) - 1, int(starts[-1])
    row_bytes = C * itemsize
    per = max(1, min(STAGE_ROWS, stage_bytes // row_bytes))
    rows_cut = max(1, min(per, -(-R // min_ranges)))
    segs_cut = max(1, min(per, MAX_RANGE_OUT // C, -(-N // min_ranges)))
    bounds = [0]
    while bounds[-1] < N:
        s0 = bounds[-1]
        fit = int(np.searchsorted(starts, starts[s0] + rows_cut, side="right")) - 1
        bounds.append(max(s0 + 1, min(s0 + segs_cut, fit)))
    b = np.asarray(bounds, np.int64)
    ranges = np.stack([b, starts[b]], axis=1)
    rows = int(np.diff(starts[b]).max(initial=0))
    chunk_rows = max(1, min(rows, MAX_CHUNK_BYTES // row_bytes))
    return ranges, chunk_rows, int(np.diff(b).max(initial=1))


def table_stride(chunk_rows: int, list_len: int = 0) -> int:
    """The int32 columns of a range_table row: a head of 8, chunk_rows row
    indices, and with list_len > 0 the list of segments with rows (list_len)
    and their row offsets (list_len + 1); to a multiple of 4."""
    return -(-(8 + chunk_rows + (2 * list_len + 1 if list_len else 0)) // 4) * 4


def range_table(order: torch.Tensor, ranges: np.ndarray, chunk_rows: int, starts=None):
    """(tab, list_len): kernel E's table, a row per range, int32 on order's
    device. A row holds the range's first segment, first row, end segment and
    end row, the number of its segments with rows (-1 where not listed),
    3 zeros, the row indices order[r] of its first chunk (up to chunk_rows
    rows, zero-padded), then, given the plan's `starts` (a mostly empty
    plan), for a range whose rows fit one chunk its segments with rows
    (range-local) and their row offsets from its first row (list_len of
    each, the most any range has, and the end). A block reads its row in one
    coalesced round trip, so the rows it gathers wait on nothing else, and a
    listed range needs no starts."""
    ranges = np.asarray(ranges, np.int64)
    n = len(ranges) - 1
    s0, r0 = ranges[:-1, 0], ranges[:-1, 1]
    n_rows = np.diff(ranges[:, 1])
    listed = np.full(n, -1, np.int64)
    list_len = 0
    if starts is not None:
        starts = np.asarray(starts, np.int64)
        fits = n_rows <= chunk_rows
        nz = np.nonzero(np.diff(starts))[0]
        b_of = np.searchsorted(ranges[:, 0], nz, side="right") - 1
        nz, b_of = nz[fits[b_of]], b_of[fits[b_of]]
        per = np.bincount(b_of, minlength=n)
        listed[fits] = per[fits]
        list_len = max(1, int(per.max(initial=0)))  # a listing table has the section
    stride = table_stride(chunk_rows, list_len)
    host = np.zeros((n, stride), np.int64)
    host[:, :5] = np.stack([s0, r0, ranges[1:, 0], ranges[1:, 1], listed], axis=1)
    if list_len:
        j = np.arange(len(nz)) - np.repeat(np.cumsum(per) - per, per)
        host[b_of, 8 + chunk_rows + j] = nz - s0[b_of]
        host[b_of, 8 + chunk_rows + list_len + j] = starts[nz] - r0[b_of]
        host[fits, 8 + chunk_rows + list_len + per[fits]] = n_rows[fits]
    tab = torch.as_tensor(host.astype(np.int32), device=order.device)
    rows = np.minimum(n_rows, chunk_rows)
    total = int(rows.sum())
    if total:
        j = np.arange(total) - np.repeat(np.cumsum(rows) - rows, rows)
        b = np.repeat(np.arange(n), rows)
        src = torch.as_tensor(np.repeat(r0, rows) + j, device=order.device)
        tab.view(-1)[torch.as_tensor(b * stride + 8 + j, device=order.device)] = order[src]
    return tab, list_len


def smem_bytes(C: int, itemsize: int, chunk_rows: int, range_segs: int,
               list_len: int = 0) -> int:
    """Kernel E's shared memory per block: the staged rows (to 16 bytes),
    the block's range_table row, then the range's starts."""
    return (-(-chunk_rows * C * itemsize // 16) * 16
            + 4 * (table_stride(chunk_rows, list_len) + range_segs + 1))


def make_launch(plan, C: int, itemsize: int, **cut) -> CsrLaunch:
    """Kernel E's launch plan of `plan` at rows of C values of `itemsize`
    bytes: the cut of csr_ranges (with `cut`'s budgets, default the
    wrapper's) and its range_table on the plan's device, which lists each
    range's segments with rows where the plan is mostly empty (half of its
    segments or more without rows). Raises where a block's shared memory
    cannot hold it or C exceeds MAX_RANGE_OUT."""
    if C > MAX_RANGE_OUT:
        raise ValueError(f"kernel E takes at most {MAX_RANGE_OUT} channels, not {C}")
    ranges, chunk_rows, range_segs = csr_ranges(plan.starts_host, C, itemsize, **cut)
    sparse = 2 * int((np.diff(plan.starts_host) == 0).sum()) >= plan.num_segments
    tab, list_len = range_table(plan.order, ranges, chunk_rows,
                                plan.starts_host if sparse else None)
    if smem_bytes(C, itemsize, chunk_rows, range_segs, list_len) > MAX_SMEM:
        raise ValueError(f"kernel E: a row of {C} x {itemsize} bytes needs more shared memory "
                         f"than a block has")
    return CsrLaunch(tab, len(ranges) - 1, chunk_rows, range_segs, list_len)


def launch_plan(plan, C: int, itemsize: int) -> CsrLaunch:
    """The plan's CsrLaunch at rows of C values of `itemsize` bytes
    (make_launch), made at the first call and kept in plan.launch."""
    key = (int(C), int(itemsize))
    lp = plan.launch.get(key)
    if lp is None:
        lp = plan.launch[key] = make_launch(plan, C, itemsize)
    return lp


def csr_segment_sum_plain(vals: torch.Tensor, plan: CsrPlan) -> torch.Tensor:
    """Plain PyTorch version: out (N, C) with out[s] the sum of the rows
    vals[plan.order[r]] of segment s, added in `order` from zero."""
    out = torch.zeros((plan.num_segments, vals.shape[1]), dtype=vals.dtype, device=vals.device)
    return out.index_add_(0, plan.seg, vals[plan.order])


def _launch(vals: torch.Tensor, plan) -> torch.Tensor:
    """Kernel E on CUDA values the wrapper has checked."""
    vals = vals.contiguous()
    N, C = plan.num_segments, vals.shape[1]
    lp = launch_plan(plan, C, vals.element_size())
    out = torch.empty((N, C), dtype=vals.dtype, device=vals.device)
    fn = (load_kernels().tpufem_csr_segment_sum_ranges_f64 if vals.dtype == torch.float64
          else load_kernels().tpufem_csr_segment_sum_ranges_f32)
    status = fn(vals.data_ptr(), plan.order.data_ptr(), plan.starts.data_ptr(),
                lp.tab.data_ptr(), out.data_ptr(), C, lp.n_ranges, lp.chunk_rows,
                lp.range_segs, lp.list_len, torch.cuda.current_stream(vals.device).cuda_stream)
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
    by its field names (order, starts, seg, num_segments, starts_host,
    launch), so a tuple that carries a CsrPlan's fields among others
    (fem.assembly.IncidencePlan, fem.tet10.ForcePlan10) serves as one."""
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
