"""Segment-sum formulations — port of ``tpufem/ops/segment.py``.

Three ways to sum per-row values into segments, each with the semantics of
``jax.ops.segment_sum``: rows whose id lies outside [0, num_segments) land
nowhere.

  segment_sum_plain    — zeros, then ``index_add_``: the scatter-add
                         formulation (tpufem's XLA scatter-add). On the card
                         ``index_add_`` adds with atomics, so f32 bits depend
                         on the order the rows land in. Not on any path.
  segment_sum_sorted   — over a host-made permutation (make_sorted_plan):
                         on the card kernel A entry (a) in f32
                         (ops.gather_scatter.sorted_segment_sum) and kernel E
                         in f64 (ops.csr_segment_sum), each in a fixed order.
  incidence_gather_sum — per-node padded incidence gather
                         (fem.assembly.gather_accumulate): the same torch ops
                         on any device, slot by slot.

tpufem measured these on the TPU, where scatter serialised on duplicate
indices; the port's paths sum through kernels A, D and E, and these names
exist for tpufem's callers.
"""

from __future__ import annotations

import numpy as np
import torch

from tpufem_torch.fem.assembly import build_incidence, gather_accumulate  # noqa: F401
from tpufem_torch.ops.csr_segment_sum import csr_plan, csr_segment_sum
from tpufem_torch.ops.gather_scatter import sorted_segment_sum, sorted_segment_sum_plain


def _ids(seg_ids, num_segments: int, device) -> torch.Tensor:
    """The ids as int64 on `device`, every id outside [0, num_segments) made
    num_segments (the dump row)."""
    ids = torch.as_tensor(seg_ids, device=device).long()
    return torch.where((ids >= 0) & (ids < num_segments), ids, num_segments)


def _rows(values: torch.Tensor) -> torch.Tensor:
    """values (E, ...) as (E, C) rows."""
    return values.reshape(values.shape[0], -1)


def segment_sum_plain(values: torch.Tensor, seg_ids, num_segments: int) -> torch.Tensor:
    """Sum of the rows of values (E, ...) by seg_ids (E,) into (num_segments,
    ...): zeros, then index_add_ (atomics on the card)."""
    ids = _ids(seg_ids, num_segments, values.device)
    out = torch.zeros((num_segments + 1,) + tuple(values.shape[1:]), dtype=values.dtype,
                      device=values.device)
    return out.index_add_(0, ids, values)[:num_segments]


def make_sorted_plan(seg_ids: np.ndarray):
    """(perm, sorted_ids) for segment_sum_sorted, computed once per topology
    on the host: the stable argsort of the ids and the ids in that order,
    both int32 numpy arrays."""
    seg_ids = np.asarray(seg_ids)
    perm = np.argsort(seg_ids, kind="stable")
    return perm.astype(np.int32), seg_ids[perm].astype(np.int32)


def segment_sum_sorted(values: torch.Tensor, perm, sorted_ids, num_segments: int
                       ) -> torch.Tensor:
    """Sum of the rows values[perm] (E, ...) by the ascending sorted_ids (E,)
    into (num_segments, ...), each segment's rows added in order from zero.

    On a CPU tensor: values[perm], then sorted_segment_sum_plain. On a CUDA
    tensor: f32 launches kernel A entry (a) (differentiable in values, its
    backward kernel C); f64 launches kernel E over csr_plan(the ids in
    range), the CPU version's bits. Another dtype raises there: the card
    never falls back to the plain version."""
    dev = values.device
    rows = _rows(values)[torch.as_tensor(perm, device=dev).long()]
    trailing = tuple(values.shape[1:])
    if not values.is_cuda:
        out = sorted_segment_sum_plain(rows, _ids(sorted_ids, num_segments, dev), num_segments)
    elif values.dtype == torch.float32:
        ids = torch.as_tensor(sorted_ids, device=dev).to(torch.int32).contiguous()
        out = sorted_segment_sum(rows.contiguous(), ids, num_segments)
    elif values.dtype == torch.float64:
        ids = torch.as_tensor(sorted_ids).cpu().numpy().astype(np.int64)
        lo, hi = np.searchsorted(ids, [0, num_segments])  # the rows in range
        out = csr_segment_sum(rows[lo:hi].contiguous(), csr_plan(ids[lo:hi], num_segments, dev))
    else:
        raise TypeError(f"segment_sum_sorted takes f32 (kernel A) or f64 (kernel E) values on "
                        f"the card, got {values.dtype}")
    return out.reshape((num_segments,) + trailing)


def incidence_gather_sum(values: torch.Tensor, incidence, inc_mask) -> torch.Tensor:
    """values (M, C) summed per node through the precomputed (N, V)
    incidence plan (tpufem's build_incidence pair): gather_accumulate."""
    return gather_accumulate(values, incidence, inc_mask)
