"""The exchange layer: the collectives tpufem's shard_map bodies called
(``tpufem/parallel/shard_stencil.py:67-117``, the ppermute / psum of
``halo_pcg``), made explicit over ``torch.distributed``.

- Span slabs (shard_stencil): rank d holds node layers [d c, (d + 1) c] of a
  span axis, so its last layer is rank d + 1's first. `sync_layers` repairs
  such a shared layer after a local apply (both copies := the sum of the two
  partials), `own` zeroes the copy a rank does not own before a transpose-type
  read, `gather_full` assembles the replicated array, `slice_local` cuts a
  rank's slab out of it.
- Halo shifts (halo_pcg): `from_next` brings the next rank's leading rows
  (its ghosts), `to_next` ships ghost contributions forward.
- `all_reduce_sum` is tpufem's psum; `all_gather` its all_gather.

Point-to-point pairs are posted together (``batch_isend_irecv``) and then
waited on, so neighbours never block each other. Under NCCL the device
tensors go as they are. Under gloo with CUDA tensors every collective stages
through pinned host buffers, because gloo's send, recv and all_gather take
CPU tensors: the staging is chosen by backend, up front, never as a retry.
Every call is timed into the group's `stats` (exchange seconds and calls),
the exchange share the sharded solvers report.
"""

from __future__ import annotations

import time
from contextlib import contextmanager

import torch
import torch.distributed as dist

from tpufem_torch.parallel.meshes import DeviceGroup


@contextmanager
def timed(group: DeviceGroup):
    """Count the enclosed exchange into group.stats (wall seconds, calls)."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        group.stats["exchange_s"] += time.perf_counter() - t0
        group.stats["calls"] += 1


def _host_buffer(group: DeviceGroup, key, like: torch.Tensor) -> torch.Tensor:
    """A pinned host buffer shaped like `like`, kept per key (reused by every
    exchange of that shape)."""
    k = (key, tuple(like.shape), like.dtype)
    buf = group.buffers.get(k)
    if buf is None:
        buf = group.buffers[k] = torch.empty(like.shape, dtype=like.dtype, pin_memory=True)
    return buf


def exchange(group: DeviceGroup, sends: dict, recvs: dict) -> dict:
    """Send sends[peer] to each peer and receive a tensor shaped like
    recvs[peer] from each peer, all posted at once and then waited on.
    Returns {peer: received tensor on the group's device}."""
    if not sends and not recvs:
        return {}
    with timed(group):
        ops, out = [], {}
        for peer, t in sends.items():
            if group.staged:
                buf = _host_buffer(group, ("send", peer), t)
                buf.copy_(t)
            else:
                buf = t.contiguous()
            ops.append(dist.P2POp(dist.isend, buf, peer, group=group.pg))
        for peer, like in recvs.items():
            if group.staged:
                buf = _host_buffer(group, ("recv", peer), like)
            else:
                buf = torch.empty(like.shape, dtype=like.dtype, device=like.device)
            out[peer] = buf
            ops.append(dist.P2POp(dist.irecv, buf, peer, group=group.pg))
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        if group.staged:
            out = {p: b.to(group.device) for p, b in out.items()}
        return out


def _layer(y: torch.Tensor, axis: int, i: int) -> torch.Tensor:
    return y.narrow(axis, i % y.shape[axis], 1)


def sync_layers(group: DeviceGroup, y: torch.Tensor, span_axis: int = -1) -> torch.Tensor:
    """tpufem's _sync: repair the shared span layers, both copies := the sum
    of the two partials. Rank d's last layer and rank d + 1's first layer are
    the same global layer, each holding the contributions of its own cells.
    Returns a new tensor (y itself at world size 1)."""
    if group.world == 1:
        return y
    r = group.rank
    sends, recvs = {}, {}
    if r + 1 < group.world:
        sends[r + 1] = recvs[r + 1] = _layer(y, span_axis, -1)
    if r > 0:
        sends[r - 1] = recvs[r - 1] = _layer(y, span_axis, 0)
    got = exchange(group, sends, recvs)
    y = y.clone()
    if r + 1 < group.world:
        _layer(y, span_axis, -1).add_(got[r + 1])
    if r > 0:
        _layer(y, span_axis, 0).add_(got[r - 1])
    return y


def own(group: DeviceGroup, y: torch.Tensor, span_axis: int = -1) -> torch.Tensor:
    """tpufem's _own: zero the first span layer on every rank but the first
    (a shared layer's owner is the earlier rank), so a transpose-type read or
    a dot product reads each global layer once."""
    if group.rank == 0:
        return y
    y = y.clone()
    _layer(y, span_axis, 0).zero_()
    return y


def all_gather(group: DeviceGroup, t: torch.Tensor) -> list:
    """Every rank's `t` (all of one shape), in rank order, on the group's
    device."""
    if group.world == 1:
        return [t]
    with timed(group):
        if group.staged:
            src = t.cpu()
            parts = [torch.empty_like(src) for _ in range(group.world)]
            dist.all_gather(parts, src, group=group.pg)
            return [p.to(group.device) for p in parts]
        parts = [torch.empty_like(t) for _ in range(group.world)]
        dist.all_gather(parts, t.contiguous(), group=group.pg)
        return parts


def gather_full(group: DeviceGroup, y: torch.Tensor, span_axis: int = -1) -> torch.Tensor:
    """tpufem's _gather_full: the whole span axis from the ranks' consistent
    overlapping slabs (each shared layer taken once), replicated on every
    rank."""
    if group.world == 1:
        return y
    parts = all_gather(group, y)
    L = y.shape[span_axis]
    parts = [p.narrow(span_axis, 0, L - 1) for p in parts[:-1]] + [parts[-1]]
    return torch.cat(parts, dim=span_axis)


def slice_local(group: DeviceGroup, y_full: torch.Tensor, c: int,
                span_axis: int = -1) -> torch.Tensor:
    """tpufem's _slice_local: this rank's slab [d c, d c + c] (c + 1 layers)
    of a replicated array, contiguous."""
    return y_full.narrow(span_axis, group.rank * c, c + 1).contiguous()


def all_reduce_sum(group: DeviceGroup, t: torch.Tensor) -> torch.Tensor:
    """tpufem's psum: the sum of every rank's `t`, on every rank (a new
    tensor)."""
    if group.world == 1:
        return t
    with timed(group):
        if group.staged:
            buf = t.cpu()  # a copy: gloo reduces in place
            dist.all_reduce(buf, group=group.pg)
            return buf.to(group.device)
        buf = t.clone()
        dist.all_reduce(buf, group=group.pg)
        return buf


def from_next(group: DeviceGroup, head: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Halo shift backward: send this rank's `head` (its leading rows) to the
    previous rank and return the next rank's head (shaped like `like`; zeros
    on the last rank)."""
    r, sends, recvs = group.rank, {}, {}
    if r > 0:
        sends[r - 1] = head
    if r + 1 < group.world:
        recvs[r + 1] = like
    got = exchange(group, sends, recvs)
    return got.get(r + 1, torch.zeros_like(like))


def to_next(group: DeviceGroup, tail: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Halo shift forward: send this rank's `tail` (its ghost rows) to the
    next rank and return what the previous rank sent (shaped like `like`;
    zeros on the first rank)."""
    r, sends, recvs = group.rank, {}, {}
    if r + 1 < group.world:
        sends[r + 1] = tail
    if r > 0:
        recvs[r - 1] = like
    got = exchange(group, sends, recvs)
    return got.get(r - 1, torch.zeros_like(like))


def check_exchanges(group: DeviceGroup, fail_rank: int = -1) -> dict:
    """Run every collective of this module once on small tensors made from
    the rank and return what came back (numpy), for a test or a smoke run to
    hold against the values they must have; in an initialised group also the
    backend's own all_reduce of d + 1 ("raw_sum"), which runs at world size 1
    too, where the layer's functions return at once. Rank `fail_rank` raises first
    instead: the others then wait in a collective, which run_ranks must end."""
    if group.rank == fail_rank:
        raise RuntimeError(f"rank {fail_rank} fails on purpose")
    d, dev = group.rank, group.device
    y = torch.arange(2 * 3 * 4, dtype=torch.float64, device=dev).reshape(2, 3, 4) + 100.0 * d
    full = gather_full(group, y)
    out = {
        "sync": sync_layers(group, y),
        "own": own(group, y),
        "full": full,
        "slice": slice_local(group, full, 3),
        "sum": all_reduce_sum(group, torch.tensor([1.0, float(d)], dtype=torch.float64,
                                                  device=dev)),
        "next": from_next(group, y[:, :1], y[:, :1]),
        "prev": to_next(group, y[:, -1:], y[:, -1:]),
    }
    if dist.is_initialized():  # the backend's own all-reduce, at world size 1 too
        t = torch.full((2,), float(d + 1), dtype=torch.float64, device=dev)
        t = t.cpu() if group.staged else t
        dist.all_reduce(t, group=group.pg)
        out["raw_sum"] = t
    return {k: v.cpu().numpy() for k, v in out.items()}
