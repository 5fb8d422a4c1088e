"""The traced window of a `--trace 1` run: one batch under torch.profiler,
its device activities and the CUDA runtime calls on the host (the host's
own operations are not recorded: recording them triples a batch's host
time), and the arguments of every launch of the kernel entry points the
cell's metrics name (their ctypes functions are wrapped for the window and
restored after it). The window's bounds are the host's clock (unix ns, the
profiler's time base) around the batch, which ends in a synchronize.

Kept in memory and reduced after the batch: the device activities (start,
end, name), the launches, and the runtime calls that the idle gaps are
named by. Nothing is written to disk.
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict

import torch

from benchmark.yardstick import busy_s

GAP_NAMING_US = 20.0  # idle gaps shorter than this are summed as launch gaps


class Window:
    """start() before the window, then a context manager around the traced
    batch, then reduce()."""

    def __init__(self, entries):
        self.entries = sorted(set(entries))
        self.launches = defaultdict(list)
        self.count = 0

    def _wrap(self):
        from tpufem_torch.ops.kernels import load_kernels

        self.lib = load_kernels()
        self.saved = {}
        for name in self.entries:
            if not hasattr(self.lib, name):
                continue
            orig = getattr(self.lib, name)
            log = self.launches[name]

            def wrapped(*args, _orig=orig, _log=log):
                # the arguments, numbers only, and the launch's sequence number last
                _log.append(tuple(a if isinstance(a, (int, float)) else None for a in args)
                            + (self.count,))
                self.count += 1
                return _orig(*args)

            self.saved[name] = orig
            setattr(self.lib, name, wrapped)

    def start(self) -> None:
        """Wrap the entry points and start the profiler (seconds of work the
        first time in a process: before the window)."""
        self._wrap()
        self.prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
        self.prof.__enter__()
        # a profiler window can lose its first ~100 us of device records
        torch.cuda.synchronize()
        time.sleep(0.05)

    def __enter__(self):
        torch.cuda.synchronize()
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        self.t1 = time.time_ns()
        for name, orig in self.saved.items():
            setattr(self.lib, name, orig)
        if exc[0] is not None:
            self.prof.__exit__(*exc)
        return False

    def reduce(self) -> dict:
        """Stop the profiler and read it (after the window: stopping it
        gathers every record, seconds of work)."""
        self.prof.__exit__(None, None, None)
        return reduce(self.prof.profiler.kineto_results.events(), dict(self.launches),
                      self.t0, self.t1)


def reduce(events, launches: dict, w0: int, w1: int) -> dict:
    """{device: [(start_ns, end_ns, name)] clipped to the window [w0, w1),
    busy_s, window_s, launches, top_ops, idle_gaps, outside (device seconds
    the profile holds outside the window: a check of the time base)}."""
    cuda = torch.autograd.DeviceType.CUDA
    dev, host = [], []
    for e in events:
        if e.device_type() == cuda:
            if not e.is_user_annotation():
                dev.append((e.start_ns(), e.end_ns(), e.name()))
        elif not e.is_user_annotation() and e.end_ns() > e.start_ns():
            host.append((e.start_ns(), e.end_ns(), e.name()))
    outside = sum(max(0, min(e, w0) - s) + max(0, e - max(s, w1)) for s, e, _ in dev) * 1e-9
    dev = sorted((max(s, w0), min(e, w1), n) for s, e, n in dev if e > w0 and s < w1)
    per_op = defaultdict(float)
    for s, e, n in dev:
        per_op[n] += (e - s) * 1e-9
    top = sorted(per_op.items(), key=lambda kv: -kv[1])[:10]
    return {"device": dev, "busy_s": busy_s([(s, e) for s, e, _ in dev]),
            "window_s": (w1 - w0) * 1e-9, "launches": launches, "top_ops": top,
            "idle_gaps": idle_gaps(dev, host, w0, w1), "outside_s": outside}


def idle_gaps(dev, host, w0: int, w1: int) -> list:
    """The window's idle time on the device, by what the host was doing: each
    gap of at least GAP_NAMING_US named by the innermost CUDA runtime call
    running at its middle ("host, no CUDA call" where none is: Python,
    PyTorch's dispatch, host numpy), the shorter gaps summed as "launch
    gaps"; the 10 largest sums."""
    gaps, cur = [], w0
    for s, e, _ in dev:
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, e)
    if w1 > cur:
        gaps.append((cur, w1))
    host = sorted(host)
    starts = [h[0] for h in host]
    named = defaultdict(float)
    for g0, g1 in gaps:
        sec = (g1 - g0) * 1e-9
        if sec * 1e6 < GAP_NAMING_US:
            named[f"launch gaps < {GAP_NAMING_US:g} us"] += sec
            continue
        mid = (g0 + g1) // 2
        name = "host, no CUDA call"
        # host operations nest on a thread: the innermost one holding `mid`
        # is the latest-starting one that has not ended
        i = bisect.bisect_right(starts, mid) - 1
        for j in range(i, max(i - 500, -1), -1):
            if host[j][1] >= mid:
                name = host[j][2]
                break
        named[name] += sec
    return sorted(named.items(), key=lambda kv: -kv[1])[:10]
