"""Per-stage wall clock, traces and solver telemetry — port of
``tpufem/utils/profiling.py``: ``StageTimer`` and ``solver_stats`` (the FEM
stage's ``spans`` and ``solve_ladder`` report blocks), and ``trace``, which
wraps torch.profiler where tpufem's wraps the JAX profiler (``bench.py
--trace DIR``). The port's profile scripts (``tpufem_torch/profile_*.py``)
share the two timers below: ``median_event_ms`` (CUDA events around one
call) and ``device_time`` (a kernel's own time from a profiler window).

The span recorder: ``span(name)`` times a stretch of the host's work and
``count(name, n)`` adds to a counter, both while recording is on
(``recording(True)``) and neither otherwise: then ``span`` hands back one
shared no-op context and ``count`` returns at once, with no allocation, no
clock read and no device work. A span is ``(name, start_ns, end_ns, depth)``
on ``time.time_ns()``, the clock torch.profiler stamps its events with, so a
span lies on a device trace's timeline as it is; ``depth`` is the number of
spans open around it. The recorder times the host alone: it adds no
synchronisation and no device work, on or off. ``drain()`` hands back what
was recorded and clears it. Spans nest on one thread; the recorder is the
process's.
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path


class _Recorder:
    def __init__(self):
        self.on = False
        self.emit = False  # each span also a torch.profiler.record_function range (trace)
        self.depth = 0
        self.spans: list[tuple[str, int, int, int]] = []
        self.counters: dict[str, int] = {}


_REC = _Recorder()
_OFF = contextlib.nullcontext()


class _Span:
    """One timed stretch; recorded on exit where recording is on."""

    __slots__ = ("name", "t0", "t1", "depth", "rf")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.depth = _REC.depth
        _REC.depth += 1
        self.rf = None
        if _REC.emit:
            import torch

            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.t1 = time.time_ns()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        _REC.depth -= 1
        if _REC.on:
            _REC.spans.append((self.name, self.t0, self.t1, self.depth))
        return False


def span(name: str):
    """Context manager: the span `name` while recording is on, else one shared
    no-op context. Callers keep `name` a constant (no string built per call)."""
    return _Span(name) if _REC.on else _OFF


def count(name: str, n: int) -> None:
    """Adds n to the counter `name` while recording is on."""
    if _REC.on:
        _REC.counters[name] = _REC.counters.get(name, 0) + int(n)


def recording(on: bool) -> bool:
    """Turns the recorder on or off; returns whether it was on."""
    was, _REC.on = _REC.on, bool(on)
    return was


def is_recording() -> bool:
    return _REC.on


def drain() -> dict:
    """{"spans": [(name, start_ns, end_ns, depth)] in order of start, outer
    before inner, "counters": {name: n}}: what was recorded since the last
    drain, which the recorder forgets."""
    out = {"spans": sorted(_REC.spans, key=lambda s: (s[1], s[3])),
           "counters": dict(_REC.counters)}
    _REC.spans, _REC.counters = [], {}
    return out


@contextlib.contextmanager
def trace(log_dir: Path | str | None):
    """torch.profiler trace context; no-op when log_dir is None.

    Profiles the CPU, and CUDA where a card is present, and on exit writes
    one trace file into log_dir through
    ``torch.profiler.tensorboard_trace_handler`` (``*.pt.trace.json``), which
    TensorBoard's profiler plugin and ``chrome://tracing`` read. The span
    recorder is on inside, and each span is a ``record_function`` range in
    the file; spans recorded inside are kept only where the recorder was
    already on."""
    if log_dir is None:
        yield
        return
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    was = (_REC.on, _REC.emit)
    try:
        with torch.profiler.profile(
                activities=acts, on_trace_ready=torch.profiler.tensorboard_trace_handler(
                    str(log_dir))):
            _REC.on = _REC.emit = True
            yield
    finally:
        _REC.on, _REC.emit = was
        if not was[0]:
            drain()


class StageTimer:
    """Accumulates named wall-clock spans; `report()` gives the elapsed_ms dict
    embedded into StepReport.extra. Each span is timed by the span recorder,
    and recorded there too while recording is on."""

    def __init__(self):
        self.spans: dict[str, float] = {}

    @contextlib.contextmanager
    def span(self, name: str):
        s = _Span(name)
        try:
            with s:
                yield
        finally:
            self.spans[name] = self.spans.get(name, 0.0) + (s.t1 - s.t0) * 1e-6

    def report(self) -> dict[str, float]:
        return {f"{k}_ms": round(v, 3) for k, v in self.spans.items()}


def solver_stats(iters: int, rel_residual: float, converged: bool) -> dict:
    return {"iters": int(iters), "rel_residual": float(rel_residual), "converged": bool(converged)}


def median_event_ms(fn, runs: int = 21) -> float:
    """Median of `runs` CUDA-event timings of fn() after a warm-up call, in
    ms. An event pair around one call carries its launch latency."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


L2_FLUSH_BYTES = 256 * 2**20  # five times the H100's 50 MB L2
_HEAD_S = 0.01  # the head of a profiler window, whose device records may be lost
_WINDOWS = 8  # windows taken before device_time gives up, each with twice the last's head


def whole_window(events, dev, n_kern: int, t0: float, reps: int, cold: bool) -> bool:
    """Whether a device_time window holds the device records of all its
    counted calls: `dev` (the device records from host time t0 on, n_kern
    of them of the timed kernel) holds at least one kernel record for each
    kernel launch the host recorded from t0 on, and its counts are whole
    per call. With `cold` the window is `reps` calls and then `reps` times
    (one L2 overwrite, a call), so every count of the calls is even per
    repetition and the overwrites add `reps` records: a window that lost
    the repeated half and kept the flushed one (reps kernel records where
    2 reps are due) fails here, whether or not the host's launch records
    of the kernel's own library are traced."""
    host = sum(1 for e in events if "LaunchKernel" in e.name and e.time_range.start >= t0)
    kernels = sum(1 for e in dev if not e.name.startswith(("Memcpy", "Memset")))
    per = 2 * reps if cold else reps
    return (kernels >= host and n_kern % per == 0
            and (len(dev) - (reps if cold else 0)) % per == 0)


def device_time(fn, kernel: str, reps: int = 20, cold: bool = False) -> dict:
    """The device's own time for the kernels whose name holds `kernel`, from
    one torch.profiler window of `reps` calls of fn() after a warm-up:
    ``device_us`` per such launch, ``launches`` of them per call, and
    ``activities`` (every device activity, so wrapper launches show) and
    ``all_device_us`` per call. Repeated calls find in the L2 cache what fits
    there; with `cold` the window goes on with `reps` more calls, a buffer
    larger than the L2 overwritten before each, and ``device_us_cold`` is
    the time per launch of those.

    In a process that has run for a while the tracer comes up late: the
    device records of the launches in a window's first ~100 us are lost (two
    large kernels, or a third of 20 small ones; their host-side launch records
    are there), and now and then all of a window's. So the window opens with
    _HEAD_S seconds of calls that are not counted, then a synchronize, and only
    the device records that start after that synchronize returned are read.
    The tracer can come up later still, past the head and into the counted
    calls, so a window is taken again, with twice the head (at most
    _WINDOWS windows), unless it is whole (whole_window). The result's
    "windows" counts the windows taken, and a reading that took more than one
    says so on stdout. Raises if no window was whole, or if the window saw no
    such kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda") if cold else None
    fn()
    torch.cuda.synchronize()
    for attempt in range(_WINDOWS):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            head_ends = time.perf_counter() + _HEAD_S * 2**attempt
            while time.perf_counter() < head_ends:
                fn()
            torch.cuda.synchronize()
            time.sleep(2e-4)  # device and host timestamps may differ by a few us
            for _ in range(reps):
                fn()
            for _ in range(reps if cold else 0):
                flush.zero_()
                fn()
            torch.cuda.synchronize()
        events = list(prof.events())
        # the synchronize after the head: the first one that began after a launch
        first = min((e.time_range.start for e in events if "LaunchKernel" in e.name),
                    default=float("-inf"))
        syncs = [e.time_range.end for e in events
                 if e.name == "cudaDeviceSynchronize" and e.time_range.start >= first]
        if not syncs:
            raise RuntimeError("the profiler recorded no cudaDeviceSynchronize: the head of "
                               "the window cannot be told from the calls that count")
        dev = sorted((e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
                      and e.time_range.start >= min(syncs)),
                     key=lambda e: e.time_range.start)
        kern = [e.time_range.elapsed_us() for e in dev if kernel in e.name]
        if dev and whole_window(events, dev, len(kern), min(syncs), reps, cold):
            break
    else:
        raise RuntimeError(f"{_WINDOWS} profiler windows in a row lost device records: the last "
                           f"held {len(dev)} activities, {len(kern)} of *{kernel}*, for {reps} "
                           f"calls")
    if not kern:
        raise RuntimeError(f"the profiler saw no kernel named *{kernel}* among "
                           f"{sorted({e.name for e in dev})}")
    if attempt:
        print(f"[device_time] *{kernel}*: whole in window {attempt + 1} of {_WINDOWS}",
              flush=True)
    out = {"windows": attempt + 1}
    if cold:  # the window's second half: the same activities and one overwrite per call
        half = len(kern) // 2
        out["device_us_cold"] = sum(kern[half:]) / (len(kern) - half)
        kern = kern[:half]
        warm = (len(dev) - reps) // 2
        # every activity of the flushed calls: the second half without its
        # overwrites, each the first record of its call's group
        per = (len(dev) - warm) // reps
        out["all_device_us_cold"] = sum(e.time_range.elapsed_us() for i, e in
                                        enumerate(dev[warm:]) if i % per) / reps
        dev = dev[:warm]
    return {"device_us": sum(kern) / len(kern), "launches": len(kern) / reps,
            "activities": len(dev) / reps,
            "all_device_us": sum(e.time_range.elapsed_us() for e in dev) / reps, **out}
