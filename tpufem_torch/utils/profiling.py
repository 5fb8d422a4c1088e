"""Per-stage wall clock and solver telemetry — port of
``tpufem/utils/profiling.py``'s ``StageTimer`` and ``solver_stats`` (the FEM
stage's ``spans`` and ``solve_ladder`` report blocks). tpufem's ``trace()``
wraps the JAX profiler and has no counterpart here: the port's device traces
come from torch.profiler (``tpufem_torch/profile_*.py``), which share the two
timers below: ``median_event_ms`` (CUDA events around one call) and
``device_time`` (a kernel's own time from a profiler window).
"""

from __future__ import annotations

import contextlib
import time


class StageTimer:
    """Accumulates named wall-clock spans; `report()` gives the elapsed_ms dict
    embedded into StepReport.extra."""

    def __init__(self):
        self.spans: dict[str, float] = {}

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.spans[name] = self.spans.get(name, 0.0) + (time.perf_counter() - t0) * 1e3

    def report(self) -> dict[str, float]:
        return {f"{k}_ms": round(v, 3) for k, v in self.spans.items()}


def solver_stats(iters: int, rel_residual: float, converged: bool,
                 elapsed_s: float | None = None) -> dict:
    out = {"iters": int(iters), "rel_residual": float(rel_residual), "converged": bool(converged)}
    if elapsed_s is not None:
        out["elapsed_s"] = round(elapsed_s, 4)
        out["iters_per_s"] = round(iters / max(elapsed_s, 1e-9), 1)
    return out


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
