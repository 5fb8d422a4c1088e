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


def device_time(fn, kernel: str, reps: int = 20, cold: bool = False) -> dict:
    """The device's own time for the kernels whose name holds `kernel`, from
    one torch.profiler window of `reps` calls of fn() after a warm-up:
    ``device_us`` per such launch, ``launches`` of them per call, and
    ``activities`` (every device activity, so wrapper launches show) and
    ``all_device_us`` per call. Repeated calls find in the L2 cache what fits
    there; with `cold` the window goes on with `reps` more calls, a buffer
    larger than the L2 overwritten before each, and ``device_us_cold`` is
    the time per launch of those. A window that recorded no device activity
    at all is taken again, at most twice; raises if the window saw no such
    kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda") if cold else None
    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # a window now and then comes back without any device record
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            for _ in range(reps if cold else 0):
                flush.zero_()
                fn()
            torch.cuda.synchronize()
        dev = sorted((e for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA),
                     key=lambda e: e.time_range.start)
        if dev:
            break
    kern = [e.time_range.elapsed_us() for e in dev if kernel in e.name]
    if not kern:
        raise RuntimeError(f"the profiler saw no kernel named *{kernel}*: "
                           f"{sorted({e.name for e in dev})}")
    out = {}
    if cold:  # the window's second half: the same activities and one overwrite per call
        half = len(kern) // 2
        out["device_us_cold"] = sum(kern[half:]) / (len(kern) - half)
        kern = kern[:half]
        dev = dev[:(len(dev) - reps) // 2]
    return {"device_us": sum(kern) / len(kern), "launches": len(kern) / reps,
            "activities": len(dev) / reps,
            "all_device_us": sum(e.time_range.elapsed_us() for e in dev) / reps, **out}
