"""utils/profiling.py::whole_window, the test that decides whether a
device_time profiler window kept the device records of all its counted
calls, on made-up event lists (no card needed); trace, tpufem's profiler
context on torch.profiler, on the CPU; and the span recorder: off, on,
nested, on the profiler's clock, inside trace and under StageTimer."""

import time
from types import SimpleNamespace

import pytest

from tpufem_torch.utils import profiling
from tpufem_torch.utils.profiling import whole_window

REPS = 20
T0 = 100.0  # host time at which the synchronize after the window's head returned


def _event(name, start):
    return SimpleNamespace(name=name, time_range=SimpleNamespace(start=start))


def _window(per_call, cold, lost=0, traced=True, head=5):
    """(events, dev, n_kern) of a window of REPS calls, each launching the
    device records `per_call` (kernel names, or "Memset (Device)"), and with
    `cold` REPS more calls each after an L2 overwrite ("fill"). The first
    `lost` device records after T0 are dropped, as a tracer that came up late
    drops them; `head` calls before T0 are on the host only. Without `traced`
    the host has no launch records of the calls' own kernels."""
    calls = [list(per_call)] * REPS + [["fill", *per_call]] * (REPS if cold else 0)
    host, dev, t = [], [], T0 + 1.0
    for _ in range(head):
        host += [_event("cudaLaunchKernel", T0 - 50.0) for _ in per_call]
    for names in calls:
        for name in names:
            api = "cudaMemsetAsync" if name.startswith("Memset") else "cudaLaunchKernel"
            if traced or name == "fill":
                host.append(_event(api, t))
            dev.append(_event(name, t + 0.5))
            t += 1.0
    dev = dev[lost:]
    return host + dev, dev, sum(1 for e in dev if e.name == "kern")


CASES = {
    # (device records per call, cold, lost records, host traces the calls, whole)
    "repeated-whole": (["kern"], False, 0, True, True),
    "repeated-lost-one": (["kern"], False, 1, True, False),
    "cold-whole": (["kern"], True, 0, True, True),
    # the repeated half lost, the flushed half kept: reps records of the
    # kernel where 2 reps are due
    "cold-lost-repeated-half": (["kern"], True, REPS, True, False),
    "cold-lost-repeated-half-untraced": (["kern"], True, REPS, False, False),
    # two launches per call: the flushed half alone has whole counts, so only
    # the host's launch records show the loss
    "cold-two-launches-lost-repeated-half": (["kern", "kern"], True, 2 * REPS, True, False),
    "cold-with-memset-whole": (["Memset (Device)", "kern"], True, 0, True, True),
}


@pytest.mark.parametrize("case", CASES)
def test_whole_window(case):
    per_call, cold, lost, traced, whole = CASES[case]
    events, dev, n_kern = _window(per_call, cold, lost, traced)
    assert whole_window(events, dev, n_kern, T0, REPS, cold) is whole


def test_trace_none_does_nothing(tmp_path, monkeypatch):
    from tpufem_torch.utils.profiling import trace

    monkeypatch.chdir(tmp_path)
    ran = []
    with trace(None):
        ran.append(1)
    assert ran == [1] and list(tmp_path.iterdir()) == []


def test_trace_writes_one_file_with_the_solve(tmp_path):
    """trace(dir) on the CPU: one torch.profiler trace file (chrome-trace JSON)
    holding the CPU events of a small stencil solve."""
    import json

    import numpy as np

    from tpufem_torch.fem.stencil_mg import WingStencilT
    from tpufem_torch.mesher import WingMeshResolution
    from tpufem_torch.utils.profiling import trace

    solver = WingStencilT(WingMeshResolution(4, 6, 2, te_floor_frac=0.006, spacing="le"),
                          device="cpu")
    with trace(tmp_path / "tr"):
        out = solver.solve(np.array([[1.2, 0.35, 10.0, 0.10]]), tol=1e-6, maxiter=200,
                           outer_f64=True)
    assert bool(out.converged.all())
    files = list((tmp_path / "tr").iterdir())
    assert len(files) == 1 and files[0].name.endswith(".pt.trace.json"), files
    events = json.loads(files[0].read_text())["traceEvents"]
    names = {e["name"] for e in events if e.get("cat") == "cpu_op"}
    assert {"aten::mul", "aten::sum"} <= names, sorted(names)[:20]
    # the solve's spans, each a record_function range; the recorder was off
    # before, so it is off again and kept none of them
    ranges = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert {"setup", "setup.coarsest_inverse", "cg", "cg.wait", "vcycle.L0",
            "recover"} <= ranges, sorted(ranges)
    assert not profiling.is_recording() and profiling.drain()["spans"] == []


@pytest.fixture
def recorder():
    """The span recorder, empty and off before and after the test."""
    profiling.recording(False)
    profiling.drain()
    yield profiling
    profiling.recording(False)
    profiling.drain()


def test_recorder_off_records_nothing(recorder):
    first = recorder.span("a")
    assert recorder.span("b") is first
    with recorder.span("a"):
        recorder.count("n", 3)
    assert recorder.drain() == {"spans": [], "counters": {}}


def test_recorder_on_nests_in_order_and_drains(recorder):
    assert recorder.recording(True) is False
    with recorder.span("outer"):
        with recorder.span("inner"):
            recorder.count("n", 2)
        with recorder.span("inner2"):
            recorder.count("n", 3)
    with recorder.span("next"):
        pass
    assert recorder.recording(False) is True
    out = recorder.drain()
    assert [(n, d) for n, _, _, d in out["spans"]] == [("outer", 0), ("inner", 1),
                                                       ("inner2", 1), ("next", 0)]
    (_, o0, o1, _), (_, i0, i1, _), (_, j0, j1, _), (_, n0, _, _) = out["spans"]
    assert o0 <= i0 <= i1 <= j0 <= j1 <= o1 <= n0
    assert out["counters"] == {"n": 5}
    assert recorder.drain() == {"spans": [], "counters": {}}


def test_span_encloses_the_profilers_event(recorder):
    """A span and torch.profiler's record of the op inside it share one
    clock: the op's [start_ns, end_ns] lies inside the span's."""
    import torch

    a = torch.randn(256, 256)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        recorder.recording(True)
        with recorder.span("mm"):
            a @ a
        recorder.recording(False)
    (_, s0, s1, _), = recorder.drain()["spans"]
    ops = [(e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events()
           if e.name() == "aten::mm"]
    assert len(ops) == 1
    assert s0 <= ops[0][0] <= ops[0][1] <= s1, (s0, ops, s1)


def test_stage_timer_times_through_the_recorder(recorder):
    timer = profiling.StageTimer()
    with timer.span("mesh"):
        time.sleep(0.002)
    recorder.recording(True)
    with timer.span("mesh"):
        time.sleep(0.002)
    recorder.recording(False)
    (name, s0, s1, depth), = recorder.drain()["spans"]
    assert (name, depth) == ("mesh", 0)
    rep = timer.report()
    assert list(rep) == ["mesh_ms"] and rep["mesh_ms"] >= 4.0
    assert rep["mesh_ms"] >= round((s1 - s0) * 1e-6, 3)
