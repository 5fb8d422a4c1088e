"""utils/profiling.py::whole_window, the test that decides whether a
device_time profiler window kept the device records of all its counted
calls, on made-up event lists (no card needed); and trace, tpufem's
profiler context on torch.profiler, on the CPU."""

from types import SimpleNamespace

import pytest

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
