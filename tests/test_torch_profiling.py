"""utils/profiling.py::whole_window, the test that decides whether a
device_time profiler window kept the device records of all its counted
calls, on made-up event lists (no card needed)."""

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
