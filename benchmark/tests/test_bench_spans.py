"""benchmark/spans.py: the readers of the program's spans and counters on a
made-up run (device activities, spans, counters), the idle time named by
the innermost span, and the recorder found in the program."""

import pytest

from benchmark import spans
from benchmark.harness import Run

MS = 1_000_000  # ns


def _batch(traced, iters, rec):
    return {"traced": traced, "iters": iters, "program": rec}


def _run():
    """A window of 100 ms, the traced batch's setup 0-40 ms (its coarsest
    inverse 5-35 ms), cg 40-95 ms (a V-cycle 41-59 ms, a wait 60-70 ms),
    recover 95-99 ms; the device busy 0-5, 35-45, 50-60, 70-96, 96.01-96.02
    and 99-99.5 ms."""
    traced = {"spans": [("setup", 0, 40 * MS, 0), ("setup.coarsest_inverse", 5 * MS, 35 * MS, 1),
                        ("cg", 40 * MS, 95 * MS, 0), ("vcycle.L0", 41 * MS, 59 * MS, 1),
                        ("cg.wait", 60 * MS, 70 * MS, 1), ("recover", 95 * MS, 99 * MS, 0)],
              "counters": {"cg.lane_steps": 10, "cg.lane_steps_useful": 9}}
    device = [(0, 5 * MS, "k"), (35 * MS, 45 * MS, "k"), (50 * MS, 60 * MS, "k"),
              (70 * MS, 96 * MS, "k"), (96 * MS + 10_000, 96 * MS + 20_000, "k"),
              (99 * MS, 99 * MS + MS // 2, "k")]
    plain = [{"spans": [("setup", 0, 30 * MS, 0), ("setup.coarsest_inverse", 0, 20 * MS, 1),
                        ("cg", 30 * MS, 80 * MS, 0), ("cg.wait", 40 * MS, 50 * MS, 1),
                        ("cg.wait", 60 * MS, 70 * MS, 1)],
              "counters": {"cg.lane_steps": 200, "cg.lane_steps_useful": 150}},
             {"spans": [("setup", 0, 30 * MS, 0), ("setup.coarsest_inverse", 0, 40 * MS, 1),
                        ("cg", 30 * MS, 90 * MS, 0), ("cg.wait", 40 * MS, 60 * MS, 1)],
              "counters": {"cg.lane_steps": 200, "cg.lane_steps_useful": 100}}]
    trace = {"device": device, "window_s": 0.1, "busy_s": 0.0}
    trace.update(spans.reduce(device, traced["spans"], 0, 100 * MS))
    return Run(batches=[_batch(True, 5, traced), _batch(False, 10, plain[0]),
                        _batch(False, 20, plain[1])], trace=trace)


def test_idle_is_named_by_the_innermost_span():
    run = _run()
    named = dict(run.trace["idle_spans"])
    assert named == {"setup.coarsest_inverse": pytest.approx(0.030),  # 5-35 ms
                     "vcycle.L0": pytest.approx(0.005),  # 45-50 ms, inside cg too
                     "cg.wait": pytest.approx(0.010),  # 60-70 ms
                     "launch gaps < 20 us": pytest.approx(10e-6),  # 96.00-96.01 ms
                     "recover": pytest.approx(0.00298),  # 96.02-99 ms
                     spans.NO_SPAN: pytest.approx(0.0005)}  # 99.5-100 ms
    assert run.trace["spans_outside_s"] == 0.0


def test_spans_outside_the_window_are_measured():
    out = spans.reduce([], [("cg", -2 * MS, 6 * MS, 0), ("recover", 6 * MS, 13 * MS, 0)],
                       0, 10 * MS)
    assert out["spans_outside_s"] == pytest.approx(3e-3)
    # one gap, the whole window, named by the span at its middle
    assert dict(out["idle_spans"]) == {"cg": pytest.approx(10e-3)}


def test_innermost_cuts_nested_spans():
    segs = spans.innermost([("a", 0, 10, 0), ("b", 2, 4, 1), ("c", 2, 3, 2), ("d", 12, 14, 0)])
    assert segs == [(0, 2, "a"), (2, 3, "c"), (3, 4, "b"), (4, 10, "a"), (12, 14, "d")]


def test_readers_by_hand():
    run = _run()
    # setup: idle 5-35 ms of the 100 ms window; cg: 45-50 and 60-70 ms
    assert spans.idle_in(run, "setup") == pytest.approx(30.0)
    assert spans.idle_in(run, "cg") == pytest.approx(15.0)
    # the untraced batches: 20 and 40 ms
    assert spans.coarsest_inverse_ms(run) == pytest.approx(30.0)
    # (50 - 20) / 10 and (60 - 20) / 20 ms an iteration
    assert spans.cg_host_ms(run) == pytest.approx((3.0 + 2.0) / 2)
    assert spans.lane_busy(run) == pytest.approx(100.0 * 250 / 400)


def test_readers_without_the_programs_record():
    """A program without the recorder (the batches' record None), and a run
    with no trace: every reader reads nothing."""
    run = _run()
    for b in run.batches:
        b["program"] = None
    run.trace = None
    for read in (spans.coarsest_inverse_ms, spans.cg_host_ms, spans.lane_busy):
        assert read(run) is None
    assert spans.idle_in(run, "setup") is None


def test_recorder_is_the_programs():
    rec = spans.recorder()
    from tpufem_torch.utils import profiling

    assert rec is profiling
    was = rec.recording(True)
    try:
        with rec.span("x"):
            rec.count("n", 1)
    finally:
        rec.recording(was)
    out = rec.drain()
    assert [s[0] for s in out["spans"]] == ["x"] and out["counters"] == {"n": 1}
