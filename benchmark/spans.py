"""The program's own spans and counters in a run, and the numbers the
benchmark reads from them.

The program records them itself (tpufem_torch.utils.profiling: `span`,
`count`, `recording`, `drain`), on the clock torch.profiler stamps its
events with (unix ns), so a span of the traced batch lies on the device
trace's timeline as it is. A run with --trace 1 turns the recorder on from
the window's start to its end and keeps each batch's drained record as the
batch's "program" ({"spans": [(name, start_ns, end_ns, depth)], "counters":
{name: n}}, None where the program has no recorder); `reduce` adds to the
traced window what the spans say of it. Every reader returns None where its
run has nothing to read: no trace, or a program without the recorder.

The spans WingStencilT.solve records: setup (its setup phase, where
last_timing["setup_s"] is taken) and inside it setup.coarsest_inverse (the
host f64 coarsest inverse and its copy to the card); cg (the solve phase,
solve_s) and inside it cg.wait (each host read that waits on the card) and
vcycle.L<i> (the V-cycle at level i, nested); recover (recover_s). Its
counters: cg.lane_steps (lanes x steps run, over every CG of the batch) and
cg.lane_steps_useful (the steps of lanes not yet converged in their CG and
above tol at their correction round's start).
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from statistics import fmean

from benchmark.tracing import GAP_NAMING_US

NO_SPAN = "no program span"


def recorder():
    """The program's span recorder (the module), or None where the program
    has none."""
    try:
        from tpufem_torch.utils import profiling
    except ImportError:
        return None
    return profiling if hasattr(profiling, "drain") else None


def reduce(device: list, spans: list, w0: int, w1: int) -> dict:
    """What the traced batch's spans say of its window [w0, w1): idle_spans,
    the window's idle time by the innermost span open at each gap's middle
    (gaps shorter than GAP_NAMING_US summed as launch gaps; the 10 largest
    sums), spans_outside_s, the most any span lies outside the window (a
    check of the shared clock), and the spans and bounds the readers use."""
    segs = innermost(spans)
    starts = [s for s, _, _ in segs]
    named = defaultdict(float)
    for g0, g1 in idle(device, w0, w1):
        sec = (g1 - g0) * 1e-9
        if sec * 1e6 < GAP_NAMING_US:
            named[f"launch gaps < {GAP_NAMING_US:g} us"] += sec
            continue
        mid = (g0 + g1) // 2
        i = bisect.bisect_right(starts, mid) - 1
        named[segs[i][2] if i >= 0 and segs[i][1] > mid else NO_SPAN] += sec
    outside = max((max(0, w0 - s0) + max(0, s1 - w1) for _, s0, s1, _ in spans), default=0)
    return {"idle_spans": sorted(named.items(), key=lambda kv: -kv[1])[:10],
            "spans_outside_s": outside * 1e-9, "spans": spans, "w0": w0, "w1": w1}


def idle(device: list, w0: int, w1: int) -> list:
    """[(start_ns, end_ns)] of the window in which no device activity runs
    (`device`: [(start_ns, end_ns, name)] sorted by start)."""
    gaps, cur = [], w0
    for s, e, _ in device:
        if s > cur:
            gaps.append((cur, min(s, w1)))
        cur = max(cur, e)
    if w1 > cur:
        gaps.append((cur, w1))
    return [(a, b) for a, b in gaps if b > a]


def innermost(spans: list) -> list:
    """[(start_ns, end_ns, name)]: the time the spans cover cut where any of
    them starts or ends, each piece named by the innermost span over it
    (spans of one thread nest)."""
    ev = sorted([(s0, 1, d, n) for n, s0, _, d in spans]
                + [(s1, 0, -d, n) for n, _, s1, d in spans])  # ends first, inner first
    out, stack, prev = [], [], None
    for t, start, d, name in ev:
        if stack and t > prev:
            out.append((prev, t, stack[-1][0]))
        if start:
            stack.append((name, d))
        else:
            stack.remove((name, -d))
        prev = t
    return out


def _union(intervals) -> list:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _overlap_ns(xs: list, ys: list) -> int:
    """Length of the intersection of two sorted lists of disjoint intervals."""
    i = j = tot = 0
    while i < len(xs) and j < len(ys):
        lo, hi = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        tot += max(0, hi - lo)
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return tot


def _program(run) -> list:
    """The program's records of the window's untraced batches (of all where
    every one was traced), or [] where the program recorded none."""
    return [b["program"] for b in run.span_batches() if b.get("program")]


def _span_s(rec: dict, name: str) -> float:
    return sum(s1 - s0 for n, s0, s1, _ in rec["spans"] if n == name) * 1e-9


def coarsest_inverse_ms(run):
    """The host f64 coarsest inverse and its copy to the card (the span
    setup.coarsest_inverse) a batch, ms, mean over the batches."""
    recs = _program(run)
    return 1e3 * fmean(_span_s(r, "setup.coarsest_inverse") for r in recs) if recs else None


def idle_in(run, name: str):
    """Share of the traced window, %, in which no device activity runs while
    the host is inside the span `name`."""
    t = run.trace
    if t is None or not t.get("spans"):
        return None
    inside = _union((s0, s1) for n, s0, s1, _ in t["spans"] if n == name)
    return 100.0 * _overlap_ns(idle(t["device"], t["w0"], t["w1"]), inside) * 1e-9 / t["window_s"]


def cg_host_ms(run):
    """The host's own time per CG iteration, ms: the span cg less the cg.wait
    spans (host reads waiting on the card) inside it, over the batch's
    iterations; mean over the batches."""
    rows = [(b["program"], b["iters"]) for b in run.span_batches() if b.get("program")]
    if not rows:
        return None
    return 1e3 * fmean((_span_s(r, "cg") - _span_s(r, "cg.wait")) / it for r, it in rows)


def lane_busy(run):
    """Share of the CG's lane steps, %, spent on lanes not yet converged and
    above tol at their round's start (cg.lane_steps_useful over
    cg.lane_steps, summed over the batches)."""
    recs = [r["counters"] for r in _program(run) if r["counters"].get("cg.lane_steps")]
    if not recs:
        return None
    return 100.0 * (sum(c["cg.lane_steps_useful"] for c in recs)
                    / sum(c["cg.lane_steps"] for c in recs))
