"""What the metric files of benchmark/metrics/ share: each reads one
number from a finished run (a harness.Run), or None where its run has
nothing to read (no trace, no launch of its kernel)."""

from __future__ import annotations

from statistics import fmean

from benchmark import yardstick as ys


def wings_per_s(run) -> float:
    """Certified wings over the window's seconds."""
    return run.certified / run.window_s


def setup_ms(run) -> float:
    """The program's setup of a batch (WingStencilT.last_timing), mean
    over the window's batches, in ms."""
    return 1e3 * fmean(b["timing"]["setup_s"] for b in run.span_batches())


def cg_iters(run) -> float:
    """CG iterations a batch, mean over the window's batches."""
    return fmean(b["iters"] for b in run.batches)


def device_idle(run):
    """Share of the traced window, in %, in which no device activity ran."""
    if run.trace is None:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])


def step_mfu(run) -> float:
    """The CG iteration's bound (the driver's step_cost at the batch's
    lanes) over its wall time (the program's solve seconds over its
    iterations), in %, summed over the window's batches."""
    bound = sum(b["iters"] * run.driver_module.step_cost(run.cfg, b["lanes"]).bound_s()
                for b in run.span_batches())
    return 100.0 * bound / sum(b["timing"]["solve_s"] for b in run.span_batches())


def roofline(run, entries: dict, kernel: str, cost_of):
    """Sum of the bounds of the traced launches of `entries` ({entry point:
    dtype}) over the device time of the activities whose name holds
    `kernel`, in %. The profiler may lose the window's first device records:
    the launches are then matched from the end. None where the window holds
    no such launch or more activities than launches."""
    if run.trace is None:
        return None
    launches = launches_in_order(run.trace["launches"], entries)
    acts = [(s, e) for s, e, n in run.trace["device"] if kernel in n]
    if not launches or not acts or len(acts) > len(launches):
        return None
    # one thread launches them and one stream runs them, in that order
    bound = sum(cost_of(args, dtype).bound_s() for args, dtype in launches[-len(acts):])
    return 100.0 * bound / (sum(e - s for s, e in acts) * 1e-9)


def launches_in_order(logged: dict, entries: dict) -> list:
    """[(args, dtype)] of the entries' launches in the order they were made
    (each logged launch carries its sequence number last)."""
    out = [(args[:-1], dtype, args[-1]) for name, dtype in entries.items()
           for args in logged.get(name, [])]
    return [(a, d) for a, d, _ in sorted(out, key=lambda t: t[2])]


def b_cost(args, dtype) -> ys.Cost:
    """Kernel B's entry (g, vol, u, free, y, B, NI, NK, NJ, ...)."""
    B, NI, NK, NJ = args[5:9]
    return ys.b_apply(NI - 1, NK - 1, NJ - 1, B, dtype)

