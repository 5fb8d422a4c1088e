"""Per-stage wall clock and solver telemetry — port of
``tpufem/utils/profiling.py``'s ``StageTimer`` and ``solver_stats`` (the FEM
stage's ``spans`` and ``solve_ladder`` report blocks). tpufem's ``trace()``
wraps the JAX profiler and has no counterpart here: the port's device traces
come from torch.profiler (``tpufem_torch/profile_*.py``).
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
