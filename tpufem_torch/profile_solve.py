"""Where the time of the DOF100K batched solve goes, on one CUDA card.

Solves chip_smoke.py's seeded batch (the second np.random.default_rng(42)
draw of PRD parameters, B=8, pressure 5 kPa, tol 1e-6) with WingStencilT:
three unprofiled solves for the phase seconds, then one under torch.profiler.
Prints the device's busy time in the profiled solve (sum of its device
activities), how many device activities the solve launched, and device time
by op; the full table goes to --out.

Usage: python -m tpufem_torch.profile_solve [--batch 8] [--out PATH]
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from tpufem_torch.fem.stencil_mg import WingStencilT
from tpufem_torch.mesher import DOF100K
from tpufem_torch.pipeline.types import PRD_RANGES

_NAMES = ("span_m", "chord_m", "sweep_deg", "thickness_ratio")


def seeded_batch(batch: int) -> np.ndarray:
    """The second seeded draw of PRD parameters (bench.py's timed batch)."""
    rng = np.random.default_rng(42)
    draws = [np.stack([rng.uniform(*PRD_RANGES[k], batch) for k in _NAMES], axis=1)
             for _ in range(2)]
    return draws[1].astype(np.float32)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--out", default=None, help="file for the full by-op table")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_solve: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    p4 = seeded_batch(args.batch)
    solver = WingStencilT(DOF100K, device=dev)
    for run in range(3):
        t0 = time.perf_counter()
        out = solver.solve(p4, tol=1e-6, maxiter=2000)
        wall = time.perf_counter() - t0
        tm = solver.last_timing
        print(f"[unprofiled {run}] iters {out.iters} wall {wall:.3f} s = {wall / args.batch:.4f} "
              f"s/wing: setup {tm['setup_s']:.3f} s, solve {tm['solve_s']:.3f} s "
              f"({tm['solve_s'] / max(out.iters, 1) * 1e3:.3f} ms per CG iteration), recover "
              f"{tm['recover_s']:.3f} s")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = solver.solve(p4, tol=1e-6, maxiter=2000)
        torch.cuda.synchronize()
    tm = solver.last_timing
    dev_events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_s = sum(e.time_range.elapsed_us() for e in dev_events) / 1e6
    print(f"[profiled] iters {out.iters}; setup {tm['setup_s']:.3f} s, solve "
          f"{tm['solve_s']:.3f} s (profiler on)")
    print(f"[profiled] device busy {busy_s:.3f} s in {len(dev_events)} device activities "
          f"({len(dev_events) / max(out.iters, 1):.0f} per CG iteration); "
          f"{busy_s / wall:.1%} of the last unprofiled wall")
    kern_b = {}
    for e in dev_events:
        if "strain_apply" in e.name:
            kern_b.setdefault(e.name, []).append(e.time_range.elapsed_us())
    for name, us in kern_b.items():
        print(f"[profiled] kernel B {name[:60]}: {len(us)} launches, {sum(us) / 1e3:.3f} ms, "
              f"{sum(us) / len(us):.2f} us per launch (all levels)")
    table = prof.key_averages().table(sort_by="self_device_time_total", row_limit=40)
    if args.out:
        with open(args.out, "w") as f:
            f.write(table)
    print("\n".join(table.splitlines()[:25]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
