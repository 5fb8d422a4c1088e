"""The readings that a cell's correctness limits are set from: the program's
certified path and the control, on the cell's own batches, in one process.

    python3 benchmark/control.py --workload NAME --seeds 1 2 ... \
        --control-seeds 7 8 9 [--out FILE]

For each seed, batch 0 of the cell's traffic (the timed size) is solved by
the program as the window solves it, and by the control (`control_solve`):
the program's own lower-precision path (the CG in float32 alone, judged on
its recurred residual), its von Mises recovered by the reference computed in
float32 in the program's place. Each batch goes through the harness's own
comparison (`harness.judge`, `harness.verdict`). Printed: each run's
`correct`, its largest TRUE relative residual and von Mises gap, and the two
readings of each number: the lower (the largest the program gives over the
seeds) and the upper (the smallest the control gives).
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark import harness  # noqa: E402


def control_solve(driver, ref32, p4) -> dict:
    """The control in the program's place: the driver's lower-precision
    solve, its von Mises recovered by the float32 reference `ref32`."""
    res = dict(driver.solve_control(p4))
    res["vm"] = ref32.vm(p4, res["u"])
    return res


def readings(c: dict, seeds, control_seeds, device, out=None) -> dict:
    import numpy as np
    import torch

    from benchmark.traffic import Traffic

    cfg = c["config"]
    drv = harness.load_module("drivers", cfg["driver"]).Driver(cfg, device)
    ref_mod = importlib.import_module(f"benchmark.reference.{cfg['reference']}")
    ref64 = ref_mod.Reference(cfg, device, torch.float64)
    ref32 = ref_mod.Reference(cfg, device, torch.float32)
    rows = []
    for kind, seed_list in (("program", seeds), ("control", control_seeds)):
        for seed in seed_list:
            p4 = Traffic(c["traffic"], cfg, seed).batch(0)
            t = time.perf_counter()
            res = drv.solve(p4) if kind == "program" else control_solve(drv, ref32, p4)
            harness.sync(device)
            t = time.perf_counter() - t
            b = {"p4": p4, "out": res}
            checks, failed, attempted = harness.judge(cfg, [b], device, ref=ref64)
            row = {"kind": kind, "seed": seed, "iters": int(res["iters"]), "seconds": t,
                   "correct": harness.verdict(checks, failed, attempted), "failed": failed,
                   "rel_max": checks["true_rel_max"]["value"],
                   "vm_gap_max": checks["vm_gap_max"]["value"], "apart_max": b["rel_disc"],
                   "rel": [float(f"{v:.6e}") for v in b["rel"]],
                   "program_rel": [float(f"{v:.6e}") for v in
                                   np.asarray(torch.as_tensor(res["rel"]).double().cpu())]}
            rows.append(row)
            print(json.dumps({k: v for k, v in row.items() if "rel" not in k or "max" in k}),
                  flush=True)
            if out is not None:
                out.write(json.dumps(row) + "\n")
    prog = [r for r in rows if r["kind"] == "program"]
    ctrl = [r for r in rows if r["kind"] == "control"]
    summary = {k: {"lower": max((r[k] for r in prog), default=None),
                   "upper": min((r[k] for r in ctrl), default=None)}
               for k in ("rel_max", "vm_gap_max")}
    summary["correct"] = {"program": [r["correct"] for r in prog],
                          "control": [r["correct"] for r in ctrl]}
    print(json.dumps({"summary": summary}), flush=True)
    return {"rows": rows, "summary": summary}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    import os

    os.environ.update(harness.fixed_caches())
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 3
    print(harness.power_limit(), flush=True)
    c = harness.load_cell(args.workload)
    with open(args.out, "a") if args.out else open(os.devnull, "w") as f:
        readings(c, args.seeds, args.control_seeds, "cuda", f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
