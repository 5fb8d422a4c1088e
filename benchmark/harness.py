"""The benchmark of tpufem_torch: one run of one cell of BENCHMARK.json.

    python3 benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1

Everything that belongs to one configuration, traffic mix or metric is a
file of its own, found by the name BENCHMARK.json gives it:
benchmark/configs/<config>.json (the mesh, load case, solve and guarantee,
and which driver and reference serve it), benchmark/workloads/<traffic>.json
(read by benchmark/traffic.py), benchmark/drivers/<driver>.py (the calls
into the program), benchmark/reference/<reference>.py (the plain
reference), benchmark/metrics/<metric>.py (read(run) -> number or None).

A run: build the driver, solve one warm-up batch of other seeded wings, then
start batches back to back until --seconds have passed; the window ends with
the last batch. With --trace 1 the window's first batch runs under
torch.profiler. Once the window has closed and the peak memory is read, the
program is freed and the reference judges every wing of the window. The last
line of standard output is the result's JSON; the numbers compared, each
beside its limit, are the last lines of standard error.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import importlib
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "tpufem")  # top-level module names, compared whole
KINDS = ("configs", "workloads", "metrics", "drivers", "reference")


def fixed_caches(root: Path = ROOT) -> dict:
    """Every build and kernel cache at a fixed path inside the checkout (the
    port's own nvcc build goes to <checkout>/build)."""
    return {"TORCH_EXTENSIONS_DIR": str(root / "build" / "torch_extensions"),
            "TRITON_CACHE_DIR": str(root / "build" / "triton"),
            "CUDA_CACHE_PATH": str(root / "build" / "cuda_cache"),
            "USE_FLAX": "0"}


# ------------------------------------------------------------------ loader


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def list_data(bench: Path = BENCH) -> dict:
    """{kind: sorted names} of the data and code files a cell can name."""
    suffix = {"configs": ".json", "workloads": ".json"}
    out = {}
    for kind in KINDS:
        ext = suffix.get(kind, ".py")
        out[kind] = sorted(p.name[: -len(ext)] for p in (bench / kind).glob(f"*{ext}")
                           if p.name != "__init__.py")
    return out


def load_module(kind: str, name: str, bench: Path = BENCH):
    """benchmark/<kind>/<name>.py as a module (a metric's name may hold dots)."""
    path = bench / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file {path}")
    spec = importlib.util.spec_from_file_location(f"benchmark_{kind}_{name}".replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_cell(name: str, spec: dict | None = None, bench: Path = BENCH) -> dict:
    """The cell `name` of BENCHMARK.json with its configuration, traffic and
    metrics: {cell, config, traffic, end_to_end, per_layer}."""
    spec = spec if spec is not None else read_json(bench.parent / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: {sorted(cells)}")
    cell = cells[name]

    def mine(kind):
        return [m for m in spec[kind] if name in m.get("workloads", [name])]

    return {"cell": cell, "config": read_json(bench / "configs" / f"{cell['config']}.json"),
            "traffic": read_json(bench / "workloads" / f"{cell['traffic']}.json"),
            "end_to_end": mine("end_to_end"), "per_layer": mine("per_layer")}


# --------------------------------------------------------------------- run


class Run:
    """What a finished run hands the metric files."""

    def __init__(self, **kw):
        self.__dict__.update(kw)

    def span_batches(self) -> list:
        """The window's batches that ran untraced (all of them where every
        one did): the program's own wall-clock spans, unslowed by the profiler."""
        plain = [b for b in self.batches if not b["traced"]]
        return plain or self.batches


def sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run_cell(c: dict, seed: int, seconds: float, trace: bool, device, t_start: float,
             bench: Path = BENCH, wrap_driver=None, say=print) -> dict:
    """One run of the cell `c` (load_cell) on `device`: the result line's
    fields and the Run. `wrap_driver(driver)`, where given, takes the place
    of the driver (the tests break the timed path with it)."""
    import torch

    from benchmark import tracing
    from benchmark.traffic import WARMUP, Traffic

    cfg, traffic = c["config"], c["traffic"]
    drv_mod = load_module("drivers", cfg["driver"], bench)
    metrics = {m["name"]: load_module("metrics", m["name"], bench)
               for m in c["end_to_end"] + c["per_layer"]}
    t_built = time.perf_counter()
    driver = drv_mod.Driver(cfg, device)
    if wrap_driver is not None:
        driver = wrap_driver(driver)
    gen = Traffic(traffic, cfg, seed)
    t_warm = time.perf_counter()
    driver.warm_up(gen.batch(WARMUP))
    sync(device)
    setup_s = time.perf_counter() - t_start
    say(f"setup: {t_built - t_start:.3f} s to the driver, {t_warm - t_built:.3f} s to build "
        f"it, {t_start + setup_s - t_warm:.3f} s the warm-up batch", file=sys.stderr)

    batches, trace_out, win = [], None, None
    if trace:
        win = tracing.Window([e for m in metrics.values() for e in getattr(m, "ENTRIES", {})])
        win.start()
    t0 = t1 = time.perf_counter()
    while not batches or t1 - t0 < seconds:
        p4 = gen.batch(len(batches))
        traced = trace and not batches
        tb = time.perf_counter()
        with win if traced else contextlib.nullcontext():
            out = driver.solve(p4)
            sync(device)
        t1 = time.perf_counter()
        batches.append({"p4": p4, "out": out, "iters": int(out["iters"]), "lanes": len(p4),
                        "timing": out["timing"], "wall_s": t1 - tb, "traced": traced})
        if traced:
            trace_out = win.reduce()
            say(f"traced window {trace_out['window_s']:.3f} s, device busy "
                f"{trace_out['busy_s']:.3f} s, {len(trace_out['device'])} activities, "
                f"{trace_out['outside_s']:.6f} s of them outside it", file=sys.stderr)
            paused = time.perf_counter() - t1  # reading the profile is no part of the window
            t0, t1 = t0 + paused, t1 + paused
    window_s = t1 - t0
    cuda = torch.device(device).type == "cuda"
    memory_peak = int(torch.cuda.max_memory_allocated()) if cuda else 0
    say(f"window {window_s:.3f} s, {len(batches)} batches of {len(batches[0]['p4'])}, "
        f"setup {setup_s:.3f} s, peak {memory_peak} B", file=sys.stderr)

    del driver, out
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    checks, failed, attempted = judge(cfg, batches, device)
    say(f"reference: {time.perf_counter() - t_ref:.3f} s", file=sys.stderr)
    for i, b in enumerate(batches):
        say(f"batch {i}: {b['iters']} iterations, wall {b['wall_s']:.3f} s, "
            f"{ {k: round(v, 4) for k, v in b['timing'].items()} }, TRUE rel max "
            f"{b['rel'].max():.4e} (the program's {b['prog_rel_max']:.4e}, a lane's two "
            f"readings apart by up to {b['rel_disc']:.3e}), vm gap max "
            f"{b['vm_gap'].max():.3e}{', traced' if b['traced'] else ''}", file=sys.stderr)
    run = Run(cell=c["cell"], cfg=cfg, traffic=traffic, setup_s=setup_s, window_s=window_s,
              batches=batches, attempted=attempted, certified=attempted - failed,
              trace=trace_out, driver_module=drv_mod)
    names = c["per_layer"] if trace else c["end_to_end"]
    values = {}
    for m in names:
        v = metrics[m["name"]].read(run)
        if v is not None:
            values[m["name"]] = {"value": float(v), "unit": m["unit"]}
    correct = verdict(checks, failed, attempted)
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": memory_peak}
    line = {"correct": bool(correct), "attempted": attempted, "failed": failed,
            "metrics": values, "device": dev}
    if trace_out is not None:
        dev["busy_s"] = trace_out["busy_s"]
        dev["window_s"] = trace_out["window_s"]
        line["breakdown"] = {"device_ops": [[n[:160], s] for n, s in trace_out["top_ops"]],
                             "idle_gaps": [[n[:160], s] for n, s in trace_out["idle_gaps"]]}
    line["checks"] = checks
    return {"line": line, "run": run}


def verdict(checks: dict, failed: int, attempted: int) -> bool:
    """`correct`: some wings attempted, none failed, every number within its limit."""
    return attempted > 0 and failed == 0 and all(
        ck["value"] <= ck["limit"] for ck in checks.values())


def judge(cfg: dict, batches: list, device, ref=None):
    """The reference (`ref`, else the configuration's, built here in float64)
    over every wing of `batches`: ({name: {value, limit}}, wings failed, wings
    attempted). A wing fails where the program's lane did not converge, or
    the reference finds its TRUE relative residual or its von Mises gap over
    the limit."""
    import numpy as np
    import torch

    if ref is None:
        ref_mod = importlib.import_module(f"benchmark.reference.{cfg['reference']}")
        ref = ref_mod.Reference(cfg, device, torch.float64)
    rel_lim, vm_lim = cfg["limits"]["true_rel"], cfg["limits"]["vm_gap"]
    rel_max = gap_max = 0.0
    failed = attempted = 0
    for b in batches:
        out = b["out"]
        r = ref.judge(b["p4"], out["u"], out["vm"])
        conv = np.asarray(torch.as_tensor(out["converged"]).cpu(), bool)
        bad = ~conv | ~(r["rel"] <= rel_lim) | ~(r["vm_gap"] <= vm_lim)
        failed += int(bad.sum())
        attempted += len(bad)
        rel_max = max(rel_max, float(np.max(r["rel"])))
        gap_max = max(gap_max, float(np.max(r["vm_gap"])))
        b["rel"], b["vm_gap"] = r["rel"], r["vm_gap"]
        prog_rel = np.asarray(torch.as_tensor(out["rel"]).double().cpu())
        b["prog_rel_max"] = float(np.max(prog_rel))
        b["rel_disc"] = float(np.max(np.abs(r["rel"] - prog_rel)))
    as_num = lambda v: v if math.isfinite(v) else 1e300  # noqa: E731  (NaN fails its limit)
    return ({"true_rel_max": {"value": as_num(rel_max), "limit": rel_lim},
             "vm_gap_max": {"value": as_num(gap_max), "limit": vm_lim},
             "failed_wings": {"value": failed, "limit": 0}}, failed, attempted)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def power_limit() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def main(argv=None, t_start: float | None = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(description="one run of one cell of BENCHMARK.json")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    os.environ.update(fixed_caches())
    import torch

    c = load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < c["cell"]["chips"]:
        print(f"needs {c['cell']['chips']} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    out = run_cell(c, args.seed, args.seconds, bool(args.trace), "cuda", t_start)
    found = forbidden_modules()
    if found:
        print(f"forbidden modules loaded in this process: {found}", file=sys.stderr)
        return 4
    line = out["line"]
    line["device"]["power"] = power_limit()
    for k, ck in line["checks"].items():
        print(f"check {k} {ck['value']!r} limit {ck['limit']!r}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0
