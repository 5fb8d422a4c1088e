"""Sharded flagship: the 2.51M-DOF tet10 wing (DOF1M_TET10, 96x128x8) solved
by the span-sharded stencil-MG solver (tpufem_torch.parallel.shard_stencil)
over ranks of torch.distributed — port of ``scripts/sharded_flagship.py``,
with its flags, defaults and JSON keys (the same resolution, wing, pressure
and tolerance as tpufem's single-chip record, so the iteration counts
compare; tpufem's 8-CPU-device record is results/sharded_tet10_2p5mdof_cpu_mesh.json,
188 iterations).

Added flags: --ranks (default 2), --backend (nccl or gloo; default nccl on
the card, gloo on the CPU; several gloo ranks may share one card, NCCL needs
a card per rank) and --device (default cuda; raises without one). The JSON
goes to --out (default build/sharded_tet10_2p5mdof.json); its detail adds
the card as nvidia-smi names it, the backend, the world size, the exchange
share and each rank's peak device memory.

Example (one H100, two ranks sharing it):
    python -m tpufem_torch.scripts.sharded_flagship --ranks 2 --backend gloo
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from pathlib import Path

import torch

from tpufem_torch.mesher import WingMeshResolution
from tpufem_torch.parallel.launch import run_ranks
from tpufem_torch.parallel.meshes import default_backend
from tpufem_torch.scripts import device_arg

P4 = (1.6, 0.4, 20.0, 0.10)  # the single-chip flagship wing
TPUFEM_RECORD = (Path(__file__).resolve().parents[2] / "results"
                 / "sharded_tet10_2p5mdof_cpu_mesh.json")


def card_name() -> str | None:
    """The card's name and power limit as nvidia-smi prints them, or None."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else None
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


def tpufem_record_iters() -> int | None:
    """Iterations of tpufem's sharded record (8 CPU devices), for comparison."""
    try:
        return int(json.loads(TPUFEM_RECORD.read_text())["detail"]["iters"])
    except (OSError, ValueError, KeyError):
        return None


def flagship_rank(group, res: WingMeshResolution, tol: float, maxiter: int,
                  pressure: float) -> dict:
    """One rank of the sharded flagship solve (run_ranks' target): u on rank
    0 only, iters, rel, the solver's timing, the rank's peak memory and its
    kernel launches (every counter set to 0 first)."""
    from tpufem_torch.parallel.launch import kernel_counters
    from tpufem_torch.parallel.shard_stencil import ShardedStencilSolver

    counters = kernel_counters()
    for f in counters.values():
        f.launches = 0
    dev = group.device
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    solver = ShardedStencilSolver(res, group.world, element="tet10", dtype=torch.float64)
    u, iters, rel = solver.solve(P4, group, pressure=pressure, tol=tol, maxiter=maxiter)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None
    return {"u": u if group.rank == 0 else None, "iters": iters, "rel": rel,
            "timing": solver.last_timing, "wall_s": wall, "peak_bytes": peak,
            "n_shard": solver.plan.n_shard, "cells": solver.plan.cells,
            "device": str(dev), "launches": {k: f.launches for k, f in counters.items()}}


def run(argv=None):
    """The CLI's work: (the JSON record, rank 0's result with u)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="build/sharded_tet10_2p5mdof.json")
    ap.add_argument("--tol", type=float, default=1e-6)
    ap.add_argument("--maxiter", type=int, default=600)
    ap.add_argument("--pressure", type=float, default=5e3)
    ap.add_argument("--n_chord", type=int, default=96)
    ap.add_argument("--n_span", type=int, default=128)
    ap.add_argument("--n_thick", type=int, default=8)
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--backend", choices=("nccl", "gloo"), default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the ranks (default cuda; raises without one)")
    ap.add_argument("--timeout", type=float, default=1200.0,
                    help="seconds the ranks (and each collective) may take")
    args = ap.parse_args(argv)
    dev = device_arg(args.device)
    backend = args.backend or default_backend(dev)

    from tpufem_torch.fem.tet10_stencil import grid_meta2

    res = WingMeshResolution(args.n_chord, args.n_span, args.n_thick, 0.006, "le")
    dof = 3 * grid_meta2(res)["num_nodes"]
    print(f"sharded flagship: {dof} DOF tet10 ({args.n_chord}x{args.n_span}x{args.n_thick}) "
          f"over {args.ranks} ranks ({backend} on {dev.type})", flush=True)
    t0 = time.perf_counter()
    outs = run_ranks(flagship_rank, args.ranks, backend, dev.type, timeout_s=args.timeout,
                     args=(res, args.tol, args.maxiter, args.pressure))
    wall = time.perf_counter() - t0
    r0 = outs[0]
    tm = r0["timing"]
    conv = bool(r0["rel"] <= args.tol)
    rec = {
        "metric": "fem_tet10_2p5mdof_sharded_mg",
        "value": round(tm["solve_s"], 3),
        "unit": "s",
        "detail": {
            "dof": int(dof),
            "devices": args.ranks,
            "platform": "gpu" if dev.type == "cuda" else "cpu",
            "card": card_name() if dev.type == "cuda" else None,
            "backend": backend,
            "world_size": args.ranks,
            "iters": int(r0["iters"]),
            "rel_residual": float(r0["rel"]),
            "converged": conv,
            "tol": args.tol,
            "tpufem_sharded_record_iters": tpufem_record_iters(),
            "setup_s": round(tm["setup_s"], 3),
            "ms_per_iter": round(1e3 * tm["solve_s"] / max(r0["iters"], 1), 3),
            "exchange_share": round(tm["exchange_solve_s"] / max(tm["solve_s"], 1e-12), 4),
            "peak_bytes_per_rank": [o["peak_bytes"] for o in outs],
            "n_shard": r0["n_shard"],
            "cells": list(r0["cells"]),
            "wall_s_with_spawn": round(wall, 3),
            "solver": "span-sharded stencil MG-PCG (torch.distributed, layer exchanges, "
                      "sharded V-cycle, replicated coarse tail)",
            "cmd": f"python -m tpufem_torch.scripts.sharded_flagship --ranks {args.ranks} "
                   f"--backend {backend} --device {dev.type}",
        },
    }
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(rec, indent=1) + "\n")
    return rec, r0


def main(argv=None) -> int:
    rec, _ = run(argv)
    print(json.dumps(rec), flush=True)
    if not rec["detail"]["converged"]:
        raise SystemExit(f"NOT CONVERGED: rel {rec['detail']['rel_residual']:.3e} after "
                         f"{rec['detail']['iters']} iters")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
