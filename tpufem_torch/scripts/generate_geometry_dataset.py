"""Batch geometry generation — port of ``scripts/generate_geometry_dataset.py``
(reference scripts/generate_geometry_dataset.py:84-181): seeded uniform
sampling in the PRD ranges, sequential case ids 001..N overriding the hash,
params.csv + manifest geometry_index + last_run summary.

    python -m tpufem_torch.scripts.generate_geometry_dataset --count 16 --seed 7

Each case also gets the gray preview wing_viz.glb unless --no_glb.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from tpufem_torch.pipeline.config import get_paths
from tpufem_torch.pipeline.geometry_stage import run_geometry_case
from tpufem_torch.pipeline.reports import append_csv, append_manifest_index, update_manifest
from tpufem_torch.pipeline.types import PRD_RANGES, WingParams


def sample_params(rng: np.random.Generator) -> WingParams:
    return WingParams(
        span_m=float(rng.uniform(*PRD_RANGES["span_m"])),
        chord_m=float(rng.uniform(*PRD_RANGES["chord_m"])),
        sweep_deg=float(rng.uniform(*PRD_RANGES["sweep_deg"])),
        thickness_ratio=float(rng.uniform(*PRD_RANGES["thickness_ratio"])),
    )


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--count", type=int, default=10)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--data_root", type=str, default=None)
    ap.add_argument("--sequential_ids", action="store_true", default=True)
    ap.add_argument("--hash_ids", dest="sequential_ids", action="store_false")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--no_glb", action="store_true")
    args = ap.parse_args(argv)

    paths = get_paths(args.data_root).ensure()
    rng = np.random.default_rng(args.seed)
    t0 = time.time()
    n_ok = 0
    entries = []
    for i in range(1, args.count + 1):
        params = sample_params(rng)
        case_id = f"{i:03d}" if args.sequential_ids else None
        rep = run_geometry_case(
            params, paths, case_id=case_id, force=args.force, make_glb=not args.no_glb
        )
        n_ok += rep.status == "success"
        print(f"[{i}/{args.count}] {rep.case_id} {rep.status}"
              + (f" ({rep.failure_reason})" if rep.failure_reason else ""))
        row = {"case_id": rep.case_id, **params.as_dict(), "status": rep.status}
        append_csv(paths.data / "params.csv", row)
        entries.append(row)

    update_manifest(
        paths.manifest,
        "geometry_last_run",
        {
            "count": args.count,
            "success": n_ok,
            "seed": args.seed,
            "elapsed_s": time.time() - t0,
        },
    )
    append_manifest_index(paths.manifest, "geometry_index", entries)
    print(f"done: {n_ok}/{args.count} success in {time.time()-t0:.1f}s")
    return 0 if n_ok == args.count else 1


if __name__ == "__main__":
    raise SystemExit(main())
