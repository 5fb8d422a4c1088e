"""Batch meshing — port of ``scripts/generate_mesh_dataset.py`` (reference
scripts/generate_mesh_dataset.py:40-145): reads success rows from params.csv,
meshes each case, appends mesh.csv and the manifest mesh_index. Resumable:
cache hits skip completed cases.

    python -m tpufem_torch.scripts.generate_mesh_dataset \\
        --n_chord 64 --n_span 80 --n_thick 6 --te_floor_frac 0.006 --spacing le

Each case gets mesh.npz, boundary_sets.json, the debug surf_sets.glb and its
report.
"""

from __future__ import annotations

import argparse
import time

from tpufem_torch.mesher import MEDIUM, WingMeshResolution
from tpufem_torch.pipeline.config import get_paths
from tpufem_torch.pipeline.mesh_stage import run_mesh_case
from tpufem_torch.pipeline.reports import (
    append_csv,
    append_manifest_index,
    read_csv_rows,
    update_manifest,
)
from tpufem_torch.pipeline.types import WingParams


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--data_root", type=str, default=None)
    ap.add_argument("--limit", type=int, default=0)
    ap.add_argument("--n_chord", type=int, default=MEDIUM.n_chord)
    ap.add_argument("--n_span", type=int, default=MEDIUM.n_span)
    ap.add_argument("--n_thick", type=int, default=MEDIUM.n_thick)
    ap.add_argument("--te_floor_frac", type=float, default=MEDIUM.te_floor_frac,
                    help="trailing-edge half-thickness floor (fraction of chord); "
                         "needed for well-conditioned 100k-DOF-class meshes")
    ap.add_argument("--spacing", choices=("cosine", "le"), default=MEDIUM.spacing)
    ap.add_argument("--y_tol", type=float, default=1e-4)
    ap.add_argument("--nz_min", type=float, default=0.2)
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    paths = get_paths(args.data_root).ensure()
    res = WingMeshResolution(args.n_chord, args.n_span, args.n_thick,
                             te_floor_frac=args.te_floor_frac, spacing=args.spacing)
    rows = [r for r in read_csv_rows(paths.data / "params.csv") if r["status"] == "success"]
    # params.csv is append-only — resumed runs append duplicate rows for
    # cached cases; keep the LAST row per case id
    by_id = {r["case_id"]: r for r in rows}
    rows = list(by_id.values())
    # keep only cases whose geometry artifacts exist (reference :58-62)
    rows = [r for r in rows if (paths.geometry_case(r["case_id"]) / "params.json").exists()]
    if args.limit:
        rows = rows[: args.limit]

    t0 = time.time()
    n_ok = 0
    entries = []
    for i, r in enumerate(rows, 1):
        params = WingParams(
            span_m=float(r["span_m"]),
            chord_m=float(r["chord_m"]),
            sweep_deg=float(r["sweep_deg"]),
            thickness_ratio=float(r["thickness_ratio"]),
        )
        rep = run_mesh_case(
            params, r["case_id"], paths, resolution=res,
            force=args.force, y_tol=args.y_tol, nz_min=args.nz_min,
        )
        n_ok += rep.status == "success"
        print(f"[{i}/{len(rows)}] {rep.case_id} {rep.status}"
              + (f" ({rep.failure_reason})" if rep.failure_reason else ""))
        row = {
            "case_id": rep.case_id,
            "status": rep.status,
            "num_nodes": rep.extra.get("num_nodes", 0),
            "num_tets": rep.extra.get("num_tets", 0),
            "quality_ok_ratio": rep.extra.get("quality", {}).get("quality_ok_ratio", 0.0),
        }
        append_csv(paths.data / "mesh.csv", row)
        entries.append(row)

    update_manifest(
        paths.manifest,
        "mesh_last_run",
        {
            "count": len(rows),
            "success": n_ok,
            "resolution": list(res.key),
            "elapsed_s": time.time() - t0,
        },
    )
    append_manifest_index(paths.manifest, "mesh_index", entries)
    print(f"done: {n_ok}/{len(rows)} success in {time.time()-t0:.1f}s")
    return 0 if n_ok == len(rows) else 1


if __name__ == "__main__":
    raise SystemExit(main())
