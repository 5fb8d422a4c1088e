"""Surrogate inference CLI — port of ``scripts/inference_gnn.py`` (reference
scripts/inference_gnn.py:91-423).

    python -m tpufem_torch.scripts.inference_gnn --split test --no_glb --device cuda

Per case: load checkpoint + config, forward, expm1 de-scaling, metrics,
pred_results.npz and inference_report.json per case, and an aggregate
data/models/inference_summary.json. The prediction/error GLBs are not ported
yet, so --no_glb is required.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np

from tpufem_torch.models.dataset import WingStressDataset, load_case_graph
from tpufem_torch.models.metrics import compute_metrics
from tpufem_torch.models.train import TrainConfig, Trainer
from tpufem_torch.pipeline.config import get_paths
from tpufem_torch.pipeline.geometry_stage import GLB_NOT_PORTED
from tpufem_torch.scripts import device_arg


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--data_root", default=None)
    ap.add_argument("--checkpoint", default=None, help="default: data/models/best_model.pt")
    ap.add_argument("--split", default="test", choices=["train", "val", "test", "all"])
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--no_glb", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the forward (default cuda; raises without one)")
    args = ap.parse_args(argv)
    if not args.no_glb:
        ap.error(GLB_NOT_PORTED)
    device = device_arg(args.device)

    paths = get_paths(args.data_root)
    ckpt = Path(args.checkpoint) if args.checkpoint else paths.models / "best_model.pt"
    ds = WingStressDataset(paths, seed=args.seed)
    case_ids = ds.case_ids if args.split == "all" else ds.splits[args.split]
    if not case_ids:
        print("no cases in split", args.split)
        return 1

    model, model_cfg = Trainer.load_checkpoint(ckpt, device=device)
    trainer = Trainer(TrainConfig(model=model_cfg), device=device)

    reports = []
    for i, cid in enumerate(case_ids, 1):
        t0 = time.perf_counter()
        g = load_case_graph(cid, paths)
        pred_log = trainer.predict(model, g)
        pred_pa = np.expm1(pred_log.astype(np.float64))
        metrics = compute_metrics(pred_log, g.stress_vm, g.loss_mask)

        fem_dir = paths.fem_case(cid)
        surf = dict(np.load(fem_dir / "surface_results.npz"))
        # persist predictions so the dashboard can overlay FEM vs AI
        # histograms without re-running the model (reference app.py:306-391)
        np.savez_compressed(
            fem_dir / "pred_results.npz",
            node_id=surf["node_id"],
            pred_pa=pred_pa.astype(np.float32),
            loss_mask=surf["loss_mask"],
        )
        report = {
            "case_id": cid,
            "metrics": metrics,
            "inference_time_ms": (time.perf_counter() - t0) * 1e3,
            "checkpoint": str(ckpt),
        }
        (fem_dir / "inference_report.json").write_text(json.dumps(report, indent=2))
        reports.append(report)
        print(f"[{i}/{len(case_ids)}] {cid} "
              f"MAE(masked) {metrics['masked_nodes']['mae_pa']/1e6:.3f} MPa")

    maes = [r["metrics"]["masked_nodes"]["mae_pa"] for r in reports]
    rels = [r["metrics"]["masked_nodes"]["rel_mae"] for r in reports]
    summary = {
        "split": args.split,
        "num_cases": len(reports),
        "mae_pa_masked_mean": float(np.mean(maes)),
        "mae_mpa_masked_mean": float(np.mean(maes)) / 1e6,
        "rel_mae_masked_mean": float(np.mean(rels)),
        "checkpoint": str(ckpt),
    }
    (paths.models / "inference_summary.json").write_text(json.dumps(summary, indent=2))
    print(f"summary: MAE(masked) {summary['mae_mpa_masked_mean']:.3f} MPa "
          f"rel {100*summary['rel_mae_masked_mean']:.2f}% over {len(reports)} cases")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
