"""Surrogate training CLI — port of ``scripts/train_gnn.py`` (reference
scripts/train_gnn.py:112-284).

    python -m tpufem_torch.scripts.train_gnn --epochs 100 --device cuda

Flags mirror the reference hparams (lr 1e-3, wd 1e-4, batch 4, epochs 100,
early-stop 20, plateau 10/x0.5, seed 42); --device is the port's (default
cuda; raises without one). Outputs under data/models/: best_model.pt(+json),
final_model.pt(+json), training_log.json, and a test-set evaluation with
Pa-scale all/masked metrics.
"""

from __future__ import annotations

import argparse
import json

from tpufem_torch.models.dataset import WingStressDataset
from tpufem_torch.models.sage import SAGEConfig
from tpufem_torch.models.train import TrainConfig, Trainer
from tpufem_torch.pipeline.config import get_paths
from tpufem_torch.scripts import device_arg


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--data_root", default=None)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--weight_decay", type=float, default=1e-4)
    ap.add_argument("--batch_size", type=int, default=4)
    ap.add_argument("--epochs", type=int, default=100)
    ap.add_argument("--early_stop", type=int, default=20)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--hidden", type=int, default=128)
    ap.add_argument("--num_layers", type=int, default=4)
    ap.add_argument("--dropout", type=float, default=0.1)
    ap.add_argument("--aggregate_impl", default="segment", choices=["segment", "pallas"],
                    help="kept so configs round-trip; both name the segment-sum kernels here")
    ap.add_argument("--clip_norm", type=float, default=1.0,
                    help="global-norm gradient clip (0 = off)")
    ap.add_argument("--max_seconds", type=float, default=0.0,
                    help="wall-clock budget for the fit loop (0 = unbounded); "
                         "finishes the current epoch then finalizes like an "
                         "early stop, recording stopped_reason")
    ap.add_argument("--ema", type=float, default=0.0,
                    help="EMA decay for eval/checkpoint params (0 = off)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of training (default cuda; raises without one)")
    args = ap.parse_args(argv)
    device = device_arg(args.device)

    paths = get_paths(args.data_root)
    ds = WingStressDataset(paths, seed=args.seed)
    train_g = ds.graphs("train")
    val_g = ds.graphs("val")
    test_g = ds.graphs("test")
    print(f"dataset: {len(train_g)} train / {len(val_g)} val / {len(test_g)} test")

    cfg = TrainConfig(
        lr=args.lr,
        weight_decay=args.weight_decay,
        batch_size=args.batch_size,
        max_epochs=args.epochs,
        early_stop_patience=args.early_stop,
        seed=args.seed,
        clip_norm=args.clip_norm,
        ema_decay=args.ema,
        max_seconds=args.max_seconds,
        model=SAGEConfig(
            hidden=args.hidden,
            num_layers=args.num_layers,
            dropout=args.dropout,
            aggregate_impl=args.aggregate_impl,
        ),
    )
    trainer = Trainer(cfg, device=device)
    out_dir = paths.models
    summary = trainer.fit(train_g, val_g, out_dir)

    model, _ = Trainer.load_checkpoint(out_dir / "best_model.pt", device=device)
    test_metrics = trainer.evaluate(model, test_g)
    print(
        f"test: loss {test_metrics['loss']:.5f}  "
        f"MAE(masked) {test_metrics['mae_pa_masked']/1e6:.3f} MPa  "
        f"rel {100*test_metrics['rel_mae_masked']:.2f}%"
    )
    summary["test"] = {k: v for k, v in test_metrics.items() if k != "per_case"}
    (out_dir / "training_log.json").write_text(json.dumps(summary, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
