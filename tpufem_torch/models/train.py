"""Surrogate training loop — port of ``tpufem/models/train.py``: AdamW +
global-norm clipping + EMA + plateau LR + early stop + checkpoints.

Parity with reference scripts/train_gnn.py:44-288:
  AdamW(lr 1e-3, weight_decay 1e-4), ReduceLROnPlateau(patience 10, x0.5),
  batch_size 4 whole graphs, early stop patience 20, max 100 epochs,
  best_model checkpoint on val loss, training_log.json with per-epoch records.

How the port differs from tpufem's jitted, vmapped step:
  - Batching. tpufem vmapped a per-graph loss over a stacked (B, N, ...)
    batch. Here the B padded graphs of a batch are merged into one disjoint
    graph (node ids of graph b offset by b*N; padded edges keep edge_mask 0
    and fall into the dump segment), so every SAGE layer runs one segment sum
    per batch: kernel A twice forward, kernel C once backward, on the card.
    The loss is still the mean over graphs of each graph's masked MSE.
  - The optimizer is torch.optim.AdamW, which has optax.adamw's semantics
    (decoupled decay on every parameter, eps 1e-8 outside the square root);
    clipping is written out with optax.clip_by_global_norm's formula
    (scale by max_norm/norm only when norm >= max_norm), not torch's
    clip_grad_norm_ (max_norm/(norm+1e-6)).
  - Randomness: the shuffle order and the dropout draws come from
    torch.Generators seeded from cfg.seed; they are not JAX's PRNG streams.
  - Checkpoints are a torch state_dict (``*.pt``) with the same sidecar
    ``.json`` (epoch, val_loss, model_config in SAGEConfig's schema).
"""

from __future__ import annotations

import copy
import json
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from tpufem_torch.device import resolve_device
from tpufem_torch.models.graph import GraphData
from tpufem_torch.models.metrics import compute_metrics, masked_mse
from tpufem_torch.models.sage import GraphSAGE, SAGEConfig


@dataclass
class TrainConfig:
    lr: float = 1e-3
    weight_decay: float = 1e-4
    batch_size: int = 4
    max_epochs: int = 100
    early_stop_patience: int = 20
    plateau_patience: int = 10
    plateau_factor: float = 0.5
    min_lr: float = 1e-6
    seed: int = 42
    # global-norm gradient clipping (0 = off): at reference-scale graphs the
    # masked MSE occasionally spikes on extreme-stress validation wings
    clip_norm: float = 0.0
    # exponential moving average of params for eval/checkpointing (0 = off):
    # decouples model selection from single-step noise (Polyak averaging)
    ema_decay: float = 0.0
    # wall-clock budget for fit() (0 = unbounded): a bounded run finishes the
    # current epoch, then stops and finalizes like an early stop (the summary
    # records stopped_reason="time_budget")
    max_seconds: float = 0.0
    model: SAGEConfig = field(default_factory=SAGEConfig)


class GraphBatch(NamedTuple):
    """B padded graphs merged into one disjoint graph of B*N nodes."""

    x: torch.Tensor  # (B*N, in_dim)
    edge_index: torch.Tensor  # (2, B*E) int32, graph b's ids offset by b*N
    edge_mask: torch.Tensor  # (B*E,)
    y: torch.Tensor  # (B, N)
    loss_mask: torch.Tensor  # (B, N), loss_mask * node_mask
    node_mask: torch.Tensor  # (B, N)


class GraphSet:
    """The padded graphs of one split, stacked on a device (one tensor per
    field); ``batch(idx)`` merges the graphs idx into one GraphBatch."""

    def __init__(self, graphs: list[GraphData], device):
        def t(name):
            return torch.as_tensor(np.stack([getattr(g, name) for g in graphs]), device=device)

        self.x = t("x")  # (n, N, in_dim)
        self.edge_index = t("edge_index")  # (n, 2, E) int32
        self.edge_mask = t("edge_mask")  # (n, E)
        self.y = t("y")  # (n, N)
        self.node_mask = t("node_mask")
        self.loss_mask = t("loss_mask") * self.node_mask

    def __len__(self) -> int:
        return self.x.shape[0]

    def batch(self, idx) -> GraphBatch:
        idx = torch.as_tensor(idx, dtype=torch.long, device=self.x.device)
        B, N = len(idx), self.x.shape[1]
        offs = (torch.arange(B, device=self.x.device, dtype=torch.int32) * N)[:, None, None]
        ei = (self.edge_index[idx] + offs).permute(1, 0, 2).reshape(2, -1)
        return GraphBatch(
            x=self.x[idx].reshape(B * N, -1),
            edge_index=ei,
            edge_mask=self.edge_mask[idx].reshape(-1),
            y=self.y[idx],
            loss_mask=self.loss_mask[idx],
            node_mask=self.node_mask[idx],
        )


def clip_by_global_norm_(params, max_norm: float) -> torch.Tensor:
    """optax.clip_by_global_norm on the .grad of `params`, in place:
    g <- g / norm * max_norm when norm >= max_norm. Returns the norm."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))
    return norm


@torch.no_grad()
def ema_update_(ema: torch.nn.Module, model: torch.nn.Module, decay: float) -> None:
    """e <- decay * e + (1 - decay) * p for every parameter."""
    for e, p in zip(ema.parameters(), model.parameters()):
        e.copy_(decay * e + (1.0 - decay) * p)


class Trainer:
    """Fits a GraphSAGE on `device`, the card unless the caller asks for the
    CPU (cuda runs the CUDA kernels A and C)."""

    def __init__(self, cfg: TrainConfig, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        # plateau scheduling multiplies cfg.lr by this host-side scale
        self._lr_scale = 1.0

    # ------------------------------------------------------------- core steps
    def init(self) -> tuple[GraphSAGE, torch.optim.Optimizer]:
        """A model with weights drawn from cfg.seed, and its AdamW."""
        cfg = self.cfg
        model = GraphSAGE(cfg.model, generator=torch.Generator().manual_seed(cfg.seed),
                          device=self.device)
        opt = torch.optim.AdamW(model.parameters(), lr=cfg.lr, betas=(0.9, 0.999),
                                eps=1e-8, weight_decay=cfg.weight_decay)
        return model, opt

    @staticmethod
    def _loss_fn(model: GraphSAGE, batch: GraphBatch, generator=None) -> torch.Tensor:
        """Mean over the batch's graphs of each graph's masked MSE."""
        pred = model(batch.x, batch.edge_index, batch.edge_mask, generator=generator)
        return masked_mse(pred.reshape(batch.y.shape), batch.y, batch.loss_mask).mean()

    def _apply_grads(self, model, opt, ema) -> None:
        """The update from model's .grad: optax-style clip, AdamW at
        cfg.lr * lr_scale, then the EMA (tpufem's opt.update + EMA)."""
        cfg = self.cfg
        if cfg.clip_norm > 0:
            clip_by_global_norm_(model.parameters(), cfg.clip_norm)
        for group in opt.param_groups:
            group["lr"] = cfg.lr * self._lr_scale
        opt.step()
        if ema is not None:
            ema_update_(ema, model, cfg.ema_decay)

    def _train_step(self, model, opt, ema, batch: GraphBatch, generator) -> torch.Tensor:
        """One optimizer step; returns the batch loss (a device scalar)."""
        model.train()
        opt.zero_grad(set_to_none=True)
        loss = self._loss_fn(model, batch, generator)
        loss.backward()
        self._apply_grads(model, opt, ema)
        return loss.detach()

    @torch.no_grad()
    def _eval_set(self, model: GraphSAGE, gset: GraphSet) -> tuple[torch.Tensor, torch.Tensor]:
        """(preds (n, N), per-graph losses (n,)) in batches of cfg.batch_size."""
        model.eval()
        preds, losses = [], []
        for lo in range(0, len(gset), self.cfg.batch_size):
            batch = gset.batch(range(lo, min(lo + self.cfg.batch_size, len(gset))))
            pred = model(batch.x, batch.edge_index, batch.edge_mask).reshape(batch.y.shape)
            preds.append(pred)
            losses.append(masked_mse(pred, batch.y, batch.loss_mask))
        return torch.cat(preds), torch.cat(losses)

    # ---------------------------------------------------------------- fitting
    def fit(
        self,
        train_graphs: list[GraphData],
        val_graphs: list[GraphData],
        out_dir: Path | str,
        verbose: bool = True,
    ) -> dict:
        out_dir = Path(out_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        cfg = self.cfg
        model, opt = self.init()
        # EMA state starts at the init point; evaluated/checkpointed in place
        # of the raw iterate when ema_decay > 0
        ema = copy.deepcopy(model) if cfg.ema_decay > 0 else None
        shuffle_gen = torch.Generator().manual_seed(cfg.seed + 1)
        dropout_gen = torch.Generator(device=self.device).manual_seed(cfg.seed + 2)

        train_set = GraphSet(train_graphs, self.device)
        val_set = GraphSet(val_graphs, self.device)
        n_train = len(train_set)

        best_val = np.inf
        best_epoch = -1
        epochs_no_improve = 0
        plateau_no_improve = 0
        log: list[dict] = []
        stopped_reason = None
        t_start = time.time()

        for epoch in range(1, cfg.max_epochs + 1):
            t0 = time.time()
            order = torch.randperm(n_train, generator=shuffle_gen)
            epoch_losses = []
            for i in range(0, n_train, cfg.batch_size):
                batch = train_set.batch(order[i : i + cfg.batch_size])
                loss = self._train_step(model, opt, ema, batch, dropout_gen)
                epoch_losses.append(float(loss))

            eval_model = ema if ema is not None else model
            _, val_losses = self._eval_set(eval_model, val_set)
            val_loss = float(val_losses.mean())
            train_loss = float(np.mean(epoch_losses))
            epoch_time = time.time() - t0
            lr_now = cfg.lr * self._lr_scale

            improved = val_loss < best_val - 1e-12
            if improved:
                best_val = val_loss
                best_epoch = epoch
                epochs_no_improve = 0
                plateau_no_improve = 0
                self.save_checkpoint(out_dir / "best_model.pt", eval_model, epoch, val_loss)
            else:
                epochs_no_improve += 1
                plateau_no_improve += 1
                if plateau_no_improve > cfg.plateau_patience:
                    self._lr_scale = max(
                        self._lr_scale * cfg.plateau_factor, cfg.min_lr / cfg.lr
                    )
                    plateau_no_improve = 0

            log.append(
                {
                    "epoch": epoch,
                    "train_loss": train_loss,
                    "val_loss": val_loss,
                    "lr": lr_now,
                    "epoch_time_s": epoch_time,
                }
            )
            if verbose:
                print(
                    f"epoch {epoch:3d}  train {train_loss:.5f}  val {val_loss:.5f}"
                    f"  lr {lr_now:.2e}  {epoch_time:.2f}s",
                    flush=True,
                )
            if epochs_no_improve >= cfg.early_stop_patience:
                stopped_reason = "early_stop"
                break
            if cfg.max_seconds > 0 and time.time() - t_start > cfg.max_seconds:
                stopped_reason = "time_budget"
                break

        total = time.time() - t_start
        self.save_checkpoint(
            out_dir / "final_model.pt", ema if ema is not None else model, epoch, val_loss
        )
        summary = {
            "best_epoch": best_epoch,
            "best_val_loss": best_val,
            "epochs_run": len(log),
            "total_time_s": total,
            "stopped_reason": stopped_reason or "max_epochs",
            "log": log,
            "model_config": cfg.model.to_json_dict(),
        }
        (out_dir / "training_log.json").write_text(json.dumps(summary, indent=2))
        return summary

    # ------------------------------------------------------------ persistence
    def save_checkpoint(self, path: Path, model: GraphSAGE, epoch: int, val_loss: float) -> None:
        """state_dict at `path`, sidecar {epoch, val_loss, model_config} beside it."""
        path = Path(path)
        torch.save({k: v.detach().cpu() for k, v in model.state_dict().items()}, path)
        meta = {
            "epoch": epoch,
            "val_loss": val_loss,
            "model_config": model.config.to_json_dict(),
        }
        path.with_suffix(".json").write_text(json.dumps(meta, indent=2))

    @staticmethod
    def load_checkpoint(path: Path | str, device="cuda") -> tuple[GraphSAGE, SAGEConfig]:
        """Rebuild the model from the sidecar config and load its weights onto
        `device`, the card unless the caller asks for the CPU (the reference's
        self-describing checkpoint, inference_gnn.py:44-59)."""
        device = resolve_device(device)
        path = Path(path)
        meta = json.loads(path.with_suffix(".json").read_text())
        cfg = SAGEConfig.from_json_dict(meta["model_config"])
        model = GraphSAGE(cfg, device=device)
        model.load_state_dict(torch.load(path, map_location=device, weights_only=True))
        return model.eval(), cfg

    @torch.no_grad()
    def predict(self, model: GraphSAGE, graph: GraphData) -> np.ndarray:
        model.eval()
        pred = model(
            torch.as_tensor(graph.x, device=self.device),
            torch.as_tensor(graph.edge_index, device=self.device),
            torch.as_tensor(graph.edge_mask, device=self.device),
        )
        return pred.cpu().numpy()

    def evaluate(self, model: GraphSAGE, graphs: list[GraphData]) -> dict:
        preds, losses = self._eval_set(model, GraphSet(graphs, self.device))
        preds = preds.cpu().numpy()
        metrics = [
            compute_metrics(preds[i], g.stress_vm, g.loss_mask, g.node_mask)
            for i, g in enumerate(graphs)
        ]
        return {
            "loss": float(losses.mean()),
            "mae_pa_masked": float(np.mean([m["masked_nodes"]["mae_pa"] for m in metrics])),
            "mae_pa_all": float(np.mean([m["all_nodes"]["mae_pa"] for m in metrics])),
            "rel_mae_masked": float(np.mean([m["masked_nodes"]["rel_mae"] for m in metrics])),
            "per_case": metrics,
        }
