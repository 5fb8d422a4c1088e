"""Masked loss (torch) and Pa-scale surrogate metrics (numpy) — port of
``tpufem/models/metrics.py``: the training loss is the MSE over loss-masked
nodes; the metrics are MAE, RMSE, max error and MAE relative to the true max
stress, for all real nodes and for the loss-masked nodes."""

from __future__ import annotations

import numpy as np
import torch


def masked_mse(pred, target, mask):
    """Mean squared error over masked nodes along the last axis (one value
    per graph of a (B, N) batch); 0 where the mask is empty."""
    num = (mask * (pred - target) ** 2).sum(dim=-1)
    den = mask.sum(dim=-1)
    return torch.where(den > 0, num / torch.clamp(den, min=1.0), torch.zeros_like(num))


def _subset_metrics(pred_pa: np.ndarray, true_pa: np.ndarray) -> dict:
    err = np.abs(pred_pa - true_pa)
    if len(err) == 0:
        return {"mae_pa": 0.0, "rmse_pa": 0.0, "max_err_pa": 0.0, "rel_mae": 0.0}
    mae = float(err.mean())
    return {
        "mae_pa": mae,
        "rmse_pa": float(np.sqrt((err**2).mean())),
        "max_err_pa": float(err.max()),
        "rel_mae": float(mae / max(float(true_pa.max()), 1e-12)),
    }


def compute_metrics(pred_log, true_stress_pa, loss_mask, node_mask=None) -> dict:
    """pred_log: (N,) log1p-space prediction; true_stress_pa: (N,) raw Pa."""
    pred_pa = np.expm1(np.asarray(pred_log, dtype=np.float64))
    true_pa = np.asarray(true_stress_pa, dtype=np.float64)
    real = (
        np.asarray(node_mask) > 0
        if node_mask is not None
        else np.ones(len(true_pa), dtype=bool)
    )
    masked = real & (np.asarray(loss_mask) > 0)
    return {
        "all_nodes": _subset_metrics(pred_pa[real], true_pa[real]),
        "masked_nodes": _subset_metrics(pred_pa[masked], true_pa[masked]),
    }
