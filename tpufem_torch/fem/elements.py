"""Tet4 element setup: shape-function gradients and volumes — port of
``tpufem/fem/elements.py``.

For tet (x0..x3) with edge matrix J = [x1-x0; x2-x0; x3-x0] (rows),
V = det(J)/6 and the shape gradients are grad N_a = columns of inv(J) for
a=1..3, grad N_0 = -sum. The stiffness action never materializes Ke: with
gradients g[a] the element operator is H = sum_a g_a (x) u_a,
sigma = lam*tr(sym H)*I + 2*mu*sym(H), f_a = V * sigma @ g_a (kernel D).
"""

from __future__ import annotations

import torch


def tet4_setup(nodes: torch.Tensor, tets: torch.Tensor, tet_mask: torch.Tensor | None = None):
    """Per-element gradients (T,4,3) and volumes (T,) from nodes (N,3) and
    positively oriented tets (T,4). Degenerate tets (det == 0) and tets with
    tet_mask == 0 get zero gradients and volume."""
    x = nodes[tets]  # (T,4,3)
    e = x[:, 1:] - x[:, :1]  # (T,3,3) rows = edge vectors
    # adjugate / det for a 3x3 (cheaper + well-defined under masking)
    c0 = torch.linalg.cross(e[:, 1], e[:, 2])
    c1 = torch.linalg.cross(e[:, 2], e[:, 0])
    c2 = torch.linalg.cross(e[:, 0], e[:, 1])
    det = (e[:, 0] * c0).sum(dim=1)
    vols = det / 6.0
    safe_det = torch.where(det.abs() > 0, det, torch.ones_like(det))
    g123 = torch.stack([c0, c1, c2], dim=1) / safe_det[:, None, None]  # row a-1 = grad N_a
    grads = torch.cat([-g123.sum(dim=1, keepdim=True), g123], dim=1)  # (T,4,3)

    valid = det.abs() > 0
    if tet_mask is not None:
        valid = valid & (tet_mask > 0)
    grads = torch.where(valid[:, None, None], grads, torch.zeros_like(grads))
    vols = torch.where(valid, vols, torch.zeros_like(vols))
    return grads, vols
