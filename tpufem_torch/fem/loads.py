"""Equivalent nodal loads from surface pressure — port of
``tpufem/fem/loads.py``.

Per loaded face the force is p * A * (-n_hat), split 1/3 to each vertex;
since A * n_hat = 0.5 * (e1 x e2) for an outward-wound triangle, the
per-vertex load is -p/6 * cross(e1, e2). tpufem's segment_sum becomes
kernel E over the CSR plan of the faces' vertex ids.
"""

from __future__ import annotations

import torch

from tpufem_torch.ops.csr_segment_sum import CsrPlan, csr_segment_sum


def pressure_loads(nodes: torch.Tensor, faces: torch.Tensor, pressure: float,
                   plan: CsrPlan) -> torch.Tensor:
    """Nodal load vector (N,3) from uniform pressure on outward-oriented faces
    (F,3); `plan` is ``csr_plan(faces, num_nodes)``."""
    v = nodes[faces]  # (F,3,3)
    area_vec = 0.5 * torch.linalg.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0])  # A * n_hat
    f_vert = (-pressure / 3.0) * area_vec  # per-vertex share
    f3 = f_vert[:, None, :].expand(-1, 3, -1).reshape(-1, 3)  # row f*3+k: vertex k of face f
    return csr_segment_sum(f3, plan)
