"""Dirichlet boundary conditions as dof masks — port of ``tpufem/fem/bc.py``.

The reference deck clamps all 3 dofs of every root node
(``*BOUNDARY Nroot,1,3,0``); with the masked operator of
tpufem_torch.fem.assembly this is exact row/column elimination.
"""

from __future__ import annotations

import numpy as np
import torch


def dirichlet_mask(num_nodes: int, clamped_nodes, node_mask=None, dtype=torch.float32,
                   device="cpu") -> torch.Tensor:
    """(N*3,) mask: 1.0 on free dofs, 0.0 on clamped-node dofs and padded nodes."""
    m = np.ones((num_nodes, 3), dtype=np.float32)
    m[np.asarray(clamped_nodes)] = 0.0
    m = torch.as_tensor(m, dtype=dtype, device=device)
    if node_mask is not None:
        m = m * node_mask[:, None]
    return m.reshape(-1)
