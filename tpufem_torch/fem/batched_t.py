"""Trailing-batch wing pieces (case axis last: node states (N, 3, B)) — port
of the parts of ``tpufem/fem/batched_t.py`` that ``WingStencilT`` uses: node
coordinates, element gradients, stress recovery, the loaded upper faces and
the root mask. The gather-path CG, the line/RBM two-level preconditioner and
the experimental fast layout stay behind in tpufem.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from tpufem_torch.device import resolve_device
from tpufem_torch.mesher import WingMeshResolution, structured_wing_mesh, wing_topology
from tpufem_torch.ops.csr_segment_sum import csr_plan, csr_segment_sum
from tpufem_torch.sets import build_boundary_sets


class BatchTSolveResult(NamedTuple):
    nodes: torch.Tensor  # (N,3,B)
    u: torch.Tensor  # (N,3,B)
    stress6: torch.Tensor  # (N,6,B)
    vm: torch.Tensor  # (N,B)
    iters: int
    rel_residual: torch.Tensor  # (B,)
    converged: torch.Tensor  # (B,) bool


def _det3(e):
    """det of (T,3,3,B) over the 3x3 axes."""
    a, b, c = e[:, 0], e[:, 1], e[:, 2]  # rows (T,3,B)
    cross0 = b[:, 1] * c[:, 2] - b[:, 2] * c[:, 1]
    cross1 = b[:, 2] * c[:, 0] - b[:, 0] * c[:, 2]
    cross2 = b[:, 0] * c[:, 1] - b[:, 1] * c[:, 0]
    return a[:, 0] * cross0 + a[:, 1] * cross1 + a[:, 2] * cross2  # (T,B)


def _cross(u, v):
    """cross product on axis 1 of (T,3,B)."""
    return torch.stack(
        [
            u[:, 1] * v[:, 2] - u[:, 2] * v[:, 1],
            u[:, 2] * v[:, 0] - u[:, 0] * v[:, 2],
            u[:, 0] * v[:, 1] - u[:, 1] * v[:, 0],
        ],
        dim=1,
    )


class WingBatchT:
    """Fixed-topology wing data at one resolution, on `device`: the card
    unless the caller asks for the CPU (no CUDA device there: raises)."""

    def __init__(self, res: WingMeshResolution, device="cuda"):
        self.device = resolve_device(device)
        topo = wing_topology(res)
        self.res = res
        self.num_nodes = topo.num_nodes
        self.te_floor = topo.te_floor
        self.basis64 = torch.as_tensor(topo.node_basis, dtype=torch.float64, device=self.device)
        self.tets = torch.as_tensor(topo.tets.astype(np.int64), device=self.device)
        ref = structured_wing_mesh(1.2, 0.35, 10.0, 0.10, res)
        self.sets = build_boundary_sets(ref)
        self.surf_faces = topo.surf_faces
        self.upper = torch.as_tensor(
            topo.surf_faces[self.sets.surf_upper_faces].astype(np.int64), device=self.device
        )
        # kernel E's plans for the per-node sums of loads and of stress: a
        # fixed summation order, so two solves of one batch give the same bits
        self.upper_plan = csr_plan(self.upper, self.num_nodes, self.device)
        self.tet_plan = csr_plan(self.tets, self.num_nodes, self.device)
        free = np.ones((self.num_nodes, 3), np.float64)
        free[self.sets.nroot_nodes] = 0.0
        self.free64 = torch.as_tensor(free, device=self.device)  # (N,3)

    def _nodes(self, p4, dtype):
        """(N,3,B) node coords from (B,4) params, computed in `dtype`."""
        s, yfrac, zfrac, zbase = self.basis64.to(dtype).unbind(1)
        span, chord, sweep, t = p4.to(dtype).unbind(1)  # (B,)
        y = yfrac[:, None] * span[None, :]
        x = s[:, None] * chord[None, :] + torch.tan(torch.deg2rad(sweep))[None, :] * y
        half = torch.maximum(t[None, :] * zbase[:, None], self.te_floor * s[:, None])
        z = chord[None, :] * half * zfrac[:, None]
        return torch.stack([x, y, z], dim=1)  # (N,3,B)

    def _grads_vols(self, nodes):
        xt = nodes[self.tets]  # (T,4,3,B)
        e = xt[:, 1:] - xt[:, :1]  # (T,3,3,B) rows = edges
        det = _det3(e)  # (T,B)
        vols = det / 6.0
        safe = torch.where(torch.abs(det) > 0, det, torch.ones_like(det))
        c0 = _cross(e[:, 1], e[:, 2])  # (T,3,B)
        c1 = _cross(e[:, 2], e[:, 0])
        c2 = _cross(e[:, 0], e[:, 1])
        g123 = torch.stack([c0, c1, c2], dim=1) / safe[:, None, None]  # (T,3,3,B)
        g0 = -g123.sum(dim=1, keepdim=True)
        return torch.cat([g0, g123], dim=1), vols  # (T,4,3,B), (T,B)

    def _recover(self, grads, vols, x, lam, mu):
        """(u, s6 (N,6,B), vm (N,B)): volume-weighted nodal average of the
        element Voigt stress, and von Mises. tpufem's segment_sums are kernel
        E over the tets' plan."""
        free = self.free64.to(x.dtype)[:, :, None]
        u = x * free
        ue = u[self.tets]  # (T,4,3,B)
        H = (grads[:, :, :, None, :] * ue[:, :, None, :, :]).sum(dim=1)  # (T,3,3,B)
        eps = 0.5 * (H + H.transpose(1, 2))
        tr = eps[:, 0, 0] + eps[:, 1, 1] + eps[:, 2, 2]
        sig = 2.0 * mu * eps
        for d in range(3):
            sig[:, d, d] += lam * tr
        voigt = torch.stack(
            [sig[:, 0, 0], sig[:, 1, 1], sig[:, 2, 2], sig[:, 0, 1], sig[:, 1, 2], sig[:, 2, 0]],
            dim=1,
        )  # (T,6,B)
        nb = vols.shape[-1]
        # rows tet-major, corner-minor like tpufem's tets.reshape(-1)
        contrib = (vols[:, None, :] * voigt)[:, None].expand(-1, 4, -1, -1)
        num = csr_segment_sum(contrib.reshape(-1, 6 * nb), self.tet_plan).reshape(-1, 6, nb)
        den = csr_segment_sum(vols[:, None, :].expand(-1, 4, -1).reshape(-1, nb), self.tet_plan)
        s6 = num / torch.clamp(den, min=1e-30)[:, None, :]
        sxx, syy, szz, sxy, syz, szx = s6.unbind(1)
        vm = torch.sqrt(
            0.5 * ((sxx - syy) ** 2 + (syy - szz) ** 2 + (szz - sxx) ** 2)
            + 3.0 * (sxy**2 + syz**2 + szx**2)
        )
        return u, s6, vm
