"""Plain reference for a linear tet4 wing solve: from the wing parameters it
works out again the nodes, the pressure loads on the upper surface, the f64
stiffness of the linear tet4 elements with the root clamped, and judges a
given displacement u by its TRUE relative residual; from u it recovers the
volume-weighted nodal stress and its von Mises value and compares them with
the program's.

The stiffness is applied element by element (sum_e B_e^T D B_e u_e), which
is the assembled K times u in exact arithmetic; nothing is solved. Plain
torch in `dtype` (float64; the control runs it in float32), on any device.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import wing


def lame(E: float, nu: float) -> tuple[float, float]:
    return E * nu / ((1.0 + nu) * (1.0 - 2.0 * nu)), E / (2.0 * (1.0 + nu))


class Tet4Reference:
    """The configuration's fixed parts (topology, sets), built once."""

    def __init__(self, cfg: dict, device, dtype=torch.float64):
        self.cfg, self.device, self.dtype = cfg, torch.device(device), dtype
        self.topo = wing.topology(cfg["mesh"])
        as_t = lambda a: torch.as_tensor(a, dtype=torch.long, device=self.device)  # noqa: E731
        self.tets = as_t(self.topo["tets"])
        self.upper = as_t(wing.upper_faces(self.topo, cfg["upper_surface_wing"]))
        free = torch.ones((self.topo["num_nodes"], 1, 1), dtype=dtype, device=self.device)
        free[as_t(wing.root_nodes(self.topo))] = 0.0
        self.free = free
        self.lam, self.mu = lame(cfg["youngs_pa"], cfg["poisson"])

    def nodes(self, p4) -> torch.Tensor:
        x = wing.node_coords(self.topo["basis"], p4, self.topo["te_floor"])
        return torch.as_tensor(x, dtype=self.dtype, device=self.device)

    def loads(self, x: torch.Tensor) -> torch.Tensor:
        """(N, 3, B): -p/3 of each upper face's area vector on each of its corners."""
        v = x[self.upper]  # (F, 3, 3, B)
        f = (-self.cfg["pressure_pa"] / 6.0) * torch.linalg.cross(v[:, 1] - v[:, 0],
                                                                   v[:, 2] - v[:, 0], dim=1)
        b = torch.zeros_like(x)
        for c in range(3):
            b.index_add_(0, self.upper[:, c], f)
        return b * self.free

    def grads(self, x: torch.Tensor):
        """Shape-function gradients (T, 4, 3, B) and volumes (T, B)."""
        xt = x[self.tets]  # (T, 4, 3, B)
        J = (xt[:, 1:] - xt[:, :1]).permute(0, 3, 1, 2)  # (T, B, 3 edges, 3)
        vol = torch.linalg.det(J) / 6.0
        G = torch.linalg.inv(J)  # columns: gradients of the corners 1..3
        g = torch.cat([-G.sum(dim=3, keepdim=True), G], dim=3)  # (T, B, 3, 4)
        return g.permute(0, 3, 2, 1), vol.abs()

    def stress(self, g, u):
        """Element stress (T, 3, 3, B) of displacements u (N, 3, B)."""
        H = torch.einsum("taib,tajb->tijb", g, u[self.tets])
        eps = 0.5 * (H + H.transpose(1, 2))
        tr = eps[:, 0, 0] + eps[:, 1, 1] + eps[:, 2, 2]
        eye = torch.eye(3, dtype=u.dtype, device=u.device)[None, :, :, None]
        return 2.0 * self.mu * eps + self.lam * tr[:, None, None] * eye

    def judge(self, p4, u, vm, lanes: int = 10) -> dict:
        """Per wing: `rel`, the TRUE relative residual ||b - K u|| / ||b||
        over the free rows, with u on the clamped rows as their residual;
        `vm_gap`, max |vm - vm_ref| / max vm_ref over the nodes. u (N, 3, B),
        vm (N, B), tensors or arrays of any float type; `lanes` wings at a time."""
        rel, gap = [], []
        p4 = np.asarray(p4, np.float64)
        for s in range(0, len(p4), lanes):
            sl = slice(s, s + lanes)
            x = self.nodes(p4[sl])
            ub = torch.as_tensor(u[:, :, sl], device=self.device).to(self.dtype)
            g, vol = self.grads(x)
            sig = self.stress(g, ub)
            f = torch.einsum("tijb,tajb->taib", sig, g) * vol[:, None, None, :]
            Ku = torch.zeros_like(ub).index_add_(0, self.tets.reshape(-1),
                                                 f.reshape(-1, 3, f.shape[-1]))
            b = self.loads(x)
            r = (b - Ku) * self.free - ub * (1.0 - self.free)
            rel.append(torch.linalg.vector_norm(r, dim=(0, 1))
                       / torch.linalg.vector_norm(b, dim=(0, 1)))
            gap.append(vm_gap(self.nodal_vm(sig, vol), vm[:, sl], self.device))
        return {"rel": torch.cat(rel).double().cpu().numpy(),
                "vm_gap": torch.cat(gap).double().cpu().numpy()}

    def vm(self, p4, u, lanes: int = 10) -> torch.Tensor:
        """(N, B) von Mises recovered from u (N, 3, B) in the reference's dtype."""
        p4 = np.asarray(p4, np.float64)
        out = []
        for s in range(0, len(p4), lanes):
            g, vol = self.grads(self.nodes(p4[s:s + lanes]))
            ub = torch.as_tensor(u[:, :, s:s + lanes], device=self.device).to(self.dtype)
            out.append(self.nodal_vm(self.stress(g, ub), vol))
        return torch.cat(out, dim=1)

    def nodal_vm(self, sig, vol):
        """Von Mises of the volume-weighted nodal average of element stress."""
        w = vol[:, None, None, :] * sig
        num = torch.zeros((self.topo["num_nodes"], 3, 3, sig.shape[-1]), dtype=sig.dtype,
                          device=sig.device)
        den = torch.zeros((self.topo["num_nodes"], sig.shape[-1]), dtype=sig.dtype,
                          device=sig.device)
        for c in range(4):
            num.index_add_(0, self.tets[:, c], w)
            den.index_add_(0, self.tets[:, c], vol)
        return von_mises(num / den.clamp_min(1e-300)[:, None, None, :])


def von_mises(s):
    """Von Mises stress of symmetric tensors s (N, 3, 3, B) -> (N, B)."""
    d = s[:, 0, 0] - s[:, 1, 1], s[:, 1, 1] - s[:, 2, 2], s[:, 2, 2] - s[:, 0, 0]
    shear = s[:, 0, 1] ** 2 + s[:, 1, 2] ** 2 + s[:, 2, 0] ** 2
    return torch.sqrt(0.5 * (d[0] ** 2 + d[1] ** 2 + d[2] ** 2) + 3.0 * shear)


def vm_gap(vm_ref, vm, device) -> torch.Tensor:
    """(B,) max over nodes of |vm - vm_ref| / max vm_ref."""
    vm = torch.as_tensor(vm, device=device).to(vm_ref.dtype)
    return (vm - vm_ref).abs().amax(dim=0) / vm_ref.abs().amax(dim=0)


Reference = Tet4Reference
