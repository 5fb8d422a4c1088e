"""Matrix-free stiffness operator and Jacobi diagonal — port of
``tpufem/fem/assembly.py``.

y = K u is computed per element and summed per node: kernel D
(``csrc/tet4_force.cu``, ``tet4_element_force``) forms each tet's corner
forces from its gradients and the gathered corner displacements, and kernel
E (``csrc/csr_segment_sum.cu``) sums them per node over the tets' incidence
plan. No global sparse matrix is ever materialized. The Dirichlet wrap of
``stiffness_operator`` stays in PyTorch around the two kernels.
"""

from __future__ import annotations

import torch

from tpufem_torch.ops.csr_segment_sum import CsrPlan, csr_plan, csr_segment_sum
from tpufem_torch.ops.kernels import check, load_kernels


def build_incidence(tets, num_nodes: int, device="cpu") -> CsrPlan:
    """The per-node sum plan of the (tet*4 + corner) force rows.

    tpufem stored the same stable argsort as a dense (N, V) padded gather
    table, because XLA:TPU's scatter serialized on duplicate indices
    (assembly.py:20-25). The port keeps it as CSR (order, starts), which
    kernel E walks row by row in a fixed order: no padding, no atomics.
    """
    return csr_plan(tets, num_nodes, device)


def tet4_element_force_plain(grads, vols, tets, u_nodes, lam, mu) -> torch.Tensor:
    """Plain PyTorch version of kernel D: fe (T*4, 3) = vol * sigma . g_a per
    corner, sigma = 2 mu sym(H) + lam tr(H) I, H = sum_a g_a (x) u_a."""
    ue = u_nodes[tets]  # (T,4,3) gather
    H = (grads[:, :, :, None] * ue[:, :, None, :]).sum(dim=1)  # (T,3,3)
    eps = 0.5 * (H + H.transpose(1, 2))
    tr = eps[:, 0, 0] + eps[:, 1, 1] + eps[:, 2, 2]
    sigma = 2.0 * mu * eps
    for d in range(3):
        sigma[:, d, d] += lam * tr
    fe = vols[:, None, None] * (sigma[:, None, :, :] * grads[:, :, None, :]).sum(dim=3)
    return fe.reshape(-1, 3)


def tet4_element_force(grads, vols, tets, u_nodes, lam, mu) -> torch.Tensor:
    """Corner forces (T*4, 3) of every tet. A CPU tensor takes the plain
    version; a CUDA tensor launches kernel D (f32 or f64; tets int32), or
    raises."""
    if not u_nodes.is_cuda:
        return tet4_element_force_plain(grads, vols, tets, u_nodes, lam, mu)
    dt = u_nodes.dtype
    if dt not in (torch.float32, torch.float64) or grads.dtype != dt or vols.dtype != dt:
        raise TypeError(f"kernel D takes one float dtype (f32/f64), got "
                        f"{grads.dtype}/{vols.dtype}/{dt}")
    if tets.dtype != torch.int32:
        raise TypeError(f"kernel D takes int32 tets, got {tets.dtype}")
    T = tets.shape[0]
    if (grads.shape != (T, 4, 3) or vols.shape != (T,) or tets.shape != (T, 4)
            or u_nodes.dim() != 2 or u_nodes.shape[1] != 3):
        raise ValueError(f"kernel D: bad shapes grads {tuple(grads.shape)} vols "
                         f"{tuple(vols.shape)} tets {tuple(tets.shape)} u {tuple(u_nodes.shape)}")
    if not (grads.device == vols.device == tets.device == u_nodes.device):
        raise ValueError("kernel D: inputs on different devices")
    grads, vols, tets, u_nodes = (t.contiguous() for t in (grads, vols, tets, u_nodes))
    fe = torch.empty((T * 4, 3), dtype=dt, device=u_nodes.device)
    lib = load_kernels()
    fn = lib.tpufem_tet4_force_f64 if dt == torch.float64 else lib.tpufem_tet4_force_f32
    status = fn(grads.data_ptr(), vols.data_ptr(), tets.data_ptr(), u_nodes.data_ptr(),
                fe.data_ptr(), T, float(lam), float(mu),
                torch.cuda.current_stream(u_nodes.device).cuda_stream)
    check(status, "tet4_element_force")
    tet4_element_force.launches += 1
    return fe


tet4_element_force.launches = 0


def elastic_force(grads, vols, tets, u_nodes, lam, mu, plan: CsrPlan) -> torch.Tensor:
    """y = K u in nodal (N,3) layout: kernel D, then kernel E over `plan`
    (``build_incidence(tets, N)``)."""
    return csr_segment_sum(tet4_element_force(grads, vols, tets, u_nodes, lam, mu), plan)


def stiffness_operator(grads, vols, tets, lam, mu, plan: CsrPlan, free_mask):
    """A(x) for the BC-reduced SPD system in flat (N*3,) layout.

    Dirichlet elimination by masking: A(x) = m*K(m*x) + (1-m)*x, which keeps
    the operator SPD with unit diagonal on constrained dofs.
    """
    free3 = free_mask.reshape(-1, 3)

    def apply(x_flat):
        x3 = x_flat.reshape(-1, 3)
        y = elastic_force(grads, vols, tets, x3 * free3, lam, mu, plan)
        return (y * free3 + x3 * (1.0 - free3)).reshape(-1)

    return apply


def stiffness_diagonal(grads, vols, lam, mu, plan: CsrPlan, free_mask) -> torch.Tensor:
    """diag(K) (N*3,) with unit entries on constrained dofs (Jacobi).

    Per element, K_{ai,ai} = V * (lam*g_ai^2 + mu*g_ai^2 + mu*|g_a|^2),
    summed per node by kernel E.
    """
    g2 = grads**2  # (T,4,3)
    gg = g2.sum(dim=2, keepdim=True)  # |g_a|^2
    d = vols[:, None, None] * ((lam + mu) * g2 + mu * gg)  # (T,4,3)
    diag = csr_segment_sum(d.reshape(-1, 3), plan).reshape(-1)
    one = torch.ones_like(diag)
    # padded/isolated nodes also get unit diagonal so the operator stays SPD
    diag = torch.where((free_mask > 0) & (diag > 0), diag, one)
    return torch.where(free_mask > 0, diag, one)
