"""Stress recovery: element stress, volume-weighted nodal averaging, von
Mises — port of ``tpufem/fem/vonmises.py`` (reference fem.py:332-356).

Nodal stress is the volume-weighted average of the adjacent constant-strain
element stresses, summed by kernel E over the tets' incidence plan.
"""

from __future__ import annotations

import torch

from tpufem_torch.ops.csr_segment_sum import CsrPlan, csr_segment_sum


def element_stress(grads, vols, tets, u_nodes, lam, mu) -> torch.Tensor:
    """Constant per-element Cauchy stress (T,3,3) from nodal displacement (N,3)."""
    ue = u_nodes[tets]  # (T,4,3)
    H = (grads[:, :, :, None] * ue[:, :, None, :]).sum(dim=1)  # (T,3,3)
    eps = 0.5 * (H + H.transpose(1, 2))
    tr = eps[:, 0, 0] + eps[:, 1, 1] + eps[:, 2, 2]
    sigma = 2.0 * mu * eps
    for d in range(3):
        sigma[:, d, d] += lam * tr
    return sigma


def nodal_stress(sigma_e, vols, plan: CsrPlan) -> torch.Tensor:
    """Volume-weighted average of adjacent element stresses -> (N,6) Voigt
    (sxx, syy, szz, sxy, syz, szx); `plan` is the tets' incidence plan
    (tpufem_torch.fem.assembly.build_incidence)."""
    voigt = torch.stack(
        [sigma_e[:, 0, 0], sigma_e[:, 1, 1], sigma_e[:, 2, 2],
         sigma_e[:, 0, 1], sigma_e[:, 1, 2], sigma_e[:, 2, 0]],
        dim=1,
    )  # (T,6)
    contrib = (vols[:, None] * voigt)[:, None, :].expand(-1, 4, -1).reshape(-1, 6)
    num = csr_segment_sum(contrib, plan)
    den = csr_segment_sum(vols[:, None].expand(-1, 4).reshape(-1, 1), plan)
    return num / torch.clamp(den, min=1e-300)


def von_mises(stress6: torch.Tensor) -> torch.Tensor:
    """von Mises from (..., 6) Voigt stress (reference fem.py:332-356)."""
    sxx, syy, szz = stress6[..., 0], stress6[..., 1], stress6[..., 2]
    sxy, syz, szx = stress6[..., 3], stress6[..., 4], stress6[..., 5]
    return torch.sqrt(
        0.5 * ((sxx - syy) ** 2 + (syy - szz) ** 2 + (szz - sxx) ** 2)
        + 3.0 * (sxy**2 + syz**2 + szx**2)
    )
