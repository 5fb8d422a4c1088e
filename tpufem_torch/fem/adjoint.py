"""Differentiable wing FEM: adjoint gradients through the stencil MG-PCG solve
— port of ``tpufem/fem/adjoint.py``.

With K(p) u = b(p) (SPD, Dirichlet rows/cols projected by the free mask) and
an objective J(p, u), the total derivative is

    dJ/dp = dJ/dp|_u - lam^T dF/dp,   K lam = dJ/du,   F(p) = K(p) u - b(p)

with u held fixed in dF/dp. Both linear solves (primal and adjoint) use the
same grid MG-PCG (K is symmetric): ``stencil_mg._cg_grid_run`` with the f64
operator (kernel B on the card) and the f32 V-cycle, judged, as tpufem's, by
the recurred residual. tpufem's ``lax.while_loop`` becomes the port's
host-checked loop.

``_Solve`` (a ``torch.autograd.Function``, tpufem's ``jax.custom_vjp``) keeps
autograd out of the CG loop: forward is one CG; backward projects the
cotangent onto the free welded subspace, runs one more CG for lam, and takes
the VJP of F at fixed u under ``torch.enable_grad()``. On the card that VJP
crosses kernel B through ``stencil.StrainApplyGeo`` (backward: kernel K) and
the loads' per-node sum through ``csr_segment_sum.CsrSegmentSum``; the chain
from the cell geometry to p stays torch autograd.

The V-cycle state is FROZEN at the designs given to ``refresh``: a
preconditioner changes the iteration count, never the solution, so its
p-dependence carries no true gradient.
"""

from __future__ import annotations

import numpy as np
import torch

from tpufem_torch.fem.material import Material, lame_params
from tpufem_torch.fem.stencil import cell_geometry, from_grid, nodes_grid, strain_apply
from tpufem_torch.fem.stencil_mg import WingStencilT, _cg_grid_init, _cg_grid_run, ops64
from tpufem_torch.mesher import WingMeshResolution


class _Solve(torch.autograd.Function):
    """u(p4) with tpufem's custom VJP: the backward is one adjoint CG and one
    VJP of the residual form at fixed u."""

    @staticmethod
    def forward(ctx, p4, fem):
        geo, bg = fem._system(p4)
        u = fem._pcg(geo, bg, "primal")
        ctx.fem = fem
        ctx.save_for_backward(p4, u)
        return u

    @staticmethod
    def backward(ctx, gu):
        fem = ctx.fem
        p4, u = ctx.saved_tensors
        u = u.detach()  # F's VJP is at fixed u (a saved output comes back with its grad_fn)
        # cotangents on constrained / duplicate slots are inert (u is
        # identically zero there); project them out so that the adjoint RHS
        # stays in the free welded subspace where K is SPD
        gu = gu * fem._active64
        geo, _ = fem._system(p4)
        lam_adj = fem._pcg(geo, gu.contiguous(), "adjoint")
        with torch.enable_grad():
            p = p4.detach().requires_grad_()
            geo_p, bg_p = fem._system(p)
            F = strain_apply(fem.res, geo_p, u, fem._free64, fem._lam64, fem._mu64) - bg_p
            (gp,) = torch.autograd.grad(F, p, grad_outputs=lam_adj)
        return -gp, None


class DifferentiableWingFEM:
    """Batched differentiable solve u(p4) on the stencil grid, on `device`
    (the card unless the caller asks for the CPU).

    p4: (B, 4) [span_m, chord_m, sweep_deg, thickness_ratio], f64.
    solve(p4) -> u grid (3, B, NI, NK, NJ) f64, differentiable wrt p4.
    `last_cg` keeps, per CG ("primal", "adjoint"), the right-hand side, the
    solution, the iterations and the recurred relative residual, so that a
    caller can recompute the TRUE residual.
    """

    def __init__(
        self,
        res: WingMeshResolution,
        p_ref,
        pressure: float = 5e3,
        material: Material | None = None,
        tol: float = 1e-10,
        maxiter: int = 2000,
        device="cuda",
    ):
        self.res = res
        self.pressure = float(pressure)
        self.material = material or Material()
        self.tol = float(tol)
        self.maxiter = int(maxiter)
        self.st = WingStencilT(res, device=device)
        self.device = self.st.device
        self._lam64, self._mu64 = lame_params(self.material)
        self._free64 = self.st.free64
        self._active64 = self.st.smg.active_masks[0].to(torch.float64)  # free * dup
        self.last_cg: dict = {}
        self.refresh(p_ref)

    # ---- preconditioner (frozen, solution-invariant)
    def refresh(self, p_ref) -> None:
        """(Re)build the V-cycle state at `p_ref` (host coarsest included)."""
        self._mstate = self.st.mg_setup(np.asarray(p_ref, np.float64), self.material)

    # ---- the discrete system, differentiable in p4
    def _p4(self, p4) -> torch.Tensor:
        return torch.as_tensor(p4, dtype=torch.float64, device=self.device)

    def _system(self, p4):
        """(geo, b) of the f64 discrete system, from parameters."""
        X = nodes_grid(self.res, p4, torch.float64)
        geo = cell_geometry(self.res, X)
        bg = self.st._loads_grid(from_grid(self.res, X), self.pressure)
        return geo, bg

    def _pcg(self, geo, rhs, label: str):
        A, M, dot = ops64(self.res, geo, self._free64, self._lam64, self._mu64, self.st.smg,
                          self._mstate)
        cg = _cg_grid_init(A, M, dot, rhs, torch.zeros_like(rhs))
        cg, iters, rel, _ = _cg_grid_run(A, M, dot, cg, self.tol, self.maxiter)
        self.last_cg[label] = {"rhs": rhs, "x": cg[0], "geo": geo, "iters": iters, "rel": rel}
        return cg[0]

    def solve(self, p4):
        """u grid (3,B,NI,NK,NJ), f64, differentiable wrt p4 (B,4)."""
        return _Solve.apply(self._p4(p4), self)

    def true_residual(self, label: str) -> torch.Tensor:
        """Per-lane TRUE relative residual ||rhs - A x|| / ||rhs|| of the last
        `label` CG ("primal" or "adjoint"), recomputed with the f64 operator."""
        c = self.last_cg[label]
        with torch.no_grad():
            geo = tuple(t.detach() for t in c["geo"])
            r = c["rhs"] - strain_apply(self.res, geo, c["x"], self._free64, self._lam64,
                                        self._mu64)
            bn = torch.sqrt((c["rhs"] ** 2).sum(dim=(0, 2, 3, 4)))
            return torch.sqrt((r * r).sum(dim=(0, 2, 3, 4))) / torch.where(
                bn > 0, bn, torch.ones_like(bn))

    # ---- differentiable post-processing / objectives
    def displacements(self, p4, u_grid):
        """Node displacements (N,3,B) from the grid solution."""
        return from_grid(self.res, u_grid)

    def compliance(self, p4, u_grid):
        """Per-lane compliance b^T u (work of the pressure load; lower =
        stiffer wing). Differentiable in both arguments."""
        _, bg = self._system(self._p4(p4))
        return (bg * u_grid).sum(dim=(0, 2, 3, 4))

    def volume(self, p4):
        """Per-lane wing volume (mass proxy), from parameters."""
        nodes = self.st.bt._nodes(self._p4(p4), torch.float64)
        _, vols = self.st.bt._grads_vols(nodes)
        return vols.sum(dim=0)

    def smooth_max_vm(self, p4, u_grid, sharpness: float = 30.0):
        """Differentiable upper envelope of the von Mises field per lane: a
        log-sum-exp over the per-node vM normalized by its mean (>= max,
        approached as `sharpness` grows)."""
        bt = self.st.bt
        nodes = bt._nodes(self._p4(p4), torch.float64)
        grads, vols = bt._grads_vols(nodes)
        x = from_grid(self.res, u_grid)
        _, _, vm = bt._recover(grads, vols, x, self._lam64, self._mu64)
        scale = vm.mean(dim=0) + 1e-30  # (B,)
        z = sharpness * vm / scale[None, :]
        return scale / sharpness * torch.logsumexp(z, dim=0)
