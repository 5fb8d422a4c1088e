"""Geometrically nonlinear statics: total-Lagrangian St. Venant-Kirchhoff
Newton-Krylov on the grid stencil operator — port of
``tpufem/fem/nonlinear.py``.

Formulation (classical total Lagrangian), per Kuhn tet, in tpufem's index
convention H[d,e] = sum_a g_a[d] u_a[e] = d u_e / d X_d:

  E = 1/2 (H + H^T + H H^T)           (Green-Lagrange)
  S = lam tr(E) I + 2 mu E             (StVK, 2nd Piola-Kirchhoff)
  P = S + H^T S                        (1st Piola-Kirchhoff)
  f_int_a = V P g_a                    per tet corner a
  residual r(u) = s f_ext - f_int(u)   (dead pressure load, scale s)

The three grid functions on the Newton path have hand-written CUDA kernels,
f64 only, each one launch per call (H and I on the tiled schedule of
``csrc/grid_tile.cuh``, J a thread per Kuhn tet); on a CPU tensor each runs
its plain version:

- ``stvk_internal_force``: kernel H (``csrc/stvk_force.cu``), welds, root
  mask and Dirichlet identity included, as kernel B wraps the linear
  operator.
- ``stvk_tangent_apply``: K_T(u) x, the directional derivative tpufem takes
  with ``jax.jvp``; kernel I (``csrc/stvk_tangent.cu``). Its plain version is
  ``torch.func.jvp`` of the plain force. It is the operator of every
  Newton-CG iteration, symmetric on the free subspace (f_int = grad W).
- ``stvk_energy``: the line search's merit W(u), a 0-d f64 tensor; kernel J
  (``csrc/stvk_energy.cu``) sums it in a fixed order, so a backtrack cannot
  flip from run to run.

``stvk_cauchy_stress`` (sigma = F S F^T / det F, per tet) is post-processing,
run once per CLI run, and stays plain torch. ``WingNonlinear`` ramps the
load, Newton-iterates with the frozen f32 V-cycle of the u = 0 elastic
operator as the CG's preconditioner, and Armijo-backtracks on the total
potential W - <f_ext, u>, host control flow at Newton granularity as in
tpufem.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from tpufem_torch.fem.modal import GridBlockSolver
from tpufem_torch.fem.stencil import (
    _corners,
    check_f64_grid_operands,
    from_grid,
    weld_reduce,
    weld_spread,
)
from tpufem_torch.fem.stencil_mg import _cg_grid_init, _cg_grid_run
from tpufem_torch.mesher import _HEX_CORNERS, _KUHN_TETS, WingMeshResolution
from tpufem_torch.ops.kernels import check, load_kernels


def _elem_H(g, uc, t):
    """H[d,e] = sum_a g[t,a,d] u_a[e] = d u_e / d X_d, per Kuhn tet t:
    (3,3,B,nc,nt,ns) slab."""
    H = None
    for a in range(4):
        term = g[t, a][:, None] * uc[_KUHN_TETS[t, a]][None, :]
        H = term if H is None else H + term
    return H


def _stvk_E_S(H, lam, mu):
    """Green-Lagrange strain and 2nd Piola-Kirchhoff stress slabs from H,
    written without in-place writes so that torch.func.jvp differentiates
    them: E[m,n] = 1/2 (H[m,n] + H[n,m] + sum_k H[m,k] H[n,k])."""
    quad = (H[:, None] * H[None, :]).sum(dim=2)  # sum_k H[m,k] H[n,k]
    E = 0.5 * (H + H.transpose(0, 1) + quad)
    tr = E[0, 0] + E[1, 1] + E[2, 2]
    eye = torch.eye(3, dtype=H.dtype, device=H.device).reshape(3, 3, *([1] * (H.dim() - 2)))
    return E, 2.0 * mu * E + (lam * tr) * eye


def _corner_add(fe, a_corner):
    """fe (3,B,nc,nt,ns) placed at hex corner a_corner of every cell, on the
    full node grid (3,B,NI,NK,NJ): tpufem's shifted-slice add, written as a
    pad so that it carries a tangent."""
    ia, ja, ka = (int(v) for v in _HEX_CORNERS[a_corner])
    return F.pad(fe, (ja, 1 - ja, ka, 1 - ka, ia, 1 - ia))


def stvk_internal_force_plain(res: WingMeshResolution, geo, u, free, lam, mu):
    """Plain PyTorch version of stvk_internal_force (tpufem's jnp, written
    functionally for torch.func.jvp)."""
    g, vol = geo
    us = weld_spread(res, u * free)
    uc = _corners(us)
    y = torch.zeros_like(us)
    for t in range(6):
        H = _elem_H(g, uc, t)
        _, S = _stvk_E_S(H, lam, mu)
        # P[i,d] = F[i,m] S[m,d] = S[i,d] + sum_m H[m,i] S[m,d]  (F = I + H^T)
        P = S + (H[:, :, None] * S[:, None, :]).sum(dim=0)
        Pw = P * vol[t][None, None]
        for a in range(4):
            fe = (Pw * g[t, a][None, :]).sum(dim=1)  # (3,B,nc,nt,ns)
            y = y + _corner_add(fe, _KUHN_TETS[t, a])
    y = weld_reduce(res, y) * free
    return y + u * (1.0 - free)


def stvk_internal_force(res: WingMeshResolution, geo, u, free, lam: float, mu: float):
    """y = f_int(u) = R(f_int(S(u * free))) * free + u * (1 - free), the
    matrix-free TL-StVK nodal forces on the grid (identity on constrained rows,
    so the tangent stays SPD on the full space). geo from cell_geometry.

    A CPU tensor takes stvk_internal_force_plain; a CUDA f64 tensor launches
    kernel H; other inputs raise. lam and mu are Python floats."""
    if not u.is_cuda:
        return stvk_internal_force_plain(res, geo, u, free, lam, mu)
    check_f64_grid_operands("H (stvk_internal_force)", res, geo, u, free)
    g, vol = geo
    y = torch.empty_like(u)
    _, B, NI, NK, NJ = u.shape
    status = load_kernels().tpufem_stvk_force_f64(
        g.data_ptr(), vol.data_ptr(), u.data_ptr(), free.data_ptr(), y.data_ptr(), B, NI, NK, NJ,
        int(res.te_floor_frac == 0.0), float(lam), float(mu),
        torch.cuda.current_stream(u.device).cuda_stream)
    check(status, "stvk_internal_force")
    stvk_internal_force.launches += 1
    return y


stvk_internal_force.launches = 0


def stvk_tangent_apply_plain(res: WingMeshResolution, geo, u, x, free, lam, mu):
    """Plain PyTorch version of stvk_tangent_apply: torch.func.jvp of the
    plain force at u along x, as tpufem's jax.jvp."""
    return torch.func.jvp(lambda v: stvk_internal_force_plain(res, geo, v, free, lam, mu),
                          (u,), (x,))[1]


def stvk_tangent_apply(res: WingMeshResolution, geo, u, x, free, lam: float, mu: float):
    """y = K_T(u) x, the directional derivative of stvk_internal_force at u
    along x (tpufem's jax.jvp(fint, (u,), (x,))[1]): per tet dH from x,
    dE = 1/2 (dH + dH^T + dH H^T + H dH^T), dS = 2 mu dE + lam tr(dE) I,
    dP = dS + dH^T S + H^T dS, forces V dP g_a; x * (1 - free) on constrained
    rows. At u = 0 it is strain_apply(x).

    A CPU tensor takes stvk_tangent_apply_plain; a CUDA f64 tensor launches
    kernel I; other inputs raise."""
    if not u.is_cuda:
        return stvk_tangent_apply_plain(res, geo, u, x, free, lam, mu)
    check_f64_grid_operands("I (stvk_tangent_apply)", res, geo, u, free, x=x)
    g, vol = geo
    y = torch.empty_like(x)
    _, B, NI, NK, NJ = u.shape
    status = load_kernels().tpufem_stvk_tangent_f64(
        g.data_ptr(), vol.data_ptr(), x.data_ptr(), u.data_ptr(), free.data_ptr(), y.data_ptr(),
        B, NI, NK, NJ, int(res.te_floor_frac == 0.0), float(lam), float(mu),
        torch.cuda.current_stream(u.device).cuda_stream)
    check(status, "stvk_tangent_apply")
    stvk_tangent_apply.launches += 1
    return y


stvk_tangent_apply.launches = 0


def stvk_energy_plain(res: WingMeshResolution, geo, u, free, lam, mu):
    """Plain PyTorch version of stvk_energy (tpufem's jnp, line for line)."""
    g, vol = geo
    uc = _corners(weld_spread(res, u * free))
    W = torch.zeros((), dtype=u.dtype, device=u.device)
    for t in range(6):
        E, _ = _stvk_E_S(_elem_H(g, uc, t), lam, mu)
        tr = E[0, 0] + E[1, 1] + E[2, 2]
        dens = 0.5 * lam * tr * tr + mu * (E * E).sum(dim=(0, 1))
        W = W + (vol[t] * dens).sum()
    return W


_TICKETS: dict = {}  # per device: kernel J's ticket counter, 0 between calls


def stvk_energy(res: WingMeshResolution, geo, u, free, lam: float, mu: float):
    """Stored StVK strain energy W(u) = sum_T V (lam/2 tr(E)^2 + mu E:E), a
    0-d tensor; grad_u W == stvk_internal_force on free rows, the hyperelastic
    consistency that makes the tangent symmetric.

    A CPU tensor takes stvk_energy_plain; a CUDA f64 tensor launches kernel J
    (a thread per lane, cell and Kuhn tet), whose sum has a fixed order (two
    calls give the same bits); other inputs raise. The partials are sized by
    the library's own tpufem_stvk_energy_blocks. Calls on one device share its
    ticket counter, so they must not run on two streams at once."""
    if not u.is_cuda:
        return stvk_energy_plain(res, geo, u, free, lam, mu)
    check_f64_grid_operands("J (stvk_energy)", res, geo, u, free)
    g, vol = geo
    _, B, NI, NK, NJ = u.shape
    lib = load_kernels()
    ticket = _TICKETS.get(u.device)
    if ticket is None:
        ticket = _TICKETS[u.device] = torch.zeros(1, dtype=torch.int32, device=u.device)
    partial = torch.empty(lib.tpufem_stvk_energy_blocks(B, NI, NK, NJ), dtype=u.dtype,
                          device=u.device)
    out = torch.empty((), dtype=u.dtype, device=u.device)
    status = lib.tpufem_stvk_energy_f64(
        g.data_ptr(), vol.data_ptr(), u.data_ptr(), free.data_ptr(), partial.data_ptr(),
        ticket.data_ptr(), out.data_ptr(), B, NI, NK, NJ, int(res.te_floor_frac == 0.0),
        float(lam), float(mu), torch.cuda.current_stream(u.device).cuda_stream)
    check(status, "stvk_energy")
    stvk_energy.launches += 1
    return out


stvk_energy.launches = 0


def stvk_cauchy_stress(res: WingMeshResolution, geo, u, free, lam, mu):
    """Per-Kuhn-tet Cauchy stress sigma = F S F^T / det F,
    (6,3,3,B,nc,nt,ns). Reduces to the linear element_stress at u -> 0.
    Post-processing, once per CLI run: plain torch on every device."""
    g, _vol = geo
    uc = _corners(weld_spread(res, u * free))
    eye = torch.eye(3, dtype=u.dtype, device=u.device).reshape(3, 3, 1, 1, 1, 1)
    sigs = []
    for t in range(6):
        H = _elem_H(g, uc, t)
        _, S = _stvk_E_S(H, lam, mu)
        Fd = H.transpose(0, 1) + eye  # F[i,m] = delta_im + H[m,i]
        FS = torch.einsum("im...,md...->id...", Fd, S)
        sig = torch.einsum("id...,jd...->ij...", FS, Fd)  # F S F^T
        J = (
            Fd[0, 0] * (Fd[1, 1] * Fd[2, 2] - Fd[1, 2] * Fd[2, 1])
            - Fd[0, 1] * (Fd[1, 0] * Fd[2, 2] - Fd[1, 2] * Fd[2, 0])
            + Fd[0, 2] * (Fd[1, 0] * Fd[2, 1] - Fd[1, 1] * Fd[2, 0])
        )
        sigs.append(sig / torch.where(J == 0, torch.ones_like(J), J)[None, None])
    return torch.stack(sigs, dim=0)


@dataclass
class NonlinearResult:
    u: np.ndarray  # (N,3) converged nonlinear displacement
    u_linear: np.ndarray  # (N,3) linear solution at the same load
    newton_iters: int  # total Newton iterations across load steps
    cg_iters: int  # total inner PCG iterations
    rel_residual: float  # final ||r|| / ||f_ext||
    converged: bool
    history: list  # per-load-step dicts (scale, newton iters, residual)


class WingNonlinear(GridBlockSolver):
    """Large-deflection wing solve: TL-StVK Newton-Krylov with the linear
    stencil-MG V-cycle as the frozen preconditioner (single case, q=1 lane),
    on `device` (the card unless the caller asks for the CPU).

    Dead pressure load (the reference's load vector, frozen in the reference
    configuration — no follower-pressure geometry update), root clamp, valid
    in the pre-buckling regime (a non-finite tangent-CG residual raises).

    Differences from tpufem, each a TPU workaround dropped: the f64 loads are
    built on the device (tpufem's _host_setup64 built them on the host
    because TPU f64 is emulated); a Newton correction is one _cg_grid_run of
    up to inner_maxiter steps (chunk_iters is accepted and unused, as in
    GridBlockSolver); the linear reference is WingStencilT.solve, judged on
    its TRUE f64 residual, with the solver's material, to newton_tol where
    that is looser than tpufem's 1e-8."""

    def __init__(self, res: WingMeshResolution, p4, pressure: float = 5e3, **kw):
        super().__init__(res, p4, **kw)
        self.pressure = float(pressure)
        self._nl_ready = False

    def _prepare_nl(self) -> None:
        if self._nl_ready:
            return
        self._prepare(1)  # q=1 MG state + f64 geometry, on the device
        bg64 = self.st._loads_grid(from_grid(self.res, self._X64), self.pressure)
        self._bg64 = bg64 * self._free64
        self._nl_ready = True

    def _fint(self, ug):
        return stvk_internal_force(self.res, self._geo64, ug, self._free64, self._lam64,
                                   self._mu64)

    def _potential(self, ug, target) -> float:
        # total potential Pi = W - <f_ext, u>: the line-search merit. The
        # RESIDUAL norm is the wrong merit here: the full Newton step from
        # u=0 spikes ||r|| by the sliver-cell quadratic remainder yet lands
        # inside the quadratic basin; Pi decreases monotonically along Newton
        # directions while K_T stays SPD.
        W = stvk_energy(self.res, self._geo64, ug, self._free64, self._lam64, self._mu64)
        return float(W - (target * ug).sum())

    def _newton_correction(self, ug, rg) -> tuple[torch.Tensor, int]:
        """du = K_T(u)^{-1} r by MG-preconditioned CG: one _cg_grid_run of up
        to inner_maxiter steps (tpufem dispatched it in chunk_iters chunks,
        a guard for its TPU worker)."""
        res, geo, free = self.res, self._geo64, self._free64

        def A(x):
            return stvk_tangent_apply(res, geo, ug, x, free, self._lam64, self._mu64)

        _, M, dot = self._ops()
        cg = _cg_grid_init(A, M, dot, rg, torch.zeros_like(rg))
        cg, total, rel, _ = _cg_grid_run(A, M, dot, cg, self.inner_tol, self.inner_maxiter)
        if not bool(torch.isfinite(rel).all()):
            raise RuntimeError(
                "tangent CG diverged (non-finite residual): load likely "
                "beyond the pre-buckling regime this solver targets"
            )
        return cg[0], total

    def solve(
        self,
        n_steps: int = 4,
        newton_tol: float = 1e-8,
        max_newton: int = 12,
        max_backtracks: int = 6,
    ) -> NonlinearResult:
        """Ramp the pressure in n_steps increments; Newton to newton_tol
        (||r|| relative to the full-load ||f_ext||) at each step."""
        self._prepare_nl()
        bg = self._bg64
        bnorm = float(torch.sqrt((bg * bg).sum()))
        bnorm = bnorm if bnorm > 0 else 1.0

        # linear reference solution at full load: the same engine, TRUE f64
        # residual, the solver's material, at tol 1e-8 (tpufem's floor) or
        # newton_tol where that is looser: f64's own floor on a fine wing is
        # above 1e-8 (DOF100K: 3.3e-8), where tpufem's fixed 1e-8 would fail
        lin = self.st.solve(self.p4[None], pressure=self.pressure, material=self.material,
                            tol=max(1e-8, newton_tol), maxiter=4000)
        if not bool(lin.converged.all()):
            raise RuntimeError("linear reference solve did not converge")

        ug = torch.zeros_like(bg)
        history = []
        newton_total = 0
        cg_total = 0
        rel = np.inf
        for step in range(1, n_steps + 1):
            s = step / n_steps
            target = s * bg
            step_newton = 0
            for _ in range(max_newton):
                r = target - self._fint(ug)
                rel = float(torch.sqrt((r * r).sum())) / (s * bnorm)
                if rel <= newton_tol:
                    break
                du, k = self._newton_correction(ug, r)
                cg_total += k
                # Armijo backtracking on the total potential energy (grad Pi =
                # -r, so the directional derivative along du is -<r, du> < 0
                # for an SPD-tangent correction)
                pi0 = self._potential(ug, target)
                slope = -float((r * du).sum())
                alpha = 1.0
                for _ in range(max_backtracks):
                    pi_t = self._potential(ug + alpha * du, target)
                    if np.isfinite(pi_t) and pi_t <= pi0 + 1e-4 * alpha * slope:
                        break
                    alpha *= 0.5
                ug = ug + alpha * du
                step_newton += 1
                newton_total += 1
            r = target - self._fint(ug)
            rel = float(torch.sqrt((r * r).sum())) / (s * bnorm)
            history.append({"scale": s, "newton_iters": step_newton, "rel_residual": rel})

        return NonlinearResult(
            u=from_grid(self.res, ug)[:, :, 0].cpu().numpy().astype(np.float64),
            u_linear=lin.u[:, :, 0].cpu().numpy().astype(np.float64),
            newton_iters=newton_total,
            cg_iters=cg_total,
            rel_residual=rel,
            converged=rel <= newton_tol,
            history=history,
        )
