"""p-multigrid for the tet10 wing on the incidence-gather operator — port of
``tpufem/fem/tet10_mg.py``, the gather engine of the flagship element.

    tet10 level   — Chebyshev smoothing on the tet10 thickness-line blocks
                    (tpufem_torch.fem.tet10.tet10_line_blocks on the doubled
                    grid's stations)
    p-transfer    — the natural P2 -> P1 embedding: corner dofs identity,
                    midside = mean of its edge endpoints (exact on the P1
                    subspace); restriction is the exact transpose
    tet4 level(s) — one V-cycle of the grid-native stencil multigrid
                    (tpufem_torch.fem.stencil_mg.StencilMG, kernel B) on the
                    SAME resolution

The operator (`_apply_A`) is kernel N (csrc/tet10_force.cu) on the card and
its plain version on the CPU, over the connectivity's tile plan; the
restriction's two sums over the edge endpoints are kernel E; the
thickness-line solve is a gather, one batched matmul and a scatter (tpufem
computes it outside any Pallas kernel).

The whole preconditioner is a fixed linear symmetric operator, so the outer
loop is plain PCG; `outer_f64` runs the outer operator and state in f64 with
the `dtype` preconditioner, and `refine_steps > 0` is mixed-precision
iterative refinement judged on the TRUE f64 residual, with an f64-outer
polish and a final refinement pass where the rounds stall (tpufem's
measurements of why are in its module docstring).

The CG, the correction rounds and the Chebyshev smoother are the port's
shared ones (stencil_mg._cg_grid_init / _cg_grid_run / _correction_rounds,
StencilMG._chebyshev) on one lane: the (N, 3) arrays with 0-d per-lane
values, the dots accumulated in f64 (_dot64).

Deliberate differences from tpufem: there is no chunked dispatch
(`chunk_iters` and `elem_chunk` are accepted: they bounded a TPU dispatch's
length and its HBM temporaries) and no jit; a CG run looks at the host every
stencil_mg._CHECK_EVERY steps, as the port's Tet10StencilT does, and counts
the steps tpufem's while_loop would have taken; the refinement judges each
round on the TRUE residual of the x it returns (tpufem's last round leaves
the residual of the x before it, which decides the polish); the device
defaults to the card.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from tpufem_torch.device import resolve_device
from tpufem_torch.fem.material import Material, lame_params
from tpufem_torch.fem.precond import make_line_preconditioner
from tpufem_torch.fem.stencil import from_grid, to_grid
from tpufem_torch.fem.stencil_mg import (
    StencilMG,
    _cg_grid_init,
    _cg_grid_run,
    _correction_rounds,
)
from tpufem_torch.fem.tet10 import (
    Tet10Mesh,
    force_plan,
    line_plan10,
    pressure_loads_t6,
    t6_plan,
    tet10_force,
    tet10_line_blocks,
    tet10_root_nodes,
    tet10_setup,
    tet10_stress_nodal,
    tet10_upper_t6,
)
from tpufem_torch.fem.vonmises import von_mises
from tpufem_torch.mesher import WingMeshResolution
from tpufem_torch.ops.csr_segment_sum import csr_plan, csr_segment_sum


@dataclass
class Tet10MGResult:
    u: np.ndarray  # (N10, 3)
    vm: np.ndarray  # (N10,)
    iters: int
    rel_residual: float
    converged: bool


class Tet10MGSolver:
    """Single-case tet10 MG-PCG solver for the structured wing, on `device`
    (the card unless the caller asks for the CPU)."""

    def __init__(
        self,
        res: WingMeshResolution,
        t10: Tet10Mesh,
        dtype=torch.float32,
        smooth_degree: int = 2,
        smooth_alpha: float = 0.25,
        power_iters: int = 10,
        lmax_safety: float = 1.2,
        elem_chunk: int | None = None,
        device="cuda",
    ):
        if t10.station_id is None:
            raise ValueError("Tet10MGSolver needs the structured wing's tet10 mesh (stations)")
        del elem_chunk  # kernel N keeps the element forces in shared memory
        self.res = res
        self.t10 = t10
        self.dtype = dtype
        self.device = dev = resolve_device(device)
        self.smooth_degree = smooth_degree
        self.smooth_alpha = smooth_alpha
        self.power_iters = power_iters
        self.lmax_safety = lmax_safety
        self.N10 = t10.num_nodes
        self.N4 = t10.mesh4.num_nodes
        self.conn = torch.as_tensor(t10.tet10, dtype=torch.int32, device=dev)
        # kernel N's blocks; its CSR fields also sum the nodal stress
        self.plan = force_plan(t10, dev)
        edges = np.asarray(t10.edge_endpoints, np.int64)  # (M,2)
        self.edges = torch.as_tensor(edges, device=dev)
        self.edge_plans = [csr_plan(edges[:, c], self.N4, dev) for c in (0, 1)]
        self.S2, self.K2 = t10.num_stations, t10.slots_per_station
        self.line_plan = line_plan10(t10.tet10, t10.station_id, t10.slot, self.S2, self.K2,
                                     dev)
        free = np.ones((self.N10, 3), np.float32)
        free[tet10_root_nodes(t10)] = 0.0
        self.free = torch.as_tensor(free, dtype=dtype, device=dev)
        self.free64 = self.free.to(torch.float64)
        # tet4 coarse hierarchy, batch lane B=1
        self.smg = StencilMG(res, dtype=dtype, device=dev, smooth_degree=smooth_degree,
                             smooth_alpha=smooth_alpha, power_iters=power_iters,
                             lmax_safety=lmax_safety)
        self._t6_plans: dict = {}
        # wall-clock split of the last solve(): setup / solve / recover seconds
        self.last_timing: dict | None = None

    # ---------------------------------------------------------- p-transfers
    def prolong(self, u4):
        """(N4,3) tet4 -> (N10,3) tet10: P1 embedding into P2."""
        mids = 0.5 * (u4[self.edges[:, 0]] + u4[self.edges[:, 1]])
        return torch.cat([u4, mids], dim=0) * self.free.to(u4.dtype)

    def restrict(self, r10):
        """Exact transpose of prolong: the midside halves summed onto each
        edge endpoint by kernel E, first endpoints then second, as tpufem adds
        its two segment sums."""
        r10 = r10 * self.free.to(r10.dtype)
        half = 0.5 * r10[self.N4:]
        r4 = r10[: self.N4] + csr_segment_sum(half, self.edge_plans[0])
        return r4 + csr_segment_sum(half, self.edge_plans[1])

    # ------------------------------------------------------------- operator
    def _apply_A(self, Jinv, vols, lam, mu, x, free=None):
        """A x = K(x * free) * free + x * (1 - free): one tet10_force call
        (kernel N on the card)."""
        return tet10_force(Jinv, vols, self.conn, x, lam, mu, self.N10, plan=self.plan,
                           free=self.free if free is None else free)

    def _line_apply(self, Binv, r):
        z = make_line_preconditioner(self.line_plan, Binv)(r.reshape(-1))
        return z.reshape(-1, 3) * self.free

    # ----------------------------------------------------------------- setup
    def _setup(self, nodes10, p4, lam, mu):
        """(Jinv, vols, Binv, lmax, smg_state) in `dtype`: geometry, the tet10
        line inverses, the Chebyshev lmax by power iteration and the tet4
        StencilMG state of the wing p4 (numpy (4,))."""
        Jinv, vols = tet10_setup(nodes10, self.conn)
        Binv = tet10_line_blocks(Jinv, vols, self.conn, self.t10.station_id, self.t10.slot, lam,
                                 mu, self.free.reshape(-1), S=self.S2, K=self.K2,
                                 plan=self.line_plan)
        # lambda_max of M_line^-1 A by power iteration
        v = torch.sin(torch.arange(self.N10 * 3, dtype=self.dtype, device=self.device)
                      * 0.7311).reshape(-1, 3)
        v = v * self.free
        lmax = torch.ones((), dtype=self.dtype, device=self.device)
        for _ in range(self.power_iters):
            w = self._line_apply(Binv, self._apply_A(Jinv, vols, lam, mu, v))
            nrm = torch.sqrt((w * w).sum())
            lmax = nrm
            v = w / torch.clamp(nrm, min=1e-30)
        lmax = lmax * self.lmax_safety
        smg_state = self.smg.setup(np.asarray(p4)[None, :], lam, mu)
        return Jinv, vols, Binv, lmax, smg_state

    # --------------------------------------------------------- preconditioner
    def apply_M(self, Jinv, vols, Binv, lmax, smg_state, lam, mu, r):
        """One p-MG V-cycle: tet10 smoothing + tet4 stencil-MG correction."""
        A = lambda x: self._apply_A(Jinv, vols, lam, mu, x)  # noqa: E731
        Ml = lambda rr: self._line_apply(Binv, rr)  # noqa: E731
        cheb = self.smg._chebyshev
        x = cheb(A, Ml, r, lmax, self.smooth_degree, self.smooth_alpha)
        rr = r - A(x)
        r4 = self.restrict(rr)  # (N4,3)
        rg = to_grid(self.res, r4[:, :, None]) * self.smg.active_masks[0]
        zg = self.smg._vcycle(smg_state, 0, rg)
        z4 = from_grid(self.res, zg)[:, :, 0]
        x = x + self.prolong(z4)
        rr = r - A(x)
        return x + cheb(A, Ml, rr, lmax, self.smooth_degree, self.smooth_alpha)

    # --------------------------------------------------------------- CG ops
    def _ops(self, Jinv, vols, Binv, lmax, smg_state, lam, mu):
        """(A, M) of the `dtype` CG."""
        A = lambda x: self._apply_A(Jinv, vols, lam, mu, x)  # noqa: E731
        M = lambda r: self.apply_M(Jinv, vols, Binv, lmax, smg_state, lam, mu, r)  # noqa: E731
        return A, M

    def _ops64(self, sys64, Binv, lmax, smg_state, lam, mu):
        """(A, M) of the f64-operator CG: kernel N in f64 on the f64 geometry
        and the exact Lame constants, the `dtype` V-cycle as preconditioner.
        As tpufem's, that V-cycle applies the f64 geometry cast to `dtype`
        (not the `dtype` setup's own Jinv), at the rounded constants lam, mu."""
        Jinv64, vols64, lam64, mu64, _ = sys64
        Jc, vc = Jinv64.to(self.dtype), vols64.to(self.dtype)  # cast once

        def A(x):
            return self._apply_A(Jinv64, vols64, lam64, mu64, x, self.free64)

        def M(r):
            return self.apply_M(Jc, vc, Binv, lmax, smg_state, lam, mu,
                                r.to(self.dtype)).to(torch.float64)

        return A, M

    def _resid64(self, sys64, x64):
        """TRUE f64 residual r = b - A x of the f64-assembled system and its
        relative norm: one f64 operator apply, on the device."""
        Jinv64, vols64, lam64, mu64, b64 = sys64
        r = b64 - self._apply_A(Jinv64, vols64, lam64, mu64, x64, self.free64)
        bn = torch.sqrt((b64 * b64).sum())
        rn = torch.sqrt((r * r).sum())
        return r, rn / torch.where(bn > 0, bn, torch.ones_like(bn))

    def _recover(self, Jinv, vols, x, lam, mu):
        u = x * self.free.to(x.dtype)
        s6 = tet10_stress_nodal(Jinv, vols, self.conn, u, lam, mu, self.N10, plan=self.plan)
        return u, von_mises(s6)

    def _t6_plan(self, upper_t6):
        key = (upper_t6.shape, upper_t6.tobytes())
        if key not in self._t6_plans:
            self._t6_plans[key] = t6_plan(upper_t6, self.N10, self.device)
        return self._t6_plans[key]

    def system64(self, upper_t6, pressure: float, lam64: float, mu64: float):
        """(Jinv64, vols64, lam64, mu64, b64): the f64 system on the device,
        at the exact material constants (rebuilding them from the rounded
        `dtype` values would perturb the system by ~eps_f32, tpufem measured)."""
        nodes64 = torch.as_tensor(self.t10.nodes10(self.t10.mesh4.nodes), dtype=torch.float64,
                                  device=self.device)
        Jinv64, vols64 = tet10_setup(nodes64, self.conn)
        b64 = pressure_loads_t6(nodes64, upper_t6, pressure, self.N10,
                                plan=self._t6_plan(upper_t6)) * self.free64
        return Jinv64, vols64, lam64, mu64, b64

    # ------------------------------------------------------------------- API
    def solve(
        self,
        params4,
        upper_face_idx,
        pressure: float = 5e3,
        material: Material | None = None,
        tol: float = 1e-6,
        maxiter: int = 2000,
        chunk_iters: int = 100,
        outer_f64: bool = False,
        refine_steps: int = 0,
        inner_tol: float = 1e-4,
        progress: bool = False,
    ) -> Tet10MGResult:
        """refine_steps > 0 selects mixed-precision iterative refinement:
        `dtype` MG-PCG to `inner_tol`, then up to refine_steps rounds of (f64
        TRUE residual -> `dtype` correction solve), convergence judged on the
        TRUE f64 residual against `tol`, then where the rounds stall an
        f64-outer polish and a final refinement pass. outer_f64 runs the whole
        CG on the f64 operator. u is f64 on both paths (their residual
        certifies the f64 state). chunk_iters is accepted for tpufem's
        signature (see the module docstring)."""
        del chunk_iters
        lam64, mu64 = lame_params(material or Material())
        # the `dtype` system sees the Lame constants rounded to it, as tpufem's
        lam, mu = (float(torch.tensor(v, dtype=self.dtype)) for v in (lam64, mu64))
        p4 = torch.as_tensor(np.asarray(params4), dtype=self.dtype).numpy()
        nodes10 = torch.as_tensor(self.t10.nodes10(self.t10.mesh4.nodes), dtype=self.dtype,
                                  device=self.device)
        upper_t6 = tet10_upper_t6(self.t10, upper_face_idx)
        sync = torch.cuda.synchronize if self.device.type == "cuda" else (lambda: None)
        tm = {"setup_s": 0.0, "solve_s": 0.0, "recover_s": 0.0}
        self.last_timing = tm

        def say(msg):
            if progress:
                print(f"  [tet10-mg] {msg}", flush=True)

        t0 = time.perf_counter()
        Jinv, vols, Binv, lmax, smg_state = self._setup(nodes10, p4, lam, mu)
        f = pressure_loads_t6(nodes10, upper_t6, pressure, self.N10, plan=self._t6_plan(upper_t6))
        b = f * self.free
        sys64 = (self.system64(upper_t6, pressure, lam64, mu64)
                 if outer_f64 or refine_steps > 0 else None)
        sync()
        tm["setup_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        mg = (Binv, lmax, smg_state, lam, mu)
        if refine_steps > 0:
            x, total, rel, conv = self._solve_refine(Jinv, vols, mg, b, sys64, tol, maxiter,
                                                     refine_steps, inner_tol, say)
        else:
            if outer_f64:
                A, M = self._ops64(sys64, *mg)
                rhs = sys64[4]
            else:
                A, M = self._ops(Jinv, vols, *mg)
                rhs = b
            cg = _cg_grid_init(A, M, _dot64, rhs, torch.zeros_like(rhs))
            cg, total, rel, conv = _cg_grid_run(A, M, _dot64, cg, tol, maxiter)
            say(f"iters {total}: rel {float(rel):.3e}")
            x = cg[0]
        sync()
        tm["solve_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        _, vm = self._recover(Jinv, vols, x.to(self.dtype), lam, mu)
        # u keeps the solve dtype: casting an f64 solution to f32 at the output
        # boundary would forfeit its certified residual (tpufem measured)
        u = (x * self.free.to(x.dtype)).cpu().numpy()
        vm = vm.cpu().numpy()
        sync()
        tm["recover_s"] = time.perf_counter() - t0
        return Tet10MGResult(u=u, vm=vm, iters=int(total), rel_residual=float(rel),
                             converged=bool(conv))

    def _solve_refine(self, Jinv, vols, mg, b, sys64, tol, maxiter, refine_steps, inner_tol,
                      say):
        """Mixed-precision refinement (see solve): (x64, iters, TRUE rel, converged)."""
        A, M = self._ops(Jinv, vols, *mg)
        cg = _cg_grid_init(A, M, _dot64, b, torch.zeros_like(b))
        cg, total, _, _ = _cg_grid_run(A, M, _dot64, cg, inner_tol, maxiter)
        say(f"iters {total}: inner solve")
        resid = lambda x64: self._resid64(sys64, x64)  # noqa: E731

        def rounds(x64, total):
            # 0.5: the refinement floor, where the `dtype` correction operator's
            # ~eps difference from the f64 one leaves further rounds chasing noise
            return _correction_rounds(A, M, _dot64, resid, x64, total, tol, maxiter,
                                      refine_steps, 0.5, inner_tol, self.dtype, say)

        x64, total, rel = rounds(cg[0].to(torch.float64), total)
        if rel > tol and total < maxiter:
            # f64-outer polish warm-started from the refined solution: it removes
            # the correction operator's floor; then a final refinement pass, each
            # round from a freshly computed residual, resets the polish's
            # recurrence drift
            A64, M64 = self._ops64(sys64, *mg)
            cg = _cg_grid_init(A64, M64, _dot64, sys64[4], x64)
            cg, k, rel, _ = _cg_grid_run(A64, M64, _dot64, cg, tol, maxiter - total)
            total += k
            say(f"f64 polish, iters {total}: rel {float(rel):.3e}")
            x64, total, rel = rounds(cg[0], total)
        return x64, total, rel, rel <= tol


def _dot64(u_, v_):
    """f64-accumulated dot, returned in u_'s dtype: plain f32 reductions at
    ~2.5M DOF carry ~sqrt(N)*eps ~ 2e-4 relative noise into alpha and beta
    (tpufem measured the recurred residual stall at ~1e-2 on the flagship)."""
    return (u_.to(torch.float64) * v_.to(torch.float64)).sum().to(u_.dtype)
