"""Modal analysis: natural frequencies / mode shapes of the clamped wing —
port of ``tpufem/fem/modal.py``.

Solves the generalized eigenproblem K phi = lambda M phi (lambda = omega^2)
for the smallest n_modes of the root-clamped wing by Bathe subspace
iteration. Each sweep's block solve K Y = M X is one f64-operator MG-PCG
over the trailing batch axis: the q subspace vectors ride the axis the
production solver batches cases over, so the block reuses the grid operator
(kernel B on the card), the f32 V-cycle and the per-lane CG of
fem.stencil_mg unchanged. The q x q reduced pencil is solved on the host with
scipy.linalg.eigh in f64. The mass is row-sum lumped (diagonal), the same
discretization as tpufem's refsolve anchor.

The response functions (harmonic, transient, von Karman gust PSD, random
response) are numpy, copied from tpufem so that the port keeps its own.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from tpufem_torch.fem.material import Material, lame_params
from tpufem_torch.fem.stencil import from_grid, to_grid
from tpufem_torch.fem.stencil_mg import WingStencilT, _cg_grid_init, _cg_grid_run, ops64
from tpufem_torch.mesher import WingMeshResolution, structured_wing_mesh
from tpufem_torch.sets import build_boundary_sets


def lumped_mass(nodes: np.ndarray, tets: np.ndarray, rho: float) -> np.ndarray:
    """Row-sum lumped tet4 mass per node (N,), kg. Exact total mass."""
    x = nodes[tets]
    e = x[:, 1:] - x[:, :1]
    vols = np.abs(np.linalg.det(e)) / 6.0
    m = np.zeros(len(nodes), np.float64)
    share = (rho / 4.0) * vols
    for a in range(4):
        np.add.at(m, tets[:, a], share)
    return m


@dataclass
class ModalResult:
    freqs_hz: np.ndarray  # (k,) natural frequencies
    lam: np.ndarray  # (k,) eigenvalues omega^2
    modes: np.ndarray  # (N,3,k) M-orthonormal mode shapes (root rows zero)
    sweeps: int
    eig_residual: np.ndarray  # (k,) ||K phi - lam M phi|| / ||K phi||
    converged: bool
    inner_iters: int = 0  # total block-PCG iterations across all sweeps


def harmonic_response(
    result: ModalResult,
    mass: np.ndarray,
    force: np.ndarray,
    freqs_hz: np.ndarray,
    zeta: float = 0.02,
) -> np.ndarray:
    """Steady-state displacement amplitude by modal superposition.

    u(w) = sum_i phi_i * f_i / (w_i^2 - w^2 + 2 j zeta w_i w), f_i = phi_i^T F
    (modes are M-orthonormal, so modal masses are 1). Exact for any force
    lying in the span of the retained modes; truncation error otherwise.

    result: a ModalResult; mass: (N,) lumped nodal mass (for completeness
    checks only — projection needs no M); force: (N,3) real load amplitude;
    freqs_hz: (F,) excitation frequencies; zeta: modal damping ratio.
    Returns complex modal displacement field u (F, N, 3).
    """
    phi = result.modes  # (N,3,k)
    f_modal = np.einsum("nik,ni->k", phi, force.astype(np.float64))
    w = 2.0 * np.pi * np.asarray(freqs_hz, np.float64)  # (F,)
    wi = np.sqrt(np.maximum(result.lam, 0.0))  # (k,)
    denom = (wi[None, :] ** 2 - w[:, None] ** 2) + 2j * zeta * wi[None, :] * w[:, None]
    q = f_modal[None, :] / denom  # (F,k)
    return np.einsum("fk,nik->fni", q, phi)


def transient_response(
    result: ModalResult,
    force: np.ndarray,
    f_time: np.ndarray,
    t: np.ndarray,
    zeta: float = 0.02,
) -> np.ndarray:
    """Transient displacement by piecewise-exact modal superposition.

    Integrates each modal SDOF q_i'' + 2 zeta w_i q_i' + w_i^2 q_i = f_i g(t)
    (f_i = phi_i^T F; modes are M-orthonormal) with the exact solution for
    piecewise-LINEAR forcing on each step — unconditionally stable and exact
    for the sampled forcing, so the step size is a sampling choice, not a
    stability constraint. Zero initial conditions.

    force: (N,3) spatial load pattern; f_time: (T,) scalar forcing factor
    sampled at t; t: (T,) strictly increasing times from 0. Returns u (T,N,3).
    """
    phi = result.modes  # (N,3,k)
    k = phi.shape[2]
    f_modal = np.einsum("nik,ni->k", phi, force.astype(np.float64))
    w = np.sqrt(np.maximum(result.lam, 0.0))
    wd = w * np.sqrt(max(1.0 - zeta**2, 1e-300))
    q = np.zeros((len(t), k))
    qi = np.zeros(k)
    vi = np.zeros(k)
    for n in range(len(t) - 1):
        h = float(t[n + 1] - t[n])
        g0 = float(f_time[n])
        g1 = float(f_time[n + 1])
        # exact underdamped step for q'' + 2 z w q' + w^2 q = f*(a + b*tau)
        a = f_modal * g0
        b = f_modal * (g1 - g0) / h
        w2 = np.maximum(w**2, 1e-300)
        # particular solution: qp(tau) = A + B*tau
        B = b / w2
        A = (a - 2.0 * zeta * w * B) / w2
        # homogeneous part matches initial conditions at tau=0
        c1 = qi - A
        c2 = (vi + zeta * w * c1 - B) / np.maximum(wd, 1e-300)
        e = np.exp(-zeta * w * h)
        cwd, swd = np.cos(wd * h), np.sin(wd * h)
        qi = e * (c1 * cwd + c2 * swd) + A + B * h
        vi = (
            e * ((-zeta * w) * (c1 * cwd + c2 * swd)
                 + wd * (-c1 * swd + c2 * cwd))
            + B
        )
        q[n + 1] = qi
    return np.einsum("tk,nik->tni", q, phi)


def von_karman_psd(
    freqs_hz: np.ndarray, sigma_w: float, scale_l: float, airspeed: float
) -> np.ndarray:
    """One-sided PSD of vertical gust velocity, von Karman form, (m/s)^2/Hz.

    Phi(Omega) = sigma^2 (L/pi) (1 + 8/3 (1.339 L Omega)^2) /
    (1 + (1.339 L Omega)^2)^(11/6) with Omega = 2 pi f / V the spatial
    frequency; S(f) = Phi(Omega) * 2 pi / V. One-sided over f in [0, inf):
    integral S df = sigma_w^2 exactly (the 1.339 constant makes
    int (1+8/3 u^2)(1+u^2)^{-11/6} du = pi * 1.339)."""
    f = np.asarray(freqs_hz, np.float64)
    om = 2.0 * np.pi * f / airspeed
    u2 = (1.339 * scale_l * om) ** 2
    phi = (
        sigma_w**2 * (scale_l / np.pi) * (1.0 + (8.0 / 3.0) * u2)
        / (1.0 + u2) ** (11.0 / 6.0)
    )
    return phi * (2.0 * np.pi / airspeed)


def random_response(
    result: ModalResult,
    mass: np.ndarray,
    force: np.ndarray,
    freqs_hz: np.ndarray,
    s_g: np.ndarray,
    zeta: float = 0.02,
    chunk: int = 256,
) -> tuple[np.ndarray, np.ndarray]:
    """Stationary random-vibration RMS by modal superposition.

    The load is F * g(t) with F the spatial pattern (N,3) and g a zero-mean
    stationary process with one-sided PSD s_g(f) (1/Hz for dimensionless g,
    sampled at freqs_hz). The response PSD at each dof is |T(f)|^2 s_g(f)
    with T = harmonic_response's transfer field, so the RMS field is
    sigma_u = sqrt(int s_g |T|^2 df) — integrated by trapezoid over the
    supplied grid (resolve the resonance peaks, df << 2 zeta f_i, AND the
    low-frequency plateau: gust spectra concentrate variance near f = 0,
    e.g. below V / (2 pi 1.339 L) for von Karman — extend the grid down in
    log spacing rather than starting at a linear df), chunked
    over frequency so the (F,N,3) transfer field never materializes at
    flagship node counts. Returns (rms_u (N,3), sigma_q (k,) modal RMS)."""
    f = np.asarray(freqs_hz, np.float64)
    s = np.asarray(s_g, np.float64)
    w = np.empty_like(f)  # trapezoid weights
    w[1:-1] = 0.5 * (f[2:] - f[:-2])
    w[0] = 0.5 * (f[1] - f[0])
    w[-1] = 0.5 * (f[-1] - f[-2])
    ws = w * s

    acc = np.zeros(force.shape, np.float64)
    for i in range(0, len(f), chunk):
        U = harmonic_response(result, mass, force, f[i : i + chunk], zeta)
        acc += (ws[i : i + chunk, None, None] * (U.real**2 + U.imag**2)).sum(
            axis=0
        )

    # modal RMS from the scalar SDOF transfer functions (no field needed)
    phi = result.modes
    f_modal = np.einsum("nik,ni->k", phi, force.astype(np.float64))
    om = 2.0 * np.pi * f
    wi = np.sqrt(np.maximum(result.lam, 0.0))
    den2 = (wi[None, :] ** 2 - om[:, None] ** 2) ** 2 + (
        2.0 * zeta * wi[None, :] * om[:, None]
    ) ** 2
    sig_q2 = (ws[:, None] * (f_modal[None, :] ** 2) / den2).sum(axis=0)
    return np.sqrt(acc), np.sqrt(sig_q2)


class GridBlockSolver:
    """Shared machinery for block eigen/solve algorithms on the grid stencil
    operator: one wing instance (p4), a q-lane tiled MG state, and a block
    MG-PCG where the q block vectors ride the trailing batch axis, on
    `device` (the card unless the caller asks for the CPU). Subclassed by
    WingModal (vibration) and WingBuckling (fem.buckling).

    tpufem refused to build without jax_enable_x64; the card's f64 is native,
    so there is no such guard here."""

    def __init__(
        self,
        res: WingMeshResolution,
        p4,
        material: Material | None = None,
        inner_tol: float = 1e-8,
        inner_maxiter: int = 400,
        chunk_iters: int = 200,
        smooth_degree: int = 2,
        smooth_alpha: float = 0.25,
        device="cuda",
    ):
        self.res = res
        self.p4 = np.asarray(p4, np.float64).reshape(4)
        self.material = material or Material()
        self.inner_tol = float(inner_tol)
        self.inner_maxiter = int(inner_maxiter)
        # kept for tpufem's signature and CLI flag: tpufem cut each block
        # solve into dispatches of chunk_iters steps because its TPU worker
        # killed long ones; here a block solve is one _cg_grid_run of up to
        # inner_maxiter steps
        self.chunk_iters = int(chunk_iters)
        self.st = self._engine(res, smooth_degree, smooth_alpha, device)
        self.device = self.st.device

        # host-side discretization anchors: welded mesh + clamp set
        self.mesh = structured_wing_mesh(*self.p4, res)
        self.sets = build_boundary_sets(self.mesh)
        self.num_nodes, root = self._nodes_and_root()
        self.free_rows = np.ones(self.num_nodes, bool)
        self.free_rows[root] = False

        self._lam64, self._mu64 = lame_params(self.material)
        self._free64 = self.st.free64
        self._mstate = None
        self._X64 = self._geo64 = None
        self._block = None

    def _engine(self, res, smooth_degree, smooth_alpha, device):
        """The stencil engine whose operator and V-cycle the block CG runs."""
        return WingStencilT(
            res, device=device,
            mg_kwargs={"smooth_degree": smooth_degree, "smooth_alpha": smooth_alpha},
        )

    def _nodes_and_root(self):
        """(number of mesh nodes, the clamped root nodes' ids)."""
        return len(self.mesh.nodes), self.sets.nroot_nodes

    # ---- device-side pieces -------------------------------------------------
    def _prepare(self, q: int) -> None:
        """Build the q-lane MG state + f64 geometry (tiled single case); kept
        per q, since every sweep asks for it."""
        if self._block == q:
            return
        p4q = np.tile(self.p4[None], (q, 1))
        self._mstate = self.st.mg_setup(p4q, self.material)
        self._X64, self._geo64 = self.st.geometry64(p4q)
        self._block = q

    def _ops(self):
        """(A, M, dot) of the block CG: K in f64, the f32 V-cycle."""
        return ops64(self.res, self._geo64, self._free64, self._lam64, self._mu64, self.st.smg,
                     self._mstate)

    def _to_grid(self, X_np: np.ndarray):
        return to_grid(self.res, torch.as_tensor(X_np, dtype=torch.float64, device=self.device))

    def _from_grid(self, xg) -> np.ndarray:
        return np.array(from_grid(self.res, xg).cpu().numpy(), np.float64)  # writable copy

    def _block_solve(
        self,
        B_np: np.ndarray,
        x0_np: np.ndarray | None = None,
        tol: float | None = None,
    ) -> tuple[np.ndarray, int]:
        """Y = A^{-1} B for a mesh-space block B (N,3,q), A the block CG's
        operator (K here): one PCG run of up to inner_maxiter steps.
        `x0_np` warm-starts the Krylov iteration (subspace sweeps reuse the
        Ritz prediction); `tol` overrides self.inner_tol for one solve
        (inexact sweeps)."""
        tol = self.inner_tol if tol is None else float(tol)
        A, M, dot = self._ops()
        bg = self._to_grid(B_np)
        x0g = self._to_grid(x0_np) if x0_np is not None else torch.zeros_like(bg)
        cg = _cg_grid_init(A, M, dot, bg, x0g)
        cg, total, _, _ = _cg_grid_run(A, M, dot, cg, tol, self.inner_maxiter)
        return self._from_grid(cg[0]), total

    def _apply_K(self, X_np: np.ndarray) -> np.ndarray:
        """The block CG's operator on a mesh-space block (N,3,q)."""
        return self._from_grid(self._ops()[0](self._to_grid(X_np)))


def _subspace_smallest(
    solver, k: int, q: int, tol: float, max_sweeps: int, seed: int,
    X0: np.ndarray | None = None,
) -> ModalResult:
    """Bathe subspace iteration for the smallest eigenpairs of (K, M) with
    diagonal M. `solver` provides num_nodes, free_rows, mass, _block_solve
    (K^{-1} on a mesh-space block) and _apply_K (for the final honesty
    residual). X0 (N,3,<=q) seeds the leading subspace columns (warm start
    across a load sweep).

    Two wall-clock levers over textbook subspace iteration (the dominant
    cost is the block linear solve):

    - **Ritz warm start.** Near convergence K phi = lam M phi, so the sweep
      solve K Y = M X has the analytic prediction Y ~ X diag(1/lam): seed
      the block PCG there and each sweep only corrects the (shrinking)
      subspace error instead of re-solving from zero.
    - **Inexact sweeps.** Inner tolerance tracks the eigenvalue convergence
      (tol_sweep ~ 0.1 x last relative change, floored at solver.inner_tol,
      quantized to decades); convergence is only ACCEPTED from a sweep run
      at the full inner_tol, and the final true eigen-residual check below
      stays the honesty bar.
    """
    import scipy.linalg as sla

    m3 = solver.mass[:, None] * solver.free_rows[:, None]  # (N,1) masked mass
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((solver.num_nodes, 3, q))
    if X0 is not None:
        X[:, :, : X0.shape[2]] = X0[:, :, :q]
    X[~solver.free_rows] = 0.0

    inner_tol = float(solver.inner_tol)
    loose_cap = max(inner_tol, 1e-3)
    lam_prev = None
    lam_r = None
    rel_last = None
    sweeps = 0
    inner_total = 0
    converged = False
    for sweeps in range(1, max_sweeps + 1):
        # inexact-sweep tolerance: a decade below the current eigen movement
        if rel_last is None:
            tol_sweep = loose_cap
        else:
            tol_sweep = min(max(0.1 * rel_last, inner_tol), loose_cap)
        tol_sweep = 10.0 ** np.floor(np.log10(tol_sweep))  # decade quantize
        tol_sweep = max(tol_sweep, inner_tol)
        B = m3[:, :, None] * X  # M X  (N,3,q)
        Y0 = None
        if lam_r is not None:  # Ritz warm start: Y ~ X diag(1/lam)
            lam_safe = np.maximum(lam_r[:q], 1e-300)
            Y0 = X / lam_safe[None, None, :]
        Y, k_in = solver._block_solve(B, Y0, tol_sweep)
        inner_total += k_in
        Y[~solver.free_rows] = 0.0
        # reduced pencil: Kbar = Y^T K Y = Y^T (M X); Mbar = Y^T M Y
        Kbar = np.einsum("niq,nip->qp", Y, B)
        Mbar = np.einsum("niq,nip->qp", Y, m3[:, :, None] * Y)
        Kbar = 0.5 * (Kbar + Kbar.T)
        Mbar = 0.5 * (Mbar + Mbar.T)
        lam_r, Q = sla.eigh(Kbar, Mbar)
        X = np.einsum("niq,qp->nip", Y, Q)
        lam_k = lam_r[:k]
        if lam_prev is not None:
            rel = np.abs(lam_k - lam_prev) / np.maximum(np.abs(lam_k), 1e-300)
            rel_last = float(rel.max())
            # accept only from a full-precision sweep: a loose inner solve
            # can stall the Ritz values without converging the modes
            if rel_last < tol and tol_sweep <= inner_tol * (1 + 1e-12):
                converged = True
                break
        lam_prev = lam_k.copy()

    lam_k = lam_r[:k]
    modes = X[:, :, :k]
    # honesty check: true eigen-residual via one operator application
    Kphi = solver._apply_K(X)[:, :, :k]
    Mphi = m3[:, :, None] * modes
    num = np.sqrt(((Kphi - lam_k[None, None, :] * Mphi) ** 2).sum(axis=(0, 1)))
    den = np.sqrt((Kphi**2).sum(axis=(0, 1)))
    eig_res = num / np.maximum(den, 1e-300)
    freqs = np.sqrt(np.maximum(lam_k, 0.0)) / (2.0 * np.pi)
    return ModalResult(
        freqs_hz=freqs,
        lam=lam_k,
        modes=modes,
        sweeps=sweeps,
        eig_residual=eig_res,
        converged=converged,
        inner_iters=inner_total,
    )


class WingModal(GridBlockSolver):
    """Subspace-iteration vibration eigensolver on the grid stencil operator.

    One wing instance (p4) at a structured resolution; the block dimension is
    the trailing batch axis. All reduced algebra is host-side f64.
    """

    def __init__(self, res: WingMeshResolution, p4, **kw):
        super().__init__(res, p4, **kw)
        self.mass = self._lumped_mass()

    def _lumped_mass(self) -> np.ndarray:
        return lumped_mass(self.mesh.nodes.astype(np.float64), self.mesh.tets, self.material.rho)

    def solve(
        self,
        n_modes: int = 6,
        block: int | None = None,
        tol: float = 1e-9,
        max_sweeps: int = 40,
        seed: int = 0,
    ) -> ModalResult:
        k = int(n_modes)
        q = block or min(2 * k, k + 8)
        q = max(q, k + 2)
        self._prepare(q)
        return _subspace_smallest(self, k, q, tol, max_sweeps, seed)


class WingModal10(WingModal):
    """tet10 (quadratic) modal analysis on the doubled-grid stencil engine.

    Same algorithm as WingModal — subspace vectors on the trailing batch
    axis, one p-MG-PCG run per sweep, host Rayleigh-Ritz — with the flagship
    quadratic element family, on `device` (the card unless the caller asks
    for the CPU): the f64 operator is kernel L on the device-built f64
    geometry, the preconditioner the f32 tet10 V-cycle
    (fem.tet10_stencil.Tet10StencilT), and the mass is HRZ-lumped
    (fem.refsolve.lumped_mass10; row-sum lumping of the consistent tet10 mass
    is non-positive at corners). tpufem's jax_enable_x64 check has no
    counterpart: the card's f64 is native. Only the engine, the node set,
    the mass, the block CG's ops and the grid maps differ from WingModal."""

    def _engine(self, res, smooth_degree, smooth_alpha, device):
        from tpufem_torch.fem.tet10_stencil import Tet10StencilT

        return Tet10StencilT(res, dtype=torch.float32, smooth_degree=smooth_degree,
                             smooth_alpha=smooth_alpha, device=device)

    def _nodes_and_root(self):
        from tpufem_torch.fem.tet10 import tet10_root_nodes

        self.t10 = self.st.t10
        self.nodes10 = self.t10.nodes10(self.mesh.nodes.astype(np.float64))
        return self.t10.num_nodes, tet10_root_nodes(self.t10)

    def _lumped_mass(self) -> np.ndarray:
        from tpufem_torch.fem.refsolve import lumped_mass10

        return lumped_mass10(self.nodes10, self.t10.tet10, self.material.rho)

    def _prepare(self, q: int) -> None:
        """The q-lane f32 V-cycle state and f64 geometry (one wing tiled);
        kept per q, since every sweep asks for it."""
        if self._block == q:
            return
        from tpufem_torch.fem.tet10 import tet10_upper_t6

        st = self.st
        p4q = np.tile(self.p4[None], (q, 1))
        lam, mu = (float(torch.tensor(v, dtype=torch.float32))
                   for v in (self._lam64, self._mu64))
        upper_t6 = tet10_upper_t6(self.t10, self.sets.surf_upper_faces)
        geo, Binv, _bg, lmax, smg_state = st.setup(p4q.astype(np.float32), 0.0, upper_t6,
                                                   lam, mu)
        geo64, _ = st.system64(p4q, 0.0, upper_t6)
        self._cg_ops = st.ops64(geo64, geo, Binv, lmax, smg_state, self._lam64, self._mu64,
                                lam, mu)
        self._block = q

    def _ops(self):
        return self._cg_ops

    def _to_grid(self, X_np: np.ndarray):
        from tpufem_torch.fem.tet10_stencil import to_grid2

        X = torch.as_tensor(X_np, dtype=torch.float64, device=self.device)
        return to_grid2(self.res, X) * self._free64

    def _from_grid(self, xg) -> np.ndarray:
        from tpufem_torch.fem.tet10_stencil import from_grid2

        return np.array(from_grid2(self.res, xg).cpu().numpy(), np.float64)
