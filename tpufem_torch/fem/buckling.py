"""Linearized buckling and the stress-stiffened vibration spectrum — port of
``tpufem/fem/buckling.py``.

Solves the initial-stress eigenproblem (K + lambda K_G(sigma0)) phi = 0,
where sigma0 is the element stress of the static pre-solve under the
reference pressure: the smallest positive lambda is the buckling load factor.
For tet4, K_G[ai,bj] = delta_ij * (g_a^T sigma g_b) * V, a metric-weighted
Laplacian replicated over the three displacement components.

- ``element_stress`` gives the per-Kuhn-tet sigma of a grid displacement; on
  a CUDA tensor it is one launch of ``csrc/element_stress.cu`` (kernel F).
- ``geom_apply`` applies K_G matrix-free on the grid, welds and root mask
  included; on a CUDA tensor it is one launch of ``csrc/geom_apply.cu``
  (kernel G). Unlike strain_apply it has no Dirichlet identity: constrained
  rows come back zero.
- ``WingBuckling`` runs subspace iteration on the pencil K phi = (1/lambda)
  S phi, S = -K_G, on fem.modal's block engine; the reduced pencil is solved
  on the host, and lambda_cr = 1 / nu_max.
- ``WingPrestressedModal`` solves (K + p K_G(sigma0)) phi = w^2 M phi: at
  p = 0 the free-vibration pencil, and as p -> lambda_cr the lowest
  frequency goes to zero.

On a CPU tensor both kernel wrappers run their plain versions, line-for-line
ports of tpufem's jnp.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from tpufem_torch.fem.modal import (
    GridBlockSolver,
    ModalResult,
    _subspace_smallest,
    lumped_mass,
)
from tpufem_torch.fem.stencil import (
    _corners,
    check_grid_operands,
    grid_shapes,
    weld_reduce,
    weld_spread,
)
from tpufem_torch.fem.stencil_mg import ops64
from tpufem_torch.mesher import _HEX_CORNERS, _KUHN_TETS, WingMeshResolution
from tpufem_torch.ops.kernels import check, load_kernels


def element_stress_plain(res: WingMeshResolution, geo, u, lam, mu):
    """Plain PyTorch version of element_stress (tpufem's jnp, line for line)."""
    g, _vol = geo
    us = weld_spread(res, u)
    uc = _corners(us)
    sigs = []
    for t in range(6):
        H = None
        for a in range(4):
            term = g[t, a][:, None] * uc[_KUHN_TETS[t, a]][None, :]
            H = term if H is None else H + term  # H[d,e]
        eps = 0.5 * (H + H.transpose(0, 1))
        tr = eps[0, 0] + eps[1, 1] + eps[2, 2]
        sig = 2.0 * mu * eps
        for d in range(3):
            sig[d, d] += lam * tr
        sigs.append(sig)
    return torch.stack(sigs, dim=0)


def geom_apply_plain(res: WingMeshResolution, geo, sig, u, free):
    """Plain PyTorch version of geom_apply (tpufem's jnp, line for line)."""
    g, vol = geo
    us = weld_spread(res, u * free)
    uc = _corners(us)
    nc, nt, ns = us.shape[2] - 1, us.shape[3] - 1, us.shape[4] - 1
    y = torch.zeros_like(us)
    for t in range(6):
        # sg[b] = sigma @ g_b : (3,B,nc,nt,ns)
        H = None
        for b in range(4):
            sgb = (sig[t] * g[t, b][None, :]).sum(dim=1)  # (3,B,...)
            term = sgb[:, None] * uc[_KUHN_TETS[t, b]][None, :]  # (3d,3i,B,...)
            H = term if H is None else H + term
        Hw = H * vol[t][None, None]
        for a in range(4):
            fe = (Hw * g[t, a][:, None]).sum(dim=0)  # (3i,B,...)
            ia, ja, ka = _HEX_CORNERS[_KUHN_TETS[t, a]]
            y[:, :, ia : ia + nc, ka : ka + nt, ja : ja + ns] += fe
    return weld_reduce(res, y) * free


def element_stress(res: WingMeshResolution, geo, u, lam: float, mu: float):
    """Per-Kuhn-tet Cauchy stress sig (6,3,3,B,nc,nt,ns) from a grid
    displacement u (3,B,NI,NK,NJ); geo from cell_geometry. Symmetric in the
    two component axes. u is weld-spread but not masked.

    A CPU tensor takes element_stress_plain; a CUDA tensor launches kernel F
    (one thread per lane and cell, the 6 tets in turn); inputs it does not
    take raise. lam and mu are Python floats."""
    if not u.is_cuda:
        return element_stress_plain(res, geo, u, lam, mu)
    g, _ = geo
    want = grid_shapes(res, u.shape[1] if u.dim() == 5 else 0)
    check_grid_operands("F (element_stress)", res, u, {"g": (g, want["g"])})
    if np.prod(want["sig"]) >= 2**31:
        raise ValueError("kernel F indexes in 32 bits: the stress array is too large")
    sig = torch.empty(want["sig"], dtype=u.dtype, device=u.device)
    _, B, NI, NK, NJ = u.shape
    lib = load_kernels()
    fn = (lib.tpufem_element_stress_f64 if u.dtype == torch.float64
          else lib.tpufem_element_stress_f32)
    status = fn(g.data_ptr(), u.data_ptr(), sig.data_ptr(), B, NI, NK, NJ,
                int(res.te_floor_frac == 0.0), float(lam), float(mu),
                torch.cuda.current_stream(u.device).cuda_stream)
    check(status, "element_stress")
    element_stress.launches += 1
    return sig


element_stress.launches = 0


def geom_apply(res: WingMeshResolution, geo, sig, u, free):
    """y = K_G(sigma) u = R(K_G(S(u * free))) * free, matrix-free on the grid
    (S = weld_spread, R = weld_reduce): y[a,i] = sum_t V_t * g_a . H_i with
    H[d,i] = sum_b (sigma g_b)[d] u_b[i]. No Dirichlet identity: constrained
    rows come back zero.

    A CPU tensor takes geom_apply_plain; a CUDA tensor launches kernel G,
    which computes the whole function, mask and welds included, in one
    launch; inputs it does not take raise."""
    if not u.is_cuda:
        return geom_apply_plain(res, geo, sig, u, free)
    g, vol = geo
    want = grid_shapes(res, u.shape[1] if u.dim() == 5 else 0)
    check_grid_operands("G (geom_apply)", res, u, {
        k: (t, want[k]) for k, t in (("g", g), ("vol", vol), ("sig", sig), ("free", free))})
    _, B, NI, NK, NJ = u.shape
    y = torch.empty_like(u)
    lib = load_kernels()
    fn = lib.tpufem_geom_apply_f64 if u.dtype == torch.float64 else lib.tpufem_geom_apply_f32
    status = fn(g.data_ptr(), vol.data_ptr(), sig.data_ptr(), u.data_ptr(), free.data_ptr(),
                y.data_ptr(), B, NI, NK, NJ, int(res.te_floor_frac == 0.0),
                torch.cuda.current_stream(u.device).cuda_stream)
    check(status, "geom_apply")
    geom_apply.launches += 1
    return y


geom_apply.launches = 0


@dataclass
class BucklingResult:
    load_factor: float  # smallest positive lambda (critical multiple of load)
    factors: np.ndarray  # (k,) positive lambdas ascending (inf-padded)
    modes: np.ndarray  # (N,3,k) buckling mode shapes (K-normalized)
    sweeps: int
    converged: bool
    # per sweep: (inner CG tolerance, CG iterations, largest relative change
    # of the k factors from the sweep before, None on the first)
    history: list = field(default_factory=list)


class WingBuckling(GridBlockSolver):
    """Subspace-iteration buckling eigensolver: pre-solve -> sigma0 -> pencil
    (K, -K_G) via the shared block MG-PCG engine."""

    def __init__(self, res: WingMeshResolution, p4, pressure: float = 5e3, **kw):
        super().__init__(res, p4, **kw)
        self.pressure = float(pressure)
        self._u0 = None
        self._sig = None
        self._block_u0 = None

    def _prepare_stress(self) -> None:
        """Static pre-solve at the reference pressure (the solver's material;
        tpufem's pre-solve took the default one)."""
        if self._u0 is not None:
            return
        out = self.st.solve(self.p4[None], pressure=self.pressure, material=self.material,
                            tol=1e-8, maxiter=2000)
        if not bool(out.converged.all()):
            raise RuntimeError(
                f"static pre-solve did not converge: rel {float(out.rel_residual.max()):.2e}")
        self._u0 = out.u.cpu().numpy().astype(np.float64)  # (N,3,1)
        self._block_u0 = None

    def _prepare_pencil(self, q: int) -> None:
        """sigma0 at q lanes (kernel F on the card) + the MG state."""
        self._prepare_stress()
        self._prepare(q)  # MG state + geo64 at q lanes
        if self._block_u0 == q:
            return
        u0g = self._to_grid(np.tile(self._u0, (1, 1, q)))
        self._sig = element_stress(self.res, self._geo64, u0g, self._lam64, self._mu64)
        self._block_u0 = q

    def _geom(self, xg):
        """K_G(sigma0) x on the grid (kernel G on the card)."""
        return geom_apply(self.res, self._geo64, self._sig, xg, self._free64)

    def _S(self, X_np: np.ndarray) -> np.ndarray:
        """Mesh-space S X = -K_G X for a block (N,3,q)."""
        return -self._from_grid(self._geom(self._to_grid(X_np)))

    def solve(
        self,
        n_modes: int = 4,
        block: int | None = None,
        tol: float = 1e-8,
        max_sweeps: int = 60,
        seed: int = 0,
    ) -> BucklingResult:
        k = int(n_modes)
        # the K^{-1}K_G spectrum is CLUSTERED (neighboring factors within
        # ~20% on the 19.8k-DOF demo), so subspace separation needs a
        # generous buffer; the 2k+8 default buys separation at linear
        # per-sweep cost
        q = block or (2 * k + 8)
        self._prepare_pencil(q)

        rng = np.random.default_rng(seed)
        X = rng.standard_normal((self.num_nodes, 3, q))
        X[~self.free_rows] = 0.0

        import scipy.linalg as sla

        # wall-clock levers shared with fem.modal._subspace_smallest: Ritz
        # warm start (S x = nu K x near convergence, so K Y = S X has the
        # prediction Y ~ X diag(nu)) + inexact early sweeps (inner tol tracks
        # the factor movement; accept convergence only from a sweep run at
        # the full inner_tol)
        inner_tol = float(self.inner_tol)
        loose_cap = max(inner_tol, 1e-3)
        lam_prev = None
        nu_cols = None
        rel_last = None
        sweeps = 0
        converged = False
        nu = None
        history = []
        for sweeps in range(1, max_sweeps + 1):
            if rel_last is None:
                tol_sweep = loose_cap
            else:
                tol_sweep = min(max(0.1 * rel_last, inner_tol), loose_cap)
            tol_sweep = max(10.0 ** np.floor(np.log10(tol_sweep)), inner_tol)
            SX = self._S(X)
            Y0 = X * nu_cols[None, None, :] if nu_cols is not None else None
            Y, k_in = self._block_solve(SX, Y0, tol_sweep)  # K Y = S X
            Y[~self.free_rows] = 0.0
            Kbar = np.einsum("niq,nip->qp", Y, SX)  # Y^T K Y
            SY = self._S(Y)
            Sbar = np.einsum("niq,nip->qp", Y, SY)  # Y^T S Y (indefinite)
            Kbar = 0.5 * (Kbar + Kbar.T)
            Sbar = 0.5 * (Sbar + Sbar.T)
            nu, Q = sla.eigh(Sbar, Kbar)  # ascending; K-orthonormal Q
            # dominant |nu| subspace is retained automatically (all q kept)
            X = np.einsum("niq,qp->nip", Y, Q)
            nu_cols = nu  # per-column Ritz values for the next warm start
            pos = nu[nu > 0]
            lam_now = np.sort(1.0 / pos)[:k] if len(pos) else np.array([])
            rel_now = None
            if lam_prev is not None and len(lam_now) and len(lam_prev) == len(lam_now):
                rel = np.abs(lam_now - lam_prev) / np.maximum(lam_now, 1e-300)
                rel_last = rel_now = float(rel.max())
            history.append((tol_sweep, k_in, rel_now))
            if rel_now is not None and rel_now < tol and tol_sweep <= inner_tol * (1 + 1e-12):
                converged = True
                break
            lam_prev = lam_now.copy() if len(lam_now) else None

        order = np.argsort(-nu)  # descending nu = ascending lambda
        nu_sorted = nu[order]
        factors = np.full(k, np.inf)
        modes = np.zeros((self.num_nodes, 3, k))
        j = 0
        for idx, v in zip(order, nu_sorted):
            if v <= 0 or j >= k:
                continue
            factors[j] = 1.0 / v
            modes[:, :, j] = X[:, :, idx]
            j += 1
        return BucklingResult(
            load_factor=float(factors[0]),
            factors=factors,
            modes=modes,
            sweeps=sweeps,
            converged=converged,
            history=history,
        )


class WingPrestressedModal(WingBuckling):
    """Stress-stiffened vibration spectrum: (K + p K_G(sigma0)) phi = w^2 M phi.

    At load factor p = 0 it is the free-vibration pencil (fem.modal.WingModal),
    and as p approaches the critical factor lambda_cr (WingBuckling.solve) the
    lowest frequency collapses to zero: the frequency-vs-load curve used to
    read buckling margins from vibration tests. sigma0 comes from one
    converged static pre-solve; the block CG's operator is kernel B plus p
    times kernel G (built by stencil_mg.ops64), and the K-built f32 V-cycle
    stays the preconditioner (spectrally close for p below critical)."""

    def __init__(self, res: WingMeshResolution, p4, pressure: float = 5e3, **kw):
        super().__init__(res, p4, pressure=pressure, **kw)
        self.mass = lumped_mass(
            self.mesh.nodes.astype(np.float64), self.mesh.tets, self.material.rho
        )
        self._pg = None

    def _ops(self):
        """(A, M, dot) with A = K + p K_G(sigma0) at the current load factor."""
        pg = self._pg
        return ops64(self.res, self._geo64, self._free64, self._lam64, self._mu64, self.st.smg,
                     self._mstate, extra=lambda x: pg * self._geom(x))

    def solve(
        self,
        n_modes: int = 6,
        load_factor: float = 1.0,
        block: int | None = None,
        tol: float = 1e-9,
        max_sweeps: int = 40,
        seed: int = 0,
        X0: np.ndarray | None = None,
    ) -> ModalResult:
        k = int(n_modes)
        q = block or min(2 * k, k + 8)
        q = max(q, k + 2)
        self._prepare_pencil(q)
        self._pg = float(load_factor)
        return _subspace_smallest(self, k, q, tol, max_sweeps, seed, X0=X0)

    def frequency_sweep(
        self, load_factors, n_modes: int = 4, **kw
    ) -> list[ModalResult]:
        """Modal spectra across load factors; each step warm-starts from the
        previous subspace, so the per-point cost drops along the curve."""
        outs: list[ModalResult] = []
        X0 = None
        for p in load_factors:
            out = self.solve(n_modes=n_modes, load_factor=float(p), X0=X0, **kw)
            X0 = out.modes
            outs.append(out)
        return outs
