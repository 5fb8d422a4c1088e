"""Stencil-form wing stiffness on the structured grid — port of
``tpufem/fem/stencil.py``.

Grid array layout (kept from tpufem): state (3, B, NI, NK, NJ); per-tet
gradients (6, 4, 3, B, nc, nt, ns) and volumes (6, B, nc, nt, ns) in cell
layout; stencil coefficients per lattice offset (3, 3, B, NI, NK, NJ) stored at
the row node. Welded nodes (LE always, TE when te_floor == 0) are embedded in
the full grid: state vectors keep the weld duplicates at zero, and the operator
is wrapped as R K_full S with S = weld_spread, R = S^T = weld_reduce.
Dirichlet (root, j = 0) by masking with identity on fixed dofs.

``strain_apply`` is the operator of the CG and of every V-cycle smoother; on a
CUDA tensor it is one launch of the hand-written kernel ``csrc/strain_apply.cu``
(kernel B, welds and Dirichlet wrap included), on a CPU tensor it runs
``strain_apply_plain``. Where the geometry requires a gradient (the adjoint of
fem.adjoint), the CUDA launch goes through ``StrainApplyGeo``, whose backward
is kernel K (``csrc/strain_geo_vjp.cu``, ``strain_apply_geo_vjp``).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from tpufem_torch.geometry import naca00xx_half_thickness, stations
from tpufem_torch.mesher import _HEX_CORNERS, _KUHN_TETS, WingMeshResolution, wing_topology
from tpufem_torch.ops.kernels import check, load_kernels, wants_grad

# the 15 lattice offsets (di, dj, dk) the Kuhn tets couple a node to
OFFSETS = sorted(
    {
        tuple(_HEX_CORNERS[_KUHN_TETS[t, b]] - _HEX_CORNERS[_KUHN_TETS[t, a]])
        for t in range(6)
        for a in range(4)
        for b in range(4)
    }
)


@lru_cache(maxsize=16)
def grid_meta(res: WingMeshResolution):
    """Static grid facts + welded-node <-> grid index maps (numpy)."""
    topo = wing_topology(res)
    NI, NJ, NK = res.n_chord + 1, res.n_span + 1, res.n_thick + 1
    st = topo.station_id.astype(np.int64)
    return {
        "NI": NI,
        "NJ": NJ,
        "NK": NK,
        "gi": (st // NJ).astype(np.int32),
        "gj": (st % NJ).astype(np.int32),
        "gk": topo.slot.astype(np.int32),
        "weld_te": res.te_floor_frac == 0.0,
        "num_nodes": topo.num_nodes,
    }


@lru_cache(maxsize=32)
def _grid_index(res: WingMeshResolution, device: torch.device):
    """(gi, gk, gj) welded-node grid indices as long tensors on `device`."""
    m = grid_meta(res)
    return tuple(torch.as_tensor(m[k], dtype=torch.long, device=device) for k in ("gi", "gk", "gj"))


def nodes_grid(res: WingMeshResolution, p4: torch.Tensor, dtype: torch.dtype):
    """Full-grid node coordinates (3, B, NI, NK, NJ) from (B,4) params,
    computed on p4's device in `dtype`."""
    dev = p4.device
    NI, NJ, NK = res.n_chord + 1, res.n_span + 1, res.n_thick + 1
    s_np = stations(res.n_chord, res.spacing)
    s = torch.as_tensor(s_np, dtype=dtype, device=dev)  # (NI,)
    zbase = torch.as_tensor(naca00xx_half_thickness(s_np, 1.0), dtype=dtype, device=dev)
    yfrac = torch.as_tensor(np.arange(NJ) / res.n_span, dtype=dtype, device=dev)
    zfrac = torch.as_tensor(2.0 * np.arange(NK) / res.n_thick - 1.0, dtype=dtype, device=dev)
    span, chord, sweep, t = p4.to(dtype).unbind(1)  # (B,)

    y = span[:, None] * yfrac[None, :]  # (B, NJ)
    x = (
        chord[:, None, None] * s[None, :, None]
        + torch.tan(torch.deg2rad(sweep))[:, None, None] * y[:, None, :]
    )  # (B, NI, NJ)
    half = torch.maximum(t[:, None] * zbase[None, :], res.te_floor_frac * s[None, :])
    z = chord[:, None, None] * half[:, :, None] * zfrac[None, None, :]  # (B, NI, NK)
    B = p4.shape[0]
    X = torch.empty((3, B, NI, NK, NJ), dtype=dtype, device=dev)
    X[0] = x[:, :, None, :]
    X[1] = y[:, None, None, :]
    X[2] = z[:, :, :, None]
    return X


def _cross0(u, v):
    """Cross product on axis 0 of (3, ...) tensors."""
    return torch.stack(
        [
            u[1] * v[2] - u[2] * v[1],
            u[2] * v[0] - u[0] * v[2],
            u[0] * v[1] - u[1] * v[0],
        ],
        dim=0,
    )


def _corners(X):
    """The 8 hex-corner slabs (3, B, nc, nt, ns) of a grid array."""
    nc, nt, ns = X.shape[2] - 1, X.shape[3] - 1, X.shape[4] - 1
    return [
        X[:, :, di : di + nc, dk : dk + nt, dj : dj + ns] for di, dj, dk in _HEX_CORNERS
    ]


def _tet_gradients(corners, t):
    """(g0..g3, vol) of Kuhn tet t over all cells, with the relative
    degenerate-tet cut."""
    c0, c1, c2, c3 = (_KUHN_TETS[t, a] for a in range(4))
    x0 = corners[c0]
    e1 = corners[c1] - x0
    e2 = corners[c2] - x0
    e3 = corners[c3] - x0
    det = (e1 * _cross0(e2, e3)).sum(dim=0)  # (B,nc,nt,ns)
    # Degeneracy is judged RELATIVE to the edge scale: collapsed weld tets have
    # det = rounding residue (~eps * |e|^3), and vol * (c/det)^2 on that
    # residue is garbage. Real thin-wing tets sit at |det|/scale ~ 1e-3.
    scale = (
        torch.sqrt((e1 * e1).sum(dim=0))
        * torch.sqrt((e2 * e2).sum(dim=0))
        * torch.sqrt((e3 * e3).sum(dim=0))
    )
    degen = torch.abs(det) <= 1e-6 * scale
    # |det|: collapsed weld cells also hold inverted tets in canonical corner
    # order; gradients c/det are orientation-invariant, so only vol takes abs.
    vol = torch.where(degen, torch.zeros_like(det), torch.abs(det) / 6.0)
    safe = torch.where(degen, torch.ones_like(det), det)
    g1 = _cross0(e2, e3) / safe
    g2 = _cross0(e3, e1) / safe
    g3 = _cross0(e1, e2) / safe
    g0 = -(g1 + g2 + g3)
    return [g0, g1, g2, g3], vol


def assemble_stencil(res: WingMeshResolution, X, lam, mu, offsets=None):
    """Per-offset stiffness coefficient grids {offset: (3,3,B,NI,NK,NJ)} from
    full-grid coords X; `offsets` restricts assembly to a subset (the line
    blocks use the (0,0,dk) same-station offsets). Used only to build the
    line-block preconditioner: in f32 the CG operator must be strain_apply."""
    NI, NK, NJ = X.shape[2], X.shape[3], X.shape[4]
    nc, nt, ns = NI - 1, NK - 1, NJ - 1
    B = X.shape[1]
    corners = _corners(X)
    keep = set(OFFSETS if offsets is None else offsets)
    C = {
        o: torch.zeros((3, 3, B, NI, NK, NJ), dtype=X.dtype, device=X.device)
        for o in OFFSETS
        if o in keep
    }
    eye3 = torch.eye(3, dtype=X.dtype, device=X.device)[:, :, None, None, None, None]
    for t in range(6):
        g, vol = _tet_gradients(corners, t)
        for a in range(4):
            ga = g[a]
            ia, ja, ka = _HEX_CORNERS[_KUHN_TETS[t, a]]
            for b in range(4):
                off = tuple(_HEX_CORNERS[_KUHN_TETS[t, b]] - _HEX_CORNERS[_KUHN_TETS[t, a]])
                if off not in keep:
                    continue
                gb = g[b]
                dot = (ga * gb).sum(dim=0)
                kab = vol[None, None] * (
                    lam * ga[:, None] * gb[None, :]
                    + mu * gb[:, None] * ga[None, :]
                    + mu * dot[None, None] * eye3
                )  # (3,3,B,nc,nt,ns)
                C[off][:, :, :, ia : ia + nc, ka : ka + nt, ja : ja + ns] += kab
    return C


def cell_geometry(res: WingMeshResolution, X):
    """Per-tet gradients/volumes in cell-grid layout:
    (g (6,4,3,B,nc,nt,ns), vol (6,B,nc,nt,ns)). strain_apply's input: computing
    the strain first keeps f32 arithmetic at physical scale, where pre-assembled
    stencil coefficients lose the small force residual of cancelling entries."""
    corners = _corners(X)
    gs, vols = [], []
    for t in range(6):
        g, vol = _tet_gradients(corners, t)
        gs.append(torch.stack(g, dim=0))  # (4,3,B,nc,nt,ns)
        vols.append(vol)
    return torch.stack(gs, dim=0), torch.stack(vols, dim=0)


def strain_apply_plain(res: WingMeshResolution, geo, u, free, lam, mu):
    """Plain PyTorch version of strain_apply: per cell the 6 Kuhn tets read
    their corner slabs, compute sigma(eps(u)), and add the forces back with
    shifted-slice adds (tpufem's formulation, ~100 launches per apply)."""
    g, vol = geo
    us = weld_spread(res, u * free)
    NI, NK, NJ = us.shape[2], us.shape[3], us.shape[4]
    nc, nt, ns = NI - 1, NK - 1, NJ - 1
    uc = _corners(us)
    y = torch.zeros_like(us)
    for t in range(6):
        H = None  # H_{de} = sum_a g[t,a,d] * u_a[e]
        for a in range(4):
            term = g[t, a][:, None] * uc[_KUHN_TETS[t, a]][None, :]  # (3,3,B,...)
            H = term if H is None else H + term
        eps = 0.5 * (H + H.transpose(0, 1))
        tr = eps[0, 0] + eps[1, 1] + eps[2, 2]
        sig = 2.0 * mu * eps
        for d in range(3):
            sig[d, d] += lam * tr
        sw = sig * vol[t][None, None]
        for a in range(4):
            fe = (sw * g[t, a][None, :]).sum(dim=1)  # (3,B,nc,nt,ns)
            ia, ja, ka = _HEX_CORNERS[_KUHN_TETS[t, a]]
            y[:, :, ia : ia + nc, ka : ka + nt, ja : ja + ns] += fe
    y = weld_reduce(res, y) * free
    return y + u * (1.0 - free)


def check_grid_operands(name: str, res: WingMeshResolution, u, named: dict) -> None:
    """Raise unless grid kernel `name` (B, F or G) takes these operands as
    they are: u (3,B,NI,NK,NJ) on res's grid and every tensor in `named`
    (name -> (tensor, expected shape)), contiguous, of u's dtype (f32 or f64),
    on u's device, with every index below 2^31 (the kernels index in 32
    bits), none of them wanting a gradient (the kernels have no backward)."""
    if u.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"kernel {name} takes f32 or f64, got {u.dtype}")
    NI, NK, NJ = res.n_chord + 1, res.n_thick + 1, res.n_span + 1
    if u.dim() != 5 or (u.shape[0], *u.shape[2:]) != (3, NI, NK, NJ):
        raise ValueError(f"kernel {name} on the {NI}x{NK}x{NJ} grid: bad u {tuple(u.shape)}")
    for k, (t, want) in {"u": (u, tuple(u.shape)), **named}.items():
        if t.dtype != u.dtype:
            raise TypeError(f"kernel {name} needs one dtype: u {u.dtype}, {k} {t.dtype}")
        if t.device != u.device:
            raise ValueError(f"kernel {name}: {k} lies on {t.device}, u on {u.device}")
        if tuple(t.shape) != want:
            raise ValueError(f"kernel {name}: {k} has shape {tuple(t.shape)}, not {want}")
        if not t.is_contiguous():
            raise ValueError(f"kernel {name} takes contiguous operands: {k} is not")
        if t.numel() >= 2**31:
            raise ValueError(f"kernel {name} indexes in 32 bits: {k} is too large")
        if wants_grad(t):
            raise ValueError(f"kernel {name} has no backward: {k} requires_grad (the plain "
                             f"version on the CPU differentiates)")


def grid_shapes(res: WingMeshResolution, B: int) -> dict:
    """The shapes of the grid kernels' cell operands at B lanes: g, vol, the
    per-tet stress sig and the root mask free."""
    nc, nt, ns = res.n_chord, res.n_thick, res.n_span
    return {"g": (6, 4, 3, B, nc, nt, ns), "vol": (6, B, nc, nt, ns),
            "sig": (6, 3, 3, B, nc, nt, ns), "free": (1, 1, 1, 1, ns + 1)}


def check_strain_apply_inputs(res: WingMeshResolution, geo, u, free) -> None:
    """Raise unless kernel B takes these inputs as they are (check_grid_operands
    with g (6,4,3,B,nc,nt,ns), vol (6,B,nc,nt,ns) and the root mask free
    (1,1,1,1,NJ))."""
    g, vol = geo
    want = grid_shapes(res, u.shape[1] if u.dim() == 5 else 0)
    check_grid_operands("B (strain_apply)", res, u, {
        "g": (g, want["g"]), "vol": (vol, want["vol"]), "free": (free, want["free"])})


def strain_apply(res: WingMeshResolution, geo, u, free, lam: float, mu: float):
    """y = A_w u = R(K(S(u * free))) * free + u * (1 - free), the welded +
    Dirichlet-wrapped strain-first operator (S = weld_spread, R = weld_reduce).

    A CPU tensor takes strain_apply_plain. A CUDA tensor launches kernel B,
    which computes the whole function, mask, welds and Dirichlet identity
    included, in one launch; inputs it does not take raise
    (check_strain_apply_inputs). Where g or vol requires a gradient, the
    launch goes through StrainApplyGeo (backward: kernel K). lam and mu are
    Python floats.
    """
    if not u.is_cuda:
        return strain_apply_plain(res, geo, u, free, lam, mu)
    if wants_grad(geo[0]) or wants_grad(geo[1]):
        return StrainApplyGeo.apply(res, geo[0], geo[1], u, free, lam, mu)
    check_strain_apply_inputs(res, geo, u, free)
    g, vol = geo
    _, B, NI, NK, NJ = u.shape
    y = torch.empty_like(u)
    lib = load_kernels()
    fn = lib.tpufem_strain_apply_f64 if u.dtype == torch.float64 else lib.tpufem_strain_apply_f32
    status = fn(g.data_ptr(), vol.data_ptr(), u.data_ptr(), free.data_ptr(), y.data_ptr(),
                B, NI, NK, NJ, int(res.te_floor_frac == 0.0), float(lam), float(mu),
                torch.cuda.current_stream(u.device).cuda_stream)
    check(status, "strain_apply")
    strain_apply.launches += 1
    return y


strain_apply.launches = 0


def strain_apply_geo_vjp_plain(res: WingMeshResolution, geo, u, w, free, lam, mu):
    """Plain PyTorch version of strain_apply_geo_vjp: (gbar, volbar), the
    cotangents of g and vol of w . strain_apply(geo, u) at fixed u, written
    out per Kuhn tet (kernel K's formulas)."""
    g, vol = geo
    uc = _corners(weld_spread(res, u * free))
    wc = _corners(weld_spread(res, w * free))
    eye = torch.eye(3, dtype=u.dtype, device=u.device).reshape(3, 3, 1, 1, 1, 1)
    gbars, volbars = [], []
    for t in range(6):
        Hu = sum(g[t, a][:, None] * uc[_KUHN_TETS[t, a]][None, :] for a in range(4))
        Hw = sum(g[t, a][:, None] * wc[_KUHN_TETS[t, a]][None, :] for a in range(4))
        eu, ew = 0.5 * (Hu + Hu.transpose(0, 1)), 0.5 * (Hw + Hw.transpose(0, 1))
        su = 2.0 * mu * eu + lam * (eu[0, 0] + eu[1, 1] + eu[2, 2]) * eye
        sw = 2.0 * mu * ew + lam * (ew[0, 0] + ew[1, 1] + ew[2, 2]) * eye
        volbars.append((su * ew).sum(dim=(0, 1)))
        gbars.append(torch.stack([
            vol[t] * ((sw * uc[_KUHN_TETS[t, a]][None, :]).sum(dim=1)
                      + (su * wc[_KUHN_TETS[t, a]][None, :]).sum(dim=1)) for a in range(4)]))
    return torch.stack(gbars), torch.stack(volbars)


def strain_apply_geo_vjp(res: WingMeshResolution, geo, u, w, free, lam: float, mu: float):
    """(gbar (6,4,3,B,nc,nt,ns), volbar (6,B,nc,nt,ns)): the VJP of
    strain_apply(geo, u) with respect to geo = (g, vol) for the cotangent w,
    at fixed u. Per Kuhn tet, with us = S(u * free), ws = S(w * free):
    gbar[t,a] = V (sigma(eps_w) us_a + sigma(eps_u) ws_a), volbar[t] =
    sigma(eps_u) : eps_w.

    A CPU tensor takes strain_apply_geo_vjp_plain; a CUDA f64 tensor launches
    kernel K (a thread per lane, cell and Kuhn tet, no scatter); other
    inputs raise."""
    if not u.is_cuda:
        return strain_apply_geo_vjp_plain(res, geo, u, w, free, lam, mu)
    check_f64_grid_operands("K (strain_apply_geo_vjp)", res, geo, u, free, w=w)
    g, vol = geo
    gbar, volbar = torch.empty_like(g), torch.empty_like(vol)
    _, B, NI, NK, NJ = u.shape
    status = load_kernels().tpufem_strain_geo_vjp_f64(
        g.data_ptr(), vol.data_ptr(), u.data_ptr(), w.data_ptr(), free.data_ptr(),
        gbar.data_ptr(), volbar.data_ptr(), B, NI, NK, NJ, int(res.te_floor_frac == 0.0),
        float(lam), float(mu), torch.cuda.current_stream(u.device).cuda_stream)
    check(status, "strain_apply_geo_vjp")
    strain_apply_geo_vjp.launches += 1
    return gbar, volbar


strain_apply_geo_vjp.launches = 0


def check_f64_grid_operands(name: str, res: WingMeshResolution, geo, u, free, **fields) -> None:
    """Raise unless the f64-only grid kernels (H, I, J, K) take these inputs
    as they are: check_grid_operands with g, vol, the root mask free and every
    extra grid field in `fields` shaped like u, all f64."""
    if u.dtype != torch.float64:
        raise TypeError(f"kernel {name} takes f64 only, got {u.dtype}")
    g, vol = geo
    want = grid_shapes(res, u.shape[1] if u.dim() == 5 else 0)
    check_grid_operands(name, res, u, {
        "g": (g, want["g"]), "vol": (vol, want["vol"]), "free": (free, want["free"]),
        **{k: (t, tuple(u.shape)) for k, t in fields.items()}})


class StrainApplyGeo(torch.autograd.Function):
    """strain_apply on the card with a gradient to the geometry: forward is
    kernel B on the detached g and vol, backward is kernel K. u is held fixed
    (the adjoint differentiates F(p) = K(p) u - b(p) at fixed u), so a u that
    requires a gradient raises rather than get a wrong or missing one; free,
    lam and mu get none. f64 only, as kernel K."""

    @staticmethod
    def forward(ctx, res, g, vol, u, free, lam, mu):
        if u.requires_grad:
            raise ValueError("kernel B has no backward to u: the CUDA displacement "
                             "requires_grad (only the geometry's gradient is kernel K's)")
        if u.dtype != torch.float64:
            raise TypeError(f"kernel K, the geometry's gradient, takes f64 only, got {u.dtype}")
        ctx.res, ctx.lam, ctx.mu = res, lam, mu
        ctx.save_for_backward(g, vol, u, free)
        return strain_apply(res, (g, vol), u, free, lam, mu)

    @staticmethod
    def backward(ctx, grad_y):
        g, vol, u, free = ctx.saved_tensors
        gbar, volbar = strain_apply_geo_vjp(ctx.res, (g, vol), u, grad_y.contiguous(), free,
                                            ctx.lam, ctx.mu)
        return None, gbar, volbar, None, None, None, None


def weld_spread(res: WingMeshResolution, u):
    """S: copy k=0 values across the thickness on weld lines (LE; TE if sharp)."""
    u = u.clone()
    u[..., 0, :, :] = u[..., 0, 0:1, :]
    if res.te_floor_frac == 0.0:
        u[..., -1, :, :] = u[..., -1, 0:1, :]
    return u


def weld_reduce(res: WingMeshResolution, y):
    """R = S^T: sum thickness values into k=0 on weld lines, zero the rest."""
    y = y.clone()
    rows = [0] + ([-1] if res.te_floor_frac == 0.0 else [])
    for i in rows:
        tot = y[..., i, :, :].sum(dim=-2)  # (..., NJ)
        y[..., i, :, :] = 0.0
        y[..., i, 0, :] = tot
    return y


def to_grid(res: WingMeshResolution, v_nodes):
    """Welded node vector (N,3,B) -> active grid form (3,B,NI,NK,NJ)."""
    m = grid_meta(res)
    gi, gk, gj = _grid_index(res, v_nodes.device)
    g = torch.zeros((3, v_nodes.shape[2], m["NI"], m["NK"], m["NJ"]),
                    dtype=v_nodes.dtype, device=v_nodes.device)
    g[:, :, gi, gk, gj] = v_nodes.permute(1, 2, 0)
    return g


def from_grid(res: WingMeshResolution, g):
    """Active grid form -> welded node vector (N,3,B)."""
    gi, gk, gj = _grid_index(res, g.device)
    return g[:, :, gi, gk, gj].permute(2, 0, 1)
