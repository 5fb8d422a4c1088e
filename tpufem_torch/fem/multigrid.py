"""Batched geometric multigrid for the structured wing mesh in the
trailing-batch layout — port of ``tpufem/fem/multigrid.py``.

The wing mesher produces NESTED station grids under 2x in-plane coarsening
(both chord spacings satisfy s_{2I}(n) == s_I(n/2), and yfrac = j/n_span is
trivially nested), so the coarse wing at (n_chord/2, n_span/2, n_thick) is a
true geometric coarsening of the fine wing for any parameter vector.

Design (semi-coarsening + line smoothing, kept from tpufem):
  - coarsen chord x span by 2 per level, and thickness by 2 while even;
  - smoother: a fixed-degree Chebyshev polynomial preconditioned by the
    thickness-line block-Jacobi, lambda_max per case from a setup-time power
    iteration: a fixed linear symmetric operator, so plain CG stays valid
    outside;
  - coarsest level: exact dense inverse (a few hundred dofs) assembled and
    inverted in numpy f64 on the host (in f32 the assembly cancels away the
    global bending modes: the coarsest sits at cond ~1e13);
  - transfers: interpolation linear in the physical station coordinates,
    identity (or 2x) along thickness; welded LE/TE nodes interpolate from the
    welded coarse node. Restriction is the exact transpose; both directions
    are gathers of fixed width summed in order.

Everything runs on (N, 3, B) node arrays, B cases of one topology (the
layout of ``fem.batched_t.WingBatchT``). The operator of every smoother step
is kernel O (``fem.assembly.stiffness_apply_t``) on the card. tpufem's
segment sums are kernel E over CSR plans built once per topology; the line
blocks and the RBM coarse operator are inverted by batched Cholesky
(``precond.spd_block_inverse``), where tpufem ran Newton-Schulz matmuls on
the TPU. The production batched engine is ``stencil_mg.WingStencilT``; this
module is tpufem's cross-check of it and the preconditioner of
``WingBatchT(mg_levels != 0)``. The host-side coarsest machinery
(``_level_host``, ``coarsest_dense_inverse_host``) serves StencilMG too.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from tpufem_torch.device import resolve_device
from tpufem_torch.fem.assembly import (
    IncidencePlan,
    build_incidence,
    force_plan_t,
    stiffness_apply_t,
)
from tpufem_torch.fem.precond import (
    LinePrecondPlan,
    RbmPlan,
    _rbm_basis,
    build_line_plan,
    plan_device_arrays,
    spd_block_inverse,
)
from tpufem_torch.geometry import stations
from tpufem_torch.mesher import WingMeshResolution, WingTopology, wing_topology
from tpufem_torch.ops.csr_segment_sum import csr_plan, csr_segment_sum

# --------------------------------------------------------------------- host


@dataclass(frozen=True)
class MGTransfer:
    """Prolongation P between a fine and the next-coarser level, stored twice
    (both as gathers): parents[f] = coarse nodes feeding fine node f;
    children[c] = fine nodes fed by coarse node c (exact transpose)."""

    parents: np.ndarray  # (N_f, P) int32
    pweights: np.ndarray  # (N_f, P) float32
    children: np.ndarray  # (N_c, C) int32
    cweights: np.ndarray  # (N_c, C) float32


@dataclass(frozen=True)
class MGLevelHost:
    res: WingMeshResolution
    topo: WingTopology
    plan: LinePrecondPlan
    free3: np.ndarray  # (N,3) float32, 0 at root (j==0) nodes
    incidence: IncidencePlan  # the tets' incidence plan on the CPU (tpufem's inc / incm)


@dataclass(frozen=True)
class WingHierarchy:
    levels: tuple[MGLevelHost, ...]  # [0] = finest
    transfers: tuple[MGTransfer, ...]  # len = len(levels) - 1


def _level_host(res: WingMeshResolution) -> MGLevelHost:
    topo = wing_topology(res)
    NJ = res.n_span + 1
    free3 = np.ones((topo.num_nodes, 3), np.float32)
    free3[topo.station_id % NJ == 0] = 0.0  # root stations j == 0
    return MGLevelHost(res=res, topo=topo, plan=build_line_plan(topo), free3=free3,
                       incidence=build_incidence(topo.tets, topo.num_nodes))


def _grid_node_lookup(level: MGLevelHost):
    """(i, j, k) -> node id, collapsing welded stations to their slot-0 node."""
    plan = level.plan
    NJ = level.res.n_span + 1

    def lookup(i, j, k):
        st = i * NJ + j
        kk = np.where(plan.slot_valid[st, k] > 0, k, 0)
        return plan.station_nodes[st, kk]

    return lookup


def _build_transfer(fine: MGLevelHost, coarse: MGLevelHost) -> MGTransfer:
    """Bilinear interpolation coefficients as a COO list, then packed into
    padded parent/child gather tables (exact transposes).

    Weights are linear in the PHYSICAL station coordinates (s, yfrac), not in
    index space: chord stations are LE-clustered, and index-space 0.5/0.5
    averaging mis-interpolates smooth fields there badly enough that the
    rediscretized coarse correction overshoots (tpufem measured a CG
    residual blow-up x500 at DOF100K)."""
    NJ_f = fine.res.n_span + 1
    st = fine.topo.station_id.astype(np.int64)
    ri, rj = st // NJ_f, st % NJ_f
    rk = fine.topo.slot.astype(np.int64)
    N_f = fine.topo.num_nodes
    lut = _grid_node_lookup(coarse)

    s_f = stations(fine.res.n_chord, fine.res.spacing)

    rows, cols, wts = [], [], []
    # i-parents: even i -> exact coarse station; odd i -> neighbors i-1, i+1
    # weighted by s-distance (coarse stations are the even fine stations)
    even_i = (ri % 2) == 0
    iL = np.where(even_i, ri, ri - 1)
    iR = np.where(even_i, ri, ri + 1)
    span_s = np.maximum(s_f[iR] - s_f[iL], 1e-300)
    wL = np.where(even_i, 1.0, (s_f[iR] - s_f[ri]) / span_s)
    i_par = [(iL // 2, wL), (iR // 2, np.where(even_i, 0.0, 1.0 - wL))]
    # j-parents: span stations are uniform -> 0.5/0.5
    even_j = (rj % 2) == 0
    j_par = [(rj // 2, np.where(even_j, 1.0, 0.5))]
    j_par.append((np.where(even_j, rj // 2, (rj + 1) // 2), np.where(even_j, 0.0, 0.5)))
    # k-parents: identity when n_thick matches; else 2x-coarsened (zfrac is
    # uniform in the slot index, so plain 0.5/0.5 for odd slots)
    if coarse.res.n_thick == fine.res.n_thick:
        k_par = [(rk, np.ones(N_f)), (rk, np.zeros(N_f))]
    elif 2 * coarse.res.n_thick == fine.res.n_thick:
        even_k = (rk % 2) == 0
        k_par = [(rk // 2, np.where(even_k, 1.0, 0.5))]
        k_par.append((np.where(even_k, rk // 2, (rk + 1) // 2), np.where(even_k, 0.0, 0.5)))
    else:
        raise ValueError("coarse n_thick must equal fine or half of it")

    fid = np.arange(N_f, dtype=np.int64)
    for ii, wi in i_par:
        for jj, wj in j_par:
            for kk, wk in k_par:
                w = wi * wj * wk
                keep = w > 0
                rows.append(fid[keep])
                cols.append(lut(ii[keep], jj[keep], kk[keep]))
                wts.append(w[keep])
    rows = np.concatenate(rows)
    cols = np.concatenate(cols).astype(np.int64)
    wts = np.concatenate(wts).astype(np.float32)

    # parents table (each fine node has <= 8 entries; duplicate (row,col)
    # pairs from welded-station collapse are kept as separate summands)
    order = np.argsort(rows, kind="stable")
    r_s, c_s, w_s = rows[order], cols[order], wts[order]
    counts = np.bincount(r_s, minlength=N_f)
    P = int(counts.max())
    starts = np.zeros(N_f + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    rank = np.arange(len(r_s)) - starts[r_s]
    parents = np.zeros((N_f, P), np.int32)
    pweights = np.zeros((N_f, P), np.float32)
    parents[r_s, rank] = c_s
    pweights[r_s, rank] = w_s

    # children table (transpose; padded to max fan-in, welded nodes widest)
    N_c = coarse.topo.num_nodes
    order = np.argsort(cols, kind="stable")
    r_s, c_s, w_s = rows[order], cols[order], wts[order]
    counts = np.bincount(c_s, minlength=N_c)
    C = int(counts.max())
    starts = np.zeros(N_c + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    rank = np.arange(len(c_s)) - starts[c_s]
    children = np.zeros((N_c, C), np.int32)
    cweights = np.zeros((N_c, C), np.float32)
    children[c_s, rank] = r_s
    cweights[c_s, rank] = w_s
    return MGTransfer(parents, pweights, children, cweights)


def build_hierarchy(
    res: WingMeshResolution,
    n_levels: int | None = None,
    min_stations: int = 3,
) -> WingHierarchy:
    """Coarsen (n_chord, n_span) by 2 while even and >= min_stations; also
    halve n_thick while even so per-element aspect ratios stay bounded
    (in-plane-only coarsening doubles element AR per level, and the coarser
    rediscretized operators then shear-lock progressively harder than the
    fine one; tpufem measured cond(VA) 211 vs 23 on the thin PRD-corner
    wing)."""
    resolutions = [res]
    while n_levels is None or len(resolutions) < n_levels:
        r = resolutions[-1]
        if (
            r.n_chord % 2 or r.n_span % 2
            or r.n_chord // 2 < min_stations or r.n_span // 2 < min_stations
        ):
            break
        nt = r.n_thick // 2 if (r.n_thick % 2 == 0 and r.n_thick >= 2) else r.n_thick
        resolutions.append(
            WingMeshResolution(
                r.n_chord // 2, r.n_span // 2, nt, r.te_floor_frac, r.spacing
            )
        )
    if n_levels is not None and len(resolutions) != n_levels:
        raise ValueError(
            f"cannot build {n_levels} levels from {res} (got {len(resolutions)})"
        )
    levels = tuple(_level_host(r) for r in resolutions)
    transfers = tuple(
        _build_transfer(levels[i], levels[i + 1]) for i in range(len(levels) - 1)
    )
    return WingHierarchy(levels, transfers)


# ------------------------------------------------- trailing-layout primitives


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


def nodes_t(basis, te_floor: float, p4, dtype):
    """(N,3,B) node coords from (B,4) params, computed in `dtype` (the map of
    mesher.nodes_from_params); basis (N,4) is the topology's node basis."""
    s, yfrac, zfrac, zbase = basis.to(dtype).unbind(1)
    span, chord, sweep, t = p4.to(dtype).unbind(1)  # (B,)
    y = yfrac[:, None] * span[None, :]
    x = s[:, None] * chord[None, :] + torch.tan(torch.deg2rad(sweep))[None, :] * y
    half = torch.maximum(t[None, :] * zbase[:, None], te_floor * s[:, None])
    z = chord[None, :] * half * zfrac[:, None]
    return torch.stack([x, y, z], dim=1)  # (N,3,B)


def grads_vols_t(nodes, tets):
    """Element gradients/volumes, case axis trailing: (T,4,3,B), (T,B)."""
    xt = nodes[tets]  # (T,4,3,B)
    e = xt[:, 1:] - xt[:, :1]  # (T,3,3,B) rows = edges
    det = _det3(e)  # (T,B)
    vols = det / 6.0
    safe = torch.where(torch.abs(det) > 0, det, torch.ones_like(det))
    c0 = _cross(e[:, 1], e[:, 2])  # (T,3,B)
    c1 = _cross(e[:, 2], e[:, 0])
    c2 = _cross(e[:, 0], e[:, 1])
    g123 = torch.stack([c0, c1, c2], dim=1) / safe[:, None, None]  # (T,3,3,B)
    g0 = -g123.sum(dim=1, keepdim=True)
    return torch.cat([g0, g123], dim=1).contiguous(), vols.contiguous()


def node_columns(topo, res: WingMeshResolution) -> np.ndarray:
    """(N,2) the (chord, span) station column of each node of a structured
    wing: kernel O's plan cuts the nodes into tiles of these columns."""
    NJ = res.n_span + 1
    return np.stack([topo.station_id // NJ, topo.station_id % NJ], axis=1)


class LanePlans:
    """Kernel O's plans of one topology on `device`, made once per (lanes,
    dtype) (``assembly.force_plan_t``, tiles of the wing's station `columns`,
    node_columns); on the CPU one CSR plan of the tets serves every lane
    count (the plain version reads only that)."""

    def __init__(self, tets: np.ndarray, num_nodes: int, device, columns: np.ndarray):
        self.tets = np.asarray(tets)
        self.num_nodes = int(num_nodes)
        self.device = torch.device(device)
        self.columns = columns
        self._plans: dict = {}

    def __call__(self, lanes: int, dtype):
        key = (lanes, dtype) if self.device.type == "cuda" else None
        if key not in self._plans:
            self._plans[key] = (force_plan_t(self.tets, self.num_nodes, lanes, dtype,
                                             self.device, columns=self.columns)
                                if key is not None
                                else csr_plan(self.tets, self.num_nodes, self.device))
        return self._plans[key]


def force_t(grads, vols, tets, plans: LanePlans, u, lam, mu):
    """y = K u on (N,3,B): kernel O without the mask (stiffness_apply_t)."""
    return stiffness_apply_t(grads, vols, tets, u, lam, mu, plans(u.shape[-1], u.dtype))


def apply_A_t(grads, vols, tets, plans: LanePlans, x, lam, mu, free):
    """The masked operator y = K(x * free) * free + x * (1 - free) on
    (N,3,B), free (N,3): one launch of kernel O on the card."""
    return stiffness_apply_t(grads, vols, tets, x, lam, mu, plans(x.shape[-1], x.dtype), free)


def line_blocks_t(lv, grads, vols, lam, mu, free):
    """Inverted per-station line blocks (S,B,D,D) — trailing-layout twin of
    precond.line_blocks. The same-station pair blocks are summed per (station,
    slot, slot) block by kernel E over the plan's blk_plan (tpufem summed
    them per corner pair into a flat matrix); the case axis sits before the
    block (tpufem kept it last, (S,D,D,B)) so that the apply is one batched
    matmul."""
    line = lv["line"]
    S, K = line["S"], line["K"]
    D = 3 * K
    nb = grads.shape[-1]
    ga = grads[line["pair_t"], line["pair_a"]]  # (P,3,B)
    gb = grads[line["pair_t"], line["pair_b"]]
    v = vols[line["pair_t"]]  # (P,B)
    eye3 = torch.eye(3, dtype=grads.dtype, device=grads.device)[None, :, :, None]
    kab = v[:, None, None, :] * (
        lam * ga[:, :, None, :] * gb[:, None, :, :]
        + mu * gb[:, :, None, :] * ga[:, None, :, :]
        + mu * (ga * gb).sum(dim=1)[:, None, None, :] * eye3
    )  # (P,3,3,B)
    blk = csr_segment_sum(kab.reshape(kab.shape[0], 9 * nb), line["blk_plan"])  # (S*K*K, 9B)
    Bm = blk.reshape(S, K, K, 3, 3, nb).permute(0, 5, 1, 3, 2, 4).reshape(S, nb, D, D)
    fm = free[line["station_nodes"]] * line["slot_valid"][:, :, None].to(free.dtype)  # (S,K,3)
    m = fm.reshape(S, 1, D)
    Bm = Bm * m[:, :, :, None] * m[:, :, None, :]
    Bm = Bm + torch.eye(D, dtype=Bm.dtype, device=Bm.device) * (1.0 - m)[:, :, :, None]
    return spd_block_inverse(Bm.reshape(S * nb, D, D)).reshape(S, nb, D, D)


def line_apply_t(lv, Binv, r):
    """z = Binv r per station line, (N,3,B) -> (N,3,B), one batched matmul."""
    line = lv["line"]
    S, K = line["S"], line["K"]
    nb = r.shape[-1]
    rs = r[line["station_nodes"]].permute(0, 3, 1, 2).reshape(S, nb, 3 * K, 1)
    zs = torch.matmul(Binv, rs).reshape(S, nb, K, 3).permute(0, 2, 3, 1)  # (S,K,3,B)
    return zs[line["node_station"], line["node_slot"]].contiguous()


def rbm_setup_t(lv, rbm: RbmPlan, nodes, grads, vols, lam, mu, ridge: float = 3e-4):
    """(Ac_inv (B,nc,nc), dvec (N,3,B)) — trailing-layout twin of
    precond.rbm_coarse_inverse: the Galerkin product P^T (m K m) P over
    per-group rigid-body modes, summed per group pair by kernel E over the
    RbmPlan's pair plans. Near-singular coarse dofs (e.g. the rotation about
    the axis of a single-station boundary group) are deactivated per case,
    and the scaled operator inverted with `ridge`, as tpufem does."""
    free3 = lv["free"]
    tets = lv["tets"].long()
    G = rbm.n_groups
    nc = 6 * G
    N, nb = nodes.shape[0], nodes.shape[-1]
    ones = torch.ones((N, 1, nb), dtype=nodes.dtype, device=nodes.device)
    cx = csr_segment_sum(torch.cat([ones, nodes], dim=1).reshape(N, 4 * nb),
                         rbm.group_plan).reshape(G, 4, nb)
    xg = cx[:, 1:] / torch.clamp(cx[:, :1], min=1.0)
    dvec = nodes - xg[rbm.node_group]  # (N,3,B)

    gB = grads.permute(0, 3, 1, 2)  # (T,B,4,3)
    dB = dvec.permute(0, 2, 1)  # (N,B,3)
    eye3 = torch.eye(3, dtype=nodes.dtype, device=nodes.device)
    T = tets.shape[0]
    acc = torch.zeros((G * G, 36 * nb), dtype=nodes.dtype, device=nodes.device)
    for a in range(4):
        Pa = _rbm_basis(dB[tets[:, a]].reshape(-1, 3)).reshape(T, nb, 3, 6)
        ga = gB[:, :, a]  # (T,B,3)
        fa = free3[tets[:, a]][:, None, :, None]
        for c in range(4):
            gb = gB[:, :, c]
            kab = vols[:, :, None, None] * (
                lam * ga[..., :, None] * gb[..., None, :]
                + mu * gb[..., :, None] * ga[..., None, :]
                + mu * (ga * gb).sum(dim=-1)[..., None, None] * eye3
            )  # (T,B,3,3)
            kab = kab * fa * free3[tets[:, c]][:, None, None, :]
            Pb = _rbm_basis(dB[tets[:, c]].reshape(-1, 3)).reshape(T, nb, 3, 6)
            blk = Pa.transpose(2, 3) @ kab @ Pb  # (T,B,6,6)
            acc = acc + csr_segment_sum(blk.permute(0, 2, 3, 1).reshape(T, 36 * nb),
                                        rbm.pair_plans[a * 4 + c])
    Ac = acc.reshape(G, G, 6, 6, nb).permute(4, 0, 2, 1, 3).reshape(nb, nc, nc)
    dg = torch.diagonal(Ac, dim1=1, dim2=2)  # (B,nc)
    act = (dg > 1e-8 * dg.max(dim=1, keepdim=True).values).to(nodes.dtype)
    Ac = Ac * act[:, :, None] * act[:, None, :] + torch.diag_embed(1.0 - act)
    return spd_block_inverse(Ac, ridge=ridge), dvec


def rbm_apply_t(lv, rbm: RbmPlan, Ac_inv, dvec, r):
    """The RBM coarse correction P Ac^-1 P^T r per case on (N,3,B): the
    per-group sums [sum r | sum d x r] by kernel E over the group plan (one
    launch at C = 6B), the coarse matvec by one bmm."""
    free = lv["free"][:, :, None]
    G = rbm.n_groups
    N, nb = r.shape[0], r.shape[-1]
    rm = r * free
    rc = csr_segment_sum(torch.cat([rm, _cross(dvec, rm)], dim=1).reshape(N, 6 * nb),
                         rbm.group_plan)  # (G, 6B): group g's 6 sums per lane
    zc = torch.bmm(Ac_inv, rc.reshape(6 * G, nb).t().unsqueeze(-1))  # (B,nc,1)
    zc = zc.squeeze(-1).t().reshape(G, 6, nb)
    zt = zc[:, :3][rbm.node_group]  # (N,3,B)
    zw = zc[:, 3:][rbm.node_group]
    return (zt + _cross(zw, dvec)) * free


def dense_stiffness_t(lv, grads, vols, lam, mu):
    """Fully-assembled (3N, 3N, B) stiffness with identity rows on constrained
    dofs — only for the tiny coarsest level (a few hundred dofs); the node
    pair sums by kernel E over a plan of (row node, column node) built here."""
    tets = lv["tets"].long()
    N = lv["num_nodes"]
    nb = grads.shape[-1]
    eye3 = torch.eye(3, dtype=grads.dtype, device=grads.device)[None, :, :, None]
    kabs, ids = [], []
    for a in range(4):
        ga = grads[:, a]
        for c in range(4):
            gb = grads[:, c]
            kabs.append(vols[:, None, None, :] * (
                lam * ga[:, :, None, :] * gb[:, None, :, :]
                + mu * gb[:, :, None, :] * ga[:, None, :, :]
                + mu * (ga * gb).sum(dim=1)[:, None, None, :] * eye3))  # (T,3,3,B)
            ids.append(tets[:, a] * N + tets[:, c])
    plan = csr_plan(torch.cat(ids), N * N, grads.device)
    acc = csr_segment_sum(torch.cat(kabs).reshape(-1, 9 * nb), plan)  # (N*N, 9B)
    Kd = acc.reshape(N, N, 3, 3, nb).permute(0, 2, 1, 3, 4).reshape(3 * N, 3 * N, nb)
    m = lv["free"].reshape(-1)  # (3N,)
    Kd = Kd * m[:, None, None] * m[None, :, None]
    eye = torch.eye(3 * N, dtype=Kd.dtype, device=Kd.device)
    return Kd + eye[:, :, None] * (1.0 - m)[:, None, None]


# ------------------------------------------------------------ device-side MG


class WingMGT:
    """Device arrays + setup/apply for the batched V-cycle, on `device` (the
    card unless the caller asks for the CPU) in `dtype`.

    The V-cycle with fixed-degree Chebyshev smoothing and setup-frozen
    eigenvalue bounds is a fixed, linear, symmetric operator — a legal CG
    preconditioner. `setup` builds the per-case state on the device;
    `finalize` attaches the host f64 coarsest inverse (tpufem split the two
    because setup ran inside jit).
    """

    def __init__(
        self,
        hier: WingHierarchy,
        dtype=torch.float32,
        smooth_degree: int = 2,
        smooth_alpha: float = 0.25,
        power_iters: int = 10,
        lmax_safety: float = 1.2,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.dtype = dtype
        self.smooth_degree = smooth_degree
        self.smooth_alpha = smooth_alpha
        self.power_iters = power_iters
        self.lmax_safety = lmax_safety
        self.n_levels = len(hier.levels)
        self._coarsest_host = hier.levels[-1]
        dev = self.device

        self.levels = []
        for lh in hier.levels:
            tets = lh.topo.tets.astype(np.int32)
            self.levels.append({
                "basis": torch.as_tensor(lh.topo.node_basis, dtype=torch.float64, device=dev),
                "te_floor": lh.topo.te_floor,
                "tets": torch.as_tensor(tets, device=dev),
                "plans": LanePlans(tets, lh.topo.num_nodes, dev, node_columns(lh.topo, lh.res)),
                "free": torch.as_tensor(lh.free3, dtype=dtype, device=dev),
                "line": plan_device_arrays(lh.plan, dev),
                "num_nodes": lh.topo.num_nodes,
            })
        self.transfers = [
            {
                "parents": torch.as_tensor(t.parents.astype(np.int64), device=dev),
                "pweights": torch.as_tensor(t.pweights, dtype=dtype, device=dev),
                "children": torch.as_tensor(t.children.astype(np.int64), device=dev),
                "cweights": torch.as_tensor(t.cweights, dtype=dtype, device=dev),
            }
            for t in hier.transfers
        ]

    # -- per-level operator -------------------------------------------------
    def _apply_A(self, lv, st, x):
        return apply_A_t(st["grads"], st["vols"], lv["tets"], lv["plans"], x, st["lam"],
                         st["mu"], lv["free"])

    def _smoother(self, lv, st):
        """(A, M) pair for this level."""
        A = lambda x: self._apply_A(lv, st, x)  # noqa: E731
        M = lambda r: line_apply_t(lv, st["Binv"], r)  # noqa: E731
        return A, M

    def _coarsest_solve(self, st, r):
        z = torch.bmm(st["Kinv"], r.reshape(-1, r.shape[-1]).t().unsqueeze(-1))  # (B,3N,1)
        return z.squeeze(-1).t().reshape(r.shape).contiguous()

    def _power_lmax(self, A, M, lv, nb):
        """Per-case lambda_max of M^-1 A by power iteration (deterministic
        start vector; constrained dofs carry eigenvalue 1, harmless)."""
        N = lv["num_nodes"]
        v = torch.sin(torch.arange(N * 3, dtype=self.dtype, device=self.device) * 0.7311)
        v = v.reshape(N, 3, 1).expand(N, 3, nb) * lv["free"][:, :, None]
        lam = torch.ones((nb,), dtype=self.dtype, device=self.device)
        for _ in range(self.power_iters):
            w = M(A(v))
            nrm = torch.sqrt((w * w).sum(dim=(0, 1)))
            lam = nrm
            v = w / torch.clamp(nrm, min=1e-30)
        # power iteration approaches lambda_max from BELOW; Chebyshev AMPLIFIES
        # modes above the interval, so the safety margin must absorb the
        # remaining under-estimate (hypre uses 1.1-1.2x for the same reason)
        return lam * self.lmax_safety

    # -- setup ---------------------------------------------------------------
    def setup(self, p4, lam: float, mu: float, level0=None):
        """Per-level operator data on the device; p4 (B,4) a tensor on the
        device. level0 = (nodes, grads, vols) reuses the caller's finest-level
        geometry instead of recomputing it. The coarsest level's inverse
        comes from finalize()."""
        state = []
        nb = p4.shape[0]
        for li, lv in enumerate(self.levels):
            if li == 0 and level0 is not None:
                nodes, grads, vols = level0
            else:
                nodes = nodes_t(lv["basis"], lv["te_floor"], p4, self.dtype)
                grads, vols = grads_vols_t(nodes, lv["tets"].long())
            st = {"grads": grads, "vols": vols, "lam": lam, "mu": mu}
            if li < self.n_levels - 1:
                st["Binv"] = line_blocks_t(lv, grads, vols, lam, mu, lv["free"])
                A, M = self._smoother(lv, st)
                st["lmax"] = self._power_lmax(A, M, lv, nb)
            state.append(st)
        return state

    def finalize(self, state, p4, lam: float, mu: float):
        """Attach the coarsest level's inverse: its dense stiffness assembled
        in numpy f64 on the host and inverted with symmetric Jacobi scaling +
        LAPACK; p4 is the (B,4) parameter array as numpy."""
        Kinv = coarsest_dense_inverse_host(
            self._coarsest_host, np.asarray(p4, np.float64), float(lam), float(mu)
        )
        st = dict(state[-1])
        st["Kinv"] = torch.as_tensor(Kinv, dtype=self.dtype, device=self.device)
        return state[:-1] + [st]

    # -- apply ---------------------------------------------------------------
    def _chebyshev(self, A, M, r0, lmax, degree, alpha):
        """x ~= A^-1 r0 by degree-`degree` preconditioned Chebyshev over
        [alpha*lmax, lmax]; x0 = 0. Per-case (B,) coefficients broadcast over
        the trailing lane axis."""
        lmin = alpha * lmax
        theta = 0.5 * (lmax + lmin)  # (B,)
        delta = 0.5 * (lmax - lmin)
        sigma = theta / delta
        rho = 1.0 / sigma
        d = M(r0) / theta
        x = d
        for _ in range(degree - 1):
            r = r0 - A(x)
            rho_new = 1.0 / (2.0 * sigma - rho)
            d = (rho_new * rho) * d + (2.0 * rho_new / delta) * M(r)
            x = x + d
            rho = rho_new
        return x

    def apply(self, state, r):
        """z = V-cycle(r), r (N,3,B) — use as CG preconditioner."""
        return self._vcycle(state, 0, r)

    def _vcycle(self, state, li, r):
        lv = self.levels[li]
        st = state[li]
        if li == self.n_levels - 1:
            return self._coarsest_solve(st, r)
        A, M = self._smoother(lv, st)
        x = self._chebyshev(A, M, r, st["lmax"], self.smooth_degree, self.smooth_alpha)
        rr = r - A(x)
        tr = self.transfers[li]
        lvc = self.levels[li + 1]
        rc = (rr[tr["children"]] * tr["cweights"][:, :, None, None]).sum(dim=1)
        rc = rc * lvc["free"][:, :, None]
        xc = self._vcycle(state, li + 1, rc)
        dx = (xc[tr["parents"]] * tr["pweights"][:, :, None, None]).sum(dim=1)
        x = x + dx * lv["free"][:, :, None]
        rr = r - A(x)
        x = x + self._chebyshev(A, M, rr, st["lmax"], self.smooth_degree, self.smooth_alpha)
        return x


def coarsest_dense_inverse_host(lh: MGLevelHost, p4, lam, mu):
    """(B, 3N, 3N) f64 inverse of the coarsest welded stiffness, assembled in
    numpy f64 and inverted with symmetric Jacobi scaling + LAPACK."""
    Kb = _coarsest_dense_host(lh, p4, lam, mu)
    d = np.einsum("bii->bi", Kb)
    s = 1.0 / np.sqrt(np.maximum(d, 1e-300))
    Ks = Kb * s[:, :, None] * s[:, None, :]
    return np.linalg.inv(Ks) * s[:, :, None] * s[:, None, :]


def _coarsest_dense_host(lh: MGLevelHost, p4, lam, mu):
    """(B, 3N, 3N) f64 coarsest stiffness with identity rows on constrained
    dofs."""
    basis = lh.topo.node_basis  # f64
    tets = lh.topo.tets.astype(np.int64)
    N = lh.topo.num_nodes
    B = p4.shape[0]
    span, chord, sweep, t = (p4[:, i] for i in range(4))
    s_, yfrac, zfrac, zbase = (basis[:, i] for i in range(4))
    y = yfrac[:, None] * span[None, :]
    x = s_[:, None] * chord[None, :] + np.tan(np.deg2rad(sweep))[None, :] * y
    half = np.maximum(t[None, :] * zbase[:, None], lh.topo.te_floor * s_[:, None])
    z = chord[None, :] * half * zfrac[:, None]
    nodes = np.stack([x, y, z], axis=1)  # (N,3,B)
    xt = np.moveaxis(nodes[tets], -1, 0)  # (B,T,4,3)
    e = xt[:, :, 1:] - xt[:, :, :1]  # (B,T,3,3)
    det = np.linalg.det(e)
    vols = det / 6.0
    inv = np.linalg.inv(np.where(np.abs(det)[..., None, None] > 0, e, np.eye(3)))
    g123 = np.swapaxes(inv, -1, -2)  # rows = columns of inv(J)
    g0 = -g123.sum(axis=2, keepdims=True)
    grads = np.concatenate([g0, g123], axis=2)  # (B,T,4,3)
    K = np.zeros((B, 3 * N, 3 * N))
    eye3 = np.eye(3)
    for a in range(4):
        ga = grads[:, :, a]  # (B,T,3)
        ta = tets[:, a]
        for c in range(4):
            gb = grads[:, :, c]
            dot = (ga * gb).sum(axis=-1)
            kab = vols[..., None, None] * (
                lam * ga[..., :, None] * gb[..., None, :]
                + mu * gb[..., :, None] * ga[..., None, :]
                + mu * dot[..., None, None] * eye3
            )  # (B,T,3,3)
            for b in range(B):
                np.add.at(
                    K[b].reshape(N, 3, N, 3),
                    (ta, slice(None), tets[:, c], slice(None)),
                    kab[b],
                )
    m = lh.free3.reshape(-1).astype(np.float64)  # (3N,)
    K = K * m[None, :, None] * m[None, None, :]
    K += np.eye(3 * N)[None] * (1.0 - m)[None, :, None]
    return K
