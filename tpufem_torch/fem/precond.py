"""Thickness-line block-Jacobi and RBM two-level preconditioners — port of
``tpufem/fem/precond.py``.

Why: the wing is a thin structure; a tensor-grid tet mesh has
through-thickness cells orders of magnitude smaller than in-plane cells near
the LE/TE, so the Jacobi-preconditioned stiffness has kappa ~ 1e7+ and
float32 CG diverges. The strong coupling runs along the thickness "lines"
(each (chord, span) station's n_thick+1 nodes); solving those lines exactly
removes the anisotropic part of the spectrum. Per-group rigid-body modes then
give the coarse correction that bending needs at ~100k DOF.

The plan builders are numpy, copied from tpufem. The device parts are torch;
tpufem's segment sums become kernel E over CSR plans built once per topology
(``plan_device_arrays``, ``build_rbm_plan``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from tpufem_torch.mesher import WingTopology
from tpufem_torch.ops.csr_segment_sum import CsrPlan, csr_plan, csr_segment_sum


class NotPositiveDefiniteError(RuntimeError):
    """A block handed to spd_block_inverse is not positive definite in its
    dtype: a numerical breakdown of the preconditioner, which the FEM
    stage's solve ladder records as a failed attempt."""


def spd_block_inverse(B: torch.Tensor, ridge: float = 0.0) -> torch.Tensor:
    """Inverse of a batch (S, D, D) of SPD blocks: symmetric Jacobi scaling,
    then batched Cholesky.

    The scaling stays from tpufem: raw line blocks inherit the mesh's
    anisotropic conditioning (diagonal spread ~1e6+), which the scaling makes
    O(1). `ridge` adds ridge*I to the scaled blocks, as tpufem does: f32
    assembly round-off can leave a scaled matrix microscopically indefinite
    (tpufem measured an eigenvalue ~ -1e-5 on the RBM coarse operator).
    tpufem inverted the scaled blocks with Newton-Schulz matmuls because LU
    lowers to scalar loops on a TPU; batched Cholesky runs in f32 and f64 on
    CUDA. A block that is still not positive definite raises
    NotPositiveDefiniteError: there is no fallback.
    """
    B = 0.5 * (B + B.transpose(1, 2))  # kill accumulation asymmetry
    d = torch.diagonal(B, dim1=1, dim2=2)
    s = 1.0 / torch.sqrt(torch.clamp(d, min=1e-30))
    Bs = B * s[:, :, None] * s[:, None, :]
    if ridge:
        Bs = Bs + ridge * torch.eye(B.shape[-1], dtype=B.dtype, device=B.device)
    L, info = torch.linalg.cholesky_ex(Bs)
    bad = int((info != 0).sum())
    if bad:
        raise NotPositiveDefiniteError(f"spd_block_inverse: {bad} of {B.shape[0]} blocks "
                                       f"are not positive definite in {B.dtype}")
    X = torch.cholesky_inverse(L)
    X = 0.5 * (X + X.transpose(1, 2))  # SPD apply needs exact symmetry
    return X * s[:, :, None] * s[:, None, :]


# ------------------------------------------------------- line plan (numpy)


@dataclass(frozen=True)
class LinePrecondPlan:
    """Topology-constant scatter plan (host-precomputed)."""

    pair_t: np.ndarray  # (P,) tet index of each same-station node pair
    pair_a: np.ndarray  # (P,) local corner a in 0..3
    pair_b: np.ndarray  # (P,) local corner b in 0..3
    pair_seg: np.ndarray  # (P,) flat segment base: station*D*D + (3*slot_a)*D + 3*slot_b
    station_nodes: np.ndarray  # (S, K) node id per slot (duplicated node 0 on empty slots)
    slot_valid: np.ndarray  # (S, K) 1.0 where the slot holds a real node
    node_station: np.ndarray  # (N,) station of each node
    node_slot: np.ndarray  # (N,) slot of each node
    num_stations: int
    K: int  # slots per station
    D: int  # block dim = 3*K


def build_line_plan(topo: WingTopology) -> LinePrecondPlan:
    return build_line_plan_arrays(
        topo.tets, topo.station_id, topo.slot, topo.num_stations,
        topo.slots_per_station, topo.num_nodes,
    )


def build_line_plan_arrays(
    tets: np.ndarray,
    station_id: np.ndarray,
    slot: np.ndarray,
    num_stations: int,
    slots_per_station: int,
    num_nodes: int,
) -> LinePrecondPlan:
    st = np.asarray(station_id)
    sl = np.asarray(slot)
    S = int(num_stations)
    K = int(slots_per_station)
    D = 3 * K

    tets = np.asarray(tets).astype(np.int64)
    n_corners = tets.shape[1]
    cst = st[tets]  # (T, n_corners)
    csl = sl[tets]
    ti, ai, bi = [], [], []
    for a in range(n_corners):
        for b in range(n_corners):
            same = cst[:, a] == cst[:, b]
            idx = np.nonzero(same)[0]
            ti.append(idx)
            ai.append(np.full(len(idx), a))
            bi.append(np.full(len(idx), b))
    pair_t = np.concatenate(ti)
    pair_a = np.concatenate(ai)
    pair_b = np.concatenate(bi)
    st_p = cst[pair_t, pair_a]
    sa = csl[pair_t, pair_a]
    sb = csl[pair_t, pair_b]
    pair_seg = st_p.astype(np.int64) * (D * D) + (3 * sa) * D + 3 * sb

    station_nodes = np.zeros((S, K), dtype=np.int32)
    slot_valid = np.zeros((S, K), dtype=np.float32)
    station_nodes[st, sl] = np.arange(num_nodes, dtype=np.int32)
    slot_valid[st, sl] = 1.0

    return LinePrecondPlan(
        pair_t=pair_t.astype(np.int32),
        pair_a=pair_a.astype(np.int8),
        pair_b=pair_b.astype(np.int8),
        pair_seg=pair_seg,
        station_nodes=station_nodes,
        slot_valid=slot_valid,
        node_station=st.astype(np.int32),
        node_slot=sl.astype(np.int32),
        num_stations=S,
        K=K,
        D=D,
    )


def pair_blocks(plan: LinePrecondPlan) -> np.ndarray:
    """(P,) the (station, slot_a, slot_b) block of each same-station pair,
    station*K*K + slot_a*K + slot_b."""
    D, K = plan.D, plan.K
    st, rem = np.divmod(plan.pair_seg, D * D)
    return (st * K + rem // (3 * D)) * K + (rem % D) // 3


def station_device_arrays(plan: LinePrecondPlan, device="cpu") -> dict:
    """The plan's pair and station index tensors on `device` (int64), its
    slot_valid, and its sizes S and K."""
    out = {k: torch.as_tensor(np.asarray(getattr(plan, k)).astype(np.int64), device=device)
           for k in ("pair_t", "pair_a", "pair_b", "station_nodes", "node_station", "node_slot")}
    out["slot_valid"] = torch.as_tensor(plan.slot_valid, device=device)
    out["S"], out["K"] = plan.num_stations, plan.K
    return out


def plan_device_arrays(plan: LinePrecondPlan, device="cpu") -> dict:
    """The plan as device index tensors with its sizes S and K, plus the CSR
    plan that sums each
    same-station pair's 3x3 block into its (station, slot_a, slot_b) block:
    tpufem summed the 9 entries one by one into the flat (S*D*D,) matrix."""
    out = station_device_arrays(plan, device)
    out["blk_plan"] = csr_plan(pair_blocks(plan), plan.num_stations * plan.K * plan.K, device)
    return out


def line_blocks(plan: dict, grads, vols, lam, mu, free_mask):
    """Assemble and invert the per-station blocks -> (S, D, D) inverses.

    K_{ai,bj} = V*(lam*g_ai*g_bj + mu*g_aj*g_bi + mu*delta_ij*(g_a.g_b)) for
    same-station pairs; constrained/padded dofs replaced by identity rows so
    the blocks stay SPD. `plan` is the dict from plan_device_arrays.
    """
    ga = grads[plan["pair_t"], plan["pair_a"]]  # (P,3)
    gb = grads[plan["pair_t"], plan["pair_b"]]
    v = vols[plan["pair_t"]]
    eye = torch.eye(3, dtype=grads.dtype, device=grads.device)
    kab = v[:, None, None] * (
        lam * ga[:, :, None] * gb[:, None, :]
        + mu * gb[:, :, None] * ga[:, None, :]
        + mu * (ga * gb).sum(dim=1)[:, None, None] * eye
    )  # (P,3,3)
    return line_blocks_from_pairs(kab, plan, free_mask)


def line_blocks_from_pairs(kab, plan: dict, free_mask):
    """Sum precomputed (P,3,3) same-station pair blocks into per-station
    matrices (kernel E over plan["blk_plan"]), apply BC masking, invert."""
    S, K = plan["S"], plan["K"]
    D = 3 * K
    blk = csr_segment_sum(kab.reshape(-1, 9), plan["blk_plan"])  # (S*K*K, 9)
    B = blk.reshape(S, K, K, 3, 3).permute(0, 1, 3, 2, 4).reshape(S, D, D)
    return mask_and_invert(B, plan, free_mask)


def mask_and_invert(B, plan: dict, free_mask):
    """The inverses (S, D, D) of the station blocks B after the rows and
    columns of constrained dofs and of empty slots are replaced by identity
    (`plan`'s station_nodes and slot_valid), so that every block is SPD."""
    S, D = B.shape[0], B.shape[1]
    # dof validity: slot present AND free
    free3 = free_mask.reshape(-1, 3)
    fm = free3[plan["station_nodes"]] * plan["slot_valid"][:, :, None].to(free3.dtype)
    m = fm.reshape(S, D)
    B = B * m[:, :, None] * m[:, None, :]
    B = B + torch.eye(D, dtype=B.dtype, device=B.device)[None] * (1.0 - m)[:, :, None]
    return spd_block_inverse(B)


def make_line_preconditioner(plan: dict, Binv):
    """Return M(r_flat) -> z_flat applying the inverted station blocks
    (`plan` from plan_device_arrays)."""
    S, K = plan["S"], plan["K"]
    D = 3 * K
    station_nodes = plan["station_nodes"]
    node_station = plan["node_station"]
    node_slot = plan["node_slot"]

    def M(r_flat):
        rs = r_flat.reshape(-1, 3)[station_nodes].reshape(S, D, 1)  # gather lines
        zs = torch.bmm(Binv, rs).reshape(S, K, 3)
        return zs[node_station, node_slot].reshape(-1)  # scatter back

    return M


# ----------------------------------------------------- RBM two-level (single)


def build_rbm_groups(station_id, slot, ni: int, nj: int, group=(4, 4)):
    """(node_group (N,) int32, n_groups) for rigid-body-mode aggregation:
    (group x group station) x full-thickness aggregates."""
    st = np.asarray(station_id).astype(np.int64)
    ii, jj = st // nj, st % nj
    ngj = (nj + group[1] - 1) // group[1]
    ngi = (ni + group[0] - 1) // group[0]
    node_group = ((ii // group[0]) * ngj + (jj // group[1])).astype(np.int32)
    return node_group, int(ngi * ngj)


@dataclass(frozen=True)
class RbmPlan:
    """Topology-constant sums of the RBM coarse level on one device."""

    node_group: torch.Tensor  # (N,) int64
    n_groups: int
    group_plan: CsrPlan  # nodes -> their group
    pair_plans: tuple  # [a*n_corners + c]: tets -> (group of corner a, group of corner c)


def build_rbm_plan(node_group, n_groups: int, tets, device="cpu") -> RbmPlan:
    """Group and group-pair CSR plans; tpufem summed the coarse matrix's 36
    entries per tet corner pair one by one into the flat (nc*nc,) matrix."""
    ng = np.asarray(node_group).astype(np.int64)
    tg = ng[np.asarray(tets)]  # (T, corners)
    n_corners = tg.shape[1]
    pairs = tuple(csr_plan(tg[:, a] * n_groups + tg[:, c], n_groups * n_groups, device)
                  for a in range(n_corners) for c in range(n_corners))
    return RbmPlan(torch.as_tensor(ng, device=device), int(n_groups),
                   csr_plan(ng, n_groups, device), pairs)


def _rbm_basis(d):
    """(M,3) offsets -> (M,3,6) node RBM basis [I | e_k x d]."""
    z = torch.zeros_like(d[:, 0])
    dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]
    rx = torch.stack([z, -dz, dy], dim=1)
    ry = torch.stack([dz, z, -dx], dim=1)
    rz = torch.stack([-dy, dx, z], dim=1)
    ident = torch.eye(3, dtype=d.dtype, device=d.device)[None].expand(d.shape[0], 3, 3)
    rot = torch.stack([rx, ry, rz], dim=2)
    return torch.cat([ident, rot], dim=2)  # (M,3,6)


def _cross(u, v):
    return torch.linalg.cross(u, v, dim=1)


def rbm_coarse_inverse(rbm: RbmPlan, tets, nodes, grads, vols, lam, mu, free_mask,
                       ridge: float = 3e-4):
    """(Ac_inv (nc,nc), dvec (N,3)) for the RBM coarse correction: the
    Galerkin product P^T K P over per-group rigid-body modes (nc = 6 *
    n_groups), summed per group pair by kernel E, inverted with `ridge`."""
    G = rbm.n_groups
    nc = 6 * G
    ones = torch.ones((nodes.shape[0], 1), dtype=nodes.dtype, device=nodes.device)
    cx = csr_segment_sum(torch.cat([ones, nodes], dim=1), rbm.group_plan)  # (G,4)
    xg = cx[:, 1:] / torch.clamp(cx[:, :1], min=1.0)
    dvec = nodes - xg[rbm.node_group]  # (N,3)

    free3 = free_mask.reshape(-1, 3)
    eye3 = torch.eye(3, dtype=nodes.dtype, device=nodes.device)
    n_corners = tets.shape[1]
    acc = torch.zeros((G * G, 36), dtype=nodes.dtype, device=nodes.device)
    for a in range(n_corners):
        Pa = _rbm_basis(dvec[tets[:, a]])  # (T,3,6)
        ga = grads[:, a]
        fa = free3[tets[:, a]]
        for c in range(n_corners):
            gb = grads[:, c]
            kab = vols[:, None, None] * (
                lam * ga[:, :, None] * gb[:, None, :]
                + mu * gb[:, :, None] * ga[:, None, :]
                + mu * (ga * gb).sum(dim=1)[:, None, None] * eye3
            )
            kab = kab * fa[:, :, None] * free3[tets[:, c]][:, None, :]
            Pb = _rbm_basis(dvec[tets[:, c]])
            blk = Pa.transpose(1, 2) @ kab @ Pb  # (T,6,6)
            acc = acc + csr_segment_sum(blk.reshape(-1, 36), rbm.pair_plans[a * n_corners + c])
    Ac = acc.reshape(G, G, 6, 6).permute(0, 2, 1, 3).reshape(nc, nc)
    dg = torch.diagonal(Ac)
    act = (dg > 1e-8 * dg.max()).to(nodes.dtype)
    Ac = Ac * act[:, None] * act[None, :] + torch.diag(1.0 - act)
    return spd_block_inverse(Ac[None], ridge=ridge)[0], dvec


def make_rbm_two_level(M_line, Ac_inv, rbm: RbmPlan, dvec, free_mask):
    """M(r) = M_line(r) + P Ac^-1 P^T r with RBM prolongation."""
    free3 = free_mask.reshape(-1, 3)
    G = rbm.n_groups

    def M(r_flat):
        z1 = M_line(r_flat)
        r = r_flat.reshape(-1, 3) * free3
        rc = csr_segment_sum(torch.cat([r, _cross(dvec, r)], dim=1), rbm.group_plan)  # (G,6)
        zc = (Ac_inv @ rc.reshape(-1)).reshape(G, 6)
        zt = zc[:, :3][rbm.node_group]
        zw = zc[:, 3:][rbm.node_group]
        z2 = (zt + _cross(zw, dvec)) * free3
        return z1 + z2.reshape(-1)

    return M
