"""Tet10 (quadratic C3D10) elements: mesh promotion, matrix-free operator,
loads, stress recovery — port of ``tpufem/fem/tet10.py``.

With straight edges the Jacobian is constant per element, so only inv(J)
(T,3,3) and V (T,) are stored; quadrature-point shape gradients come from a
constant (Q,10,3) reference table contracted with inv(J). 4-point Gauss
quadrature integrates the (linear-strain)^2 stiffness exactly.

Node order: corners 0-3, then midpoints of edges
(0,1), (1,2), (2,0), (0,3), (1,3), (2,3) (CalculiX C3D10 convention).

Every segment sum goes through ``ops.csr_segment_sum`` (kernel E on a CUDA
tensor, a fixed summation order): float atomics would change the f64 loads'
last bits, and with them iteration counts, from run to run. The plan of a
connectivity is built on the host once and may be passed in.

The operator ``tet10_force`` (with the Dirichlet mask, the gather engine's
``A``) is kernel N (``csrc/tet10_force.cu``) on a CUDA tensor, one launch over
the connectivity's incidence plan (``force_plan``), and
``tet10_force_plain`` on a CPU tensor. The gather engine's pieces follow:
``tet10_diagonal``, ``tet10_line_blocks`` (one fixed-order sum over the
same-station node pairs, ``line_plan10``) and the two-level host-facing
solve ``solve_tet10_case``; its p-multigrid is ``fem.tet10_mg``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from tpufem_torch.fem.assembly import IncidencePlan, build_incidence, check_incidence_inputs
from tpufem_torch.fem.precond import (
    build_line_plan_arrays,
    mask_and_invert,
    pair_blocks,
    station_device_arrays,
)
from tpufem_torch.mesh_types import Mesh
from tpufem_torch.ops.csr_segment_sum import (
    CsrPlan,
    csr_plan,
    csr_segment_sum,
    csr_segment_sum_plain,
)
from tpufem_torch.ops.kernels import check, load_kernels

_EDGES = np.array([(0, 1), (1, 2), (2, 0), (0, 3), (1, 3), (2, 3)], dtype=np.int64)

# 4-point Gauss rule on the tet (degree-2 exact), barycentric a=0.5854102, b=0.1381966
_A, _B = 0.5854101966249685, 0.13819660112501053
GAUSS_POINTS = np.array(
    [
        [_A, _B, _B, _B],
        [_B, _A, _B, _B],
        [_B, _B, _A, _B],
        [_B, _B, _B, _A],
    ]
)  # barycentric (lambda0..lambda3)
GAUSS_WEIGHT = 0.25  # x V each


def _dndxi_table() -> np.ndarray:
    """(Q, 10, 3) gradients of the 10 shape functions wrt (xi1, xi2, xi3)
    where lambda0 = 1-xi1-xi2-xi3, lambda_i = xi_i."""
    dl = np.array([[-1.0, -1.0, -1.0], [1, 0, 0], [0, 1, 0], [0, 0, 1]])
    out = np.zeros((len(GAUSS_POINTS), 10, 3))
    for q, lam in enumerate(GAUSS_POINTS):
        # corners: N_a = lam_a*(2 lam_a - 1) -> dN = (4 lam_a - 1) dlam_a
        for a in range(4):
            out[q, a] = (4 * lam[a] - 1) * dl[a]
        # midsides: N = 4 lam_a lam_b -> dN = 4 (lam_a dlam_b + lam_b dlam_a)
        for e, (a, b) in enumerate(_EDGES):
            out[q, 4 + e] = 4 * (lam[a] * dl[b] + lam[b] * dl[a])
    return out


DNDXI = _dndxi_table()  # (4, 10, 3)


@dataclass
class Tet10Mesh:
    """Quadratic mesh derived from a tet4 Mesh."""

    mesh4: Mesh
    tet10: np.ndarray  # (T,10) int32
    edge_endpoints: np.ndarray  # (M,2) int32 corner-node ids per midpoint node
    surf_t6: np.ndarray  # (F,6) int32 quadratic boundary triangles (outward)
    num_nodes: int  # N4 + M
    station_id: np.ndarray | None = None  # doubled-grid stations (structured only)
    slot: np.ndarray | None = None
    num_stations: int = 0
    slots_per_station: int = 0

    def nodes10(self, nodes4):
        """Node coordinates (N10,3): corners then straight-edge midpoints, for
        numpy or torch corner coordinates (N4,3)."""
        a, b = self.edge_endpoints[:, 0], self.edge_endpoints[:, 1]
        if isinstance(nodes4, torch.Tensor):
            ia = torch.as_tensor(a, dtype=torch.long, device=nodes4.device)
            ib = torch.as_tensor(b, dtype=torch.long, device=nodes4.device)
            return torch.cat([nodes4, 0.5 * (nodes4[ia] + nodes4[ib])], dim=0)
        return np.concatenate([nodes4, 0.5 * (nodes4[a] + nodes4[b])], axis=0)


def tet10_from_tet4(mesh: Mesh) -> Tet10Mesh:
    """Promote a tet4 mesh: unique edges -> midpoint nodes, T6 boundary faces,
    and (for structured wing meshes) doubled-grid station/slot assignment for
    the thickness-line preconditioner.

    tpufem looks each boundary edge up in a Python dict over all edges
    (~1.9M at the flagship mesh); here the lookup is a binary search over the
    lexicographically sorted unique edges, keyed a * N4 + b: the same arrays."""
    tets = mesh.tets.astype(np.int64)
    N4 = mesh.num_nodes
    edges = np.sort(tets[:, _EDGES].reshape(-1, 2), axis=1)  # (T*6, 2)
    uniq, inv = np.unique(edges, axis=0, return_inverse=True)
    inv = inv.reshape(-1)
    mid_id = N4 + np.arange(len(uniq))
    tet10 = np.concatenate([tets, mid_id[inv].reshape(-1, 6)], axis=1).astype(np.int32)

    # boundary T6 faces: corner faces from mesh.surf_faces + their edge midpoints
    ukey = uniq[:, 0] * N4 + uniq[:, 1]  # increasing: uniq is sorted row by row
    sf = mesh.surf_faces.astype(np.int64)
    fe = []
    for pair in ((0, 1), (1, 2), (2, 0)):
        key = np.sort(sf[:, pair], axis=1)
        key = key[:, 0] * N4 + key[:, 1]
        idx = np.searchsorted(ukey, key)
        if not np.array_equal(ukey[np.minimum(idx, len(ukey) - 1)], key):
            raise KeyError("a boundary face edge is not an edge of the mesh")
        fe.append(N4 + idx)
    surf_t6 = np.concatenate([sf, np.stack(fe, axis=1)], axis=1).astype(np.int32)

    st = sl = None
    S = K = 0
    meta = mesh.meta or {}
    if "station_id" in meta and "num_span_stations" in meta:
        # every tet10 node is a point of the 2x-refined structured grid:
        # corner (i,j,k) -> (2i,2j,2k); midpoint -> sum of endpoints' indices
        st4 = np.asarray(meta["station_id"], dtype=np.int64)
        sl4 = np.asarray(meta["slot"], dtype=np.int64)
        NJ = int(meta["num_span_stations"])  # station = i*NJ + j
        i4, j4 = st4 // NJ, st4 % NJ
        i2 = np.concatenate([2 * i4, i4[uniq[:, 0]] + i4[uniq[:, 1]]])
        j2 = np.concatenate([2 * j4, j4[uniq[:, 0]] + j4[uniq[:, 1]]])
        k2 = np.concatenate([2 * sl4, sl4[uniq[:, 0]] + sl4[uniq[:, 1]]])
        NJ2 = 2 * NJ - 1
        st = (i2 * NJ2 + j2).astype(np.int32)
        sl = k2.astype(np.int32)
        NI2 = int(i2.max()) + 1
        S = NI2 * NJ2
        K = int(k2.max()) + 1

    return Tet10Mesh(
        mesh4=mesh,
        tet10=tet10,
        edge_endpoints=uniq.astype(np.int32),
        surf_t6=surf_t6,
        num_nodes=N4 + len(uniq),
        station_id=st,
        slot=sl,
        num_stations=S,
        slots_per_station=K,
    )


def _cross(u, v):
    """Cross product on the last axis of (..., 3) tensors."""
    return torch.stack(
        [
            u[..., 1] * v[..., 2] - u[..., 2] * v[..., 1],
            u[..., 2] * v[..., 0] - u[..., 0] * v[..., 2],
            u[..., 0] * v[..., 1] - u[..., 1] * v[..., 0],
        ],
        dim=-1,
    )


def tet10_setup(nodes10: torch.Tensor, tet10: torch.Tensor, tet_mask=None):
    """Constant per-element inv(J) (T,3,3) and volume (T,) (straight-edge
    tet10). The determinant is the triple product e0 . (e1 x e2), which
    tpufem's jnp.linalg.det (an LU) gives to rounding."""
    x = nodes10[tet10[:, :4].long()]  # corner geometry defines the affine map
    e = x[:, 1:] - x[:, :1]
    c0 = _cross(e[:, 1], e[:, 2])
    c1 = _cross(e[:, 2], e[:, 0])
    c2 = _cross(e[:, 0], e[:, 1])
    det = (e[:, 0] * c0).sum(dim=-1)
    vols = det / 6.0
    safe_det = torch.where(det.abs() > 0, det, torch.ones_like(det))
    inv = torch.stack([c0, c1, c2], dim=2) / safe_det[:, None, None]  # inv(J)
    valid = det.abs() > 0
    if tet_mask is not None:
        valid = valid & (tet_mask > 0)
    inv = torch.where(valid[:, None, None], inv, torch.zeros_like(inv))
    vols = torch.where(valid, vols, torch.zeros_like(vols))
    return inv, vols


def _quad_grads(Jinv: torch.Tensor) -> torch.Tensor:
    """(T,Q,10,3) physical gradients: grad_x N = inv(J) @ dN/dxi (with x =
    x0 + J^T xi, grad_x xi_i is column i of inv(J))."""
    table = torch.as_tensor(DNDXI, dtype=Jinv.dtype, device=Jinv.device)  # (Q,10,3)
    return torch.einsum("qaj,tij->tqai", table, Jinv)


def _quad_stress(g, ue, lam, mu):
    """Cauchy stress (T,Q,3,3) at the quadrature points from the gradients g
    (T,Q,10,3) and the element displacements ue (T,10,3)."""
    H = torch.einsum("tqai,taj->tqij", g, ue)
    eps = 0.5 * (H + H.transpose(2, 3))
    tr = eps[..., 0, 0] + eps[..., 1, 1] + eps[..., 2, 2]
    eye = torch.eye(3, dtype=g.dtype, device=g.device)
    return 2.0 * mu * eps + (lam * tr)[..., None, None] * eye


def _tet10_fe(Jinv, vols, conn, u_nodes, lam, mu):
    """Per-element internal force (T,10,3) for y = K u."""
    g = _quad_grads(Jinv)  # (T,Q,10,3)
    sigma = _quad_stress(g, u_nodes[conn.long()], lam, mu)
    sw = sigma * (GAUSS_WEIGHT * vols)[:, None, None, None]  # equal Gauss weights
    return torch.einsum("tqij,tqaj->tai", sw, g)


def connectivity_plan(tet10, num_nodes: int, device) -> CsrPlan:
    """The CSR plan of the (T,10) connectivity's node ids (host, once per
    topology): the segment sums of tet10_stress_nodal."""
    return csr_plan(_host(tet10), num_nodes, device)


def force_plan(tet10, num_nodes: int, device) -> IncidencePlan:
    """The incidence plan of the (T,10) connectivity (host, once per
    topology): kernel N's blocks, and the CSR plan of the same node ids (its
    first fields), so it also serves the segment sums of tet10_diagonal and
    tet10_stress_nodal."""
    return build_incidence(_host(tet10), num_nodes, device)


def _host(a) -> np.ndarray:
    return np.asarray(a.cpu() if isinstance(a, torch.Tensor) else a)


def tet10_force_plain(Jinv, vols, tet10, x, lam, mu, plan, free=None):
    """Plain PyTorch version of kernel N: y (N,3) = K(x * free) * free +
    x * (1 - free), or K x where `free` is None; the element forces of
    _tet10_fe added per node in the plan's order from zero (any plan of
    tet10.reshape(-1): a CsrPlan or an IncidencePlan)."""
    u = x if free is None else x * free
    y = csr_segment_sum_plain(_tet10_fe(Jinv, vols, tet10, u, lam, mu).reshape(-1, 3), plan)
    return y if free is None else y * free + x * (1.0 - free)


def check_tet10_force_inputs(Jinv, vols, tet10, x, plan: IncidencePlan, free) -> None:
    """Raise unless kernel N takes these inputs as they are
    (assembly.check_incidence_inputs): Jinv (T,3,3), vols (T,), tet10
    (T,10) and its force_plan."""
    T = tet10.shape[0]
    if tet10.shape[1:] != (10,):
        raise ValueError(f"kernel N takes (T,10) tets, got {tuple(tet10.shape)}")
    check_incidence_inputs("N", {"Jinv": (Jinv, (T, 3, 3)), "vols": (vols, (T,))}, tet10, x,
                           plan, free)


def tet10_force(Jinv, vols, tet10, u_nodes, lam, mu, num_nodes, elem_chunk=None, plan=None,
                free=None):
    """y = K u (N,3) for tet10, quadrature-point tensor form; with `free`
    (N,3), the masked operator y = K(u * free) * free + u * (1 - free).

    A CPU tensor takes tet10_force_plain. A CUDA tensor launches kernel N
    (csrc/tet10_force.cu), one launch for the whole function, over `plan`
    (force_plan, built here when not given), or raises
    (check_tet10_force_inputs). `elem_chunk` is accepted and ignored: tpufem
    scanned element blocks to bound its temporaries in a TPU's HBM; kernel N
    keeps the element forces in shared memory."""
    del elem_chunk
    plan = plan or force_plan(tet10, num_nodes, u_nodes.device)
    if not u_nodes.is_cuda:
        return tet10_force_plain(Jinv, vols, tet10, u_nodes, lam, mu, plan, free)
    check_tet10_force_inputs(Jinv, vols, tet10, u_nodes, plan, free)
    y = torch.empty_like(u_nodes)
    lib = load_kernels()
    fn = (lib.tpufem_tet10_force_f64 if u_nodes.dtype == torch.float64
          else lib.tpufem_tet10_force_f32)
    status = fn(Jinv.data_ptr(), vols.data_ptr(), tet10.data_ptr(), plan.pos.data_ptr(),
                plan.btet.data_ptr(), plan.bt_start.data_ptr(), plan.bnode.data_ptr(),
                plan.starts.data_ptr(), u_nodes.data_ptr(),
                None if free is None else free.data_ptr(), y.data_ptr(),
                plan.bnode.shape[0] - 1, plan.slots, float(lam), float(mu),
                torch.cuda.current_stream(u_nodes.device).cuda_stream)
    check(status, "tet10_force")
    tet10_force.launches += 1
    return y


tet10_force.launches = 0


def tet10_operator(Jinv, vols, tet10, lam, mu, num_nodes, free_mask, plan=None):
    """A(x) for the BC-reduced SPD system in flat (N*3,) layout: one
    tet10_force call with the Dirichlet mask (kernel N on the card)."""
    free3 = free_mask.reshape(-1, 3)
    plan = plan or force_plan(tet10, num_nodes, free3.device)

    def apply(x_flat):
        return tet10_force(Jinv, vols, tet10, x_flat.reshape(-1, 3), lam, mu, num_nodes,
                           plan=plan, free=free3).reshape(-1)

    return apply


def tet10_diagonal(Jinv, vols, tet10, lam, mu, num_nodes, free_mask, plan=None):
    """diag(K) (N*3,) with unit entries on constrained dofs (Jacobi): per
    element and node, sum_q w (lam + mu) g_qai^2 + mu |g_qa|^2, summed per
    node by kernel E over `plan` (connectivity_plan or force_plan)."""
    g2 = _quad_grads(Jinv) ** 2  # (T,Q,10,3)
    gg = g2.sum(dim=3, keepdim=True)
    w = (GAUSS_WEIGHT * vols)[:, None, None, None]
    d = (w * ((lam + mu) * g2 + mu * gg)).sum(dim=1)  # (T,10,3)
    plan = plan or connectivity_plan(tet10, num_nodes, Jinv.device)
    diag = csr_segment_sum(d.reshape(-1, 3), plan).reshape(-1)
    return torch.where((free_mask > 0) & (diag > 0), diag, torch.ones_like(diag))


def line_plan10(tet10, station_id, slot, S: int, K: int, device) -> dict:
    """The same-station pair plan of tet10_line_blocks for the (T,10)
    connectivity whose nodes sit at (station_id, slot) of S stations of K
    slots (host, once per topology): precond.build_line_plan_arrays's pairs
    (grouped by (a, b) in a-major order, the tets ascending; pair_offsets
    (101,) on the host) and station arrays on `device`, and blk_plan, the CSR
    plan that sums each pair's 3x3 block into its (station, slot_a, slot_b)
    block. Only the blocks some pair touches are segments (`used`, their
    station*K*K + slot_a*K + slot_b): at the flagship 2.6M of the 14.3M
    (49,601 stations x 17 x 17), whose empty segments would swell kernel E's
    launch table with their listings."""
    st = _host(station_id)
    lp = build_line_plan_arrays(_host(tet10), st, _host(slot), S, K, len(st))
    counts = np.bincount(lp.pair_a.astype(np.int64) * 10 + lp.pair_b, minlength=100)
    used, seg = np.unique(pair_blocks(lp), return_inverse=True)
    return {**station_device_arrays(lp, device),
            "pair_offsets": np.concatenate([[0], np.cumsum(counts)]),
            "blk_plan": csr_plan(seg, len(used), device),
            "used": torch.as_tensor(used, device=device)}


def tet10_line_blocks_raw(Jinv, vols, lam, mu, plan: dict) -> torch.Tensor:
    """The raw per-station thickness-line blocks (S, D, D), D = 3K, of
    tpufem's tet10_line_blocks before masking and inversion: for each of the
    100 node pairs (a, b) of a tet on one station, sum_q w [lam ga gb^T + mu
    gb ga^T + mu (ga . gb) I] with w = V/4, the pairs' 3x3 blocks summed by
    kernel E over plan["blk_plan"] (line_plan10) in one fixed order.
    tpufem added 100 segment sums of T*9 values into S*D*D slots; the same
    sum runs here over the same-station rows only."""
    S, K = plan["S"], plan["K"]
    D = 3 * K
    g = _quad_grads(Jinv)  # (T,Q,10,3)
    w = GAUSS_WEIGHT * vols
    eye = torch.eye(3, dtype=Jinv.dtype, device=Jinv.device)
    off = plan["pair_offsets"]
    kab = torch.empty((int(off[-1]), 3, 3), dtype=Jinv.dtype, device=Jinv.device)
    for a in range(10):
        for b in range(10):
            o0, o1 = int(off[10 * a + b]), int(off[10 * a + b + 1])
            t = plan["pair_t"][o0:o1]
            ga, gb = g[t, :, a], g[t, :, b]  # (P,Q,3)
            outer = torch.einsum("pqi,pqj->pij", ga, gb)
            wv = w[t]
            kab[o0:o1] = (wv[:, None, None] * (lam * outer + mu * outer.transpose(1, 2))
                          + (wv * mu * (ga * gb).sum(dim=(1, 2)))[:, None, None] * eye)
    blk = torch.zeros((S * K * K, 9), dtype=Jinv.dtype, device=Jinv.device)
    blk[plan["used"]] = csr_segment_sum(kab.reshape(-1, 9), plan["blk_plan"])
    return blk.reshape(S, K, K, 3, 3).permute(0, 1, 3, 2, 4).reshape(S, D, D)


def tet10_line_blocks(Jinv, vols, tet10, station_id, slot, lam, mu, free_mask, S: int, K: int,
                      plan: dict | None = None):
    """Inverted per-station line blocks (S, D, D) for tet10: the raw blocks
    (tet10_line_blocks_raw over `plan`, line_plan10 of the mesh), the rows
    and columns of constrained dofs and of empty slots replaced by identity,
    then inverted (precond.spd_block_inverse). `tet10`, `station_id`,
    `slot`, S and K are tpufem's arguments; where `plan` is given they must
    be its mesh's."""
    plan = plan or line_plan10(tet10, station_id, slot, S, K, Jinv.device)
    return mask_and_invert(tet10_line_blocks_raw(Jinv, vols, lam, mu, plan), plan, free_mask)


def t6_plan(t6_faces, num_nodes: int, device) -> CsrPlan:
    """The CSR plan of the T6 faces' midside node ids (host, once per face set)."""
    faces = np.asarray(t6_faces.cpu() if isinstance(t6_faces, torch.Tensor) else t6_faces)
    return csr_plan(faces[:, 3:], num_nodes, device)


def t6_midside_forces(nodes10, t6_faces, pressure, face_mask=None):
    """The (3F, 3[*B]) rows that pressure_loads_t6 sums over t6_plan: each
    face's midside force A*p/3, once per midside node."""
    faces = torch.as_tensor(np.asarray(t6_faces), dtype=torch.long, device=nodes10.device)
    v = nodes10[faces[:, :3]]  # (F,3,3[,B])
    d1, d2 = v[:, 1] - v[:, 0], v[:, 2] - v[:, 0]
    area_vec = 0.5 * _cross(d1.movedim(1, -1), d2.movedim(1, -1)).movedim(-1, 1)  # A n_hat
    f_mid = (-pressure / 3.0) * area_vec  # per midside node
    if face_mask is not None:
        fm = torch.as_tensor(face_mask, dtype=f_mid.dtype, device=f_mid.device)
        f_mid = f_mid * fm.reshape(-1, *([1] * (f_mid.dim() - 1)))
    F = faces.shape[0]
    return f_mid[:, None].expand(F, 3, *f_mid.shape[1:]).reshape(3 * F, -1).contiguous()


def pressure_loads_t6(nodes10, t6_faces, pressure, num_nodes, face_mask=None, plan=None):
    """Consistent nodal loads for uniform pressure on quadratic triangles:
    corner shares are exactly 0 and each midside carries A*p/3 (standard T6
    consistent load vector with straight edges).

    nodes10 (N,3) gives (N,3); nodes10 (N,3,B), B wings of one topology,
    gives (N,3,B) in one segment sum (tpufem vmaps over the wings)."""
    f6 = t6_midside_forces(nodes10, t6_faces, pressure, face_mask)
    plan = plan or t6_plan(t6_faces, num_nodes, nodes10.device)
    return csr_segment_sum(f6, plan).reshape(num_nodes, *nodes10.shape[1:])


def tet10_root_nodes(t10: Tet10Mesh, y_tol: float = 1e-4) -> np.ndarray:
    nodes10 = t10.nodes10(t10.mesh4.nodes)
    return np.nonzero(nodes10[:, 1] <= y_tol)[0].astype(np.int32)


def tet10_upper_t6(t10: Tet10Mesh, upper_face_idx: np.ndarray) -> np.ndarray:
    """T6 faces corresponding to tet4 boundary-set face indices (the T6 face
    array is built in the same order as mesh.surf_faces)."""
    return t10.surf_t6[np.asarray(upper_face_idx)]


def stress_nodal_terms(Jinv, vols, tet10, u_nodes, lam, mu):
    """The (10T,6) numerator and (10T,1) denominator rows that
    tet10_stress_nodal sums over connectivity_plan: each element's
    volume-weighted mean Voigt stress and its volume, once per node."""
    g = _quad_grads(Jinv)
    sig_mean = _quad_stress(g, u_nodes[tet10.long()], lam, mu).mean(dim=1)  # (T,3,3)
    voigt = torch.stack(
        [
            sig_mean[:, 0, 0],
            sig_mean[:, 1, 1],
            sig_mean[:, 2, 2],
            sig_mean[:, 0, 1],
            sig_mean[:, 1, 2],
            sig_mean[:, 2, 0],
        ],
        dim=1,
    )
    w = vols
    T = w.shape[0]
    return ((w[:, None] * voigt)[:, None, :].expand(T, 10, 6).reshape(-1, 6),
            w[:, None].expand(T, 10).reshape(-1, 1))


def tet10_stress_nodal(Jinv, vols, tet10, u_nodes, lam, mu, num_nodes, plan=None):
    """Quad-point stresses -> volume-weighted nodal (N,6) Voigt average."""
    num, den = stress_nodal_terms(Jinv, vols, tet10, u_nodes, lam, mu)
    plan = plan or connectivity_plan(tet10, num_nodes, u_nodes.device)
    return csr_segment_sum(num, plan) / torch.clamp(csr_segment_sum(den, plan), min=1e-300)


def solve_tet10_case(
    t10: Tet10Mesh,
    nroot_nodes10: np.ndarray,
    upper_t6: np.ndarray,
    pressure: float,
    material=None,
    tol: float = 1e-6,
    maxiter: int = 20000,
    dtype=torch.float32,
    chunk_iters: int = 0,
    two_level: bool = True,
    nj2: int | None = None,
    device="cuda",
):
    """Full tet10 linear-static solve (host-facing), on `device` (the card
    unless the caller asks for the CPU).

    Returns (u (N,3), vm (N,), iters, rel_residual, converged) over the tet10
    node set, numpy on the host. Uses the thickness-line preconditioner (+
    RBM two-level coarse correction when two_level and the doubled-grid
    stations are available; nj2 = span station count of the doubled grid,
    i.e. 2*(n_span+1)-1), Jacobi otherwise. The operator is kernel N on the
    card; every segment sum is kernel E. chunk_iters is accepted for
    tpufem's signature: it bounded a TPU dispatch, and the port runs one CG
    (fem.solver.pcg)."""
    from tpufem_torch.device import resolve_device
    from tpufem_torch.fem.bc import dirichlet_mask
    from tpufem_torch.fem.material import Material, lame_params
    from tpufem_torch.fem.precond import (
        build_rbm_groups,
        build_rbm_plan,
        make_line_preconditioner,
        make_rbm_two_level,
        rbm_coarse_inverse,
    )
    from tpufem_torch.fem.solver import pcg
    from tpufem_torch.fem.vonmises import von_mises

    del chunk_iters
    device = resolve_device(device)
    lam, mu = lame_params(material or Material())
    # the `dtype` system sees the Lame constants rounded to it, as tpufem's
    lam, mu = (float(torch.tensor(v, dtype=dtype)) for v in (lam, mu))
    nodes10 = torch.as_tensor(t10.nodes10(t10.mesh4.nodes), dtype=dtype, device=device)
    conn = torch.as_tensor(t10.tet10, dtype=torch.int32, device=device)
    N = t10.num_nodes
    plan = force_plan(t10.tet10, N, device)
    free = dirichlet_mask(N, nroot_nodes10, dtype=dtype, device=device)
    Jinv, vols = tet10_setup(nodes10, conn)
    f = pressure_loads_t6(nodes10, upper_t6, pressure, N)
    b = f.reshape(-1) * free
    A = tet10_operator(Jinv, vols, conn, lam, mu, N, free, plan=plan)

    if t10.station_id is not None:
        S, K = t10.num_stations, t10.slots_per_station
        lplan = line_plan10(t10.tet10, t10.station_id, t10.slot, S, K, device)
        Binv = tet10_line_blocks(Jinv, vols, conn, t10.station_id, t10.slot, lam, mu, free,
                                 S=S, K=K, plan=lplan)
        M = make_line_preconditioner(lplan, Binv)
        if two_level and nj2 is not None:
            ni2 = t10.num_stations // nj2
            node_group, n_groups = build_rbm_groups(t10.station_id, t10.slot, ni2, nj2,
                                                    group=(8, 8))
            rbm = build_rbm_plan(node_group, n_groups, t10.tet10, device)
            grads_c = _quad_grads(Jinv).mean(dim=1)  # (T,10,3) avg-point grads
            Ac_inv, dvec = rbm_coarse_inverse(rbm, conn.long(), nodes10, grads_c, vols, lam, mu,
                                              free)
            M = make_rbm_two_level(M, Ac_inv, rbm, dvec, free)
    else:
        diag = tet10_diagonal(Jinv, vols, conn, lam, mu, N, free, plan=plan)
        M = None

    res = pcg(A, b, diag=None if M is not None else diag, tol=tol, maxiter=maxiter, M=M)
    u = (res.x * free).reshape(-1, 3)
    vm = von_mises(tet10_stress_nodal(Jinv, vols, conn, u, lam, mu, N, plan=plan))
    return (u.cpu().numpy(), vm.cpu().numpy(), int(res.iters), float(res.rel_residual),
            bool(res.converged))
