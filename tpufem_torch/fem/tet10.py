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
``A``) is kernel N (``csrc/tet10_force.cu``) on a CUDA tensor, over the
connectivity's tile plan (``force_plan``: every tet in one block of
neighbours), and ``tet10_force_plain`` on a CPU tensor. The gather engine's pieces follow:
``tet10_diagonal``, ``tet10_line_blocks`` (one fixed-order sum over the
same-station node pairs, ``line_plan10``) and the two-level host-facing
solve ``solve_tet10_case``; its p-multigrid is ``fem.tet10_mg``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from tpufem_torch.fem.assembly import check_incidence_inputs
from tpufem_torch.fem.precond import (
    build_line_plan_arrays,
    mask_and_invert,
    pair_blocks,
    station_device_arrays,
)
from tpufem_torch.mesh_types import Mesh
from tpufem_torch.ops.csr_segment_sum import (
    CsrPlan,
    csr_arrays,
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


def default_plan(tet10, num_nodes: int, device) -> CsrPlan:
    """The plan of a tet10_force or tet10_operator call that gives none: the
    connectivity's CSR plan, all the plain version reads. Kernel N takes
    the mesh's force_plan, which a bare connectivity cannot give (its cut
    follows the mesh's station metadata), so a CUDA device raises."""
    if torch.device(device).type == "cuda":
        raise ValueError("kernel N takes the mesh's plan: pass plan=force_plan(t10, device), "
                         "built once per topology")
    return connectivity_plan(tet10, num_nodes, device)


TILE_TETS = 432  # a block's tets, about: 3 x 3 cells at the flagship's full thickness
MIN_BLOCKS = 264  # smaller tiles where a mesh has fewer: two blocks on each of 132 SMs
MIN_TILE = 64  # but not below this many tets
TILE_ROWS = 4800  # a block's most interior rows and nodes: 112.5 KB of f64, two blocks an SM
SMEM_LIMIT = 232448  # a Hopper block's most shared memory


class ForcePlan10(NamedTuple):
    """Kernel N's plan of a (T,10) connectivity (force_plan): the CSR plan of
    tet10.reshape(-1) (the first six fields are a CsrPlan's, so kernel E and
    csr_segment_sum take it too: tet10_diagonal, tet10_stress_nodal) and the
    cut of the tets into blocks, every tet in one. A node whose entries all
    come from one block's tets is interior to that block; every other node
    (one no tet touches too) is a halo node. Each node's rows, in shared
    memory or gathered from the halo scratch (`hslot`), lie in ascending
    t*10+m order. A block stages the displacements of its tets' nodes (its
    closure) in shared memory beside its interior rows. The halo scratch is
    laid out in the order a block's warps write it (by block, warp of 32
    listed tets, m, lane), so that a warp's halo rows for one m are
    consecutive slots and its stores coalesce."""

    order: torch.Tensor  # (10T,) int32: stable argsort of tet10.reshape(-1)
    starts: torch.Tensor  # (N+1,) int32: node n's rows are order[starts[n]:starts[n+1]]
    seg: torch.Tensor  # (10T,) int64: the node of each row of `order`
    num_segments: int
    starts_host: np.ndarray  # (N+1,) int64: `starts` on the host (kernel E's cut)
    launch: dict  # kernel E's cuts by row width, filled at first use (launch_plan)
    ttet: torch.Tensor  # (T,) int32: the tets in block order, ascending within a block
    tstart: torch.Tensor  # (n_blocks+1,) int32: block b lists ttet[tstart[b]:tstart[b+1]]
    dst: torch.Tensor  # (10T,) int32: entry m of listed tet l at l*10+m: its row in its
    #                    block's shared memory, or ~ (bitwise not) its slot of the halo scratch
    inode: torch.Tensor  # int32: the interior nodes, block after block, ascending
    istart: torch.Tensor  # (n_blocks+1,) int32: block b's are inode[istart[b]:istart[b+1]]
    irow: torch.Tensor  # (len(inode)+1,) int32: interior node i's rows irow[i]:irow[i+1],
    #                     less irow[istart[b]] of its block b
    hnode: torch.Tensor  # int32: the halo nodes, ascending
    hrow: torch.Tensor  # (len(hnode)+1,) int32: halo node i's rows hrow[i]:hrow[i+1]
    hslot: torch.Tensor  # (halo_rows,) int32: each halo row's slot of the scratch
    cnode: torch.Tensor  # int32: the nodes of each block's tets, block after block, ascending
    cstart: torch.Tensor  # (n_blocks+1,) int32: block b's are cnode[cstart[b]:cstart[b+1]]
    lnode: torch.Tensor  # (10T,) int16: node m of listed tet l at l*10+m: its place in its
    #                      block's cnode
    rows: int  # the most interior rows of one block
    closure: int  # the most nodes of one block's tets (its shared memory: 3 values a row and
    #               a node)
    halo_rows: int  # the scratch's rows
    overlap: float  # tet evaluations per tet: 1
    halo_share: float  # halo rows / 10T
    args: tuple  # the kernel's plan arguments, ttet's pointer to closure, made once
    scratch: dict  # the halo scratch by (dtype, stream), made at first use (tet10_force)


def tet_cells(t10: Tet10Mesh) -> np.ndarray | None:
    """(T,2) the (chord, span) cell of each tet of a structured wing: the
    least doubled-grid station index of its corners, halved (a Kuhn tet holds
    its cell's first corner); None on a mesh without station metadata."""
    if t10.station_id is None:
        return None
    nj2 = 2 * int(t10.mesh4.meta["num_span_stations"]) - 1
    st = t10.station_id.astype(np.int64)[t10.tet10[:, :4]]
    return np.stack([(st // nj2).min(axis=1) // 2, (st % nj2).min(axis=1) // 2], axis=1)


def _tile_blocks(cells: np.ndarray, tile_tets: int) -> list:
    """Blocks of tets of a structured wing: tiles of a x b cells at full
    thickness, about tile_tets tets each (a tile with more is cut into equal
    runs of its tets); each block's tets ascending."""
    ci, cj = cells[:, 0].astype(np.int64), cells[:, 1].astype(np.int64)
    nj = int(cj.max()) + 1
    per_col = int(np.bincount(ci * nj + cj).max())  # the fullest column's tets
    cols = max(1, round(tile_tets / per_col))
    a = max(1, int(np.sqrt(cols)))
    b = max(1, cols // a)
    key = (ci // a) * (nj // b + 1) + cj // b
    order = np.argsort(key, kind="stable")  # by tile, the tets ascending in each
    bounds = np.flatnonzero(np.diff(key[order])) + 1
    blocks = []
    for tile in np.split(order, bounds):
        blocks += np.array_split(tile, -(-len(tile) // tile_tets))
    return blocks


def _rcm_blocks(tets: np.ndarray, num_nodes: int, tile_tets: int) -> list:
    """Blocks of tets of any mesh: the nodes in reverse Cuthill-McKee order of
    the node graph, each tet keyed by its lowest reordered node, runs of
    tile_tets tets in that order; each block's tets ascending."""
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    T, k = tets.shape
    inc = csr_matrix((np.ones(T * k, np.int32), tets.reshape(-1), np.arange(0, T * k + 1, k)),
                     shape=(T, num_nodes))
    perm = reverse_cuthill_mckee((inc.T @ inc).tocsr(), symmetric_mode=True)
    rank = np.empty(num_nodes, np.int64)
    rank[perm] = np.arange(num_nodes)
    order = np.argsort(rank[tets].min(axis=1), kind="stable")
    return [np.sort(b) for b in np.array_split(order, max(1, -(-T // tile_tets)))]


def _interior(order, starts, blk_of_tet, k: int):
    """(block of each node, interior mask): a node is interior when all its
    entries' tets lie in one block; a node no tet touches is not."""
    val = np.diff(starts)
    touched = np.flatnonzero(val)
    eb = blk_of_tet[order // k]
    first = starts[touched]
    bmin = np.full(len(val), -1, np.int64)
    bmax = np.full(len(val), -2, np.int64)
    if len(touched):
        bmin[touched] = np.minimum.reduceat(eb, first)
        bmax[touched] = np.maximum.reduceat(eb, first)
    return bmin, bmin == bmax


def force_plan(t10: Tet10Mesh, device, tile_tets: int = TILE_TETS) -> ForcePlan10:
    """Kernel N's plan of the mesh's (T,10) connectivity (host, once per
    topology; ForcePlan10): its CSR plan, so it also serves the segment sums
    of tet10_diagonal and tet10_stress_nodal, and its blocks of neighbouring
    tets, each tet in one. A structured wing (station metadata) is cut into
    tiles of cells at full thickness (tet_cells); the tets of any other mesh
    follow the reverse Cuthill-McKee order of its nodes. Blocks hold about
    tile_tets tets (smaller ones put most nodes on the halo: the tests' cuts),
    fewer (down to MIN_TILE) where that leaves under MIN_BLOCKS blocks, and
    a block with more than TILE_ROWS interior rows and staged nodes is
    halved until none has."""
    tets = np.asarray(t10.tet10).astype(np.int64)
    num_nodes = t10.num_nodes
    cells = tet_cells(t10)
    T, k = tets.shape
    order, starts, flat = csr_arrays(tets, num_nodes)
    val = np.diff(starts)
    tile_tets = max(1, min(tile_tets, max(MIN_TILE, -(-T // MIN_BLOCKS))))
    if T == 0:
        blocks = []
    elif cells is not None:
        blocks = _tile_blocks(cells, tile_tets)
    else:
        blocks = _rcm_blocks(tets, num_nodes, tile_tets)
    while True:  # halve the blocks whose rows and nodes overflow their shared memory
        blk_of_tet = np.empty(T, np.int64)
        for b, ts_ in enumerate(blocks):
            blk_of_tet[ts_] = b
        bnode, interior = _interior(order, starts, blk_of_tet, k)
        rows = np.bincount(bnode[interior], weights=val[interior], minlength=len(blocks))
        pairs = np.unique(np.repeat(blk_of_tet, k) * num_nodes + flat)  # (block, node)
        closure = np.bincount(pairs // num_nodes, minlength=len(blocks))
        over = np.flatnonzero(rows + closure > TILE_ROWS)
        if not len(over):
            break
        for b in over[::-1]:
            blocks[b:b + 1] = np.array_split(blocks[b], 2)
    nb = len(blocks)
    ttet = np.concatenate(blocks) if nb else np.zeros(0, np.int64)
    tstart = np.zeros(nb + 1, np.int64)
    np.cumsum([len(b) for b in blocks], out=tstart[1:])
    inode = np.flatnonzero(interior)
    inode = inode[np.argsort(bnode[inode], kind="stable")]  # block-major, ascending
    istart = np.zeros(nb + 1, np.int64)
    np.cumsum(np.bincount(bnode[inode], minlength=nb), out=istart[1:])
    irow = np.zeros(len(inode) + 1, np.int64)
    np.cumsum(val[inode], out=irow[1:])
    hnode = np.flatnonzero(~interior)
    hrow = np.zeros(len(hnode) + 1, np.int64)
    np.cumsum(val[hnode], out=hrow[1:])
    # each node's first row: in its block's shared memory, or in the scratch
    first = np.zeros(num_nodes, np.int64)
    first[inode] = irow[:-1] - irow[istart[bnode[inode]]]
    first[hnode] = hrow[:-1]
    pos = np.empty(T * k, np.int64)
    pos[order] = np.arange(T * k)
    dst = (first[flat] + pos - starts[flat]).reshape(T, k)[ttet]  # each listed entry's row
    # halo slots: by block, warp of 32 listed tets (g), m, lane
    lpos = np.arange(T) - np.repeat(tstart[:-1], np.diff(tstart))  # place in its block's list
    warps = -(-np.diff(tstart) // 32)  # each block's warps of 32 listed tets
    g = np.repeat(np.cumsum(warps) - warps, np.diff(tstart)) + lpos // 32
    halo_e = ~interior[flat].reshape(T, k)[ttet]
    key = ((g[:, None] * k + np.arange(k)) * 32 + (lpos % 32)[:, None])[halo_e]
    slot = np.empty(len(key), np.int64)
    slot[np.argsort(key, kind="stable")] = np.arange(len(key))
    hslot = np.empty(len(key), np.int64)
    hslot[dst[halo_e]] = slot
    dst[halo_e] = ~slot
    block_rows = irow[istart[1:]] - irow[istart[:-1]]
    cstart = np.zeros(nb + 1, np.int64)
    np.cumsum(closure, out=cstart[1:])
    listed = (ttet[:, None] * k + np.arange(k)).reshape(-1)  # entries in block order
    blk_listed = np.repeat(np.arange(nb), np.diff(tstart) * k)
    lnode = np.searchsorted(pairs, blk_listed * num_nodes + flat[listed]) - cstart[blk_listed]

    def to_dev(a, dtype=np.int32):
        return torch.as_tensor(np.ascontiguousarray(a, dtype=dtype), device=device)

    plan = ForcePlan10(
        order=to_dev(order), starts=to_dev(starts), seg=to_dev(flat[order], np.int64),
        num_segments=int(num_nodes), starts_host=starts, launch={}, ttet=to_dev(ttet),
        tstart=to_dev(tstart), dst=to_dev(dst.reshape(-1)), inode=to_dev(inode),
        istart=to_dev(istart), irow=to_dev(irow), hnode=to_dev(hnode), hrow=to_dev(hrow),
        hslot=to_dev(hslot), cnode=to_dev(pairs % max(num_nodes, 1)), cstart=to_dev(cstart),
        lnode=to_dev(lnode, np.int16), rows=int(block_rows.max(initial=0)),
        closure=int(closure.max(initial=0)), halo_rows=int(hrow[-1]), overlap=1.0,
        halo_share=float(hrow[-1] / max(T * k, 1)), args=(), scratch={})
    return plan._replace(args=(
        *(t.data_ptr() for t in (plan.ttet, plan.tstart, plan.dst, plan.inode, plan.istart,
                                 plan.irow, plan.hnode, plan.hrow, plan.hslot, plan.cnode,
                                 plan.cstart, plan.lnode)),
        nb, len(hnode), plan.rows, plan.closure))


def _host(a) -> np.ndarray:
    return np.asarray(a.cpu() if isinstance(a, torch.Tensor) else a)


def tet10_force_plain(Jinv, vols, tet10, x, lam, mu, plan, free=None):
    """Plain PyTorch version of kernel N: y (N,3) = K(x * free) * free +
    x * (1 - free), or K x where `free` is None; the element forces of
    _tet10_fe added per node in the plan's order from zero (any plan of
    tet10.reshape(-1): a CsrPlan or a ForcePlan10)."""
    u = x if free is None else x * free
    y = csr_segment_sum_plain(_tet10_fe(Jinv, vols, tet10, u, lam, mu).reshape(-1, 3), plan)
    return y if free is None else y * free + x * (1.0 - free)


def check_tet10_force_inputs(Jinv, vols, tet10, x, plan: ForcePlan10, free) -> None:
    """Raise unless kernel N takes these inputs as they are
    (assembly.check_incidence_inputs): Jinv (T,3,3), vols (T,), tet10
    (T,10) and its force_plan."""
    T = tet10.shape[0]
    if tet10.shape[1:] != (10,):
        raise ValueError(f"kernel N takes (T,10) tets, got {tuple(tet10.shape)}")
    check_incidence_inputs("N", {"Jinv": (Jinv, (T, 3, 3)), "vols": (vols, (T,))}, tet10, x,
                           plan, free, kind=ForcePlan10, builder="force_plan")
    if (3 * plan.halo_rows >= 2**31
            or (plan.rows + plan.closure) * 3 * x.element_size() > SMEM_LIMIT):
        raise ValueError(f"kernel N: a plan of {plan.halo_rows} halo rows and blocks of "
                         f"{plan.rows} rows and {plan.closure} nodes does not fit the kernel")


def tet10_force(Jinv, vols, tet10, u_nodes, lam, mu, num_nodes, elem_chunk=None, plan=None,
                free=None):
    """y = K u (N,3) for tet10, quadrature-point tensor form; with `free`
    (N,3), the masked operator y = K(u * free) * free + u * (1 - free).

    A CPU tensor takes tet10_force_plain (over the connectivity's CSR plan
    when `plan` is not given). A CUDA tensor launches kernel N
    (csrc/tet10_force.cu: its tiles, then its halo nodes, on the current
    stream; one count in `launches`) over `plan`, the mesh's force_plan, or
    raises (check_tet10_force_inputs). The halo scratch is the plan's, one
    for each dtype and stream. `elem_chunk` is accepted and ignored: tpufem
    scanned element blocks to bound its temporaries in a TPU's HBM; kernel N
    keeps the element forces in shared memory and its halo scratch."""
    del elem_chunk
    plan = plan or default_plan(tet10, num_nodes, u_nodes.device)
    if not u_nodes.is_cuda:
        return tet10_force_plain(Jinv, vols, tet10, u_nodes, lam, mu, plan, free)
    check_tet10_force_inputs(Jinv, vols, tet10, u_nodes, plan, free)
    y = torch.empty_like(u_nodes)
    stream = torch.cuda.current_stream(u_nodes.device).cuda_stream
    halo = plan.scratch.get((u_nodes.dtype, stream))
    if halo is None:
        halo = plan.scratch[(u_nodes.dtype, stream)] = torch.empty(
            3 * plan.halo_rows, dtype=u_nodes.dtype, device=u_nodes.device)
    lib = load_kernels()
    fn = (lib.tpufem_tet10_force_tiled_f64 if u_nodes.dtype == torch.float64
          else lib.tpufem_tet10_force_tiled_f32)
    status = fn(Jinv.data_ptr(), vols.data_ptr(), *plan.args[:12], u_nodes.data_ptr(),
                None if free is None else free.data_ptr(), y.data_ptr(), halo.data_ptr(),
                *plan.args[12:], float(lam), float(mu), stream)
    check(status, "tet10_force")
    tet10_force.launches += 1
    return y


tet10_force.launches = 0


def tet10_operator(Jinv, vols, tet10, lam, mu, num_nodes, free_mask, plan=None):
    """A(x) for the BC-reduced SPD system in flat (N*3,) layout: one
    tet10_force call with the Dirichlet mask (kernel N on the card)."""
    free3 = free_mask.reshape(-1, 3)
    plan = plan or default_plan(tet10, num_nodes, free3.device)

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
    plan = force_plan(t10, device)
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
