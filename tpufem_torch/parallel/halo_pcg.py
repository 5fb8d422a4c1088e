"""Halo-exchange PCG on spanwise slabs — port of ``tpufem/parallel/halo_pcg.py``.

Nodes are ordered span-major by their layer (tet4: span station j; tet10:
doubled-grid station j2), so each rank owns a contiguous spanwise slab and
every element touches at most W consecutive layers (tet4: 2, tet10: 3). Per
CG iteration:

    ghosts  = from_next(first (W-1)-layer nodes)   # the next rank's, backward
    f_local = element forces on the extended local mesh (kernel D or N)
    f_ghost = contributions to the ghost rows, to_next'd forward and added
    dots    = all_reduce_sum(local partials)

The slabs may be uneven (layers np.array_split over the ranks, every rank's
arrays padded to the largest slab), and the preconditioner is tpufem's two
levels inside the sharded operator: slab-local thickness-line blocks (the
ghost station bands shipped forward at setup) plus the rigid-body-mode
coarse correction, whose small dense system is all-reduced and solved
redundantly on every rank.

The partition (build_halo_partition) is host numpy, tpufem's exactly. The
operator on a rank's extended mesh is kernel D (tet4) or kernel N over
force_plan (tet10, its RCM cut on such a mesh), unmasked, then the foldback;
padded elements are left out of the local plans, because D and N take no
element mask. Every fixed-order sum is kernel E: the loads, the line pair
blocks, the RBM group sums and the coarse pair blocks. tpufem's psum is
comm.all_reduce_sum, its ppermute comm.from_next / comm.to_next;
`chunk_iters` is accepted and ignored (the port's CG runs as one loop).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from tpufem_torch.fem.material import Material, lame_params
from tpufem_torch.fem.precond import _rbm_basis, build_rbm_plan, spd_block_inverse
from tpufem_torch.fem.stencil_mg import _cg_grid_init, _cg_grid_run
from tpufem_torch.mesher import WingMeshResolution, structured_wing_mesh, wing_topology
from tpufem_torch.ops.csr_segment_sum import csr_plan, csr_segment_sum
from tpufem_torch.parallel.comm import all_gather, all_reduce_sum, from_next, to_next
from tpufem_torch.parallel.meshes import DeviceGroup
from tpufem_torch.sets import build_boundary_sets


@dataclass
class HaloPartition:
    """Host-prepared per-rank arrays (leading axis = rank).

    Node layout per rank: slots [0, n_max) hold owned nodes (padded; padding
    slots are fully masked), slots [n_max, n_max + g_max) hold ghosts = the
    next rank's first nodes in its local order.
    """

    n_devices: int
    element: str  # 'tet4' | 'tet10'
    V: int  # nodes per element
    W: int  # element layer span (ghost width = W - 1)
    n_max: int  # owned-node slots per rank
    g_max: int  # ghost slots
    NI: int  # stations per layer
    K: int  # slots per station
    s_max: int  # owned-station slots per rank (NI * max layers)
    s_ghost: int  # ghost-station slots (NI * (W - 1))
    nodes: np.ndarray  # (D, n_max, 3)
    node_mask: np.ndarray  # (D, n_max)
    elems: np.ndarray  # (D, T_max, V) local ids in [0, n_max + g_max)
    elem_mask: np.ndarray  # (D, T_max)
    faces: np.ndarray  # (D, F_max, Vf) loaded faces, local ids
    face_mask: np.ndarray  # (D, F_max)
    free: np.ndarray  # (D, n_max, 3)
    node_station: np.ndarray  # (D, n_max) local station in [0, s_max + s_ghost)
    node_slot: np.ndarray  # (D, n_max)
    elem_station: np.ndarray  # (D, T_max, V)
    elem_slot: np.ndarray  # (D, T_max, V)
    station_nodes: np.ndarray  # (D, s_max, K) local node id per slot
    slot_valid: np.ndarray  # (D, s_max, K)
    node_group: np.ndarray  # (D, n_max) global RBM group of each owned node
    n_groups: int
    perm: np.ndarray  # global span-major order: new -> old
    num_nodes: int  # global welded node count
    dev_of_node: np.ndarray  # (N,) owner rank of each global (new-order) node


def _wing_arrays(res: WingMeshResolution, span, chord, sweep, t, element: str):
    """Global welded arrays for either element type, plus layer/station maps."""
    topo = wing_topology(res)
    mesh = structured_wing_mesh(span, chord, sweep, t, res)
    bs = build_boundary_sets(mesh)
    NJ = res.n_span + 1
    st4 = topo.station_id.astype(np.int64)
    i4, j4 = st4 // NJ, st4 % NJ

    if element == "tet4":
        nodes = mesh.nodes
        elems = topo.tets.astype(np.int64)
        faces = mesh.surf_faces[bs.surf_upper_faces].astype(np.int64)
        layer = j4
        n_layers = NJ
        chord_i = i4
        slot = topo.slot.astype(np.int64)
        K = topo.slots_per_station
        NI = res.n_chord + 1
        W = 2
        free = np.ones((topo.num_nodes, 3), np.float32)
        free[bs.nroot_nodes] = 0.0
    elif element == "tet10":
        from tpufem_torch.fem.tet10 import tet10_from_tet4, tet10_root_nodes, tet10_upper_t6

        t10 = tet10_from_tet4(mesh)
        nodes = t10.nodes10(mesh.nodes)
        elems = t10.tet10.astype(np.int64)
        faces = tet10_upper_t6(t10, bs.surf_upper_faces).astype(np.int64)
        NJ2 = 2 * NJ - 1
        st2 = t10.station_id.astype(np.int64)
        chord_i = st2 // NJ2
        layer = st2 % NJ2
        n_layers = NJ2
        slot = t10.slot.astype(np.int64)
        K = t10.slots_per_station
        NI = int(chord_i.max()) + 1
        W = 3
        free = np.ones((t10.num_nodes, 3), np.float32)
        free[tet10_root_nodes(t10)] = 0.0
    else:
        raise ValueError(element)
    return nodes, elems, faces, layer, n_layers, chord_i, slot, K, NI, W, free


def build_halo_partition(
    res: WingMeshResolution,
    n_devices: int,
    span_m: float,
    chord_m: float,
    sweep_deg: float,
    thickness_ratio: float,
    dtype=np.float32,
    element: str = "tet4",
    rbm_group=(4, 4),
) -> HaloPartition:
    """The uneven span-slab partition of the wing over n_devices ranks (host
    numpy, tpufem's arrays exactly)."""
    nodes, elems, faces, layer, n_layers, chord_i, slot, K, NI, W, free = _wing_arrays(
        res, span_m, chord_m, sweep_deg, thickness_ratio, element
    )
    D = n_devices
    N = len(nodes)
    if n_layers < D * W:
        raise ValueError(f"{n_layers} layers cannot be split over {D} devices (need >= {D * W})")

    # span-major node order: (layer, chord station, slot)
    key = (layer * NI + chord_i) * K + slot
    perm = np.argsort(key, kind="stable")  # new -> old
    inv = np.empty_like(perm)
    inv[perm] = np.arange(N)

    layer_n, chord_n, slot_n = layer[perm], chord_i[perm], slot[perm]
    nodes_n = nodes[perm]
    free_n = free[perm]
    elems_n = inv[elems]
    faces_n = inv[faces]

    # uneven slab split of layers
    layer_sets = np.array_split(np.arange(n_layers), D)
    first_layer = np.array([ls[0] for ls in layer_sets])
    dev_of_layer = np.zeros(n_layers, np.int64)
    for d, ls in enumerate(layer_sets):
        dev_of_layer[ls] = d
    dev_of_node = dev_of_layer[layer_n]
    node_start = np.searchsorted(dev_of_node, np.arange(D))
    node_end = np.append(node_start[1:], N)
    n_loc = node_end - node_start
    n_max = int(n_loc.max())

    # ghosts: next rank's first nodes covering (W-1) layers
    g_cnt = np.zeros(D, np.int64)
    for d in range(D - 1):
        nxt = d + 1
        gl = layer_sets[nxt][: W - 1]
        sel = np.isin(layer_n[node_start[nxt] : node_end[nxt]], gl)
        g_cnt[d] = int(sel.sum())
        assert sel[: g_cnt[d]].all(), "ghost nodes must be a prefix of the next slab"
    g_max = int(g_cnt.max()) if D > 1 else 0

    def local_id(global_new, d):
        """Map global new-order node ids to rank-d local slots."""
        own = (global_new >= node_start[d]) & (global_new < node_end[d])
        nxt_start = node_end[d]
        out = np.where(own, global_new - node_start[d], n_max + (global_new - nxt_start))
        bad = ~own & ((global_new < nxt_start) | (global_new >= nxt_start + max(g_max, 1)))
        if bad.any():
            raise AssertionError("element references a node outside slab+ghost")
        return out

    # elements / faces by owner = rank of min layer
    e_dev = dev_of_layer[layer_n[elems_n].min(axis=1)]
    f_dev = dev_of_layer[layer_n[faces_n].min(axis=1)]
    T_max = int(np.bincount(e_dev, minlength=D).max())
    F_max = max(int(np.bincount(f_dev, minlength=D).max()), 1)
    V = elems.shape[1]
    Vf = faces.shape[1]

    max_layers = max(len(ls) for ls in layer_sets)
    s_max = NI * max_layers
    s_ghost = NI * (W - 1)

    def station_of(global_new, d):
        """Local station id: owned layers first (layer-major), ghosts after."""
        lay = layer_n[global_new]
        loc_lay = lay - first_layer[d]
        own_lay = len(layer_sets[d])
        ghost = loc_lay >= own_lay
        return np.where(
            ghost,
            s_max + (loc_lay - own_lay) * NI + chord_n[global_new],
            loc_lay * NI + chord_n[global_new],
        )

    elems_l = np.zeros((D, T_max, V), np.int32)
    elem_mask = np.zeros((D, T_max), dtype)
    elem_station = np.zeros((D, T_max, V), np.int32)
    elem_slot = np.zeros((D, T_max, V), np.int32)
    faces_l = np.zeros((D, F_max, Vf), np.int32)
    face_mask = np.zeros((D, F_max), dtype)
    nodes_p = np.zeros((D, n_max, 3), dtype)
    node_mask = np.zeros((D, n_max), dtype)
    free_p = np.zeros((D, n_max, 3), dtype)
    node_station = np.zeros((D, n_max), np.int32)
    node_slot = np.zeros((D, n_max), np.int32)
    station_nodes = np.zeros((D, s_max, K), np.int32)
    slot_valid = np.zeros((D, s_max, K), np.float32)

    for d in range(D):
        sl_own = slice(node_start[d], node_end[d])
        n_d = n_loc[d]
        nodes_p[d, :n_d] = nodes_n[sl_own]
        node_mask[d, :n_d] = 1.0
        free_p[d, :n_d] = free_n[sl_own]
        gids = np.arange(node_start[d], node_end[d])
        st_l = station_of(gids, d)
        node_station[d, :n_d] = st_l
        node_slot[d, :n_d] = slot_n[sl_own]
        station_nodes[d][st_l, slot_n[sl_own]] = np.arange(n_d, dtype=np.int32)
        slot_valid[d][st_l, slot_n[sl_own]] = 1.0

        sel = np.nonzero(e_dev == d)[0]
        ge = elems_n[sel]
        elems_l[d, : len(sel)] = local_id(ge, d)
        elem_mask[d, : len(sel)] = 1.0
        elem_station[d, : len(sel)] = station_of(ge, d)
        elem_slot[d, : len(sel)] = slot_n[ge]

        fsel = np.nonzero(f_dev == d)[0]
        if len(fsel):
            faces_l[d, : len(fsel)] = local_id(faces_n[fsel], d)
            face_mask[d, : len(fsel)] = 1.0

    # RBM groups: (chord-group x layer-group) aggregates of GLOBAL stations
    gi, gl = rbm_group
    ngi = (NI + gi - 1) // gi
    ngl = (n_layers + gl - 1) // gl
    node_group_glob = ((chord_n // gi) * ngl + (layer_n // gl)).astype(np.int32)
    node_group = np.zeros((D, n_max), np.int32)
    for d in range(D):
        node_group[d, : n_loc[d]] = node_group_glob[node_start[d] : node_end[d]]

    return HaloPartition(
        n_devices=D,
        element=element,
        V=V,
        W=W,
        n_max=n_max,
        g_max=g_max,
        NI=NI,
        K=K,
        s_max=s_max,
        s_ghost=s_ghost,
        nodes=nodes_p,
        node_mask=node_mask,
        elems=elems_l,
        elem_mask=elem_mask,
        faces=faces_l,
        face_mask=face_mask,
        free=free_p,
        node_station=node_station,
        node_slot=node_slot,
        elem_station=elem_station,
        elem_slot=elem_slot,
        station_nodes=station_nodes,
        slot_valid=slot_valid,
        node_group=node_group,
        n_groups=int(ngi * ngl),
        perm=perm,
        num_nodes=N,
        dev_of_node=dev_of_node,
    )


def extended_nodes(part: HaloPartition, d: int) -> np.ndarray:
    """Rank d's extended node coordinates (n_ext, 3) on the host: its owned
    slots, then its ghosts (the next rank's first g_max nodes; one zero row
    where there are none), what from_next gives the solve."""
    n_g = max(part.g_max, 1)
    ghost = (part.nodes[d + 1][:n_g] if d + 1 < part.n_devices and part.g_max
             else np.zeros((n_g, 3), part.nodes.dtype))
    return np.concatenate([part.nodes[d], ghost], axis=0)


# ----------------------------------------------------------- the solve


class _Local:
    """One rank's extended mesh: its geometry, its operator (kernel D or N
    over the real elements' plan), its pair blocks and its loads."""

    def __init__(self, part: HaloPartition, group: DeviceGroup, dtype, lam, mu):
        d, dev = group.rank, group.device
        self.group, self.lam, self.mu = group, lam, mu
        self.n_max, self.g_max = part.n_max, part.g_max
        self.n_ext = part.n_max + max(part.g_max, 1)
        self.tet10 = part.element == "tet10"
        n_el = int(part.elem_mask[d].sum())  # real elements lead, padding follows
        assert (part.elem_mask[d, :n_el] > 0).all() and not part.elem_mask[d, n_el:].any()
        self.elems_h = part.elems[d, :n_el].astype(np.int64)
        self.elems = torch.as_tensor(part.elems[d, :n_el], device=dev).contiguous()  # int32
        n_f = int(part.face_mask[d].sum())
        self.faces_h = part.faces[d, :n_f].astype(np.int64)
        t = lambda a, dt=dtype: torch.as_tensor(np.asarray(a), device=dev).to(dt)  # noqa: E731
        self.nodes = t(part.nodes[d])
        self.nmask = t(part.node_mask[d])
        self.free3 = t(part.free[d]) * self.nmask[:, None]
        self.nodes_ext = self.extend(self.nodes)
        if self.tet10:
            from tpufem_torch.fem.tet10 import Tet10Mesh, _quad_grads, force_plan, tet10_setup

            self.Jinv, self.vols = tet10_setup(self.nodes_ext, self.elems)
            self.gq = _quad_grads(self.Jinv)  # (T,Q,10,3)
            mesh = Tet10Mesh(mesh4=None, tet10=self.elems_h, edge_endpoints=np.zeros((0, 2)),
                             surf_t6=np.zeros((0, 6)), num_nodes=self.n_ext)
            self.plan = force_plan(mesh, dev)  # RCM blocks: no station metadata here
        else:
            from tpufem_torch.fem.assembly import build_incidence
            from tpufem_torch.fem.elements import tet4_setup

            self.grads, self.vols = tet4_setup(self.nodes_ext, self.elems.long())
            self.plan = build_incidence(self.elems_h, self.n_ext, dev)

    # ---- halo traffic
    def extend(self, u):
        """(n_max, ...) -> (n_ext, ...) with the ghosts from the next rank."""
        if not self.g_max:
            return torch.cat([u, torch.zeros((1,) + u.shape[1:], dtype=u.dtype,
                                             device=u.device)], dim=0)
        head = u[: self.g_max]
        return torch.cat([u, from_next(self.group, head, head)], dim=0)

    def foldback(self, y_ext):
        """Ship the ghost rows' contributions forward; returns (n_max, ...)."""
        y = y_ext[: self.n_max]
        if not self.g_max:
            return y
        tail = y_ext[self.n_max:]
        add = to_next(self.group, tail, tail)
        y = y.clone()
        y[: self.g_max] += add
        return y

    # ---- element quantities
    def force(self, u_ext):
        """K u on the extended mesh (n_ext, 3): kernel D or N, no mask."""
        if self.tet10:
            from tpufem_torch.fem.tet10 import tet10_force

            return tet10_force(self.Jinv, self.vols, self.elems, u_ext, self.lam, self.mu,
                               self.n_ext, plan=self.plan)
        from tpufem_torch.fem.assembly import stiffness_apply

        return stiffness_apply(self.grads, self.vols, self.elems, u_ext, self.lam, self.mu,
                               self.plan)

    def pair_blocks(self):
        """(T, V, V, 3, 3): the element stiffness block of every corner pair."""
        lam, mu = self.lam, self.mu
        eye = torch.eye(3, dtype=self.nodes.dtype, device=self.nodes.device)
        if self.tet10:
            from tpufem_torch.fem.tet10 import GAUSS_WEIGHT

            gq = self.gq  # (T,Q,V,3)
            w = GAUSS_WEIGHT * self.vols
            outer = torch.einsum("tqai,tqbj->tabij", gq, gq)  # sum_q g_a g_b^T
            dot = torch.einsum("tqai,tqbi->tab", gq, gq)
            return w[:, None, None, None, None] * (lam * outer + mu * outer.transpose(3, 4)) \
                + (w[:, None, None] * mu * dot)[..., None, None] * eye
        g = self.grads  # (T,4,3)
        outer = g[:, :, None, :, None] * g[:, None, :, None, :]  # (T,a,b,i,j) = g_a,i g_b,j
        dot = (g[:, :, None, :] * g[:, None, :, :]).sum(dim=-1)
        return self.vols[:, None, None, None, None] * (
            lam * outer + mu * outer.transpose(3, 4) + mu * dot[..., None, None] * eye)

    def loads(self, pressure):
        """The pressure loads of the rank's faces on the extended mesh
        (kernel E over the faces' plan): tet4 a third of each face's force at
        its corners, tet10 a third at each midside (T6, straight edges)."""
        faces = torch.as_tensor(self.faces_h, device=self.nodes.device)
        v = self.nodes_ext[faces[:, :3]]
        area = 0.5 * torch.linalg.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0])
        fv = (-pressure / 3.0) * area  # (F,3)
        ids = self.faces_h[:, 3:] if self.tet10 else self.faces_h
        rows = fv[:, None, :].expand(-1, 3, -1).reshape(-1, 3)
        return csr_segment_sum(rows, csr_plan(ids, self.n_ext, self.nodes.device))


def halo_pcg_solve(
    part: HaloPartition,
    group: DeviceGroup,
    pressure: float,
    material: Material | None = None,
    tol: float = 1e-6,
    maxiter: int = 5000,
    axis: str = "mesh",
    dtype=torch.float32,
    two_level: bool = True,
    chunk_iters: int | None = None,
):
    """The halo-exchange two-level-preconditioned PCG on this rank of `group`
    (every rank calls it with the same partition). Returns (u (num_nodes, 3)
    numpy in ORIGINAL node order, iters, rel_residual), the same on every
    rank. `axis` and `chunk_iters` are tpufem's and ignored."""
    del axis, chunk_iters
    if group.world != part.n_devices:
        raise ValueError(f"a partition for {part.n_devices} ranks run on {group.world}")
    from tpufem_torch.device import float_dtype

    dtype = float_dtype(dtype)
    lam, mu = (float(torch.tensor(v, dtype=dtype)) for v in lame_params(material or Material()))
    press = float(torch.tensor(pressure, dtype=dtype))
    d, dev = group.rank, group.device
    loc = _Local(part, group, dtype, lam, mu)
    free3, nmask = loc.free3, loc.nmask
    K, Dd, s_max, s_ghost, V = part.K, 3 * part.K, part.s_max, part.s_ghost, part.V
    S = s_max + s_ghost
    b = loc.foldback(loc.loads(press)) * free3

    def A(x):
        y = loc.foldback(loc.force(loc.extend(x * free3)))
        return y * free3 + x * (1.0 - free3)

    # ---- line blocks: the same-station pair blocks summed per station slot
    # pair by kernel E (rows in tpufem's (a, c, element) order), ghost bands
    # shipped forward
    el_st = part.elem_station[d, : len(loc.elems_h)].astype(np.int64)
    el_sl = part.elem_slot[d, : len(loc.elems_h)].astype(np.int64)
    kab = loc.pair_blocks()  # (T,V,V,3,3)
    sel_e, sel_a, sel_c = [], [], []
    for a in range(V):
        for c in range(V):
            e = np.flatnonzero(el_st[:, a] == el_st[:, c])
            sel_e.append(e)
            sel_a.append(np.full(len(e), a))
            sel_c.append(np.full(len(e), c))
    sel_e, sel_a, sel_c = (np.concatenate(v) for v in (sel_e, sel_a, sel_c))
    ids = (el_st[sel_e, sel_a] * K + el_sl[sel_e, sel_a]) * K + el_sl[sel_e, sel_c]
    rows = kab[torch.as_tensor(sel_e, device=dev), torch.as_tensor(sel_a, device=dev),
               torch.as_tensor(sel_c, device=dev)].reshape(-1, 9)
    blk = csr_segment_sum(rows, csr_plan(ids, S * K * K, dev))  # (S*K*K, 9)
    B_all = blk.reshape(S, K, K, 3, 3).permute(0, 1, 3, 2, 4).reshape(S, Dd, Dd)
    Bm = B_all[:s_max].clone()
    ghost = B_all[s_max:].contiguous()
    Bm[:s_ghost] += to_next(group, ghost, ghost)
    st_nodes = torch.as_tensor(part.station_nodes[d], dtype=torch.long, device=dev)
    sl_valid = torch.as_tensor(part.slot_valid[d], device=dev).to(dtype)
    mvec = (free3[st_nodes] * sl_valid[:, :, None]).reshape(s_max, Dd)
    Bm = Bm * mvec[:, :, None] * mvec[:, None, :]
    Bm = Bm + torch.eye(Dd, dtype=dtype, device=dev)[None] * (1.0 - mvec)[:, :, None]
    Binv = spd_block_inverse(Bm)
    node_st = torch.as_tensor(part.node_station[d], dtype=torch.long, device=dev)
    node_sl = torch.as_tensor(part.node_slot[d], dtype=torch.long, device=dev)

    def M_line(r):
        rs = r[st_nodes].reshape(s_max, Dd, 1)
        zs = torch.matmul(Binv, rs).reshape(s_max, K, 3)
        return zs[node_st, node_sl] * nmask[:, None] * free3

    M = M_line
    if two_level:
        # ---- RBM coarse correction: the global dense system, all-reduced
        G = part.n_groups
        nc = 6 * G
        ngroup_h = part.node_group[d].astype(np.int64)
        ngroup = torch.as_tensor(ngroup_h, device=dev)
        gplan = csr_plan(ngroup_h, G, dev)
        cx = all_reduce_sum(group, csr_segment_sum(
            torch.cat([nmask[:, None], loc.nodes * nmask[:, None]], dim=1), gplan))  # (G,4)
        xg = cx[:, 1:] / torch.clamp(cx[:, :1], min=1.0)
        dvec = (loc.nodes - xg[ngroup]) * nmask[:, None]
        dvec_ext = loc.extend(dvec)
        free_ext = loc.extend(free3)
        group_ext = loc.extend(ngroup[:, None])[:, 0].cpu().numpy()
        pairs = build_rbm_plan(group_ext, G, loc.elems_h, dev).pair_plans
        el = loc.elems.long()
        acc = torch.zeros((G * G, 36), dtype=dtype, device=dev)
        for a in range(V):
            Pa = _rbm_basis(dvec_ext[el[:, a]])  # (T,3,6)
            fa = free_ext[el[:, a]]
            for c in range(V):
                kb = kab[:, a, c] * fa[:, :, None] * free_ext[el[:, c]][:, None, :]
                Pb = _rbm_basis(dvec_ext[el[:, c]])
                acc = acc + csr_segment_sum((Pa.transpose(1, 2) @ kb @ Pb).reshape(-1, 36),
                                            pairs[a * V + c])
        Ac = all_reduce_sum(group, acc).reshape(G, G, 6, 6).permute(0, 2, 1, 3).reshape(nc, nc)
        dg = torch.diagonal(Ac)
        act = (dg > 1e-8 * dg.max()).to(dtype)
        Ac = Ac * act[:, None] * act[None, :] + torch.diag(1.0 - act)
        Ac_inv = spd_block_inverse(Ac[None], ridge=3e-4)[0]

        def M(r_in):
            z1 = M_line(r_in)
            rm = r_in * free3
            rc = csr_segment_sum(torch.cat([rm, torch.linalg.cross(dvec, rm, dim=1)], dim=1),
                                 gplan)  # (G,6)
            zc = (Ac_inv @ all_reduce_sum(group, rc).reshape(-1)).reshape(G, 6)
            z2 = (zc[:, :3][ngroup] + torch.linalg.cross(zc[:, 3:][ngroup], dvec, dim=1))
            return z1 + z2 * free3 * nmask[:, None]

    def dot(u_, v_):
        return all_reduce_sum(group, (u_ * v_).sum())

    cg = _cg_grid_init(A, M, dot, b, torch.zeros_like(b))
    cg, iters, rel, _ = _cg_grid_run(A, M, dot, cg, tol, maxiter)
    u_dev = torch.stack(all_gather(group, cg[0] * free3)).cpu().numpy()  # (D, n_max, 3)
    mask = np.asarray(part.node_mask) > 0
    u_new = np.concatenate([u_dev[r][mask[r]] for r in range(part.n_devices)], axis=0)
    u = np.empty_like(u_new)
    u[part.perm] = u_new
    return u, int(iters), float(rel)


def halo_solve(group: DeviceGroup, res: WingMeshResolution, params4, element: str = "tet4",
               pressure: float = 200.0, tol: float = 1e-10, maxiter: int = 20000,
               dtype=torch.float64) -> dict:
    """One rank's part of a halo PCG solve as run_ranks runs it: the
    partition of the wing over the group's ranks, then u, iters and rel."""
    part = build_halo_partition(res, group.world, *params4,
                                dtype=np.float64 if dtype == torch.float64 else np.float32,
                                element=element)
    u, iters, rel = halo_pcg_solve(part, group, pressure, tol=tol, maxiter=maxiter, dtype=dtype)
    return {"u": u, "iters": iters, "rel": rel}
