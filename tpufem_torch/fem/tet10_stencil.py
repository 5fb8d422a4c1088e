"""Grid-native tet10 operator on the DOUBLED structured grid and its
p-multigrid solver — port of ``tpufem/fem/tet10_stencil.py``.

Every tet10 node of the structured wing mesh occupies one position of the
doubled grid (i2, k2, j2) in NI2 x NK2 x NJ2 = (2NI-1)(2NK-1)(2NJ-1):
all-even positions are tet4 corners; any other parity pattern o in {0,1}^3 is
the midpoint of the unique Kuhn-lattice edge (I, I+o) with I = pos//2 (the 7
positive offsets of tpufem_torch.fem.stencil.OFFSETS are exactly the nonzero
patterns). The tet10 operator reads and writes strided slices of a dense
(3, B, NI2, NK2, NJ2) state array, with no incidence gathers.

Weld embedding (LE always; TE when te_floor == 0): beyond the tet4-style
column weld at i2 = 0 (all k2 merge to slot 0), the doubled grid has PAIR
merges at i2 = 1: the midpoint of diagonal edge ((0,j,k),(1,j,k+1)) at slot
2k+1 and of axis edge ((0,j,k+1),(1,j,k+1)) at slot 2k+2 are the SAME welded
tet10 node. The active form keeps duplicates at zero; weld_spread2 /
weld_reduce2 implement S and R = S^T so the wrapped operator R K_full S
reproduces the welded tet10 stiffness exactly. grid_meta2 verifies the merge
pattern numerically per resolution (exact bijection active positions <->
welded tet10 nodes).

The operator (``strain_apply10``) is kernel L (``csrc/strain_apply10.cu``)
on a CUDA tensor and ``strain_apply10_plain`` on a CPU tensor; the
p-transfers (``prolong_p`` / ``restrict_p``) are kernel M
(``csrc/p_transfer.cu``) on CUDA and their plain versions on the CPU. The
thickness-line solve (``line_apply10``) is one batched matmul.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

from tpufem_torch.device import resolve_device
from tpufem_torch.fem.material import Material, lame_params
from tpufem_torch.fem.precond import spd_block_inverse
from tpufem_torch.fem.stencil import (
    OFFSETS,
    cell_geometry,
    check_grid_operands,
    grid_meta,
    grid_shapes,
    nodes_grid,
    weld_reduce,
    weld_spread,
)
from tpufem_torch.fem.stencil_mg import StencilMG, _cg_grid_init, _cg_grid_run, _correction_rounds
from tpufem_torch.fem.tet10 import (
    _EDGES,
    DNDXI,
    GAUSS_WEIGHT,
    connectivity_plan,
    pressure_loads_t6,
    t6_plan,
    tet10_from_tet4,
    tet10_setup,
    tet10_stress_nodal,
    tet10_upper_t6,
)
from tpufem_torch.fem.vonmises import von_mises
from tpufem_torch.mesher import (
    _HEX_CORNERS,
    _KUHN_TETS,
    WingMeshResolution,
    nodes_from_params,
    structured_wing_mesh,
    wing_topology,
)
from tpufem_torch.ops.kernels import check, load_kernels

# (t, m) -> doubled-grid offset (oi, ok, oj) of tet10 node m of Kuhn tet t
# relative to the cell origin (2i, 2k, 2j). HEX_CORNERS rows are (di, dj, dk).
_OFF2 = np.zeros((6, 10, 3), np.int64)
for _t in range(6):
    for _a in range(4):
        di, dj, dk = _HEX_CORNERS[_KUHN_TETS[_t, _a]]
        _OFF2[_t, _a] = (2 * di, 2 * dk, 2 * dj)
    for _e, (_a, _b) in enumerate(_EDGES):
        ca = _HEX_CORNERS[_KUHN_TETS[_t, _a]]
        cb = _HEX_CORNERS[_KUHN_TETS[_t, _b]]
        _OFF2[_t, 4 + _e] = (ca[0] + cb[0], ca[2] + cb[2], ca[1] + cb[1])

# S2[m, m', j, j'] = sum_q DNDXI[q,m,j] * DNDXI[q,m',j'] — the quadrature sum
# of shape-gradient coefficient products (equal Gauss weights fold into one
# constant tensor; pair stiffness blocks become w * sum_{jj'} S2 * G_{jj'}).
_S2 = np.einsum("qmj,qnk->mnjk", DNDXI, DNDXI)

# positive lattice offsets (di, dj, dk) — edge directions of the Kuhn lattice
_POS_OFFSETS = [tuple(int(v) for v in o) for o in OFFSETS if o > (0, 0, 0)]
assert len(_POS_OFFSETS) == 7


@lru_cache(maxsize=8)
def grid_meta2(res: WingMeshResolution):
    """Doubled-grid facts + welded-tet10-node <-> grid index maps.

    Builds the full->welded map numerically and ASSERTS the active-position
    bijection the weld_spread2/weld_reduce2 slice pattern relies on.
    """
    topo = wing_topology(res)
    mesh = structured_wing_mesh(1.0, 0.35, 10.0, 0.10, res)  # topology-invariant
    t10 = tet10_from_tet4(mesh)
    NI, NJ, NK = res.n_chord + 1, res.n_span + 1, res.n_thick + 1
    NI2, NJ2, NK2 = 2 * NI - 1, 2 * NJ - 1, 2 * NK - 1
    sharp_te = res.te_floor_frac == 0.0

    # full tet4 grid -> welded tet4 id
    m4 = grid_meta(res)
    weld4 = np.full((NI, NJ, NK), -1, np.int64)
    weld4[m4["gi"], m4["gj"], m4["gk"]] = np.arange(topo.num_nodes)
    weld4[0, :, 1:] = weld4[0, :, 0:1]
    if sharp_te:
        weld4[-1, :, 1:] = weld4[-1, :, 0:1]
    assert (weld4 >= 0).all()

    # welded identity of every doubled position
    I2, K2g, J2 = np.meshgrid(np.arange(NI2), np.arange(NK2), np.arange(NJ2), indexing="ij")
    oi, ok, oj = I2 % 2, K2g % 2, J2 % 2
    bi, bk, bj = I2 // 2, K2g // 2, J2 // 2
    wa = weld4[bi, bj, bk]
    wb = weld4[bi + oi, bj + oj, bk + ok]
    corner = (oi == 0) & (ok == 0) & (oj == 0)
    welded_id = np.where(corner, wa, -1)
    edge_mask = (~corner) & (wa != wb)
    ee = t10.edge_endpoints.astype(np.int64)  # (M,2) sorted pairs, lex-sorted
    big = np.int64(topo.num_nodes)
    ekey = ee[:, 0] * big + ee[:, 1]
    key = np.minimum(wa, wb) * big + np.maximum(wa, wb)
    pos = np.searchsorted(ekey, key.ravel()).reshape(key.shape)
    posc = np.minimum(pos, len(ekey) - 1)
    found = ekey[posc] == key
    missing = edge_mask & ~found
    assert not missing.any(), "nondegenerate full edge absent from welded mesh"
    welded_id = np.where(edge_mask, topo.num_nodes + posc, welded_id)

    # active (representative) positions: the slice-expressible weld pattern
    active = np.ones((NI2, NK2, NJ2), bool)
    active[0, 1:, :] = False  # LE column: rep at k2=0
    active[1, 1::2, :] = False  # LE-adjacent: odd k2 merges into even k2+1
    if sharp_te:
        active[-1, 1:, :] = False
        active[-2, 1::2, :] = False  # TE-adjacent: odd k2 merges into even k2-1
    ai, ak, aj = np.nonzero(active)
    ids = welded_id[ai, ak, aj]
    assert (ids >= 0).all()
    assert len(ids) == t10.num_nodes, (len(ids), t10.num_nodes)
    assert len(np.unique(ids)) == t10.num_nodes, "active positions not a bijection"
    gi2 = np.empty(t10.num_nodes, np.int32)
    gk2 = np.empty(t10.num_nodes, np.int32)
    gj2 = np.empty(t10.num_nodes, np.int32)
    gi2[ids], gk2[ids], gj2[ids] = ai, ak, aj

    return {
        "NI2": NI2,
        "NJ2": NJ2,
        "NK2": NK2,
        "gi2": gi2,
        "gk2": gk2,
        "gj2": gj2,
        "sharp_te": sharp_te,
        "num_nodes": t10.num_nodes,
        "t10": t10,
    }


@lru_cache(maxsize=32)
def _grid_index2(res: WingMeshResolution, device: torch.device):
    """(gi2, gk2, gj2) welded-tet10-node grid indices as long tensors on `device`."""
    m = grid_meta2(res)
    return tuple(torch.as_tensor(m[k], dtype=torch.long, device=device)
                 for k in ("gi2", "gk2", "gj2"))


def dup_mask2(res: WingMeshResolution, dtype, device="cpu"):
    """(1,1,NI2,NK2,NJ2) zero at duplicate (non-representative) positions."""
    m = grid_meta2(res)
    a = np.ones((1, 1, m["NI2"], m["NK2"], m["NJ2"]), np.float32)
    a[:, :, 0, 1:, :] = 0.0
    a[:, :, 1, 1::2, :] = 0.0
    if m["sharp_te"]:
        a[:, :, -1, 1:, :] = 0.0
        a[:, :, -2, 1::2, :] = 0.0
    return torch.as_tensor(a, dtype=dtype, device=device)


def free_mask2(res: WingMeshResolution, dtype, device="cpu"):
    """(1,1,1,1,NJ2) Dirichlet root mask (j2 = 0 clamped)."""
    NJ2 = 2 * res.n_span + 1
    f = np.ones((1, 1, 1, 1, NJ2), np.float32)
    f[..., 0] = 0.0
    return torch.as_tensor(f, dtype=dtype, device=device)


def weld_spread2(res: WingMeshResolution, u):
    """S on the doubled grid: copy representative values into duplicates."""
    u = u.clone()
    u[:, :, 0] = u[:, :, 0, 0:1, :]  # LE column i2=0: all k2 read slot 0
    u[:, :, 1, 1::2, :] = u[:, :, 1, 2::2, :]  # i2=1: odd k2 = value of even k2+1
    if res.te_floor_frac == 0.0:
        u[:, :, -1] = u[:, :, -1, 0:1, :]
        u[:, :, -2, 1::2, :] = u[:, :, -2, 0:-1:2, :]  # i2=NI2-2: odd k2 = even k2-1
    return u


def weld_reduce2(res: WingMeshResolution, y):
    """R = S^T: fold duplicate contributions into representatives, zero dups."""
    y = y.clone()
    rows = [(0, 1)] + ([(-1, -2)] if res.te_floor_frac == 0.0 else [])
    for col, pair in rows:
        tot = y[:, :, col].sum(dim=2)  # (3,B,NJ2)
        y[:, :, col] = 0.0
        y[:, :, col, 0] = tot
        if pair == 1:
            y[:, :, 1, 2::2, :] += y[:, :, 1, 1::2, :]
        else:
            y[:, :, -2, 0:-1:2, :] += y[:, :, -2, 1::2, :]
        y[:, :, pair, 1::2, :] = 0.0
    return y


def nodes_grid2(res: WingMeshResolution, p4: torch.Tensor, dtype, yfrac=None):
    """Full doubled-grid coordinates (3, B, NI2, NK2, NJ2) from (B,4) params.

    Even positions = tet4 corner coords; odd-pattern positions = exact edge
    midpoints (straight-edge tet10). `yfrac` is nodes_grid's: the corner
    layers' span fractions, so a slab of c + 1 corner layers gives its 2c + 1
    doubled layers."""
    X4 = nodes_grid(res, p4, dtype, yfrac=yfrac)  # (3,B,NI,NK,NJ)
    NI, NK, NJ = X4.shape[2], X4.shape[3], X4.shape[4]
    B = X4.shape[1]
    X2 = torch.zeros((3, B, 2 * NI - 1, 2 * NK - 1, 2 * NJ - 1), dtype=dtype, device=X4.device)
    X2[:, :, ::2, ::2, ::2] = X4
    for di, dj, dk in _POS_OFFSETS:
        A = X4[:, :, : NI - di, : NK - dk, : NJ - dj]
        Bp = X4[:, :, di:, dk:, dj:]
        X2[:, :, di::2, dk::2, dj::2] = 0.5 * (A + Bp)
    return X2


def cell_geometry2(res: WingMeshResolution, X2):
    """Per-tet gradients/volumes from the doubled grid's corner sublattice.

    Straight-edge tet10: the affine map (and so inv(J), V) is set by the 4
    corners, so the tet4 cell geometry is reused verbatim."""
    return cell_geometry(res, X2[:, :, ::2, ::2, ::2])


def _doubled(res: WingMeshResolution) -> tuple[int, int, int]:
    return 2 * res.n_chord + 1, 2 * res.n_thick + 1, 2 * res.n_span + 1


# the 27 cell-local doubled offsets (oi, ok, oj) in {0,1,2}^3, and each tet
# node's index among them (kernel L's pos27)
_POS27 = [(oi, ok, oj) for oi in range(3) for ok in range(3) for oj in range(3)]
_NODE_POS = np.array([[_POS27.index(tuple(int(v) for v in _OFF2[t, m])) for m in range(10)]
                      for t in range(6)])


def strain_apply10_plain(res: WingMeshResolution, geo, u2, free2, lam, mu):
    """Plain PyTorch version of strain_apply10: tpufem's formulation (per
    Kuhn tet and Gauss point, v_j = sum_m DNDXI[q,m,j] u_m over the 10 node
    slabs, H = sum_j grad(lambda_j) o v_j, sigma(eps(H)), the forces folded
    back through the same constants and added with shifted-slice adds), with
    the 6 tets and 4 Gauss points batched into matmuls over the cells' 27
    node slabs (~100 launches per apply where the literal loop takes ~2000)."""
    g, vol = geo  # (6,4,3,B,nc,nt,ns), (6,B,nc,nt,ns)
    us = weld_spread2(res, u2 * free2)
    NI2, NK2, NJ2 = us.shape[2], us.shape[3], us.shape[4]
    nc, nt, ns = (NI2 - 1) // 2, (NK2 - 1) // 2, (NJ2 - 1) // 2

    def slab(t, oi, ok, oj):
        return t[:, :, oi : oi + 2 * nc - 1 : 2, ok : ok + 2 * nt - 1 : 2,
                 oj : oj + 2 * ns - 1 : 2]

    node_pos = torch.as_tensor(_NODE_POS, device=us.device)
    un = torch.stack([slab(us, *o) for o in _POS27])[node_pos]  # (6,10,3,B,nc,nt,ns)
    cells = un.shape[3:]
    K = un[0, 0, 0].numel()
    D = torch.as_tensor(DNDXI, dtype=us.dtype, device=us.device)  # (4,10,3)
    Dm = D.permute(0, 2, 1).reshape(12, 10)  # (q j, m)
    gv = g[:, 1:].reshape(6, 3, 3, K)  # (t, j, d, cells): grad lambda_1..3
    v = (Dm @ un.reshape(6, 10, 3 * K)).reshape(6, 4, 3, 3, K)  # (t, q, j, e, cells)
    H = sum(gv[:, None, j, :, None] * v[:, :, j, None] for j in range(3))  # (t,q,d,e,cells)
    eps = 0.5 * (H + H.transpose(2, 3))
    tr = eps[:, :, 0, 0] + eps[:, :, 1, 1] + eps[:, :, 2, 2]
    eye = torch.eye(3, dtype=us.dtype, device=us.device).reshape(1, 1, 3, 3, 1)
    sig = 2.0 * mu * eps + lam * tr[:, :, None, None] * eye
    sw = sig * (GAUSS_WEIGHT * vol.reshape(6, 1, 1, 1, K))  # equal Gauss weights
    s_ = sum(sw[:, :, None, :, e] * gv[:, None, :, None, e] for e in range(3))  # (t,q,j,d,K)
    f = (Dm.t() @ s_.reshape(6, 12, 3 * K)).reshape(6, 10, 3, *cells)  # (t, m, d, cells)
    f27 = torch.zeros((27, *f.shape[2:]), dtype=f.dtype, device=f.device)
    f27.index_add_(0, node_pos.reshape(-1), f.reshape(60, *f.shape[2:]))
    y = torch.zeros_like(us)
    for o, fo in zip(_POS27, f27):
        slab(y, *o).add_(fo)
    y = weld_reduce2(res, y) * free2
    return y + u2 * (1.0 - free2)


L_THREADS = 256  # kernel L's block (csrc/strain_apply10.cu)
L_CELLS = L_THREADS // 2  # the most cells of its tile: two threads a cell
L_SLOTS = 36  # a cell's force slots of 3 values: 18 for its tets 0-2, 18 for 3-5
MAX_DYNAMIC_SMEM = 232448 - 1024  # a Hopper block's shared memory, less 1 KB for static use


@dataclass(frozen=True)
class LPlan:
    """Kernel L's launch: tiles of TI x TJ cells (chord x span) at full
    thickness, tiles_i x tiles_j of them per lane, `smem` bytes of force
    slots each, `rim` partial columns each: its rim, 4 (TI + TJ), then its
    weld rows, 4 (2 TJ + 1)."""

    TI: int
    TJ: int
    tiles_i: int
    tiles_j: int
    smem: int
    rim: int


def l_plan(res: WingMeshResolution, itemsize: int) -> LPlan:
    """Kernel L's tile at res's grid for a dtype of `itemsize` bytes: the
    widest span run TJ of 8, 4, 2, 1 cells (one 64-byte run of a gradient
    plane in f64) and then the most chord rows TI such that the tile holds at
    most L_CELLS cells at full thickness (two threads each); clipped to the
    grid. Raises where no tile fits."""
    nc, nt, ns = res.n_chord, res.n_thick, res.n_span
    for TJ in (8, 4, 2, 1):
        TJ = min(TJ, ns)
        TI = min(nc, L_CELLS // (nt * TJ))
        smem = L_SLOTS * 3 * TI * TJ * nt * itemsize
        if TI >= 1 and smem <= MAX_DYNAMIC_SMEM:
            return LPlan(TI, TJ, -(-nc // TI), -(-ns // TJ), smem,
                         4 * (TI + TJ) + 4 * (2 * TJ + 1))
    raise ValueError(f"kernel L (strain_apply10) takes at most {L_CELLS} cell layers, not {nt}")


_L_TICKETS: dict = {}  # per device: kernel L's per-tile ticket counters, 0 between calls


def _l_tickets(device, n: int) -> torch.Tensor:
    t = _L_TICKETS.get(device)
    if t is None or t.numel() < n:
        t = _L_TICKETS[device] = torch.zeros(n, dtype=torch.int32, device=device)
    return t


def check_strain_apply10_inputs(res: WingMeshResolution, geo, u2, free2) -> None:
    """Raise unless kernel L takes these inputs as they are: u2 on res's
    doubled grid, g (6,4,3,B,nc,nt,ns), vol (6,B,nc,nt,ns) and the root mask
    free2 (1,1,1,1,NJ2), contiguous, one dtype (f32 or f64), one device, none
    wanting a gradient (check_grid_operands), on a grid of at least 2 chord
    cells."""
    g, vol = geo
    want = grid_shapes(res, u2.shape[1] if u2.dim() == 5 else 0)
    NJ2 = _doubled(res)[2]
    if res.n_chord < 2:
        raise ValueError("kernel L (strain_apply10) needs at least 2 chord cells")
    check_grid_operands("L (strain_apply10)", res, u2, {
        "g": (g, want["g"]), "vol": (vol, want["vol"]), "free2": (free2, (1, 1, 1, 1, NJ2))},
        grid=_doubled(res))


def strain_apply10(res: WingMeshResolution, geo, u2, free2, lam: float, mu: float):
    """y = A_w u for tet10 on the doubled grid: R2(K10(S2(u2 * free2))) *
    free2 + u2 * (1 - free2), strain first, f32-safe.

    A CPU tensor takes strain_apply10_plain. A CUDA tensor launches kernel L,
    which computes the whole function in one launch on the tiles of l_plan;
    inputs it does not take raise (check_strain_apply10_inputs). lam and mu
    are Python floats. Calls on one device share its ticket counters, so they
    must not run on two streams at once."""
    if not u2.is_cuda:
        return strain_apply10_plain(res, geo, u2, free2, lam, mu)
    check_strain_apply10_inputs(res, geo, u2, free2)
    g, vol = geo
    _, B, NI2, NK2, NJ2 = u2.shape
    plan = l_plan(res, u2.element_size())
    tiles = B * plan.tiles_i * plan.tiles_j
    y = torch.empty_like(u2)
    partial = torch.empty(tiles * plan.rim * 3 * NK2, dtype=u2.dtype, device=u2.device)
    ticket = _l_tickets(u2.device, tiles)
    lib = load_kernels()
    fn = (lib.tpufem_strain_apply10_tiled_f64 if u2.dtype == torch.float64
          else lib.tpufem_strain_apply10_tiled_f32)
    status = fn(g.data_ptr(), vol.data_ptr(), u2.data_ptr(), free2.data_ptr(), y.data_ptr(),
                partial.data_ptr(), ticket.data_ptr(), B, NI2, NK2, NJ2,
                int(res.te_floor_frac == 0.0), plan.TI, plan.TJ, float(lam), float(mu),
                torch.cuda.current_stream(u2.device).cuda_stream)
    check(status, "strain_apply10")
    strain_apply10.launches += 1
    return y


strain_apply10.launches = 0


# ------------------------------------------------------------ p-transfers


def prolong_p_plain(res: WingMeshResolution, x4, dup2, free2):
    """Plain PyTorch version of prolong_p (tpufem's slice form)."""
    xs = weld_spread(res, x4)
    NI, NK, NJ = xs.shape[2], xs.shape[3], xs.shape[4]
    B = xs.shape[1]
    X2 = torch.zeros((3, B, 2 * NI - 1, 2 * NK - 1, 2 * NJ - 1), dtype=xs.dtype,
                     device=xs.device)
    X2[:, :, ::2, ::2, ::2] = xs
    for di, dj, dk in _POS_OFFSETS:
        A = xs[:, :, : NI - di, : NK - dk, : NJ - dj]
        Bp = xs[:, :, di:, dk:, dj:]
        X2[:, :, di::2, dk::2, dj::2] = 0.5 * (A + Bp)
    return X2 * dup2 * free2


def restrict_p_plain(res: WingMeshResolution, r2, free4):
    """Plain PyTorch version of restrict_p (tpufem's slice form)."""
    NI2, NK2, NJ2 = r2.shape[2], r2.shape[3], r2.shape[4]
    NI, NK, NJ = (NI2 + 1) // 2, (NK2 + 1) // 2, (NJ2 + 1) // 2
    y4 = r2[:, :, ::2, ::2, ::2].clone()
    for di, dj, dk in _POS_OFFSETS:
        mid = 0.5 * r2[:, :, di::2, dk::2, dj::2]
        y4[:, :, : NI - di, : NK - dk, : NJ - dj] += mid
        y4[:, :, di:, dk:, dj:] += mid
    y4 = weld_reduce(res, y4)
    return y4 * free4


def prolong_p(res: WingMeshResolution, x4, dup2, free2):
    """tet4 active grid (3,B,NI,NK,NJ) -> tet10 active doubled grid: the P1
    embedding into P2 (corners copied, midpoints = edge-endpoint means),
    times dup2 (1,1,NI2,NK2,NJ2) and free2 (1,1,1,1,NJ2).

    A CPU tensor takes prolong_p_plain; a CUDA tensor launches kernel M's
    prolongation (one launch), or raises on inputs it does not take."""
    if not x4.is_cuda:
        return prolong_p_plain(res, x4, dup2, free2)
    NI2, NK2, NJ2 = _doubled(res)
    check_grid_operands("M (prolong_p)", res, x4, {
        "dup2": (dup2, (1, 1, NI2, NK2, NJ2)), "free2": (free2, (1, 1, 1, 1, NJ2))})
    _, B, NI, NK, NJ = x4.shape
    y = torch.empty((3, B, NI2, NK2, NJ2), dtype=x4.dtype, device=x4.device)
    lib = load_kernels()
    fn = lib.tpufem_prolong_p_f64 if x4.dtype == torch.float64 else lib.tpufem_prolong_p_f32
    status = fn(x4.data_ptr(), dup2.data_ptr(), free2.data_ptr(), y.data_ptr(), B, NI, NK, NJ,
                int(res.te_floor_frac == 0.0), torch.cuda.current_stream(x4.device).cuda_stream)
    check(status, "prolong_p")
    prolong_p.launches += 1
    return y


prolong_p.launches = 0


@dataclass(frozen=True)
class MPlan:
    """restrict_p's launch: tiles of TIr x TJr tet4 node rows and columns at
    full thickness, tiles_i x tiles_j of them per lane and component, `smem`
    bytes each."""

    TIr: int
    TJr: int
    tiles_i: int
    tiles_j: int
    smem: int


M_NODE_COLS = 16  # restrict_p's most node columns a tile (a thread each)
M_MAX_ROWS = 1024  # restrict_p's most staged doubled rows (its static row table)


def m_plan(res: WingMeshResolution, itemsize: int) -> MPlan:
    """restrict_p's tile at res's grid: M_NODE_COLS node columns (a staged
    doubled row of 33 values) and the most of 4, 3, 2, 1 node rows whose
    staged rows (2 TIr + 1 doubled rows at every k2, each padded to whole
    16-byte chunks, at most M_MAX_ROWS) and weld shares fit in shared memory
    beside the static row table; clipped to the grid. Raises where one row
    does not fit."""
    NI, NK, NJ = res.n_chord + 1, res.n_thick + 1, res.n_span + 1
    v = 16 // itemsize
    TJr = min(M_NODE_COLS, NJ)
    rs = (2 * TJr + 1 + 2 * (v - 1)) // v * v
    for TIr in (4, 3, 2, 1):
        TIr = min(TIr, NI)
        smem = ((2 * TIr + 1) * (2 * NK - 1) * rs + TIr * NK * TJr) * itemsize
        if (2 * TIr + 1) * (2 * NK - 1) <= M_MAX_ROWS and smem <= MAX_DYNAMIC_SMEM - 4 * M_MAX_ROWS:
            return MPlan(TIr, TJr, -(-NI // TIr), -(-NJ // TJr), smem)
    raise ValueError(f"kernel M (restrict_p) takes at most {(M_MAX_ROWS // 3 + 1) // 2} node "
                     f"layers, not {NK}")


def restrict_p(res: WingMeshResolution, r2, free4):
    """Exact transpose of prolong_p: (3,B,NI2,NK2,NJ2) active -> tet4 grid
    (3,B,NI,NK,NJ), then the tet4 weld reduce and free4 (1,1,1,1,NJ).

    A CPU tensor takes restrict_p_plain; a CUDA tensor launches kernel M's
    restriction (one launch on the tiles of m_plan, a gather per tet4 node
    from shared memory, no atomics), or raises on inputs it does not take."""
    if not r2.is_cuda:
        return restrict_p_plain(res, r2, free4)
    NJ = res.n_span + 1
    check_grid_operands("M (restrict_p)", res, r2, {"free4": (free4, (1, 1, 1, 1, NJ))},
                        grid=_doubled(res))
    B = r2.shape[1]
    NI, NK = res.n_chord + 1, res.n_thick + 1
    y4 = torch.empty((3, B, NI, NK, NJ), dtype=r2.dtype, device=r2.device)
    plan = m_plan(res, r2.element_size())
    lib = load_kernels()
    fn = (lib.tpufem_restrict_p_tiled_f64 if r2.dtype == torch.float64
          else lib.tpufem_restrict_p_tiled_f32)
    status = fn(r2.data_ptr(), free4.data_ptr(), y4.data_ptr(), B, NI, NK, NJ,
                int(res.te_floor_frac == 0.0), plan.TIr, plan.TJr,
                torch.cuda.current_stream(r2.device).cuda_stream)
    check(status, "restrict_p")
    restrict_p.launches += 1
    return y4


restrict_p.launches = 0


# ------------------------------------------------------- thickness lines


def line_blocks10_raw(res: WingMeshResolution, geo, lam, mu, dtype):
    """Raw per-(i2,j2)-station thickness-line blocks (NI2,NJ2,NK2,3,NK2,3,B)
    BEFORE weld folds / Dirichlet masking / inversion.

    Same-station pairs (same i2 AND j2 offsets) of each Kuhn tet contribute
    w * sum_{jj'} S2[m,m',j,j'] * (lam G_jj' + mu G_j'j + mu D_jj' I); the
    quadrature constants fold into the precomputed _S2 tensor."""
    g, vol = geo
    dev = vol.device
    nb = vol.shape[1]
    nc, nt, ns = vol.shape[-3], vol.shape[-2], vol.shape[-1]
    NI2, NK2, NJ2 = 2 * nc + 1, 2 * nt + 1, 2 * ns + 1
    # accumulate in (NI2, NJ2, NK2, 3, dk+2, 3, B) layout: one slice-add per
    # same-station pair; dk = k2' - k2 in [-2, 2]
    Bacc = torch.zeros((NI2, NJ2, NK2, 3, 5, 3, nb), dtype=dtype, device=dev)
    eye3 = torch.eye(3, dtype=dtype, device=dev)[:, :, None, None, None, None]
    for t in range(6):
        gv = (g[t, 1], g[t, 2], g[t, 3])
        w = GAUSS_WEIGHT * vol[t]  # (B,nc,nt,ns)
        G = {}
        D = {}
        for j in range(3):
            for jp in range(3):
                G[(j, jp)] = gv[j][:, None] * gv[jp][None, :]  # (3,3,B,...)
                D[(j, jp)] = (gv[j] * gv[jp]).sum(dim=0)  # (B,...)
        for m in range(10):
            oi, okm, ojm = (int(v) for v in _OFF2[t, m])
            for mp in range(10):
                oip, okp, ojp_ = (int(v) for v in _OFF2[t, mp])
                if oi != oip or ojm != ojp_:
                    continue  # different station
                S = _S2[m, mp]  # (3,3) constants
                kblk = None
                dterm = None
                for j in range(3):
                    for jp in range(3):
                        c = float(S[j, jp])
                        if abs(c) < 1e-14:
                            continue
                        term = c * (lam * G[(j, jp)] + mu * G[(jp, j)])
                        kblk = term if kblk is None else kblk + term
                        dt_ = c * D[(j, jp)]
                        dterm = dt_ if dterm is None else dterm + dt_
                if kblk is None:
                    continue
                kblk = kblk + mu * dterm[None, None] * eye3
                kblk = kblk * w[None, None]  # (3,3,B,nc,nt,ns)
                # scatter: (i2=oi+2ci, j2=ojm+2cj, k2=okm+2ck, :, dk, :, B)
                dk = okp - okm + 2
                add = kblk.permute(3, 5, 4, 0, 1, 2)  # (nc,ns,nt,3,3,B)
                Bacc[oi : oi + 2 * nc - 1 : 2, ojm : ojm + 2 * ns - 1 : 2,
                     okm : okm + 2 * nt - 1 : 2, :, dk, :, :] += add
    # expand (k2, dk) -> dense (D2, D2) per station
    Bm = torch.zeros((NI2, NJ2, NK2, 3, NK2, 3, nb), dtype=dtype, device=dev)
    for dk in range(-2, 3):
        for k2 in range(max(0, -dk), min(NK2, NK2 - dk)):
            Bm[:, :, k2, :, k2 + dk, :, :] += Bacc[:, :, k2, :, dk + 2, :, :]
    return Bm


def line_blocks10_finalize(res: WingMeshResolution, Bm, dup2, free2):
    """Weld folds + duplicate/Dirichlet identity masking + inversion of raw
    station blocks -> (NI2, NJ2, B, D2, D2) inverses. The case axis sits
    before the block (tpufem keeps it last, (NI2,NJ2,D2,D2,B)) so the apply is
    one batched matmul; the inversion is the port's batched Cholesky
    (precond.spd_block_inverse), where tpufem used Newton-Schulz."""
    dtype = Bm.dtype
    NI2, NJ2, NK2 = Bm.shape[0], Bm.shape[1], Bm.shape[2]
    nb = Bm.shape[-1]
    D2 = 3 * NK2
    Bm = Bm.clone()
    # weld folds (R ... S on both block axes), mirroring weld_reduce2:
    # i2=0: all k2 sum into slot 0 (rows and columns)
    cols = [(0, 1)] + ([(-1, -2)] if res.te_floor_frac == 0.0 else [])
    for col, pair in cols:
        row0 = Bm[col].sum(dim=(1, 3))  # (NJ2,3,3,B)
        Bm[col] = 0.0
        Bm[col][:, 0, :, 0] = row0
        b1 = Bm[pair]
        if pair == 1:  # odd k2 folds into even k2+1 on both axes
            b1[:, 2::2] += b1[:, 1::2]
            b1[:, 1::2] = 0.0
            b1[:, :, :, 2::2] += b1[:, :, :, 1::2]
            b1[:, :, :, 1::2] = 0.0
        else:  # odd k2 folds into even k2-1
            b1[:, 0:-1:2] += b1[:, 1::2]
            b1[:, 1::2] = 0.0
            b1[:, :, :, 0:-1:2] += b1[:, :, :, 1::2]
            b1[:, :, :, 1::2] = 0.0
    Bm = Bm.reshape(NI2, NJ2, D2, D2, nb)
    # mask: slot active iff representative AND free (j2 > 0)
    mvec = (dup2 * free2).expand(1, 1, NI2, NK2, NJ2)[0, 0].to(dtype)
    mvec = mvec.permute(0, 2, 1)  # (NI2,NJ2,NK2)
    mvec = mvec[:, :, :, None].expand(NI2, NJ2, NK2, 3).reshape(NI2, NJ2, D2)
    Bm = Bm * mvec[:, :, :, None, None] * mvec[:, :, None, :, None]
    eyeD = torch.eye(D2, dtype=dtype, device=Bm.device)
    Bm = Bm + eyeD[None, None, :, :, None] * (1.0 - mvec)[:, :, :, None, None]
    flat = Bm.permute(0, 1, 4, 2, 3).reshape(NI2 * NJ2 * nb, D2, D2)
    return spd_block_inverse(flat).reshape(NI2, NJ2, nb, D2, D2)


def line_blocks10(res: WingMeshResolution, geo, lam, mu, dup2, free2, dtype):
    """Raw assembly + finalize in one call."""
    return line_blocks10_finalize(
        res, line_blocks10_raw(res, geo, lam, mu, dtype), dup2, free2
    )


def line_apply10(res: WingMeshResolution, Binv, rg, dup2, free2):
    """z = line-block solve; rg (3,B,NI2,NK2,NJ2) active form, Binv
    (NI2,NJ2,B,D2,D2). One batched matmul (tpufem computes it outside any
    Pallas kernel); z comes back contiguous, as kernel L takes it."""
    NI2, NK2, NJ2 = rg.shape[2], rg.shape[3], rg.shape[4]
    nb = rg.shape[1]
    rs = rg.permute(2, 4, 1, 3, 0).reshape(NI2, NJ2, nb, 3 * NK2, 1)
    zs = torch.matmul(Binv, rs)
    z = zs.reshape(NI2, NJ2, nb, NK2, 3).permute(4, 2, 0, 3, 1)
    out = torch.empty(z.shape, dtype=z.dtype, device=z.device)
    return torch.mul(z, dup2 * free2, out=out)


def to_grid2(res: WingMeshResolution, v_nodes):
    """Welded tet10 node vector (N10,3,B) -> active grid (3,B,NI2,NK2,NJ2)."""
    m = grid_meta2(res)
    gi, gk, gj = _grid_index2(res, v_nodes.device)
    g = torch.zeros((3, v_nodes.shape[2], m["NI2"], m["NK2"], m["NJ2"]),
                    dtype=v_nodes.dtype, device=v_nodes.device)
    g[:, :, gi, gk, gj] = v_nodes.permute(1, 2, 0)
    return g


def from_grid2(res: WingMeshResolution, g):
    """Active grid form -> welded tet10 node vector (N10,3,B)."""
    gi, gk, gj = _grid_index2(res, g.device)
    return g[:, :, gi, gk, gj].permute(2, 0, 1)


# ----------------------------------------------------------- solver class


@dataclass
class Tet10Result:
    """A Tet10StencilT solve: u (N10,3,B) (f64 on the certified paths), vm
    (N10,B), iters, rel_residual (B,), converged (B,), numpy on the host."""

    u: np.ndarray
    vm: np.ndarray
    iters: int
    rel_residual: np.ndarray
    converged: np.ndarray


class Tet10StencilT:
    """Batched grid-native tet10 solver: p-MG-PCG on the doubled grid, on
    `device` (the card unless the caller asks for the CPU).

    tet10 line-Chebyshev smoothing, exact P2->P1 restriction, the tet4
    StencilMG V-cycle as correction (kernel B on the card), with the operator
    and all transfers as grid computations and a TRAILING case batch axis.
    Supports outer_f64 (f64 operator/state, `dtype` V-cycle preconditioner)
    and mixed-precision refinement (refine_steps > 0) for TRUE-f64-residual
    convergence.

    Dropped from tpufem, on purpose: the host-built f64 system and the host
    judge (_host_setup64 / _host_resid / _cpu0: TPU f64 is emulated; the
    H100's is native, so the f64 geometry is built and the TRUE residual
    judged on the device), chunked dispatch (chunk_iters is accepted; a CG
    run looks at the host every _CHECK_EVERY steps, as fem.stencil_mg's), and
    the jax.jit wrappers.
    """

    def __init__(
        self,
        res: WingMeshResolution,
        dtype=torch.float32,
        smooth_degree: int = 2,
        smooth_alpha: float = 0.25,
        power_iters: int = 10,
        lmax_safety: float = 1.2,
        mg_levels: int | None = None,
        device="cuda",
    ):
        self.res = res
        self.dtype = dtype
        self.device = resolve_device(device)
        self.smooth_degree = smooth_degree
        self.smooth_alpha = smooth_alpha
        self.power_iters = power_iters
        self.lmax_safety = lmax_safety
        self.meta2 = grid_meta2(res)
        self.t10 = self.meta2["t10"]
        self.N10 = self.meta2["num_nodes"]
        self.dup2 = dup_mask2(res, dtype, self.device)
        self.free2 = free_mask2(res, dtype, self.device)
        self.free64 = self.free2.to(torch.float64)
        self.smg = StencilMG(
            res, dtype=dtype, device=self.device, n_levels=mg_levels,
            smooth_degree=smooth_degree, smooth_alpha=smooth_alpha,
            power_iters=power_iters, lmax_safety=lmax_safety,
        )
        self._plans: dict = {}
        # wall-clock split of the last solve(): setup / solve / recover seconds
        self.last_timing: dict | None = None

    # ------------------------------------------------------------- plans
    def _t6_plan(self, upper_t6: np.ndarray):
        key = ("t6", upper_t6.shape, upper_t6.tobytes())
        if key not in self._plans:
            self._plans[key] = t6_plan(upper_t6, self.N10, self.device)
        return self._plans[key]

    def _conn(self):
        if "conn" not in self._plans:
            self._plans["conn"] = (
                torch.as_tensor(self.t10.tet10, dtype=torch.long, device=self.device),
                connectivity_plan(self.t10.tet10, self.N10, self.device))
        return self._plans["conn"]

    # ------------------------------------------------------------- setup
    def loads_grid2(self, X2, pressure: float, upper_t6: np.ndarray):
        """Pressure load vector in doubled-grid form (3,B,NI2,NK2,NJ2) from the
        node grid X2: the tet10 nodes are read off the grid (tpufem's f64
        setup, _finish64, does the same), the loads summed by kernel E on the
        card."""
        n10 = from_grid2(self.res, X2)  # (N10,3,B)
        f = pressure_loads_t6(n10, upper_t6, pressure, self.N10, plan=self._t6_plan(upper_t6))
        return to_grid2(self.res, f) * self.free2.to(X2.dtype)

    def setup(self, p4, pressure: float, upper_t6: np.ndarray, lam: float, mu: float):
        """(geo, Binv, bg, lmax, smg_state) in self.dtype for the batch p4
        (B,4) numpy: cell geometry, tet10 line inverses, loads, the Chebyshev
        lmax by power iteration, and the tet4 StencilMG state."""
        p4_t = torch.as_tensor(np.asarray(p4), dtype=self.dtype, device=self.device)
        X2 = nodes_grid2(self.res, p4_t, self.dtype)
        geo = cell_geometry2(self.res, X2)
        Binv = line_blocks10(self.res, geo, lam, mu, self.dup2, self.free2, self.dtype)
        bg = self.loads_grid2(X2, pressure, upper_t6)
        A = lambda x: strain_apply10(self.res, geo, x, self.free2, lam, mu)  # noqa: E731
        M = lambda r: line_apply10(self.res, Binv, r, self.dup2, self.free2)  # noqa: E731
        nb = p4_t.shape[0]
        NI2, NK2, NJ2 = self.meta2["NI2"], self.meta2["NK2"], self.meta2["NJ2"]
        v = torch.sin(torch.arange(NI2 * NK2 * NJ2 * 3, dtype=self.dtype, device=self.device)
                      * 0.7311).reshape(3, 1, NI2, NK2, NJ2)
        v = v.expand(3, nb, NI2, NK2, NJ2) * self.dup2 * self.free2
        lmax = torch.ones((nb,), dtype=self.dtype, device=self.device)
        for _ in range(self.power_iters):
            w = M(A(v))
            nrm = torch.sqrt((w * w).sum(dim=(0, 2, 3, 4)))
            lmax = nrm
            v = w / torch.clamp(nrm, min=1e-30)[None, :, None, None, None]
        lmax = lmax * self.lmax_safety
        smg_state = self.smg.setup(np.asarray(p4_t.cpu().numpy()), lam, mu)
        return geo, Binv, bg, lmax, smg_state

    def system64(self, p4, pressure: float, upper_t6: np.ndarray):
        """(geo64, bg64): the f64 cell geometry and loads of the batch p4,
        built on the device (tpufem built them on the host CPU,
        _host_setup64, because TPU f64 is emulated)."""
        p464 = torch.as_tensor(np.asarray(p4), dtype=torch.float64, device=self.device)
        X64 = nodes_grid2(self.res, p464, torch.float64)
        return cell_geometry2(self.res, X64), self.loads_grid2(X64, pressure, upper_t6)

    # ---------------------------------------------------------- V-cycle
    def apply_M(self, geo, Binv, lmax, smg_state, lam, mu, r):
        """One p-MG V-cycle on the doubled grid."""
        A = lambda x: strain_apply10(self.res, geo, x, self.free2, lam, mu)  # noqa: E731
        Ml = lambda rr: line_apply10(self.res, Binv, rr, self.dup2, self.free2)  # noqa: E731
        cheb = self.smg._chebyshev
        x = cheb(A, Ml, r, lmax, self.smooth_degree, self.smooth_alpha)
        rr = r - A(x)
        r4 = restrict_p(self.res, rr, self.smg.free_masks[0]) * self.smg.active_masks[0]
        z4 = self.smg._vcycle(smg_state, 0, r4)
        x = x + prolong_p(self.res, z4, self.dup2, self.free2)
        rr = r - A(x)
        return x + cheb(A, Ml, rr, lmax, self.smooth_degree, self.smooth_alpha)

    # ------------------------------------------------------------ CG ops
    def ops(self, geo, Binv, lmax, smg_state, lam, mu):
        """(A, M, dot) of the `dtype` CG (dots accumulated in f64)."""
        A = lambda x: strain_apply10(self.res, geo, x, self.free2, lam, mu)  # noqa: E731
        M = lambda r: self.apply_M(geo, Binv, lmax, smg_state, lam, mu, r)  # noqa: E731

        def dot(u_, v_):
            return (u_.double() * v_.double()).sum(dim=(0, 2, 3, 4)).to(u_.dtype)

        return A, M, dot

    def ops64(self, geo64, geo, Binv, lmax, smg_state, lam64, mu64, lam, mu):
        """(A, M, dot) of the f64-operator CG: kernel L in f64, the `dtype`
        V-cycle as preconditioner (at the rounded Lame constants lam, mu)."""
        A = lambda x: strain_apply10(self.res, geo64, x, self.free64, lam64, mu64)  # noqa: E731

        def M(r):
            z = self.apply_M(geo, Binv, lmax, smg_state, lam, mu, r.to(self.dtype))
            return z.to(torch.float64)

        def dot(u_, v_):
            return (u_ * v_).sum(dim=(0, 2, 3, 4))

        return A, M, dot

    def resid64(self, geo64, bg64, x64, lam64, mu64):
        """TRUE f64 residual r = b - A x and its per-lane relative norm, on the
        device in native f64 (tpufem judged it on the host CPU, _host_resid)."""
        r = bg64 - strain_apply10(self.res, geo64, x64, self.free64, lam64, mu64)
        bn = torch.sqrt((bg64 * bg64).sum(dim=(0, 2, 3, 4)))
        rn = torch.sqrt((r * r).sum(dim=(0, 2, 3, 4)))
        return r, rn / torch.where(bn > 0, bn, torch.ones_like(bn))

    def recover(self, xg, p4, lam64: float, mu64: float):
        """Gather-path nodal stress recovery per lane in f64: von Mises (N10,B)."""
        x = from_grid2(self.res, xg.to(torch.float64))  # (N10,3,B)
        p464 = np.asarray(p4, np.float64)
        topo = wing_topology(self.res)
        conn, plan = self._conn()
        vms = []
        for b in range(p464.shape[0]):
            n4 = nodes_from_params(topo.node_basis, *p464[b], topo.te_floor)
            n10 = torch.as_tensor(self.t10.nodes10(n4), dtype=torch.float64, device=self.device)
            Jinv, vols = tet10_setup(n10, conn)
            s6 = tet10_stress_nodal(Jinv, vols, conn, x[:, :, b], lam64, mu64, self.N10,
                                    plan=plan)
            vms.append(von_mises(s6))
        return torch.stack(vms, dim=1).cpu().numpy()

    # ---------------------------------------------------------------- API
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
    ) -> Tet10Result:
        """Batched tet10 p-MG-PCG solve over the trailing case axis.

        Returns a Tet10Result. u is f64 on the f64-certified paths (outer_f64 /
        refine_steps > 0), whose rel_residual is the TRUE f64 residual.
        chunk_iters is accepted for tpufem's signature (see the class)."""
        del chunk_iters
        material = material or Material()
        lam64, mu64 = lame_params(material)
        # the `dtype` system sees the Lame constants rounded to it, as tpufem's
        lam, mu = (float(torch.tensor(v, dtype=self.dtype)) for v in (lam64, mu64))
        p4 = np.asarray(params4)
        p4d = torch.as_tensor(p4, dtype=self.dtype).numpy()
        upper_t6 = tet10_upper_t6(self.t10, upper_face_idx)
        sync = torch.cuda.synchronize if self.device.type == "cuda" else (lambda: None)
        tm = {"setup_s": 0.0, "solve_s": 0.0, "recover_s": 0.0}
        self.last_timing = tm

        def say(msg):
            if progress:
                print(f"  [tet10-stencil] {msg}", flush=True)

        t0 = time.perf_counter()
        geo, Binv, bg, lmax, smg_state = self.setup(p4d, pressure, upper_t6, lam, mu)
        certified = outer_f64 or refine_steps > 0
        if certified:
            geo64, bg64 = self.system64(p4, pressure, upper_t6)
            resid = lambda x_: self.resid64(geo64, bg64, x_, lam64, mu64)  # noqa: E731
        sync()
        tm["setup_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()

        if outer_f64:
            A, M, dot = self.ops64(geo64, geo, Binv, lmax, smg_state, lam64, mu64, lam, mu)
            cg = _cg_grid_init(A, M, dot, bg64, torch.zeros_like(bg64))
            cg, total, rel, _ = _cg_grid_run(A, M, dot, cg, tol, maxiter)
            say(f"iters {total}: max rel {float(rel.max()):.3e}")
            # classical iterative refinement judged on the TRUE f64 residual
            x, total, rel = _correction_rounds(A, M, dot, resid, cg[0], total, tol, maxiter,
                                               6, 0.9, 1e-2, say=say)
        else:
            A, M, dot = self.ops(geo, Binv, lmax, smg_state, lam, mu)
            cg = _cg_grid_init(A, M, dot, bg, torch.zeros_like(bg))
            if refine_steps <= 0:
                cg, total, rel, _ = _cg_grid_run(A, M, dot, cg, tol, maxiter)
                say(f"iters {total}: max rel {float(rel.max()):.3e}")
                x = cg[0]
            else:
                # mixed-precision refinement: `dtype` solve to inner_tol, then
                # rounds of (TRUE f64 residual -> `dtype` correction), judged
                # on the f64 residual
                cg, total, _, _ = _cg_grid_run(A, M, dot, cg, inner_tol, maxiter)
                say(f"iters {total}: inner solve")
                x, total, rel = _correction_rounds(
                    A, M, dot, resid, cg[0].to(torch.float64), total, tol, maxiter,
                    refine_steps, 0.5, inner_tol, dtype=self.dtype, say=say)
        conv = rel <= tol
        sync()
        tm["solve_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        vm = self.recover(x, p4, lam64, mu64)
        # u stays f64 on the certified paths: the reported residual certifies it
        u = from_grid2(self.res, x).cpu().numpy()
        sync()
        tm["recover_s"] = time.perf_counter() - t0
        return Tet10Result(u, vm, int(total), rel.cpu().numpy(), conv.cpu().numpy())
