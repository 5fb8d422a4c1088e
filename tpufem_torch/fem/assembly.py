"""Matrix-free stiffness operator and Jacobi diagonal — port of
``tpufem/fem/assembly.py``.

y = K u is computed per element and summed per node over the tets' incidence
plan; no global sparse matrix is ever materialized. On the card one operator
apply is one launch of kernel D (``csrc/tet4_force.cu``, ``stiffness_apply``):
Dirichlet mask, element forces, the per-node sum in the plan's fixed order
and the Dirichlet identity, with the element forces never written to device
memory. On a CPU tensor it is the plain composition: the mask,
``tet4_element_force_plain``, ``csr_segment_sum_plain``, the identity.

``stiffness_apply_t`` is the same function for B cases of one topology with
the case axis last ((N,3,B), tpufem's ``multigrid.force_t`` with its mask):
one launch of kernel O (``csrc/tet4_force_t.cu``) on the card, over the
tile plan ``force_plan_t``.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from tpufem_torch.ops.csr_segment_sum import (
    CsrPlan,
    csr_arrays,
    csr_segment_sum,
    csr_segment_sum_plain,
)
from tpufem_torch.ops.kernels import check, load_kernels, wants_grad


SLOTS = 1536  # incident entries per block of kernel D (36 KB of f64 forces)
SLOT_LIMIT = 2048  # what a block's 48 KB of shared memory hold in f64: the highest valence taken
MAX_SMEM = 232448  # a Hopper block's most dynamic shared memory


class IncidencePlan(NamedTuple):
    """The per-node sum plan of the (tet*k + corner) force rows of a (T,k)
    connectivity: the CSR plan of tets.reshape(-1) (the first six fields are
    a CsrPlan's, and csr_segment_sum reads a plan by those names, so it takes
    this one too) and the cut of the nodes into blocks that kernel D walks
    (k = 4; kernel N's first design walked it at k = 10, kernel O's at k = 4
    with B lanes)."""

    order: torch.Tensor  # (kT,) int32: stable argsort of tets.reshape(-1)
    starts: torch.Tensor  # (N+1,) int32: node n's rows are order[starts[n]:starts[n+1]]
    seg: torch.Tensor  # (kT,) int64: the node of each row of `order`
    num_segments: int
    starts_host: np.ndarray  # (N+1,) int64: `starts` on the host (kernel E's cut)
    launch: dict  # kernel E's cuts by row width, filled at first use (launch_plan)
    pos: torch.Tensor  # (kT,) int32: the CSR row of entry t*k+a (the inverse of `order`)
    bnode: torch.Tensor  # (n_blocks+1,) int32: block b owns the nodes bnode[b]:bnode[b+1]
    bt_start: torch.Tensor  # (n_blocks+1,) int32: block b's tets are btet[bt_start[b]:...[b+1]]
    btet: torch.Tensor  # int32: per block, ascending, the tets with a corner in its range
    slots: int  # no block's nodes hold more rows than this
    overlap: float  # len(btet) / T: how often a tet is evaluated (1 to k)


def build_incidence(tets, num_nodes: int, device="cpu", slots: int | None = None
                    ) -> IncidencePlan:
    """The incidence plan of `tets` (T,k) over `num_nodes` nodes, built on
    the host once per topology; `slots` (default SLOTS) caps a block's rows.

    tpufem stored the same stable argsort as a dense (N, V) padded gather
    table, because XLA:TPU's scatter serialized on duplicate indices
    (assembly.py:20-25). The port keeps it as CSR, walked row by row in a
    fixed order: no padding, no atomics. For kernel D the nodes are cut
    greedily into contiguous ranges of at most `slots` rows (a node of higher
    valence gets a block of its own, up to SLOT_LIMIT rows, what a block's
    shared memory holds; beyond that it raises), and each range lists the
    tets that touch it.
    """
    if isinstance(tets, torch.Tensor):
        tets = tets.cpu().numpy()
    tets = np.asarray(tets)
    k = tets.shape[1]
    order, starts, flat = csr_arrays(tets, num_nodes)
    slots = max(SLOTS if slots is None else slots, int(np.diff(starts).max(initial=0)))
    if slots > SLOT_LIMIT:
        raise ValueError(f"a node with {slots} incident tets: the kernel's blocks hold at most "
                         f"{SLOT_LIMIT}")
    pos = np.empty(len(order), np.int32)
    pos[order] = np.arange(len(order), dtype=np.int32)
    bnode = [0]
    while bnode[-1] < num_nodes:  # the last node whose rows still fit; always at least one
        bnode.append(int(np.searchsorted(starts, starts[bnode[-1]] + slots, side="right")) - 1)
    bnode = np.asarray(bnode, np.int64)
    n_blocks = len(bnode) - 1
    # every (block, tet) pair once: the distinct blocks of each tet's corners, then
    # block-major with the tets of a block ascending (a stable sort by block)
    blocks = np.sort(np.repeat(np.arange(n_blocks), np.diff(bnode))[flat].reshape(-1, k), axis=1)
    first = np.ones(blocks.shape, bool)
    first[:, 1:] = blocks[:, 1:] != blocks[:, :-1]
    pair_tet, pair_block = np.nonzero(first)[0], blocks[first]
    by_block = np.argsort(pair_block.astype(np.uint16 if n_blocks <= 2**16 else np.int64),
                          kind="stable")  # 16-bit keys: numpy's radix sort
    bt_start = np.zeros(n_blocks + 1, np.int64)
    np.cumsum(np.bincount(pair_block, minlength=n_blocks), out=bt_start[1:])

    def to_dev(a, dtype=np.int32):
        return torch.as_tensor(np.ascontiguousarray(a, dtype=dtype), device=device)

    return IncidencePlan(order=to_dev(order), starts=to_dev(starts),
                         seg=to_dev(flat[order], np.int64), num_segments=int(num_nodes),
                         starts_host=starts, launch={}, pos=to_dev(pos), bnode=to_dev(bnode), bt_start=to_dev(bt_start),
                         btet=to_dev(pair_tet[by_block]), slots=slots,
                         overlap=len(pair_tet) / max(len(tets), 1))


def tet4_element_force_plain(grads, vols, tets, u_nodes, lam, mu) -> torch.Tensor:
    """The per-tet half of kernel D's plain version: fe (T*4, 3) =
    vol * sigma . g_a per corner, sigma = 2 mu sym(H) + lam tr(H) I, H = sum_a g_a (x) u_a."""
    ue = u_nodes[tets]  # (T,4,3) gather
    H = (grads[:, :, :, None] * ue[:, :, None, :]).sum(dim=1)  # (T,3,3)
    eps = 0.5 * (H + H.transpose(1, 2))
    tr = eps[:, 0, 0] + eps[:, 1, 1] + eps[:, 2, 2]
    sigma = 2.0 * mu * eps
    for d in range(3):
        sigma[:, d, d] += lam * tr
    fe = vols[:, None, None] * (sigma[:, None, :, :] * grads[:, :, None, :]).sum(dim=3)
    return fe.reshape(-1, 3)


def stiffness_apply_plain(grads, vols, tets, x, lam, mu, plan: IncidencePlan, free=None):
    """Plain PyTorch version of kernel D: y (N,3) = K(x * free) * free +
    x * (1 - free), or K x where `free` is None; each node's element forces
    added in the plan's order from zero."""
    u = x if free is None else x * free
    y = csr_segment_sum_plain(tet4_element_force_plain(grads, vols, tets, u, lam, mu), plan)
    return y if free is None else y * free + x * (1.0 - free)


def check_incidence_inputs(name: str, geo: dict, tets, x, plan, free,
                           aligned: dict | None = None, kind=IncidencePlan,
                           builder: str = "build_incidence", lanes: int | None = None) -> None:
    """Raise unless kernel `name` (an operator over a connectivity's plan:
    D, N, O) takes these inputs as they are: the per-tet geometry `geo`
    ({label: (tensor, its shape)}), x (N,3) (or (N,3,lanes) where `lanes` is
    given) and free (N,3) or None of one
    float dtype (f32 or f64), tets (T,k) int32 and its plan over N nodes (a
    `kind`, made by `builder`), all contiguous on one device, the tensors of
    `aligned` ({label: tensor}) 16-byte aligned, kT and x's size below 2^31 (the
    kernel indexes in 32 bits), and none of them wanting a gradient (the
    kernel has no backward). The plan's values are trusted; its tensors,
    which its builder makes together, stand checked by its `order`."""
    floats = [t for t, _ in geo.values()] + [t for t in (x, free) if t is not None]
    if x.dtype not in (torch.float32, torch.float64) or any(t.dtype != x.dtype for t in floats):
        raise TypeError(f"kernel {name} takes one float dtype (f32/f64), got "
                        f"{[str(t.dtype) for t in floats]}")
    if tets.dtype != torch.int32:
        raise TypeError(f"kernel {name} takes int32 tets, got {tets.dtype}")
    if not isinstance(plan, kind):
        raise TypeError(f"kernel {name} takes a {kind.__name__} ({builder}), not "
                        f"{type(plan).__name__}")
    N = x.shape[0] if x.dim() == (2 if lanes is None else 3) else -1
    xshape = (N, 3) if lanes is None else (N, 3, lanes)
    if (any(t.shape != shape for t, shape in geo.values()) or tets.dim() != 2
            or x.shape != xshape or (free is not None and free.shape != (N, 3))):
        raise ValueError(f"kernel {name}: bad shapes "
                         + " ".join(f"{k} {tuple(t.shape)}" for k, (t, _) in geo.items())
                         + f" tets {tuple(tets.shape)} x {tuple(x.shape)} free "
                           f"{None if free is None else tuple(free.shape)}")
    if plan.num_segments != N or plan.order.shape[0] != tets.numel():
        raise ValueError(f"kernel {name}: a plan of {plan.order.shape[0]} rows over "
                         f"{plan.num_segments} nodes against {tuple(tets.shape)} tets and {N} "
                         f"nodes")
    tensors = [*floats, tets, plan.order]
    if any(t.device != x.device for t in tensors):
        raise ValueError(f"kernel {name}: inputs and plan lie on different devices")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"kernel {name} takes contiguous {', '.join(geo)}, tets, x and free")
    if aligned and any(t.data_ptr() % 16 for t in aligned.values()):
        raise ValueError(f"kernel {name} loads {', '.join(aligned)} 16 bytes at a time: not "
                         f"aligned")
    if tets.numel() >= 2**31 or x.numel() >= 2**31:
        raise ValueError(f"kernel {name} indexes in 32 bits: the arrays are too large")
    if any(wants_grad(t) for t in floats):
        raise ValueError(f"kernel {name} has no backward: a CUDA input requires_grad (the plain "
                         f"version on the CPU differentiates)")


def check_stiffness_apply_inputs(grads, vols, tets, x, plan: IncidencePlan, free) -> None:
    """Raise unless kernel D takes these inputs as they are
    (check_incidence_inputs): grads (T,4,3), vols (T,), tets (T,4); grads,
    tets and the plan's pos 16-byte aligned."""
    T = tets.shape[0]
    if tets.shape[1:] != (4,):
        raise ValueError(f"kernel D takes (T,4) tets, got {tuple(tets.shape)}")
    check_incidence_inputs("D", {"grads": (grads, (T, 4, 3)), "vols": (vols, (T,))}, tets, x,
                           plan, free, {"grads": grads, "tets": tets, "pos": plan.pos})


def stiffness_apply(grads, vols, tets, x, lam, mu, plan: IncidencePlan, free=None) -> torch.Tensor:
    """The gather path's operator apply in nodal (N,3) layout:
    y = K(x * free) * free + x * (1 - free), or y = K x where `free` is None,
    over `plan` (``build_incidence(tets, N)``). A CPU tensor takes
    stiffness_apply_plain; a CUDA tensor launches kernel D, one launch for the
    whole function, or raises (check_stiffness_apply_inputs). lam and mu are
    Python floats."""
    if not x.is_cuda:
        return stiffness_apply_plain(grads, vols, tets, x, lam, mu, plan, free)
    check_stiffness_apply_inputs(grads, vols, tets, x, plan, free)
    y = torch.empty_like(x)
    lib = load_kernels()
    fn = (lib.tpufem_stiffness_apply_f64 if x.dtype == torch.float64
          else lib.tpufem_stiffness_apply_f32)
    status = fn(grads.data_ptr(), vols.data_ptr(), tets.data_ptr(), plan.pos.data_ptr(),
                plan.btet.data_ptr(), plan.bt_start.data_ptr(), plan.bnode.data_ptr(),
                plan.starts.data_ptr(), x.data_ptr(), None if free is None else free.data_ptr(),
                y.data_ptr(), plan.bnode.shape[0] - 1, plan.slots, float(lam), float(mu),
                torch.cuda.current_stream(x.device).cuda_stream)
    check(status, "stiffness_apply")
    stiffness_apply.launches += 1
    return y


stiffness_apply.launches = 0


# ------------------------------------------------- the trailing-batch operator


O_THREADS = 256  # kernel O's block (csrc/tet4_force_t.cu, kThreads)
O_SMS = 132  # the H100's SMs
O_RESIDENT = 3  # blocks of kernel O the tiles fill on each SM
O_LANES = 8  # most lanes a block takes
SM_SMEM = 233472  # an H100 SM's shared memory (228 KB), 1 KB of it reserved for each block


class ForcePlanT(NamedTuple):
    """Kernel O's plan of a (T,4) connectivity for `lanes` cases in one
    dtype (force_plan_t): the CSR plan of tets.reshape(-1) (the first six
    fields are a CsrPlan's, so the plain version and kernel E read it too)
    and the cut of the nodes into tiles, a block per (tile, lane group).
    Each tile lists every tet with a corner on it, ascending, and walks the
    list in chunks of O_THREADS / group tets; a tet on the border of tiles
    is listed (evaluated) by each. Each chunk's corners on the tile's nodes
    get staging rows ordered by (node, tet), so that a node's rows run in
    ascending t*4+a within a chunk, and the chunks run in ascending t. Where
    `closure` > 0 a block stages the masked displacements of its tile's
    closure (the nodes of its listed tets) in shared memory."""

    order: torch.Tensor  # (4T,) int32: stable argsort of tets.reshape(-1)
    starts: torch.Tensor  # (N+1,) int32: node n's rows are order[starts[n]:starts[n+1]]
    seg: torch.Tensor  # (4T,) int64: the node of each row of `order`
    num_segments: int
    starts_host: np.ndarray  # (N+1,) int64: `starts` on the host (kernel E's cut)
    launch: dict  # kernel E's cuts by row width, filled at first use (launch_plan)
    ttet: torch.Tensor  # (L,) int32: the listed tets, tile after tile, ascending in a tile
    lnode: torch.Tensor | None  # (L,4) int16: each listed corner's place in its tile's
    #                            closure, where it is staged (else None)
    lids: torch.Tensor | None  # (L,4) int32: the listed tets' corner nodes, where the
    #                           closure is not staged (else None)
    dst: torch.Tensor  # (L,4) int16: each listed corner's staging row in its chunk, or -1
    #                    where its node lies on another tile
    tstart: torch.Tensor  # (tiles+1,) int32: tile k lists ttet[tstart[k]:tstart[k+1]]
    qbase: torch.Tensor  # (tiles+1,) int32: tile k's chunks are qbase[k]:qbase[k+1]
    qseg: torch.Tensor  # (chunks+1,) int32: chunk q's segments are segs[qseg[q]:qseg[q+1]]
    segs: torch.Tensor  # int32: per (chunk, node) segment, the node's place among its
    #                     tile's | (the chunk row after the segment's last) << 16
    onode: torch.Tensor  # int32: each tile's nodes, ascending, tile after tile
    ostart: torch.Tensor  # (tiles+1,) int32: tile k owns onode[ostart[k]:ostart[k+1]]
    cnode: torch.Tensor  # int32: each tile's closure (its listed tets' nodes), ascending
    cstart: torch.Tensor  # (tiles+1,) int32: tile k's closure is cnode[cstart[k]:cstart[k+1]]
    lanes: int  # B, the lane count the plan is cut for
    group: int  # lanes a block takes
    itemsize: int  # the dtype's bytes
    tiles: int
    tile: tuple  # (a, b): station columns a tile spans (chord, span); (a, 1) on a plain mesh
    rows: int  # the most staging rows of one chunk
    nodes: int  # the most nodes of one tile
    closure: int  # the most nodes of one tile's closure, 0 where it is not staged
    smem: int  # a block's shared memory, bytes
    overlap: float  # L / T: how often a tet is evaluated (by each lane group)
    args: tuple  # the kernel's plan arguments: host arrays of the plan's device pointers
    #              and of its sizes (kernel O's `plan` and `dims`), made once


def lane_group(lanes: int) -> int:
    """Lanes a block of kernel O takes: the largest divisor of `lanes` up to
    O_LANES (8, so that a warp's load covers each row of a tet once)."""
    return max(d for d in range(1, min(lanes, O_LANES) + 1) if lanes % d == 0)


def _tile_shape(NI: int, NJ: int, target: int, fits) -> tuple:
    """((a, b), one wave): the tile of the fewest station columns with ghosts
    ((a+1)(b+1), then the fewest tiles) that cuts an NI x NJ grid of columns
    into at most `target` tiles and `fits`, and True; the one of the fewest
    tiles that fits, and False, where none is that few."""
    best, least = None, None
    for a in range(1, NI + 1):
        for b in range(1, NJ + 1):
            if not fits(a, b):
                break
            n = -(-NI // a) * -(-NJ // b)
            key = ((a + 1) * (b + 1), n)
            if n <= target and (best is None or key < best[0]):
                best = (key, (a, b))
            if least is None or (n, key) < least[0]:
                least = ((n, key), (a, b))
    if least is None:
        raise ValueError("kernel O: a tile of one column does not fit a block's shared memory")
    return (best[1], True) if best else (least[1], False)


def force_plan_t(tets, num_nodes: int, lanes: int, dtype, device="cpu", *, columns,
                 tile: tuple | None = None, stage: bool | None = None) -> ForcePlanT:
    """Kernel O's plan of `tets` for `lanes` cases in `dtype` (host, once per
    topology, lane count and dtype; ForcePlanT). `columns` (N,2) gives each
    node's (chord, span) station of a structured wing
    (multigrid.node_columns), and the nodes are cut into tiles of a x b
    station columns at full thickness. `tile` (a, b) fixes the cut (the
    tests' small tiles); by default it is the smallest whose blocks, lane
    groups (lane_group) included, fill O_RESIDENT blocks on each of O_SMS
    SMs in one wave, within their shared memory there. `stage` has a block
    stage its closure's masked displacements in shared memory (by default
    where a staged tile still fills one wave; not where no staged tile fits,
    as on a thick wing). Raises where a tile's sums and a chunk's rows
    overflow a block's shared memory."""
    if isinstance(tets, torch.Tensor):
        tets = tets.cpu().numpy()
    tets = np.asarray(tets).astype(np.int64)
    T = len(tets)
    itemsize = torch.empty((), dtype=dtype).element_size()
    group = lane_group(lanes)
    groups = lanes // group
    chunk = O_THREADS // group
    W = 3 * group * itemsize  # bytes of a row: (component, lane)
    cols = np.asarray(columns).astype(np.int64)
    NI, NJ = int(cols[:, 0].max(initial=0)) + 1, int(cols[:, 1].max(initial=0)) + 1
    per_col = int(np.bincount(cols[:, 0] * NJ + cols[:, 1]).max(initial=1))
    budget = min(MAX_SMEM, SM_SMEM // O_RESIDENT - 1024) - 2 * 4 * chunk * (W + 4)
    target = max(1, O_SMS * O_RESIDENT // groups)

    def shape(staged):
        return _tile_shape(NI, NJ, target, lambda a, b: (a * b + staged * (a + 2) * (b + 2))
                           * per_col * W <= budget)

    if stage is None:  # staged where a staged tile still fills one wave
        try:
            staged_tile, stage = shape(True) if budget > 0 else (None, False)
        except ValueError:  # not even a one-column tile fits beside its closure
            staged_tile, stage = None, False
        tile = tile or (staged_tile if stage else None)
    stage = bool(stage)
    a, b = tile or shape(stage)[0]
    key = (cols[:, 0] // a) * (-(-NJ // b)) + cols[:, 1] // b
    _, tile_of = np.unique(key, return_inverse=True)  # tiles numbered by key
    tile_of = tile_of.reshape(-1)
    tiles = int(tile_of.max(initial=-1)) + 1
    onode = np.argsort(tile_of, kind="stable")  # each tile's nodes ascending
    ostart = np.zeros(tiles + 1, np.int64)
    np.cumsum(np.bincount(tile_of, minlength=tiles), out=ostart[1:])
    local = np.empty(num_nodes, np.int64)
    local[onode] = np.arange(num_nodes) - ostart[tile_of[onode]]
    # every (tile, tet) pair once, tile-major, the tets ascending in a tile
    tt = np.sort(tile_of[tets], axis=1)
    first = np.ones(tt.shape, bool)
    first[:, 1:] = tt[:, 1:] != tt[:, :-1]
    pair_tet, pair_tile = np.nonzero(first)[0], tt[first]
    by = np.argsort(pair_tile, kind="stable")
    ttet, ptile = pair_tet[by], pair_tile[by]
    L = len(ttet)
    tstart = np.zeros(tiles + 1, np.int64)
    np.cumsum(np.bincount(ptile, minlength=tiles), out=tstart[1:])
    lids = tets[ttet]
    # each tile's closure: the (tile, node) pairs of its listed tets' corners
    cpair = np.unique(ptile[:, None] * num_nodes + lids)
    cstart = np.zeros(tiles + 1, np.int64)
    np.cumsum(np.bincount(cpair // max(num_nodes, 1), minlength=tiles), out=cstart[1:])
    lnode = np.searchsorted(cpair, ptile[:, None] * num_nodes + lids) - cstart[ptile][:, None]
    place = np.arange(L) - tstart[ptile]
    qbase = np.zeros(tiles + 1, np.int64)
    np.cumsum(-(-np.diff(tstart) // chunk), out=qbase[1:])
    q = qbase[ptile] + place // chunk  # each listed tet's chunk
    # the corners on the tile's own nodes: rows by (chunk, node, tet)
    el, ea = np.nonzero(tile_of[lids] == ptile[:, None])
    enode = lids[el, ea]
    ekey = q[el] * max(num_nodes, 1) + local[enode]
    srt = np.argsort(ekey, kind="stable")  # ties (one node) keep the tets ascending
    sq = q[el][srt]
    row = np.arange(len(srt)) - np.searchsorted(sq, sq, side="left")
    dst = np.full((L, 4), -1, np.int64)
    dst[el[srt], ea[srt]] = row
    skey = ekey[srt]
    last = np.ones(len(skey), bool)
    last[:-1] = skey[1:] != skey[:-1]
    seg_q = sq[last]
    segs = local[enode[srt][last]] | ((row[last] + 1) << 16)
    qseg = np.searchsorted(seg_q, np.arange(int(qbase[-1]) + 1), side="left")
    rows = int(np.bincount(sq, minlength=1).max(initial=0))
    nodes = int(np.diff(ostart).max(initial=0))
    closure = int(np.diff(cstart).max(initial=0)) if stage else 0
    # the staging rows, the sums, the closure, the segments
    smem = (2 * rows + nodes + closure) * W + 2 * rows * 4
    if smem > MAX_SMEM or nodes > 2**16 or rows > 2**15 or closure > 2**15:
        raise ValueError(f"kernel O: a tile of {nodes} nodes ({closure} with its tets' others) "
                         f"and chunks of {rows} rows need {smem} bytes of a block's shared "
                         f"memory ({MAX_SMEM} at most) at {group} lanes a block")
    order, starts, flat = csr_arrays(tets, num_nodes)

    def to_dev(a, dtype=np.int32):
        return torch.as_tensor(np.ascontiguousarray(a, dtype=dtype), device=device)

    plan = ForcePlanT(
        order=to_dev(order), starts=to_dev(starts), seg=to_dev(flat[order], np.int64),
        num_segments=int(num_nodes), starts_host=starts, launch={}, ttet=to_dev(ttet),
        lnode=to_dev(lnode, np.int16) if stage else None, lids=None if stage else to_dev(lids),
        dst=to_dev(dst, np.int16),
        tstart=to_dev(tstart), qbase=to_dev(qbase), qseg=to_dev(qseg), segs=to_dev(segs),
        onode=to_dev(onode), ostart=to_dev(ostart), cnode=to_dev(cpair % max(num_nodes, 1)),
        cstart=to_dev(cstart), lanes=int(lanes), group=group, itemsize=itemsize, tiles=tiles,
        tile=(int(a), int(b)), rows=rows, nodes=nodes, closure=closure, smem=smem,
        overlap=L / max(T, 1), args=())
    ptrs = (ctypes.c_void_p * 12)(*(None if t is None else t.data_ptr() for t in (
        plan.ttet, plan.lnode, plan.dst, plan.tstart, plan.qbase, plan.qseg, plan.segs,
        plan.onode, plan.ostart, plan.cnode, plan.cstart, plan.lids)))
    dims = (ctypes.c_int * 7)(tiles * groups, groups, group, int(lanes), rows, nodes, closure)
    return plan._replace(args=(ptrs, dims))


def tet4_element_force_t_plain(grads, vols, tets, u, lam, mu) -> torch.Tensor:
    """The per-tet half of kernel O's plain version, tpufem's force_t with
    the case axis last: fe (T*4, 3*B) = vol * sigma . g_a per corner and
    lane, from grads (T,4,3,B), vols (T,B) and u (N,3,B)."""
    ue = u[tets]  # (T,4,3,B)
    H = (grads[:, :, :, None, :] * ue[:, :, None, :, :]).sum(dim=1)  # (T,3,3,B)
    eps = 0.5 * (H + H.transpose(1, 2))
    tr = eps[:, 0, 0] + eps[:, 1, 1] + eps[:, 2, 2]  # (T,B)
    sig = 2.0 * mu * eps
    for d in range(3):
        sig[:, d, d] += lam * tr
    fe = vols[:, None, None, :] * (sig[:, None, :, :, :] * grads[:, :, None, :, :]).sum(dim=3)
    return fe.reshape(-1, 3 * u.shape[-1])


def stiffness_apply_t_plain(grads, vols, tets, x, lam, mu, plan, free=None):
    """Plain PyTorch version of kernel O: y (N,3,B) = K(x * free) * free +
    x * (1 - free) per lane, or K x where `free` (N,3) is None; each node's
    element forces added in the plan's order from zero (any CSR plan of
    tets.reshape(-1): a CsrPlan or a ForcePlanT)."""
    fr = None if free is None else free[:, :, None]
    u = x if fr is None else x * fr
    y = csr_segment_sum_plain(tet4_element_force_t_plain(grads, vols, tets, u, lam, mu),
                              plan).reshape(x.shape)
    return y if fr is None else y * fr + x * (1.0 - fr)


def check_stiffness_apply_t_inputs(grads, vols, tets, x, plan: ForcePlanT, free) -> None:
    """Raise unless kernel O takes these inputs as they are
    (check_incidence_inputs): grads (T,4,3,B), vols (T,B), tets (T,4), x
    (N,3,B) and a plan cut for B lanes in x's dtype (force_plan_t)."""
    T = tets.shape[0]
    B = x.shape[-1] if x.dim() == 3 else -1
    if tets.shape[1:] != (4,):
        raise ValueError(f"kernel O takes (T,4) tets, got {tuple(tets.shape)}")
    check_incidence_inputs("O", {"grads": (grads, (T, 4, 3, B)), "vols": (vols, (T, B))}, tets,
                           x, plan, free, {k: t for k, t in (("lnode", plan.lnode),
                                                             ("dst", plan.dst), ("lids", plan.lids))
                                           if t is not None},
                           kind=ForcePlanT,
                           builder="force_plan_t", lanes=B)
    if plan.lanes != B or plan.itemsize != x.element_size():
        raise ValueError(f"kernel O: a plan cut for B={plan.lanes} in {plan.itemsize}-byte "
                         f"floats against x of B={B} in {x.element_size()}: its blocks' shared "
                         f"memory is sized for the lanes and the dtype (force_plan_t)")


def stiffness_apply_t(grads, vols, tets, x, lam, mu, plan: ForcePlanT, free=None
                      ) -> torch.Tensor:
    """The trailing-batch operator apply, B cases of one topology in (N,3,B)
    layout: y = K_b(x * free) * free + x * (1 - free) per lane b, or K_b x
    where `free` (N,3) is None, over `plan` (``force_plan_t(tets, N, B,
    dtype)``). A CPU tensor takes stiffness_apply_t_plain; a CUDA tensor
    launches kernel O, one launch for the whole function, or raises
    (check_stiffness_apply_t_inputs). lam and mu are Python floats."""
    if not x.is_cuda:
        return stiffness_apply_t_plain(grads, vols, tets, x, lam, mu, plan, free)
    check_stiffness_apply_t_inputs(grads, vols, tets, x, plan, free)
    y = torch.empty_like(x)
    lib = load_kernels()
    fn = (lib.tpufem_stiffness_apply_t_tiled_f64 if x.dtype == torch.float64
          else lib.tpufem_stiffness_apply_t_tiled_f32)
    status = fn(grads.data_ptr(), vols.data_ptr(), x.data_ptr(),
                None if free is None else free.data_ptr(), y.data_ptr(),
                *(ctypes.addressof(a) for a in plan.args), float(lam), float(mu),
                torch.cuda.current_stream(x.device).cuda_stream)
    check(status, "stiffness_apply_t")
    stiffness_apply_t.launches += 1
    return y


stiffness_apply_t.launches = 0


def elastic_force(grads, vols, tets, u_nodes, lam, mu, plan: IncidencePlan) -> torch.Tensor:
    """y = K u in nodal (N,3) layout over `plan` (``build_incidence(tets, N)``)."""
    return stiffness_apply(grads, vols, tets, u_nodes, lam, mu, plan)


def stiffness_operator(grads, vols, tets, lam, mu, plan: IncidencePlan, free_mask):
    """A(x) for the BC-reduced SPD system in flat (N*3,) layout.

    Dirichlet elimination by masking: A(x) = m*K(m*x) + (1-m)*x, which keeps
    the operator SPD with unit diagonal on constrained dofs.
    """
    free3 = free_mask.reshape(-1, 3)

    def apply(x_flat):
        return stiffness_apply(grads, vols, tets, x_flat.reshape(-1, 3), lam, mu, plan,
                               free3).reshape(-1)

    return apply


def stiffness_diagonal(grads, vols, lam, mu, plan: CsrPlan, free_mask) -> torch.Tensor:
    """diag(K) (N*3,) with unit entries on constrained dofs (Jacobi).

    Per element, K_{ai,ai} = V * (lam*g_ai^2 + mu*g_ai^2 + mu*|g_a|^2),
    summed per node by kernel E.
    """
    g2 = grads**2  # (T,4,3)
    gg = g2.sum(dim=2, keepdim=True)  # |g_a|^2
    d = vols[:, None, None] * ((lam + mu) * g2 + mu * gg)  # (T,4,3)
    diag = csr_segment_sum(d.reshape(-1, 3), plan).reshape(-1)
    one = torch.ones_like(diag)
    # padded/isolated nodes also get unit diagonal so the operator stays SPD
    diag = torch.where((free_mask > 0) & (diag > 0), diag, one)
    return torch.where(free_mask > 0, diag, one)
