"""Kernel O (csrc/tet4_force_t.cu, the trailing-batch tet4 operator) and its
tile plan (fem/assembly.py::force_plan_t) on the CPU, without nvcc: the CUDA
source compiled with g++ against tests/cuda_emulation/cuda_runtime.h (each
block's threads as std::threads, the blocks in a shuffled order, shared
memory NaN before each block), on COARSE (sharp TE, cosine spacing) and
16x16x4 (LE spacing, TE floor) wings, B = 1, 3 and 8 lanes, f64 and f32,
masked and unmasked:

- within 1e-12 (f64) / 1e-5 (f32) of the largest entry of
  stiffness_apply_t_plain, the same bits on a second call;
- the first design's node-order contract, bit for bit: every lane's node sum
  runs in ascending t*4+a from zero (held to a numpy replay of the kernel's
  arithmetic, which g++ without FMA contraction computes exactly so), at the
  plan force_plan_t cuts for the lanes and dtype, at tiles of one station
  column (most tets evaluated again as ghosts of the next tile), and at
  tiles of SMALL_TILE columns; with the tile's closure staged in shared
  memory and without;
- the Dirichlet rows are x itself; a plan cut for other lanes, or whose
  tile overflows a block's shared memory, is refused;
- on a wing too thick for any tile beside its staged closure, the plan
  reads the corners from device memory, with the same bits.

The plan alone: each tet is listed by exactly the tiles its corners lie on
(so once where one tile holds the whole mesh, `overlap` exactly the listed
count over T); each node's entries get rows in ascending t*4+a chunk after
chunk, so no row is staged outside its node's tile (halo share 0); every
block fits its shared memory, in one wave of resident blocks,
at every level of DOF100K's hierarchy and at MEDIUM for B = 1-8; a plan
stages the closure or reads the corner ids, and holds only the array its
kernel reads.
"""

import ctypes

import numpy as np
import pytest
import torch

from test_torch_tet10_force_host import emulate
from tpufem_torch.fem import assembly as asm
from tpufem_torch.fem.material import Material, lame_params
from tpufem_torch.fem.multigrid import grads_vols_t, node_columns, nodes_t
from tpufem_torch.fem.stencil_mg import hierarchy_resolutions
from tpufem_torch.mesher import COARSE, DOF100K, MEDIUM, WingMeshResolution, wing_topology
from tpufem_torch.profile_batched import halo_share_t

LAM, MU = lame_params(Material())
GRIDS = {"COARSE": COARSE, "16x16x4": WingMeshResolution(16, 16, 4, 0.006, "le")}
SMALL_TILE = (2, 1)  # the station columns of a small tile whose corners are read, not staged
THICK = WingMeshResolution(4, 4, 16, 0.006, "le")  # 17 nodes a column: no staged tile fits
DTYPES = {"f64": (torch.float64, 1e-12), "f32": (torch.float32, 1e-5)}
O_ARGS = [ctypes.c_void_p] * 7 + [ctypes.c_double] * 2 + [ctypes.c_void_p]
PRD = np.array([[1.2, 0.35, 10.0, 0.10], [1.8, 0.25, 25.0, 0.07], [1.0, 0.20, 0.0, 0.15],
                [1.5, 0.30, 5.0, 0.12], [2.0, 0.40, 30.0, 0.06], [1.1, 0.22, 15.0, 0.09],
                [1.7, 0.33, 20.0, 0.11], [1.3, 0.28, 2.0, 0.08]])


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    """Kernel O's source under the emulation, as a ctypes library."""
    return emulate(tmp_path_factory.mktemp("cuda_emulation_o"), "tet4_force_t.cu",
                   "tpufem_stiffness_apply_t_tiled", O_ARGS, 1)


@pytest.fixture(scope="module")
def wings():
    """{grid: (tets int32, grads64 (T,4,3,8), vols64 (T,8), x64 (N,3,8), free64 (N,3),
    the node columns (N,2))}."""
    torch.set_num_threads(1)
    out = {}
    for i, (name, res) in enumerate(GRIDS.items()):
        topo = wing_topology(res)
        basis = torch.as_tensor(topo.node_basis)
        tets = torch.as_tensor(topo.tets.astype(np.int32))
        nodes = nodes_t(basis, topo.te_floor, torch.as_tensor(PRD), torch.float64)
        grads, vols = grads_vols_t(nodes, tets.long())
        x = torch.as_tensor(np.random.default_rng(i).normal(size=(topo.num_nodes, 3, 8)) * 1e-3)
        free = torch.ones((topo.num_nodes, 3), dtype=torch.float64)
        free[topo.station_id % (res.n_span + 1) == 0] = 0.0
        out[name] = (tets, grads, vols, x, free, node_columns(topo, res))
    return out


def emulated(lib, grads, vols, tets, x, free, plan):
    """y of one emulated launch of kernel O, as stiffness_apply_t passes its
    arguments."""
    asm.check_stiffness_apply_t_inputs(grads, vols, tets, x, plan, free)
    y = torch.full_like(x, float("nan"))
    fn = getattr(lib, "tpufem_stiffness_apply_t_tiled_" + ("f64" if x.dtype == torch.float64
                                                            else "f32"))
    assert fn(grads.data_ptr(), vols.data_ptr(), x.data_ptr(),
              None if free is None else free.data_ptr(), y.data_ptr(),
              *(ctypes.addressof(a) for a in plan.args), LAM, MU, None) == 0
    return y


def ordered_reference(grads, vols, tets, x, free) -> np.ndarray:
    """Kernel O's function in numpy, operation for operation as its source
    writes it (tet4.cuh's stress, the force, the blend), each lane's node
    sum in ascending t*4+a from zero: the first design's bits."""
    g, v, x = grads.numpy(), vols.numpy(), x.numpy()
    dt = x.dtype.type
    lam, mu = dt(LAM), dt(MU)
    u = x if free is None else x * free.numpy()[:, :, None]
    ue = u[tets.numpy().astype(np.int64)]  # (T,4,3,B)
    H = [[np.zeros_like(v) for _ in range(3)] for _ in range(3)]
    for a in range(4):
        for d in range(3):
            for e in range(3):
                H[d][e] = H[d][e] + g[:, a, d] * ue[:, a, e]
    ltr = lam * (H[0][0] + H[1][1] + H[2][2])
    s = [[mu * (H[d][e] + H[e][d]) for e in range(3)] for d in range(3)]
    for d in range(3):
        s[d][d] = s[d][d] + ltr
    fe = np.stack([np.stack([v * (s[d][0] * g[:, a, 0] + s[d][1] * g[:, a, 1]
                                  + s[d][2] * g[:, a, 2]) for d in range(3)], axis=1)
                   for a in range(4)], axis=1).reshape(-1, *x.shape[1:])  # (4T,3,B)
    flat = tets.numpy().reshape(-1).astype(np.int64)
    order = np.argsort(flat, kind="stable")
    starts = np.searchsorted(flat[order], np.arange(x.shape[0] + 1))
    acc = np.zeros_like(x)
    for k in range(int(np.diff(starts).max())):
        has = np.flatnonzero(np.diff(starts) > k)
        acc[has] = acc[has] + fe[order[starts[has] + k]]
    if free is None:
        return acc
    m = free.numpy()[:, :, None]
    return acc * m + x * (dt(1) - m)


def plans(tets, N, lanes, dtype, cols):
    """{label: plan}: the port's cut, tiles of one station column (the
    closure staged), and tiles of SMALL_TILE columns (the corners read from
    device memory)."""
    return {"port": asm.force_plan_t(tets, N, lanes, dtype, columns=cols),
            "column": asm.force_plan_t(tets, N, lanes, dtype, columns=cols, tile=(1, 1),
                                       stage=True),
            "small": asm.force_plan_t(tets, N, lanes, dtype, columns=cols, tile=SMALL_TILE,
                                      stage=False)}


@pytest.mark.parametrize("grid", list(GRIDS))
@pytest.mark.parametrize("lanes", [1, 3, 8])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_kernel_o_matches_plain(lib, wings, grid, lanes, dtype):
    td, tol = DTYPES[dtype]
    tets, g64, v64, x64, f64, cols = wings[grid]
    g, v = g64[..., :lanes].to(td).contiguous(), v64[:, :lanes].to(td).contiguous()
    x, fr = x64[..., :lanes].to(td).contiguous(), f64.to(td)
    cuts = plans(tets, x.shape[0], lanes, td, cols)
    for free in (fr, None):
        ref = asm.stiffness_apply_t_plain(g, v, tets, x, LAM, MU, cuts["port"], free)
        scale = ref.abs().max().item()
        want = torch.as_tensor(ordered_reference(g, v, tets, x, free))
        outs = {k: emulated(lib, g, v, tets, x, free, p) for k, p in cuts.items()}
        assert (outs["port"] - ref).abs().max().item() <= tol * scale
        assert torch.equal(emulated(lib, g, v, tets, x, free, cuts["port"]), outs["port"])
        for k, y in outs.items():
            assert torch.equal(y, want), k
        if free is not None:
            fixed = fr[:, :, None].expand_as(x) == 0
            assert torch.equal(outs["port"][fixed], x[fixed])


def test_kernel_o_refuses_an_overfull_plan(wings):
    tets, g64, v64, x64, f64, cols = wings["COARSE"]
    plan = asm.force_plan_t(tets, x64.shape[0], 1, torch.float64, columns=cols)
    with pytest.raises(ValueError, match="shared memory"):
        asm.check_stiffness_apply_t_inputs(g64, v64, tets, x64, plan, f64)
    plan32 = asm.force_plan_t(tets, x64.shape[0], 8, torch.float32, columns=cols)
    with pytest.raises(ValueError, match="shared memory"):
        asm.check_stiffness_apply_t_inputs(g64, v64, tets, x64, plan32, f64)
    topo = wing_topology(MEDIUM)
    with pytest.raises(ValueError, match="shared memory"):  # one tile of 4,125 nodes
        asm.force_plan_t(topo.tets, topo.num_nodes, 8, torch.float64,
                         columns=node_columns(topo, MEDIUM), tile=(33, 25))


def listed(plan):
    """(tile of each listed tet, its place in the tile's list) on the host."""
    tstart = plan.tstart.numpy()
    tile = np.repeat(np.arange(plan.tiles), np.diff(tstart))
    return tile, np.arange(len(tile)) - tstart[tile]


@pytest.mark.parametrize("grid", list(GRIDS))
def test_plan_lists_each_tet_once_per_tile_it_touches(wings, grid):
    tets, g64, v64, x64, f64, cols = wings[grid]
    t = tets.numpy().astype(np.int64)
    T, N = len(t), x64.shape[0]
    whole = asm.force_plan_t(tets, N, 1, torch.float64, columns=cols, tile=(100, 100))
    assert whole.tiles == 1 and whole.overlap == 1.0
    assert np.array_equal(whole.ttet.numpy(), np.arange(T))
    for label, plan in plans(tets, N, 8, torch.float64, cols).items():
        onode, ostart = plan.onode.numpy(), plan.ostart.numpy()
        assert np.array_equal(np.sort(onode), np.arange(N)), label
        tile_of = np.empty(N, np.int64)
        tile_of[onode] = np.repeat(np.arange(plan.tiles), np.diff(ostart))
        assert all((np.diff(onode[a:b]) > 0).all() for a, b in zip(ostart[:-1], ostart[1:]))
        tile, _ = listed(plan)
        ttet = plan.ttet.numpy()
        want = np.unique(tile_of[t] + plan.tiles * np.arange(T)[:, None])
        assert np.array_equal(np.sort(tile + plan.tiles * ttet), want), label
        assert plan.overlap == len(ttet) / T
        cnode, cstart = plan.cnode.numpy(), plan.cstart.numpy()
        if plan.closure:  # the closure finds each corner; no ids are kept
            assert plan.lids is None and plan.closure == int(np.diff(cstart).max()), label
            lids = cnode[cstart[tile][:, None] + plan.lnode.numpy()]
        else:  # the corners' ids are read; no closure places are kept
            assert plan.lnode is None, label
            lids = plan.lids.numpy()
        assert np.array_equal(lids, t[ttet]), label
        for k in range(plan.tiles):
            assert np.array_equal(cnode[cstart[k]:cstart[k + 1]],
                                  np.unique(t[ttet[tile == k]]))
        for a, b in zip(plan.tstart.numpy()[:-1], plan.tstart.numpy()[1:]):
            assert (np.diff(ttet[a:b]) > 0).all()


@pytest.mark.parametrize("grid", list(GRIDS))
@pytest.mark.parametrize("lanes", [1, 3, 8])
def test_plan_rows_ascend_per_node(wings, grid, lanes):
    """Each entry (t, a) gets one row, on its node's tile; a node's rows in
    a chunk are one segment; chunk after chunk, row after row, a node's
    entries run in ascending t*4+a."""
    tets, g64, v64, x64, f64, cols = wings[grid]
    N = x64.shape[0]
    for label, plan in plans(tets, N, lanes, torch.float64, cols).items():
        chunk = asm.O_THREADS // plan.group
        tile, place = listed(plan)
        q = plan.qbase.numpy()[tile] + place // chunk
        dst = plan.dst.numpy().astype(np.int64)
        ttet = plan.ttet.numpy()
        lids = tets.numpy()[ttet]
        onode, ostart = plan.onode.numpy(), plan.ostart.numpy()
        el, ea = np.nonzero(dst >= 0)
        assert len(el) == 4 * len(tets), label  # every entry once
        node = lids[el, ea]
        assert np.array_equal(np.sort(ttet[el] * 4 + ea), np.arange(4 * len(tets)))
        tile_node = np.empty(N, np.int64)
        tile_node[onode] = np.repeat(np.arange(plan.tiles), np.diff(ostart))
        local = np.empty(N, np.int64)
        local[onode] = np.arange(N) - ostart[tile_node[onode]]
        assert np.array_equal(tile_node[node], tile[el]), label  # stored on its own tile
        assert halo_share_t(plan, tets) == 0.0, label  # no row leaves its block
        key = np.lexsort((dst[el, ea], q[el]))  # by chunk, then row
        ent, nd = (ttet[el] * 4 + ea)[key], node[key]
        by_node = np.lexsort((np.arange(len(nd)), nd))
        same = nd[by_node][1:] == nd[by_node][:-1]
        assert (np.diff(ent[by_node])[same] > 0).all(), label
        # the segments: a chunk's rows cut into runs, one node's each
        qseg, segs = plan.qseg.numpy().astype(np.int64), plan.segs.numpy().astype(np.int64)
        seg_q = np.repeat(np.arange(len(qseg) - 1), np.diff(qseg))
        r1 = segs >> 16
        r0 = np.where(np.arange(len(segs)) == qseg[seg_q], 0, np.roll(r1, 1))
        assert (r1 > r0).all()
        s = np.searchsorted(seg_q * 2**16 + r0, q[el] * 2**16 + dst[el, ea], side="right") - 1
        assert (seg_q[s] == q[el]).all() and (dst[el, ea] < r1[s]).all(), label
        assert np.array_equal(segs[s] & 0xFFFF, local[node]), label
        assert plan.rows == int(np.bincount(q[el]).max())


@pytest.mark.parametrize("lanes", range(1, 9))
def test_plan_fits_every_level(lanes):
    """At every level of DOF100K's hierarchy and at MEDIUM, f64 and f32:
    the blocks' shared memory within a Hopper block's and within the SM's
    share of O_RESIDENT blocks, the lane groups whole, the chunks' rows
    within four a listed tet, the tiles one wave of resident blocks."""
    for res in (*hierarchy_resolutions(DOF100K), MEDIUM):
        topo = wing_topology(res)
        for dtype in (torch.float64, torch.float32):
            p = asm.force_plan_t(topo.tets, topo.num_nodes, lanes, dtype,
                                 columns=node_columns(topo, res))
            resident = asm.O_RESIDENT
            groups = lanes // p.group
            assert p.group * groups == lanes and p.group <= asm.O_LANES
            assert p.smem == ((2 * p.rows + p.nodes + p.closure) * 3 * p.group * p.itemsize
                              + 8 * p.rows)
            assert p.smem <= min(asm.MAX_SMEM, asm.SM_SMEM // resident - 1024), (res, dtype)
            assert p.rows <= 4 * (asm.O_THREADS // p.group)
            assert p.tiles * groups <= asm.O_SMS * resident
            assert 1.0 <= p.overlap <= 4.0


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_thick_wing_reads_its_corners(lib, dtype):
    """A wing of 17 nodes a station column (THICK) at B = 8: not even one
    column fits a block beside its staged closure in f64 (10 columns'
    closure of 17 x 192 B), so force_plan_t reads the corners from device
    memory (closure 0), within the block's shared memory; f32 still stages.
    The emulated kernel gives the first design's bits and the plain
    version's values either way."""
    td, tol = DTYPES[dtype]
    topo = wing_topology(THICK)
    cols = node_columns(topo, THICK)
    assert np.bincount(cols[:, 0] * (THICK.n_span + 1) + cols[:, 1]).max() == 17
    tets = torch.as_tensor(topo.tets.astype(np.int32))
    nodes = nodes_t(torch.as_tensor(topo.node_basis), topo.te_floor, torch.as_tensor(PRD),
                    torch.float64)
    g, v = (t.to(td).contiguous() for t in grads_vols_t(nodes, tets.long()))
    x = torch.as_tensor(np.random.default_rng(5).normal(size=(topo.num_nodes, 3, 8)) * 1e-3
                        ).to(td)
    fr = torch.ones((topo.num_nodes, 3), dtype=td)
    fr[topo.station_id % (THICK.n_span + 1) == 0] = 0.0
    plan = asm.force_plan_t(tets, topo.num_nodes, 8, td, columns=cols)
    assert (plan.closure == 0) == (td == torch.float64)
    assert plan.smem <= min(asm.MAX_SMEM, asm.SM_SMEM // asm.O_RESIDENT - 1024)
    if td == torch.float64:
        with pytest.raises(ValueError, match="does not fit"):
            asm.force_plan_t(tets, topo.num_nodes, 8, td, columns=cols, stage=True)
    for free in (fr, None):
        y = emulated(lib, g, v, tets, x, free, plan)
        ref = asm.stiffness_apply_t_plain(g, v, tets, x, LAM, MU, plan, free)
        assert (y - ref).abs().max().item() <= tol * ref.abs().max().item()
        assert torch.equal(y, torch.as_tensor(ordered_reference(g, v, tets, x, free)))
