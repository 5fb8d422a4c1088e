"""Kernels N (csrc/tet10_force.cu, the tile-plan tet10 operator) and D
(csrc/tet4_force.cu, the tet4 one on the incidence walk of
csrc/incidence_walk.cuh) on the CPU, without nvcc: the CUDA sources compiled
with g++ against tests/cuda_emulation/cuda_runtime.h (each block's threads as
std::threads, the blocks in a shuffled order, shared memory NaN before each
block). Kernel N on the tet10 promotion of a 6x4x2 sharp-TE and an 8x6x2
floored wing, f64 and f32, masked and unmasked:

- within 1e-12 (f64) / 1e-5 (f32) of the largest entry of
  tet10_force_plain, the same bits on a second call;
- at the plan's own tiles (cut to MIN_BLOCKS blocks where the mesh allows:
  a cell column here) and at odd small ones (7 and 23 tets a block), where
  most nodes are halo nodes, all with the same bits: each node's sum runs in
  ascending t*10+m from zero however the tets are cut;
- on the mesh without its station metadata (the reverse Cuthill-McKee
  order) and with its node numbering shuffled, the same bits again;
- the plan: every tet evaluated once, every node interior to one block or
  listed once among the halo nodes, its rows in ascending order, shared
  memory within a Hopper block's 232,448 bytes; at the flagship's
  connectivity too, which also holds the numbers PERF.md quotes (blocks,
  rows, halo share).

Kernel D on the same two wings' tet4 meshes, f64 and f32, masked and
unmasked, at the plan's own cut and at 37 rows a block: within 1e-12 (f64)
of stiffness_apply_plain's largest entry, f32 no worse than 2x the plain f32
version against f64, the same bits twice, the Dirichlet rows x itself.
"""

import ctypes
import dataclasses
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from tpufem_torch.fem import assembly as asm
from tpufem_torch.fem import tet10 as tt10
from tpufem_torch.fem.elements import tet4_setup
from tpufem_torch.fem.material import Material, lame_params
from tpufem_torch.mesher import WingMeshResolution, structured_wing_mesh
from tpufem_torch.sets import build_boundary_sets

CSRC = Path(tt10.__file__).resolve().parents[1] / "csrc"
STUB = Path(__file__).resolve().parent / "cuda_emulation"
HOPPER_SMEM = 232448  # a Hopper block's most shared memory
LAM, MU = lame_params(Material())
GRIDS = {"6x4x2 sharp TE": WingMeshResolution(6, 4, 2, 0.0, "le"),
         "8x6x2 floored": WingMeshResolution(8, 6, 2, 0.006, "le")}
DTYPES = {"f64": (torch.float64, 1e-12), "f32": (torch.float32, 1e-5)}
CUTS = (None, 37)  # kernel D: the plan's own SLOTS, and odd block cuts
TILES = (None, 7, 23)  # kernel N: the plan's own TILE_TETS, and odd small tiles


SMEM_DECL = "extern __shared__ __align__(16) unsigned char smem_raw[];"
# kernel N's entry points: (Jinv, vols, ttet, tstart, dst, inode, istart, irow, hnode, hrow,
# hslot, cnode, cstart, lnode, x, free, y, halo, n_blocks, n_halo, rows, closure, lam, mu,
# stream)
N_ARGS = [ctypes.c_void_p] * 18 + [ctypes.c_int] * 4 + [ctypes.c_double] * 2 + [ctypes.c_void_p]
# kernel D's: (grads, vols, tets, pos, btet, bt_start, bnode, starts, x, free, y, n_blocks,
# slots, lam, mu, stream)
D_ARGS = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 2 + [ctypes.c_double] * 2 + [ctypes.c_void_p]


def emulate(out: Path, source: str, entry: str, argtypes, launches: int):
    """csrc/`source` compiled with g++ against the emulation header, as a
    ctypes library whose f32/f64 `entry` points take `argtypes`: its
    `launches` kernel launches rewritten into emu_launch, the dynamic shared
    array (in the source or the walk's header) into emu_smem."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    emu = "unsigned char* smem_raw = emu_smem;"
    for h in CSRC.glob("*.cuh"):
        (out / h.name).write_text(h.read_text().replace(SMEM_DECL, emu))
    s = (CSRC / source).read_text()
    assert SMEM_DECL in s + (CSRC / "incidence_walk.cuh").read_text()
    s, n = re.subn(r"(\w+<\w+>)<<<(.*?), (\w+), .*?>>>\((.*?)\);",
                   r"emu_launch(\2, \3, [&]() { \1(\4); });", s.replace(SMEM_DECL, emu),
                   flags=re.S)
    assert n == launches
    cpp = out / (Path(source).stem + ".cpp")
    cpp.write_text(s)
    lib = out / f"lib{cpp.stem}.so"
    subprocess.run(["g++", "-std=c++17", "-O1", "-fPIC", "-shared", "-pthread", "-I", str(STUB),
                    "-I", str(out), "-o", str(lib), str(cpp)], check=True)
    lib = ctypes.CDLL(str(lib))
    for d in ("f32", "f64"):
        fn = getattr(lib, f"{entry}_{d}")
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """Kernel N's source under the emulation, as a ctypes library."""
    return emulate(tmp_path_factory.mktemp("cuda_emulation"), "tet10_force.cu",
                   "tpufem_tet10_force_tiled", N_ARGS, 2)


@pytest.fixture(scope="module")
def emulated_d(tmp_path_factory):
    """Kernel D's source under the emulation, as a ctypes library."""
    return emulate(tmp_path_factory.mktemp("cuda_emulation_d"), "tet4_force.cu",
                   "tpufem_stiffness_apply", D_ARGS, 1)


def wing10(res):
    """(tet10 mesh, Jinv64, vols64, conn int32) of the test wing at res."""
    mesh = structured_wing_mesh(1.2, 0.35, 10.0, 0.10, res)
    t10 = tt10.tet10_from_tet4(mesh)
    conn = torch.as_tensor(t10.tet10, dtype=torch.int32)
    Jinv, vols = tt10.tet10_setup(torch.as_tensor(t10.nodes10(mesh.nodes)), conn)
    return t10, Jinv, vols, conn


@pytest.fixture(scope="module")
def meshes():
    """{grid: (Jinv64, vols64, conn int32, x64, free64, tet10 mesh)} of a seeded field."""
    torch.set_num_threads(1)
    out = {}
    for i, (name, res) in enumerate(GRIDS.items()):
        t10, Jinv, vols, conn = wing10(res)
        rng = np.random.default_rng(i)
        x = torch.as_tensor(rng.normal(size=(t10.num_nodes, 3)) * 1e-3)
        free = torch.ones((t10.num_nodes, 3), dtype=torch.float64)
        free[tt10.tet10_root_nodes(t10)] = 0.0
        out[name] = (Jinv, vols, conn, x, free, t10)
    return out


def emulated_n(lib, Jinv, vols, conn, x, free, plan):
    """y of one emulated apply of kernel N (its two launches), its plan
    arguments the plan's own `args`, as tet10_force passes them."""
    del conn  # the kernel reads the connectivity through its plan
    assert plan.args == (*(t.data_ptr() for t in (
        plan.ttet, plan.tstart, plan.dst, plan.inode, plan.istart, plan.irow, plan.hnode,
        plan.hrow, plan.hslot, plan.cnode, plan.cstart, plan.lnode)),
        plan.tstart.numel() - 1, plan.hnode.numel(), plan.rows, plan.closure)
    y = torch.full_like(x, float("nan"))
    halo = torch.full((3 * plan.halo_rows,), float("nan"), dtype=x.dtype)
    fn = getattr(lib, "tpufem_tet10_force_tiled_" + ("f64" if x.dtype == torch.float64
                                                      else "f32"))
    assert fn(Jinv.data_ptr(), vols.data_ptr(), *plan.args[:12], x.data_ptr(),
              None if free is None else free.data_ptr(), y.data_ptr(), halo.data_ptr(),
              *plan.args[12:], LAM, MU, None) == 0
    return y


def emulated_force(lib, grads, vols, tets, x, free, plan):
    """y of one emulated launch of kernel D."""
    y = torch.full_like(x, float("nan"))
    fn = getattr(lib, "tpufem_stiffness_apply_" + ("f64" if x.dtype == torch.float64
                                                    else "f32"))
    assert fn(grads.data_ptr(), vols.data_ptr(), tets.data_ptr(), plan.pos.data_ptr(),
              plan.btet.data_ptr(), plan.bt_start.data_ptr(), plan.bnode.data_ptr(),
              plan.starts.data_ptr(), x.data_ptr(), None if free is None else free.data_ptr(),
              y.data_ptr(), plan.bnode.shape[0] - 1, plan.slots, LAM, MU, None) == 0
    return y


def check_plan(plan, tets: np.ndarray, num_nodes: int) -> None:
    """Every tet in one block, listed ascending; every node interior to one
    block or a halo node, once; `dst` puts each node's entries at
    consecutive rows in ascending t*10+m, interior rows within the block's
    own, halo rows (through `hslot`) within the node's; the halo slots in
    the order a block's warps write them (warp, m, lane); each block's staged nodes
    are its tets' nodes, ascending, and `lnode` finds each entry's node
    among them; the blocks' shared memory within a Hopper block's."""
    T = len(tets)
    ttet, tstart = plan.ttet.numpy(), plan.tstart.numpy()
    assert np.array_equal(np.sort(ttet), np.arange(T)) and tstart[-1] == T
    assert all((np.diff(ttet[a:b]) > 0).all() for a, b in zip(tstart[:-1], tstart[1:]))
    inode, istart, irow = plan.inode.numpy(), plan.istart.numpy(), plan.irow.numpy()
    hnode, hrow = plan.hnode.numpy(), plan.hrow.numpy()
    assert np.array_equal(np.sort(np.concatenate([inode, hnode])), np.arange(num_nodes))
    assert (np.diff(hnode) > 0).all() and hrow[-1] == plan.halo_rows
    val = np.bincount(tets.reshape(-1), minlength=num_nodes)
    assert np.array_equal(np.diff(irow), val[inode]) and np.array_equal(np.diff(hrow), val[hnode])
    block_rows = irow[istart[1:]] - irow[istart[:-1]]
    cnode, cstart, lnode = plan.cnode.numpy(), plan.cstart.numpy(), plan.lnode.numpy()
    for b in range(len(tstart) - 1):
        assert np.array_equal(cnode[cstart[b]:cstart[b + 1]],
                              np.unique(tets[ttet[tstart[b]:tstart[b + 1]]]))
    blk10 = np.repeat(np.arange(len(tstart) - 1), np.diff(tstart) * 10)
    assert np.array_equal(cnode[cstart[blk10] + lnode], tets[ttet].reshape(-1))
    assert block_rows.max(initial=0) == plan.rows
    assert np.diff(cstart).max(initial=0) == plan.closure
    assert (plan.rows + plan.closure) * 3 * 8 <= HOPPER_SMEM
    # each entry's (block, row): the node's rows, in ascending t*10+m
    dst = plan.dst.numpy().reshape(-1, 10)
    blk = np.repeat(np.arange(len(tstart) - 1), np.diff(tstart))
    ent = (ttet[:, None] * 10 + np.arange(10)).reshape(-1)
    node = tets[ttet].reshape(-1)
    row = dst.reshape(-1)
    interior = np.zeros(num_nodes, bool)
    interior[inode] = True
    assert np.array_equal(row >= 0, interior[node])
    first = np.zeros(num_nodes, np.int64)
    iblk = np.repeat(np.arange(len(istart) - 1), np.diff(istart))
    first[inode] = irow[:-1] - irow[istart[iblk]]
    first[hnode] = hrow[:-1]
    owner = np.full(num_nodes, -1)
    owner[inode] = iblk
    ib = row >= 0
    assert np.array_equal(blk.repeat(10)[ib], owner[node[ib]])  # an interior node's own block
    hslot = plan.hslot.numpy()
    assert np.array_equal(np.sort(hslot), np.arange(plan.halo_rows))
    hrow_of = np.empty(plan.halo_rows, np.int64)
    hrow_of[hslot] = np.arange(plan.halo_rows)
    r = np.where(ib, row, hrow_of[~np.minimum(row, -1)]) - first[node]  # place among its rows
    # the halo slots by block, warp of 32 listed tets, m, lane
    lpos = np.arange(len(ttet)) - np.repeat(tstart[:-1], np.diff(tstart))
    grp = ((blk * (len(ttet) + 1) + lpos // 32)[:, None] * 10 + np.arange(10)).reshape(-1)
    o2 = np.lexsort((np.repeat(lpos % 32, 10)[~ib], grp[~ib]))
    assert np.array_equal(~row[~ib][o2], np.arange(plan.halo_rows))
    o = np.lexsort((ent, node))
    assert np.array_equal(r[o], np.concatenate([np.arange(v) for v in val]))
    assert plan.overlap == 1.0


@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("grid", list(GRIDS))
def test_kernel_emulated_matches_plain(emulated, meshes, grid, dtype, masked, tile):
    Jinv, vols, conn, x, free, t10 = meshes[grid]
    dt, tol = DTYPES[dtype]
    plan = tt10.force_plan(t10, "cpu", tile_tets=tile or tt10.TILE_TETS)
    assert tile is None or plan.tstart.numel() > 10 and plan.halo_share > 0.5
    ref64 = tt10.tet10_force_plain(Jinv, vols, conn, x, LAM, MU, plan, free if masked else None)
    J, v, xx = Jinv.to(dt), vols.to(dt), x.to(dt)
    fr = free.to(dt) if masked else None
    y = emulated_n(emulated, J, v, conn, xx, fr, plan)
    ref = tt10.tet10_force_plain(J, v, conn, xx, LAM, MU, plan, fr)
    scale = ref64.abs().max().item()
    assert (y - ref).abs().max().item() <= tol * scale
    if dtype == "f32":  # no worse than 2x the plain f32 version, both against f64
        assert (y.double() - ref64).abs().max() <= 2 * (ref.double() - ref64).abs().max() + \
            1e-7 * scale
    assert torch.equal(y, emulated_n(emulated, J, v, conn, xx, fr, plan))
    if tile is not None:  # the same bits as at the plan's own tiles
        own = tt10.force_plan(t10, "cpu")
        assert torch.equal(y, emulated_n(emulated, J, v, conn, xx, fr, own))
    if masked:  # the Dirichlet identity rows
        root = free[:, 0] == 0
        assert torch.equal(y[root], xx[root])


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("mesh", ["no station metadata", "shuffled nodes", "an untouched node"])
def test_kernel_emulated_other_meshes(emulated, meshes, mesh, dtype, masked):
    """The 8x6x2 wing without its station metadata (force_plan's reverse
    Cuthill-McKee blocks, also at 13 tets a block), with its nodes
    renumbered at random, and with one more node that no tet touches (a
    halo node of no rows: its y the Dirichlet identity, or 0 unmasked): the
    bits of the structured plan on the wing as numbered."""
    Jinv, vols, conn, x, free, t10 = meshes["8x6x2 floored"]
    dt = DTYPES[dtype][0]
    J, v, xx = Jinv.to(dt), vols.to(dt), x.to(dt)
    fr = free.to(dt) if masked else None
    N = x.shape[0]
    y = emulated_n(emulated, J, v, conn, xx, fr, tt10.force_plan(t10, "cpu"))
    bare = dataclasses.replace(t10, station_id=None, slot=None)
    if mesh == "no station metadata":
        for tile in (tt10.TILE_TETS, 13):
            plan = tt10.force_plan(bare, "cpu", tile_tets=tile)
            check_plan(plan, conn.numpy(), N)
            assert torch.equal(emulated_n(emulated, J, v, conn, xx, fr, plan), y)
        return
    if mesh == "an untouched node":
        x1 = torch.cat([xx, xx[:1] + 1])
        fr1 = None if fr is None else torch.cat([fr, torch.zeros_like(fr[:1])])
        plan = tt10.force_plan(dataclasses.replace(t10, num_nodes=N + 1), "cpu")
        check_plan(plan, conn.numpy(), N + 1)
        assert N in plan.hnode.tolist()
        y1 = emulated_n(emulated, J, v, conn, x1, fr1, plan)
        assert torch.equal(y1[:N], y)
        assert torch.equal(y1[N], x1[N] if masked else torch.zeros_like(x1[N]))
        return
    perm = torch.as_tensor(np.random.default_rng(5).permutation(N))  # new id of node n
    conn_p = perm[conn.long()].to(torch.int32)
    inv = torch.argsort(perm)
    xp, frp = xx[inv], None if fr is None else fr[inv]
    shuffled = dataclasses.replace(t10, tet10=conn_p.numpy(),
                                   station_id=t10.station_id[inv.numpy()])
    # the station tiles do not follow the numbering, nor does the order of the bare mesh
    for m in (shuffled, dataclasses.replace(shuffled, station_id=None)):
        plan = tt10.force_plan(m, "cpu")
        check_plan(plan, conn_p.numpy(), N)
        assert torch.equal(emulated_n(emulated, J, v, conn_p, xp, frp, plan)[perm], y)


@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("grid", list(GRIDS))
def test_plan_evaluates_each_tet_once(meshes, grid, tile):
    _, _, conn, x, _, t10 = meshes[grid]
    for m in (t10, dataclasses.replace(t10, station_id=None)):
        plan = tt10.force_plan(m, "cpu", tile_tets=tile or tt10.TILE_TETS)
        check_plan(plan, conn.numpy(), x.shape[0])


def test_flagship_plan_fits_and_overlap():
    """At the flagship's connectivity (96x128x8, 586,752 tets, 837,049
    nodes), host-exact: each tet evaluated once, every node interior to one
    block or a halo node once with its rows in order, every block's forces
    within its shared memory in f64 (two blocks an SM), and the numbers
    PERF.md quotes: 1,376 blocks of 3 x 3 cells, at most 3,400 interior rows
    and 833 staged nodes (101,592 B of f64), 250,099 halo nodes with
    2,240,800 rows, a halo share of 38.19 %."""
    from tpufem_torch.mesher import DOF1M_TET10

    t10 = tt10.tet10_from_tet4(structured_wing_mesh(1.6, 0.4, 20.0, 0.10, DOF1M_TET10))
    plan = tt10.force_plan(t10, "cpu")
    T = len(t10.tet10)
    assert (T, t10.num_nodes) == (586752, 837049)
    check_plan(plan, t10.tet10.astype(np.int64), t10.num_nodes)
    assert (plan.tstart.numel() - 1, plan.rows, plan.closure) == (1376, 3400, 833)
    smem = (plan.rows + plan.closure) * 3 * 8
    assert smem == 101592 and 2 * (smem + 1024) <= 233472  # two blocks in an SM's 228 KB
    assert (plan.hnode.numel(), plan.halo_rows) == (250099, 2240800)
    assert round(plan.halo_share, 4) == 0.3819


def test_default_plan_is_csr_and_refuses_the_card(meshes):
    """A tet10_force call that gives no plan sums over the connectivity's CSR
    plan on the CPU, with the bits of force_plan's; kernel N takes the mesh's
    force_plan, so the default raises for a CUDA device (no card needed)."""
    Jinv, vols, conn, x, free, t10 = meshes["8x6x2 floored"]
    N = x.shape[0]
    assert isinstance(tt10.default_plan(conn, N, "cpu"), tt10.CsrPlan)
    assert torch.equal(tt10.tet10_force(Jinv, vols, conn, x, LAM, MU, N, free=free),
                       tt10.tet10_force(Jinv, vols, conn, x, LAM, MU, N, free=free,
                                        plan=tt10.force_plan(t10, "cpu")))
    with pytest.raises(ValueError, match="force_plan"):
        tt10.default_plan(conn, N, "cuda")


@pytest.fixture(scope="module")
def meshes4():
    """{grid: (grads64, vols64, tets int32, x64, free64)} of the tet4 meshes."""
    out = {}
    for i, (name, res) in enumerate(GRIDS.items()):
        mesh = structured_wing_mesh(1.2, 0.35, 10.0, 0.10, res)
        tets = torch.as_tensor(mesh.tets.astype(np.int32))
        grads, vols = tet4_setup(torch.as_tensor(mesh.nodes, dtype=torch.float64), tets)
        rng = np.random.default_rng(10 + i)
        x = torch.as_tensor(rng.normal(size=(mesh.num_nodes, 3)) * 1e-3)
        free = torch.ones((mesh.num_nodes, 3), dtype=torch.float64)
        free[torch.as_tensor(build_boundary_sets(mesh).nroot_nodes)] = 0.0
        out[name] = (grads, vols, tets, x, free)
    return out


@pytest.mark.parametrize("cut", CUTS)
@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("grid", list(GRIDS))
def test_kernel_D_emulated_matches_plain(emulated_d, meshes4, grid, dtype, masked, cut):
    """Kernel D on the shared walk: the tet4 stiffness apply against its
    plain version, twice with the same bits."""
    g64, v64, tets, x64, free64 = meshes4[grid]
    dt = DTYPES[dtype][0]
    plan = asm.build_incidence(tets, x64.shape[0], slots=cut)
    assert cut is None or plan.bnode.numel() > 5
    ref64 = asm.stiffness_apply_plain(g64, v64, tets, x64, LAM, MU, plan,
                                      free64 if masked else None)
    g, v, x = g64.to(dt), v64.to(dt), x64.to(dt)
    fr = free64.to(dt) if masked else None
    y = emulated_force(emulated_d, g, v, tets, x, fr, plan)
    err = (y.double() - ref64).abs().max().item()
    if dt == torch.float64:
        assert err <= 1e-12 * ref64.abs().max().item()
    else:
        ref = asm.stiffness_apply_plain(g, v, tets, x, LAM, MU, plan, fr)
        assert err <= 2 * (ref.double() - ref64).abs().max().item()
    assert torch.equal(y, emulated_force(emulated_d, g, v, tets, x, fr, plan))
    if masked:
        root = free64[:, 0] == 0
        assert root.any() and torch.equal(y[root], x[root])
