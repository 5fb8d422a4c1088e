"""Kernels L (strain_apply10) and M (restrict_p) of tpufem_torch on the CPU,
without nvcc:

- the DNDXI table that csrc/strain_apply10.cu folds at compile time equals
  tpufem's (tpufem/fem/tet10.py) within one f64 ulp, and its force-slot
  tables follow from the port's node positions (fem/tet10_stencil.py);
- the launch plans the wrappers compute (l_plan, m_plan) at every shape the
  paths launch (the flagship, the modal CLI's 32x40x4, WingModal10's 8x10x2,
  the gpu tests' grids, the tile edges, a span that is no multiple of the
  tile): every cell and node in exactly one tile, every doubled column of L
  stored exactly once by the kernel's rule (l_stores), shared memory within
  a Hopper block's 232,448 bytes;
- the CUDA sources themselves, compiled with g++ against
  tests/cuda_emulation/cuda_runtime.h (each block's threads as std::threads,
  the blocks in a shuffled order), against the plain versions at tpufem's
  tolerances (L: f64 1e-12, f32 1e-5; M: 1e-14, 1e-6 of the largest entry),
  at the default tiles and at odd ones, twice with the same bits;
- profile_tet10 --compare refuses a malformed LABEL=DIR before it builds
  anything.
"""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from tpufem.fem.tet10 import DNDXI as TPUFEM_DNDXI
from tpufem_torch import profile_tet10
from tpufem_torch.fem import tet10_stencil as ts
from tpufem_torch.fem.material import Material, lame_params
from tpufem_torch.mesher import DOF1M_TET10, WingMeshResolution
from tpufem_torch.ops.kernels import parse_compare_specs

CSRC = Path(ts.__file__).resolve().parents[1] / "csrc"
STUB = Path(__file__).resolve().parent / "cuda_emulation"
LAM, MU = lame_params(Material())
HOPPER_SMEM = 232448  # a Hopper block's most shared memory

# the shapes the paths launch L and M at, and the grids of the gpu tests
PLAN_SHAPES = {
    "DOF1M_TET10": DOF1M_TET10,
    "modal CLI 32x40x4": WingMeshResolution(32, 40, 4, 0.006, "le"),
    "WingModal10 8x10x2": WingMeshResolution(8, 10, 2, 0.006, "le"),
    "16x24x4 sharp TE": WingMeshResolution(16, 24, 4, 0.0, "le"),
    "8x6x2 floored": WingMeshResolution(8, 6, 2, 0.006, "le"),
    "6x4x2 sharp TE": WingMeshResolution(6, 4, 2, 0.0, "le"),
    "10x18x8 tiles": WingMeshResolution(10, 18, 8, 0.006, "le"),
    "9x9x4 sharp TE, tile edges": WingMeshResolution(9, 9, 4, 0.0, "le"),
    "4x3x2 sharp TE, one tile": WingMeshResolution(4, 3, 2, 0.0, "le"),
    "13x37x4, span no multiple of the tile": WingMeshResolution(13, 37, 4, 0.006, "le"),
}
ITEMSIZES = {"f64": 8, "f32": 4}


def macro_numbers(source: str, name: str) -> np.ndarray:
    """The numbers of the multi-line #define `name` in csrc/`source`."""
    lines = (CSRC / source).read_text().splitlines()
    start = next(i for i, l in enumerate(lines) if l.startswith(f"#define {name}"))
    body = []
    for line in lines[start:]:
        body.append(line.rstrip("\\").replace(f"#define {name}", ""))
        if not line.rstrip().endswith("\\"):
            break
    return np.array([float(v) for v in re.findall(r"-?\d+(?:\.\d+)?(?:e-?\d+)?", " ".join(body))])


def slot_tables():
    """Kernel L's force slots from the node positions: tets 0-2 of a cell add
    into slots 0-17, tets 3-5 into 18-35, each half's positions in order;
    ([h][o] half h's slot of cell-local position o or -1, [t][m] the slot of
    node m of tet t)."""
    pos = [[-1] * 27 for _ in range(2)]
    for h in range(2):
        for i, o in enumerate(sorted({int(v) for v in ts._NODE_POS[3 * h:3 * h + 3].ravel()})):
            pos[h][o] = 18 * h + i
    return pos, [[pos[t // 3][int(ts._NODE_POS[t, m])] for m in range(10)] for t in range(6)]


def l_stores(res: WingMeshResolution, plan) -> np.ndarray:
    """How often kernel L stores each doubled column (i2, j2) under `plan`,
    by csrc/strain_apply10.cu's rule: a tile stores the columns of its
    closure that no other tile's closure holds, and tile (by, bx) finishes
    the shared columns of its low-i face (by > 0) and low-j face (bx > 0)
    from the partials."""
    nc, ns = res.n_chord, res.n_span
    n = np.zeros((2 * nc + 1, 2 * ns + 1), np.int64)
    for by in range(plan.tiles_i):
        for bx in range(plan.tiles_j):
            i0, j0 = 2 * by * plan.TI, 2 * bx * plan.TJ
            ti, tj = min(plan.TI, nc - by * plan.TI), min(plan.TJ, ns - bx * plan.TJ)
            for li2 in range(2 * ti + 1):
                for lj2 in range(2 * tj + 1):
                    shared = ((li2 == 0 and by > 0) or (li2 == 2 * ti and by < plan.tiles_i - 1)
                              or (lj2 == 0 and bx > 0)
                              or (lj2 == 2 * tj and bx < plan.tiles_j - 1))
                    n[i0 + li2, j0 + lj2] += not shared
            if by > 0:
                jhi = 2 * ns if bx == plan.tiles_j - 1 else j0 + 2 * plan.TJ - 1
                n[i0, j0:jhi + 1] += 1
            if bx > 0:
                ihi = 2 * nc if by == plan.tiles_i - 1 else i0 + 2 * plan.TI - 1
                n[i0 + (by > 0):ihi + 1, j0] += 1
    return n


def test_dndxi_table_in_source_matches_tpufem():
    """Kernel L's compile-time DNDXI equals tpufem's within one f64 ulp, and
    its zero entries (the terms the kernel drops) are tpufem's zeros."""
    src = macro_numbers("strain_apply10.cu", "TPUFEM_DNDXI").reshape(4, 10, 3)
    ref = np.asarray(TPUFEM_DNDXI, np.float64)
    assert np.all(np.abs(src - ref) <= np.spacing(np.abs(ref)))
    np.testing.assert_array_equal(src == 0.0, ref == 0.0)


def test_slot_tables_in_source_match_the_node_positions():
    """Kernel L's force-slot tables follow from the port's node positions:
    node m of tet t lands in its half's slot of its cell-local position;
    every position has a slot and the two halves share exactly the 9
    positions both touch."""
    pos = macro_numbers("strain_apply10.cu", "TPUFEM_L_POS_SLOT").astype(int).reshape(2, 27)
    tet = macro_numbers("strain_apply10.cu", "TPUFEM_L_TET_SLOT").astype(int).reshape(6, 10)
    want_pos, want_tet = slot_tables()
    np.testing.assert_array_equal(pos, want_pos)
    np.testing.assert_array_equal(tet, want_tet)
    for t in range(6):
        for m in range(10):
            assert tet[t, m] == pos[t // 3, ts._NODE_POS[t, m]]
    assert ((pos >= 0).any(axis=0)).all() and ((pos >= 0).all(axis=0)).sum() == 9
    assert sorted(pos[pos >= 0].tolist()) == list(range(ts.L_SLOTS))


@pytest.mark.parametrize("dtype", list(ITEMSIZES))
@pytest.mark.parametrize("shape", list(PLAN_SHAPES))
def test_l_plan_covers_every_cell_and_column_once(shape, dtype):
    res, itemsize = PLAN_SHAPES[shape], ITEMSIZES[dtype]
    plan = ts.l_plan(res, itemsize)
    nc, nt, ns = res.n_chord, res.n_thick, res.n_span
    assert plan.TI * plan.TJ * nt <= ts.L_CELLS
    assert plan.smem == ts.L_SLOTS * 3 * plan.TI * plan.TJ * nt * itemsize
    assert plan.smem <= ts.MAX_DYNAMIC_SMEM < HOPPER_SMEM
    assert plan.rim == 4 * (plan.TI + plan.TJ) + 4 * (2 * plan.TJ + 1)
    cells = np.zeros((nc, ns), np.int64)
    for by in range(plan.tiles_i):
        for bx in range(plan.tiles_j):
            cells[by * plan.TI:(by + 1) * plan.TI, bx * plan.TJ:(bx + 1) * plan.TJ] += 1
    np.testing.assert_array_equal(cells, 1)
    np.testing.assert_array_equal(l_stores(res, plan), 1)


@pytest.mark.parametrize("dtype", list(ITEMSIZES))
@pytest.mark.parametrize("shape", list(PLAN_SHAPES))
def test_m_plan_covers_every_node_once(shape, dtype):
    res, itemsize = PLAN_SHAPES[shape], ITEMSIZES[dtype]
    plan = ts.m_plan(res, itemsize)
    NI, NK, NJ = res.n_chord + 1, res.n_thick + 1, res.n_span + 1
    assert plan.TJr <= ts.M_NODE_COLS and (2 * plan.TIr + 1) * (2 * NK - 1) <= ts.M_MAX_ROWS
    assert plan.smem + 4 * ts.M_MAX_ROWS <= ts.MAX_DYNAMIC_SMEM < HOPPER_SMEM
    nodes = np.zeros((NI, NJ), np.int64)
    for by in range(plan.tiles_i):
        for bx in range(plan.tiles_j):
            nodes[by * plan.TIr:(by + 1) * plan.TIr, bx * plan.TJr:(bx + 1) * plan.TJr] += 1
    np.testing.assert_array_equal(nodes, 1)


def test_profile_tet10_compare_refuses_a_malformed_spec(monkeypatch):
    assert parse_compare_specs(["parent=build/parent/tpufem_torch/csrc", "v=x"]) == [
        ("parent", Path("build/parent/tpufem_torch/csrc")), ("v", Path("x"))]
    for bad in ("nolabel", "=dir", "label="):
        with pytest.raises(ValueError):
            parse_compare_specs([bad])
        with pytest.raises(ValueError):
            profile_tet10.main(["--compare", bad])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert profile_tet10.main(["--compare", "parent=build/parent"]) == 2  # parsed; no card


# ------------------------------------------------ the sources, emulated on the CPU


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """csrc/strain_apply10.cu and p_transfer.cu compiled with g++ against the
    emulation header, as ctypes libraries."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    out = tmp_path_factory.mktemp("cuda_emulation")
    for h in CSRC.glob("*.cuh"):
        shutil.copy(h, out / h.name)
    libs = {}
    for name in ("strain_apply10", "p_transfer"):
        s = (CSRC / f"{name}.cu").read_text()
        s = s.replace("extern __shared__ __align__(16) unsigned char smem_raw[];",
                      "unsigned char* smem_raw = emu_smem;")
        s = re.sub(r"(\w+(?:<\w+>)?)<<<(.*?), (\w+), .*?>>>\((.*?)\);",
                   r"emu_launch(\2, \3, [&]() { \1(\4); });", s, flags=re.S)
        (out / f"{name}.cpp").write_text(s)
        lib = out / f"lib{name}.so"
        subprocess.run(["g++", "-std=c++17", "-O1", "-fPIC", "-shared", "-pthread", "-I", str(STUB),
                        "-I", str(out), "-o", str(lib), str(out / f"{name}.cpp")], check=True)
        libs[name] = ctypes.CDLL(str(lib))
    P, I, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    for d in ("f32", "f64"):
        fn = getattr(libs["strain_apply10"], f"tpufem_strain_apply10_tiled_{d}")
        fn.argtypes, fn.restype = [P] * 7 + [I] * 7 + [D] * 2 + [P], I
        fn = getattr(libs["p_transfer"], f"tpufem_restrict_p_tiled_{d}")
        fn.argtypes, fn.restype = [P] * 3 + [I] * 7 + [P], I
    return libs


def emulated_L(lib, res, geo, u, free2, plan):
    g, vol = geo
    _, B, NI2, NK2, NJ2 = u.shape
    tiles = B * plan.tiles_i * plan.tiles_j
    y = torch.full_like(u, float("nan"))
    partial = torch.full((tiles * plan.rim * 3 * NK2,), float("nan"), dtype=u.dtype)
    ticket = torch.zeros(tiles, dtype=torch.int32)
    fn = getattr(lib, "tpufem_strain_apply10_tiled_" + ("f64" if u.dtype == torch.float64 else "f32"))
    assert fn(g.data_ptr(), vol.data_ptr(), u.data_ptr(), free2.data_ptr(), y.data_ptr(),
              partial.data_ptr(), ticket.data_ptr(), B, NI2, NK2, NJ2,
              int(res.te_floor_frac == 0.0), plan.TI, plan.TJ, LAM, MU, None) == 0
    assert (ticket == 0).all()  # left at 0 for the next call
    return y


def emulated_R(lib, res, r2, free4, plan):
    B = r2.shape[1]
    NI, NK, NJ = res.n_chord + 1, res.n_thick + 1, res.n_span + 1
    y4 = torch.full((3, B, NI, NK, NJ), float("nan"), dtype=r2.dtype)
    fn = getattr(lib, "tpufem_restrict_p_tiled_" + ("f64" if r2.dtype == torch.float64 else "f32"))
    assert fn(r2.data_ptr(), free4.data_ptr(), y4.data_ptr(), B, NI, NK, NJ,
              int(res.te_floor_frac == 0.0), plan.TIr, plan.TJr, None) == 0
    return y4


EMULATED = {"6x4x2 sharp TE B=2": (WingMeshResolution(6, 4, 2, 0.0, "le"), 2),
            "9x9x4 sharp TE, tile edges": (WingMeshResolution(9, 9, 4, 0.0, "le"), 1)}
TOL = {"f64": (torch.float64, 1e-12, 1e-14), "f32": (torch.float32, 1e-5, 1e-6)}


@pytest.mark.parametrize("dtype", list(TOL))
@pytest.mark.parametrize("case", list(EMULATED))
def test_kernels_emulated_match_plain(emulated, case, dtype):
    """The sources of L and M, run as host threads at the wrappers' tiles and
    at tiles of one cell (L) and one node (M), against the plain versions;
    the same bits twice. L's odd tiles put shared faces on the weld rows."""
    res, B = EMULATED[case]
    torch_dtype, tol_l, tol_m = TOL[dtype]
    rng = np.random.default_rng(B)
    p4 = np.tile([[1.2, 0.35, 10.0, 0.10]], (B, 1))
    X2 = ts.nodes_grid2(res, torch.as_tensor(p4), torch_dtype)
    geo = ts.cell_geometry2(res, X2)
    u = torch.as_tensor(rng.standard_normal(X2.shape) * 1e-3, dtype=torch_dtype)
    free2 = ts.free_mask2(res, torch_dtype)
    ref = ts.strain_apply10_plain(res, geo, u, free2, LAM, MU)
    nc, ns = res.n_chord, res.n_span
    for TI, TJ in ((None, None), (1, 1), (2, 3)):
        plan = (ts.l_plan(res, u.element_size()) if TI is None else
                ts.LPlan(TI, TJ, -(-nc // TI), -(-ns // TJ), 0, 4 * (TI + TJ) + 4 * (2 * TJ + 1)))
        y = emulated_L(emulated["strain_apply10"], res, geo, u, free2, plan)
        assert (y - ref).abs().max().item() <= tol_l * ref.abs().max().item(), plan
        assert torch.equal(y, emulated_L(emulated["strain_apply10"], res, geo, u, free2, plan))
    NI, NJ = res.n_chord + 1, res.n_span + 1
    r2 = torch.as_tensor(rng.standard_normal((3, B, *ts._doubled(res))), dtype=torch_dtype)
    free4 = torch.ones((1, 1, 1, 1, NJ), dtype=torch_dtype)
    free4[..., 0] = 0.0
    ref = ts.restrict_p_plain(res, r2, free4)
    for plan in (ts.m_plan(res, r2.element_size()), ts.MPlan(1, 1, NI, NJ, 0)):
        y4 = emulated_R(emulated["p_transfer"], res, r2, free4, plan)
        assert (y4 - ref).abs().max().item() <= tol_m * ref.abs().max().item(), plan
        assert torch.equal(y4, emulated_R(emulated["p_transfer"], res, r2, free4, plan))
