"""Kernel E (csrc/csr_segment_sum.cu) and its launch plan on the CPU, without
nvcc:

- csr_ranges, the cut the wrapper launches the kernel on, at every plan and
  width the port launches it at (profile_csr.PLANS: the gather path's plans
  at DOF100K, the stencil engine's at B = 8, the tet10 flagship's): every
  segment in exactly one range, a range of several segments within its row
  and segment budgets and within one staged chunk, shared memory within a
  Hopper block's 232,448 bytes;
- the CUDA source itself, compiled with g++ against
  tests/cuda_emulation/cuda_runtime.h (each block's threads as std::threads,
  the blocks in a shuffled order, shared memory NaN before each block), on
  small plans of each regime (mostly empty segments, a few long segments,
  many short ones, one segment longer than a block's staged rows) at C in
  {1, 3, 6, 9, 36, 48}, f32 and f64: bit for bit csr_segment_sum_plain,
  twice with the same bits, at the wrapper's cut and at odd cuts (chunks of
  5 rows, so that ranges of several segments stream too);
- profile_csr --compare refuses a malformed LABEL=DIR before it builds
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

from tpufem_torch import profile_csr
from tpufem_torch.ops import csr_segment_sum as cs
from tpufem_torch.ops.kernels import parse_compare_specs

CSRC = Path(cs.__file__).resolve().parents[1] / "csrc"
STUB = Path(__file__).resolve().parent / "cuda_emulation"
HOPPER_SMEM = 232448  # a Hopper block's most shared memory
ITEMSIZES = {"f64": 8, "f32": 4}
DTYPES = {"f64": torch.float64, "f32": torch.float32}
WIDTHS = (1, 3, 6, 9, 36, 48)


# ------------------------------------------------ the launch plan at the port's plans


@pytest.fixture(scope="module")
def port_plans():
    """{(label, C): CPU plan} at every plan and width of profile_csr.PLANS."""
    torch.set_num_threads(1)
    return {(label, C): plan for make in profile_csr.PLANS for label, plan, widths in make("cpu")
            for C in widths}


PORT_CASES = [("gather incidence", 3), ("gather incidence", 6), ("gather incidence", 1),
              ("gather loads", 3), ("gather line blk_plan", 9), ("gather RBM group_plan", 4),
              ("gather RBM group_plan", 6), ("gather RBM pair_plans[0]", 36),
              ("stencil upper_plan", 24), ("stencil tet_plan", 48), ("stencil tet_plan", 8),
              ("tet10 T6 loads", 3), ("tet10 connectivity", 6), ("tet10 connectivity", 1)]


def check_cut(starts, C, itemsize, ranges, chunk_rows, range_segs, **budgets):
    """The invariants of a csr_ranges cut (module docstring)."""
    N, R = len(starts) - 1, int(starts[-1])
    assert ranges[0].tolist() == [0, 0] and ranges[-1].tolist() == [N, R]
    segs, rows = np.diff(ranges[:, 0]), np.diff(ranges[:, 1])
    assert (segs >= 1).all()  # every segment in exactly one range, in order
    np.testing.assert_array_equal(ranges[:, 1], starts[ranges[:, 0]])
    per = max(1, min(cs.STAGE_ROWS, budgets.get("stage_bytes", cs.STAGE_BYTES) // (C * itemsize)))
    assert range_segs == segs.max() <= min(per, cs.MAX_RANGE_OUT // C)
    several = segs > 1
    assert (rows[several] <= per).all() and (rows[several] <= chunk_rows).all()
    # a range of one segment that outgrows the chunk is one the cut could not split
    assert chunk_rows >= 1 and chunk_rows * C * itemsize <= max(cs.MAX_CHUNK_BYTES, C * itemsize)
    assert cs.smem_bytes(C, itemsize, chunk_rows, range_segs) <= HOPPER_SMEM


@pytest.mark.parametrize("dtype", list(ITEMSIZES))
@pytest.mark.parametrize("label,C", PORT_CASES)
def test_ranges_cover_every_segment_once_within_budget(port_plans, label, C, dtype):
    plan, itemsize = port_plans[(label, C)], ITEMSIZES[dtype]
    starts = plan.starts_host
    ranges, chunk_rows, range_segs = cs.csr_ranges(starts, C, itemsize)
    check_cut(starts, C, itemsize, ranges, chunk_rows, range_segs)
    # enough blocks to fill the card wherever the plan has the segments for it
    assert len(ranges) - 1 >= min(cs.MIN_RANGES, len(starts) - 1)
    # the launch plan the wrapper makes, with its table (and lists where the
    # plan is mostly empty), within a block's shared memory
    lp = cs.make_launch(plan, C, itemsize)
    assert lp.tab.shape == (len(ranges) - 1, cs.table_stride(chunk_rows, lp.list_len))
    assert (lp.list_len > 0) == (2 * int((np.diff(starts) == 0).sum()) >= len(starts) - 1)
    assert cs.smem_bytes(C, itemsize, chunk_rows, range_segs, lp.list_len) <= HOPPER_SMEM


def test_group_sum_takes_a_block_per_group(port_plans):
    """The RBM group sum of every f64 gather CG iteration: a block per group
    of ~100 rows (two of the tip's 28-row groups share one), not a few
    blocks of many groups."""
    plan = port_plans[("gather RBM group_plan", 6)]
    ranges, chunk_rows, range_segs = cs.csr_ranges(plan.starts_host, 6, 8)
    segs, rows = np.diff(ranges[:, 0]), np.diff(ranges[:, 1])
    assert plan.num_segments == 357 and len(ranges) - 1 >= cs.MIN_RANGES
    assert (rows[segs > 1] <= 36369 // cs.MIN_RANGES + 1).all() and range_segs <= 2
    assert chunk_rows == int(np.diff(plan.starts_host).max()) == 112


def test_launch_plan_is_cut_once_per_width():
    plan = cs.csr_plan(np.array([2, 0, 2, 1, 2]), 4)
    a = cs.launch_plan(plan, 3, 8)
    assert cs.launch_plan(plan, 3, 8) is a and set(plan.launch) == {(3, 8)}
    assert a.tab.dtype == torch.int32 and a.n_ranges == len(a.tab) == 4
    cs.launch_plan(plan, 3, 4)
    assert set(plan.launch) == {(3, 8), (3, 4)}


def test_range_table_rows_hold_bounds_and_first_chunk_indices():
    rng = np.random.default_rng(2)
    ids = rng.integers(0, 50, 700)
    ids[ids == 7] = 8  # an empty segment
    plan = cs.csr_plan(ids, 50)
    ranges, _, _ = cs.csr_ranges(plan.starts_host, 3, 8, stage_bytes=40 * 24, min_ranges=4)
    order, starts = plan.order.numpy(), plan.starts_host
    dense, zero = cs.range_table(plan.order, ranges, 16)
    listed, list_len = cs.range_table(plan.order, ranges, 16, starts)
    assert zero == 0 and dense.shape == (len(ranges) - 1, cs.table_stride(16))
    assert listed.shape == (len(ranges) - 1, cs.table_stride(16, list_len))
    for tab in (dense.numpy(), listed.numpy()):
        assert tab.shape[1] % 4 == 0
        for b, ((s0, r0), (s1, r1)) in enumerate(zip(ranges[:-1], ranges[1:])):
            n = min(r1 - r0, 16)
            with_rows = np.nonzero(np.diff(starts[s0:s1 + 1]))[0]
            k = len(with_rows) if tab is not dense.numpy() and r1 - r0 <= 16 else -1
            np.testing.assert_array_equal(tab[b, :8], [s0, r0, s1, r1, k, 0, 0, 0])
            np.testing.assert_array_equal(tab[b, 8:8 + n], order[r0:r0 + n])
            assert (tab[b, 8 + n:24] == 0).all()
            if k >= 0:
                np.testing.assert_array_equal(tab[b, 24:24 + k], with_rows)
                np.testing.assert_array_equal(tab[b, 24 + list_len:24 + list_len + k + 1],
                                              np.append(starts[s0 + with_rows], r1) - r0)


# ------------------------------------------------ the source, emulated on the CPU


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """csrc/csr_segment_sum.cu compiled with g++ against the emulation
    header, as a ctypes library."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    out = tmp_path_factory.mktemp("cuda_emulation")
    s = (CSRC / "csr_segment_sum.cu").read_text()
    s = s.replace("extern __shared__ __align__(16) unsigned char smem_raw[];",
                  "unsigned char* smem_raw = emu_smem;")
    s, n = re.subn(r"(\w+<[^<>;]*>)<<<(.*?), (\w+), .*?>>>\((.*?)\);",
                   r"emu_launch(\2, \3, [&]() { \1(\4); });", s, flags=re.S)
    assert n == 2  # the f64 and the f32 kernel
    (out / "csr_segment_sum.cpp").write_text(s)
    lib = out / "libcsr.so"
    subprocess.run(["g++", "-std=c++17", "-O1", "-fPIC", "-shared", "-pthread", "-I", str(STUB),
                    "-o", str(lib), str(out / "csr_segment_sum.cpp")], check=True)
    lib = ctypes.CDLL(str(lib))
    for d in ("f32", "f64"):
        fn = getattr(lib, f"tpufem_csr_segment_sum_ranges_{d}")
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def emulated_sum(lib, vals, plan, ranges, chunk_rows, range_segs, listed=False):
    """The emulated kernel on a table of `ranges`, with its ranges' segments
    with rows listed or not."""
    N, C = plan.num_segments, vals.shape[1]
    out = torch.full((N, C), float("nan"), dtype=vals.dtype)
    tab, list_len = cs.range_table(plan.order, ranges, chunk_rows,
                                   plan.starts_host if listed else None)
    fn = getattr(lib, "tpufem_csr_segment_sum_ranges_" + ("f64" if vals.dtype == torch.float64
                                                           else "f32"))
    assert fn(vals.data_ptr(), plan.order.data_ptr(), plan.starts.data_ptr(), tab.data_ptr(),
              out.data_ptr(), C, len(ranges) - 1, chunk_rows, range_segs, list_len, None) == 0
    return out


def regime_ids(regime: str, rng) -> tuple:
    """(segment ids in row order, num_segments) of a small plan of one regime."""
    if regime == "mostly empty":  # the loads: few segments of 1-3 rows among many
        hot = rng.choice(600, 40, replace=False)
        return rng.permutation(np.repeat(hot, rng.integers(1, 4, 40))), 600
    if regime == "few long":  # the RBM group sum: a few groups of ~100 rows
        return rng.permutation(np.repeat(np.arange(6), rng.integers(90, 113, 6))), 6
    if regime == "many short":  # the incidence and connectivity: 0-24 rows each
        return rng.integers(0, 80, 520), 80
    if regime == "one longer than a chunk":  # the RBM pair plans: 576 rows, empties around
        ids = np.concatenate([np.full(300, 5), np.full(260, 9), rng.integers(0, 20, 40)])
        return rng.permutation(ids), 20
    raise ValueError(regime)


REGIMES = ("mostly empty", "few long", "many short", "one longer than a chunk")


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("C", WIDTHS)
@pytest.mark.parametrize("regime", REGIMES)
def test_kernel_emulated_equals_plain_bitwise(emulated, regime, C, dtype):
    """The source at the wrapper's cut (the row budget scaled down for the
    long segment, so that it streams at every width), with its ranges'
    segments with rows listed in the table and not, and at chunks of 5 rows
    over ranges of several segments: the plain version's bits, twice."""
    rng = np.random.default_rng(WIDTHS.index(C) + 10 * REGIMES.index(regime))
    ids, N = regime_ids(regime, rng)
    plan = cs.csr_plan(ids, N)
    vals = torch.as_tensor(rng.normal(size=(len(ids), C)) * 10.0 ** rng.integers(-3, 4, C),
                           dtype=DTYPES[dtype])
    ref = cs.csr_segment_sum_plain(vals, plan)
    itemsize = ITEMSIZES[dtype]
    stage = cs.STAGE_BYTES if regime != "one longer than a chunk" else 64 * C * itemsize
    cut = cs.csr_ranges(plan.starts_host, C, itemsize, stage_bytes=stage, min_ranges=8)
    check_cut(plan.starts_host, C, itemsize, *cut, stage_bytes=stage)
    if regime == "one longer than a chunk":
        cut = (cut[0], 128, cut[2])  # 300 rows through chunks of 128
    ranges, _, segs = cs.csr_ranges(plan.starts_host, C, itemsize, stage_bytes=30 * C * itemsize,
                                    min_ranges=4)
    odd = (ranges, 5, segs)  # ranges of up to 30 rows, staged 5 rows at a time
    for (r, chunk_rows, range_segs), listed in ((cut, False), (cut, True), (odd, False)):
        out = emulated_sum(emulated, vals, plan, r, chunk_rows, range_segs, listed)
        assert torch.equal(out, ref), (regime, C, dtype, chunk_rows, listed)
        assert torch.equal(out, emulated_sum(emulated, vals, plan, r, chunk_rows, range_segs,
                                             listed))


def test_kernel_emulated_misaligned_rows_and_empty_plan(emulated):
    """A view whose rows are not 16-byte aligned (f32, C = 4: 8-byte units)
    and a plan with no rows (every output 0)."""
    rng = np.random.default_rng(3)
    ids = rng.integers(0, 30, 200)
    plan = cs.csr_plan(ids, 30)
    base = torch.as_tensor(rng.normal(size=(200 * 4 + 2,)), dtype=torch.float32)
    vals = base[2:].view(200, 4)  # 8 bytes past a 16-byte boundary
    cut = cs.csr_ranges(plan.starts_host, 4, 4, min_ranges=8)
    assert torch.equal(emulated_sum(emulated, vals, plan, *cut), cs.csr_segment_sum_plain(vals,
                                                                                         plan))
    empty = cs.csr_plan(np.zeros(0, np.int64), 40)
    cut = cs.csr_ranges(empty.starts_host, 3, 8, min_ranges=8)
    for listed in (False, True):
        out = emulated_sum(emulated, torch.zeros((0, 3), dtype=torch.float64), empty, *cut,
                           listed)
        assert torch.equal(out, torch.zeros((40, 3), dtype=torch.float64))


def test_profile_csr_compare_refuses_a_malformed_spec(monkeypatch):
    for bad in ("nolabel", "=dir", "label="):
        with pytest.raises(ValueError):
            parse_compare_specs([bad])
        with pytest.raises(ValueError):
            profile_csr.main(["--compare", bad])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert profile_csr.main(["--compare", "parent=build/parent"]) == 2  # parsed; no card
