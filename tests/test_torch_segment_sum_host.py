"""Kernel A entry (b) (csrc/segment_sum.cu, ``gather_row_sum``, over the row
pointers of ``segment_rowptr``) on the CPU, without nvcc: the CUDA source
compiled with g++ against tests/cuda_emulation/cuda_runtime.h (each block's
threads as std::threads, a group of lanes' shuffles at a barrier of their
own, the blocks in a shuffled order), beside a host reference in C++ that
sums each segment's rows in row order from 0 with one ``fmaf`` each.

Regimes: isolated nodes (empty segments, a run of them at the end), dump
rows, short segments, a segment longer than a warp's 32 rows, one huge
segment, no rows at all; each under weights, unit weights, ``rowdiv`` and
``normalize``, at C in {1, 3, 8, 128, 300} (lane groups of 1 to 32 lanes,
the float4 and the scalar routes, a row wider than a warp), with
16-byte-aligned rows and rows offset by 4 bytes (the scalar route): the
row-pointer kernel equal to searchsorted, the sums bit for bit the
reference, and (under rowdiv) again with the same bits, the blocks in
another order. Then the wrapper's plain version against the same
reference (to f32 rounding), and the row-pointer kernel on ids out of
range.
"""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from tpufem_torch.ops import gather_scatter as tgs

CSRC = Path(tgs.__file__).resolve().parents[1] / "csrc"
STUB = Path(__file__).resolve().parent / "cuda_emulation"
WIDTHS = (1, 3, 8, 128, 300)
MODES = ("weighted", "unit weights", "rowdiv", "normalize")

# the host reference: segment s's rows in row order, out = fmaf(w, x, out) from 0
REFERENCE = r"""
extern "C" void reference_gather_row_sum(const float* x, const int* idx, const float* w,
                                         const float* rowdiv, const int* seg, float* out,
                                         float* deg, long long E, long long C, int N,
                                         int normalize) {
  for (long long i = 0; i < static_cast<long long>(N) * C; ++i) out[i] = 0.0f;
  for (int s = 0; s < N; ++s) deg[s] = 0.0f;
  for (long long r = 0; r < E; ++r) {
    const int s = seg[r];
    if (s < 0 || s >= N) continue;
    float wr = w != nullptr ? w[r] : 1.0f;
    if (rowdiv != nullptr) wr /= fmaxf(rowdiv[idx[r]], 1.0f);
    for (long long c = 0; c < C; ++c) {
      out[s * C + c] = fmaf(wr, x[static_cast<long long>(idx[r]) * C + c], out[s * C + c]);
    }
    deg[s] += wr;
  }
  if (normalize) {
    for (int s = 0; s < N; ++s)
      for (long long c = 0; c < C; ++c) out[s * C + c] /= fmaxf(deg[s], 1.0f);
  }
}
"""


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """csrc/segment_sum.cu and the reference compiled with g++ against the
    emulation header, as a ctypes library."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    out = tmp_path_factory.mktemp("cuda_emulation")
    s = (CSRC / "segment_sum.cu").read_text()
    s, n = re.subn(r"(\w+(?:<[^<>;]*>)?)<<<(.*?), (\w+), .*?>>>\((.*?)\);",
                   r"emu_launch(\2, \3, [&]() { \1(\4); });", s, flags=re.S)
    assert n == 5  # row pointers, entries (a) and (b) x 2 (float4, float), kernel C x 2
    (out / "segment_sum.cpp").write_text(s + REFERENCE)
    lib = out / "libsegment_sum.so"
    subprocess.run(["g++", "-std=c++17", "-O1", "-fPIC", "-shared", "-pthread", "-I", str(STUB),
                    "-o", str(lib), str(out / "segment_sum.cpp")], check=True)
    lib = ctypes.CDLL(str(lib))
    P, L, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.tpufem_segment_rowptr_i32.argtypes = [P, P, L, I, P]
    lib.tpufem_gather_row_sum_f32.argtypes = [P] * 7 + [L, L, I, I, P]
    lib.reference_gather_row_sum.argtypes = [P] * 7 + [L, L, I, I]
    lib.reference_gather_row_sum.restype = None
    return lib


def _ptr(t):
    return None if t is None else t.data_ptr()


def emulated_rowptr(lib, seg, N):
    rowptr = torch.full((N + 1,), -7, dtype=torch.int32)
    assert lib.tpufem_segment_rowptr_i32(_ptr(seg), _ptr(rowptr), seg.shape[0], N, None) == 0
    return rowptr


def emulated_sum(lib, x, idx, w, rowptr, rowdiv, normalize):
    """(sums, deg) of the emulated kernel, its outputs NaN before the call."""
    N = rowptr.shape[0] - 1
    out = torch.full((N, x.shape[1]), float("nan"))
    deg = torch.full((N,), float("nan"))
    assert lib.tpufem_gather_row_sum_f32(
        _ptr(x), _ptr(idx), _ptr(w), _ptr(rowdiv), _ptr(rowptr), _ptr(out), _ptr(deg),
        x.shape[0], x.shape[1], N, int(normalize), None) == 0
    return out, deg


def reference_sum(lib, x, idx, w, seg, N, rowdiv, normalize):
    x = x.contiguous()
    out, deg = torch.empty((N, x.shape[1])), torch.empty(N)
    lib.reference_gather_row_sum(_ptr(x), _ptr(idx), _ptr(w), _ptr(rowdiv), _ptr(seg), _ptr(out),
                                 _ptr(deg), idx.shape[0], x.shape[1], N, int(normalize))
    return out, deg


def regime_ids(regime: str, rng) -> tuple:
    """(sorted segment ids, num_segments) of a small plan."""
    if regime == "isolated nodes":  # a third of the segments empty, a run of them at the end
        hot = np.sort(rng.choice(np.arange(0, 48, 3), 12, replace=False))
        return np.repeat(hot, rng.integers(1, 9, 12)), 60
    if regime == "dump rows":  # the masked edges at the end, in the dump segment
        ids = np.sort(rng.integers(0, 40, 90))
        return np.concatenate([ids, np.full(21, 40)]), 40
    if regime == "short segments":  # 1-9 rows each, as a surface mesh's nodes have
        return np.repeat(np.arange(16), rng.integers(1, 10, 16)), 16
    if regime == "longer than a warp":  # 45 rows: a warp's 32 row indices twice
        return np.concatenate([np.repeat([0, 1], [5, 3]), np.full(45, 2),
                               np.repeat(np.arange(3, 20), 3)]), 22
    if regime == "one huge segment":  # 400 rows
        return np.concatenate([np.repeat(np.arange(5), 2), np.full(400, 6),
                               np.arange(7, 25)]), 26
    if regime == "no rows":
        return np.zeros(0, np.int64), 9
    raise ValueError(regime)


REGIMES = ("isolated nodes", "dump rows", "short segments", "longer than a warp",
           "one huge segment", "no rows")


def case_inputs(regime, C, offset, rng):
    """(x, idx, w, seg, N, rowdiv) of a regime at width C, x's rows `offset`
    floats past a 16-byte boundary."""
    ids, N = regime_ids(regime, rng)
    E, R = len(ids), 23
    base = torch.as_tensor(rng.normal(size=R * C + offset), dtype=torch.float32)
    x = base[offset:].view(R, C)
    idx = torch.as_tensor(rng.integers(0, R, E), dtype=torch.int32)
    w = torch.as_tensor(rng.uniform(0.25, 1.5, E), dtype=torch.float32)
    seg = torch.as_tensor(ids, dtype=torch.int32)
    rowdiv = torch.as_tensor(rng.uniform(0.0, 6.0, R), dtype=torch.float32)
    return x, idx, w, seg, N, rowdiv


def mode_args(mode, w, rowdiv):
    """(w, rowdiv, normalize) of a mode."""
    return {"weighted": (w, None, False), "unit weights": (None, None, False),
            "rowdiv": (w, rowdiv, False), "normalize": (w, None, True)}[mode]


@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "offset"])
@pytest.mark.parametrize("C", WIDTHS)
@pytest.mark.parametrize("regime", REGIMES)
def test_kernel_emulated_equals_row_order_fma_bitwise(emulated, regime, C, offset):
    rng = np.random.default_rng(WIDTHS.index(C) + 10 * REGIMES.index(regime))
    x, idx, w, seg, N, rowdiv = case_inputs(regime, C, offset, rng)
    assert (x.data_ptr() % 16 == 0) == (offset == 0)
    rowptr = emulated_rowptr(emulated, seg, N)
    np.testing.assert_array_equal(rowptr.numpy(), np.searchsorted(seg.numpy(), np.arange(N + 1)))
    for mode in MODES:
        wm, rd, normalize = mode_args(mode, w, rowdiv)
        ref, ref_deg = reference_sum(emulated, x, idx, wm, seg, N, rd, normalize)
        out, deg = emulated_sum(emulated, x, idx, wm, rowptr, rd, normalize)
        assert torch.equal(out, ref) and torch.equal(deg, ref_deg), (regime, C, offset, mode)
        if mode == "rowdiv":  # the blocks in another order
            again = emulated_sum(emulated, x, idx, wm, rowptr, rd, normalize)
            assert torch.equal(again[0], out) and torch.equal(again[1], deg)


@pytest.mark.parametrize("case", ["ids-out-of-range", "all-dump", "gaps"])
def test_rowptr_kernel_emulated(emulated, case):
    """Rows of a negative id lie before rowptr[0], rows of an id >= N past
    rowptr[N]; every pointer is written exactly once (the output starts at
    -7)."""
    seg, N = {"ids-out-of-range": ([-3, -1, 0, 2, 2, 9, 9], 5), "all-dump": ([17] * 30, 17),
              "gaps": ([0, 0, 5, 5, 5, 60, 61, 61, 64, 64], 64)}[case]
    seg = torch.as_tensor(seg, dtype=torch.int32)
    assert torch.equal(emulated_rowptr(emulated, seg, N), tgs.segment_rowptr_plain(seg, N))


@pytest.mark.parametrize("regime", REGIMES)
def test_plain_version_matches_reference(emulated, regime):
    """gather_row_sum on CPU tensors (its plain version: index_add_) against
    the row-order reference, to f32 rounding; rows of the dump segment are
    dropped."""
    rng = np.random.default_rng(REGIMES.index(regime))
    x, idx, w, seg, N, rowdiv = case_inputs(regime, 8, 0, rng)
    rowptr = tgs.segment_rowptr(seg, N)
    for mode in MODES:
        wm, rd, normalize = mode_args(mode, w, rowdiv)
        before = tgs.gather_row_sum.launches
        out, deg = tgs.gather_row_sum(x, idx, wm, rowptr, rd, normalize)
        assert tgs.gather_row_sum.launches == before  # the CPU takes the plain version
        ref, ref_deg = reference_sum(emulated, x, idx, wm, seg, N, rd, normalize)
        torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(deg, ref_deg, rtol=1e-6, atol=1e-6)


def test_profile_aggregation_compare_refuses_a_malformed_spec(monkeypatch):
    from tpufem_torch import profile_aggregation

    for bad in ("nolabel", "=dir", "label="):
        with pytest.raises(ValueError):
            profile_aggregation.main(["--compare", bad])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert profile_aggregation.main(["--compare", "parent=build/parent"]) == 2  # parsed; no card
