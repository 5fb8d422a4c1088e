// Kernel A: row sums over SORTED int32 segment ids (f32), in two entries, the
// row-pointer kernel that plans them, and kernel C, the row gather that is
// entry (a)'s backward.
//
// Replaces the Pallas TPU kernel tpufem/ops/gather_scatter.py::_seg_sum_kernel
// (reached through sorted_segment_sum_pallas) and its VJP _seg_sum_bwd, which
// GraphSAGE's mean aggregation uses: out[s, :] = sum of the rows r with
// seg[r] == s, for s < num_segments. Rows whose id is num_segments (padding,
// masked edges) belong to no output row and are dropped.
//
// What bounds all of it on the card: bytes. There is almost no arithmetic
// (one multiply-add per element read) and no product, so tensor cores buy
// nothing: the TPU kernel's one-hot and triangular MXU matmuls existed only
// because its whole output had to stay resident in VMEM across a sequential
// grid (hence its MAX_SEGMENTS cap and the XLA fallback above it). Here every
// segment is independent and there is no cap.
//
// Design.
//  - Run boundaries once per graph, not once per thread: segment_rowptr turns
//    the sorted ids into row pointers (rowptr[s] = first row whose id >= s),
//    the TPU kernel's per-tile is_start / slot walk done once. Dump rows lie
//    past rowptr[num_segments], so no sum ever visits them.
//  - Kernel A: a group of lanes per segment (C/4 lanes, a whole warp at
//    C=128; each lane owns one float4 of the row) walks the rows
//    [rowptr[s], rowptr[s+1]) in order, with kRows row loads in flight in
//    entry (a) and one in entry (b).
//    Entry (a) sums the rows of msgs themselves. Entry (b) is the fused
//    neighbour sum: row r is x[idx[r], :] * w[r], read straight from the node
//    features through the read-only path (mesh neighbours lie close in memory,
//    so gathered rows come from L2), the same launch accumulates
//    deg[s] = sum w[r] and, when asked, writes sums / max(deg, 1). The lanes
//    of a group load idx and w of up to a group's width of rows together, one
//    row per lane, and hand them round by shuffle. No (E, C) tensor exists.
//    Its backward is entry (b) again over the edges sorted by source, with
//    each row's weight divided by max(rowdiv[idx[r]], 1).
//  - Kernel C: a group of lanes per kRows consecutive edge rows copies
//    g[seg[e], :] to out[e, :] (0 for dump rows) with all row loads in flight
//    before the stores.
//  - 16-byte float4 loads and stores when C is a multiple of 4 and the
//    pointers are 16-byte aligned, a scalar route (C lanes per group) for any
//    other C or alignment; 32-bit index arithmetic (the entry points refuse
//    tensors of 2^31 elements or more).
//  - No atomics anywhere: rows are summed in order, so two runs give the same
//    bits.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// Row loads in flight per lane group in entry (a) and kernel C. Entry (b)
// keeps one: with a warp per segment of ~6 rows and tens of thousands of
// segments, its loads in flight come from the resident warps, and every
// further row held in registers costs occupancy (measured on an H100: 1, 2,
// 3, 4, 8 rows -> 32, 34, 38, 40, 45 us at the training batch).
constexpr int kRows = 4;

__device__ __forceinline__ void clear(float& a) { a = 0.0f; }
__device__ __forceinline__ void clear(float4& a) { a = make_float4(0.0f, 0.0f, 0.0f, 0.0f); }
__device__ __forceinline__ void add(float& a, float v) { a += v; }
__device__ __forceinline__ void add(float4& a, const float4& v) {
  a.x += v.x; a.y += v.y; a.z += v.z; a.w += v.w;
}
__device__ __forceinline__ void axpy(float& a, float w, float v) { a = fmaf(w, v, a); }
__device__ __forceinline__ void axpy(float4& a, float w, const float4& v) {
  a.x = fmaf(w, v.x, a.x); a.y = fmaf(w, v.y, a.y);
  a.z = fmaf(w, v.z, a.z); a.w = fmaf(w, v.w, a.w);
}
__device__ __forceinline__ void divide(float& a, float d) { a /= d; }
__device__ __forceinline__ void divide(float4& a, float d) {
  a.x /= d; a.y /= d; a.z /= d; a.w /= d;
}

// One thread per row boundary r in [0, E]: it writes the pointer of every id
// s in [0, num_segments] with seg[r-1] < s <= seg[r] (seg[-1] = -1,
// seg[E] = num_segments), so each of the num_segments + 1 pointers is written
// exactly once; rows of a negative id lie before rowptr[0].
__global__ void segment_rowptr_kernel(const int32_t* __restrict__ seg,
                                      int32_t* __restrict__ rowptr, int E,
                                      int num_segments) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r > E) return;
  const int prev = r == 0 ? -1 : max(seg[r - 1], -1);
  const int cur = r == E ? num_segments : min(seg[r], num_segments);
  for (int s = prev + 1; s <= cur; ++s) rowptr[s] = r;
}

// Kernel A. V is float4 (CV = C/4) or float (CV = C); G = 1 << log2g lanes
// serve one segment, lane l the elements l, l+G, ... < CV of its rows.
// GATHER false is entry (a): row r is x[r, :]. GATHER true is entry (b): row
// r is x[idx[r], :] * w[r] (w null: 1), its weight divided by
// max(rowdiv[idx[r]], 1) when rowdiv is given; deg_out (nullable) gets the
// sum of the weights and `normalize` divides the sum by max(deg, 1).
template <typename V, bool GATHER>
__global__ void __launch_bounds__(kThreads)
row_sum_kernel(const V* __restrict__ x, const int32_t* __restrict__ idx,
               const float* __restrict__ w, const float* __restrict__ rowdiv,
               const int32_t* __restrict__ rowptr, V* __restrict__ out,
               float* __restrict__ deg_out, int num_segments, int CV, int log2g,
               int normalize) {
  const int G = 1 << log2g;
  const int lane = threadIdx.x & (G - 1);
  const int s = (blockIdx.x * kThreads + threadIdx.x) >> log2g;
  if (s >= num_segments) return;  // a whole group leaves together
  const int lo = rowptr[s], hi = rowptr[s + 1];
  // the lanes of this group within its warp: the shuffles name only them,
  // since neighbouring groups walk segments of other lengths
  const unsigned group_mask =
      G == 32 ? 0xffffffffu : ((1u << G) - 1u) << ((threadIdx.x & 31) & ~(G - 1));
  float deg = 0.0f;
  for (int c0 = 0; c0 < CV; c0 += G) {  // one pass at C <= 128
    const int c = c0 + lane;
    const bool active = c < CV;
    V acc;
    clear(acc);
    deg = 0.0f;
    if (GATHER) {
      for (int base = lo; base < hi; base += G) {
        const int n = min(G, hi - base);
        int my_i = 0;
        float my_w = 0.0f;
        if (lane < n) {  // one row's index and weight per lane, once per group
          my_i = idx[base + lane];
          my_w = w != nullptr ? w[base + lane] : 1.0f;
          if (rowdiv != nullptr) my_w /= fmaxf(rowdiv[my_i], 1.0f);
        }
        for (int j = 0; j < n; ++j) {
          const int i = __shfl_sync(group_mask, my_i, j, G);
          const float wr = __shfl_sync(group_mask, my_w, j, G);
          if (active) axpy(acc, wr, __ldg(x + static_cast<uint32_t>(i) * CV + c));
          deg += wr;
        }
      }
    } else if (active) {
      for (int r = lo; r < hi; r += kRows) {
        V v[kRows];
#pragma unroll
        for (int u = 0; u < kRows; ++u) {
          if (r + u < hi) v[u] = __ldg(x + static_cast<uint32_t>(r + u) * CV + c);
        }
#pragma unroll
        for (int u = 0; u < kRows; ++u) {
          if (r + u < hi) add(acc, v[u]);
        }
      }
    }
    if (active) {
      if (normalize) divide(acc, fmaxf(deg, 1.0f));
      out[static_cast<uint32_t>(s) * CV + c] = acc;
    }
  }
  if (deg_out != nullptr && lane == 0) deg_out[s] = deg;
}

// Kernel C: the VJP of entry (a) (f32), out[e, :] = g[seg[e], :] for
// seg[e] < num_segments and 0 for dump rows; ids are clipped at 0 as the
// reference clips them. Replaces tpufem/ops/gather_scatter.py::_seg_sum_bwd
// (g_pad[clip(seg, 0, num_segments)] inside the custom_vjp). A copy, bound by
// bytes: each output row written once, each cotangent row read once per edge
// that points at it (from L2 after the first read). A group of G lanes
// copies kRows consecutive rows: the ids first (one broadcast load per
// row), then every row load, then the stores.
template <typename V>
__global__ void __launch_bounds__(kThreads)
segment_gather_kernel(const V* __restrict__ g, const int32_t* __restrict__ seg,
                      V* __restrict__ out, int E, int CV, int log2g, int num_segments) {
  const int G = 1 << log2g;
  const int lane = threadIdx.x & (G - 1);
  const int base = ((blockIdx.x * kThreads + threadIdx.x) >> log2g) * kRows;
  if (base >= E) return;
  int s[kRows];
#pragma unroll
  for (int u = 0; u < kRows; ++u) s[u] = base + u < E ? max(__ldg(seg + base + u), 0) : 0;
  for (int c = lane; c < CV; c += G) {
    V v[kRows];
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      clear(v[u]);
      if (base + u < E && s[u] < num_segments) {
        v[u] = __ldg(g + static_cast<uint32_t>(s[u]) * CV + c);
      }
    }
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      if (base + u < E) out[static_cast<uint32_t>(base + u) * CV + c] = v[u];
    }
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

// lanes per group for rows of cv elements: the power of two >= cv, at most 32
int group_log2(long long cv) {
  int l = 0;
  while (l < 5 && (1LL << l) < cv) ++l;
  return l;
}

unsigned int blocks_for(long long groups, int log2g) {
  const long long per_block = kThreads >> log2g;
  return static_cast<unsigned int>((groups + per_block - 1) / per_block);
}

constexpr long long kMaxElements = 1LL << 31;  // 32-bit index arithmetic

template <bool GATHER>
int launch_row_sum(const void* x, const void* idx, const void* w, const void* rowdiv,
                   const void* rowptr, void* out, void* deg_out, long long x_rows,
                   long long C, int num_segments, int normalize, void* stream) {
  if (C < 1 || x_rows * C >= kMaxElements ||
      static_cast<long long>(num_segments) * C >= kMaxElements) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (num_segments > 0) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (C % 4 == 0 && aligned16(x) && aligned16(out)) {
      const int CV = static_cast<int>(C / 4), lg = group_log2(CV);
      row_sum_kernel<float4, GATHER><<<blocks_for(num_segments, lg), kThreads, 0, st>>>(
          static_cast<const float4*>(x), static_cast<const int32_t*>(idx),
          static_cast<const float*>(w), static_cast<const float*>(rowdiv),
          static_cast<const int32_t*>(rowptr), static_cast<float4*>(out),
          static_cast<float*>(deg_out), num_segments, CV, lg, normalize);
    } else {
      const int CV = static_cast<int>(C), lg = group_log2(CV);
      row_sum_kernel<float, GATHER><<<blocks_for(num_segments, lg), kThreads, 0, st>>>(
          static_cast<const float*>(x), static_cast<const int32_t*>(idx),
          static_cast<const float*>(w), static_cast<const float*>(rowdiv),
          static_cast<const int32_t*>(rowptr), static_cast<float*>(out),
          static_cast<float*>(deg_out), num_segments, CV, lg, normalize);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// All pointers are contiguous device arrays; every entry launches on `stream`,
// allocates nothing and returns cudaGetLastError() (cudaErrorInvalidValue
// without a launch when a tensor is too large for 32-bit indices).

// seg (E,) int32 sorted -> rowptr (num_segments + 1,) int32.
extern "C" int tpufem_segment_rowptr_i32(const void* seg, void* rowptr, long long E,
                                         int num_segments, void* stream) {
  if (E >= kMaxElements - 1 || num_segments < 0) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned int blocks = static_cast<unsigned int>((E + 1 + kThreads - 1) / kThreads);
  segment_rowptr_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(seg), static_cast<int32_t*>(rowptr), static_cast<int>(E),
      num_segments);
  return static_cast<int>(cudaGetLastError());
}

// Entry (a): msgs (E, C) f32, rowptr (num_segments + 1,) int32 ->
// out (num_segments, C) f32.
extern "C" int tpufem_sorted_segment_sum_f32(const void* msgs, const void* rowptr, void* out,
                                             long long E, long long C, int num_segments,
                                             void* stream) {
  return launch_row_sum<false>(msgs, nullptr, nullptr, nullptr, rowptr, out, nullptr, E, C,
                               num_segments, 0, stream);
}

// Entry (b): x (x_rows, C) f32, idx (E,) int32 rows of x, w (E,) f32 or null,
// rowdiv (x_rows,) f32 or null, rowptr (num_segments + 1,) int32 ->
// out (num_segments, C) f32 and deg_out (num_segments,) f32 or null.
extern "C" int tpufem_gather_row_sum_f32(const void* x, const void* idx, const void* w,
                                         const void* rowdiv, const void* rowptr, void* out,
                                         void* deg_out, long long x_rows, long long C,
                                         int num_segments, int normalize, void* stream) {
  return launch_row_sum<true>(x, idx, w, rowdiv, rowptr, out, deg_out, x_rows, C, num_segments,
                              normalize, stream);
}

// Kernel C: g (num_segments, C) f32, seg (E,) int32 -> out (E, C) f32.
extern "C" int tpufem_segment_gather_f32(const void* g, const void* seg, void* out, long long E,
                                         long long C, int num_segments, void* stream) {
  if (C < 1 || E * C >= kMaxElements ||
      static_cast<long long>(num_segments) * C >= kMaxElements) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (E > 0) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const long long groups = (E + kRows - 1) / kRows;
    if (C % 4 == 0 && aligned16(g) && aligned16(out)) {
      const int CV = static_cast<int>(C / 4), lg = group_log2(CV);
      segment_gather_kernel<float4><<<blocks_for(groups, lg), kThreads, 0, st>>>(
          static_cast<const float4*>(g), static_cast<const int32_t*>(seg),
          static_cast<float4*>(out), static_cast<int>(E), CV, lg, num_segments);
    } else {
      const int CV = static_cast<int>(C), lg = group_log2(CV);
      segment_gather_kernel<float><<<blocks_for(groups, lg), kThreads, 0, st>>>(
          static_cast<const float*>(g), static_cast<const int32_t*>(seg),
          static_cast<float*>(out), static_cast<int>(E), CV, lg, num_segments);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
