// Kernel A: segment sum over SORTED int32 segment ids (forward, f32), and
// kernel C, its backward (below).
//
// Replaces the Pallas TPU kernel tpufem/ops/gather_scatter.py::_seg_sum_kernel
// (reached through sorted_segment_sum_pallas), which GraphSAGE's mean
// aggregation uses: out[s, :] = sum of msgs[r, :] over rows r with seg[r] == s,
// for s < num_segments. Rows whose id is num_segments (padding) belong to no
// output row and are dropped.
//
// What bounds it on the card: bytes. Each message row is read once (E*C*4 B,
// ~36 MB for a DOF100K surface graph at C=128) and each output row written
// once; there is almost no arithmetic.
//
// Design: the TPU kernel compressed each 256-edge tile's runs with one-hot and
// triangular MXU matmuls and walked the slots in SMEM, because its whole output
// had to stay resident in VMEM across a sequential grid (hence its
// MAX_SEGMENTS cap and the XLA fallback above it). On the GPU the ids are
// sorted, so each output element finds its own row range [lo, hi) by binary
// search and sums those rows in order: one thread per (segment, channel),
// channels fastest, so a warp reads 32 neighbouring floats of one row
// (coalesced). No atomics, so two runs give the same bits, and no cap on the
// number of segments.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ int64_t lower_bound(const int32_t* __restrict__ seg,
                                               int64_t n, int32_t v) {
  int64_t lo = 0, hi = n;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (seg[mid] < v) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__global__ void sorted_segment_sum_kernel(const float* __restrict__ msgs,
                                          const int32_t* __restrict__ seg,
                                          float* __restrict__ out, int64_t E,
                                          int64_t C, int32_t num_segments) {
  const int64_t idx = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (idx >= static_cast<int64_t>(num_segments) * C) return;
  const int32_t s = static_cast<int32_t>(idx / C);
  const int64_t c = idx - static_cast<int64_t>(s) * C;
  const int64_t lo = lower_bound(seg, E, s);
  const int64_t hi = lower_bound(seg, E, s + 1);
  float acc = 0.0f;
  for (int64_t r = lo; r < hi; ++r) acc += msgs[r * C + c];
  out[idx] = acc;
}

// Kernel C: the segment sum's backward (f32), out[e, :] = g[seg[e], :] for
// seg[e] < num_segments and 0 for dump rows (seg[e] == num_segments).
//
// Replaces the VJP of the Pallas kernel, tpufem/ops/gather_scatter.py::
// _seg_sum_bwd (g_pad[clip(seg, 0, num_segments)] inside the custom_vjp).
// Bound by bytes like kernel A: each output row is written once and each
// cotangent row read once per edge that points at it (from L2 after the
// first read: rows of one segment are adjacent because seg is sorted).
// One thread per (edge, channel), channels fastest, so a warp reads 32
// neighbouring floats of one row of g and writes 32 neighbouring floats of
// one row of out. A copy: deterministic, no atomics.
__global__ void segment_gather_kernel(const float* __restrict__ g,
                                      const int32_t* __restrict__ seg,
                                      float* __restrict__ out, int64_t E,
                                      int64_t C, int32_t num_segments) {
  const int64_t idx = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (idx >= E * C) return;
  const int64_t e = idx / C;
  const int64_t c = idx - e * C;
  const int32_t s = max(seg[e], 0);  // the reference clips ids to [0, num_segments]
  out[idx] = s < num_segments ? g[static_cast<int64_t>(s) * C + c] : 0.0f;
}

}  // namespace

// msgs (E, C) f32 and seg (E,) int32 sorted, both contiguous on the device;
// out (num_segments, C) f32. Returns cudaGetLastError() after the launch.
extern "C" int tpufem_sorted_segment_sum_f32(const void* msgs, const void* seg,
                                             void* out, long long E, long long C,
                                             int num_segments, void* stream) {
  const int64_t total = static_cast<int64_t>(num_segments) * C;
  if (total > 0) {
    const int threads = 256;
    const int64_t blocks = (total + threads - 1) / threads;
    sorted_segment_sum_kernel<<<static_cast<unsigned int>(blocks), threads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(msgs), static_cast<const int32_t*>(seg),
        static_cast<float*>(out), E, C, num_segments);
  }
  return static_cast<int>(cudaGetLastError());
}

// g (num_segments, C) f32 and seg (E,) int32, both contiguous on the device;
// out (E, C) f32. Returns cudaGetLastError() after the launch.
extern "C" int tpufem_segment_gather_f32(const void* g, const void* seg, void* out,
                                         long long E, long long C, int num_segments,
                                         void* stream) {
  const int64_t total = static_cast<int64_t>(E) * C;
  if (total > 0) {
    const int threads = 256;
    const int64_t blocks = (total + threads - 1) / threads;
    segment_gather_kernel<<<static_cast<unsigned int>(blocks), threads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(g), static_cast<const int32_t*>(seg),
        static_cast<float*>(out), E, C, num_segments);
  }
  return static_cast<int>(cudaGetLastError());
}
