// Kernel E: deterministic segment sum over a fixed index list in CSR form
// (f32 and f64, any number of channels C).
//
// Replaces jax.ops.segment_sum over a topology-constant index list, which
// XLA fused on the TPU: the per-node sum of element forces and of the Jacobi
// diagonal (tpufem/fem/assembly.py:77,110), the pressure loads
// (tpufem/fem/loads.py:29), the nodal stress average (tpufem/fem/vonmises.py:
// 48-55), the line-block and RBM sums (tpufem/fem/precond.py:160,213-214,241,
// 267-268) and the stencil engine's load and stress sums.
//
//   out[s, c] = sum over r in [starts[s], starts[s+1]) of vals[order[r], c]
//
// `order` is a stable argsort of the rows' segment ids and `starts` the
// row offsets of each segment in that order, both built once per topology on
// the host (tpufem_torch/ops/csr_segment_sum.py::csr_plan).
//
// What bounds it on the card: bytes. Each value row is read once and each
// output element written once; one add per value. Design: one thread per
// (segment, channel), channels fastest, so the threads of one segment read
// neighbouring values of one row. Each thread adds its rows in the fixed
// `order` sequence, starting from zero: no atomics, so two runs give the same
// bits, and the sum is taken in the order the plain version takes it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T>
__global__ void csr_segment_sum_kernel(const T* __restrict__ vals,
                                       const int32_t* __restrict__ order,
                                       const int32_t* __restrict__ starts,
                                       T* __restrict__ out, int64_t N, int64_t C) {
  const int64_t idx = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (idx >= N * C) return;
  const int64_t s = idx / C;
  const int64_t c = idx - s * C;
  const int64_t lo = starts[s];
  const int64_t hi = starts[s + 1];
  T acc = 0;
  for (int64_t r = lo; r < hi; ++r) acc += vals[static_cast<int64_t>(order[r]) * C + c];
  out[idx] = acc;
}

template <typename T>
int launch(const void* vals, const void* order, const void* starts, void* out, long long N,
           long long C, void* stream) {
  const int64_t total = static_cast<int64_t>(N) * C;
  if (total > 0) {
    const int threads = 256;
    const int64_t blocks = (total + threads - 1) / threads;
    csr_segment_sum_kernel<T><<<static_cast<unsigned int>(blocks), threads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(vals), static_cast<const int32_t*>(order),
        static_cast<const int32_t*>(starts), static_cast<T*>(out), N, C);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// vals (R, C), order (R,) int32, starts (N+1,) int32, out (N, C); all
// contiguous on the device, vals and out of one dtype. Returns
// cudaGetLastError() after the launch.
extern "C" int tpufem_csr_segment_sum_f32(const void* vals, const void* order,
                                          const void* starts, void* out, long long N,
                                          long long C, void* stream) {
  return launch<float>(vals, order, starts, out, N, C, stream);
}

extern "C" int tpufem_csr_segment_sum_f64(const void* vals, const void* order,
                                          const void* starts, void* out, long long N,
                                          long long C, void* stream) {
  return launch<double>(vals, order, starts, out, N, C, stream);
}
