// Kernel M: the p-multigrid transfers between the tet4 grid and the doubled
// tet10 grid, one launch each way.
//
// Replaces tpufem/fem/tet10_stencil.py:301 prolong_p and :316 restrict_p (jnp
// code that XLA fused on the TPU; ~20 PyTorch launches each in the plain
// version), applied once each per tet10 V-cycle.
//
// prolong_p: x4 (3,B,NI,NK,NJ), the tet4 grid in active form, to the doubled
// grid y (3,B,NI2,NK2,NJ2): the P1 embedding into P2. A thread per doubled
// position reads the tet4 weld spread S (weld rows i = 0 and, with weld_te,
// i = NI - 1 read layer k = 0); an all-even position (2I, 2K, 2J) copies node
// (I, K, J), any other parity pattern o is the midpoint of the lattice edge
// (I, I + o) and takes 0.5 * (x(I) + x(I + o)). The result is multiplied by
// the duplicate mask dup2 (1,1,NI2,NK2,NJ2) and the root mask free2 (NJ2).
//
// restrict_p: its exact transpose, written as a gather. A thread per tet4
// node (I, K, J) adds to its own position's value half of each incident edge
// midpoint: for each of the 7 positive lattice offsets o in the order of
// tpufem_torch/fem/tet10_stencil.py::_POS_OFFSETS, the midpoint 2I + o (node I
// the edge's low end) and then 2I - o (its high end), each where it lies on
// the grid. Then the tet4 weld reduce R (the node at k = 0 of a weld row takes
// its column's sum in k order, the others zero) and the root mask free4 (NJ).
// No atomics: two calls give the same bits.
//
// Bytes bind both: at the flagship (96 x 128 x 8 cells, B = 1) each reads and
// writes ~11.5 MB in f64, a ~3.4 us bound, so a launch is close to its
// launch latency. Every index is 32-bit; the wrappers check that every
// operand has fewer than 2^31 elements.

#include <cuda_runtime.h>

#include "grid_tet.cuh"

namespace {

constexpr int kThreads = 256;

// the 7 positive lattice offsets (di, dj, dk), in _POS_OFFSETS' order
__device__ __forceinline__ int off_di(int o) { return o >= 3; }
__device__ __forceinline__ int off_dj(int o) { constexpr int v[7] = {0, 1, 1, 0, 0, 1, 1}; return v[o]; }
__device__ __forceinline__ int off_dk(int o) { constexpr int v[7] = {1, 0, 1, 0, 1, 0, 1}; return v[o]; }

template <typename T>
__global__ void __launch_bounds__(kThreads)
    prolong_p_kernel(const T* __restrict__ x4, const T* __restrict__ dup2,
                     const T* __restrict__ free2, T* __restrict__ y, int B, int NI, int NK, int NJ,
                     int weld_te) {
  const int NI2 = 2 * NI - 1, NK2 = 2 * NK - 1, NJ2 = 2 * NJ - 1;
  const int plane2 = NI2 * NK2 * NJ2, plane4 = NI * NK * NJ;
  const int n = blockIdx.x * kThreads + threadIdx.x;
  if (n >= B * plane2) return;
  const int j2 = n % NJ2, r = n / NJ2;
  const int k2 = r % NK2, rk = r / NK2;
  const int i2 = rk % NI2, b = rk / NI2;
  const int I = i2 >> 1, K = k2 >> 1, J = j2 >> 1;
  const int oi = i2 & 1, ok = k2 & 1, oj = j2 & 1;
  const int pos = (i2 * NK2 + k2) * NJ2 + j2;
  const T m = __ldg(dup2 + pos) * __ldg(free2 + j2);
  const int na = b * plane4 + (I * NK + grid_tet::weld_k(I, K, NI, weld_te)) * NJ + J;
  const int nb = b * plane4 +
                 ((I + oi) * NK + grid_tet::weld_k(I + oi, K + ok, NI, weld_te)) * NJ + J + oj;
  const bool corner = (oi | ok | oj) == 0;
#pragma unroll
  for (int e = 0; e < 3; ++e) {
    const T* xe = x4 + e * B * plane4;
    const T a = __ldg(xe + na);
    const T v = corner ? a : T(0.5) * (a + __ldg(xe + nb));
    y[e * B * plane2 + b * plane2 + pos] = v * m;
  }
}

// sum_{o} the tet4 node (I, K, J)'s share of the doubled field r2 (see above)
template <typename T>
__device__ __forceinline__ T restrict_node(const T* r2, int NI, int NK, int NJ, int I, int K,
                                           int J) {
  const int NK2 = 2 * NK - 1, NJ2 = 2 * NJ - 1;
  T v = __ldg(r2 + ((2 * I) * NK2 + 2 * K) * NJ2 + 2 * J);
#pragma unroll
  for (int o = 0; o < 7; ++o) {
    const int di = off_di(o), dj = off_dj(o), dk = off_dk(o);
    if (I + di < NI && K + dk < NK && J + dj < NJ)
      v += T(0.5) * __ldg(r2 + ((2 * I + di) * NK2 + 2 * K + dk) * NJ2 + 2 * J + dj);
    if (I - di >= 0 && K - dk >= 0 && J - dj >= 0)
      v += T(0.5) * __ldg(r2 + ((2 * I - di) * NK2 + 2 * K - dk) * NJ2 + 2 * J - dj);
  }
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    restrict_p_kernel(const T* __restrict__ r2, const T* __restrict__ free4, T* __restrict__ y4,
                      int B, int NI, int NK, int NJ, int weld_te) {
  const int NI2 = 2 * NI - 1, NK2 = 2 * NK - 1, NJ2 = 2 * NJ - 1;
  const int plane2 = NI2 * NK2 * NJ2, plane4 = NI * NK * NJ;
  const int n = blockIdx.x * kThreads + threadIdx.x;
  if (n >= B * plane4) return;
  const int J = n % NJ, r = n / NJ;
  const int K = r % NK, rk = r / NK;
  const int I = rk % NI, b = rk / NI;
  const bool weld = grid_tet::weld_row(I, NI, weld_te);
  const T fr = __ldg(free4 + J);
#pragma unroll
  for (int e = 0; e < 3; ++e) {
    const T* re = r2 + (e * B + b) * plane2;
    T v = T(0);
    if (!weld) {
      v = restrict_node(re, NI, NK, NJ, I, K, J);
    } else if (K == 0) {
      for (int kk = 0; kk < NK; ++kk) v += restrict_node(re, NI, NK, NJ, I, kk, J);
    }
    y4[(e * B + b) * plane4 + (I * NK + K) * NJ + J] = v * fr;
  }
}

bool grid_ok(int B, int NI, int NK, int NJ) { return B > 0 && NI >= 2 && NK >= 2 && NJ >= 2; }

template <typename T>
int prolong(const void* x4, const void* dup2, const void* free2, void* y, int B, int NI, int NK,
            int NJ, int weld_te, void* stream) {
  if (!grid_ok(B, NI, NK, NJ)) return static_cast<int>(cudaErrorInvalidValue);
  const int n = B * (2 * NI - 1) * (2 * NK - 1) * (2 * NJ - 1);
  prolong_p_kernel<T><<<(n + kThreads - 1) / kThreads, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x4), static_cast<const T*>(dup2), static_cast<const T*>(free2),
      static_cast<T*>(y), B, NI, NK, NJ, weld_te);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int restrict_(const void* r2, const void* free4, void* y4, int B, int NI, int NK, int NJ,
              int weld_te, void* stream) {
  if (!grid_ok(B, NI, NK, NJ)) return static_cast<int>(cudaErrorInvalidValue);
  const int n = B * NI * NK * NJ;
  restrict_p_kernel<T><<<(n + kThreads - 1) / kThreads, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(r2), static_cast<const T*>(free4), static_cast<T*>(y4), B, NI, NK, NJ,
      weld_te);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// All tensors contiguous on the device, of one dtype; (NI, NK, NJ) is the
// tet4 grid. Returns cudaGetLastError() after the launch.
extern "C" int tpufem_prolong_p_f32(const void* x4, const void* dup2, const void* free2, void* y,
                                    int B, int NI, int NK, int NJ, int weld_te, void* stream) {
  return prolong<float>(x4, dup2, free2, y, B, NI, NK, NJ, weld_te, stream);
}

extern "C" int tpufem_prolong_p_f64(const void* x4, const void* dup2, const void* free2, void* y,
                                    int B, int NI, int NK, int NJ, int weld_te, void* stream) {
  return prolong<double>(x4, dup2, free2, y, B, NI, NK, NJ, weld_te, stream);
}

extern "C" int tpufem_restrict_p_f32(const void* r2, const void* free4, void* y4, int B, int NI,
                                     int NK, int NJ, int weld_te, void* stream) {
  return restrict_<float>(r2, free4, y4, B, NI, NK, NJ, weld_te, stream);
}

extern "C" int tpufem_restrict_p_f64(const void* r2, const void* free4, void* y4, int B, int NI,
                                     int NK, int NJ, int weld_te, void* stream) {
  return restrict_<double>(r2, free4, y4, B, NI, NK, NJ, weld_te, stream);
}
