// Kernel J: the stored St. Venant-Kirchhoff energy of a grid displacement,
// summed in a fixed order, one launch per call.
//
// Replaces tpufem/fem/nonlinear.py:130 stvk_energy (jnp code that XLA fused on
// the TPU; the merit of WingNonlinear's Armijo line search, evaluated once
// per Newton step and once per backtrack):
//
//   W(u) = sum over lanes, cells and Kuhn tets of V (lam/2 tr(E)^2 + mu E:E),
//
// E the Green-Lagrange strain of S(u * free) (stvk.cuh), a 0-d result. The
// line search compares two such sums, so the sum must not depend on the
// schedule: an atomic sum could flip a backtrack, and with it the Newton and
// CG counts, from run to run.
//
// Operands in tpufem's layouts, all contiguous, f64: g (6,4,3,B,nc,nt,ns),
// vol (6,B,nc,nt,ns), u (3,B,NI,NK,NJ), free the NJ root mask; `partial`
// holds one f64 per block and `ticket` one counter, which is 0 before the
// launch and which the launch leaves at 0.
//
// The bound is bytes: g, vol and u read once, at DOF100K B = 1 20.1 MB,
// ~6.0 us at 3.35 TB/s; the arithmetic, ~130 flops per tet, ~0.7 us.
//
// Design: a thread per (lane, cell), cells contiguous along span so a warp's
// loads of each gradient plane are coalesced; the thread loads its cell's 8
// corners once and sums its 6 tets in order. Each block sums its threads by a
// fixed tree and stores one partial; the last block to finish (a ticket
// counter after a fence) sums the partials in index order, by a fixed tree,
// and writes the result. Which block that is varies; the order of the sum
// does not, so two calls give the same bits. Every index is 32-bit; the
// wrapper checks that g has fewer than 2^31 elements.

#include <cuda_runtime.h>

#include "stvk.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__device__ __forceinline__ T block_sum(T v, T* red) {
  const int tid = threadIdx.x;
  red[tid] = v;
  __syncthreads();
#pragma unroll
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (tid < s) red[tid] += red[tid + s];
    __syncthreads();
  }
  return red[0];
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    stvk_energy_kernel(const T* __restrict__ g, const T* __restrict__ vol,
                       const T* __restrict__ u, const T* __restrict__ free, T* partial,
                       unsigned* ticket, T* out, int B, int NI, int NK, int NJ, int weld_te, T lam,
                       T mu) {
  __shared__ T red[kThreads];
  __shared__ bool last;
  const int nc = NI - 1, nt = NK - 1, ns = NJ - 1;
  const int ncell = nc * nt * ns;
  const int idx = blockIdx.x * kThreads + threadIdx.x;
  T w = T(0);
  if (idx < B * ncell) {
    const int b = idx / ncell, c = idx - b * ncell;
    const int cj = c % ns, ck = (c / ns) % nt, ci = c / (ns * nt);
    T U[8][3];
    stvk::load_corners(u, free, b, ci, ck, cj, B, NI, NK, NJ, weld_te, U);
    const int plane = B * ncell;
#pragma unroll
    for (int t = 0; t < 6; ++t) {
      T H[3][3], E[3][3];
      stvk::grad(t, g + (t * 12 * B + b) * ncell + c, plane, U, H);
      stvk::green(H, E);
      const T tr = E[0][0] + E[1][1] + E[2][2];
      T ee = T(0);
#pragma unroll
      for (int m = 0; m < 3; ++m)
#pragma unroll
        for (int n = 0; n < 3; ++n) ee += E[m][n] * E[m][n];
      w += __ldg(vol + (t * B + b) * ncell + c) * (T(0.5) * lam * tr * tr + mu * ee);
    }
  }
  const T s = block_sum(w, red);
  if (threadIdx.x == 0) {
    partial[blockIdx.x] = s;
    __threadfence();  // the partial is visible before the ticket is taken
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  T acc = T(0);
  for (int i = threadIdx.x; i < gridDim.x; i += kThreads)
    acc += static_cast<volatile T*>(partial)[i];
  const T total = block_sum(acc, red);
  if (threadIdx.x == 0) {
    *out = total;
    *ticket = 0u;  // ready for the next call
  }
}

}  // namespace

// The number of blocks, i.e. of `partial` entries, a call at this shape needs.
extern "C" int tpufem_stvk_energy_blocks(int B, int NI, int NK, int NJ) {
  const long long n = static_cast<long long>(B) * (NI - 1) * (NK - 1) * (NJ - 1);
  return static_cast<int>((n + kThreads - 1) / kThreads);
}

// All tensors contiguous on the device, f64; partial holds
// tpufem_stvk_energy_blocks entries, ticket one unsigned int that is 0; out
// one f64. Returns cudaGetLastError() after the launch.
extern "C" int tpufem_stvk_energy_f64(const void* g, const void* vol, const void* u,
                                      const void* free, void* partial, void* ticket, void* out,
                                      int B, int NI, int NK, int NJ, int weld_te, double lam,
                                      double mu, void* stream) {
  if (B <= 0 || NI < 2 || NK < 2 || NJ < 2) return 0;
  const int blocks = tpufem_stvk_energy_blocks(B, NI, NK, NJ);
  stvk_energy_kernel<double><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(g), static_cast<const double*>(vol),
      static_cast<const double*>(u), static_cast<const double*>(free),
      static_cast<double*>(partial), static_cast<unsigned*>(ticket), static_cast<double*>(out), B,
      NI, NK, NJ, weld_te, lam, mu);
  return static_cast<int>(cudaGetLastError());
}
