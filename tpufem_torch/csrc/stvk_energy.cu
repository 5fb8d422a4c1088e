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
// ~6.0 us at 3.35 TB/s; the arithmetic, ~135 flops per tet, ~0.7 us. At the
// nonlinear CLI's 16x24x4 the bytes are 1.0 MB, 0.3 us: there the time is
// the latency of one launch, one round trip to memory and the sum.
//
// Design: a thread per (lane, cell, Kuhn tet), the cell fastest
// (stvk::TetThread), so a warp's loads of each gradient plane are coalesced
// and each thread issues all of its loads at once (4 corners of u, 12
// gradients, its volume): one round trip to memory, where a thread per cell
// waited on one per tet in turn. 9,216 threads at 16x24x4; the block is the
// largest of 256, 128 and 64 threads that still gives every SM a block
// (stvk::tet_block: 144 blocks of 64 there, 720 of 256 at DOF100K). Each
// block sums its threads in a fixed order (a shuffle tree in each warp, then
// one over the warps' sums) and stores one partial; the last block to finish
// (a ticket counter after a fence) reads the partials with its loads in
// flight together, sums them in index order the same way and writes the
// result. Which block that is varies; the order of the sum does not, so two
// calls give the same bits. Every index is 32-bit; the wrapper checks that g
// has fewer than 2^31 elements.

#include <cuda_runtime.h>

#include "stvk.cuh"

namespace {

// The sum of v over the block in a fixed order, in thread 0: a shuffle tree
// in each warp, then one over the warps' sums in warp 0. `warp_sums` holds a
// double per warp; a second call must follow a barrier after the first's
// reads, as the last block's does.
template <int kThreads>
__device__ __forceinline__ double block_sum(double v, double* warp_sums) {
  constexpr int kWarps = kThreads / 32;
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) v += __shfl_down_sync(0xffffffffu, v, s);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  v = 0.0;
  if (warp == 0) {
    v = lane < kWarps ? warp_sums[lane] : 0.0;
#pragma unroll
    for (int s = kWarps / 2; s > 0; s >>= 1) v += __shfl_down_sync(0xffffffffu, v, s);
  }
  return v;
}

template <int kThreads>
__global__ void __launch_bounds__(kThreads)
    stvk_energy_kernel(const double* __restrict__ g, const double* __restrict__ vol,
                       const double* __restrict__ u, const double* __restrict__ free,
                       double* partial, unsigned* ticket, double* out, int B, int NI, int NK,
                       int NJ, int weld_te, double lam, double mu) {
  __shared__ double warp_sums[kThreads / 32];
  __shared__ bool last;
  const int nt = NK - 1, ns = NJ - 1;
  const int ncell = (NI - 1) * nt * ns, plane = B * ncell;
  const int idx = blockIdx.x * kThreads + threadIdx.x;
  double w = 0.0;
  if (idx < 6 * plane) {
    const stvk::TetThread p = stvk::tet_thread(idx, plane, ncell, nt, ns);
    const stvk::TetNodes<double> n = stvk::tet_nodes(p, free, NI, NK, NJ, weld_te);
    double U[4][3], G[4][3], H[3][3], E[3][3];
    stvk::load_tet_field(u, n, B * NI * NK * NJ, U);
    stvk::load_tet_grads(g + p.t * 12 * plane + p.bc, plane, G);
    const double v = __ldg(vol + idx);
    stvk::tet_grad(G, U, H);
    stvk::green(H, E);
    const double tr = E[0][0] + E[1][1] + E[2][2];
    double ee = 0.0;
#pragma unroll
    for (int m = 0; m < 3; ++m)
#pragma unroll
      for (int k = 0; k < 3; ++k) ee += E[m][k] * E[m][k];
    w = v * (0.5 * lam * tr * tr + mu * ee);
  }
  const double s = block_sum<kThreads>(w, warp_sums);
  if (threadIdx.x == 0) {
    partial[blockIdx.x] = s;
    __threadfence();  // the partial is visible before the ticket is taken
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  // partials tid, tid + kThreads, ... in index order, kUnroll loads in
  // flight; .cg reads L2, where the other blocks wrote them
  constexpr int kUnroll = 4;
  const int nb = gridDim.x;
  double acc = 0.0;
  for (int i = threadIdx.x; i < nb; i += kUnroll * kThreads) {
    double v[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k)
      v[k] = i + k * kThreads < nb ? __ldcg(partial + i + k * kThreads) : 0.0;
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) acc += v[k];
  }
  const double total = block_sum<kThreads>(acc, warp_sums);
  if (threadIdx.x == 0) {
    *out = total;
    *ticket = 0u;  // ready for the next call
  }
}

long long tets(int B, int NI, int NK, int NJ) {
  return 6LL * B * (NI - 1) * (NK - 1) * (NJ - 1);
}

}  // namespace

// The number of blocks, i.e. of `partial` entries, a call at this shape needs.
extern "C" int tpufem_stvk_energy_blocks(int B, int NI, int NK, int NJ) {
  const long long n = tets(B, NI, NK, NJ);
  const int threads = stvk::tet_block(n);
  return static_cast<int>((n + threads - 1) / threads);
}

// All tensors contiguous on the device, f64; partial holds
// tpufem_stvk_energy_blocks entries, ticket one unsigned int that is 0; out
// one f64. Returns cudaGetLastError() after the launch.
extern "C" int tpufem_stvk_energy_f64(const void* g, const void* vol, const void* u,
                                      const void* free, void* partial, void* ticket, void* out,
                                      int B, int NI, int NK, int NJ, int weld_te, double lam,
                                      double mu, void* stream) {
  if (B <= 0 || NI < 2 || NK < 2 || NJ < 2) return 0;
  const long long n = tets(B, NI, NK, NJ);
  const int threads = stvk::tet_block(n);
  const int blocks = static_cast<int>((n + threads - 1) / threads);
  auto* kernel = threads == 256   ? stvk_energy_kernel<256>
                 : threads == 128 ? stvk_energy_kernel<128>
                                  : stvk_energy_kernel<64>;
  kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(g), static_cast<const double*>(vol),
      static_cast<const double*>(u), static_cast<const double*>(free),
      static_cast<double*>(partial), static_cast<unsigned*>(ticket), static_cast<double*>(out), B,
      NI, NK, NJ, weld_te, lam, mu);
  return static_cast<int>(cudaGetLastError());
}
