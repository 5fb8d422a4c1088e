// Kernel K: the VJP of kernel B's operator with respect to the cell
// geometry, at a fixed displacement. The backward of fem.stencil's
// StrainApplyGeo, which the adjoint of DifferentiableWingFEM crosses once per
// gradient.
//
// Replaces the geometry half of tpufem's jax.vjp(F, p4) at
// tpufem/fem/adjoint.py:156 (F(p) = strain_apply(geo(p), u) - b(p); XLA's
// transpose of the fused strain_apply on the TPU). For a cotangent w of y =
// strain_apply(geo, u), with us = S(u * free) and ws = S(w * free) (S the weld
// spread), per lane, cell and Kuhn tet t:
//
//   eps_u = sym(sum_a g_a (x) us_a),  eps_w = sym(sum_a g_a (x) ws_a),
//   sigma(eps) = 2 mu eps + lam tr(eps) I,
//   gbar[t, a] = V (sigma(eps_w) us_a + sigma(eps_u) ws_a),
//   volbar[t]  = sigma(eps_u) : eps_w,
//
// the derivative of w . y = sum_t V sigma(eps_u) : eps_w. The Dirichlet
// identity term has no geometry in it. The chain from (gbar, volbar) back
// through cell_geometry and nodes_grid to the design parameters runs once per
// backward in torch autograd.
//
// Operands in tpufem's layouts, all contiguous, f64: g (6,4,3,B,nc,nt,ns),
// vol (6,B,nc,nt,ns), u and w (3,B,NI,NK,NJ), free the NJ root mask; it
// writes gbar (6,4,3,B,nc,nt,ns) and volbar (6,B,nc,nt,ns), each entry once:
// no scatter, no atomics, the same bits every call.
//
// The bound is bytes: g and vol read, gbar and volbar written, u and w read;
// at 32x40x4 B = 4 (the optimizer's grid) 26.9 MB, ~8.0 us at 3.35 TB/s; at
// the optimizer record's 24x32x2 B = 4 8.1 MB, ~2.4 us. The arithmetic,
// ~250 flops per tet, is ~0.6 us at 32x40x4 at the FP64 rate.
//
// Design: a thread per (lane, cell, Kuhn tet), the cell fastest
// (stvk::TetThread), so a warp's loads of each g plane and stores of each
// gbar plane are coalesced, and each thread issues all of its loads at once
// (4 corners of u and of w, 12 gradients, its volume) and stores its 12 gbar
// values and its volbar once: one round trip to memory, where a thread per
// cell waited on one per tet in turn. u and w, small beside g and gbar, are
// read once per tet, 6 times per cell, from the cache. The block is the
// largest of 256, 128 and 64 threads that still gives every SM a block
// (stvk::tet_block: 144 blocks of 256 at 24x32x2 B = 4). Every index is
// 32-bit; the wrapper checks that every operand has fewer than 2^31 elements.

#include <cuda_runtime.h>

#include "stvk.cuh"

namespace {

// sigma(sym(H)) = mu (H + H^T) + lam tr(H) I, in place of H
template <typename T>
__device__ __forceinline__ void linear_stress(T (&H)[3][3], T lam, T mu) {
  const T ltr = lam * (H[0][0] + H[1][1] + H[2][2]);
#pragma unroll
  for (int m = 0; m < 3; ++m)
#pragma unroll
    for (int n = m; n < 3; ++n) {
      const T s = mu * (H[m][n] + H[n][m]) + (m == n ? ltr : T(0));
      H[m][n] = s;
      H[n][m] = s;
    }
}

template <int kThreads>
__global__ void __launch_bounds__(kThreads)
    strain_geo_vjp_kernel(const double* __restrict__ g, const double* __restrict__ vol,
                          const double* __restrict__ u, const double* __restrict__ w,
                          const double* __restrict__ free, double* __restrict__ gbar,
                          double* __restrict__ volbar, int B, int NI, int NK, int NJ, int weld_te,
                          double lam, double mu) {
  const int nt = NK - 1, ns = NJ - 1;
  const int ncell = (NI - 1) * nt * ns, plane = B * ncell;
  const int idx = blockIdx.x * kThreads + threadIdx.x;
  if (idx >= 6 * plane) return;
  const stvk::TetThread p = stvk::tet_thread(idx, plane, ncell, nt, ns);
  const stvk::TetNodes<double> n = stvk::tet_nodes(p, free, NI, NK, NJ, weld_te);
  const int stride = B * NI * NK * NJ, base = p.t * 12 * plane + p.bc;
  double U[4][3], W[4][3], G[4][3];
  stvk::load_tet_field(u, n, stride, U);
  stvk::load_tet_field(w, n, stride, W);
  stvk::load_tet_grads(g + base, plane, G);
  const double v = __ldg(vol + idx);
  double Su[3][3], Sw[3][3];
  stvk::tet_grad(G, U, Su);
  stvk::tet_grad(G, W, Sw);
  // volbar = sigma(eps_u) : eps_w = mu (Hu + Hu^T) : sym(Hw) + lam tr(Hu) tr(Hw)
  double vb = lam * (Su[0][0] + Su[1][1] + Su[2][2]) * (Sw[0][0] + Sw[1][1] + Sw[2][2]);
#pragma unroll
  for (int m = 0; m < 3; ++m)
#pragma unroll
    for (int k = 0; k < 3; ++k)
      vb += mu * (Su[m][k] + Su[k][m]) * 0.5 * (Sw[m][k] + Sw[k][m]);
  volbar[idx] = vb;
  linear_stress(Su, lam, mu);
  linear_stress(Sw, lam, mu);
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      double s = 0.0;
#pragma unroll
      for (int e = 0; e < 3; ++e) s += Sw[d][e] * U[a][e] + Su[d][e] * W[a][e];
      gbar[base + (a * 3 + d) * plane] = v * s;
    }
}

}  // namespace

// All tensors contiguous on the device, f64. Returns cudaGetLastError()
// after the launch.
extern "C" int tpufem_strain_geo_vjp_f64(const void* g, const void* vol, const void* u,
                                         const void* w, const void* free, void* gbar,
                                         void* volbar, int B, int NI, int NK, int NJ, int weld_te,
                                         double lam, double mu, void* stream) {
  if (B <= 0 || NI < 2 || NK < 2 || NJ < 2) return 0;
  const long long n = 6LL * B * (NI - 1) * (NK - 1) * (NJ - 1);
  const int threads = stvk::tet_block(n);
  auto* kernel = threads == 256   ? strain_geo_vjp_kernel<256>
                 : threads == 128 ? strain_geo_vjp_kernel<128>
                                  : strain_geo_vjp_kernel<64>;
  kernel<<<static_cast<int>((n + threads - 1) / threads), threads, 0,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(g), static_cast<const double*>(vol),
      static_cast<const double*>(u), static_cast<const double*>(w),
      static_cast<const double*>(free), static_cast<double*>(gbar),
      static_cast<double*>(volbar), B, NI, NK, NJ, weld_te, lam, mu);
  return static_cast<int>(cudaGetLastError());
}
