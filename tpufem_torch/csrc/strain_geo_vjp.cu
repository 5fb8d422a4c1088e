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
// at 32x40x4 B = 4 (the optimizer's grid) 31.5 MB, ~9.4 us at 3.35 TB/s. The
// arithmetic, ~250 flops per tet, is ~0.6 us at the FP64 rate.
//
// Design: kernel F's: a thread per (lane, cell), cells contiguous along span,
// so a warp's loads of each g plane and stores of each gbar plane are
// coalesced; the thread loads its cell's 8 corners of u and of w once and
// walks the 6 tets. Every index is 32-bit; the wrapper checks that every
// operand has fewer than 2^31 elements.

#include <cuda_runtime.h>

#include "stvk.cuh"

namespace {

constexpr int kThreads = 256;

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
    strain_geo_vjp_kernel(const T* __restrict__ g, const T* __restrict__ vol,
                          const T* __restrict__ u, const T* __restrict__ w,
                          const T* __restrict__ free, T* __restrict__ gbar,
                          T* __restrict__ volbar, int B, int NI, int NK, int NJ, int weld_te,
                          T lam, T mu) {
  const int nc = NI - 1, nt = NK - 1, ns = NJ - 1;
  const int ncell = nc * nt * ns;
  const int idx = blockIdx.x * kThreads + threadIdx.x;
  if (idx >= B * ncell) return;
  const int b = idx / ncell, c = idx - b * ncell;
  const int cj = c % ns, ck = (c / ns) % nt, ci = c / (ns * nt);
  T U[8][3], W[8][3];
  stvk::load_corners(u, free, b, ci, ck, cj, B, NI, NK, NJ, weld_te, U);
  stvk::load_corners(w, free, b, ci, ck, cj, B, NI, NK, NJ, weld_te, W);
  const int plane = B * ncell;
#pragma unroll
  for (int t = 0; t < 6; ++t) {
    const int base = (t * 12 * B + b) * ncell + c;
    T Su[3][3], Sw[3][3];
    stvk::grad(t, g + base, plane, U, Su);
    stvk::grad(t, g + base, plane, W, Sw);
    // volbar = sigma(eps_u) : eps_w = mu (Hu + Hu^T) : sym(Hw) + lam tr(Hu) tr(Hw)
    T vb = lam * (Su[0][0] + Su[1][1] + Su[2][2]) * (Sw[0][0] + Sw[1][1] + Sw[2][2]);
#pragma unroll
    for (int m = 0; m < 3; ++m)
#pragma unroll
      for (int n = 0; n < 3; ++n)
        vb += mu * (Su[m][n] + Su[n][m]) * T(0.5) * (Sw[m][n] + Sw[n][m]);
    volbar[(t * B + b) * ncell + c] = vb;
    linear_stress(Su, lam, mu);
    linear_stress(Sw, lam, mu);
    const T v = __ldg(vol + (t * B + b) * ncell + c);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int q = grid_tet::kuhn(t, a);
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        T s = T(0);
#pragma unroll
        for (int e = 0; e < 3; ++e) s += Sw[d][e] * U[q][e] + Su[d][e] * W[q][e];
        gbar[base + (a * 3 + d) * plane] = v * s;
      }
    }
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
  const int n = B * (NI - 1) * (NK - 1) * (NJ - 1);
  strain_geo_vjp_kernel<double><<<(n + kThreads - 1) / kThreads, kThreads, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(g), static_cast<const double*>(vol),
      static_cast<const double*>(u), static_cast<const double*>(w),
      static_cast<const double*>(free), static_cast<double*>(gbar),
      static_cast<double*>(volbar), B, NI, NK, NJ, weld_te, lam, mu);
  return static_cast<int>(cudaGetLastError());
}
