// Kernel F: per-Kuhn-tet Cauchy stress of a grid displacement, the buckling
// pre-stress.
//
// Replaces tpufem/fem/buckling.py:71 element_stress (jnp code that XLA fused
// on the TPU; run once per buckling pre-stress). For every case b, cell
// (ci, ck, cj) and Kuhn tet t of the structured grid:
//
//   H[d][e] = sum_a g[t,a,d] * u_a[e],  eps = sym(H),
//   sig[t,d,e] = 2 mu eps[d][e] + lam tr(eps) delta_de,
//
// u_a the displacement at corner a of the tet, weld-spread on load (on weld
// rows, i = 0 and, when weld_te, i = NI - 1, every thickness node takes the
// k = 0 value) and not masked. Layouts are tpufem's, all contiguous:
// g (6,4,3,B,nc,nt,ns), u (3,B,NI,NK,NJ), sig (6,3,3,B,nc,nt,ns), the whole
// symmetric tensor stored.
//
// The bound is bytes: at DOF100K (64x80x6 cells), B = 16, f64, it reads g
// (283 MB) and u (4 MB) and writes sig (212 MB), ~152 us at 3.35 TB/s; the
// arithmetic, ~100 flops per tet, is ~9 us at the FP64 rate.
//
// Design: one thread per (case, cell), cells contiguous along span, so a
// warp's loads and stores of every g and sig plane are coalesced; the thread
// loads its cell's 8 corner displacements once and walks the 6 tets. There is
// no reduction, so the result does not depend on the schedule. Every index is
// 32-bit; the wrapper checks that g, u and sig have fewer than 2^31 elements.

#include <cuda_runtime.h>

#include "grid_tet.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    element_stress_kernel(const T* __restrict__ g, const T* __restrict__ u, T* __restrict__ sig,
                          int B, int NI, int NK, int NJ, int weld_te, T lam, T mu) {
  const int nc = NI - 1, nt = NK - 1, ns = NJ - 1;
  const int ncell = nc * nt * ns;
  const int idx = blockIdx.x * kThreads + threadIdx.x;
  if (idx >= B * ncell) return;
  const int b = idx / ncell, c = idx - b * ncell;
  const int cj = c % ns, ck = (c / ns) % nt, ci = c / (ns * nt);
  const int uplane = NI * NK * NJ, ustride = B * uplane;

  T U[8][3];  // the cell's corner displacements, weld-spread
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const int i = ci + grid_tet::corner_di(q);
    const int j = cj + grid_tet::corner_dj(q);
    const int k = grid_tet::weld_row(i, NI, weld_te) ? 0 : ck + grid_tet::corner_dk(q);
    const int node = b * uplane + (i * NK + k) * NJ + j;
#pragma unroll
    for (int e = 0; e < 3; ++e) U[q][e] = __ldg(u + e * ustride + node);
  }

  const T two_mu = T(2) * mu;
#pragma unroll
  for (int t = 0; t < 6; ++t) {
    T H[3][3] = {};
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int q = grid_tet::kuhn(t, a);
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        const T gd = __ldg(g + (((t * 4 + a) * 3 + d) * B + b) * ncell + c);
#pragma unroll
        for (int e = 0; e < 3; ++e) H[d][e] += gd * U[q][e];
      }
    }
    T eps[3][3];
#pragma unroll
    for (int d = 0; d < 3; ++d)
#pragma unroll
      for (int e = 0; e < 3; ++e) eps[d][e] = T(0.5) * (H[d][e] + H[e][d]);
    const T ltr = lam * (eps[0][0] + eps[1][1] + eps[2][2]);
#pragma unroll
    for (int d = 0; d < 3; ++d)
#pragma unroll
      for (int e = 0; e < 3; ++e) {
        const T s = two_mu * eps[d][e];
        sig[(((t * 3 + d) * 3 + e) * B + b) * ncell + c] = d == e ? s + ltr : s;
      }
  }
}

template <typename T>
int launch(const void* g, const void* u, void* sig, int B, int NI, int NK, int NJ, int weld_te,
           double lam, double mu, void* stream) {
  if (B <= 0 || NI < 2 || NK < 2 || NJ < 2) return 0;
  const int n = B * (NI - 1) * (NK - 1) * (NJ - 1);
  element_stress_kernel<T><<<(n + kThreads - 1) / kThreads, kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(g), static_cast<const T*>(u), static_cast<T*>(sig), B, NI, NK, NJ,
      weld_te, static_cast<T>(lam), static_cast<T>(mu));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// All tensors contiguous on the device, of one dtype. Returns
// cudaGetLastError() after the launch.
extern "C" int tpufem_element_stress_f32(const void* g, const void* u, void* sig, int B, int NI,
                                         int NK, int NJ, int weld_te, double lam, double mu,
                                         void* stream) {
  return launch<float>(g, u, sig, B, NI, NK, NJ, weld_te, lam, mu, stream);
}

extern "C" int tpufem_element_stress_f64(const void* g, const void* u, void* sig, int B, int NI,
                                         int NK, int NJ, int weld_te, double lam, double mu,
                                         void* stream) {
  return launch<double>(g, u, sig, B, NI, NK, NJ, weld_te, lam, mu, stream);
}
