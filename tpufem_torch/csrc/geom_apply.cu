// Kernel G: the welded, masked geometric-stiffness apply on the structured
// wing grid, one launch per operator apply.
//
// Replaces tpufem/fem/buckling.py:93 geom_apply (jnp code that XLA fused on
// the TPU; applied twice per WingBuckling sweep and once per inner CG
// iteration of WingPrestressedModal). One launch computes the whole function
//
//   y = R( K_G( S(u * free) ) ) * free
//
// S (weld spread: on weld rows every thickness node takes the k = 0 value)
// and the root mask `free` (an NJ vector) are applied as u is loaded; R (weld
// reduce: the thickness sum goes to k = 0, the rest is zero) and the mask as y
// is stored. Weld rows are i = 0 and, when weld_te, i = NI - 1. There is no
// Dirichlet identity: constrained rows come back zero. K_G is, per Kuhn tet t
// of every cell, with the tet's stress sigma (symmetric),
//
//   f_a[i] = V_t * sum_b (g_a^T sigma g_b) u_b[i],
//
// from the per-tet gradients g (6,4,3,B,nc,nt,ns), volumes vol (6,B,nc,nt,ns),
// stresses sig (6,3,3,B,nc,nt,ns) and u, y (3,B,NI,NK,NJ), all contiguous, in
// tpufem's layouts.
//
// The bound is bytes. Per lane it reads 132 scalars per cell (72 gradients,
// 6 volumes, 54 stresses) and u and y: at DOF100K (64x80x6 cells), f64, 34.2 MB
// per lane, so 274 MB and ~82 us at B = 8, ~122 us at B = 12, at 3.35 TB/s.
//
// Design, node-centric gather in a fixed order: one thread per (case, node)
// of the full grid, nodes contiguous along span. The thread visits the up to
// 8 cells around its node (hex corner q = 0..7 of the cell it is corner q of),
// and in each the tets t = 0..5 that hold that corner, and adds the tet's
// force on it: each tet is evaluated once for each of its 4 corners, and its
// 22 planes are read by 4 threads, mostly from L1/L2. The sum order is fixed,
// with no atomics, so two applies give the same bits. A weld row's k = 0
// thread sums its whole thickness line, and its other threads store zero.
// Every index is 32-bit; the wrapper checks that every operand has fewer than
// 2^31 elements.

#include <cuda_runtime.h>

#include "grid_tet.cuh"

namespace {

using grid_tet::corner_di;
using grid_tet::corner_dj;
using grid_tet::corner_dk;
using grid_tet::kuhn;
using grid_tet::weld_row;

constexpr int kThreads = 256;

template <typename T>
struct Args {
  const T* g;
  const T* vol;
  const T* sig;
  const T* u;
  const T* free;
  T* y;
  int B, NI, NK, NJ;
  int weld_te;
};

// Adds to acc the forces on node (i, k, j) of the full grid, lane b, from
// every tet that holds it.
template <typename T>
__device__ __forceinline__ void node_forces(const Args<T>& p, int b, int i, int k, int j,
                                            T (&acc)[3]) {
  const int NI = p.NI, NK = p.NK, NJ = p.NJ, B = p.B;
  const int nc = NI - 1, nt = NK - 1, ns = NJ - 1;
  const int ncell = nc * nt * ns;
  const int uplane = NI * NK * NJ, ustride = B * uplane;
#pragma unroll
  for (int qn = 0; qn < 8; ++qn) {  // the node is corner qn of cell (ci, ck, cj)
    const int ci = i - corner_di(qn);
    const int cj = j - corner_dj(qn);
    const int ck = k - corner_dk(qn);
    if (ci < 0 || ci >= nc || cj < 0 || cj >= ns || ck < 0 || ck >= nt) continue;
    const int c = (ci * nt + ck) * ns + cj;
#pragma unroll
    for (int t = 0; t < 6; ++t) {
      int a = -1;
#pragma unroll
      for (int aa = 0; aa < 4; ++aa)
        if (kuhn(t, aa) == qn) a = aa;
      if (a < 0) continue;  // resolved at compile time once the loops unroll
      const T* gt = p.g + (t * 12 * B + b) * ncell + c;  // plane (a, d): + (a * 3 + d) * B * ncell
      const T* st = p.sig + (t * 9 * B + b) * ncell + c;
      const int plane = B * ncell;
      T s[3][3];
#pragma unroll
      for (int d = 0; d < 3; ++d)
#pragma unroll
        for (int e = 0; e < 3; ++e) s[d][e] = __ldg(st + (d * 3 + e) * plane);
      T ga[3];
#pragma unroll
      for (int d = 0; d < 3; ++d) ga[d] = __ldg(gt + (a * 3 + d) * plane);
      // r = sigma g_a (sigma is symmetric, so g_a^T sigma g_b = r . g_b)
      T r[3];
#pragma unroll
      for (int d = 0; d < 3; ++d) r[d] = s[d][0] * ga[0] + s[d][1] * ga[1] + s[d][2] * ga[2];
      const T v = __ldg(p.vol + (t * B + b) * ncell + c);
      T f[3] = {T(0), T(0), T(0)};
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) {
        const int q = kuhn(t, bb);
        const int ui = ci + corner_di(q);
        const int uj = cj + corner_dj(q);
        const int uk = weld_row(ui, NI, p.weld_te) ? 0 : ck + corner_dk(q);
        const int node = b * uplane + (ui * NK + uk) * NJ + uj;
        const T fr = __ldg(p.free + uj);
        const T cab = r[0] * __ldg(gt + (bb * 3 + 0) * plane) +
                      r[1] * __ldg(gt + (bb * 3 + 1) * plane) +
                      r[2] * __ldg(gt + (bb * 3 + 2) * plane);
#pragma unroll
        for (int e = 0; e < 3; ++e) f[e] += cab * (__ldg(p.u + e * ustride + node) * fr);
      }
#pragma unroll
      for (int e = 0; e < 3; ++e) acc[e] += v * f[e];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) geom_apply_kernel(Args<T> p) {
  const int NI = p.NI, NK = p.NK, NJ = p.NJ;
  const int uplane = NI * NK * NJ, ustride = p.B * uplane;
  const int idx = blockIdx.x * kThreads + threadIdx.x;
  if (idx >= p.B * uplane) return;
  const int b = idx / uplane, n = idx - b * uplane;
  const int j = n % NJ, k = (n / NJ) % NK, i = n / (NJ * NK);
  const bool weld = weld_row(i, NI, p.weld_te);
  T acc[3] = {T(0), T(0), T(0)};
  if (!weld) {
    node_forces<T>(p, b, i, k, j, acc);
  } else if (k == 0) {
    for (int kk = 0; kk < NK; ++kk) node_forces<T>(p, b, i, kk, j, acc);
  }
  const T fr = __ldg(p.free + j);
#pragma unroll
  for (int e = 0; e < 3; ++e) p.y[e * ustride + idx] = acc[e] * fr;
}

template <typename T>
int launch(const void* g, const void* vol, const void* sig, const void* u, const void* free,
           void* y, int B, int NI, int NK, int NJ, int weld_te, void* stream) {
  if (B <= 0 || NI < 2 || NK < 2 || NJ < 2) return 0;
  const Args<T> a{static_cast<const T*>(g), static_cast<const T*>(vol),
                  static_cast<const T*>(sig), static_cast<const T*>(u),
                  static_cast<const T*>(free), static_cast<T*>(y), B, NI, NK, NJ, weld_te};
  const int n = B * NI * NK * NJ;
  geom_apply_kernel<T><<<(n + kThreads - 1) / kThreads, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// All tensors contiguous on the device, of one dtype; free is the NJ root
// mask. Returns cudaGetLastError() after the launch.
extern "C" int tpufem_geom_apply_f32(const void* g, const void* vol, const void* sig,
                                     const void* u, const void* free, void* y, int B, int NI,
                                     int NK, int NJ, int weld_te, void* stream) {
  return launch<float>(g, vol, sig, u, free, y, B, NI, NK, NJ, weld_te, stream);
}

extern "C" int tpufem_geom_apply_f64(const void* g, const void* vol, const void* sig,
                                     const void* u, const void* free, void* y, int B, int NI,
                                     int NK, int NJ, int weld_te, void* stream) {
  return launch<double>(g, vol, sig, u, free, y, B, NI, NK, NJ, weld_te, stream);
}
