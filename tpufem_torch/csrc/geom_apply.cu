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
// of every cell, with the tet's stress sigma (a full 3x3, not assumed
// symmetric), in tpufem's order
//
//   s_b = sigma g_b,  H[d][i] = sum_b s_b[d] u_b[i],  f_a[i] = V_t * g_a . H[:, i],
//
// i.e. f_a = V_t * sum_b (g_a^T sigma g_b) u_b, from the per-tet gradients g
// (6,4,3,B,nc,nt,ns), volumes vol (6,B,nc,nt,ns), stresses sig
// (6,3,3,B,nc,nt,ns) and u, y (3,B,NI,NK,NJ), all contiguous, in tpufem's
// layouts.
//
// The bound is bytes. Per lane it reads 132 scalars per cell (72 gradients,
// 6 volumes, 54 stresses) and u and y: at DOF100K (64x80x6 cells), f64, 34.2 MB
// per lane, so 410.5 MB and ~122.5 us at B = 12, at 3.35 TB/s. The arithmetic
// is ~200 flops per tet, ~12 us at the FP64 rate outside the tensor cores.
//
// Design: the cell-centric walk of grid_walk.cuh with the body below: each
// tet is evaluated once per block that holds its cell, its 22 planes (12
// gradients, the volume, 9 stresses) staged per (layer, tet) through a
// cp.async ring, the node sums in a fixed order with no atomics, so two
// applies give the same bits. Tiles are 32 x 4 cells: at ~200 registers a
// thread in f64, 8-row tiles leave one block of 8 warps per SM, 4-row tiles
// two of 4, and measured faster at every shape the solvers launch (1.38x
// the geometry bytes against 1.18x). The ring holds 3 stages of 23.9 KB in
// f64 (2 measured 6-25 % slower), 4 of 12.7 KB in f32.

#include <cuda_runtime.h>
#include <stdint.h>

#include "grid_walk.cuh"

namespace {

using grid_tet::kuhn;

template <typename T>
struct geom_apply_body {
  static constexpr int kPlanes = 22;  // 4 x 3 gradients, the volume, 3 x 3 stresses
  static constexpr bool kIdentity = false;
  static constexpr int kFields = 1;

  __device__ __forceinline__ void operator()(int tet, const T* sg, int plane,
                                             const T (&U)[8][3], T (&lo)[4][3],
                                             T (&hi)[4][3]) const {
    const T* sig = sg + 13 * plane;  // sigma[d][e] at plane d * 3 + e
    T H[3][3] = {};                  // H[d][i] = sum_b (sigma g_b)[d] * u_b[i]
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int q = kuhn(tet, b);
      const T g0 = sg[(b * 3 + 0) * plane];
      const T g1 = sg[(b * 3 + 1) * plane];
      const T g2 = sg[(b * 3 + 2) * plane];
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        const T s = sig[(d * 3 + 0) * plane] * g0 + sig[(d * 3 + 1) * plane] * g1 +
                    sig[(d * 3 + 2) * plane] * g2;
        H[d][0] += s * U[q][0];
        H[d][1] += s * U[q][1];
        H[d][2] += s * U[q][2];
      }
    }
    const T v = sg[12 * plane];
#pragma unroll
    for (int d = 0; d < 3; ++d)
#pragma unroll
      for (int i = 0; i < 3; ++i) H[d][i] *= v;
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int q = kuhn(tet, a);
      const T g0 = sg[(a * 3 + 0) * plane];
      const T g1 = sg[(a * 3 + 1) * plane];
      const T g2 = sg[(a * 3 + 2) * plane];
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        const T f = H[0][i] * g0 + H[1][i] * g1 + H[2][i] * g2;
        if (q < 4) {
          lo[q][i] += f;
        } else {
          hi[q - 4][i] += f;
        }
      }
    }
  }
};

constexpr int kRows = 4;  // cell rows along chord per block (one warp each)

template <typename T, int VEC, int DEPTH>
__global__ void __launch_bounds__(grid_walk::kLanes * kRows)
    geom_apply_kernel(grid_walk::Operands<T> p) {
  grid_walk::walk<T, kRows, VEC, DEPTH>(p, geom_apply_body<T>{});
}

template <typename T, int VEC>
int launch_with(const grid_walk::Operands<T>& a, cudaStream_t stream) {
  constexpr int kDepth = sizeof(T) == 8 ? 3 : 4;
  constexpr size_t smem =
      grid_walk::smem_bytes<T, geom_apply_body<T>::kPlanes, kRows, VEC, kDepth>();
  // above 48 KB of dynamic shared memory needs the opt-in, once per kernel
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      geom_apply_kernel<T, VEC, kDepth>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (opt_in != cudaSuccess) return static_cast<int>(opt_in);
  geom_apply_kernel<T, VEC, kDepth>
      <<<grid_walk::grid_of<kRows>(a.B, a.NI, a.NJ), dim3(grid_walk::kLanes, kRows), smem, stream>>>(
          a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* g, const void* vol, const void* sig, const void* u, const void* free,
           void* y, int B, int NI, int NK, int NJ, int weld_te, void* stream) {
  if (B <= 0 || NI < 2 || NK < 2 || NJ < 2) return 0;
  const grid_walk::Operands<T> a{static_cast<const T*>(g), static_cast<const T*>(vol),
                                 static_cast<const T*>(sig), static_cast<const T*>(u),
                                 static_cast<const T*>(free), static_cast<T*>(y),
                                 B, NI, NK, NJ, weld_te};
  constexpr int kVec = 16 / sizeof(T);
  // a 16-byte copy needs its span row, every plane and the three bases aligned
  const bool aligned = (NJ - 1) % kVec == 0 && reinterpret_cast<uintptr_t>(g) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(vol) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(sig) % 16 == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return aligned ? launch_with<T, kVec>(a, st) : launch_with<T, 1>(a, st);
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
