// Kernel B: the welded, Dirichlet-wrapped strain-first stiffness apply on the
// structured wing grid, one launch per operator apply.
//
// Replaces tpufem/fem/stencil.py:249 strain_apply (jnp code that XLA fused on
// the TPU; the operator every CG iteration applies once in f64 and every
// V-cycle level above the coarsest 4 times in f32). One launch computes the
// whole public function
//
//   y = R( K_cells( S(u * free) ) ) * free + u * (1 - free)
//
// S (weld spread: on weld rows every thickness node takes the k = 0 value) and
// the root mask `free` (an NJ vector) are applied as u is loaded; R (weld
// reduce: the thickness sum goes to k = 0, the rest is zero), the mask and the
// Dirichlet identity u * (1 - free) as y is stored. Weld rows are i = 0 and,
// when weld_te, i = NI - 1. K_cells is, per Kuhn tet t of every cell,
//
//   f_a = vol_t * sigma(eps_t) . g_{t,a},  eps_t = sym(sum_a g_{t,a} (x) u_a),
//   sigma = 2 mu eps + lam tr(eps) I,
//
// from the per-tet gradients g (6,4,3,B,nc,nt,ns), volumes vol (6,B,nc,nt,ns)
// and u, y (3,B,NI,NK,NJ), all contiguous, in tpufem's layouts.
//
// The bound is bytes. Per apply at DOF100K, B = 8, the inputs are 17,694,720
// gradient and 1,474,560 volume scalars, and u and y hold 884,520 each:
// 167.5 MB in f64, 83.8 MB in f32, so 50 us and 25 us at 3.35 TB/s. The
// arithmetic is ~170 flops per tet, 0.25 GFLOP per apply, ~7 us at the FP64
// rate outside the tensor cores: the work is bytes-bound at ~7x its flop
// time, so tensor cores (wgmma) would buy nothing here.
//
// Design: the cell-centric walk of grid_walk.cuh (a block of 8 warps per
// tile of 32 x 8 cells and lane, 13 planes per (layer, tet) staged through a
// cp.async ring, fixed-order node sums, no atomics) with the elastic body
// below and the Dirichlet identity.
// Every index is 32-bit; the wrapper checks that the gradient array and u have
// fewer than 2^31 elements.

#include <cuda_runtime.h>
#include <stdint.h>

#include "grid_walk.cuh"

namespace {

using grid_tet::kuhn;

// One Kuhn tet of the thread's cell: strain from its 4 corner displacements,
// stress, and the 4 corner forces vol * sigma . g_a added to the corner sums
// (lo: corners 0-3 on the cell's lower node layer, hi: 4-7 on the upper).
// tet is a constant once the walk's loop is unrolled.
template <typename T>
struct strain_apply_body {
  static constexpr int kPlanes = 13;  // 4 x 3 gradient planes and the volume
  static constexpr bool kIdentity = true;
  static constexpr int kFields = 1;
  T lam, mu;

  __device__ __forceinline__ void operator()(int tet, const T* sg, int plane,
                                             const T (&U)[8][3], T (&lo)[4][3],
                                             T (&hi)[4][3]) const {
    T H[3][3] = {};  // H[d][e] = sum_a g[t,a,d] * u_a[e]
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int q = kuhn(tet, a);
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        const T gd = sg[(a * 3 + d) * plane];
        H[d][0] += gd * U[q][0];
        H[d][1] += gd * U[q][1];
        H[d][2] += gd * U[q][2];
      }
    }
    const T v = sg[12 * plane];
    const T tr = H[0][0] + H[1][1] + H[2][2];
    T s[3][3];
#pragma unroll
    for (int d = 0; d < 3; ++d) {
#pragma unroll
      for (int e = 0; e < 3; ++e) s[d][e] = mu * (H[d][e] + H[e][d]) * v;  // 2 mu eps, times vol
      s[d][d] += lam * tr * v;
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int q = kuhn(tet, a);
      const T g0 = sg[(a * 3 + 0) * plane];
      const T g1 = sg[(a * 3 + 1) * plane];
      const T g2 = sg[(a * 3 + 2) * plane];
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        const T f = s[d][0] * g0 + s[d][1] * g1 + s[d][2] * g2;
        if (q < 4) {
          lo[q][d] += f;
        } else {
          hi[q - 4][d] += f;
        }
      }
    }
  }
};

constexpr int kRows = 8;  // cell rows along chord per block (one warp each)

template <typename T, int VEC, int DEPTH>
__global__ void __launch_bounds__(grid_walk::kLanes * kRows)
    strain_apply_kernel(grid_walk::Operands<T> p, strain_apply_body<T> body) {
  grid_walk::walk<T, kRows, VEC, DEPTH>(p, body);
}

template <typename T, int VEC, int DEPTH>
int launch_with(const grid_walk::Operands<T>& a, strain_apply_body<T> body, cudaStream_t stream) {
  constexpr size_t smem = grid_walk::smem_bytes<T, strain_apply_body<T>::kPlanes, kRows, VEC, DEPTH>();
  // above 48 KB of dynamic shared memory needs the opt-in, once per kernel
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      strain_apply_kernel<T, VEC, DEPTH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (opt_in != cudaSuccess) return static_cast<int>(opt_in);
  strain_apply_kernel<T, VEC, DEPTH>
      <<<grid_walk::grid_of<kRows>(a.B, a.NI, a.NJ), dim3(grid_walk::kLanes, kRows), smem, stream>>>(
          a, body);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* g, const void* vol, const void* u, const void* free, void* y, int B,
           int NI, int NK, int NJ, int weld_te, double lam, double mu, void* stream) {
  if (B <= 0 || NI < 2 || NK < 2 || NJ < 2) return 0;
  const grid_walk::Operands<T> a{static_cast<const T*>(g), static_cast<const T*>(vol), nullptr,
                                 static_cast<const T*>(u), static_cast<const T*>(free),
                                 static_cast<T*>(y), B, NI, NK, NJ, weld_te};
  const strain_apply_body<T> body{static_cast<T>(lam), static_cast<T>(mu)};
  constexpr int kVec = 16 / sizeof(T);
  // a 16-byte copy needs its span row, every plane and both bases aligned
  const bool aligned = (NJ - 1) % kVec == 0 && reinterpret_cast<uintptr_t>(g) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(vol) % 16 == 0;
  // ring depth: 3 stages of 27-28 KB in f64, 4 of 14-15 KB in f32 (deeper
  // rings measured no faster: the walk is not waiting on the copies)
  constexpr int kDepth = sizeof(T) == 8 ? 3 : 4;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return aligned ? launch_with<T, kVec, kDepth>(a, body, st)
                 : launch_with<T, 1, kDepth>(a, body, st);
}

}  // namespace

// All tensors contiguous on the device, of one dtype; free is the NJ root
// mask. Returns cudaGetLastError() after the launch.
extern "C" int tpufem_strain_apply_f32(const void* g, const void* vol, const void* u,
                                       const void* free, void* y, int B, int NI, int NK, int NJ,
                                       int weld_te, double lam, double mu, void* stream) {
  return launch<float>(g, vol, u, free, y, B, NI, NK, NJ, weld_te, lam, mu, stream);
}

extern "C" int tpufem_strain_apply_f64(const void* g, const void* vol, const void* u,
                                       const void* free, void* y, int B, int NI, int NK, int NJ,
                                       int weld_te, double lam, double mu, void* stream) {
  return launch<double>(g, vol, u, free, y, B, NI, NK, NJ, weld_te, lam, mu, stream);
}
