// Kernel H: the total-Lagrangian St. Venant-Kirchhoff internal force on the
// structured wing grid, welded and Dirichlet-wrapped, one launch per call.
//
// Replaces tpufem/fem/nonlinear.py:107 stvk_internal_force (jnp code that XLA
// fused on the TPU; evaluated once per Newton residual of WingNonlinear). One
// launch computes the whole public function
//
//   y = R( f_int( S(u * free) ) ) * free + u * (1 - free)
//
// with S (weld spread) and the root mask applied as u is loaded, R (weld
// reduce), the mask and the Dirichlet identity as y is stored, exactly as
// kernel B wraps the linear operator. f_int is, per Kuhn tet of every cell,
// H = sum_a g_a (x) u_a, the Green-Lagrange E, S = 2 mu E + lam tr(E) I,
// P = S + H^T S and the corner forces V P g_a (stvk.cuh). At small u it is
// kernel B's operator to O(|grad u|^2).
//
// Operands in tpufem's layouts, all contiguous, f64: g (6,4,3,B,nc,nt,ns),
// vol (6,B,nc,nt,ns), u and y (3,B,NI,NK,NJ), free the NJ root mask.
//
// The bound is bytes: it reads what kernel B reads (13 planes of geometry per
// tet, u once) and writes y; at DOF100K B = 1 that is 20.9 MB, ~6.2 us at
// 3.35 TB/s. The arithmetic is ~330 flops per tet, ~1.8 us at the FP64 rate
// outside the tensor cores.
//
// Design: kernel B's cell-centric walk (grid_walk.cuh: a block of 8 warps per
// lane and 32 x 8-cell tile, the 13 planes of each (layer, tet) staged
// through a cp.async ring, fixed-order node sums without atomics, so two calls
// give the same bits) with the StVK body below.

#include <cuda_runtime.h>
#include <stdint.h>

#include "grid_walk.cuh"
#include "stvk.cuh"

namespace {

template <typename T>
struct stvk_force_body {
  static constexpr int kPlanes = 13;  // 4 x 3 gradient planes and the volume
  static constexpr bool kIdentity = true;
  static constexpr int kFields = 1;
  T lam, mu;

  __device__ __forceinline__ void operator()(int tet, const T* sg, int plane,
                                             const T (&U)[8][3], T (&lo)[4][3],
                                             T (&hi)[4][3]) const {
    T H[3][3], S[3][3];
    stvk::grad(tet, sg, plane, U, H);
    stvk::green(H, S);
    stvk::stress(S, lam, mu);
    const T v = sg[12 * plane];
    T P[3][3];  // V (S + H^T S)
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int d = 0; d < 3; ++d)
        P[i][d] = (S[i][d] + H[0][i] * S[0][d] + H[1][i] * S[1][d] + H[2][i] * S[2][d]) * v;
    stvk::add_forces(tet, sg, plane, P, lo, hi);
  }
};

constexpr int kRows = 8;  // cell rows along chord per block (one warp each)
constexpr int kDepth = 3;  // ring stages (kernel B's f64 setting)

template <int VEC>
__global__ void __launch_bounds__(grid_walk::kLanes * kRows)
    stvk_force_kernel(grid_walk::Operands<double> p, stvk_force_body<double> body) {
  grid_walk::walk<double, kRows, VEC, kDepth>(p, body);
}

template <int VEC>
int launch_with(const grid_walk::Operands<double>& a, stvk_force_body<double> body,
                cudaStream_t stream) {
  constexpr size_t smem =
      grid_walk::smem_bytes<double, stvk_force_body<double>::kPlanes, kRows, VEC, kDepth>();
  // above 48 KB of dynamic shared memory needs the opt-in, once per kernel
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      stvk_force_kernel<VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (opt_in != cudaSuccess) return static_cast<int>(opt_in);
  stvk_force_kernel<VEC>
      <<<grid_walk::grid_of<kRows>(a.B, a.NI, a.NJ), dim3(grid_walk::kLanes, kRows), smem, stream>>>(
          a, body);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// All tensors contiguous on the device, f64; free is the NJ root mask.
// Returns cudaGetLastError() after the launch.
extern "C" int tpufem_stvk_force_f64(const void* g, const void* vol, const void* u,
                                     const void* free, void* y, int B, int NI, int NK, int NJ,
                                     int weld_te, double lam, double mu, void* stream) {
  if (B <= 0 || NI < 2 || NK < 2 || NJ < 2) return 0;
  const grid_walk::Operands<double> a{static_cast<const double*>(g),
                                      static_cast<const double*>(vol), nullptr,
                                      static_cast<const double*>(u),
                                      static_cast<const double*>(free), static_cast<double*>(y),
                                      B, NI, NK, NJ, weld_te};
  const stvk_force_body<double> body{lam, mu};
  // a 16-byte copy needs its span row, every plane and both bases aligned
  const bool aligned = (NJ - 1) % 2 == 0 && reinterpret_cast<uintptr_t>(g) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(vol) % 16 == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return aligned ? launch_with<2>(a, body, st) : launch_with<1>(a, body, st);
}
