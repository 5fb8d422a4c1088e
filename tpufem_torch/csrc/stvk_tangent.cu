// Kernel I: the consistent tangent of the total-Lagrangian St. Venant-Kirchhoff
// internal force applied to a direction, K_T(u) x, on the structured wing
// grid, welded and Dirichlet-wrapped, one launch per call.
//
// Replaces tpufem's jax.jvp of stvk_internal_force (tpufem/fem/nonlinear.py:238
// and :245; XLA fused the jvp'd slab program on the TPU), the operator of
// every Newton-CG iteration of WingNonlinear. One launch computes
//
//   y = R( dF(u)[x] ) * free + x * (1 - free),  dF(u)[x] the directional
//   derivative of kernel H's f_int at S(u * free) along S(x * free),
//
// per Kuhn tet (stvk.cuh's convention): H from u, dH from x,
//   dE = 1/2 (dH + dH^T + dH H^T + H dH^T),  dS = 2 mu dE + lam tr(dE) I,
//   dP = dS + dH^T S + H^T dS,               f_a = V dP g_a.
// At u = 0 it is kernel B's linear operator applied to x; it is symmetric on
// the free subspace (f_int is the gradient of kernel J's energy), which the
// Newton CG needs.
//
// Operands in tpufem's layouts, all contiguous, f64: g (6,4,3,B,nc,nt,ns),
// vol (6,B,nc,nt,ns), x, u and y (3,B,NI,NK,NJ), free the NJ root mask.
//
// The bound is bytes: kernel B's reads plus a second grid field; at DOF100K
// B = 1, 21.8 MB, ~6.5 us at 3.35 TB/s. The arithmetic, ~520 flops per tet,
// is ~2.8 us at the FP64 rate outside the tensor cores.
//
// Design: grid_tile.cuh's schedule for one lane with a 2-field body: a
// thread loads the corners of both fields its cell touches, masked and
// weld-spread; every cell of a tile is evaluated at once, then one barrier and
// a fixed-order node sum in shared memory without atomics, so two calls give
// the same bits. The tile is H's (stvk_force.cu: tpufem_grid_tile_f64).

#include <cuda_runtime.h>

#include "grid_tile.cuh"
#include "stvk.cuh"

namespace {

template <typename T>
struct stvk_tangent_body {
  static constexpr bool kIdentity = true;  // of X, the direction
  T lam, mu;

  __device__ __forceinline__ void operator()(int tet, const T* sg, int plane,
                                             const T (&X)[8][3], const T (&U)[8][3],
                                             T (&lo)[4][3], T (&hi)[4][3]) const {
    T H[3][3], dH[3][3], S[3][3], dS[3][3];
    stvk::grad(tet, sg, plane, U, H);
    stvk::grad(tet, sg, plane, X, dH);
    stvk::green(H, S);
    stvk::stress(S, lam, mu);
#pragma unroll
    for (int m = 0; m < 3; ++m)
#pragma unroll
      for (int n = m; n < 3; ++n) {
        const T q = dH[m][0] * H[n][0] + dH[m][1] * H[n][1] + dH[m][2] * H[n][2] +
                    H[m][0] * dH[n][0] + H[m][1] * dH[n][1] + H[m][2] * dH[n][2];
        dS[m][n] = T(0.5) * (dH[m][n] + dH[n][m] + q);
        dS[n][m] = dS[m][n];
      }
    stvk::stress(dS, lam, mu);
    const T v = sg[12 * plane];
    T P[3][3];  // V (dS + dH^T S + H^T dS)
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int d = 0; d < 3; ++d)
        P[i][d] = (dS[i][d] + dH[0][i] * S[0][d] + dH[1][i] * S[1][d] + dH[2][i] * S[2][d] +
                   H[0][i] * dS[0][d] + H[1][i] * dS[1][d] + H[2][i] * dS[2][d]) *
                  v;
    stvk::add_forces(tet, sg, plane, P, lo, hi);
  }
};

__global__ void __launch_bounds__(grid_tile::kThreads, grid_tile::kMinBlocks)
    stvk_tangent_kernel(grid_tile::Operands<double> p, grid_tile::Tile tile,
                        stvk_tangent_body<double> body) {
  grid_tile::run<double, 2>(p, tile, body);
}

}  // namespace

// All tensors contiguous on the device, f64; x is the direction (and the
// field of the Dirichlet identity), u the state; free is the NJ root mask.
// Returns cudaGetLastError() after the launch.
extern "C" int tpufem_stvk_tangent_f64(const void* g, const void* vol, const void* x,
                                       const void* u, const void* free, void* y, int B, int NI,
                                       int NK, int NJ, int weld_te, double lam, double mu,
                                       void* stream) {
  if (B <= 0 || NI < 2 || NK < 2 || NJ < 2) return 0;
  const grid_tile::Operands<double> a{static_cast<const double*>(g),
                                      static_cast<const double*>(vol),
                                      static_cast<const double*>(x),
                                      static_cast<const double*>(free), static_cast<double*>(y),
                                      B, NI, NK, NJ, weld_te, static_cast<const double*>(u)};
  return grid_tile::launch(stvk_tangent_kernel, a, stvk_tangent_body<double>{lam, mu},
                                  static_cast<cudaStream_t>(stream));
}
