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
// Design: grid_tile.cuh's schedule for one lane, with the StVK body below:
// every cell of a tile is evaluated at once (no barrier between layers or
// tets), then one barrier and a fixed-order node sum in shared memory without
// atomics, so two calls give the same bits. The tile a launch takes is
// tpufem_grid_tile_f64's below.

#include <cuda_runtime.h>

#include "grid_tile.cuh"
#include "stvk.cuh"

namespace {

template <typename T>
struct stvk_force_body {
  static constexpr bool kIdentity = true;
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

__global__ void __launch_bounds__(grid_tile::kThreads, grid_tile::kMinBlocks)
    stvk_force_kernel(grid_tile::Operands<double> p, grid_tile::Tile tile,
                      stvk_force_body<double> body) {
  grid_tile::run<double, 1>(p, tile, body);
}

}  // namespace

// All tensors contiguous on the device, f64; free is the NJ root mask.
// Returns cudaGetLastError() after the launch.
extern "C" int tpufem_stvk_force_f64(const void* g, const void* vol, const void* u,
                                     const void* free, void* y, int B, int NI, int NK, int NJ,
                                     int weld_te, double lam, double mu, void* stream) {
  if (B <= 0 || NI < 2 || NK < 2 || NJ < 2) return 0;
  const grid_tile::Operands<double> a{static_cast<const double*>(g),
                                      static_cast<const double*>(vol),
                                      static_cast<const double*>(u),
                                      static_cast<const double*>(free), static_cast<double*>(y),
                                      B, NI, NK, NJ, weld_te, nullptr};
  return grid_tile::launch(stvk_force_kernel, a, stvk_force_body<double>{lam, mu},
                                  static_cast<cudaStream_t>(stream));
}

// The tile kernels H and I launch with at this grid on the current device
// (grid_tile::tile_of): tile[0] owned node columns along span, tile[1] chord
// rows. Returns 0.
extern "C" int tpufem_grid_tile_f64(int B, int NI, int NK, int NJ, int* tile) {
  const grid_tile::Tile t = grid_tile::tile_of<double>(B, NI, NK, NJ, grid_tile::sm_count());
  tile[0] = t.own_j;
  tile[1] = t.own_i;
  return 0;
}
