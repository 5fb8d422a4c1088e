// Per-Kuhn-tet pieces of the total-Lagrangian St. Venant-Kirchhoff kernels H
// (stvk_force), I (stvk_tangent) and J (stvk_energy), in tpufem's index
// convention (tpufem/fem/nonlinear.py:83-104):
//
//   H[d][e] = sum_a g_a[d] u_a[e]                      (= d u_e / d X_d)
//   E[m][n] = 1/2 (H[m][n] + H[n][m] + sum_k H[m][k] H[n][k])
//   S       = 2 mu E + lam tr(E) I                     (2nd Piola-Kirchhoff)
//   P[i][d] = S[i][d] + sum_m H[m][i] S[m][d]          (1st Piola-Kirchhoff)
//
// and the corner forces f_a[i] = V sum_d P[i][d] g_a[d].

#pragma once

#include "grid_tet.cuh"

namespace stvk {

// H of tet `tet` from the cell's corner values U; gradients at sg, planes
// `plane` apart (g (a * 3 + d)), as grid_walk stages them
template <typename T>
__device__ __forceinline__ void grad(int tet, const T* sg, int plane, const T (&U)[8][3],
                                     T (&H)[3][3]) {
#pragma unroll
  for (int d = 0; d < 3; ++d)
#pragma unroll
    for (int e = 0; e < 3; ++e) H[d][e] = T(0);
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int q = grid_tet::kuhn(tet, a);
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const T gd = sg[(a * 3 + d) * plane];
#pragma unroll
      for (int e = 0; e < 3; ++e) H[d][e] += gd * U[q][e];
    }
  }
}

// Green-Lagrange strain E of H (symmetric, stored whole)
template <typename T>
__device__ __forceinline__ void green(const T (&H)[3][3], T (&E)[3][3]) {
#pragma unroll
  for (int m = 0; m < 3; ++m)
#pragma unroll
    for (int n = m; n < 3; ++n) {
      const T q = H[m][0] * H[n][0] + H[m][1] * H[n][1] + H[m][2] * H[n][2];
      E[m][n] = T(0.5) * (H[m][n] + H[n][m] + q);
      E[n][m] = E[m][n];
    }
}

// S = 2 mu E + lam tr(E) I, in place
template <typename T>
__device__ __forceinline__ void stress(T (&E)[3][3], T lam, T mu) {
  const T ltr = lam * (E[0][0] + E[1][1] + E[2][2]);
#pragma unroll
  for (int m = 0; m < 3; ++m)
#pragma unroll
    for (int n = 0; n < 3; ++n) E[m][n] = T(2) * mu * E[m][n] + (m == n ? ltr : T(0));
}

// adds f_a[i] = sum_d P[i][d] g_a[d] (P already times the volume) to the
// cell's corner sums: lo for hex corners 0-3, hi for 4-7
template <typename T>
__device__ __forceinline__ void add_forces(int tet, const T* sg, int plane, const T (&P)[3][3],
                                           T (&lo)[4][3], T (&hi)[4][3]) {
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int q = grid_tet::kuhn(tet, a);
    const T g0 = sg[(a * 3 + 0) * plane];
    const T g1 = sg[(a * 3 + 1) * plane];
    const T g2 = sg[(a * 3 + 2) * plane];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const T f = P[i][0] * g0 + P[i][1] * g1 + P[i][2] * g2;
      if (q < 4) {
        lo[q][i] += f;
      } else {
        hi[q - 4][i] += f;
      }
    }
  }
}

// the cell's 8 corner values of grid field f (3,B,NI,NK,NJ) at lane b,
// masked by the root mask and weld-spread (on weld rows every thickness node
// reads k = 0), for the thread-per-cell kernels J and K
template <typename T>
__device__ __forceinline__ void load_corners(const T* f, const T* free, int b, int ci, int ck,
                                             int cj, int B, int NI, int NK, int NJ, int weld_te,
                                             T (&U)[8][3]) {
  const int uplane = NI * NK * NJ, ustride = B * uplane;
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const int i = ci + grid_tet::corner_di(q);
    const int j = cj + grid_tet::corner_dj(q);
    const int k = grid_tet::weld_row(i, NI, weld_te) ? 0 : ck + grid_tet::corner_dk(q);
    const int node = b * uplane + (i * NK + k) * NJ + j;
    const T fr = __ldg(free + j);
#pragma unroll
    for (int e = 0; e < 3; ++e) U[q][e] = __ldg(f + e * ustride + node) * fr;
  }
}

}  // namespace stvk
