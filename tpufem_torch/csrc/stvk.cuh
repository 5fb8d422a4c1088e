// Per-Kuhn-tet pieces of the total-Lagrangian St. Venant-Kirchhoff kernels H
// (stvk_force), I (stvk_tangent) and J (stvk_energy), and the thread-per-tet
// indexing of J and K (strain_geo_vjp), in tpufem's index convention
// (tpufem/fem/nonlinear.py:83-104):
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

// One thread's Kuhn tet in the thread-per-tet kernels J and K: thread idx <
// 6 * plane (plane = B * ncell) takes tet t = idx / plane of cell bc = idx -
// t * plane (lane b, cell (ci, ck, cj)). The cell runs fastest, so a warp
// holds consecutive cells of one tet and reads each plane of g
// (6,4,3,B,nc,nt,ns) at consecutive addresses; its vol entry is vol[idx].
struct TetThread {
  int t, bc, b, ci, ck, cj;
};

__device__ __forceinline__ TetThread tet_thread(int idx, int plane, int ncell, int nt, int ns) {
  TetThread r;
  r.t = idx / plane;
  r.bc = idx - r.t * plane;
  r.b = r.bc / ncell;
  const int c = r.bc - r.b * ncell;
  r.cj = c % ns;
  r.ck = (c / ns) % nt;
  r.ci = c / (ns * nt);
  return r;
}

// The grid nodes (offsets into one component of a field (3,B,NI,NK,NJ)) and
// root-mask values of a tet's 4 corners, weld-spread: on weld rows every
// thickness node reads k = 0
template <typename T>
struct TetNodes {
  int node[4];
  T fr[4];
};

template <typename T>
__device__ __forceinline__ TetNodes<T> tet_nodes(const TetThread& p, const T* free, int NI,
                                                 int NK, int NJ, int weld_te) {
  TetNodes<T> n;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int q = grid_tet::kuhn_rt(p.t, a);
    const int i = p.ci + grid_tet::corner_di(q);
    const int j = p.cj + grid_tet::corner_dj(q);
    const int k = grid_tet::weld_k(i, p.ck + grid_tet::corner_dk(q), NI, weld_te);
    n.node[a] = (p.b * NI + i) * NK * NJ + k * NJ + j;
    n.fr[a] = __ldg(free + j);
  }
  return n;
}

// the tet's 4 corner values of grid field f, masked by the root mask;
// `stride` = B * NI * NK * NJ, one component's size
template <typename T>
__device__ __forceinline__ void load_tet_field(const T* f, const TetNodes<T>& n, int stride,
                                               T (&U)[4][3]) {
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int e = 0; e < 3; ++e) U[a][e] = __ldg(f + e * stride + n.node[a]) * n.fr[a];
}

// the tet's 12 gradient values g (a, d) from sg = g + (t * 12 * B) * ncell + bc,
// planes `plane` apart
template <typename T>
__device__ __forceinline__ void load_tet_grads(const T* sg, int plane, T (&G)[4][3]) {
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int d = 0; d < 3; ++d) G[a][d] = __ldg(sg + (a * 3 + d) * plane);
}

// H[d][e] = sum_a G[a][d] U[a][e] over one tet's corners, in grad's order
template <typename T>
__device__ __forceinline__ void tet_grad(const T (&G)[4][3], const T (&U)[4][3], T (&H)[3][3]) {
#pragma unroll
  for (int d = 0; d < 3; ++d)
#pragma unroll
    for (int e = 0; e < 3; ++e) H[d][e] = T(0);
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int d = 0; d < 3; ++d)
#pragma unroll
      for (int e = 0; e < 3; ++e) H[d][e] += G[a][d] * U[a][e];
}

// The block size of a thread-per-tet launch of n threads: the largest of 256,
// 128 and 64 whose grid still gives every SM of the card a block, else 64
inline int tet_block(long long n) {
  const int sms = grid_tet::sm_count();
  for (int t = 256; t > 64; t /= 2)
    if ((n + t - 1) / t >= sms) return t;
  return 64;
}

}  // namespace stvk
