// The tet4 element stress of kernels D (csrc/tet4_force.cu) and O
// (csrc/tet4_force_t.cu): one point, linear elasticity.

#pragma once

#include <cuda_runtime.h>

// sigma = 2 mu sym(H) + lam tr(H) I with H = sum_a g_a (x) u_a
template <typename T>
__device__ __forceinline__ void tet4_stress(const T (&g)[4][3], const T (&ue)[4][3], T lam, T mu,
                                            T (&s)[3][3]) {
  T H[3][3] = {{0, 0, 0}, {0, 0, 0}, {0, 0, 0}};
#pragma unroll
  for (int a = 0; a < 4; ++a) {
#pragma unroll
    for (int d = 0; d < 3; ++d) {
#pragma unroll
      for (int e = 0; e < 3; ++e) H[d][e] += g[a][d] * ue[a][e];
    }
  }
  const T ltr = lam * (H[0][0] + H[1][1] + H[2][2]);
#pragma unroll
  for (int d = 0; d < 3; ++d) {
#pragma unroll
    for (int e = 0; e < 3; ++e) s[d][e] = mu * (H[d][e] + H[e][d]);  // 2 mu eps
    s[d][d] += ltr;
  }
}
