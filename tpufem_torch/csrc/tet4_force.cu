// Kernel D: tet4 element forces of the matrix-free stiffness operator
// (f32 and f64).
//
// Replaces the per-tet body of tpufem/fem/assembly.py::elastic_force
// (:60-74; jnp code that XLA fused on the TPU), which the gather-path CG
// applies once per iteration:
//
//   H     = sum_a g_a (x) u_a           (displacement gradient, 3x3)
//   sigma = 2 mu sym(H) + lam tr(H) I
//   fe[t*4 + a, :] = vol_t * sigma . g_a
//
// from the per-tet gradients grads (T,4,3), volumes vols (T,), corner ids
// tets (T,4) int32 and nodal displacements u (N,3). The per-node sum of fe
// is kernel E (csr_segment_sum.cu); the Dirichlet wrap stays in PyTorch.
//
// What bounds it on the card: bytes. A tet reads 12 gradients, a volume, 4
// ids and 12 gathered displacements and writes 12 forces (~180 B in f32)
// against ~100 flops. Design: one thread per tet; the tet's corner values
// stay in registers, nothing is shared, and each thread writes only its own
// rows of fe, so there are no atomics and two runs give the same bits.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T>
__global__ void tet4_force_kernel(const T* __restrict__ grads, const T* __restrict__ vols,
                                  const int32_t* __restrict__ tets, const T* __restrict__ u,
                                  T* __restrict__ fe, int64_t n_tets, T lam, T mu) {
  const int64_t t = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (t >= n_tets) return;
  T g[4][3];
  T H[3][3] = {{0, 0, 0}, {0, 0, 0}, {0, 0, 0}};
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int64_t node = tets[t * 4 + a];
    const T u0 = u[node * 3], u1 = u[node * 3 + 1], u2 = u[node * 3 + 2];
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      g[a][d] = grads[(t * 4 + a) * 3 + d];
      H[d][0] += g[a][d] * u0;
      H[d][1] += g[a][d] * u1;
      H[d][2] += g[a][d] * u2;
    }
  }
  const T v = vols[t];
  const T tr = H[0][0] + H[1][1] + H[2][2];
  T s[3][3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
#pragma unroll
    for (int e = 0; e < 3; ++e) s[d][e] = mu * (H[d][e] + H[e][d]);  // 2 mu eps
    s[d][d] += lam * tr;
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      fe[(t * 4 + a) * 3 + d] = v * (s[d][0] * g[a][0] + s[d][1] * g[a][1] + s[d][2] * g[a][2]);
    }
  }
}

template <typename T>
int launch(const void* grads, const void* vols, const void* tets, const void* u, void* fe,
           long long n_tets, double lam, double mu, void* stream) {
  if (n_tets > 0) {
    const int threads = 128;
    const int64_t blocks = (n_tets + threads - 1) / threads;
    tet4_force_kernel<T><<<static_cast<unsigned int>(blocks), threads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(grads), static_cast<const T*>(vols),
        static_cast<const int32_t*>(tets), static_cast<const T*>(u), static_cast<T*>(fe),
        n_tets, static_cast<T>(lam), static_cast<T>(mu));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// grads (T,4,3), vols (T,), tets (T,4) int32, u (N,3), fe (T*4,3); all
// contiguous on the device, the float tensors of one dtype. Returns
// cudaGetLastError() after the launch.
extern "C" int tpufem_tet4_force_f32(const void* grads, const void* vols, const void* tets,
                                     const void* u, void* fe, long long n_tets, double lam,
                                     double mu, void* stream) {
  return launch<float>(grads, vols, tets, u, fe, n_tets, lam, mu, stream);
}

extern "C" int tpufem_tet4_force_f64(const void* grads, const void* vols, const void* tets,
                                     const void* u, void* fe, long long n_tets, double lam,
                                     double mu, void* stream) {
  return launch<double>(grads, vols, tets, u, fe, n_tets, lam, mu, stream);
}
