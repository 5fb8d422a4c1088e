// Kernel D: the gather path's matrix-free stiffness operator in one launch
// (f32 and f64): Dirichlet mask, tet4 element forces, per-node sum and the
// Dirichlet identity.
//
// Replaces tpufem/fem/assembly.py::elastic_force (:60-79) and the body of
// stiffness_operator.apply around it (:93-97), jnp code that XLA fused on the
// TPU, which the gather-path CG applies once per iteration:
//
//   u       = x * free                                  (free == nullptr: u = x)
//   H_t     = sum_a grads[t,a] (x) u[tets[t,a]]         per tet
//   sigma_t = 2 mu sym(H_t) + lam tr(H_t) I
//   f[t,a]  = vols[t] * sigma_t . grads[t,a]
//   K u [n] = sum of f[t,a] over the entries (t,a) with tets[t,a] == n,
//             in ascending t*4+a, from zero
//   y       = (K u) * free + x * (1 - free)             (free == nullptr: y = K u)
//
// from grads (T,4,3), vols (T,), tets (T,4) int32, x, free, y (N,3) and the
// tets' incidence plan (tpufem_torch/fem/assembly.py::build_incidence, built
// once per topology on the host). The element forces f never reach device
// memory.
//
// What bounds it on the card: bytes. An apply must read the gradients (96 B
// per tet in f64), volumes, ids, the plan, x and free once and write y once;
// the arithmetic (about 180 flops per evaluated tet) stays below that.
//
// Design: tet-centric, block-local sum: the incidence walk
// (csrc/incidence_walk.cuh; kernel N takes it with a tet10 body) with a tet4
// body. A thread evaluates one listed tet at a time, whole: the 12 gradients,
// the 4 ids and the 4 CSR rows of its entries (pos[t*4+a]) by 16-byte loads,
// the 4 masked corner displacements gathered, sigma formed once; each corner
// force whose node lies in the block's range goes to shared memory at its
// entry's row. A tet is evaluated by every block it touches (the plan's
// `overlap`: 2.11 on the structured wing mesh's numbering, 4 at worst).

#include <cuda_runtime.h>
#include <stdint.h>

#include "incidence_walk.cuh"
#include "tet4.cuh"

namespace {

using incidence::kThreads;

// a tet's 12 gradients (4 corners x 3 components) by 16-byte loads
__device__ __forceinline__ void load_grads(const float* __restrict__ p, float (&g)[4][3]) {
  const float4* v = reinterpret_cast<const float4*>(p);
  const float4 a = __ldg(v), b = __ldg(v + 1), c = __ldg(v + 2);
  g[0][0] = a.x; g[0][1] = a.y; g[0][2] = a.z; g[1][0] = a.w;
  g[1][1] = b.x; g[1][2] = b.y; g[2][0] = b.z; g[2][1] = b.w;
  g[2][2] = c.x; g[3][0] = c.y; g[3][1] = c.z; g[3][2] = c.w;
}

__device__ __forceinline__ void load_grads(const double* __restrict__ p, double (&g)[4][3]) {
  const double2* v = reinterpret_cast<const double2*>(p);
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    const double2 q = __ldg(v + i);
    g[(2 * i) / 3][(2 * i) % 3] = q.x;
    g[(2 * i + 1) / 3][(2 * i + 1) % 3] = q.y;
  }
}

// u = x[node] * free[node], or x[node] where there is no mask
template <typename T>
__device__ __forceinline__ void load_node(const T* __restrict__ x, const T* __restrict__ free,
                                          int node, T (&u)[3]) {
  const int o = node * 3;
#pragma unroll
  for (int e = 0; e < 3; ++e) u[e] = __ldg(x + o + e);
  if (free != nullptr) {
#pragma unroll
    for (int e = 0; e < 3; ++e) u[e] *= __ldg(free + o + e);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
stiffness_apply_kernel(const T* __restrict__ grads, const T* __restrict__ vols,
                       const int32_t* __restrict__ tets, const int32_t* __restrict__ pos,
                       const int32_t* __restrict__ btet, const int32_t* __restrict__ bt_start,
                       const int32_t* __restrict__ bnode, const int32_t* __restrict__ starts,
                       const T* __restrict__ x, const T* __restrict__ free, T* __restrict__ y,
                       T lam, T mu) {
  const incidence::Plan plan{pos, btet, bt_start, bnode, starts};
  incidence::walk<4>(plan, x, free, y, [&](int t, const incidence::Block<T, 4>& blk) {
    const int4 ids = __ldg(reinterpret_cast<const int4*>(tets) + t);
    const int4 p4 = __ldg(reinterpret_cast<const int4*>(pos) + t);
    T g[4][3], ue[4][3], s[3][3];
    load_grads(grads + static_cast<int64_t>(t) * 12, g);
    const int id[4] = {ids.x, ids.y, ids.z, ids.w};
    const int pp[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
    for (int a = 0; a < 4; ++a) load_node(x, free, id[a], ue[a]);
    const T vol = __ldg(vols + t);
    tet4_stress(g, ue, lam, mu, s);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      if (blk.owns(id[a])) {
        T* o = blk.at_row(pp[a]);
#pragma unroll
        for (int d = 0; d < 3; ++d) {
          o[d] = vol * (s[d][0] * g[a][0] + s[d][1] * g[a][1] + s[d][2] * g[a][2]);
        }
      }
    }
  });
}

template <typename T>
int launch(const void* grads, const void* vols, const void* tets, const void* pos,
           const void* btet, const void* bt_start, const void* bnode, const void* starts,
           const void* x, const void* free, void* y, int n_blocks, int slots, double lam,
           double mu, void* stream) {
  if (n_blocks > 0) {
    const int bytes = incidence::smem_bytes<T>(slots);
    stiffness_apply_kernel<T><<<n_blocks, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(grads), static_cast<const T*>(vols),
        static_cast<const int32_t*>(tets), static_cast<const int32_t*>(pos),
        static_cast<const int32_t*>(btet), static_cast<const int32_t*>(bt_start),
        static_cast<const int32_t*>(bnode), static_cast<const int32_t*>(starts),
        static_cast<const T*>(x), static_cast<const T*>(free), static_cast<T*>(y),
        static_cast<T>(lam), static_cast<T>(mu));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// grads (T,4,3), vols (T,), tets (T,4) int32, x, y (N,3), free (N,3) or null,
// and the plan: pos (4T,), btet, bt_start (n_blocks+1,), bnode (n_blocks+1,),
// starts (N+1,), all int32, no block's range holding more than `slots`
// entries (at most 2048, whose f64 forces fill the 48 KB of shared memory a
// block gets without asking); all contiguous on the device, grads, tets and
// pos 16-byte aligned, the float tensors of one dtype. The plan's values are trusted. Returns
// cudaGetLastError() after the launch.
extern "C" int tpufem_stiffness_apply_f32(
    const void* grads, const void* vols, const void* tets, const void* pos, const void* btet,
    const void* bt_start, const void* bnode, const void* starts, const void* x, const void* free,
    void* y, int n_blocks, int slots, double lam, double mu, void* stream) {
  return launch<float>(grads, vols, tets, pos, btet, bt_start, bnode, starts, x, free, y,
                       n_blocks, slots, lam, mu, stream);
}

extern "C" int tpufem_stiffness_apply_f64(
    const void* grads, const void* vols, const void* tets, const void* pos, const void* btet,
    const void* bt_start, const void* bnode, const void* starts, const void* x, const void* free,
    void* y, int n_blocks, int slots, double lam, double mu, void* stream) {
  return launch<double>(grads, vols, tets, pos, btet, bt_start, bnode, starts, x, free, y,
                        n_blocks, slots, lam, mu, stream);
}
