// Kernel N: the incidence-gather tet10 (quadratic) operator in one launch (f32
// and f64): Dirichlet mask, element forces at the 4 Gauss points, per-node
// sum and the Dirichlet identity.
//
// Replaces tpufem/fem/tet10.py::tet10_force (:167-216, with _tet10_fe and
// _quad_grads) and the masking around it in Tet10MGSolver._apply_A
// (tpufem/fem/tet10_mg.py:141-147) and tet10_operator (tet10.py:219-228), jnp
// code that XLA fused on the TPU; the gather engine's CG applies it 5 times an
// iteration (once in the CG, 4 times in its V-cycle):
//
//   u       = x * free                                   (free == nullptr: u = x)
//   v_q[j]  = sum_m DNDXI[q][m][j] u[tets[t,m]]          per tet, Gauss point q
//   H_q     = sum_j grad(lambda_j) (x) v_q[j],           grad(lambda_j)[d] = Jinv[t][d][j]
//   sigma_q = 2 mu sym(H_q) + lam tr(H_q) I
//   s_q[j]  = (vols[t] / 4) sigma_q . grad(lambda_j)
//   f[t,m]  = sum_q sum_j DNDXI[q][m][j] s_q[j]
//   K u [n] = sum of f[t,m] over the entries (t,m) with tets[t,m] == n,
//             in ascending t*10+m, from zero
//   y       = (K u) * free + x * (1 - free)              (free == nullptr: y = K u)
//
// from Jinv (T,3,3), vols (T,), tets (T,10) int32, x, free, y (N,3) and the
// connectivity's incidence plan (tpufem_torch/fem/assembly.py::build_incidence
// at k = 10, built once per topology on the host). The element forces never
// reach device memory.
//
// Design: kernel D's incidence walk (csrc/incidence_walk.cuh: a block per
// contiguous node range, a thread per listed tet, the node sums in a fixed
// order in shared memory, no atomics) with a tet10 body, kernel L's
// (csrc/strain_apply10.cu): DNDXI a compile-time table (tet10.cuh), so its
// exact zeros drop out of both contractions; the 10 nodes gathered in groups
// of 3, 3, 2, 2 into the 36 sums v; per Gauss point H, the weighted stress and
// s in v's place; then one node force at a time, and only for a node in the
// block's range, written to shared memory at its entry's CSR row
// (pos[t*10+m]). tpufem numbers the midside nodes after all corners (N4 +
// edge id), so a tet's nodes fall into several ranges and it is evaluated once
// per block it touches (the plan's `overlap`); the body's flops are counted
// once per tet in the bound, the re-evaluations are the design's cost.

#include <cuda_runtime.h>
#include <stdint.h>

#include "incidence_walk.cuh"
#include "tet10.cuh"

namespace {

using incidence::kThreads;
using tet10::dndxi;
using tet10::static_for;

template <typename T>
struct Args {
  const T* jinv;
  const T* vols;
  const int32_t* tets;
  incidence::Plan plan;
  const T* x;
  const T* free;
  T* y;
  T lam, mu;
};

// Nodes M0..M1-1 of tet t: their (masked) displacements loaded at once, then
// their DNDXI terms added into v in node order
template <int M0, int M1, typename T>
__device__ __forceinline__ void add_nodes(const Args<T>& p, int t, T (&v)[4][3][3]) {
  T un[M1 - M0][3];
  static_for<M1 - M0>([&](auto ic) {
    constexpr int i = decltype(ic)::value;
    const int o = __ldg(p.tets + t * 10 + M0 + i) * 3;
#pragma unroll
    for (int e = 0; e < 3; ++e) un[i][e] = __ldg(p.x + o + e);
    if (p.free != nullptr) {
#pragma unroll
      for (int e = 0; e < 3; ++e) un[i][e] *= __ldg(p.free + o + e);
    }
  });
  static_for<M1 - M0>([&](auto ic) {
    constexpr int i = decltype(ic)::value;
    static_for<4>([&](auto qc) {
      constexpr int q = decltype(qc)::value;
      static_for<3>([&](auto jc) {
        constexpr int j = decltype(jc)::value;
        constexpr double c = dndxi(q, M0 + i, j);
        if constexpr (c != 0.0) {
#pragma unroll
          for (int e = 0; e < 3; ++e) v[q][j][e] += T(c) * un[i][e];
        }
      });
    });
  });
}

// One tet: its node forces for the nodes the block owns, at their entries' rows
template <typename T>
__device__ __forceinline__ void tet_forces(const Args<T>& p, int t,
                                           const incidence::Block<T, 10>& blk) {
  T v[4][3][3];
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int j = 0; j < 3; ++j)
#pragma unroll
      for (int e = 0; e < 3; ++e) v[q][j][e] = T(0);
  add_nodes<0, 3>(p, t, v);
  add_nodes<3, 6>(p, t, v);
  add_nodes<6, 8>(p, t, v);
  add_nodes<8, 10>(p, t, v);
  T J[3][3];  // J[d][j] = grad(lambda_j)[d]
#pragma unroll
  for (int d = 0; d < 3; ++d)
#pragma unroll
    for (int j = 0; j < 3; ++j) J[d][j] = __ldg(p.jinv + t * 9 + d * 3 + j);
  const T wq = T(0.25) * __ldg(p.vols + t);
  // per Gauss point: H, the weighted stress in its place, then s[j][d] = wq
  // sum_e sigma[d][e] grad(lambda_j)[e] in v[q]'s place
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    T w[3][3];
#pragma unroll
    for (int d = 0; d < 3; ++d)
#pragma unroll
      for (int e = 0; e < 3; ++e)
        w[d][e] = J[d][0] * v[q][0][e] + J[d][1] * v[q][1][e] + J[d][2] * v[q][2][e];
    const T tr = w[0][0] + w[1][1] + w[2][2];
#pragma unroll
    for (int d = 0; d < 3; ++d) {
#pragma unroll
      for (int e = d + 1; e < 3; ++e) w[d][e] = w[e][d] = wq * (p.mu * (w[d][e] + w[e][d]));
      w[d][d] = wq * (p.mu * (w[d][d] + w[d][d]) + p.lam * tr);  // 2 mu eps + lam tr(eps) I
    }
#pragma unroll
    for (int j = 0; j < 3; ++j)
#pragma unroll
      for (int d = 0; d < 3; ++d)
        v[q][j][d] = w[d][0] * J[0][j] + w[d][1] * J[1][j] + w[d][2] * J[2][j];
  }
  // f_m[d] = sum_q sum_j DNDXI[q][m][j] s_q[j][d], one node at a time, where the
  // block owns the node
  static_for<10>([&](auto mc) {
    constexpr int m = decltype(mc)::value;
    if (blk.owns(__ldg(p.tets + t * 10 + m))) {
      T* o = blk.at(t, m);
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        T f = T(0);
        static_for<4>([&](auto qc) {
          constexpr int q = decltype(qc)::value;
          static_for<3>([&](auto jc) {
            constexpr int j = decltype(jc)::value;
            constexpr double c = dndxi(q, m, j);
            if constexpr (c != 0.0) f += T(c) * v[q][j][d];
          });
        });
        o[d] = f;
      }
    }
  });
}

template <typename T>
__global__ void __launch_bounds__(kThreads) tet10_force_kernel(Args<T> p) {
  incidence::walk<10>(p.plan, p.x, p.free, p.y,
                      [&](int t, const incidence::Block<T, 10>& blk) { tet_forces(p, t, blk); });
}

template <typename T>
int launch(const void* jinv, const void* vols, const void* tets, const void* pos,
           const void* btet, const void* bt_start, const void* bnode, const void* starts,
           const void* x, const void* free, void* y, int n_blocks, int slots, double lam,
           double mu, void* stream) {
  if (n_blocks > 0) {
    const incidence::Plan plan{
        static_cast<const int32_t*>(pos), static_cast<const int32_t*>(btet),
        static_cast<const int32_t*>(bt_start), static_cast<const int32_t*>(bnode),
        static_cast<const int32_t*>(starts)};
    const Args<T> args{static_cast<const T*>(jinv), static_cast<const T*>(vols),
                       static_cast<const int32_t*>(tets), plan, static_cast<const T*>(x),
                       static_cast<const T*>(free), static_cast<T*>(y), static_cast<T>(lam),
                       static_cast<T>(mu)};
    const int bytes = incidence::smem_bytes<T>(slots);
    tet10_force_kernel<T><<<n_blocks, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(args);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Jinv (T,3,3), vols (T,), tets (T,10) int32, x, y (N,3), free (N,3) or null,
// and the plan: pos (10T,), btet, bt_start (n_blocks+1,), bnode (n_blocks+1,),
// starts (N+1,), all int32, no block's range holding more than `slots`
// entries (at most 2048, whose f64 forces fill the 48 KB of shared memory a
// block gets without asking); all contiguous on the device, the float tensors
// of one dtype. The plan's values are trusted. Returns cudaGetLastError()
// after the launch.
extern "C" int tpufem_tet10_force_f32(
    const void* jinv, const void* vols, const void* tets, const void* pos, const void* btet,
    const void* bt_start, const void* bnode, const void* starts, const void* x, const void* free,
    void* y, int n_blocks, int slots, double lam, double mu, void* stream) {
  return launch<float>(jinv, vols, tets, pos, btet, bt_start, bnode, starts, x, free, y,
                       n_blocks, slots, lam, mu, stream);
}

extern "C" int tpufem_tet10_force_f64(
    const void* jinv, const void* vols, const void* tets, const void* pos, const void* btet,
    const void* bt_start, const void* bnode, const void* starts, const void* x, const void* free,
    void* y, int n_blocks, int slots, double lam, double mu, void* stream) {
  return launch<double>(jinv, vols, tets, pos, btet, bt_start, bnode, starts, x, free, y,
                        n_blocks, slots, lam, mu, stream);
}
