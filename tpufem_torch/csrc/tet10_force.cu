// Kernel N: the incidence-gather tet10 (quadratic) operator (f32 and f64):
// Dirichlet mask, element forces at the 4 Gauss points, per-node sum and the
// Dirichlet identity.
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
// from Jinv (T,3,3), vols (T,), x, free, y (N,3) and the tile plan of the
// (T,10) connectivity `tets` (tpufem_torch/fem/tet10.py::force_plan, built
// once per topology on the host: the kernel reads the connectivity through
// it).
//
// Bound: the bytes of Jinv, vols, tets, x and free read once and y written
// once, and 1,500 flops a tet. Design: every tet is evaluated once. The plan
// cuts the tets into blocks of neighbours (tiles of cells at full thickness
// on a structured wing, runs of the reverse Cuthill-McKee order elsewhere);
// a node whose entries all come from one block's tets is interior to it, any
// other node is a halo node. Two launches:
//
//   tiles: a block per tile. Its threads first stage the masked displacement
//     u of every node its tets touch (the plan's `cnode`) in shared memory,
//     so that a tet reads its 10 nodes there (`lnode`) and not from scattered
//     global addresses; then a thread per listed tet runs the body of kernel
//     L (csrc/strain_apply10.cu: DNDXI a compile-time table from tet10.cuh, so
//     its exact zeros drop out of both contractions; the 10 nodes gathered in
//     groups of 3, 3, 2, 2 into the 36 sums v; per Gauss point H, the weighted
//     stress and s in v's place; then one node force at a time). The force of
//     an entry on an interior node goes to shared memory at the entry's row
//     among its block's (the plan's `dst`), that of a halo entry to the halo
//     scratch at its slot, in the order the block's warps write them (by
//     warp, node m, lane), so that a warp's stores for one m are one
//     contiguous run; after one barrier a thread per (interior node,
//     component) adds the node's rows in order from zero and stores y.
//   halo: a thread per (halo node, component) gathers the node's rows from
//     the scratch (`hslot`) and adds them in order from zero, and stores y
//     (a node no tet touches: zero rows).
//
// Both sums run in ascending t*10+m from zero, as the plan lays each node's
// rows out, and the body's arithmetic is kernel N's first design's (the walk
// of csrc/incidence_walk.cuh, which kernel D keeps): the same bits. The one
// contraction the compiler chose differently here, the diagonal stress, is
// pinned to the first design's with fma_rn. No atomics.
// The scratch and the plan's arrays are the design's bytes, not in the
// bound.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tet10.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kStage = 4;  // staged values a thread loads at once
// a block's most dynamic shared memory, Hopper's opt-in
constexpr int kMaxSmem = 232448;

using tet10::dndxi;
using tet10::static_for;

template <typename T>
struct Args {
  const T* jinv;
  const T* vols;
  const int32_t* ttet;    // (T,) the tets in block order, ascending within a block
  const int32_t* tstart;  // (n_blocks+1,) block b lists ttet[tstart[b]:tstart[b+1]]
  const int32_t* dst;     // (10T,) entry m of listed tet l at l*10+m: its shared row, or ~halo row
  const int32_t* inode;   // the interior nodes, block after block, ascending
  const int32_t* istart;  // (n_blocks+1,) block b's interior nodes inode[istart[b]:...]
  const int32_t* irow;    // interior node i's rows irow[i]:irow[i+1], less its block's first
  const int32_t* hnode;   // the halo nodes, ascending
  const int32_t* hrow;    // halo node i's rows hrow[i]:hrow[i+1]
  const int32_t* hslot;   // each halo row's slot of the scratch
  const int32_t* cnode;   // the nodes of each block's tets, block after block
  const int32_t* cstart;  // (n_blocks+1,) block b's are cnode[cstart[b]:cstart[b+1]]
  const int16_t* lnode;   // (10T,) node m of listed tet l at l*10+m: its place in cnode
  const T* x;
  const T* free;
  T* y;
  T* halo;  // the halo scratch, 3 values a row
  int n_halo;
  T lam, mu;
};

// a * b + c rounded once, as the compiler would fuse it
__device__ __forceinline__ double fma_rn(double a, double b, double c) { return __fma_rn(a, b, c); }
__device__ __forceinline__ float fma_rn(float a, float b, float c) { return __fmaf_rn(a, b, c); }

// y at flat index o: the sum of row(r) for r in [r0, r1) in order from zero,
// with the Dirichlet identity where free is 0; x and free loaded before the sum
template <typename T, typename Row>
__device__ __forceinline__ void sum_store(const Args<T>& p, int o, int r0, int r1, Row&& row) {
  const T m = p.free != nullptr ? __ldg(p.free + o) : T(1);
  const T xo = p.free != nullptr ? __ldg(p.x + o) : T(0);
  T acc = 0;
  for (int r = r0; r < r1; ++r) acc += row(r);
  p.y[o] = p.free != nullptr ? acc * m + xo * (T(1) - m) : acc;
}

// Nodes M0..M1-1 of listed tet l: their masked displacements read from the
// block's staged u (su), then their DNDXI terms added into v in node order
template <int M0, int M1, typename T>
__device__ __forceinline__ void add_nodes(const Args<T>& p, int l, const T* su,
                                          T (&v)[4][3][3]) {
  T un[M1 - M0][3];
  static_for<M1 - M0>([&](auto ic) {
    constexpr int i = decltype(ic)::value;
    const int o = __ldg(p.lnode + l * 10 + M0 + i) * 3;
#pragma unroll
    for (int e = 0; e < 3; ++e) un[i][e] = su[o + e];
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

// f_m[d] = sum_q sum_j DNDXI[q][m][j] s_q[j][d] into o[d]
template <int m, typename T>
__device__ __forceinline__ void node_force(const T (&v)[4][3][3], T* o) {
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

// Listed tet l: its 10 node forces, each to shared memory (sh) at the row the
// plan gives its entry, or to the halo scratch at its slot
template <typename T>
__device__ __forceinline__ void tet_forces(const Args<T>& p, int l, const T* su, T* sh) {
  const int t = __ldg(p.ttet + l);
  T v[4][3][3];
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int j = 0; j < 3; ++j)
#pragma unroll
      for (int e = 0; e < 3; ++e) v[q][j][e] = T(0);
  add_nodes<0, 3>(p, l, su, v);
  add_nodes<3, 6>(p, l, su, v);
  add_nodes<6, 8>(p, l, su, v);
  add_nodes<8, 10>(p, l, su, v);
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
      // 2 mu eps + lam tr(eps) I, lam tr fused as kernel N's first design compiled it
      w[d][d] = wq * fma_rn(p.lam, tr, p.mu * (w[d][d] + w[d][d]));
    }
#pragma unroll
    for (int j = 0; j < 3; ++j)
#pragma unroll
      for (int d = 0; d < 3; ++d)
        v[q][j][d] = w[d][0] * J[0][j] + w[d][1] * J[1][j] + w[d][2] * J[2][j];
  }
  static_for<10>([&](auto mc) {
    constexpr int m = decltype(mc)::value;
    const int r = __ldg(p.dst + l * 10 + m);
    node_force<m>(v, r >= 0 ? sh + r * 3 : p.halo + static_cast<size_t>(~r) * 3);
  });
}

// Shared memory: the block's interior rows (3 values a row), then its staged u
// (3 values a node)
template <typename T>
__global__ void __launch_bounds__(kThreads) tet10_force_tiles_kernel(Args<T> p, int rows) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sh = reinterpret_cast<T*>(smem_raw);
  T* su = sh + rows * 3;
  const int b = blockIdx.x;
  const int c0 = __ldg(p.cstart + b);
  const int nu = (__ldg(p.cstart + b + 1) - c0) * 3;
  // kStage values a thread, their loads issued together
  for (int k0 = threadIdx.x; k0 < nu; k0 += kStage * kThreads) {
    T xs[kStage], fs[kStage];
#pragma unroll
    for (int s = 0; s < kStage; ++s) {
      const int k = k0 + s * kThreads;
      if (k < nu) {
        const int o = __ldg(p.cnode + c0 + k / 3) * 3 + k - (k / 3) * 3;
        xs[s] = __ldg(p.x + o);
        if (p.free != nullptr) fs[s] = __ldg(p.free + o);
      }
    }
#pragma unroll
    for (int s = 0; s < kStage; ++s) {
      const int k = k0 + s * kThreads;
      if (k < nu) su[k] = p.free != nullptr ? xs[s] * fs[s] : xs[s];
    }
  }
  __syncthreads();
  const int l1 = __ldg(p.tstart + b + 1);
  for (int l = __ldg(p.tstart + b) + threadIdx.x; l < l1; l += kThreads)
    tet_forces(p, l, su, sh);
  __syncthreads();
  const int i0 = __ldg(p.istart + b);
  const int row0 = __ldg(p.irow + i0);
  const int nvals = (__ldg(p.istart + b + 1) - i0) * 3;
  for (int k = threadIdx.x; k < nvals; k += kThreads) {
    const int i = i0 + k / 3, c = k - (k / 3) * 3;
    sum_store(p, __ldg(p.inode + i) * 3 + c, __ldg(p.irow + i) - row0,
              __ldg(p.irow + i + 1) - row0, [&](int r) { return sh[r * 3 + c]; });
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) tet10_force_halo_kernel(Args<T> p) {
  const int k = blockIdx.x * kThreads + threadIdx.x;
  if (k >= p.n_halo * 3) return;
  const int i = k / 3, c = k - (k / 3) * 3;
  sum_store(p, __ldg(p.hnode + i) * 3 + c, __ldg(p.hrow + i), __ldg(p.hrow + i + 1),
            [&](int r) { return p.halo[static_cast<size_t>(__ldg(p.hslot + r)) * 3 + c]; });
}

template <typename T>
int launch(const void* jinv, const void* vols, const void* ttet,
           const void* tstart, const void* dst, const void* inode, const void* istart,
           const void* irow, const void* hnode, const void* hrow, const void* hslot,
           const void* cnode,
           const void* cstart, const void* lnode, const void* x, const void* free, void* y,
           void* halo, int n_blocks, int n_halo, int rows, int closure, double lam, double mu,
           void* stream) {
  const size_t smem = static_cast<size_t>(rows + closure) * 3 * sizeof(T);
  if (n_blocks < 0 || n_halo < 0 || rows < 0 || closure < 0 ||
      smem > static_cast<size_t>(kMaxSmem))
    return static_cast<int>(cudaErrorInvalidValue);
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      tet10_force_tiles_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (opt_in != cudaSuccess) return static_cast<int>(opt_in);
  const Args<T> args{
      static_cast<const T*>(jinv),      static_cast<const T*>(vols),
      static_cast<const int32_t*>(ttet),
      static_cast<const int32_t*>(tstart), static_cast<const int32_t*>(dst),
      static_cast<const int32_t*>(inode), static_cast<const int32_t*>(istart),
      static_cast<const int32_t*>(irow), static_cast<const int32_t*>(hnode),
      static_cast<const int32_t*>(hrow), static_cast<const int32_t*>(hslot),
      static_cast<const int32_t*>(cnode),
      static_cast<const int32_t*>(cstart), static_cast<const int16_t*>(lnode),
      static_cast<const T*>(x),
      static_cast<const T*>(free),      static_cast<T*>(y),
      static_cast<T*>(halo),            n_halo,
      static_cast<T>(lam),              static_cast<T>(mu)};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_blocks > 0) tet10_force_tiles_kernel<T><<<n_blocks, kThreads, smem, s>>>(args, rows);
  if (n_halo > 0)
    tet10_force_halo_kernel<T><<<(n_halo * 3 + kThreads - 1) / kThreads, kThreads, 0, s>>>(args);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Jinv (T,3,3), vols (T,), x, y (N,3), free (N,3) or null, halo (3 x the
// plan's halo rows), and the plan of the (T,10) connectivity (force_plan,
// which reads its tets through cnode and lnode): ttet (T,),
// tstart (n_blocks+1,), dst (10T,), inode, istart (n_blocks+1,), irow,
// hnode (n_halo,), hrow (n_halo+1,), cnode, cstart (n_blocks+1,), all int32,
// and lnode (10T,) int16, no block holding more than `rows` interior rows and
// `closure` nodes (its shared memory: (rows + closure) x 3 values, at most
// Hopper's 232,448 bytes); all contiguous on the device, the float tensors of
// one dtype. The plan's values are trusted. Returns cudaGetLastError() after
// the two launches (the second reads the scratch the first wrote, on the
// same stream).
extern "C" int tpufem_tet10_force_tiled_f32(
    const void* jinv, const void* vols, const void* ttet, const void* tstart,
    const void* dst, const void* inode, const void* istart, const void* irow, const void* hnode,
    const void* hrow, const void* hslot, const void* cnode, const void* cstart, const void* lnode,
    const void* x,
    const void* free, void* y, void* halo, int n_blocks, int n_halo, int rows, int closure,
    double lam, double mu, void* stream) {
  return launch<float>(jinv, vols, ttet, tstart, dst, inode, istart, irow, hnode, hrow,
                       hslot, cnode, cstart, lnode, x, free, y, halo, n_blocks, n_halo, rows,
                       closure, lam, mu, stream);
}

extern "C" int tpufem_tet10_force_tiled_f64(
    const void* jinv, const void* vols, const void* ttet, const void* tstart,
    const void* dst, const void* inode, const void* istart, const void* irow, const void* hnode,
    const void* hrow, const void* hslot, const void* cnode, const void* cstart, const void* lnode,
    const void* x,
    const void* free, void* y, void* halo, int n_blocks, int n_halo, int rows, int closure,
    double lam, double mu, void* stream) {
  return launch<double>(jinv, vols, ttet, tstart, dst, inode, istart, irow, hnode, hrow,
                        hslot, cnode, cstart, lnode, x, free, y, halo, n_blocks, n_halo, rows,
                        closure, lam, mu, stream);
}
