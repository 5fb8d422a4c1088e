// Kernel O: the trailing-batch tet4 operator in one launch (f32 and f64): B
// wing cases of one topology, the case axis last, Dirichlet mask, element
// forces, per-node sum and the Dirichlet identity.
//
// Replaces tpufem/fem/multigrid.py::force_t (:265) and
// tpufem/fem/batched_t.py::WingBatchT._force (:174) with the mask and
// identity around them (_apply_A, batched_t.py:462; WingMGT._apply_A,
// multigrid.py:498), jnp code that XLA fused on the TPU, which every
// WingBatchT CG iteration and every smoother step of the WingMGT V-cycle
// applies, at each level of the hierarchy:
//
//   u          = x * free                                (free == nullptr: u = x)
//   H_t,b      = sum_a grads[t,a,:,b] (x) u[tets[t,a],:,b]   per tet and lane b
//   sigma_t,b  = 2 mu sym(H_t,b) + lam tr(H_t,b) I
//   f[t,a,:,b] = vols[t,b] * sigma_t,b . grads[t,a,:,b]
//   K u [n,:,b] = sum of f[t,a,:,b] over the entries (t,a) with tets[t,a] == n,
//                in ascending t*4+a, from zero, for each lane
//   y          = (K u) * free + x * (1 - free)           (free == nullptr: y = K u)
//
// from grads (T,4,3,B) and vols (T,B) per lane, tets (T,4) int32 and free
// (N,3) shared by the lanes, x and y (N,3,B), and the tets' incidence plan
// (tpufem_torch/fem/assembly.py::build_incidence, cut for this lane count:
// incidence_t). The element forces never reach device memory.
//
// What bounds it on the card: bytes. An apply reads the gradients (96 B per
// tet and lane in f64), volumes, ids, x and free once and writes y once; the
// arithmetic (about 180 flops per tet and lane) stays below that.
//
// Design: kernel D's incidence walk (csrc/incidence_walk.cuh) with the lane
// axis inside the block. Block b owns the node range [bnode[b], bnode[b+1])
// and walks its listed tets (btet[bt_start[b]:bt_start[b+1]]) as (tet, lane)
// pairs, the B lanes of one tet on consecutive threads: each (t,a,c) row of
// grads (B contiguous values), each x row of a node and vols[t,:] are read
// coalesced, and a tet's ids and CSR rows (pos) are one broadcast load for
// the lanes of a warp. A thread evaluates one (tet, lane) whole; each corner
// force whose node lies in the block's range goes to shared memory at
// (entry's CSR row, component, lane). After one barrier a thread per (node,
// component, lane) adds the node's rows in ascending order from zero and
// stores y. No atomics: two launches give the same bits. The plan's slots
// are cut so that a block's rows x 3 x B values fit 48 KB
// (fem/assembly.py::O_SMEM): four blocks an SM. Larger cuts evaluate each
// tet fewer times but leave fewer blocks to hide the barrier and the loads
// (at DOF100K B = 8 f64, flushed: 149.89 us at 48 KB, 180.72 at 96 KB,
// 298.10 at 192 KB on an H100 80GB HBM3 at 700 W); the block may ask for up
// to a Hopper block's 232,448 bytes, where a node's valence needs it.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tet4.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSmem = 232448;  // a Hopper block's most dynamic shared memory

template <typename T>
__global__ void __launch_bounds__(kThreads)
stiffness_apply_t_kernel(const T* __restrict__ grads, const T* __restrict__ vols,
                         const int32_t* __restrict__ tets, const int32_t* __restrict__ pos,
                         const int32_t* __restrict__ btet, const int32_t* __restrict__ bt_start,
                         const int32_t* __restrict__ bnode, const int32_t* __restrict__ starts,
                         const T* __restrict__ x, const T* __restrict__ free, T* __restrict__ y,
                         int B, T lam, T mu) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sh = reinterpret_cast<T*>(smem_raw);
  const int b = blockIdx.x;
  const int n0 = __ldg(bnode + b), n1 = __ldg(bnode + b + 1);
  const int row0 = __ldg(starts + n0);
  const int l0 = __ldg(bt_start + b);
  const int pairs = (__ldg(bt_start + b + 1) - l0) * B;
  const int B3 = 3 * B;
  for (int i = threadIdx.x; i < pairs; i += kThreads) {
    const int li = i / B, lane = i - li * B;
    const int t = __ldg(btet + l0 + li);
    const int4 ids = __ldg(reinterpret_cast<const int4*>(tets) + t);
    const int4 p4 = __ldg(reinterpret_cast<const int4*>(pos) + t);
    const int id[4] = {ids.x, ids.y, ids.z, ids.w};
    const int pp[4] = {p4.x, p4.y, p4.z, p4.w};
    const T* gp = grads + static_cast<int64_t>(t) * 12 * B + lane;
    T g[4][3], ue[4][3], s[3][3];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
#pragma unroll
      for (int c = 0; c < 3; ++c) g[a][c] = __ldg(gp + (a * 3 + c) * B);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const T* xp = x + static_cast<int64_t>(id[a]) * B3 + lane;
#pragma unroll
      for (int e = 0; e < 3; ++e) {
        ue[a][e] = __ldg(xp + e * B);
        if (free != nullptr) ue[a][e] *= __ldg(free + id[a] * 3 + e);
      }
    }
    const T vol = __ldg(vols + static_cast<int64_t>(t) * B + lane);
    tet4_stress(g, ue, lam, mu, s);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      if (id[a] >= n0 && id[a] < n1) {
        T* o = sh + (pp[a] - row0) * B3 + lane;
#pragma unroll
        for (int d = 0; d < 3; ++d) {
          o[d * B] = vol * (s[d][0] * g[a][0] + s[d][1] * g[a][1] + s[d][2] * g[a][2]);
        }
      }
    }
  }
  __syncthreads();
  const int nvals = (n1 - n0) * B3;
  for (int i = threadIdx.x; i < nvals; i += kThreads) {
    const int nl = i / B3, rem = i - nl * B3;
    const int r1 = __ldg(starts + n0 + nl + 1) - row0;
    T acc = 0;
    for (int r = __ldg(starts + n0 + nl) - row0; r < r1; ++r) acc += sh[r * B3 + rem];
    const int64_t o = static_cast<int64_t>(n0) * B3 + i;
    if (free != nullptr) {
      const T m = __ldg(free + (n0 + nl) * 3 + rem / B);
      y[o] = acc * m + __ldg(x + o) * (T(1) - m);
    } else {
      y[o] = acc;
    }
  }
}

template <typename T>
int launch(const void* grads, const void* vols, const void* tets, const void* pos,
           const void* btet, const void* bt_start, const void* bnode, const void* starts,
           const void* x, const void* free, void* y, int n_blocks, int slots, int B, double lam,
           double mu, void* stream) {
  const int bytes = slots * 3 * B * static_cast<int>(sizeof(T));
  if (bytes > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (n_blocks > 0) {
    static bool opted_in = false;  // once per dtype: the plan may ask for more than 48 KB
    if (!opted_in) {
      const cudaError_t e = cudaFuncSetAttribute(stiffness_apply_t_kernel<T>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 kMaxSmem);
      if (e != cudaSuccess) return static_cast<int>(e);
      opted_in = true;
    }
    stiffness_apply_t_kernel<T><<<n_blocks, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(grads), static_cast<const T*>(vols),
        static_cast<const int32_t*>(tets), static_cast<const int32_t*>(pos),
        static_cast<const int32_t*>(btet), static_cast<const int32_t*>(bt_start),
        static_cast<const int32_t*>(bnode), static_cast<const int32_t*>(starts),
        static_cast<const T*>(x), static_cast<const T*>(free), static_cast<T*>(y), B,
        static_cast<T>(lam), static_cast<T>(mu));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// grads (T,4,3,B), vols (T,B), tets (T,4) int32, x, y (N,3,B), free (N,3) or
// null, and the plan: pos (4T,), btet, bt_start (n_blocks+1,), bnode
// (n_blocks+1,), starts (N+1,), all int32, no block's range holding more than
// `slots` entries, slots x 3 x B values within a Hopper block's 232,448 bytes
// of shared memory; all contiguous on the device, tets and pos 16-byte
// aligned, the float tensors of one dtype. The plan's values are trusted.
// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue where
// the slots do not fit).
extern "C" int tpufem_stiffness_apply_t_f32(
    const void* grads, const void* vols, const void* tets, const void* pos, const void* btet,
    const void* bt_start, const void* bnode, const void* starts, const void* x, const void* free,
    void* y, int n_blocks, int slots, int B, double lam, double mu, void* stream) {
  return launch<float>(grads, vols, tets, pos, btet, bt_start, bnode, starts, x, free, y,
                       n_blocks, slots, B, lam, mu, stream);
}

extern "C" int tpufem_stiffness_apply_t_f64(
    const void* grads, const void* vols, const void* tets, const void* pos, const void* btet,
    const void* bt_start, const void* bnode, const void* starts, const void* x, const void* free,
    void* y, int n_blocks, int slots, int B, double lam, double mu, void* stream) {
  return launch<double>(grads, vols, tets, pos, btet, bt_start, bnode, starts, x, free, y,
                        n_blocks, slots, B, lam, mu, stream);
}
