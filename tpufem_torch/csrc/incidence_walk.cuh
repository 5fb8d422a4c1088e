// The incidence walk of kernels D (csrc/tet4_force.cu) and N
// (csrc/tet10_force.cu): a matrix-free operator apply over tets of K nodes in
// one launch, each node's sum in a fixed order inside one block.
//
// The nodes are cut into contiguous ranges of at most `slots` incident (tet,
// node) entries, one range per block (tpufem_torch/fem/assembly.py::
// build_incidence, built once per topology on the host): block b owns the
// nodes [bnode[b], bnode[b+1]), whose entries are the CSR rows
// [starts[bnode[b]], starts[bnode[b+1]]) of the stable argsort of
// tets.reshape(-1), and evaluates the tets that touch them
// (btet[bt_start[b]:bt_start[b+1]], ascending), a thread one tet at a time.
// The element body writes each force of a node in the block's range to shared
// memory at its entry's CSR row (pos[t*K+m]). After one barrier a thread per
// (node, component) adds the node's rows in ascending order from zero and
// stores
//
//   y = (K u) * free + x * (1 - free)          (free == nullptr: y = K u).
//
// No atomics: two launches give the same bits. A tet on a range boundary is
// evaluated by every block it touches (the plan's `overlap`); a node that no
// tet touches gets y = x * (1 - free). Indices are 32-bit (the wrappers check
// K T and 3 N).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace incidence {

constexpr int kThreads = 256;

// the plan's device arrays, all int32
struct Plan {
  const int32_t* pos;       // (K T,) the CSR row of entry (t, m)
  const int32_t* btet;      // the tets each block evaluates, ascending per block
  const int32_t* bt_start;  // (n_blocks+1,)
  const int32_t* bnode;     // (n_blocks+1,) the blocks' node ranges
  const int32_t* starts;    // (N+1,) the nodes' CSR rows
};

// The node range [n0, n1) a block owns and the shared memory its entries'
// forces go to (3 values a CSR row, less the block's first row0)
template <typename T, int K>
struct Block {
  int n0, n1, row0;
  T* sh;
  const int32_t* pos;

  __device__ __forceinline__ bool owns(int node) const { return node >= n0 && node < n1; }
  // the forces of the entry at CSR row `row`
  __device__ __forceinline__ T* at_row(int row) const { return sh + (row - row0) * 3; }
  // the forces of entry (t, m)
  __device__ __forceinline__ T* at(int t, int m) const { return at_row(__ldg(pos + t * K + m)); }
};

// The dynamic shared memory of a block of `slots` entries: at most 48 KB in
// f64 at the plan's cap of 2048, what a block gets without asking
template <typename T>
inline int smem_bytes(int slots) {
  return slots * 3 * static_cast<int>(sizeof(T));
}

// One block's apply: body(t, blk) for each tet t the block lists, then the
// ordered per-node sums and the Dirichlet identity into y
template <int K, typename T, typename Body>
__device__ __forceinline__ void walk(const Plan& p, const T* __restrict__ x,
                                     const T* __restrict__ free, T* __restrict__ y,
                                     Body&& body) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int b = blockIdx.x;
  const int n0 = __ldg(p.bnode + b), n1 = __ldg(p.bnode + b + 1);
  const Block<T, K> blk{n0, n1, __ldg(p.starts + n0), reinterpret_cast<T*>(smem_raw), p.pos};
  const int l1 = __ldg(p.bt_start + b + 1);
  for (int l = __ldg(p.bt_start + b) + threadIdx.x; l < l1; l += kThreads)
    body(__ldg(p.btet + l), blk);
  __syncthreads();
  const int nvals = (n1 - n0) * 3;
  for (int i = threadIdx.x; i < nvals; i += kThreads) {
    const int nl = i / 3, c = i - nl * 3;
    const int r1 = __ldg(p.starts + n0 + nl + 1) - blk.row0;
    T acc = 0;
    for (int r = __ldg(p.starts + n0 + nl) - blk.row0; r < r1; ++r) acc += blk.sh[r * 3 + c];
    const int o = n0 * 3 + i;
    if (free != nullptr) {
      const T m = __ldg(free + o);
      y[o] = acc * m + __ldg(x + o) * (T(1) - m);
    } else {
      y[o] = acc;
    }
  }
}

}  // namespace incidence
