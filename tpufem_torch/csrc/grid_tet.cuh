// The structured wing grid's cell layout, shared by kernels B (strain_apply),
// F (element_stress), G (geom_apply), H (stvk_force), I (stvk_tangent), J
// (stvk_energy) and K (strain_geo_vjp).
//
// Every hex cell (ci, ck, cj) of the grid is cut into the 6 Kuhn tets of the
// unit hex. Hex corner q = 0..7 sits at node (ci + corner_di(q), ck +
// corner_dk(q), cj + corner_dj(q)): corners 0-3 on the cell's lower node layer,
// q and q + 4 above one another. Weld rows (i = 0, the leading edge, and i =
// NI - 1, the trailing edge when weld_te) are one node through the thickness:
// every thickness node there reads and writes the k = 0 node.
//
// Must match tpufem_torch/mesher.py::_KUHN_TETS and ::_HEX_CORNERS.

#pragma once

#include <cuda_runtime.h>

namespace grid_tet {

// Corner a = 0..3 of Kuhn tet t = 0..5, as a hex corner. With t and a known
// at compile time (unrolled loops) the lookup folds to a constant.
__device__ __forceinline__ int kuhn(int t, int a) {
  constexpr int k[6][4] = {{0, 1, 2, 6}, {0, 2, 3, 6}, {0, 3, 7, 6},
                           {0, 7, 4, 6}, {0, 4, 5, 6}, {0, 5, 1, 6}};
  return k[t][a];
}

// The same for a t known only at run time (a thread per tet, kernels J and
// K): corners 0 and 6 are every tet's, corners 1 and 2 walk the cycle 1 2 3 7
// 4 5 around the 0-6 diagonal (nibble n of kCycle is its n-th corner, the
// first repeated at n = 6). With a known at compile time it is one shift.
__device__ __forceinline__ int kuhn_rt(int t, int a) {
  constexpr unsigned kCycle = 0x1547321u;
  return a == 0 ? 0 : a == 3 ? 6 : static_cast<int>((kCycle >> (4 * (t + a - 1))) & 15u);
}

__device__ __forceinline__ int corner_di(int q) { return (q & 3) == 1 || (q & 3) == 2; }
__device__ __forceinline__ int corner_dj(int q) { return (q & 3) >= 2; }
__device__ __forceinline__ int corner_dk(int q) { return q >= 4; }

__device__ __forceinline__ bool weld_row(int i, int NI, int weld_te) {
  return i == 0 || (weld_te && i == NI - 1);
}

// The node layer a field is read from at node (i, k): k = 0 on weld rows
// (the weld spread)
__device__ __forceinline__ int weld_k(int i, int k, int NI, int weld_te) {
  return weld_row(i, NI, weld_te) ? 0 : k;
}

// The value stored at a node whose summed force is f: masked by the root mask
// fr and, with the Dirichlet identity, plus u * (1 - fr), u the node's value
// of the field the identity stores
template <bool kIdentity, typename T>
__device__ __forceinline__ T masked_store(T f, T fr, T u) {
  return kIdentity ? f * fr + u * (T(1) - fr) : f * fr;
}

// The SMs of the current device, asked once per process (one kind of card)
inline int sm_count() {
  static const int n = [] {
    int dev = 0, v = 1;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev);
    return v;
  }();
  return n;
}

}  // namespace grid_tet
