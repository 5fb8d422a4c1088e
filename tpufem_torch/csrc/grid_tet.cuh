// The structured wing grid's cell layout, shared by kernels B (strain_apply),
// F (element_stress), G (geom_apply), H (stvk_force) and I (stvk_tangent).
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

namespace grid_tet {

// Corner a = 0..3 of Kuhn tet t = 0..5, as a hex corner. With t and a known
// at compile time (unrolled loops) the lookup folds to a constant.
__device__ __forceinline__ int kuhn(int t, int a) {
  constexpr int k[6][4] = {{0, 1, 2, 6}, {0, 2, 3, 6}, {0, 3, 7, 6},
                           {0, 7, 4, 6}, {0, 4, 5, 6}, {0, 5, 1, 6}};
  return k[t][a];
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

}  // namespace grid_tet
