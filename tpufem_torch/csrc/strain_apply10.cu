// Kernel L: the welded, Dirichlet-wrapped tet10 (quadratic) operator on the
// doubled structured wing grid, one launch per operator apply.
//
// Replaces tpufem/fem/tet10_stencil.py:233 strain_apply10 (jnp code that XLA
// fused on the TPU; the operator every tet10 p-multigrid CG iteration applies
// once and every V-cycle 4 times). One launch computes the whole function
//
//   y = R2( K10( S2(u * free) ) ) * free + u * (1 - free)
//
// on the doubled grid (NI2, NK2, NJ2) = (2 NI - 1, 2 NK - 1, 2 NJ - 1): every
// tet10 node is a position of it, a tet4 corner at all-even indices and the
// midpoint of one Kuhn-lattice edge elsewhere. S2 (weld spread) and the root
// mask `free` (an NJ2 vector) are applied as u is loaded, R2 (weld reduce),
// the mask and the Dirichlet identity as y is stored. The welds: the leading
// edge column i2 = 0 is one node through the thickness (k2 = 0), the pairs at
// i2 = 1 merge (odd k2 into k2 + 1), and with weld_te the same at i2 = NI2 - 1
// and i2 = NI2 - 2 (odd k2 into k2 - 1). K10 is, per Kuhn tet t of every cell
// and Gauss point q (equal weights vol / 4),
//
//   v_j = sum_m DNDXI[q][m][j] u_m,  H = sum_j grad(lambda_j) (x) v_j,
//   sigma = 2 mu eps(H) + lam tr(eps) I,  s_j = (vol / 4) sigma . grad(lambda_j),
//   f_m += sum_j DNDXI[q][m][j] s_j
//
// over the tet's 10 nodes m, from the per-tet gradients g (6,4,3,B,nc,nt,ns)
// (grad lambda_1..3 are g[t, 1..3]), volumes vol (6,B,nc,nt,ns) and u, y
// (3,B,NI2,NK2,NJ2), all contiguous, in tpufem's layouts.
//
// The bound: bytes (u, g[:, 1:], vol read once, y written once) and ~1,500
// flops per Kuhn tet (the nonzero DNDXI terms) are about equal at the
// flagship (f64 ~26 us each at 3.35 TB/s and 34 TFLOP/s), so the design
// spends no flop twice:
//
// - DNDXI is a compile-time table (every use is a constant expression), so the
//   48 % of its entries that are exactly 0.0 drop out of both contractions and
//   the others are immediates.
// - Cell-owning tiles: a block owns TI x TJ cells (chord x span) of one lane
//   at full thickness and evaluates each of their tets once; no cell is
//   computed by two blocks. Two threads per cell, tets 0-2 and 3-5, each with
//   one tet's state in registers at a time (v for the 4 Gauss points, then s
//   in its place, then one node force at a time), its nodes loaded in four
//   groups: 128 registers in f64 with no spill, so two 256-thread blocks give
//   an SM 16 warps (f32: three blocks).
// - Each thread adds its tets' node forces into its own shared slots: the 18
//   positions its 3 tets touch (9 of a cell's 27 positions are touched by
//   both halves and so have two slots), 108 values a cell. One barrier, then
//   each (virtual) cell v of the tile's closure sums the positions it owns, 2
//   v + {0, 1}^3, from the slots of their <= 8 cells in a fixed order (cells
//   low before high along i, k, j; half 0 before half 1; every slot index a
//   constant) and finishes them: mask and identity, and stores them.
// - R2 sums along k on the weld rows (i2 = 0, 1 and, welded, NI2 - 2, NI2 -
//   1): a weld-row position goes through the tile's weld rows in `partial`,
//   summed after a barrier. A position on a face shared with a neighbouring
//   tile is stored as a partial (`partial`, per tile and rim column); then a
//   thread per tile takes the ticket of each tile whose shared faces this one
//   adds to, and the block that takes the last one sums that tile's shared
//   columns from the partials of its <= 4 tiles in tile order (a barrier and
//   a fence before the tickets, a fence and .cg loads after them) and stores
//   them. A column's owner is the last tile along i and then j whose closure
//   holds it: tile (by, bx) owns its low-i face (by > 0) and low-j face (bx >
//   0). The last block resets the ticket, so `ticket` is 0 between calls.
//
// No atomics on values: every position's sum has one order, so two calls give
// the same bits. The tile (TI, TJ) is the caller's choice
// (tpufem_torch/fem/tet10_stencil.py::l_plan); the launch checks that its
// shared memory fits. Every index is 32-bit; the wrapper checks that every
// operand has fewer than 2^31 elements.

#include <cuda_runtime.h>
#include <stddef.h>

#include <type_traits>
#include <utility>

#include "grid_tet.cuh"

namespace {

using grid_tet::corner_di;
using grid_tet::corner_dj;
using grid_tet::corner_dk;

// DNDXI[q][m][j], the shape-function gradients at the Gauss points
// (tpufem_torch/fem/tet10.py::DNDXI)
#define TPUFEM_DNDXI                                                                           \
  {{{-1.341640786499874, -1.341640786499874, -1.341640786499874},                             \
    {-0.44721359549995787, 0.0, 0.0},                                                          \
    {0.0, -0.44721359549995787, 0.0},                                                          \
    {0.0, 0.0, -0.44721359549995787},                                                          \
    {1.788854381999832, -0.5527864045000421, -0.5527864045000421},                             \
    {0.5527864045000421, 0.5527864045000421, 0.0},                                             \
    {-0.5527864045000421, 1.788854381999832, -0.5527864045000421},                             \
    {-0.5527864045000421, -0.5527864045000421, 1.788854381999832},                             \
    {0.5527864045000421, 0.0, 0.5527864045000421},                                             \
    {0.0, 0.5527864045000421, 0.5527864045000421}},                                            \
   {{0.44721359549995787, 0.44721359549995787, 0.44721359549995787},                           \
    {1.341640786499874, 0.0, 0.0},                                                             \
    {0.0, -0.44721359549995787, 0.0},                                                          \
    {0.0, 0.0, -0.44721359549995787},                                                          \
    {-1.788854381999832, -2.341640786499874, -2.341640786499874},                              \
    {0.5527864045000421, 2.341640786499874, 0.0},                                              \
    {-0.5527864045000421, 0.0, -0.5527864045000421},                                           \
    {-0.5527864045000421, -0.5527864045000421, 0.0},                                           \
    {0.5527864045000421, 0.0, 2.341640786499874},                                              \
    {0.0, 0.5527864045000421, 0.5527864045000421}},                                            \
   {{0.44721359549995787, 0.44721359549995787, 0.44721359549995787},                           \
    {-0.44721359549995787, 0.0, 0.0},                                                          \
    {0.0, 1.341640786499874, 0.0},                                                             \
    {0.0, 0.0, -0.44721359549995787},                                                          \
    {0.0, -0.5527864045000421, -0.5527864045000421},                                           \
    {2.341640786499874, 0.5527864045000421, 0.0},                                              \
    {-2.341640786499874, -1.788854381999832, -2.341640786499874},                              \
    {-0.5527864045000421, -0.5527864045000421, 0.0},                                           \
    {0.5527864045000421, 0.0, 0.5527864045000421},                                             \
    {0.0, 0.5527864045000421, 2.341640786499874}},                                             \
   {{0.44721359549995787, 0.44721359549995787, 0.44721359549995787},                           \
    {-0.44721359549995787, 0.0, 0.0},                                                          \
    {0.0, -0.44721359549995787, 0.0},                                                          \
    {0.0, 0.0, 1.341640786499874},                                                             \
    {0.0, -0.5527864045000421, -0.5527864045000421},                                           \
    {0.5527864045000421, 0.5527864045000421, 0.0},                                             \
    {-0.5527864045000421, 0.0, -0.5527864045000421},                                           \
    {-2.341640786499874, -2.341640786499874, -1.788854381999832},                              \
    {2.341640786499874, 0.0, 0.5527864045000421},                                              \
    {0.0, 2.341640786499874, 0.5527864045000421}}}

// DNDXI[q][m][j] as a constant expression (called only with constant indices)
__host__ __device__ constexpr double dndxi(int q, int m, int j) {
  constexpr double kTable[4][10][3] = TPUFEM_DNDXI;
  return kTable[q][m][j];
}

// f(integral_constant<int, 0>), ..., f(integral_constant<int, N - 1>): a loop
// whose index is a constant expression in the body
template <typename F, int... I>
__device__ __forceinline__ void static_for_(F&& f, std::integer_sequence<int, I...>) {
  (f(std::integral_constant<int, I>{}), ...);
}
template <int N, typename F>
__device__ __forceinline__ void static_for(F&& f) {
  static_for_(f, std::make_integer_sequence<int, N>{});
}

// A cell's force slots: tets 0-2 (half 0) add into slots 0-17, tets 3-5 (half
// 1) into 18-35. kPosSlot[h][o] is half h's slot of cell-local position o
// (-1 where its tets have no node), kTetSlot[t][m] the slot of node m of tet
// t; o packs the doubled offset (oi, ok, oj) in {0, 1, 2}^3 as (oi * 3 + ok)
// * 3 + oj (tpufem_torch/fem/tet10_stencil.py::_NODE_POS; the tables are held
// to it by tests/test_torch_tet10_kernels_host.py).
constexpr int kSlots = 36;
#define TPUFEM_L_POS_SLOT                                                                      \
  {{0, 1, 2, -1, 3, 4, -1, -1, 5, 6, 7, 8, -1, 9, 10, -1, -1, 11, 12, 13, 14, -1, 15, 16, -1,   \
    -1, 17},                                                                                   \
   {18, -1, -1, 19, 20, -1, 21, 22, 23, 24, -1, -1, 25, 26, -1, 27, 28, 29, 30, -1, -1, 31, 32, \
    -1, 33, 34, 35}}
#define TPUFEM_L_TET_SLOT                                                                      \
  {{0, 12, 14, 17, 6, 13, 7, 9, 15, 16},                                                       \
   {0, 14, 2, 17, 7, 8, 1, 9, 16, 10},                                                         \
   {0, 2, 5, 17, 1, 4, 3, 9, 10, 11},                                                          \
   {18, 23, 21, 35, 20, 22, 19, 26, 29, 28},                                                   \
   {18, 21, 33, 35, 19, 27, 25, 26, 28, 34},                                                   \
   {18, 33, 30, 35, 25, 31, 24, 26, 34, 32}}
__constant__ int kTetSlot[6][10] = TPUFEM_L_TET_SLOT;

// kPosSlot[h][o] as a constant expression (called only with constant indices)
__host__ __device__ constexpr int pos_slot(int h, int o) {
  constexpr int kPosSlot[2][27] = TPUFEM_L_POS_SLOT;
  return kPosSlot[h][o];
}

// The tet10 node m of Kuhn tet t as its cell-local doubled offset o: corners
// m = 0..3 at twice their hex corner, midsides m = 4..9 at the sum of their
// edge's two corners (edges (0,1), (1,2), (2,0), (0,3), (1,3), (2,3):
// tet10.py::_EDGES). t is known at run time (a loop over a thread's 3 tets),
// m at compile time.
__device__ __forceinline__ int pos27(int t, int m) {
  constexpr int ea[6] = {0, 1, 2, 0, 1, 2}, eb[6] = {1, 2, 0, 3, 3, 3};
  const int ca = grid_tet::kuhn_rt(t, m < 4 ? m : ea[m - 4]);
  const int cb = grid_tet::kuhn_rt(t, m < 4 ? m : eb[m - 4]);
  return ((corner_di(ca) + corner_di(cb)) * 3 + corner_dk(ca) + corner_dk(cb)) * 3 +
         corner_dj(ca) + corner_dj(cb);
}

// The layer a field is read from at doubled position (i2, k2): the weld spread S2
__device__ __forceinline__ int weld_k2(int i2, int k2, int NI2, int weld_te) {
  if (i2 == 0 || (weld_te && i2 == NI2 - 1)) return 0;
  if (i2 == 1 && (k2 & 1)) return k2 + 1;
  if (weld_te && i2 == NI2 - 2 && (k2 & 1)) return k2 - 1;
  return k2;
}

// R2: the contiguous run of layers [*lo, *hi] whose sums land at doubled
// position (i2, k2) (empty, hi < lo, where the position is a weld duplicate)
__device__ __forceinline__ void weld_run(int i2, int k2, int NI2, int NK2, int weld_te, int* lo,
                                         int* hi) {
  *lo = *hi = k2;
  if (i2 == 0 || (weld_te && i2 == NI2 - 1)) {
    *hi = k2 == 0 ? NK2 - 1 : -1;  // the column's sum at k2 = 0, zero above
  } else if (i2 == 1) {
    if (k2 & 1) *hi = -1;  // merged into k2 + 1
    else if (k2 > 0) *lo = k2 - 1;
  } else if (weld_te && i2 == NI2 - 2) {
    if (k2 & 1) *hi = -1;  // merged into k2 - 1
    else if (k2 < NK2 - 1) *hi = k2 + 1;
  }
}

template <typename T>
struct Args {
  const T* g;
  const T* vol;
  const T* u;
  const T* free;
  T* y;
  T* partial;        // [tile][column: rim, weld rows][3][NK2], tile = (b * tI + by) * tJ + bx
  unsigned* ticket;  // [tile], 0 between calls
  int B, NI2, NK2, NJ2, weld_te;
  int TI, TJ;        // the tile, in cells along chord and span
  T lam, mu;
};

constexpr int kThreads = 256;
constexpr int kCells = kThreads / 2;  // the most cells a tile holds
// the most dynamic shared memory a block may ask for: a Hopper block's 232,448
// bytes less 1 KB for its static shared memory
constexpr int kMaxSmem = 232448 - 1024;
// 2 blocks of 256 threads per SM in f64 (<= 128 registers), 3 in f32 (<= 85)
template <typename T>
constexpr int kMinBlocks = sizeof(T) == 8 ? 2 : 3;

template <typename T>
constexpr size_t smem_bytes(int TI, int TJ, int nt) {
  return static_cast<size_t>(kSlots) * 3 * TI * TJ * nt * sizeof(T);
}

// The tile's closure column (li2, lj2) on its rim, as a rim index: the low-i
// row, the high-i row, then the low-j and high-j columns between them
__device__ __forceinline__ int rim_index(int li2, int lj2, int ti, int tj, int TI, int TJ) {
  if (li2 == 0) return lj2;
  if (li2 == 2 * ti) return 2 * TJ + 1 + lj2;
  if (lj2 == 0) return 2 * (2 * TJ + 1) + li2 - 1;
  return 2 * (2 * TJ + 1) + 2 * TI - 1 + li2 - 1;
}
// A tile's partial columns: its rim, then (tiles at a welded edge) its weld
// rows li2 = 0, 1, 2 ti - 1, 2 ti, each 2 TJ + 1 columns, for R2 in the tile
__host__ __device__ constexpr int rim_size(int TI, int TJ) { return 4 * (TI + TJ); }
__host__ __device__ constexpr int partial_columns(int TI, int TJ) {
  return rim_size(TI, TJ) + 4 * (2 * TJ + 1);
}

// Nodes M0..M1-1 of tet t: their displacements (the weld spread S2 and the
// root mask applied) loaded at once, then their DNDXI terms added into v in
// node order
template <int M0, int M1, typename T>
__device__ __forceinline__ void add_nodes(const Args<T>& p, int t, int b, int ci, int ck, int cj,
                                          T (&v)[4][3][3]) {
  const int NK2 = p.NK2, NJ2 = p.NJ2;
  const int uplane = p.NI2 * NK2 * NJ2, ustride = p.B * uplane;
  const T* ub = p.u + b * uplane;
  T un[M1 - M0][3];
  static_for<M1 - M0>([&](auto ic) {
    constexpr int i = decltype(ic)::value;
    const int o = pos27(t, M0 + i);
    const int i2 = 2 * ci + o / 9, k2 = 2 * ck + (o / 3) % 3, j2 = 2 * cj + o % 3;
    const int node = (i2 * NK2 + weld_k2(i2, k2, p.NI2, p.weld_te)) * NJ2 + j2;
    const T fr = __ldg(p.free + j2);
#pragma unroll
    for (int e = 0; e < 3; ++e) un[i][e] = __ldg(ub + e * ustride + node) * fr;
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

// One tet of the thread's cell: its node forces added into the thread's slots
// sc[(slot * 3 + d) * ncell]. v[q][j][e] = sum_m DNDXI[q][m][j] u_m[e] in m
// order, the nodes loaded in four groups (3, 3, 2, 2): four round trips to
// memory where a node at a time took ten, and at most 9 loaded values live
// beside the 36 sums, so f64 fits 128 registers without a spill
template <typename T>
__device__ __forceinline__ void tet_forces(const Args<T>& p, int t, int b, int cell, int cplane,
                                           int ci, int ck, int cj, T* sc, int ncell) {
  T v[4][3][3];
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int j = 0; j < 3; ++j)
#pragma unroll
      for (int e = 0; e < 3; ++e) v[q][j][e] = T(0);
  add_nodes<0, 3>(p, t, b, ci, ck, cj, v);
  add_nodes<3, 6>(p, t, b, ci, ck, cj, v);
  add_nodes<6, 8>(p, t, b, ci, ck, cj, v);
  add_nodes<8, 10>(p, t, b, ci, ck, cj, v);
  T gv[3][3];  // grad lambda_1..3
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int d = 0; d < 3; ++d)
      gv[a][d] = __ldg(p.g + ((((t * 4 + a + 1) * 3 + d) * p.B + b) * cplane) + cell);
  const T wq = T(0.25) * __ldg(p.vol + (t * p.B + b) * cplane + cell);
  // per Gauss point: H, the weighted stress in its place, then s[j][d] = wq
  // sum_e sigma[d][e] grad(lambda_j)[e] over v[q]: 9 values live beside v and
  // the gradients
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    T w[3][3];
#pragma unroll
    for (int d = 0; d < 3; ++d)
#pragma unroll
      for (int e = 0; e < 3; ++e)
        w[d][e] = gv[0][d] * v[q][0][e] + gv[1][d] * v[q][1][e] + gv[2][d] * v[q][2][e];
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
        v[q][j][d] = w[d][0] * gv[j][0] + w[d][1] * gv[j][1] + w[d][2] * gv[j][2];
  }
  // f_m[d] = sum_q sum_j DNDXI[q][m][j] s_q[j][d], one node at a time, into its slot
  static_for<10>([&](auto mc) {
    constexpr int m = decltype(mc)::value;
    T* sm = sc + kTetSlot[t][m] * 3 * ncell;
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      T f = T(0);
      static_for<4>([&](auto qc) {
        constexpr int q = decltype(qc)::value;
        constexpr double c0 = dndxi(q, m, 0), c1 = dndxi(q, m, 1), c2 = dndxi(q, m, 2);
        if constexpr (c0 != 0.0 || c1 != 0.0 || c2 != 0.0) {
          T part = T(0);
          if constexpr (c0 != 0.0) part = T(c0) * v[q][0][d];
          if constexpr (c1 != 0.0) part = c0 != 0.0 ? part + T(c1) * v[q][1][d] : T(c1) * v[q][1][d];
          if constexpr (c2 != 0.0)
            part = c0 != 0.0 || c1 != 0.0 ? part + T(c2) * v[q][2][d] : T(c2) * v[q][2][d];
          f += part;
        }
      });
      sm[d * ncell] += f;
    }
  });
}

// One dimension of a position the (virtual) cell v owns, at offset O in {0,
// 1} from the cell's origin 2 v: its contributing cells, alternative A = 0
// the cell below (v - 1, where the position is at its offset 2; only at O =
// 0) and A = 1 the cell v itself (at offset O)
template <int O, int A>
struct Side {
  static constexpr bool kExists = O == 0 || A == 1;
  static constexpr int kDelta = A == 0 ? -1 : 0;
  static constexpr int kOff = O == 1 ? 1 : (A == 0 ? 2 : 0);
};

// The tile's sum at position 2 (vi, vk, vj) + (OI, OK, OJ), which the
// (virtual) cell (vi, vk, vj) of the closure owns: the slots of its <= 8
// incident cells of the tile, cells low before high along i, then k, then j,
// each cell half 0 then half 1; every slot index a constant
template <int OI, int OK, int OJ, typename T>
__device__ __forceinline__ void owned_sum(const T* sf, int ncell, int vi, int vk, int vj, int ti,
                                          int nt, int tj, T (&f)[3]) {
  static_for<2>([&](auto ai) {
    using SI = Side<OI, decltype(ai)::value>;
    static_for<2>([&](auto ak) {
      using SK = Side<OK, decltype(ak)::value>;
      static_for<2>([&](auto aj) {
        using SJ = Side<OJ, decltype(aj)::value>;
        if constexpr (SI::kExists && SK::kExists && SJ::kExists) {
          const int ci = vi + SI::kDelta, ck = vk + SK::kDelta, cj = vj + SJ::kDelta;
          if (ci >= 0 && ci < ti && ck >= 0 && ck < nt && cj >= 0 && cj < tj) {
            const int c = (ci * nt + ck) * tj + cj;
            constexpr int o = (SI::kOff * 3 + SK::kOff) * 3 + SJ::kOff;
            constexpr int s0 = pos_slot(0, o), s1 = pos_slot(1, o);
#pragma unroll
            for (int e = 0; e < 3; ++e) {
              if constexpr (s0 >= 0 && s1 >= 0)
                f[e] += sf[(s0 * 3 + e) * ncell + c] + sf[(s1 * 3 + e) * ncell + c];
              else
                f[e] += sf[((s0 >= 0 ? s0 : s1) * 3 + e) * ncell + c];
            }
          }
        }
      });
    });
  });
}

// The finished value at doubled position (i2, k2, j2) of lane b whose summed
// force is f and displacement u: the mask and the Dirichlet identity
template <typename T>
__device__ __forceinline__ void store(const Args<T>& p, int node, int ustride, int j2,
                                      const T (&f)[3], const T (&u)[3]) {
  const T fr = __ldg(p.free + j2);
#pragma unroll
  for (int e = 0; e < 3; ++e) p.y[e * ustride + node] = grid_tet::masked_store<true>(f[e], fr, u[e]);
}

// u at a node, for the identity: loaded before the sums it is stored with
template <typename T>
__device__ __forceinline__ void load_u(const Args<T>& p, int node, int ustride, T (&u)[3]) {
#pragma unroll
  for (int e = 0; e < 3; ++e) u[e] = __ldg(p.u + e * ustride + node);
}

// Tile (byT, bxT)'s shared columns (its low-i face when byT > 0, its low-j
// face when bxT > 0), summed from the partials of the <= 4 tiles whose
// closures hold them, in tile order, with R2, and stored. A position's <= 12
// partial loads are issued together.
template <typename T>
__device__ void finish_shared(const Args<T>& p, int b, int byT, int bxT, int tI, int tJ, int nc,
                              int ns) {
  const int NK2 = p.NK2, TI = p.TI, TJ = p.TJ, P = partial_columns(TI, TJ);
  const int uplane = p.NI2 * NK2 * p.NJ2, ustride = p.B * uplane;
  const int i2T = 2 * byT * TI, j2T = 2 * bxT * TJ;
  const int nA = byT > 0 ? (bxT == tJ - 1 ? 2 * ns - j2T + 1 : 2 * TJ) : 0;
  const int iB0 = i2T + (byT > 0 ? 1 : 0);
  const int nB = bxT > 0 ? (byT == tI - 1 ? 2 * nc + 1 : i2T + 2 * TI) - iB0 : 0;
  for (int n = threadIdx.x; n < (nA + nB) * NK2; n += kThreads) {
    const int col = n / NK2, k2 = n % NK2;
    const int i2 = col < nA ? i2T : iB0 + col - nA;
    const int j2 = col < nA ? j2T + col : j2T;
    const int node = b * uplane + (i2 * NK2 + k2) * p.NJ2 + j2;
    T u[3];
    load_u(p, node, ustride, u);
    // contributor q = (dy, dx): tile (byT - 1 + dy, bxT - 1 + dx)
    const T* pp[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int cy = byT - 1 + (q >> 1), cx = bxT - 1 + (q & 1);
      const bool in = (q >> 1 || (i2 == i2T && byT > 0)) && (q & 1 || (j2 == j2T && bxT > 0));
      const int ti = min(TI, nc - cy * TI), tj = min(TJ, ns - cx * TJ);
      pp[q] = in ? p.partial +
                       ((((b * tI + cy) * tJ + cx) * P +
                         rim_index(i2 - 2 * cy * TI, j2 - 2 * cx * TJ, ti, tj, TI, TJ)) * 3) * NK2
                 : nullptr;
    }
    int lo, hi;
    weld_run(i2, k2, p.NI2, NK2, p.weld_te, &lo, &hi);
    T f[3] = {T(0), T(0), T(0)};
    for (int kk = lo; kk <= hi; ++kk) {
      T v[4][3];
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int e = 0; e < 3; ++e) v[q][e] = pp[q] ? __ldcg(pp[q] + e * NK2 + kk) : T(0);
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int e = 0; e < 3; ++e)
          if (pp[q]) f[e] += v[q][e];
    }
    store(p, node, ustride, j2, f, u);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, kMinBlocks<T>) strain_apply10_kernel(Args<T> p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sf = reinterpret_cast<T*>(smem_raw);  // [slot 36][3][ncell]; then the closure's sums
  __shared__ int finish;  // bit s: this block took the last ticket of tile s (below)

  const int NI2 = p.NI2, NK2 = p.NK2;
  const int nc = (NI2 - 1) / 2, nt = (NK2 - 1) / 2, ns = (p.NJ2 - 1) / 2;
  const int TI = p.TI, TJ = p.TJ, tI = gridDim.y, tJ = gridDim.x;
  const int cplane = nc * nt * ns;
  const int b = blockIdx.z, by = blockIdx.y, bx = blockIdx.x;
  const int ci0 = by * TI, cj0 = bx * TJ;
  const int ti = min(TI, nc - ci0), tj = min(TJ, ns - cj0);
  const int ncell = ti * nt * tj;  // cell c = (li * nt + ck) * tj + lj

  // ---- every tet of the tile once: thread (half h, cell c) takes tets 3h..3h+2
  {
    const int h = threadIdx.x / kCells, c = threadIdx.x % kCells;
    if (c < ncell) {
      T* sc = sf + c;
#pragma unroll 6
      for (int s = 18 * h; s < 18 * h + 18; ++s)
#pragma unroll
        for (int d = 0; d < 3; ++d) sc[(s * 3 + d) * ncell] = T(0);
      const int lj = c % tj, r = c / tj;
      const int ck = r % nt, ci = ci0 + r / nt, cj = cj0 + lj;
      const int cell = (ci * nt + ck) * ns + cj;
#pragma unroll 1
      for (int t = 3 * h; t < 3 * h + 3; ++t)
        tet_forces<T>(p, t, b, cell, cplane, ci, ck, cj, sc, ncell);
    }
  }
  __syncthreads();

  // ---- every position of the tile's closure, by the (virtual) cell that owns
  // it, 2 v + {0, 1}^3: a position no other tile holds is finished and stored,
  // a shared one stored as a partial, and one of a weld row that R2 sums
  // along k (li2 = 0, 1 at the leading edge; 2 ti - 1, 2 ti at a welded
  // trailing edge) stored in the tile's weld rows for the pass below
  const int uplane = NI2 * NK2 * p.NJ2, ustride = p.B * uplane;
  const int P = partial_columns(TI, TJ), tile = (b * tI + by) * tJ + bx;
  T* const pt = p.partial + tile * P * 3 * NK2;  // [column][3][NK2]
  const bool le = by == 0, te = p.weld_te && by == tI - 1;
  const int vtj = tj + 1, nv = (ti + 1) * (nt + 1) * vtj;
  for (int v = threadIdx.x; v < nv; v += kThreads) {
    const int vj = v % vtj, vk = (v / vtj) % (nt + 1), vi = v / (vtj * (nt + 1));
    static_for<8>([&](auto oc) {
      constexpr int o = decltype(oc)::value, OI = o >> 2, OK = (o >> 1) & 1, OJ = o & 1;
      if ((OI == 0 || vi < ti) && (OK == 0 || vk < nt) && (OJ == 0 || vj < tj)) {
        const int li2 = 2 * vi + OI, k2 = 2 * vk + OK, lj2 = 2 * vj + OJ;
        const int i2 = 2 * ci0 + li2, j2 = 2 * cj0 + lj2;
        const bool shared = (li2 == 0 && by > 0) || (li2 == 2 * ti && by < tI - 1) ||
                            (lj2 == 0 && bx > 0) || (lj2 == 2 * tj && bx < tJ - 1);
        const int wrow = le && li2 <= 1 ? li2 : te && li2 >= 2 * ti - 1 ? li2 - 2 * ti + 3 : -1;
        const int node = b * uplane + (i2 * NK2 + k2) * p.NJ2 + j2;
        T u[3];
        if (!shared && wrow < 0) load_u(p, node, ustride, u);
        T f[3] = {T(0), T(0), T(0)};
        owned_sum<OI, OK, OJ, T>(sf, ncell, vi, vk, vj, ti, nt, tj, f);
        if (shared || wrow >= 0) {
          const int col = shared ? rim_index(li2, lj2, ti, tj, TI, TJ)
                                 : rim_size(TI, TJ) + wrow * (2 * TJ + 1) + lj2;
#pragma unroll
          for (int e = 0; e < 3; ++e) __stcg(pt + (col * 3 + e) * NK2 + k2, f[e]);
        } else {
          store(p, node, ustride, j2, f, u);
        }
      }
    });
  }
  if (le || te) {  // R2 over the tile's own weld rows (block-uniform)
    __syncthreads();
    const int w2 = 2 * tj + 1;
    for (int n = threadIdx.x; n < 4 * NK2 * w2; n += kThreads) {
      const int lj2 = n % w2, k2 = (n / w2) % NK2, wrow = n / (w2 * NK2);
      const int li2 = wrow <= 1 ? wrow : 2 * ti - 3 + wrow;
      if (!(wrow <= 1 ? le : te) || (lj2 == 0 && bx > 0) || (lj2 == 2 * tj && bx < tJ - 1))
        continue;  // not this tile's weld row, or a shared column (finish_shared's)
      const int i2 = 2 * ci0 + li2, j2 = 2 * cj0 + lj2;
      const int node = b * uplane + (i2 * NK2 + k2) * p.NJ2 + j2;
      T u[3];
      load_u(p, node, ustride, u);
      int lo, hi;
      weld_run(i2, k2, NI2, NK2, p.weld_te, &lo, &hi);
      T f[3] = {T(0), T(0), T(0)};
      const T* pw = pt + (rim_size(TI, TJ) + wrow * (2 * TJ + 1) + lj2) * 3 * NK2;
      for (int kk = lo; kk <= hi; ++kk)
#pragma unroll
        for (int e = 0; e < 3; ++e) f[e] += __ldcg(pw + e * NK2 + kk);
      store(p, node, ustride, j2, f, u);
    }
  }

  // ---- the tickets of the tiles whose shared faces this tile adds to: this
  // one, (by + 1, bx), (by, bx + 1), (by + 1, bx + 1), a thread each
  if (threadIdx.x == 0) finish = 0;
  __syncthreads();
  if (threadIdx.x < 4) {
    const int byT = by + (threadIdx.x >> 1), bxT = bx + (threadIdx.x & 1);
    const unsigned need = 1u + (byT > 0) + (bxT > 0) + (byT > 0 && bxT > 0);
    if (byT < tI && bxT < tJ && need > 1u) {
      __threadfence();  // the block's partials (ordered before it by the barrier) are visible
      if (atomicAdd(p.ticket + (b * tI + byT) * tJ + bxT, 1u) == need - 1u) {
        __threadfence();  // the other tiles' partials are read after their tickets
        atomicOr(&finish, 1 << threadIdx.x);
      }
    }
  }
  __syncthreads();
  if (finish == 0) return;
#pragma unroll 1
  for (int s = 0; s < 4; ++s) {
    if (!((finish >> s) & 1)) continue;
    const int byT = by + (s >> 1), bxT = bx + (s & 1);
    finish_shared<T>(p, b, byT, bxT, tI, tJ, nc, ns);
    if (threadIdx.x == 0) p.ticket[(b * tI + byT) * tJ + bxT] = 0u;  // ready for the next call
  }
}

template <typename T>
int launch(const void* g, const void* vol, const void* u, const void* free, void* y,
           void* partial, void* ticket, int B, int NI2, int NK2, int NJ2, int weld_te, int TI,
           int TJ, double lam, double mu, void* stream) {
  if (B <= 0) return 0;
  if (NI2 < 5 || NK2 < 3 || NJ2 < 3 || NI2 % 2 == 0 || NK2 % 2 == 0 || NJ2 % 2 == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nc = (NI2 - 1) / 2, nt = (NK2 - 1) / 2, ns = (NJ2 - 1) / 2;
  if (TI < 1 || TJ < 1 || TI > nc || TJ > ns || TI * TJ * nt > kCells ||
      smem_bytes<T>(TI, TJ, nt) > static_cast<size_t>(kMaxSmem))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args<T> a{static_cast<const T*>(g), static_cast<const T*>(vol), static_cast<const T*>(u),
                  static_cast<const T*>(free), static_cast<T*>(y), static_cast<T*>(partial),
                  static_cast<unsigned*>(ticket), B, NI2, NK2, NJ2, weld_te, TI, TJ,
                  static_cast<T>(lam), static_cast<T>(mu)};
  // above 48 KB of dynamic shared memory needs the opt-in, once per kernel
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      strain_apply10_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (opt_in != cudaSuccess) return static_cast<int>(opt_in);
  const dim3 grid((ns + TJ - 1) / TJ, (nc + TI - 1) / TI, B);
  strain_apply10_kernel<T><<<grid, kThreads, smem_bytes<T>(TI, TJ, nt),
                             static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// All tensors contiguous on the device, of one dtype; free is the NJ2 root
// mask; partial holds B * tI * tJ * (4 (TI + TJ) + 4 (2 TJ + 1)) * 3 * NK2
// values of the dtype (tI, tJ the tiles along chord and span), ticket B * tI
// * tJ unsigned ints, all 0. Returns cudaGetLastError() after the launch (cudaErrorInvalidValue
// on a grid or tile the kernel does not take).
extern "C" int tpufem_strain_apply10_tiled_f32(const void* g, const void* vol, const void* u,
                                               const void* free, void* y, void* partial,
                                               void* ticket, int B, int NI2, int NK2, int NJ2,
                                               int weld_te, int TI, int TJ, double lam,
                                               double mu, void* stream) {
  return launch<float>(g, vol, u, free, y, partial, ticket, B, NI2, NK2, NJ2, weld_te, TI, TJ,
                       lam, mu, stream);
}

extern "C" int tpufem_strain_apply10_tiled_f64(const void* g, const void* vol, const void* u,
                                               const void* free, void* y, void* partial,
                                               void* ticket, int B, int NI2, int NK2, int NJ2,
                                               int weld_te, int TI, int TJ, double lam,
                                               double mu, void* stream) {
  return launch<double>(g, vol, u, free, y, partial, ticket, B, NI2, NK2, NJ2, weld_te, TI, TJ,
                        lam, mu, stream);
}
