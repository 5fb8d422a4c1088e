// The tiled schedule over the structured wing grid that kernels H
// (stvk_force) and I (stvk_tangent) run: one launch computes
//
//   y = R( K( S(u * free) ) ) * free + u * (1 - free)
//
// for an element operator K given per Kuhn tet by a body, with S (weld
// spread), the root mask and R (weld reduce) as in grid_walk.cuh. The
// operands are g (6,4,3,B,nc,nt,ns), vol (6,B,nc,nt,ns) and u, y
// (3,B,NI,NK,NJ), all contiguous, in tpufem's layouts.
//
// It is built for the Newton solve's single lane, where kernel B's walk
// (grid_walk.cuh: a thread per cell column, every (layer, tet) stage in turn
// behind a barrier) has too few blocks to fill the card and a serial chain of
// 6 * nt stages per thread. Here every cell of a tile is evaluated at once:
//   - A block owns own_j (span) x own_i (chord) node columns of one lane at
//     full thickness and computes every cell that touches them, (own_j + 1) x
//     (own_i + 1) x nt cells; the cells on its low edges are halo cells that
//     the neighbouring block computes as well, so no node needs a second pass
//     or an atomic. The launcher picks the tile (tile_of): the widest one,
//     from kOwnJ columns halved down to kMinOwnJ, whose launch still gives
//     every SM a block and whose corner forces fit in shared memory, with the
//     most chord rows that keep it within kCells cells (halved with the
//     columns), fewer while SMs would go without a block.
//   - A thread per cell: the block's kThreads threads take the tile's cells
//     in turn. A cell's 8 corners are loaded masked and weld-spread (both fields
//     for a 2-field body); for each of its 6 tets the 13 geometry scalars go
//     from device memory into registers (coalesced along span) and the body
//     adds the tet's corner forces; the cell's 8 corner forces go to shared
//     memory: no barrier between tets or layers.
//   - One barrier, then a thread per owned node sums the corner forces of its
//     <= 8 incident cells in a fixed corner order, without atomics, so two
//     calls give the same bits. Weld rows: the node at k = 0 takes the
//     thickness sum, the rest zero. Then the mask and the Dirichlet identity
//     (grid_tet.cuh: weld_k, masked_store).
// Every index is 32-bit; the wrappers check that every operand has fewer than
// 2^31 elements.
//
// A body is a type with kIdentity and operator()(tet, sg, plane, U[, U2], lo,
// hi) as grid_walk.cuh describes; here sg points at the tet's 13 geometry
// scalars in registers, `plane` 1 apart.

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

#include "grid_tet.cuh"

namespace grid_tile {

template <typename T>
struct Operands {
  const T* g;
  const T* vol;
  const T* u;  // the field the Dirichlet identity stores
  const T* free;
  T* y;
  int B, NI, NK, NJ;
  int weld_te;
  const T* u2;  // the second field of a 2-field body, else null
};

// The schedule: at most kOwnJ owned node columns along span and kCells cells
// per block (tile_of), down to kMinOwnJ columns (a span row of 9 cells: long
// runs of each geometry plane); kThreads threads per block, and the blocks
// per SM the kernels' registers are capped for (__launch_bounds__)
constexpr int kOwnJ = 16, kCells = 512, kMinOwnJ = 8;
constexpr int kThreads = 256, kMinBlocks = 1;
constexpr int kMaxSmem = 232448;  // the most dynamic shared memory a Hopper block takes

// Dynamic shared memory of one block: the cells' corner forces [8][3][ncell]
template <typename T>
constexpr size_t smem_bytes(int own_j, int own_i, int nt) {
  return static_cast<size_t>(8 * 3) * (own_j + 1) * (own_i + 1) * nt * sizeof(T);
}

struct Tile {
  int own_j, own_i;
};

inline int blocks_of(int B, int NI, int NJ, Tile t) {
  return B * ((NJ + t.own_j - 1) / t.own_j) * ((NI + t.own_i - 1) / t.own_i);
}

// The tile of a launch on a card of `sms` SMs (see the header)
template <typename T>
inline Tile tile_of(int B, int NI, int NK, int NJ, int sms) {
  for (int own_j = kOwnJ, cells = kCells;; own_j /= 2, cells /= 2) {
    Tile t{own_j, cells / ((own_j + 1) * (NK - 1)) - 1};
    if (t.own_i < 1) t.own_i = 1;
    while (t.own_i > 1 && blocks_of(B, NI, NJ, t) < sms) --t.own_i;
    const bool fits = smem_bytes<T>(t.own_j, t.own_i, NK - 1) <= static_cast<size_t>(kMaxSmem);
    if ((fits && blocks_of(B, NI, NJ, t) >= sms) || own_j / 2 < kMinOwnJ) return t;
  }
}

inline dim3 grid_of(int B, int NI, int NJ, Tile t) {
  return dim3((NJ + t.own_j - 1) / t.own_j, (NI + t.own_i - 1) / t.own_i, B);
}

// One cell (ci, ck, cj), the tile's cell c of ncell: its 8 corner forces
// to sf; an off-grid cell (ok false) writes zeros
template <typename T, int FIELDS, class Body>
__device__ __forceinline__ void eval_cell(const Operands<T>& p, const Body& body, bool ok, int ci,
                                          int ck, int cj, T* sf, int ncell, int c) {
  using grid_tet::corner_di;
  using grid_tet::corner_dj;
  using grid_tet::corner_dk;
  T lo[4][3], hi[4][3];
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int e = 0; e < 3; ++e) lo[q][e] = hi[q][e] = T(0);
  if (ok) {
    const int B = p.B, NI = p.NI, NK = p.NK, NJ = p.NJ;
    const int nt = NK - 1, ns = NJ - 1;
    const int cplane = (NI - 1) * nt * ns;
    const int uplane = NI * NK * NJ, ustride = B * uplane;
    const int b = blockIdx.z;
    T U[8][3], U2[FIELDS > 1 ? 8 : 1][3];
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int i = ci + corner_di(q), j = cj + corner_dj(q);
      const int k = grid_tet::weld_k(i, ck + corner_dk(q), NI, p.weld_te);
      const int node = b * uplane + (i * NK + k) * NJ + j;
      const T fr = __ldg(p.free + j);
#pragma unroll
      for (int e = 0; e < 3; ++e) U[q][e] = __ldg(p.u + e * ustride + node) * fr;
      if constexpr (FIELDS > 1) {
#pragma unroll
        for (int e = 0; e < 3; ++e) U2[q][e] = __ldg(p.u2 + e * ustride + node) * fr;
      }
    }
    const int cell = (ci * nt + ck) * ns + cj;
#pragma unroll
    for (int t = 0; t < 6; ++t) {
      T sg[13];  // the tet's gradients (a * 3 + d) and volume
      const T* gs = p.g + (t * 12 * B + b) * cplane + cell;
#pragma unroll
      for (int n = 0; n < 12; ++n) sg[n] = __ldg(gs + n * B * cplane);
      sg[12] = __ldg(p.vol + (t * B + b) * cplane + cell);
      if constexpr (FIELDS > 1) {
        body(t, sg, 1, U, U2, lo, hi);
      } else {
        body(t, sg, 1, U, lo, hi);
      }
    }
  }
#pragma unroll
  for (int q = 0; q < 8; ++q)
#pragma unroll
    for (int e = 0; e < 3; ++e) sf[(q * 3 + e) * ncell + c] = q < 4 ? lo[q][e] : hi[q - 4][e];
}

// The schedule of one block, launched as grid_of(B, NI, NJ, tile) blocks of
// kThreads threads with smem_bytes<T>(tile.own_j, tile.own_i, NK - 1) of
// dynamic shared memory. FIELDS: 1, or 2 for a body that takes u2's corners.
template <typename T, int FIELDS, class Body>
__device__ __forceinline__ void run(const Operands<T>& p, Tile tile, const Body& body) {
  using grid_tet::corner_di;
  using grid_tet::corner_dj;
  using grid_tet::corner_dk;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sf = reinterpret_cast<T*>(smem_raw);  // [corner][3][ncell]

  const int B = p.B, NI = p.NI, NK = p.NK, NJ = p.NJ;
  const int nc = NI - 1, nt = NK - 1, ns = NJ - 1;
  const int own_j = tile.own_j, own_i = tile.own_i;
  const int TJ = own_j + 1;  // cells along span
  const int b = blockIdx.z;
  const int n0i = blockIdx.y * own_i, n0j = blockIdx.x * own_j;  // first owned node
  const int c0i = n0i - 1, c0j = n0j - 1;                         // first computed cell
  const int ncell = (own_i + 1) * nt * TJ;  // cell c = (li * nt + ck) * TJ + lj

  for (int c = threadIdx.x; c < ncell; c += kThreads) {
    const int lj = c % TJ, r = c / TJ;
    const int ck = r % nt, li = r / nt;
    const int ci = c0i + li, cj = c0j + lj;
    const bool ok = ci >= 0 && ci < nc && cj >= 0 && cj < ns;
    eval_cell<T, FIELDS>(p, body, ok, ci, ck, cj, sf, ncell, c);
  }
  __syncthreads();

  const int uplane = NI * NK * NJ, ustride = B * uplane;
  for (int n = threadIdx.x; n < own_i * NK * own_j; n += kThreads) {
    const int oj = n % own_j, r = n / own_j;
    const int k = r % NK, oi = r / NK;
    const int i = n0i + oi, j = n0j + oj;
    if (i >= NI || j >= NJ) continue;
    const bool weld = grid_tet::weld_row(i, NI, p.weld_te);
    T f[3] = {T(0), T(0), T(0)};
    // weld rows: the node at k = 0 sums its column, the nodes above store zero
    const int k_end = weld ? (k == 0 ? nt : -1) : k;
    for (int kk = k; kk <= k_end; ++kk) {
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int ck = kk - corner_dk(q);
        if (ck < 0 || ck >= nt) continue;
        const int c = ((oi + 1 - corner_di(q)) * nt + ck) * TJ + (oj + 1 - corner_dj(q));
#pragma unroll
        for (int e = 0; e < 3; ++e) f[e] += sf[(q * 3 + e) * ncell + c];
      }
    }
    const T fr = __ldg(p.free + j);
    const int node = b * uplane + (i * NK + k) * NJ + j;
#pragma unroll
    for (int e = 0; e < 3; ++e) {
      const T u = Body::kIdentity ? __ldg(p.u + e * ustride + node) : T(0);
      p.y[e * ustride + node] = grid_tet::masked_store<Body::kIdentity>(f[e], fr, u);
    }
  }
}

using grid_tet::sm_count;

// Launches `kernel` (a __global__ that runs run<T, ...>) on operands a;
// returns cudaGetLastError() after the launch, or cudaErrorInvalidValue where
// a tile of kMinOwnJ columns and one chord row at full thickness needs more
// shared memory than a block has (nt above 67 in f64).
template <typename T, class Body>
int launch(void (*kernel)(Operands<T>, Tile, Body), const Operands<T>& a, const Body& body,
           cudaStream_t stream) {
  // above 48 KB of dynamic shared memory needs the opt-in, once per kernel
  static const cudaError_t opt_in =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (opt_in != cudaSuccess) return static_cast<int>(opt_in);
  const Tile t = tile_of<T>(a.B, a.NI, a.NK, a.NJ, sm_count());
  const size_t smem = smem_bytes<T>(t.own_j, t.own_i, a.NK - 1);
  if (smem > static_cast<size_t>(kMaxSmem)) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<grid_of(a.B, a.NI, a.NJ, t), kThreads, smem, stream>>>(a, t, body);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace grid_tile
