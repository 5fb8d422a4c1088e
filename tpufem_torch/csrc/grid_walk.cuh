// The cell-centric walk over the structured wing grid that kernels B
// (strain_apply) and G (geom_apply) share: one launch computes
//
//   y = R( K( S(u * free) ) ) * free  [+ u * (1 - free), the Dirichlet identity]
//
// for an element operator K given per Kuhn tet by a body. S (weld spread: on
// weld rows every thickness node takes the k = 0 value) and the root mask
// `free` (an NJ vector) are applied as u is loaded; R (weld reduce: the
// thickness sum goes to k = 0, the rest is zero), the mask and, where the
// body asks for it, the identity as y is stored. The operands are the
// per-tet gradients g (6,4,3,B,nc,nt,ns), volumes vol (6,B,nc,nt,ns), for a
// body with 22 planes the stresses sig (6,3,3,B,nc,nt,ns), and u, y
// (3,B,NI,NK,NJ), all contiguous, in tpufem's layouts.
//
// A block of ROWS warps owns one lane and a tile of cells, full thickness, 32
// cells along span (one warp, the contiguous axis) by ROWS along chord (one
// warp each). Each thread owns one cell column (ci, cj) and walks up the
// thickness; it evaluates each of its cell's 6 tets once and keeps the 8
// corner displacements and forces in registers. The block writes the 31 x
// (ROWS - 1) node columns whose every touching cell it computed; the cells on
// the tile's low edges are halo cells that the neighbouring block also
// computes (ROWS / (ROWS - 1) along chord, 32/31 along span: ~1.18x the
// geometry bytes at 8 rows, ~1.38x at 4), so no node needs a second pass or
// an atomic.
//   - Geometry is staged per (layer, tet): the tet's planes of the tile (12
//     gradients, the volume, and for G the 9 stresses) are copied with
//     cp.async into a ring of DEPTH stages in shared memory, 16-byte copies
//     where the span rows allow it (ns and the base pointers aligned, which
//     the launcher checks), else one scalar per copy; a warp's copies are
//     contiguous along span, so each geometry scalar is read from device
//     memory once per block that needs it. Which copies a thread issues is the
//     same for every stage, so their source offsets are computed once.
//   - Node sums in a fixed order, without atomics: node layer k gets the
//     dk = 0 corners of cell layer k added to the dk = 1 corners of layer
//     k - 1, kept in registers (the carry); the two span neighbours combine
//     by a warp shuffle; the two chord neighbours through shared memory, one
//     barrier per node layer. Two runs give the same bits.
//   - Weld rows: the writer keeps the thickness sum in registers and stores
//     it at k = 0 after the last layer (grid_tet.cuh: weld_k, masked_store).
// Every index is 32-bit; the wrappers check that every operand has fewer than
// 2^31 elements.
//
// A body is a type with
//   static constexpr int kPlanes;     // 13 (g, vol) or 22 (g, vol, sig)
//   static constexpr bool kIdentity;  // store u * (1 - free) on masked rows
//   void operator()(int tet, const T* sg, int plane, const T (&U)[8][3],
//                   T (&lo)[4][3], T (&hi)[4][3]) const;
// which adds tet `tet`'s corner forces to lo (hex corners 0-3, the cell's
// lower node layer) and hi (corners 4-7); sg points at the cell's entry in
// plane 0 of the stage, the planes `plane` apart, in the order g (a * 3 + d),
// vol, sig (d * 3 + e). u is the field the Dirichlet identity stores.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "grid_tet.cuh"

namespace grid_walk {

constexpr int kLanes = 32;  // cells along span per block (one warp)

template <typename T>
struct Operands {
  const T* g;
  const T* vol;
  const T* sig;  // null for a 13-plane body
  const T* u;
  const T* free;
  T* y;
  int B, NI, NK, NJ;
  int weld_te;
};

template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s), "l"(src), "n"(BYTES));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Dynamic shared memory of one block: the ring and the chord half-sums.
template <typename T, int PLANES, int ROWS, int VEC, int DEPTH>
constexpr size_t smem_bytes() {
  return (static_cast<size_t>(DEPTH) * PLANES * ROWS * (kLanes + VEC) + 2 * 3 * kLanes * ROWS) *
         sizeof(T);
}

// The grid of blocks: one per tile of 31 x (ROWS - 1) node columns and lane.
template <int ROWS>
inline dim3 grid_of(int B, int NI, int NJ) {
  return dim3((NJ + kLanes - 2) / (kLanes - 1), (NI + ROWS - 2) / (ROWS - 1), B);
}

// The walk of one block, launched as dim3(kLanes, ROWS) threads with
// smem_bytes<T, Body::kPlanes, ROWS, VEC, DEPTH>() of dynamic shared memory.
// VEC: scalars per cp.async (16 bytes, or 1 where the rows are not aligned).
// DEPTH: stages in the ring.
template <typename T, int ROWS, int VEC, int DEPTH, class Body>
__device__ __forceinline__ void walk(const Operands<T>& p, const Body& body) {
  using grid_tet::corner_di;
  using grid_tet::corner_dj;
  using grid_tet::weld_row;
  constexpr int kPlanes = Body::kPlanes;
  constexpr bool kSig = kPlanes > 13;
  constexpr int kOwnJ = kLanes - 1;  // node columns a block writes along span
  constexpr int kOwnI = ROWS - 1;    // ... and along chord
  constexpr int kThreads = kLanes * ROWS;
  constexpr int WJ = kLanes + VEC;  // staged cells per row (alignment slack)
  constexpr int NQ = WJ / VEC;      // copies per staged row
  constexpr int PLANE = ROWS * WJ;
  constexpr int STAGE = kPlanes * PLANE;
  constexpr int NCOPY = kPlanes * ROWS * NQ;
  constexpr int NSLOT = (NCOPY + kThreads - 1) / kThreads;  // copies per thread
  constexpr int VOL_Q = 12 * ROWS * NQ;  // copies from here on are of the volume,
  constexpr int SIG_Q = 13 * ROWS * NQ;  // and from here on of the stress
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);
  T* part = ring + DEPTH * STAGE;  // [2][3][ROWS][kLanes]: the di = 0 half-sums

  const int lj = threadIdx.x, li = threadIdx.y;
  const int tid = li * kLanes + lj;
  const int b = blockIdx.z;
  const int B = p.B, NI = p.NI, NK = p.NK, NJ = p.NJ;
  const int nc = NI - 1, nt = NK - 1, ns = NJ - 1;
  const int n0i = blockIdx.y * kOwnI, n0j = blockIdx.x * kOwnJ;  // first owned node
  const int c0i = n0i - 1, c0j = n0j - 1;                         // first computed cell
  const int ci = c0i + li, cj = c0j + lj;
  const bool cell_ok = ci >= 0 && ci < nc && cj >= 0 && cj < ns;
  const int cplane = nc * nt * ns;
  const int uplane = NI * NK * NJ;
  const int ustride = uplane * B;                    // u's component stride
  const int a0 = c0j - (((c0j % VEC) + VEC) % VEC);  // c0j rounded down to VEC
  const T* ub = p.u + b * uplane;
  const int n_steps = nt * 6;

  // Copy q = tid + n * kThreads of a stage lands at q * VEC in its ring slot
  // (plane, row, chunk in row-major order); its source offset from the
  // stage's base in its operand is the same for every stage, -1 where it
  // falls off the grid
  int src_off[NSLOT];
#pragma unroll
  for (int n = 0; n < NSLOT; ++n) {
    const int q = tid + n * kThreads;
    const int pl = q / (ROWS * NQ);
    const int r = q - pl * (ROWS * NQ);
    const int row = r / NQ;
    const int cs = a0 + (r - row * NQ) * VEC;  // first cell of this copy
    const int cr = c0i + row;
    const bool ok = q < NCOPY && cr >= 0 && cr < nc && cs >= 0 && cs + VEC <= ns &&
                    cs < c0j + kLanes;
    const int pl_off = q < VOL_Q ? pl : (!kSig || q < SIG_Q) ? 0 : pl - 13;
    src_off[n] = ok ? pl_off * B * cplane + cr * nt * ns + cs : -1;
  }
  // stage s = (layer s / 6, tet s % 6) into ring slot s % DEPTH; always
  // commits a group, so the wait count below stays uniform
  auto issue = [&](int s) {
    if (s < n_steps) {
      const int ck = s / 6, t = s - ck * 6;
      T* dst = ring + (s % DEPTH) * STAGE;
      const T* gs = p.g + (t * 12 * B + b) * cplane + ck * ns;
      const T* vs = p.vol + (t * B + b) * cplane + ck * ns;
      const T* ss = kSig ? p.sig + (t * 9 * B + b) * cplane + ck * ns : nullptr;
#pragma unroll
      for (int n = 0; n < NSLOT; ++n) {
        const int q = tid + n * kThreads;
        if (src_off[n] >= 0) {
          const T* src = q < VOL_Q ? gs : (!kSig || q < SIG_Q) ? vs : ss;
          cp_async<static_cast<int>(VEC * sizeof(T))>(dst + q * VEC, src + src_off[n]);
        }
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < DEPTH - 1; ++s) issue(s);

  // corner displacements of the cell, masked and weld-spread on load:
  // U[q] for q < 4 on node layer k, q >= 4 on layer k + 1
  T U[8][3];
  auto load_layer = [&](int k, int q0) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int i = ci + corner_di(q), j = cj + corner_dj(q);
      const int node = (i * NK + grid_tet::weld_k(i, k, NI, p.weld_te)) * NJ + j;
      const T fr = __ldg(p.free + j);
#pragma unroll
      for (int c = 0; c < 3; ++c) U[q0 + q][c] = __ldg(ub + c * ustride + node) * fr;
    }
  };
  if (cell_ok) load_layer(0, 0);

  T lo[4][3], hi[4][3];  // forces on node layers k (with the carry) and k + 1
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int c = 0; c < 3; ++c) lo[q][c] = T(0);

  const bool writer = li < kOwnI && lj < kOwnJ && n0i + li < NI && n0j + lj < NJ;
  const int wi = n0i + li, wj = n0j + lj;
  const bool wweld = weld_row(wi, NI, p.weld_te);
  const T wfree = writer ? __ldg(p.free + wj) : T(0);
  const int wnode = b * uplane + wi * NK * NJ + wj;  // the writer's node at k = 0
  T wsum[3] = {T(0), T(0), T(0)};  // weld rows: the thickness sum
  const int soff = li * WJ + (c0j - a0) + lj;  // this cell in a stage plane

  for (int k = 0; k <= nt; ++k) {  // node layer k
    // u at the writer's node for the Dirichlet identity, loaded here and used
    // after the layer's 6 tets
    T uw[3] = {T(0), T(0), T(0)};
    if constexpr (Body::kIdentity) {
#pragma unroll
      for (int c = 0; c < 3; ++c) uw[c] = writer ? __ldg(p.u + c * ustride + wnode + k * NJ) : T(0);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int c = 0; c < 3; ++c) hi[q][c] = T(0);
    if (k < nt) {
      if (cell_ok) load_layer(k + 1, 4);
#pragma unroll
      for (int t = 0; t < 6; ++t) {
        const int s = k * 6 + t;
        cp_async_wait<DEPTH - 2>();
        __syncthreads();  // stage s landed; every thread is done with stage s - 1
        issue(s + DEPTH - 1);
        if (cell_ok) body(t, ring + (s % DEPTH) * STAGE + soff, PLANE, U, lo, hi);
      }
    }
    // node (n0j + lane) of this row: corner dj = 1 of this lane's cell plus
    // corner dj = 0 of the next lane's; di = 0 goes to the row below via
    // shared memory, di = 1 stays with this row's writer
    T h1[3];
    T* pb = part + (k & 1) * (3 * kThreads);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const T h0 = lo[3][c] + __shfl_down_sync(0xffffffffu, lo[0][c], 1);
      h1[c] = lo[2][c] + __shfl_down_sync(0xffffffffu, lo[1][c], 1);
      pb[c * kThreads + tid] = h0;
    }
    __syncthreads();
    if (writer) {
      const int node = wnode + k * NJ;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const T f = h1[c] + pb[c * kThreads + tid + kLanes];
        if (!wweld) {
          p.y[c * ustride + node] = grid_tet::masked_store<Body::kIdentity>(f, wfree, uw[c]);
        } else {
          wsum[c] += f;
          if (k > 0) {
            p.y[c * ustride + node] =
                Body::kIdentity ? grid_tet::masked_store<true>(T(0), wfree, uw[c]) : T(0);
          }
        }
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        lo[q][c] = hi[q][c];
        U[q][c] = U[q + 4][c];
      }
    }
  }
  if (writer && wweld) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const T uv = Body::kIdentity ? __ldg(p.u + c * ustride + wnode) : T(0);
      p.y[c * ustride + wnode] = grid_tet::masked_store<Body::kIdentity>(wsum[c], wfree, uv);
    }
  }
}

}  // namespace grid_walk
