// Kernel B: the welded, Dirichlet-wrapped strain-first stiffness apply on the
// structured wing grid, one launch per operator apply.
//
// Replaces tpufem/fem/stencil.py:249 strain_apply (jnp code that XLA fused on
// the TPU; the operator every CG iteration applies once in f64 and every
// V-cycle level above the coarsest 4 times in f32). One launch computes the
// whole public function
//
//   y = R( K_cells( S(u * free) ) ) * free + u * (1 - free)
//
// S (weld spread: on weld rows every thickness node takes the k = 0 value) and
// the root mask `free` (an NJ vector) are applied as u is loaded; R (weld
// reduce: the thickness sum goes to k = 0, the rest is zero), the mask and the
// Dirichlet identity u * (1 - free) as y is stored. Weld rows are i = 0 and,
// when weld_te, i = NI - 1. K_cells is, per Kuhn tet t of every cell,
//
//   f_a = vol_t * sigma(eps_t) . g_{t,a},  eps_t = sym(sum_a g_{t,a} (x) u_a),
//   sigma = 2 mu eps + lam tr(eps) I,
//
// from the per-tet gradients g (6,4,3,B,nc,nt,ns), volumes vol (6,B,nc,nt,ns)
// and u, y (3,B,NI,NK,NJ), all contiguous, in tpufem's layouts.
//
// The bound is bytes. Per apply at DOF100K, B = 8, the inputs are 17,694,720
// gradient and 1,474,560 volume scalars, and u and y hold 884,520 each:
// 167.5 MB in f64, 83.8 MB in f32, so 50 us and 25 us at 3.35 TB/s. The
// arithmetic is ~170 flops per tet, 0.25 GFLOP per apply, ~7 us at the FP64
// rate outside the tensor cores: the work is bytes-bound at ~7x its flop
// time, so tensor cores (wgmma) would buy nothing here.
//
// Design, cell-centric: a block of 8 warps owns one case and a tile of cells,
// full thickness, 32 cells along span (one warp, the contiguous axis) by 8
// along chord (one warp each). Each thread owns one cell column (ci, cj) and
// walks up the thickness; it evaluates each of its cell's 6 tets once and
// keeps the 8 corner displacements and forces in registers. The block writes
// the 31 x 7 node columns whose every touching cell it computed; the cells on
// the tile's low edges are halo cells that the neighbouring block also
// computes (8/7 along chord, 32/31 along span: ~1.18x the geometry bytes),
// so no node needs a second pass or an atomic.
//   - Geometry is staged per (layer, tet): its 13 planes (12 gradients and the
//     volume) of the tile are copied with cp.async into a ring of DEPTH stages
//     in shared memory, 16-byte copies where the span rows allow it (ns and
//     the base pointers aligned, which the launcher checks), else one scalar
//     per copy; a warp's copies are contiguous along span, so each geometry
//     scalar is read from device memory once per block that needs it. Which
//     copies a thread issues is the same for every stage, so their source
//     offsets are computed once, before the walk.
//   - Node sums in a fixed order, without atomics: node layer k gets the
//     dk = 0 corners of cell layer k added to the dk = 1 corners of layer
//     k - 1, kept in registers (the carry); the two span neighbours combine
//     by a warp shuffle; the two chord neighbours through shared memory, one
//     barrier per node layer. Two runs give the same bits.
//   - Weld rows: the writer keeps the thickness sum in registers and stores
//     it at k = 0 after the last layer.
// Every index is 32-bit; the wrapper checks that the gradient array and u have
// fewer than 2^31 elements.

#include <cuda_runtime.h>
#include <stdint.h>

#include "grid_tet.cuh"

namespace {

constexpr int kLanes = 32;          // cells along span per block (one warp)
constexpr int kRows = 8;            // cell rows along chord per block (one warp each)
constexpr int kOwnJ = kLanes - 1;   // node columns a block writes along span
constexpr int kOwnI = kRows - 1;    // ... and along chord
constexpr int kThreads = kLanes * kRows;
constexpr int kPlanes = 13;         // per tet: 4 x 3 gradient planes and the volume

template <typename T>
struct Args {
  const T* g;
  const T* vol;
  const T* u;
  const T* free;
  T* y;
  int B, NI, NK, NJ;
  int weld_te;
  T lam, mu;
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

using grid_tet::corner_di;
using grid_tet::corner_dj;
using grid_tet::kuhn;
using grid_tet::weld_row;

// One Kuhn tet of the thread's cell: strain from its 4 corner displacements,
// stress, and the 4 corner forces vol * sigma . g_a added to the corner sums
// (lo: corners 0-3 on the cell's lower node layer, hi: 4-7 on the upper).
// sg points at the cell's entry in plane 0 of the stage; planes are `plane`
// apart. tet is a constant once the caller's loop is unrolled.
template <typename T>
__device__ __forceinline__ void tet_forces(int tet, const T* sg, int plane,
                                           const T (&U)[8][3], T (&lo)[4][3],
                                           T (&hi)[4][3], T lam, T mu) {
  T H[3][3] = {};  // H[d][e] = sum_a g[t,a,d] * u_a[e]
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int q = kuhn(tet, a);
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const T gd = sg[(a * 3 + d) * plane];
      H[d][0] += gd * U[q][0];
      H[d][1] += gd * U[q][1];
      H[d][2] += gd * U[q][2];
    }
  }
  const T v = sg[12 * plane];
  const T tr = H[0][0] + H[1][1] + H[2][2];
  T s[3][3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
#pragma unroll
    for (int e = 0; e < 3; ++e) s[d][e] = mu * (H[d][e] + H[e][d]) * v;  // 2 mu eps, times vol
    s[d][d] += lam * tr * v;
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int q = kuhn(tet, a);
    const T g0 = sg[(a * 3 + 0) * plane];
    const T g1 = sg[(a * 3 + 1) * plane];
    const T g2 = sg[(a * 3 + 2) * plane];
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const T f = s[d][0] * g0 + s[d][1] * g1 + s[d][2] * g2;
      if (q < 4) {
        lo[q][d] += f;
      } else {
        hi[q - 4][d] += f;
      }
    }
  }
}

// VEC: scalars per cp.async (16 bytes, or 1 where the rows are not aligned).
// DEPTH: stages in the ring.
template <typename T, int VEC, int DEPTH>
__global__ void __launch_bounds__(kThreads) strain_apply_kernel(Args<T> p) {
  constexpr int WJ = kLanes + VEC;       // staged cells per row (alignment slack)
  constexpr int NQ = WJ / VEC;           // copies per staged row
  constexpr int PLANE = kRows * WJ;
  constexpr int STAGE = kPlanes * PLANE;
  constexpr int NCOPY = kPlanes * kRows * NQ;
  constexpr int NSLOT = (NCOPY + kThreads - 1) / kThreads;  // copies per thread
  constexpr int VOL_Q = 12 * kRows * NQ;  // copies from here on are of the volume
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);
  T* part = ring + DEPTH * STAGE;  // [2][3][kRows][kLanes]: the di = 0 half-sums

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
  const int ustride = uplane * B;                        // u's component stride
  const int a0 = c0j - (((c0j % VEC) + VEC) % VEC);      // c0j rounded down to VEC
  const T* ub = p.u + b * uplane;
  const T lam = p.lam, mu = p.mu;
  const int n_steps = nt * 6;

  // Copy q = tid + n * kThreads of a stage lands at q * VEC in its ring slot
  // (plane, row, chunk in row-major order); its source offset from the
  // stage's base is the same for every stage, -1 where it falls off the grid
  int src_off[NSLOT];
#pragma unroll
  for (int n = 0; n < NSLOT; ++n) {
    const int q = tid + n * kThreads;
    const int pl = q / (kRows * NQ);
    const int r = q - pl * (kRows * NQ);
    const int row = r / NQ;
    const int cs = a0 + (r - row * NQ) * VEC;  // first cell of this copy
    const int cr = c0i + row;
    const bool ok = q < NCOPY && cr >= 0 && cr < nc && cs >= 0 && cs + VEC <= ns &&
                    cs < c0j + kLanes;
    src_off[n] = ok ? (q < VOL_Q ? pl * B * cplane : 0) + cr * nt * ns + cs : -1;
  }
  // stage s = (layer s / 6, tet s % 6) into ring slot s % DEPTH; always
  // commits a group, so the wait count below stays uniform
  auto issue = [&](int s) {
    if (s < n_steps) {
      const int ck = s / 6, t = s - ck * 6;
      T* dst = ring + (s % DEPTH) * STAGE;
      const T* gs = p.g + (t * 12 * B + b) * cplane + ck * ns;
      const T* vs = p.vol + (t * B + b) * cplane + ck * ns;
#pragma unroll
      for (int n = 0; n < NSLOT; ++n) {
        const int q = tid + n * kThreads;
        if (src_off[n] >= 0) {
          cp_async<static_cast<int>(VEC * sizeof(T))>(dst + q * VEC,
                                                      (q < VOL_Q ? gs : vs) + src_off[n]);
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
      const bool weld = weld_row(i, NI, p.weld_te);
      const int node = (i * NK + (weld ? 0 : k)) * NJ + j;
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
    T uw[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) uw[c] = writer ? __ldg(p.u + c * ustride + wnode + k * NJ) : T(0);
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
        if (cell_ok) tet_forces<T>(t, ring + (s % DEPTH) * STAGE + soff, PLANE, U, lo, hi, lam, mu);
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
          p.y[c * ustride + node] = f * wfree + uw[c] * (T(1) - wfree);
        } else {
          wsum[c] += f;
          if (k > 0) p.y[c * ustride + node] = T(0) * wfree + uw[c] * (T(1) - wfree);
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
      const T uv = __ldg(p.u + c * ustride + wnode);
      p.y[c * ustride + wnode] = wsum[c] * wfree + uv * (T(1) - wfree);
    }
  }
}

template <typename T, int VEC, int DEPTH>
int launch_with(const Args<T>& a, cudaStream_t stream) {
  constexpr int WJ = kLanes + VEC;
  constexpr size_t smem = (static_cast<size_t>(DEPTH) * kPlanes * kRows * WJ
                           + 2 * 3 * kThreads) * sizeof(T);
  // above 48 KB of dynamic shared memory needs the opt-in, once per kernel
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      strain_apply_kernel<T, VEC, DEPTH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (opt_in != cudaSuccess) return static_cast<int>(opt_in);
  const dim3 grid((a.NJ + kOwnJ - 1) / kOwnJ, (a.NI + kOwnI - 1) / kOwnI, a.B);
  strain_apply_kernel<T, VEC, DEPTH><<<grid, dim3(kLanes, kRows), smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* g, const void* vol, const void* u, const void* free, void* y, int B,
           int NI, int NK, int NJ, int weld_te, double lam, double mu, void* stream) {
  if (B <= 0 || NI < 2 || NK < 2 || NJ < 2) return 0;
  const Args<T> a{static_cast<const T*>(g), static_cast<const T*>(vol), static_cast<const T*>(u),
                  static_cast<const T*>(free), static_cast<T*>(y), B, NI, NK, NJ, weld_te,
                  static_cast<T>(lam), static_cast<T>(mu)};
  constexpr int kVec = 16 / sizeof(T);
  // a 16-byte copy needs its span row, every plane and both bases aligned
  const bool aligned = (NJ - 1) % kVec == 0 && reinterpret_cast<uintptr_t>(g) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(vol) % 16 == 0;
  // ring depth: 3 stages of 27-28 KB in f64, 4 of 14-15 KB in f32 (deeper
  // rings measured no faster: the walk is not waiting on the copies)
  constexpr int kDepth = sizeof(T) == 8 ? 3 : 4;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return aligned ? launch_with<T, kVec, kDepth>(a, st) : launch_with<T, 1, kDepth>(a, st);
}

}  // namespace

// All tensors contiguous on the device, of one dtype; free is the NJ root
// mask. Returns cudaGetLastError() after the launch.
extern "C" int tpufem_strain_apply_f32(const void* g, const void* vol, const void* u,
                                       const void* free, void* y, int B, int NI, int NK, int NJ,
                                       int weld_te, double lam, double mu, void* stream) {
  return launch<float>(g, vol, u, free, y, B, NI, NK, NJ, weld_te, lam, mu, stream);
}

extern "C" int tpufem_strain_apply_f64(const void* g, const void* vol, const void* u,
                                       const void* free, void* y, int B, int NI, int NK, int NJ,
                                       int weld_te, double lam, double mu, void* stream) {
  return launch<double>(g, vol, u, free, y, B, NI, NK, NJ, weld_te, lam, mu, stream);
}
