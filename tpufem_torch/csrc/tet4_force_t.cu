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
// from grads (T,4,3,B) and vols (T,B) per lane, free (N,3) shared by the
// lanes, x and y (N,3,B), and the tile plan of the (T,4) connectivity
// (tpufem_torch/fem/assembly.py::force_plan_t, built on the host once per
// topology, lane count and dtype: the kernel reads the connectivity through
// it). The element forces never reach device memory.
//
// What bounds it on the card: bytes. An apply reads the gradients (96 B per
// tet and lane in f64), volumes, ids, x and free once and writes y once; the
// arithmetic (about 180 flops per tet and lane) stays below that.
//
// Design (the second; the first walked contiguous node ranges of 48 KB of
// per-entry forces, 256 rows in f64 at B = 8, so that each tet was evaluated
// 2.69 times at DOF100K, and summed each node after one barrier):
//
//   How the tets are cut. The plan cuts the nodes of a structured wing into
//   tiles of a x b station columns at full thickness, and a block owns one
//   tile for one group of `lanes`
//   consecutive lanes (by default all B <= 8 of them: a warp's load then
//   covers each row of a tet once; the plan may split the lanes into groups
//   of blocks). The block lists every tet with a corner on its tile,
//   ascending, and walks the list in chunks of kThreads / lanes tets, a
//   thread per (tet, lane). The plan sizes the tiles so that
//   all blocks are resident in one wave.
//   Evaluations. A tet whose corners all lie on one tile is evaluated once,
//   by that tile's blocks; a tet on the border of two to four tiles is
//   evaluated again by each (a ring of ghost tets round every tile): the
//   plan's `overlap` (listed tets / T, exactly) says how often a tet is
//   evaluated, about (a+1)(b+1)/(ab) on a wing (1.51 at DOF100K B = 8).
//   Where a node's rows live. Every node is owned by one tile, and only its
//   blocks store it: no halo, no scratch, no second launch, no atomics, and
//   no thread-block cluster (a block reads no other block's shared memory).
//   Chunk c's forces on the tile's nodes go to shared memory at the row the
//   plan gives each corner (`dst`: the chunk's rows ordered by node, then
//   tet), corners on other tiles' nodes nowhere. In the next phase a thread
//   per (segment, component, lane) adds a node's rows of the chunk in order
//   to the node's running sum, kept in shared memory for the whole walk;
//   the chunks run in ascending t, so each node's sum runs in ascending
//   t*4+a from zero, however the nodes are cut: the first design's bits.
//   The staging rows and the chunk's segment list are double-buffered, so
//   that chunk c-1's sums and chunk c's evaluation share one barrier. After
//   the last chunk a thread per (owned node, component, lane) stores y.
//   The closure. Where the plan says so (`closure` > 0: wherever the larger
//   shared memory still lets one wave hold every block), a block first
//   stages u = x * free of every node its tets touch, so that a (tet, lane)
//   reads its 12 displacements from shared memory and not 12 x and 12 free
//   values from device memory; else it reads them there (f64 at DOF100K, and
//   wherever a station column is too deep for any tile beside its closure).
//   The arithmetic is the first design's (tet4.cuh's stress, the same force
//   expression, the same masked product and final blend), so the compiler
//   contracts it the same: the redesign gives its bits at every level.
//
// Not in the bound: the plan's arrays (the listed tets, their rows, closure
// places or ids, the segments, the owned and closure nodes), the ghost
// tets' second reads of grads and vols (the neighbouring tiles' blocks make
// them at about the same time, often from L2), and the closure's x and free
// read by each tile that touches a node.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tet4.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSmem = 232448;  // a Hopper block's most dynamic shared memory

// The plan's arrays, as force_plan_t lays them out (int32 but lnode and dst):
//   ttet (L,)     the listed tets, tile after tile, ascending within a tile
//   lnode (L,4)   int16: each listed corner's place in its tile's closure,
//                 read where the closure is staged (closure > 0; else null)
//   dst (L,4)     int16: the staging row of each listed corner within its
//                 chunk, -1 where the corner's node lies on another tile
//   tstart        (tiles+1,): tile k lists ttet[tstart[k]:tstart[k+1]]
//   qbase         (tiles+1,): tile k's chunks are qbase[k]:qbase[k+1]
//   qseg          (chunks+1,): chunk q's segments are seg[qseg[q]:qseg[q+1]]
//   seg           per segment (node of the tile, in its tile's onode order)
//                 | (the chunk row after its last) << 16; a segment's rows
//                 start where the previous segment of its chunk ended
//   onode, ostart the tiles' nodes, ascending: tile k's are onode[ostart[k]:...]
//   cnode, cstart each tile's closure, the nodes of its listed tets, ascending
//   lids (L,4)    the listed tets' corner nodes (16-byte rows), read where the
//                 closure is not staged (closure == 0; else null)
struct Plan {
  const int32_t* ttet;
  const short4* lnode;
  const short4* dst;
  const int32_t* tstart;
  const int32_t* qbase;
  const int32_t* qseg;
  const int32_t* seg;
  const int32_t* onode;
  const int32_t* ostart;
  const int32_t* cnode;
  const int32_t* cstart;
  const int4* lids;
};

// A kernel's dtype and lanes a block, as one type (K::T, K::kLanes).
template <typename T_, int L>
struct Lanes {
  using T = T_;
  static constexpr int kLanes = L;
};

template <typename K, typename T = typename K::T>
__global__ void __launch_bounds__(kThreads)
stiffness_apply_t_kernel(const T* __restrict__ grads, const T* __restrict__ vols,
                         const T* __restrict__ x, const T* __restrict__ free, T* __restrict__ y,
                         Plan p, int groups, int B, int rows, int nodes, int closure, T lam,
                         T mu) {
  constexpr int LANES = K::kLanes;
  constexpr int W = 3 * LANES;               // values a row: (component, lane)
  constexpr int kChunk = kThreads / LANES;   // tets a chunk: a (tet, lane) a thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* stage = reinterpret_cast<T*>(smem_raw);  // two buffers of rows x W
  T* acc = stage + 2 * rows * W;              // the tile's running sums, (node, component, lane)
  T* cl = acc + nodes * W;                    // the closure's u = x * free, (node, component, lane)
  int* segbuf = reinterpret_cast<int*>(cl + closure * W);  // two buffers of a chunk's segments
  const int tile = blockIdx.x / groups;
  const int g = blockIdx.x - tile * groups;
  const int l0 = __ldg(p.tstart + tile), l1 = __ldg(p.tstart + tile + 1);
  const int q0 = __ldg(p.qbase + tile), nq = __ldg(p.qbase + tile + 1) - q0;
  const int o0 = __ldg(p.ostart + tile), nvals = (__ldg(p.ostart + tile + 1) - o0) * W;
  const int c0 = __ldg(p.cstart + tile);
  const int ncl = closure > 0 ? (__ldg(p.cstart + tile + 1) - c0) * W : 0;
  const int tl = threadIdx.x / LANES, lane = threadIdx.x - tl * LANES;
  const int bl = g * LANES + lane;  // this thread's lane of the B
  const int B3 = 3 * B;
  for (int i = threadIdx.x; i < ncl; i += kThreads) {  // the closure's u, once
    const int ln = i / W, v = i - ln * W, comp = v / LANES;
    const int n = __ldg(p.cnode + c0 + ln);
    T u = __ldg(x + static_cast<int64_t>(n) * B3 + comp * B + g * LANES + (v - comp * LANES));
    if (free != nullptr) u *= __ldg(free + n * 3 + comp);
    cl[i] = u;
  }
  for (int i = threadIdx.x; i < nvals; i += kThreads) acc[i] = T(0);
  __syncthreads();
  int sc = __ldg(p.qseg + q0);  // chunk c's segments are [sc, qseg[q0 + c + 1])
  int n_prev = 0;               // chunk c-1's segment count
  // phase c: add chunk c-1's rows (c > 0), then evaluate chunk c (c < nq)
  for (int c = 0; c <= nq; ++c) {
    if (c > 0) {  // chunk c-1's rows, each segment's in order, onto its node's sum
      const T* st = stage + ((c - 1) & 1) * rows * W;
      const int* sg = segbuf + ((c - 1) & 1) * rows;
      for (int i = threadIdx.x; i < n_prev * W; i += kThreads) {
        const int si = i / W, v = i - si * W;
        const int w = sg[si];
        const int r1 = static_cast<int>(static_cast<uint32_t>(w) >> 16);
        const int r0 = si == 0 ? 0 : static_cast<int>(static_cast<uint32_t>(sg[si - 1]) >> 16);
        T* a = acc + (w & 0xffff) * W + v;
        T sum = *a;
        for (int r = r0; r < r1; ++r) sum += st[r * W + v];
        *a = sum;
      }
    }
    if (c == nq) break;
    const int sd = __ldg(p.qseg + q0 + c + 1);
    const int n_now = sd - sc;  // chunk c's segments, to shared memory for phase c+1
    const int sw = threadIdx.x < n_now ? __ldg(p.seg + sc + threadIdx.x) : 0;
    const int l = l0 + c * kChunk + tl;
    if (tl < kChunk && l < l1) {
      const int t = __ldg(p.ttet + l);
      const short4 d4 = __ldg(p.dst + l);
      const int dd[4] = {d4.x, d4.y, d4.z, d4.w};
      const T* gp = grads + static_cast<int64_t>(t) * 12 * B + bl;
      T g_[4][3], ue[4][3], s[3][3];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
#pragma unroll
        for (int k = 0; k < 3; ++k) g_[a][k] = __ldg(gp + (a * 3 + k) * B);
      }
      const T vol = __ldg(vols + static_cast<int64_t>(t) * B + bl);
      if (closure > 0) {  // u from the staged closure
        const short4 n4 = __ldg(p.lnode + l);
        const int ln[4] = {n4.x, n4.y, n4.z, n4.w};
#pragma unroll
        for (int a = 0; a < 4; ++a) {
#pragma unroll
          for (int e = 0; e < 3; ++e) ue[a][e] = cl[ln[a] * W + e * LANES + lane];
        }
      } else {  // u = x * free of the corners, from device memory
        const int4 ids = __ldg(p.lids + l);
        const int id[4] = {ids.x, ids.y, ids.z, ids.w};
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const T* xp = x + static_cast<int64_t>(id[a]) * B3 + bl;
#pragma unroll
          for (int e = 0; e < 3; ++e) {
            ue[a][e] = __ldg(xp + e * B);
            if (free != nullptr) ue[a][e] *= __ldg(free + id[a] * 3 + e);
          }
        }
      }
      tet4_stress(g_, ue, lam, mu, s);
      T* st = stage + (c & 1) * rows * W + lane;
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        if (dd[a] >= 0) {
          T* o = st + dd[a] * W;
#pragma unroll
          for (int d = 0; d < 3; ++d) {
            o[d * LANES] = vol * (s[d][0] * g_[a][0] + s[d][1] * g_[a][1] + s[d][2] * g_[a][2]);
          }
        }
      }
    }
    int* sg = segbuf + (c & 1) * rows;
    if (threadIdx.x < n_now) sg[threadIdx.x] = sw;
    for (int i = threadIdx.x + kThreads; i < n_now; i += kThreads) sg[i] = __ldg(p.seg + sc + i);
    n_prev = n_now;
    sc = sd;
    __syncthreads();
  }
  __syncthreads();  // the last chunk's sums
  for (int i = threadIdx.x; i < nvals; i += kThreads) {
    const int nl = i / W, v = i - nl * W, comp = v / LANES;
    const int n = __ldg(p.onode + o0 + nl);
    const int64_t o = static_cast<int64_t>(n) * B3 + comp * B + g * LANES + (v - comp * LANES);
    if (free != nullptr) {
      const T m = __ldg(free + n * 3 + comp);
      y[o] = acc[i] * m + __ldg(x + o) * (T(1) - m);
    } else {
      y[o] = acc[i];
    }
  }
}

// The launch's sizes, as the plan's `dims` holds them.
struct Dims {
  int n_blocks, groups, lanes, B, rows, nodes, closure;
};

template <typename T, int LANES>
int launch_lanes(const T* grads, const T* vols, const T* x, const T* free, T* y, const Plan& p,
                 const Dims& d, int bytes, T lam, T mu, cudaStream_t stream) {
  using K = Lanes<T, LANES>;
  static bool opted_in = false;  // once per kernel: the plan may ask for more than 48 KB
  if (!opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(stiffness_apply_t_kernel<K>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               kMaxSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    opted_in = true;
  }
  stiffness_apply_t_kernel<K><<<d.n_blocks, kThreads, bytes, stream>>>(
      grads, vols, x, free, y, p, d.groups, d.B, d.rows, d.nodes, d.closure, lam, mu);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* grads, const void* vols, const void* x, const void* free, void* y,
           const void* const* plan, const int* dims, double lam, double mu, void* stream) {
  const Dims d{dims[0], dims[1], dims[2], dims[3], dims[4], dims[5], dims[6]};
  const long long bytes =
      (2LL * d.rows + d.nodes + d.closure) * 3 * d.lanes * static_cast<long long>(sizeof(T)) +
      2LL * d.rows * static_cast<long long>(sizeof(int));
  if (bytes > kMaxSmem || d.lanes * d.groups != d.B || d.lanes < 1 || d.lanes > 8)
    return static_cast<int>(cudaErrorInvalidValue);
  if (d.n_blocks == 0) return static_cast<int>(cudaGetLastError());
  const Plan p{static_cast<const int32_t*>(plan[0]), static_cast<const short4*>(plan[1]),
               static_cast<const short4*>(plan[2]), static_cast<const int32_t*>(plan[3]),
               static_cast<const int32_t*>(plan[4]), static_cast<const int32_t*>(plan[5]),
               static_cast<const int32_t*>(plan[6]), static_cast<const int32_t*>(plan[7]),
               static_cast<const int32_t*>(plan[8]), static_cast<const int32_t*>(plan[9]),
               static_cast<const int32_t*>(plan[10]), static_cast<const int4*>(plan[11])};
  const T* g = static_cast<const T*>(grads);
  const T* v = static_cast<const T*>(vols);
  const T* xx = static_cast<const T*>(x);
  const T* f = static_cast<const T*>(free);
  T* yy = static_cast<T*>(y);
  const int b = static_cast<int>(bytes);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T l = static_cast<T>(lam), m = static_cast<T>(mu);
  switch (d.lanes) {
    case 1: return launch_lanes<T, 1>(g, v, xx, f, yy, p, d, b, l, m, s);
    case 2: return launch_lanes<T, 2>(g, v, xx, f, yy, p, d, b, l, m, s);
    case 3: return launch_lanes<T, 3>(g, v, xx, f, yy, p, d, b, l, m, s);
    case 4: return launch_lanes<T, 4>(g, v, xx, f, yy, p, d, b, l, m, s);
    case 5: return launch_lanes<T, 5>(g, v, xx, f, yy, p, d, b, l, m, s);
    case 6: return launch_lanes<T, 6>(g, v, xx, f, yy, p, d, b, l, m, s);
    case 7: return launch_lanes<T, 7>(g, v, xx, f, yy, p, d, b, l, m, s);
    default: return launch_lanes<T, 8>(g, v, xx, f, yy, p, d, b, l, m, s);
  }
}

}  // namespace

// grads (T,4,3,B), vols (T,B), x, y (N,3,B), free (N,3) or null, all
// contiguous on the device, the float tensors of one dtype; `plan` a host
// array of the plan's 12 device arrays in Plan's order (lnode and dst
// 8-byte, lids 16-byte aligned; lnode null where closure is 0, lids null
// where it is not), `dims` a host array of 7 ints: n_blocks
// (tiles x groups), groups, lanes (B / groups, 1 to 8), B, rows (staging
// rows a chunk, at most 4 x kThreads / lanes), nodes (the most nodes a tile
// owns) and closure (the most nodes of a tile's tets, or 0: u read from
// device memory, not staged): (2 rows + nodes + closure) x 3 x lanes values
// and 2 rows ints within a Hopper block's 232,448 bytes of shared memory.
// The plan's values are trusted. Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue where the sizes do not fit).
extern "C" int tpufem_stiffness_apply_t_tiled_f32(const void* grads, const void* vols,
                                                  const void* x, const void* free, void* y,
                                                  const void* const* plan, const int* dims,
                                                  double lam, double mu, void* stream) {
  return launch<float>(grads, vols, x, free, y, plan, dims, lam, mu, stream);
}

extern "C" int tpufem_stiffness_apply_t_tiled_f64(const void* grads, const void* vols,
                                                  const void* x, const void* free, void* y,
                                                  const void* const* plan, const int* dims,
                                                  double lam, double mu, void* stream) {
  return launch<double>(grads, vols, x, free, y, plan, dims, lam, mu, stream);
}
