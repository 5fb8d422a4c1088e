// Kernel M: the p-multigrid transfers between the tet4 grid and the doubled
// tet10 grid, one launch each way.
//
// Replaces tpufem/fem/tet10_stencil.py:301 prolong_p and :316 restrict_p (jnp
// code that XLA fused on the TPU; ~20 PyTorch launches each in the plain
// version), applied once each per tet10 V-cycle.
//
// prolong_p: x4 (3,B,NI,NK,NJ), the tet4 grid in active form, to the doubled
// grid y (3,B,NI2,NK2,NJ2): the P1 embedding into P2. A thread per doubled
// position reads the tet4 weld spread S (weld rows i = 0 and, with weld_te,
// i = NI - 1 read layer k = 0); an all-even position (2I, 2K, 2J) copies node
// (I, K, J), any other parity pattern o is the midpoint of the lattice edge
// (I, I + o) and takes 0.5 * (x(I) + x(I + o)). The result is multiplied by
// the duplicate mask dup2 (1,1,NI2,NK2,NJ2) and the root mask free2 (NJ2).
//
// restrict_p: its exact transpose, written as a gather. Tet4 node (I, K, J)
// adds to its own position's value half of each incident edge midpoint: for
// each of the 7 positive lattice offsets o in the order of
// tpufem_torch/fem/tet10_stencil.py::_POS_OFFSETS, the midpoint 2I + o (node
// I the edge's low end) and then 2I - o (its high end), each where it lies on
// the grid. Then the tet4 weld reduce R (the node at k = 0 of a weld row takes
// its column's sum in k order, the others zero) and the root mask free4 (NJ).
// No atomics: two calls give the same bits.
//
// Bytes bind both: at the flagship (96 x 128 x 8 cells, B = 1) restrict_p
// reads 20.2 MB and writes 2.7 MB in f64, a 6.85 us bound. Its design: a block
// per tile of TIr node rows x TJr node columns at full thickness of one
// component of one lane (the tile is the caller's choice:
// tpufem_torch/fem/tet10_stencil.py::m_plan). The block stages the doubled
// rows its nodes read, i2 in [2 I0 - 1, 2 (I0 + TIr) - 1] at every k2 and a
// contiguous j2 run, into shared memory with 16-byte asynchronous copies, all
// in flight at once (each staged row keeps its element offset modulo 16
// bytes, so aligned chunks stay aligned; a chunk may hold up to 15 bytes
// beyond the run, in the same 16 bytes of the tensor's allocation),
// then a thread per node sums its share from shared memory, weld rows
// included, in the same order and with the same operations as a lone thread
// would; a weld row's nodes leave their shares in shared memory and, after a
// barrier, the k = 0 thread of each weld column sums them in k order. Every
// index is 32-bit; the wrappers check that every operand has fewer than 2^31
// elements.

#include <cuda_runtime.h>
#include <string.h>

#include "grid_tet.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kNodeCols = 16;   // restrict_p: the most node columns of a tile (a thread each)
constexpr int kMaxRows = 1024;  // restrict_p: the most staged doubled rows of a tile

// the 7 positive lattice offsets (di, dj, dk), in _POS_OFFSETS' order
__device__ __forceinline__ int off_di(int o) { return o >= 3; }
__device__ __forceinline__ int off_dj(int o) { constexpr int v[7] = {0, 1, 1, 0, 0, 1, 1}; return v[o]; }
__device__ __forceinline__ int off_dk(int o) { constexpr int v[7] = {1, 0, 1, 0, 1, 0, 1}; return v[o]; }

template <typename T>
__global__ void __launch_bounds__(kThreads)
    prolong_p_kernel(const T* __restrict__ x4, const T* __restrict__ dup2,
                     const T* __restrict__ free2, T* __restrict__ y, int B, int NI, int NK, int NJ,
                     int weld_te) {
  const int NI2 = 2 * NI - 1, NK2 = 2 * NK - 1, NJ2 = 2 * NJ - 1;
  const int plane2 = NI2 * NK2 * NJ2, plane4 = NI * NK * NJ;
  const int n = blockIdx.x * kThreads + threadIdx.x;
  if (n >= B * plane2) return;
  const int j2 = n % NJ2, r = n / NJ2;
  const int k2 = r % NK2, rk = r / NK2;
  const int i2 = rk % NI2, b = rk / NI2;
  const int I = i2 >> 1, K = k2 >> 1, J = j2 >> 1;
  const int oi = i2 & 1, ok = k2 & 1, oj = j2 & 1;
  const int pos = (i2 * NK2 + k2) * NJ2 + j2;
  const T m = __ldg(dup2 + pos) * __ldg(free2 + j2);
  const int na = b * plane4 + (I * NK + grid_tet::weld_k(I, K, NI, weld_te)) * NJ + J;
  const int nb = b * plane4 +
                 ((I + oi) * NK + grid_tet::weld_k(I + oi, K + ok, NI, weld_te)) * NJ + J + oj;
  const bool corner = (oi | ok | oj) == 0;
#pragma unroll
  for (int e = 0; e < 3; ++e) {
    const T* xe = x4 + e * B * plane4;
    const T a = __ldg(xe + na);
    const T v = corner ? a : T(0.5) * (a + __ldg(xe + nb));
    y[e * B * plane2 + b * plane2 + pos] = v * m;
  }
}

template <typename T>
__device__ __forceinline__ int align_of(const T* p) {  // p's element offset modulo 16 bytes
  return static_cast<int>((reinterpret_cast<size_t>(p) / sizeof(T)) & (16 / sizeof(T) - 1));
}

// 16 bytes from global to shared memory, asynchronously (cp.async, through L2
// only): a thread issues all its copies before it waits for any
__device__ __forceinline__ void copy16_async(void* smem, const void* gmem) {
#ifdef __CUDA_ARCH__
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
#else
  memcpy(smem, gmem, 16);
#endif
}

__device__ __forceinline__ void copy_async_wait_all() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_all;\n" ::);
#endif
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    restrict_p_kernel(const T* __restrict__ r2, const T* __restrict__ free4, T* __restrict__ y4,
                      int NI, int NK, int NJ, int weld_te, int TIr, int TJr) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int row_at[kMaxRows];  // staged row (i2 - i2lo) * NK2 + k2: its element j2 at j2 + row_at
  constexpr int V = 16 / sizeof(T);
  const int NI2 = 2 * NI - 1, NK2 = 2 * NK - 1, NJ2 = 2 * NJ - 1;
  const int plane2 = NI2 * NK2 * NJ2, plane4 = NI * NK * NJ;
  const T* re = r2 + blockIdx.z * plane2;  // blockIdx.z = e * B + b
  T* ye = y4 + blockIdx.z * plane4;
  const int I0 = blockIdx.y * TIr, J0 = blockIdx.x * TJr;
  const int ni = min(TIr, NI - I0), nj = min(TJr, NJ - J0);
  const int i2lo = max(2 * I0 - 1, 0), i2hi = min(2 * (I0 + ni) - 1, NI2 - 1);
  const int j2lo = max(2 * J0 - 1, 0), j2hi = min(2 * (J0 + nj) - 1, NJ2 - 1);
  const int RS = ((2 * TJr + 1 + V - 1 + V - 1) / V) * V;  // a staged row's stride
  T* S = reinterpret_cast<T*>(smem_raw);                    // [row][RS]
  T* W = S + (2 * TIr + 1) * NK2 * RS;                      // weld rows' shares [li][K][lj]

  // ---- stage rows (i2, k2), j2 in [j2lo, j2hi], a thread per 16-byte chunk:
  // the row's element j2 lands at j2 - j2lo + a, a the run's element offset
  // modulo 16 bytes
  const int rows = (i2hi - i2lo + 1) * NK2, nseg = j2hi - j2lo + 1, cpr = RS / V;
  for (int n = threadIdx.x; n < rows * cpr; n += kThreads) {
    const int row = n / cpr, ch = n - row * cpr, di2 = row / NK2;
    const T* src = re + ((i2lo + di2) * NK2 + row - di2 * NK2) * NJ2 + j2lo;
    const int a = align_of(src);
    if (ch == 0) row_at[row] = row * RS + a - j2lo;
    if (ch * V < a + nseg) copy16_async(S + row * RS + ch * V, src - a + ch * V);
  }
  copy_async_wait_all();
  __syncthreads();

  // ---- every node's share, in the order of a lone thread's gather: its
  // position, then for each positive offset o the midpoints 2I + o and 2I - o
  const int tx = threadIdx.x % kNodeCols, ty = threadIdx.x / kNodeCols;
  for (int r = ty; r < ni * NK && tx < nj; r += kThreads / kNodeCols) {
    const int li = r / NK, K = r % NK, I = I0 + li, J = J0 + tx;
    auto at = [&](int i2, int k2, int j2) { return S[row_at[(i2 - i2lo) * NK2 + k2] + j2]; };
    T v = at(2 * I, 2 * K, 2 * J);
#pragma unroll
    for (int o = 0; o < 7; ++o) {
      const int di = off_di(o), dj = off_dj(o), dk = off_dk(o);
      if (I + di < NI && K + dk < NK && J + dj < NJ) v += T(0.5) * at(2 * I + di, 2 * K + dk, 2 * J + dj);
      if (I - di >= 0 && K - dk >= 0 && J - dj >= 0) v += T(0.5) * at(2 * I - di, 2 * K - dk, 2 * J - dj);
    }
    if (grid_tet::weld_row(I, NI, weld_te))
      W[(li * NK + K) * nj + tx] = v;
    else
      ye[(I * NK + K) * NJ + J] = v * __ldg(free4 + J);
  }
  __syncthreads();

  // ---- the weld rows: each column's sum in k order at k = 0, zero above
  for (int n = threadIdx.x; n < ni * nj; n += kThreads) {
    const int lj = n % nj, li = n / nj, I = I0 + li, J = J0 + lj;
    if (!grid_tet::weld_row(I, NI, weld_te)) continue;
    const T fr = __ldg(free4 + J);
    T v = T(0);
    for (int K = 0; K < NK; ++K) v += W[(li * NK + K) * nj + lj];
    ye[I * NK * NJ + J] = v * fr;
    for (int K = 1; K < NK; ++K) ye[(I * NK + K) * NJ + J] = T(0) * fr;
  }
}

bool grid_ok(int B, int NI, int NK, int NJ) { return B > 0 && NI >= 2 && NK >= 2 && NJ >= 2; }

template <typename T>
int prolong(const void* x4, const void* dup2, const void* free2, void* y, int B, int NI, int NK,
            int NJ, int weld_te, void* stream) {
  if (!grid_ok(B, NI, NK, NJ)) return static_cast<int>(cudaErrorInvalidValue);
  const int n = B * (2 * NI - 1) * (2 * NK - 1) * (2 * NJ - 1);
  prolong_p_kernel<T><<<(n + kThreads - 1) / kThreads, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x4), static_cast<const T*>(dup2), static_cast<const T*>(free2),
      static_cast<T*>(y), B, NI, NK, NJ, weld_te);
  return static_cast<int>(cudaGetLastError());
}

// restrict_p's shared memory at tile (TIr, TJr) (m_plan computes the same)
template <typename T>
size_t restrict_smem(int NK, int TIr, int TJr) {
  constexpr int V = 16 / sizeof(T);
  const size_t RS = ((2 * TJr + 1 + V - 1 + V - 1) / V) * V;
  return ((2 * TIr + 1) * (2 * NK - 1) * RS + static_cast<size_t>(TIr) * NK * TJr) * sizeof(T);
}

// a Hopper block's, less the static row table and headroom
constexpr int kMaxSmem = 232448 - 1024 - kMaxRows * 4;

template <typename T>
int restrict_(const void* r2, const void* free4, void* y4, int B, int NI, int NK, int NJ,
              int weld_te, int TIr, int TJr, void* stream) {
  if (!grid_ok(B, NI, NK, NJ) || TIr < 1 || TJr < 1 || TIr > NI || TJr > NJ ||
      TJr > kNodeCols || (2 * TIr + 1) * (2 * NK - 1) > kMaxRows)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = restrict_smem<T>(NK, TIr, TJr);
  if (smem > static_cast<size_t>(kMaxSmem)) return static_cast<int>(cudaErrorInvalidValue);
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      restrict_p_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (opt_in != cudaSuccess) return static_cast<int>(opt_in);
  const dim3 grid((NJ + TJr - 1) / TJr, (NI + TIr - 1) / TIr, 3 * B);
  restrict_p_kernel<T><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(r2), static_cast<const T*>(free4), static_cast<T*>(y4), NI, NK, NJ,
      weld_te, TIr, TJr);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// All tensors contiguous on the device, of one dtype; (NI, NK, NJ) is the
// tet4 grid. Returns cudaGetLastError() after the launch.
extern "C" int tpufem_prolong_p_f32(const void* x4, const void* dup2, const void* free2, void* y,
                                    int B, int NI, int NK, int NJ, int weld_te, void* stream) {
  return prolong<float>(x4, dup2, free2, y, B, NI, NK, NJ, weld_te, stream);
}

extern "C" int tpufem_prolong_p_f64(const void* x4, const void* dup2, const void* free2, void* y,
                                    int B, int NI, int NK, int NJ, int weld_te, void* stream) {
  return prolong<double>(x4, dup2, free2, y, B, NI, NK, NJ, weld_te, stream);
}

// (TIr, TJr): restrict_p's tile of tet4 node rows and columns (m_plan).
extern "C" int tpufem_restrict_p_tiled_f32(const void* r2, const void* free4, void* y4, int B,
                                           int NI, int NK, int NJ, int weld_te, int TIr, int TJr,
                                           void* stream) {
  return restrict_<float>(r2, free4, y4, B, NI, NK, NJ, weld_te, TIr, TJr, stream);
}

extern "C" int tpufem_restrict_p_tiled_f64(const void* r2, const void* free4, void* y4, int B,
                                           int NI, int NK, int NJ, int weld_te, int TIr, int TJr,
                                           void* stream) {
  return restrict_<double>(r2, free4, y4, B, NI, NK, NJ, weld_te, TIr, TJr, stream);
}
