// Kernel E: deterministic segment sum over a fixed index list in CSR form
// (f32 and f64, any number of channels C).
//
// Replaces jax.ops.segment_sum over a topology-constant index list, which
// XLA fused on the TPU: the per-node sum of element forces and of the Jacobi
// diagonal (tpufem/fem/assembly.py:77,110), the pressure loads
// (tpufem/fem/loads.py:29), the nodal stress average (tpufem/fem/vonmises.py:
// 48-55), the line-block and RBM sums (tpufem/fem/precond.py:160,213-214,241,
// 267-268) and the stencil engine's load and stress sums.
//
//   out[s, c] = sum over r in [starts[s], starts[s+1]) of vals[order[r], c]
//
// `order` is a stable argsort of the rows' segment ids and `starts` the
// row offsets of each segment in that order, both built once per topology on
// the host (tpufem_torch/ops/csr_segment_sum.py::csr_plan).
//
// What bounds it on the card: bytes where rows are many (each value row read
// once, each output written once, one add per value), and the latency of a
// block's dependent loads where they are few. The plans it runs on are of
// three kinds: few long segments (the RBM group sum of the gather CG, ~100
// rows each, once per iteration), mostly empty segments (the loads), and
// many short ones (the incidence and connectivity sums, 7-24 rows).
//
// Design: a block per range of consecutive segments, the ranges cut on the
// host once per plan and row width (ops/csr_segment_sum.py::csr_ranges) so
// that a range of several segments stages at most 2048 rows and 32 KB of
// them and has at most 2048 outputs; a segment longer than that is a range
// of its own, streamed through shared memory in chunks. A block reads its
// row of the host-built range table (its bounds, its first chunk's row
// indices and, in a mostly empty plan, its segments with rows) in one
// coalesced round trip, then gathers the rows vals[order[r], :] into shared
// memory with cp.async (16-, 8- or 4-byte copies, every copy in flight at
// once, none held in registers). A range whose segments with rows are
// listed writes its outputs 0 in 16-byte stores meanwhile, and a thread per
// (listed segment, channel) adds and overwrites; another range reads its
// starts with the rows, writes its empty segments' outputs 0, and each
// thread adds the rows of its (segment, channel) outputs. The adds run from
// shared memory in `order` sequence, starting from zero. No atomics: two
// runs give the same bits, and the adds are taken in the order the plain
// version (and the first design, a thread per (segment, channel) walking
// its rows) takes them.

#include <cuda_runtime.h>
#include <stdint.h>

#include <string.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kOut = 8;           // outputs a thread owns: a range has <= kThreads * kOut
constexpr int kMaxSmem = 232448;  // a Hopper block's most shared memory

struct alignas(16) Unit16 {
  unsigned long long a, b;
};
struct alignas(8) Unit8 {
  unsigned long long a;
};
struct alignas(4) Unit4 {
  unsigned int a;
};

__host__ __device__ size_t chunk_bytes(int chunk_rows, int C, size_t itemsize) {
  return (static_cast<size_t>(chunk_rows) * C * itemsize + 15) & ~static_cast<size_t>(15);
}

// kBytes (4, 8 or 16) from global to shared memory, asynchronously
// (cp.async; 16 bytes through L2 only): a thread issues all its copies
// before it waits for any, and holds none of them in registers
template <int kBytes>
__device__ __forceinline__ void copy_async(void* smem, const void* gmem) {
#ifdef __CUDA_ARCH__
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if constexpr (kBytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
  else if constexpr (kBytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(gmem));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
#else
  memcpy(smem, gmem, kBytes);
#endif
}

__device__ __forceinline__ void copy_async_wait_all() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_all;\n" ::);
#endif
}

// Item threadIdx.x + m * kThreads of a row-major (rows, width) array, as
// (row, column), stepped one m at a time without a division.
struct Cursor {
  int row, col, q, rem, width;

  __device__ __forceinline__ Cursor(int width_, bool one) : width(width_) {
    q = one ? kThreads : kThreads / width;
    rem = one ? 0 : kThreads - q * width;
    row = one ? threadIdx.x : threadIdx.x / width;
    col = one ? 0 : threadIdx.x - row * width;
  }
  __device__ __forceinline__ void next() {
    row += q;
    col += rem;
    if (col >= width) {
      col -= width;
      ++row;
    }
  }
};

// The chunk's rows vals[ord[j]] (j < n_rows) into `rows`, in units of U
// (upr a row), every copy in flight at once.
template <typename U, bool kOne>
__device__ __forceinline__ void gather(const U* __restrict__ vals, const int32_t* ord, int n_rows,
                                       int upr, U* rows) {
  int i = threadIdx.x;
  for (Cursor c(upr, kOne); c.row < n_rows; c.next(), i += kThreads)
    copy_async<sizeof(U)>(rows + i, vals + static_cast<int64_t>(ord[c.row]) * upr + c.col);
}

// The row of the range table a block reads first: its range's first
// segment, first row, end segment and end row, the number of its segments
// with rows (or -1), 3 words of padding, the row indices order[r] of the
// range's first chunk (chunk_rows), then, in a table of a mostly empty plan
// (list_len > 0), the range's segments with rows (list_len, range-local) and
// their row offsets (list_len + 1, from the range's first row); padded to a
// multiple of 4 int32.
constexpr int kHead = 8;
__host__ __device__ int table_stride(int chunk_rows, int list_len) {
  return (kHead + chunk_rows + (list_len > 0 ? 2 * list_len + 1 : 0) + 3) / 4 * 4;
}

// tab: (n_ranges, table_stride(chunk_rows, list_len)) int32, a range per row
// (ops/csr_segment_sum.py::range_table); a range has at most kThreads * kOut
// outputs. kOne: C == 1 (then a row is one unit of the dtype).
//
// A block's range in two asynchronous round trips: its row of the table,
// a barrier, then the rows its indices name. Where the row lists the
// range's segments with rows (a mostly empty plan, all the range's rows in
// one chunk), the block writes all its outputs 0 in 16-byte stores while the
// rows are in flight; after a barrier a thread per (listed segment, channel)
// adds the segment's rows and overwrites its output. Otherwise the range's
// starts come with the rows; after a barrier the outputs of empty segments
// are written 0 and each thread adds the rows of its outputs of the other
// segments. Either way each sum is one thread's, in `order` sequence from
// zero. A range of one segment longer than a chunk stages and adds its
// later chunks in turn (their row indices from `order`), each output's
// partial sum carried in out by the thread that owns it.
template <typename T, typename U, bool kOne>
__device__ __forceinline__ void sum_range(const T* __restrict__ vals,
                                          const int32_t* __restrict__ order,
                                          const int32_t* __restrict__ starts,
                                          const int32_t* __restrict__ tab, T* __restrict__ out,
                                          int C, int chunk_rows, int list_len) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int stride = table_stride(chunk_rows, list_len);
  T* rows = reinterpret_cast<T*>(smem_raw);
  U* urows = reinterpret_cast<U*>(smem_raw);
  int32_t* trow = reinterpret_cast<int32_t*>(smem_raw + chunk_bytes(chunk_rows, C, sizeof(T)));
  int32_t* ord = trow + kHead;
  int32_t* st = trow + stride;
  const int32_t* my_row = tab + static_cast<int64_t>(blockIdx.x) * stride;
  for (int i = 4 * threadIdx.x; i < stride; i += 4 * kThreads)
    copy_async<16>(trow + i, my_row + i);
  copy_async_wait_all();
  __syncthreads();

  const int s0 = trow[0], r0 = trow[1], s1 = trow[2], r1 = trow[3];
  const int segs = s1 - s0, n_out = segs * C;
  const int upr = kOne ? 1 : C * static_cast<int>(sizeof(T)) / static_cast<int>(sizeof(U));
  const U* uvals = reinterpret_cast<const U*>(vals);
  T* o_base = out + static_cast<int64_t>(s0) * C;
  int hi = r1 - r0 > chunk_rows ? r0 + chunk_rows : r1;
  gather<U, kOne>(uvals, ord, hi - r0, upr, urows);
  const int n_listed = trow[4];
  if (n_listed >= 0) {  // the range's segments with rows are listed in its row
    const int64_t n_el = static_cast<int64_t>(segs) * C;
    const int64_t skew = ((16 - (reinterpret_cast<uintptr_t>(o_base) & 15)) & 15) / sizeof(T);
    const int head = static_cast<int>(skew < n_el ? skew : n_el);
    const int64_t n16 = (n_el - head) * static_cast<int64_t>(sizeof(T)) / 16;
    if (static_cast<int>(threadIdx.x) < head) o_base[threadIdx.x] = T(0);
    Unit16* body = reinterpret_cast<Unit16*>(o_base + head);
    for (int64_t j = threadIdx.x; j < n16; j += kThreads) body[j] = Unit16{0ull, 0ull};
    for (int64_t e = head + n16 * static_cast<int64_t>(16 / sizeof(T)) + threadIdx.x; e < n_el;
         e += kThreads)
      o_base[e] = T(0);
    copy_async_wait_all();
    __syncthreads();  // the rows are in, and every 0 is written before a sum overwrites it
    const int32_t* listed = ord + chunk_rows;
    const int32_t* from = listed + list_len;
    for (int q = threadIdx.x; q < n_listed * C; q += kThreads) {
      const int j = kOne ? q : q / C, c = kOne ? 0 : q - j * C;
      const T* x = rows + from[j] * C + c;
      T acc = T(0);
#pragma unroll 4
      for (int r = 0; r < from[j + 1] - from[j]; ++r) acc += x[r * C];
      o_base[static_cast<int64_t>(listed[j]) * C + c] = acc;
    }
    return;
  }
  for (int i = threadIdx.x; i <= segs; i += kThreads) copy_async<4>(st + i, starts + s0 + i);
  copy_async_wait_all();
  __syncthreads();

  // this thread's outputs threadIdx.x + k * kThreads: segment seg[k]; the
  // empty segments' written now, the others marked in `mask`
  int seg[kOut];
  unsigned mask = 0;
  Cursor oc(C, kOne);
#pragma unroll
  for (int k = 0; k < kOut; ++k) {
    const int p = threadIdx.x + k * kThreads;
    seg[k] = oc.row;
    oc.next();
    if (p < n_out) {
      if (st[seg[k]] == st[seg[k] + 1])
        o_base[p] = T(0);
      else
        mask |= 1u << k;
    }
  }
  for (int lo = r0;;) {
#pragma unroll
    for (int k = 0; k < kOut; ++k) {
      if (!(mask >> k & 1u)) continue;
      const int p = threadIdx.x + k * kThreads, s = seg[k];
      const int a = st[s], b = st[s + 1];
      if (a >= hi || b <= lo) continue;  // none of the segment's rows are in this chunk
      // from zero where the segment begins in this chunk, else from its partial sum
      T acc = a >= lo ? T(0) : o_base[p];
      const int first = a > lo ? a : lo, last = b < hi ? b : hi;
      const T* x = rows + (first - lo) * C + (p - s * C);
#pragma unroll 4
      for (int r = 0; r < last - first; ++r) acc += x[r * C];
      o_base[p] = acc;
    }
    if (hi >= r1) break;
    lo = hi;
    hi = r1 - lo > chunk_rows ? lo + chunk_rows : r1;
    __syncthreads();  // every thread is done with the last chunk's rows and indices
    for (int i = threadIdx.x; i < hi - lo; i += kThreads) copy_async<4>(ord + i, order + lo + i);
    copy_async_wait_all();
    __syncthreads();
    gather<U, kOne>(uvals, ord, hi - lo, upr, urows);
    copy_async_wait_all();
    __syncthreads();
  }
}

// The kernels, one per dtype: f64 with the registers the compiler chooses,
// f32 held to 64 registers a thread (4 resident blocks an SM). The f32 plans
// ran faster held; the f64 ones ran slower held, at the 31-55 registers the
// compiler then chose.
template <typename U, bool kOne>
__global__ void __launch_bounds__(kThreads)
    csr_segment_sum_kernel_f64(const double* __restrict__ vals, const int32_t* __restrict__ order,
                               const int32_t* __restrict__ starts,
                               const int32_t* __restrict__ tab, double* __restrict__ out, int C,
                               int chunk_rows, int list_len) {
  sum_range<double, U, kOne>(vals, order, starts, tab, out, C, chunk_rows, list_len);
}

template <typename U, bool kOne>
__global__ void __launch_bounds__(kThreads, 4)
    csr_segment_sum_kernel_f32(const float* __restrict__ vals, const int32_t* __restrict__ order,
                               const int32_t* __restrict__ starts,
                               const int32_t* __restrict__ tab, float* __restrict__ out, int C,
                               int chunk_rows, int list_len) {
  sum_range<float, U, kOne>(vals, order, starts, tab, out, C, chunk_rows, list_len);
}

template <typename T, typename U, bool kOne>
int launch_ranges(const void* vals, const void* order, const void* starts, const void* tab,
                  void* out, int C, int n_ranges, int chunk_rows, int list_len, size_t smem,
                  void* stream) {
  const auto v = static_cast<const T*>(vals);
  const auto o = static_cast<const int32_t*>(order);
  const auto st = static_cast<const int32_t*>(starts);
  const auto tb = static_cast<const int32_t*>(tab);
  const auto y = static_cast<T*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  if constexpr (sizeof(T) == 8) {
    static const cudaError_t opt_in = cudaFuncSetAttribute(
        csr_segment_sum_kernel_f64<U, kOne>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxSmem);
    if (opt_in != cudaSuccess) return static_cast<int>(opt_in);
    csr_segment_sum_kernel_f64<U, kOne><<<n_ranges, kThreads, smem, s>>>(v, o, st, tb, y, C,
                                                                         chunk_rows, list_len);
  } else {
    static const cudaError_t opt_in = cudaFuncSetAttribute(
        csr_segment_sum_kernel_f32<U, kOne>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxSmem);
    if (opt_in != cudaSuccess) return static_cast<int>(opt_in);
    csr_segment_sum_kernel_f32<U, kOne><<<n_ranges, kThreads, smem, s>>>(v, o, st, tb, y, C,
                                                                         chunk_rows, list_len);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* vals, const void* order, const void* starts, const void* tab, void* out,
           int C, int n_ranges, int chunk_rows, int range_segs, int list_len, void* stream) {
  if (C < 1 || C > kThreads * kOut || n_ranges < 0 || chunk_rows < 1 || range_segs < 1 ||
      range_segs * C > kThreads * kOut || list_len < 0 || list_len > range_segs)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t table_words = static_cast<size_t>(table_stride(chunk_rows, list_len));
  const size_t smem = chunk_bytes(chunk_rows, C, sizeof(T)) +
                      sizeof(int32_t) * (table_words + static_cast<size_t>(range_segs) + 1);
  if (smem > static_cast<size_t>(kMaxSmem)) return static_cast<int>(cudaErrorInvalidValue);
  if (n_ranges == 0) return static_cast<int>(cudaSuccess);
  const size_t row_bytes = static_cast<size_t>(C) * sizeof(T);
  const uintptr_t at = reinterpret_cast<uintptr_t>(vals);
  using One = typename std::conditional<sizeof(T) == 8, Unit8, Unit4>::type;
  if (C == 1)
    return launch_ranges<T, One, true>(vals, order, starts, tab, out, C, n_ranges, chunk_rows,
                                       list_len, smem, stream);
  if (row_bytes % 16 == 0 && at % 16 == 0)
    return launch_ranges<T, Unit16, false>(vals, order, starts, tab, out, C, n_ranges,
                                           chunk_rows, list_len, smem, stream);
  if (row_bytes % 8 == 0 && at % 8 == 0)
    return launch_ranges<T, Unit8, false>(vals, order, starts, tab, out, C, n_ranges, chunk_rows,
                                          list_len, smem, stream);
  return launch_ranges<T, Unit4, false>(vals, order, starts, tab, out, C, n_ranges, chunk_rows,
                                        list_len, smem, stream);
}

}  // namespace

// vals (R, C), order (R,) int32, starts (N+1,) int32, tab (n_ranges,
// table_stride(chunk_rows, list_len)) int32 (ops/csr_segment_sum.py::
// range_table), out (N, C); all contiguous on the device, vals and out of one
// dtype, vals at least 4-byte aligned, tab 16-byte aligned. chunk_rows: the
// rows a block stages at once (no range of more than one segment holds
// more); range_segs: the most segments in a range; list_len: the most
// segments with rows a table row lists (0: none listed); C <= 2048 and
// range_segs * C <= 2048. Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue on arguments the kernel does not take).
extern "C" int tpufem_csr_segment_sum_ranges_f32(const void* vals, const void* order,
                                                 const void* starts, const void* tab, void* out,
                                                 int C, int n_ranges, int chunk_rows,
                                                 int range_segs, int list_len, void* stream) {
  return launch<float>(vals, order, starts, tab, out, C, n_ranges, chunk_rows, range_segs,
                       list_len, stream);
}

extern "C" int tpufem_csr_segment_sum_ranges_f64(const void* vals, const void* order,
                                                 const void* starts, const void* tab, void* out,
                                                 int C, int n_ranges, int chunk_rows,
                                                 int range_segs, int list_len, void* stream) {
  return launch<double>(vals, order, starts, tab, out, C, n_ranges, chunk_rows, range_segs,
                        list_len, stream);
}
