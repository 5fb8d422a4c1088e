// A CPU stand-in for the parts of the CUDA runtime that tpufem_torch/csrc's
// kernels use, so that their sources compile with g++ and run on the host:
// each block's threads run as std::threads (__syncthreads a barrier among
// them, __shfl_sync one among the lanes its mask names, __shared__ one copy
// per kernel, the dynamic shared memory one buffer filled with NaN bytes
// before each block), the blocks one after another in a seeded shuffled
// order, so that a schedule's order never decides a result. The threads are
// made once a launch and run every block in turn.
// Device loads and stores, fences and atomics are plain host operations; the
// rounding intrinsics (__fma_rn) are std::fma.
// tests/test_torch_tet10_kernels_host.py rewrites each `kernel<<<grid, block,
// smem, stream>>>(args)` launch into emu_launch and the extern dynamic
// shared array into emu_smem before it compiles a source.
#pragma once
#include <linux/futex.h>
#include <sys/syscall.h>
#include <unistd.h>

#include <algorithm>
#include <climits>
#include <atomic>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <functional>
#include <map>
#include <memory>
#include <mutex>
#include <random>
#include <thread>
#include <vector>

using std::max;
using std::min;
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __constant__
#define __shared__ static
#define __launch_bounds__(...)
#define __align__(n) alignas(n)

struct dim3 {
  unsigned x = 1, y = 1, z = 1;
  dim3() {}
  dim3(unsigned a, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
inline thread_local dim3 threadIdx, blockIdx;
inline dim3 gridDim, blockDim;
struct alignas(16) float4 { float x, y, z, w; };
inline float4 make_float4(float x, float y, float z, float w) { return {x, y, z, w}; }
struct alignas(16) double2 { double x, y; };
struct alignas(16) int4 { int x, y, z, w; };
inline int4 make_int4(int x, int y, int z, int w) { return {x, y, z, w}; }
struct alignas(8) short4 { short x, y, z, w; };
inline short4 make_short4(short x, short y, short z, short w) { return {x, y, z, w}; }
typedef void* cudaStream_t;
typedef int cudaError_t;
enum {
  cudaSuccess = 0,
  cudaErrorInvalidValue = 1,
  cudaFuncAttributeMaxDynamicSharedMemorySize = 8,
  cudaDevAttrMultiProcessorCount = 16
};
template <class F>
cudaError_t cudaFuncSetAttribute(F, int, int) { return cudaSuccess; }
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return cudaSuccess; }
inline cudaError_t cudaDeviceGetAttribute(int* v, int, int) { *v = 132; return cudaSuccess; }

inline double __fma_rn(double a, double b, double c) { return std::fma(a, b, c); }
inline float __fmaf_rn(float a, float b, float c) { return std::fma(a, b, c); }
template <class T>
T __ldg(const T* p) { return *p; }
template <class T>
T __ldcg(const T* p) { return *p; }
template <class T>
void __stcg(T* p, T v) { *p = v; }
inline void __threadfence() { std::atomic_thread_fence(std::memory_order_seq_cst); }
inline unsigned atomicAdd(unsigned* p, unsigned v) { return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST); }
inline int atomicOr(int* p, int v) { return __atomic_fetch_or(p, v, __ATOMIC_SEQ_CST); }

// A generation-counting barrier: a waiter yields a few times, then sleeps on
// the generation word (a futex) until the last arrival bumps it and wakes
// every sleeper with one call. (A condition variable's wake-ups of a block's
// 256 threads, one after another through its mutex, cost milliseconds a
// barrier; pure spinning starves the other test processes of the CPU.)
struct EmuBarrier {
  std::atomic<int> count{0};
  std::atomic<int> gen{0};
  int n;
  explicit EmuBarrier(int n_) : n(n_) {}
  void wait() {
    const int g = gen.load(std::memory_order_acquire);
    if (count.fetch_add(1, std::memory_order_acq_rel) + 1 == n) {
      count.store(0, std::memory_order_relaxed);
      gen.fetch_add(1, std::memory_order_release);
      syscall(SYS_futex, reinterpret_cast<int*>(&gen), FUTEX_WAKE_PRIVATE, INT_MAX, nullptr,
              nullptr, 0);
    } else {
      for (int i = 0; i < 16 && gen.load(std::memory_order_acquire) == g; ++i)
        std::this_thread::yield();
      while (gen.load(std::memory_order_acquire) == g)
        syscall(SYS_futex, reinterpret_cast<int*>(&gen), FUTEX_WAIT_PRIVATE, g, nullptr, nullptr, 0);
    }
  }
};
inline EmuBarrier* emu_barrier = nullptr;
inline void __syncthreads() { emu_barrier->wait(); }

// The lanes a shuffle's mask names (a warp, or an aligned group of its lanes)
// meet at a barrier of their own to exchange values: every lane the mask
// names calls it, the same number of times (the sources keep a group's
// control flow uniform around a shuffle).
struct EmuWarp {
  std::mutex m;
  std::map<unsigned, std::unique_ptr<EmuBarrier>> bars;  // by mask
  long long slot[32];
  EmuBarrier& group(unsigned mask) {
    std::lock_guard<std::mutex> l(m);
    auto& b = bars[mask];
    if (!b) b.reset(new EmuBarrier(__builtin_popcount(mask)));
    return *b;
  }
};
inline thread_local EmuWarp* emu_warp = nullptr;
inline thread_local int emu_lane = 0;
template <class T>
T __shfl_sync(unsigned mask, T v, int src, int width = 32) {
  static_assert(sizeof(T) <= sizeof(long long), "a shuffle moves at most 8 bytes");
  EmuBarrier& bar = emu_warp->group(mask);
  long long bits = 0;
  std::memcpy(&bits, &v, sizeof(T));
  emu_warp->slot[emu_lane] = bits;
  bar.wait();
  bits = emu_warp->slot[(emu_lane & ~(width - 1)) + (src & (width - 1))];
  bar.wait();
  std::memcpy(&v, &bits, sizeof(T));
  return v;
}
alignas(16) inline unsigned char emu_smem[256 * 1024];
inline unsigned emu_seed = 1;

inline void emu_launch(dim3 grid, int threads, const std::function<void()>& body) {
  gridDim = grid;
  blockDim = dim3(threads);
  std::vector<dim3> blocks;
  for (unsigned z = 0; z < grid.z; ++z)
    for (unsigned y = 0; y < grid.y; ++y)
      for (unsigned x = 0; x < grid.x; ++x) blocks.push_back(dim3(x, y, z));
  std::mt19937 rng(emu_seed++);
  std::shuffle(blocks.begin(), blocks.end(), rng);
  // One std::thread per thread of a block, reused for every block in turn:
  // the threads of one block run together, the blocks one after another. A
  // barrier of its own (not __syncthreads') closes each block, after which
  // thread 0 fills the dynamic shared memory with NaN for the next.
  EmuBarrier bar(threads), boundary(threads);
  emu_barrier = &bar;
  std::vector<std::unique_ptr<EmuWarp>> warps;
  for (int t = 0; t < threads; t += 32) warps.emplace_back(new EmuWarp());
  std::memset(emu_smem, 0xff, sizeof(emu_smem));  // NaN where a kernel reads what it never wrote
  std::vector<std::thread> ts;
  for (int t = 0; t < threads; ++t)
    ts.emplace_back([&, t] {
      threadIdx = dim3(t);
      emu_warp = warps[t / 32].get();
      emu_lane = t % 32;
      for (const dim3& b : blocks) {
        blockIdx = b;
        body();
        boundary.wait();
        if (t == 0) std::memset(emu_smem, 0xff, sizeof(emu_smem));
        boundary.wait();
      }
    });
  for (auto& th : ts) th.join();
}
