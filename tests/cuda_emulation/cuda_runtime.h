// A CPU stand-in for the parts of the CUDA runtime that tpufem_torch/csrc's
// kernels use, so that their sources compile with g++ and run on the host:
// each block's threads run as std::threads (__syncthreads a barrier among
// them, __shared__ one copy per kernel, the dynamic shared memory one buffer
// filled with NaN bytes before each block), the blocks one after another in
// a seeded shuffled order, so that a schedule's order never decides a result.
// Device loads and stores, fences and atomics are plain host operations.
// tests/test_torch_tet10_kernels_host.py rewrites each `kernel<<<grid, block,
// smem, stream>>>(args)` launch into emu_launch and the extern dynamic
// shared array into emu_smem before it compiles a source.
#pragma once
#include <algorithm>
#include <atomic>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <functional>
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

template <class T>
T __ldg(const T* p) { return *p; }
template <class T>
T __ldcg(const T* p) { return *p; }
template <class T>
void __stcg(T* p, T v) { *p = v; }
inline void __threadfence() { std::atomic_thread_fence(std::memory_order_seq_cst); }
inline unsigned atomicAdd(unsigned* p, unsigned v) { return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST); }
inline int atomicOr(int* p, int v) { return __atomic_fetch_or(p, v, __ATOMIC_SEQ_CST); }

struct EmuBarrier {
  std::mutex m;
  std::condition_variable cv;
  int n, count = 0;
  long gen = 0;
  explicit EmuBarrier(int n_) : n(n_) {}
  void wait() {
    std::unique_lock<std::mutex> l(m);
    const long g = gen;
    if (++count == n) {
      count = 0;
      ++gen;
      cv.notify_all();
    } else {
      cv.wait(l, [&] { return gen != g; });
    }
  }
};
inline EmuBarrier* emu_barrier = nullptr;
inline void __syncthreads() { emu_barrier->wait(); }
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
  for (const dim3& b : blocks) {
    std::memset(emu_smem, 0xff, sizeof(emu_smem));  // NaN where a kernel reads what it never wrote
    EmuBarrier bar(threads);
    emu_barrier = &bar;
    std::vector<std::thread> ts;
    for (int t = 0; t < threads; ++t)
      ts.emplace_back([&, t] {
        threadIdx = dim3(t);
        blockIdx = b;
        body();
      });
    for (auto& th : ts) th.join();
  }
}
