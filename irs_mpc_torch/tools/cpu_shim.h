// A CUDA block emulated on the CPU, for checking the port's kernel sources
// where there is no GPU and no nvcc (tools/cpu_shim.py builds a source
// against this header with g++).  Every CUDA thread is an OS thread; the
// blocks of a grid run one after another.  __syncthreads() and
// __syncwarp() are barriers (of the block, of the warp); a shuffle writes
// its value to a per-warp buffer between two warp barriers.  Static
// __shared__ arrays become function statics (one block at a time), dynamic
// shared memory is a buffer filled with NaN before each block, so that a
// read before a write shows.  cp.async copies are plain copies.  The
// device reports `shim_smem_cap` bytes of opt-in shared memory.
#pragma once
#include <algorithm>
#include <cmath>
#include <condition_variable>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <functional>
#include <memory>
#include <mutex>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__ static

struct alignas(16) float4 { float x, y, z, w; };
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct shim_uint3 { unsigned x, y, z; };
inline thread_local shim_uint3 threadIdx{0, 0, 0};
inline thread_local shim_uint3 blockIdx{0, 0, 0};
inline thread_local dim3 blockDim;
inline thread_local dim3 gridDim;

typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
typedef void* cudaStream_t;
inline int cudaGetLastError() { return 0; }
inline const char* cudaGetErrorString(int e) {
  return e ? "invalid value (CPU shim)" : "no error";
}
inline int cudaGetDevice(int* d) { *d = 0; return 0; }
enum { cudaDevAttrMaxSharedMemoryPerBlockOptin = 97 };
inline int shim_smem_cap = 232448;   // an H100's
inline int cudaDeviceGetAttribute(int* v, int, int) {
  *v = shim_smem_cap;
  return 0;
}
enum { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
template <class F> int cudaFuncSetAttribute(F, int, int bytes) {
  return bytes > shim_smem_cap ? cudaErrorInvalidValue : 0;
}

struct ShimBarrier {
  std::mutex mu;
  std::condition_variable cv;
  int count = 0, waiting = 0;
  long gen = 0;
  void wait() {
    std::unique_lock<std::mutex> lk(mu);
    const long g = gen;
    if (++waiting == count) {
      waiting = 0;
      ++gen;
      cv.notify_all();
    } else {
      cv.wait(lk, [&] { return gen != g; });
    }
  }
};
struct ShimWarp { ShimBarrier bar; uint64_t buf[32]; };
struct ShimBlock {
  ShimBarrier block;
  std::vector<std::unique_ptr<ShimWarp>> warps;
};
inline thread_local ShimBlock* shim_block = nullptr;
inline char* shim_dyn = nullptr;
inline void* shim_dyn_smem() { return shim_dyn; }

inline ShimWarp& shim_warp() { return *shim_block->warps[threadIdx.x / 32]; }
inline void __syncthreads() { shim_block->block.wait(); }
inline void __syncwarp(unsigned = 0xffffffffu) { shim_warp().bar.wait(); }
template <class T> T shim_exchange(T v, int src) {
  ShimWarp& w = shim_warp();
  uint64_t u = 0;
  std::memcpy(&u, &v, sizeof(T));
  w.buf[threadIdx.x % 32] = u;
  w.bar.wait();
  const uint64_t r = w.buf[src & 31];
  w.bar.wait();
  T out;
  std::memcpy(&out, &r, sizeof(T));
  return out;
}
// With a width below 32 the warp is split into segments of that many
// lanes, each shuffling within itself, as on the card.
template <class T> T __shfl_sync(unsigned, T v, int src, int width = 32) {
  const int lane = threadIdx.x % 32;
  return shim_exchange(v, (lane & ~(width - 1)) + (src & (width - 1)));
}
template <class T> T __shfl_xor_sync(unsigned, T v, int mask, int width = 32) {
  const int lane = threadIdx.x % 32, src = lane ^ mask;
  return shim_exchange(v, src / width == lane / width ? src : lane);
}

inline void __pipeline_memcpy_async(void* dst, const void* src, size_t n) {
  std::memcpy(dst, src, n);
}
inline void __pipeline_commit() {}
inline void __pipeline_wait_prior(int) {}

inline void shim_launch(dim3 grid, dim3 block, size_t smem, cudaStream_t,
                        const std::function<void()>& body) {
  std::vector<float4> dyn(smem / sizeof(float4) + 1);
  for (unsigned b = 0; b < grid.x; ++b) {
    ShimBlock ctx;
    ctx.block.count = block.x;
    for (unsigned w = 0; w < (block.x + 31) / 32; ++w) {
      ctx.warps.emplace_back(new ShimWarp);
      ctx.warps.back()->bar.count = std::min(32u, block.x - 32 * w);
    }
    std::fill_n(reinterpret_cast<float*>(dyn.data()), dyn.size() * 4, NAN);
    shim_dyn = reinterpret_cast<char*>(dyn.data());
    std::vector<std::thread> threads;
    for (unsigned i = 0; i < block.x; ++i) {
      threads.emplace_back([&, i, b] {
        threadIdx = {i, 0, 0};
        blockIdx = {b, 0, 0};
        blockDim = block;
        gridDim = grid;
        shim_block = &ctx;
        body();
      });
    }
    for (auto& t : threads) t.join();
  }
}
