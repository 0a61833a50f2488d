// The CUDA surface the port's kernels use, mapped onto C++20 threads, so
// that a kernel source under annotatedvdb_tpu_torch/csrc/ compiles with g++
// and runs on the CPU (tests/test_torch_cuda_sim.py).
//
// Model: blocks run one after another; a block's threads each run on a
// std::thread.  __syncthreads is a std::barrier of the block's threads, and
// a warp's collectives (__ballot_sync, __any_sync, __shfl_sync) go through a
// per-warp buffer between two waits on a std::barrier of the warp's
// threads.  A thread that returns drops out of both barriers, so threads
// that leave early do not hold up the rest.  __shared__ is `static`, which
// is enough while blocks run one at a time.  The device attributes are
// small (kSimSms SMs, kSimBlocksPerSm blocks each), so a grid sized to the
// card runs its grid-stride loops several times even on small inputs.
// Launches `k<<<grid, block, smem, stream>>>(args)` are rewritten by the
// test into `sim_launch(grid, block, k, args)`.

#pragma once

#include <algorithm>
#include <barrier>
#include <cstdint>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__ static

struct dim3 {
  unsigned x = 1, y = 1, z = 1;
  dim3(unsigned x_ = 1, unsigned y_ = 1, unsigned z_ = 1) : x(x_), y(y_), z(z_) {}
};

struct alignas(16) int4 {
  int x, y, z, w;
};

using cudaStream_t = void*;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16 };

constexpr int kSimSms = 3;
constexpr int kSimBlocksPerSm = 2;

inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline cudaError_t cudaGetDevice(int* dev) {
  *dev = 0;
  return cudaSuccess;
}
inline cudaError_t cudaDeviceGetAttribute(int* value, cudaDeviceAttr, int) {
  *value = kSimSms;
  return cudaSuccess;
}
template <typename K>
inline cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, K, int, size_t) {
  *n = kSimBlocksPerSm;
  return cudaSuccess;
}

inline dim3 gridDim, blockDim;
inline thread_local dim3 threadIdx, blockIdx;

struct SimWarp {
  explicit SimWarp(int n) : bar(n) {}
  std::barrier<> bar;
  uint32_t vals[32] = {};
};

struct SimThread {
  std::barrier<>* block = nullptr;
  SimWarp* warp = nullptr;
  int lane = 0;
};
inline thread_local SimThread sim_self;

template <typename T>
inline T __ldg(const T* p) { return *p; }

template <typename T>
inline T min(T a, T b) { return a < b ? a : b; }
template <typename T>
inline T max(T a, T b) { return a < b ? b : a; }

inline int __clz(int x) {
  return x == 0 ? 32 : __builtin_clz(static_cast<unsigned>(x));
}
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int __ffs(int x) { return __builtin_ffs(x); }

inline void __syncthreads() { sim_self.block->arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xffffffffu) { sim_self.warp->bar.arrive_and_wait(); }

// Every lane writes its word, all wait, each reads all, all wait again (so
// no lane overwrites a word another is still reading).
inline void sim_exchange(uint32_t mine, uint32_t* all) {
  SimWarp& w = *sim_self.warp;
  w.vals[sim_self.lane] = mine;
  w.bar.arrive_and_wait();
  std::memcpy(all, w.vals, sizeof(w.vals));
  w.bar.arrive_and_wait();
}

inline unsigned __ballot_sync(unsigned mask, int pred) {
  uint32_t all[32];
  sim_exchange(pred ? 1u : 0u, all);
  unsigned out = 0;
  for (int l = 0; l < 32; ++l) out |= all[l] << l;
  return out & mask;
}
inline bool __any_sync(unsigned mask, int pred) { return __ballot_sync(mask, pred) != 0; }
inline bool __all_sync(unsigned mask, int pred) {
  return __ballot_sync(mask, pred) == mask;
}
template <typename T>
inline T __shfl_sync(unsigned, T v, int src) {
  static_assert(sizeof(T) == 4, "32-bit shuffles only");
  uint32_t all[32], mine;
  std::memcpy(&mine, &v, 4);
  sim_exchange(mine, all);
  T out;
  std::memcpy(&out, &all[src & 31], 4);
  return out;
}

template <typename... P, typename... A>
void sim_launch(dim3 grid, dim3 block, void (*kernel)(P...), A... args) {
  gridDim = grid;
  blockDim = block;
  const int n = static_cast<int>(block.x * block.y * block.z);
  for (unsigned bz = 0; bz < grid.z; ++bz)
    for (unsigned by = 0; by < grid.y; ++by)
      for (unsigned bx = 0; bx < grid.x; ++bx) {
        std::barrier<> bar(n);
        std::vector<std::unique_ptr<SimWarp>> warps;
        for (int w = 0; w * 32 < n; ++w) {
          warps.push_back(std::make_unique<SimWarp>(std::min(32, n - 32 * w)));
        }
        std::vector<std::thread> threads;
        threads.reserve(n);
        for (int t = 0; t < n; ++t) {
          threads.emplace_back([&, t] {
            blockIdx = dim3(bx, by, bz);
            threadIdx = dim3(t % block.x, (t / block.x) % block.y,
                             t / (block.x * block.y));
            sim_self = {&bar, warps[t / 32].get(), t % 32};
            kernel(static_cast<P>(args)...);
            bar.arrive_and_drop();
            warps[t / 32]->bar.arrive_and_drop();
          });
        }
        for (auto& th : threads) th.join();
      }
}
