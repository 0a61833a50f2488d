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
// test into `sim_launch(grid, block, k, args)`; a kernel with dynamic
// shared memory reads `sim_dynamic_smem`, which the test's rewrite sizes
// with `sim_dynamic_smem_alloc` before the launch.  Hopper's TMA bulk
// copies and transaction-counting mbarriers, written in PTX in a source,
// are emulated by the `sim_mbar_*` and `sim_bulk_copy` functions, which a
// test substitutes for the source's own helpers: a copy is a memcpy that
// completes its barrier's pending bytes at once.

#pragma once

#include <algorithm>
#include <atomic>
#include <barrier>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <mutex>
#include <thread>
#include <unordered_map>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__ static
#define __align__(n) __attribute__((aligned(n)))

struct dim3 {
  unsigned x = 1, y = 1, z = 1;
  dim3(unsigned x_ = 1, unsigned y_ = 1, unsigned z_ = 1) : x(x_), y(y_), z(z_) {}
};

struct alignas(16) int4 {
  int x, y, z, w;
};
struct alignas(16) uint4 {
  unsigned x, y, z, w;
};

using cudaStream_t = void*;
enum cudaError_t {
  cudaSuccess = 0,
  cudaErrorInvalidValue = 1,
  cudaErrorInvalidConfiguration = 9,
  cudaErrorInvalidDevice = 101
};
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };

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

template <typename K>
inline cudaError_t cudaFuncSetAttribute(K, cudaFuncAttribute, int) {
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
inline uint32_t __funnelshift_r(uint32_t lo, uint32_t hi, uint32_t shift) {
  return static_cast<uint32_t>(((static_cast<uint64_t>(hi) << 32) | lo) >> (shift & 31));
}
// the documented selector: the low 3 bits of each of its four nibbles
inline uint32_t __byte_perm(uint32_t x, uint32_t y, uint32_t s) {
  const uint64_t src = x | (static_cast<uint64_t>(y) << 32);
  uint32_t d = 0;
  for (int i = 0; i < 4; ++i) {
    d |= static_cast<uint32_t>((src >> (8 * ((s >> (4 * i)) & 7))) & 0xFF) << (8 * i);
  }
  return d;
}
// PTX prmt.b32 in its generic mode: a selector nibble's high bit
// replicates the selected byte's sign
inline uint32_t sim_prmt(uint32_t a, uint32_t b, uint32_t sel) {
  const uint64_t src = a | (static_cast<uint64_t>(b) << 32);
  uint32_t d = 0;
  for (int i = 0; i < 4; ++i) {
    const uint32_t nib = (sel >> (4 * i)) & 15;
    uint32_t v = (src >> (8 * (nib & 7))) & 0xFF;
    if (nib & 8) v = (v & 0x80) ? 0xFF : 0;
    d |= v << (8 * i);
  }
  return d;
}

// The launch's dynamic shared memory (blocks run one at a time).
inline uint8_t* sim_dynamic_smem = nullptr;
inline size_t sim_dynamic_smem_bytes = 0;
inline void sim_dynamic_smem_alloc(size_t bytes) {
  std::free(sim_dynamic_smem);
  const size_t rounded = (bytes + 127) / 128 * 128;
  sim_dynamic_smem = static_cast<uint8_t*>(std::aligned_alloc(128, rounded + 128));
  std::memset(sim_dynamic_smem, 0xA5, rounded + 128);  // never zeroed on a card
  sim_dynamic_smem_bytes = bytes;
}

// An mbarrier of one arrival and a transaction count: the phases it
// completed and the bytes its current phase still waits for.
struct SimMbar {
  std::atomic<uint32_t> done{0};
  std::atomic<int64_t> pending{0};
};
inline SimMbar* sim_mbar(const void* bar) {
  static std::mutex mu;
  static std::unordered_map<const void*, std::unique_ptr<SimMbar>> bars;
  std::lock_guard<std::mutex> lock(mu);
  auto& b = bars[bar];
  if (!b) b = std::make_unique<SimMbar>();
  return b.get();
}
inline void sim_mbar_init(const void* bar) {
  SimMbar* b = sim_mbar(bar);
  b->done = 0;
  b->pending = 0;
}
// the arrival, expecting `bytes` (a phase of no bytes completes at once)
inline void sim_mbar_expect(const void* bar, uint32_t bytes) {
  SimMbar* b = sim_mbar(bar);
  if (bytes == 0) {
    b->done++;
  } else {
    b->pending += bytes;
  }
}
// try_wait.parity: until the phase of that parity has completed
inline void sim_mbar_wait(const void* bar, uint32_t parity) {
  SimMbar* b = sim_mbar(bar);
  while ((b->done.load() & 1u) == parity) std::this_thread::yield();
}
// cp.async.bulk into the dynamic shared memory: 16-byte aligned ends and
// a size that is a multiple of 16, or a "runtime error" report
inline void sim_bulk_copy(void* dst, const void* src, uint32_t bytes, const void* bar) {
  const auto d = reinterpret_cast<uintptr_t>(dst), s = reinterpret_cast<uintptr_t>(src);
  const auto lo = reinterpret_cast<uintptr_t>(sim_dynamic_smem);
  if ((d | s | bytes) & 15u || d < lo || d + bytes > lo + sim_dynamic_smem_bytes) {
    std::fprintf(stderr, "runtime error: bulk copy of %u bytes to %#zx misplaced\n",
                 bytes, static_cast<size_t>(d - lo));
  } else {
    std::memcpy(dst, src, bytes);
  }
  SimMbar* b = sim_mbar(bar);
  if ((b->pending -= bytes) == 0) b->done++;
}

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
