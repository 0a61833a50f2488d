// Batched Binary Interval Search (BITS) kernel for Hopper (sm_90a): the row
// span and bin token of every query interval of a region panel.
//
// Replaces annotatedvdb_tpu/ops/intervals.py::bits_spans_kernel (an XLA
// program, not a Pallas kernel).  `pos` [K] int32 is one chromosome group's
// position-sorted, deduplicated row positions, sentinel-padded to a power of
// two (INT32_MAX sorts after every clamped query bound); `starts`/`ends` [Q]
// int32 are 1-based inclusive query bounds, clamped into [0, INT32_MAX - 16].
// Outputs per query: lo = searchsorted(pos, start, left) and hi =
// searchsorted(pos, end, right) as int32, the deepest enclosing bin's level
// [Q] int8 = 13 - (number of s in 0..12 with (a ^ b) >> s != 0) and its leaf
// [Q] int32 = a, where a = floor((start - 1) / 15625), b = floor((end - 1) /
// 15625) (ops/binindex.py's arithmetic, floor division as in jnp).
//
// The searches are the textbook lower and upper bounds: on a sorted array
// `lo` counts the elements < start and `hi` the elements <= end, which is
// what searchsorted returns on runs of equal positions and on the sentinel
// tail.  Nothing here needs the queries sorted.
//
// Bound: memory.  Each query reads its two bounds and writes 13 bytes; its
// two searches each touch log2(K) positions, the upper levels shared by all
// queries and the lower ones by queries that land near each other.  At the
// serving shape (K = 4,194,304 padded rows, Q = 4,096) that is about 0.2 MB,
// well under a microsecond at 3.35 TB/s, so a launch and a chain of 22
// dependent loads per search are what the card can approach.
//
// Design: one thread per query, 256 a block.  The simple kernel first; a
// wider search (a warp per query, or a CTA-staged upper tree) is later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int32_t kLeafSize = 15625;
constexpr int kLevels = 13;

__device__ __forceinline__ int lower_bound(const int32_t* __restrict__ pos,
                                           int k, int32_t x) {
  int lo = 0, hi = k;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(pos + mid) < x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__device__ __forceinline__ int upper_bound(const int32_t* __restrict__ pos,
                                           int k, int32_t x) {
  int lo = 0, hi = k;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(pos + mid) <= x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__device__ __forceinline__ int32_t floor_div(int32_t a, int32_t b) {
  const int32_t q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

__global__ void __launch_bounds__(kThreads)
bits_spans_kernel(const int32_t* __restrict__ pos, int k,
                  const int32_t* __restrict__ starts,
                  const int32_t* __restrict__ ends, int q,
                  int32_t* __restrict__ lo, int32_t* __restrict__ hi,
                  int8_t* __restrict__ level, int32_t* __restrict__ leaf) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= q) return;
  const int32_t s = __ldg(starts + i), e = __ldg(ends + i);
  lo[i] = lower_bound(pos, k, s);
  hi[i] = upper_bound(pos, k, e);
  const int32_t a = floor_div(s - 1, kLeafSize);
  const int32_t b = floor_div(e - 1, kLeafSize);
  const int32_t x = a ^ b;
  int mism = 0;
#pragma unroll
  for (int sh = 0; sh < kLevels; ++sh) mism += (x >> sh) != 0;
  level[i] = static_cast<int8_t>(kLevels - mism);
  leaf[i] = a;
}

}  // namespace

// Launches on `stream`; returns the cudaError_t of the launch (0 = queued).
extern "C" int bits_spans_launch(const void* pos, int k, const void* starts,
                                 const void* ends, int q, void* lo, void* hi,
                                 void* level, void* leaf, void* stream) {
  if (q <= 0) return 0;
  if (k < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (q + kThreads - 1) / kThreads;
  bits_spans_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(pos), k, static_cast<const int32_t*>(starts),
      static_cast<const int32_t*>(ends), q, static_cast<int32_t*>(lo),
      static_cast<int32_t*>(hi), static_cast<int8_t*>(level),
      static_cast<int32_t*>(leaf));
  return static_cast<int>(cudaGetLastError());
}
