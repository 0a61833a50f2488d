// Batched Binary Interval Search (BITS) kernel for Hopper (sm_90a): the row
// span and bin token of every query interval of a region panel.
//
// Replaces annotatedvdb_tpu/ops/intervals.py::bits_spans_kernel and, with a
// group index, ::bits_spans_stacked (XLA programs, not Pallas kernels).  `pos` [K] int32 is one chromosome group's
// position-sorted, deduplicated row positions, sentinel-padded to a power of
// two by the engine (INT32_MAX sorts after every clamped query bound), though
// any sorted K works, K = 0 included; `starts`/`ends` [Q] int32 are 1-based
// inclusive query bounds, clamped into [0, INT32_MAX - 16] by the callers.
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
// two searches touch a few dozen positions, the upper levels shared by all
// queries and the lower ones by queries that land near each other.  At the
// serving shape (K = 4,194,304 padded rows, Q = 4,096) that is about 0.2 MB,
// well under a microsecond at 3.35 TB/s.  What the card can approach is
// set by latency: each round of a search is a load that waits on the round
// before it, a trip to L2 (the 16 MB of positions stay there between calls)
// or to device memory.
//
// What held the first design back (one thread per query, 256 a block): 16
// blocks on 132 SMs at Q = 4,096, and two 22-step binary searches one after
// the other, 44 dependent loads a query.
//
// Design: one warp per query, 8 a block (512 blocks at Q = 4,096).  Each
// bound is a k-ary search by ballots, as in cadd_join.cu: in a round, the
// kLanes lanes of a bound load kLanes evenly spaced splitters of its bracket
// [lo, hi] (the answer's range), __ballot_sync and __popc count the
// splitters that pass (< start for lo, <= end for hi: a prefix, the
// positions being sorted), and the bracket narrows to the gap between the
// last that passes and the first that fails, (kLanes + 1)-fold.  When the
// bracket holds at most kLanes rows, one coalesced load of them and one
// ballot give the answer.  Splitter offsets are 32-bit products of a step
// (len / 17), with the remainder spread over the first gaps.  kLanes = 16:
// both bounds at once, each in half the warp (17-ary, 5 rounds and the
// window at K = 4,194,304: 6 dependent loads a query).  On the card
// (PERF.md) that beat 32 lanes a bound, one bound after the other (33-ary,
// 10 loads), lanes loading 2 or 4 splitters a round (33- and 65-ary, 5 and
// 4 loads, but two and four times the requests a round), and 64-bit
// splitter products; staging the first one or two rounds' splitters in
// shared memory once a block gained nothing, since the first round's loads
// depend on nothing and go out beside the query bounds' loads.  Lane 0
// computes the bin token.
//
// The stacked form (the mesh executor's panel call, one launch per shard's
// stack): `pos` [B, R] holds B groups' sentinel-padded rows, `starts` and
// `ends` [B, Q] each group's queries, zero-padded to the common Q; a warp
// serves one (group, query) pair, searching its group's row alone, and the
// outputs are [B, Q].  Pad queries come back too: a zero bound gives a =
// (0 - 1) // 15625 = -1 by floor division, as in the plain version.  At
// phase 15's stack (25 groups of 131,072 padded rows, 330 queries a
// group) half the warps serve pad queries, and each searched its whole
// row.  The stacked kernel loads the row's first position beside the
// query's bounds, and where it decides a bound (every row >= start: lo =
// 0; every row > end: hi = 0) that half of the warp searches nothing:
// every pad query and every all-sentinel group's queries end there.
// Measured against it on the card (PERF.md): the first round's splitters
// loaded beside the query's bounds (slower), and one group a block
// searching a shared-memory fence of 256 or 1,024 of its rows first
// (slower: the fence's strided loads cost more than the rounds they
// save).  The single-group kernel is unchanged.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 16;  // lanes a bound: half a warp
constexpr int kWarps = 8;   // queries a block
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kAll = 0xffffffffu;
constexpr unsigned kGroup = (1u << kLanes) - 1;
constexpr int32_t kLeafSize = 15625;
constexpr int kLevels = 13;

// The i-th of kLanes splitters of a bracket [lo, lo + len), len > kLanes:
// lo + step (i + 1) + min(i + 1, rem) with step = len / (kLanes + 1) >= 1
// and rem = len % (kLanes + 1), strictly increasing, inside the bracket,
// and leaving gaps of at most `step` rows; i = kLanes is lo + len.  All
// 32-bit: (i + 1) step + rem <= len.
__device__ __forceinline__ int splitter(int lo, int step, int rem, int i) {
  return lo + step * (i + 1) + min(i + 1, rem);
}

// The first index i in [lo, hi] at which pos[i] < key (pos[i] <= key when
// `upper`) fails, given that it lies there, searched by the kLanes lanes of
// this lane's group, `sub` its index there and `shift` the group's first
// lane.  Every lane of the warp calls it together.  The predicate passes
// on a prefix of the rows, so the passing splitters (or window rows) are a
// prefix too, and counting them is enough.
__device__ __forceinline__ int bound_from(const int32_t* __restrict__ pos,
                                          int lo, int hi, int32_t key,
                                          bool upper, int sub, int shift) {
  while (true) {
    const int len = hi - lo;
    const bool wide = len > kLanes;
    if (!__any_sync(kAll, wide)) break;
    const int step = len / (kLanes + 1);
    const int rem = len - step * (kLanes + 1);
    bool pass = false;
    if (wide) {
      const int32_t v = __ldg(pos + splitter(lo, step, rem, sub));
      pass = upper ? v <= key : v < key;
    }
    const int below = __popc((__ballot_sync(kAll, pass) >> shift) & kGroup);
    if (wide) {
      // splitters [0, below) pass: the answer is past splitter below - 1
      // and not past splitter below
      const int base = lo;
      if (below > 0) lo = splitter(base, step, rem, below - 1) + 1;
      if (below < kLanes) hi = splitter(base, step, rem, below);
    }
  }
  bool pass = false;
  if (sub < hi - lo) {
    const int32_t v = __ldg(pos + lo + sub);
    pass = upper ? v <= key : v < key;
  }
  return lo + __popc((__ballot_sync(kAll, pass) >> shift) & kGroup);
}

// The same over the whole of [0, k].
__device__ __forceinline__ int bound(const int32_t* __restrict__ pos, int k,
                                     int32_t key, bool upper, int sub,
                                     int shift) {
  return bound_from(pos, 0, k, key, upper, sub, shift);
}

__device__ __forceinline__ int32_t floor_div(int32_t a, int32_t b) {
  const int32_t q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

// `pos` [groups, k]; `starts`, `ends` and the outputs [groups, q]
__global__ void __launch_bounds__(kThreads)
bits_spans_kernel(const int32_t* __restrict__ pos, int k,
                  const int32_t* __restrict__ starts,
                  const int32_t* __restrict__ ends, int q, int groups,
                  int32_t* __restrict__ lo, int32_t* __restrict__ hi,
                  int8_t* __restrict__ level, int32_t* __restrict__ leaf) {
  const int lane = threadIdx.x & 31;
  const int64_t i =
      static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (i >= static_cast<int64_t>(q) * groups) return;  // the whole warp
  const int64_t g = i / q;
  const int32_t s = __ldg(starts + i), e = __ldg(ends + i);
  // lanes 0-15 search lo, lanes 16-31 hi, in this group's row
  const bool upper = lane >= kLanes;
  const int r = bound(pos + g * k, k, upper ? e : s, upper,
                      lane & (kLanes - 1), lane & kLanes);
  if (lane == 0) lo[i] = r;
  if (lane == kLanes) hi[i] = r;
  if (lane == 0) {
    const int32_t a = floor_div(s - 1, kLeafSize);
    const int32_t b = floor_div(e - 1, kLeafSize);
    const int32_t x = a ^ b;
    int mism = 0;
#pragma unroll
    for (int sh = 0; sh < kLevels; ++sh) mism += (x >> sh) != 0;
    level[i] = static_cast<int8_t>(kLevels - mism);
    leaf[i] = a;
  }
}

// The stack's kernel: a warp a (group, query) pair, as above, except
// where the row's first position already decides a bound (every row >=
// start: lo = 0; every row > end: hi = 0): the half of the warp that
// searches it then does no search.  Every zero-padded query and every
// all-sentinel group's queries end there, exactly, since the row is
// sorted; the first position is loaded beside the query's bounds.
__global__ void __launch_bounds__(kThreads)
bits_spans_stacked_kernel(const int32_t* __restrict__ pos, int k,
                          const int32_t* __restrict__ starts,
                          const int32_t* __restrict__ ends, int q,
                          int groups, int32_t* __restrict__ lo,
                          int32_t* __restrict__ hi, int8_t* __restrict__ level,
                          int32_t* __restrict__ leaf) {
  const int lane = threadIdx.x & 31;
  const int64_t i =
      static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (i >= static_cast<int64_t>(q) * groups) return;  // the whole warp
  const int32_t* __restrict__ row = pos + (i / q) * k;
  const bool upper = lane >= kLanes;
  const int32_t s = __ldg(starts + i), e = __ldg(ends + i);
  const int32_t first = k > 0 ? __ldg(row) : 0;
  const int32_t key = upper ? e : s;
  const bool none = k == 0 || (upper ? first > key : first >= key);
  const int r = bound_from(row, 0, none ? 0 : k, key, upper,
                           lane & (kLanes - 1), lane & kLanes);
  if (lane == 0) lo[i] = r;
  if (lane == kLanes) hi[i] = r;
  if (lane == 0) {
    const int32_t a = floor_div(s - 1, kLeafSize);
    const int32_t x = a ^ floor_div(e - 1, kLeafSize);
    int mism = 0;
#pragma unroll
    for (int sh = 0; sh < kLevels; ++sh) mism += (x >> sh) != 0;
    level[i] = static_cast<int8_t>(kLevels - mism);
    leaf[i] = a;
  }
}

bool misaligned(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 3u) != 0;
}

using Kernel = void (*)(const int32_t*, int, const int32_t*, const int32_t*,
                        int, int, int32_t*, int32_t*, int8_t*, int32_t*);

int launch(Kernel kernel, const void* pos, int k, const void* starts,
           const void* ends, int q, int groups, void* lo, void* hi,
           void* level, void* leaf, void* stream) {
  if (k < 0 || q < 0 || groups < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (misaligned(pos) || misaligned(starts) || misaligned(ends) ||
      misaligned(lo) || misaligned(hi) || misaligned(leaf)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t warps = static_cast<int64_t>(q) * groups;
  if (warps == 0) return 0;
  const int64_t blocks = (warps + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(pos), k, static_cast<const int32_t*>(starts),
      static_cast<const int32_t*>(ends), q, groups, static_cast<int32_t*>(lo),
      static_cast<int32_t*>(hi), static_cast<int8_t*>(level),
      static_cast<int32_t*>(leaf));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Both entry points launch on `stream` and return the cudaError_t of the
// launch (0 = queued); a negative size or a base off 4-byte alignment is
// refused (cudaErrorInvalidValue) before any launch.

// One group: `pos` [k], `starts`/`ends` and the outputs [q].
extern "C" int bits_spans_launch(const void* pos, int k, const void* starts,
                                 const void* ends, int q, void* lo, void* hi,
                                 void* level, void* leaf, void* stream) {
  return launch(bits_spans_kernel, pos, k, starts, ends, q, 1, lo, hi, level,
                leaf, stream);
}

// A stack of `b` groups: `pos` [b, r], `starts`/`ends` and the outputs
// [b, q], all contiguous.
extern "C" int bits_spans_stacked_launch(const void* pos, int b, int r,
                                         const void* starts, const void* ends,
                                         int q, void* lo, void* hi,
                                         void* level, void* leaf,
                                         void* stream) {
  return launch(bits_spans_stacked_kernel, pos, r, starts, ends, q, b, lo, hi,
                level, leaf, stream);
}
