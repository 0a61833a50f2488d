// Fused analytics kernels for Hopper (sm_90a): the stats panel and the
// windowed scan of one chromosome group's feature columns over a panel of
// query intervals.
//
// Replace annotatedvdb_tpu/ops/stats.py::stats_panel_kernel (:139) and
// ::windowed_stats_kernel (:187) (XLA programs, not Pallas kernels).  Inputs:
// `pos` [K] int32, position-sorted and sentinel-padded to a power of two; the
// int32 fixed-point feature columns `af`, `cadd`, `rank` [K] aligned to it
// (-1 = missing); `starts`/`ends` [Q] int32, clamped, 1-based inclusive.  The
// panel returns lo/hi [Q] (left and right searchsorted) and, per query, the
// difference of row counters between hi and lo: 21 AF bit lanes, 10 AF
// histogram bins, 21 CADD lanes, 10 CADD bins and 32 rank buckets (94 int32
// counters).  The windowed scan splits each query into W <= 64 equal windows
// (boundary b_w = start + q*w + (r*w)/W, q and r from the floor division of
// end - start + 1 by W, int32 as in the reference), searches each boundary
// (left), and returns per window the row count, the CADD present count and
// the 21 CADD lanes.
//
// The reference builds [K, 94] int32 one-hot and bit-plane cumulants and
// gathers them at the span ends: ~1.6 GB per call at the serving shape.  Here
// a counter at row x, cum(x) = the count over rows [0, x), comes from a table
// of counts at every T-th row (T = 256 for the panel, 64 for the windows)
// plus the rows between x and its nearer table row.  On one stream:
//   1. (panel only) reach: whether some end is the sentinel, the one key
//      whose search can pass the first padding row;
//   2. count, one launch of two kinds of blocks.  Search blocks give each
//      key its own thread (Q x 2 for the panel, Q x (W + 1) for the
//      windows: a query's boundaries are searched at once, never in turn).
//      Table blocks walk the 4,096-row super-tiles, a warp per tile, and
//      write each tile's counts as an exclusive prefix within its
//      super-tile (tile-major, coalesced) and the super-tile's totals.  The
//      counting needs no search result, so the searches' chains of
//      dependent loads overlap it.  A super-tile no search can reach (all
//      rows from half a tile before it are at the sentinel position, and no
//      end is the sentinel) only zeroes its totals: the padding is never
//      read unless a span reaches it;
//   3. scan: a block per counter turns the super-tile totals into
//      exclusive prefixes;
//   4. combine: the panel gives each query a warp that counts the rows
//      between each endpoint and its nearer table row (at most T/2 = 128, 4
//      a lane); the windows give each boundary a thread (at most 32 rows,
//      their loads issued together, the table rows as 16-byte loads) and a
//      block a few queries; cum(x) = prefix(super) + prefix(tile) +/- those
//      rows, and the outputs are differences of cum.
// Counting needs no ballots or popcounts: a lane adds its rows into packed
// byte counters (byte f of register j counts bit 8f + j of a value; levels
// v >= edge_k in bytes of three more registers), the warp sums those by
// recursive halving (a shuffle per pair of registers kept, 16-bit fields for
// the last step), and rank buckets go through a per-warp shared histogram.
// The 10 histogram bins are kept as 10 cumulative levels (present, v >=
// edge_1..9) and bin_j = level_j - level_{j+1} at the end.  Integer sums are
// exact in any order, so the outputs equal the reference's int32 cumulant
// differences bit for bit.
//
// Bound: memory.  The counts read the 12 (panel) or 4 (windows) feature
// bytes of every row up to the last span end once, the searches read the
// sectors of `pos` on their paths, and the outputs are 376 (panel) or 92 W
// (windows) bytes a query: ~30 MB and ~20 MB at the serving shape (2,274,305
// rows padded to 4,194,304, Q = 4,096), 9 and 6 us at 3.35 TB/s.  What the
// design adds to that: a 22-step dependent search chain per key (hidden
// behind the counting), the table (~4 MB written and read), three or four
// launches, and ~100 integer instructions a row for the panel's packed
// counts.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kAll = 0xffffffffu;
constexpr int kThreads = 256;     // every kernel but the scan
constexpr int kWarps = kThreads / 32;
constexpr int kSumBits = 21;      // ops/stats.py::SUM_BITS
constexpr int kBins = 10;         // len(AF_EDGES_FP) - 1 == len(CADD_EDGES_FP) - 1
constexpr int kRanks = 32;        // ops/stats.py::RANK_BUCKETS
constexpr int kMaxWindows = 64;   // ops/stats.py::MAX_WINDOWS
constexpr int kPanelC = 2 * kSumBits + 2 * kBins + kRanks;  // 94
constexpr int kWinC = 1 + kSumBits;                          // 22
constexpr int kPanelTile = 256;   // ops/stats.py::PANEL_TILE_ROWS
constexpr int kWindowTile = 64;   // ops/stats.py::WINDOW_TILE_ROWS
constexpr int kSuperRows = 4096;  // ops/stats.py::SUPER_ROWS
constexpr int kPanelSlots = 96;   // ops/stats.py::PANEL_SLOTS (94 padded)
constexpr int kWindowSlots = 24;  // ops/stats.py::WINDOW_SLOTS (22 padded)
constexpr int kHeaderWords = 32;  // ops/stats.py::SCRATCH_HEADER_WORDS (the
                                  // table starts on a 128-byte line)
constexpr int kTileBlocks = 1056; // most blocks of the tile pass (8 a SM)
constexpr int kScanThreads = 1024;
constexpr int kScanItems = 4;
constexpr int32_t kCap = (1 << kSumBits) - 1;  // ops/stats.py::FP_CAP
constexpr int32_t kSentinel = 2147483647;      // utils/arrays.py::POS_SENTINEL
constexpr uint32_t kPresent = 1u << kSumBits;  // windows: bit 21 counts present

// the table's counter order (panel): AF lanes, AF levels, CADD lanes, CADD
// levels, ranks; (windows): CADD lanes 0..20, present
constexpr int kAfLevels = kSumBits;
constexpr int kCaddLanes = kSumBits + kBins;
constexpr int kCaddLevels = 2 * kSumBits + kBins;
constexpr int kRankBase = 2 * kSumBits + 2 * kBins;

static_assert(kSuperRows / kPanelTile % kWarps == 0, "whole panel tiles a warp");
static_assert(kSuperRows / kWindowTile % kWarps == 0, "whole window tiles a warp");

// ops/stats.py::AF_EDGES_FP and ::CADD_EDGES_FP
__constant__ int32_t kAfEdges[kBins + 1] = {
    0, 10, 100, 1000, 5000, 10000, 50000, 100000, 250000, 500000, 1000000};
__constant__ int32_t kCaddEdges[kBins + 1] = {
    0, 1000, 5000, 10000, 15000, 20000, 25000, 30000, 40000, 50000, 100000};

// ----------------------------------------------------------- packed counts

// Adds the bits of `v` (< 2^24) to eight packed registers: byte f of
// register j counts bit 8f + j.  Register j keeps its counts shifted left by
// j % 3 (one mask and one add a register), which leaves room for 63 rows.
__device__ __forceinline__ void add_bits(uint32_t (&acc)[8], uint32_t v) {
  acc[0] += v & 0x01010101u;
  acc[1] += v & 0x02020202u;
  acc[2] += v & 0x04040404u;
  const uint32_t w = v >> 3;
  acc[3] += w & 0x01010101u;
  acc[4] += w & 0x02020202u;
  acc[5] += w & 0x04040404u;
  const uint32_t u = v >> 6;
  acc[6] += u & 0x01010101u;
  acc[7] += u & 0x02020202u;
}

// Undoes add_bits's shifts: byte f of register j is then the plain count.
__device__ __forceinline__ void unshift_bits(uint32_t (&acc)[8]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j] >>= j % 3;
}

template <bool kCadd>
__device__ __forceinline__ uint32_t level(int32_t v, int j) {
  return static_cast<uint32_t>(v >= (kCadd ? kCaddEdges[j] : kAfEdges[j]));
}

// Adds one present value's levels: byte f of register i counts level
// 4i + f, where level 0 is "present" and level k >= 1 is v >= edge k.
template <bool kCadd>
__device__ __forceinline__ void add_levels(uint32_t (&acc)[3], int32_t v) {
  acc[0] += 1u + (level<kCadd>(v, 1) << 8) + (level<kCadd>(v, 2) << 16) +
            (level<kCadd>(v, 3) << 24);
  acc[1] += level<kCadd>(v, 4) + (level<kCadd>(v, 5) << 8) +
            (level<kCadd>(v, 6) << 16) + (level<kCadd>(v, 7) << 24);
  acc[2] += level<kCadd>(v, 8) + (level<kCadd>(v, 9) << 8);
}

// One step of recursive halving: lanes whose `delta` bit is set keep the
// upper half of the registers and receive their partner's upper half.
template <int N>
__device__ __forceinline__ void halve(const uint32_t (&in)[N],
                                      uint32_t (&out)[N / 2], int lane,
                                      int delta) {
  const bool upper = (lane & delta) != 0;
#pragma unroll
  for (int j = 0; j < N / 2; ++j) {
    const uint32_t keep = upper ? in[j + N / 2] : in[j];
    const uint32_t send = upper ? in[j] : in[j + N / 2];
    out[j] = keep + __shfl_xor_sync(kAll, send, delta);
  }
}

// The sum of N packed byte registers over the G lanes of a lane group (N
// <= G <= 32, powers of two), each group's rows counted once: lane l ends
// with register (l % G) / (G / N)'s four fields as two words of 16-bit
// fields, .x = fields 0 and 2, .y = fields 1 and 3.  Byte fields must stay
// below 256 over N / 2 lanes, 16-bit fields over G lanes.
template <int N, int G>
struct GroupSum {
  static __device__ __forceinline__ uint2 run(const uint32_t (&v)[N], int lane) {
    uint32_t h[N / 2];
    halve<N>(v, h, lane, G / 2);
    return GroupSum<N / 2, G / 2>::run(h, lane);
  }
};

template <int G>
struct GroupSum<2, G> {
  static __device__ __forceinline__ uint2 run(const uint32_t (&v)[2], int lane) {
    const uint32_t u[4] = {v[0] & 0x00ff00ffu, (v[0] >> 8) & 0x00ff00ffu,
                           v[1] & 0x00ff00ffu, (v[1] >> 8) & 0x00ff00ffu};
    uint32_t h[2];
    halve<4>(u, h, lane, G / 2);
#pragma unroll
    for (int d = G / 4; d >= 1; d >>= 1) {
      h[0] += __shfl_xor_sync(kAll, h[0], d);
      h[1] += __shfl_xor_sync(kAll, h[1], d);
    }
    return make_uint2(h[0], h[1]);
  }
};

// Field f (0..3) of a GroupSum result.
__device__ __forceinline__ int32_t field16(uint2 s, int f) {
  const uint32_t w = (f & 1) ? s.y : s.x;
  return static_cast<int32_t>((w >> (16 * (f >> 1))) & 0xffffu);
}

// The table counter of the panel's packed register r, field f (-1: unused).
__device__ __forceinline__ int panel_counter(int r, int f) {
  if (r < 8) return 8 * f + r < kSumBits ? 8 * f + r : -1;
  if (r < 16) return 8 * f + r - 8 < kSumBits ? kCaddLanes + 8 * f + r - 8 : -1;
  if (r < 19) return 4 * (r - 16) + f < kBins ? kAfLevels + 4 * (r - 16) + f : -1;
  if (r < 22) return 4 * (r - 19) + f < kBins ? kCaddLevels + 4 * (r - 19) + f : -1;
  return -1;
}

struct PanelCounts {
  uint2 packed;  // lane l: packed register l (panel_counter(l, f))
  int32_t rank;  // lane l: rank bucket l
};

// The panel's counters over rows [a, b), R rows a lane (b - a <= 32 R),
// summed over the warp.  `hist` is the warp's 32-int shared histogram.
template <int R>
__device__ __forceinline__ PanelCounts panel_rows(
    int a, int b, const int32_t* __restrict__ af,
    const int32_t* __restrict__ cadd, const int32_t* __restrict__ rank,
    int32_t* hist, int lane) {
  uint32_t af_bits[8] = {}, cadd_bits[8] = {}, af_lv[3] = {}, cadd_lv[3] = {};
  hist[lane] = 0;
  __syncwarp();
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = a + 32 * i + lane;
    if (row < b) {
      const int32_t f = __ldg(af + row), c = __ldg(cadd + row), r = __ldg(rank + row);
      if (f >= 0) {
        add_bits(af_bits, static_cast<uint32_t>(f & kCap));
        add_levels<false>(af_lv, f);
      }
      if (c >= 0) {
        add_bits(cadd_bits, static_cast<uint32_t>(c & kCap));
        add_levels<true>(cadd_lv, c);
      }
      if (r >= 0) atomicAdd(hist + min(r, kRanks - 1), 1);
    }
  }
  unshift_bits(af_bits);
  unshift_bits(cadd_bits);
  uint32_t v[32];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    v[j] = af_bits[j];
    v[8 + j] = cadd_bits[j];
  }
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    v[16 + j] = af_lv[j];
    v[19 + j] = cadd_lv[j];
  }
#pragma unroll
  for (int j = 22; j < 32; ++j) v[j] = 0;
  PanelCounts out;
  out.packed = GroupSum<32, 32>::run(v, lane);
  __syncwarp();
  out.rank = hist[lane];
  return out;
}

// ----------------------------------------------------------------- search

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

// Window boundary w of [s, e] split W ways, in the reference's wrapping
// int32 arithmetic with floor division.
__device__ __forceinline__ int32_t boundary(int32_t s, int32_t e, int windows,
                                            int w) {
  const int32_t span = static_cast<int32_t>(
      static_cast<uint32_t>(e) - static_cast<uint32_t>(s) + 1u);
  int32_t qd = span / windows, r = span % windows;
  if (r < 0) {
    r += windows;
    --qd;
  }
  return static_cast<int32_t>(static_cast<uint32_t>(s) +
                              static_cast<uint32_t>(qd) * static_cast<uint32_t>(w) +
                              static_cast<uint32_t>((r * w) / windows));
}

// Search key i of a call, on its own thread.  The panel's keys are the
// starts (left, into lo) then the ends (right, into hi); the windows' are
// each query's W + 1 boundaries (left, into idx [Q][W + 1]).
template <bool kPanel>
__device__ __forceinline__ void search_key(long long i, const int32_t* __restrict__ pos,
                                           int k, const int32_t* __restrict__ starts,
                                           const int32_t* __restrict__ ends, int q,
                                           int windows, int32_t* __restrict__ lo,
                                           int32_t* __restrict__ hi) {
  if (kPanel) {
    if (i < q) {
      lo[i] = lower_bound(pos, k, __ldg(starts + i));
    } else if (i < 2LL * q) {
      hi[i - q] = upper_bound(pos, k, __ldg(ends + (i - q)));
    }
  } else {
    const int per = windows + 1;
    if (i < static_cast<long long>(q) * per) {
      const int qi = static_cast<int>(i / per), w = static_cast<int>(i % per);
      lo[i] = lower_bound(pos, k, boundary(__ldg(starts + qi), __ldg(ends + qi), windows, w));
    }
  }
}

// ------------------------------------------------------------ table passes

// Step 1 of the panel: header[0] = whether some end is the sentinel, the
// one key whose search (right) can pass the first sentinel row.
__global__ void __launch_bounds__(kScanThreads)
reach_kernel(const int32_t* __restrict__ ends, int q, int32_t* __restrict__ header) {
  __shared__ int32_t any;
  if (threadIdx.x == 0) any = 0;
  __syncthreads();
  bool found = false;
  for (int i = threadIdx.x; i < q; i += kScanThreads) found |= __ldg(ends + i) == kSentinel;
  if (found) any = 1;
  __syncthreads();
  if (threadIdx.x == 0) header[0] = any;
}

// Whether a combine can read super-tile s's table rows.  It reads row j
// only for an index x > (j - 1) T + T / 2, and no search returns more than
// the first row at the sentinel position (`pos` is sorted and the
// sentinel is the largest int32), unless a panel end is the sentinel
// (`reach`; then up to k).  So the rows past the real ones are never
// counted unless a span reaches them.
template <int T>
__device__ __forceinline__ bool live_super(int s, const int32_t* __restrict__ pos,
                                           int k, bool reach) {
  if (s == 0) return true;
  const long long row = static_cast<long long>(s) * kSuperRows - T / 2;
  return row < k && (reach || __ldg(pos + row) != kSentinel);
}

// The panel's super-tile s: a warp per 256-row tile (8 rows a lane).
__device__ __forceinline__ void panel_super(int s, const int32_t* __restrict__ af,
                                            const int32_t* __restrict__ cadd,
                                            const int32_t* __restrict__ rank, int k,
                                            int32_t* __restrict__ local,
                                            int32_t* __restrict__ sup) {
  constexpr int kPer = kSuperRows / kPanelTile;  // tiles a super-tile
  __shared__ int32_t cnt[kPer][kPanelSlots];
  __shared__ int32_t hist[kWarps][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < kPer / kWarps; ++i) {
    const int tl = i * kWarps + warp;
    const int a = (s * kPer + tl) * kPanelTile;
    const PanelCounts c = panel_rows<kPanelTile / 32>(
        a, min(a + kPanelTile, k), af, cadd, rank, hist[warp], lane);
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      const int id = panel_counter(lane, f);
      if (id >= 0) cnt[tl][id] = field16(c.packed, f);
    }
    cnt[tl][kRankBase + lane] = c.rank;
  }
  __syncthreads();
  if (threadIdx.x < kPanelC) {
    int32_t run = 0;
#pragma unroll
    for (int t = 0; t < kPer; ++t) {
      local[static_cast<size_t>(s * kPer + t) * kPanelSlots + threadIdx.x] = run;
      run += cnt[t][threadIdx.x];
    }
    sup[static_cast<size_t>(s) * kPanelSlots + threadIdx.x] = run;
  }
  __syncthreads();
}

// The windows' super-tile s: a warp per 64-row tile (2 rows a lane), 4
// tiles a warp.
__device__ __forceinline__ void window_super(int s, const int32_t* __restrict__ cadd,
                                             int k, int32_t* __restrict__ local,
                                             int32_t* __restrict__ sup) {
  constexpr int kPer = kSuperRows / kWindowTile;  // 32 tiles a super-tile
  __shared__ int32_t cnt[kPer][kWindowSlots];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < kPer / kWarps; ++i) {
    const int tl = i * kWarps + warp;
    const int a = (s * kPer + tl) * kWindowTile;
    uint32_t bits[8] = {};
#pragma unroll
    for (int j = 0; j < kWindowTile / 32; ++j) {
      const int row = a + 32 * j + lane;
      if (row < k) {
        const int32_t c = __ldg(cadd + row);
        if (c >= 0) add_bits(bits, static_cast<uint32_t>(c & kCap) | kPresent);
      }
    }
    unshift_bits(bits);
    const uint2 sum = GroupSum<8, 32>::run(bits, lane);
    if ((lane & 3) == 0) {
      const int r = lane >> 2;  // the packed register this lane holds
#pragma unroll
      for (int f = 0; f < 3; ++f)
        if (8 * f + r < kWinC) cnt[tl][8 * f + r] = field16(sum, f);
    }
  }
  __syncthreads();
  if (threadIdx.x < kWinC) {
    int32_t run = 0;
    for (int t = 0; t < kPer; ++t) {
      local[static_cast<size_t>(s * kPer + t) * kWindowSlots + threadIdx.x] = run;
      run += cnt[t][threadIdx.x];
    }
    sup[static_cast<size_t>(s) * kWindowSlots + threadIdx.x] = run;
  }
  __syncthreads();
}

// Step 2, count, in one launch: the first `search_blocks` blocks search
// (a key a thread) while the others count the super-tiles (the counting
// needs no search result), so the searches' chains of dependent loads
// overlap the counting.  A super-tile no combine can read only zeroes its
// totals.
template <bool kPanel>
__global__ void __launch_bounds__(kThreads)
count_kernel(const int32_t* __restrict__ pos, const int32_t* __restrict__ af,
             const int32_t* __restrict__ cadd, const int32_t* __restrict__ rank,
             int k, const int32_t* __restrict__ starts,
             const int32_t* __restrict__ ends, int q, int windows,
             int search_blocks, int supers, const int32_t* __restrict__ header,
             int32_t* __restrict__ lo, int32_t* __restrict__ hi,
             int32_t* __restrict__ local, int32_t* __restrict__ sup) {
  constexpr int kSlots = kPanel ? kPanelSlots : kWindowSlots;
  if (static_cast<int>(blockIdx.x) < search_blocks) {
    search_key<kPanel>(static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x,
                       pos, k, starts, ends, q, windows, lo, hi);
    return;
  }
  const bool reach = kPanel && header[0] != 0;
  const int stride = gridDim.x - search_blocks;
  for (int s = blockIdx.x - search_blocks; s < supers; s += stride) {
    const bool live = kPanel ? live_super<kPanelTile>(s, pos, k, reach)
                             : live_super<kWindowTile>(s, pos, k, false);
    if (!live) {
      if (threadIdx.x < kSlots) sup[static_cast<size_t>(s) * kSlots + threadIdx.x] = 0;
    } else if (kPanel) {
      panel_super(s, af, cadd, rank, k, local, sup);
    } else {
      window_super(s, cadd, k, local, sup);
    }
  }
}

// Step 3: counter blockIdx.x's super-tile totals (column c of sup [supers]
// [slots]) into exclusive prefixes, in place.
__global__ void __launch_bounds__(kScanThreads)
scan_supers_kernel(int32_t* __restrict__ sup, int supers, int slots) {
  __shared__ int32_t warp_sum[kScanThreads / 32];
  __shared__ int32_t chunk_sum;
  const int c = blockIdx.x, t = threadIdx.x, lane = t & 31, warp = t >> 5;
  int32_t carry = 0;
  for (int base = 0; base < supers; base += kScanThreads * kScanItems) {
    int32_t v[kScanItems];
    int32_t local = 0;
#pragma unroll
    for (int i = 0; i < kScanItems; ++i) {
      const int s = base + t * kScanItems + i;
      v[i] = s < supers ? sup[static_cast<size_t>(s) * slots + c] : 0;
      local += v[i];
    }
    int32_t incl = local;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int32_t u = __shfl_up_sync(kAll, incl, d);
      if (lane >= d) incl += u;
    }
    if (lane == 31) warp_sum[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      const int32_t x = warp_sum[lane];
      int32_t y = x;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int32_t u = __shfl_up_sync(kAll, y, d);
        if (lane >= d) y += u;
      }
      warp_sum[lane] = y - x;
      if (lane == 31) chunk_sum = y;
    }
    __syncthreads();
    int32_t run = carry + warp_sum[warp] + incl - local;
#pragma unroll
    for (int i = 0; i < kScanItems; ++i) {
      const int s = base + t * kScanItems + i;
      if (s < supers) sup[static_cast<size_t>(s) * slots + c] = run;
      run += v[i];
    }
    carry += chunk_sum;
    __syncthreads();
  }
}

// The table row and the rows to count for cum(x): the nearer of the tile
// rows before and after x.  cum(x) = prefix(base) + sign * count(rows [a, b)).
struct Endpoint {
  int base, a, b, sign;
};

template <int T>
__device__ __forceinline__ Endpoint endpoint(int x, int k) {
  const int t = x / T, r = x - t * T;
  if (r <= T / 2) return {t, t * T, x, 1};
  return {t + 1, x, min((t + 1) * T, k), -1};
}

// Step 4 of the panel: a warp per query, both endpoints.
__global__ void __launch_bounds__(kThreads)
panel_kernel(const int32_t* __restrict__ af, const int32_t* __restrict__ cadd,
             const int32_t* __restrict__ rank, int k,
             const int32_t* __restrict__ local, const int32_t* __restrict__ sup,
             const int32_t* __restrict__ lo, const int32_t* __restrict__ hi, int q,
             int32_t* __restrict__ af_lanes, int32_t* __restrict__ af_hist,
             int32_t* __restrict__ cadd_lanes, int32_t* __restrict__ cadd_hist,
             int32_t* __restrict__ rank_counts) {
  constexpr int kPer = kSuperRows / kPanelTile;
  __shared__ int32_t hist[kWarps][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int i = blockIdx.x * kWarps + warp;
  if (i >= q) return;  // the whole warp
  int32_t acc[4] = {0, 0, 0, 0}, acc_rank = 0;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int32_t sign = e == 0 ? 1 : -1;
    const Endpoint p = endpoint<kPanelTile>(e == 0 ? hi[i] : lo[i], k);
    const PanelCounts c = panel_rows<kPanelTile / 64>(p.a, p.b, af, cadd, rank,
                                                      hist[warp], lane);
    const int32_t* lt = local + static_cast<size_t>(p.base) * kPanelSlots;
    const int32_t* st = sup + static_cast<size_t>(p.base / kPer) * kPanelSlots;
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      const int id = panel_counter(lane, f);
      if (id >= 0) acc[f] += sign * (lt[id] + st[id] + p.sign * field16(c.packed, f));
    }
    acc_rank += sign * (lt[kRankBase + lane] + st[kRankBase + lane] + p.sign * c.rank);
  }
  const int32_t next = __shfl_down_sync(kAll, acc[0], 1);  // the next level
  const size_t o = i;
#pragma unroll
  for (int f = 0; f < 4; ++f) {
    const int id = panel_counter(lane, f);
    if (id < 0) continue;
    if (id < kAfLevels) {
      af_lanes[o * kSumBits + id] = acc[f];
    } else if (id < kCaddLanes) {
      af_hist[o * kBins + id - kAfLevels] = acc[f] - (f < 3 ? acc[f + 1] : next);
    } else if (id < kCaddLevels) {
      cadd_lanes[o * kSumBits + id - kCaddLanes] = acc[f];
    } else {
      cadd_hist[o * kBins + id - kCaddLevels] = acc[f] - (f < 3 ? acc[f + 1] : next);
    }
  }
  rank_counts[o * kRanks + lane] = acc_rank;
}

// Step 4 of the windows: a thread per boundary, kThreads / (W + 1) queries a
// block (its rows' loads all issued at once, the table rows as 16-byte
// loads); then the block writes its queries' windows.
__global__ void __launch_bounds__(kThreads)
window_kernel(const int32_t* __restrict__ cadd, int k,
              const int32_t* __restrict__ local, const int32_t* __restrict__ sup,
              const int32_t* __restrict__ idx, int q, int windows,
              int32_t* __restrict__ counts, int32_t* __restrict__ present,
              int32_t* __restrict__ lanes) {
  constexpr int kPer = kSuperRows / kWindowTile;
  __shared__ int32_t at[kThreads][kWinC + 1];  // odd stride: no bank conflicts
  __shared__ int32_t at_idx[kThreads];
  const int per = windows + 1;
  const int g = kThreads / per;
  const int q0 = blockIdx.x * g;
  const int nq = min(g, q - q0);
  const int u = threadIdx.x;
  if (u < nq * per) {
    const int x = idx[static_cast<size_t>(q0) * per + u];
    const Endpoint p = endpoint<kWindowTile>(x, k);
    uint32_t bits[8] = {};
#pragma unroll
    for (int j = 0; j < kWindowTile / 2; ++j) {
      const int row = p.a + j;
      if (row < p.b) {
        const int32_t c = __ldg(cadd + row);
        if (c >= 0) add_bits(bits, static_cast<uint32_t>(c & kCap) | kPresent);
      }
    }
    unshift_bits(bits);
    const int4* lt = reinterpret_cast<const int4*>(
        local + static_cast<size_t>(p.base) * kWindowSlots);
    const int4* st = reinterpret_cast<const int4*>(
        sup + static_cast<size_t>(p.base / kPer) * kWindowSlots);
#pragma unroll
    for (int v = 0; v < kWindowSlots / 4; ++v) {
      const int4 a = __ldg(lt + v), b = __ldg(st + v);
      const int32_t tab[4] = {a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w};
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int j = 4 * v + jj;
        if (j < kWinC) {
          const int32_t n = static_cast<int32_t>((bits[j & 7] >> (8 * (j >> 3))) & 0xffu);
          at[u][j] = tab[jj] + p.sign * n;
        }
      }
    }
    at_idx[u] = x;
  }
  __syncthreads();
  const int nw = nq * windows;
  const size_t w0 = static_cast<size_t>(q0) * windows;
  for (int o = threadIdx.x; o < nw; o += kThreads) {
    const int b = (o / windows) * per + o % windows;
    counts[w0 + o] = at_idx[b + 1] - at_idx[b];
    present[w0 + o] = at[b + 1][kSumBits] - at[b][kSumBits];
  }
  for (int o = threadIdx.x; o < nw * kSumBits; o += kThreads) {
    const int wl = o / kSumBits, j = o - wl * kSumBits;
    const int b = (wl / windows) * per + wl % windows;
    lanes[w0 * kSumBits + o] = at[b + 1][j] - at[b][j];
  }
}

// ------------------------------------------------------------------ host

// Scratch words: the header, the table [tiles][slots] of whole super-tiles
// (one more table row than tiles), and their totals [supers][slots].
struct Layout {
  size_t local, sup, end;
  int supers;
};

Layout layout(int k, int tile, int slots) {
  const long long per = kSuperRows / tile;
  const long long tiles = (static_cast<long long>(k) + tile - 1) / tile;
  const long long supers = (tiles + per) / per;
  Layout l;
  l.supers = static_cast<int>(supers);
  l.local = kHeaderWords;
  l.sup = l.local + static_cast<size_t>(supers * per * slots);
  l.end = l.sup + static_cast<size_t>(supers * slots);
  return l;
}

int blocks(long long n, int per_block) {
  return static_cast<int>((n + per_block - 1) / per_block);
}

}  // namespace

// The stats panel.  `scratch` holds `scratch_words` int32, 16-byte aligned
// (at least ops/stats.py::scratch_words("panel", k)).  Launches on
// `stream`; returns the first cudaError_t (0 = all queued).
extern "C" int stats_panel_launch(const void* pos, const void* af,
                                  const void* cadd, const void* rank, int k,
                                  const void* starts, const void* ends, int q,
                                  void* scratch, long long scratch_words,
                                  void* lo, void* hi, void* af_lanes,
                                  void* af_hist, void* cadd_lanes,
                                  void* cadd_hist, void* rank_counts,
                                  void* stream) {
  if (q <= 0) return 0;
  if (k < 0 || k >= (1 << 30) || q >= (1 << 30))
    return static_cast<int>(cudaErrorInvalidValue);
  const Layout l = layout(k, kPanelTile, kPanelSlots);
  if (scratch_words < static_cast<long long>(l.end) ||
      reinterpret_cast<uintptr_t>(scratch) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int32_t* base = static_cast<int32_t*>(scratch);
  const int32_t* f_af = static_cast<const int32_t*>(af);
  const int32_t* f_cadd = static_cast<const int32_t*>(cadd);
  const int32_t* f_rank = static_cast<const int32_t*>(rank);
  const int32_t* q_ends = static_cast<const int32_t*>(ends);
  int32_t* o_lo = static_cast<int32_t*>(lo);
  int32_t* o_hi = static_cast<int32_t*>(hi);
  cudaError_t err;
  reach_kernel<<<1, kScanThreads, 0, st>>>(q_ends, q, base);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const int searches = blocks(2LL * q, kThreads);
  count_kernel<true><<<searches + min(l.supers, kTileBlocks), kThreads, 0, st>>>(
      static_cast<const int32_t*>(pos), f_af, f_cadd, f_rank, k,
      static_cast<const int32_t*>(starts), q_ends, q, 1, searches, l.supers,
      base, o_lo, o_hi, base + l.local, base + l.sup);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  scan_supers_kernel<<<kPanelC, kScanThreads, 0, st>>>(base + l.sup, l.supers,
                                                       kPanelSlots);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  panel_kernel<<<blocks(q, kWarps / 2), kThreads, 0, st>>>(
      f_af, f_cadd, f_rank, k, base + l.local, base + l.sup, o_lo, o_hi, q,
      static_cast<int32_t*>(af_lanes), static_cast<int32_t*>(af_hist),
      static_cast<int32_t*>(cadd_lanes), static_cast<int32_t*>(cadd_hist),
      static_cast<int32_t*>(rank_counts));
  return static_cast<int>(cudaGetLastError());
}

// The windowed scan.  `scratch` holds `scratch_words` int32, 16-byte
// aligned (at least ops/stats.py::scratch_words("windows", k, q,
// windows)): the layout above, then the boundaries' indices [Q][W + 1].
extern "C" int windowed_stats_launch(const void* pos, const void* cadd, int k,
                                     const void* starts, const void* ends, int q,
                                     int windows, void* scratch,
                                     long long scratch_words, void* counts,
                                     void* present, void* lanes, void* stream) {
  if (q <= 0) return 0;
  if (k < 0 || k >= (1 << 30) || q >= (1 << 30) || windows < 1 ||
      windows > kMaxWindows)
    return static_cast<int>(cudaErrorInvalidValue);
  const Layout l = layout(k, kWindowTile, kWindowSlots);
  const long long keys = static_cast<long long>(q) * (windows + 1);
  if (keys >= (1LL << 31) || scratch_words < static_cast<long long>(l.end) + keys ||
      reinterpret_cast<uintptr_t>(scratch) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int32_t* base = static_cast<int32_t*>(scratch);
  int32_t* idx = base + l.end;
  const int32_t* f_cadd = static_cast<const int32_t*>(cadd);
  cudaError_t err;
  const int searches = blocks(keys, kThreads);
  count_kernel<false><<<searches + min(l.supers, kTileBlocks), kThreads, 0, st>>>(
      static_cast<const int32_t*>(pos), nullptr, f_cadd, nullptr, k,
      static_cast<const int32_t*>(starts), static_cast<const int32_t*>(ends), q,
      windows, searches, l.supers, base, idx, nullptr, base + l.local,
      base + l.sup);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  scan_supers_kernel<<<kWinC, kScanThreads, 0, st>>>(base + l.sup, l.supers,
                                                     kWindowSlots);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  window_kernel<<<blocks(q, kThreads / (windows + 1)), kThreads, 0, st>>>(
      f_cadd, k, base + l.local, base + l.sup, idx, q, windows,
      static_cast<int32_t*>(counts), static_cast<int32_t*>(present),
      static_cast<int32_t*>(lanes));
  return static_cast<int>(cudaGetLastError());
}
