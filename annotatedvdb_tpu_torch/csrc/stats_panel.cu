// Fused analytics kernels for Hopper (sm_90a): the stats panel and the
// windowed scan of one chromosome group's feature columns over a panel of
// query intervals.
//
// Replace annotatedvdb_tpu/ops/stats.py::stats_panel_kernel and
// ::windowed_stats_kernel (XLA programs, not Pallas kernels).  Inputs: `pos`
// [K] int32, position-sorted and sentinel-padded to a power of two; the
// int32 fixed-point feature columns `af`, `cadd`, `rank` [K] aligned to it
// (-1 = missing, so padded rows count nothing); `starts`/`ends` [Q] int32,
// clamped, 1-based inclusive.  The panel returns lo/hi [Q] (left and right
// searchsorted) and, per query, the difference of row counters between hi
// and lo: 21 AF bit lanes, 10 AF histogram bins, 21 CADD lanes, 10 CADD
// bins and 32 rank buckets (94 int32 counters).  The windowed scan splits
// each query into W <= 64 equal windows (boundary b_w = start + q*w +
// (r*w)/W, q and r from the floor division of end - start + 1 by W, int32 as
// in the reference), searches each boundary (left), and returns per window
// the row count, the CADD present count and the 21 CADD lanes.
//
// The reference builds [K, 94] int32 one-hot and bit-plane cumulants and
// gathers them at the span ends: ~1.6 GB per call at the serving shape.
// Here a counter at row x, cum(x) = the count over rows [0, x), is split as
// (the counts of whole 256-row tiles before x) + (the rows of x's tile
// before x):
//   pass 1, one block per tile: each warp counts its 32 rows with one ballot
//     and popcount per counter, and the block sums its 8 warps;
//   pass 2, one block per counter: an exclusive scan over the tiles, into a
//     [counters][tiles + 1] table;
//   pass 3, one block per query: the searches, then each endpoint's partial
//     tile counted like pass 1, and the answer cum(hi) - cum(lo).
// Integer sums are exact in any order, so the outputs equal the reference's
// int32 cumulant differences bit for bit.  Both C entry points launch the
// three passes on one stream.
//
// Bound: memory.  Pass 1 reads the 12 (panel) or 4 (windowed) feature bytes
// of every row once; pass 3 reads at most 255 rows of a tile per endpoint and
// the search paths, and writes 376 (panel) or 92 W (windowed) bytes a query.
// At the serving shape (K = 4,194,304 padded rows, Q = 4,096) the panel's
// bytes are ~52 MB, ~16 us at 3.35 TB/s; the ballots (94 a warp per 32 rows)
// are of the same order on 132 SMs.  What the card can approach is that
// plus three launches.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 256;  // rows a tile = threads a block of passes 1, 3
constexpr int kWarps = kTile / 32;
constexpr unsigned kAll = 0xffffffffu;
constexpr int kSumBits = 21;   // ops/stats.py::SUM_BITS
constexpr int kBins = 10;      // len(AF_EDGES_FP) - 1 == len(CADD_EDGES_FP) - 1
constexpr int kRanks = 32;     // ops/stats.py::RANK_BUCKETS
constexpr int kMaxWindows = 64;  // ops/stats.py::MAX_WINDOWS
constexpr int kPanelC = 2 * kSumBits + 2 * kBins + kRanks;  // 94
constexpr int kWinC = 1 + kSumBits;                          // 22
constexpr int kSlots = 96;  // counters a warp holds: 3 a lane
constexpr int kScanThreads = 1024;

// ops/stats.py::AF_EDGES_FP and ::CADD_EDGES_FP
__constant__ int32_t kAfEdges[kBins + 1] = {
    0, 10, 100, 1000, 5000, 10000, 50000, 100000, 250000, 500000, 1000000};
__constant__ int32_t kCaddEdges[kBins + 1] = {
    0, 1000, 5000, 10000, 15000, 20000, 25000, 30000, 40000, 50000, 100000};

// The warp's count of `pred` into counter c, held by lane c % 32 in slot
// c / 32 (c is a constant after unrolling, so the slot is a register).
__device__ __forceinline__ void tally(int32_t (&acc)[3], int lane, int c,
                                      bool pred) {
  const int n = __popc(__ballot_sync(kAll, pred));
  if (lane == (c & 31)) acc[c >> 5] += n;
}

// searchsorted(edges, v, right) - 1, clipped to [0, kBins - 1]
__device__ __forceinline__ int bucket(int32_t v, const int32_t* edges) {
  int b = 0;
#pragma unroll
  for (int j = 1; j < kBins; ++j) b += v >= edges[j];
  return b;
}

__device__ __forceinline__ void panel_row(bool valid, int32_t af, int32_t cadd,
                                          int32_t rank, int32_t (&acc)[3],
                                          int lane) {
  const bool a = valid && af >= 0, c = valid && cadd >= 0,
             r = valid && rank >= 0;
  const int ab = bucket(af, kAfEdges), cb = bucket(cadd, kCaddEdges);
  const int rb = min(max(rank, 0), kRanks - 1);
#pragma unroll
  for (int b = 0; b < kSumBits; ++b) tally(acc, lane, b, a && ((af >> b) & 1));
#pragma unroll
  for (int j = 0; j < kBins; ++j) tally(acc, lane, kSumBits + j, a && ab == j);
#pragma unroll
  for (int b = 0; b < kSumBits; ++b)
    tally(acc, lane, kSumBits + kBins + b, c && ((cadd >> b) & 1));
#pragma unroll
  for (int j = 0; j < kBins; ++j)
    tally(acc, lane, 2 * kSumBits + kBins + j, c && cb == j);
#pragma unroll
  for (int j = 0; j < kRanks; ++j)
    tally(acc, lane, 2 * kSumBits + 2 * kBins + j, r && rb == j);
}

__device__ __forceinline__ void window_row(bool valid, int32_t cadd,
                                           int32_t (&acc)[3], int lane) {
  const bool c = valid && cadd >= 0;
  tally(acc, lane, 0, c);
#pragma unroll
  for (int b = 0; b < kSumBits; ++b) tally(acc, lane, 1 + b, c && ((cadd >> b) & 1));
}

// The counters of rows [base + 0, end) of one tile (base = a multiple of
// kTile), one row a thread, summed over the block into out[0..C).  Every
// thread of the block calls it (the ballots need whole warps).
template <bool kPanel>
__device__ __forceinline__ void count_rows(int base, int end,
                                           const int32_t* __restrict__ af,
                                           const int32_t* __restrict__ cadd,
                                           const int32_t* __restrict__ rank,
                                           int32_t (*red)[kSlots], int32_t* out) {
  constexpr int C = kPanel ? kPanelC : kWinC;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row = base + static_cast<int>(threadIdx.x);
  const bool valid = row < end;
  int32_t acc[3] = {0, 0, 0};
  if (kPanel) {
    panel_row(valid, valid ? __ldg(af + row) : -1, valid ? __ldg(cadd + row) : -1,
              valid ? __ldg(rank + row) : -1, acc, lane);
  } else {
    window_row(valid, valid ? __ldg(cadd + row) : -1, acc, lane);
  }
#pragma unroll
  for (int j = 0; j < 3; ++j) red[warp][lane + 32 * j] = acc[j];
  __syncthreads();
  if (threadIdx.x < C) {
    int32_t s = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[w][threadIdx.x];
    out[threadIdx.x] = s;
  }
  __syncthreads();
}

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

// Pass 1: tile t's counters into cum[c][t + 1].
template <bool kPanel>
__global__ void __launch_bounds__(kTile)
tile_counts_kernel(const int32_t* __restrict__ af,
                   const int32_t* __restrict__ cadd,
                   const int32_t* __restrict__ rank, int k, int tiles,
                   int32_t* __restrict__ cum) {
  constexpr int C = kPanel ? kPanelC : kWinC;
  __shared__ int32_t red[kWarps][kSlots];
  __shared__ int32_t out[kSlots];
  const int tile = blockIdx.x;
  count_rows<kPanel>(tile * kTile, k, af, cadd, rank, red, out);
  if (threadIdx.x < C) cum[threadIdx.x * (tiles + 1) + tile + 1] = out[threadIdx.x];
}

// Pass 2: counter c's column cum[c][1..tiles] scanned in place (inclusive),
// cum[c][0] = 0: cum[c][t] is then the count over the tiles before t.  Each
// thread takes a contiguous run of tiles.
__global__ void __launch_bounds__(kScanThreads)
scan_tiles_kernel(int32_t* __restrict__ cum, int tiles) {
  __shared__ int32_t warp_sum[kScanThreads / 32];
  int32_t* col = cum + static_cast<size_t>(blockIdx.x) * (tiles + 1);
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int per = (tiles + kScanThreads - 1) / kScanThreads;
  const int b0 = min(1 + t * per, tiles + 1), b1 = min(b0 + per, tiles + 1);
  int32_t local = 0;
  for (int i = b0; i < b1; ++i) local += col[i];
  int32_t incl = local;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int32_t v = __shfl_up_sync(kAll, incl, d);
    if (lane >= d) incl += v;
  }
  if (lane == 31) warp_sum[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int32_t v = warp_sum[lane];
    int32_t w_incl = v;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int32_t u = __shfl_up_sync(kAll, w_incl, d);
      if (lane >= d) w_incl += u;
    }
    warp_sum[lane] = w_incl - v;  // exclusive over the warps
  }
  __syncthreads();
  int32_t run = warp_sum[warp] + incl - local;
  for (int i = b0; i < b1; ++i) {
    run += col[i];
    col[i] = run;
  }
  if (t == 0) col[0] = 0;
}

// Pass 3 of the panel: one block per query.
__global__ void __launch_bounds__(kTile)
panel_kernel(const int32_t* __restrict__ pos, const int32_t* __restrict__ af,
             const int32_t* __restrict__ cadd, const int32_t* __restrict__ rank,
             int k, int tiles, const int32_t* __restrict__ cum,
             const int32_t* __restrict__ starts, const int32_t* __restrict__ ends,
             int32_t* __restrict__ lo_out, int32_t* __restrict__ hi_out,
             int32_t* __restrict__ af_lanes, int32_t* __restrict__ af_hist,
             int32_t* __restrict__ cadd_lanes, int32_t* __restrict__ cadd_hist,
             int32_t* __restrict__ rank_counts) {
  __shared__ int32_t red[kWarps][kSlots];
  __shared__ int32_t part[2][kSlots];
  const int i = blockIdx.x;
  const int lo = lower_bound(pos, k, __ldg(starts + i));
  const int hi = upper_bound(pos, k, __ldg(ends + i));
  count_rows<true>(lo & ~(kTile - 1), lo, af, cadd, rank, red, part[0]);
  count_rows<true>(hi & ~(kTile - 1), hi, af, cadd, rank, red, part[1]);
  const int c = threadIdx.x;
  if (c < kPanelC) {
    const int32_t* col = cum + static_cast<size_t>(c) * (tiles + 1);
    const int32_t v = (col[hi / kTile] + part[1][c]) - (col[lo / kTile] + part[0][c]);
    const size_t q = i;
    if (c < kSumBits) {
      af_lanes[q * kSumBits + c] = v;
    } else if (c < kSumBits + kBins) {
      af_hist[q * kBins + (c - kSumBits)] = v;
    } else if (c < 2 * kSumBits + kBins) {
      cadd_lanes[q * kSumBits + (c - kSumBits - kBins)] = v;
    } else if (c < 2 * kSumBits + 2 * kBins) {
      cadd_hist[q * kBins + (c - 2 * kSumBits - kBins)] = v;
    } else {
      rank_counts[q * kRanks + (c - 2 * kSumBits - 2 * kBins)] = v;
    }
  }
  if (c == 0) {
    lo_out[i] = lo;
    hi_out[i] = hi;
  }
}

// Pass 3 of the windowed scan: one block per query, the windows' boundaries
// in turn.
__global__ void __launch_bounds__(kTile)
window_kernel(const int32_t* __restrict__ pos, const int32_t* __restrict__ cadd,
              int k, int tiles, const int32_t* __restrict__ cum,
              const int32_t* __restrict__ starts, const int32_t* __restrict__ ends,
              int windows, int32_t* __restrict__ counts,
              int32_t* __restrict__ present, int32_t* __restrict__ lanes) {
  __shared__ int32_t red[kWarps][kSlots];
  __shared__ int32_t part[kSlots];
  __shared__ int32_t at[kMaxWindows + 1][kWinC];
  __shared__ int32_t idx[kMaxWindows + 1];
  const int i = blockIdx.x;
  const int32_t s = __ldg(starts + i), e = __ldg(ends + i);
  const int32_t span = e - s + 1;
  int32_t qd = span / windows, r = span % windows;
  if (r < 0) {  // floor division, as numpy's and jnp's
    r += windows;
    --qd;
  }
  for (int w = 0; w <= windows; ++w) {
    const int32_t b = s + qd * w + (r * w) / windows;
    const int x = lower_bound(pos, k, b);
    count_rows<false>(x & ~(kTile - 1), x, nullptr, cadd, nullptr, red, part);
    if (threadIdx.x < kWinC)
      at[w][threadIdx.x] =
          cum[static_cast<size_t>(threadIdx.x) * (tiles + 1) + x / kTile] +
          part[threadIdx.x];
    if (threadIdx.x == 0) idx[w] = x;
  }
  __syncthreads();
  for (int t = threadIdx.x; t < windows * (kWinC + 1); t += kTile) {
    const int w = t / (kWinC + 1), f = t % (kWinC + 1);
    const size_t o = static_cast<size_t>(i) * windows + w;
    if (f == 0) {
      counts[o] = idx[w + 1] - idx[w];
    } else if (f == 1) {
      present[o] = at[w + 1][0] - at[w][0];
    } else {
      lanes[o * kSumBits + (f - 2)] = at[w + 1][f - 1] - at[w][f - 1];
    }
  }
}

template <bool kPanel>
int tile_passes(const int32_t* af, const int32_t* cadd, const int32_t* rank,
                int k, int32_t* cum, cudaStream_t stream) {
  const int tiles = (k + kTile - 1) / kTile;
  if (tiles > 0) {
    tile_counts_kernel<kPanel><<<tiles, kTile, 0, stream>>>(af, cadd, rank, k,
                                                            tiles, cum);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  scan_tiles_kernel<<<kPanel ? kPanelC : kWinC, kScanThreads, 0, stream>>>(cum,
                                                                          tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The stats panel.  `scratch` holds kPanelC * (ceil(k / 256) + 1) int32.
// Launches on `stream`; returns the first cudaError_t (0 = all queued).
extern "C" int stats_panel_launch(const void* pos, const void* af,
                                  const void* cadd, const void* rank, int k,
                                  const void* starts, const void* ends, int q,
                                  void* scratch, void* lo, void* hi,
                                  void* af_lanes, void* af_hist,
                                  void* cadd_lanes, void* cadd_hist,
                                  void* rank_counts, void* stream) {
  if (q <= 0) return 0;
  if (k < 0 || k >= (1 << 30)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int32_t* cum = static_cast<int32_t*>(scratch);
  const int rc = tile_passes<true>(static_cast<const int32_t*>(af),
                                   static_cast<const int32_t*>(cadd),
                                   static_cast<const int32_t*>(rank), k, cum, st);
  if (rc != 0) return rc;
  panel_kernel<<<q, kTile, 0, st>>>(
      static_cast<const int32_t*>(pos), static_cast<const int32_t*>(af),
      static_cast<const int32_t*>(cadd), static_cast<const int32_t*>(rank), k,
      (k + kTile - 1) / kTile, cum, static_cast<const int32_t*>(starts),
      static_cast<const int32_t*>(ends), static_cast<int32_t*>(lo),
      static_cast<int32_t*>(hi), static_cast<int32_t*>(af_lanes),
      static_cast<int32_t*>(af_hist), static_cast<int32_t*>(cadd_lanes),
      static_cast<int32_t*>(cadd_hist), static_cast<int32_t*>(rank_counts));
  return static_cast<int>(cudaGetLastError());
}

// The windowed scan.  `scratch` holds kWinC * (ceil(k / 256) + 1) int32.
extern "C" int windowed_stats_launch(const void* pos, const void* cadd, int k,
                                     const void* starts, const void* ends, int q,
                                     int windows, void* scratch, void* counts,
                                     void* present, void* lanes, void* stream) {
  if (q <= 0) return 0;
  if (k < 0 || k >= (1 << 30) || windows < 1 || windows > kMaxWindows)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int32_t* cum = static_cast<int32_t*>(scratch);
  const int rc = tile_passes<false>(nullptr, static_cast<const int32_t*>(cadd),
                                    nullptr, k, cum, st);
  if (rc != 0) return rc;
  window_kernel<<<q, kTile, 0, st>>>(
      static_cast<const int32_t*>(pos), static_cast<const int32_t*>(cadd), k,
      (k + kTile - 1) / kTile, cum, static_cast<const int32_t*>(starts),
      static_cast<const int32_t*>(ends), windows, static_cast<int32_t*>(counts),
      static_cast<int32_t*>(present), static_cast<int32_t*>(lanes));
  return static_cast<int>(cudaGetLastError());
}
