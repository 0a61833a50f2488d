// Sorted score-table join kernel for Hopper (sm_90a): the CADD evidence
// lookup.
//
// Replaces annotatedvdb_tpu/ops/cadd_join.py::cadd_join_kernel (an XLA
// program, not a Pallas kernel).  For each variant: the lower bound of its
// position in the block's position-sorted `spos` (a left searchsorted),
// then up to `probe` rows from there; a row matches when both of the
// variant's alleles are in the row's allele set {s_ref, s_alt} by
// full-width byte equality, and the first matching row wins.  Outputs
// matched [N] (one byte, 0/1) and match_idx [N] int32 (-1 where unmatched).
//
// Equivalence with the reference's loop, which ORs `matched` over every
// probe and keeps the first hit's index: the probes run in the same order
// (lo, lo + 1, ...), so stopping at the first hit gives the same pair.  The
// reference clips lo + k to K - 1, re-probing the last row; a re-probe of
// a row that did not match cannot match, so the probe ends at row K - 1
// instead.  Rows at and after lo are sorted, so once a row's position
// differs from the variant's, every later row's does too, and the probe
// ends there as well.  Sentinel rows (pos = INT32_MAX, all-zero alleles)
// need no special case: a real allele is never all zero bytes, so a
// variant at INT32_MAX compares against them and never matches.  Nothing
// here needs the variants sorted.
//
// Bound: memory.  Each variant reads its position and two W-byte allele
// rows and writes 5 bytes; the probe reads at most `probe` score rows
// (4 + 2W bytes each), fewer where the run at its position is shorter,
// and neighbouring variants share rows.  The arithmetic is a search of
// log2(K) steps and at most 4W byte compares a probed row.  At the main
// path's shapes (8,192 or 16,384 variants against 262,144 rows) the bytes
// take well under a microsecond, so what the card can approach is a chain
// of a few dependent loads and the launch.
//
// What held the first design back (one thread per variant, 256 a block):
// 32 or 64 blocks on 132 SMs, so little latency to hide behind; an 18-step
// binary search, each step a load waiting on the one before; compares one
// byte a dependent load, up to 4W loads for a matching row; and a warp's
// j-th byte load touching 32 rows W bytes apart.
//
// Design: one warp per variant, 8 a block, so the SNV shape alone puts
// 8,192 warps on the card.
// - The lower bound is a 32-ary search: lane l loads the l-th of 32
//   evenly spaced pivots of the range, and a ballot narrows the range
//   33-fold, so K = 262,144 takes 4 dependent rounds instead of 18.  With
//   position-sorted variants (the loader's windows), neighbouring warps
//   search neighbouring ranges and the upper rounds stay in L1/L2.
// - The probe: lane l loads spos[lb + l] for up to 32 rows in one
//   coalesced request; a ballot over `== p` gives the run at the
//   variant's position (a prefix of the window, the rows being sorted).
//   A window of 32 that is all run continues with the next 32.
// - The compares: each lane holds the variant's bytes at columns l and
//   l + 32 in registers; for the run's rows, four at a time with all
//   their loads in flight together, the lanes load each row's two W-byte
//   alleles at the same columns (contiguous, so coalesced) and four
//   __all_sync votes give ref-in and alt-in.  Columns past 64 (W > 64)
//   loop over further 32-byte columns.  The first row that passes wins,
//   and lane 0 writes both outputs.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;  // variants a block
constexpr int kThreads = 32 * kWarps;
constexpr int kGroup = 4;  // candidate rows whose loads are issued together
constexpr unsigned kAll = 0xffffffffu;

__device__ __forceinline__ uint8_t byte_at(const uint8_t* __restrict__ row,
                                           int col, int w) {
  return col < w ? __ldg(row + col) : uint8_t{0};
}

__global__ void __launch_bounds__(kThreads)
cadd_join_kernel(const int32_t* __restrict__ vpos,
                 const uint8_t* __restrict__ vref,
                 const uint8_t* __restrict__ valt,
                 const int32_t* __restrict__ spos,
                 const uint8_t* __restrict__ sref,
                 const uint8_t* __restrict__ salt, int n, int k, int w,
                 int probe, uint8_t* __restrict__ matched,
                 int32_t* __restrict__ match_idx) {
  const int lane = threadIdx.x & 31;
  const int v = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (v >= n) return;  // the whole warp
  const int32_t p = __ldg(vpos + v);
  const uint8_t* vr = vref + static_cast<size_t>(v) * w;
  const uint8_t* va = valt + static_cast<size_t>(v) * w;
  // the variant's columns lane and lane + 32, in flight during the search
  const uint8_t r0 = byte_at(vr, lane, w), r1 = byte_at(vr, lane + 32, w);
  const uint8_t a0 = byte_at(va, lane, w), a1 = byte_at(va, lane + 32, w);

  // lower bound: the first row whose position is not below p lies in
  // [lo, hi] (hi == k: none)
  int lo = 0;
  int hi = k;
  while (hi - lo > 32) {
    const int len = hi - lo;
    // 32 strictly increasing pivots in [lo, hi), since len >= 33
    const int q = lo + static_cast<int>(
        static_cast<long long>(len) * (lane + 1) / 33);
    const int below = __popc(__ballot_sync(kAll, __ldg(spos + q) < p));
    // pivots below p are lanes [0, below): rows up to pivot below - 1 are
    // below p, and pivot `below` (if any) is not
    const int q_below = __shfl_sync(kAll, q, (below + 31) & 31);
    const int q_above = __shfl_sync(kAll, q, below & 31);
    if (below > 0) lo = q_below + 1;
    if (below < 32) hi = q_above;
  }
  const int lb = lo + __popc(__ballot_sync(
      kAll, lo + lane < hi && __ldg(spos + lo + lane) < p));

  const int end = (k - lb < probe) ? k : lb + probe;
  int found = -1;
  for (int base = lb; base < end && found < 0; base += 32) {
    const unsigned at_p = __ballot_sync(
        kAll, base + lane < end && __ldg(spos + base + lane) == p);
    const int run = at_p == kAll ? 32 : __ffs(~at_p) - 1;
    for (int c = 0; c < run && found < 0; c += kGroup) {
      uint8_t s0[kGroup], s1[kGroup], t0[kGroup], t1[kGroup];
#pragma unroll
      for (int g = 0; g < kGroup; ++g) {
        const bool live = c + g < run;
        const size_t off = static_cast<size_t>(base + c + g) * w;
        s0[g] = live ? byte_at(sref + off, lane, w) : uint8_t{0};
        s1[g] = live ? byte_at(sref + off, lane + 32, w) : uint8_t{0};
        t0[g] = live ? byte_at(salt + off, lane, w) : uint8_t{0};
        t1[g] = live ? byte_at(salt + off, lane + 32, w) : uint8_t{0};
      }
#pragma unroll
      for (int g = 0; g < kGroup; ++g) {
        if (c + g >= run) break;  // warp-uniform
        const int row = base + c + g;
        bool rr = r0 == s0[g] && r1 == s1[g];  // ref == row's ref
        bool ra = r0 == t0[g] && r1 == t1[g];  // ref == row's alt
        bool ar = a0 == s0[g] && a1 == s1[g];  // alt == row's ref
        bool aa = a0 == t0[g] && a1 == t1[g];  // alt == row's alt
        const size_t off = static_cast<size_t>(row) * w;
        for (int col0 = 64; col0 < w; col0 += 32) {  // W > 64 only
          const int col = col0 + lane;
          const uint8_t x = byte_at(vr, col, w), y = byte_at(va, col, w);
          const uint8_t s = byte_at(sref + off, col, w);
          const uint8_t t = byte_at(salt + off, col, w);
          rr = rr && x == s;
          ra = ra && x == t;
          ar = ar && y == s;
          aa = aa && y == t;
        }
        const bool ref_in = __all_sync(kAll, rr) | __all_sync(kAll, ra);
        const bool alt_in = __all_sync(kAll, ar) | __all_sync(kAll, aa);
        if (ref_in && alt_in) {
          found = row;
          break;
        }
      }
    }
    if (run < 32) break;
  }
  if (lane == 0) {
    matched[v] = found >= 0 ? 1 : 0;
    match_idx[v] = found;
  }
}

}  // namespace

// Launches on `stream`; returns a cudaError_t (0 = ok).  `matched` is one
// byte a variant (torch.bool), `match_idx` int32.
extern "C" int cadd_join_launch(const void* vpos, const void* vref,
                                const void* valt, const void* spos,
                                const void* sref, const void* salt, int n,
                                int k, int w, int probe, void* matched,
                                void* match_idx, void* stream) {
  // row indices up to k + 31 and warp indices up to n + 7 stay in int
  if (n < 0 || n > INT_MAX - kWarps || k < 1 || k > INT_MAX - 32 || w < 1 ||
      probe < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  const int grid = (n + kWarps - 1) / kWarps;
  cadd_join_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(vpos), static_cast<const uint8_t*>(vref),
      static_cast<const uint8_t*>(valt), static_cast<const int32_t*>(spos),
      static_cast<const uint8_t*>(sref), static_cast<const uint8_t*>(salt), n,
      k, w, probe, static_cast<uint8_t*>(matched),
      static_cast<int32_t*>(match_idx));
  return static_cast<int>(cudaGetLastError());
}
