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
// a row that did not match cannot match, so the loop ends at row K - 1
// instead.  Rows at and after lo are sorted, so once a row's position
// differs from the variant's, every later row's does too, and the loop
// ends there as well.  Sentinel rows (pos = INT32_MAX, all-zero alleles)
// need no special case: a real allele is never all zero bytes, so a
// variant at INT32_MAX compares against them and never matches.
//
// Bound: memory.  Each variant reads its position and two W-byte allele
// rows and writes 5 bytes; the probe reads at most `probe` score rows
// (4 + 2W bytes each), fewer where the run at its position is shorter,
// and neighbouring variants share rows.  The arithmetic is a binary
// search of log2(K) steps and at most 4W byte compares a probed row.
//
// Design: one thread per variant, 256 threads a block.  The binary search
// reads `spos` through the read-only path: the top levels of the search
// are the same for every thread and stay in L1/L2.  Rows are W bytes and W
// (49 by default) is not a multiple of 4, so rows are not word-aligned and
// the compares load bytes; a compare stops at the first differing byte, so
// a non-matching candidate row usually costs one or two bytes.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ bool rows_equal(const uint8_t* __restrict__ a,
                                           const uint8_t* __restrict__ b,
                                           int w) {
  for (int j = 0; j < w; ++j) {
    if (__ldg(a + j) != __ldg(b + j)) return false;
  }
  return true;
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
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const int32_t p = __ldg(vpos + i);
  // lower bound: the first row whose position is not below p (k when none)
  int lo = 0;
  int hi = k;
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (__ldg(spos + mid) < p) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  const uint8_t* vr = vref + static_cast<size_t>(i) * w;
  const uint8_t* va = valt + static_cast<size_t>(i) * w;
  const int end = (k - lo < probe) ? k : lo + probe;
  int found = -1;
  for (int idx = lo; idx < end; ++idx) {
    if (__ldg(spos + idx) != p) break;
    const uint8_t* sr = sref + static_cast<size_t>(idx) * w;
    const uint8_t* sa = salt + static_cast<size_t>(idx) * w;
    const bool ref_in = rows_equal(vr, sr, w) || rows_equal(vr, sa, w);
    if (ref_in && (rows_equal(va, sr, w) || rows_equal(va, sa, w))) {
      found = idx;
      break;
    }
  }
  matched[i] = found >= 0 ? 1 : 0;
  match_idx[i] = found;
}

}  // namespace

// Launches on `stream`; returns a cudaError_t (0 = ok).  `matched` is one
// byte a variant (torch.bool), `match_idx` int32.
extern "C" int cadd_join_launch(const void* vpos, const void* vref,
                                const void* valt, const void* spos,
                                const void* sref, const void* salt, int n,
                                int k, int w, int probe, void* matched,
                                void* match_idx, void* stream) {
  if (n < 0 || k < 1 || w < 1 || probe < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  const int grid = (n + kThreads - 1) / kThreads;
  cadd_join_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(vpos), static_cast<const uint8_t*>(vref),
      static_cast<const uint8_t*>(valt), static_cast<const int32_t*>(spos),
      static_cast<const uint8_t*>(sref), static_cast<const uint8_t*>(salt), n,
      k, w, probe, static_cast<uint8_t*>(matched),
      static_cast<int32_t*>(match_idx));
  return static_cast<int>(cudaGetLastError());
}
