// Multi-chromosome store membership probe for Hopper (sm_90a): for each
// query identity, the first row of a shard's store slice that holds it.
//
// Replaces annotatedvdb_tpu/ops/dedup.py::lookup_in_sorted_multi (an XLA
// program, not a Pallas kernel), the probe every mesh step runs on its
// shard (parallel/distributed.py: insert, update and serve lookup).  The
// slice is sorted by (pos, chromosome-mixed hash) and holds several
// chromosomes: `s_pos` [M] int32 (POS_SENTINEL pad rows sort last), `s_hm`
// [M] int64 (uint32 values, non-negative), `s_chrom` [M] int8, `s_ref` and
// `s_alt` [M, W] uint8, `s_rl` and `s_al` [M] int32; the queries are the
// same columns at [N].  Per query, exactly as the reference:
//   lo = lower bound of pos in s_pos, hi = upper bound;
//   l  = lower bound of hm in s_hm[lo, hi);
//   then the candidates l, l + 1, l + 2, l + 3 (those < hi, at most four,
//   so a run of five or more equal (pos, hm) rows stops at four), each
//   confirmed on pos, hm, the chromosome byte, both lengths and all W bytes
//   of both alleles; the first confirmed candidate wins.
// Outputs: found [N] bool and index [N] int32 (-1 when absent).  M = 0 (an
// empty shard) reads nothing and finds nothing; a candidate is read only
// below hi <= M, so no clamp is needed.
//
// Bound: latency.  A query reads its own 2W + 21 bytes and writes 5; its
// three binary searches are ~log2(M) dependent loads each (20 at M = 2^20),
// the top levels shared by all queries and held in L2, the last few in
// sectors no other query touches.  The byte count of a call is far below
// what the card moves in a microsecond; what it waits on is the chain of
// dependent loads.
//
// Design: one thread per query, 256 a block.  The two position bounds are
// one search and a second from its answer (the upper bound starts at the
// lower), and the hash search runs inside the equal-position run, which
// is one to a few rows in a real store, so it ends in one or two steps.
// The confirmation reads the candidate's scalars first and its allele
// bytes only when those match.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ bool same_bytes(const uint8_t* __restrict__ a,
                                           const uint8_t* __restrict__ b,
                                           int w) {
  for (int k = 0; k < w; ++k) {
    if (__ldg(a + k) != __ldg(b + k)) return false;
  }
  return true;
}

__global__ void __launch_bounds__(kThreads)
lookup_multi_kernel(const int8_t* __restrict__ s_chrom,
                    const int32_t* __restrict__ s_pos,
                    const int64_t* __restrict__ s_hm,
                    const uint8_t* __restrict__ s_ref,
                    const uint8_t* __restrict__ s_alt,
                    const int32_t* __restrict__ s_rl,
                    const int32_t* __restrict__ s_al, int m,
                    const int8_t* __restrict__ chrom,
                    const int32_t* __restrict__ pos,
                    const int64_t* __restrict__ hm,
                    const uint8_t* __restrict__ ref,
                    const uint8_t* __restrict__ alt,
                    const int32_t* __restrict__ rl,
                    const int32_t* __restrict__ al, int n, int w,
                    bool* __restrict__ found, int32_t* __restrict__ index) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const int32_t p = __ldg(pos + i);
  const int64_t h = __ldg(hm + i);
  // lower bound of p
  int a = 0, b = m;
  while (a < b) {
    const int mid = a + ((b - a) >> 1);
    if (__ldg(s_pos + mid) < p) a = mid + 1; else b = mid;
  }
  const int lo = a;
  // upper bound of p, from lo
  b = m;
  while (a < b) {
    const int mid = a + ((b - a) >> 1);
    if (__ldg(s_pos + mid) <= p) a = mid + 1; else b = mid;
  }
  const int hi = a;
  // lower bound of h in [lo, hi)
  int l = lo, r = hi;
  while (l < r) {
    const int mid = l + ((r - l) >> 1);
    if (__ldg(s_hm + mid) < h) l = mid + 1; else r = mid;
  }
  const int8_t c = __ldg(chrom + i);
  const int32_t q_rl = __ldg(rl + i), q_al = __ldg(al + i);
  const size_t row = static_cast<size_t>(i) * w;
  bool hit = false;
  int32_t at = -1;
  for (int k = 0; k < 4 && l + k < hi; ++k) {
    const int j = l + k;
    if (__ldg(s_pos + j) != p || __ldg(s_hm + j) != h ||
        __ldg(s_chrom + j) != c || __ldg(s_rl + j) != q_rl ||
        __ldg(s_al + j) != q_al) {
      continue;
    }
    const size_t srow = static_cast<size_t>(j) * w;
    if (same_bytes(s_ref + srow, ref + row, w) &&
        same_bytes(s_alt + srow, alt + row, w)) {
      hit = true;
      at = j;
      break;
    }
  }
  found[i] = hit;
  index[i] = at;
}

bool misaligned(const void* p, uintptr_t align) {
  return (reinterpret_cast<uintptr_t>(p) & (align - 1)) != 0;
}

}  // namespace

// Launches on `stream`; returns the cudaError_t of the launch (0 = queued).
// Refuses (cudaErrorInvalidValue) a negative size or an int32/int64 column
// off its natural alignment.
extern "C" int lookup_multi_launch(
    const void* s_chrom, const void* s_pos, const void* s_hm,
    const void* s_ref, const void* s_alt, const void* s_rl, const void* s_al,
    int m, const void* chrom, const void* pos, const void* hm,
    const void* ref, const void* alt, const void* rl, const void* al, int n,
    int w, void* found, void* index, void* stream) {
  if (m < 0 || n < 0 || w < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (misaligned(s_pos, 4) || misaligned(s_rl, 4) || misaligned(s_al, 4) ||
      misaligned(pos, 4) || misaligned(rl, 4) || misaligned(al, 4) ||
      misaligned(index, 4) || misaligned(s_hm, 8) || misaligned(hm, 8)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  const int blocks = (n + kThreads - 1) / kThreads;
  lookup_multi_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(s_chrom), static_cast<const int32_t*>(s_pos),
      static_cast<const int64_t*>(s_hm), static_cast<const uint8_t*>(s_ref),
      static_cast<const uint8_t*>(s_alt), static_cast<const int32_t*>(s_rl),
      static_cast<const int32_t*>(s_al), m, static_cast<const int8_t*>(chrom),
      static_cast<const int32_t*>(pos), static_cast<const int64_t*>(hm),
      static_cast<const uint8_t*>(ref), static_cast<const uint8_t*>(alt),
      static_cast<const int32_t*>(rl), static_cast<const int32_t*>(al), n, w,
      static_cast<bool*>(found), static_cast<int32_t*>(index));
  return static_cast<int>(cudaGetLastError());
}
