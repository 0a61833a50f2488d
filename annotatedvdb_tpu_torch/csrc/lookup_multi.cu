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
// below hi <= M, so no clamp is needed.  A candidate inside [lo, hi) has
// the query's position by construction, so its position is not read again.
//
// Bound: latency and the memory system's scattered reads.  A query reads
// its own scalars (21 bytes) and, where a candidate matches them, its 2W
// allele bytes, and writes 5; its searches are ~log2(M) dependent loads
// (20 at M = 2^20), the top levels shared by all queries, the last few in
// sectors no other query touches, and a matching candidate's alleles are
// two rows at a random place in the slice.  The bytes of a call take a
// few microseconds at 3.35 TB/s; what the card waits on is the chain of
// dependent loads and the scattered sectors each warp-wide load touches.
//
// What held the first design back (a thread a query, 256 a block; PERF.md
// has the times): (1) the allele compare read one byte a step from each
// lane's own row, up to 2W dependent loads chained by an early exit, each
// instruction touching up to 32 sectors, one a lane: 40 of its 58.8 us
// at the mesh's probe shape.  (2) The upper bound of pos restarted at M:
// a full ~20-step search for a run of one to three equal positions (7 us).
//
// Design: one thread a query for the searches, the warp's lanes together
// for the allele bytes.
// - The lower bound of pos is a binary search (a step costs one sector).
//   The upper bound gallops from it (lo, lo + 1, lo + 3, lo + 7, ...) and
//   then searches inside the bracket it found: two or three steps for a
//   real run, in sectors the lower bound's last steps already brought in.
//   The hash's lower bound runs inside [lo, hi) as before.
// - Each lane then checks its up to four candidates' scalars (hash,
//   chromosome, both lengths) with loads that wait on nothing but l, and
//   keeps a bit a candidate that passes.
// - The warp confirms those candidates in rounds: the lanes with a
//   pending candidate are taken in order (ballot), kGroups a round, each
//   by a group of kGroup lanes that receives its (query, row) pair by
//   __shfl_sync.  The lanes of a group take the 8-aligned words under the
//   slice's row in turn (one each at W = 49) and funnel-shift the query
//   row's bytes at the same offsets out of two aligned words, so a row is
//   one load instruction a group and rows need no alignment (they start
//   at j * W); bytes outside the row are masked, and a word reaching past
//   a matrix's ends is read byte by byte inside it.  There is no early
//   exit: every load of a round goes out at once.  One ballot gives every
//   group's verdict.  A lane's candidates are served lowest first and a
//   confirmed one clears the rest, so the first confirmed candidate wins
//   as in the reference.
// - No lane leaves before the warp's last round: every ballot and shuffle
//   names the whole warp, and lanes past N carry no candidate.
// Measured against this (PERF.md): byte loads for the compare (8% slower),
// groups of 4, 16 and 32 lanes (equal, 28% and 78% slower), 128-thread
// blocks (equal), and the pending rows prefetched to L2 before the rounds
// (5% slower).  At the probe shape the searches take about half of what
// is left, the candidates' scalars a tenth and the confirmations, bound
// by scattered reads of the slice's allele rows, the rest.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;             // queries (threads) a block
constexpr int kGroup = 8;                 // lanes that confirm one candidate
constexpr int kGroups = 32 / kGroup;      // candidates confirmed a round
constexpr unsigned kAll = 0xffffffffu;
constexpr unsigned kGroupMask = (1u << kGroup) - 1;

// The 8-byte word at the 8-aligned address `a`, its bytes outside [lo, hi)
// read as 0 (and not read): only a matrix's first and last rows reach past
// its ends.
__device__ __forceinline__ uint64_t word_at(uintptr_t a, uintptr_t lo,
                                            uintptr_t hi) {
  if (a >= lo && a + 8 <= hi) {
    return __ldg(reinterpret_cast<const unsigned long long*>(a));
  }
  uint64_t v = 0;
  for (int b = 0; b < 8; ++b) {
    if (a + b >= lo && a + b < hi) {
      v |= static_cast<uint64_t>(__ldg(reinterpret_cast<const uint8_t*>(a + b)))
           << (8 * b);
    }
  }
  return v;
}

// Bits [s, s + 64) of the 128-bit value hi:lo, 0 <= s < 64.
__device__ __forceinline__ uint64_t funnel(uint64_t lo, uint64_t hi, int s) {
  return s == 0 ? lo : (lo >> s) | (hi << (64 - s));
}

// This lane's share of the difference between the w-byte rows at `s` (in
// a matrix spanning [s_lo, s_hi)) and `q` (in [q_lo, q_hi)): nonzero if
// they differ in a byte it reads.  The group's lanes take the 8-aligned
// words under the `s` row in turn (lane `sub` the words sub, sub +
// kGroup, ...); the `q` bytes at the same row offsets are two aligned
// words funnel-shifted into place, and bytes outside the row are masked.
__device__ __forceinline__ uint64_t row_diff(uintptr_t s, uintptr_t s_lo,
                                             uintptr_t s_hi, uintptr_t q,
                                             uintptr_t q_lo, uintptr_t q_hi,
                                             int w, int sub) {
  const int so = static_cast<int>(s & 7);
  const int words = (so + w + 7) >> 3;
  uint64_t diff = 0;
  for (int k = sub; k < words; k += kGroup) {
    const int r0 = 8 * k - so;  // the row offset of the word's first byte
    const uint64_t sv = word_at(s - so + 8 * k, s_lo, s_hi);
    const uintptr_t qa = q + r0;
    const int qo = static_cast<int>(qa & 7);
    const uint64_t q0 = word_at(qa - qo, q_lo, q_hi);
    const uint64_t q1 = qo != 0 ? word_at(qa - qo + 8, q_lo, q_hi) : 0;
    uint64_t keep = ~0ull;
    if (r0 < 0) keep <<= 8 * -r0;
    if (w - r0 < 8) keep &= (1ull << (8 * (w - r0))) - 1;
    diff |= (sv ^ funnel(q0, q1, 8 * qo)) & keep;
  }
  return diff;
}

// The first index in [a, b) whose position is not below p (b if none).
__device__ __forceinline__ int lower_pos(const int32_t* __restrict__ s_pos,
                                         int a, int b, int32_t p) {
  while (a < b) {
    const int mid = a + ((b - a) >> 1);
    if (__ldg(s_pos + mid) < p) a = mid + 1; else b = mid;
  }
  return a;
}

// The first index in [a, m) whose position is above p (m if none), where
// every index before a holds a position <= p: gallop from a to a bracket,
// then search inside it.
__device__ __forceinline__ int upper_pos_from(
    const int32_t* __restrict__ s_pos, int a, int m, int32_t p) {
  int b = m;
  for (int step = 1; a < b; step = step < (1 << 29) ? 2 * step : step) {
    const int j = a + min(step, b - a) - 1;
    if (__ldg(s_pos + j) > p) {
      b = j;
      break;
    }
    a = j + 1;
  }
  while (a < b) {
    const int mid = a + ((b - a) >> 1);
    if (__ldg(s_pos + mid) <= p) a = mid + 1; else b = mid;
  }
  return a;
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
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  int l = 0;
  unsigned pend = 0;  // bit k: candidate l + k matches on every scalar
  if (i < n) {
    const int32_t p = __ldg(pos + i);
    const int64_t h = __ldg(hm + i);
    const int8_t c = __ldg(chrom + i);
    const int32_t q_rl = __ldg(rl + i), q_al = __ldg(al + i);
    const int lo = lower_pos(s_pos, 0, m, p);
    const int hi = upper_pos_from(s_pos, lo, m, p);
    int r = hi;
    l = lo;
    while (l < r) {
      const int mid = l + ((r - l) >> 1);
      if (__ldg(s_hm + mid) < h) l = mid + 1; else r = mid;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (k < hi - l) {
        const int j = l + k;
        const bool same = (__ldg(s_hm + j) == h) & (__ldg(s_chrom + j) == c) &
                          (__ldg(s_rl + j) == q_rl) & (__ldg(s_al + j) == q_al);
        pend |= static_cast<unsigned>(same) << k;
      }
    }
  }
  // the warp confirms the pending candidates' allele bytes, kGroups a round
  const uintptr_t a_sref = reinterpret_cast<uintptr_t>(s_ref);
  const uintptr_t a_salt = reinterpret_cast<uintptr_t>(s_alt);
  const uintptr_t a_ref = reinterpret_cast<uintptr_t>(ref);
  const uintptr_t a_alt = reinterpret_cast<uintptr_t>(alt);
  const size_t m_bytes = static_cast<size_t>(m) * w;
  const size_t n_bytes = static_cast<size_t>(n) * w;
  const int sub = lane % kGroup;
  const int grp = lane / kGroup;
  const unsigned below = (1u << lane) - 1;
  int32_t at = -1;
  unsigned waiting = __ballot_sync(kAll, pend != 0);
  while (waiting != 0) {
    // group grp serves the grp-th waiting lane's lowest candidate
    unsigned rest = waiting;
    for (int g = 0; g < grp; ++g) rest &= rest - 1;
    const int owner = rest != 0 ? __ffs(static_cast<int>(rest)) - 1 : lane;
    const int qi = __shfl_sync(kAll, i, owner);
    const int sj = __shfl_sync(kAll, l + __ffs(static_cast<int>(pend)) - 1, owner);
    uint64_t diff = 0;
    if (rest != 0) {
      const size_t qrow = static_cast<size_t>(qi) * w;
      const size_t srow = static_cast<size_t>(sj) * w;
      diff = row_diff(a_sref + srow, a_sref, a_sref + m_bytes, a_ref + qrow,
                      a_ref, a_ref + n_bytes, w, sub) |
             row_diff(a_salt + srow, a_salt, a_salt + m_bytes, a_alt + qrow,
                      a_alt, a_alt + n_bytes, w, sub);
    }
    const unsigned bad = __ballot_sync(kAll, diff != 0);
    if (pend != 0) {
      const int rank = __popc(waiting & below);
      if (rank < kGroups) {
        if (((bad >> (rank * kGroup)) & kGroupMask) == 0) {
          at = l + __ffs(static_cast<int>(pend)) - 1;
          pend = 0;
        } else {
          pend &= pend - 1;
        }
      }
    }
    waiting = __ballot_sync(kAll, pend != 0);
  }
  if (i < n) {
    found[i] = at >= 0;
    index[i] = at;
  }
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
