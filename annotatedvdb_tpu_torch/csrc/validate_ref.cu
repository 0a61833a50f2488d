// Reference-genome validation kernel for Hopper (sm_90a): each row's ref
// allele against the 2-bit packed genome.
//
// Replaces annotatedvdb_tpu/genome/refgenome.py::validate_ref_kernel (an
// XLA program, not a Pallas kernel; jitted in validate_ref_batch).  A row
// passes when its chromosome is in the genome (lengths[chrom] > 0, a code
// outside [0, 26) counting as absent), ref_len <= W, and every one of its
// first ref_len bytes, uppercased (bytes 97-122 only), equals the genome
// base at pos - 1 + k — or is 'N' where the ambiguity mask is set — with
// 0 <= pos - 1 + k < lengths[chrom].  Bytes past ref_len are never
// compared, so a row with ref_len <= 0 passes on any chromosome of the
// genome, and pos - 1 < 0 fails a row only through a column inside the
// allele.  Output: one byte a row (torch.bool).
//
// Layout: packed holds 4 bases a byte (base j at bit 2*(j%4)), n_mask 1
// bit a base (bit j%8); byte_off/mask_off give each chromosome's first
// byte.  Offsets fit int32 for GRCh38 (~775M packed bytes plus a
// chromosome's 62M); positions are widened to 64 bits so that pos near
// INT32_MAX cannot wrap.
//
// Bound: memory.  A row reads chrom, pos, ref_len (9 bytes) and its
// ref_len ref bytes, about ref_len/4 + 1 packed bytes and ref_len/8 + 1
// mask bytes, and writes one byte.  The arithmetic is a few integer
// operations per base.  The packed reads are gathers at data-dependent
// addresses into a table of ~1.16 GB, with a width that depends on the
// row, which is why this is CUDA C++ and not a fused elementwise Triton
// pass.  At the load's chunk (65,536 rows) the bytes take a fraction of a
// microsecond, so what the card can approach is the launch and two rounds
// of loads: the rows' own columns, then everything under their bases.
//
// What held the first design back (one thread per row, every load a
// byte): each row was a chain of dependent loads — chrom, then the
// chromosome's length and offsets, then for every base a ref byte, a mask
// byte and a packed byte, each issued after the previous compare, up to
// 147 loads in a chain for a 49-base ref.  A warp's time is its longest
// row, and one row in ten is 7-49 bases long, so nearly every warp waited
// on such a chain.
//
// Design: one thread per row, 256 rows a block, and no load that waits on
// a compare.
// - The three 26-entry chromosome tables sit in shared memory, loaded
//   once a block beside the rows' chrom, pos and ref_len.
// - For up to 64 bases at a time, a row then issues every load it needs
//   at once: its ref bytes as aligned 8-byte words (at most 9), and the
//   genome as aligned 8-byte words (at most 3 packed, 2 mask) — one round
//   of loads instead of a chain.  Words that would reach past either end of
//   the ref, packed or mask array (the chromosome stored last, a view
//   that starts unaligned) are read byte by byte inside it, so nothing
//   outside the tensors is touched whatever is passed.
// - Funnel shifts line bases up in registers, and the compare takes four
//   bases a step with byte-wise SIMD: the ref bytes uppercased
//   (__vcmpgeu4/__vcmpleu4), the expected bytes decoded from four 2-bit
//   codes by one __byte_perm of "ACGT", 'N' where the mask bits are set,
//   and the xor masked to the allele's length.  No per-base branch.
// - Rows that cannot reach the genome (ref_len <= 0 or > W, an absent
//   code, a span outside the chromosome) load nothing more.
//
// A shared-memory tile of the block's ref rows (coalesced 16-byte copies,
// then per-base reads) measured slower than these per-row word loads on
// the card: its copy and barriers cost more than the sectors it saves.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 256;      // rows (threads) a block
constexpr int kSpan = 64;       // bases compared a pass
constexpr int kRefWords = 9;    // 8-byte words under 64 unaligned bytes
constexpr int kCodes = 26;
constexpr uint32_t kAcgt = 0x54474341u;  // "ACGT": code c at byte c
constexpr uint32_t kNNNN = 0x4e4e4e4eu;  // "NNNN"

// The 8-byte word at the 8-aligned address `a`, its bytes outside [lo, hi)
// read as 0 (and not read).
__device__ __forceinline__ uint64_t word_at(uintptr_t a, uintptr_t lo,
                                            uintptr_t hi) {
  if (a >= lo && a + 8 <= hi) {
    return __ldg(reinterpret_cast<const unsigned long long*>(a));
  }
  uint64_t v = 0;
#pragma unroll
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

// Four bases' expected bytes: "ACGT"[code] from the four 2-bit codes in
// the low byte of `codes`, 'N' where the low four bits of `amb` are set.
__device__ __forceinline__ uint32_t expected4(uint32_t codes, uint32_t amb) {
  const uint32_t sel = (codes & 0x3u) | ((codes & 0xcu) << 2) |
                       ((codes & 0x30u) << 4) | ((codes & 0xc0u) << 6);
  const uint32_t bases = __byte_perm(kAcgt, 0, sel);
  // bit b of amb to 0xff in byte b
  const uint32_t n = (((amb & 0xfu) * 0x00204081u) & 0x01010101u) * 0xffu;
  return (bases & ~n) | (kNNNN & n);
}

// Four ref bytes with 'a'-'z' (bytes 97-122) made uppercase.
__device__ __forceinline__ uint32_t upper4(uint32_t x) {
  const uint32_t lower = __vcmpgeu4(x, 0x61616161u) & __vcmpleu4(x, 0x7a7a7a7au);
  return x - (lower & 0x20202020u);
}

__global__ void __launch_bounds__(kRows)
validate_ref_kernel(const uint8_t* __restrict__ packed, long long packed_size,
                    const uint8_t* __restrict__ n_mask, long long mask_size,
                    const int32_t* __restrict__ byte_off,
                    const int32_t* __restrict__ mask_off,
                    const int32_t* __restrict__ lengths,
                    const int8_t* __restrict__ chrom,
                    const int32_t* __restrict__ pos,
                    const uint8_t* __restrict__ ref,
                    const int32_t* __restrict__ ref_len, int n, int w,
                    uint8_t* __restrict__ ok) {
  __shared__ int32_t s_len[kCodes], s_boff[kCodes], s_moff[kCodes];
  const int t = threadIdx.x;
  if (t < kCodes) {
    s_len[t] = __ldg(lengths + t);
    s_boff[t] = __ldg(byte_off + t);
    s_moff[t] = __ldg(mask_off + t);
  }
  const long long i = static_cast<long long>(blockIdx.x) * kRows + t;
  const bool live = i < n;
  int c = -1;
  int rl = 0;
  long long start = 0;
  if (live) {
    c = __ldg(chrom + i);
    rl = __ldg(ref_len + i);
    start = static_cast<long long>(__ldg(pos + i)) - 1;
  }
  __syncthreads();  // the tables
  if (!live) return;
  const long long length = (c >= 0 && c < kCodes) ? s_len[c] : 0;
  bool pass = length > 0 && rl <= w;
  if (pass && rl > 0) {
    if (start < 0 || start + rl > length) {
      pass = false;  // a column inside the allele falls outside the chromosome
    } else {
      const uintptr_t pk_lo = reinterpret_cast<uintptr_t>(packed);
      const uintptr_t pk_hi = pk_lo + static_cast<uintptr_t>(packed_size);
      const uintptr_t mk_lo = reinterpret_cast<uintptr_t>(n_mask);
      const uintptr_t mk_hi = mk_lo + static_cast<uintptr_t>(mask_size);
      const uintptr_t rf_lo = reinterpret_cast<uintptr_t>(ref);
      const uintptr_t rf_hi =
          rf_lo + static_cast<uintptr_t>(n) * static_cast<uintptr_t>(w);
      const long long boff = s_boff[c];
      const long long moff = s_moff[c];
      for (int c0 = 0; c0 < rl && pass; c0 += kSpan) {
        const int nb = min(rl - c0, kSpan);
        const long long j0 = start + c0;
        const long long j1 = j0 + nb - 1;
        // every word under bases [c0, c0 + nb), issued together
        const uintptr_t ra = rf_lo + static_cast<uintptr_t>(i * w + c0);
        const uintptr_t rz = ra + nb - 1;
        const uintptr_t rw = ra & ~uintptr_t{7};
        uint64_t rword[kRefWords];
#pragma unroll
        for (int q = 0; q < kRefWords; ++q) {
          rword[q] = rw + 8 * q <= rz ? word_at(rw + 8 * q, rf_lo, rf_hi) : 0;
        }
        const uintptr_t pa = pk_lo + static_cast<uintptr_t>(boff + (j0 >> 2));
        const uintptr_t pz = pk_lo + static_cast<uintptr_t>(boff + (j1 >> 2));
        const uintptr_t pw = pa & ~uintptr_t{7};
        const uint64_t pw0 = word_at(pw, pk_lo, pk_hi);
        const uint64_t pw1 = pz >= pw + 8 ? word_at(pw + 8, pk_lo, pk_hi) : 0;
        const uint64_t pw2 = pz >= pw + 16 ? word_at(pw + 16, pk_lo, pk_hi) : 0;
        const uintptr_t ma = mk_lo + static_cast<uintptr_t>(moff + (j0 >> 3));
        const uintptr_t mz = mk_lo + static_cast<uintptr_t>(moff + (j1 >> 3));
        const uintptr_t mw = ma & ~uintptr_t{7};
        const uint64_t mw0 = word_at(mw, mk_lo, mk_hi);
        const uint64_t mw1 = mz >= mw + 8 ? word_at(mw + 8, mk_lo, mk_hi) : 0;

        // base k: 2-bit code at bit 2k of codes[k / 32], mask bit k of amb,
        // ref byte k % 8 of funnel(rword[k / 8], rword[k / 8 + 1], rsh)
        const int rsh = static_cast<int>(ra - rw) * 8;
        const int psh = static_cast<int>(pa - pw) * 8 + static_cast<int>(j0 & 3) * 2;
        const int msh = static_cast<int>(ma - mw) * 8 + static_cast<int>(j0 & 7);
        const uint64_t codes[2] = {funnel(pw0, pw1, psh), funnel(pw1, pw2, psh)};
        const uint64_t amb = funnel(mw0, mw1, msh);
        uint32_t diff = 0;
#pragma unroll
        for (int g = 0; g < kSpan / 4; ++g) {  // bases 4g .. 4g + 3
          if (4 * g >= nb) break;
          const uint64_t r8 = funnel(rword[g / 2], rword[g / 2 + 1], rsh);
          const uint32_t r4 = static_cast<uint32_t>(r8 >> (32 * (g & 1)));
          const uint32_t want = expected4(
              static_cast<uint32_t>(codes[g / 8] >> (8 * (g % 8))),
              static_cast<uint32_t>(amb >> (4 * g)));
          const int left = nb - 4 * g;  // bases of this step in the allele
          const uint32_t in = left >= 4 ? 0xffffffffu : (1u << (8 * left)) - 1u;
          diff |= (upper4(r4) ^ want) & in;
        }
        pass = diff == 0;
      }
    }
  }
  ok[i] = pass ? 1 : 0;
}

}  // namespace

// Launches on `stream`; returns a cudaError_t (0 = ok).  `packed_size` and
// `mask_size` are the two genome arrays' lengths in bytes; `ok` is one
// byte a row (torch.bool).
extern "C" int validate_ref_launch(const void* packed, long long packed_size,
                                   const void* n_mask, long long mask_size,
                                   const void* byte_off, const void* mask_off,
                                   const void* lengths, const void* chrom,
                                   const void* pos, const void* ref,
                                   const void* ref_len, int n, int w, void* ok,
                                   void* stream) {
  if (n < 0 || w < 1 || packed_size < 0 || mask_size < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  const int grid = (n + kRows - 1) / kRows;
  validate_ref_kernel<<<grid, kRows, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(packed), packed_size,
      static_cast<const uint8_t*>(n_mask), mask_size,
      static_cast<const int32_t*>(byte_off),
      static_cast<const int32_t*>(mask_off),
      static_cast<const int32_t*>(lengths), static_cast<const int8_t*>(chrom),
      static_cast<const int32_t*>(pos), static_cast<const uint8_t*>(ref),
      static_cast<const int32_t*>(ref_len), n, w, static_cast<uint8_t*>(ok));
  return static_cast<int>(cudaGetLastError());
}
