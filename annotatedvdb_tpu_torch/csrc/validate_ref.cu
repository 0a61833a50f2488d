// Reference-genome validation kernel for Hopper (sm_90a): each row's ref
// allele against the 2-bit packed genome.
//
// Replaces annotatedvdb_tpu/genome/refgenome.py::validate_ref_kernel (an
// XLA program, not a Pallas kernel; jitted in validate_ref_batch).  A row
// passes when its chromosome is in the genome (lengths[chrom] > 0, a code
// outside [0, 26) counting as absent), ref_len <= W, and every one of its
// first ref_len bytes, uppercased (bytes 97-122 only), equals the genome
// base at pos - 1 + k — or is 'N' where the ambiguity mask is set — with
// 0 <= pos - 1 + k < lengths[chrom].  Bytes past ref_len are never read,
// so a row with ref_len <= 0 passes on any chromosome of the genome, and
// pos - 1 < 0 fails a row only through a column inside the allele.
// Output: one byte a row (torch.bool).
//
// Layout: packed holds 4 bases a byte (base j at bit 2*(j%4)), n_mask 1
// bit a base (bit j%8); byte_off/mask_off give each chromosome's first
// byte.  Offsets fit int32 for GRCh38 (~775M packed bytes plus a
// chromosome's 62M), so the byte index is computed in 64 bits only to
// keep pos near INT32_MAX from wrapping.
//
// Bound: memory.  A row reads chrom, pos, ref_len (9 bytes) and its
// ref_len ref bytes, about ref_len/4 + 1 packed bytes and ref_len/8 + 1
// mask bytes, and writes one byte.  The arithmetic is a few integer
// operations per base.  The packed reads are gathers at data-dependent
// addresses into a table of ~1.16 GB, with a trip count that depends on
// the row and an early exit at the first mismatch, which is why this is
// CUDA C++ and not a fused elementwise Triton pass.
//
// Design: one thread per row, 256 threads a block.  Rows at nearby
// positions (a position-sorted chunk) read neighbouring genome bytes, so
// the gathers of a warp mostly land in a few sectors and stay in L2.  The
// ref rows are W bytes and W (49 by default) is not a multiple of 4, so
// they are not word-aligned and the compare loads bytes.  A simple,
// correct kernel first; the chunk shape (65,536 rows) fills the card's
// 132 SMs with 256 blocks.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCodes = 26;

__global__ void __launch_bounds__(kThreads)
validate_ref_kernel(const uint8_t* __restrict__ packed,
                    const uint8_t* __restrict__ n_mask,
                    const int32_t* __restrict__ byte_off,
                    const int32_t* __restrict__ mask_off,
                    const int32_t* __restrict__ lengths,
                    const int8_t* __restrict__ chrom,
                    const int32_t* __restrict__ pos,
                    const uint8_t* __restrict__ ref,
                    const int32_t* __restrict__ ref_len, int n, int w,
                    uint8_t* __restrict__ ok) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const int c = __ldg(chrom + i);
  const int64_t length = (c >= 0 && c < kCodes) ? __ldg(lengths + c) : 0;
  const int rl = __ldg(ref_len + i);
  bool pass = length > 0 && rl <= w;
  if (pass && rl > 0) {
    const int64_t start = static_cast<int64_t>(__ldg(pos + i)) - 1;
    if (start < 0 || start + rl > length) {
      pass = false;  // a column inside the allele falls outside the chromosome
    } else {
      const uint8_t* bases = packed + __ldg(byte_off + c);
      const uint8_t* mask = n_mask + __ldg(mask_off + c);
      const uint8_t* r = ref + static_cast<size_t>(i) * w;
      for (int k = 0; k < rl; ++k) {
        const int64_t j = start + k;
        unsigned u = __ldg(r + k);
        if (u >= 97u && u <= 122u) u -= 32u;
        const bool ambiguous = (__ldg(mask + (j >> 3)) >> (j & 7)) & 1u;
        unsigned want;
        if (ambiguous) {
          want = 'N';
        } else {
          const unsigned code = (__ldg(bases + (j >> 2)) >> ((j & 3) * 2)) & 3u;
          want = code == 0u ? 'A' : code == 1u ? 'C' : code == 2u ? 'G' : 'T';
        }
        if (u != want) {
          pass = false;
          break;
        }
      }
    }
  }
  ok[i] = pass ? 1 : 0;
}

}  // namespace

// Launches on `stream`; returns a cudaError_t (0 = ok).  `ok` is one byte
// a row (torch.bool).
extern "C" int validate_ref_launch(const void* packed, const void* n_mask,
                                   const void* byte_off, const void* mask_off,
                                   const void* lengths, const void* chrom,
                                   const void* pos, const void* ref,
                                   const void* ref_len, int n, int w, void* ok,
                                   void* stream) {
  if (n < 0 || w < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const int grid = (n + kThreads - 1) / kThreads;
  validate_ref_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(packed), static_cast<const uint8_t*>(n_mask),
      static_cast<const int32_t*>(byte_off),
      static_cast<const int32_t*>(mask_off),
      static_cast<const int32_t*>(lengths), static_cast<const int8_t*>(chrom),
      static_cast<const int32_t*>(pos), static_cast<const uint8_t*>(ref),
      static_cast<const int32_t*>(ref_len), n, w, static_cast<uint8_t*>(ok));
  return static_cast<int>(cudaGetLastError());
}
