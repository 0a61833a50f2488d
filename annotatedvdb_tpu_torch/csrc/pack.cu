// Packed transport kernels for Hopper (sm_90a): the nibble inflate of the
// uploaded allele matrices and the one-buffer packs of the loaders' per-row
// outputs.
//
// Replaces three XLA programs of annotatedvdb_tpu/ops/pack.py (no Pallas
// kernel): `inflate_alleles` (:124), `pack_outputs` (:32) and
// `pack_vep_outputs` (:214).  Three entry points, three kernels:
//
// - inflate: `ref_packed` and `alt_packed` [n, cols] uint8, two 4-bit codes
//   a byte (low nibble first), decode into `ref` and `alt` [n, width] uint8.
//   Packed byte j of a row holds columns 2j and 2j + 1; a column at or past
//   `width` is dropped (the last high nibble for odd widths, and any packed
//   byte past ceil(width / 2)).  The decode table is the reference's `_DEC`:
//   code 0 -> 0, codes 1-13 -> "ACGTNacgtn*.-", codes 14 and 15 -> 0.  The
//   encoder never writes 14 or 15, but the function is defined on them.
//   The table is two 64-bit constants indexed by shift, so it costs no
//   memory access.  Both matrices go through one launch: a thread decodes
//   the same packed byte of each.
// - pack_outputs: one [n, 10] uint8 row a variant, little-endian: the hash
//   (4 bytes), leaf_bin (int32, 4 bytes), bin_level truncated to its low
//   byte, and a flag byte dup | needs_digest << 1 | host_fallback << 2 (the
//   flags are bytes; OR and left shifts commute with truncation to 8 bits,
//   so this is the reference's uint8 arithmetic).  A null `dup` is zero.
// - pack_vep_outputs: one [n, 6] uint8 row: the hash, prefix_len truncated
//   to its low byte, host_fallback.
//
// bin_level and prefix_len come as 1-byte or 4-byte integers
// (`level_bytes`): the low byte of a little-endian int32 is its truncation
// to uint8, so the kernel reads that byte either way.  Rows are written with
// byte stores: a row starts at 10 i (or 6 i), 2-byte aligned at best, and
// the wrapper may hand an output at any address.
//
// Bound: memory.  The inflate at the load's chunk (65,536 rows, W = 49)
// reads 2 x 65,536 x 25 bytes and writes 2 x 65,536 x 49: 9,699,328 bytes,
// 0.0029 ms at 3.35 TB/s.  The pack at that chunk reads 4 + 4 + 1 + 3 and
// writes 10 bytes a row (1.4 MB, 0.0004 ms): less than an empty launch
// takes, so it is launch-bound.  Design: grid-stride loops over rows (the
// packs) or packed bytes (the inflate), a warp on consecutive addresses, the
// grid at most what the SMs hold at once.  No shared memory, no TMA: each
// byte is touched once.

#include <algorithm>
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
// codes 0-7 and 8-15, one byte a code at shift 8 (code & 7)
constexpr uint64_t kDecLo = 0x63614E5447434100ull;  // 0 A C G T N a c
constexpr uint64_t kDecHi = 0x00002D2E2A6E7467ull;  // g t n * . - 0 0

__device__ __forceinline__ uint8_t decode(uint32_t code) {
  const uint64_t table = code < 8 ? kDecLo : kDecHi;
  return static_cast<uint8_t>(table >> (8 * (code & 7)));
}

__global__ void __launch_bounds__(kThreads)
inflate_kernel(const uint8_t* __restrict__ ref_packed,
               const uint8_t* __restrict__ alt_packed, int n, int cols,
               int width, uint8_t* __restrict__ ref, uint8_t* __restrict__ alt) {
  // packed bytes a row that hold a column below the width
  const int used = min(cols, (width + 1) / 2);
  const int total = n * used;
  for (int t = blockIdx.x * blockDim.x + threadIdx.x; t < total;
       t += gridDim.x * blockDim.x) {
    const int i = t / used;
    const int j = t - i * used;
    const size_t in = static_cast<size_t>(i) * cols + j;
    const uint32_t r = __ldg(ref_packed + in);
    const uint32_t a = __ldg(alt_packed + in);
    const size_t out = static_cast<size_t>(i) * width + 2 * j;
    ref[out] = decode(r & 15u);
    alt[out] = decode(a & 15u);
    if (2 * j + 1 < width) {
      ref[out + 1] = decode(r >> 4);
      alt[out + 1] = decode(a >> 4);
    }
  }
}

__device__ __forceinline__ void put32(uint8_t* p, uint32_t v) {
  p[0] = static_cast<uint8_t>(v);
  p[1] = static_cast<uint8_t>(v >> 8);
  p[2] = static_cast<uint8_t>(v >> 16);
  p[3] = static_cast<uint8_t>(v >> 24);
}

__global__ void __launch_bounds__(kThreads)
pack_outputs_kernel(const uint32_t* __restrict__ h,
                    const uint8_t* __restrict__ dup,
                    const uint8_t* __restrict__ level, int level_bytes,
                    const uint32_t* __restrict__ leaf,
                    const uint8_t* __restrict__ needs_digest,
                    const uint8_t* __restrict__ host_fallback, int n,
                    uint8_t* __restrict__ out) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    uint8_t* row = out + static_cast<size_t>(i) * 10;
    put32(row, __ldg(h + i));
    put32(row + 4, __ldg(leaf + i));
    row[8] = __ldg(level + static_cast<size_t>(i) * level_bytes);
    const uint32_t d = dup != nullptr ? __ldg(dup + i) : 0u;
    row[9] = static_cast<uint8_t>(d | (__ldg(needs_digest + i) << 1) |
                                  (__ldg(host_fallback + i) << 2));
  }
}

__global__ void __launch_bounds__(kThreads)
pack_vep_kernel(const uint32_t* __restrict__ h,
                const uint8_t* __restrict__ prefix, int prefix_bytes,
                const uint8_t* __restrict__ host_fallback, int n,
                uint8_t* __restrict__ out) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    uint8_t* row = out + static_cast<size_t>(i) * 6;
    put32(row, __ldg(h + i));
    row[4] = __ldg(prefix + static_cast<size_t>(i) * prefix_bytes);
    row[5] = __ldg(host_fallback + i);
  }
}

// Blocks for `items` grid-stride items of `kernel`: enough to cover them,
// at most what the SMs hold at once.  0 on error (`*err` set).
template <typename K>
int grid_for(K kernel, int items, cudaError_t* err) {
  int dev = 0, sms = 0, per_sm = 0;
  *err = cudaGetDevice(&dev);
  if (*err == cudaSuccess) {
    *err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (*err == cudaSuccess) {
    *err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                         kThreads, 0);
  }
  if (*err != cudaSuccess) return 0;
  return std::min((items + kThreads - 1) / kThreads, std::max(1, sms * per_sm));
}

bool aligned4(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 3) == 0;
}

}  // namespace

// Inflates both packed matrices on `stream`; returns a cudaError_t (0 =
// queued).  Needs 2 cols >= width (every column has a nibble) and n x cols,
// n x width within int.
extern "C" int inflate_alleles_launch(const uint8_t* ref_packed,
                                      const uint8_t* alt_packed, int n,
                                      int cols, int width, uint8_t* ref,
                                      uint8_t* alt, cudaStream_t stream) {
  if (n < 0 || cols < 0 || width < 0 || 2LL * cols < width ||
      static_cast<long long>(n) * std::max(cols, width) > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0 || width == 0) return 0;
  cudaError_t err;
  const int blocks = grid_for(inflate_kernel, n * std::min(cols, (width + 1) / 2), &err);
  if (err != cudaSuccess) return static_cast<int>(err);
  inflate_kernel<<<blocks, kThreads, 0, stream>>>(ref_packed, alt_packed, n, cols,
                                                  width, ref, alt);
  return static_cast<int>(cudaGetLastError());
}

// Packs n rows of 10 bytes on `stream`.  `h` and `leaf` are 4-byte words
// (4-byte aligned), `level` 1- or 4-byte integers (`level_bytes`, 4-byte
// aligned when 4), the flags bytes; `dup` may be null (zero).
extern "C" int pack_outputs_launch(const void* h, const void* dup,
                                   const void* level, int level_bytes,
                                   const void* leaf, const void* needs_digest,
                                   const void* host_fallback, int n, void* out,
                                   cudaStream_t stream) {
  if (n < 0 || static_cast<long long>(n) * 10 > INT_MAX ||
      (level_bytes != 1 && level_bytes != 4) || !aligned4(h) || !aligned4(leaf) ||
      (level_bytes == 4 && !aligned4(level))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  cudaError_t err;
  const int blocks = grid_for(pack_outputs_kernel, n, &err);
  if (err != cudaSuccess) return static_cast<int>(err);
  pack_outputs_kernel<<<blocks, kThreads, 0, stream>>>(
      static_cast<const uint32_t*>(h), static_cast<const uint8_t*>(dup),
      static_cast<const uint8_t*>(level), level_bytes,
      static_cast<const uint32_t*>(leaf), static_cast<const uint8_t*>(needs_digest),
      static_cast<const uint8_t*>(host_fallback), n, static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

// Packs n rows of 6 bytes on `stream`; `prefix` as `level` above.
extern "C" int pack_vep_outputs_launch(const void* h, const void* prefix,
                                       int prefix_bytes, const void* host_fallback,
                                       int n, void* out, cudaStream_t stream) {
  if (n < 0 || static_cast<long long>(n) * 6 > INT_MAX ||
      (prefix_bytes != 1 && prefix_bytes != 4) || !aligned4(h) ||
      (prefix_bytes == 4 && !aligned4(prefix))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  cudaError_t err;
  const int blocks = grid_for(pack_vep_kernel, n, &err);
  if (err != cudaSuccess) return static_cast<int>(err);
  pack_vep_kernel<<<blocks, kThreads, 0, stream>>>(
      static_cast<const uint32_t*>(h), static_cast<const uint8_t*>(prefix),
      prefix_bytes, static_cast<const uint8_t*>(host_fallback), n,
      static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
