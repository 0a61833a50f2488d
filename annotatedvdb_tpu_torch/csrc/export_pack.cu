// Corpus batch pack kernel for Hopper (sm_90a): the bin token, the validity
// mask and the padded-lane masking of one fixed-shape export batch.
//
// Replaces annotatedvdb_tpu/ops/export_pack.py::export_pack_kernel (an XLA
// program, not a Pallas kernel).  Input: `cols` [7, B] int32, rows pos, end,
// ref_code, alt_code, af_fp, cadd_fp, rank_i; `n_valid` the real rows, already
// clamped into [0, B] by the wrapper (so `i < n_valid` is `arange(B) <
// n_valid` for any int32 n_valid).  Output: one byte buffer `out` of 30 B
// bytes, so a batch comes back in one copy: [7, B] int32 (leaf_bin, pos,
// ref_code, alt_code, af_fp, cadd_fp, rank_i), then the mask [B] (0/1 bytes),
// then bin_level [B] int8.  Every lane at or past n_valid is -1, mask 0.
//
// The arithmetic is the JAX function's on every int32 input, not only on the
// positions callers give:
// - pos - 1 wraps at INT32_MIN in JAX: computed in uint32, then read back as
//   int32, so no signed overflow;
// - // floors in JAX and / truncates in C++: floor_div corrects the quotient
//   when the remainder is nonzero and the dividend negative;
// - the level counts s in 0..12 with (x >> s) != 0 for x = a ^ b.  For x < 0
//   an arithmetic shift never reaches 0, so the count is 13 (level 0); for
//   x >= 0, (x >> s) != 0 exactly when s < bit length of x, so the count is
//   min(13, 32 - __clz(x)) (0 for x = 0, level 13).
//
// Bound: memory.  A row reads 28 bytes and writes 30, 58 bytes in all, and
// does a few dozen integer operations; at the export's B = 4,096 that is
// 237,568 bytes, 0.07 us at 3.35 TB/s, so one launch costs more than the
// work.  Design: one thread per row, grid-stride, 256 a block; each field's
// loads and stores are coalesced across a warp (the [7, B] layouts keep a
// field's rows contiguous).  Nothing else is needed for a kernel this small.

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 8;
constexpr int32_t kLeafSize = 15625;
constexpr int kLevels = 13;
constexpr int kCols = 7;

__device__ __forceinline__ int32_t minus_one(int32_t v) {
  return static_cast<int32_t>(static_cast<uint32_t>(v) - 1u);
}

__device__ __forceinline__ int32_t floor_div(int32_t a, int32_t b) {
  const int32_t q = a / b;  // b > 0 here, so a / b never overflows
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

__device__ __forceinline__ int level_of(int32_t a, int32_t b) {
  const int32_t x = a ^ b;
  const int bits = x < 0 ? kLevels : min(kLevels, 32 - __clz(x));
  return kLevels - bits;
}

__global__ void __launch_bounds__(kThreads)
export_pack_kernel(const int32_t* __restrict__ cols, int b, int n_valid,
                   int32_t* __restrict__ out32, uint8_t* __restrict__ mask,
                   int8_t* __restrict__ level) {
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < b;
       i += gridDim.x * kThreads) {
    if (i < n_valid) {
      const int32_t pos = __ldg(cols + i);
      const int32_t end = __ldg(cols + b + i);
      const int32_t a = floor_div(minus_one(pos), kLeafSize);
      const int32_t e = floor_div(minus_one(end), kLeafSize);
      out32[i] = a;
      out32[b + i] = pos;
#pragma unroll
      for (int c = 2; c < kCols; ++c) out32[c * b + i] = __ldg(cols + c * b + i);
      mask[i] = 1;
      level[i] = static_cast<int8_t>(level_of(a, e));
    } else {
#pragma unroll
      for (int c = 0; c < kCols; ++c) out32[c * b + i] = -1;
      mask[i] = 0;
      level[i] = -1;
    }
  }
}

}  // namespace

extern "C" int export_pack_launch(const int32_t* cols, int b, int n_valid,
                                  uint8_t* out, cudaStream_t stream) {
  if (b <= 0) return 0;
  const int blocks = std::min((b + kThreads - 1) / kThreads, kMaxBlocks);
  int32_t* out32 = reinterpret_cast<int32_t*>(out);
  uint8_t* mask = out + static_cast<size_t>(4) * kCols * b;
  int8_t* level = reinterpret_cast<int8_t*>(mask + b);
  export_pack_kernel<<<blocks, kThreads, 0, stream>>>(cols, b, n_valid, out32,
                                                      mask, level);
  return static_cast<int>(cudaGetLastError());
}
