// Corpus pack kernel for Hopper (sm_90a): the bin token, the validity mask
// and the padded-lane masking of a stack of fixed-shape export batches.
//
// Replaces annotatedvdb_tpu/ops/export_pack.py::export_pack_kernel (an XLA
// program, not a Pallas kernel), for `nb` batches in one launch.  Input:
// `cols` [nb, 7, B] int32, each batch's rows pos, end, ref_code, alt_code,
// af_fp, cadd_fp, rank_i; `n_valid` [nb] int32, each batch's real rows,
// already clamped into [0, B] by the wrapper (so `i < n_valid[k]` is
// `arange(B) < n_valid` for any int32 n_valid).  Output: one byte buffer
// `out` of nb blocks of 30 B bytes, batch k at byte 30 B k, so a part comes
// back in one copy and each block is the one-batch layout: [7, B] int32
// (leaf_bin, pos, ref_code, alt_code, af_fp, cadd_fp, rank_i), then the
// mask [B] (0/1 bytes), then bin_level [B] int8.  Every lane at or past its
// batch's n_valid is -1, mask 0.
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
// does a few dozen integer operations.  At the export's part (37 batches of
// 4,096 rows) that is 37 x 4,096 x 58 = 8,790,016 bytes, 0.002624 ms at
// 3.35 TB/s; one 4,096-row batch is 237,568 bytes, 0.000071 ms, less than a
// launch costs.
//
// What held the first design back: one launch a batch (16 blocks of 256
// threads at B = 4,096), each with its own upload and copy back, so the
// launch and the round trip, not the bytes, set the time.  Design: the
// wrapper stacks a whole part and launches once.  The pass touches each
// byte once and reuses nothing, so TMA or a shared-memory staging ring buys
// nothing here: the card's memory path is the limit, and what it wants is
// wide, coalesced requests and enough of them in flight.  Each thread takes
// four consecutive rows of one batch (a group; batch = group / groups a
// batch), loads each of the 7 columns with one 16-byte load, stores each of
// the 7 output columns with one 16-byte store and the four rows' mask and
// level bytes as one 4-byte word each; a warp's requests are contiguous.
// Blocks are at most 128 threads (on the card a part packed faster than
// with 256, PERF.md), fewer for a small launch (one 4,096-row batch: 1,024
// groups, 32 blocks of one warp) so that it still reaches as many SMs as it
// can; the grid is at most what the SMs hold at once and strides over the
// groups.  At one batch this kernel is slower than the first design (a
// thread's four rows make a longer chain where few warps run): the stream
// pays that, the export's part does not.  A group whose columns or output block are not
// 16-byte aligned (B not a multiple of 4, a view at an odd offset, every
// other batch when B is 4 mod 8) takes the row-by-row index path: the same
// arithmetic with 4-byte loads, and 2-byte and 1-byte stores (with B odd,
// every other batch's int32 block is only 2-byte aligned).

#include <algorithm>
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int32_t kLeafSize = 15625;
constexpr int kLevels = 13;
constexpr int kCols = 7;
constexpr int kRowBytes = 4 * kCols + 2;

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

__device__ __forceinline__ int32_t& lane_of(int4& v, int r) {
  return reinterpret_cast<int32_t*>(&v)[r];
}

// Stores v at p in two 16-bit halves: batch k's int32 block starts at
// byte 30 B k, which is only 2-byte aligned when B is odd.
__device__ __forceinline__ void store32(uint8_t* p, int32_t v) {
  const uint32_t u = static_cast<uint32_t>(v);
  reinterpret_cast<uint16_t*>(p)[0] = static_cast<uint16_t>(u);
  reinterpret_cast<uint16_t*>(p)[1] = static_cast<uint16_t>(u >> 16);
}

// One row, 2-byte and 1-byte stores (the index path); `out32` is the
// batch's int32 block.
__device__ __forceinline__ void pack_row(const int32_t* __restrict__ in,
                                         int b, int i, bool valid,
                                         uint8_t* __restrict__ out32,
                                         uint8_t* __restrict__ mask,
                                         int8_t* __restrict__ level) {
  if (valid) {
    const int32_t pos = __ldg(in + i);
    const int32_t a = floor_div(minus_one(pos), kLeafSize);
    const int32_t e = floor_div(minus_one(__ldg(in + b + i)), kLeafSize);
    store32(out32 + 4 * i, a);
    store32(out32 + 4 * (b + i), pos);
#pragma unroll
    for (int c = 2; c < kCols; ++c) {
      store32(out32 + 4 * (c * b + i), __ldg(in + c * b + i));
    }
    mask[i] = 1;
    level[i] = static_cast<int8_t>(level_of(a, e));
  } else {
#pragma unroll
    for (int c = 0; c < kCols; ++c) store32(out32 + 4 * (c * b + i), -1);
    mask[i] = 0;
    level[i] = -1;
  }
}

__global__ void __launch_bounds__(kThreads)
export_pack_kernel(const int32_t* __restrict__ cols,
                   const int32_t* __restrict__ n_valid, int nb, int b,
                   uint8_t* __restrict__ out) {
  const int per_batch = (b + 3) >> 2;  // four-row groups a batch
  const int groups = nb * per_batch;
  for (int g = blockIdx.x * blockDim.x + threadIdx.x; g < groups;
       g += gridDim.x * blockDim.x) {
    const int k = g / per_batch;
    const int i0 = (g - k * per_batch) << 2;
    const int n = __ldg(n_valid + k);
    const int32_t* in = cols + static_cast<size_t>(k) * kCols * b;
    uint8_t* base = out + static_cast<size_t>(k) * kRowBytes * b;
    uint8_t* mask = base + static_cast<size_t>(4) * kCols * b;
    int8_t* level = reinterpret_cast<int8_t*>(mask + b);
    const uintptr_t align = reinterpret_cast<uintptr_t>(in) |
                            reinterpret_cast<uintptr_t>(base) |
                            static_cast<uintptr_t>(4 * b);
    if ((align & 15) != 0) {
      for (int r = 0; r < 4 && i0 + r < b; ++r) {
        pack_row(in, b, i0 + r, i0 + r < n, base, mask, level);
      }
      continue;
    }
    const int stride = b >> 2;  // one column, in int4
    const int4* in4 = reinterpret_cast<const int4*>(in + i0);
    int4 v[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) v[c] = __ldg(in4 + c * stride);
    int4 o[kCols];
    uint32_t mword = 0, lword = 0;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const bool valid = i0 + r < n;
      const int32_t pos = lane_of(v[0], r);
      const int32_t a = floor_div(minus_one(pos), kLeafSize);
      const int32_t e = floor_div(minus_one(lane_of(v[1], r)), kLeafSize);
      lane_of(o[0], r) = valid ? a : -1;
      lane_of(o[1], r) = valid ? pos : -1;
#pragma unroll
      for (int c = 2; c < kCols; ++c) lane_of(o[c], r) = valid ? lane_of(v[c], r) : -1;
      mword |= (valid ? 1u : 0u) << (8 * r);
      lword |= (valid ? static_cast<uint32_t>(level_of(a, e)) : 0xffu) << (8 * r);
    }
    int4* o4 = reinterpret_cast<int4*>(base) + (i0 >> 2);
#pragma unroll
    for (int c = 0; c < kCols; ++c) o4[c * stride] = o[c];
    *reinterpret_cast<uint32_t*>(mask + i0) = mword;
    *reinterpret_cast<uint32_t*>(level + i0) = lword;
  }
}

}  // namespace

// Packs `nb` batches of `b` rows on `stream`; returns a cudaError_t (0 =
// queued).  `n_valid` is a device array of nb counts in [0, b]; `cols` and
// `n_valid` must be 4-byte aligned (int32 tensors are) and `out` 2-byte
// aligned (the wrapper allocates it).
extern "C" int export_pack_launch(const int32_t* cols, const int32_t* n_valid,
                                  int nb, int b, uint8_t* out,
                                  cudaStream_t stream) {
  if (nb < 0 || b < 0 ||
      static_cast<long long>(nb) * b * kRowBytes > INT_MAX ||
      (reinterpret_cast<uintptr_t>(cols) & 3) != 0 ||
      (reinterpret_cast<uintptr_t>(n_valid) & 3) != 0 ||
      (reinterpret_cast<uintptr_t>(out) & 1) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (nb == 0 || b == 0) return 0;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  // threads a block: as many as spread the four-row groups over every SM,
  // from one warp up to kThreads; the grid holds what the SMs hold at once
  const int groups = nb * ((b + 3) / 4);
  const int per_block = (groups + sms - 1) / std::max(1, sms);
  const int threads = std::min(kThreads, std::max(32, (per_block + 31) / 32 * 32));
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, export_pack_kernel, threads, 0);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = std::min((groups + threads - 1) / threads,
                              std::max(1, sms * per_sm));
  export_pack_kernel<<<blocks, threads, 0, stream>>>(cols, n_valid, nb, b, out);
  return static_cast<int>(cudaGetLastError());
}
