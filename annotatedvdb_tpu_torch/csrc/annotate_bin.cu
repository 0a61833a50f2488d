// Fused annotate + bin-index kernel for Hopper (sm_90a).
//
// Replaces annotatedvdb_tpu/ops/annotate_pallas.py::annotate_bin_pallas
// (the Pallas TPU kernel, body `_kernel`).  Per variant it computes the
// shared-prefix length (left-normalization), the inversion test, the end
// location, the duplication-motif test (lag 0 included), the variant class,
// the closed-form bin (level, leaf), needs_digest and host_fallback — the
// semantics of ops/annotate.py::annotate_kernel followed by
// ops/binindex.py::bin_index_kernel, bit for bit on every row that is not
// host_fallback; host_fallback and needs_digest are exact on every row.
//
// Bound: memory.  Each row reads 2W + 12 bytes (two W-byte allele rows and
// three int32 scalars) and writes 33 bytes (seven int32 and five one-byte
// fields); the arithmetic is a few hundred integer operations per row at
// most, so at W = 49 the card's 3.35 TB/s, not its ALUs, is the limit.
//
// Design: one pass, every allele byte read from device memory once.  The
// TPU kernel's transposed [W, N] layout, MXU reversal matmul and O(W^2)
// static-shift scans existed only because Mosaic has no lane gathers; here
// one thread owns one variant and follows the direct algorithm.  A block's
// rows of `ref` and `alt` are contiguous ([BLOCK, W], row-major as the
// loader hands them), so the block stages them into shared memory with
// coalesced byte loads, then each thread scans its own row there: prefix
// run, reversed compare for the inversion, modular motif compare for the
// duplication.  W is a runtime argument; the wrapper refuses widths whose
// staging would exceed the default 48 KB of dynamic shared memory.
//
// Overflow: positions near INT32_MAX (pad rows carry POS_SENTINEL) make
// sums such as pos + nr overflow.  They are computed in unsigned arithmetic
// and reinterpreted, which is the two's-complement wrap jnp and torch give.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 128;
constexpr int kLeafSize = 15625;
constexpr int kLevels = 13;
constexpr int kMaxPkSequenceLength = 50;

// VariantClass codes (types.py)
constexpr int8_t kSnv = 0, kMnv = 1, kInversion = 2, kIns = 3, kDup = 4,
                 kIndel = 5, kDel = 6;

__device__ __forceinline__ int32_t wrap_add(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) +
                              static_cast<uint32_t>(b));
}

__device__ __forceinline__ int32_t floor_div(int32_t n, int32_t d) {
  int32_t q = n / d;
  return (n % d != 0 && n < 0) ? q - 1 : q;
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__global__ void __launch_bounds__(kBlock) annotate_bin_kernel(
    const int32_t* __restrict__ pos_in, const uint8_t* __restrict__ ref_in,
    const uint8_t* __restrict__ alt_in, const int32_t* __restrict__ rlen_in,
    const int32_t* __restrict__ alen_in, int n, int w,
    int32_t* __restrict__ prefix_out, int32_t* __restrict__ nr_out,
    int32_t* __restrict__ na_out, int32_t* __restrict__ end_out,
    int32_t* __restrict__ loc_start_out, int32_t* __restrict__ loc_end_out,
    int8_t* __restrict__ cls_out, uint8_t* __restrict__ dup_out,
    int8_t* __restrict__ level_out, int32_t* __restrict__ leaf_out,
    uint8_t* __restrict__ digest_out, uint8_t* __restrict__ fallback_out) {
  extern __shared__ uint8_t smem[];
  uint8_t* s_ref = smem;
  uint8_t* s_alt = smem + kBlock * w;

  const int row0 = blockIdx.x * kBlock;
  const int rows = min(kBlock, n - row0);
  const size_t base = static_cast<size_t>(row0) * w;
  const int nbytes = rows * w;
  // coalesced staging: neighbouring threads load neighbouring bytes
  for (int i = threadIdx.x; i < nbytes; i += kBlock) {
    s_ref[i] = ref_in[base + i];
    s_alt[i] = alt_in[base + i];
  }
  __syncthreads();
  if (threadIdx.x >= rows) return;

  const int row = row0 + threadIdx.x;
  const uint8_t* r = s_ref + threadIdx.x * w;
  const uint8_t* a = s_alt + threadIdx.x * w;
  const int32_t pos = pos_in[row];
  const int32_t rlen = rlen_in[row];
  const int32_t alen = alen_in[row];

  const bool snv = rlen == 1 && alen == 1;
  const bool mnv = rlen == alen && !snv;

  // ---- left-normalization: length of the shared leading run
  int32_t prefix = 0;
  if (!snv) {
    while (prefix < w && prefix < rlen && prefix < alen &&
           r[prefix] == a[prefix]) {
      ++prefix;
    }
  }
  const int32_t nr = rlen - prefix;
  const int32_t na = alen - prefix;

  // ---- inversion: ref == reverse(alt), equal lengths (alt index clipped
  // to the width exactly as the gather in annotate_kernel clips it)
  bool inversion = mnv;
  for (int i = 0; inversion && i < w && i < rlen; ++i) {
    inversion = r[i] == a[clampi(alen - 1 - i, 0, w - 1)];
  }

  // ---- end location (variant_annotator.py:36-79)
  int32_t end;
  if (snv) {
    end = pos;
  } else if (mnv) {
    end = inversion ? wrap_add(pos, rlen - 1) : wrap_add(pos, nr - 1);
  } else if (na >= 1) {
    if (nr >= 1) {
      end = wrap_add(pos, nr);
    } else if (nr == 0 && rlen > 1) {
      end = wrap_add(pos, rlen - 1);
    } else {
      end = wrap_add(pos, 1);
    }
  } else {
    end = nr == 0 ? wrap_add(pos, rlen - 1) : wrap_add(pos, nr);
  }

  // ---- duplication motif: ref[1:] is whole copies of alt[prefix:]
  const int32_t orig_len = rlen - 1;
  bool is_dup = orig_len > 0 && na > 0 && orig_len % na == 0;
  for (int i = 0; is_dup && i < w && i < orig_len; ++i) {
    const uint8_t shifted = i + 1 < w ? r[i + 1] : 0;
    is_dup = shifted == a[clampi(prefix + i % na, 0, w - 1)];
  }

  // ---- class codes: the reference's branch order, first match wins
  const bool ins_side = !snv && !mnv && na >= 1;
  const bool pure_ins = ins_side && nr == 0 && end == wrap_add(pos, 1);
  int8_t cls;
  if (snv) {
    cls = kSnv;
  } else if (inversion) {
    cls = kInversion;
  } else if (mnv) {
    cls = kMnv;
  } else if (ins_side && !pure_ins) {
    cls = kIndel;
  } else if (pure_ins && is_dup) {
    cls = kDup;
  } else if (pure_ins) {
    cls = kIns;
  } else {
    cls = kDel;
  }

  // ---- closed-form bin on [pos, end]
  const int32_t leaf_a = floor_div(wrap_add(pos, -1), kLeafSize);
  const int32_t leaf_b = floor_div(wrap_add(end, -1), kLeafSize);
  const int32_t bits = 32 - __clz(leaf_a ^ leaf_b);
  const int32_t level = kLevels - min(kLevels, bits);

  prefix_out[row] = prefix;
  nr_out[row] = nr;
  na_out[row] = na;
  end_out[row] = end;
  loc_start_out[row] = cls >= kIns ? wrap_add(pos, 1) : pos;
  loc_end_out[row] = end;
  cls_out[row] = cls;
  dup_out[row] = is_dup && ins_side;
  level_out[row] = static_cast<int8_t>(level);
  leaf_out[row] = leaf_a;
  digest_out[row] = wrap_add(rlen, alen) > kMaxPkSequenceLength;
  fallback_out[row] = rlen > w || alen > w;
}

}  // namespace

extern "C" int annotate_bin_block() { return kBlock; }

// Launches on `stream`; returns cudaGetLastError() after the launch (0 = ok).
extern "C" int annotate_bin_launch(
    const void* pos, const void* ref, const void* alt, const void* rlen,
    const void* alen, int n, int w, void* prefix, void* nr, void* na,
    void* end, void* loc_start, void* loc_end, void* cls, void* dup,
    void* level, void* leaf, void* digest, void* fallback, void* stream) {
  const int grid = (n + kBlock - 1) / kBlock;
  const size_t shmem = static_cast<size_t>(2) * kBlock * w;
  annotate_bin_kernel<<<grid, kBlock, shmem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(pos), static_cast<const uint8_t*>(ref),
      static_cast<const uint8_t*>(alt), static_cast<const int32_t*>(rlen),
      static_cast<const int32_t*>(alen), n, w,
      static_cast<int32_t*>(prefix), static_cast<int32_t*>(nr),
      static_cast<int32_t*>(na), static_cast<int32_t*>(end),
      static_cast<int32_t*>(loc_start), static_cast<int32_t*>(loc_end),
      static_cast<int8_t*>(cls), static_cast<uint8_t*>(dup),
      static_cast<int8_t*>(level), static_cast<int32_t*>(leaf),
      static_cast<uint8_t*>(digest), static_cast<uint8_t*>(fallback));
  return static_cast<int>(cudaGetLastError());
}
