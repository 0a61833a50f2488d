// Fused annotate + bin-index + allele-hash kernel for Hopper (sm_90a).
//
// Replaces annotatedvdb_tpu/ops/annotate_pallas.py::annotate_bin_pallas
// (the Pallas TPU kernel, body `_kernel`) and, in the same pass, the XLA
// kernel annotatedvdb_tpu/ops/hashing.py::allele_hash that the reference
// loader dispatches right after it on the same arrays.  Per variant it
// computes the shared-prefix length (left-normalization), the inversion
// test, the end location, the duplication-motif test (lag 0 included), the
// variant class, the closed-form bin (level, leaf), needs_digest,
// host_fallback and the 32-bit FNV-1a identity hash — the semantics of
// ops/annotate.py::annotate_kernel, ops/binindex.py::bin_index_kernel and
// ops/hashing.py::allele_hash.  host_fallback, needs_digest and the hash
// are exact on every row; the other fields on every row that is not
// host_fallback.  The hash covers all W bytes of ref and then of alt, pad
// bytes included, so over-width rows hash their truncated bytes exactly as
// the plain version does.
//
// Bound: memory.  Each row reads 2W + 12 bytes (two W-byte allele rows and
// three int32 scalars) and writes 37 bytes (eight int32 and five one-byte
// fields); the arithmetic is 2W + 2 dependent xor/multiply steps of the
// hash plus the short scans, a few hundred integer operations per row, so
// at W = 49 the card's 3.35 TB/s, not its ALUs, is the limit.
//
// Design: a persistent grid (as many blocks as fit on the SMs, rounded so
// every block walks the same number of tiles) strides over tiles of
// kTileRows rows; one thread owns one row.  A tile's ref and alt rows are
// contiguous ([T, W] row-major), so one thread stages each of them with a
// one-dimensional TMA bulk copy (cp.async.bulk completing on an mbarrier)
// into one of two shared-memory stages: the copy of the next tile runs
// under the scans and the hash of this one.  A bulk copy needs 16-byte
// aligned addresses and a size that is a multiple of 16.  The tile's bytes
// land at the same offset modulo 16 in shared memory as they have in
// device memory (the shift is constant across tiles because T * W is a
// multiple of 16), so the aligned middle of every tile goes in one bulk
// copy, and the at most 15 leading bytes (an unaligned base, such as a
// tensor with a storage offset) and 15 trailing bytes (the ragged last
// tile) are loaded by 64 threads into registers when the copy starts and
// stored after the scans.  The hash reads its row as 32-bit words
// re-aligned with funnel shifts (a quarter of the shared-memory loads of a
// byte walk); at W = 49 a warp's 32 rows then fall at most two to a bank.
// The prefix and inversion scans compare four bytes a step the same way:
// their trip counts differ from row to row, so a warp runs as long as its
// longest row, and on mixed rows (one SNV in seven) bytewise scans set the
// kernel's time.
// The serial FNV chain (100 dependent steps at W = 49) is hidden behind
// the other warps on the SM, not inside the thread.
//
// Overflow: positions near INT32_MAX (pad rows carry POS_SENTINEL) make
// sums such as pos + nr overflow.  They are computed in unsigned arithmetic
// and reinterpreted, which is the two's-complement wrap jnp and torch give.
// (pos - 1) // 15625 is a floor division, as in jnp, not C's truncation.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTileRows = 128;  // rows per tile = threads per block
constexpr int kStages = 2;
constexpr int kMaxWidth = 192;
// per allele buffer: the 0..15-byte alignment shift, the tile, and the
// words the funnel-shifted hash reads past a row's last byte
constexpr int kSlack = 32;
constexpr int kLeafSize = 15625;
constexpr int kLevels = 13;
constexpr int kMaxPkSequenceLength = 50;
constexpr uint32_t kFnvOffset = 2166136261u;
constexpr uint32_t kFnvPrime = 16777619u;

static_assert(kTileRows % 16 == 0 && kTileRows >= 64 && kTileRows <= 1024,
              "tiles must keep 16-byte alignment and have 64 copy threads");

// VariantClass codes (types.py)
constexpr int8_t kSnv = 0, kMnv = 1, kInversion = 2, kIns = 3, kDup = 4,
                 kIndel = 5, kDel = 6;

// Output buffer: eight int32 fields of n values, then five one-byte fields
// of n values, in this order (ops/annotate_cuda.py carves the same views).
enum Word { kPrefix, kNr, kNa, kEnd, kLocStart, kLocEnd, kLeaf, kHash, kWords };
enum Byte { kCls, kDupMotif, kLevel, kDigest, kFallback, kBytes };

struct Params {
  const int32_t* pos;
  const uint8_t* ref;
  const uint8_t* alt;
  const int32_t* rlen;
  const int32_t* alen;
  uint8_t* out;
  int n;
  int w;
  int ntiles;
  uint32_t buf_bytes;  // one allele's buffer in one stage
  uint32_t ref_shift;  // ref's address modulo 16
  uint32_t alt_shift;
};

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

__device__ __forceinline__ uint32_t fnv(uint32_t h, uint32_t byte) {
  return (h ^ byte) * kFnvPrime;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// How one allele's bytes of one tile split between the bulk copy and the
// registers: [0, head) and [head + mid, total) by threads, the 16-byte
// aligned [head, head + mid) by one bulk copy.
struct Split {
  uint32_t head, mid, total;
};

__device__ __forceinline__ Split split(uint32_t total, uint32_t shift) {
  const uint32_t head = min(total, (16u - shift) & 15u);
  return {head, (total - head) & ~15u, total};
}

// Row scalars of one tile, read ahead into registers.
struct Scalars {
  int32_t pos, rlen, alen;
};

// One byte of a tile edge held in a register between its load and store
// (threads 0..31 serve ref, 32..63 alt; lanes 0..15 the head, 16..31 the
// tail).
struct Held {
  uint8_t value;
  int32_t dst;  // byte offset in shared memory, -1 for none
};

// Start staging `tile` into `stage`: the bulk copies (thread 0), the edge
// bytes (threads 0..63) and every thread's row scalars.
__device__ __forceinline__ void stage_tile(const Params& p, uint8_t* smem,
                                           uint64_t* bars, int tile,
                                           int stage, Held& held,
                                           Scalars& sc) {
  const int t = threadIdx.x;
  const int row0 = tile * kTileRows;
  const int rows = min(kTileRows, p.n - row0);
  const uint32_t total = static_cast<uint32_t>(rows) * p.w;
  const size_t goff = static_cast<size_t>(row0) * p.w;
  uint8_t* sref = smem + stage * 2 * p.buf_bytes;
  uint8_t* salt = sref + p.buf_bytes;
  if (t == 0) {
    const Split r = split(total, p.ref_shift);
    const Split a = split(total, p.alt_shift);
    mbar_arrive_expect_tx(&bars[stage], r.mid + a.mid);
    if (r.mid) {
      bulk_copy(sref + p.ref_shift + r.head, p.ref + goff + r.head, r.mid,
                &bars[stage]);
    }
    if (a.mid) {
      bulk_copy(salt + p.alt_shift + a.head, p.alt + goff + a.head, a.mid,
                &bars[stage]);
    }
  }
  held.dst = -1;
  if (t < 64) {
    const bool is_alt = t >= 32;
    const uint32_t shift = is_alt ? p.alt_shift : p.ref_shift;
    const Split s = split(total, shift);
    const int lane = t & 31;
    uint32_t at = 0xFFFFFFFFu;
    if (lane < 16 && static_cast<uint32_t>(lane) < s.head) {
      at = lane;
    } else if (lane >= 16 && s.head + s.mid + (lane - 16) < s.total) {
      at = s.head + s.mid + (lane - 16);
    }
    if (at != 0xFFFFFFFFu) {
      const uint8_t* g = (is_alt ? p.alt : p.ref) + goff;
      held.value = g[at];
      held.dst = static_cast<int32_t>((is_alt ? salt : sref) - smem + shift +
                                      at);
    }
  }
  if (t < rows) {
    const int row = row0 + t;
    sc = {p.pos[row], p.rlen[row], p.alen[row]};
  }
}

// The four bytes at shared-memory byte offset `off` (any alignment), the
// first in the low byte: two aligned loads and a funnel shift.
__device__ __forceinline__ uint32_t word_at(const uint8_t* smem,
                                            uint32_t off) {
  const uint32_t* q = reinterpret_cast<const uint32_t*>(smem) + (off >> 2);
  return __funnelshift_r(q[0], q[1], (off & 3u) * 8u);
}

// FNV-1a over the `w` bytes at shared-memory byte offset `off`, read as
// aligned 32-bit words and re-aligned with funnel shifts.
__device__ __forceinline__ uint32_t fnv_row(uint32_t h, const uint8_t* smem,
                                            uint32_t off, int w) {
  const uint32_t* q = reinterpret_cast<const uint32_t*>(smem) + (off >> 2);
  const uint32_t sh = (off & 3u) * 8u;
  uint32_t lo = q[0];
  int i = 0;
  for (; i + 4 <= w; i += 4) {
    const uint32_t hi = q[(i >> 2) + 1];
    const uint32_t v = __funnelshift_r(lo, hi, sh);
    h = fnv(h, v & 0xFFu);
    h = fnv(h, (v >> 8) & 0xFFu);
    h = fnv(h, (v >> 16) & 0xFFu);
    h = fnv(h, v >> 24);
    lo = hi;
  }
  if (i < w) {
    uint32_t v = __funnelshift_r(lo, q[(i >> 2) + 1], sh);
    for (; i < w; ++i, v >>= 8) h = fnv(h, v & 0xFFu);
  }
  return h;
}

__device__ __forceinline__ void annotate_row(const Params& p,
                                             const uint8_t* smem,
                                             uint32_t ref_off,
                                             uint32_t alt_off, int row,
                                             const Scalars& sc) {
  const int w = p.w;
  const uint8_t* r = smem + ref_off;
  const uint8_t* a = smem + alt_off;
  const int32_t pos = sc.pos;
  const int32_t rlen = sc.rlen;
  const int32_t alen = sc.alen;

  // ---- identity hash: lengths' low bytes, then every byte of both rows
  uint32_t h = fnv(kFnvOffset, static_cast<uint32_t>(rlen) & 0xFFu);
  h = fnv(h, static_cast<uint32_t>(alen) & 0xFFu);
  h = fnv_row(h, smem, ref_off, w);
  h = fnv_row(h, smem, alt_off, w);

  const bool snv = rlen == 1 && alen == 1;
  const bool mnv = rlen == alen && !snv;

  // ---- left-normalization: length of the shared leading run, four bytes
  // a step (the first differing byte ends it)
  int32_t prefix = 0;
  if (!snv) {
    const int lim = min(w, min(rlen, alen));
    while (prefix < lim) {
      const uint32_t x =
          word_at(smem, ref_off + prefix) ^ word_at(smem, alt_off + prefix);
      const int same = x ? (__ffs(x) - 1) >> 3 : 4;
      if (same < 4 || prefix + 4 >= lim) {
        prefix = min(prefix + same, lim);
        break;
      }
      prefix += 4;
    }
  }

  // ---- inversion: ref == reverse(alt), equal lengths.  Within the width,
  // four bytes of ref against four byte-reversed bytes of alt a step; past
  // it (host_fallback rows) bytewise with the alt index clipped to the
  // width exactly as the gather in annotate_kernel clips it.
  bool inversion = mnv;
  if (mnv && rlen <= w) {
    int i = 0;
    for (; inversion && i + 4 <= rlen; i += 4) {
      inversion = word_at(smem, ref_off + i) ==
                  __byte_perm(word_at(smem, alt_off + rlen - 4 - i), 0,
                              0x0123);
    }
    for (; inversion && i < rlen; ++i) inversion = r[i] == a[rlen - 1 - i];
  } else {
    for (int i = 0; inversion && i < w && i < rlen; ++i) {
      inversion = r[i] == a[clampi(alen - 1 - i, 0, w - 1)];
    }
  }
  const int32_t nr = rlen - prefix;
  const int32_t na = alen - prefix;

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

  int32_t* words = reinterpret_cast<int32_t*>(p.out);
  uint8_t* bytes = p.out + static_cast<size_t>(kWords) * 4 * p.n;
  const size_t n = p.n;
  words[kPrefix * n + row] = prefix;
  words[kNr * n + row] = nr;
  words[kNa * n + row] = na;
  words[kEnd * n + row] = end;
  words[kLocStart * n + row] = cls >= kIns ? wrap_add(pos, 1) : pos;
  words[kLocEnd * n + row] = end;
  words[kLeaf * n + row] = leaf_a;
  words[kHash * n + row] = static_cast<int32_t>(h);
  bytes[kCls * n + row] = static_cast<uint8_t>(cls);
  bytes[kDupMotif * n + row] = is_dup && ins_side;
  bytes[kLevel * n + row] = static_cast<uint8_t>(level);
  bytes[kDigest * n + row] = wrap_add(rlen, alen) > kMaxPkSequenceLength;
  bytes[kFallback * n + row] = rlen > w || alen > w;
}

// at most 64 registers a thread, so 1,024 threads fit on an SM
__global__ void __launch_bounds__(kTileRows, 1024 / kTileRows)
    annotate_bin_kernel(const Params p) {
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ __align__(8) uint64_t bars[kStages];
  const int t = threadIdx.x;
  if (t == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(&bars[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  int tile = blockIdx.x;
  Held held;
  Scalars next = {0, 0, 0};
  stage_tile(p, smem, bars, tile, 0, held, next);
  if (held.dst >= 0) smem[held.dst] = held.value;
  __syncthreads();

  uint32_t phases = 0;
  for (int k = 0; tile < p.ntiles; ++k, tile += gridDim.x) {
    const int stage = k & 1;
    const Scalars cur = next;
    const int ahead = tile + gridDim.x;
    // stage ^ 1 was last read in iteration k - 1, before its closing
    // barrier: refill it with the next tile while this one is scanned
    if (ahead < p.ntiles) {
      stage_tile(p, smem, bars, ahead, stage ^ 1, held, next);
    }
    mbar_wait(&bars[stage], (phases >> stage) & 1u);
    phases ^= 1u << stage;

    const int row0 = tile * kTileRows;
    if (t < min(kTileRows, p.n - row0)) {
      const uint32_t base = stage * 2 * p.buf_bytes;
      const uint32_t row_off = static_cast<uint32_t>(t) * p.w;
      annotate_row(p, smem, base + p.ref_shift + row_off,
                   base + p.buf_bytes + p.alt_shift + row_off, row0 + t, cur);
    }
    if (ahead < p.ntiles && held.dst >= 0) smem[held.dst] = held.value;
    // order this iteration's shared-memory accesses before the bulk copy
    // that refills this stage in the next one
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
  }
}

uint32_t buffer_bytes(int w) {
  return (static_cast<uint32_t>(kTileRows) * w + kSlack + 15u) & ~15u;
}

size_t smem_bytes(int w) {
  return static_cast<size_t>(kStages) * 2 * buffer_bytes(w);
}

constexpr int kMaxDevices = 64;
int g_sms[kMaxDevices];
bool g_smem_opt_in[kMaxDevices];
int g_blocks_per_sm[kMaxDevices][kMaxWidth + 1];

}  // namespace

extern "C" int annotate_bin_tile_rows() { return kTileRows; }
extern "C" int annotate_bin_max_width() { return kMaxWidth; }

// Blocks per SM the launch would use for width `w` on the current device
// (0 on error).
extern "C" int annotate_bin_blocks_per_sm(int w) {
  if (w < 1 || w > kMaxWidth) return 0;
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= kMaxDevices) return 0;
  // opt in once to the dynamic shared memory of the widest width (above
  // the default 48 KB from W = 96 on)
  if (!g_smem_opt_in[dev]) {
    if (cudaFuncSetAttribute(annotate_bin_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_bytes(kMaxWidth))) !=
        cudaSuccess) {
      return 0;
    }
    g_smem_opt_in[dev] = true;
  }
  int& cached = g_blocks_per_sm[dev][w];
  if (cached == 0 &&
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &cached, annotate_bin_kernel, kTileRows, smem_bytes(w)) !=
          cudaSuccess) {
    cached = 0;
  }
  return cached;
}

// Launches on `stream` with as many blocks on each SM as fit; returns a
// cudaError_t (0 = ok).  `out` receives
// the 13 fields in the layout of `Word` and `Byte` above.
extern "C" int annotate_bin_launch(const void* pos, const void* ref,
                                   const void* alt, const void* rlen,
                                   const void* alen, int n, int w, void* out,
                                   void* stream) {
  if (n <= 0 || w < 1 || w > kMaxWidth) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (g_sms[dev] == 0) {
    err = cudaDeviceGetAttribute(&g_sms[dev], cudaDevAttrMultiProcessorCount,
                                 dev);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int per_sm = annotate_bin_blocks_per_sm(w);
  if (per_sm == 0) {
    err = cudaGetLastError();
    return static_cast<int>(err != cudaSuccess ? err
                                               : cudaErrorInvalidConfiguration);
  }
  const int ntiles = (n + kTileRows - 1) / kTileRows;
  // every block walks the same number of tiles
  const int slots = per_sm * g_sms[dev];
  const int rounds = (ntiles + slots - 1) / slots;
  const int grid = (ntiles + rounds - 1) / rounds;

  Params p;
  p.pos = static_cast<const int32_t*>(pos);
  p.ref = static_cast<const uint8_t*>(ref);
  p.alt = static_cast<const uint8_t*>(alt);
  p.rlen = static_cast<const int32_t*>(rlen);
  p.alen = static_cast<const int32_t*>(alen);
  p.out = static_cast<uint8_t*>(out);
  p.n = n;
  p.w = w;
  p.ntiles = ntiles;
  p.buf_bytes = buffer_bytes(w);
  p.ref_shift = static_cast<uint32_t>(reinterpret_cast<uintptr_t>(ref) & 15u);
  p.alt_shift = static_cast<uint32_t>(reinterpret_cast<uintptr_t>(alt) & 15u);
  annotate_bin_kernel<<<grid, kTileRows, smem_bytes(w),
                        static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
