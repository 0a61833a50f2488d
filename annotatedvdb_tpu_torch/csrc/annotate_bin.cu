// Fused annotate + bin-index + allele-hash kernel for Hopper (sm_90a), with
// a second entry that also takes the packed transport's two device steps
// and a third that computes only the VEP update's identity columns.
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
// Three entries share the staging ring and the identity parts of the body:
// - annotate_bin_launch: [n, W] allele byte matrices in, the 13 fields out
//   (raw uploads, display attributes, the egress, the mesh, and VEP stores
//   wider than the identity row takes);
// - annotate_bin_packed_launch: the nibble-packed [n, cols] matrices of the
//   packed transport in (two 4-bit codes a byte, low nibble first, as
//   csrc/pack.cu's inflate reads them) and the [n, 10] row of
//   ops/pack.py::pack_outputs out (hash, leaf bin, bin level, flags with
//   the dup lane 0), so a nibble-uploaded chunk of the VCF load takes one
//   launch where it took three (inflate, annotate, pack) and neither the
//   inflated matrices nor the 13 fields reach device memory.  It replaces,
//   with the first entry's work, the reference's XLA programs
//   annotatedvdb_tpu/ops/pack.py::inflate_alleles (:124) and pack_outputs
//   (:32) on that path;
// - annotate_bin_identity_launch: [n, W] allele byte matrices and the two
//   lengths in (no position), the [n, 6] row of
//   ops/pack.py::pack_vep_outputs out (hash, the shared prefix's low byte,
//   host_fallback), so a VEP identity batch and an update leg's lookup hash
//   take one launch where they took two (annotate_bin, pack_vep_outputs).
//   Its body is the hash, the prefix scan and the width test alone: no
//   inversion or motif scan, no end, class or bin.  It replaces, on that
//   path, the reference's annotate step, allele_hash and the XLA program
//   annotatedvdb_tpu/ops/pack.py::pack_vep_outputs (:214)
//   (annotatedvdb_tpu/loaders/vep_loader.py:478-503).  All three outputs
//   are exact on every row: the prefix scan stops at the width, so it is the
//   plain version's on host_fallback rows too.
//
// Bound: memory.  Each row of the first entry reads 2W + 12 bytes (two
// W-byte allele rows and three int32 scalars) and writes 37 bytes (eight
// int32 and five one-byte fields); the arithmetic is 2W + 2 dependent
// xor/multiply steps of the hash plus the short scans, a few hundred
// integer operations per row, so at W = 49 the card's 3.35 TB/s, not its
// ALUs, is the limit.  The packed entry reads 2 cols + 12 bytes and writes
// 10 a row: 72 at W = 49, 4.4x less than the three kernels it replaces.
// The identity entry reads 2W + 8 and writes 6: 112 at W = 49, where
// annotate_bin and pack_vep_outputs moved 147 + 15.
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
// The packed entry stages the tile's packed rows the same way (T * cols
// bytes, a multiple of 16 as well).  Each thread then decodes its own row
// into a decoded buffer that no copy lands in: rows at a stride of an odd
// number of 32-bit words (no two rows of a warp on one bank) with at least
// one zeroed word past a row's last column, so every scan and the
// funnel-shifted hash stay inside the thread's own row and no barrier is
// needed between the decode and the body.  Four codes decode with two
// byte permutes (the table below, as two 64-bit constants) and two words
// are stored for every four packed bytes; a column at or past W is 0.
// Each thread writes its 10 output bytes into a shared [T, 10] tile (two of
// them, alternating by iteration, so no second barrier is needed), and
// after the tile's closing barrier the block stores the tile's T * 10
// contiguous bytes with 16-byte stores (byte stores where `out` is not
// 16-byte aligned, and for the last tile's ragged end).
//
// The identity entry runs the first entry's ring over the allele rows (the
// position column is not read) and writes its 6-byte rows through two
// alternating shared [T, 6] tiles, stored as the packed entry stores its
// rows.  Its width limit is the row's: a prefix of at most 255 fits its
// byte, and two stages of [128, 255] tiles fit in shared memory.
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
// the packed entry's output row (ops/pack.py::pack_outputs) and its tile
constexpr int kOutRow = 10;
constexpr int kOutTile = kTileRows * kOutRow;
// the identity entry's row (ops/pack.py::pack_vep_outputs), its tile, and
// its width limit (the prefix's byte)
constexpr int kVepRow = 6;
constexpr int kVepTile = kTileRows * kVepRow;
constexpr int kIdentityMaxWidth = 255;
// nibble code -> byte, codes 0-7 and 8-15, one byte a code at shift
// 8 (code & 7): 0 A C G T N a c / g t n * . - 0 0 (csrc/pack.cu's table)
constexpr uint64_t kDecLo = 0x63614E5447434100ull;
constexpr uint64_t kDecHi = 0x00002D2E2A6E7467ull;

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
  int w;  // the staged rows' bytes: the allele width (the packed entry: cols)
  int ntiles;
  uint32_t buf_bytes;  // one allele's buffer in one stage
  uint32_t ref_shift;  // ref's address modulo 16
  uint32_t alt_shift;
};

// The packed entry's launch: the staging ring's parameters over the packed
// rows, the allele width, and the rest of its shared-memory layout.
struct PackedParams {
  Params ring;
  int w;
  uint32_t dec_stride;  // a decoded row's bytes
  uint32_t dec_base;    // where the decoded buffers start in shared memory
  uint32_t out_base;    // where the two output tiles start
  bool out_aligned;     // ring.out 16-byte aligned
};

// The identity entry's launch: the ring over the allele rows (`pos` null)
// and where its two output tiles start.
struct IdentityParams {
  Params ring;
  uint32_t out_base;
  bool out_aligned;  // ring.out 16-byte aligned
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
// bytes (threads 0..63) and every thread's row scalars (the position only
// where kPos).
template <bool kPos>
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
    sc = {kPos ? p.pos[row] : 0, p.rlen[row], p.alen[row]};
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

// The identity hash: FNV-1a over the lengths' low bytes, then every byte
// of both `w`-byte rows at shared-memory byte offsets `ref_off` and
// `alt_off`, pad bytes included.
__device__ __forceinline__ uint32_t identity_hash(const uint8_t* smem,
                                                  uint32_t ref_off,
                                                  uint32_t alt_off, int w,
                                                  int32_t rlen, int32_t alen) {
  uint32_t h = fnv(kFnvOffset, static_cast<uint32_t>(rlen) & 0xFFu);
  h = fnv(h, static_cast<uint32_t>(alen) & 0xFFu);
  h = fnv_row(h, smem, ref_off, w);
  return fnv_row(h, smem, alt_off, w);
}

// Left-normalization: the length of the two rows' shared leading run
// within the width and both lengths, four bytes a step (the first
// differing byte ends it); 0 for an SNV, which scans no byte.
__device__ __forceinline__ int32_t shared_prefix(const uint8_t* smem,
                                                 uint32_t ref_off,
                                                 uint32_t alt_off, int w,
                                                 int32_t rlen, int32_t alen) {
  const int lim = rlen == 1 && alen == 1 ? 0 : min(w, min(rlen, alen));
  int32_t prefix = 0;
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
  return prefix;
}

// host_fallback: an allele longer than the width (truncated on the device).
__device__ __forceinline__ bool over_width(int32_t rlen, int32_t alen, int w) {
  return rlen > w || alen > w;
}

// One variant's outputs.
struct Row {
  int32_t prefix, nr, na, end, loc_start, leaf, level;
  uint32_t h;
  int8_t cls;
  bool dup_motif, digest, fallback;
};

// The body: one row's scans, class, bin and hash, its `w` allele bytes at
// shared-memory byte offsets `ref_off` and `alt_off`.
__device__ __forceinline__ Row annotate_row(const uint8_t* smem,
                                            uint32_t ref_off,
                                            uint32_t alt_off, int w,
                                            const Scalars& sc) {
  const uint8_t* r = smem + ref_off;
  const uint8_t* a = smem + alt_off;
  const int32_t pos = sc.pos;
  const int32_t rlen = sc.rlen;
  const int32_t alen = sc.alen;

  // ---- identity hash: lengths' low bytes, then every byte of both rows
  const uint32_t h = identity_hash(smem, ref_off, alt_off, w, rlen, alen);

  const bool snv = rlen == 1 && alen == 1;
  const bool mnv = rlen == alen && !snv;

  // ---- left-normalization.  The guard repeats the helper's SNV rule: with
  // it this kernel compiles to the instructions it had before the helper
  // (without it, 1.0-1.8% slower in turns on the card)
  int32_t prefix = 0;
  if (!snv) prefix = shared_prefix(smem, ref_off, alt_off, w, rlen, alen);

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

  Row out;
  out.prefix = prefix;
  out.nr = nr;
  out.na = na;
  out.end = end;
  out.loc_start = cls >= kIns ? wrap_add(pos, 1) : pos;
  out.leaf = leaf_a;
  out.level = level;
  out.h = h;
  out.cls = cls;
  out.dup_motif = is_dup && ins_side;
  out.digest = wrap_add(rlen, alen) > kMaxPkSequenceLength;
  out.fallback = over_width(rlen, alen, w);
  return out;
}

// The first entry's outputs: row `row` of each of the 13 fields.
__device__ __forceinline__ void store_fields(const Params& p, int row,
                                             const Row& r) {
  int32_t* words = reinterpret_cast<int32_t*>(p.out);
  uint8_t* bytes = p.out + static_cast<size_t>(kWords) * 4 * p.n;
  const size_t n = p.n;
  words[kPrefix * n + row] = r.prefix;
  words[kNr * n + row] = r.nr;
  words[kNa * n + row] = r.na;
  words[kEnd * n + row] = r.end;
  words[kLocStart * n + row] = r.loc_start;
  words[kLocEnd * n + row] = r.end;
  words[kLeaf * n + row] = r.leaf;
  words[kHash * n + row] = static_cast<int32_t>(r.h);
  bytes[kCls * n + row] = static_cast<uint8_t>(r.cls);
  bytes[kDupMotif * n + row] = r.dup_motif;
  bytes[kLevel * n + row] = static_cast<uint8_t>(r.level);
  bytes[kDigest * n + row] = r.digest;
  bytes[kFallback * n + row] = r.fallback;
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
  stage_tile<true>(p, smem, bars, tile, 0, held, next);
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
      stage_tile<true>(p, smem, bars, ahead, stage ^ 1, held, next);
    }
    mbar_wait(&bars[stage], (phases >> stage) & 1u);
    phases ^= 1u << stage;

    const int row0 = tile * kTileRows;
    if (t < min(kTileRows, p.n - row0)) {
      const uint32_t base = stage * 2 * p.buf_bytes;
      const uint32_t row_off = static_cast<uint32_t>(t) * p.w;
      store_fields(p, row0 + t,
                   annotate_row(smem, base + p.ref_shift + row_off,
                                base + p.buf_bytes + p.alt_shift + row_off,
                                p.w, cur));
    }
    if (ahead < p.ntiles && held.dst >= 0) smem[held.dst] = held.value;
    // order this iteration's shared-memory accesses before the bulk copy
    // that refills this stage in the next one
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
  }
}

// prmt in its generic mode: result byte i is the byte of {b, a} that the
// low 3 bits of selector nibble i name, or, where the nibble's high bit is
// set, that byte's sign replicated
__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b, uint32_t sel) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(sel));
  return d;
}

// Four columns from the 16 bits of packed codes in `codes` (column i in
// bits 4i..4i+3), the first in the low byte.  Codes 0-7 copy from the
// table's low half, and a code of 8-15 in that permute takes a byte's sign,
// 0 for these ASCII bytes; flipping bit 3 makes the high half's permute the
// other way round.
__device__ __forceinline__ uint32_t decode4(uint32_t codes) {
  return prmt(static_cast<uint32_t>(kDecLo), static_cast<uint32_t>(kDecLo >> 32),
              codes) |
         prmt(static_cast<uint32_t>(kDecHi), static_cast<uint32_t>(kDecHi >> 32),
              codes ^ 0x8888u);
}

// The low `cols` bytes of a word (0 to 4 of them).
__device__ __forceinline__ uint32_t keep(int cols) {
  return cols >= 4 ? 0xFFFFFFFFu : (cols <= 0 ? 0u : (1u << (8 * cols)) - 1u);
}

// Decodes one row's packed codes at shared-memory byte offset `poff` (any
// alignment) into `w` columns at the word-aligned `doff`: four packed bytes
// a step, two words stored.  Columns at or past `w` are 0: the last high
// nibble at an odd width and any packed byte past ceil(w / 2).
__device__ __forceinline__ void decode_row(uint8_t* smem, uint32_t poff,
                                           uint32_t doff, int w) {
  uint32_t* d = reinterpret_cast<uint32_t*>(smem + doff);
  for (int k = 0; 8 * k < w; ++k) {
    const uint32_t codes = word_at(smem, poff + 4 * k);
    d[2 * k] = decode4(codes) & keep(w - 8 * k);
    d[2 * k + 1] = decode4(codes >> 16) & keep(w - 8 * k - 4);
  }
}

// The store of a tile's `rows` output rows of kRow bytes from shared memory
// to `out`: 16 bytes a thread where `out` is 16-byte aligned (a tile starts
// at a multiple of 128 kRow bytes, itself a multiple of 16), bytes for the
// rest.
template <int kRow>
__device__ __forceinline__ void store_tile(uint8_t* out, bool out_aligned,
                                           const uint8_t* otile, int row0,
                                           int rows) {
  const int t = threadIdx.x;
  uint8_t* dst = out + static_cast<size_t>(row0) * kRow;
  const int bytes = rows * kRow;
  int done = 0;
  if (out_aligned) {
    done = bytes & ~15;
    for (int i = t; 16 * i < done; i += kTileRows) {
      reinterpret_cast<uint4*>(dst)[i] = reinterpret_cast<const uint4*>(otile)[i];
    }
  }
  for (int i = done + t; i < bytes; i += kTileRows) dst[i] = otile[i];
}

// The packed entry: annotate_bin_kernel's ring over the packed rows, a
// decode a row, the same body, and packed output rows.
__global__ void __launch_bounds__(kTileRows, 1024 / kTileRows)
    annotate_bin_packed_kernel(const PackedParams pp) {
  const Params& p = pp.ring;
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ __align__(8) uint64_t bars[kStages];
  const int t = threadIdx.x;
  if (t == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(&bars[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the words of this thread's decoded rows that no decode writes
  const uint32_t dref = pp.dec_base + static_cast<uint32_t>(t) * pp.dec_stride;
  const uint32_t dalt = dref + kTileRows * pp.dec_stride;
  for (uint32_t k = 8 * ((pp.w + 7) / 8); k < pp.dec_stride; k += 4) {
    *reinterpret_cast<uint32_t*>(smem + dref + k) = 0;
    *reinterpret_cast<uint32_t*>(smem + dalt + k) = 0;
  }
  __syncthreads();

  int tile = blockIdx.x;
  Held held;
  Scalars next = {0, 0, 0};
  stage_tile<true>(p, smem, bars, tile, 0, held, next);
  if (held.dst >= 0) smem[held.dst] = held.value;
  __syncthreads();

  uint32_t phases = 0;
  for (int k = 0; tile < p.ntiles; ++k, tile += gridDim.x) {
    const int stage = k & 1;
    const Scalars cur = next;
    const int ahead = tile + gridDim.x;
    if (ahead < p.ntiles) {
      stage_tile<true>(p, smem, bars, ahead, stage ^ 1, held, next);
    }
    mbar_wait(&bars[stage], (phases >> stage) & 1u);
    phases ^= 1u << stage;

    const int row0 = tile * kTileRows;
    const int rows = min(kTileRows, p.n - row0);
    // iteration k writes tile k & 1; the store of tile k & 1 in iteration
    // k - 2 ended before iteration k - 1's closing barrier
    uint8_t* otile = smem + pp.out_base + stage * kOutTile;
    if (t < rows) {
      const uint32_t base = stage * 2 * p.buf_bytes;
      const uint32_t row_off = static_cast<uint32_t>(t) * p.w;
      decode_row(smem, base + p.ref_shift + row_off, dref, pp.w);
      decode_row(smem, base + p.buf_bytes + p.alt_shift + row_off, dalt, pp.w);
      const Row r = annotate_row(smem, dref, dalt, pp.w, cur);
      // little-endian: hash, leaf bin, bin level, flags (dup lane 0)
      uint16_t* o = reinterpret_cast<uint16_t*>(otile + kOutRow * t);
      o[0] = static_cast<uint16_t>(r.h);
      o[1] = static_cast<uint16_t>(r.h >> 16);
      o[2] = static_cast<uint16_t>(static_cast<uint32_t>(r.leaf));
      o[3] = static_cast<uint16_t>(static_cast<uint32_t>(r.leaf) >> 16);
      o[4] = static_cast<uint16_t>((r.level & 0xFF) |
                                   ((r.digest << 1) | (r.fallback << 2)) << 8);
    }
    if (ahead < p.ntiles && held.dst >= 0) smem[held.dst] = held.value;
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    store_tile<kOutRow>(p.out, pp.out_aligned, otile, row0, rows);
  }
}

// The identity entry: annotate_bin_kernel's ring over the allele rows, the
// identity parts of the body, and [n, 6] rows through shared tiles.
__global__ void __launch_bounds__(kTileRows, 1024 / kTileRows)
    annotate_bin_identity_kernel(const IdentityParams ip) {
  const Params& p = ip.ring;
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
  stage_tile<false>(p, smem, bars, tile, 0, held, next);
  if (held.dst >= 0) smem[held.dst] = held.value;
  __syncthreads();

  uint32_t phases = 0;
  for (int k = 0; tile < p.ntiles; ++k, tile += gridDim.x) {
    const int stage = k & 1;
    const Scalars cur = next;
    const int ahead = tile + gridDim.x;
    if (ahead < p.ntiles) {
      stage_tile<false>(p, smem, bars, ahead, stage ^ 1, held, next);
    }
    mbar_wait(&bars[stage], (phases >> stage) & 1u);
    phases ^= 1u << stage;

    const int row0 = tile * kTileRows;
    const int rows = min(kTileRows, p.n - row0);
    // iteration k writes tile k & 1, as in the packed entry
    uint8_t* otile = smem + ip.out_base + stage * kVepTile;
    if (t < rows) {
      const uint32_t base = stage * 2 * p.buf_bytes;
      const uint32_t row_off = static_cast<uint32_t>(t) * p.w;
      const uint32_t ref_off = base + p.ref_shift + row_off;
      const uint32_t alt_off = base + p.buf_bytes + p.alt_shift + row_off;
      const uint32_t h = identity_hash(smem, ref_off, alt_off, p.w, cur.rlen,
                                       cur.alen);
      const int32_t prefix =
          shared_prefix(smem, ref_off, alt_off, p.w, cur.rlen, cur.alen);
      // little-endian: hash, the prefix's low byte, host_fallback
      uint16_t* o = reinterpret_cast<uint16_t*>(otile + kVepRow * t);
      o[0] = static_cast<uint16_t>(h);
      o[1] = static_cast<uint16_t>(h >> 16);
      o[2] = static_cast<uint16_t>(
          (prefix & 0xFF) | (over_width(cur.rlen, cur.alen, p.w) << 8));
    }
    if (ahead < p.ntiles && held.dst >= 0) smem[held.dst] = held.value;
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    store_tile<kVepRow>(p.out, ip.out_aligned, otile, row0, rows);
  }
}

uint32_t buffer_bytes(int w) {
  return (static_cast<uint32_t>(kTileRows) * w + kSlack + 15u) & ~15u;
}

size_t smem_bytes(int w) {
  return static_cast<size_t>(kStages) * 2 * buffer_bytes(w);
}

// A decoded row's stride: an odd number of words (a warp's rows on distinct
// banks), at least one past the row's last column (the scans' and the
// hash's reads past it stay in the row).
uint32_t dec_stride(int w) {
  return 4u * (((static_cast<uint32_t>(w) + 3u) / 4u + 1u) | 1u);
}

// The packed entry's shared memory: the two-stage ring of packed rows, the
// two decoded buffers and the two output tiles, in this order.
size_t packed_smem_bytes(int w, int cols) {
  return smem_bytes(cols) + 2u * kTileRows * dec_stride(w) +
         static_cast<size_t>(kStages) * kOutTile;
}

// The identity entry's shared memory: the ring, then its two output tiles.
size_t identity_smem_bytes(int w) {
  return smem_bytes(w) + static_cast<size_t>(kStages) * kVepTile;
}

constexpr int kMaxDevices = 64;
int g_sms[kMaxDevices];
bool g_smem_opt_in[kMaxDevices];
int g_blocks_per_sm[kMaxDevices][kMaxWidth + 1];
bool g_packed_opt_in[kMaxDevices];
// the packed entry's blocks per SM for the last shared-memory size asked
size_t g_packed_smem[kMaxDevices];
int g_packed_per_sm[kMaxDevices];
bool g_identity_opt_in[kMaxDevices];
int g_identity_per_sm[kMaxDevices][kIdentityMaxWidth + 1];

// The device's SM count (cached); 0 on error.
int sm_count(int dev) {
  if (g_sms[dev] == 0 &&
      cudaDeviceGetAttribute(&g_sms[dev], cudaDevAttrMultiProcessorCount,
                             dev) != cudaSuccess) {
    g_sms[dev] = 0;
  }
  return g_sms[dev];
}

// Blocks for `ntiles` tiles at `per_sm` blocks an SM: every block walks the
// same number of tiles.
int grid_for(int ntiles, int per_sm, int sms) {
  const int slots = per_sm * sms;
  const int rounds = (ntiles + slots - 1) / slots;
  return (ntiles + rounds - 1) / rounds;
}

}  // namespace

extern "C" int annotate_bin_tile_rows() { return kTileRows; }
extern "C" int annotate_bin_max_width() { return kMaxWidth; }
extern "C" int annotate_bin_identity_max_width() { return kIdentityMaxWidth; }

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

namespace {

// The launch's common part: the device, its SM count and `per_sm` (0 on
// error, as the blocks-per-SM functions give it), the grid, and the
// row-independent parameters.  Returns a cudaError_t (0 = ok).
int prepare(const void* pos, const void* ref, const void* alt,
            const void* rlen, const void* alen, int n, int row_bytes,
            void* out, int per_sm, Params* p, int* grid) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  const int sms = sm_count(dev);
  if (sms == 0 || per_sm == 0) {
    err = cudaGetLastError();
    return static_cast<int>(err != cudaSuccess ? err
                                               : cudaErrorInvalidConfiguration);
  }
  const int ntiles = (n + kTileRows - 1) / kTileRows;
  *grid = grid_for(ntiles, per_sm, sms);
  p->pos = static_cast<const int32_t*>(pos);
  p->ref = static_cast<const uint8_t*>(ref);
  p->alt = static_cast<const uint8_t*>(alt);
  p->rlen = static_cast<const int32_t*>(rlen);
  p->alen = static_cast<const int32_t*>(alen);
  p->out = static_cast<uint8_t*>(out);
  p->n = n;
  p->w = row_bytes;
  p->ntiles = ntiles;
  p->buf_bytes = buffer_bytes(row_bytes);
  p->ref_shift = static_cast<uint32_t>(reinterpret_cast<uintptr_t>(ref) & 15u);
  p->alt_shift = static_cast<uint32_t>(reinterpret_cast<uintptr_t>(alt) & 15u);
  return 0;
}

}  // namespace

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
  Params p;
  int grid = 0;
  const int err = prepare(pos, ref, alt, rlen, alen, n, w, out,
                          annotate_bin_blocks_per_sm(w), &p, &grid);
  if (err != 0) return err;
  annotate_bin_kernel<<<grid, kTileRows, smem_bytes(w),
                        static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// Blocks per SM the packed entry would use at width `w` and `cols` packed
// bytes a row on the current device (0 on error).
extern "C" int annotate_bin_packed_blocks_per_sm(int w, int cols) {
  if (w < 1 || w > kMaxWidth || cols < (w + 1) / 2 || cols > kMaxWidth) {
    return 0;
  }
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= kMaxDevices) return 0;
  // opt in once to the shared memory of the widest width and packed row
  // (above the default 48 KB from W = 80 on at cols = ceil(W / 2))
  if (!g_packed_opt_in[dev]) {
    if (cudaFuncSetAttribute(
            annotate_bin_packed_kernel,
            cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(packed_smem_bytes(kMaxWidth, kMaxWidth))) !=
        cudaSuccess) {
      return 0;
    }
    g_packed_opt_in[dev] = true;
  }
  const size_t bytes = packed_smem_bytes(w, cols);
  if (g_packed_smem[dev] != bytes) {
    int per_sm = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, annotate_bin_packed_kernel, kTileRows, bytes) !=
        cudaSuccess) {
      return 0;
    }
    g_packed_per_sm[dev] = per_sm;
    g_packed_smem[dev] = bytes;
  }
  return g_packed_per_sm[dev];
}

// The packed entry on `stream`: `ref_packed` and `alt_packed` [n, cols]
// nibble codes (2 cols >= w, cols <= kMaxWidth, any address), `out` the
// [n, 10] packed rows.  Returns a cudaError_t (0 = ok).
extern "C" int annotate_bin_packed_launch(const void* pos,
                                          const void* ref_packed,
                                          const void* alt_packed,
                                          const void* rlen, const void* alen,
                                          int n, int cols, int w, void* out,
                                          void* stream) {
  if (n <= 0 || w < 1 || w > kMaxWidth || cols < (w + 1) / 2 ||
      cols > kMaxWidth) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  PackedParams pp;
  int grid = 0;
  const int err =
      prepare(pos, ref_packed, alt_packed, rlen, alen, n, cols, out,
              annotate_bin_packed_blocks_per_sm(w, cols), &pp.ring, &grid);
  if (err != 0) return err;
  pp.w = w;
  pp.dec_stride = dec_stride(w);
  pp.dec_base = static_cast<uint32_t>(smem_bytes(cols));
  pp.out_base = pp.dec_base + 2u * kTileRows * pp.dec_stride;
  pp.out_aligned = (reinterpret_cast<uintptr_t>(out) & 15u) == 0;
  annotate_bin_packed_kernel<<<grid, kTileRows, packed_smem_bytes(w, cols),
                               static_cast<cudaStream_t>(stream)>>>(pp);
  return static_cast<int>(cudaGetLastError());
}

// Blocks per SM the identity entry would use at width `w` on the current
// device (0 on error).
extern "C" int annotate_bin_identity_blocks_per_sm(int w) {
  if (w < 1 || w > kIdentityMaxWidth) return 0;
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= kMaxDevices) return 0;
  // opt in once to the shared memory of the widest width (above the
  // default 48 KB from W = 93 on)
  if (!g_identity_opt_in[dev]) {
    if (cudaFuncSetAttribute(
            annotate_bin_identity_kernel,
            cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(identity_smem_bytes(kIdentityMaxWidth))) !=
        cudaSuccess) {
      return 0;
    }
    g_identity_opt_in[dev] = true;
  }
  int& cached = g_identity_per_sm[dev][w];
  if (cached == 0 &&
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &cached, annotate_bin_identity_kernel, kTileRows,
          identity_smem_bytes(w)) != cudaSuccess) {
    cached = 0;
  }
  return cached;
}

// The identity entry on `stream`: `ref` and `alt` [n, w] allele bytes (w at
// most kIdentityMaxWidth, any address), `rlen` and `alen` [n] int32, `out`
// the [n, 6] rows.  Returns a cudaError_t (0 = ok).
extern "C" int annotate_bin_identity_launch(const void* ref, const void* alt,
                                            const void* rlen, const void* alen,
                                            int n, int w, void* out,
                                            void* stream) {
  if (n <= 0 || w < 1 || w > kIdentityMaxWidth) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  IdentityParams ip;
  int grid = 0;
  const int err = prepare(nullptr, ref, alt, rlen, alen, n, w, out,
                          annotate_bin_identity_blocks_per_sm(w), &ip.ring,
                          &grid);
  if (err != 0) return err;
  ip.out_base = static_cast<uint32_t>(smem_bytes(w));
  ip.out_aligned = (reinterpret_cast<uintptr_t>(out) & 15u) == 0;
  annotate_bin_identity_kernel<<<grid, kTileRows, identity_smem_bytes(w),
                                 static_cast<cudaStream_t>(stream)>>>(ip);
  return static_cast<int>(cudaGetLastError());
}
