// avdb_cadd: native tokenizer for CADD score tables (TSV: chrom, pos, ref,
// alt, raw, phred).
//
// The JAX package's native/avdb_cadd.cpp but for comments (pinned by
// tests/test_torch_cadd.py).  In the reference system tabix reads these
// tables; a per-line Python loop is the CADD join leg's dominant cost.
// This tokenizer scans a decompressed byte window and fills columnar output
// buffers directly: chromosome codes, positions, width-bounded allele
// matrices + true lengths + byte spans (long alleles materialize host-side
// from the spans), and float64 scores.
//
// Rows that fail to parse (short lines, non-numeric fields, unplaceable
// contigs) are skipped and counted.  Only COMPLETE lines are consumed; the
// caller re-feeds the unconsumed tail, exactly like avdb_native.cpp.
//
// Build: g++ at first use (bound in annotatedvdb_tpu_torch/native/cadd.py).

#include <cstdint>
#include <cstdlib>
#include <cstring>

namespace {

inline int8_t chrom_code(const char* s, int len) {
    if (len >= 3 && s[0] == 'c' && s[1] == 'h' && s[2] == 'r') {
        s += 3;
        len -= 3;
    }
    if (len == 1) {
        switch (s[0]) {
            case 'X': return 23;
            case 'Y': return 24;
            case 'M': return 25;
            default: break;
        }
        if (s[0] >= '1' && s[0] <= '9') return static_cast<int8_t>(s[0] - '0');
        return 0;
    }
    if (len == 2) {
        if (s[0] == 'M' && s[1] == 'T') return 25;
        if (s[0] >= '1' && s[0] <= '2' && s[1] >= '0' && s[1] <= '9') {
            int v = (s[0] - '0') * 10 + (s[1] - '0');
            if (v >= 10 && v <= 22) return static_cast<int8_t>(v);
        }
    }
    return 0;
}

struct Span {
    const char* ptr;
    int len;
};

}  // namespace

extern "C" {

// Counters layout (int64): [0] data lines seen, [1] skipped (malformed or
// unplaceable contig).
//
// Returns rows written.  *consumed = bytes of fully processed lines;
// *need_more = 1 when the row buffers filled before the window was
// exhausted.
int64_t avdb_parse_cadd_chunk(
    const char* buf, int64_t n_bytes, int32_t width, int64_t max_rows,
    int8_t* chrom, int32_t* pos,
    uint8_t* ref, uint8_t* alt,
    int32_t* ref_len, int32_t* alt_len,
    int64_t* ref_off, int64_t* alt_off,
    double* raw, double* phred,
    int64_t* counters, int64_t* consumed, int32_t* need_more) {
    int64_t rows = 0;
    int64_t offset = 0;
    *need_more = 0;

    while (offset < n_bytes) {
        const char* nl = static_cast<const char*>(
            memchr(buf + offset, '\n', static_cast<size_t>(n_bytes - offset)));
        if (nl == nullptr) break;  // incomplete final line
        const char* p = buf + offset;
        int64_t len = nl - p;
        int64_t next_offset = offset + len + 1;
        if (len > 0 && p[len - 1] == '\r') --len;
        if (len == 0 || p[0] == '#') {
            offset = next_offset;
            continue;
        }
        if (rows >= max_rows) {
            *need_more = 1;
            break;
        }
        counters[0]++;

        Span fields[6];
        int nf = 0;
        const char* start = p;
        const char* end = p + len;
        for (const char* q = p; q <= end && nf < 6; ++q) {
            if (q == end || *q == '\t') {
                fields[nf].ptr = start;
                fields[nf].len = static_cast<int>(q - start);
                ++nf;
                start = q + 1;
            }
        }
        if (nf < 6) {
            counters[1]++;
            offset = next_offset;
            continue;
        }
        int8_t code = chrom_code(fields[0].ptr, fields[0].len);
        int64_t position = 0;
        bool ok = code != 0 && fields[1].len > 0;
        for (int i = 0; ok && i < fields[1].len; ++i) {
            char c = fields[1].ptr[i];
            if (c < '0' || c > '9') ok = false;
            else if (position > (INT64_C(0x7fffffff) - (c - '0')) / 10)
                ok = false;
            else position = position * 10 + (c - '0');
        }
        if (position <= 0) ok = false;  // 1-based coordinates
        double raw_v = 0.0, phred_v = 0.0;
        if (ok) {
            // strtod needs NUL-terminated input; fields sit inside the
            // window, so bound-copy the score fields (they are tiny)
            char tmp[64];
            for (int f = 4; f <= 5 && ok; ++f) {
                int l = fields[f].len;
                if (l <= 0 || l >= static_cast<int>(sizeof(tmp))) {
                    ok = false;
                    break;
                }
                std::memcpy(tmp, fields[f].ptr, static_cast<size_t>(l));
                tmp[l] = '\0';
                char* endp = nullptr;
                double v = std::strtod(tmp, &endp);
                if (endp != tmp + l) ok = false;
                else if (f == 4) raw_v = v;
                else phred_v = v;
            }
        }
        if (!ok || fields[2].len == 0 || fields[3].len == 0) {
            counters[1]++;
            offset = next_offset;
            continue;
        }
        int64_t r = rows++;
        chrom[r] = code;
        pos[r] = static_cast<int32_t>(position);
        ref_len[r] = fields[2].len;
        alt_len[r] = fields[3].len;
        ref_off[r] = fields[2].ptr - buf;
        alt_off[r] = fields[3].ptr - buf;
        int rc = fields[2].len < width ? fields[2].len : width;
        int ac = fields[3].len < width ? fields[3].len : width;
        uint8_t* rrow = ref + r * width;
        uint8_t* arow = alt + r * width;
        std::memcpy(rrow, fields[2].ptr, static_cast<size_t>(rc));
        std::memset(rrow + rc, 0, static_cast<size_t>(width - rc));
        std::memcpy(arow, fields[3].ptr, static_cast<size_t>(ac));
        std::memset(arow + ac, 0, static_cast<size_t>(width - ac));
        raw[r] = raw_v;
        phred[r] = phred_v;
        offset = next_offset;
    }
    *consumed = offset;
    return rows;
}

}  // extern "C"
