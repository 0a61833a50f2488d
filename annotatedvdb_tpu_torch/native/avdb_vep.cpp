// avdb_vep: native VEP-result transformer for the TPU variant-annotation
// framework.
//
// The reference's VEP load is a per-line Python pipeline: json.loads, rank
// every consequence combo, re-key the four consequence blocks per allele,
// extract/group colocated frequencies, and build per-alt UPDATE rows
// (Load/bin/load_vep_result.py + vep_variant_loader.py + vep_parser.py).
// Constructing millions of small Python dicts dominates that path.  This
// transformer parses each result ONCE in C++, keeps verbatim byte spans for
// every value it does not change (numbers are never reformatted), and emits
// the four store-bound values as ready JSON TEXT per per-alt row:
//
//   - adsp_most_severe_consequence: first consequence of the first
//     non-empty block in transcript -> regulatory -> motif -> intergenic
//     order for the row's LEFT-NORMALIZED allele ('-' when normalization
//     empties it);
//   - adsp_ranked_consequences: {"<ctype>_consequences": [ ... ]} with each
//     consequence object spliced verbatim plus appended
//     vep_consequence_order_num / rank / consequence_is_coding fields
//     (rank text comes from the Python-side table blob, so formatting is
//     bit-identical to the host ranker);
//   - allele_frequencies: the chosen colocated variant's frequencies for
//     the normalized allele, regrouped into GnomAD / 1000Genomes / ESP
//     buckets (vep_parser.py:235-254 semantics, incl. COSMIC filtering and
//     dbSNP refsnp disambiguation);
//   - vep_output: the result minus the extracted blocks, with the raw
//     "input" string replaced by its structured form
//     (vep_variant_loader.py:111-123, :279-281).
//
// Any anomaly — unknown combo (the host ranker's learn-on-miss path),
// escapes inside compared strings, malformed input line, non-digit
// position — flags the DOC for the Python fallback path; correctness never
// depends on this fast path.
//
// Build: g++ -O3 -shared -fPIC (see native/vep.py).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

// ---- tiny JSON scanner over a byte buffer (spans, no DOM) --------------

struct Cur {
    const char* s;
    int64_t i;
    int64_t n;
    bool ok = true;

    bool eof() const { return i >= n; }
    char peek() const { return s[i]; }
    void ws() {
        while (i < n) {
            char c = s[i];
            if (c == ' ' || c == '\t' || c == '\n' || c == '\r') ++i;
            else break;
        }
    }
};

struct Span {
    int64_t off = 0;
    int32_t len = 0;
};

// skip a JSON string (cursor at opening quote); returns false on error
bool skip_string(Cur& c) {
    if (c.eof() || c.s[c.i] != '"') return false;
    ++c.i;
    while (c.i < c.n) {
        char ch = c.s[c.i];
        if (ch == '\\') { c.i += 2; continue; }
        ++c.i;
        if (ch == '"') return true;
    }
    return false;
}

// skip any JSON value; records its span
bool skip_value(Cur& c, Span* span) {
    c.ws();
    int64_t start = c.i;
    if (c.eof()) return false;
    char ch = c.s[c.i];
    if (ch == '"') {
        if (!skip_string(c)) return false;
    } else if (ch == '{' || ch == '[') {
        char close = (ch == '{') ? '}' : ']';
        int depth = 0;
        while (c.i < c.n) {
            char d = c.s[c.i];
            if (d == '"') {
                if (!skip_string(c)) return false;
                continue;
            }
            if (d == '{' || d == '[') ++depth;
            else if (d == '}' || d == ']') {
                --depth;
                ++c.i;
                if (depth == 0) {
                    if (d != close) return false;
                    break;
                }
                continue;
            }
            ++c.i;
        }
        if (depth != 0) return false;
    } else {
        // number / true / false / null
        while (c.i < c.n) {
            char d = c.s[c.i];
            if (d == ',' || d == '}' || d == ']' || d == ' ' || d == '\t' ||
                d == '\n' || d == '\r')
                break;
            ++c.i;
        }
        if (c.i == start) return false;
    }
    if (span) {
        span->off = start;
        span->len = static_cast<int32_t>(c.i - start);
    }
    return true;
}

// parse a string value WITHOUT escapes: span excludes the quotes.  Returns
// false (fallback) when the string contains a backslash — compared strings
// (terms, alleles, ids) are plain in practice, and the Python path handles
// the exotic rest.
bool plain_string(Cur& c, Span* out) {
    c.ws();
    if (c.eof() || c.s[c.i] != '"') return false;
    int64_t start = ++c.i;
    while (c.i < c.n) {
        char ch = c.s[c.i];
        if (ch == '\\') return false;
        if (ch == '"') {
            out->off = start;
            out->len = static_cast<int32_t>(c.i - start);
            ++c.i;
            return true;
        }
        ++c.i;
    }
    return false;
}

// iterate object keys: call at '{'; each next() yields key span (no
// escapes; keys with escapes -> error) and leaves cursor at the value.
struct ObjIter {
    Cur& c;
    bool first = true;
    bool done = false;
    bool fail = false;

    explicit ObjIter(Cur& cur) : c(cur) {
        c.ws();
        if (c.eof() || c.s[c.i] != '{') { fail = true; return; }
        ++c.i;
    }
    // returns true with key set; false when object ended or failed
    bool next(Span* key) {
        if (fail || done) return false;
        c.ws();
        if (!c.eof() && c.s[c.i] == '}') { ++c.i; done = true; return false; }
        if (!first) {
            if (c.eof() || c.s[c.i] != ',') { fail = true; return false; }
            ++c.i;
            c.ws();
            if (!c.eof() && c.s[c.i] == '}') { ++c.i; done = true; return false; }
        }
        first = false;
        if (!plain_string(c, key)) { fail = true; return false; }
        c.ws();
        if (c.eof() || c.s[c.i] != ':') { fail = true; return false; }
        ++c.i;
        return true;
    }
};

struct ArrIter {
    Cur& c;
    bool first = true;
    bool done = false;
    bool fail = false;

    explicit ArrIter(Cur& cur) : c(cur) {
        c.ws();
        if (c.eof() || c.s[c.i] != '[') { fail = true; return; }
        ++c.i;
    }
    bool next() {  // leaves cursor at the element
        if (fail || done) return false;
        c.ws();
        if (!c.eof() && c.s[c.i] == ']') { ++c.i; done = true; return false; }
        if (!first) {
            if (c.eof() || c.s[c.i] != ',') { fail = true; return false; }
            ++c.i;
            c.ws();
            if (!c.eof() && c.s[c.i] == ']') { ++c.i; done = true; return false; }
        }
        first = false;
        return true;
    }
};

inline bool span_eq(const char* s, const Span& a, const char* lit) {
    size_t ln = std::strlen(lit);
    return a.len == static_cast<int32_t>(ln) && std::memcmp(s + a.off, lit, ln) == 0;
}

// ---- output arena -------------------------------------------------------

struct Arena {
    char* buf;
    int64_t cap;
    int64_t used = 0;
    bool overflow = false;

    int64_t mark() const { return used; }
    void put(const char* p, int64_t len) {
        if (used + len > cap) { overflow = true; return; }
        std::memcpy(buf + used, p, len);
        used += len;
    }
    void lit(const char* p) { put(p, static_cast<int64_t>(std::strlen(p))); }
    void ch(char c) {
        if (used + 1 > cap) { overflow = true; return; }
        buf[used++] = c;
    }
    // minimal JSON string emit for plain ASCII-ish text (fallback guards
    // already rejected strings containing '\\' or '"')
    void jstr(const char* p, int64_t len) {
        ch('"');
        put(p, len);
        ch('"');
    }
};

// ---- ranking table ------------------------------------------------------

struct RankEntry {
    std::string rank_json;  // spliced verbatim (Python-formatted)
    double sort_key;
    bool coding;
};

using RankTable = std::unordered_map<std::string, RankEntry>;

// blob: lines of canon \x1F rank_json \x1F sort_key \x1F coding(0/1)
RankTable parse_table(const char* blob, int64_t len) {
    RankTable t;
    int64_t i = 0;
    while (i < len) {
        int64_t j = i;
        while (j < len && blob[j] != '\n') ++j;
        // split on \x1F
        const char* line = blob + i;
        int64_t ll = j - i;
        int64_t p1 = -1, p2 = -1, p3 = -1;
        for (int64_t k = 0; k < ll; ++k) {
            if (line[k] == '\x1F') {
                if (p1 < 0) p1 = k;
                else if (p2 < 0) p2 = k;
                else { p3 = k; break; }
            }
        }
        if (p1 > 0 && p2 > p1 && p3 > p2) {
            RankEntry e;
            e.rank_json.assign(line + p1 + 1, p2 - p1 - 1);
            e.sort_key = std::strtod(std::string(line + p2 + 1, p3 - p2 - 1).c_str(), nullptr);
            e.coding = (p3 + 1 < ll) && line[p3 + 1] == '1';
            t.emplace(std::string(line, p1), std::move(e));
        }
        i = j + 1;
    }
    return t;
}

// ---- per-doc structures -------------------------------------------------

struct Conseq {
    Span obj;          // the whole original {...}
    Span allele;       // variant_allele value
    const RankEntry* rank = nullptr;
    int32_t order = 0;
};

constexpr int N_CTYPES = 4;
const char* CTYPE_KEYS[N_CTYPES] = {
    "transcript_consequences", "regulatory_feature_consequences",
    "motif_feature_consequences", "intergenic_consequences",
};

struct Doc {
    Span input_str;                       // raw escaped content of "input"
    std::vector<Conseq> conseqs[N_CTYPES];
    bool has_ctype[N_CTYPES] = {false, false, false, false};
    Span freq_obj;                        // chosen covar's "frequencies"
    // kept top-level keys for cleaned vep_output, in original order
    std::vector<std::pair<Span, Span>> kept;   // (key, value span)
    int64_t input_key_index = -1;              // position of "input" in kept order
    // colocated-variant scratch (parse_doc); lives here so one Doc reused
    // across a whole transform call keeps every vector's capacity
    std::vector<Span> covar_freqs;
    std::vector<Span> covar_ids;
    std::vector<Span> covar_alleles;

    // clear per doc, retaining heap capacity (per-doc construction cost
    // ~10 allocations/frees at millions of docs)
    void reset() {
        input_str = Span{};
        for (int t = 0; t < N_CTYPES; ++t) {
            conseqs[t].clear();
            has_ctype[t] = false;
        }
        freq_obj = Span{};
        kept.clear();
        input_key_index = -1;
        covar_freqs.clear();
        covar_ids.clear();
        covar_alleles.clear();
    }
};

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

// per-transform memo: raw bytes of a "consequence_terms" array -> rank
// entry (nullptr = known-novel combo).  Real VEP files repeat a few dozen
// distinct combos across millions of consequences; caching on the RAW
// span skips per-conseq term parsing, canonical sort/join allocations and
// the hash-map lookup.  Spans index the call's text, so the cache lives
// for exactly one transform call.
struct ComboCache {
    struct E {
        uint32_t h;
        Span raw;
        const RankEntry* entry;
    };
    std::vector<E> entries;
};

inline uint32_t span_fnv(const char* s, const Span& sp) {
    uint32_t h = 2166136261u;
    for (int32_t k = 0; k < sp.len; ++k)
        h = (h ^ static_cast<uint8_t>(s[sp.off + k])) * 16777619u;
    return h;
}

// resolve one raw consequence_terms span to its rank entry via the cache;
// *ok=false on malformed JSON inside the span
const RankEntry* resolve_combo(const char* s, Span raw,
                               const RankTable& table, ComboCache* cache,
                               bool* ok) {
    *ok = true;
    uint32_t h = span_fnv(s, raw);
    for (const ComboCache::E& e : cache->entries)
        if (e.h == h && e.raw.len == raw.len
            && std::memcmp(s + e.raw.off, s + raw.off, raw.len) == 0)
            return e.entry;
    // slow path (once per distinct combo): parse, canonize, look up
    Cur tc{s, raw.off, raw.off + raw.len};
    ArrIter ta(tc);
    if (ta.fail) { *ok = false; return nullptr; }
    std::vector<std::string> tv;
    while (ta.next()) {
        Span t;
        if (!plain_string(tc, &t)) { *ok = false; return nullptr; }
        tv.emplace_back(s + t.off, t.len);
    }
    if (ta.fail) { *ok = false; return nullptr; }
    std::sort(tv.begin(), tv.end());
    std::string canon;
    for (size_t k = 0; k < tv.size(); ++k) {
        if (k) canon.push_back(',');
        canon += tv[k];
    }
    auto it = table.find(canon);
    const RankEntry* entry = it == table.end() ? nullptr : &it->second;
    if (cache->entries.size() < 4096)
        cache->entries.push_back({h, raw, entry});
    return entry;
}

// parse the 4 consequence-block arrays + colocated + kept keys of one doc
bool parse_doc(Cur& c, const RankTable& table, bool is_dbsnp, Doc* d,
               Span id_for_match, ComboCache* combos) {
    ObjIter top(c);
    if (top.fail) return false;
    Span key;
    // colocated candidates: reference keeps the LAST covar with
    // frequencies (matching the id when is_dbsnp and the id is an rs);
    // scratch vectors live on the Doc (capacity reuse across docs)
    std::vector<Span>& covar_freqs = d->covar_freqs;
    std::vector<Span>& covar_ids = d->covar_ids;
    std::vector<Span>& covar_alleles = d->covar_alleles;
    bool saw_coloc = false;
    int64_t n_covars = 0;

    while (top.next(&key)) {
        int ctype = -1;
        for (int t = 0; t < N_CTYPES; ++t)
            if (span_eq(c.s, key, CTYPE_KEYS[t])) { ctype = t; break; }
        if (ctype >= 0) {
            d->has_ctype[ctype] = true;
            ArrIter arr(c);
            if (arr.fail) return false;
            int32_t order = 0;
            while (arr.next()) {
                Conseq q;
                int64_t el_start;
                {
                    c.ws();
                    el_start = c.i;
                }
                // walk the element object to find terms + allele
                ObjIter el(c);
                if (el.fail) return false;
                Span ekey;
                Span terms_raw{};
                bool have_terms = false, have_allele = false;
                while (el.next(&ekey)) {
                    if (span_eq(c.s, ekey, "consequence_terms")) {
                        // raw span only; the combo cache resolves it (and
                        // parses term-wise just once per distinct combo)
                        if (!skip_value(c, &terms_raw)) return false;
                        have_terms = true;
                    } else if (span_eq(c.s, ekey, "variant_allele")) {
                        if (!plain_string(c, &q.allele)) return false;
                        have_allele = true;
                    } else {
                        if (!skip_value(c, nullptr)) return false;
                    }
                }
                if (el.fail || !have_terms || !have_allele) return false;
                q.obj.off = el_start;
                q.obj.len = static_cast<int32_t>(c.i - el_start);
                q.order = order++;
                bool combo_ok;
                q.rank = resolve_combo(c.s, terms_raw, table, combos,
                                       &combo_ok);
                if (!combo_ok) return false;       // malformed terms array
                if (q.rank == nullptr) return false;  // novel combo -> host
                d->conseqs[ctype].push_back(q);
            }
            if (arr.fail) return false;
        } else if (span_eq(c.s, key, "colocated_variants")) {
            saw_coloc = true;
            ArrIter arr(c);
            if (arr.fail) return false;
            while (arr.next()) {
                ++n_covars;
                ObjIter cv(c);
                if (cv.fail) return false;
                Span ckey, freq{}, cid{}, callele{};
                while (cv.next(&ckey)) {
                    if (span_eq(c.s, ckey, "frequencies")) {
                        if (!skip_value(c, &freq)) return false;
                    } else if (span_eq(c.s, ckey, "id")) {
                        if (!plain_string(c, &cid)) return false;
                    } else if (span_eq(c.s, ckey, "allele_string")) {
                        if (!plain_string(c, &callele)) return false;
                    } else {
                        if (!skip_value(c, nullptr)) return false;
                    }
                }
                if (cv.fail) return false;
                covar_freqs.push_back(freq);
                covar_ids.push_back(cid);
                covar_alleles.push_back(callele);
            }
            if (arr.fail) return false;
        } else if (span_eq(c.s, key, "input")) {
            c.ws();
            if (c.eof() || c.s[c.i] != '"') return false;  // pre-parsed dict
            int64_t start = c.i + 1;
            if (!skip_string(c)) return false;
            d->input_str.off = start;
            d->input_str.len = static_cast<int32_t>(c.i - 1 - start);
            d->input_key_index = static_cast<int64_t>(d->kept.size());
            d->kept.emplace_back(key, Span{});  // value filled structurally
        } else {
            Span val;
            if (!skip_value(c, &val)) return false;
            d->kept.emplace_back(key, val);
        }
    }
    if (top.fail) return false;

    // frequency selection (vep_parser.py:164-184)
    if (saw_coloc && n_covars > 0) {
        if (n_covars == 1) {
            if (covar_freqs[0].len) d->freq_obj = covar_freqs[0];
        } else {
            for (int64_t k = 0; k < n_covars; ++k) {
                if (covar_alleles[k].len &&
                    span_eq(c.s, covar_alleles[k], "COSMIC_MUTATION"))
                    continue;
                if (!covar_freqs[k].len) continue;
                if (is_dbsnp && id_for_match.len) {
                    if (covar_ids[k].len == id_for_match.len &&
                        std::memcmp(c.s + covar_ids[k].off,
                                    c.s + id_for_match.off,
                                    id_for_match.len) == 0)
                        d->freq_obj = covar_freqs[k];
                } else {
                    d->freq_obj = covar_freqs[k];
                }
            }
        }
    }
    return true;
}

// emit one conseq with the appended rank fields
void emit_conseq(Arena& a, const char* s, const Conseq& q) {
    // original object text minus the closing '}'
    a.put(s + q.obj.off, q.obj.len - 1);
    // empty object "{}" cannot happen (terms+allele required)
    char tmp[64];
    int n = std::snprintf(tmp, sizeof(tmp),
                          ",\"vep_consequence_order_num\":%d,\"rank\":",
                          q.order);
    a.put(tmp, n);
    a.put(q.rank->rank_json.data(),
          static_cast<int64_t>(q.rank->rank_json.size()));
    a.lit(",\"consequence_is_coding\":");
    a.lit(q.rank->coding ? "true" : "false");
    a.ch('}');
}

// group one frequencies VALUE object (for a single allele) into
// GnomAD / 1000Genomes / ESP buckets (vep_parser.py:196-221)
bool emit_grouped_freq(Arena& a, const char* s, Span values) {
    // collect (key, value) pairs
    Cur c{s, values.off, values.off + values.len};
    ObjIter obj(c);
    if (obj.fail) return false;
    Span key;
    std::vector<std::pair<Span, Span>> gnomad, esp, genomes;
    while (obj.next(&key)) {
        Span val;
        if (!skip_value(c, &val)) return false;
        bool has_gnomad = false;
        for (int32_t k = 0; k + 6 <= key.len; ++k)
            if (std::memcmp(s + key.off + k, "gnomad", 6) == 0) {
                has_gnomad = true;
                break;
            }
        if (has_gnomad)
            gnomad.emplace_back(key, val);
        else if (span_eq(s, key, "aa") || span_eq(s, key, "ea"))
            esp.emplace_back(key, val);
        else
            genomes.emplace_back(key, val);
    }
    if (obj.fail) return false;
    if (gnomad.empty() && esp.empty() && genomes.empty()) return false;
    a.ch('{');
    bool first_bucket = true;
    auto bucket = [&](const char* name,
                      const std::vector<std::pair<Span, Span>>& kv) {
        if (kv.empty()) return;
        if (!first_bucket) a.ch(',');
        first_bucket = false;
        a.ch('"');
        a.lit(name);
        a.lit("\":{");
        for (size_t k = 0; k < kv.size(); ++k) {
            if (k) a.ch(',');
            a.jstr(s + kv[k].first.off, kv[k].first.len);
            a.ch(':');
            a.put(s + kv[k].second.off, kv[k].second.len);
        }
        a.ch('}');
    };
    // bucket order matches the reference dict-build order
    bucket("GnomAD", gnomad);
    bucket("1000Genomes", genomes);
    bucket("ESP", esp);
    a.ch('}');
    return true;
}

}  // namespace

extern "C" {

// returns: 0 ok, 1 rows overflow, 2 arena overflow, -1 hard error.
// Lines are '\n'-separated JSON docs in text[0..n_bytes).
int64_t avdb_vep_transform(
    const char* text, int64_t n_bytes,
    const char* table_blob, int64_t table_len,
    int32_t is_dbsnp, int32_t width,
    int64_t rows_cap,
    int32_t* doc_of_row, int8_t* chrom_out, int32_t* pos_out,
    uint8_t* ref_mat, uint8_t* alt_mat, int32_t* ref_len, int32_t* alt_len,
    int64_t* ref_off, int32_t* ref_slen,
    int64_t* alt_off, int32_t* alt_slen,
    uint8_t* is_multi,
    // identity hash per row (uint32 FNV-1a; see fnv comment at the emit
    // site) + over-width flag (allele longer than the matrix width)
    uint32_t* hash_out, uint8_t* host_fb,
    int64_t* ms_off, int32_t* ms_len,
    int64_t* rk_off, int32_t* rk_len,
    int64_t* fq_off, int32_t* fq_len,
    int64_t* vo_off, int32_t* vo_len,
    int64_t docs_cap, uint8_t* doc_fallback, int32_t* doc_skipped,
    // byte offset of each doc's line within `text` (fallback docs re-parse
    // from here; a restart re-transforms from a doc's offset)
    int64_t* doc_off,
    char* arena_buf, int64_t arena_cap,
    int64_t* out_rows, int64_t* out_docs, int64_t* arena_used) {
    RankTable table = parse_table(table_blob, table_len);
    Arena arena{arena_buf, arena_cap};
    int64_t rows = 0;
    int64_t docs = 0;
    int64_t li = 0;

    // prime^k table for zero-pad folding in the identity hash (pad bytes
    // are zeros: x ^ 0 == x, so each contributes one multiply)
    uint32_t primepow[4096];
    int pp_n = width + 1 <= 4096 ? width + 1 : 4096;
    primepow[0] = 1u;
    for (int k = 1; k < pp_n; ++k) primepow[k] = primepow[k - 1] * 16777619u;

    ComboCache combos;  // per-call: spans reference this call's text
    Doc d;              // reused across docs (reset() keeps capacities)
    std::vector<const Conseq*> mine;  // per-(row,ctype) scratch

    while (li < n_bytes) {
        int64_t le = li;
        while (le < n_bytes && text[le] != '\n') ++le;
        // skip blank lines
        bool blank = true;
        for (int64_t k = li; k < le; ++k)
            if (text[k] != ' ' && text[k] != '\t' && text[k] != '\r') {
                blank = false;
                break;
            }
        if (blank) {
            li = le + 1;
            continue;
        }
        if (docs >= docs_cap) return 1;
        int64_t doc_idx = docs++;
        doc_fallback[doc_idx] = 0;
        doc_off[doc_idx] = li;
        doc_skipped[doc_idx] = 0;
        int64_t row_mark = rows;
        int64_t arena_mark = arena.mark();

        Cur c{text, li, le};
        d.reset();
        // the id field of the parsed input line feeds dbSNP freq matching;
        // parse input FIRST via a pre-scan?  The doc object may put
        // "input" after colocated_variants; two-pass: first locate input.
        Span input_span{};
        {
            Cur c0{text, li, le};
            ObjIter t0(c0);
            Span k0;
            while (t0.next(&k0)) {
                if (span_eq(text, k0, "input")) {
                    c0.ws();
                    if (c0.eof() || text[c0.i] != '"') break;
                    int64_t start = c0.i + 1;
                    if (!skip_string(c0)) break;
                    input_span.off = start;
                    input_span.len = static_cast<int32_t>(c0.i - 1 - start);
                    break;
                }
                if (!skip_value(c0, nullptr)) break;
            }
        }
        bool ok = input_span.len > 0;
        // split the (escaped) input on literal "\t" escape pairs; any other
        // escape inside -> fallback
        Span fields[8];
        int nf = 0;
        if (ok) {
            int64_t fs = input_span.off;
            int64_t end = input_span.off + input_span.len;
            for (int64_t k = input_span.off; k + 1 <= end && nf < 8; ++k) {
                if (k < end && text[k] == '\\') {
                    if (k + 1 < end && text[k + 1] == 't') {
                        fields[nf].off = fs;
                        fields[nf].len = static_cast<int32_t>(k - fs);
                        ++nf;
                        fs = k + 2;
                        ++k;
                    } else if (k + 1 < end && text[k + 1] == 'n' && k + 2 >= end) {
                        // trailing \n escape: rstrip('\n') semantics
                        break;
                    } else {
                        ok = false;
                        break;
                    }
                }
            }
            if (ok && nf < 8) {
                int64_t end2 = end;
                // trailing literal "\n" escape already handled; strip it
                if (end2 - fs >= 2 && text[end2 - 2] == '\\' &&
                    text[end2 - 1] == 'n')
                    end2 -= 2;
                fields[nf].off = fs;
                fields[nf].len = static_cast<int32_t>(end2 - fs);
                ++nf;
            }
            if (nf < 5) ok = false;
        }
        int8_t code = 0;
        long pos_val = 0;
        if (ok) {
            code = chrom_code(text + fields[0].off, fields[0].len);
            // position must be plain digits for the verbatim splice, and
            // must fit int32 — an overflowing value here would silently
            // wrap where the Python path raises, so such docs take the
            // fallback (explicit-failure parity)
            if (fields[1].len == 0) ok = false;
            for (int32_t k = 0; ok && k < fields[1].len; ++k) {
                char pc = text[fields[1].off + k];
                if (pc < '0' || pc > '9') ok = false;
                else if (pos_val > (INT64_C(0x7fffffff) - (pc - '0')) / 10)
                    ok = false;  // exact int32 bound
                else pos_val = pos_val * 10 + (pc - '0');
            }
        }
        if (ok)
            ok = parse_doc(c, table, is_dbsnp != 0, &d,
                           // rs-id matching only when the id looks like rs...
                           (fields[2].len >= 2 && text[fields[2].off] == 'r' &&
                            text[fields[2].off + 1] == 's')
                               ? fields[2]
                               : Span{},
                           &combos);
        if (!ok) {
            doc_fallback[doc_idx] = 1;
            rows = row_mark;
            arena.used = arena_mark;
            li = le + 1;
            continue;
        }
        if (code == 0) {
            // non-standard contig: skipped (counted by Python from
            // doc_fallback==2 markers)
            doc_fallback[doc_idx] = 2;
            li = le + 1;
            continue;
        }

        // ---- emit the doc-shared cleaned vep_output text
        int64_t vo_start = arena.mark();
        arena.ch('{');
        for (size_t k = 0; k < d.kept.size(); ++k) {
            if (k) arena.ch(',');
            arena.jstr(text + d.kept[k].first.off, d.kept[k].first.len);
            arena.ch(':');
            if (static_cast<int64_t>(k) == d.input_key_index) {
                arena.lit("{\"chrom\":");
                arena.jstr(text + fields[0].off, fields[0].len);
                arena.lit(",\"pos\":");
                arena.put(text + fields[1].off, fields[1].len);
                arena.lit(",\"id\":");
                arena.jstr(text + fields[2].off, fields[2].len);
                arena.lit(",\"ref\":");
                arena.jstr(text + fields[3].off, fields[3].len);
                arena.lit(",\"alt\":");
                arena.jstr(text + fields[4].off, fields[4].len);
                arena.ch('}');
            } else {
                arena.put(text + d.kept[k].second.off, d.kept[k].second.len);
            }
        }
        arena.ch('}');
        int64_t vo_end = arena.mark();

        // sort each ctype's conseqs per allele lazily at emit time; first
        // group them: (allele span) -> indices, preserving insert order
        // (few alleles per doc; linear scans are fine)

        // ---- per-alt rows: split ALT column on ','
        Span altcol = fields[4];
        int64_t as = altcol.off;
        int64_t aend = altcol.off + altcol.len;
        // count usable alts for is_multi
        int total_alts = 0, usable_alts = 0;
        {
            int64_t x = as;
            while (x <= aend) {
                int64_t y = x;
                while (y < aend && text[y] != ',') ++y;
                ++total_alts;
                if (!(y - x == 1 && text[x] == '.')) ++usable_alts;
                x = y + 1;
                if (y >= aend) break;
            }
        }
        uint8_t multi = usable_alts > 1 ? 1 : 0;

        int64_t x = as;
        // pos_val parsed (and int32-bounded) during validation above
        while (x <= aend) {
            int64_t y = x;
            while (y < aend && text[y] != ',') ++y;
            int32_t alen_s = static_cast<int32_t>(y - x);
            if (alen_s == 1 && text[x] == '.') {
                ++doc_skipped[doc_idx];
                x = y + 1;
                if (y >= aend) break;
                continue;
            }
            if (rows >= rows_cap) return 1;
            int64_t r = rows++;
            doc_of_row[r] = static_cast<int32_t>(doc_idx);
            chrom_out[r] = code;
            pos_out[r] = static_cast<int32_t>(pos_val);
            // identity columns: fixed-width byte matrices + true lengths
            const char* rs = text + fields[3].off;
            int32_t rl = fields[3].len;
            ref_len[r] = rl;
            alt_len[r] = alen_s;
            ref_off[r] = fields[3].off;
            ref_slen[r] = rl;
            alt_off[r] = x;
            alt_slen[r] = alen_s;
            is_multi[r] = multi;
            uint8_t* rrow = ref_mat + r * width;
            uint8_t* arow = alt_mat + r * width;
            std::memset(rrow, 0, width);
            std::memset(arow, 0, width);
            std::memcpy(rrow, rs, std::min<int32_t>(rl, width));
            std::memcpy(arow, text + x, std::min<int32_t>(alen_s, width));

            // identity hash, FNV-1a over (rl&0xFF, al&0xFF, bytes...):
            // width-bounded rows mirror ops/hashing.py::allele_hash over
            // the padded matrices (zero pads fold to prime powers);
            // over-width rows mirror the loaders' _fnv32_str full-string
            // host re-hash and are flagged host_fb — this is exactly the
            // hash the Python path would compute, so no device round trip
            // (or per-row re-hash) remains on the apply side
            {
                const uint32_t prime = 16777619u;
                bool over = rl > width || alen_s > width;
                host_fb[r] = over ? 1 : 0;
                uint32_t h = 2166136261u;
                h = (h ^ static_cast<uint32_t>(rl & 0xFF)) * prime;
                h = (h ^ static_cast<uint32_t>(alen_s & 0xFF)) * prime;
                if (over) {
                    for (int32_t i2 = 0; i2 < rl; ++i2)
                        h = (h ^ static_cast<uint8_t>(rs[i2])) * prime;
                    for (int32_t i2 = 0; i2 < alen_s; ++i2)
                        h = (h ^ static_cast<uint8_t>(text[x + i2])) * prime;
                } else {
                    for (int32_t i2 = 0; i2 < rl; ++i2)
                        h = (h ^ static_cast<uint8_t>(rs[i2])) * prime;
                    int pad = width - rl;
                    while (pad >= pp_n) {
                        h *= primepow[pp_n - 1];
                        pad -= pp_n - 1;
                    }
                    h *= primepow[pad];
                    for (int32_t i2 = 0; i2 < alen_s; ++i2)
                        h = (h ^ static_cast<uint8_t>(text[x + i2])) * prime;
                    pad = width - alen_s;
                    while (pad >= pp_n) {
                        h *= primepow[pp_n - 1];
                        pad -= pp_n - 1;
                    }
                    h *= primepow[pad];
                }
                hash_out[r] = h;
            }

            // ---- left-normalize: shared prefix of ref vs THIS alt
            int32_t p = 0;
            if (!(rl == 1 && alen_s == 1)) {  // SNVs untouched
                int32_t lim = std::min(rl, alen_s);
                while (p < lim && rs[p] == text[x + p]) ++p;
            }
            // normalized allele string ('-' when emptied)
            const char* norm = text + x + p;
            int32_t norm_len = alen_s - p;
            const char* dash = "-";
            if (norm_len == 0) {
                norm = dash;
                norm_len = 1;
            }

            // ---- ranked consequences + most-severe for this allele
            int64_t rk_start = arena.mark();
            bool any_ct = false;
            const Conseq* best = nullptr;
            arena.ch('{');
            for (int t = 0; t < N_CTYPES; ++t) {
                // collect this allele's conseqs, sorted by (rank, order)
                mine.clear();
                for (const Conseq& q : d.conseqs[t]) {
                    if (q.allele.len == norm_len &&
                        std::memcmp(text + q.allele.off, norm, norm_len) == 0)
                        mine.push_back(&q);
                }
                if (mine.empty()) continue;
                std::stable_sort(mine.begin(), mine.end(),
                                 [](const Conseq* a, const Conseq* b) {
                                     if (a->rank->sort_key != b->rank->sort_key)
                                         return a->rank->sort_key < b->rank->sort_key;
                                     return a->order < b->order;
                                 });
                if (!best) best = mine[0];
                if (any_ct) arena.ch(',');
                any_ct = true;
                arena.ch('"');
                arena.lit(CTYPE_KEYS[t]);
                arena.lit("\":[");
                for (size_t k = 0; k < mine.size(); ++k) {
                    if (k) arena.ch(',');
                    emit_conseq(arena, text, *mine[k]);
                }
                arena.ch(']');
            }
            arena.ch('}');
            if (any_ct) {
                rk_off[r] = rk_start;
                rk_len[r] = static_cast<int32_t>(arena.mark() - rk_start);
            } else {
                arena.used = rk_start;  // roll back the empty "{}"
                rk_off[r] = 0;
                rk_len[r] = 0;
            }
            if (best) {
                int64_t m0 = arena.mark();
                emit_conseq(arena, text, *best);
                ms_off[r] = m0;
                ms_len[r] = static_cast<int32_t>(arena.mark() - m0);
            } else {
                ms_off[r] = 0;
                ms_len[r] = 0;
            }

            // ---- frequencies for this allele
            fq_off[r] = 0;
            fq_len[r] = 0;
            if (d.freq_obj.len) {
                // find norm allele key in the chosen frequencies object
                Cur fc{text, d.freq_obj.off, d.freq_obj.off + d.freq_obj.len};
                ObjIter fo(fc);
                Span fkey;
                bool emitted = false;
                while (!emitted && fo.next(&fkey)) {
                    Span val;
                    if (!skip_value(fc, &val)) { doc_fallback[doc_idx] = 1; break; }
                    if (fkey.len == norm_len &&
                        std::memcmp(text + fkey.off, norm, norm_len) == 0) {
                        int64_t f0 = arena.mark();
                        if (emit_grouped_freq(arena, text, val)) {
                            fq_off[r] = f0;
                            fq_len[r] = static_cast<int32_t>(arena.mark() - f0);
                        } else {
                            arena.used = f0;  // empty/failed -> no freq
                        }
                        emitted = true;
                    }
                }
                if (fo.fail) doc_fallback[doc_idx] = 1;
            }
            vo_off[r] = vo_start;
            vo_len[r] = static_cast<int32_t>(vo_end - vo_start);

            x = y + 1;
            if (y >= aend) break;
        }
        if (doc_fallback[doc_idx] == 1) {
            // a late anomaly: drop this doc's rows AND its counter
            // contributions (the Python re-run counts them afresh)
            rows = row_mark;
            arena.used = arena_mark;
            doc_skipped[doc_idx] = 0;
        }
        if (arena.overflow) return 2;
        li = le + 1;
    }
    *out_rows = rows;
    *out_docs = docs;
    *arena_used = arena.used;
    return 0;
}

}  // extern "C"
