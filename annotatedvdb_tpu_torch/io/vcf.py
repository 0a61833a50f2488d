"""Host-side VCF ingest: text chunks -> VariantBatch + per-row sidecar.

Copy of ``annotatedvdb_tpu/io/vcf.py``: both engines (the native C++
tokenizer of ``native/`` by default, the Python tokenizer under
``AVDB_INGEST_ENGINE=python``), the zero-copy FREQ sidecar
(:func:`freq_sidecar`) and the prefetch spine (:meth:`iter_prefetched`).
Chunk boundaries depend on the engine (the native scanner also ends a
chunk at each read window), so a store written by either package equals
the other's byte for byte when both read with the same engine and batch
size.

Replaces the reference's per-line ``VcfEntryParser``
(``Util/lib/python/parsers/vcf_parser.py:76-231``) with a batch reader that
emits fixed-size ``VariantBatch`` arrays for the device pipeline plus a
host-side sidecar (refsnp ids, FREQ-field frequencies, INFO access) for the
egress path.  Behavioral parity notes:

- multi-allelic entries expand to one row per alt allele; '.' alts are
  skipped with a counter (``vcf_variant_loader.py:280-284``);
- chromosome 'chr' prefixes are stripped and 'MT' folds to 'M'
  (``vcf_parser.py:135-137``); an optional accession map translates RefSeq
  ids (``parsers/chromosome_map_parser.py``);
- refsnp comes from the ID column when it is an rs id, else from INFO ``RS``
  (``vcf_parser.py:158-169``);
- the variant id is the ID column unless '.'/rs, in which case it is the
  full metaseq-style id (``vcf_parser.py:140-142``);
- INFO ``FREQ=source:f1,f2|...`` per-population frequencies are matched to
  each alt by index offset 1, zero/'.' entries dropped
  (``vcf_parser.py:200-222``);
- INFO strings scrub the ``\\x2c``/``\\x59``/'#' escapes that break JSON and
  the '#' COPY delimiter (``vcf_parser.py:101-104``).
"""

from __future__ import annotations

import gzip
import io
import json
import math
import re
from dataclasses import dataclass, field
from typing import Iterator

import numpy as np

from annotatedvdb_tpu_torch.types import VariantBatch, chromosome_code
from annotatedvdb_tpu_torch.utils.strings import to_numeric


def rs_number(ref_snp) -> int:
    """'rs<digits>' -> the number, else -1.

    Strict ASCII digits only (``isdigit`` would admit e.g. '¹²' and
    ``int()`` admits '1_2'/'+12'), matching the native tokenizer's
    ``rs_number_of`` byte scan exactly so both engines store identical
    ref_snp columns."""
    s = str(ref_snp) if ref_snp else ""
    if not s.startswith("rs") or len(s) < 3:
        return -1
    v = 0
    for c in s[2:]:
        if c < "0" or c > "9":
            return -1
        # pre-multiply int64 bound, the same test the C++ twin applies
        # ((INT64_MAX - 9) / 10): ids within 8 of INT64_MAX are rejected by
        # BOTH engines rather than accepted here and rejected there
        if v > 922337203685477579:  # 'weird' (PK keeps the verbatim string)
            return -1
        v = v * 10 + ord(c) - 48
    return v


def rs_is_weird(ref_snp, rs_num: int) -> bool:
    """True when a refsnp STRING exists but does not round-trip through its
    parsed number — unparsable ids and zero-padded ids ('rs0042' prints
    back as 'rs42').  Primary keys for such rows must use the string.
    Shared by the Python reader and the loaders' chunk fallback; mirrored
    byte-for-byte by the native tokenizer's rs_number_of."""
    if ref_snp is None:
        return False
    s = str(ref_snp)
    return rs_num < 0 or (s.startswith("rs0") and len(s) > 3)


def _open_text(path: str):
    if path.endswith(".gz"):
        return io.TextIOWrapper(gzip.open(path, "rb"), encoding="utf-8")
    return open(path, "r", encoding="utf-8")


def parse_info(info_str: str) -> dict:
    """INFO field -> dict with numeric coercion and escape scrubbing."""
    s = info_str.replace("\\x2c", ",").replace("\\x59", "/").replace("#", ":")
    out = {}
    for item in s.split(";"):
        if "=" in item:
            k, v = item.split("=", 1)
            out[k] = to_numeric(v)
        elif item:
            out[item] = True
    return out


def parse_freq(info: dict, n_alts: int) -> list:
    """Per-alt frequency dicts from the FREQ INFO field; None when absent/zero."""
    raw = info.get("FREQ")
    if raw is None:
        return [None] * n_alts
    pops = {}
    for pop in str(raw).split("|"):
        if ":" in pop:
            name, freqs = pop.split(":", 1)
            pops[name] = freqs.split(",")
    out = []
    for alt_index in range(1, n_alts + 1):
        freqs = {}
        for name, values in pops.items():
            if alt_index < len(values) and values[alt_index] not in (".", "0"):
                freqs[name] = {"gmaf": to_numeric(values[alt_index])}
        out.append(freqs or None)
    return out


# \Z anchors, not $: '$' also matches before a trailing newline
_INT_RE = re.compile(r"[+-]?\d+\Z", re.ASCII)
_FLOAT_RE = re.compile(
    r"[+-]?(?:\d+\.?\d*|\.\d+)(?:[eE][+-]?\d+)?\Z", re.ASCII
)
# safe to splice into JSON between quotes verbatim; must not LOOK numeric
# (int()/float() accept whitespace padding, underscores, inf/nan forms:
# anything of this charset not screened above takes the exact to_numeric
# fallback)
_SAFE_STR_RE = re.compile(r'[A-Za-z_][A-Za-z0-9_:,./|\-]*\Z', re.ASCII)
# the only alpha tokens float() accepts (unsigned; signed forms fail the
# leading-alpha screen): these take the exact fallback so the allow_nan
# abort fires
_FLOAT_WORDS = frozenset(("inf", "infinity", "nan"))
# population-name charset whose json.dumps rendering is the name verbatim
# between quotes (printable ASCII, no '"'/'\\', nothing ensure_ascii would
# escape); anything else takes the exact json.dumps fallback
_FREQ_KEY_RE = re.compile(r"[A-Za-z0-9 _.,:/|\-]+\Z", re.ASCII)


def info_to_json(info_str: str) -> str:
    """INFO field -> the JSON text of ``parse_info``'s dict, in one pass.

    Regex-screened int/float/safe-string tokens splice verbatim; anything
    else falls back to ``to_numeric`` + ``json.dumps``.  The text equals
    ``json.dumps(parse_info(s), separators=(",", ":"))``: compact
    separators, unlike the Python engine's ``json.dumps`` of the dict.

    Raises ValueError on Infinity/NaN values (the QC update's abort).
    Repeated keys de-duplicate last-wins at the first key's position, as
    the dict does; an overwritten non-finite value does not abort."""
    s = info_str.replace("\\x2c", ",").replace("\\x59", "/").replace("#", ":")
    items: dict[str, str | None] = {}  # None = bare flag (-> true)
    for item in s.split(";"):
        eq = item.find("=")
        if eq < 0:
            if item:
                items[item] = None
        else:
            items[item[:eq]] = item[eq + 1:]
    parts = []
    for k, v in items.items():
        key = f'"{k}"' if _SAFE_STR_RE.match(k) else json.dumps(k)
        if v is None:
            parts.append(f"{key}:true")
        elif _INT_RE.match(v):
            parts.append(f"{key}:{int(v)}")
        elif _FLOAT_RE.match(v) and math.isfinite(fv := float(v)):
            # isfinite: '1e400' overflows to inf, which must take the
            # aborting fallback
            parts.append(f"{key}:{fv!r}")
        elif _SAFE_STR_RE.match(v) and v.lower() not in _FLOAT_WORDS:
            parts.append(f'{key}:"{v}"')
        else:
            parts.append(
                f"{key}:{json.dumps(to_numeric(v), allow_nan=False)}"
            )
    return "{" + ",".join(parts) + "}"


def freq_sidecar(info_str: str, n_alts: int) -> list:
    """Per-alt FREQ sidecar as stored-JSONB text, straight from the raw
    INFO span (the native engine's frequencies column).

    Returns a list of ``RawJson``/None, one per alt, where each text is
    byte-identical to ``json.dumps(parse_freq(parse_info(info_str), n)[i])``
    — the bytes ``store.variant_store.sidecar_line`` writes for the dict.
    The segment writer splices these verbatim, so FREQ never round-trips
    through a Python dict per row.  Only the FREQ token is extracted (the
    last one wins, as in a dict)."""
    from annotatedvdb_tpu_torch.store.variant_store import RawJson

    s = info_str.replace("\\x2c", ",").replace("\\x59", "/").replace("#", ":")
    raw = None
    for item in s.split(";"):
        if item.startswith("FREQ="):
            raw = item[5:]
    if raw is None:
        return [None] * n_alts
    pops = {}
    for pop in raw.split("|"):
        if ":" in pop:
            name, freqs = pop.split(":", 1)
            pops[name] = freqs.split(",")
    if not pops:
        return [None] * n_alts
    keys = {
        name: (f'"{name}"' if _FREQ_KEY_RE.match(name)
               else json.dumps(name))
        for name in pops
    }
    out = []
    for alt_index in range(1, n_alts + 1):
        parts = []
        for name, values in pops.items():
            if alt_index < len(values) and values[alt_index] not in (".", "0"):
                v = values[alt_index]
                if _INT_RE.match(v):
                    val = str(int(v))
                elif _FLOAT_RE.match(v) and math.isfinite(fv := float(v)):
                    # repr IS json.dumps' float rendering; overflow
                    # ('1e400') takes the fallback, which writes Infinity
                    # exactly like the dict path
                    val = repr(fv)
                else:
                    val = json.dumps(to_numeric(v))
                parts.append(f'{keys[name]}: {{"gmaf": {val}}}')
        out.append(RawJson("{" + ", ".join(parts) + "}") if parts else None)
    return out


@dataclass
class VcfChunk:
    """One ingest batch: device arrays + host sidecar (aligned by row).

    ``refs``/``alts`` hold the ORIGINAL allele strings — the device arrays
    truncate at the batch width, so all host-side identity work (digest PKs,
    display attributes, long-allele hashing) must read these, never decode
    the device arrays."""

    batch: VariantBatch
    refs: list                 # original ref string, per row
    alts: list                 # original alt string, per row
    ref_snp: list              # 'rs...' string or None, per row
    variant_id: list           # ID column or metaseq-style id, per row
    is_multi_allelic: np.ndarray
    frequencies: list          # per-row dict, RawJson or None (FREQ field)
    line_number: np.ndarray    # 1-based source line, per row
    counters: dict = field(default_factory=dict)
    rs_position: list = field(default_factory=list)  # INFO RSPOS, per row
    #: full INFO dict per row (shared across the alts of a line)
    info: list = field(default_factory=list)
    # site columns beyond identity (the QC and LoF updates read these):
    # QUAL, FILTER, FORMAT as raw strings, None when absent or '.'
    qual: list = field(default_factory=list)
    filter: list = field(default_factory=list)
    format: list = field(default_factory=list)
    #: raw INFO column text per row (None when absent/'.'), so update
    #: strategies write INFO as JSON text without the dict round trip
    #: (:func:`info_to_json`).  None from the Python engine: consumers
    #: then serialize the parsed ``info`` dict.
    info_raw: list | None = None
    #: int64 refsnp number per row (ID "rs<digits>" first, else INFO RS=,
    #: else -1) — lets the insert path store rs ids without materializing
    #: any per-row sidecar string (``loaders/vcf_loader.py`` append stage)
    rs_number: np.ndarray | None = None
    #: bool per row: a refsnp STRING exists but does not parse to a number
    #: ('weird' ids like 'chr_rs_x'); primary keys for these rows fall back
    #: to the materialized ``ref_snp`` string (rare)
    rs_weird: np.ndarray | None = None
    #: bool per row: the ID column is a verbatim variant id (not '.' / not
    #: an rs accession) — mapping ids for other rows assemble vectorized
    id_verbatim: np.ndarray | None = None
    #: bool per row: INFO carries a FREQ entry.  The insert path skips the
    #: frequencies column entirely for chunks with no flagged row.
    has_freq: np.ndarray | None = None
    #: uint32 allele-identity hash per row, computed by the native tokenizer
    #: during the scan (the bit-exact twin of ``ops.hashing.allele_hash``
    #: over the width-bounded arrays); a view of the chunk's buffer.  None
    #: from the Python engine.  Over-width rows still need the host
    #: full-string re-hash, as with every engine.
    h_native: np.ndarray | None = None


class VcfBatchReader:
    """Stream a VCF into fixed-size per-alt row chunks.

    ``batch_size`` rows per chunk (the final chunk is smaller); rows on
    unplaceable contigs are skipped and counted, mirroring the reference's
    standard-chromosome-only loads.

    ``engine`` (``AVDB_INGEST_ENGINE`` when ``auto`` is passed): ``auto``
    reads with the native C++ tokenizer unless an accession map is given
    (the native tokenizer resolves chromosome codes itself), ``native``
    forces it (and refuses a map), ``python`` forces the Python scanner.
    A native build that fails raises with the compiler's stderr: ``auto``
    never falls back to the Python scanner.
    """

    def __init__(self, path: str, batch_size: int = 1 << 16, width: int = 49,
                 chromosome_map: dict | None = None, engine: str = "auto",
                 on_reject=None):
        self.path = path
        self.batch_size = batch_size
        self.width = width
        self.chromosome_map = chromosome_map
        #: ``on_reject(line_no, raw_line, reason)`` for malformed lines —
        #: the quarantine hook.  Only the Python scanner sees line content
        #: (the native tokenizer reports counts, not spans); loaders check
        #: :attr:`rejects_captured` and budget-count from the chunk's
        #: malformed counter when content capture is unavailable.
        self.on_reject = on_reject
        if engine == "auto":
            import os

            engine = os.environ.get("AVDB_INGEST_ENGINE", "auto")
        if engine not in ("auto", "python", "native"):
            raise ValueError(f"unknown engine {engine!r}")
        self.engine = engine

    @property
    def rejects_captured(self) -> bool:
        """Whether malformed lines will reach ``on_reject`` with content."""
        return self.on_reject is not None and not self._use_native()

    def _use_native(self) -> bool:
        """The engine this reader scans with; builds the native library on
        first use (raising when the build fails)."""
        if self.engine == "python":
            return False
        if self.chromosome_map is not None:
            if self.engine == "native":
                raise RuntimeError(
                    "native ingest engine cannot apply a chromosome_map; "
                    "use engine='python' (or 'auto') with accession maps"
                )
            return False
        from annotatedvdb_tpu_torch import native

        native.load()
        return True

    def __iter__(self) -> Iterator[VcfChunk]:
        if self._use_native():
            from annotatedvdb_tpu_torch.native.vcf import iter_native_chunks

            chunks = iter_native_chunks(self.path, self.batch_size, self.width)
        else:
            chunks = self._iter_python()
        return self._fire_per_chunk(chunks)

    @staticmethod
    def _fire_per_chunk(chunks) -> Iterator[VcfChunk]:
        from annotatedvdb_tpu_torch.utils import faults

        for chunk in chunks:
            # crash point: per parsed chunk, engine-independent (fires on
            # the ingest thread under the overlapped pipeline, so an
            # injected raise also exercises the cross-thread error path)
            faults.fire("ingest.chunk")
            yield chunk

    def iter_prefetched(self, timer, depth: int = 2,
                        shuffle_seed: int | None = None,
                        tagged: bool = False):
        """Chunk iterator with the scan on a background ingest thread: the
        first stage of the overlapped load executor.  ``depth`` bounds the
        unconsumed chunks (backpressure blocks the scan).  Chunks are safe
        to hand across the thread boundary: both engines emit self-owned
        arrays, and sidecar columns only reference immutable window bytes.

        ``tagged`` yields ``(seq, chunk)`` pairs; ``shuffle_seed`` (with
        ``tagged``) arms shuffled chunk scheduling (see
        :class:`~annotatedvdb_tpu_torch.io.prefetch.ChunkPrefetcher`).
        ``timer`` gets the scan seconds as its ``ingest`` stage, on the
        ingest thread.  Callers that stop early must ``close()`` the
        returned prefetcher."""
        from annotatedvdb_tpu_torch.io.prefetch import ChunkPrefetcher

        return ChunkPrefetcher(
            self, depth=depth, shuffle_seed=shuffle_seed, tagged=tagged,
            timer=timer, name="vcf-ingest",
        )

    def _iter_python(self) -> Iterator[VcfChunk]:
        rows: list = []
        counters = {"line": 0, "skipped_alt": 0, "skipped_contig": 0,
                    "malformed": 0}
        with _open_text(self.path) as fh:
            for line_no, line in enumerate(fh, start=1):
                if line.startswith("#") or not line.strip():
                    continue
                fields = line.rstrip("\r\n").split("\t")
                if (len(fields) < 5 or not fields[1].isdigit()
                        or int(fields[1]) > 0x7FFFFFFF):
                    counters["line"] += 1
                    counters["malformed"] += 1
                    if self.on_reject is not None:
                        self.on_reject(
                            line_no, line.rstrip("\r\n"),
                            "malformed VCF line (needs >=5 tab-separated "
                            "fields with an in-range integer POS)",
                        )
                    continue
                chrom_str, pos_str, vid, ref, alt_str = fields[:5]
                if self.chromosome_map is not None:
                    chrom_str = self.chromosome_map.get(chrom_str, chrom_str)
                code = chromosome_code(chrom_str)
                if code == 0:
                    counters["line"] += 1
                    counters["skipped_contig"] += 1
                    continue
                # flush BEFORE a line that would overflow the batch: chunks
                # stay line-aligned AND never exceed batch_size, so the
                # loader pads every chunk to one fixed kernel shape (the
                # native engine's fixed-capacity buffer behaves the same)
                alts = alt_str.split(",")
                if rows and len(rows) + len(alts) > self.batch_size:
                    yield self._emit(rows, counters)
                    rows = []
                    counters = {k: 0 for k in counters}
                counters["line"] += 1
                info = (
                    parse_info(fields[7])
                    if len(fields) > 7 and fields[7] != "."
                    else {}
                )
                chrom_label = str(chrom_str)
                if chrom_label.startswith("chr"):
                    chrom_label = chrom_label[3:]
                if chrom_label == "MT":
                    chrom_label = "M"
                ref_snp = None
                if "rs" in vid:
                    ref_snp = vid
                elif "RS" in info:
                    ref_snp = "rs" + str(info["RS"])
                variant_id = (
                    ":".join((chrom_label, pos_str, ref, alt_str))
                    if vid == "." or vid.startswith("rs")
                    else vid
                )
                freqs = parse_freq(info, len(alts))
                multi = len(alts) > 1
                # line-level flag (INFO carries a FREQ key), same rule as
                # the native tokenizer's pre-scan; per-alt values may still
                # be None
                has_freq = "FREQ" in info
                id_verbatim = not (vid == "." or vid.startswith("rs"))
                qual = fields[5] if len(fields) > 5 and fields[5] != "." else None
                filt = fields[6] if len(fields) > 6 and fields[6] != "." else None
                fmt = fields[8] if len(fields) > 8 and fields[8] != "." else None
                for i, alt in enumerate(alts):
                    if alt == ".":
                        counters["skipped_alt"] += 1
                        continue
                    rows.append(
                        (
                            code,
                            int(pos_str),
                            ref,
                            alt,
                            ref_snp,
                            variant_id,
                            multi,
                            freqs[i],
                            line_no,
                            has_freq,
                            id_verbatim,
                            info.get("RSPOS"),
                            info,
                            qual,
                            filt,
                            fmt,
                        )
                    )
        if rows or any(counters.values()):
            # a trailing zero-row chunk still carries skip/malformed counters
            # so totals reconcile; loaders must tolerate batch.n == 0
            yield self._emit(rows, counters)

    def _emit(self, rows: list, counters: dict) -> VcfChunk:
        batch = VariantBatch.from_tuples(
            [(r[0], r[1], r[2], r[3]) for r in rows], width=self.width
        )
        # from_tuples re-derives chromosome codes from labels; codes are
        # already resolved here, so set them directly.
        batch = batch._replace(
            chrom=np.array([r[0] for r in rows], dtype=np.int8)
        )
        rs_col = np.array(
            [rs_number(r[4]) for r in rows], dtype=np.int64
        ) if rows else np.zeros(0, np.int64)
        rs_weird = np.array(
            [rs_is_weird(r[4], n) for r, n in zip(rows, rs_col)],
            dtype=bool,
        ) if rows else np.zeros(0, bool)
        return VcfChunk(
            rs_number=rs_col,
            rs_weird=rs_weird,
            id_verbatim=np.array([r[10] for r in rows], dtype=bool),
            has_freq=np.array([r[9] for r in rows], dtype=bool),
            batch=batch,
            refs=[r[2] for r in rows],
            alts=[r[3] for r in rows],
            ref_snp=[r[4] for r in rows],
            variant_id=[r[5] for r in rows],
            is_multi_allelic=np.array([r[6] for r in rows], dtype=bool),
            frequencies=[r[7] for r in rows],
            line_number=np.array([r[8] for r in rows], dtype=np.int64),
            counters=dict(counters),
            rs_position=[r[11] for r in rows],
            info=[r[12] for r in rows],
            qual=[r[13] for r in rows],
            filter=[r[14] for r in rows],
            format=[r[15] for r in rows],
        )


def read_chromosome_map(path: str) -> dict:
    """TSV (headered or accession <tab> chromosome) -> {accession: chromosome}
    (``parsers/chromosome_map_parser.py:49-62``).  Thin wrapper over
    :class:`~annotatedvdb_tpu_torch.io.chromosome_map.ChromosomeMap` so there is
    exactly one parser for the format."""
    from annotatedvdb_tpu_torch.io.chromosome_map import ChromosomeMap

    return ChromosomeMap(path).chromosome_map()
