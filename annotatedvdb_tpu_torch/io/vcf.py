"""Host-side VCF ingest: text chunks -> VariantBatch + per-row sidecar.

Copy of ``annotatedvdb_tpu/io/vcf.py`` with the Python tokenizer only: the
native C++ tokenizer, its zero-copy FREQ sidecar and the prefetch spine
are not ported yet.  Chunk boundaries depend on the engine, so stores
written by the two packages agree byte for byte when the reference runs
``engine="python"`` (``AVDB_INGEST_ENGINE=python``) with the same batch
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
    frequencies: list          # per-row dict or None (FREQ field)
    line_number: np.ndarray    # 1-based source line, per row
    counters: dict = field(default_factory=dict)
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


class VcfBatchReader:
    """Stream a VCF into fixed-size per-alt row chunks (Python tokenizer).

    ``batch_size`` rows per chunk (the final chunk is smaller); rows on
    unplaceable contigs are skipped and counted, mirroring the reference's
    standard-chromosome-only loads.  ``AVDB_INGEST_ENGINE=native`` (the
    JAX package's C++ tokenizer) is refused: it is not ported yet.  The
    site columns the update loaders read (QUAL, FILTER, FORMAT, the INFO
    dict) come with them.
    """

    def __init__(self, path: str, batch_size: int = 1 << 16, width: int = 49,
                 chromosome_map: dict | None = None, on_reject=None):
        import os

        self.path = path
        self.batch_size = batch_size
        self.width = width
        self.chromosome_map = chromosome_map
        #: ``on_reject(line_no, raw_line, reason)`` for malformed lines —
        #: the quarantine hook (the Python scanner sees every line's
        #: content)
        self.on_reject = on_reject
        engine = os.environ.get("AVDB_INGEST_ENGINE", "auto")
        if engine == "native":
            raise NotImplementedError(
                "AVDB_INGEST_ENGINE=native: the native tokenizer is not yet "
                "ported; the port reads VCFs with the Python tokenizer"
            )
        if engine not in ("auto", "python"):
            raise ValueError(f"unknown engine {engine!r}")

    def __iter__(self) -> Iterator[VcfChunk]:
        return self._iter_python()

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
        )


def read_chromosome_map(path: str) -> dict:
    """TSV (headered or accession <tab> chromosome) -> {accession: chromosome}
    (``parsers/chromosome_map_parser.py:49-62``).  Thin wrapper over
    :class:`~annotatedvdb_tpu_torch.io.chromosome_map.ChromosomeMap` so there is
    exactly one parser for the format."""
    from annotatedvdb_tpu_torch.io.chromosome_map import ChromosomeMap

    return ChromosomeMap(path).chromosome_map()
