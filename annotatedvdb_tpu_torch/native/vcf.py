"""Native-engine VCF scanner: C++ tokenizer -> VcfChunk batches.

Port of ``annotatedvdb_tpu/native/vcf.py``.  Drives
``avdb_parse_vcf_chunk`` (``native/avdb_native.cpp``) over large
decompressed byte windows and assembles the :class:`VcfChunk` the Python
reader emits (``io/vcf.py``).  The device-batch columns and the allele
hash (``h_native``) come straight out of the C++ tokenizer; sidecar
strings (ids, INFO, QUAL, FILTER, FORMAT, original over-width alleles)
materialize lazily from the byte spans it reports.

A chunk ends every ``batch_size`` rows AND at the end of each
``READ_SIZE`` window, so the native engine cuts a file into other chunks
than the Python engine: the stores of the two engines differ in bytes
(segments, checkpoints and quarantine records follow chunks).  With
``pack_alleles`` the tokenizer also nibble-packs each row's alleles during
the scan (``ops/pack.py``'s codes), and a chunk whose every row packed
carries the packed matrices (``ref_packed``, ``alt_packed``) for the
loader's upload; ``identity_only`` leaves INFO unread (every INFO view of
the chunk is empty).
"""

from __future__ import annotations

import ctypes
import gzip

import numpy as np

from annotatedvdb_tpu_torch import native
from annotatedvdb_tpu_torch.types import VariantBatch, chromosome_label

READ_SIZE = 8 << 20  # decompressed bytes per window (read at call time)


class _Arrays:
    """Per-batch output buffers for the C call.

    ``np.empty``, not ``np.zeros``: the tokenizer writes every per-row slot
    for rows [0, n) and consumers only ever view ``[:n]``.  With ``pack``
    False the nibble matrices are 1-element dummies (valid pointers the C
    call never writes through under ``want_packed = 0``)."""

    def __init__(self, cap: int, width: int, pack: bool = True):
        self.cap = cap
        self.chrom = np.empty(cap, np.int8)
        self.pos = np.empty(cap, np.int32)
        self.ref = np.empty((cap, width), np.uint8)
        self.alt = np.empty((cap, width), np.uint8)
        self.ref_len = np.empty(cap, np.int32)
        self.alt_len = np.empty(cap, np.int32)
        self.multi = np.empty(cap, np.uint8)
        self.line_no = np.empty(cap, np.int64)
        self.ref_off = np.empty(cap, np.int64)
        self.alt_off = np.empty(cap, np.int64)
        self.id_off = np.empty(cap, np.int64)
        self.id_len = np.empty(cap, np.int32)
        self.qual_off = np.empty(cap, np.int64)
        self.qual_len = np.empty(cap, np.int32)
        self.filter_off = np.empty(cap, np.int64)
        self.filter_len = np.empty(cap, np.int32)
        self.info_off = np.empty(cap, np.int64)
        self.info_len = np.empty(cap, np.int32)
        self.format_off = np.empty(cap, np.int64)
        self.format_len = np.empty(cap, np.int32)
        self.altcol_off = np.empty(cap, np.int64)
        self.altcol_len = np.empty(cap, np.int32)
        self.alt_index = np.empty(cap, np.int32)
        self.n_alts = np.empty(cap, np.int32)
        self.rs_number = np.empty(cap, np.int64)
        self.rs_weird = np.empty(cap, np.uint8)
        self.id_verbatim = np.empty(cap, np.uint8)
        self.has_freq = np.empty(cap, np.uint8)
        self.hash = np.empty(cap, np.uint32)
        pack_rows = cap if pack else 1
        pack_cols = (width + 1) // 2 if pack else 1
        self.ref_packed = np.empty((pack_rows, pack_cols), np.uint8)
        self.alt_packed = np.empty((pack_rows, pack_cols), np.uint8)
        self.pack_ok = np.empty(cap, np.uint8)

    def pointers(self):
        def p(a):
            return a.ctypes.data_as(ctypes.c_void_p)

        return [
            p(self.chrom), p(self.pos), p(self.ref), p(self.alt),
            p(self.ref_len), p(self.alt_len), p(self.multi), p(self.line_no),
            p(self.ref_off), p(self.alt_off),
            p(self.id_off), p(self.id_len), p(self.qual_off), p(self.qual_len),
            p(self.filter_off), p(self.filter_len),
            p(self.info_off), p(self.info_len),
            p(self.format_off), p(self.format_len),
            p(self.altcol_off), p(self.altcol_len),
            p(self.alt_index), p(self.n_alts),
            p(self.rs_number), p(self.rs_weird), p(self.id_verbatim),
            p(self.has_freq), p(self.hash),
            p(self.ref_packed), p(self.alt_packed), p(self.pack_ok),
        ]


def scan_native(path: str, batch_size: int, width: int,
                identity_only: bool = False, pack_alleles: bool = True):
    """Yield ``(arrays, n_rows, window_bytes, start, counters_dict,
    decoded_cache)`` per fill of the row buffer.

    ``window_bytes`` is the bytes object the span columns index into (from
    offset ``start``); it must outlive any span materialization."""
    lib = native.load()
    opener = gzip.open if path.endswith(".gz") else open
    arrays = _Arrays(batch_size, width, pack_alleles)
    counters = np.zeros(5, np.int64)
    consumed = ctypes.c_int64(0)
    need_more = ctypes.c_int32(0)

    with opener(path, "rb") as fh:
        tail = b""
        line_base = 0
        eof = False
        while not eof or tail:
            window = tail
            # one-slot decoded-text cache SHARED by every chunk cut from
            # this window (chunk_from_native fills it lazily on first span
            # access; multiple fills of one window must not re-decode)
            decoded_cache: list = []
            if not eof:
                block = fh.read(READ_SIZE)
                if block:
                    window = tail + block
                else:
                    eof = True
                    # final partial line (no trailing newline): terminate it
                    if window and not window.endswith(b"\n"):
                        window += b"\n"
            elif window and not window.endswith(b"\n"):
                window += b"\n"
            if not window:
                break
            # drain the window; the tokenizer may fill the row buffer more
            # than once per window.  Pointer arithmetic (not window[start:])
            # avoids re-copying the tail of the window per fill.
            window_addr = ctypes.cast(
                ctypes.c_char_p(window), ctypes.c_void_p
            ).value
            start = 0
            while True:
                counters[:] = 0
                n = lib.avdb_parse_vcf_chunk(
                    ctypes.cast(window_addr + start, ctypes.c_char_p),
                    len(window) - start, width, arrays.cap,
                    line_base,
                    *arrays.pointers(),
                    ctypes.c_int32(1 if identity_only else 0),
                    ctypes.c_int32(1 if pack_alleles else 0),
                    counters.ctypes.data_as(ctypes.c_void_p),
                    ctypes.byref(consumed), ctypes.byref(need_more),
                )
                if need_more.value and n == 0 and consumed.value == 0:
                    # one source line holds more alt rows than the buffer:
                    # grow and retry (the Python engine likewise lets a chunk
                    # exceed batch_size rather than split a line)
                    arrays = _Arrays(arrays.cap * 2, width, pack_alleles)
                    continue
                # absolute line numbers: the tokenizer reports the lines it
                # consumed (headers included), so no host newline re-scan
                line_base += int(counters[4])
                if n or counters.any():
                    # zero-row fills with consumed lines still surface
                    # their counters so totals stay exact
                    yield arrays, int(n), window, start, {
                        "line": int(counters[0]),
                        "skipped_contig": int(counters[1]),
                        "skipped_alt": int(counters[2]),
                        "malformed": int(counters[3]),
                    }, decoded_cache
                if n:
                    # ownership handoff: the chunk keeps VIEWS of these
                    # buffers, so the next fill writes into a fresh set —
                    # which also makes chunks safe to hand to another
                    # pipeline thread
                    arrays = _Arrays(arrays.cap, width, pack_alleles)
                start += consumed.value
                if not need_more.value:
                    break
            tail = window[start:]
            if eof and tail and consumed.value == 0 and not need_more.value:
                # no newline progress possible: malformed remainder
                break


_MISSING = object()


class LazyColumn:
    """A list-compatible per-row column materialized on first access.

    The native tokenizer reports byte spans, not strings; consumers that
    never touch a field pay nothing.  Supports the access patterns the
    loaders use: ``col[i]``, iteration, ``len``, ``in`` (fail-at scans),
    ``==`` against lists (tests).  Materialization runs on whichever thread
    touches the column (the loader's process thread)."""

    __slots__ = ("_n", "_fn", "_cache")

    def __init__(self, n: int, fn):
        self._n = n
        self._fn = fn
        self._cache: list | None = None  # allocated on first access

    def __len__(self):
        return self._n

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self[j] for j in range(*i.indices(self._n))]
        if i < 0:
            i += self._n
        if self._cache is None:
            self._cache = [_MISSING] * self._n
        v = self._cache[i]
        if v is _MISSING:
            v = self._cache[i] = self._fn(i)
        return v

    def __iter__(self):
        for i in range(self._n):
            yield self[i]

    def __contains__(self, item):
        return any(v == item for v in self)

    def __eq__(self, other):
        if isinstance(other, (list, tuple, LazyColumn)):
            return len(self) == len(other) and all(
                a == b for a, b in zip(self, other)
            )
        return NotImplemented

    def __repr__(self):
        return f"LazyColumn({list(self)!r})"


def chunk_from_native(arrays: _Arrays, n: int, window: bytes, base: int,
                      counters: dict, identity_only: bool = False,
                      pack_alleles: bool = True,
                      decoded_cache: list | None = None):
    """Assemble a :class:`~annotatedvdb_tpu_torch.io.vcf.VcfChunk` from one
    native batch: zero-copy VIEWS of the buffers ``scan_native`` handed
    over, and lazy sidecar columns over the immutable window bytes."""
    from annotatedvdb_tpu_torch.io.vcf import VcfChunk, freq_sidecar, parse_info

    batch = VariantBatch(
        chrom=arrays.chrom[:n],
        pos=arrays.pos[:n],
        ref=arrays.ref[:n],
        alt=arrays.alt[:n],
        ref_len=arrays.ref_len[:n],
        alt_len=arrays.alt_len[:n],
    )
    ref_off = arrays.ref_off[:n]
    alt_off = arrays.alt_off[:n]
    id_off = arrays.id_off[:n]
    id_len = arrays.id_len[:n]
    info_off = arrays.info_off[:n]
    info_len = arrays.info_len[:n]
    qual_off, qual_len = arrays.qual_off[:n], arrays.qual_len[:n]
    filter_off, filter_len = arrays.filter_off[:n], arrays.filter_len[:n]
    format_off, format_len = arrays.format_off[:n], arrays.format_len[:n]
    altcol_off = arrays.altcol_off[:n]
    altcol_len = arrays.altcol_len[:n]
    alt_index = arrays.alt_index[:n]
    n_alts = arrays.n_alts[:n]
    # uint8 0/1 -> bool reinterpret (same itemsize): no copy
    has_freq = arrays.has_freq[:n].view(np.bool_)
    line_no = arrays.line_no[:n]
    # pre-packed alleles travel with the chunk only when EVERY row packs
    # (the loader uploads a chunk packed or raw); without ``pack_alleles``
    # packing was never tried and ``packable`` stays None
    packable = bool(arrays.pack_ok[:n].all()) if pack_alleles else None
    if packable:
        ref_packed, alt_packed = arrays.ref_packed[:n], arrays.alt_packed[:n]
    else:
        ref_packed = alt_packed = None
    # the window decodes ONCE on first span access (ascii is 1 byte -> 1
    # char, so byte offsets index the str directly); the cache is shared
    # by every chunk cut from the same window
    decoded = decoded_cache if decoded_cache is not None else []

    def span(off, length, i):
        if not decoded:
            decoded.append(window.decode("ascii", errors="replace"))
        o = base + int(off[i])
        return decoded[0][o:o + int(length[i])]

    refs = LazyColumn(n, lambda i: span(ref_off, batch.ref_len, i))
    alts = LazyColumn(n, lambda i: span(alt_off, batch.alt_len, i))

    # INFO parses at most once per source line (rows of a line share it)
    line_cache: dict = {}

    def info_at(i):
        if identity_only or int(info_len[i]) <= 0:
            return {}
        key = int(line_no[i])
        hit = line_cache.get(key)
        if hit is None:
            hit = line_cache[key] = parse_info(span(info_off, info_len, i))
        return hit

    # FREQ decodes once per source line straight to stored-JSONB text
    # (io.vcf.freq_sidecar): no INFO dict, no per-row freq dict
    freq_cache: dict = {}

    def freq_at(i):
        if not has_freq[i] or identity_only or int(info_len[i]) <= 0:
            return None
        key = int(line_no[i])
        hit = freq_cache.get(key)
        if hit is None:
            hit = freq_cache[key] = freq_sidecar(
                span(info_off, info_len, i), int(n_alts[i])
            )
        return hit[int(alt_index[i])]

    def ref_snp_at(i):
        # substring rule first, exactly like the Python reader: an ID
        # containing 'rs' IS the refsnp
        vid = span(id_off, id_len, i)
        if "rs" in vid:
            return vid
        info = info_at(i)
        if "RS" in info:
            return "rs" + str(info["RS"])
        return None

    def variant_id_at(i):
        vid = span(id_off, id_len, i)
        if vid == "." or vid.startswith("rs"):
            return ":".join((
                chromosome_label(batch.chrom[i]), str(int(batch.pos[i])),
                refs[i], span(altcol_off, altcol_len, i),
            ))
        return vid

    def opt(off, length):
        # the tokenizer reports a negative offset for an absent or '.' field
        return lambda i: span(off, length, i) if off[i] >= 0 else None

    return VcfChunk(
        batch=batch,
        refs=refs,
        alts=alts,
        ref_snp=LazyColumn(n, ref_snp_at),
        variant_id=LazyColumn(n, variant_id_at),
        is_multi_allelic=arrays.multi[:n].astype(bool),
        # the tokenizer pre-flags FREQ-bearing rows, so FREQ-less rows
        # skip even the FREQ-token scan
        frequencies=LazyColumn(n, freq_at),
        rs_position=LazyColumn(n, lambda i: info_at(i).get("RSPOS")),
        info=LazyColumn(n, info_at),
        info_raw=LazyColumn(
            # identity_only: both INFO views agree (empty)
            n, lambda i: (span(info_off, info_len, i)
                          if info_len[i] > 0 and not identity_only else None)
        ),
        qual=LazyColumn(n, opt(qual_off, qual_len)),
        filter=LazyColumn(n, opt(filter_off, filter_len)),
        format=LazyColumn(n, opt(format_off, format_len)),
        line_number=line_no,
        counters=dict(counters),
        rs_number=arrays.rs_number[:n],
        rs_weird=arrays.rs_weird[:n].view(np.bool_),
        id_verbatim=arrays.id_verbatim[:n].view(np.bool_),
        has_freq=has_freq,
        h_native=arrays.hash[:n],
        ref_packed=ref_packed,
        alt_packed=alt_packed,
        alleles_packable=packable,
    )


def iter_native_chunks(path: str, batch_size: int, width: int,
                       identity_only: bool = False, pack_alleles: bool = True):
    """VcfChunk iterator over the native scanner (engine ``native``)."""
    pending_counters = {"line": 0, "skipped_contig": 0, "skipped_alt": 0,
                        "malformed": 0}
    for arrays, n, window, base, counters, decoded_cache in scan_native(
            path, batch_size, width, identity_only, pack_alleles):
        for k, v in counters.items():
            pending_counters[k] = pending_counters.get(k, 0) + v
        if n == 0:
            continue
        chunk = chunk_from_native(
            arrays, n, window, base, pending_counters, identity_only,
            pack_alleles, decoded_cache,
        )
        pending_counters = {k: 0 for k in pending_counters}
        yield chunk
    if any(pending_counters.values()):
        # counters from lines after the last emitted row (or from a file
        # whose data lines were all filtered) ride a zero-row chunk so load
        # totals reconcile — same contract as the Python engine
        yield _empty_chunk(width, pending_counters)


def _empty_chunk(width: int, counters: dict):
    from annotatedvdb_tpu_torch.io.vcf import VcfChunk

    batch = VariantBatch(
        chrom=np.zeros(0, np.int8), pos=np.zeros(0, np.int32),
        ref=np.zeros((0, width), np.uint8), alt=np.zeros((0, width), np.uint8),
        ref_len=np.zeros(0, np.int32), alt_len=np.zeros(0, np.int32),
    )
    return VcfChunk(
        batch=batch, refs=[], alts=[], ref_snp=[], variant_id=[],
        is_multi_allelic=np.zeros(0, bool), frequencies=[], rs_position=[],
        info=[], qual=[], filter=[], format=[],
        line_number=np.zeros(0, np.int64), counters=dict(counters),
        rs_number=np.zeros(0, np.int64), has_freq=np.zeros(0, bool),
    )
