"""Chromosome-sharded columnar variant store with log-structured segments.

Port of ``annotatedvdb_tpu/store/variant_store.py`` for the insert load:
the same on-disk format (manifest format 3, flat-container segments,
``.ann.jsonl`` sidecars, crc32 integrity records), so a store written by
either package loads in the other.  The replacement for the reference's
``AnnotatedVDB.Variant`` Postgres table
(``Load/lib/sql/annotatedvdb_schema/tables/createVariant.sql:4-50``):

- one shard per chromosome, each a list of **sorted segments** (LSM-style):
  a flush appends one segment, overlapping tails cascade-merge, disjoint
  tails stay apart;
- membership checks are searchsorted joins against each segment; large
  joins run ``ops/dedup.lookup_in_sorted`` in torch against a copy of the
  segment's identity columns held on the device;
- persistence is incremental: ``save`` writes only new or dirty segments;
- update loads address rows by global id (a shard's segments, oldest
  first, numbered consecutively): ``lookup`` resolves identities to ids,
  ``update_annotation`` deep-merges JSONB values into them (the
  reference's ``jsonb_merge``), ``set_col`` sets numeric columns, and the
  segments they touch become dirty;
- whole-shard passes (the CADD join, VCF export) ``compact`` a shard into
  one segment and read its flat views (``cols``, ``ref``, ``alt``), whose
  row ids are then position-sorted; ``alleles`` gives a row's full
  strings, the long-allele tail included;
- ``delete_by_algorithm`` undoes a load: it drops every row stamped with
  the load's invocation id.

JSONB values may be held as raw JSON text (:class:`RawJson`, the native
VCF tokenizer's FREQ sidecar): the segment writer splices the text, and
every mutation site materializes a fresh object on the row first.

Cooperative writers: a serve worker's memtable flush may commit into the
same directory while a loader holds the store.  ``save`` carries the
groups such a writer committed since this store loaded forward verbatim
and never reuses their seg ids (``_adoptable_groups``); groups below the
load-time floor stay this store's own, so an undo still drops their rows.

The on-disk compaction lives in ``store/compact.py`` and reads segments
through :meth:`VariantStore._read_segment`.  Segment containers at or
above ``AVDB_STORE_SPILL_BYTES`` load their raw streams as copy-on-write
memmaps (the out-of-core tier, :func:`_spill_bytes`).  Not ported: the
mesh placement block.
"""

from __future__ import annotations

import json
import os
import zlib

import numpy as np
import torch

from annotatedvdb_tpu_torch.types import chromosome_label, decode_allele
from annotatedvdb_tpu_torch.utils import faults
from annotatedvdb_tpu_torch.utils import io as tio
from annotatedvdb_tpu_torch.utils.strings import deep_update


class StoreCorruptError(ValueError):
    """The on-disk store is internally inconsistent (torn/missing/mismatched
    segment files, unreadable manifest)."""


def _fsck_hint(path: str) -> str:
    return (
        f"run `python -m annotatedvdb_tpu doctor --storeDir {path}` "
        "(tools/store_fsck.py) to diagnose, and add --repair to prune "
        "orphans / roll back to the last consistent state"
    )


# The ten JSONB annotation columns of AnnotatedVDB.Variant
# (createVariant.sql:4-24).
JSONB_COLUMNS = [
    "display_attributes",
    "allele_frequencies",
    "cadd_scores",
    "adsp_most_severe_consequence",
    "adsp_ranked_consequences",
    "loss_of_function",
    "vep_output",
    "adsp_qc",
    "gwas_flags",
    "other_annotation",
]

# Non-JSONB per-row object columns (host-side tails).
_DIGEST_PK = "_digest_pk"
_LONG_ALLELES = "_long_alleles"
OBJECT_COLUMNS = JSONB_COLUMNS + [_DIGEST_PK, _LONG_ALLELES]

_NUMERIC_COLUMNS = [
    ("pos", np.int32),
    ("h", np.uint32),
    ("ref_len", np.int32),
    ("alt_len", np.int32),
    ("ref_snp", np.int64),          # rs number; -1 = NULL
    ("is_multi_allelic", np.bool_),
    ("is_adsp_variant", np.int8),   # -1 NULL / 0 false / 1 true
    ("bin_level", np.int8),
    ("leaf_bin", np.int32),
    ("needs_digest", np.bool_),
    ("row_algorithm_id", np.int32),
]

# Columns that define a row's identity (and its place in the sorted order).
_IDENTITY_COLUMNS = ("pos", "h", "ref_len", "alt_len")

# Device-probe thresholds for AVDB_DEVICE_LOOKUP=auto on a CUDA device.
# Below them host numpy wins: the query columns must ship to the device per
# probe, so the torch probe pays off only once the segment is far too large
# for a cache-resident host searchsorted.
DEVICE_SEGMENT_MIN = 1 << 18
DEVICE_QUERY_MIN = 1 << 12

# Ski-rental rule: a segment uploads its identity columns once the query
# volume its numpy probes served reaches 1/AMORTIZE of its size.
DEVICE_UPLOAD_AMORTIZE = 4

# Cascade merges stop once the older segment exceeds this row count.
MERGE_SEGMENT_CAP = 1 << 20

# Disjoint tail segments are never cascade-merged; past this count
# ``maintain`` collapses consecutive runs back into MERGE_SEGMENT_CAP-sized
# segments.
MAX_SEGMENTS = 512


def _verify_mode() -> str:
    """AVDB_VERIFY load-time integrity checking: ``size`` (default) checks
    byte counts against the manifest's integrity records; ``deep`` also
    checksums every segment file; ``off`` disables both."""
    mode = os.environ.get("AVDB_VERIFY", "size").lower()
    return mode if mode in ("off", "size", "deep") else "size"


def _spill_bytes() -> int:
    """``AVDB_STORE_SPILL_BYTES``: segment containers at or above this size
    load as copy-on-write memmaps instead of materialized arrays (the
    out-of-core tier, :meth:`VariantStore._read_stream`).  Takes ``512m``
    / ``2g`` suffixes (``utils.strings.parse_bytes``); a malformed value
    raises with the variable's name; unset, ``0`` or ``off`` disables."""
    raw = os.environ.get("AVDB_STORE_SPILL_BYTES", "").strip().lower()
    if not raw or raw in ("0", "off"):
        return 0
    from annotatedvdb_tpu_torch.utils.strings import parse_bytes

    try:
        return parse_bytes(raw)
    except ValueError as err:
        raise ValueError(f"AVDB_STORE_SPILL_BYTES: {err}") from None


def crc32_file(path: str) -> int:
    """Chunked crc32 of a whole file (load-time deep verify)."""
    crc = 0
    with open(path, "rb") as f:
        while True:
            buf = f.read(1 << 20)
            if not buf:
                break
            crc = zlib.crc32(buf, crc)
    return crc


class _CrcWriter:
    """File-object wrapper accumulating crc32 + byte count over every write
    — the integrity record is computed on the bytes on their way to disk,
    never by re-reading the file."""

    __slots__ = ("_f", "crc", "nbytes")

    def __init__(self, f):
        self._f = f
        self.crc = 0
        self.nbytes = 0

    def write(self, b):
        self.crc = zlib.crc32(b, self.crc)
        self.nbytes += len(b)
        return self._f.write(b)

    def __getattr__(self, name):  # flush/tell/fileno passthrough
        return getattr(self._f, name)


def device_lookup_mode() -> str:
    """``AVDB_DEVICE_LOOKUP``: ``auto`` (default: torch probe on a CUDA
    device past the size thresholds), ``always`` (torch probe on the
    loader's device, CPU included), ``off`` (numpy only).  Read per call."""
    return os.environ.get("AVDB_DEVICE_LOOKUP", "auto")


def combined_key(pos: np.ndarray, h: np.ndarray) -> np.ndarray:
    """uint64 (pos << 32 | hash) — host-side sort/join key."""
    return (pos.astype(np.uint64) << np.uint64(32)) | h.astype(np.uint64)


class RawJson:
    """A JSONB column value held as raw JSON TEXT instead of parsed dicts.

    The native VCF tokenizer emits FREQ values as ready JSON
    (``io.vcf.freq_sidecar``); the common consumer is the segment writer,
    which wants text anyway.  A RawJson is immutable — sharing one instance
    across rows is safe, unlike dicts under deep-merge — and behaves as a
    read-only mapping for consumers that index into it (the parse is
    cached).  Store-side mutation sites (deep-merge targets, ``get_ann``)
    materialize a FRESH object per row via :meth:`fresh`, so no parsed tree
    is ever shared between rows."""

    __slots__ = ("text", "_obj")

    def __init__(self, text: str):
        self.text = text
        self._obj = None

    def fresh(self):
        """A newly parsed (never shared) Python object of this value."""
        return json.loads(self.text)

    def _cached(self):
        if self._obj is None:
            self._obj = json.loads(self.text)
        return self._obj

    # -- read-only mapping protocol (cached parse) --------------------------

    def __getitem__(self, k):
        return self._cached()[k]

    def get(self, k, default=None):
        obj = self._cached()
        return obj.get(k, default) if isinstance(obj, dict) else default

    def __contains__(self, k):
        return k in self._cached()

    def __iter__(self):
        return iter(self._cached())

    def __len__(self):
        return len(self._cached())

    def keys(self):
        return self._cached().keys()

    def values(self):
        return self._cached().values()

    def items(self):
        return self._cached().items()

    def __eq__(self, other):
        if isinstance(other, RawJson):
            other = other._cached()
        return self._cached() == other

    def __bool__(self):
        return bool(self._cached())

    def __repr__(self):
        return f"RawJson({self.text!r})"


def jsonb_dumps(value) -> str:
    """Serialize a stored JSONB value — raw text splices straight through."""
    if isinstance(value, RawJson):
        return value.text
    return json.dumps(value)


def sidecar_line(named_values, i: int) -> str | None:
    """One annotation-sidecar JSONL line for row ``i`` (None when the row
    carries no values) — byte-identical to the reference's writer.
    RawJson values write their text verbatim (no parse/re-serialize)."""
    parts = []
    for c, v in named_values:
        if v is None:
            continue
        if isinstance(v, RawJson):
            parts.append(f'"{c}":{v.text}')
        elif c == _LONG_ALLELES:
            parts.append(f'"{c}":{json.dumps(list(v))}')
        else:
            parts.append(f'"{c}":{json.dumps(v)}')
    if not parts:
        return None
    parts.append(f'"i":{i}')
    return "{" + ",".join(parts) + "}\n"


class Segment:
    """One sorted run of rows: numeric columns + packed alleles + object cols.

    Rows are sorted by (pos, hash); within equal keys, original append order
    is preserved (first-wins duplicate semantics).  ``backing`` is the
    on-disk identity: the ordered list of saved segment ids whose files,
    merged left-to-right, reproduce this segment exactly (None = never
    saved)."""

    __slots__ = ("n", "cols", "ref", "alt", "obj", "backing", "dirty",
                 "_key", "_device", "_numpy_query_volume", "residency")

    def __init__(self, cols, ref, alt, obj, backing=None):
        self.n = int(ref.shape[0])
        self.cols = cols
        self.ref = ref
        self.alt = alt
        self.obj = obj
        self.backing: list[int] | None = backing
        self.dirty = True
        self._key = None
        #: (device, identity tensors) once uploaded for torch probes
        self._device = None
        self._numpy_query_volume = 0  # ski-rental accumulator (see probe)
        # None = the segment decides its own device cache (ski-rental in
        # wants_device); "managed" = a serving residency manager
        # (serve/residency.py) owns upload and eviction under a byte budget:
        # probes then use the cache it installed and never upload one
        self.residency: str | None = None

    @property
    def key(self) -> np.ndarray:
        if self._key is None:
            self._key = combined_key(self.cols["pos"], self.cols["h"])
        return self._key

    @property
    def key_min(self) -> np.uint64:
        return self.key[0]

    @property
    def key_max(self) -> np.uint64:
        return self.key[-1]

    def overlaps(self, other: "Segment") -> bool:
        """Whether this segment's key range intersects ``other``'s."""
        if self.n == 0 or other.n == 0:
            return False
        return not (self.key_max < other.key_min
                    or other.key_max < self.key_min)

    # -- construction -------------------------------------------------------

    @classmethod
    def build(cls, rows: dict, ref, alt, annotations=None, digest_pk=None,
              long_alleles=None) -> "Segment":
        """Create a sorted segment from one flush's rows (any input order).

        Already-sorted input (the insert loader pre-sorts each flush by
        identity key) skips the argsort AND the per-column gather — the
        arrays are owned as-is, so build is O(n) dtype checks."""
        k = rows["pos"].shape[0]
        cols = {}
        for name, dtype in _NUMERIC_COLUMNS:
            if name in rows:
                cols[name] = np.asarray(rows[name], dtype)
            elif name in ("ref_snp", "is_adsp_variant"):
                cols[name] = np.full((k,), -1, dtype)
            else:
                cols[name] = np.zeros((k,), dtype)
        key = combined_key(cols["pos"], cols["h"])
        if k <= 1 or bool((key[1:] >= key[:-1]).all()):
            order = None
        else:
            order = np.argsort(key, kind="stable")
            key = key[order]
            cols = {name: col[order] for name, col in cols.items()}

        obj = {}
        for c in JSONB_COLUMNS:
            src = annotations.get(c) if annotations else None
            obj[c] = _obj_array(src, order, k)
        obj[_DIGEST_PK] = _obj_array(digest_pk, order, k)
        obj[_LONG_ALLELES] = _obj_array(long_alleles, order, k)
        ref = np.asarray(ref)
        alt = np.asarray(alt)
        seg = cls(
            cols,
            ref if order is None else ref[order],
            alt if order is None else alt[order],
            obj,
        )
        seg._key = key
        return seg

    @classmethod
    def merge(cls, older: "Segment", newer: "Segment") -> "Segment":
        """Stable two-way merge (older rows first on equal keys).

        Position-sorted loads append monotonically, so the newer segment's
        keys usually all sort after the older's — that case is a pure
        concatenation (sequential memcpy, no gather)."""
        ka, kb = older.key, newer.key
        n = older.n + newer.n
        if older.n == 0 or newer.n == 0 or kb[0] > ka[-1]:
            def merge_col(a, b):
                return np.concatenate([a, b])
        else:
            pos_a = np.searchsorted(kb, ka, side="left") + np.arange(older.n)
            pos_b = np.searchsorted(ka, kb, side="right") + np.arange(newer.n)

            def merge_col(a, b):
                out = np.empty((n,) + a.shape[1:], a.dtype)
                out[pos_a] = a
                out[pos_b] = b
                return out

        cols = {name: merge_col(older.cols[name], newer.cols[name])
                for name, _ in _NUMERIC_COLUMNS}
        obj = {}
        for c in OBJECT_COLUMNS:
            a, b = older.obj[c], newer.obj[c]
            obj[c] = None if a is None and b is None else merge_col(
                _dense(a, older.n), _dense(b, newer.n)
            )
        seg = cls(cols, merge_col(older.ref, newer.ref),
                  merge_col(older.alt, newer.alt), obj)
        # both inputs' keys are already materialized for the guard/scatter:
        # hand the merged key to the new segment so its next probe skips
        # the O(n) recompute
        seg._key = merge_col(ka, kb)
        # two CLEAN segments merge into a clean segment whose on-disk
        # identity is the concatenation of their files (stable merge is
        # associative, so loading [a..., b...] left-to-right reproduces
        # this exact row order) — the append-only persistence invariant
        if not older.dirty and not newer.dirty and older.backing and newer.backing:
            seg.backing = older.backing + newer.backing
            seg.dirty = False
        return seg

    @classmethod
    def merge_many(cls, parts: list["Segment"]) -> "Segment":
        """Merge an ordered list of segments in one pass.

        The common shape — consecutive ascending DISJOINT runs, which is
        what a position-sorted load accumulates and what a backing group
        persists — is a single multi-way ``np.concatenate`` per column
        (each row copied once).  Anything else falls back to a balanced
        pairwise tree, O(n log k) instead of the O(n·k) a left fold pays."""
        if not parts:
            raise ValueError("merge_many of an empty part list")
        if len(parts) == 1:
            return parts[0]
        live = [p for p in parts if p.n > 0]
        chain = all(
            live[i].key_max < live[i + 1].key_min
            for i in range(len(live) - 1)
        )
        if not chain or len(live) < 2:
            merged = parts
            while len(merged) > 1:  # balanced pairwise tree
                merged = [
                    cls.merge(merged[i], merged[i + 1])
                    if i + 1 < len(merged) else merged[i]
                    for i in range(0, len(merged), 2)
                ]
            return merged[0]
        cols = {
            name: np.concatenate([p.cols[name] for p in live])
            for name, _ in _NUMERIC_COLUMNS
        }
        obj = {}
        for c in OBJECT_COLUMNS:
            if all(p.obj[c] is None for p in live):
                obj[c] = None
            else:
                obj[c] = np.concatenate(
                    [_dense(p.obj[c], p.n) for p in live]
                )
        seg = cls(
            cols,
            np.concatenate([p.ref for p in live]),
            np.concatenate([p.alt for p in live]),
            obj,
        )
        seg._key = np.concatenate([p.key for p in live])
        # backing/dirty propagate over ALL parts (an empty persisted part
        # still owns its on-disk files and must stay referenced)
        if all(not p.dirty and p.backing for p in parts):
            seg.backing = [sid for p in parts for sid in p.backing]
            seg.dirty = False
        return seg

    # -- membership ---------------------------------------------------------

    def wants_device(self, nq: int, device: torch.device | None) -> bool:
        """Whether a probe of ``nq`` rows runs the torch probe on ``device``
        (see :func:`device_lookup_mode`).  Unlike the reference, which turns
        device lookups off on a CPU backend and latches them off after one
        failure, ``always`` honours the CPU too and errors propagate.  A
        segment a residency manager governs (``residency == "managed"``)
        probes on ``device`` only through the cache the manager installed."""
        if device is None:
            return False
        mode = device_lookup_mode()
        if mode == "off":
            return False
        if self.residency == "managed":
            dev = self._device
            return dev is not None and dev[0] == device
        if mode == "always":
            return True
        if device.type != "cuda":
            return False
        if self._device is not None and self._device[0] == device:
            return True  # an uploaded cache is sunk cost
        return (self.n >= DEVICE_SEGMENT_MIN and nq >= DEVICE_QUERY_MIN
                and (self._numpy_query_volume + nq)
                * DEVICE_UPLOAD_AMORTIZE >= self.n)

    def probe(self, qkey, pos, h, ref, alt, ref_len, alt_len,
              device: torch.device | None = None, stats: dict | None = None):
        """(found [N] bool, local index [N] int32; -1 when absent).

        ``device``: where the torch probe may run (None = host numpy only).
        ``stats``: optional counter dict, incremented under ``"device"`` or
        ``"host"`` for the path this probe took."""
        if self.n == 0:
            return np.zeros(pos.shape, np.bool_), np.full(pos.shape, -1, np.int32)
        nq = pos.shape[0]
        # the cache is read once: a residency manager may evict it from
        # another thread, and a managed segment whose cache vanished after
        # the check probes on the host instead of uploading one
        cached = self._device
        if self.wants_device(nq, device) and (
                self.residency != "managed"
                or (cached is not None and cached[0] == device)):
            if stats is not None:
                stats["device"] = stats.get("device", 0) + 1
            return self._probe_device(device, pos, h, ref, alt, ref_len,
                                      alt_len, cached=cached)
        if stats is not None:
            stats["host"] = stats.get("host", 0) + 1
        self._numpy_query_volume += nq
        lo = np.searchsorted(self.key, qkey, side="left")
        found = np.zeros(nq, np.bool_)
        index = np.full(nq, -1, np.int32)
        # equal-(pos,hash) runs are length 1 barring 2^-32 collisions; probe
        # up to 4, comparing the wide allele rows only where the key matches
        for k in range(4):
            i = np.clip(lo + k, 0, self.n - 1)
            keyeq = (lo + k < self.n) & (self.key[i] == qkey)
            if not keyeq.any():
                break
            rows_q = np.where(keyeq & ~found)[0]
            if rows_q.size == 0:
                continue
            ii = i[rows_q]
            cand = (
                (self.cols["ref_len"][ii] == ref_len[rows_q])
                & (self.cols["alt_len"][ii] == alt_len[rows_q])
                & (self.ref[ii] == ref[rows_q]).all(axis=1)
                & (self.alt[ii] == alt[rows_q]).all(axis=1)
            )
            sel = rows_q[cand]
            index[sel] = ii[cand]
            found[sel] = True
        return found, index

    def _ensure_device_cache(self, device: torch.device) -> tuple:
        """Upload this segment's identity columns to ``device`` (once).
        Hashes travel as int64 so torch compares them as unsigned 32-bit
        values.  No power-of-two padding: torch has no per-shape compile
        to bound."""
        from annotatedvdb_tpu_torch.runtime import to_device

        if self._device is None or self._device[0] != device:
            self._device = (device, tuple(
                to_device(x, device) for x in (
                    self.cols["pos"], self.cols["h"].astype(np.int64),
                    self.ref, self.alt,
                    self.cols["ref_len"], self.cols["alt_len"],
                )
            ))
        return self._device[1]

    def _probe_device(self, device, pos, h, ref, alt, ref_len, alt_len,
                      cached=None):
        """Membership through ``ops/dedup.lookup_in_sorted`` against the
        device copy of this segment's identity columns (``cached``: the
        caller's captured ``(device, tensors)``, else built here)."""
        from annotatedvdb_tpu_torch.ops.dedup import lookup_in_sorted
        from annotatedvdb_tpu_torch.runtime import to_device

        if cached is not None and cached[0] == device:
            cache = cached[1]
        else:
            cache = self._ensure_device_cache(device)
        query = [to_device(x, device) for x in (
            np.asarray(pos, np.int32), np.asarray(h).astype(np.int64),
            ref, alt, np.asarray(ref_len, np.int32),
            np.asarray(alt_len, np.int32),
        )]
        found, index = lookup_in_sorted(*cache, *query)
        return found.cpu().numpy(), index.cpu().numpy()

    # -- mutation -----------------------------------------------------------

    def filter(self, keep: np.ndarray) -> "Segment":
        """A new (dirty, never saved) segment of the rows where ``keep``."""
        return Segment(
            {name: col[keep] for name, col in self.cols.items()},
            self.ref[keep], self.alt[keep],
            {c: (None if a is None else a[keep]) for c, a in self.obj.items()},
        )

    def obj_dense(self, name: str) -> np.ndarray:
        """Object column, materialized into the segment if still all-None."""
        if self.obj[name] is None:
            self.obj[name] = np.full((self.n,), None, object)
        return self.obj[name]


def _obj_array(values, order: np.ndarray | None, n: int) -> np.ndarray | None:
    """Object column from per-row values; None when the column is all-None
    (lazily-materialized columns keep annotation-free segments free).
    ``order=None`` means the rows are already in sorted order."""
    if values is None or all(v is None for v in values):
        return None
    out = np.empty((n,), object)
    if order is None:
        out[:] = list(values) if not isinstance(values, np.ndarray) else values
    else:
        for j, i in enumerate(order):
            out[j] = values[i]
    return out


def _dense(arr: np.ndarray | None, n: int) -> np.ndarray:
    return np.full((n,), None, object) if arr is None else arr


class ChromosomeShard:
    """One chromosome's rows: a list of sorted segments, oldest first."""

    def __init__(self, chrom_code: int, width: int):
        self.chrom_code = int(chrom_code)
        self.width = width
        self.segments: list[Segment] = []

    @property
    def n(self) -> int:
        return sum(s.n for s in self.segments)

    # -- whole-column views (any segment count, global-id order) ------------

    def column(self, name: str) -> np.ndarray:
        """Full numeric column concatenated in global-id order."""
        if not self.segments:
            return np.empty((0,), dict(_NUMERIC_COLUMNS)[name])
        return np.concatenate([s.cols[name] for s in self.segments])

    def object_column(self, name: str) -> np.ndarray:
        """Full object column concatenated in global-id order (a copy:
        mutate through :meth:`update_annotation`, not this view)."""
        if not self.segments:
            return np.empty((0,), object)
        return np.concatenate([_dense(s.obj[name], s.n) for s in self.segments])

    # -- per-row access by global id ----------------------------------------
    # Global ids number the rows of the segments in list order.  They stay
    # valid until the segment list changes (append, merge).

    def _starts(self) -> np.ndarray:
        """Global id of each segment's first row, and the row count last."""
        return np.concatenate(
            [[0], np.cumsum([s.n for s in self.segments])]
        ).astype(np.int64)

    def locate_row(self, gid: int) -> tuple["Segment", int]:
        """(segment, local offset) for one global row id — the per-row read
        accessor the serving path renders records through."""
        gid = int(gid)
        starts = self._starts()
        si = int(starts.searchsorted(gid, side="right")) - 1
        return self.segments[si], gid - int(starts[si])

    def _locate(self, ids) -> tuple[np.ndarray, np.ndarray]:
        """Global ids -> (segment index, local offset), vectorized."""
        ids = np.asarray(ids, np.int64)
        starts = self._starts()
        seg = np.searchsorted(starts, ids, side="right") - 1
        return seg, ids - starts[seg]

    # -- flat single-segment views (whole-shard passes) ---------------------
    # The CADD join and VCF export walk the shard in position-sorted order:
    # they call compact() once, after which global ids coincide with sorted
    # order and these views are O(1).  Accessing a flat view COMPACTS the
    # shard, which renumbers global ids — never hold ids from an earlier
    # lookup across a flat-view access.

    def _single(self) -> Segment:
        if len(self.segments) != 1:
            self.compact()
        if not self.segments:  # empty shard: materialize one empty segment
            self.segments.append(Segment.build(
                {"pos": np.empty((0,), np.int32)},
                np.empty((0, self.width), np.uint8),
                np.empty((0, self.width), np.uint8),
            ))
        return self.segments[0]

    @property
    def cols(self) -> dict:
        return self._single().cols

    @property
    def ref(self) -> np.ndarray:
        return self._single().ref

    @property
    def alt(self) -> np.ndarray:
        return self._single().alt

    @property
    def annotations(self) -> dict:
        """Every JSONB column of the compacted shard (all-None columns
        as fresh arrays; the segment is not changed)."""
        seg = self._single()
        return {c: _dense(seg.obj[c], seg.n) for c in JSONB_COLUMNS}

    def compact(self) -> None:
        """Merge all segments into one (position-sorted global ids)."""
        if len(self.segments) > 1:
            # one splice after the merge completes, as in maintain()
            self.segments[:] = [Segment.merge_many(list(self.segments))]

    def alleles(self, i: int) -> tuple[str, str]:
        """True (ref, alt) strings of row ``i`` — exact even for the
        long-allele tail whose device arrays are width-truncated."""
        seg, off = self._locate([i])
        s, j = self.segments[int(seg[0])], int(off[0])
        if s.obj[_LONG_ALLELES] is not None and s.obj[_LONG_ALLELES][j] is not None:
            return tuple(s.obj[_LONG_ALLELES][j])
        ref_len = int(s.cols["ref_len"][j])
        alt_len = int(s.cols["alt_len"][j])
        if ref_len > self.width or alt_len > self.width:
            # a truncated prefix would silently corrupt joins and exports
            raise ValueError(
                f"row {i}: allele length {max(ref_len, alt_len)} exceeds device "
                f"width {self.width} but the original strings were not retained "
                "(store predates long-allele retention; reload from source)"
            )
        return (
            decode_allele(s.ref[j], ref_len),
            decode_allele(s.alt[j], alt_len),
        )

    def get_col(self, name: str, ids) -> np.ndarray:
        seg, off = self._locate(ids)
        out = np.empty(seg.shape, dtype=dict(_NUMERIC_COLUMNS)[name])
        for si in np.unique(seg):
            m = seg == si
            out[m] = self.segments[si].cols[name][off[m]]
        return out

    def set_col(self, name: str, ids, values) -> None:
        if name in _IDENTITY_COLUMNS:
            raise ValueError(f"identity column {name} is immutable")
        seg, off = self._locate(ids)
        values = np.broadcast_to(np.asarray(values), seg.shape)
        for si in np.unique(seg):
            m = seg == si
            s = self.segments[si]
            s.cols[name][off[m]] = values[m]
            s.dirty = True

    def set_flag(self, index: np.ndarray, column: str, values) -> None:
        """:meth:`set_col` on the rows of ``index`` that were found
        (``index >= 0``); ``values`` is a scalar or parallel to ``index``."""
        index = np.asarray(index, np.int64)
        mask = index >= 0
        self.set_col(
            column, index[mask],
            np.asarray(values)[mask] if np.ndim(values) else values,
        )

    def get_ann(self, column: str, i):
        """One row's JSONB value (None when unset) — the stored object
        itself, not a copy.  A RawJson value is materialized ON THE ROW
        first (a fresh parse: one RawJson may back several rows)."""
        seg, off = self._locate([i])
        col = self.segments[int(seg[0])].obj[column]
        if col is None:
            return None
        v = col[int(off[0])]
        if isinstance(v, RawJson):
            v = col[int(off[0])] = v.fresh()
        return v

    def lookup(self, pos, h, ref, alt, ref_len, alt_len,
               device: torch.device | None = None, stats: dict | None = None):
        """Vectorized membership: (found [N] bool, global id [N] int64).

        Oldest segment wins when an identity appears in several segments
        (first-wins duplicate policy).  Each segment probe takes the path
        :meth:`Segment.probe` chooses for ``device`` and counts it in
        ``stats``."""
        found = np.zeros(pos.shape, np.bool_)
        index = np.full(pos.shape, -1, np.int64)
        if not self.segments:
            return found, index
        qkey = combined_key(pos, h)
        if qkey.size == 0:
            return found, index
        # range pruning: a segment whose key range misses the query range
        # cannot match
        qlo, qhi = qkey.min(), qkey.max()
        starts = self._starts()
        for si, seg in enumerate(self.segments):
            if seg.n == 0 or seg.key_max < qlo or seg.key_min > qhi:
                continue
            if found.all():
                break
            f, idx = seg.probe(qkey, pos, h, ref, alt, ref_len, alt_len,
                               device=device, stats=stats)
            take = f & ~found
            index = np.where(take, idx.astype(np.int64) + starts[si], index)
            found |= f
        return found, index

    def update_annotation(self, index: np.ndarray, column: str,
                          values, merge: bool = True) -> int:
        """Set/merge a JSONB column at given global ids; returns the update
        count (ids < 0 are skipped).

        ``merge=True`` applies jsonb_merge deep-merge semantics (patch wins,
        into the stored dict in place); ``merge=False`` replaces.  Rows with
        no stored value are assigned with one scatter per segment; only rows
        that merge pay per-row work.  Duplicate ids within one call keep
        strict in-order semantics (the second occurrence merges into the
        first's result).  A RawJson on either side of a merge is
        materialized fresh first, so a shared RawJson is never mutated."""
        index = np.asarray(index, np.int64)
        if index.size == 0:
            return 0
        vals = np.empty(index.shape, object)
        # element-wise: bulk list -> object-array assignment would probe
        # each element for nested sequences
        for k, v in enumerate(values):
            vals[k] = v
        valid = index >= 0
        count = int(valid.sum())
        if count == 0:
            return 0
        if not valid.all():
            index, vals = index[valid], vals[valid]
        seg_idx, off = self._locate(index)
        for si in np.unique(seg_idx):
            s = self.segments[int(si)]
            fresh_col = s.obj[column] is None  # never materialized: every
            col = s.obj_dense(column)          # target row is fresh
            m = seg_idx == si
            offs, vs = off[m], vals[m]
            s.dirty = True
            has_dups = np.unique(offs).size != offs.size
            if fresh_col and not has_dups:
                col[offs] = vs
                continue
            if has_dups:
                # order is observable: later values merge into earlier
                # results
                for j, v in zip(offs.tolist(), vs):
                    cur = col[j]
                    if (merge and isinstance(cur, (dict, RawJson))
                            and isinstance(v, (dict, RawJson))):
                        if isinstance(cur, RawJson):
                            cur = col[j] = cur.fresh()
                        deep_update(
                            cur, v.fresh() if isinstance(v, RawJson) else v
                        )
                    else:
                        col[j] = v
                continue
            cur = col[offs]
            if merge:
                replace = np.fromiter(
                    (not isinstance(c, (dict, RawJson))
                     or not isinstance(v, (dict, RawJson))
                     for c, v in zip(cur, vs)),
                    bool, offs.size,
                )
            else:
                replace = np.ones(offs.size, bool)
            col[offs[replace]] = vs[replace]
            km = ~replace
            for j, c, v in zip(offs[km].tolist(), cur[km], vs[km]):
                # materialize raw values per row (fresh: a RawJson may back
                # several rows) before mutating
                if isinstance(c, RawJson):
                    c = col[j] = c.fresh()
                deep_update(c, v.fresh() if isinstance(v, RawJson) else v)
        return count

    # -- mutation -----------------------------------------------------------

    def delete_by_algorithm(self, alg_id: int) -> int:
        """Drop every row stamped with ``alg_id``; returns the rows removed.
        Untouched segments stay as they are (clean ones keep their files);
        a segment that loses rows is replaced by a new dirty one."""
        removed = 0
        kept: list[Segment] = []
        for s in self.segments:
            keep = s.cols["row_algorithm_id"] != alg_id
            k = int((~keep).sum())
            if k == 0:
                kept.append(s)
                continue
            removed += k
            if k < s.n:
                kept.append(s.filter(keep))
        if removed:
            self.segments = kept
        return removed

    def append_segment(self, seg: Segment) -> None:
        """O(1) append of a prebuilt sorted segment, no cascade merge.

        The async insert pipeline appends here, persists, and runs
        :meth:`maintain` afterwards — merging clean (persisted) segments
        keeps their backing files referenced instead of rewriting them, so
        per-checkpoint disk writes stay O(new rows)."""
        if seg.n == 0:
            return
        self.segments.append(seg)

    def maintain(self) -> None:
        """Keep membership-probe cost flat without paying merge copies.

        Two-part policy (Postgres analog: append heap pages, defer vacuum,
        ``createVariant.sql:4`` / ``alterAutoVacuum.sql:2-19``):

        - OVERLAPPING tail segments cascade-merge size-tiered (geometric
          sizes, O(log n) count, O(n log n) total work) — range pruning
          cannot skip them, so their count must stay logarithmic;
        - DISJOINT tail segments are left alone: a position-sorted load
          appends strictly-ascending runs, probes skip them by range
          (``lookup``), and merging would copy every row O(log n) times
          for no probe savings.  Only when the count passes MAX_SEGMENTS
          does ``_collapse`` concatenate consecutive runs back into
          MERGE_SEGMENT_CAP-sized segments (amortized O(1) copies/row).
        """
        while (len(self.segments) >= 2
               and self.segments[-2].n <= 2 * self.segments[-1].n
               and self.segments[-2].n <= MERGE_SEGMENT_CAP
               and self.segments[-2].overlaps(self.segments[-1])):
            merged = Segment.merge(self.segments[-2], self.segments[-1])
            # single splice AFTER the merge completes: a concurrent reader
            # snapshotting the list (the loader's membership probe) must
            # never observe a window where the older rows are in neither
            # the list nor the in-flight set — pop-then-merge would open
            # one for the whole O(n) merge
            self.segments[-2:] = [merged]
        if len(self.segments) > MAX_SEGMENTS:
            self._collapse()

    def _collapse(self) -> None:
        """Merge consecutive segments into ~MERGE_SEGMENT_CAP-row groups.

        Runs every ~MAX_SEGMENTS flushes at most, so each row is copied
        amortized O(1) times between collapses.  Same atomic-splice
        discipline as ``maintain`` — the list is rewritten group by group,
        never holding rows outside it."""
        i = 0
        while i < len(self.segments) - 1:
            j = i + 1
            total = self.segments[i].n
            while (j < len(self.segments)
                   and total + self.segments[j].n <= MERGE_SEGMENT_CAP):
                total += self.segments[j].n
                j += 1
            if j - i >= 2:
                merged = Segment.merge_many(self.segments[i:j])
                self.segments[i:j] = [merged]
            i += 1


class VariantStore:
    """All chromosome shards + incremental persistence."""

    def __init__(self, width: int):
        import uuid

        self.width = width
        #: read-only stores (``load(..., readonly=True)``) refuse ``save``
        #: and never materialize shards on access: a serving read path must
        #: not create directories or persist empty shards
        self.readonly = False
        self.shards: dict[int, ChromosomeShard] = {}
        self._next_seg_id = 1
        # per-stem write-time integrity records ({stem: {npz: {bytes, crc32},
        # jsonl: {...}}}), carried in the manifest so load can detect torn
        # or bit-rotted segment files
        self._integrity: dict[str, dict] = {}
        #: advisory chromosome->device placement block read back from the
        #: manifest (written by save() when a >1-device mesh is
        #: configured) — None for single-device stores
        self.mesh_placement: dict | None = None
        # identity of THIS store's on-disk lineage: save() only trusts
        # pre-existing segment files in a directory whose manifest carries
        # this uid
        self._uid = uuid.uuid4().hex
        # cooperative-writer adoption (see save()): the next_seg_id of the
        # manifest this store was loaded from (None for a fresh store),
        # and every seg id this store allocated itself
        self._sid_floor: int | None = None
        self._my_sids: set[int] = set()

    def shard(self, chrom_code: int) -> ChromosomeShard:
        code = int(chrom_code)
        if code not in self.shards:
            if self.readonly:
                raise RuntimeError(
                    f"readonly store: shard {code} does not exist and must "
                    "not be created by a read path (use store.shards.get)"
                )
            self.shards[code] = ChromosomeShard(code, self.width)
        return self.shards[code]

    @property
    def n(self) -> int:
        return sum(s.n for s in self.shards.values())

    def delete_by_algorithm(self, alg_id: int) -> int:
        """Undo a load: drop every row stamped with ``alg_id``
        (``undo_variant_load.py:21-67`` semantics, without the chunked
        DELETE back-off a columnar mask does not need)."""
        return sum(s.delete_by_algorithm(alg_id) for s in self.shards.values())

    def compact(self) -> None:
        for s in self.shards.values():
            s.compact()

    def pin_for_updates(self, device: torch.device) -> int:
        """Upload the identity columns of every segment of at least
        DEVICE_SEGMENT_MIN rows to ``device``'s membership cache: update
        loads (VEP/CADD/QC) probe a static store many times, so the one
        upload amortizes over the whole file, and a cached segment's probes
        then run on the card (:meth:`Segment.wants_device`).  Nothing on the
        CPU or with ``AVDB_DEVICE_LOOKUP=off``.  Returns the segments
        pinned."""
        if device.type != "cuda" or device_lookup_mode() == "off":
            return 0
        pinned = 0
        for shard in self.shards.values():
            for seg in shard.segments:
                if seg.n >= DEVICE_SEGMENT_MIN:
                    seg._ensure_device_cache(device)
                    pinned += 1
        return pinned

    # -- persistence --------------------------------------------------------
    #
    # Layout v3: manifest.json lists each shard's segments in order, each as
    # a GROUP of saved segment ids — an in-memory segment merged from
    # already-persisted segments is manifested as the list of its
    # constituents' ids (merged left-to-right on load), so merges never
    # rewrite rows on disk.  Every segment file is one flat container
    # (numeric cols + alleles) plus one sparse JSONL (object columns, only
    # rows that have any).

    def _dir_manifest(self, path: str) -> dict | None:
        """The directory's CURRENT manifest when it belongs to THIS
        store's lineage (carries our uid), else None."""
        try:
            with open(os.path.join(path, "manifest.json")) as f:
                manifest = json.load(f)
        except (OSError, ValueError):
            return None
        if not isinstance(manifest, dict) \
                or manifest.get("store_uid") != self._uid:
            return None
        return manifest

    def _adoptable_groups(self, on_disk: dict | None) -> dict:
        """{label: [group, ...]} of backing groups another cooperative
        writer (a serve worker's memtable flush) committed into this
        directory since this store loaded — detected by seg id: at or
        above the load-time floor and not allocated by this store.  save()
        carries these forward verbatim: dropping them would destroy rows
        this store never held (for a flush, acknowledged upserts whose WAL
        was already truncated).  Groups below the floor are this store's
        own to manage, including not carrying them when an undo dropped
        their rows."""
        if self._sid_floor is None or on_disk is None:
            return {}
        if int(on_disk.get("next_seg_id", 1)) <= self._sid_floor:
            return {}  # no id at or above the floor can exist in it
        floor = self._sid_floor
        fmt2 = on_disk.get("format") == 2
        adopted: dict[str, list] = {}
        for label, groups in (on_disk.get("shards") or {}).items():
            norm = [[g] for g in groups] if fmt2 else groups
            keep = [
                list(group) for group in norm
                if group and all(
                    isinstance(sid, int) and sid >= floor
                    and sid not in self._my_sids for sid in group
                )
            ]
            if keep:
                adopted[label] = keep
        return adopted

    @staticmethod
    def _peek_segment_rows(path: str, stem: str) -> int:
        """Row count of one on-disk segment from its container header
        alone — the stats entry of an adopted group.  Best-effort: stats
        are advisory, a parse failure reports 0."""
        fp = os.path.join(path, stem + ".npz")
        try:
            with open(fp, "rb") as f:
                head = f.readline()
                if not head.startswith(b"{"):
                    with open(fp, "rb") as zf:  # legacy zip npz
                        with np.load(zf) as z:
                            return int(z["ref"].shape[0])
                meta = json.loads(head)
                if "rows" in meta:
                    return int(meta["rows"])
                version = np.lib.format.read_magic(f)
                if version == (1, 0):
                    shape, _f, _d = np.lib.format.read_array_header_1_0(f)
                elif version == (2, 0):
                    shape, _f, _d = np.lib.format.read_array_header_2_0(f)
                else:
                    return 0
                return int(shape[0])
        except (OSError, ValueError, KeyError):
            return 0

    def save(self, path: str) -> None:
        if self.readonly:
            raise RuntimeError(
                "readonly store: save() is forbidden (opened with "
                "readonly=True — reload without it to mutate)"
            )
        os.makedirs(path, exist_ok=True)
        on_disk = self._dir_manifest(path)
        trusted = on_disk is not None
        # cooperative-writer sync: groups a memtable flush committed since
        # this store loaded or last saved are carried forward below, and
        # their seg ids are never allocated again here
        adopted = self._adoptable_groups(on_disk)
        if trusted:
            self._next_seg_id = max(
                self._next_seg_id, int(on_disk.get("next_seg_id", 1))
            )
        live_files = {"manifest.json"}
        manifest = {
            "format": 3, "width": self.width, "store_uid": self._uid,
            "shards": {},
        }
        # walk shards in sorted-code order, allocating seg ids and manifest
        # groups exactly as the reference's save does (byte-identical
        # manifests for identical stores)
        for code, shard in sorted(self.shards.items()):
            label = chromosome_label(code)
            groups = []
            for seg in shard.segments:
                stems = (
                    [f"chr{label}.{sid:06d}" for sid in seg.backing]
                    if seg.backing else []
                )
                ids = list(seg.backing) if seg.backing else []
                if (seg.dirty or not stems or not trusted
                        # a clean segment saved to a DIFFERENT directory
                        # earlier: its files aren't here, rewrite
                        or not all(
                            os.path.exists(os.path.join(path, s + ".npz"))
                            and os.path.exists(
                                os.path.join(path, s + ".ann.jsonl"))
                            for s in stems)):
                    # EVERY (re-)write takes a fresh seg id, so a
                    # manifested segment's files are never touched in
                    # place — the manifest swap below is the single
                    # commit point
                    sid = self._next_seg_id
                    self._next_seg_id += 1
                    self._my_sids.add(sid)
                    stems = [f"chr{label}.{sid:06d}"]
                    ids = [sid]
                    self._integrity[stems[0]] = self._write_segment(
                        path, stems[0], seg
                    )
                    seg.backing = [sid]
                    seg.dirty = False
                for stem in stems:
                    live_files.update({stem + ".npz", stem + ".ann.jsonl"})
                groups.append(ids)
            manifest["shards"][label] = groups
        # adopted groups go after this store's own (they are the newer
        # writes: first-wins order on disk matches the overlay their
        # writer served), with their integrity records
        adopted_rows: dict[str, int] = {}
        for label, groups in sorted(adopted.items()):
            manifest["shards"].setdefault(label, [])
            rows = 0
            for group in groups:
                manifest["shards"][label].append(list(group))
                for sid in group:
                    stem = f"chr{label}.{sid:06d}"
                    live_files.update({stem + ".npz", stem + ".ann.jsonl"})
                    rec = (on_disk.get("integrity") or {}).get(stem)
                    if rec is not None:
                        self._integrity[stem] = rec
                    rows += self._peek_segment_rows(path, stem)
            adopted_rows[label] = rows
        manifest["next_seg_id"] = self._next_seg_id
        # write-time integrity records for every LIVE segment file (size +
        # crc32 of the exact bytes handed to the OS), sorted for the
        # deterministic-manifest invariant
        live_stems = sorted({
            f[: -len(".npz")] for f in live_files if f.endswith(".npz")
        })
        manifest["integrity"] = {
            stem: self._integrity[stem]
            for stem in live_stems if stem in self._integrity
        }
        # residency stats, deterministic on store content only
        stats_rows = {
            chromosome_label(code): int(shard.n)
            for code, shard in sorted(self.shards.items())
        }
        for label, rows in sorted(adopted_rows.items()):
            stats_rows[label] = stats_rows.get(label, 0) + rows
        manifest["stats"] = {
            "rows": stats_rows,
            "segments": {
                label: len(groups)
                for label, groups in manifest["shards"].items()
            },
        }
        # advisory mesh placement: which device each chromosome group would
        # serve from under the configured AVDB_MESH_SHAPE (absent on a
        # single-device resolution); deterministic on the environment and
        # the content only, so save() never touches a device
        from annotatedvdb_tpu_torch.parallel.placement import placement_hint

        placement = placement_hint()
        if placement is not None:
            manifest["mesh_placement"] = placement
        # atomic swap: a process crash mid-save leaves the previous
        # manifest intact (segments are also written via tmp+rename, so the
        # old manifest's files are never mutated in place).
        # crash point: every segment of this checkpoint is on disk, the
        # commit (manifest swap) has not happened — a death here must leave
        # the PREVIOUS manifest fully consistent (new files are orphans)
        faults.fire("store.save.pre_manifest")
        tio.replace_manifest(os.path.join(path, "manifest.json"), manifest)
        for fname in os.listdir(path):
            if fname not in live_files and (
                    fname.endswith(".npz") or fname.endswith(".ann.jsonl")
                    # orphaned tmp files from crashed saves (any pid)
                    or (fname.startswith(".") and ".tmp" in fname)):
                tio.unlink(os.path.join(path, fname))
        # drop integrity records for files the cleanup just removed
        self._integrity = {
            stem: rec for stem, rec in self._integrity.items()
            if stem + ".npz" in live_files
        }

    @staticmethod
    def _write_segment(path: str, stem: str, seg: Segment) -> dict:
        # uncompressed: segments are rewritten on every cascade merge, and
        # deflate CPU dominates the persist stage at load throughput (the
        # reference's Postgres heap is uncompressed for the same reason).
        # tmp+rename: a re-persisted dirty segment (e.g. updated
        # annotations) must never corrupt the file the current manifest
        # references if the process dies mid-write
        fsync_data = tio.fsync_wanted()
        tmp = os.path.join(path, f".{stem}.tmp{os.getpid()}.npz")
        # width-trim the allele matrices to this segment's longest allele:
        # dbSNP/gnomAD-shaped data stores <=8-byte alleles in width-49
        # arrays, so ~85% of segment bytes would be zero padding (load
        # inflates back to the store width)
        ref, alt = seg.ref, seg.alt
        if seg.n and ref.shape[1] > 1:
            # clamp to the array width: over-width rows store full lengths
            # but only width bytes, so one 300bp indel must not forfeit the
            # whole segment's trim
            width = ref.shape[1]
            w = int(max(
                np.minimum(seg.cols["ref_len"], width).max(),
                np.minimum(seg.cols["alt_len"], width).max(), 1,
            ))
            if w < ref.shape[1]:
                ref = np.ascontiguousarray(ref[:, :w])
                alt = np.ascontiguousarray(alt[:, :w])
        # flat sequential container, NOT an npz: np.savez's zipfile
        # machinery (per-member seek-back size patching, 8KB buffered
        # writes, crc32 passes) was ~45% of checkpoint-persist CPU on
        # syscall-expensive filesystems.  Layout: one JSON name line, then
        # one raw .npy stream per column in that order.  The extension
        # stays .npz for manifest compatibility; _read_segment sniffs the
        # leading byte ('{' here vs zip's 'P'), so stores persisted by
        # older builds keep loading.
        arrays = {
            "ref": ref, "alt": alt,
            **{name: seg.cols[name] for name, _ in _NUMERIC_COLUMNS},
        }
        with open(tmp, "wb", buffering=1 << 20) as raw_f:
            # integrity record accumulates on the bytes in hand (see
            # _CrcWriter) — no post-hoc re-read pass
            f = _CrcWriter(raw_f)
            f.write(
                (json.dumps({"seg": 1, "names": list(arrays)}) + "\n")
                .encode()
            )
            first = True
            for arr in arrays.values():
                np.lib.format.write_array(f, arr, allow_pickle=False)
                if first:
                    # crash point: the container body is part-written (the
                    # tmp file tears, the manifested store must not notice)
                    faults.fire("store.save.mid_segment", raw_f)
                    first = False
            if fsync_data:
                f.flush()
                tio.fsync(raw_f)
        npz_rec = {"bytes": f.nbytes, "crc32": f.crc}
        tio.replace(tmp, os.path.join(path, stem + ".npz"))
        atmp = os.path.join(path, f".{stem}.tmp{os.getpid()}.ann.jsonl")
        with open(atmp, "wb") as raw_f:
            f = _CrcWriter(raw_f)
            present = [(c, seg.obj[c]) for c in OBJECT_COLUMNS
                       if seg.obj[c] is not None]
            for i in range(seg.n) if present else ():
                line = sidecar_line(
                    ((c, col[i]) for c, col in present), i
                )
                if line is not None:
                    f.write(line.encode())
            if fsync_data:
                f.flush()
                tio.fsync(raw_f)
        tio.replace(atmp, os.path.join(path, stem + ".ann.jsonl"))
        return {"npz": npz_rec, "jsonl": {"bytes": f.nbytes, "crc32": f.crc}}

    @classmethod
    def load(cls, path: str, readonly: bool = False) -> "VariantStore":
        """Load a persisted store (format 2 or 3, written by either
        package).  ``readonly=True`` marks the result read-only (``save``
        raises, missing shards are never materialized) — the serving
        path's open."""
        mpath = os.path.join(path, "manifest.json")
        try:
            with open(mpath) as f:
                manifest = json.load(f)
        except FileNotFoundError:
            raise FileNotFoundError(
                f"{mpath}: no store manifest — {path!r} is not a variant "
                "store directory, or its first save never completed; "
                + _fsck_hint(path)
            ) from None
        except (ValueError, OSError) as err:
            raise StoreCorruptError(
                f"{mpath}: unreadable store manifest ({err}); "
                + _fsck_hint(path)
            ) from err
        if not isinstance(manifest, dict):
            raise StoreCorruptError(
                f"{mpath}: manifest is not a JSON object; " + _fsck_hint(path)
            )
        fmt = manifest.get("format")
        if fmt not in (2, 3):
            raise ValueError(
                "unsupported store format (pre-segment layout); reload from "
                "source VCFs"
            )
        store = cls(manifest["width"])
        store._next_seg_id = manifest.get("next_seg_id", 1)
        # adoption floor (see save()): everything below this id is this
        # manifest's own lineage; a cooperative writer committing later
        # allocates at or above it
        store._sid_floor = int(store._next_seg_id)
        uid = manifest.get("store_uid")
        if uid:
            # resume this store's on-disk lineage: saves back into this
            # directory may trust its existing segment files.  Manifests
            # predating store_uid keep the fresh uid — the first save into
            # their directory rewrites segments once, then records the uid.
            store._uid = uid
        store._integrity = dict(manifest.get("integrity") or {})
        placement = manifest.get("mesh_placement")
        if isinstance(placement, dict):
            store.mesh_placement = placement
        verify = _verify_mode()
        from annotatedvdb_tpu_torch.types import chromosome_code

        for label, groups in manifest["shards"].items():
            if fmt == 2:  # v2: flat id list, one file per segment
                groups = [[sid] for sid in groups]
            shard = store.shard(chromosome_code(label))
            for group in groups:
                parts = [
                    cls._read_segment(
                        path, label, sid, store.width,
                        integrity=store._integrity.get(
                            f"chr{label}.{sid:06d}"
                        ),
                        verify=verify,
                    )
                    for sid in group
                ]
                # multi-way (concat for the common ascending-disjoint
                # chain, balanced tree otherwise) — a frozen group built
                # from many small checkpoints loads with each row copied
                # once, not O(parts) times
                seg = Segment.merge_many(parts)
                # merge propagated backing == group for clean inputs;
                # verify the invariant rather than trusting it (an
                # explicit raise — asserts vanish under ``python -O`` and
                # a violation here would persist wrong backing metadata
                # on the next save)
                if seg.backing != list(group) or seg.dirty:
                    raise ValueError(
                        f"store load: backing group {group} did not "
                        f"reassemble cleanly (got {seg.backing}, "
                        f"dirty={seg.dirty}); store files are inconsistent"
                    )
                shard.segments.append(seg)
        store.readonly = bool(readonly)
        return store

    @staticmethod
    def _check_file(fp: str, rec: dict | None, verify: str,
                    store_path: str) -> None:
        """Integrity gate for one segment file: size check whenever a record
        exists (free — one stat), full crc32 under ``AVDB_VERIFY=deep``."""
        if rec is None or verify == "off":
            return
        try:
            actual = os.path.getsize(fp)
        except OSError as err:
            raise StoreCorruptError(
                f"{fp}: unreadable segment file ({err}); "
                + _fsck_hint(store_path)
            ) from err
        if actual != rec["bytes"]:
            raise StoreCorruptError(
                f"{fp}: segment file is {actual} bytes, manifest integrity "
                f"record says {rec['bytes']} (torn or truncated write); "
                + _fsck_hint(store_path)
            )
        if verify == "deep":
            crc = crc32_file(fp)
            if crc != rec["crc32"]:
                raise StoreCorruptError(
                    f"{fp}: crc32 mismatch (stored {rec['crc32']:#010x}, "
                    f"computed {crc:#010x}) — bit rot or partial overwrite; "
                    + _fsck_hint(store_path)
                )

    @classmethod
    def _read_segment(cls, path: str, label: str, seg_id: int,
                      width: int, integrity: dict | None = None,
                      verify: str = "size") -> Segment:
        stem = f"chr{label}.{seg_id:06d}"
        fp = os.path.join(path, stem + ".npz")
        ap = os.path.join(path, stem + ".ann.jsonl")
        for p, key in ((fp, "npz"), (ap, "jsonl")):
            if not os.path.exists(p):
                raise StoreCorruptError(
                    f"{p}: segment file referenced by the manifest is "
                    f"missing; " + _fsck_hint(path)
                )
            cls._check_file(
                p, (integrity or {}).get(key), verify, path
            )
        try:
            spill = _spill_bytes()
            spill_this = bool(spill and os.path.getsize(fp) >= spill)
            with open(fp, "rb") as f:
                head = f.read(1)
                if head == b"{":
                    # flat container (see _write_segment): JSON name line +
                    # sequential raw .npy streams.  ``seg: 2`` (written by
                    # the reference's store/compact.py) additionally dictionary-codes the
                    # allele matrices (ref_dict/ref_codes streams).
                    f.seek(0)
                    names = json.loads(f.readline())["names"]
                    data = {
                        name: cls._read_stream(f, fp, spill_this)
                        for name in names
                    }
                    # dict-coded alleles decode to the plain matrices (a
                    # spilled segment materializes only this decode: the
                    # dictionary is small, the numeric bulk stays mapped)
                    for col in ("ref", "alt"):
                        if col + "_dict" in data:
                            data[col] = data.pop(col + "_dict")[
                                data.pop(col + "_codes")
                            ]
                else:  # legacy zip-backed npz from older builds
                    f.seek(0)
                    with np.load(f) as z:
                        data = {name: z[name] for name in z.files}
        except StoreCorruptError:
            raise
        except Exception as err:
            # a torn file with no integrity record (pre-integrity store)
            # still must not surface as a bare numpy/zip parse error
            raise StoreCorruptError(
                f"{fp}: segment container failed to parse ({err}); "
                + _fsck_hint(path)
            ) from err
        cols = {name: data[name] for name, _ in _NUMERIC_COLUMNS}
        n = data["ref"].shape[0]
        ref, alt = data["ref"], data["alt"]
        if ref.shape[1] < width:
            # width-trimmed on save: inflate back to the store width
            # (trailing pad bytes are zeros by construction)
            full = np.zeros((n, width), np.uint8)
            full[:, :ref.shape[1]] = ref
            ref = full
            full = np.zeros((n, width), np.uint8)
            full[:, :alt.shape[1]] = alt
            alt = full
        obj: dict = {c: None for c in OBJECT_COLUMNS}
        try:
            for k, line in enumerate(cls._iter_sidecar(ap), start=1):
                try:
                    row = json.loads(line)
                    i = row.pop("i")
                except (ValueError, KeyError) as err:
                    raise StoreCorruptError(
                        f"{ap}:{k}: unparseable annotation row ({err}); "
                        + _fsck_hint(path)
                    ) from err
                for c, v in row.items():
                    if obj[c] is None:
                        obj[c] = np.full((n,), None, object)
                    obj[c][i] = tuple(v) if c == _LONG_ALLELES else v
        except zlib.error as err:
            # a bit-flipped compressed sidecar (compaction's format) must
            # surface with the same actionable contract as every other
            # torn/corrupt segment file — never a bare zlib.error
            raise StoreCorruptError(
                f"{ap}: compressed annotation sidecar failed to inflate "
                f"({err}); " + _fsck_hint(path)
            ) from err
        seg = Segment(cols, ref, alt, obj, backing=[seg_id])
        seg.dirty = False
        return seg

    @staticmethod
    def _read_stream(f, fp: str, spill: bool) -> np.ndarray:
        """One raw .npy stream from the flat container ``fp`` open as ``f``:
        materialized, or with ``spill`` (the out-of-core tier) a
        copy-on-write memmap view of the file — pages are read on demand,
        and the update loaders' in-place writes land in private pages (a
        dirty segment is rewritten whole on save, never written back
        through the map).  An unknown header version, a Fortran-ordered or
        an object array materializes."""
        if not spill:
            return np.lib.format.read_array(f, allow_pickle=False)
        start = f.tell()
        version = np.lib.format.read_magic(f)
        if version == (1, 0):
            shape, fortran, dtype = np.lib.format.read_array_header_1_0(f)
        elif version == (2, 0):
            shape, fortran, dtype = np.lib.format.read_array_header_2_0(f)
        else:
            shape = fortran = dtype = None
        if shape is None or fortran or dtype.hasobject:
            f.seek(start)
            return np.lib.format.read_array(f, allow_pickle=False)
        offset = f.tell()
        nbytes = int(dtype.itemsize * int(np.prod(shape, dtype=np.int64)))
        arr = (np.memmap(fp, dtype=dtype, mode="c", shape=shape, offset=offset)
               if nbytes else np.empty(shape, dtype))
        f.seek(offset + nbytes)
        return arr

    @staticmethod
    def _iter_sidecar(ap: str):
        """Annotation-sidecar lines: plain JSONL ('{' leading byte, the
        save() format) or the zlib-compressed variant compaction writes
        (0x78 leading byte) — streamed, never fully buffered."""
        with open(ap, "rb") as f:
            head = f.read(1)
            if not head:
                return
            f.seek(0)
            if head == b"{":
                for raw in f:
                    yield raw.decode()
                return
            d = zlib.decompressobj()
            buf = b""
            while True:
                block = f.read(1 << 20)
                if not block:
                    break
                buf += d.decompress(block)
                lines = buf.split(b"\n")
                buf = lines.pop()
                for ln in lines:
                    if ln:
                        yield ln.decode()
            buf += d.flush()
            for ln in buf.split(b"\n"):
                if ln:
                    yield ln.decode()
