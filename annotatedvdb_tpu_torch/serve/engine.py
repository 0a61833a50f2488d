"""Query engine: point, bulk, region, batch-region and stats reads over a
pinned store snapshot.

Port of ``annotatedvdb_tpu/serve/engine.py``:

- **point / bulk**: ``chr:pos:ref:alt`` resolves through the loaders'
  identity rule (the allele hash over the width-bounded bytes, the
  host-string override past the width, on the host as in the reference),
  then one sorted-merge probe per chromosome group
  (``ChromosomeShard.lookup``, ``ops/dedup.py`` where a segment probes on
  the device);
- **region** (``chr:start-end``, filters, cursor pages) and **regions**
  (``POST /regions``: thousands of intervals, one BITS call per chromosome
  group, count-only and ``tokenize``): a per-(generation, chromosome)
  :class:`IntervalIndex`, position-sorted and first-wins deduplicated, is
  searched by ``ops/intervals.py`` — the ``bits_spans`` kernel on the card
  for groups of at least ``AVDB_SERVE_REGIONS_DEVICE_MIN`` intervals, its
  numpy twin below that or behind an open breaker;
- **stats** (``POST /stats/region``): the fused panel and the windowed scan
  of ``ops/stats.py`` over the group's decoded feature columns
  (:class:`StatsColumns`), on the card for groups of at least
  ``AVDB_SERVE_STATS_DEVICE_MIN`` intervals.

Every answer renders the reference's bytes.  The engine's ``device``
(``cuda`` unless the caller asks for ``cpu``) holds the pow2-padded index
positions and feature columns; on the CPU the same wrappers run their
plain versions.  On the card the engine loads its kernels' libraries
(``bits_spans``, ``stats_panel`` and ``export_pack``, which
``export/stream.py`` launches on ``engine.device``) when it is made, so a
kernel that does not build raises there and never reaches a request.  A device failure feeds the per-group
:class:`~annotatedvdb_tpu_torch.serve.resilience.DeviceBreaker` and the
request is answered by the numpy twin; with no breaker it fails the
request, where the reference answers from the twin unrecorded.  Fault
points: ``engine.device_probe`` (a breaker-routed membership probe),
``serve.regions`` and ``serve.stats`` (a parsed batch, nothing run).  Not
ported: the mesh executor (``mesh=``, ``_mesh_lookup_many``) and so its
``mesh.dispatch`` point.
"""

from __future__ import annotations

import base64
import functools
import json
import os
import re
import threading
import time
from collections import OrderedDict

import numpy as np
import torch

from annotatedvdb_tpu_torch.export.tokens import bin_path as _bin_path
from annotatedvdb_tpu_torch.export.tokens import build_region_tokens
from annotatedvdb_tpu_torch.loaders.lookup import identity_hashes
from annotatedvdb_tpu_torch.obs import reqtrace
from annotatedvdb_tpu_torch.ops import export_pack
from annotatedvdb_tpu_torch.ops import intervals as interval_ops
from annotatedvdb_tpu_torch.ops import stats as stats_ops
from annotatedvdb_tpu_torch.ops.binindex import bin_index_kernel
from annotatedvdb_tpu_torch.oracle.binindex import closed_form_path
from annotatedvdb_tpu_torch.runtime import resolve_device, to_device
from annotatedvdb_tpu_torch.store.variant_store import (
    _DIGEST_PK,
    _LONG_ALLELES,
    JSONB_COLUMNS,
    combined_key,
    jsonb_dumps,
)
from annotatedvdb_tpu_torch.types import (
    chromosome_code,
    chromosome_label,
    decode_allele,
    encode_allele_array,
)
from annotatedvdb_tpu_torch.utils import faults
from annotatedvdb_tpu_torch.utils.arrays import POS_SENTINEL, next_pow2, pad_pow2
from annotatedvdb_tpu_torch.utils.locks import make_lock


class QueryError(ValueError):
    """Malformed query (grammar / unknown chromosome / bad range) — the
    client's fault; HTTP maps it to 400, never 500."""


_ALLELE_RE = re.compile(r"^[ACGTUNacgtun]+$")

#: region span cap: one level-0 bin side (64Mb) covers any chromosome arm;
#: anything wider is a scan, not a region query, and must page.
MAX_REGION_SPAN = 64_000_000


def _cursor_key(code, start, end, min_cadd, max_conseq_rank) -> int:
    """FNV-1a fingerprint binding a continuation token to ONE query shape —
    a token replayed against different bounds/filters is a client error,
    not a silent wrong page."""
    h = 2166136261
    for ch in f"{code}:{start}:{end}:{min_cadd}:{max_conseq_rank}".encode():
        h = ((h ^ ch) * 16777619) & 0xFFFFFFFF
    return h


def encode_cursor(generation: int, offset: int, key: int) -> str:
    """Opaque continuation token: urlsafe base64 of a compact JSON triple
    (generation, row offset, query fingerprint).  Opaque by contract —
    clients must round-trip it verbatim."""
    raw = json.dumps(
        {"g": generation, "o": offset, "k": key}, separators=(",", ":")
    ).encode()
    return base64.urlsafe_b64encode(raw).decode().rstrip("=")


def decode_cursor(token: str, key: int) -> int:
    """Token -> row offset.  ``""``/``"0"`` start the first page; anything
    else must be a token this query shape minted.  A token from an OLDER
    generation stays valid: the offset re-applies against the current
    generation's match list (best-effort continuation across commits, the
    same contract a Postgres keyset page would give)."""
    if token in ("", "0"):
        return 0
    try:
        raw = base64.urlsafe_b64decode(token + "=" * (-len(token) % 4))
        obj = json.loads(raw)
        offset = int(obj["o"])
        k = int(obj["k"])
        int(obj["g"])  # well-formedness only: ANY generation is accepted
    except (ValueError, KeyError, TypeError):
        raise QueryError(f"bad continuation cursor {token!r}") from None
    if k != key:
        raise QueryError(
            "continuation cursor does not belong to this region query "
            "(region or filters changed mid-page)"
        )
    if offset < 0:
        raise QueryError(f"bad continuation cursor {token!r}")
    return offset


def parse_variant_id(spec: str) -> tuple[int, int, str, str]:
    """``chr:pos:ref:alt`` -> (chrom code, pos, REF, ALT).

    Accepts a ``chr`` prefix and tolerates a trailing ``:rs<N>`` field (the
    store's own primary keys round-trip as queries).  Alleles are uppercased
    — the store encodes uppercase bytes."""
    parts = spec.split(":")
    if len(parts) == 5 and parts[4].startswith("rs"):
        parts = parts[:4]
    if len(parts) != 4:
        raise QueryError(
            f"bad variant id {spec!r}: expected chr:pos:ref:alt"
        )
    code = chromosome_code(parts[0])
    if code == 0:
        raise QueryError(f"bad variant id {spec!r}: unknown chromosome")
    try:
        pos = int(parts[1])
    except ValueError:
        raise QueryError(
            f"bad variant id {spec!r}: position is not an integer"
        ) from None
    if pos < 1:
        raise QueryError(f"bad variant id {spec!r}: position is 1-based")
    ref, alt = parts[2].upper(), parts[3].upper()
    if not _ALLELE_RE.match(ref) or not _ALLELE_RE.match(alt):
        raise QueryError(f"bad variant id {spec!r}: non-nucleotide allele")
    return code, pos, ref, alt


def parse_region(spec: str) -> tuple[int, int, int]:
    """``chr:start-end`` -> (chrom code, start, end), 1-based inclusive."""
    chrom, sep, rng = spec.partition(":")
    start_s, dash, end_s = rng.partition("-")
    if not sep or not dash:
        raise QueryError(f"bad region {spec!r}: expected chr:start-end")
    code = chromosome_code(chrom)
    if code == 0:
        raise QueryError(f"bad region {spec!r}: unknown chromosome")
    try:
        start, end = int(start_s), int(end_s)
    except ValueError:
        raise QueryError(f"bad region {spec!r}: bounds must be integers") \
            from None
    if start < 1 or end < start:
        raise QueryError(
            f"bad region {spec!r}: need 1 <= start <= end"
        )
    if end - start + 1 > MAX_REGION_SPAN:
        raise QueryError(
            f"bad region {spec!r}: span exceeds {MAX_REGION_SPAN} bp — "
            "page the query"
        )
    return code, start, end


@functools.lru_cache(maxsize=4096)
def _region_bin(start: int, end: int) -> tuple[int, int]:
    """(level, leaf_bin) of the deepest bin enclosing [start, end] — the
    plain closed-form bin (``ops/binindex.py``) on one row of CPU tensors,
    memoized.  Bounds clamp below the int32 position sentinel exactly like
    the batched span paths, so the single and batch routes stay
    byte-identical on absurd-but-grammatical specs."""
    start = min(int(start), interval_ops.MAX_QUERY_POS)
    end = min(int(end), interval_ops.MAX_QUERY_POS)
    level, leaf = bin_index_kernel(
        torch.tensor([start], dtype=torch.int32),
        torch.tensor([end], dtype=torch.int32),
    )
    return int(level[0]), int(leaf[0])


def segment_alleles(seg, j: int, width: int) -> tuple[str, str]:
    """(ref, alt) strings for one segment row: retained original strings
    for the over-width tail, decoded device bytes otherwise (the scalar
    definition ``shard.alleles`` pins).  Single source for every renderer
    — ``_render_row`` here and the export dictionary coder both call it,
    so a corpus decode can never diverge from the serving JSON."""
    la = seg.obj[_LONG_ALLELES]
    if la is not None and la[j] is not None:
        ref, alt = la[j]
        return ref, alt
    ref_len = int(seg.cols["ref_len"][j])
    alt_len = int(seg.cols["alt_len"][j])
    if ref_len > width or alt_len > width:
        raise ValueError(
            f"allele length {max(ref_len, alt_len)} exceeds store "
            f"width {width} with no retained strings (store predates "
            "long-allele retention; reload from source)"
        )
    return decode_allele(seg.ref[j], ref_len), decode_allele(seg.alt[j], alt_len)


def render_variant(shard, code: int, gid: int) -> str:
    """One store row (by global id) as JSON text."""
    seg, j = shard.locate_row(gid)
    return _render_row(seg, j, chromosome_label(code), shard.width)


def _render_row(seg, j: int, label: str, width: int) -> str:
    """One segment row as JSON text (fixed field order; annotation values
    splice through ``jsonb_dumps`` — raw-text columns copy verbatim).
    Identity strings are assembled without ``json.dumps``: alleles, labels,
    and PKs are [A-Za-z0-9:._-] by construction, nothing to escape."""
    ref, alt = segment_alleles(seg, j, width)
    pos = int(seg.cols["pos"][j])
    rs = int(seg.cols["ref_snp"][j])
    adsp = int(seg.cols["is_adsp_variant"][j])
    rs_suffix = f":rs{rs}" if rs >= 0 else ""
    # record PK: retained digest for the long-allele tail, else the literal
    # (primary_key_generator.py:99-122 semantics, same as shard.primary_key)
    dp = seg.obj[_DIGEST_PK]
    if dp is not None and dp[j] is not None:
        pk = dp[j]
    else:
        pk = f"{label}:{pos}:{ref}:{alt}{rs_suffix}"
    bin_path = _bin_path(
        label, int(seg.cols["bin_level"][j]), int(seg.cols["leaf_bin"][j])
    )
    parts = [
        f'"primary_key":"{pk}"',
        f'"metaseq_id":"{label}:{pos}:{ref}:{alt}"',
        f'"chromosome":"{label}"',
        f'"position":{pos}',
        f'"ref":"{ref}"',
        f'"alt":"{alt}"',
        '"ref_snp":' + (f'"rs{rs}"' if rs >= 0 else "null"),
        '"is_multi_allelic":'
        + ("true" if seg.cols["is_multi_allelic"][j] else "false"),
        '"is_adsp_variant":'
        + ("null" if adsp < 0 else ("true" if adsp else "false")),
        f'"bin_index":{json.dumps(bin_path)}',
    ]
    ann = []
    for c in JSONB_COLUMNS:
        col = seg.obj[c]
        if col is None:
            continue
        v = col[j]
        if v is not None:
            ann.append(f'"{c}":{jsonb_dumps(v)}')
    parts.append('"annotations":{' + ",".join(ann) + "}")
    return "{" + ",".join(parts) + "}"


class RegionPage:
    """One prepared region answer: the fixed envelope (``prefix``/
    ``suffix``) around the rendered rows, joined by ``assemble``.

    Unpaged pages (``cursor=None`` at prepare time) close with exactly
    ``]}`` — byte-identical to the pre-paging envelope; paged ones append
    a ``"next"`` field carrying the continuation token (null on the last
    page)."""

    __slots__ = ("shard", "label", "level", "bin_path", "count",
                 "generation", "shown", "region_str", "next_token", "paged")

    def __init__(self, shard, label, level, bin_path, count, generation,
                 shown, region_str, next_token, paged):
        self.shard = shard
        self.label = label
        self.level = level
        self.bin_path = bin_path
        self.count = count
        self.generation = generation
        self.shown = shown
        self.region_str = region_str
        self.next_token = next_token
        self.paged = paged

    @property
    def returned(self) -> int:
        return len(self.shown)

    def prefix(self) -> str:
        return (
            f'{{"region":{json.dumps(self.region_str)}'
            f',"bin_level":{self.level}'
            f',"bin_index":{json.dumps(self.bin_path)}'
            f',"count":{self.count}'
            f',"returned":{len(self.shown)}'
            f',"generation":{self.generation}'
            ',"variants":['
        )

    def rows(self):
        """Rendered JSON text per row, in response order."""
        shard = self.shard
        for si, j in self.shown:
            yield _render_row(shard.segments[si], j, self.label, shard.width)

    def suffix(self) -> str:
        if not self.paged:
            return "]}"
        nxt = json.dumps(self.next_token) if self.next_token else "null"
        return f'],"next":{nxt}}}'

    def assemble(self) -> str:
        return self.prefix() + ",".join(self.rows()) + self.suffix()


class IntervalIndex:
    """One chromosome group's deduplicated, position-sorted row view —
    the BITS "database" every interval query searches against.

    Built once per (store generation, chromosome): every segment's rows
    concatenated, ordered by (pos, hash, segment age) and first-wins
    deduplicated (a row whose identity an older segment holds is shadowed,
    the store's lookup policy) — so a query's ``[lo, hi)`` span over ``pos`` is the
    region's post-dedup match list verbatim, a span width is the exact
    region count, and an N-interval panel shares one O(n log n) build
    instead of paying N per-query dedup passes.  The common case (no
    cross-segment (pos, hash) collisions — loader-deduplicated stores)
    builds with three vectorized numpy ops; when collisions exist, the
    per-row Python identity walk runs over ONLY the colliding (pos, hash)
    runs (a singleton row can never be a duplicate), so one shadowed
    duplicate on a 100M-row chromosome costs a few rows of Python, not a
    full-chromosome loop.

    ``device_pos(device)`` lazily uploads the sentinel-padded position
    array once per index, so a panel's kernel calls re-use the resident
    copy instead of re-shipping the index per request."""

    __slots__ = ("pos", "si", "jj", "_dev_pos")

    def __init__(self, pos, si, jj):
        self.pos = pos  # [K] int32, sorted
        self.si = si    # [K] int32 segment index per kept row
        self.jj = jj    # [K] int64 local row per kept row
        self._dev_pos = None

    @property
    def n(self) -> int:
        return int(self.pos.shape[0])

    @classmethod
    def build(cls, shard) -> "IntervalIndex":
        pos_parts, h_parts, si_parts, jj_parts = [], [], [], []
        for si, seg in enumerate(shard.segments):
            if seg.n == 0:
                continue
            pos_parts.append(seg.cols["pos"])
            h_parts.append(seg.cols["h"])
            si_parts.append(np.full(seg.n, si, np.int32))
            jj_parts.append(np.arange(seg.n, dtype=np.int64))
        if not pos_parts:
            return cls(np.empty(0, np.int32), np.empty(0, np.int32),
                       np.empty(0, np.int64))
        pos = np.concatenate(pos_parts)
        h = np.concatenate(h_parts)
        si = np.concatenate(si_parts)
        jj = np.concatenate(jj_parts)
        order = np.lexsort((si, h, pos))
        ps, hs = pos[order], h[order]
        same = (ps[1:] == ps[:-1]) & (hs[1:] == hs[:-1])
        if not bool(np.any(same)):
            # no (pos, hash) collision anywhere: duplicates are impossible
            # and the sorted view IS the dedup'd view (vectorized path)
            return cls(np.ascontiguousarray(ps),
                       np.ascontiguousarray(si[order]),
                       np.ascontiguousarray(jj[order]))
        # collision case: only members of a multi-row (pos, hash) run can
        # be duplicates — walk those rows (and only those) with the exact
        # first-wins identity compare
        run_member = np.zeros(order.shape[0], bool)
        run_member[1:] |= same
        run_member[:-1] |= same
        keep = np.ones(order.shape[0], bool)
        run_key = None
        run_seen: list = []  # identities kept for the current (pos, h)
        si_o, jj_o = si[order], jj[order]
        for t in np.nonzero(run_member)[0].tolist():
            key = (int(ps[t]), int(hs[t]))
            if key != run_key:
                run_key, run_seen = key, []
            seg = shard.segments[int(si_o[t])]
            j = int(jj_o[t])
            ident = (
                int(seg.cols["ref_len"][j]), int(seg.cols["alt_len"][j]),
                seg.ref[j].tobytes(), seg.alt[j].tobytes(),
            )
            if ident in run_seen:  # shadowed duplicate in a newer segment
                keep[t] = False
            else:
                run_seen.append(ident)
        return cls(np.ascontiguousarray(ps[keep]),
                   np.ascontiguousarray(si_o[keep]),
                   np.ascontiguousarray(jj_o[keep]))

    def device_pos(self, device):
        """The sentinel-padded position array on ``device`` (uploaded once;
        a failure propagates to the caller, which falls back host-side
        and feeds the circuit breaker)."""
        if self._dev_pos is None:
            self._dev_pos = to_device(pad_pow2(self.pos, POS_SENTINEL), device)
        return self._dev_pos

    def device_bytes(self) -> int:
        """Bytes the retained device copy occupies (0 when none): the
        pow2-padded int32 position array."""
        if self._dev_pos is None:
            return 0
        return next_pow2(self.n) * 4

    def drop_device(self) -> None:
        """Forget a (possibly half-built) device copy after a failed
        kernel call or a budget eviction — the next device attempt
        re-uploads cleanly (host arrays stay; correctness is
        unaffected)."""
        self._dev_pos = None


class StatsColumns:
    """One chromosome group's decoded analytics feature columns, aligned
    row-for-row to its :class:`IntervalIndex`.

    The JSONB sidecar is decoded ONCE per (store generation, chromosome)
    — ``feature_values`` walks every index row exactly one time — into:

    - ``cadd_f``/``rank_f`` float64 (NaN = missing): the exact values the
      ``min_cadd``/``max_conseq_rank`` filters compare, so the filter path
      never re-parses sidecar JSON per row per request;
    - ``af_fp``/``cadd_fp``/``rank_i`` int32 fixed point
      (``ops.stats.STATS_MISSING`` = absent): the stats kernels' inputs.

    Because the columns align to the index (position-sorted, first-wins
    deduplicated), a BITS span over
    the index IS a slice of these columns — filters vectorize and the
    fused stats kernel reduces over them directly.  ``device(device)``
    uploads the MISSING-padded kernel columns once per generation (the
    ``IntervalIndex.device_pos`` discipline, same pow2 capacity)."""

    __slots__ = ("cadd_f", "rank_f", "af_fp", "cadd_fp", "rank_i", "_dev")

    def __init__(self, cadd_f, rank_f, af_fp, cadd_fp, rank_i):
        self.cadd_f = cadd_f
        self.rank_f = rank_f
        self.af_fp = af_fp
        self.cadd_fp = cadd_fp
        self.rank_i = rank_i
        self._dev = None

    @classmethod
    def build(cls, shard, index: "IntervalIndex") -> "StatsColumns":
        n = index.n
        cadd_f = np.full(n, np.nan, np.float64)
        rank_f = np.full(n, np.nan, np.float64)
        af_fp = np.full(n, stats_ops.STATS_MISSING, np.int32)
        cadd_fp = np.full(n, stats_ops.STATS_MISSING, np.int32)
        rank_i = np.full(n, stats_ops.STATS_MISSING, np.int32)
        si, jj = index.si, index.jj
        # group index rows per segment in ONE stable sort + run split —
        # a per-segment boolean scan would be O(segments x rows)
        order = np.argsort(si, kind="stable")
        run_starts = np.nonzero(
            np.diff(si[order], prepend=si[order[0]] - 1 if order.size
                    else 0)
        )[0]
        for r, lo in enumerate(run_starts.tolist()):
            hi = run_starts[r + 1] if r + 1 < len(run_starts) \
                else order.shape[0]
            s = int(si[order[lo]])
            seg = shard.segments[s]
            cadd_col = seg.obj["cadd_scores"]
            af_col = seg.obj["allele_frequencies"]
            ms_col = seg.obj["adsp_most_severe_consequence"]
            if cadd_col is None and af_col is None and ms_col is None:
                continue  # nothing annotated: the columns stay MISSING
            for t in order[lo:hi].tolist():
                j = int(jj[t])
                cf, rf, afp, cfp, ri = stats_ops.feature_values(
                    cadd_col[j] if cadd_col is not None else None,
                    af_col[j] if af_col is not None else None,
                    ms_col[j] if ms_col is not None else None,
                )
                cadd_f[t] = cf
                rank_f[t] = rf
                af_fp[t] = afp
                cadd_fp[t] = cfp
                rank_i[t] = ri
        return cls(cadd_f, rank_f, af_fp, cadd_fp, rank_i)

    def device(self, device):
        """The MISSING-padded kernel columns on ``device`` (uploaded once;
        a failure propagates — the caller falls back host-side and feeds
        the circuit breaker)."""
        if self._dev is None:
            self._dev = tuple(
                to_device(pad_pow2(a, stats_ops.STATS_MISSING), device)
                for a in (self.af_fp, self.cadd_fp, self.rank_i)
            )
        return self._dev

    def device_bytes(self) -> int:
        """Bytes the retained device copies occupy (0 when none): three
        pow2-padded int32 columns — the INDEX_DEVICE_BYTES ledger's unit,
        same accessor contract as ``IntervalIndex.device_bytes``."""
        if self._dev is None:
            return 0
        return 3 * next_pow2(int(self.af_fp.shape[0])) * 4

    def drop_device(self) -> None:
        """Forget a (possibly half-built) device copy after a failed
        kernel call or a budget eviction — host arrays stay, answers
        stay byte-identical."""
        self._dev = None


class StatsResult:
    """One prepared analytics answer: per-interval summary dicts in
    request order, wrapped as ``{"n", "generation", "metrics", "bins",
    "results"}``, rendered by ``assemble()``."""

    __slots__ = ("generation", "metrics", "entries")

    def __init__(self, generation: int, metrics, entries: list):
        self.generation = generation
        self.metrics = list(metrics)
        self.entries = entries

    @property
    def returned(self) -> int:
        """Summary rows rendered (one per interval) — the metrics row
        count."""
        return len(self.entries)

    def assemble(self) -> str:
        return json.dumps({
            "n": len(self.entries),
            "generation": self.generation,
            "metrics": self.metrics,
            "bins": stats_ops.edges_payload(),
            "results": self.entries,
        }, separators=(",", ":"))


class RegionsResult:
    """One prepared batch-region answer: per-interval envelopes (each a
    :class:`RegionPage`, byte-identical to its single-``region()`` call)
    in request order, wrapped as ``{"n": N[, "tokens": {...}],
    "results": [...]}``, rendered by ``assemble()``."""

    __slots__ = ("pages", "tokens")

    def __init__(self, pages: list, tokens: dict | None = None):
        self.pages = pages
        self.tokens = tokens

    @property
    def returned(self) -> int:
        """Total rows rendered across the batch (the metrics row count)."""
        return sum(p.returned for p in self.pages)

    def prefix(self) -> str:
        head = f'{{"n":{len(self.pages)}'
        if self.tokens is not None:
            tok = ",".join(
                f'"{k}":{json.dumps(v, separators=(",", ":"))}'
                for k, v in self.tokens.items()
            )
            head += ',"tokens":{' + tok + "}"
        return head + ',"results":['

    def rows(self):
        for page in self.pages:
            yield page.assemble()

    def suffix(self) -> str:
        return "]}"

    def assemble(self) -> str:
        return self.prefix() + ",".join(self.rows()) + self.suffix()


class QueryEngine:
    """Point/bulk/region/stats queries over a snapshot provider
    (:class:`~annotatedvdb_tpu_torch.serve.snapshot.SnapshotManager` in a
    server, :class:`~annotatedvdb_tpu_torch.serve.snapshot.StaticSnapshots`
    in tests) on ``device``.  An optional
    :class:`~annotatedvdb_tpu_torch.serve.residency.ResidencyManager`
    governs which probed segments stay device-resident."""

    #: rendered point-record LRU capacity (entries).  Keyed by
    #: (generation, chromosome, global id): a serving generation's rows
    #: are immutable, so a hot variant renders once per generation and
    #: costs a dict probe afterwards — rendering is the dominant term of
    #: a point drain (~half the microbatch budget).
    POINT_RENDER_CACHE = 1 << 16
    #: and a byte ceiling on the cached text: records carrying large
    #: spliced RawJson annotation blobs (tens of KB each) must not pin
    #: entries x record-size of RSS in a long-lived gc.freeze'd process
    POINT_RENDER_CACHE_BYTES = 64 << 20

    #: retained interval indexes (one per (generation, chromosome); a
    #: generation swap naturally ages the old entries out of the LRU)
    INDEX_CACHE = 64
    #: byte ceiling on RETAINED device copies of interval indexes (the
    #: BITS kernel's search arrays) AND stats feature columns (the fused
    #: analytics kernel's inputs, ~3x the position bytes per group) —
    #: all of which live OUTSIDE the residency manager's ``--hbmBudget``
    #: plan: beyond it the least-recently-used entries drop their device
    #: copy — host arrays stay, answers are byte-identical, only the
    #: re-upload cost returns.  Without this the count-bounded caches
    #: could pin dozens of chromosome-sized arrays of HBM on a large
    #: store.
    INDEX_DEVICE_BYTES = 256 << 20

    #: retained stats feature-column sets (one per (generation,
    #: chromosome), the INDEX_CACHE discipline; ~33 bytes/row each).
    #: Sized like INDEX_CACHE — a human store loads ~24 chromosome
    #: groups, and a cross-chromosome filtered workload cycling past the
    #: cap would re-pay the full-chromosome sidecar decode per request
    STATS_CACHE = 64

    def __init__(self, snapshots, registry=None,
                 region_cache_size: int | None = None, residency=None,
                 breaker=None, regions_max: int | None = None,
                 regions_device_min: int | None = None,
                 stats_max: int | None = None,
                 stats_device_min: int | None = None, device=None):
        from annotatedvdb_tpu_torch.serve.batcher import (
            resolve_regions_knobs,
            resolve_stats_knobs,
        )

        self.snapshots = snapshots
        self.residency = residency
        self.device = device if isinstance(device, torch.device) \
            else resolve_device(device)
        self.stats_max, self.stats_device_min = resolve_stats_knobs(
            stats_max, stats_device_min
        )
        self.regions_max, self.regions_device_min = resolve_regions_knobs(
            regions_max, regions_device_min
        )
        #: device-path circuit breaker (serve/resilience.DeviceBreaker) —
        #: None lets a device failure fail the request
        self.breaker = breaker
        if self.device.type == "cuda":
            # a kernel that does not build raises here, not in a request
            interval_ops._library()
            stats_ops._library()
            export_pack._library()
        #: host seconds spent building interval indexes and decoding
        #: feature columns (guarded by self._index_build_lock)
        self.index_build_s = 0.0
        self.decode_s = 0.0
        self._render_lock = make_lock("serve.engine.render")
        #: guarded by self._render_lock
        self._render_cache: OrderedDict = OrderedDict()
        #: guarded by self._render_lock
        self._render_cache_bytes = 0
        if region_cache_size is None:
            region_cache_size = int(
                os.environ.get("AVDB_SERVE_REGION_CACHE", "") or 64
            )
        self.region_cache_size = max(int(region_cache_size), 0)
        self._cache_lock = make_lock("serve.engine.cache")
        #: guarded by self._cache_lock
        self._region_cache: OrderedDict = OrderedDict()
        #: guarded by self._cache_lock; (generation, region, filters) ->
        #: (si, j) int64 arrays of the walk's post-filter matches, so an
        #: N-page cursor walk scans the region once, not once per page
        self._walk_cache: OrderedDict = OrderedDict()
        #: guarded by self._cache_lock; (generation, code) ->
        #: :class:`IntervalIndex` (the BITS search database per group)
        self._index_cache: OrderedDict = OrderedDict()
        #: guarded by self._cache_lock; (generation, code) ->
        #: :class:`StatsColumns` (sidecar features decoded ONCE per
        #: generation — shared by stats kernels and region filters)
        self._stats_cache: OrderedDict = OrderedDict()
        #: guarded by self._cache_lock; id(index) -> (index, bytes) for
        #: indexes holding a device copy — the INDEX_DEVICE_BYTES ledger
        self._index_device: OrderedDict = OrderedDict()
        #: serializes interval-index BUILDS (not lookups): after a
        #: generation swap every concurrent region request misses the
        #: cache at once, and a full-chromosome lexsort is seconds of CPU
        #: and a multiple of the shard's RAM — N duplicate builds would
        #: be an N-fold memory spike for identical results.  Losers wait
        #: and take the winner's entry from the cache.
        self._index_build_lock = make_lock("serve.engine.index_build")
        if registry is not None:
            self._cache_hits = registry.counter(
                "avdb_query_cache_hits_total",
                "region queries served from the rendered LRU",
            )
            self._cache_misses = registry.counter(
                "avdb_query_cache_misses_total",
                "region queries that rendered fresh",
            )
        else:
            self._cache_hits = self._cache_misses = None

    # -- point / bulk -------------------------------------------------------

    def lookup(self, variant_id: str) -> str | None:
        """JSON text of the record, or None when absent."""
        return self.lookup_many([variant_id])[0]

    def lookup_many(self, ids: list, parsed: list | None = None) -> list:
        """[JSON text | None] per id, order-preserving.  Ids are parsed up
        front (one bad id fails the CALL with :class:`QueryError` — the
        batcher pre-validates at submit so co-batched strangers never share
        a client's grammar error), then probed per chromosome as one
        vectorized batch through the loader's membership path.  The
        batcher passes the tuples it already parsed at submit via
        ``parsed`` — re-parsing a microbatch is measurable at QPS."""
        out: list = [None] * len(ids)
        if not ids:
            return out
        if parsed is None:
            parsed = [parse_variant_id(s) for s in ids]
        snap = self.snapshots.current()
        if self.residency is not None:
            self.residency.govern(snap)
        store = snap.store
        width = store.width
        by_code: dict[int, list] = {}
        for i, (code, _pos, _ref, _alt) in enumerate(parsed):
            by_code.setdefault(code, []).append(i)
        for code, idxs in by_code.items():
            shard = store.shards.get(code)
            if shard is None:
                continue  # chromosome not loaded: every id misses
            refs = [parsed[i][2] for i in idxs]
            alts = [parsed[i][3] for i in idxs]
            ref, ref_len = encode_allele_array(refs, width)
            alt, alt_len = encode_allele_array(alts, width)
            pos = np.fromiter(
                (parsed[i][1] for i in idxs), np.int32, count=len(idxs)
            )
            h = identity_hashes(width, ref, alt, ref_len, alt_len, refs, alts)
            if self.residency is not None:
                qkey = combined_key(pos, h)
                self.residency.touch_window(
                    shard, qkey.min(), qkey.max(), len(idxs)
                )
            found, gid = self._probe_group(
                shard, code, pos, h, ref, alt, ref_len, alt_len
            )
            generation = snap.generation
            for k, i in enumerate(idxs):
                if found[k]:
                    out[i] = self._render_cached(
                        shard, code, int(gid[k]), generation
                    )
        return out

    def _probe_group(self, shard, code: int, pos, h, ref, alt,
                     ref_len, alt_len):
        """One chromosome group's membership probe, routed through the
        device circuit breaker when one is installed.

        The probe may run on the engine's device (a segment whose cache the
        residency manager installed, or the store's own upload rule); an
        open group probes on the host.  A device error in the probe feeds
        the breaker and the group is probed again on the host, which gives
        the same answer.  The ``engine.device_probe`` fault point injects
        such a failure where a breaker is installed (as in the reference,
        which fires it only on the breaker's path)."""
        breaker = self.breaker
        if breaker is not None and not breaker.allow_device(code):
            return shard.lookup(pos, h, ref, alt, ref_len, alt_len)
        try:
            if breaker is not None:
                # crash point: models a device probe/upload failure
                # surfacing from this group's membership probe — the
                # breaker must absorb it on the host path, never wrong
                # bytes
                faults.fire("engine.device_probe")
            out = shard.lookup(pos, h, ref, alt, ref_len, alt_len,
                               device=self.device)
        except Exception as exc:
            if breaker is None:
                raise
            breaker.record_failure(code, exc)
            return shard.lookup(pos, h, ref, alt, ref_len, alt_len)
        if breaker is not None:
            breaker.record_success(code)
        return out

    def _render_cached(self, shard, code: int, gid: int,
                       generation: int) -> str:
        """Point-record render through the generation-keyed LRU (stale
        generations age out with everything else; their keys can never be
        probed again)."""
        key = (generation, code, gid)
        with self._render_lock:
            text = self._render_cache.get(key)
            if text is not None:
                self._render_cache.move_to_end(key)
                return text
        text = render_variant(shard, code, gid)
        with self._render_lock:
            # two threads can race the same miss: replace, don't
            # double-count
            old = self._render_cache.pop(key, None)
            if old is not None:
                self._render_cache_bytes -= len(old)
            self._render_cache[key] = text
            self._render_cache_bytes += len(text)
            while self._render_cache and (
                len(self._render_cache) > self.POINT_RENDER_CACHE
                or self._render_cache_bytes > self.POINT_RENDER_CACHE_BYTES
            ):
                _, old = self._render_cache.popitem(last=False)
                self._render_cache_bytes -= len(old)
        return text

    # -- region -------------------------------------------------------------

    def region(self, spec: str, min_cadd=None, max_conseq_rank=None,
               limit: int | None = None, cursor: str | None = None,
               host_only: bool = False) -> str:
        """JSON text answering ``chr:start-end`` (with optional filters):
        ``{"region", "bin_level", "bin_index", "count", "returned",
        "generation", "variants": [...]}``.  ``count`` is the post-filter
        match total; ``variants`` carries the first ``limit`` of them.
        With ``cursor`` (``""`` starts a paged walk, a returned token
        continues it) the envelope additionally carries ``"next"``.
        ``host_only=True`` pins the interval search to the numpy twin
        (byte-identical — the circuit breaker's path).  Unpaged answers
        sit in the generation-keyed rendered LRU."""
        kind, payload = self.region_serve(
            spec, min_cadd=min_cadd, max_conseq_rank=max_conseq_rank,
            limit=limit, cursor=cursor, stream_threshold=None,
            host_only=host_only,
        )
        return payload if kind == "text" else payload.assemble()

    def region_serve(self, spec: str, min_cadd=None, max_conseq_rank=None,
                     limit: int | None = None, cursor: str | None = None,
                     stream_threshold: int | None = None,
                     host_only: bool = False):
        """The front ends' region entry point: ``("text", str)`` for
        responses small enough to buffer (cache-eligible when unpaged), or
        ``("page", RegionPage)`` when the row count exceeds
        ``stream_threshold`` — the aio front end then streams
        prefix/rows/suffix chunked without materializing the body."""
        code, start, end = parse_region(spec)
        snap = self.snapshots.current()
        if self.residency is not None:
            self.residency.govern(snap)
        cache_key = None
        if cursor is None:
            cache_key = (snap.generation, code, start, end,
                         min_cadd, max_conseq_rank, limit)
            text = self._cache_get(cache_key)
            if text is not None:
                return "text", text
        page = self._region_page(
            snap, code, start, end, min_cadd, max_conseq_rank, limit,
            cursor, host_only,
        )
        if stream_threshold is not None and page.returned > stream_threshold:
            return "page", page
        text = page.assemble()
        if cache_key is not None:
            self._cache_put(cache_key, text)
        return "text", text

    def regions_serve(self, specs: list, min_cadd=None, max_conseq_rank=None,
                      limit: int | None = None, tokenize: bool = False,
                      host_only: bool = False) -> RegionsResult:
        """Bulk region join: a batch of ``chr:start-end`` specs answered
        with ONE BITS kernel call per touched chromosome group.

        Returns a :class:`RegionsResult` whose per-interval envelopes are
        **byte-identical** to ``len(specs)`` sequential :meth:`region`
        calls with the same filters/limit, in request order.  Grammar is
        validated up front — one bad spec fails the CALL with
        :class:`QueryError` (the bulk-``/variants`` contract: co-batched
        strangers never share a client's grammar error, because the front
        end maps this to one 400 for the one caller).

        ``limit=0`` with no filters is the pure count-only mode: counts
        come straight from the kernel's span widths (the index is already
        deduplicated) and NO row is ever located, filtered, or rendered.
        ``tokenize=True`` adds the fixed-width interval-token arrays
        (``bin_level``/``leaf_bin``/``bin_index`` path, ``row_lo``/
        ``row_hi`` spans into the generation's interval index, pre-filter
        ``count``) for ML consumers."""
        if len(specs) > self.regions_max:
            raise QueryError(
                f"regions batch of {len(specs)} exceeds the "
                f"{self.regions_max}-interval cap (AVDB_SERVE_REGIONS_MAX); "
                "split the request"
            )
        parsed = [parse_region(s) for s in specs]
        snap = self.snapshots.current()
        if self.residency is not None:
            self.residency.govern(snap)
        # crash point: the batch is parsed, nothing executed — a failure
        # here must fail exactly this batch's caller and leave the engine
        # serving the next one
        faults.fire("serve.regions")
        by_code: dict[int, list[int]] = {}
        for i, (code, _s, _e) in enumerate(parsed):
            by_code.setdefault(code, []).append(i)
        # per-interval kernel outputs, scattered back to request order
        n = len(parsed)
        lo = np.zeros(n, np.int64)
        hi = np.zeros(n, np.int64)
        level = np.zeros(n, np.int64)
        leaf = np.zeros(n, np.int64)
        indexes: dict[int, IntervalIndex | None] = {}
        for code, idxs in by_code.items():
            t_group = time.perf_counter()
            index = indexes[code] = self._interval_index(snap, code)
            if index is None:
                level[idxs], leaf[idxs] = interval_ops.bin_tokens_host(
                    [parsed[i][1] for i in idxs],
                    [parsed[i][2] for i in idxs],
                )
                continue
            g_lo, g_hi, g_level, g_leaf = self._interval_spans(
                index, code,
                [parsed[i][1] for i in idxs],
                [parsed[i][2] for i in idxs],
                host_only,
            )
            lo[idxs], hi[idxs] = g_lo, g_hi
            level[idxs], leaf[idxs] = g_level, g_leaf
            # per-group sub-span onto the request's trace (no-op outside
            # an active trace): a panel's every interval shares the
            # request's trace id, and the group split is where device
            # time actually goes
            reqtrace.span_active(
                f"regions.chr{chromosome_label(code)}",
                time.perf_counter() - t_group,
            )
        no_filters = min_cadd is None and max_conseq_rank is None
        pages = []
        for i, (code, start, end) in enumerate(parsed):
            index = indexes[code]
            shard = snap.store.shards.get(code)
            label = chromosome_label(code)
            i_lo, i_hi = int(lo[i]), int(hi[i])
            span = i_hi - i_lo
            if index is None:
                kept: list = []
                count = 0
            elif no_filters:
                # the index is deduplicated, so the span width IS the
                # post-filter count — materialize ONLY the rows that will
                # render (limit=0 is the pure count-only mode: none)
                count = span
                take = span if limit is None \
                    else min(max(int(limit), 0), span)
                kept = list(zip(index.si[i_lo:i_lo + take].tolist(),
                                index.jj[i_lo:i_lo + take].tolist()))
            else:
                # filters vectorize over the cached feature columns —
                # never a per-row sidecar parse
                sel = self._filter_span(
                    snap, code, index, i_lo, i_hi, min_cadd,
                    max_conseq_rank,
                )
                kept = list(zip(index.si[sel].tolist(),
                                index.jj[sel].tolist()))
                count = len(kept)
            stop = len(kept) if limit is None \
                else min(max(int(limit), 0), len(kept))
            pages.append(RegionPage(
                shard, label, int(level[i]),
                closed_form_path(label, int(level[i]), int(leaf[i])),
                count, snap.generation, kept[:stop],
                f"{label}:{start}-{end}", None, paged=False,
            ))
        tokens = None
        if tokenize:
            tokens = build_region_tokens(
                snap.generation,
                [parsed[i][0] for i in range(n)],
                level, leaf, lo, hi,
                [indexes[parsed[i][0]] is not None for i in range(n)],
            )
        return RegionsResult(pages, tokens)

    # -- analytics (the fused stats panel) -----------------------------------

    def stats_serve(self, specs: list, metrics=None,
                    windows: int | None = None,
                    host_only: bool = False) -> StatsResult:
        """On-device analytics over a batch of ``chr:start-end`` intervals:
        ONE fused kernel call per touched chromosome group answers the
        whole panel — per-interval row count, cohort-max allele-frequency
        spectrum + mean, CADD-phred histogram/mean/quantiles, and the
        consequence-rank rollup — over the generation's cached feature
        columns.

        ``metrics`` selects rendered sections (default all of
        ``ops.stats.STATS_METRICS``; the kernel always computes the full
        panel — selection is render-side).  ``windows=W`` adds the per-bin summary
        block: each interval subdivided into W equal windows with
        per-window row counts and CADD means (the segmented scan keyed on
        the interval spans).  ``host_only=True`` — or an open circuit
        breaker — pins the reductions to the byte-identical numpy twins.
        Grammar is validated up front: one bad spec fails the CALL with
        :class:`QueryError` (the bulk contract)."""
        if len(specs) > self.stats_max:
            raise QueryError(
                f"stats batch of {len(specs)} exceeds the "
                f"{self.stats_max}-interval cap (AVDB_SERVE_STATS_MAX); "
                "split the request"
            )
        if metrics is None:
            metrics = list(stats_ops.STATS_METRICS)
        else:
            if not isinstance(metrics, (list, tuple)) or not metrics or \
                    any(m not in stats_ops.STATS_METRICS for m in metrics):
                raise QueryError(
                    "stats metrics must be a non-empty subset of: "
                    + ", ".join(stats_ops.STATS_METRICS)
                )
            metrics = list(metrics)
        if windows is not None:
            windows = int(windows)
            if not 1 <= windows <= stats_ops.MAX_WINDOWS:
                raise QueryError(
                    f"stats windows must be in [1, {stats_ops.MAX_WINDOWS}]"
                )
        parsed = [parse_region(s) for s in specs]
        snap = self.snapshots.current()
        if self.residency is not None:
            self.residency.govern(snap)
        # crash point: the panel is parsed, nothing executed — a failure
        # here must fail exactly this request's caller (HTTP 500) and
        # leave the engine answering the next panel byte-identically
        faults.fire("serve.stats")
        by_code: dict[int, list[int]] = {}
        for i, (code, _s, _e) in enumerate(parsed):
            by_code.setdefault(code, []).append(i)
        entries: list = [None] * len(parsed)
        for code, idxs in by_code.items():
            t_group = time.perf_counter()
            starts = [parsed[i][1] for i in idxs]
            ends = [parsed[i][2] for i in idxs]
            index = self._interval_index(snap, code)
            if index is None:
                # unloaded/empty chromosome: the zero-row reductions (the
                # host twin over empty columns keeps every shape exact)
                empty = np.empty(0, np.int32)
                panel = stats_ops.stats_panel_host(
                    empty, empty, empty, empty, starts, ends
                )
                wins = stats_ops.windowed_stats_host(
                    empty, empty, starts, ends, windows
                ) if windows is not None else None
            else:
                feats = self._stats_features(snap, code, index)
                panel = self._stats_panel(
                    code, index, feats, starts, ends, host_only
                )
                wins = self._stats_windows(
                    code, index, feats, starts, ends, windows, host_only
                ) if windows is not None else None
            lo, hi, af_l, af_h, c_l, c_h, rk = panel
            for k, i in enumerate(idxs):
                block = stats_ops.windows_summary(
                    wins[0][k], wins[1][k], wins[2][k]
                ) if wins is not None else None
                code_i, start, end = parsed[i]
                entries[i] = {
                    "region": f"{chromosome_label(code_i)}:{start}-{end}",
                    **stats_ops.interval_summary(
                        int(hi[k] - lo[k]), af_l[k], af_h[k], c_l[k],
                        c_h[k], rk[k], metrics, block,
                    ),
                }
            # per-group sub-span onto the request's trace (no-op outside
            # an active trace) — the group split is where device time goes
            reqtrace.span_active(
                f"stats.chr{chromosome_label(code)}",
                time.perf_counter() - t_group,
            )
        return StatsResult(snap.generation, metrics, entries)

    def _stats_features(self, snap, code: int,
                        index: IntervalIndex) -> StatsColumns:
        """The (generation, chromosome) feature columns, decoded lazily
        and LRU-retained — builds coalesce under the index build lock
        (a decode is a full-column sidecar walk; N concurrent misses
        must not pay it N times)."""
        key = (snap.generation, code)
        with self._cache_lock:
            feats = self._stats_cache.get(key)
            if feats is not None:
                self._stats_cache.move_to_end(key)
                return feats
        with self._index_build_lock:
            with self._cache_lock:
                feats = self._stats_cache.get(key)
                if feats is not None:
                    self._stats_cache.move_to_end(key)
                    return feats
            t0 = time.perf_counter()
            feats = StatsColumns.build(snap.store.shards.get(code), index)
            self.decode_s += time.perf_counter() - t0
            evicted: list[StatsColumns] = []
            with self._cache_lock:
                self._stats_cache[key] = feats
                while len(self._stats_cache) > self.STATS_CACHE:
                    _k, old = self._stats_cache.popitem(last=False)
                    # the device-byte ledger must not keep an evicted
                    # column set (and its HBM copies) alive behind the
                    # cache's back — the _index_cache discipline
                    if self._index_device.pop(id(old), None) is not None:
                        evicted.append(old)
        for old in evicted:
            old.drop_device()
        return feats

    def _filter_span(self, snap, code: int, index: IntervalIndex,
                     i_lo: int, i_hi: int, min_cadd, max_conseq_rank):
        """Index positions of ``[i_lo, i_hi)`` passing the annotation
        filters — one vectorized compare over the cached feature columns
        instead of a JSON decode per row per request.  NaN (missing
        annotation) never satisfies a predicate (the reference's
        ``WHERE (col->>'x')::numeric`` NULL semantics)."""
        feats = self._stats_features(snap, code, index)
        keep = np.ones(i_hi - i_lo, bool)
        with np.errstate(invalid="ignore"):  # NaN compares are the point
            if min_cadd is not None:
                keep &= feats.cadd_f[i_lo:i_hi] >= min_cadd
            if max_conseq_rank is not None:
                keep &= feats.rank_f[i_lo:i_hi] <= max_conseq_rank
        return np.nonzero(keep)[0] + i_lo

    def _device_stats(self, index: IntervalIndex, feats: StatsColumns,
                      starts, ends):
        """One fused stats-panel kernel call on the device (test seam:
        monkeypatch to model a failing device)."""
        af, cadd, rank = feats.device(self.device)
        return stats_ops.stats_panel_batch(
            index.device_pos(self.device), af, cadd, rank, starts, ends,
            padded=True,
        )

    def _device_windows(self, index: IntervalIndex, feats: StatsColumns,
                        starts, ends, windows: int):
        """One windowed-scan kernel call on the device (test seam)."""
        _af, cadd, _rank = feats.device(self.device)
        return stats_ops.windowed_stats_batch(
            index.device_pos(self.device), cadd, starts, ends, windows,
            padded=True,
        )

    def _stats_panel(self, code: int, index: IntervalIndex,
                     feats: StatsColumns, starts, ends, host_only: bool):
        """The fused panel for one group (breaker-guarded device
        dispatch; byte-identical host twin otherwise)."""
        return self._stats_guarded(
            code, index, feats, len(starts), host_only,
            lambda: self._device_stats(index, feats, starts, ends),
            lambda: stats_ops.stats_panel_host(
                index.pos, feats.af_fp, feats.cadd_fp, feats.rank_i,
                starts, ends,
            ),
        )

    def _stats_windows(self, code: int, index: IntervalIndex,
                       feats: StatsColumns, starts, ends, windows: int,
                       host_only: bool):
        """The windowed scan for one group (same guard)."""
        return self._stats_guarded(
            code, index, feats, len(starts), host_only,
            lambda: self._device_windows(index, feats, starts, ends,
                                         windows),
            lambda: stats_ops.windowed_stats_host(
                index.pos, feats.cadd_fp, starts, ends, windows
            ),
        )

    def _stats_guarded(self, code: int, index: IntervalIndex,
                       feats: StatsColumns, n_queries: int,
                       host_only: bool, device_fn, host_fn):
        """The ONE stats device-dispatch guard: the kernel runs when the
        batch is worth a dispatch and the group's circuit breaker allows
        it, the byte-identical numpy twin otherwise.  A device failure
        feeds the breaker and drops BOTH retained device copies (index
        position array + feature columns) with their ledger entries —
        one failure path to maintain, not one per kernel."""
        breaker = self.breaker
        if (not host_only
                and n_queries >= self.stats_device_min
                and (breaker is None or breaker.allow_device(code))):
            try:
                out = device_fn()
            except Exception as exc:
                index.drop_device()
                feats.drop_device()
                with self._cache_lock:
                    self._index_device.pop(id(index), None)
                    self._index_device.pop(id(feats), None)
                if breaker is None:
                    raise
                breaker.record_failure(code, exc)
            else:
                if breaker is not None:
                    breaker.record_success(code)
                self._note_index_device(index)
                self._note_index_device(feats)
                return out
        return host_fn()

    #: distinct in-flight cursor walks whose match lists stay cached
    #: (two compact int64 arrays per walk, LRU; stale generations age out)
    WALK_CACHE = 8

    def _region_page(self, snap, code, start, end,
                     min_cadd, max_conseq_rank, limit,
                     cursor: str | None, host_only: bool = False
                     ) -> RegionPage:
        label = chromosome_label(code)
        level, leaf = _region_bin(start, end)
        shard = snap.store.shards.get(code)
        t_page = time.perf_counter()
        paged = cursor is not None
        wkey = hit = None
        if paged:
            wkey = (snap.generation, code, start, end,
                    min_cadd, max_conseq_rank)
            with self._cache_lock:
                hit = self._walk_cache.get(wkey)
                if hit is not None:
                    self._walk_cache.move_to_end(wkey)
        full_count = None
        if hit is None:
            kept: list[tuple[int, int]] = []  # (segment index, local row)
            index = self._interval_index(snap, code)
            if index is not None:
                # the single-region route rides the SAME interval-index +
                # BITS-span machinery as the batch API (one query is just
                # a panel of one); the breaker/host_only fallback is
                # byte-identical
                lo, hi, _lvl, _leaf = self._interval_spans(
                    index, code, [start], [end], host_only
                )
                i_lo, i_hi = int(lo[0]), int(hi[0])
                if min_cadd is not None or max_conseq_rank is not None:
                    # filters vectorize over the cached feature columns
                    # (decoded once per generation)
                    sel = self._filter_span(
                        snap, code, index, i_lo, i_hi, min_cadd,
                        max_conseq_rank,
                    )
                    kept = list(zip(index.si[sel].tolist(),
                                    index.jj[sel].tolist()))
                else:
                    if not paged:
                        # dedup'd span width IS the count; no filter pass
                        # and no walk cache to fill — materialize only
                        # the rows that will render
                        full_count = i_hi - i_lo
                        take = full_count if limit is None \
                            else min(max(int(limit), 0), full_count)
                        i_hi = i_lo + take
                    kept = list(zip(index.si[i_lo:i_hi].tolist(),
                                    index.jj[i_lo:i_hi].tolist()))
            if paged:
                # without this an N-page walk re-runs the full region
                # scan + filter pass per page (O(N x region) for what the
                # client sees as keyset pagination)
                hit = (
                    np.fromiter((t[0] for t in kept), np.int64, len(kept)),
                    np.fromiter((t[1] for t in kept), np.int64, len(kept)),
                )
                with self._cache_lock:
                    self._walk_cache[wkey] = hit
                    while len(self._walk_cache) > self.WALK_CACHE:
                        self._walk_cache.popitem(last=False)
        if paged:
            total = int(hit[0].shape[0])
            ckey = _cursor_key(code, start, end, min_cadd, max_conseq_rank)
            offset = decode_cursor(cursor, ckey)
            stop = total if limit is None \
                else min(offset + max(int(limit), 0), total)
            shown = list(zip(hit[0][offset:stop].tolist(),
                             hit[1][offset:stop].tolist()))
            next_token = None
            # a page must ADVANCE to mint a continuation (limit=0
            # count-only pages would otherwise hand back a
            # self-referential token and loop a cursor-following client
            # forever)
            if stop < total and stop > offset:
                next_token = encode_cursor(snap.generation, stop, ckey)
            # page sub-span: every page of a cursor walk attributes its
            # scan to the walking request's trace id (no-op untraced)
            reqtrace.span_active(f"region.chr{label}",
                                 time.perf_counter() - t_page)
            return RegionPage(
                shard, label, level, closed_form_path(label, level, leaf),
                total, snap.generation, shown, f"{label}:{start}-{end}",
                next_token, paged=True,
            )
        stop = len(kept) if limit is None \
            else min(max(int(limit), 0), len(kept))
        reqtrace.span_active(f"region.chr{label}",
                             time.perf_counter() - t_page)
        return RegionPage(
            shard, label, level, closed_form_path(label, level, leaf),
            len(kept) if full_count is None else full_count,
            snap.generation, kept[:stop],
            f"{label}:{start}-{end}", None, paged=False,
        )

    # -- interval index (the BITS search database) ---------------------------

    def _interval_index(self, snap, code: int) -> IntervalIndex | None:
        """The (generation, chromosome) interval index, built lazily and
        LRU-retained; ``None`` when the chromosome is unloaded or empty.
        Stale generations age out of the cap like every other
        generation-keyed cache here — their keys can never be probed
        again."""
        shard = snap.store.shards.get(code)
        if shard is None or not shard.n:
            return None
        key = (snap.generation, code)
        with self._cache_lock:
            index = self._index_cache.get(key)
            if index is not None:
                self._index_cache.move_to_end(key)
                return index
        with self._index_build_lock:
            # double-checked: the winner of the race built it while this
            # thread waited — take the cached entry instead of paying a
            # duplicate full-chromosome sort
            with self._cache_lock:
                index = self._index_cache.get(key)
                if index is not None:
                    self._index_cache.move_to_end(key)
                    return index
            t0 = time.perf_counter()
            index = IntervalIndex.build(shard)
            self.index_build_s += time.perf_counter() - t0
            evicted: list[IntervalIndex] = []
            with self._cache_lock:
                self._index_cache[key] = index
                while len(self._index_cache) > self.INDEX_CACHE:
                    _k, old = self._index_cache.popitem(last=False)
                    # the device-byte ledger must not keep the evicted
                    # index (and its HBM copy) alive behind the cache's
                    # back
                    if self._index_device.pop(id(old), None) is not None:
                        evicted.append(old)
        for old in evicted:
            old.drop_device()
        return index

    def _device_spans(self, index: IntervalIndex, starts, ends):
        """One batched BITS kernel call (test seam: monkeypatch to model
        a failing device)."""
        return interval_ops.interval_spans(
            index.device_pos(self.device), starts, ends, pos_padded=True
        )

    def _interval_spans(self, index: IntervalIndex, code: int,
                        starts, ends, host_only: bool = False):
        """(lo, hi, level, leaf) per query interval — the device kernel
        when the batch is worth a dispatch and the group's circuit
        breaker allows it, the byte-identical numpy twin otherwise.  A
        device failure feeds the breaker (so a sick device stops being
        attempted per panel) and falls back host-side: correct bytes
        either way, the serving contract."""
        breaker = self.breaker
        if (not host_only
                and len(starts) >= self.regions_device_min
                and (breaker is None or breaker.allow_device(code))):
            try:
                out = self._device_spans(index, starts, ends)
            except Exception as exc:
                index.drop_device()
                with self._cache_lock:
                    self._index_device.pop(id(index), None)
                if breaker is None:
                    raise
                breaker.record_failure(code, exc)
            else:
                if breaker is not None:
                    breaker.record_success(code)
                self._note_index_device(index)
                return out
        return interval_ops.interval_spans_host(index.pos, starts, ends)

    def device_bytes(self) -> int:
        """Bytes of the interval indexes' and feature columns' device
        copies held now (the ``INDEX_DEVICE_BYTES`` ledger)."""
        with self._cache_lock:
            return sum(b for _i, b in self._index_device.values())

    def _note_index_device(self, index) -> None:
        """Account a retained device copy — an :class:`IntervalIndex`
        position array OR a :class:`StatsColumns` feature set (both
        expose ``device_bytes``/``drop_device``) — against
        ``INDEX_DEVICE_BYTES``, evicting the least-recently-used copies
        past the ceiling (the just-used entry always stays)."""
        nbytes = index.device_bytes()
        if not nbytes:
            return
        evicted: list = []
        with self._cache_lock:
            self._index_device[id(index)] = (index, nbytes)
            self._index_device.move_to_end(id(index))
            total = sum(b for _i, b in self._index_device.values())
            while total > self.INDEX_DEVICE_BYTES \
                    and len(self._index_device) > 1:
                _key, (old, b) = self._index_device.popitem(last=False)
                evicted.append(old)
                total -= b
        for old in evicted:  # the device free happens off-lock
            old.drop_device()

    # -- region LRU ---------------------------------------------------------

    def _cache_get(self, key):
        if not self.region_cache_size:
            return None
        with self._cache_lock:
            text = self._region_cache.get(key)
            if text is not None:
                self._region_cache.move_to_end(key)
        counter = self._cache_hits if text is not None else self._cache_misses
        if counter is not None:
            counter.inc()
        return text

    def _cache_put(self, key, text: str) -> None:
        if not self.region_cache_size:
            return
        with self._cache_lock:
            self._region_cache[key] = text
            self._region_cache.move_to_end(key)
            # stale-generation entries age out with everything else — the
            # cap bounds them, and their keys can never be probed again
            while len(self._region_cache) > self.region_cache_size:
                self._region_cache.popitem(last=False)
