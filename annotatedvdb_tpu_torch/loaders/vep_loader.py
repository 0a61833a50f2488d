"""VEP result load: update-only annotation of existing store rows.

Port of ``annotatedvdb_tpu/loaders/vep_loader.py::TpuVepLoader``.
Reference flow (``Load/bin/load_vep_result.py`` +
``Util/lib/python/loaders/vep_variant_loader.py``): stream VEP JSON lines;
per line, rank+sort the consequence blocks, re-parse the embedded VCF
``input`` entry, and per alt allele — PK lookup, skip/update existing
``vep_output``, match frequencies and consequences via the
**left-normalized** allele ('-' for emptied alleles, the VEP convention),
then batch ``jsonb_merge`` UPDATEs.

A reader thread (``io/prefetch.py``) cuts the file into 4 MiB blocks of
whole lines; each block is one flush, through one of two transforms:

- **native** (the default, as in the reference): the C++ transformer
  (``native/vep.py``) turns the block into per-alt rows with their allele
  hash and the four JSONB values as raw JSON text, which the store keeps
  verbatim (``RawJson``, assembled in C by ``native/pyfast.py``).  Its hash
  is the ``annotate_bin`` kernel's bit-exact twin, so these rows make no
  device round trip.  Docs it cannot transform faithfully (novel
  consequence combos, escaped strings, malformed lines) re-run through the
  Python transform, interleaved in document order; a doc that learns a
  combo restarts the transformer after it with the re-ranked table, and
  after four restarts the rest of the block takes the Python transform.
  A failed build of either library raises: there is no quiet fallback.
- **python** (``AVDB_NATIVE_VEP=0``): ``json.loads`` and the host parser.
  A flush's per-alt rows form one identity batch (split at
  ``2 * next_pow2(batch_size)`` rows): on the card ONE launch of the fused
  ``annotate_bin`` kernel gives each row's allele hash, shared-prefix
  length and host-fallback flag, and only those three columns come back,
  in one copy after the launch; on the CPU the plain versions compute
  them.  Under the default only the docs handed to this path launch.

Membership then runs per chromosome shard, and the updates deep-merge into
the store's JSONB columns.  Each transform writes the store bytes of the
reference's same transform for the same store and VEP file
(``tests/test_torch_vep.py``, ``tests/test_torch_vep_native.py``).

Not ported: the mesh update step, the run-record telemetry (``obs/``) and
``warmup``.
"""

from __future__ import annotations

import gzip
import json
import os

import numpy as np
import torch

from annotatedvdb_tpu_torch.conseq import ConsequenceRanker
from annotatedvdb_tpu_torch.io.prefetch import ChunkPrefetcher
from annotatedvdb_tpu_torch.io.vep import VepResultParser
from annotatedvdb_tpu_torch.loaders.vcf_loader import _fnv32_str
from annotatedvdb_tpu_torch.models.pipeline import annotate_hash_fn
from annotatedvdb_tpu_torch.native import pyfast
from annotatedvdb_tpu_torch.native import vep as native_vep
from annotatedvdb_tpu_torch.ops.hashing import to_uint32
from annotatedvdb_tpu_torch.oracle import normalize_alleles
from annotatedvdb_tpu_torch.runtime import resolve_device, to_device
from annotatedvdb_tpu_torch.store import AlgorithmLedger, VariantStore
from annotatedvdb_tpu_torch.store.variant_store import RawJson
from annotatedvdb_tpu_torch.types import (
    VariantBatch,
    chromosome_code,
    encode_allele_array,
)
from annotatedvdb_tpu_torch.utils.arrays import next_pow2
from annotatedvdb_tpu_torch.utils.pipeline import merge_stage_stats
from annotatedvdb_tpu_torch.utils.profiling import StageTimer, bulk_load_gc

#: the ledger's ``script`` label for VEP loads — the reference's
LEDGER_SCRIPT = "TpuVepLoader.load_file"

#: bytes the reader takes per block; every block of whole lines is a flush
BLOCK_BYTES = 4 << 20

#: restarts of the native transformer within one block (one after each
#: flagged doc that learns a combo) after which the rest of the block
#: takes the Python transform
MAX_RESTARTS = 4

# pending-row tuple layout (see _parse_result)
R_CODE, R_POS, R_REF, R_ALT, R_ANN, R_FREQ, R_CLEANED, R_SHARED = range(8)


def _np_scalar(obj):
    """json.dumps ``default`` hook: numpy scalars degrade to their Python
    value instead of failing the load mid-file."""
    item = getattr(obj, "item", None)
    if item is not None:
        return item()
    raise TypeError(
        f"non-JSON value of type {type(obj).__name__} in a store update"
    )


def _fresh(obj):
    """Deep, un-aliased copy of JSON-pure data via one C-level round trip."""
    return json.loads(json.dumps(obj, default=_np_scalar))


def _open_bytes(path: str):
    if path.endswith(".gz"):
        return gzip.open(path, "rb")
    return open(path, "rb")


def _blocks(fh, test: bool):
    """Blocks of whole lines (the last one newline-terminated) from ``fh``;
    with ``test`` only the first, which covers a small file completely."""
    tail = b""
    while True:
        block = fh.read(BLOCK_BYTES)
        if not block:
            break
        block = tail + block
        cut = block.rfind(b"\n")
        if cut < 0:
            tail = block
            continue
        yield block[:cut + 1]
        tail = block[cut + 1:]
        if test:
            # if nothing follows, the unterminated final line belongs to
            # this (only) batch
            if not fh.read(1) and tail.strip():
                yield tail + b"\n"
            return
    if tail.strip():
        yield tail + b"\n"


class VepLoader:
    """Update-only loader: annotates variants already present in the store,
    on ``device`` (``cuda:0`` by default; ``"cpu"`` runs the plain torch
    versions)."""

    def __init__(
        self,
        store: VariantStore,
        ledger: AlgorithmLedger,
        ranker: ConsequenceRanker,
        datasource: str | None = None,
        skip_existing: bool = False,
        batch_size: int = 1 << 14,
        log=print,
        log_after: int | None = None,
        quarantine=None,
        device: str | torch.device | None = None,
    ):
        from annotatedvdb_tpu_torch.utils.logging import ProgressCadence
        from annotatedvdb_tpu_torch.utils.quarantine import ErrorBudget

        self.device = resolve_device(device)
        self.store = store
        self.ledger = ledger
        self.parser = VepResultParser(ranker, self.device)
        self.datasource = datasource.lower() if datasource else None
        self.skip_existing = skip_existing
        self.batch_size = batch_size
        self.log = log
        self._cadence = ProgressCadence(log, log_after, unit="results")
        #: ingest (block reads, on the reader thread) / process (transform
        #: + store apply) busy seconds + load wall
        self.timer = StageTimer()
        #: the identity step inside ``process``: ``dispatch`` (uploads and
        #: the launch) and ``copy_back`` (waiting for the device and copying
        #: the three columns back)
        self.identity_timer = StageTimer()
        #: identity batches dispatched (one ``annotate_bin`` launch each on
        #: a card)
        self.identity_batches = 0
        #: membership probes by path ("device" / "host")
        self.probe_stats: dict[str, int] = {}
        #: the transform's own counts: rows the native transformer applied,
        #: docs it handed to the Python transform, its restarts after a
        #: learned combo, and blocks (or, after MAX_RESTARTS, tails of
        #: blocks) that went whole through the Python transform
        self.transform_stats = {"native_rows": 0, "fallback_docs": 0,
                                "restarts": 0, "python_blocks": 0}
        self._blob: bytes | None = None      # the rank table for the C++ side
        self._blob_version = -1
        #: backpressure at the reader boundary
        self.queue_stalls: dict = {}
        # quarantine sink + --maxErrors budget: malformed JSON lines and
        # structurally broken result docs are preserved replayably; without
        # a sink they are only counted
        self.quarantine = quarantine
        self._budget = (
            quarantine.budget if quarantine is not None else ErrorBudget()
        )
        self.counters = {
            "line": 0, "variant": 0, "skipped": 0, "duplicates": 0,
            "update": 0, "not_found": 0,
        }

    def _reject(self, raw, reason: str) -> None:
        """Quarantine one rejected VEP result line (line numbers are not
        tracked through the block reader; the raw line is what replay
        needs).  Raises ErrorBudgetExceeded past --maxErrors."""
        self.counters["rejected"] = self.counters.get("rejected", 0) + 1
        if isinstance(raw, bytes):
            raw = raw.decode("utf-8", "replace")
        if self.quarantine is not None:
            self.quarantine.reject(None, raw, reason)
        else:
            self._budget.add(1, context=reason)

    def _ranking_blob(self) -> bytes:
        """Serialized rank table for the native transformer, refreshed when
        a learn-on-miss re-rank bumps the ranker's version."""
        v = self.parser.ranker.version
        if self._blob is None or self._blob_version != v:
            self._blob = native_vep.ranking_blob(self.parser.ranker)
            self._blob_version = v
        return self._blob

    @property
    def is_adsp(self) -> bool:
        return self.datasource == "adsp"

    @property
    def is_dbsnp(self) -> bool:
        return self.datasource == "dbsnp"

    @bulk_load_gc()
    def load_file(self, path: str, commit: bool = False, test: bool = False) -> dict:
        # the native transform runs unless AVDB_NATIVE_VEP=0, read per
        # load as the reference reads it
        use_native = os.environ.get("AVDB_NATIVE_VEP", "1") != "0"
        if use_native:
            # build (or find) both libraries before the ledger records a
            # run: a failed build or probe raises here, with its cause
            native_vep.load()
            pyfast.load()
        alg_id = self.ledger.begin(
            LEDGER_SCRIPT,
            {"file": path, "datasource": self.datasource, "test": test},
            commit,
        )
        # update loads probe a static store per flush: pin the large
        # segments' membership caches on the card once
        self.store.pin_for_updates(self.device)
        n_added_before = len(self.parser.ranker.added)
        with self.timer.wall(), _open_bytes(path) as fh:
            pre = ChunkPrefetcher(_blocks(fh, test), timer=self.timer,
                                  name="vep-ingest")
            try:
                for text in pre:
                    with self.timer.stage("process"):
                        self._flush_text(text, alg_id, commit, use_native)
            finally:
                # settle the reader thread before fh leaves scope
                pre.close()
                merge_stage_stats(self.queue_stalls, "ingest", pre.stats)
        added = self.parser.ranker.added[n_added_before:]
        if added:
            self.log(f"added {len(added)} new consequence combos: {added}")
        self.ledger.finish(alg_id, dict(self.counters))
        self._cadence.finish(
            self.counters["line"], self.counters, self.timer.summary()
        )
        self.counters["alg_id"] = alg_id
        return dict(self.counters)

    # ------------------------------------------------------------------

    def _flush_text(self, text: bytes, alg_id: int, commit: bool,
                    use_native: bool) -> None:
        """One block of whole lines.  Natively: the C++ transformer over
        the raw bytes; the docs it flags re-run through the Python transform
        INTERLEAVED in document order, so same-row merge order matches the
        all-Python path.  A flagged doc that LEARNS a combo renumbers the
        rank table, so the docs after it re-transform with the new table —
        the version-mix point the Python path has."""
        stats = self.transform_stats
        start_off = 0
        restarts = 0
        # input lines are counted once per block: by the FIRST transform
        # (its docs cover the whole block; restarts re-scan tails) or by
        # the Python path when it takes the whole block
        counted = False
        while start_off < len(text):
            sub = text[start_off:] if start_off else text
            if not use_native or restarts >= MAX_RESTARTS:
                stats["python_blocks"] += 1
                self._flush_python_text(sub, alg_id, commit, count=not counted)
                break
            res = native_vep.transform_text(
                sub, self._ranking_blob(), self.is_dbsnp, self.store.width
            )
            n_docs = int(res.doc_fallback.size)
            if not counted:
                self.counters["line"] += n_docs
                counted = True
            doc_of_row = res.doc_of_row
            lo_row, lo_doc = 0, 0
            restart = None
            for f in np.flatnonzero(res.doc_fallback == 1).tolist():
                hi_row = int(np.searchsorted(doc_of_row, f))
                self._native_range(res, alg_id, commit, lo_doc, f, lo_row, hi_row)
                stats["fallback_docs"] += 1
                v0 = self.parser.ranker.version
                o = int(res.doc_off[f])
                e = sub.find(b"\n", o)
                self._flush_lines([sub[o:] if e < 0 else sub[o:e]], alg_id, commit)
                lo_row = int(np.searchsorted(doc_of_row, f, side="right"))
                lo_doc = f + 1
                if self.parser.ranker.version != v0:
                    # resume from the doc AFTER the flagged one
                    restart = (start_off + int(res.doc_off[f + 1])
                               if f + 1 < n_docs else len(text))
                    break
            if restart is not None:
                start_off = restart
                restarts += 1
                stats["restarts"] += 1
                continue
            self._native_range(res, alg_id, commit, lo_doc, n_docs, lo_row,
                               res.n_rows)
            break
        self._cadence.maybe_log(self.counters["line"], self.counters)

    def _flush_python_text(self, text: bytes, alg_id: int, commit: bool,
                           count: bool) -> None:
        """A block (or a block's tail) through the Python transform."""
        batch_lines = [ln for ln in text.split(b"\n") if ln.strip()]
        if count:
            self.counters["line"] += len(batch_lines)
        if batch_lines:
            self._flush_lines(batch_lines, alg_id, commit)

    def _flush_lines(self, batch_lines: list[bytes], alg_id: int,
                     commit: bool) -> None:
        # ONE json.loads over the whole flush (lines joined into a JSON
        # array) — the C decoder amortizes per-call setup across the batch
        try:
            raw = json.loads(b"[" + b",".join(batch_lines) + b"]")
        except ValueError:
            raw = None
        if raw is not None and len(raw) == len(batch_lines):
            pairs = list(zip(raw, batch_lines))
        else:
            # a malformed line poisons the whole-batch decode, and a line
            # carrying several comma-joined docs desyncs the doc<->line
            # pairing: fall back per line so only bad lines quarantine and
            # each doc is attributed to its OWN line
            pairs = []
            for ln in batch_lines:
                try:
                    pairs.append((json.loads(ln), ln))
                except ValueError:
                    try:
                        docs_on_line = json.loads(b"[" + ln + b"]")
                    except ValueError as err:
                        self._reject(ln, f"invalid VEP JSON: {err}")
                        continue
                    pairs.extend((d, ln) for d in docs_on_line)
        docs = []
        for ann, ln in pairs:
            if isinstance(ann, dict):
                docs.append((ann, ln))
            else:
                self._reject(ln, "VEP result line is not a JSON object")
        # batched combo -> rank resolution through the rank-table snapshot
        # first; the per-row parse below then hits the memo, and only novel
        # combos take the host ranker's learn-on-miss path
        self.parser.prefetch_ranks([d for d, _ in docs])
        pending: list[tuple] = []
        for ann, ln in docs:
            try:
                pending.extend(self._parse_result(ann))
            except (KeyError, ValueError, TypeError, IndexError,
                    AttributeError) as err:
                # structurally broken doc (missing 'input', bad POS...)
                self._reject(ln, f"unparseable VEP result: {err!r}")
        if pending:
            self._apply_batch(pending, alg_id, commit)

    def _native_range(self, res, alg_id: int, commit: bool, doc_lo: int,
                      doc_hi: int, row_lo: int, row_hi: int) -> None:
        """Count and apply docs [doc_lo, doc_hi) of a transformed block,
        whose rows are [row_lo, row_hi): per-alt rows, '.'-alt skips and
        skipped contigs.  Rows of docs re-transformed after a restart are
        counted by the later transform only."""
        self.counters["variant"] += row_hi - row_lo
        self.counters["skipped"] += int(
            res.doc_skipped[doc_lo:doc_hi].sum()
        ) + int((res.doc_fallback[doc_lo:doc_hi] == 2).sum())
        self.transform_stats["native_rows"] += row_hi - row_lo
        if row_hi > row_lo:
            self._apply_native(res, alg_id, commit, row_lo, row_hi)

    def _apply_native(self, res, alg_id: int, commit: bool, lo: int,
                      hi: int) -> None:
        """Apply rows [lo, hi) of a transformed block: membership and the
        RawJson store writes.  No per-row Python dicts are built; sharing
        one RawJson across a doc's alts is safe because raw values are
        immutable (the store materializes fresh objects on merge and
        read)."""
        # the Python path's row split: --skipExisting's in-batch duplicate
        # check resets per sub-batch, so the duplicates count follows it
        cap = 2 * next_pow2(self.batch_size)
        if hi - lo > cap:
            for s0 in range(lo, hi, cap):
                self._apply_native(res, alg_id, commit, s0, min(s0 + cap, hi))
            return
        sl = slice(lo, hi)
        chrom, pos = res.chrom[sl], res.pos[sl]
        ref, alt = res.ref[sl], res.alt[sl]
        ref_len, alt_len = res.ref_len[sl], res.alt_len[sl]
        ms_off, ms_len = res.ms_off[sl], res.ms_len[sl]
        rk_off, rk_len = res.rk_off[sl], res.rk_len[sl]
        fq_off, fq_len = res.fq_off[sl], res.fq_len[sl]
        vo_off, vo_len = res.vo_off[sl], res.vo_len[sl]
        # identity straight from the transformer: its hash is the kernel's
        # bit-exact twin, over-width rows already full-string re-hashed
        h = res.hash[sl]
        arena = res.arena
        # ASCII arenas (the normal case) decode once; byte offsets then
        # equal str offsets and the C assembly slices the str
        arena_s = arena.decode("ascii") if arena.isascii() else None
        counters = self.counters
        raw_cache: dict[tuple, RawJson] = {}  # (off, len) -> shared instance

        def raw_column(offs, lens) -> list:
            if arena_s is not None:
                return pyfast.raw_rows(arena_s, offs, lens, RawJson)
            out = []
            for off, length in zip(offs.tolist(), lens.tolist()):
                if length == 0:
                    out.append({})
                    continue
                v = raw_cache.get((off, length))
                if v is None:
                    v = raw_cache[(off, length)] = RawJson(
                        arena[off:off + length].decode()
                    )
                out.append(v)
            return out

        for code in np.unique(chrom):
            sel = np.flatnonzero(chrom == code)
            shard = self.store.shard(int(code))
            found, idx = shard.lookup(
                pos[sel], h[sel], ref[sel], alt[sel], ref_len[sel],
                alt_len[sel], device=self.device, stats=self.probe_stats,
            )
            counters["not_found"] += int((~found).sum())
            rows_i = sel[found]
            ids = idx[found]
            if self.skip_existing and rows_i.size:
                # first occurrence per store row wins; a stored vep_output
                # marks a duplicate
                keep = np.ones(rows_i.size, np.bool_)
                seen_in_batch: set[int] = set()
                for j, row_idx in enumerate(ids.tolist()):
                    if (row_idx in seen_in_batch
                            or shard.get_ann("vep_output", row_idx)
                            is not None):
                        keep[j] = False
                    elif commit:
                        # dry runs buffer nothing: only the stored-value
                        # check applies, as on the Python path
                        seen_in_batch.add(row_idx)
                counters["duplicates"] += int((~keep).sum())
                rows_i, ids = rows_i[keep], ids[keep]
            counters["update"] += int(rows_i.size)
            if not commit or rows_i.size == 0:
                continue
            # one list per column (consecutive shared spans — a doc's
            # vep_output across its alts — collapse to one instance)
            fmask = fq_len[rows_i] > 0
            fq_rows = rows_i[fmask]
            upd_freq = raw_column(fq_off[fq_rows], fq_len[fq_rows])
            upd_ms = raw_column(ms_off[rows_i], ms_len[rows_i])
            upd_ranked = raw_column(rk_off[rows_i], rk_len[rows_i])
            upd_vep = raw_column(vo_off[rows_i], vo_len[rows_i])
            ids = np.asarray(ids, np.int64)
            if fq_rows.size:
                shard.update_annotation(ids[fmask], "allele_frequencies",
                                        upd_freq)
            shard.update_annotation(ids, "adsp_most_severe_consequence", upd_ms)
            shard.update_annotation(ids, "adsp_ranked_consequences", upd_ranked)
            shard.update_annotation(ids, "vep_output", upd_vep)
            shard.set_col("row_algorithm_id", ids, alg_id)
            if self.is_adsp:
                shard.set_col("is_adsp_variant", ids, 1)

    def _batch_identity(self, batch: VariantBatch):
        """(hash [N] uint32, prefix_len [N], host_fallback [N]) for one
        per-alt batch — the three identity outputs the update path
        consumes.  On a card: one launch of the fused kernel, then one
        copy of the three columns into pinned host memory and one
        synchronisation."""
        with self.identity_timer.stage("dispatch", items=batch.n):
            args = [to_device(x, self.device) for x in batch[1:]]
            ann, h = annotate_hash_fn(self.device)(None, *args)
            self.identity_batches += 1
        with self.identity_timer.stage("copy_back", items=batch.n):
            cols = (h, ann.prefix_len, ann.host_fallback)
            if self.device.type == "cuda":
                host = [torch.empty(c.shape, dtype=c.dtype, pin_memory=True)
                        for c in cols]
                for dst, src in zip(host, cols):
                    dst.copy_(src, non_blocking=True)
                torch.cuda.current_stream(self.device).synchronize()
            else:
                host = cols
            return to_uint32(host[0]), host[1].numpy(), host[2].numpy()

    def _parse_result(self, annotation: dict) -> list[tuple]:
        """One VEP result -> per-alt pending update rows, as tuples
        ``(code, pos, ref, alt, annotation, freq_values, cleaned, shared)``."""
        self.parser.rank_and_sort(annotation)
        entry = annotation["input"]
        if isinstance(entry, str):
            fields = entry.rstrip("\n").split("\t")
        else:  # pre-parsed dict (ADSP identity-only runs)
            fields = [entry.get(k, ".") for k in ("chrom", "pos", "id", "ref", "alt")]
        chrom_str, pos_str, vid, ref, alt_str = [str(f) for f in fields[:5]]
        # structured replacement for the raw input string
        # (vep_variant_loader.py:279-281)
        pos = int(pos_str)
        annotation["input"] = {
            "chrom": chrom_str, "pos": pos, "id": vid,
            "ref": ref, "alt": alt_str,
        }
        code = chromosome_code(chrom_str)
        if code == 0:
            self.counters["skipped"] += 1
            return []
        ref_snp = vid if vid.startswith("rs") else None
        matching_id = ref_snp if self.is_dbsnp else None
        freqs = VepResultParser.frequencies(annotation, matching_id)
        freq_values = freqs["values"] if freqs else None
        cleaned = VepResultParser.cleaned_result(annotation)

        rows = []
        alts = alt_str.split(",")
        multi = len(alts) - alts.count(".") > 1
        for alt in alts:
            if alt == ".":
                self.counters["skipped"] += 1
                continue
            self.counters["variant"] += 1
            # multi-alt rows share one cleaned dict and must not alias
            # inside the store (deep-merge mutates in place) — flagged here,
            # un-aliased at apply time
            rows.append(
                (code, pos, ref, alt, annotation, freq_values, cleaned, multi)
            )
        return rows

    def _apply_batch(self, rows: list[tuple], alg_id: int, commit: bool,
                     seen_freq: set | None = None) -> None:
        if seen_freq is None:
            # aliased-frequency tracking must span sub-batch splits AND
            # chromosome groups: two alts of one site sharing a frequency
            # bucket can land in different sub-batches
            seen_freq = set()
        # flushes trigger on the block's RESULT count but rows are per-alt:
        # split multi-allelic-heavy flushes the way the reference does, so
        # the sub-batches (and the store's write order) are the same
        cap = 2 * next_pow2(self.batch_size)
        if len(rows) > cap:
            for lo in range(0, len(rows), cap):
                self._apply_batch(rows[lo:lo + cap], alg_id, commit,
                                  seen_freq=seen_freq)
            return
        n_rows = len(rows)
        ref_arr, ref_len = encode_allele_array(
            [r[R_REF] for r in rows], self.store.width
        )
        alt_arr, alt_len = encode_allele_array(
            [r[R_ALT] for r in rows], self.store.width
        )
        batch = VariantBatch(
            chrom=np.fromiter(
                (r[R_CODE] for r in rows), np.int8, count=n_rows
            ),
            pos=np.fromiter((r[R_POS] for r in rows), np.int32, count=n_rows),
            ref=ref_arr, alt=alt_arr, ref_len=ref_len, alt_len=alt_len,
        )
        h, prefix, host = self._batch_identity(batch)
        check_existing = self.skip_existing  # the stored-value probe is
        # only a policy input; without the flag it is skipped
        msc = VepResultParser.most_severe_consequence
        conseqs_of = VepResultParser.allele_consequences
        counters = self.counters
        for code in np.unique(batch.chrom):
            sel = np.where(batch.chrom == code)[0]
            # over-width alleles are truncated in the device arrays and the
            # store hashed their full strings: re-hash on the host
            for i in sel[host[sel]]:
                h[i] = _fnv32_str(rows[i][R_REF], rows[i][R_ALT])
            shard = self.store.shard(code)
            found, idx = shard.lookup(
                batch.pos[sel], h[sel], batch.ref[sel], batch.alt[sel],
                batch.ref_len[sel], batch.alt_len[sel],
                device=self.device, stats=self.probe_stats,
            )
            # per-row policy first; store writes buffer and apply in ONE
            # vectorized pass per column
            upd_ids: list[int] = []
            upd_freq_ids: list[int] = []
            upd_freq: list = []
            upd_ms: list = []
            upd_ranked: list = []
            upd_vep: list = []
            seen_in_batch: set[int] = set()  # writes are buffered: the
            # stored-value check alone can't see earlier rows of this batch
            for j, i in enumerate(sel):
                if not found[j]:
                    counters["not_found"] += 1
                    continue
                row_idx = int(idx[j])
                r = rows[i]
                if check_existing and (
                        row_idx in seen_in_batch
                        or shard.get_ann("vep_output", row_idx) is not None):
                    counters["duplicates"] += 1
                    continue
                # normalized alleles key the VEP frequency/consequence maps
                if host[i]:
                    _norm_ref, norm_alt = normalize_alleles(
                        r[R_REF], r[R_ALT], snv_div_minus=True
                    )
                else:
                    p = int(prefix[i])
                    norm_alt = r[R_ALT][p:] or "-"
                freq_values = r[R_FREQ]
                allele_freq = None
                if freq_values and norm_alt in freq_values:
                    allele_freq = freq_values[norm_alt]
                ann = r[R_ANN]
                ms = msc(ann, norm_alt)
                ranked = conseqs_of(ann, norm_alt)
                if commit:
                    seen_in_batch.add(row_idx)
                    upd_ids.append(row_idx)
                    if allele_freq is not None:
                        # two alts of one site can normalize to the SAME
                        # allele (CAA->C and CAA->CA both key '-'), handing
                        # two store rows one frequency bucket — deep-merge
                        # mutates in place, so copy exactly the aliased ones
                        fkey = (id(freq_values), norm_alt)
                        if fkey in seen_freq:
                            allele_freq = _fresh(allele_freq)
                        seen_freq.add(fkey)
                        upd_freq_ids.append(row_idx)
                        upd_freq.append(allele_freq)
                    # {} merges as a no-op, so an empty new value never
                    # wipes stored data
                    upd_ms.append(ms if ms else {})
                    upd_ranked.append(ranked if ranked else {})
                    upd_vep.append(
                        _fresh(r[R_CLEANED]) if r[R_SHARED] else r[R_CLEANED]
                    )
                counters["update"] += 1
            if upd_ids:
                ids = np.array(upd_ids, np.int64)
                # un-alias the most-severe column: ms IS ranked's first
                # element (two columns of one row) and deep-merge mutates
                # in place
                upd_ms = _fresh(upd_ms)
                if upd_freq_ids:
                    shard.update_annotation(
                        np.array(upd_freq_ids, np.int64),
                        "allele_frequencies", upd_freq,
                    )
                shard.update_annotation(ids, "adsp_most_severe_consequence", upd_ms)
                shard.update_annotation(ids, "adsp_ranked_consequences", upd_ranked)
                shard.update_annotation(ids, "vep_output", upd_vep)
                shard.set_col("row_algorithm_id", ids, alg_id)
                if self.is_adsp:
                    shard.set_col("is_adsp_variant", ids, 1)
