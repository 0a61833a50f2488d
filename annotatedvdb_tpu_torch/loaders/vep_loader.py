"""VEP result load: update-only annotation of existing store rows.

Port of ``annotatedvdb_tpu/loaders/vep_loader.py::TpuVepLoader`` with its
pure-Python transform (the reference's path under ``AVDB_NATIVE_VEP=0``).
Reference flow (``Load/bin/load_vep_result.py`` +
``Util/lib/python/loaders/vep_variant_loader.py``): stream VEP JSON lines;
per line, rank+sort the consequence blocks, re-parse the embedded VCF
``input`` entry, and per alt allele — PK lookup, skip/update existing
``vep_output``, match frequencies and consequences via the
**left-normalized** allele ('-' for emptied alleles, the VEP convention),
then batch ``jsonb_merge`` UPDATEs.

A reader thread (``io/prefetch.py``) cuts the file into 4 MiB blocks of
whole lines; each block is one flush.  A flush's per-alt rows form one
identity batch (split at ``2 * next_pow2(batch_size)`` rows): on the card
ONE launch of the fused ``annotate_bin`` kernel gives each row's allele
hash, shared-prefix length and host-fallback flag, and only those three
columns come back, in one copy after the launch; on the CPU the plain
versions compute them.  Membership then runs per chromosome shard, and
the updates deep-merge into the store's JSONB columns.  The stores this
loader writes are byte-identical to the reference's for the same store and
VEP file (``tests/test_torch_vep.py``).

Not ported: the native C++ transform and its raw-JSON values, the mesh
update step, the run-record telemetry (``obs/``) and ``warmup``.
"""

from __future__ import annotations

import gzip
import json

import numpy as np
import torch

from annotatedvdb_tpu_torch.conseq import ConsequenceRanker
from annotatedvdb_tpu_torch.io.prefetch import ChunkPrefetcher
from annotatedvdb_tpu_torch.io.vep import VepResultParser
from annotatedvdb_tpu_torch.loaders.vcf_loader import _fnv32_str
from annotatedvdb_tpu_torch.models.pipeline import annotate_hash_fn
from annotatedvdb_tpu_torch.ops.hashing import to_uint32
from annotatedvdb_tpu_torch.oracle import normalize_alleles
from annotatedvdb_tpu_torch.runtime import resolve_device, to_device
from annotatedvdb_tpu_torch.store import AlgorithmLedger, VariantStore
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

    @property
    def is_adsp(self) -> bool:
        return self.datasource == "adsp"

    @property
    def is_dbsnp(self) -> bool:
        return self.datasource == "dbsnp"

    @bulk_load_gc()
    def load_file(self, path: str, commit: bool = False, test: bool = False) -> dict:
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
                        self._flush_text(text, alg_id, commit)
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

    def _flush_text(self, text: bytes, alg_id: int, commit: bool) -> None:
        """One block of whole lines: decode, rank, parse, apply."""
        batch_lines = [ln for ln in text.split(b"\n") if ln.strip()]
        self.counters["line"] += len(batch_lines)
        if batch_lines:
            self._flush_lines(batch_lines, alg_id, commit)
        self._cadence.maybe_log(self.counters["line"], self.counters)

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
