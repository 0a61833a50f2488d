"""Batched VCF-driven annotation updates with pluggable value strategies.

Port of ``annotatedvdb_tpu/loaders/update_loader.py`` (``TpuUpdateLoader``
is :class:`UpdateLoader` here).  The reference threads an
``update_value_generator`` callback through ``VCFVariantLoader``
(``vcf_variant_loader.py:120-125``): per known variant, the strategy
returns (record PK, {update? flags}, {column: value}) and the loader
buffers a ``jsonb_merge`` UPDATE; unknown variants fall through to the
insert path.  Here the same contract is batch-shaped: chunks stream
through the shared identity rule (``loaders/lookup.py``: the tokenizer's
hash or one device step, then one sorted-merge lookup per chromosome),
strategies see the found rows, and novel rows are re-chunked through the
:class:`VcfLoader` insert path synchronously (``_load_chunk``), so they
are in the store when the loader looks them up again.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from annotatedvdb_tpu_torch.io.vcf import VcfBatchReader, VcfChunk
from annotatedvdb_tpu_torch.loaders.lookup import chunk_lookup
from annotatedvdb_tpu_torch.loaders.vcf_loader import VcfLoader
from annotatedvdb_tpu_torch.runtime import resolve_device
from annotatedvdb_tpu_torch.store import AlgorithmLedger, VariantStore
from annotatedvdb_tpu_torch.store.variant_store import JSONB_COLUMNS
from annotatedvdb_tpu_torch.types import VariantBatch
from annotatedvdb_tpu_torch.utils.profiling import bulk_load_gc


class UpdateStrategy:
    """Per-row update policy (the ``update_value_generator`` analog).

    ``values(row, existing)`` receives the parsed row dict and, for known
    variants, a view of the stored row; it returns
    ``(do_update, flag_updates, jsonb_updates)`` where ``flag_updates`` maps
    numeric store columns (e.g. ``is_adsp_variant``) to int values and
    ``jsonb_updates`` maps JSONB columns to dicts (merged with jsonb_merge
    semantics).  ``do_update=False`` counts the row as skipped."""

    #: insert variants not found in the store (the QC update inserts novel
    #: variants; SnpEff LoF updates never insert)
    insert_novel = False

    #: JSONB columns the strategy reads from ``existing``; None = all ten
    jsonb_columns: tuple | None = None

    def values(self, row: dict, existing: dict | None):
        raise NotImplementedError

    def prefilter(self, chunk):
        """Optional pre-lookup row filter: a [N] bool mask of rows worth
        processing, or None for all.  Excluded rows count as skipped
        without a store lookup (the reference skips LOF-less SnpEff lines
        before any SQL, ``load_snpeff_lof.py:264-266``).  The mask may
        include rows ``values`` rejects but must never exclude a row
        ``values`` would accept."""
        return None

    def values_batch(self, chunk, rows, existing):
        """Optional vectorized path over one chunk's found rows.

        ``rows`` are chunk row indices ([K] int); ``existing`` maps each of
        the strategy's JSONB columns to a [K] object array of stored values
        (None where the row has none).  Return None for the per-row
        :meth:`values` loop, else ``(do_mask [K] bool, {flag col: [K] int
        array}, {jsonb col: [K] list})``; JSONB entries may be ``RawJson``.
        Batch strategies see the stored state from before the chunk, as
        the per-row path does."""
        return None


class UpdateLoader:
    """Streams a VCF and applies an :class:`UpdateStrategy` per known row,
    on ``device`` (``cuda:0`` by default; ``"cpu"`` runs the plain
    versions)."""

    def __init__(
        self,
        store: VariantStore,
        ledger: AlgorithmLedger,
        strategy: UpdateStrategy,
        datasource: str | None = None,
        batch_size: int = 1 << 15,
        chromosome_map: dict | None = None,
        log=print,
        log_after: int | None = None,
        quarantine=None,
        max_errors: int = -1,
        device=None,
    ):
        from annotatedvdb_tpu_torch.utils.logging import ProgressCadence
        from annotatedvdb_tpu_torch.utils.profiling import StageTimer
        from annotatedvdb_tpu_torch.utils.quarantine import ErrorBudget

        self.device = resolve_device(device)
        self.store = store
        self.ledger = ledger
        self.strategy = strategy
        self.batch_size = batch_size
        self.chromosome_map = chromosome_map
        self.log = log
        self.quarantine = quarantine
        self._budget = (
            quarantine.budget if quarantine is not None
            else ErrorBudget(max_errors)
        )
        self._cadence = ProgressCadence(log, log_after)
        #: per-stage busy seconds (ingest / apply / persist) + wall
        self.timer = StageTimer()
        #: membership probes by path ("device" / "host"), observability only
        self.probe_stats: dict[str, int] = {}
        self.insert_loader = VcfLoader(
            store, ledger, datasource=datasource, skip_existing=False,
            log=log, device=self.device,
        )
        self.counters = {
            "line": 0, "variant": 0, "update": 0, "skipped": 0, "not_found": 0,
            "inserted": 0,
        }

    @bulk_load_gc()
    def load_file(self, path: str, commit: bool = False, test: bool = False,
                  persist=None) -> dict:
        # the ledger's script label is the reference's, strategy name and all
        alg_id = self.ledger.begin(
            type(self.strategy).__name__ + ".load_file",
            {"file": path, "test": test}, commit,
        )
        # the update CLIs always resume after the last committed checkpoint
        resume_line = self.ledger.last_checkpoint(path)
        if resume_line:
            self.log(f"resuming {path} after committed line {resume_line}")
        if not self.strategy.insert_novel:
            # pure-update strategies probe a static store per chunk
            self.store.pin_for_updates(self.device)

        def _reject(line_no, raw, reason):
            # counted BEFORE the budget check so an abort still reports the
            # row that tripped it
            self.counters["rejected"] = self.counters.get("rejected", 0) + 1
            if self.quarantine is not None:
                self.quarantine.reject(line_no, raw, reason)
            else:
                self._budget.add(1, context=f"line {line_no}: {reason}")

        reader = VcfBatchReader(
            path, batch_size=self.batch_size, width=self.store.width,
            chromosome_map=self.chromosome_map, on_reject=_reject,
        )
        # resolving the engine builds the tokenizer here: a failed build
        # raises before any chunk is read
        captured = reader.rejects_captured
        try:
            with self.timer.wall():
                chunks = iter(reader)
                while True:
                    with self.timer.stage("ingest"):
                        chunk = next(chunks, None)
                    if chunk is None:
                        break
                    if self._consume(chunk, path, alg_id, commit, test,
                                     persist, resume_line, captured):
                        break
        finally:
            self.insert_loader.close()
        self.ledger.finish(alg_id, dict(self.counters))
        self._cadence.finish(
            self.counters["line"], self.counters, self.timer.summary()
        )
        self.counters["alg_id"] = alg_id
        return dict(self.counters)

    def _consume(self, chunk, path, alg_id, commit, test, persist,
                 resume_line, captured) -> bool:
        """Apply one chunk and checkpoint it; True when the load stops."""
        self.counters["line"] += chunk.counters.get("line", 0)
        mal = chunk.counters.get("malformed", 0)
        self.counters["malformed"] = self.counters.get("malformed", 0) + mal
        if mal and not captured:
            # native tokenizer: counts only, budget-checked here
            self.counters["rejected"] = self.counters.get("rejected", 0) + mal
            if self.quarantine is not None:
                self.quarantine.reject_uncaptured(
                    mal, "malformed VCF line(s); re-run with "
                    "AVDB_INGEST_ENGINE=python to quarantine them",
                )
            else:
                self._budget.add(mal, context="malformed VCF lines")
        if chunk.batch.n == 0:  # trailing counters-only chunk
            return False
        # chunks fully covered by a committed checkpoint replay as no-ops
        # (checkpoints land on chunk boundaries)
        if resume_line and chunk.line_number[-1] <= resume_line:
            self.counters["skipped"] += chunk.batch.n
            return False
        with self.timer.stage("apply", items=chunk.batch.n):
            self._apply_chunk(chunk, alg_id, commit)
        self._cadence.maybe_log(self.counters["line"], self.counters)
        if commit:
            with self.timer.stage("persist"):
                if persist is not None:
                    persist()
                self.ledger.checkpoint(
                    alg_id, path, int(chunk.line_number[-1]),
                    dict(self.counters),
                )
        if test:
            self.log("test mode: stopping after first batch")
            return True
        return False

    # ------------------------------------------------------------------

    def _row_dict(self, chunk: VcfChunk, i: int) -> dict:
        return {
            "chrom": int(chunk.batch.chrom[i]),
            "pos": int(chunk.batch.pos[i]),
            "ref": chunk.refs[i],
            "alt": chunk.alts[i],
            "info": chunk.info[i],
            "qual": chunk.qual[i],
            "filter": chunk.filter[i],
            "format": chunk.format[i],
            "variant_id": chunk.variant_id[i],
        }

    def _lookup(self, chunk: VcfChunk):
        return chunk_lookup(self.store, chunk, device=self.device,
                            stats=self.probe_stats)

    def _fetch_existing(self, shard, ids: np.ndarray, ann_cols) -> dict:
        """Stored-value view for a batch of global row ids: {column: [K]
        object array}, one fancy-index gather per segment.  Values are
        returned as stored (dicts or RawJson); mutation goes through
        ``update_annotation``."""
        out = {}
        seg_idx, off = shard._locate(ids)
        uniq = np.unique(seg_idx)
        for c in ann_cols:
            vals = np.full(ids.shape, None, object)
            for si in uniq:
                col = shard.segments[int(si)].obj[c]
                if col is None:
                    continue
                m = seg_idx == si
                vals[m] = col[off[m]]
            out[c] = vals
        return out

    def _apply_chunk(self, chunk: VcfChunk, alg_id: int, commit: bool) -> None:
        mask = self.strategy.prefilter(chunk)
        if mask is not None and not mask.all():
            # excluded rows count as skipped without a lookup, even when
            # their variant is absent from the store (reference semantics)
            n_excluded = int((~mask).sum())
            self.counters["variant"] += n_excluded
            self.counters["skipped"] += n_excluded
            if not mask.any():
                return
            chunk = _subset_chunk(chunk, np.where(mask)[0].tolist())
        novel: list[int] = []
        ann_cols = (
            JSONB_COLUMNS if self.strategy.jsonb_columns is None
            else self.strategy.jsonb_columns
        )
        for _code, shard, sel, found, idx in self._lookup(chunk):
            # store writes buffer per chunk and land as one vectorized call
            # per column, so duplicate variants within a chunk see the
            # stored state from before the chunk (the reference's
            # accumulate-then-process, update_from_qc_pvcf_file.py:371-372):
            # both occurrences count as updates and merge in order
            self.counters["variant"] += int(sel.size)
            novel.extend(int(i) for i in sel[~found])
            rows = sel[found]
            if rows.size == 0:
                continue
            ids = idx[found].astype(np.int64)
            existing = self._fetch_existing(shard, ids, ann_cols)
            batched = self.strategy.values_batch(chunk, rows, existing)
            if batched is not None:
                self._apply_batched(shard, ids, rows, batched, alg_id, commit)
            else:
                self._apply_rows(shard, chunk, ids, rows, existing, ann_cols,
                                 alg_id, commit)

        if novel and self.strategy.insert_novel:
            self._insert_novel(chunk, novel, alg_id, commit)
        elif novel:
            self.counters["not_found"] += len(novel)

    def _apply_batched(self, shard, ids, rows, batched, alg_id, commit) -> None:
        do, flag_upd, jsonb_upd = batched
        n_do = int(do.sum())
        self.counters["update"] += n_do
        self.counters["skipped"] += int(rows.size - n_do)
        if not commit or n_do == 0:
            return
        upd_ids = ids[do]
        keep = None if n_do == rows.size else np.where(do)[0]
        for col, vals in jsonb_upd.items():
            shard.update_annotation(
                upd_ids, col, vals if keep is None else [vals[k] for k in keep],
            )
        for col, vals in flag_upd.items():
            shard.set_col(col, upd_ids, np.asarray(vals)[do])
        shard.set_col("row_algorithm_id", upd_ids, alg_id)

    def _apply_rows(self, shard, chunk, ids, rows, existing, ann_cols,
                    alg_id, commit) -> None:
        """The per-row path (strategies without a batch path)."""
        upd_ids: dict[str, list[int]] = {}
        upd_vals: dict[str, list] = {}
        flag_ids: dict[str, list[int]] = {}
        flag_vals: dict[str, list[int]] = {}
        touched: list[int] = []
        for j in range(rows.size):
            i = int(rows[j])
            row_idx = int(ids[j])
            ex = {c: existing[c][j] for c in ann_cols}
            do_update, flags, jsonb = self.strategy.values(
                self._row_dict(chunk, i), ex
            )
            if not do_update:
                self.counters["skipped"] += 1
                continue
            self.counters["update"] += 1
            if not commit:
                continue
            touched.append(row_idx)
            for col, value in jsonb.items():
                upd_ids.setdefault(col, []).append(row_idx)
                upd_vals.setdefault(col, []).append(value)
            for col, value in flags.items():
                flag_ids.setdefault(col, []).append(row_idx)
                flag_vals.setdefault(col, []).append(value)
        for col, cids in upd_ids.items():
            shard.update_annotation(np.asarray(cids, np.int64), col, upd_vals[col])
        for col, cids in flag_ids.items():
            shard.set_col(col, np.asarray(cids, np.int64),
                          np.asarray(flag_vals[col]))
        if touched:
            shard.set_col("row_algorithm_id", np.asarray(touched, np.int64),
                          alg_id)

    def _insert_novel(self, chunk: VcfChunk, novel: list[int], alg_id: int,
                      commit: bool) -> None:
        """Insert unknown variants through the VCF insert path, then apply
        the strategy's values to the fresh rows (the reference folds the
        update fields into the COPY, ``update_from_qc_pvcf_file.py:34-72``).
        Global row ids shift with the append, so the rows are looked up
        after the insert."""
        sub = _subset_chunk(chunk, novel)
        inserted_before = self.insert_loader.counters["variant"]
        self.insert_loader._load_chunk(sub, alg_id, commit, 0, None)
        self.counters["inserted"] += (
            self.insert_loader.counters["variant"] - inserted_before
        )
        for _code, shard, sel, found, idx in self._lookup(sub):
            for j, i in enumerate(sel):
                if not found[j]:
                    continue  # dry run: nothing was inserted
                do_update, flags, jsonb = self.strategy.values(
                    self._row_dict(sub, int(i)), None
                )
                if not do_update or not commit:
                    continue
                one = np.array([int(idx[j])])
                for col, value in jsonb.items():
                    shard.update_annotation(one, col, [value])
                for col, value in flags.items():
                    shard.set_col(col, one, value)


def _subset_chunk(chunk: VcfChunk, rows: list[int]) -> VcfChunk:
    """The chunk's rows ``rows``, every per-row field subset with the batch.

    Generic over the dataclass: per-row arrays gather, per-row lists and
    lazy columns re-materialize, so a newly added sidecar field can never
    be left full-length (a stale column indexes the wrong rows)."""
    sel = np.asarray(rows)
    n = chunk.batch.n
    out = {
        "batch": VariantBatch(*(np.asarray(x)[sel] for x in chunk.batch)),
        "counters": {},
    }
    for f in dataclasses.fields(chunk):
        if f.name in out:
            continue
        v = getattr(chunk, f.name)
        if isinstance(v, np.ndarray) and v.shape[:1] == (n,):
            out[f.name] = v[sel]
        elif hasattr(v, "__len__") and not isinstance(
                v, (str, bytes, dict, np.ndarray)) and len(v) == n:
            out[f.name] = [v[i] for i in rows]
        else:
            out[f.name] = v
    return VcfChunk(**out)
