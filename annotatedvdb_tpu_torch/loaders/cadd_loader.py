"""CADD score updater: batch join of store variants against the CADD tables.

Port of ``annotatedvdb_tpu/loaders/cadd_loader.py`` (``TpuCaddUpdater``).
The reference system (``Load/bin/load_cadd_scores.py:79-177`` +
``Util/lib/python/loaders/cadd_updater.py``) streams every variant of a
chromosome partition; per variant it skips rows whose ``cadd_scores`` is
already set, picks the SNV or indel table by allele length, tabix-fetches
the rows at its position, compares allele sets, and writes
``{CADD_raw_score, CADD_phred}`` (or a ``{}`` placeholder when unmatched,
``cadd_updater.py:216-221``).

Here the chromosome shard is the partition: candidate rows come from one
vectorized scan, the SNV/indel split is a mask, and each streamed score
block joins against its position slice of the shard in one
``ops/cadd_join.cadd_join`` call on the updater's device (one launch of
``csrc/cadd_join.cu`` on a card; the block and the slice are uploaded once
per block through pinned memory).  The whole-store path makes ONE
sequential pass over each score table for all chromosomes.  Updates write
the shard's ``cadd_scores`` column with replacement semantics (the
reference's UPDATE is a plain ``SET cadd_scores = …``, not a
jsonb_merge).  With a variant subset and block-offset indexes, the join
instead seeks into the tables per candidate (``_update_random_access``,
host only).

Long alleles: variants or table rows wider than the device width are
matched on the host with full strings (see ``io/cadd.py`` host_rows), so
truncation can never produce a false match.

With a ``mesh`` of more than one shard (``--maxWorkers``), the streamed
score rows are buffered instead and resolved in sharded update steps
against a position-partitioned snapshot of the store frozen on the shards
(``_mesh_context``, ``_join_block_mesh``, ``_flush_mesh_buffer``; one
``annotate_bin`` and one ``lookup_multi`` launch per shard on the card),
both allele orientations in one query batch, the first table row winning
per store row; the host-row semantics stay those of the block join.  The
bytes written are the same.
"""

from __future__ import annotations

import os

import numpy as np

from annotatedvdb_tpu_torch.io.cadd import (
    CADD_INDEL_FILE,
    CADD_SNV_FILE,
    CaddFileReader,
)
from annotatedvdb_tpu_torch.ops.cadd_join import INDEL_PROBE, SNV_PROBE, cadd_join
from annotatedvdb_tpu_torch.runtime import resolve_device, to_device
from annotatedvdb_tpu_torch.store import AlgorithmLedger, VariantStore
from annotatedvdb_tpu_torch.types import chromosome_code
from annotatedvdb_tpu_torch.utils.profiling import bulk_load_gc

#: the invocation's script name in the ledger — the reference's, so the
#: two packages write the same records
LEDGER_SCRIPT = "TpuCaddUpdater.update_all"


def _allele_lengths(mat: np.ndarray) -> np.ndarray:
    """True lengths of width-bounded allele rows (alleles are ACGTN... text,
    never NUL, so the zero-pad boundary is the length)."""
    return (mat != 0).sum(axis=1).astype(np.int32)


def _resolve_code(chrom) -> int:
    code = int(chrom) if isinstance(chrom, (int, np.integer)) else chromosome_code(chrom)
    if not 1 <= code <= 25:
        raise ValueError(f"unrecognized chromosome {chrom!r}")
    return code


class _ChromState:
    """Per-chromosome join state for one table pass."""

    def __init__(self, sel: np.ndarray, shard):
        self.sel = sel                          # shard row indices (ascending)
        self.pos = shard.cols["pos"][sel]       # ascending: shard is pos-sorted
        self.matched = np.zeros(sel.shape, bool)
        self.raw = np.zeros(sel.shape, np.float64)
        self.phred = np.zeros(sel.shape, np.float64)
        self.examined_hi = 0                    # rows with a completed chance to match
        # mesh join: positions holding long TABLE alleles (host-match only)
        self.host_excl: set = set()


class CaddUpdater:
    """Joins a variant store against the two CADD score tables, on
    ``device`` (``cuda:0`` by default; ``"cpu"`` runs the plain join)."""

    def __init__(
        self,
        store: VariantStore,
        ledger: AlgorithmLedger,
        database_dir: str,
        skip_existing: bool = True,
        log=print,
        quarantine=None,
        max_errors: int = -1,
        log_after: int | None = None,
        device=None,
        mesh=None,
    ):
        """``mesh``: an optional :class:`~annotatedvdb_tpu_torch.parallel.
        mesh.Mesh`; with more than one shard the table pass resolves its
        rows through the sharded update step."""
        from annotatedvdb_tpu_torch.utils.logging import ProgressCadence
        from annotatedvdb_tpu_torch.utils.profiling import StageTimer
        from annotatedvdb_tpu_torch.utils.quarantine import ErrorBudget

        self.store = store
        self.ledger = ledger
        self.snv_path = os.path.join(database_dir, CADD_SNV_FILE)
        self.indel_path = os.path.join(database_dir, CADD_INDEL_FILE)
        self.skip_existing = skip_existing
        self.log = log
        self.device = resolve_device(device)
        self.mesh = mesh if (mesh is not None and mesh.size > 1) else None
        #: busy seconds of the table scan (on the prefetch thread), the
        #: joins and the finalize, plus the whole pass's wall
        self.timer = StageTimer()
        #: chunk-granularity metrics hook (ObsSession.attach)
        self.obs = None
        #: backpressure accounting for the scan-prefetch boundary
        self.queue_stalls: dict = {}
        #: device joins: blocks joined on the device and the bytes uploaded
        #: for them (score rows and the window's variants)
        self.join_stats = {"blocks": 0, "h2d_bytes": 0}
        # --logAfter cadence over score-table rows scanned
        self._cadence = ProgressCadence(self.log, log_after, unit="table rows")
        self._rows_scanned = 0
        self.counters = {"snv": 0, "indel": 0, "not_matched": 0,
                         "skipped": 0, "update": 0}
        # quarantine sink + --maxErrors budget for malformed score rows
        # (the Python scanner captures content; see CaddFileReader.on_reject)
        self.quarantine = quarantine
        self._budget = (
            quarantine.budget if quarantine is not None
            else ErrorBudget(max_errors)
        )

    def _reject(self, line_no, raw, reason) -> None:
        self.counters["rejected"] = self.counters.get("rejected", 0) + 1
        if self.quarantine is not None:
            self.quarantine.reject(line_no, raw, reason)
        else:
            self._budget.add(1, context=f"line {line_no}: {reason}")

    #: metric label / run-ledger script name (obs.ObsSession)
    obs_name = "load-cadd"

    # ------------------------------------------------------------------

    @bulk_load_gc()
    def update_all(self, chromosomes=None, commit: bool = False,
                   test: bool = False,
                   subsets: dict[int, np.ndarray] | None = None,
                   random_access: bool | None = None) -> dict:
        """Update every (or the given) chromosome in one pass per table.

        ``subsets`` maps chromosome code -> shard row indices and restricts
        the update to those rows — the ``--fileName`` mode of the reference's
        script (``load_cadd_scores.py:180-257``).  When both
        ``chromosomes`` and ``subsets`` are given, the intersection applies.

        ``random_access``: with a subset and a block-offset sidecar
        (``io.cadd.CaddIndex``) for every table, candidate rows are joined
        via seeks into the tables instead of a sequential whole-table pass
        (the tabix-fetch equivalent, ``cadd_updater.py:167-184``).  None
        (default) auto-enables when a subset is given and every table has a
        current index; True requires it (raising if an index is missing)."""
        if chromosomes:
            codes = [_resolve_code(c) for c in chromosomes]
            codes = [c for c in codes if c in self.store.shards]
        else:
            codes = sorted(self.store.shards)
        if subsets is not None:
            codes = [c for c in codes if c in subsets]
        alg_id = self.ledger.begin(
            LEDGER_SCRIPT,
            {"snv": self.snv_path, "indel": self.indel_path,
             "chromosomes": [int(c) for c in codes]},
            commit,
        )
        # whole-shard pass: compact once so rows are position-sorted and the
        # flat views below are valid (no appends happen during a CADD join)
        for code in codes:
            shard = self.store.shards.get(code)
            if shard is None:
                continue
            if subsets is not None and len(shard.segments) > 1:
                # subset ids were gathered against a different segment
                # layout; compacting here would renumber them under the caller
                raise ValueError(
                    f"chr{code}: subset row ids require a compacted shard — "
                    "compact the store before collecting subsets "
                    "(cli.load_cadd.vcf_subsets does this)"
                )
            shard.compact()
        # one not-yet-scored scan per chromosome, shared by both table passes
        candidates = {
            code: self._candidates(
                code, subset=None if subsets is None else subsets[code]
            )
            for code in codes
        }
        if random_access and subsets is None:
            # whole-store random access would do one Python fetch per
            # variant — orders of magnitude worse than the sequential pass
            raise ValueError(
                "random_access requires a variant subset (--fileName); "
                "whole-store updates use the sequential table pass"
            )
        if random_access or (random_access is None and subsets is not None):
            from annotatedvdb_tpu_torch.io.cadd import CaddIndex

            indexes = {
                path: CaddIndex.load(path)
                for _, path, _ in self._tables() if os.path.exists(path)
            }
            if all(ix is not None for ix in indexes.values()) and indexes:
                self._update_random_access(
                    codes, candidates, indexes, commit, test
                )
                self.ledger.finish(alg_id, dict(self.counters))
                self.counters["alg_id"] = alg_id
                return dict(self.counters)
            if random_access:
                missing = [p for p, ix in indexes.items() if ix is None]
                raise ValueError(
                    "random_access requires a current block-offset index for "
                    f"every table; missing/stale: {missing or 'all tables'} "
                    "(build with load_cadd --buildIndex)"
                )
        from annotatedvdb_tpu_torch.io.prefetch import ChunkPrefetcher
        from annotatedvdb_tpu_torch.utils.pipeline import merge_stage_stats

        mesh_ctx = self._mesh_context() if self.mesh is not None else None
        with self.timer.wall():
            for kind, path, probe in self._tables():
                states: dict[int, _ChromState] = {}
                for code in codes:
                    sel = candidates[code][kind]
                    if sel.size:
                        states[code] = _ChromState(sel, self.store.shard(code))
                if not states or not os.path.exists(path):
                    continue
                reader = CaddFileReader(
                    path, width=self.store.width,
                    # both tables share one sink: the table name rides the
                    # reason so a replayed rejects file is attributable
                    on_reject=lambda ln, raw, why, _t=os.path.basename(path):
                        self._reject(ln, raw, f"{_t}: {why}"),
                    # an armed --maxErrors budget needs per-line accounting
                    # the native tokenizer cannot provide: pin the Python
                    # scanner (slower, but the user asked for enforcement)
                    engine=(
                        "python" if self._budget.max_errors >= 0 else "auto"
                    ),
                )
                # the table streams on the prefetch thread while this thread
                # joins — sequential (untagged): the join consumes
                # per-chromosome blocks in table order
                stop = False
                blocks = ChunkPrefetcher(
                    reader.blocks_all(), timer=self.timer, stage="scan",
                    name="cadd-scan",
                )
                try:
                    for code, block in blocks:
                        if code not in states:
                            continue
                        n_rows = int(block.n)
                        with self.timer.stage("join", items=n_rows):
                            if mesh_ctx is not None:
                                self._join_block_mesh(
                                    states[code], code, block, mesh_ctx
                                )
                            else:
                                self._join_block(
                                    states[code], self.store.shard(code),
                                    block, probe,
                                )
                        if self.obs is not None:
                            self.obs.chunk(n_rows)
                        self._rows_scanned += n_rows
                        self._cadence.maybe_log(
                            self._rows_scanned, self.counters,
                            self.timer.summary(),
                        )
                        if test:
                            stop = True
                            break
                finally:
                    # settle the scan thread promptly (a test-mode break or
                    # a join failure must not leave it streaming the table)
                    blocks.close()
                    merge_stage_stats(self.queue_stalls, "scan", blocks.stats)
                if mesh_ctx is not None:
                    self._flush_mesh(states, mesh_ctx)
                with self.timer.stage("finalize"):
                    self._finalize(states, kind, commit, complete=not stop)
        # terminal counter line: passes ending between cadences still log
        self._cadence.finish(
            self._rows_scanned, self.counters, self.timer.summary()
        )
        self.ledger.finish(alg_id, dict(self.counters))
        self.counters["alg_id"] = alg_id
        return dict(self.counters)

    # ------------------------------------------------------------------

    def _tables(self):
        return (
            ("snv", self.snv_path, SNV_PROBE),
            ("indel", self.indel_path, INDEL_PROBE),
        )

    def _candidates(self, code: int, subset=None) -> dict[str, np.ndarray]:
        """Shard rows eligible for update, split per table: not yet scored,
        SNV/indel by allele length (``cadd_updater.py:188``).  One pass over
        the annotation column serves both table passes."""
        empty = {"snv": np.empty((0,), np.int64), "indel": np.empty((0,), np.int64)}
        shard = self.store.shards.get(int(code))
        if shard is None or shard.n == 0:
            return empty
        shard.compact()  # row ids below are flat position-sorted ids
        rows = np.arange(shard.n) if subset is None else np.sort(np.asarray(subset))
        if self.skip_existing:
            # lazily-materialized column: None means no row is scored yet
            raw_col = shard.segments[0].obj.get("cadd_scores")
            if raw_col is not None:
                has = np.not_equal(raw_col[rows], None)
                self.counters["skipped"] += int(has.sum())
                rows = rows[~has]
        is_indel = (
            (shard.cols["ref_len"][rows] > 1) | (shard.cols["alt_len"][rows] > 1)
        )
        return {"snv": rows[~is_indel], "indel": rows[is_indel]}

    def _update_random_access(self, codes, candidates, indexes, commit,
                              test: bool = False) -> None:
        """Subset join via indexed seeks: per candidate row, fetch the score
        rows at its position and allele-set match, first match wins
        (``cadd_updater.py:187-221`` semantics); unmatched rows get the
        ``{}`` placeholder.  Candidates are position-sorted, so the fetches
        make one forward scan (``CaddIndex.fetch_sorted``).  ``test`` samples only the
        first 100 candidates of the first non-empty selection (unexamined
        rows are left untouched, never placeheld)."""
        from annotatedvdb_tpu_torch.io.cadd import open_random

        bytes_read = 0
        stop = False
        for kind, path, _probe in self._tables():
            if stop:
                break
            index = indexes.get(path)
            if index is None:
                continue
            with open_random(path) as reader:
                for code in codes:
                    sel = candidates[code][kind]
                    if sel.size == 0:
                        continue
                    if test:
                        sel = sel[:100]
                        stop = True
                    shard = self.store.shard(code)
                    matched = np.zeros(sel.shape, bool)
                    raw = np.zeros(sel.shape, np.float64)
                    phred = np.zeros(sel.shape, np.float64)
                    fetched = index.fetch_sorted(
                        reader, code, shard.cols["pos"][sel].tolist())
                    for j, (row, rows_at) in enumerate(zip(sel.tolist(), fetched)):
                        ref, alt = shard.alleles(row)
                        for s_ref, s_alt, s_raw, s_phred in rows_at:
                            # allele-set membership, first match wins
                            if ref in (s_ref, s_alt) and alt in (s_ref, s_alt):
                                matched[j] = True
                                raw[j], phred[j] = s_raw, s_phred
                                break
                    evidence = [
                        {"CADD_raw_score": float(raw[j]),
                         "CADD_phred": float(phred[j])}
                        if matched[j] else {}
                        for j in range(sel.size)
                    ]
                    n_matched = int(matched.sum())
                    self.counters[kind] += n_matched
                    self.counters["update"] += n_matched
                    self.counters["not_matched"] += int(sel.size) - n_matched
                    if commit:
                        shard.update_annotation(
                            sel, "cadd_scores", evidence, merge=False
                        )
                    if stop:
                        break
                bytes_read += reader.bytes_read
        self.counters["bytes_read"] = bytes_read

    def _device_join(self, shard, window, block, probe: int):
        """One ``cadd_join`` of the window's variants against the block's
        device rows on the updater's device: (matched, match_idx) as host
        arrays over the window.  The block's real rows and the window's
        columns are uploaded once, through pinned memory on a card."""
        k = block.n
        host = (
            shard.cols["pos"][window], shard.ref[window], shard.alt[window],
            block.pos[:k], block.ref[:k], block.alt[:k],
        )
        args = [to_device(x, self.device) for x in host]
        matched, match_idx = cadd_join(*args, probe=probe)
        self.join_stats["blocks"] += 1
        self.join_stats["h2d_bytes"] += sum(int(x.nbytes) for x in host)
        return matched.cpu().numpy(), match_idx.cpu().numpy()

    def _join_block(self, state: _ChromState, shard, block, probe: int) -> None:
        vlo = np.searchsorted(state.pos, block.min_pos, side="left")
        vhi = np.searchsorted(state.pos, block.max_pos, side="right")
        state.examined_hi = max(state.examined_hi, vhi)
        if vlo == vhi:
            return
        window = state.sel[vlo:vhi]
        # over-width variants and variants at host-row positions replay the
        # reference semantics on the host with full strings
        w = self.store.width
        over_width = (
            (shard.cols["ref_len"][window] > w) | (shard.cols["alt_len"][window] > w)
        )
        host_pos = np.isin(shard.cols["pos"][window], list(block.host_rows)) \
            if block.host_rows else np.zeros(window.shape, bool)
        host_mask = over_width | host_pos
        if block.n and not host_mask.all():
            if block.max_run > probe:
                raise ValueError(
                    f"{block.max_run} score rows share one position, "
                    f"exceeding the {probe}-deep probe window"
                )
            m, midx = self._device_join(shard, window, block, probe)
            m = m & ~host_mask
            take = m & ~state.matched[vlo:vhi]
            state.matched[vlo:vhi] |= m
            # evidence gathered host-side by index: text-parsed float64 parity
            safe = np.clip(midx, 0, None)
            state.raw[vlo:vhi] = np.where(take, block.raw[safe], state.raw[vlo:vhi])
            state.phred[vlo:vhi] = np.where(
                take, block.phred[safe], state.phred[vlo:vhi]
            )
        for j in np.where(host_mask & ~state.matched[vlo:vhi])[0]:
            row = int(window[j])
            ref, alt = shard.alleles(row)
            for s_ref, s_alt, raw, phred in block.host_rows.get(
                int(shard.cols["pos"][row]), []
            ):
                # allele-set membership, first match wins (cadd_updater.py:203-212)
                if ref in (s_ref, s_alt) and alt in (s_ref, s_alt):
                    state.matched[vlo + j] = True
                    state.raw[vlo + j] = raw
                    state.phred[vlo + j] = phred
                    break

    # -- mesh path -----------------------------------------------------------

    MESH_FLUSH_ROWS = 1 << 17  # score rows buffered per sharded resolve

    def _mesh_context(self) -> dict:
        """The frozen store snapshot on the shards (position-partitioned:
        the tables stream chromosome-sorted, and chromosome routing would
        land every flush on one shard) and the score-row buffer."""
        from annotatedvdb_tpu_torch.parallel.device_store import (
            build_device_shard_store,
            place_store,
        )

        return {
            "snapshot": place_store(
                build_device_shard_store(self.store, self.mesh.size,
                                         routing="position"),
                self.mesh,
            ),
            "buf": [],       # (code, pos, ref, alt, raw, phred) per block
            "buf_rows": 0,
        }

    def _join_block_mesh(self, state: _ChromState, code: int, block,
                         ctx: dict) -> None:
        """Buffer one block's score rows for the sharded resolve; the host
        semantics (examined range, over-width and host-row matching) stay
        those of :meth:`_join_block`."""
        vlo = np.searchsorted(state.pos, block.min_pos, side="left")
        vhi = np.searchsorted(state.pos, block.max_pos, side="right")
        state.examined_hi = max(state.examined_hi, vhi)
        shard = self.store.shard(code)
        if block.n:
            k = block.n
            ctx["buf"].append((code, block.pos[:k], block.ref[:k],
                               block.alt[:k], block.raw[:k], block.phred[:k]))
            ctx["buf_rows"] += int(k)
        if block.host_rows:
            state.host_excl.update(int(p) for p in block.host_rows)
        # long TABLE alleles: match per store row on the host, only the
        # rows that can host-match (host positions, over-width variants)
        if block.host_rows and vlo != vhi:
            window = state.sel[vlo:vhi]
            w = self.store.width
            over_width = ((shard.cols["ref_len"][window] > w)
                          | (shard.cols["alt_len"][window] > w))
            host_pos = np.isin(shard.cols["pos"][window],
                               list(block.host_rows))
            cand = np.where((over_width | host_pos)
                            & ~state.matched[vlo:vhi])[0]
            for j in cand:
                row = int(window[j])
                ref, alt = shard.alleles(row)
                for s_ref, s_alt, raw, phred in block.host_rows.get(
                        int(shard.cols["pos"][row]), []):
                    if ref in (s_ref, s_alt) and alt in (s_ref, s_alt):
                        state.matched[vlo + j] = True
                        state.raw[vlo + j] = raw
                        state.phred[vlo + j] = phred
                        break
        if ctx["buf_rows"] >= self.MESH_FLUSH_ROWS:
            self._flush_mesh_buffer(ctx)

    def _flush_mesh(self, states: dict[int, "_ChromState"], ctx: dict) -> None:
        """Resolve the buffered rows, then apply the pending matches."""
        self._flush_mesh_buffer(ctx)
        self._apply_mesh_matches(states, ctx)

    def _flush_mesh_buffer(self, ctx: dict) -> None:
        """One sharded resolve of the buffered score rows in BOTH allele
        orientations (a store row (A, G) matches table row G/A too); the
        first table row wins per store row."""
        if not ctx["buf"]:
            return
        from annotatedvdb_tpu_torch.loaders.vcf_loader import _pad_batch
        from annotatedvdb_tpu_torch.parallel.distributed import (
            distributed_update_step,
        )
        from annotatedvdb_tpu_torch.types import VariantBatch
        from annotatedvdb_tpu_torch.utils.arrays import mesh_capacity

        buf, ctx["buf"], ctx["buf_rows"] = ctx["buf"], [], 0
        chrom = np.concatenate([np.full(b[1].shape[0], b[0], np.int8)
                                for b in buf])
        pos = np.concatenate([b[1] for b in buf]).astype(np.int32)
        ref = np.concatenate([b[2] for b in buf])
        alt = np.concatenate([b[3] for b in buf])
        raw = np.concatenate([b[4] for b in buf])
        phred = np.concatenate([b[5] for b in buf])
        n = pos.shape[0]
        rl = _allele_lengths(ref)
        al = _allele_lengths(alt)
        # rows [0, n) as they are, rows [n, 2n) swapped; rid % n is the
        # table row, so table order (first match wins) survives the fold
        q = VariantBatch(
            np.concatenate([chrom, chrom]), np.concatenate([pos, pos]),
            np.concatenate([ref, alt]), np.concatenate([alt, ref]),
            np.concatenate([rl, al]), np.concatenate([al, rl]),
        )
        q = _pad_batch(q, mesh_capacity(q.n, self.mesh.size))
        rid, found, store_row, _c = distributed_update_step(
            self.mesh, q, ctx["snapshot"], routing="position"
        )
        take = (rid >= 0) & found
        src = rid[take]
        real = src < 2 * n
        src, rows_g = src[real], store_row[take][real]
        table_idx = src % n
        order = np.argsort(table_idx, kind="stable")
        rows_o, tidx_o = rows_g[order], table_idx[order]
        # (code, store_row) is unique per shard only: pair with chrom
        key = (chrom[tidx_o].astype(np.int64) << 48) | rows_o
        _, first = np.unique(key, return_index=True)
        ctx.setdefault("pending", []).append((
            chrom[tidx_o[first]], rows_o[first],
            raw[tidx_o[first]], phred[tidx_o[first]],
        ))

    def _apply_mesh_matches(self, states: dict[int, "_ChromState"],
                            ctx: dict) -> None:
        """Scatter resolved matches into the per-chromosome states (store
        row -> candidate position by one searchsorted per flush)."""
        for chrom_m, rows_m, raw_m, phred_m in ctx.pop("pending", []):
            for code in np.unique(chrom_m):
                state = states.get(int(code))
                if state is None:
                    continue
                m = chrom_m == code
                rows_c, raw_c, phred_c = rows_m[m], raw_m[m], phred_m[m]
                pos_in_sel = np.searchsorted(state.sel, rows_c)
                safe = np.clip(pos_in_sel, 0, state.sel.size - 1)
                ok = (pos_in_sel < state.sel.size) & (state.sel[safe] == rows_c)
                ok &= ~state.matched[safe]
                if state.host_excl:
                    # store rows at long-table-allele positions host-match
                    # only (the block join's host_mask)
                    excl = np.isin(
                        state.pos[safe], np.fromiter(
                            state.host_excl, np.int64, len(state.host_excl)
                        )
                    )
                    ok &= ~excl
                p = pos_in_sel[ok]
                state.matched[p] = True
                state.raw[p] = raw_c[ok]
                state.phred[p] = phred_c[ok]

    def _finalize(self, states: dict[int, "_ChromState"], kind: str,
                  commit: bool, complete: bool) -> None:
        """Write evidence.  Rows past the last examined position in an
        interrupted (--test) run are left untouched — writing the ``{}``
        placeholder for them would permanently hide them from later full
        runs behind skip_existing."""
        for code, state in states.items():
            hi = state.sel.size if complete else state.examined_hi
            if hi == 0:
                continue
            sel = state.sel[:hi]
            matched = state.matched[:hi]
            evidence = [
                {"CADD_raw_score": r, "CADD_phred": p} if m
                else {}  # unmatched placeholder (cadd_updater.py:216-221)
                for r, p, m in zip(
                    state.raw[:hi].tolist(), state.phred[:hi].tolist(),
                    matched.tolist(),
                )
            ]
            n_matched = int(matched.sum())
            self.counters[kind] += n_matched
            self.counters["update"] += n_matched
            self.counters["not_matched"] += int(hi) - n_matched
            if commit:
                # replacement, not merge: the reference UPDATE overwrites
                # the column wholesale (cadd_updater.py:25-27)
                self.store.shard(code).update_annotation(
                    sel, "cadd_scores", evidence, merge=False
                )
