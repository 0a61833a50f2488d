"""End-to-end VCF insert load on a torch device.

Port of ``annotatedvdb_tpu/loaders/vcf_loader.py::TpuVcfLoader`` with its
serial runner.  Per chunk: the Python tokenizer's arrays are uploaded with
``non_blocking`` copies from pinned buffers, the annotate step (the CUDA
kernel on a card, the plain torch version on the CPU) and the allele hash
are enqueued, and the host processes the PREVIOUS chunk while the device
works — dedup within the batch (one identity sort per chromosome),
membership against the store (numpy or the torch probe), egress strings
for the rows that insert, segment build, then append -> persist ->
checkpoint -> maintain, the order of the reference's store writer.

The stores this loader writes are byte-identical to the reference's for
the same VCF, batch size and Python tokenizer
(``tests/test_torch_load_vcf.py``).  Not ported yet: the overlapped
executor and prefetch spine, the native tokenizer, the packed transport,
the mesh path, reference-genome validation and display attributes.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from annotatedvdb_tpu_torch import oracle
from annotatedvdb_tpu_torch.io import egress
from annotatedvdb_tpu_torch.io.vcf import VcfBatchReader, VcfChunk
from annotatedvdb_tpu_torch.models.pipeline import annotate_fn
from annotatedvdb_tpu_torch.ops.hashing import allele_hash, to_uint32
from annotatedvdb_tpu_torch.ops.vrs import VrsDigestGenerator
from annotatedvdb_tpu_torch.oracle.binindex import closed_form_bin
from annotatedvdb_tpu_torch.runtime import resolve_device, to_device
from annotatedvdb_tpu_torch.store import AlgorithmLedger, VariantStore
from annotatedvdb_tpu_torch.store.variant_store import Segment, combined_key
from annotatedvdb_tpu_torch.types import AnnotatedBatch, VariantBatch
from annotatedvdb_tpu_torch.utils.profiling import bulk_load_gc

#: the ledger's ``script`` label for insert loads — the reference's, so
#: stores written by either package carry one provenance vocabulary
LEDGER_SCRIPT = "TpuVcfLoader.load_file"


def _slim_annotated(n: int, bin_level, leaf_bin, needs_digest,
                    host_fallback) -> AnnotatedBatch:
    """AnnotatedBatch carrying only the store-path columns; the display
    fields (derivable on demand) are zero-filled."""
    zeros_i32 = np.zeros(n, np.int32)
    return AnnotatedBatch(
        prefix_len=zeros_i32, norm_ref_len=zeros_i32,
        norm_alt_len=zeros_i32, end_location=zeros_i32,
        location_start=zeros_i32, location_end=zeros_i32,
        variant_class=np.zeros(n, np.int8),
        is_dup_motif=np.zeros(n, np.bool_),
        bin_level=bin_level, leaf_bin=leaf_bin,
        needs_digest=needs_digest, host_fallback=host_fallback,
    )


class VcfLoader:
    """Insert-or-skip VCF loads into a :class:`VariantStore` on ``device``
    (``cuda:0`` by default; ``"cpu"`` runs the plain torch versions)."""

    def __init__(
        self,
        store: VariantStore,
        ledger: AlgorithmLedger,
        datasource: str | None = None,
        genome_build: str = "GRCh38",
        batch_size: int = 1 << 16,
        skip_existing: bool = True,
        digester: VrsDigestGenerator | None = None,
        chromosome_map: dict | None = None,
        log=print,
        log_after: int | None = None,
        quarantine=None,
        max_errors: int = -1,
        device: str | torch.device | None = None,
    ):
        from annotatedvdb_tpu_torch.genome.assemblies import (
            BUILD_LENGTHS,
            length_table,
        )
        from annotatedvdb_tpu_torch.utils.logging import ProgressCadence
        from annotatedvdb_tpu_torch.utils.profiling import StageTimer
        from annotatedvdb_tpu_torch.utils.quarantine import ErrorBudget

        self.device = resolve_device(device)
        self.store = store
        self.ledger = ledger
        self.datasource = datasource.lower() if datasource else None
        self.batch_size = batch_size
        self.skip_existing = skip_existing
        self.digester = digester or VrsDigestGenerator(genome_build)
        self.chromosome_map = chromosome_map
        self.log = log
        # genome bounds sanity from the shipped length tables; builds
        # without a table skip the check
        self._chrom_lengths = (
            length_table(genome_build)
            if genome_build.lower() in BUILD_LENGTHS else None
        )
        self._cadence = ProgressCadence(self.log, log_after)
        #: per-stage host wall-clock attribution
        self.timer = StageTimer()
        self.counters = {
            "line": 0, "variant": 0, "skipped": 0, "duplicates": 0, "update": 0,
        }
        #: membership probes by path ("device" = torch probe, "host" =
        #: numpy) — observability only, never persisted
        self.probe_stats: dict[str, int] = {}
        # quarantine sink + error budget: malformed input lines are
        # preserved replayably and counted against --maxErrors; the sink's
        # budget is authoritative when present
        self.quarantine = quarantine
        self._budget = (
            quarantine.budget if quarantine is not None
            else ErrorBudget(max_errors)
        )

    def _reject(self, line_no, raw, reason) -> None:
        """Quarantine one rejected input line.  Raises ErrorBudgetExceeded
        past --maxErrors."""
        if self.quarantine is not None:
            self.quarantine.reject(line_no, raw, reason)
        else:
            self._budget.add(1, context=f"line {line_no}: {reason}")

    @property
    def is_adsp(self) -> bool:
        return self.datasource == "adsp"

    @bulk_load_gc()
    def load_file(
        self,
        path: str,
        commit: bool = False,
        test: bool = False,
        fail_at: str | None = None,
        mapping_path: str | None = None,
        resume: bool = True,
        persist=None,
    ) -> dict:
        """Load one VCF; returns counters.

        commit=False runs the full pipeline but discards mutations (dry
        run); ``test`` stops after one batch; ``fail_at`` raises when the
        chunk holding that variant id is processed (earlier chunks commit
        first).  ``persist`` (callable) runs before each ledger checkpoint
        so the durable store never lags the resume cursor (the CLI passes
        ``store.save``)."""
        alg_id = self.ledger.begin(
            LEDGER_SCRIPT,
            {"file": path, "datasource": self.datasource, "test": test},
            commit,
        )
        resume_line = self.ledger.last_checkpoint(path) if resume else 0
        if resume_line:
            self.log(f"resuming {path} after committed line {resume_line}")
        mapping_fh = open(mapping_path, "w") if mapping_path else None
        try:
            reader = VcfBatchReader(
                path,
                batch_size=self.batch_size,
                width=self.store.width,
                chromosome_map=self.chromosome_map,
                on_reject=self._reject,
            )
            with self.timer.wall():
                self._run_serial(
                    reader, alg_id, commit, resume_line, mapping_fh,
                    fail_at, persist, path, test,
                )
            self.ledger.finish(alg_id, dict(self.counters))
            # terminal counter line: short files must still log totals
            self._cadence.finish(
                self.counters["line"], self.counters, self.timer.summary()
            )
        finally:
            if self._budget.count:
                # rejected-row total, recorded on success AND abort
                self.counters["rejected"] = self._budget.count
            if mapping_fh:
                mapping_fh.close()
        self.counters["alg_id"] = alg_id
        return dict(self.counters)

    def _run_serial(self, reader, alg_id, commit, resume_line, mapping_fh,
                    fail_at, persist, path, test) -> None:
        """Double-buffered loop: chunk k+1's device work is enqueued before
        chunk k's host processing copies its results back, so device compute
        and transfers overlap host work."""
        chunks = iter(reader)
        pending = None
        while True:
            with self.timer.stage("ingest"):
                chunk = next(chunks, None)
            entry = None
            if chunk is not None:
                entry = self._dispatch_entry(chunk, resume_line)
            if pending is not None and self._consume_entry(
                    pending, alg_id, commit, resume_line, mapping_fh,
                    fail_at, persist, path, test):
                break
            pending = entry
            if chunk is None:
                break

    def _dispatch_entry(self, chunk: VcfChunk, resume_line: int) -> tuple:
        """Counter delta of one chunk (applied only when it is consumed, so
        checkpoints never count an uncommitted chunk) and its enqueued
        device work (None for counters-only and fully replayed chunks)."""
        delta = {
            "line": chunk.counters.get("line", 0),
            "skipped": (
                chunk.counters.get("skipped_alt", 0)
                + chunk.counters.get("skipped_contig", 0)
            ),
            "malformed": chunk.counters.get("malformed", 0),
        }
        handles = None
        if chunk.batch.n == 0:
            pass  # trailing counters-only chunk
        elif resume_line and chunk.line_number[-1] <= resume_line:
            # fully-replayed chunk: count it skipped, never dispatch
            delta["skipped"] += chunk.batch.n
        else:
            with self.timer.stage("dispatch"):
                handles = self._dispatch_chunk(chunk)
        return chunk, handles, delta

    def _dispatch_chunk(self, chunk: VcfChunk) -> dict:
        """Upload the chunk and enqueue annotate + hash without waiting."""
        batch = chunk.batch
        dev = [to_device(x, self.device) for x in batch]
        return {
            "ann": annotate_fn(self.device)(*dev),
            "h": allele_hash(dev[2], dev[3], dev[4], dev[5]),
        }

    def _consume_entry(self, entry, alg_id, commit, resume_line, mapping_fh,
                       fail_at, persist, path, test) -> bool:
        """Apply one chunk's counter delta, process + commit it, checkpoint.
        Returns True when the load should stop (test mode)."""
        chunk, handles, delta = entry
        for key, v in delta.items():
            self.counters[key] = self.counters.get(key, 0) + v
        if handles is None:
            return False
        if fail_at is not None and fail_at in chunk.variant_id:
            raise RuntimeError(f"failAt variant reached: {fail_at}")
        payload = self._process_chunk(chunk, handles, alg_id, commit,
                                      resume_line, mapping_fh)
        self._cadence.maybe_log(
            self.counters["line"], self.counters, self.timer.summary()
        )
        if commit:
            # the reference's store-writer order: append, persist +
            # checkpoint, THEN cascade-merge (merging persisted segments
            # references their files instead of rewriting them)
            line = int(chunk.line_number[-1])
            counters = dict(self.counters)
            payload = payload or []
            with self.timer.stage("append", items=sum(s.n for _c, s in payload)):
                for code, seg in payload:
                    self.store.shard(code).append_segment(seg)
            with self.timer.stage("persist"):
                if persist is not None:
                    persist()
                self.ledger.checkpoint(alg_id, path, line, counters)
            with self.timer.stage("maintain"):
                for code in {c for c, _seg in payload}:
                    self.store.shard(code).maintain()
        if test:
            self.log("test mode: stopping after first batch")
            return True
        return False

    def _membership_segments(self, code: int) -> list:
        shard = self.store.shards.get(int(code))
        return list(shard.segments) if shard is not None else []

    def _process_chunk(self, chunk: VcfChunk, handles: dict, alg_id, commit,
                       resume_line, mapping_fh):
        """Copy the chunk's device results back, filter to inserts, build
        the sorted segments; returns ``[(chrom code, Segment), ...]`` for
        the caller to commit (None when nothing inserts)."""
        batch = chunk.batch
        if self._chrom_lengths is not None:
            oob = batch.pos.astype(np.int64) > self._chrom_lengths[
                np.clip(batch.chrom.astype(np.int64), 0, 25)
            ]
            n_oob = int(oob.sum())
            if n_oob:  # counted + logged, not dropped
                self.counters["out_of_bounds"] = (
                    self.counters.get("out_of_bounds", 0) + n_oob
                )
                i = int(np.argmax(oob))
                self.log(
                    f"{n_oob} positions beyond chromosome bounds, e.g. "
                    f"{chunk.variant_id[i]}"
                )
        # ---- copy back only the fields the store path consumes
        with self.timer.stage("annotate", items=batch.n):
            ann_d = handles["ann"]
            h = to_uint32(handles["h"])
            host_rows = ann_d.host_fallback.cpu().numpy()
            # long alleles are truncated in the device arrays: re-hash them
            # from the original strings so identity never collides on a
            # shared prefix
            for i in np.where(host_rows)[0]:
                h[i] = _fnv32_str(chunk.refs[i], chunk.alts[i])
            ann = _slim_annotated(
                batch.n, ann_d.bin_level.cpu().numpy(),
                ann_d.leaf_bin.cpu().numpy(),
                ann_d.needs_digest.cpu().numpy(), host_rows,
            )
        # replayed rows within a partially-committed chunk
        replay = chunk.line_number <= resume_line

        # ---- in-batch dedup + membership filtering: ONE stable host sort
        # per chromosome by identity key; in-batch duplicates are
        # adjacent-equal rows after the sort (byte-confirmed, first wins),
        # and the surviving rows are already in sorted-merge append order
        insert_rows: list[np.ndarray] = []
        with self.timer.stage("lookup", items=batch.n):
            codes = np.flatnonzero(
                np.bincount(batch.chrom, minlength=26)
            ) if batch.n else ()
            for code in codes:
                rows = np.where((batch.chrom == code) & ~replay)[0]
                if rows.size == 0:
                    continue
                key = combined_key(batch.pos[rows], h[rows])
                if rows.size > 1:
                    viol = np.flatnonzero(key[1:] < key[:-1])
                    if viol.size:
                        pos_r = batch.pos[rows]
                        if bool((pos_r[viol] == pos_r[viol + 1]).all()):
                            # position-sorted input: only the equal-position
                            # runs holding a violation need a re-sort (runs
                            # are maximal, so one stable argsort over all
                            # their rows decomposes per run)
                            run_id = np.empty(pos_r.size, np.int64)
                            run_id[0] = 0
                            np.cumsum(pos_r[1:] != pos_r[:-1],
                                      out=run_id[1:])
                            dirty = np.zeros(int(run_id[-1]) + 1, np.bool_)
                            dirty[run_id[viol]] = True
                            idx = np.flatnonzero(dirty[run_id])
                            order = np.argsort(key[idx], kind="stable")
                            rows[idx] = rows[idx][order]
                            key[idx] = key[idx][order]
                        else:
                            order = np.argsort(key, kind="stable")
                            rows, key = rows[order], key[order]
                if rows.size > 1:
                    cand = np.where(key[1:] == key[:-1])[0]
                    if cand.size:
                        a, b = rows[cand], rows[cand + 1]
                        same = (
                            (batch.ref_len[b] == batch.ref_len[a])
                            & (batch.alt_len[b] == batch.alt_len[a])
                            & (batch.ref[b] == batch.ref[a]).all(axis=1)
                            & (batch.alt[b] == batch.alt[a]).all(axis=1)
                        )
                        if same.any():
                            keep = np.ones(rows.size, np.bool_)
                            keep[cand[same] + 1] = False
                            self.counters["duplicates"] += int((~keep).sum())
                            rows, key = rows[keep], key[keep]
                segs = self._membership_segments(int(code))
                if self.skip_existing and segs:
                    qref = found = None
                    for seg in segs:
                        # range pruning: probe only segments whose key
                        # range overlaps this chunk's (key is sorted)
                        if (seg.n == 0 or seg.key_max < key[0]
                                or seg.key_min > key[-1]):
                            continue
                        if qref is None:
                            qpos, qh = batch.pos[rows], h[rows]
                            qref, qalt = batch.ref[rows], batch.alt[rows]
                            qrl = batch.ref_len[rows]
                            qal = batch.alt_len[rows]
                            found = np.zeros(rows.size, np.bool_)
                        elif found.all():
                            break
                        f, _ = seg.probe(key, qpos, qh, qref, qalt, qrl, qal,
                                         device=self.device,
                                         stats=self.probe_stats)
                        found |= f
                    if found is not None:
                        self.counters["duplicates"] += int(found.sum())
                        rows = rows[~found]
                if rows.size:
                    insert_rows.append(rows)

        if not insert_rows:
            return None
        with self.timer.stage("gather", items=int(sum(r.size for r in insert_rows))):
            sel = np.concatenate(insert_rows)
            ident = sel.size == batch.n and bool(
                (sel == np.arange(batch.n)).all()
            )
            take = lambda x: np.take(np.asarray(x), sel, axis=0)
            sub = batch if ident else VariantBatch(*(take(x) for x in batch))
            sub_ann = ann if ident else _slim_annotated(
                sel.size,
                take(ann.bin_level),
                take(ann.leaf_bin),
                take(ann.needs_digest),
                take(ann.host_fallback),
            )
            over = (
                (sub.ref_len > self.store.width)
                | (sub.alt_len > self.store.width)
            )
            # allele strings only for the paths that read them (mapping
            # sidecar / digest PKs / retained long alleles)
            need_strings = (
                mapping_fh is not None
                or bool(over.any())
                or bool(np.asarray(sub_ann.needs_digest).any())
            )
            if need_strings:
                refs, alts = egress.decode_alleles(sub)
                refs, alts = refs.astype(object), alts.astype(object)
                for j in np.where(over)[0]:
                    refs[j] = chunk.refs[int(sel[j])]
                    alts[j] = chunk.alts[int(sel[j])]
            else:
                refs = alts = None
            rs_sel = chunk.rs_number[sel]
            rs_weird_sel = chunk.rs_weird[sel]

        with self.timer.stage("egress", items=int(sel.size)):
            needs_digest = np.asarray(sub_ann.needs_digest)
            if mapping_fh is not None or needs_digest.any():
                literal = egress.metaseq_ids(sub, refs, alts)
                pks = egress.primary_keys_from_ints(
                    sub, sub_ann, rs_sel, self.digester, refs, alts,
                    rs_weird=rs_weird_sel,
                    ref_snp_at=lambda j: chunk.ref_snp[int(sel[j])],
                    literal=literal,
                )
            else:
                pks = literal = None
            # device bin outputs are undefined for host-fallback rows:
            # recompute them on the host
            bin_level = np.asarray(sub_ann.bin_level).copy()
            leaf_bin = np.asarray(sub_ann.leaf_bin).copy()
            for j in np.where(np.asarray(sub_ann.host_fallback))[0]:
                end = oracle.infer_end_location(refs[j], alts[j], int(sub.pos[j]))
                bin_level[j], leaf_bin[j] = closed_form_bin(int(sub.pos[j]), end)
            sub_ann = sub_ann._replace(bin_level=bin_level, leaf_bin=leaf_bin)
            bins = (
                egress.bin_paths(sub, sub_ann) if mapping_fh is not None else None
            )

        payload: list[tuple[int, Segment]] | None = None
        if commit:
            with self.timer.stage("build", items=int(sel.size)):
                payload = []
                offset = 0
                for rows in insert_rows:
                    k = rows.size
                    j = slice(offset, offset + k)
                    jj = np.arange(offset, offset + k)
                    code = int(batch.chrom[rows[0]])
                    if bool(chunk.has_freq[rows].any()):
                        annotations = {
                            "allele_frequencies": [
                                chunk.frequencies[i] for i in rows
                            ],
                        }
                    else:
                        annotations = {}
                    seg = Segment.build(
                        {
                            "pos": sub.pos[j],
                            "h": h[rows],
                            "ref_len": sub.ref_len[j],
                            "alt_len": sub.alt_len[j],
                            "ref_snp": rs_sel[jj],
                            "is_multi_allelic": chunk.is_multi_allelic[rows],
                            "is_adsp_variant": np.full(
                                k, 1 if self.is_adsp else -1, np.int8
                            ),
                            "bin_level": bin_level[jj],
                            "leaf_bin": leaf_bin[jj],
                            "needs_digest": needs_digest[jj],
                            "row_algorithm_id": np.full(k, alg_id, np.int32),
                        },
                        sub.ref[j],
                        sub.alt[j],
                        annotations=annotations,
                        digest_pk=(
                            [pks[jx] if needs_digest[jx] else None
                             for jx in jj]
                            if needs_digest[j].any() else None
                        ),
                        # retain original strings for width-truncated rows
                        long_alleles=(
                            [(refs[jx], alts[jx]) if over[jx] else None
                             for jx in jj]
                            if over[j].any() else None
                        ),
                    )
                    payload.append((code, seg))
                    offset += k
        self.counters["variant"] += int(sel.size)

        if mapping_fh is not None:
            with self.timer.stage("mapping", items=int(sel.size)):
                self._write_mapping(mapping_fh, chunk, sel, literal, pks, bins)
        return payload

    @staticmethod
    def _write_mapping(mapping_fh, chunk, sel, literal, pks, bins) -> None:
        """One mapping-sidecar line per inserted row: variant id ->
        primary key + bin path, one write per chunk."""
        slow = chunk.id_verbatim[sel] | chunk.is_multi_allelic[sel]
        vids = literal.astype(object)
        for j in np.where(slow)[0]:
            vids[j] = chunk.variant_id[int(sel[j])]
        lines = []
        bins_l = bins.tolist()
        for j, vid in enumerate(vids.tolist()):
            pk = str(pks[j])
            b = bins_l[j]
            probe = vid + pk
            if (probe.isascii() and probe.isprintable()
                    and '"' not in probe and "\\" not in probe):
                lines.append(
                    f'{{"{vid}": [{{"primary_key": "{pk}", '
                    f'"bin_index": "{b}"}}]}}'
                )
            else:
                lines.append(
                    f'{{{json.dumps(vid)}: '
                    f'[{{"primary_key": {json.dumps(pk)}, '
                    f'"bin_index": {json.dumps(b)}}}]}}'
                )
        mapping_fh.write("\n".join(lines) + "\n")


def _fnv32_str(ref: str, alt: str) -> np.uint32:
    """Host FNV-1a over full allele strings (identity hash for rows wider
    than the device arrays), lengths first like ``ops/hashing.py``."""
    h = 2166136261
    data = bytes([len(ref) & 0xFF, len(alt) & 0xFF]) + ref.encode() + alt.encode()
    for b in data:
        h = ((h ^ b) * 16777619) & 0xFFFFFFFF
    return np.uint32(h)

