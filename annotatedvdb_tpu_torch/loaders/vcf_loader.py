"""End-to-end VCF insert load on a torch device.

Port of ``annotatedvdb_tpu/loaders/vcf_loader.py::TpuVcfLoader`` in its
default configuration: the native C++ tokenizer, the overlapped executor
and the async store writer.  Four stages run on their own threads, each
boundary a bounded in-order queue:

- ingest (``VcfBatchReader.iter_prefetched``): the tokenizer's scan (the
  C call releases the GIL);
- dispatch: pinned non-blocking uploads, one ``annotate_bin`` launch and
  non-blocking copies of the columns the host reads into pinned memory,
  all on one CUDA stream per loader, closed by one recorded event (the
  plain torch versions on the CPU);
- process (the caller's thread): waits on the chunk's event, then dedup
  within the batch (one identity sort per chromosome), membership against
  the in-flight and stored segments (numpy or the torch probe), egress
  strings for the rows that insert, segment build;
- the store writer: append -> persist -> checkpoint -> maintain.

``AVDB_PIPELINE=serial`` runs the same per-chunk steps on one thread
(double-buffered: chunk k+1 is dispatched before chunk k is processed),
and ``AVDB_ASYNC_STORE=0`` commits on the process thread; every mode
writes the same bytes.  The stores this loader writes are byte-identical
to the reference's for the same VCF, batch size and engine
(``tests/test_torch_pipeline_modes.py``, ``tests/test_torch_load_vcf.py``).
With a ``genome`` (``--refGenome``), the rows a chunk inserts are
validated against it on the loader's device (one ``validate_ref`` launch
per chunk that inserts rows on the card) and mismatches are counted, never
dropped.  With a ``mesh`` of more than one shard (``--maxWorkers``), each
chunk's device step is the sharded annotate step instead
(``parallel.distributed.distributed_annotate_step``: 16 kb position
blocks spread the chunk over the shards, one ``annotate_bin`` launch per
shard on the card), its outputs scattered back to row order; every byte
written is the same.

The host<->device transport (``ops/pack.py``), as the reference's: when
``transport_wanted`` (``AVDB_PACK_TRANSPORT``; auto on a card) the
alleles go up nibble-packed (the tokenizer's in-scan pack, else a host
encode; a chunk with a byte outside the alphabet goes up raw), and, unless
display attributes are stored, the kernel's hash, bin and flags come back
as one ``[n, 10]`` row a variant fetched with one copy (``_will_pack``).
A nibble-packed chunk of such a load takes one launch of the kernel's
packed entry (``models/pipeline.py::annotate_packed_fn``: packed alleles
in, packed rows out); a raw chunk takes ``annotate_bin`` and one
``pack_outputs`` launch; a load that stores display attributes inflates
nibble-packed alleles with one ``inflate_alleles`` launch before
``annotate_bin``.
A load that does not pack slices a chunk's allele matrices to the
power-of-two width (at least 8) that covers its longest allele when it
carries the tokenizer's hash (the width-bucketed upload).
``store_display_attributes`` fetches every annotate field and stores the
reference's ``display_attributes`` sidecar.  Every configuration writes
the same bytes.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import sys
import time
from typing import NamedTuple

import numpy as np
import torch

from annotatedvdb_tpu_torch import oracle
from annotatedvdb_tpu_torch.io import egress
from annotatedvdb_tpu_torch.io.vcf import (
    VcfBatchReader,
    VcfChunk,
    rs_is_weird,
    rs_number,
)
from annotatedvdb_tpu_torch.models.pipeline import (
    annotate_hash_fn,
    annotate_packed_fn,
    packed_mismatches,
)
from annotatedvdb_tpu_torch.ops.hashing import to_uint32
from annotatedvdb_tpu_torch.ops.pack import (
    encode_alleles_nibble,
    ensure_nibble,
    ensure_transport,
    inflate_alleles,
    pack_outputs,
    transport_wanted,
    unpack_outputs,
)
from annotatedvdb_tpu_torch.ops.vrs import VrsDigestGenerator
from annotatedvdb_tpu_torch.oracle.binindex import closed_form_bin
from annotatedvdb_tpu_torch.runtime import resolve_device, to_device
from annotatedvdb_tpu_torch.store import AlgorithmLedger, VariantStore
from annotatedvdb_tpu_torch.store.variant_store import Segment, combined_key
from annotatedvdb_tpu_torch.types import AnnotatedBatch, VariantBatch
from annotatedvdb_tpu_torch.utils.arrays import next_pow2
from annotatedvdb_tpu_torch.utils.profiling import DeviceOccupancy, bulk_load_gc

#: the ledger's ``script`` label for insert loads — the reference's, so
#: stores written by either package carry one provenance vocabulary
LEDGER_SCRIPT = "TpuVcfLoader.load_file"

#: the device step's columns the process stage reads (plus the hash when
#: the chunk carries no tokenizer hash)
COPY_BACK = ("bin_level", "leaf_bin", "needs_digest", "host_fallback")

#: the quarantine's summary reason for malformed lines the native engine
#: counted without their content (the reference's text, byte for byte)
UNCAPTURED_REASON = (
    "malformed VCF line(s); native engine captured no content "
    "— re-run with AVDB_INGEST_ENGINE=python to quarantine them"
)


class _LoadCtx(NamedTuple):
    """Per-load consume context threaded through the pipeline runners."""

    alg_id: int
    commit: bool
    resume_line: int
    mapping_fh: object
    fail_at: str | None
    persist: object
    path: str
    async_store: bool
    test: bool


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


def _pad_batch(batch: VariantBatch, n_target: int) -> VariantBatch:
    """Pad to ``n_target`` rows: chromosome 0, sentinel positions, 1-base
    lengths and zeroed allele bytes (rows no step ever counts)."""
    from annotatedvdb_tpu_torch.utils.arrays import POS_SENTINEL

    pad = n_target - batch.n
    if pad <= 0:
        return batch

    def tail(a, fill):
        return np.concatenate([a, np.full((pad,) + a.shape[1:], fill, a.dtype)])

    return VariantBatch(
        tail(batch.chrom, 0), tail(batch.pos, POS_SENTINEL),
        tail(batch.ref, 0), tail(batch.alt, 0),
        tail(batch.ref_len, 1), tail(batch.alt_len, 1),
    )


def _pinned_copy(t: torch.Tensor) -> torch.Tensor:
    """Non-blocking copy of a device tensor into fresh pinned host memory,
    on the current stream."""
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    out.copy_(t, non_blocking=True)
    return out


class VcfLoader:
    """Insert-or-skip VCF loads into a :class:`VariantStore` on ``device``
    (``cuda:0`` by default; ``"cpu"`` runs the plain torch versions).
    Call :meth:`close` when done: it stops the store-writer thread."""

    PIPELINE_DEPTH = 2  # unconsumed chunks per stage boundary (backpressure)
    MAX_INFLIGHT_COMMITS = 2  # bounds pending-segment memory + probe work

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
        genome=None,
        mesh=None,
        store_display_attributes: bool = False,
    ):
        """``genome``: an optional
        :class:`~annotatedvdb_tpu_torch.genome.ReferenceGenome`; enables
        ref-allele validation of every inserted row (the ``ref_mismatch``
        counter) and, when no ``digester`` is given, canonical GA4GH
        sequence digests for digest PKs.  ``mesh``: an optional
        :class:`~annotatedvdb_tpu_torch.parallel.mesh.Mesh`; with more
        than one shard every chunk is annotated across it.
        ``store_display_attributes``: fetch every annotate field and store
        the ``display_attributes`` sidecar (the reference's
        store-everything option; off, the egress paths recompute them)."""
        from annotatedvdb_tpu_torch.genome.assemblies import (
            BUILD_LENGTHS,
            length_table,
        )
        from annotatedvdb_tpu_torch.utils.logging import ProgressCadence
        from annotatedvdb_tpu_torch.utils.profiling import StageTimer
        from annotatedvdb_tpu_torch.utils.quarantine import ErrorBudget

        self.device = resolve_device(device)
        self.mesh = mesh if (mesh is not None and mesh.size > 1) else None
        self.store_display_attributes = store_display_attributes
        self.store = store
        self.ledger = ledger
        self.datasource = datasource.lower() if datasource else None
        self.batch_size = batch_size
        self.skip_existing = skip_existing
        if digester is None and genome is not None:
            digester = VrsDigestGenerator(
                genome_build,
                sequence_digests=genome.lazy_digests(),
                reference_bases=genome.reference_bases,
            )
        self.digester = digester or VrsDigestGenerator(genome_build)
        self.genome = genome
        self.chromosome_map = chromosome_map
        self.log = log
        # genome bounds sanity from the shipped length tables; builds
        # without a table skip the check
        self._chrom_lengths = (
            length_table(genome_build)
            if genome_build.lower() in BUILD_LENGTHS else None
        )
        self._cadence = ProgressCadence(self.log, log_after)
        #: per-stage busy seconds, per thread (``sum > wall`` = overlap)
        self.timer = StageTimer()
        self.counters = {
            "line": 0, "variant": 0, "skipped": 0, "duplicates": 0, "update": 0,
        }
        #: membership probes by path ("device" = torch probe, "host" =
        #: numpy) — observability only, never persisted
        self.probe_stats: dict[str, int] = {}
        #: union coverage of per-chunk device in-flight windows (reset per
        #: file); ``device_idle_fraction`` is the last file's 1 - busy/wall
        self._occ = DeviceOccupancy()
        self.device_idle_fraction: float | None = None
        #: backpressure accounting per stage boundary (ingest / dispatch /
        #: store-writer), accumulated across files: ``producer_block_s`` =
        #: that boundary's consumer was the bottleneck, ``consumer_wait_s``
        #: = its producer starved it
        self.queue_stalls: dict[str, dict] = {}
        #: optional :class:`annotatedvdb_tpu_torch.obs.metrics.LoadObserver`
        #: (chunk-granularity metrics; set by ``ObsSession.attach``)
        self.obs = None
        # async store writer: built segments queue to one writer thread
        # (append -> persist -> checkpoint -> maintain) while this thread
        # processes the next chunk.  Entries are (future, payload); payload
        # segments double as the pending membership set
        # (_membership_segments)
        self._inflight: collections.deque = collections.deque()
        self._writer_pool = None
        #: the dispatch stage's CUDA stream (created on first dispatch)
        self._stream = None
        #: chunks by transport (observability only): allele uploads
        #: ``nibble`` / ``raw``, output fetches ``packed`` / ``fields``, and
        #: raw uploads by matrix width (``widths``, the bucketing)
        self.transport = {"nibble": 0, "raw": 0, "packed": 0, "fields": 0,
                          "widths": {}}
        #: seconds of the last :meth:`warmup`
        self.warmup_seconds: float | None = None
        # quarantine sink + error budget: malformed input lines are
        # preserved replayably and counted against --maxErrors; the sink's
        # budget is authoritative when present
        self.quarantine = quarantine
        self._budget = (
            quarantine.budget if quarantine is not None
            else ErrorBudget(max_errors)
        )
        self._rejects_captured = False

    #: metric/run-ledger label for this loader family
    obs_name = "load-vcf"

    def _reject(self, line_no, raw, reason) -> None:
        """Quarantine one rejected input line (may run on the ingest
        thread; the sink and budget are thread-safe).  Raises
        ErrorBudgetExceeded past --maxErrors."""
        if self.quarantine is not None:
            self.quarantine.reject(line_no, raw, reason)
        else:
            self._budget.add(1, context=f"line {line_no}: {reason}")

    def _reject_uncaptured(self, n: int, reason: str) -> None:
        if n <= 0:
            return
        if self.quarantine is not None:
            self.quarantine.reject_uncaptured(n, reason)
        else:
            self._budget.add(n, context=reason)

    def _stall_rec(self, name: str) -> dict:
        return self.queue_stalls.setdefault(name, {
            "items": 0, "producer_block_s": 0.0, "consumer_wait_s": 0.0,
            "max_depth": 0,
        })

    @property
    def is_adsp(self) -> bool:
        return self.datasource == "adsp"

    def warmup(self) -> None:
        """What the first chunk would otherwise pay, outside the measured
        stream.  On a card: the loader's kernel libraries built (one
        ``nvcc`` each, together), the annotate step's first-call check,
        the transport probes and the device step a nibble-packed chunk
        takes, at the loader's chunk shape: one launch of the packed entry
        where the load packs (after its own first-call check), else one
        inflate, each held against its plain version on the host (a
        mismatch raises).  On the CPU nothing compiles: only the 4-row
        probes run, where the transport is wanted.  Its seconds land in
        :attr:`warmup_seconds`."""
        t0 = time.perf_counter()
        wanted = self.mesh is None and transport_wanted(self.device)
        if wanted:
            ensure_nibble(self.device)
        will_pack = self._will_pack()
        if self.device.type == "cuda":
            from annotatedvdb_tpu_torch.io.synth import synthetic_batch
            from annotatedvdb_tpu_torch.ops.annotate_cuda import (
                annotate_bin_packed_reference,
            )
            from annotatedvdb_tpu_torch.ops.build import build

            build(["annotate_bin", "pack"]
                  + (["validate_ref"] if self.genome is not None else [])
                  + (["lookup_multi"] if self.mesh is not None else []))
            if self.mesh is None:
                annotate_hash_fn(self.device)
            if wanted:
                width = self.store.width
                batch = synthetic_batch(self.batch_size, width=width)
                enc = encode_alleles_nibble(batch.ref, batch.alt)
                if will_pack:
                    args = [torch.from_numpy(x) for x in (
                        batch.pos, *enc, batch.ref_len, batch.alt_len)]
                    got = annotate_packed_fn(self.device)(
                        *(to_device(x, self.device) for x in args), width).cpu()
                    bad = packed_mismatches(
                        annotate_bin_packed_reference(*args, width), got)
                    if bad:
                        raise RuntimeError(f"warmup: the chunk-shape packed step "
                                           f"mismatched in {bad}")
                else:
                    ref, alt = inflate_alleles(*(to_device(x, self.device)
                                                 for x in enc), width)
                    if not (np.array_equal(ref.cpu().numpy(), batch.ref)
                            and np.array_equal(alt.cpu().numpy(), batch.alt)):
                        raise RuntimeError("warmup: the chunk-shape inflate mismatched")
            torch.cuda.synchronize(self.device)
        self.warmup_seconds = time.perf_counter() - t0

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
        ``store.save``).

        Execution mode: ``AVDB_PIPELINE`` ``overlapped`` (default) or
        ``serial``; ``AVDB_ASYNC_STORE=0`` commits on the process thread
        instead of the writer thread.  The reader's chunk size is
        ``AVDB_INGEST_CHUNK_ROWS`` when set, else ``batch_size``."""
        from annotatedvdb_tpu_torch.io.prefetch import ingest_chunk_rows

        alg_id = self.ledger.begin(
            LEDGER_SCRIPT,
            {"file": path, "datasource": self.datasource, "test": test},
            commit,
        )
        resume_line = self.ledger.last_checkpoint(path) if resume else 0
        if resume_line:
            self.log(f"resuming {path} after committed line {resume_line}")
        mapping_fh = open(mapping_path, "w") if mapping_path else None
        async_store = commit and os.environ.get("AVDB_ASYNC_STORE", "1") != "0"
        overlapped = os.environ.get(
            "AVDB_PIPELINE", "overlapped"
        ).lower() != "serial"
        ctx = _LoadCtx(alg_id, commit, resume_line, mapping_fh, fail_at,
                       persist, path, async_store, test)
        try:
            # this file's device-idle headline must not absorb earlier
            # files loaded through the same loader
            self._occ = DeviceOccupancy()
            wall0 = self.timer.wall_seconds
            stage0 = self.timer.as_dict()
            reader = VcfBatchReader(
                path,
                batch_size=ingest_chunk_rows(self.batch_size),
                width=self.store.width,
                chromosome_map=self.chromosome_map,
                # the mesh path never uploads packed alleles, and a load
                # that does not want the transport skips the pack work
                pack_alleles=self.mesh is None and transport_wanted(self.device),
                on_reject=self._reject,
            )
            # content-capturing rejects reach _reject directly (Python
            # scanner); native-engine loads budget-count from the chunks'
            # malformed counters instead (_consume_entry).  Resolving the
            # engine here builds the native library on this thread, so a
            # failed build raises before any stage starts
            self._rejects_captured = reader.rejects_captured
            with self.timer.wall():
                if overlapped:
                    self._run_overlapped(reader, ctx)
                else:
                    self._run_serial(reader, ctx)
                self._drain_inflight()
            self.device_idle_fraction = self._occ.idle_fraction(
                self.timer.wall_seconds - wall0
            )
            if self.obs is not None:
                # per-stage busy-seconds deltas for THIS file, plus the
                # device-idle gauge, onto the obs plane
                after = self.timer.as_dict()
                for name, rec in after.items():
                    prev = stage0.get(name, {}).get("seconds", 0.0)
                    self.obs.stage_seconds(name, rec["seconds"] - prev)
                self.obs.device_idle(self.device_idle_fraction)
            self.ledger.finish(alg_id, dict(self.counters))
            # terminal counter line: short files must still log totals
            self._cadence.finish(
                self.counters["line"], self.counters, self.timer.summary()
            )
        finally:
            if self._budget.count:
                # rejected-row total, recorded on success AND abort
                self.counters["rejected"] = self._budget.count
            try:
                # earlier chunks' queued commits land even when a later
                # chunk raised (failAt: everything before the fault
                # commits, the fault's own chunk does not)
                self._drain_inflight()
            finally:
                if mapping_fh:
                    mapping_fh.close()
        self.counters["alg_id"] = alg_id
        return dict(self.counters)

    # -- pipeline runners ---------------------------------------------------

    def _run_serial(self, reader: VcfBatchReader, ctx: _LoadCtx) -> None:
        """Single-thread double-buffered loop: chunk k+1's device work is
        enqueued before chunk k's results are read back, so device compute
        and transfers still overlap host work — but ingest, dispatch and
        process share this thread's clock."""
        chunks = iter(reader)
        pending = None
        while True:
            with self.timer.stage("ingest"):
                chunk = next(chunks, None)
            entry = None
            if chunk is not None:
                entry = self._dispatch_entry(
                    self._entry_from_chunk(chunk, ctx.resume_line)
                )
            if pending is not None and self._consume_entry(pending, ctx):
                break
            pending = entry
            if chunk is None:
                break

    def _run_overlapped(self, reader: VcfBatchReader, ctx: _LoadCtx) -> None:
        """Overlapped executor: ingest thread -> dispatch thread -> this
        (process) thread -> store-writer thread, each boundary a bounded
        queue.

        Chunks travel seq-tagged: the prefetcher may emit them SHUFFLED
        (``AVDB_INGEST_SHUFFLE_SEED``) and dispatch is order-independent,
        but a :class:`Resequencer` restores source order before this
        consumer — so counters, identity first-wins, checkpoint cursors
        and ``--maxErrors`` accounting all apply in chunk order."""
        from annotatedvdb_tpu_torch.io.prefetch import (
            ingest_prefetch_depth,
            ingest_shuffle_seed,
        )
        from annotatedvdb_tpu_torch.utils.pipeline import (
            BoundedStage,
            Resequencer,
            merge_stage_stats,
        )

        depth = ingest_prefetch_depth(self.PIPELINE_DEPTH)
        ingest = reader.iter_prefetched(
            depth=depth, timer=self.timer,
            shuffle_seed=ingest_shuffle_seed(), tagged=True,
        )
        dispatch = BoundedStage(
            ingest,
            fn=lambda tagged: (
                tagged[0],
                self._dispatch_entry(
                    self._entry_from_chunk(tagged[1], ctx.resume_line)
                ),
            ),
            depth=depth,
            name="vcf-dispatch",
        )
        tracer = self.timer.tracer
        entries = Resequencer(dispatch)
        try:
            for entry in entries:
                if tracer is not None:
                    # queue-depth samples, one counter track per boundary
                    # (per chunk, so about zero cost)
                    tracer.counter(
                        "queue_depth", ingest=ingest.depth(),
                        dispatch=dispatch.depth(),
                        resequencer=entries.held(),
                        store_writer=len(self._inflight),
                    )
                if self._consume_entry(entry, ctx):
                    break
        finally:
            # stop both producers promptly (a failed load must not leave a
            # tokenizer thread scanning a multi-GB file); dispatched device
            # work is abandoned, and un-applied chunks never touched the
            # counters.  UPSTREAM first: the dispatch thread may be blocked
            # pulling from ingest, and ingest.close() unblocks it
            ingest.close()
            dispatch.close()
            merge_stage_stats(self.queue_stalls, "ingest", ingest.stats)
            merge_stage_stats(self.queue_stalls, "dispatch", dispatch.stats)
            # a stage error whose envelope never reached this consumer
            # (dropped by the close) is the abort's ROOT CAUSE — log it
            # unless it is the very exception already propagating
            propagating = sys.exc_info()[1]
            for name, stage in (("ingest", ingest), ("dispatch", dispatch)):
                if stage.error is not None and stage.error is not propagating:
                    self.log(
                        f"pipeline {name} stage failed during teardown: "
                        f"{stage.error!r}"
                    )

    def _entry_from_chunk(self, chunk: VcfChunk, resume_line: int) -> tuple:
        """Ingest-side accounting for one chunk: the counter delta that
        travels with it (applied only when the chunk is consumed, so
        checkpoints never count an uncommitted chunk) and whether it needs
        device dispatch at all."""
        delta = {
            "line": chunk.counters.get("line", 0),
            "skipped": (
                chunk.counters.get("skipped_alt", 0)
                + chunk.counters.get("skipped_contig", 0)
            ),
            "malformed": chunk.counters.get("malformed", 0),
        }
        needs_dispatch = True
        if chunk.batch.n == 0:
            needs_dispatch = False  # trailing counters-only chunk
        elif resume_line and chunk.line_number[-1] <= resume_line:
            # fully-replayed chunk: count it skipped, never dispatch
            delta["skipped"] += chunk.batch.n
            needs_dispatch = False
        return chunk, delta, needs_dispatch

    def _dispatch_entry(self, entry: tuple) -> tuple:
        """Dispatch stage: enqueue the chunk's device work (no result is
        waited for here — see ``_dispatch_chunk``)."""
        chunk, delta, needs_dispatch = entry
        handles = None
        if needs_dispatch:
            with self.timer.stage("dispatch"):
                handles = self._dispatch_chunk(chunk)
            # the device in-flight window opens at enqueue; _process_chunk
            # closes it when the results are ready (DeviceOccupancy)
            handles["t0"] = time.perf_counter()
        return chunk, handles, delta

    def _load_chunk(self, chunk: VcfChunk, alg_id, commit, resume_line,
                    mapping_fh) -> None:
        """Synchronous dispatch + process of one chunk, committed on this
        thread (never through the store writer): the path of callers that
        re-chunk rows through the insert loader and look the new rows up
        right after (the update loaders' novel rows)."""
        self._process_chunk(
            chunk, self._dispatch_chunk(chunk), alg_id, commit,
            resume_line, mapping_fh,
        )

    def _will_pack(self) -> bool:
        """Whether chunks fetch their outputs as one packed row each: a
        single-device load that stores no display attributes, with the
        transport wanted on its device.  Such a load first runs the
        transport's probe, which raises when it fails."""
        if (self.mesh is not None or self.store_display_attributes
                or not transport_wanted(self.device)):
            return False
        ensure_transport(self.device)
        return True

    def _nibble_alleles(self, chunk: VcfChunk):
        """The chunk's allele matrices nibble-packed for the upload, or None
        for a raw upload: the tokenizer's pre-packed matrices when present;
        a host encode unless the tokenizer found a byte outside the
        alphabet (``alleles_packable`` False) or the encode finds one; None
        when the transport is not wanted (or on a mesh).  A packed upload
        first runs the nibble probe, which raises when it fails."""
        if self.mesh is not None or not transport_wanted(self.device):
            return None
        ensure_nibble(self.device)
        if chunk.ref_packed is not None:
            return chunk.ref_packed, chunk.alt_packed
        if chunk.alleles_packable is False:
            return None
        return encode_alleles_nibble(chunk.batch.ref, chunk.batch.alt)

    def _upload_width(self, chunk: VcfChunk, will_pack: bool) -> int:
        """The width of a raw allele upload: the power-of-two bucket (at
        least 8) covering the chunk's longest allele when that is narrower
        than the matrices and the chunk carries the tokenizer's hash (the
        device hash of a sliced matrix is not the store's; annotate
        outputs do not depend on the width).  A packing load keeps the
        full width: it stores the device hash."""
        batch = chunk.batch
        width = batch.ref.shape[1]
        if chunk.h_native is None or will_pack or width <= 8 or batch.n == 0:
            return width
        longest = max(int(batch.ref_len.max()), int(batch.alt_len.max()), 1)
        bucket = next_pow2(max(longest, 8))
        return bucket if bucket < width else width

    def _dispatch_chunk(self, chunk: VcfChunk) -> dict:
        """Enqueue the chunk's device step without waiting: on a card,
        pinned non-blocking uploads of the positions, lengths and alleles
        (the chromosome codes stay on the host: no step reads them), then,
        for a chunk that goes up nibble-packed on a load that packs
        (:meth:`_will_pack`), one launch of the packed entry and one
        non-blocking copy of its ``[n, 10]`` rows.  Otherwise the alleles
        go up nibble-packed and are inflated by one ``inflate_alleles``
        launch when the transport is wanted, else raw at
        :meth:`_upload_width`; then one ``annotate_bin`` launch and either
        one ``pack_outputs`` launch and the copy of its rows or copies of
        the ``COPY_BACK`` columns (every annotate field with display
        attributes; the hash when the chunk carries no tokenizer hash) into
        fresh pinned host tensors.  All of it on this loader's stream, then
        one event recorded there.  The process stage waits on that event
        alone, never on the device as a whole, so it does not queue behind
        the next chunk's work.  On the CPU the plain versions run here and the event is
        None.  The lazy sidecar columns are never touched on this thread."""
        if self.mesh is not None:
            # the sharded step returns host arrays (its gather is the sync)
            self.transport["fields"] += 1
            return {"cols": self._annotate_distributed(chunk), "event": None}
        on_card = self.device.type == "cuda"
        if on_card and self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        batch = chunk.batch
        will_pack = self._will_pack()
        enc = self._nibble_alleles(chunk)
        width = batch.ref.shape[1]
        fused = enc is not None and will_pack
        with torch.cuda.stream(self._stream) if on_card else contextlib.nullcontext():
            # the first call checks the kernel entry against its plain
            # version (raises on a mismatch, failing the load)
            step = (annotate_packed_fn if fused else annotate_hash_fn)(self.device)
            pos, ref_len, alt_len = (to_device(x, self.device)
                                     for x in (batch.pos, batch.ref_len, batch.alt_len))
            if enc is not None:
                self.transport["nibble"] += 1
            if will_pack:
                # the dup lane stays zero: in-batch dedup is the host's
                self.transport["packed"] += 1
            if fused:
                cols = {"packed": step(pos, to_device(enc[0], self.device),
                                       to_device(enc[1], self.device),
                                       ref_len, alt_len, width)}
            else:
                if enc is not None:
                    ref, alt = inflate_alleles(to_device(enc[0], self.device),
                                               to_device(enc[1], self.device), width)
                else:
                    w = self._upload_width(chunk, will_pack)
                    self.transport["raw"] += 1
                    self.transport["widths"][w] = self.transport["widths"].get(w, 0) + 1
                    ref, alt = (to_device(m[:, :w], self.device)
                                for m in (batch.ref, batch.alt))
                ann, h = step(None, pos, ref, alt, ref_len, alt_len)
                if will_pack:
                    cols = {"packed": pack_outputs(h, None, ann.bin_level, ann.leaf_bin,
                                                   ann.needs_digest, ann.host_fallback)}
                else:
                    self.transport["fields"] += 1
                    names = (AnnotatedBatch._fields if self.store_display_attributes
                             else COPY_BACK)
                    cols = {name: getattr(ann, name) for name in names}
                    if chunk.h_native is None:
                        cols["h"] = h
            if not on_card:
                return {"cols": cols, "event": None}
            cols = {name: _pinned_copy(t) for name, t in cols.items()}
            event = torch.cuda.Event()
            event.record(self._stream)
        return {"cols": cols, "event": event}

    def _annotate_distributed(self, chunk: VcfChunk) -> dict:
        """Mesh path: pad to a mesh multiple, run the sharded annotate step
        with position-block routing (chromosome-sorted input spreads over
        every shard; dedup and the store stay on the host) and scatter the
        ``COPY_BACK`` columns (and the hash) back to row order through the
        returned row ids (every annotate field with display attributes).
        Capacity is the exact lossless minimum: a drop is a bug."""
        from annotatedvdb_tpu_torch.parallel.distributed import (
            distributed_annotate_step,
            position_block_owner,
        )

        batch = chunk.batch
        n_dev = self.mesh.size
        padded = _pad_batch(batch, batch.n + (-batch.n) % n_dev)
        owner = position_block_owner(padded.chrom, padded.pos, n_dev)
        ann, rid, _counts, dropped, _n_fb, h = distributed_annotate_step(
            self.mesh, padded, owner=owner, with_hash=True,
        )
        if dropped:
            raise RuntimeError(
                f"distributed annotate dropped {int(dropped)} rows despite "
                "lossless capacity"
            )
        take = rid >= 0
        src = rid[take]
        n_real = int((batch.chrom > 0).sum())
        if src.size != n_real:
            raise RuntimeError(
                f"row-id coverage {src.size} != real row count {n_real}"
            )
        cols = {}
        names = AnnotatedBatch._fields if self.store_display_attributes else COPY_BACK
        for name in names:
            vals = getattr(ann, name)
            arr = np.zeros(batch.n, vals.dtype)
            arr[src] = vals[take]
            cols[name] = torch.from_numpy(arr)
        if chunk.h_native is None:
            arr = np.zeros(batch.n, np.uint32)
            arr[src] = h[take]
            cols["h"] = torch.from_numpy(arr.view(np.int32))
        return cols

    def _consume_entry(self, entry: tuple, ctx: _LoadCtx) -> bool:
        """Process one dispatched chunk on the consumer thread: apply its
        counter delta, process + commit it, checkpoint.  Returns True when
        the load should stop (test mode)."""
        chunk, handles, delta = entry
        t_chunk = time.perf_counter() if self.obs is not None else 0.0
        for key, v in delta.items():
            self.counters[key] = self.counters.get(key, 0) + v
        if delta["malformed"] and not self._rejects_captured:
            # native tokenizer: malformed lines were counted without
            # content — budget-check them HERE, on the process thread in
            # chunk order, so --maxErrors trips at the same input line
            # however the prefetcher scheduled the chunks
            self._reject_uncaptured(delta["malformed"], UNCAPTURED_REASON)
        if handles is None:
            # resume-replayed / counters-only chunks are not observed:
            # avdb_rows_total means rows actually processed
            return False
        if ctx.fail_at is not None and ctx.fail_at in chunk.variant_id:
            raise RuntimeError(f"failAt variant reached: {ctx.fail_at}")
        self._prune_inflight()
        payload = self._process_chunk(
            chunk, handles, ctx.alg_id, ctx.commit, ctx.resume_line,
            ctx.mapping_fh, defer_commit=ctx.async_store,
        )
        self._cadence.maybe_log(
            self.counters["line"], self.counters, self.timer.summary()
        )
        line = int(chunk.line_number[-1])
        if ctx.commit and ctx.async_store:
            # checkpoint even for insert-less chunks (an all-duplicate
            # chunk must still advance the resume cursor)
            self._enqueue_commit(payload, ctx.persist, ctx.alg_id, ctx.path,
                                 line)
        elif ctx.commit:
            with self.timer.stage("persist"):
                if ctx.persist is not None:
                    ctx.persist()
                self.ledger.checkpoint(ctx.alg_id, ctx.path, line,
                                       dict(self.counters))
        if self.obs is not None:
            self.obs.chunk(
                chunk.batch.n, seconds=time.perf_counter() - t_chunk
            )
        if ctx.test:
            self.log("test mode: stopping after first batch")
            return True
        return False

    # -- async store writer --------------------------------------------------

    def _writer(self):
        if self._writer_pool is None:
            import concurrent.futures

            self._writer_pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="avdbc-store"
            )
        return self._writer_pool

    def _commit_job(self, payload, persist, alg_id, path, line, counters):
        """Writer-thread store commit for one chunk: append its segments,
        persist + checkpoint, THEN cascade-merge (merging persisted
        segments references their files instead of rewriting them)."""
        with self.timer.stage("append", items=sum(seg.n for _c, seg in payload)):
            for code, seg in payload:
                self.store.shard(code).append_segment(seg)
        with self.timer.stage("persist"):
            if persist is not None:
                persist()
            self.ledger.checkpoint(alg_id, path, line, counters)
        with self.timer.stage("maintain"):
            for code in {c for c, _seg in payload}:
                self.store.shard(code).maintain()

    def _enqueue_commit(self, payload, persist, alg_id, path, line) -> None:
        """Queue one chunk's store commit; the bounded in-flight depth
        applies backpressure by blocking on the oldest job (blocked seconds
        land in the ``store-writer`` stall record: the writer is the
        bottleneck)."""
        fut = self._writer().submit(
            self._commit_job, payload or [], persist, alg_id, path, line,
            dict(self.counters),
        )
        self._inflight.append((fut, payload or []))
        rec = self._stall_rec("store-writer")
        rec["items"] += 1
        rec["max_depth"] = max(rec["max_depth"], len(self._inflight))
        if len(self._inflight) > self.MAX_INFLIGHT_COMMITS:
            t0 = time.perf_counter()
            while len(self._inflight) > self.MAX_INFLIGHT_COMMITS:
                self._inflight[0][0].result()
                self._inflight.popleft()
            rec["producer_block_s"] = round(
                rec["producer_block_s"] + (time.perf_counter() - t0), 4
            )

    def _prune_inflight(self) -> None:
        """Drop completed commits (surfacing writer exceptions promptly)."""
        while self._inflight and self._inflight[0][0].done():
            fut, _ = self._inflight.popleft()
            fut.result()

    def _drain_inflight(self) -> None:
        while self._inflight:
            fut, _ = self._inflight.popleft()
            fut.result()

    def close(self) -> None:
        """Stop the store-writer thread after its queued commits
        (idempotent; the loader is reusable until closed)."""
        if self._writer_pool is not None:
            self._writer_pool.shutdown(wait=True)
            self._writer_pool = None

    def _membership_segments(self, code: int) -> list:
        """Segments to probe for membership of chromosome ``code``: pending
        (enqueued, possibly not yet appended) first, then a snapshot of the
        shard's list.  Only the writer thread mutates the shard's list, and
        it appends a segment before its job completes, so pending-then-
        snapshot misses none (a duplicate of a row from the previous one or
        two chunks is found in flight)."""
        segs = [
            seg
            for _fut, payload in self._inflight
            for c, seg in payload
            if c == code
        ]
        shard = self.store.shards.get(int(code))
        if shard is not None:
            segs.extend(list(shard.segments))
        return segs

    def _process_chunk(self, chunk: VcfChunk, handles: dict, alg_id, commit,
                       resume_line, mapping_fh, defer_commit: bool = False):
        """Read the chunk's device results, filter to inserts, build the
        sorted segments.  With ``defer_commit`` the built segments are
        RETURNED as ``[(chrom code, Segment), ...]`` for the store writer;
        otherwise they are appended (and merged) here."""
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
        # ---- wait for this chunk's device step (its event only) and read
        # the host copies of the fields the store path consumes
        with self.timer.stage("annotate", items=batch.n):
            if handles["event"] is not None:
                handles["event"].synchronize()
            cols = handles["cols"]
            if "packed" in cols:
                # one [n, 10] row a variant: the device hash, bin, flags
                host = unpack_outputs(cols["packed"].numpy())
                h = host["h"]
            else:
                host = {name: t.numpy() for name, t in cols.items() if name != "h"}
                h = (chunk.h_native if chunk.h_native is not None
                     else to_uint32(cols["h"]))
            host_rows = host["host_fallback"]
            # long alleles are truncated in the device arrays: re-hash them
            # from the original strings so identity never collides on a
            # shared prefix.  Copy-on-write: h_native is a view of the
            # chunk's buffer
            fb = np.where(host_rows)[0]
            if fb.size:
                h = h.copy()
                for i in fb:
                    h[i] = _fnv32_str(chunk.refs[i], chunk.alts[i])
            if self.store_display_attributes:
                ann = AnnotatedBatch(**{name: host[name]
                                        for name in AnnotatedBatch._fields})
            else:
                ann = _slim_annotated(batch.n, host["bin_level"], host["leaf_bin"],
                                      host["needs_digest"], host_rows)
        if handles.get("t0") is not None:
            # the synchronous _load_chunk path opens no in-flight window
            self._occ.record(handles["t0"], time.perf_counter())
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
            if self.store_display_attributes:
                sub_ann = ann if ident else AnnotatedBatch(*(take(x) for x in ann))
            else:
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
            # sidecar / digest PKs / genome validation / display attributes
            # / retained long alleles)
            need_strings = (
                mapping_fh is not None
                or self.genome is not None
                or self.store_display_attributes
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
            if chunk.rs_number is not None:
                rs_sel = chunk.rs_number[sel]
                rs_weird_sel = (chunk.rs_weird[sel]
                                if chunk.rs_weird is not None else None)
            else:  # chunks built from TSV rows: derive both per row
                strs = [chunk.ref_snp[i] for i in sel]
                rs_sel = np.array([rs_number(r) for r in strs], np.int64)
                rs_weird_sel = np.array(
                    [rs_is_weird(r, n) for r, n in zip(strs, rs_sel)], bool
                )

        if self.genome is not None:
            # validate only the rows being inserted (after dedup, replay
            # and membership filters), so counts match 'variant' semantics
            from annotatedvdb_tpu_torch.genome.refgenome import validate_ref_batch

            ok = validate_ref_batch(self.genome, sub, refs, device=self.device)
            n_bad = int((~ok).sum())
            if n_bad:
                self.counters["ref_mismatch"] = (
                    self.counters.get("ref_mismatch", 0) + n_bad
                )
                bad = np.where(~ok)[0][:5]
                self.log(
                    f"{n_bad} ref-allele mismatches vs genome, e.g. "
                    + ", ".join(chunk.variant_id[int(sel[j])] for j in bad)
                )
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
            display = (
                egress.display_attributes(sub, sub_ann, refs, alts)
                if self.store_display_attributes else None
            )
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
                    if (chunk.has_freq is None
                            or bool(chunk.has_freq[rows].any())):
                        annotations = {
                            "allele_frequencies": [
                                chunk.frequencies[i] for i in rows
                            ],
                        }
                    else:
                        annotations = {}
                    if display is not None:
                        annotations["display_attributes"] = display[offset:offset + k]
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
            if not defer_commit:
                with self.timer.stage("append", items=int(sel.size)):
                    for code, seg in payload:
                        shard = self.store.shard(code)
                        shard.append_segment(seg)
                        shard.maintain()
                payload = None
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

