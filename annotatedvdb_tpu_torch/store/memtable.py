"""In-memory write path: the memtable behind ``POST /variants/upsert``.

Port of ``annotatedvdb_tpu/store/memtable.py``.  A per-chromosome-group
in-memory segment set that

- **serves reads at once**: the serving snapshot overlays these segments
  after the base store's (``serve/snapshot.MemtableSnapshots``), so every
  read path (point, bulk, region, ``/regions``, ``/stats/region``) merges
  them under the store's first-wins policy: an upsert of an identity the
  store already holds is shadowed, and upserted rows render through the
  same segment machinery loaded rows do;
- **is WAL-durable**: accepted rows are CRC-framed and fsynced to the
  per-worker WAL (``store/wal.py``) before they become visible or
  acknowledged, and a fresh memtable replays them on worker start;
- **flushes to ordinary store segments** through the segment writer
  ``save()`` uses, committed by one fsynced atomic manifest replace and
  coordinated with the other writers (offline loaders) by manifest
  fingerprint: a commit that lands mid-flush aborts the flush (temps
  cleaned, rows stay in the memtable and the WAL), and the WAL is
  truncated only after the manifest commit.

Rows are built on the host (:func:`build_rows`: the host identity hash and
the closed-form bin oracle), so an upserted row equals the same row loaded
from a VCF.  A flush records one ``memtable.flush`` background span
(``obs/reqtrace.py``).  Crash contract (proven at the
``wal.{append,fsync,replay}`` and ``memtable.flush`` fault points): an
acknowledged upsert is present after recovery; an unacknowledged one is
applied in full or not at all — never a hybrid, never a torn store.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np

from annotatedvdb_tpu_torch.obs import reqtrace
from annotatedvdb_tpu_torch.store.variant_store import (
    ChromosomeShard,
    Segment,
    VariantStore,
)
from annotatedvdb_tpu_torch.store.wal import WriteAheadLog
from annotatedvdb_tpu_torch.types import chromosome_label
from annotatedvdb_tpu_torch.utils import faults
from annotatedvdb_tpu_torch.utils import io as tio
from annotatedvdb_tpu_torch.utils.locks import make_lock

#: flush temp suffix: segment files land as
#: ``chr<L>.<sid>.flush.tmp.{npz,ann.jsonl}`` before the rename step, a
#: namespace fsck attributes (``flush-tmp``, pruned under --repair)
FLUSH_TMP_SUFFIX = ".flush.tmp"


def is_flush_tmp(fname: str) -> bool:
    """Whether a directory entry is an (abandoned) memtable-flush temp."""
    return fname.endswith((FLUSH_TMP_SUFFIX + ".npz",
                           FLUSH_TMP_SUFFIX + ".ann.jsonl"))


def flush_bytes_from_env() -> int:
    """``AVDB_MEMTABLE_BYTES``: approximate in-memory bytes at which the
    memtable flushes to store segments (default 64m; ``512m``/``2g``
    suffixes; 0 disables the size trigger)."""
    raw = os.environ.get("AVDB_MEMTABLE_BYTES", "").strip().lower()
    if not raw:
        return 64 << 20
    if raw in ("0", "off"):
        return 0
    from annotatedvdb_tpu_torch.utils.strings import parse_bytes

    try:
        return parse_bytes(raw)
    except ValueError as err:
        raise ValueError(f"AVDB_MEMTABLE_BYTES: {err}") from None


def flush_age_from_env() -> float:
    """``AVDB_MEMTABLE_FLUSH_S``: oldest-unflushed-write age in seconds at
    which the memtable flushes whatever its size (default 30; 0 disables
    the age trigger)."""
    raw = os.environ.get("AVDB_MEMTABLE_FLUSH_S", "").strip()
    if not raw:
        return 30.0
    try:
        return max(float(raw), 0.0)
    except ValueError:
        raise ValueError(
            f"AVDB_MEMTABLE_FLUSH_S must be a number (got {raw!r})"
        ) from None


class MemtableFlushError(RuntimeError):
    """The flush failed hard (I/O, unreadable manifest).  The store is in
    its pre-flush state; the memtable and WAL keep every acknowledged
    row, and the next trigger retries."""


class _FlushPreempted(Exception):
    def __init__(self, reason: str):
        super().__init__(reason)
        self.reason = reason


def _manifest_fingerprint(store_dir: str) -> tuple:
    st = os.stat(os.path.join(store_dir, "manifest.json"))
    return (st.st_mtime_ns, st.st_size, st.st_ino)


def build_rows(parsed: list[dict], width: int):
    """Per-chromosome column arrays from validated upsert rows.

    ``parsed`` entries are plain data (``code``/``pos``/``ref``/``alt``/
    ``ref_snp``/``ann``).  Rows become store columns exactly as a loader
    makes them: the host identity hash (``loaders.lookup.
    identity_hashes``) and the host bin oracle (``oracle.
    infer_end_location`` + ``closed_form_bin``).  Returns ``{code: (idxs,
    rows, ref, alt, ann_cols)}``."""
    from annotatedvdb_tpu_torch.loaders.lookup import identity_hashes
    from annotatedvdb_tpu_torch.oracle.annotator import infer_end_location
    from annotatedvdb_tpu_torch.oracle.binindex import closed_form_bin
    from annotatedvdb_tpu_torch.types import encode_allele_array

    by_code: dict[int, list[int]] = {}
    for i, e in enumerate(parsed):
        by_code.setdefault(int(e["code"]), []).append(i)
    out = {}
    for code, idxs in sorted(by_code.items()):
        n = len(idxs)
        refs = [parsed[i]["ref"] for i in idxs]
        alts = [parsed[i]["alt"] for i in idxs]
        ref, ref_len = encode_allele_array(refs, width)
        alt, alt_len = encode_allele_array(alts, width)
        pos = np.fromiter(
            (parsed[i]["pos"] for i in idxs), np.int32, count=n
        )
        h = identity_hashes(width, ref, alt, ref_len, alt_len, refs, alts)
        bin_level = np.zeros(n, np.int8)
        leaf_bin = np.zeros(n, np.int32)
        for k in range(n):
            end = infer_end_location(refs[k], alts[k], int(pos[k]))
            lvl, leaf = closed_form_bin(int(pos[k]), end)
            bin_level[k] = lvl
            leaf_bin[k] = leaf
        rows = {
            "pos": pos, "h": h, "ref_len": ref_len, "alt_len": alt_len,
            "ref_snp": np.fromiter(
                (parsed[i].get("ref_snp") if parsed[i].get("ref_snp")
                 is not None else -1 for i in idxs),
                np.int64, count=n,
            ),
            "bin_level": bin_level, "leaf_bin": leaf_bin,
        }
        ann_cols: dict[str, list] = {}
        for k, i in enumerate(idxs):
            ann = parsed[i].get("ann")
            if not ann:
                continue
            for col, val in ann.items():
                if col not in ann_cols:
                    ann_cols[col] = [None] * n
                ann_cols[col][k] = val
        out[code] = (idxs, rows, ref, alt, ann_cols)
    return out


class Memtable:
    """Per-worker in-memory segment set + WAL + flush coordination.

    Reads never come here directly: ``view()`` hands an immutable (epoch,
    segments-per-code) snapshot to the overlay provider, and the serving
    engine reads those segments like any other.  Writes (``upsert``)
    serialize under one lock: membership check (first wins against the
    base store, this memtable and the batch itself), WAL append + fsync,
    then visibility, so an acknowledged row is always durable first."""

    def __init__(self, width: int, store_dir: str | None = None,
                 wal: WriteAheadLog | None = None,
                 flush_bytes: int | None = None,
                 flush_age_s: float | None = None,
                 registry=None, log=None,
                 fence_epoch: int | None = None):
        self.width = int(width)
        self.store_dir = store_dir
        self.wal = wal
        #: replication fence: the manifest ``repl_epoch`` this writer
        #: opened under (None = unfenced).  A flush observing a higher
        #: on-disk epoch aborts: the store was promoted past this writer.
        self.fence_epoch = fence_epoch
        self.log = log if log is not None else (lambda msg: None)
        self.flush_bytes = (
            flush_bytes_from_env() if flush_bytes is None
            else max(int(flush_bytes), 0)
        )
        self.flush_age_s = (
            flush_age_from_env() if flush_age_s is None
            else max(float(flush_age_s), 0.0)
        )
        self._lock = make_lock("store.memtable")
        #: the published read view (epoch, {code: [segments]}, rows,
        #: bytes): an immutable tuple replaced (never mutated) under the
        #: lock at the end of every visible change, read by view() without
        #: the lock, so a read never queues behind an upsert's WAL fsync
        self._published: tuple = (0, {}, 0, 0)
        #: guarded by self._lock
        self._shards: dict[int, ChromosomeShard] = {}
        #: guarded by self._lock — bumps on every visible change (insert,
        #: flush finalize); the overlay provider keys its view on it
        self._epoch = 0
        #: guarded by self._lock — approximate resident bytes per code
        self._bytes_by_code: dict[int, int] = {}
        #: guarded by self._lock — monotonic time of the oldest unflushed
        #: write (None = empty); the age flush trigger
        self._first_write_t: float | None = None
        #: guarded by self._lock — one flush in flight at a time; while
        #: set, upserts append segments without cascade-merging so the
        #: flush plan's segment objects stay identifiable at finalize
        self._flushing = False
        self._m_bytes = self._m_flushes = self._m_wal_bytes = None
        if registry is not None:
            self._m_bytes = registry.gauge(
                "avdb_memtable_bytes",
                "approximate bytes held by the in-memory upsert memtable",
            )
            self._m_flushes = registry.counter(
                "avdb_upsert_flushes_total",
                "memtable flushes committed to store segments",
            )
            self._m_wal_bytes = registry.counter(
                "avdb_upsert_wal_bytes_total",
                "bytes appended to the upsert write-ahead log",
            )

    # -- read-side surface ---------------------------------------------------

    @property
    def epoch(self) -> int:
        with self._lock:
            return self._epoch

    def view(self):
        """(epoch, {code: [segments]}, rows, bytes): an immutable snapshot
        of the overlay set, read lock-free off the published tuple."""
        return self._published

    def _publish_locked(self) -> None:
        """Rebuild the published view; the caller holds ``self._lock``."""
        self._published = (
            self._epoch,  # avdb: noqa[AVDB201] -- helper invoked only under self._lock (both call sites hold it)
            {code: list(sh.segments)
             for code, sh in self._shards.items() if sh.n},  # avdb: noqa[AVDB201] -- helper invoked only under self._lock
            sum(sh.n for sh in self._shards.values()),  # avdb: noqa[AVDB201] -- helper invoked only under self._lock
            sum(self._bytes_by_code.values()),  # avdb: noqa[AVDB201] -- helper invoked only under self._lock
        )

    @property
    def rows(self) -> int:
        with self._lock:
            return sum(sh.n for sh in self._shards.values())

    @property
    def nbytes(self) -> int:
        with self._lock:
            return sum(self._bytes_by_code.values())

    # -- write path ----------------------------------------------------------

    def upsert(self, base_store, parsed: list[dict],
               durable: bool = True, trace=None) -> tuple[int, int, int]:
        """Apply one validated upsert batch; returns ``(accepted,
        shadowed, wal_bytes)``.

        First wins: a row whose identity already exists in the base store,
        in this memtable or earlier in this batch is shadowed (counted,
        not applied).  Accepted rows hit the WAL (append + fsync, the ack
        barrier) before they become visible; ``durable=False`` is the
        replay path, whose rows are already in the WAL."""
        built = build_rows(parsed, self.width)
        with self._lock:
            accepted_idx: list[int] = []
            keep_by_code: dict[int, np.ndarray] = {}
            seen: set = set()
            for code, (idxs, rows, ref, alt, _ann) in built.items():
                n = len(idxs)
                found = np.zeros(n, bool)
                for shard in (
                    base_store.shards.get(code)
                    if base_store is not None else None,
                    self._shards.get(code),
                ):
                    if shard is None or not shard.n:
                        continue
                    f, _gid = shard.lookup(
                        rows["pos"], rows["h"], ref, alt,
                        rows["ref_len"], rows["alt_len"],
                    )
                    found |= f
                keep = np.zeros(n, bool)
                for k, i in enumerate(idxs):
                    ident = (code, parsed[i]["pos"], parsed[i]["ref"],
                             parsed[i]["alt"])
                    if found[k] or ident in seen:
                        continue
                    seen.add(ident)
                    keep[k] = True
                    accepted_idx.append(i)
                keep_by_code[code] = keep
            if not accepted_idx:
                return 0, len(parsed), 0
            wal_bytes = 0
            if durable and self.wal is not None:
                # the ack barrier: the WAL frame is fsynced before the rows
                # become visible — a raise here fails the request with the
                # memtable untouched
                wal_bytes = self.wal.append({
                    "rows": [parsed[i] for i in accepted_idx],
                })
                if trace is not None:
                    trace.add("wal_fsync", self.wal.last_fsync_s)
                if self._m_wal_bytes is not None:
                    self._m_wal_bytes.inc(wal_bytes)
            for code, (idxs, rows, ref, alt, ann_cols) in built.items():
                keep = keep_by_code[code]
                if not keep.any():
                    continue
                seg = Segment.build(
                    {name: col[keep] for name, col in rows.items()},
                    ref[keep], alt[keep],
                    annotations={
                        col: [v for v, k in zip(vals, keep) if k]
                        for col, vals in ann_cols.items()
                    } or None,
                )
                shard = self._shards.get(code)
                if shard is None:
                    shard = self._shards[code] = ChromosomeShard(
                        code, self.width
                    )
                shard.append_segment(seg)
                if not self._flushing:
                    # cascade-merge like any shard so probe cost stays
                    # flat; skipped mid-flush (the plan's segment objects
                    # must survive until finalize removes them)
                    shard.maintain()
                self._bytes_by_code[code] = (
                    self._bytes_by_code.get(code, 0) + self._seg_bytes(seg)
                )
            self._epoch += 1
            if self._first_write_t is None:
                self._first_write_t = time.monotonic()
            if self._m_bytes is not None:
                self._m_bytes.set(sum(self._bytes_by_code.values()))
            self._publish_locked()
            return len(accepted_idx), len(parsed) - len(accepted_idx), \
                wal_bytes

    @staticmethod
    def _seg_bytes(seg: Segment) -> int:
        total = seg.ref.nbytes + seg.alt.nbytes
        total += sum(col.nbytes for col in seg.cols.values())
        for arr in seg.obj.values():
            if arr is None:
                continue
            for v in arr:
                if v is not None:
                    total += len(json.dumps(v))
        return total

    def replay(self, base_store) -> int:
        """Rebuild the memtable from the WAL (worker start or respawn).
        Idempotent: rows the base store already holds (a flush committed
        before the crash) are shadowed by the first-wins check.  Returns
        the rows applied."""
        if self.wal is None:
            return 0
        applied = 0
        for record in self.wal.replay_records():
            rows = record.get("rows")
            if not isinstance(rows, list):
                continue
            try:
                accepted, _shadowed, _b = self.upsert(
                    base_store, rows, durable=False
                )
            except (ValueError, KeyError, TypeError) as err:
                self.log(f"wal: replay record skipped ({err})")
                continue
            applied += accepted
        return applied

    # -- flush ---------------------------------------------------------------

    def should_flush(self) -> bool:
        with self._lock:
            if self._flushing:
                return False
            if not any(sh.n for sh in self._shards.values()):
                return False
            if self.flush_bytes and sum(
                    self._bytes_by_code.values()) >= self.flush_bytes:
                return True
            return bool(
                self.flush_age_s
                and self._first_write_t is not None
                and time.monotonic() - self._first_write_t
                >= self.flush_age_s
            )

    def flush(self, base_manager=None) -> dict:
        """One flush pass: memtable segments -> ordinary store segments.

        1. **plan** (under the memtable lock): snapshot the segment lists
           and rotate the WAL — rows upserted from here on belong to the
           next interval;
        2. **write** each group's merged segment to
           ``chr<L>.<sid>.flush.tmp.*`` (fresh seg ids from the manifest's
           ``next_seg_id``), then rename to final stems, re-checking the
           manifest fingerprint before the renames and before the commit
           (another writer's commit preempts: temps cleaned, memtable
           untouched);
        3. **commit**: one fsynced atomic manifest replace;
        4. **finalize**: refresh the base snapshot so the new generation
           serves the rows, then drop the flushed segments from the
           memtable and discard the sealed WAL files.

        Returns ``{"status": "flushed"|"noop"|"aborted", ...}``; hard
        failures raise :class:`MemtableFlushError`."""
        if self.store_dir is None:
            raise MemtableFlushError(
                "memtable has no store_dir: flush needs an on-disk store"
            )
        with self._lock:
            if self._flushing:
                return {"status": "noop", "reason": "flush in flight"}
            plan = {
                code: list(sh.segments)
                for code, sh in self._shards.items() if sh.n
            }
            if not plan:
                return {"status": "noop", "reason": "memtable empty"}
            plan_bytes = {
                code: self._bytes_by_code.get(code, 0) for code in plan
            }
            self._flushing = True
            # the rotation is atomic with the plan capture (a row acked
            # between them would land in a discarded WAL file without
            # being in the plan), but a rotation failure must not leave
            # _flushing latched
            if self.wal is not None:
                try:
                    self.wal.rotate()
                except BaseException:
                    self._flushing = False
                    raise
        t0 = time.perf_counter()
        try:
            with reqtrace.background_span(
                "memtable.flush", groups=len(plan),
            ):
                merged = {
                    code: Segment.merge_many(segs) if len(segs) > 1
                    else segs[0]
                    for code, segs in plan.items()
                }
                result = flush_segments(
                    self.store_dir, merged, self.width, log=self.log,
                    fence_epoch=self.fence_epoch,
                )
            if result["status"] != "flushed":
                self.log(f"memtable flush aborted: {result.get('reason')}; "
                         "rows stay in the memtable (retry on next trigger)")
                return result
            # visibility handover: the new generation is pinned before the
            # memtable drops its copy, or reads would lose the rows for up
            # to one TTL window
            pinned_current = True
            if base_manager is not None:
                try:
                    base_manager.refresh()
                    pinned_current = (
                        base_manager.current().fingerprint
                        == result["fingerprint"]
                    )
                except Exception as err:
                    self.log(f"memtable flush: snapshot refresh failed "
                             f"({err}); keeping rows in the memtable")
                    pinned_current = False
            if not pinned_current:
                # durable on disk, but the serving pin has not caught up:
                # keep the memtable copy (first wins keeps reads the same)
                return {**result, "status": "flushed",
                        "finalized": False}
            flushed_ids = {
                id(seg) for segs in plan.values() for seg in segs
            }
            with self._lock:
                for code in plan:
                    sh = self._shards.get(code)
                    if sh is None:
                        continue
                    sh.segments = [
                        s for s in sh.segments if id(s) not in flushed_ids
                    ]
                    self._bytes_by_code[code] = max(
                        self._bytes_by_code.get(code, 0)
                        - plan_bytes.get(code, 0), 0,
                    )
                    if not sh.segments:
                        self._bytes_by_code[code] = 0
                remaining = sum(sh.n for sh in self._shards.values())
                self._first_write_t = (
                    time.monotonic() if remaining else None
                )
                self._epoch += 1
                if self._m_bytes is not None:
                    self._m_bytes.set(sum(self._bytes_by_code.values()))
                self._publish_locked()
            # WAL truncation strictly after the commit and the handover
            if self.wal is not None:
                self.wal.discard_sealed()
            if self._m_flushes is not None:
                self._m_flushes.inc()
            result["seconds"] = round(time.perf_counter() - t0, 4)
            result["finalized"] = True
            self._ledger_record(result)
            self.log(
                f"memtable flushed {result['rows']} row(s) to "
                f"{len(result['labels'])} segment(s) "
                f"({', '.join('chr' + lb for lb in result['labels'])}), "
                f"{result['seconds']}s"
            )
            return result
        finally:
            with self._lock:
                self._flushing = False
                # fold any segments appended mid-flush back into shape
                for sh in self._shards.values():
                    sh.maintain()

    def _ledger_record(self, result: dict) -> None:
        """Append the ``{"type": "flush"}`` ledger record.  Best-effort: a
        ledger problem must not fail a flush whose manifest commit
        already happened."""
        try:
            from annotatedvdb_tpu_torch.store.ledger import AlgorithmLedger

            ledger = AlgorithmLedger(
                os.path.join(self.store_dir, "ledger.jsonl"),
                log=self.log,
            )
            ledger.flush({
                k: result[k]
                for k in ("labels", "rows", "seg_ids", "bytes", "seconds")
                if k in result
            })
        except (OSError, ValueError) as err:
            self.log(f"memtable flush: ledger record not written ({err})")


def flush_segments(store_dir: str, merged: dict[int, Segment],
                   width: int, log=None,
                   fence_epoch: int | None = None) -> dict:
    """Commit one merged segment per chromosome group into the store.

    The write half of :meth:`Memtable.flush`: segment files go through
    ``VariantStore._write_segment`` (the writer ``save()`` uses), named
    into the ``*.flush.tmp.*`` namespace, renamed, and committed by one
    fsynced atomic ``manifest.json`` replace.  The fingerprint of the
    exact manifest parsed is re-checked before the renames and again
    before the commit; a rename whose destination exists re-checks first
    (a racing writer's same-sid commit is never clobbered), and the abort
    cleanup never removes a file the current manifest references."""
    log = log or (lambda msg: None)
    from annotatedvdb_tpu_torch.store.compact import _normalize_groups

    mpath = os.path.join(store_dir, "manifest.json")
    try:
        with open(mpath) as f:
            manifest = json.load(f)
            st = os.fstat(f.fileno())
    except (OSError, ValueError) as err:
        raise MemtableFlushError(
            f"{mpath}: unreadable store manifest ({err}); run doctor first"
        ) from err
    if not isinstance(manifest, dict) or "shards" not in manifest:
        raise MemtableFlushError(f"{mpath}: not a store manifest")
    if int(manifest.get("width", width)) != int(width):
        raise MemtableFlushError(
            f"{mpath}: store width {manifest.get('width')} != memtable "
            f"width {width}"
        )
    if fence_epoch is not None \
            and int(manifest.get("repl_epoch", 0) or 0) > int(fence_epoch):
        reason = (
            f"fenced: store repl_epoch "
            f"{int(manifest.get('repl_epoch', 0) or 0)} > this writer's "
            f"epoch {int(fence_epoch)} (store was promoted; this leader "
            "is deposed)"
        )
        log(f"memtable flush preempted: {reason}")
        return {"status": "aborted", "reason": reason}
    fingerprint = (st.st_mtime_ns, st.st_size, st.st_ino)
    # crash point #1: the plan is captured, nothing written — a death here
    # must leave the store byte-untouched (rows stay in memtable + WAL)
    faults.fire("memtable.flush")
    next_sid = int(manifest.get("next_seg_id", 1))
    created: list[str] = []
    committed = False
    new: dict[int, tuple[str, int, dict, int]] = {}

    def cleanup() -> None:
        if committed:
            return
        # never remove a file the current manifest references: a writer
        # that preempted this flush may have allocated the same seg ids
        live: set[str] = set()
        try:
            with open(mpath) as f:
                now = json.load(f)
            for label, glist in _normalize_groups(now).items():
                for group in glist:
                    for sid in group:
                        stem = f"chr{label}.{sid:06d}"
                        live.add(stem + ".npz")
                        live.add(stem + ".ann.jsonl")
        except (OSError, ValueError, KeyError):
            pass
        for fp in created:
            name = os.path.basename(fp)
            if name in live and not is_flush_tmp(name):
                log(f"memtable flush: {fp} is referenced by the live "
                    "manifest (a racing commit took this seg id); left in "
                    "place — run `doctor --repair` to audit the store")
                continue
            try:
                tio.unlink(fp)
            except OSError:
                pass  # fsck prunes leftovers (flush-tmp / orphan findings)

    try:
        for code, seg in sorted(merged.items()):
            label = chromosome_label(code)
            sid = next_sid
            next_sid += 1
            tmp_stem = f"chr{label}.{sid:06d}" + FLUSH_TMP_SUFFIX
            rec = VariantStore._write_segment(store_dir, tmp_stem, seg)
            created.append(os.path.join(store_dir, tmp_stem + ".npz"))
            created.append(os.path.join(store_dir, tmp_stem + ".ann.jsonl"))
            new[code] = (label, sid, rec, seg.n)

        # -- rename to final stems, then the single commit point ------------
        if _manifest_fingerprint(store_dir) != fingerprint:
            raise _FlushPreempted(
                "another writer committed a new generation mid-flush"
            )
        for code, (label, sid, _rec, _n) in sorted(new.items()):
            stem = f"chr{label}.{sid:06d}"
            for ext in (".npz", ".ann.jsonl"):
                src = os.path.join(store_dir, stem + FLUSH_TMP_SUFFIX + ext)
                dst = os.path.join(store_dir, stem + ext)
                if os.path.exists(dst) \
                        and _manifest_fingerprint(store_dir) != fingerprint:
                    # a racing writer allocated this very seg id and its
                    # commit already landed: renaming would clobber it
                    raise _FlushPreempted(
                        "another writer committed a new generation mid-flush"
                    )
                try:
                    tio.replace(src, dst)
                except FileNotFoundError:
                    # a racing loader's save() cleanup pruned our temp as
                    # an orphan: its commit owns the manifest now
                    raise _FlushPreempted(
                        "another writer committed a new generation "
                        "mid-flush (flush temp pruned)"
                    ) from None
                created.remove(src)
                created.append(dst)
        if _manifest_fingerprint(store_dir) != fingerprint:
            raise _FlushPreempted(
                "another writer committed a new generation mid-flush"
            )

        glists = _normalize_groups(manifest)
        new_manifest = dict(manifest)
        new_manifest["format"] = 3
        shards = {label: glist for label, glist in glists.items()}
        for code, (label, sid, _rec, _n) in sorted(new.items()):
            # appended as the newest group: first-wins reads keep older
            # (loaded) rows winning over upserts, as the overlay did
            shards.setdefault(label, []).append([sid])
        new_manifest["shards"] = shards
        new_manifest["next_seg_id"] = next_sid
        integrity = dict(manifest.get("integrity") or {})
        for code, (label, sid, rec, _n) in new.items():
            integrity[f"chr{label}.{sid:06d}"] = {
                "npz": rec["npz"], "jsonl": rec["jsonl"],
            }
        new_manifest["integrity"] = dict(sorted(integrity.items()))
        stats = dict(new_manifest.get("stats") or {})
        stats["rows"] = dict(stats.get("rows") or {})
        stats["segments"] = dict(stats.get("segments") or {})
        for label, glist in shards.items():
            stats["segments"][label] = len(glist)
        for code, (label, _sid, _rec, n) in new.items():
            stats["rows"][label] = int(stats["rows"].get(label, 0)) + n
        new_manifest["stats"] = stats

        # crash point #2 fires via pre_sync: the new manifest tmp is
        # written, the atomic replace has not happened — a death here
        # leaves the OLD manifest serving (final-named segments are
        # prunable orphans, the WAL still covers every row); torn_write
        # tears the tmp.  Then fsync, atomic replace, and (AVDB_FSYNC) one
        # directory fsync that covers the segment renames too
        tio.replace_manifest(
            mpath, new_manifest,
            pre_sync=lambda f: faults.fire("memtable.flush", f),
        )
        committed = True
        nbytes = sum(
            os.path.getsize(os.path.join(
                store_dir, f"chr{lb}.{sid:06d}" + ext))
            for _c, (lb, sid, _rec, _n) in new.items()
            for ext in (".npz", ".ann.jsonl")
        )
        return {
            "status": "flushed",
            "labels": sorted(lb for lb, _s, _r, _n in new.values()),
            "seg_ids": {lb: sid for lb, sid, _r, _n in new.values()},
            "rows": sum(n for _lb, _s, _r, n in new.values()),
            "bytes": int(nbytes),
            "fingerprint": _manifest_fingerprint(store_dir),
        }
    except _FlushPreempted as p:
        cleanup()
        log(f"memtable flush preempted: {p.reason}")
        return {"status": "aborted", "reason": p.reason}
    except BaseException:
        cleanup()
        raise
