"""Crash-safe online store compaction (``doctor compact``).

Port of ``annotatedvdb_tpu/store/compact.py``.  Every checkpointed load
and every memtable flush appends small segments: a chromosome that took
40 checkpoints to load answers every probe against 40 segment files.
This module merges one chromosome group's segments into ONE
position-sorted, first-wins-deduplicated columnar segment —
dictionary-coded alleles, zlib-compressed JSONB sidecar — writing the
reference's bytes for the same store.

Commit protocol (the crash contract):

1. **plan**    — read the manifest, pick eligible groups (no data touched);
2. **merge**   — stream-merge each group's segments into
   ``chr<L>.<sid>.compact.tmp.npz`` / ``...compact.tmp.ann.jsonl`` temps
   (fresh seg ids from ``next_seg_id``; old files never touched),
   integrity records computed on the bytes in hand (``_CrcWriter``);
3. **swap**    — rename temps to their final stems, re-verify the manifest
   fingerprint (a loader commit or memtable flush mid-pass preempts the
   pass), then ONE fsync'd atomic ``manifest.json`` replace: the single
   commit point;
4. **gc**      — unlink the replaced segment files (best-effort: a failure
   here leaves orphans that ``doctor --repair`` prunes).

A kill at any instant leaves either the old layout (temps and renamed but
uncommitted files are orphans fsck prunes) or the new one (stale old
files are orphans fsck prunes), never a torn hybrid.

**Online.**  Serving loads a manifest's segment set fully into memory
(``serve/snapshot.py``), so readers pin the pre-compaction generation
until they drain, and the fleet picks the compacted generation up through
the normal snapshot swap.  Writers coordinate cooperatively: the pass
captures the manifest fingerprint at plan time and re-verifies it before
the swap — a commit in between ABORTS the pass (temps removed, store
untouched, ``aborted`` report); the ``cancel`` callable gives shutdown
paths and the maintenance daemon the same clean preemption between
chunks.

**Streaming.**  The merged output is produced chunk by chunk
(``AVDB_COMPACT_CHUNK_ROWS``) through a ``BoundedStage`` (gather/encode on
the stage thread, file writes on the caller), so the row payload streams
and the merge state is the identity keys and the kept-row order.

First-wins dedup: a shadowed duplicate (same identity in an older and a
newer segment — a retried memtable flush writes them) is unreachable
through every read path, so compaction drops it.

The compaction is host work in the reference too: no kernel runs here.
Fault points: ``compact.plan`` (plan chosen, nothing read),
``compact.merge`` (mid temp body), ``compact.swap`` (renamed, before the
manifest replace) and ``compact.gc`` (committed, before the unlinks; an
``eio`` there is absorbed).  Out of core: segment containers at or above
``AVDB_STORE_SPILL_BYTES`` load as copy-on-write memmaps, so a pass over a
large group reads its pages on demand.  The segment reader lives in ``variant_store``, which imports ``torch``;
it is imported when a pass merges, so planning (``doctor compact
--dry-run``, the fleet supervisor's watermark reads) never loads it.
"""

from __future__ import annotations

import io
import json
import os
import time
import zlib

import numpy as np

from annotatedvdb_tpu_torch.obs import reqtrace
from annotatedvdb_tpu_torch.utils import faults
from annotatedvdb_tpu_torch.utils import io as tio
from annotatedvdb_tpu_torch.utils.pipeline import BoundedStage

#: compaction temp suffixes — a distinct namespace from save()'s dot-prefixed
#: ``.{stem}.tmp{pid}`` temps so fsck can attribute crash debris to the pass
#: that left it (``compact-tmp`` finding, pruned under ``--repair``)
COMPACT_TMP_NPZ = ".compact.tmp.npz"
COMPACT_TMP_JSONL = ".compact.tmp.ann.jsonl"

#: dictionary coding engages only when it SHRINKS the allele matrices:
#: dict rows + per-row codes must undercut the plain rows, and the dict is
#: capped so a high-cardinality indel segment never pays an unbounded
#: unique pass for nothing
DICT_MAX_UNIQUE = 1 << 16


class CompactionError(RuntimeError):
    """The pass failed (I/O, corrupt input segment).  The store is left in
    its pre-compaction state; temps are cleaned up where possible and
    ``doctor --repair`` prunes the rest."""


def is_compact_tmp(fname: str) -> bool:
    """Whether a directory entry is an (abandoned) compaction temp."""
    return fname.endswith(COMPACT_TMP_NPZ) or fname.endswith(COMPACT_TMP_JSONL)


def _chunk_rows() -> int:
    """AVDB_COMPACT_CHUNK_ROWS: rows per streamed merge chunk (default
    262144) — the unit of peak row-payload memory during a pass."""
    try:
        v = int(os.environ.get("AVDB_COMPACT_CHUNK_ROWS", "") or (1 << 18))
    except ValueError:
        return 1 << 18
    return max(v, 1024)


def _min_stems() -> int:
    """AVDB_COMPACT_MIN_SEGMENTS: smallest on-disk segment-file count that
    makes a chromosome group eligible (default 2 — one file is already
    compact)."""
    try:
        v = int(os.environ.get("AVDB_COMPACT_MIN_SEGMENTS", "") or 2)
    except ValueError:
        return 2
    return max(v, 2)


def _manifest_fingerprint(store_dir: str) -> tuple:
    st = os.stat(os.path.join(store_dir, "manifest.json"))
    return (st.st_mtime_ns, st.st_size, st.st_ino)


def _metrics(registry=None) -> dict:
    """Compaction counters/histogram on ``registry`` (default: a module
    registry so CLI passes always count somewhere exportable)."""
    global _DEFAULT_REGISTRY
    if registry is None:
        if _DEFAULT_REGISTRY is None:
            from annotatedvdb_tpu_torch.obs.metrics import MetricsRegistry

            _DEFAULT_REGISTRY = MetricsRegistry()
        registry = _DEFAULT_REGISTRY
    from annotatedvdb_tpu_torch.obs.metrics import CHUNK_SECONDS_EDGES

    return {
        "passes": registry.counter(
            "avdb_compact_passes_total", "completed compaction passes"
        ),
        "segments_merged": registry.counter(
            "avdb_compact_segments_merged_total",
            "on-disk segment file pairs merged away by compaction",
        ),
        "bytes_reclaimed": registry.counter(
            "avdb_compact_bytes_reclaimed_total",
            "bytes of replaced segment files reclaimed by compaction GC",
        ),
        "aborts": registry.counter(
            "avdb_compact_aborts_total",
            "compaction passes aborted (preempted, cancelled, or failed)",
        ),
        "seconds": registry.histogram(
            "avdb_compact_seconds", CHUNK_SECONDS_EDGES,
            "wall seconds per compaction pass",
        ),
    }


_DEFAULT_REGISTRY = None


# ---------------------------------------------------------------------------
# planning (manifest-only: a dry run never opens a segment file)


def _normalize_groups(manifest: dict) -> dict:
    """{label: [[sid, ...], ...]} with format-2 flat lists normalized."""
    fmt2 = manifest.get("format") == 2
    return {
        label: ([[g] for g in groups] if fmt2 else [list(g) for g in groups])
        for label, groups in manifest["shards"].items()
    }


def _label_wanted(label: str, groups_filter) -> bool:
    if not groups_filter:
        return True
    wanted = {str(g).lower().removeprefix("chr") for g in groups_filter}
    return label.lower() in wanted


def plan_compaction(store_dir: str, groups=None, max_bytes: int | None = None,
                    min_stems: int | None = None) -> dict:
    """Plan one pass without touching segment data.

    Returns ``{"store_dir", "eligible": [...], "skipped": [...],
    "total_bytes_before", "total_files_before"}``; each eligible entry
    carries ``label / stems / groups / rows / bytes_before /
    est_bytes_after`` (the estimate is the measured bytes — an upper bound:
    dedup, width-trim, dictionary coding and sidecar compression only
    shrink it; the executed pass reports exact numbers).
    ``max_bytes`` caps the pass: groups are taken smallest-first until the
    next one would push the pass's input bytes over the cap.
    """
    mpath = os.path.join(store_dir, "manifest.json")
    try:
        with open(mpath) as f:
            manifest = json.load(f)
    except (OSError, ValueError) as err:
        raise CompactionError(
            f"{mpath}: unreadable store manifest ({err}); run doctor first"
        ) from err
    if not isinstance(manifest, dict) or "shards" not in manifest:
        raise CompactionError(f"{mpath}: not a store manifest")
    min_stems = _min_stems() if min_stems is None else max(int(min_stems), 2)
    stats_rows = (manifest.get("stats") or {}).get("rows") or {}
    entries = []
    skipped = []
    for label, glist in sorted(_normalize_groups(manifest).items()):
        stems = [f"chr{label}.{sid:06d}" for group in glist for sid in group]
        nbytes = 0
        missing = False
        for stem in stems:
            for ext in (".npz", ".ann.jsonl"):
                fp = os.path.join(store_dir, stem + ext)
                try:
                    nbytes += os.path.getsize(fp)
                except OSError:
                    missing = True
        entry = {
            "label": label,
            "stems": len(stems),
            "groups": len(glist),
            "rows": stats_rows.get(label),
            "bytes_before": int(nbytes),
            "est_bytes_after": int(nbytes),
        }
        if missing:
            skipped.append({**entry, "reason": "segment file missing "
                            "(run doctor --repair first)"})
        elif not _label_wanted(label, groups):
            skipped.append({**entry, "reason": "not in --group scope"})
        elif len(stems) < min_stems:
            skipped.append({**entry, "reason":
                            f"fewer than {min_stems} segment files"})
        else:
            entries.append(entry)
    if max_bytes is not None and max_bytes >= 0:
        entries.sort(key=lambda e: e["bytes_before"])
        taken, budget = [], int(max_bytes)
        for e in entries:
            if e["bytes_before"] <= budget:
                taken.append(e)
                budget -= e["bytes_before"]
            else:
                skipped.append({**e, "reason": "over --maxBytes budget"})
        entries = sorted(taken, key=lambda e: e["label"])
    return {
        "store_dir": store_dir,
        "eligible": entries,
        "skipped": skipped,
        "total_bytes_before": sum(e["bytes_before"] for e in entries),
        "total_files_before": sum(e["stems"] for e in entries),
    }


# ---------------------------------------------------------------------------
# streamed merge + dedup


def _gather_col(parts, starts, idx, getter, dtype, tail=()):
    """Rows ``idx`` (global concat indices) gathered across ``parts`` in
    order; ``getter(part)`` returns the source column."""
    out = np.empty((idx.size,) + tail, dtype)
    pi = np.searchsorted(starts, idx, side="right") - 1
    for p in np.unique(pi):
        m = pi == p
        out[m] = getter(parts[int(p)])[idx[m] - starts[int(p)]]
    return out


def _gather_obj(parts, starts, idx, name):
    out = np.full(idx.shape, None, object)
    pi = np.searchsorted(starts, idx, side="right") - 1
    for p in np.unique(pi):
        col = parts[int(p)].obj[name]
        if col is None:
            continue
        m = pi == p
        out[m] = col[idx[m] - starts[int(p)]]
    return out


def _consecutive_runs(positions: np.ndarray):
    """Group a sorted int array into runs of consecutive values."""
    if positions.size == 0:
        return
    breaks = np.flatnonzero(np.diff(positions) != 1) + 1
    for chunk in np.split(positions, breaks):
        yield int(chunk[0]), int(chunk[-1])


def _merge_order(parts) -> tuple[np.ndarray, np.ndarray]:
    """(kept, dropped): global concat indices of the merged, position-sorted,
    first-wins-deduplicated row sequence, and of the dropped shadowed
    duplicates.  Stable over part order — older segments win on equal
    identity, exactly like ``ChromosomeShard.lookup``."""
    live = [p for p in parts if p.n > 0]
    starts = np.concatenate(
        ([0], np.cumsum([p.n for p in parts]))
    ).astype(np.int64)
    total = int(starts[-1])
    if total == 0:
        return np.empty(0, np.int64), np.empty(0, np.int64)
    # the common shape — consecutive ascending disjoint runs (what
    # position-sorted loads accumulate) — needs no key sort at all
    chain = all(
        live[i].key_max < live[i + 1].key_min for i in range(len(live) - 1)
    )
    keys = np.concatenate([
        p.key if p.n else np.empty(0, np.uint64) for p in parts
    ])
    if chain:
        order = np.arange(total, dtype=np.int64)
        sorted_keys = keys
    else:
        order = np.argsort(keys, kind="stable").astype(np.int64)
        sorted_keys = keys[order]
    keep = np.ones(total, bool)
    dup_pos = np.flatnonzero(sorted_keys[1:] == sorted_keys[:-1]) + 1
    if dup_pos.size:
        width = parts[0].ref.shape[1]
        for lo, hi in _consecutive_runs(dup_pos):
            sel = order[lo - 1:hi + 1]
            rl = _gather_col(parts, starts, sel, lambda p: p.cols["ref_len"],
                             np.int32)
            al = _gather_col(parts, starts, sel, lambda p: p.cols["alt_len"],
                             np.int32)
            rr = _gather_col(parts, starts, sel, lambda p: p.ref,
                             np.uint8, (width,))
            aa = _gather_col(parts, starts, sel, lambda p: p.alt,
                             np.uint8, (width,))
            seen = set()
            for k in range(sel.size):
                ident = (int(rl[k]), int(al[k]),
                         rr[k].tobytes(), aa[k].tobytes())
                if ident in seen:
                    keep[lo - 1 + k] = False
                else:
                    seen.add(ident)
    return order[keep], order[~keep]


def _void_rows(arr: np.ndarray) -> np.ndarray:
    """[n, w] uint8 rows viewed as one opaque scalar per row (unique /
    searchsorted material)."""
    a = np.ascontiguousarray(arr)
    return a.view(np.dtype((np.void, a.shape[1] * a.itemsize))).ravel()


def _allele_dict(parts, starts, kept, getter, width, chunk) -> np.ndarray | None:
    """The dictionary (unique width-trimmed rows) for one allele matrix, or
    None when coding would not shrink it."""
    n_out = kept.size
    if n_out < 64 or width < 2:
        return None
    uniq = None
    for lo in range(0, n_out, chunk):
        rows = _gather_col(parts, starts, kept[lo:lo + chunk], getter,
                           np.uint8, (width,))
        part_uniq = np.unique(_void_rows(rows))
        uniq = part_uniq if uniq is None else np.unique(
            np.concatenate([uniq, part_uniq])
        )
        if uniq.size > DICT_MAX_UNIQUE:
            return None
    code_bytes = 2 if uniq.size <= 0xFFFF else 4
    if uniq.size * width + code_bytes * n_out >= width * n_out:
        return None
    return uniq


def _npy_header(dtype, shape) -> bytes:
    buf = io.BytesIO()
    np.lib.format.write_array_header_1_0(buf, {
        "descr": np.lib.format.dtype_to_descr(np.dtype(dtype)),
        "fortran_order": False,
        "shape": tuple(shape),
    })
    return buf.getvalue()


def _cancelled(cancel) -> bool:
    return bool(cancel is not None and cancel())


class _Preempted(Exception):
    """Internal: the pass must yield (cancel() fired, or a loader commit
    changed the manifest under us)."""

    def __init__(self, reason: str):
        super().__init__(reason)
        self.reason = reason


def _merge_label_to_temp(store_dir: str, label: str, glist: list,
                         width: int, integrity: dict, verify: str,
                         tmp_npz: str, tmp_jsonl: str, chunk: int,
                         cancel) -> dict:
    """Stream one chromosome's segments into its compaction temps.

    Returns the new stem's integrity + row accounting:
    ``{"npz": {bytes, crc32}, "jsonl": {bytes, crc32}, "rows": n,
    "rows_dropped": d}``.
    """
    from annotatedvdb_tpu_torch.store.variant_store import (
        _NUMERIC_COLUMNS,
        OBJECT_COLUMNS,
        VariantStore,
        _CrcWriter,
        sidecar_line,
    )

    parts = [
        VariantStore._read_segment(
            store_dir, label, sid, width,
            integrity=integrity.get(f"chr{label}.{sid:06d}"), verify=verify,
        )
        for group in glist for sid in group
    ]
    starts = np.concatenate(
        ([0], np.cumsum([p.n for p in parts]))
    ).astype(np.int64)
    kept, dropped = _merge_order(parts)
    n_out = int(kept.size)

    # width-trim exactly like save(): the merged segment's matrices shrink
    # to its longest stored allele byte (over-width rows store full lengths
    # but only width bytes)
    if n_out:
        rl = _gather_col(parts, starts, kept, lambda p: p.cols["ref_len"],
                         np.int32)
        al = _gather_col(parts, starts, kept, lambda p: p.cols["alt_len"],
                         np.int32)
        w = int(max(np.minimum(rl, width).max(),
                    np.minimum(al, width).max(), 1))
    else:
        w = 1
    ref_dict = _allele_dict(parts, starts, kept,
                            lambda p: p.ref[:, :w], w, chunk) if n_out else None
    alt_dict = _allele_dict(parts, starts, kept,
                            lambda p: p.alt[:, :w], w, chunk) if n_out else None

    def allele_streams(name, getter, uniq):
        """[(stream name, dtype, shape, chunk generator)] for one matrix."""
        if uniq is None:
            def plain():
                for lo in range(0, n_out, chunk):
                    if _cancelled(cancel):
                        raise _Preempted("cancelled mid-merge")
                    yield _gather_col(parts, starts, kept[lo:lo + chunk],
                                      getter, np.uint8, (w,))
            return [(name, np.uint8, (n_out, w), plain)]
        code_dtype = np.uint16 if uniq.size <= 0xFFFF else np.uint32

        def dict_rows():
            yield uniq.view(np.uint8).reshape(-1, w)

        def codes():
            for lo in range(0, n_out, chunk):
                if _cancelled(cancel):
                    raise _Preempted("cancelled mid-merge")
                rows = _gather_col(parts, starts, kept[lo:lo + chunk],
                                   getter, np.uint8, (w,))
                yield np.searchsorted(uniq, _void_rows(rows)).astype(
                    code_dtype
                )
        return [
            (name + "_dict", np.uint8, (int(uniq.size), w), dict_rows),
            (name + "_codes", code_dtype, (n_out,), codes),
        ]

    streams = []
    streams += allele_streams("ref", lambda p: p.ref[:, :w], ref_dict)
    streams += allele_streams("alt", lambda p: p.alt[:, :w], alt_dict)
    for cname, dtype in _NUMERIC_COLUMNS:
        def numeric(cname=cname, dtype=dtype):
            for lo in range(0, n_out, chunk):
                if _cancelled(cancel):
                    raise _Preempted("cancelled mid-merge")
                yield _gather_col(parts, starts, kept[lo:lo + chunk],
                                  lambda p: p.cols[cname], dtype)
        streams.append((cname, dtype, (n_out,), numeric))

    header = (json.dumps({
        "seg": 2,
        "names": [s[0] for s in streams],
        "rows": n_out,
    }) + "\n").encode()

    def payload():
        """Container bytes in order — runs on the BoundedStage thread so
        gather/encode overlaps the caller's file writes."""
        yield header
        for _name, dtype, shape, gen in streams:
            yield _npy_header(dtype, shape)
            for block in gen():
                yield np.ascontiguousarray(block, dtype).tobytes()

    # same power-loss contract as save(): segment DATA fsyncs are the
    # AVDB_FSYNC=1 opt-in (the pass's own GC unlinks the rollback copies,
    # so under that mode the new bytes must be durable before the swap)
    fsync_data = tio.fsync_wanted()
    stage = BoundedStage(payload(), depth=4, name=f"compact-{label}")
    try:
        with open(tmp_npz, "wb", buffering=1 << 20) as raw_f:
            f = _CrcWriter(raw_f)
            first = True
            for blob in stage:
                f.write(blob)
                if first:
                    # crash point: the temp container body is part-written
                    # (torn_write tears THIS temp; the manifested store
                    # must not notice)
                    faults.fire("compact.merge", raw_f)
                    first = False
            if fsync_data:
                f.flush()
                tio.fsync(raw_f)
            npz_rec = {"bytes": f.nbytes, "crc32": f.crc}
    finally:
        stage.close()

    present = [c for c in OBJECT_COLUMNS
               if any(p.obj[c] is not None for p in parts)]
    with open(tmp_jsonl, "wb") as raw_f:
        f = _CrcWriter(raw_f)
        if present and n_out:
            # zlib-compressed JSONB sidecar: the reader sniffs the leading
            # byte (0x78 zlib vs '{' plain), so legacy sidecars keep loading
            comp = zlib.compressobj(6)
            for lo in range(0, n_out, chunk):
                if _cancelled(cancel):
                    raise _Preempted("cancelled mid-merge")
                idx = kept[lo:lo + chunk]
                cols = {col: _gather_obj(parts, starts, idx, col)
                        for col in present}
                out: list[str] = []
                for k in range(idx.size):
                    # the ONE sidecar serializer save() also uses — byte
                    # parity between saved and compacted sidecars
                    line = sidecar_line(
                        ((c, cols[c][k]) for c in present), lo + k
                    )
                    if line is not None:
                        out.append(line)
                if out:
                    f.write(comp.compress("".join(out).encode()))
            f.write(comp.flush())
        if fsync_data:
            f.flush()
            tio.fsync(raw_f)
        jsonl_rec = {"bytes": f.nbytes, "crc32": f.crc}
    return {
        "npz": npz_rec, "jsonl": jsonl_rec,
        "rows": n_out, "rows_dropped": int(dropped.size),
    }


# ---------------------------------------------------------------------------
# the pass


def compact_store(store_dir: str, *, groups=None, max_bytes: int | None = None,
                  chunk_rows: int | None = None, min_stems: int | None = None,
                  cancel=None, registry=None, log=None) -> dict:
    """One compaction pass.  Returns a report dict:

    ``{"status": "compacted" | "noop" | "aborted", "reason", "labels",
    "files_before", "files_after", "bytes_before", "bytes_after",
    "bytes_reclaimed", "rows", "rows_dropped", "seconds"}``

    Crash safety is the module contract (see the module docstring); this
    function additionally guarantees that every non-kill exit path —
    success, preemption, cancellation, error — leaves no ``*.compact.tmp*``
    temp and no uncommitted renamed segment file behind.
    """
    log = log or (lambda msg: None)
    chunk = _chunk_rows() if chunk_rows is None else max(int(chunk_rows), 1024)
    met = _metrics(registry)
    t0 = time.perf_counter()
    plan = plan_compaction(store_dir, groups=groups, max_bytes=max_bytes,
                           min_stems=min_stems)
    if not plan["eligible"]:
        return {
            "status": "noop", "reason": "no eligible chromosome groups",
            "labels": [], "files_before": 0, "files_after": 0,
            "bytes_before": 0, "bytes_after": 0, "bytes_reclaimed": 0,
            "rows": 0, "rows_dropped": 0, "seconds": 0.0,
            "plan": plan,
        }
    mpath = os.path.join(store_dir, "manifest.json")
    with open(mpath) as f:
        manifest = json.load(f)
        # fingerprint the EXACT manifest just parsed (fstat on the open
        # fd, not a fresh path stat): a loader commit racing this open
        # would otherwise slip between read and stat, and both preemption
        # re-checks below would compare against the post-commit identity
        # while the pass merges from the stale read
        st = os.fstat(f.fileno())
    fingerprint = (st.st_mtime_ns, st.st_size, st.st_ino)
    from annotatedvdb_tpu_torch.store.variant_store import _verify_mode

    width = manifest["width"]
    integrity = dict(manifest.get("integrity") or {})
    verify = _verify_mode()
    glists = _normalize_groups(manifest)
    next_sid = int(manifest.get("next_seg_id", 1))

    # temps created (and final stems renamed-but-uncommitted) this pass —
    # the cleanup set for every abort path
    created: list[str] = []
    committed = False
    new_stems: dict[str, tuple[int, dict]] = {}  # label -> (sid, rec)

    def cleanup() -> None:
        if committed:
            return
        # never remove a file the CURRENT manifest references: a loader
        # that preempted this pass may have allocated the same seg ids
        # (both writers continue from the manifest's next_seg_id) and
        # overwritten our renamed-but-uncommitted files with ITS segments
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
            pass  # unreadable manifest references nothing; prune ours
        for fp in created:
            name = os.path.basename(fp)
            if name in live and not is_compact_tmp(name):
                # the residual race: our rename landed in the instants
                # between a loader's same-sid commit and our preemption
                # re-check, so the live manifest may now reference OUR
                # bytes under ITS integrity record.  Removing it would
                # make things worse; say so loudly — fsck's integrity
                # check flags the mismatch and --repair rolls the group
                # back with a reload prescription.
                log(f"compact: {fp} is referenced by the live manifest "
                    "(a racing commit took this seg id); left in place — "
                    "run `doctor --repair` to audit the store")
                continue
            try:
                tio.unlink(fp)
            except OSError:
                pass  # fsck prunes leftovers (compact-tmp / orphan findings)

    try:
        # crash point: the plan is chosen, nothing has been read or written
        faults.fire("compact.plan")
        # the plan and this manifest are two separate reads: a writer that
        # rewrote the store in between (an undo dropping a chromosome's
        # last segments) could leave the plan naming a label this —
        # fingerprinted — manifest no longer carries; preempt, don't KeyError
        for entry in plan["eligible"]:
            if entry["label"] not in glists:
                raise _Preempted(
                    f"store changed since planning (chr{entry['label']} "
                    "no longer present in the manifest)"
                )
        for entry in plan["eligible"]:
            if _cancelled(cancel):
                raise _Preempted("cancelled before merge")
            label = entry["label"]
            sid = next_sid
            next_sid += 1
            stem = f"chr{label}.{sid:06d}"
            tmp_npz = os.path.join(store_dir, stem + COMPACT_TMP_NPZ)
            tmp_jsonl = os.path.join(store_dir, stem + COMPACT_TMP_JSONL)
            created.extend([tmp_npz, tmp_jsonl])
            log(f"compact: chr{label}: merging {entry['stems']} segment "
                f"file(s) ({entry['bytes_before']} bytes)")
            # background-track span per merged group: `doctor trace` and
            # the flight recorder show what compaction was doing while
            # p99 moved (no-op without a recorder in this process)
            with reqtrace.background_span(
                f"compact.chr{label}", stems=entry["stems"],
            ):
                rec = _merge_label_to_temp(
                    store_dir, label, glists[label], width, integrity,
                    verify, tmp_npz, tmp_jsonl, chunk, cancel,
                )
            new_stems[label] = (sid, rec)

        # -- commit: rename temps, verify no loader preempted us, swap ------
        if _cancelled(cancel):
            raise _Preempted("cancelled before swap")
        if _manifest_fingerprint(store_dir) != fingerprint:
            raise _Preempted(
                "a loader committed a new generation mid-pass"
            )
        finals: list[str] = []
        for label, (sid, _rec) in sorted(new_stems.items()):
            stem = f"chr{label}.{sid:06d}"
            for tmp_ext, ext in ((COMPACT_TMP_NPZ, ".npz"),
                                 (COMPACT_TMP_JSONL, ".ann.jsonl")):
                src = os.path.join(store_dir, stem + tmp_ext)
                dst = os.path.join(store_dir, stem + ext)
                if os.path.exists(dst) \
                        and _manifest_fingerprint(store_dir) != fingerprint:
                    # a racing loader allocated this very seg id and its
                    # commit already landed: renaming would clobber ITS
                    # segment with ours — preempt without touching it
                    raise _Preempted(
                        "a loader committed a new generation mid-pass"
                    )
                tio.replace(src, dst)
                created.remove(src)
                created.append(dst)
                finals.append(dst)
        # crash point: every new segment is in place under its final name,
        # the commit (manifest swap) has not happened — a death here must
        # leave the OLD manifest serving (the new files are orphans)
        faults.fire("compact.swap")
        # re-verify IMMEDIATELY before the commit point: a loader that
        # committed while we merged/renamed owns the manifest now (its
        # save() cleanup may already have pruned our renamed files as
        # orphans) — swapping over it would lose its rows.  Preempt.
        if _manifest_fingerprint(store_dir) != fingerprint:
            raise _Preempted(
                "a loader committed a new generation mid-pass"
            )

        old_stems = {
            label: [f"chr{label}.{sid:06d}"
                    for group in glists[label] for sid in group]
            for label in new_stems
        }
        new_manifest = dict(manifest)
        new_manifest["format"] = 3
        new_manifest["shards"] = {
            label: ([[new_stems[label][0]]] if label in new_stems
                    else glists[label])
            for label in glists
        }
        new_manifest["next_seg_id"] = next_sid
        new_integrity = {
            stem: rec for stem, rec in integrity.items()
            if not any(stem in old_stems[lb] for lb in old_stems)
        }
        for label, (sid, rec) in new_stems.items():
            new_integrity[f"chr{label}.{sid:06d}"] = {
                "npz": rec["npz"], "jsonl": rec["jsonl"],
            }
        new_manifest["integrity"] = dict(sorted(new_integrity.items()))
        stats = dict(new_manifest.get("stats") or {"rows": {}, "segments": {}})
        stats["rows"] = dict(stats.get("rows") or {})
        stats["segments"] = dict(stats.get("segments") or {})
        for label, (_sid, rec) in new_stems.items():
            stats["rows"][label] = rec["rows"]
            stats["segments"][label] = 1
        new_manifest["stats"] = stats

        # tmp -> fsync -> atomic replace; under AVDB_FSYNC (save() parity)
        # also commits the rename METADATA — the new segments' renames and
        # the manifest swap all live in replace_manifest's one directory
        tio.replace_manifest(mpath, new_manifest)
        committed = True
        for fp in finals:
            created.remove(fp)

        # -- gc: best-effort unlink of the replaced files -------------------
        bytes_reclaimed = 0
        gc_incomplete = None
        try:
            # crash point: the new manifest is live, the old segment files
            # are not yet unlinked — a death here leaves orphans (fsck
            # prunes), never a missing referenced file
            faults.fire("compact.gc")
            for label in sorted(old_stems):
                for stem in old_stems[label]:
                    for ext in (".npz", ".ann.jsonl"):
                        fp = os.path.join(store_dir, stem + ext)
                        try:
                            size = os.path.getsize(fp)
                            tio.unlink(fp)
                            bytes_reclaimed += size
                        except FileNotFoundError:
                            pass
        except OSError as err:
            gc_incomplete = f"{type(err).__name__}: {err}"
            log(f"compact: gc incomplete ({gc_incomplete}); stale files "
                "remain as orphans — doctor --repair prunes them")

        seconds = time.perf_counter() - t0
        files_before = plan["total_files_before"]
        bytes_after = sum(
            os.path.getsize(os.path.join(
                store_dir, f"chr{lb}.{sid:06d}" + ext))
            for lb, (sid, _r) in new_stems.items()
            for ext in (".npz", ".ann.jsonl")
        )
        report = {
            "status": "compacted",
            "labels": sorted(new_stems),
            "files_before": files_before,
            "files_after": len(new_stems),
            "bytes_before": plan["total_bytes_before"],
            "bytes_after": int(bytes_after),
            "bytes_reclaimed": int(bytes_reclaimed),
            "rows": sum(rec["rows"] for _s, rec in new_stems.values()),
            "rows_dropped": sum(
                rec["rows_dropped"] for _s, rec in new_stems.values()
            ),
            "seconds": round(seconds, 4),
        }
        if gc_incomplete:
            report["gc_incomplete"] = gc_incomplete
        met["passes"].inc()
        met["segments_merged"].inc(files_before - len(new_stems))
        met["bytes_reclaimed"].inc(bytes_reclaimed)
        met["seconds"].observe(seconds)
        _ledger_record(store_dir, report, log)
        log(f"compact: merged {files_before} -> {len(new_stems)} segment "
            f"file(s), {report['bytes_before']} -> {report['bytes_after']} "
            f"bytes, {report['rows_dropped']} shadowed duplicate row(s) "
            f"dropped, {report['seconds']}s")
        return report
    except _Preempted as p:
        cleanup()
        met["aborts"].inc()
        log(f"compact: pass aborted cleanly: {p.reason}")
        return {
            "status": "aborted", "reason": p.reason,
            "labels": sorted(new_stems),
            "files_before": plan["total_files_before"], "files_after": 0,
            "bytes_before": plan["total_bytes_before"], "bytes_after": 0,
            "bytes_reclaimed": 0, "rows": 0, "rows_dropped": 0,
            "seconds": round(time.perf_counter() - t0, 4),
        }
    except BaseException:
        # real failures (I/O, corrupt segment, injected fault): clean the
        # temps where possible, then surface the root cause to the caller
        cleanup()
        met["aborts"].inc()
        raise


def _ledger_record(store_dir: str, report: dict, log) -> None:
    """Append the ``{"type": "compact"}`` run record (see README ledger
    schema).  Best-effort: a ledger problem must not fail a pass whose
    manifest swap already committed."""
    try:
        from annotatedvdb_tpu_torch.store.ledger import AlgorithmLedger

        ledger = AlgorithmLedger(
            os.path.join(store_dir, "ledger.jsonl"), log=log
        )
        ledger.compact({
            k: report[k] for k in (
                "labels", "files_before", "files_after", "bytes_before",
                "bytes_after", "bytes_reclaimed", "rows", "rows_dropped",
                "seconds",
            )
        })
    except (OSError, ValueError) as err:
        log(f"compact: ledger record not written ({err})")


def segment_spans(store_dir: str) -> dict:
    """{label: stem count} from the manifest — the read-amplification
    surface bench/ops tooling reports (files a whole-chromosome scan
    touches)."""
    with open(os.path.join(store_dir, "manifest.json")) as f:
        manifest = json.load(f)
    return {
        label: sum(len(g) for g in glist)
        for label, glist in _normalize_groups(manifest).items()
    }
