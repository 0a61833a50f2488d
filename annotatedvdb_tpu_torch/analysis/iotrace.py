"""Dynamic crash-consistency sanitizer (the runtime half of AVDB10xx).

Port of ``annotatedvdb_tpu/analysis/iotrace.py``.

The static durability rules (``rules_durability``) prove each writer's
SHAPE: a rename preceded by an fsync in the same function, a manifest
replace carrying a crash point.  They cannot see what actually happens
when the writers compose at runtime — a helper that fsyncs only under a
flag, a promotion path that replaces the manifest but never fsyncs the
directory, a cleanup that unlinks a file the manifest it just read still
references.  Those orderings only exist in the executed interleaving,
so this module records it.

How it works: the :mod:`annotatedvdb_tpu_torch.utils.io` wrappers report every
store-path ``open``/``write``/``fsync``/``rename``/``unlink``/
``fsync_dir`` here when ``AVDB_IO_TRACE=1``.  The recorder keeps

- a **dirty set**: paths written since their last fsync;
- the **current manifest's references** per store directory (re-derived
  from the manifest file each time a rename lands on one);
- **pending directory-fsync obligations**: manifest replaces whose
  rename metadata has not been directory-fsynced (tracked only under
  ``AVDB_FSYNC=1``, where the store promises power-loss durability).

Violations (each recorded once, with the offending paths):

- ``rename-before-fsync`` — a dirty file renamed onto a durable final
  name.  The manifest and WAL classes are judged ALWAYS (their fsync is
  unconditional by design — the manifest commit and the ack path);
  ordinary segment data is judged only under ``AVDB_FSYNC=1``, matching
  the store's documented opt-in (unarmed, segment durability rides the
  page cache surviving process death).
- ``unlink-live-file`` — a file the CURRENT manifest references was
  unlinked (the one delete class no crash-recovery path can undo).
- ``manifest-replace-without-dir-fsync`` — under ``AVDB_FSYNC=1``, a
  manifest replace whose directory was never fsynced afterwards
  (outstanding obligations surface in :meth:`IoTraceRecorder.report`).

Unarmed processes never construct a :class:`~annotatedvdb_tpu_torch.utils.io.
TracedFile` and never reach this module; the recorder costs nothing
unless tracing is on.  ``tests/test_torch_iotrace.py`` and
``chip_smoke.py``'s traced leg fail on ANY violation.
"""

from __future__ import annotations

import json
import os
import threading

from annotatedvdb_tpu_torch.utils.io import fsync_wanted


def _manifest_refs(path: str) -> set:
    """Basenames of every segment file the manifest at ``path``
    references (the same derivation the writers' cleanup passes use).
    Empty set when the manifest is unreadable — liveness is then
    undecidable and unlink stays unjudged."""
    try:
        with open(path, encoding="utf-8") as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return set()
    refs: set = set()
    if not isinstance(doc, dict):
        return refs
    fmt2 = doc.get("format") == 2
    shards = doc.get("shards")
    if not isinstance(shards, dict):
        return refs
    for label, groups in shards.items():
        if not isinstance(groups, list):
            continue
        norm = [[g] for g in groups] if fmt2 else groups
        for group in norm:
            sids = group if isinstance(group, list) else [group]
            for sid in sids:
                try:
                    stem = f"chr{label}.{int(sid):06d}"
                except (TypeError, ValueError):
                    continue
                refs.add(stem + ".npz")
                refs.add(stem + ".ann.jsonl")
    return refs


def _durable_class(base: str) -> str | None:
    """Durability class of a rename DESTINATION basename: ``manifest`` /
    ``wal`` (fsync unconditional by design), ``data`` (fsync is the
    AVDB_FSYNC opt-in), or None for temp/dot names (not a commit)."""
    if base == "manifest.json":
        return "manifest"
    if base.startswith(".") or ".tmp" in base:
        return None
    if base.endswith(".wal"):
        return "wal"
    return "data"


class IoTraceRecorder:
    """Collects durable-I/O events and judges their happens-before order.

    Thread-safe; the internal mutex is a plain ``threading.Lock`` (never
    traced — the recorder must not observe itself).  One recorder per
    process: cross-thread ordering (a flusher thread racing a
    maintenance unlink) is exactly what we are after.
    """

    def __init__(self):
        self._mu = threading.Lock()
        #: guarded by self._mu — paths written since their last fsync
        self._dirty: set = set()
        #: guarded by self._mu — {store_dir: set of referenced basenames}
        self._refs: dict = {}
        #: guarded by self._mu — {store_dir: manifest path} replaces whose
        #: directory entry has not been fsynced (AVDB_FSYNC=1 only)
        self._pending_dirsync: dict = {}
        #: guarded by self._mu
        self._violations: list = []
        #: guarded by self._mu
        self._events = 0

    def _violate(self, kind: str, path: str, detail: str) -> None:
        self._violations.append(  # avdb: noqa[AVDB201] -- callers hold self._mu (note_* helpers append mid-judgment)
            {"kind": kind, "path": path, "detail": detail}
        )

    # -- events reported by utils.io ----------------------------------------

    def note_open(self, path: str, mode: str) -> None:
        with self._mu:
            self._events += 1
            if "w" in mode or "x" in mode:
                # truncating/creating open: previous dirty state is moot
                self._dirty.discard(path)

    def note_write(self, path: str) -> None:
        with self._mu:
            self._events += 1
            self._dirty.add(path)

    def note_fsync(self, path: str) -> None:
        with self._mu:
            self._events += 1
            self._dirty.discard(path)

    def note_rename(self, src: str, dst: str) -> None:
        base = os.path.basename(dst)
        cls = _durable_class(base)
        refs = _manifest_refs(dst) if cls == "manifest" else None
        fsync_armed = fsync_wanted()
        with self._mu:
            self._events += 1
            src_dirty = src in self._dirty
            self._dirty.discard(src)
            self._dirty.discard(dst)
            if src_dirty and cls is not None \
                    and (cls != "data" or fsync_armed):
                self._violate(
                    "rename-before-fsync", dst,
                    f"{src} renamed onto durable name {base!r} with "
                    f"unsynced writes ({cls} class)",
                )
            if cls == "manifest":
                d = os.path.dirname(dst)
                self._refs[d] = refs
                if fsync_armed:
                    self._pending_dirsync[d] = dst

    def note_unlink(self, path: str) -> None:
        base = os.path.basename(path)
        with self._mu:
            self._events += 1
            self._dirty.discard(path)
            refs = self._refs.get(os.path.dirname(path))
            if refs and base in refs:
                self._violate(
                    "unlink-live-file", path,
                    f"{base!r} is referenced by the current manifest",
                )

    def note_dir_fsync(self, path: str) -> None:
        with self._mu:
            self._events += 1
            self._pending_dirsync.pop(path, None)

    # -- reporting -----------------------------------------------------------

    def violations(self) -> list:
        """Every recorded ordering violation, plus one entry per still-
        outstanding directory-fsync obligation (a manifest replace whose
        metadata never became durable counts once the run is over)."""
        with self._mu:
            out = list(self._violations)
            for d, mpath in sorted(self._pending_dirsync.items()):
                out.append({
                    "kind": "manifest-replace-without-dir-fsync",
                    "path": mpath,
                    "detail": f"directory {d} never fsynced after the "
                              f"manifest replace (AVDB_FSYNC=1 promises "
                              f"power-loss durability here)",
                })
        return out

    def report(self) -> dict:
        """The full machine-readable report (the smokes print it)."""
        violations = self.violations()
        with self._mu:
            return {
                "events": self._events,
                "violations": violations,
                "dirty": sorted(self._dirty),
                "pending_dir_fsync": sorted(self._pending_dirsync),
            }

    def reset(self) -> None:
        with self._mu:
            self._dirty.clear()
            self._refs.clear()
            self._pending_dirsync.clear()
            self._violations.clear()
            self._events = 0


#: process-global recorder every traced I/O call reports to
RECORDER = IoTraceRecorder()
