"""Algorithm-invocation ledger: load provenance + undo + resume checkpoints.

Reference: every load inserts one row into ``AnnotatedVDB.AlgorithmInvocation``
(script name, params JSON, commit mode) and stamps its serial id on every
variant row so a load can be undone
(``Util/lib/python/algorithm_invocation.py:10-52``,
``Load/bin/undo_variant_load.py``).  Here the ledger is an append-only JSONL
file; each entry also records per-batch **cursor checkpoints** (last committed
line number per input file), which replaces the reference's
``--resumeAfter <variantId>`` log-scanning resume
(``variant_loader.py:349-354,440-455``) with idempotent batch replay.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time

from annotatedvdb_tpu_torch.utils import io as tio


class AlgorithmLedger:
    def __init__(self, path: str, log=None):
        self.path = path
        # the async store writer checkpoints from its own thread while the
        # main thread may append run/finish records — re-entrant so `begin`
        # can compute the next alg_id and append under one acquisition
        self._lock = threading.RLock()
        #: guarded by self._lock
        self._entries: list[dict] = []
        #: guarded by self._lock
        self._heal_before_append = False
        #: lines the open-scan could not parse (torn appends, garbage) —
        #: read paths skipped them; fsck reports the count
        self.skipped_lines = 0
        log = log or (lambda msg: print(msg, file=sys.stderr))
        if os.path.exists(path):
            with open(path) as f:
                lines = [line for line in f if line.strip()]
            for k, line in enumerate(lines):
                try:
                    entry = json.loads(line)
                    if not isinstance(entry, dict):
                        raise ValueError("ledger entry is not an object")
                except ValueError:
                    # torn line: the writer died mid-append, so that record
                    # never became durable — resume proceeds from the
                    # previous checkpoint (the store may run ahead of the
                    # cursor; replay is idempotent).  A NON-final torn line
                    # (a crashed append later concatenated with a fresh
                    # record, or byte damage) is skipped the same way: one
                    # bad line must never poison runs()/last_checkpoint()
                    # for the whole store.  Heal lazily at our first append
                    # — NOT here: rewriting on open would let a concurrent
                    # read-only opener clobber a line the live writer is
                    # completing.
                    self.skipped_lines += 1
                    self._heal_before_append = True
                    where = "torn trailing" if k == len(lines) - 1 else "torn"
                    log(
                        f"ledger {path}: skipping {where} line {k + 1} "
                        f"({line[:80]!r}...)"
                    )
                    continue
                self._entries.append(entry)

    def _append(self, entry: dict) -> None:
        # serialized: the async store writer checkpoints concurrently with
        # main-thread run/finish appends — interleaved list mutation or
        # interleaved file writes would tear the JSONL (a torn line the
        # open-scan would then skip as crash damage)
        with self._lock:
            self._entries.append(entry)
            if self._heal_before_append:
                # drop the torn lines detected at open, atomically, now that
                # this process IS the writer.  Dot-prefixed tmp name so
                # VariantStore.save's orphan cleanup reaps it after a crash.
                d, base = os.path.split(self.path)
                tmp = os.path.join(d, f".{base}.tmp{os.getpid()}")
                with open(tmp, "w") as out:
                    for e in self._entries:
                        out.write(json.dumps(e) + "\n")
                    out.flush()
                    tio.fsync(out)
                tio.replace(tmp, self.path)
                self._heal_before_append = False
                return
            with open(self.path, "a") as f:
                f.write(json.dumps(entry) + "\n")
                if tio.fsync_wanted():
                    # power-loss opt-in: make the cursor promptly durable.
                    # (Safety never depends on this — the store's fsync'd
                    # renames complete BEFORE this append is written, so the
                    # cursor can lag the store but never lead it.)
                    f.flush()
                    tio.fsync(f)

    def begin(self, script: str, params: dict, commit: bool) -> int:
        """Register a load; returns the new algorithm-invocation id (serial)."""
        with self._lock:
            alg_id = 1 + max(
                (e["alg_id"] for e in self._entries if "alg_id" in e),
                default=0,
            )
            self._append_begin(script, params, commit, alg_id)
        return alg_id

    def _append_begin(self, script, params, commit, alg_id) -> None:
        self._append(
            {
                "type": "invocation",
                "alg_id": alg_id,
                "script": script,
                "params": params,
                "commit_mode": commit,
                "ts": time.time(),
            }
        )

    def checkpoint(self, alg_id: int, input_file: str, line: int,
                   counters: dict | None = None) -> None:
        """Record a committed batch boundary (the resume cursor)."""
        self._append(
            {
                "type": "checkpoint",
                "alg_id": alg_id,
                "file": input_file,
                "line": line,
                "counters": counters or {},
                "ts": time.time(),
            }
        )

    def finish(self, alg_id: int, counters: dict) -> None:
        self._append(
            {"type": "finish", "alg_id": alg_id, "counters": counters, "ts": time.time()}
        )

    def run(self, record: dict) -> None:
        """Append one per-run record (``type: "run"``).  The loaders'
        observability run record is not ported, so in the port only
        ``doctor --repair``'s ledger heal writes one; resume and undo
        ignore them."""
        self._append({"type": "run", **record, "ts": time.time()})

    def runs(self) -> list[dict]:
        """All run records, oldest first (``doctor``'s read path: fsck's
        reload hints, ``status``'s run count)."""
        with self._lock:
            return [e for e in self._entries if e.get("type") == "run"]

    def compact(self, record: dict) -> None:
        """Append one ``{"type": "compact"}`` maintenance record — the
        audit trail of a compaction pass (``store/compact.py``: labels
        compacted, files and bytes before and after, shadowed-duplicate
        rows dropped, wall seconds).  Resume and undo ignore it."""
        self._append({"type": "compact", **record, "ts": time.time()})

    def compactions(self) -> list[dict]:
        """All compact records (``doctor compact`` passes), oldest first."""
        with self._lock:
            return [e for e in self._entries if e.get("type") == "compact"]

    def flush(self, record: dict) -> None:
        """Append one ``{"type": "flush"}`` record — the audit trail of a
        memtable flush (``store/memtable.py``: labels flushed, rows, new
        seg ids, bytes, wall seconds).  Resume and undo ignore it."""
        self._append({"type": "flush", **record, "ts": time.time()})

    def flushes(self) -> list[dict]:
        """All memtable-flush records, oldest first."""
        with self._lock:
            return [e for e in self._entries if e.get("type") == "flush"]

    def export(self, record: dict) -> None:
        """Append one ``{"type": "export"}`` record — a committed corpus
        part (``export/core.py``: output dir, plan signature, part ordinal,
        file, sha256, rows).  ``export --resume`` replans and skips every
        part recorded here (either package's records); load resume and
        undo ignore it."""
        self._append({"type": "export", **record, "ts": time.time()})

    def exports(self) -> list[dict]:
        """All export records, oldest first (the resume read path)."""
        with self._lock:
            return [e for e in self._entries if e.get("type") == "export"]

    def undo_intent(self, alg_id: int) -> None:
        """Record that an undo of ``alg_id`` is ABOUT to mutate the store.

        Appended BEFORE ``store.save()`` on the undo path: a crash between
        the save and the final ``undo`` record then leaves an intent with no
        completion (:meth:`pending_undo_intents`), which says "re-run
        ``undo --algId N --commit``" (idempotent: the delete masks on
        ``row_algorithm_id``) instead of the store silently disagreeing with
        the ledger.  Resume and undo read paths ignore intents."""
        self._append(
            {"type": "undo_intent", "alg_id": alg_id, "ts": time.time()}
        )

    def undo(self, alg_id: int, removed: int) -> None:
        self._append(
            {"type": "undo", "alg_id": alg_id, "removed": removed, "ts": time.time()}
        )

    def pending_undo_intents(self) -> list[int]:
        """Alg ids with an ``undo_intent`` but no completing ``undo``
        record — the cross-check for a crash mid-undo."""
        with self._lock:
            done = {
                e["alg_id"] for e in self._entries if e.get("type") == "undo"
            }
            return sorted({
                e["alg_id"] for e in self._entries
                if e.get("type") == "undo_intent" and e["alg_id"] not in done
            })

    def last_checkpoint(self, input_file: str) -> int:
        """Resume cursor for an input file: the line of its most recently
        appended checkpoint, and only if that checkpoint's invocation never
        finished (0 otherwise).  Only the latest invocation counts — a
        checkpoint left by a crashed load is superseded once a later
        invocation completes the file, so re-submitting a finished file is a
        fresh load (the loader's own skip/duplicate policy governs its rows),
        not a crash recovery."""
        with self._lock:
            entries = list(self._entries)
        finished = {
            e["alg_id"] for e in entries if e.get("type") == "finish"
        }
        undone = {
            e["alg_id"] for e in entries if e.get("type") == "undo"
        }
        invocations = {
            e["alg_id"]: e for e in entries if e.get("type") == "invocation"
        }

        def is_partial(alg_id: int) -> bool:
            # --test runs stop after one batch, so even a clean finish does
            # not mean the file completed: their checkpoints stay live as
            # resume cursors
            inv = invocations.get(alg_id)
            return bool(inv and inv.get("params", {}).get("test"))

        for pos in range(len(entries) - 1, -1, -1):
            e = entries[pos]
            if e.get("type") != "checkpoint" or e.get("file") != input_file:
                continue
            if e["alg_id"] in undone:
                # an undone invocation's rows were deleted — its checkpoint
                # is dead, and older checkpoints (if any) take over
                continue
            if e["alg_id"] in finished and not is_partial(e["alg_id"]):
                return 0
            # a later COMMIT invocation on the same file that finished
            # supersedes a crashed checkpoint even if it wrote no checkpoints
            # of its own (a resume run whose chunks were all already covered).
            # Dry runs (commit_mode False) and --test runs stop early / persist
            # nothing, so they never count as completing the file.
            later_finished = any(
                inv.get("type") == "invocation"
                and inv.get("params", {}).get("file") == input_file
                and inv.get("commit_mode")
                and not inv.get("params", {}).get("test")
                and inv["alg_id"] in finished
                and inv["alg_id"] not in undone  # an undone run covers nothing
                for inv in entries[pos + 1:]
            )
            return 0 if later_finished else e["line"]
        return 0

    def invocations(self) -> list[dict]:
        with self._lock:
            return [
                e for e in self._entries if e.get("type") == "invocation"
            ]
