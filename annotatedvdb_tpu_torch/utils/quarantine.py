"""Quarantine sink + error budgets: reject bad input rows, don't lose them.

Every loader family (VCF / VEP JSON / CADD TSV / annotation TSV) can hit
malformed input lines.  Pre-this-module behavior was skip-and-count — fine
for the odd truncated line, useless for diagnosing a systematically broken
upstream export.  The quarantine sink preserves every rejected line verbatim
at ``<store>/quarantine/<input-basename>.rejects.jsonl``:

    {"meta": {"input": ..., "loader": ..., "header": ...}}   # first record
    {"line": 4012, "reason": "invalid JSON: ...", "raw": "<original line>"}

The file is REPLAYABLE: fix the ``raw`` fields in place (or fix upstream),
run ``python -m annotatedvdb_tpu_torch doctor replay-rejects --rejects
<file> --out fixed.<ext>`` (:func:`write_replay`) to reconstruct a loadable
input (the meta record's ``header`` restores TSV headers), and load the
reconstructed file with the same loader — resume/skip-existing semantics
make the replay idempotent against the rows that already landed.

The :class:`ErrorBudget` turns tolerance into policy: ``--maxErrors N`` on a
loader CLI aborts the load (``ErrorBudgetExceeded``) once more than N rows
have been rejected — a broken input fails fast instead of quarantining
millions of lines, while the default (-1, unlimited) keeps the historical
skip-and-count behavior.  Sinks are thread-safe: under the overlapped
pipeline, rejects fire on the ingest thread.
"""

from __future__ import annotations

import json
import os
import threading


class ErrorBudgetExceeded(RuntimeError):
    """More input rows rejected than ``--maxErrors`` allows."""


class ErrorBudget:
    """Counted tolerance for rejected rows.  ``max_errors < 0`` = unlimited."""

    def __init__(self, max_errors: int = -1):
        self.max_errors = int(max_errors)
        self.count = 0
        self._lock = threading.Lock()

    def add(self, n: int = 1, context: str = "") -> None:
        with self._lock:
            self.count += n
            over = 0 <= self.max_errors < self.count
        if over:
            raise ErrorBudgetExceeded(
                f"{self.count} input rows rejected, --maxErrors "
                f"{self.max_errors} exceeded"
                + (f" ({context})" if context else "")
            )


class QuarantineSink:
    """Append-only JSONL of rejected input rows for one load.

    Lazily created: a clean load never touches the quarantine directory.
    Each record is flushed immediately — a crashed load's rejects survive.
    """

    def __init__(self, store_dir: str, input_path: str, loader: str,
                 header: str | None = None,
                 budget: ErrorBudget | None = None, log=None):
        self.path = os.path.join(
            store_dir, "quarantine",
            os.path.basename(input_path) + ".rejects.jsonl",
        )
        self.input_path = input_path
        self.loader = loader
        self.header = header
        self.budget = budget if budget is not None else ErrorBudget()
        self.log = log
        self.count = 0
        self._fh = None
        self._lock = threading.Lock()

    def _file(self):
        if self._fh is None:
            os.makedirs(os.path.dirname(self.path), exist_ok=True)
            if os.path.exists(self.path):
                # never clobber un-replayed rejects (a re-run of the same
                # input, or a different loader sharing the input basename):
                # keep one prior generation at <path>.1
                os.replace(self.path, self.path + ".1")
                if self.log is not None:
                    self.log(
                        f"quarantine: rotated previous rejects to "
                        f"{self.path}.1"
                    )
            self._fh = open(self.path, "w")
            self._fh.write(json.dumps({"meta": {
                "input": self.input_path, "loader": self.loader,
                "header": self.header,
            }}) + "\n")
        return self._fh

    def set_header(self, header: str) -> None:
        """Late header binding (the TSV loader reads its header after the
        sink is built); effective only before the first reject creates
        the file."""
        self.header = header

    def reject(self, line_no: int | None, raw: str, reason: str) -> None:
        """Quarantine one rejected input line; raises
        :class:`ErrorBudgetExceeded` past the budget (the record is written
        FIRST, so the aborting row is itself preserved)."""
        with self._lock:
            f = self._file()
            f.write(json.dumps(
                {"line": line_no, "reason": reason, "raw": raw}
            ) + "\n")
            f.flush()
            self.count += 1
        if self.log is not None:
            self.log(f"quarantined line {line_no}: {reason}")
        self.budget.add(1, context=f"last: line {line_no}: {reason}")

    def reject_uncaptured(self, n: int, reason: str) -> None:
        """Budget-count rejects whose line content is unavailable (native
        tokenizer engines report malformed counts, not spans); one summary
        record witnesses them in the quarantine file."""
        if n <= 0:
            return
        with self._lock:
            f = self._file()
            f.write(json.dumps(
                {"line": None, "reason": reason, "count": n, "raw": None}
            ) + "\n")
            f.flush()
            self.count += n
        self.budget.add(n, context=reason)

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None


def read_rejects(path: str) -> tuple[dict, list[dict]]:
    """(meta, records) from a rejects file; meta is {} for old files."""
    meta: dict = {}
    records: list[dict] = []
    with open(path) as f:
        for line in f:
            if not line.strip():
                continue
            rec = json.loads(line)
            if "meta" in rec:
                meta = rec["meta"]
            else:
                records.append(rec)
    return meta, records


def write_replay(rejects_path: str, out_path: str) -> int:
    """Reconstruct a loadable input file from a (possibly hand-fixed)
    rejects file: the meta header first (TSV loaders), then every captured
    ``raw`` line verbatim.  Returns the number of rows written; summary
    (uncaptured) records are skipped — their lines were never preserved."""
    meta, records = read_rejects(rejects_path)
    n = 0
    with open(out_path, "w") as out:
        header = meta.get("header")
        if header:
            out.write(header.rstrip("\n") + "\n")
        for rec in records:
            raw = rec.get("raw")
            if raw is None:
                continue
            out.write(raw.rstrip("\n") + "\n")
            n += 1
    return n
