"""Per-input load logs + cadence, mirroring the reference's operational
logging (``Load/bin/load_vcf_file.py:29-47``): every load writes
``<input>-<tag>.log`` beside its input file, messages mirror to stderr, a
CRITICAL record kills the process (the reference's
``ExitOnCriticalExceptionHandler``), and loaders emit counter lines every
``--logAfter`` input lines (default = the commit batch size).
"""

from __future__ import annotations

import logging
import os
import sys


class ProgressCadence:
    """Counter-line emission every N input lines — the one implementation
    of the ``--logAfter`` cadence shared by all loaders."""

    def __init__(self, log, log_after: int | None, unit: str = "lines"):
        self.log = log
        self.log_after = log_after
        self.unit = unit
        self._next = log_after or 0
        self._last_logged = -1

    def maybe_log(self, n_lines: int, counters: dict, extra: str = "") -> None:
        if self.log_after and n_lines >= self._next:
            self.log(
                f"PARSED {n_lines:,} {self.unit}; counters {counters}"
                + (f" | {extra}" if extra else "")
            )
            self._next = n_lines + self.log_after
            self._last_logged = n_lines

    def finish(self, n_lines: int, counters: dict, extra: str = "") -> None:
        """Terminal counter line at load end.  A load ending BETWEEN
        cadences (short files especially: fewer lines than one cadence)
        would otherwise never log its totals; loads that happened to end
        exactly on a cadence line don't repeat themselves."""
        if not self.log_after or n_lines <= 0 or n_lines == self._last_logged:
            return
        self.log(
            f"PARSED {n_lines:,} {self.unit} (final); counters {counters}"
            + (f" | {extra}" if extra else "")
        )
        self._last_logged = n_lines


class ExitOnCriticalHandler(logging.StreamHandler):
    """Stderr mirror that terminates the process on CRITICAL — a load must
    not keep streaming batches after an unrecoverable error
    (``load_vcf_file.py:18,35-40``)."""

    def emit(self, record):
        super().emit(record)
        if record.levelno >= logging.CRITICAL:
            raise SystemExit(1)


#: live per-input loggers this process may keep (LRU).  Python's logging
#: module interns every named logger FOREVER in ``Logger.manager.loggerDict``
#: — one logger per absolute input path leaks unboundedly in a long-lived
#: process that loads thousands of files.  Evicted loggers get their handlers
#: closed and their manager entry dropped; re-opening the same input later
#: just re-creates it.
MAX_LIVE_LOGGERS = 32
_live_loggers: "dict[str, None]" = {}  # insertion-ordered: name -> None


def _register_logger(name: str) -> None:
    """LRU-bound the per-input logger population (see MAX_LIVE_LOGGERS).

    Eviction closes the victim's file handle (that is the resource being
    bounded) and leaves a NullHandler behind: a caller still holding the
    evicted log callable (>32 interleaved in-flight loads) degrades to
    silently dropped messages, never a write-to-closed-stream error from
    inside the logging machinery."""
    _live_loggers.pop(name, None)
    _live_loggers[name] = None  # (re-)insert most-recent
    while len(_live_loggers) > MAX_LIVE_LOGGERS:
        victim = next(iter(_live_loggers))
        del _live_loggers[victim]
        old = logging.Logger.manager.loggerDict.get(victim)
        if isinstance(old, logging.Logger):
            for h in list(old.handlers):
                old.removeHandler(h)
                h.close()
            old.addHandler(logging.NullHandler())
        # drop the interned entry so a later load of the same input
        # recreates the logger fresh (the evicted object stays valid for
        # any caller still holding it, just handler-less)
        logging.Logger.manager.loggerDict.pop(victim, None)


def load_logger(input_path: str, tag: str,
                log_path: str | None = None) -> tuple:
    """(log callable, logger, log file path) for one input file.

    ``log`` accepts print-style positional args so it drops into the
    loaders' existing ``log=`` parameter."""
    if log_path is None:
        log_path = f"{input_path}-{tag}.log"
    # dots in the PATH portion are sanitized out of the logger name:
    # logging interns a PlaceHolder for every dot-separated ancestor, so
    # "x.vcf" would otherwise leak one placeholder per input past the LRU
    name = f"avdb.{tag}.{os.path.abspath(input_path).replace('.', '_')}"
    logger = logging.getLogger(name)
    logger.setLevel(logging.INFO)
    logger.propagate = False
    _register_logger(name)
    for h in list(logger.handlers):  # re-runs in one process: no dup handlers
        logger.removeHandler(h)
        h.close()
    fmt = logging.Formatter("%(asctime)s %(levelname)s %(message)s")
    eh = ExitOnCriticalHandler(sys.stderr)
    eh.setFormatter(fmt)
    logger.addHandler(eh)
    try:
        fh = logging.FileHandler(log_path)
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    except OSError as err:
        # inputs often live on read-only mounts: degrade to stderr-only
        # instead of refusing to load (pass an explicit log path to place
        # the file somewhere writable)
        log_path = None
        logger.warning(f"cannot open log file ({err}); logging to stderr only")

    def log(*args) -> None:
        logger.info(" ".join(str(a) for a in args))

    return log, logger, log_path
