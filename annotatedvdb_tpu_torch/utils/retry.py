"""Bounded retry-with-backoff for transient I/O, and the preemption
retry of cooperative store passes.

Host copy of the I/O half of ``annotatedvdb_tpu/utils/retry.py`` and its
:func:`retry_preempted` (the maintenance daemon's and ``doctor compact
--retries``' policy for a cleanly preempted compaction pass): the
Postgres egress's COPY writers and the memtable flush (which also retries
a full disk) retry transient filesystem errors
(``EIO``/``EAGAIN``/``EBUSY``/``EINTR``/``ESTALE``: NFS blips and
overloaded disks on multi-hour exports) and ONLY those — data errors and
logic errors propagate unchanged.  Retries are bounded (default 3
attempts) with exponential backoff.
"""

from __future__ import annotations

import errno
import time

#: errno values worth a retry: transient by nature, not data-dependent.
TRANSIENT_ERRNOS = frozenset({
    errno.EIO, errno.EAGAIN, errno.EBUSY, errno.EINTR, errno.ESTALE,
})


#: errno values of a full disk or quota: the memtable flush retries them
#: (space may come back), the egress writers do not
DISK_FULL_ERRNOS = frozenset({errno.ENOSPC, errno.EDQUOT})


def is_transient_io(exc: BaseException) -> bool:
    return isinstance(exc, OSError) and exc.errno in TRANSIENT_ERRNOS


def is_disk_full(exc: BaseException) -> bool:
    return isinstance(exc, OSError) and exc.errno in DISK_FULL_ERRNOS


def with_backoff(fn, *, attempts: int = 3, base_delay: float = 0.05,
                 max_delay: float = 2.0, retryable=is_transient_io):
    """Run ``fn()``; on a retryable exception, back off and re-run, at most
    ``attempts`` times total.  Non-retryable exceptions and the final
    retryable failure propagate unchanged."""
    for attempt in range(1, attempts + 1):
        try:
            return fn()
        except BaseException as exc:
            if attempt >= attempts or not retryable(exc):
                raise
            time.sleep(min(base_delay * (2 ** (attempt - 1)), max_delay))


def retry_preempted(run, *, retries: int = 1, base_delay: float = 0.2,
                    max_delay: float = 5.0, cancel=None, log=None,
                    what: str = "pass"):
    """Run a cooperative store pass and retry it while it reports a CLEAN
    preemption — the one preemption-retry policy shared by the
    maintenance daemon and ``doctor compact --retries``.

    ``run()`` returns a report dict; ``status == "aborted"`` means another
    writer preempted the pass under the cooperative commit protocol
    (store untouched, retry-safe), so the pass is re-run after an
    exponential backoff, at most ``retries`` more times.  Every other
    status and every exception returns or propagates unchanged: hard
    failures must alert, not spin.

    ``cancel`` is the caller's own abort flag (the callable the pass
    observes): an abort the caller requested — SIGTERM, daemon stop, a
    hot-health yield — is not a preemption to retry.
    """
    report = run()
    attempt = 0
    while (isinstance(report, dict) and report.get("status") == "aborted"
           and attempt < retries
           and not (cancel is not None and cancel())):
        attempt += 1
        delay = min(base_delay * (2 ** (attempt - 1)), max_delay)
        if log is not None:
            log(f"{what} preempted cleanly "
                f"({report.get('reason', 'another writer committed')}); "
                f"retry {attempt}/{retries} in {delay:.2f}s")
        time.sleep(delay)
        report = run()
    return report
