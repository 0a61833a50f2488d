"""Bounded retry-with-backoff for transient I/O.

Host copy of the I/O half of ``annotatedvdb_tpu/utils/retry.py``: the
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
