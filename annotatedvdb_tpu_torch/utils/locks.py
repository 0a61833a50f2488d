"""Named lock construction for the serve stack.

Port of ``annotatedvdb_tpu/utils/locks.py::make_lock``.  Every serve-stack
mutex is built through :func:`make_lock` with a stable dotted name; the
reference's lock-order tracing (``AVDB_LOCK_TRACE=1``, its ``TracedLock``
and recorder) is not ported, so the factory always returns a plain
``threading.Lock``/``RLock``.
"""

from __future__ import annotations

import threading


def make_lock(name: str, reentrant: bool = False):
    """A mutex named for the lock-order report (the name is kept for the
    call sites; nothing records it here)."""
    return threading.RLock() if reentrant else threading.Lock()
