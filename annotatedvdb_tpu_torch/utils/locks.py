"""Named lock construction for the serve stack (lock-order tracing hook).

Port of ``annotatedvdb_tpu/utils/locks.py``, with its ``AVDB_LOCK_TRACE``
recorder (:mod:`annotatedvdb_tpu_torch.analysis.lockorder`).

Every serve-stack mutex is built through :func:`make_lock` with a stable
dotted name.  Unarmed (the default), the factory returns a plain
``threading.Lock``/``RLock`` — zero wrapper, zero per-acquire overhead,
byte-for-byte the behavior the stack always had.  With
``AVDB_LOCK_TRACE=1`` it returns a :class:`TracedLock` that reports every
acquire/release to the process-global
:data:`annotatedvdb_tpu_torch.analysis.lockorder.RECORDER`, which maintains the
per-thread acquisition-order graph, detects cycles (potential
deadlocks), and accounts held durations as the
``avdb_lock_held_seconds`` histogram.

``tests/test_torch_locks.py`` drives the serve stack with tracing armed
(against the JAX package's recorder on the same requests) and
``chip_smoke.py`` serves a store armed on the card; either fails on any
cycle.

The obs/metrics locks are deliberately NOT built through this factory:
the recorder itself observes into metrics histograms, so tracing them
would recurse (and they are pure leaf locks — never held across another
acquire — so they cannot participate in an inversion).
"""

from __future__ import annotations

import os
import threading


def trace_enabled() -> bool:
    """``AVDB_LOCK_TRACE`` — 1 arms lock-order tracing (read at lock
    CONSTRUCTION time, so a server built after the environment is set is
    fully traced and an unarmed process pays nothing)."""
    return os.environ.get("AVDB_LOCK_TRACE", "") == "1"


class TracedLock:
    """A ``threading.Lock``/``RLock`` that reports acquisition order.

    API-compatible with the stdlib locks for every use in this tree:
    context manager, ``acquire(blocking, timeout)``, ``release``,
    ``locked``.  Only SUCCESSFUL acquires are recorded (a timed-out
    attempt changes no ordering); reentrant re-acquires of an RLock never
    produce a self-edge (the recorder filters same-name edges) but do
    push/pop so held time nests correctly.
    """

    __slots__ = ("name", "_inner", "_recorder")

    def __init__(self, name: str, reentrant: bool = False, recorder=None):
        self.name = name
        self._inner = threading.RLock() if reentrant else threading.Lock()
        if recorder is None:
            from annotatedvdb_tpu_torch.analysis.lockorder import RECORDER

            recorder = RECORDER
        self._recorder = recorder

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            self._recorder.note_acquired(self.name)
        return ok

    def release(self) -> None:
        self._recorder.note_released(self.name)
        self._inner.release()

    def locked(self) -> bool:
        fn = getattr(self._inner, "locked", None)  # RLock lacks it pre-3.12
        return bool(fn()) if fn is not None else False

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, exc_type, exc, tb):
        self.release()
        return False

    def __repr__(self) -> str:
        return f"TracedLock({self.name!r}, {self._inner!r})"


def make_lock(name: str, reentrant: bool = False):
    """A mutex named for the lock-order report.  Plain stdlib lock when
    tracing is unarmed (the production path); :class:`TracedLock` under
    ``AVDB_LOCK_TRACE=1``."""
    if not trace_enabled():
        return threading.RLock() if reentrant else threading.Lock()
    return TracedLock(name, reentrant=reentrant)
