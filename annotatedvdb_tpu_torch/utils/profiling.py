"""Per-stage timers for the load pipeline, and the bulk-load GC pause.

Copy of the parts of ``annotatedvdb_tpu/utils/profiling.py`` the serial
insert load uses: :class:`StageTimer` attributes host wall-clock to named
stages (ingest / dispatch / annotate / lookup / egress / build / append /
persist), and :func:`bulk_load_gc` suspends the cyclic collector for a
load.  Device time is not in these numbers: CUDA work is asynchronous and
is charged to the stage that waits for it (``annotate``, which copies the
results back).
"""

from __future__ import annotations

import contextlib
import threading
import time


class StageTimer:
    """Accumulates busy seconds + item counts per named stage, plus the
    wall-clock of the enclosing run."""

    def __init__(self, clock=time.perf_counter):
        self._clock = clock
        self._lock = threading.Lock()
        self.seconds: dict[str, float] = {}
        self.items: dict[str, int] = {}
        self.wall_seconds: float = 0.0

    @contextlib.contextmanager
    def stage(self, name: str, items: int = 0):
        t0 = self._clock()
        try:
            yield
        finally:
            dt = self._clock() - t0
            with self._lock:
                self.seconds[name] = self.seconds.get(name, 0.0) + dt
                self.items[name] = self.items.get(name, 0) + items

    @contextlib.contextmanager
    def wall(self):
        """Record one run's wall-clock."""
        t0 = self._clock()
        try:
            yield
        finally:
            dt = self._clock() - t0
            with self._lock:
                self.wall_seconds += dt

    def summary(self) -> str:
        with self._lock:
            snapshot = dict(self.seconds)
            items = dict(self.items)
            wall = self.wall_seconds
        total = sum(snapshot.values()) or 1e-12
        parts = []
        for name in sorted(snapshot, key=snapshot.get, reverse=True):
            s = snapshot[name]
            line = f"{name}: {s:.2f}s ({100 * s / total:.0f}%)"
            if items.get(name) and s > 0:
                line += f" {items[name] / s:,.0f}/s"
            parts.append(line)
        if wall:
            parts.append(f"wall: {wall:.2f}s")
        return " | ".join(parts)


@contextlib.contextmanager
def bulk_load_gc():
    """Suspend the cyclic GC for the duration of a bulk load (loads
    allocate millions of objects that mostly survive, so generational
    collection rescans them for nothing).  Re-entrant and exception-safe;
    ``AVDB_LOAD_GC=1`` keeps the collector on."""
    import gc
    import os

    if os.environ.get("AVDB_LOAD_GC") == "1" or not gc.isenabled():
        yield
        return
    gc.disable()
    try:
        yield
    finally:
        gc.enable()
        gc.collect()
