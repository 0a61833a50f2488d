"""Host-side span tracer emitting Chrome trace-event JSON.

Port of ``annotatedvdb_tpu/obs/trace.py``.  The overlapped load executor
runs on four threads (ingest / dispatch / process / store-writer).
``torch.profiler`` (``load-vcf --profile``) shows the DEVICE side of that
pipeline; this tracer records the HOST side — every ``StageTimer.stage``
span becomes one B/E event pair on the thread that ran it — as the Chrome
trace-event format both chrome://tracing and Perfetto load natively.  Open
the host trace and the profiler's trace in the same Perfetto session and
queue stalls line up against kernel launches on one timeline.  ``serve
--traceOut`` puts one ``serve.batch`` span around each drained microbatch.

Format (https://docs.google.com/document/d/1CvAClvFfyA5R-PhYUmn5OOQtYMH4h6I0nSsKchNAySU):
``{"traceEvents": [...], "displayTimeUnit": "ms"}`` where each span is a
``ph: "B"``/``"E"`` pair with microsecond ``ts`` per (pid, tid), thread
names are ``ph: "M"`` ``thread_name`` metadata events, and counter series
(queue depths) are ``ph: "C"`` events.

Cost model: one ``perf_counter_ns`` call plus one locked list append per
event, emitted at STAGE granularity (a handful per chunk) — never per row.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time


class Tracer:
    """Collects trace events in memory; ``save`` writes the JSON file.

    Thread-safe: any pipeline thread may emit.  ``ts`` is microseconds
    relative to tracer creation (monotonic clock), so spans from all
    threads share one timebase.
    """

    def __init__(self, process_name: str = "avdb-load"):
        self._t0 = time.perf_counter_ns()
        self._lock = threading.Lock()
        #: guarded by self._lock
        self._events: list[dict] = []
        #: ident -> (synthetic tid, thread name), guarded by self._lock.
        #: Synthetic tids because ``threading.get_ident`` values are
        #: REUSED once a thread exits: the lazily-spawned store-writer
        #: often inherits the ident of the already-finished ingest
        #: thread, and keying tracks on the raw ident silently merged
        #: the two.  A name change on a known ident means a new thread
        #: generation — it gets a fresh track.
        self._tracks: dict[int, tuple[int, str]] = {}
        self._next_tid = 1
        self.pid = os.getpid()
        with self._lock:
            self._events.append({
                "ph": "M", "name": "process_name", "pid": self.pid, "tid": 0,
                "ts": 0, "args": {"name": process_name},
            })

    def _ts_us(self) -> float:
        return (time.perf_counter_ns() - self._t0) / 1000.0

    def _emit(self, ev: dict) -> None:
        ident = threading.get_ident()
        name = threading.current_thread().name
        with self._lock:
            track = self._tracks.get(ident)
            if track is None or track[1] != name:
                track = (self._next_tid, name)
                self._next_tid += 1
                self._tracks[ident] = track
                self._events.append({
                    "ph": "M", "name": "thread_name", "pid": self.pid,
                    "tid": track[0], "ts": 0, "args": {"name": name},
                })
            ev["pid"] = self.pid
            ev["tid"] = track[0]
            self._events.append(ev)

    def begin(self, name: str, **args) -> None:
        ev = {"ph": "B", "name": name, "ts": self._ts_us()}
        if args:
            ev["args"] = args
        self._emit(ev)

    def end(self, name: str, **args) -> None:
        ev = {"ph": "E", "name": name, "ts": self._ts_us()}
        if args:
            ev["args"] = args
        self._emit(ev)

    @contextlib.contextmanager
    def span(self, name: str, **args):
        self.begin(name, **args)
        try:
            yield
        finally:
            self.end(name)

    def instant(self, name: str, **args) -> None:
        ev = {"ph": "i", "name": name, "ts": self._ts_us(), "s": "t"}
        if args:
            ev["args"] = args
        self._emit(ev)

    def counter(self, name: str, **series) -> None:
        """One sample of a counter track (e.g. queue depth gauges)."""
        self._emit({
            "ph": "C", "name": name, "ts": self._ts_us(), "args": series,
        })

    def events(self) -> list[dict]:
        """Events sorted by ``ts`` (metadata first) — the exact list
        ``save`` writes."""
        with self._lock:
            evs = list(self._events)
        # stable sort: M events carry ts 0 and were appended first, so
        # they lead; B/E pairs from one thread keep emission order at
        # equal timestamps (nested zero-width spans stay well-formed)
        evs.sort(key=lambda e: e["ts"])
        return evs

    def save(self, path: str) -> None:
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        tmp = os.path.join(d, f".{os.path.basename(path)}.tmp{os.getpid()}")
        with open(tmp, "w") as f:
            json.dump(
                {"traceEvents": self.events(), "displayTimeUnit": "ms"}, f
            )
        os.replace(tmp, path)
