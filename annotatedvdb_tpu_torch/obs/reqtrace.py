"""Request-scoped tracing: per-stage spans into a lock-free span ring.

Port of ``annotatedvdb_tpu/obs/reqtrace.py``, trimmed to what the engine,
the batcher and the threaded handler call: :func:`activate` and
:func:`span_active` (engine sub-spans onto the calling thread's trace),
and :class:`TraceRecorder` with ``begin`` (a :class:`RequestTrace`, or None
when ``AVDB_TRACE_SAMPLE`` disarms recording — the no-op path every caller
guards on) and ``finish`` (the ``avdb_stage_seconds`` histograms, the
``AVDB_TRACE_SLOW_MS`` slow-request log and the flight recorder's request
summary), and the background-writer sink (:func:`set_background_sink`,
:func:`background_span`, :func:`lifecycle_event`): the maintenance
daemon's passes, memtable flushes, compaction groups and WAL rotations
record spans and lifecycle events into the process's flight recorder
without the store layer importing serve code.

The span ring: a fixed-size (:attr:`TraceRecorder.SLOTS`) per-process ring
of finished-request and background records.  Writes are lock-free: one
shared ``itertools.count`` reserves a slot (thread-safe under the GIL),
one list-item assignment publishes the immutable record tuple, and a
reader copying the list sees each slot as the old record or the new one,
never a hybrid.  :meth:`TraceRecorder.chrome_events` renders it as Chrome
trace events, the body of the chaos-gated ``GET /debug/trace``.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import random
import threading
import time

#: the stage vocabulary (``avdb_stage_seconds{stage=...}`` series)
STAGES = ("admission", "queue", "device", "render", "wal_fsync",
          "background", "total")

#: per-stage latency histogram edges (seconds)
STAGE_SECONDS_EDGES = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 10.0,
)


def slow_ms_from_env() -> float:
    """``AVDB_TRACE_SLOW_MS`` — slow-request log threshold in ms (0 =
    disabled, the default)."""
    return max(float(os.environ.get("AVDB_TRACE_SLOW_MS", "") or 0), 0.0)


def sample_from_env() -> float:
    """``AVDB_TRACE_SAMPLE`` — fraction of requests recording span
    breakdowns (default 1.0; 0 disarms recording)."""
    v = float(os.environ.get("AVDB_TRACE_SAMPLE", "") or 1.0)
    return min(max(v, 0.0), 1.0)


class RequestTrace:
    """One request's in-flight span scratchpad, touched only by the threads
    serving that request (the handler and the batcher drain hand it off)."""

    __slots__ = ("trace_id", "kind", "t0_ns", "stages", "spans")

    #: sub-span cap per request
    MAX_SPANS = 64

    def __init__(self, trace_id: str, kind: str):
        self.trace_id = trace_id
        self.kind = kind
        self.t0_ns = time.perf_counter_ns()
        self.stages: list = []  # (stage_name, seconds)
        self.spans: list = []   # (name, seconds) sub-spans (engine detail)

    def add(self, stage: str, seconds: float) -> None:
        self.stages.append((stage, seconds))

    def span(self, name: str, seconds: float) -> None:
        if len(self.spans) < self.MAX_SPANS:
            self.spans.append((name, seconds))


_active = threading.local()


@contextlib.contextmanager
def activate(trace: RequestTrace | None):
    """Bind ``trace`` as this thread's active trace for the duration (the
    engine runs entirely on the calling thread)."""
    if trace is None:
        yield
        return
    prev = getattr(_active, "trace", None)
    _active.trace = trace
    try:
        yield
    finally:
        _active.trace = prev


def span_active(name: str, seconds: float) -> None:
    """Attach a sub-span to the calling thread's active trace (no-op
    outside any request)."""
    trace = getattr(_active, "trace", None)
    if trace is not None:
        trace.span(name, seconds)


# -- background writers (store layer joins the plane without importing it) --

#: (span_sink, event_sink) — set by the serving/supervisor process that
#: owns a recorder; store-layer writers call the module functions and a
#: process without a recorder pays one ``is None`` check
_BACKGROUND: tuple | None = None


def set_background_sink(span_sink, event_sink) -> None:
    """Install the process's background sinks: ``span_sink(name, seconds,
    meta)`` records one background-track span, ``event_sink(name,
    detail)`` one lifecycle event (flight recorder).  Either may be None;
    pass ``(None, None)`` to clear."""
    global _BACKGROUND
    _BACKGROUND = (span_sink, event_sink) \
        if (span_sink is not None or event_sink is not None) else None


@contextlib.contextmanager
def background_span(name: str, **meta):
    """Time one background-writer unit of work (a memtable flush, a
    compaction group, a daemon pass) onto the ``background`` track.  The
    sink must never take the writer down: failures are swallowed — losing
    a span is always better than losing a flush."""
    sink = _BACKGROUND
    if sink is None or sink[0] is None:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        try:
            sink[0](name, time.perf_counter() - t0, meta or None)
        except Exception:  # avdb: noqa[AVDB602] -- observability must never take down the background writer it observes
            pass


def lifecycle_event(name: str, detail: str) -> None:
    """Record one lifecycle event (brownout change, breaker trip, daemon
    pass transition, WAL rotation) into the process's flight recorder —
    a no-op without a sink, and a swallowed failure with one."""
    sink = _BACKGROUND
    if sink is None or sink[1] is None:
        return
    try:
        sink[1](name, detail)
    except Exception:  # avdb: noqa[AVDB602] -- observability must never take down the code path it observes
        pass


class TraceRecorder:
    """Per-process span recording: the ring, the stage histograms, the
    slow-request log and the flight-recorder feed."""

    SLOTS = 2048

    def __init__(self, registry=None, slots: int | None = None,
                 slow_ms: float | None = None, sample: float | None = None,
                 log=None, flight=None):
        n = self.SLOTS if slots is None else max(int(slots), 1)
        self.slots = n
        self.t0_ns = time.perf_counter_ns()
        self.t0_epoch = time.time()
        self.slow_s = (
            slow_ms_from_env() if slow_ms is None else max(float(slow_ms), 0.0)
        ) / 1000.0
        self.sample = (
            sample_from_env() if sample is None
            else min(max(float(sample), 0.0), 1.0)
        )
        self.log = log if log is not None else (lambda msg: None)
        self.flight = flight
        #: the lock-free ring: slot reservation through the (GIL-atomic)
        #: counter, publication through one list-item assignment of an
        #: immutable tuple — concurrent writers never wait on each other
        self._ring: list = [None] * n
        self._seq = itertools.count()
        self._rng = random.Random(0xA5DB7)
        self._hist = {}
        self._m_slow = None
        if registry is not None:
            for stage in STAGES:
                self._hist[stage] = registry.histogram(
                    "avdb_stage_seconds", STAGE_SECONDS_EDGES,
                    "per-request stage latency from the request tracer",
                    {"stage": stage},
                )
            self._m_slow = registry.counter(
                "avdb_trace_slow_requests_total",
                "requests whose total latency exceeded AVDB_TRACE_SLOW_MS",
            )

    def begin(self, trace_id: str, kind: str) -> RequestTrace | None:
        if self.sample <= 0.0:
            return None
        if self.sample < 1.0 and self._rng.random() >= self.sample:
            return None
        return RequestTrace(trace_id, kind)

    def finish(self, trace: RequestTrace | None, status: int = 200) -> None:
        """Seal one request's trace: publish the ring record, feed the
        stage histograms, log it when slow, and write the flight-recorder
        request summary."""
        if trace is None:
            return
        now_ns = time.perf_counter_ns()
        total = (now_ns - trace.t0_ns) / 1e9
        record = (
            trace.trace_id, trace.kind, int(status),
            trace.t0_ns, total,
            tuple(trace.stages), tuple(trace.spans),
        )
        self._ring[next(self._seq) % self.slots] = record
        hist = self._hist
        if hist:
            hist["total"].observe(total)
            for stage, seconds in trace.stages:
                h = hist.get(stage)
                if h is not None:
                    h.observe(seconds)
        if self.slow_s and total >= self.slow_s:
            if self._m_slow is not None:
                self._m_slow.inc()
            breakdown = " ".join(
                f"{stage}={seconds * 1000:.2f}ms"
                for stage, seconds in trace.stages
            )
            self.log(
                f"slow request trace={trace.trace_id} kind={trace.kind} "
                f"status={status} total={total * 1000:.2f}ms {breakdown}"
                + (f" spans={len(trace.spans)}" if trace.spans else "")
            )
        if self.flight is not None:
            try:
                self.flight.request(
                    trace.trace_id, trace.kind, int(status), total,
                    trace.stages,
                )
            except Exception:  # avdb: noqa[AVDB602] -- the flight recorder must never fail the request it records
                pass

    def background(self, name: str, seconds: float, meta=None) -> None:
        """One background-track span (the module sink's target): same
        ring, kind ``background``, plus the background stage histogram and
        a flight-recorder event."""
        t0_ns = time.perf_counter_ns() - int(seconds * 1e9)
        record = ("-", "background", 0, t0_ns, float(seconds),
                  (("background", float(seconds)),),
                  ((name, float(seconds)),))
        self._ring[next(self._seq) % self.slots] = record
        h = self._hist.get("background")
        if h is not None:
            h.observe(seconds)
        if self.flight is not None:
            try:
                detail = f"{name} {seconds * 1000:.1f}ms"
                if meta:
                    detail += " " + ",".join(
                        f"{k}={v}" for k, v in sorted(meta.items())
                    )
                self.flight.event("background", detail)
            except Exception:  # avdb: noqa[AVDB602] -- the flight recorder must never fail the writer it records
                pass

    # -- export -------------------------------------------------------------

    def records(self) -> list[tuple]:
        """Finished-request records, oldest-first best effort.  The copy
        races in-flight writers by design: each slot is either one record
        or another, never torn (immutable tuples, atomic item reads)."""
        snap = list(self._ring)
        return sorted(
            (r for r in snap if r is not None), key=lambda r: r[3]
        )

    def chrome_events(self, base_ns: int | None = None) -> list[dict]:
        """The ring as Chrome trace events: requests on one named track,
        background spans on another, stages as nested complete (``X``)
        events, timed from ``base_ns`` (the recorder's own start by
        default)."""
        base = self.t0_ns if base_ns is None else int(base_ns)
        pid = os.getpid()
        req_tid, bg_tid = 1, 2
        events: list[dict] = [
            {"ph": "M", "name": "thread_name", "pid": pid, "tid": req_tid,
             "ts": 0, "args": {"name": "requests"}},
            {"ph": "M", "name": "thread_name", "pid": pid, "tid": bg_tid,
             "ts": 0, "args": {"name": "background"}},
        ]
        for trace_id, kind, status, t0_ns, total, stages, spans \
                in self.records():
            tid = bg_tid if kind == "background" else req_tid
            ts = (t0_ns - base) / 1000.0
            args = {"trace_id": trace_id, "status": status}
            events.append({
                "ph": "X", "name": kind, "cat": "request", "pid": pid,
                "tid": tid, "ts": ts, "dur": total * 1e6, "args": args,
            })
            at = ts
            for stage, seconds in stages:
                events.append({
                    "ph": "X", "name": stage, "cat": "stage", "pid": pid,
                    "tid": tid, "ts": at, "dur": seconds * 1e6,
                    "args": {"trace_id": trace_id},
                })
                at += seconds * 1e6
            for name, seconds in spans:
                events.append({
                    "ph": "X", "name": name, "cat": "span", "pid": pid,
                    "tid": tid, "ts": ts, "dur": seconds * 1e6,
                    "args": {"trace_id": trace_id},
                })
        return events
