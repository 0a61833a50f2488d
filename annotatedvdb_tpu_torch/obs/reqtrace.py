"""Request-scoped tracing: per-stage spans of one request.

Port of ``annotatedvdb_tpu/obs/reqtrace.py``, trimmed to what the engine,
the batcher and the threaded handler call: :func:`activate` and
:func:`span_active` (engine sub-spans onto the calling thread's trace),
and :class:`TraceRecorder` with ``begin`` (a :class:`RequestTrace`, or None
when ``AVDB_TRACE_SAMPLE`` disarms recording — the no-op path every caller
guards on) and ``finish`` (the ``avdb_stage_seconds`` histograms and the
``AVDB_TRACE_SLOW_MS`` slow-request log).  The span ring, its Chrome-trace
export (``/debug/trace``), the flight recorder feed and the background
sinks are not ported.
"""

from __future__ import annotations

import contextlib
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


class TraceRecorder:
    """Per-process span recording: the stage histograms and the
    slow-request log."""

    def __init__(self, registry=None, slow_ms: float | None = None,
                 sample: float | None = None, log=None):
        self.slow_s = (
            slow_ms_from_env() if slow_ms is None else max(float(slow_ms), 0.0)
        ) / 1000.0
        self.sample = (
            sample_from_env() if sample is None
            else min(max(float(sample), 0.0), 1.0)
        )
        self.log = log if log is not None else (lambda msg: None)
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
        """Seal one request's trace: feed the stage histograms and log it
        when slow."""
        if trace is None:
            return
        total = (time.perf_counter_ns() - trace.t0_ns) / 1e9
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
