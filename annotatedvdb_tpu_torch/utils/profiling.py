"""Per-stage timers, device occupancy, stall summary, device trace
capture, bulk-load GC pause.

Port of ``annotatedvdb_tpu/utils/profiling.py``: :class:`StageTimer`
attributes host busy seconds to named stages (ingest / dispatch /
annotate / lookup / egress / build / append / persist / maintain) on
whichever thread runs them, so under the overlapped executor ``sum(stages)
> wall`` is the sign of overlap, and mirrors each span onto a host
:class:`~annotatedvdb_tpu_torch.obs.trace.Tracer` when one is attached;
:class:`DeviceOccupancy` turns per-chunk device in-flight windows into the
device idle fraction; :func:`stall_summary` renders the queue-stall table;
:func:`device_trace` wraps ``torch.profiler`` so ``load-vcf --profile
<dir>`` writes a Chrome trace viewable in Perfetto or TensorBoard;
:func:`bulk_load_gc` suspends the cyclic collector for a load.  Device
time is not in the stage numbers: CUDA work is asynchronous and is charged
to the stage that waits for it (``annotate``).
"""

from __future__ import annotations

import contextlib
import os
import threading
import time


class StageTimer:
    """Accumulates busy seconds + item counts per named stage, plus the
    wall-clock of the enclosing run.

    Usage::

        with timer.wall():                      # once around the whole load
            with timer.stage("annotate", items=batch.n):
                ...

    Stages may run CONCURRENTLY on pipeline threads, so accumulation is
    lock-guarded and per-stage seconds are *busy* time, not exclusive
    wall-clock: with real overlap ``total()`` exceeds ``wall_seconds``,
    and ``overlap()`` reports that ratio.
    """

    def __init__(self, clock=time.perf_counter):
        self._clock = clock
        self._lock = threading.Lock()
        self.seconds: dict[str, float] = {}
        self.items: dict[str, int] = {}
        #: wall-clock of the runs wrapped in ``wall()`` (accumulates across
        #: files like the per-stage counters do)
        self.wall_seconds: float = 0.0
        #: optional :class:`annotatedvdb_tpu_torch.obs.trace.Tracer`; when
        #: set, every stage span is mirrored as a B/E trace-event pair on
        #: the thread that ran it (and every ``wall()`` as a ``load`` span)
        self.tracer = None

    @contextlib.contextmanager
    def stage(self, name: str, items: int = 0):
        tracer = self.tracer
        if tracer is not None:
            tracer.begin(name)
        t0 = self._clock()
        try:
            yield
        finally:
            dt = self._clock() - t0
            with self._lock:
                self.seconds[name] = self.seconds.get(name, 0.0) + dt
                self.items[name] = self.items.get(name, 0) + items
            if tracer is not None:
                tracer.end(name)

    @contextlib.contextmanager
    def wall(self):
        """Record one run's wall-clock (the denominator of ``overlap()``)."""
        tracer = self.tracer
        if tracer is not None:
            tracer.begin("load")
        t0 = self._clock()
        try:
            yield
        finally:
            dt = self._clock() - t0
            with self._lock:
                self.wall_seconds += dt
            if tracer is not None:
                tracer.end("load")

    def total(self) -> float:
        with self._lock:
            return sum(self.seconds.values())

    def overlap(self) -> float | None:
        """Busy-seconds / wall-seconds across all recorded runs, or None
        when no wall window was recorded.  1.0 = fully serial; >1.0 = the
        pipeline ran stages concurrently."""
        with self._lock:
            wall = self.wall_seconds
            busy = sum(self.seconds.values())
        if not wall:
            return None
        return busy / wall

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

    def as_dict(self) -> dict:
        with self._lock:
            return {
                name: {
                    "seconds": round(self.seconds[name], 4),
                    "items": self.items.get(name, 0),
                }
                for name in self.seconds
            }

    def wall_dict(self) -> dict:
        """Wall vs busy accounting: per-stage seconds are busy time on
        their pipeline thread; ``overlap`` > 1 shows stages ran
        concurrently."""
        with self._lock:
            busy = sum(self.seconds.values())
            wall = self.wall_seconds
        out = {
            "wall_seconds": round(wall, 4),
            "busy_seconds": round(busy, 4),
        }
        if wall:
            out["overlap"] = round(busy / wall, 3)
        return out


class DeviceOccupancy:
    """Union coverage of per-chunk device in-flight windows.

    Each dispatched chunk contributes the interval [enqueue, results
    ready] — the window in which its device work can be executing.  The
    union of those intervals over the load, divided by the load's wall,
    approximates device occupancy from the host side; ``idle_fraction`` is
    its complement.  The window includes queue wait, so it over-counts
    busy and the idle fraction is a LOWER bound on true device idleness.

    ``record`` is called from one thread (the process stage) in
    completion order; starts may come out of order under shuffled
    scheduling, so they are clamped to the high-water mark of closed
    coverage (never double-counted)."""

    __slots__ = ("busy_s", "_start", "_end")

    def __init__(self):
        self.busy_s = 0.0
        self._start = None  # currently-open merged interval
        self._end = 0.0

    def record(self, t0: float, t1: float) -> None:
        if t1 <= t0:
            return
        if self._start is None:
            self._start, self._end = t0, t1
            return
        if t0 <= self._end:  # overlaps/extends the open interval
            if t1 > self._end:
                self._end = t1
        else:  # gap: close the open interval, start a new one
            self.busy_s += self._end - self._start
            self._start = max(t0, self._end)
            self._end = t1

    def total(self) -> float:
        """Union busy seconds recorded so far."""
        if self._start is None:
            return self.busy_s
        return self.busy_s + (self._end - self._start)

    def idle_fraction(self, wall_seconds: float) -> float:
        """1 - busy/wall, clamped to [0, 1]; 0.0 when no wall elapsed."""
        if wall_seconds <= 0:
            return 0.0
        return max(0.0, min(1.0, 1.0 - self.total() / wall_seconds))


def stall_summary(queue_stalls: dict, wall_seconds: float | None = None) -> str:
    """Human line for the backpressure accounting (``StageStats`` dicts
    keyed by boundary name): blocked = the boundary's consumer is the
    bottleneck, starved = its producer starved the consumer.  With a wall
    window each side is also a share of the wall."""
    parts = []
    for name, rec in (queue_stalls or {}).items():
        blocked = rec.get("producer_block_s", 0.0)
        waited = rec.get("consumer_wait_s", 0.0)
        bits = []
        if blocked >= 0.005:
            b = f"blocked {blocked:.2f}s"
            if wall_seconds:
                b += f" ({100 * blocked / wall_seconds:.0f}% of wall)"
            bits.append(b)
        if waited >= 0.005:
            w = f"starved {waited:.2f}s"
            if wall_seconds:
                w += f" ({100 * waited / wall_seconds:.0f}% of wall)"
            bits.append(w)
        if not bits:
            bits.append("no stalls")
        parts.append(f"{name}: " + ", ".join(bits))
    return " | ".join(parts) if parts else "no stage queues ran"


@contextlib.contextmanager
def device_trace(trace_dir: str | None, device=None):
    """``torch.profiler`` capture into ``trace_dir`` when it is set; a
    no-op otherwise.

    Records the CPU activity of every thread (the VCF load launches from
    its dispatch thread, and the profiler records only the opening
    thread's operators unless asked for all) and, when ``device`` is a
    CUDA device, the CUDA activity too (kernels, copies), then writes one
    Chrome trace, ``<host>.<pid>.pt.trace.json``, into the directory.
    There is no fallback: a CUDA capture the profiler cannot record
    raises instead of leaving a CPU-only trace.
    """
    if not trace_dir:
        yield
        return
    import socket

    import torch
    from torch._C._profiler import _ExperimentalConfig
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, supported_activities

    activities = [ProfilerActivity.CPU]
    cuda = device is not None and torch.device(device).type == "cuda"
    if cuda:
        if ProfilerActivity.CUDA not in supported_activities():
            raise RuntimeError(
                "--profile: torch.profiler cannot record CUDA activity here"
            )
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities, experimental_config=_ExperimentalConfig(
            profile_all_threads=True)) as prof:
        yield
        if cuda:
            torch.cuda.synchronize(device)
    if cuda and not any(e.device_type() == DeviceType.CUDA
                        for e in prof.profiler.kineto_results.events()):
        raise RuntimeError(
            "--profile: torch.profiler recorded no CUDA activity"
        )
    prof.export_chrome_trace(os.path.join(
        trace_dir, f"{socket.gethostname()}.{os.getpid()}.pt.trace.json"
    ))


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
