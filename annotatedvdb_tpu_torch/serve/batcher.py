"""Request coalescing: continuous batching for concurrent point lookups.

Port of ``annotatedvdb_tpu/serve/batcher.py``.  Concurrent HTTP handler
threads each carry one point query; the batcher's drain thread pulls the
first pending query, waits up to a deadline for company, executes the
whole microbatch through ``QueryEngine.lookup_many`` (one vectorized probe
per chromosome group) and hands each caller its own result.

``submit`` blocks its handler thread for the answer; ``submit_nowait``
returns the pending at once and runs a completion callback on the drain
thread (the aio front end's path when it is given this batcher instead of
its loop-native one).

Knobs (env defaults, overridable per instance): ``AVDB_SERVE_BATCH_MAX``
(256), ``AVDB_SERVE_BATCH_WAIT_MS`` (2), ``AVDB_SERVE_MAX_QUEUE`` (1024,
the 429 admission bound); :func:`resolve_regions_knobs` and
:func:`resolve_stats_knobs` resolve the batch caps and device minimums of
``POST /regions`` and ``POST /stats/region``.  Queries are grammar-checked
at ``submit``, so a malformed id fails only its own caller.  With a
``tracer`` (``serve --traceOut``) each drained microbatch is one
``serve.batch`` span.  The
``serve.batch`` fault point fires before each assembled microbatch runs
(here and in the ``aio`` front end's loop batcher).
"""

from __future__ import annotations

import contextlib
import os
import queue
import threading
import time

from annotatedvdb_tpu_torch.serve.engine import parse_variant_id
from annotatedvdb_tpu_torch.serve.resilience import DeadlineExceeded
from annotatedvdb_tpu_torch.utils import faults
from annotatedvdb_tpu_torch.utils.pipeline import StageStats
from annotatedvdb_tpu_torch.utils.locks import make_lock

#: batch-fill histogram edges (fraction of max_batch actually used)
BATCH_FILL_EDGES = (0.05, 0.1, 0.25, 0.5, 0.75, 0.9, 1.0)


class QueueFull(RuntimeError):
    """Admission rejection: the pending-query queue is at capacity.  The
    HTTP front end maps this to 429 + Retry-After."""


def resolve_batch_knobs(max_batch, max_wait_s, max_queue):
    """Fill ``None`` knobs from ``AVDB_SERVE_BATCH_MAX`` /
    ``_BATCH_WAIT_MS`` / ``_MAX_QUEUE`` and clamp — the ONE place the env
    defaults live, so both batchers (and therefore both front ends)
    resolve identically."""
    if max_batch is None:
        max_batch = int(os.environ.get("AVDB_SERVE_BATCH_MAX", "") or 256)
    if max_wait_s is None:
        max_wait_s = int(
            os.environ.get("AVDB_SERVE_BATCH_WAIT_MS", "") or 2
        ) / 1000.0
    if max_queue is None:
        max_queue = int(os.environ.get("AVDB_SERVE_MAX_QUEUE", "") or 1024)
    return (max(int(max_batch), 1), max(float(max_wait_s), 0.0),
            max(int(max_queue), 0))


def resolve_regions_knobs(regions_max, device_min):
    """The region-microbatching knobs, resolved in ONE place (the same
    contract as :func:`resolve_batch_knobs` — both front ends and the
    engine must see identical env defaults):

    - ``AVDB_SERVE_REGIONS_MAX``        — max query intervals per
      ``POST /regions`` batch (default 4096; an over-cap batch is a 400,
      never an unbounded device call);
    - ``AVDB_SERVE_REGIONS_DEVICE_MIN`` — min intervals per chromosome
      group before the batched BITS kernel engages (default 32: smaller
      groups — including every single ``GET /region`` — take the
      byte-identical host searchsorted twin, which beats a device
      dispatch at that size; 0 sends every group to the device).
    """
    if regions_max is None:
        regions_max = int(
            os.environ.get("AVDB_SERVE_REGIONS_MAX", "") or 4096
        )
    if device_min is None:
        device_min = int(
            os.environ.get("AVDB_SERVE_REGIONS_DEVICE_MIN", "") or 32
        )
    return max(int(regions_max), 1), max(int(device_min), 0)


def resolve_stats_knobs(stats_max, device_min):
    """The analytics-panel knobs, resolved in ONE place (the
    :func:`resolve_batch_knobs` contract — both front ends and the
    engine must see identical env defaults):

    - ``AVDB_SERVE_STATS_MAX``        — max query intervals per
      ``POST /stats/region`` batch (default 4096; an over-cap batch is
      a 400, never an unbounded device call);
    - ``AVDB_SERVE_STATS_DEVICE_MIN`` — min intervals per chromosome
      group before the fused stats kernel engages (default 16: smaller
      panels take the byte-identical host twin — a stats panel already
      amortizes its prefix sums over the whole group, so the dispatch
      pays off earlier than the span search's 32; 0 sends every group
      to the device).
    """
    if stats_max is None:
        stats_max = int(
            os.environ.get("AVDB_SERVE_STATS_MAX", "") or 4096
        )
    if device_min is None:
        device_min = int(
            os.environ.get("AVDB_SERVE_STATS_DEVICE_MIN", "") or 16
        )
    return max(int(stats_max), 1), max(int(device_min), 0)


class _Pending:
    """One caller's query in flight: the drain thread fills ``result`` or
    ``error`` then sets ``done`` (the Event publishes the write).  An
    optional ``callback`` runs (on the drain thread) after ``done`` is
    set — the aio front end's completion hook, so an event loop never
    parks a thread on the Event.  ``deadline_t`` (absolute
    ``time.monotonic`` seconds, or None) is the request's remaining-budget
    bound: the drain sheds already-dead pendings before device work."""

    __slots__ = ("qid", "parsed", "result", "error", "done", "callback",
                 "deadline_t", "trace", "t_enq")

    def __init__(self, qid: str, parsed=None, callback=None,
                 want_event: bool = True, deadline_t: float | None = None,
                 trace=None):
        self.qid = qid
        self.parsed = parsed  # submit-time parse, reused by the drain
        self.result = None
        self.error: BaseException | None = None
        # callback-style waiters never wait on the Event: skip it there
        self.done = threading.Event() if want_event else None
        self.callback = callback
        self.deadline_t = deadline_t
        #: request-trace scratchpad (obs/reqtrace.py) — the drain
        #: attributes queue-wait and device time to it; None when the
        #: request is unsampled (zero tracing work downstream)
        self.trace = trace
        self.t_enq = time.perf_counter() if trace is not None else 0.0

    def finish(self) -> None:
        """Publish the filled result/error to the waiter."""
        if self.done is not None:
            self.done.set()
        if self.callback is not None:
            try:
                self.callback(self)
            except Exception:  # avdb: noqa[AVDB602] -- a waiter's completion hook must never take down the shared drain thread
                pass


class QueryBatcher:
    """Drains concurrent single-query submissions into padded microbatches."""

    def __init__(self, engine, max_batch: int | None = None,
                 max_wait_s: float | None = None,
                 max_queue: int | None = None,
                 tracer=None, registry=None, timeout_s: float = 30.0):
        self.engine = engine
        self.max_batch, self.max_wait_s, self.max_queue = \
            resolve_batch_knobs(max_batch, max_wait_s, max_queue)
        self.timeout_s = timeout_s
        self.tracer = tracer
        #: admission-queue accounting (items per drain, idle wait, depth
        #: high-water) — same shape the pipeline boundaries report
        self.stats = StageStats("serve.batch")
        self._q: queue.Queue = queue.Queue()
        self._stop = threading.Event()
        self._lock = make_lock("serve.batcher.stats")
        #: guarded by self._lock
        self._batches = 0
        #: guarded by self._lock
        self._queries = 0
        if registry is not None:
            self._m_batches = registry.counter(
                "avdb_serve_batches_total", "batcher drains executed"
            )
            self._m_fill = registry.histogram(
                "avdb_serve_batch_fill", BATCH_FILL_EDGES,
                "fraction of max_batch used per drain",
            )
            self._m_depth = registry.gauge(
                "avdb_serve_queue_depth", "pending queries awaiting a drain"
            )
            self._m_deadline_shed = registry.counter(
                "avdb_deadline_shed_total",
                "requests shed because their deadline budget ran out",
                {"stage": "batcher"},
            )
        else:
            self._m_batches = self._m_fill = self._m_depth = None
            self._m_deadline_shed = None
        self._thread = threading.Thread(
            target=self._run, name="avdb-serve-batcher", daemon=True
        )
        self._thread.start()

    # -- caller side --------------------------------------------------------

    def depth(self) -> int:
        """Pending (undrained) queries — the admission gauge."""
        return self._q.qsize()

    def submit(self, variant_id: str, deadline_t: float | None = None,
               trace=None):
        """Enqueue one point query and block for its result (JSON text or
        None).  Raises :class:`QueueFull` at the admission bound,
        :class:`~annotatedvdb_tpu_torch.serve.engine.QueryError` on bad
        grammar (validated here, before the queue),
        :class:`~annotatedvdb_tpu_torch.serve.resilience.DeadlineExceeded` once
        the request's budget lapses (the drain sheds the queued pending —
        its admission slot releases — and this caller stops waiting), or
        the drain's root cause."""
        pending = self.submit_nowait(variant_id, deadline_t=deadline_t,
                                     trace=trace)
        wait_s = self.timeout_s
        if deadline_t is not None:
            wait_s = min(wait_s, max(deadline_t - time.monotonic(), 0.0))
        if not pending.done.wait(wait_s):
            if deadline_t is not None and time.monotonic() >= deadline_t:
                # the queued pending is now dead weight: the next drain
                # sheds it (counted there), nobody waits on its Event
                raise DeadlineExceeded(
                    f"query {variant_id!r} exceeded its deadline in the "
                    "serve queue"
                )
            raise TimeoutError(
                f"query {variant_id!r} timed out after {self.timeout_s}s "
                "in the serve batcher"
            )
        if pending.error is not None:
            raise pending.error
        return pending.result

    def submit_nowait(self, variant_id: str, callback=None,
                      want_event: bool = True,
                      deadline_t: float | None = None,
                      trace=None) -> _Pending:
        """Enqueue one point query without blocking for the result: the
        admission and grammar contract of :meth:`submit` applies here, in
        the caller (``QueueFull`` / ``QueryError`` raise), then the
        returned pending completes on the drain thread, where
        ``callback`` (if given) runs after the result publishes.  An event
        loop passes ``want_event=False``: nothing waits on the Event."""
        if self._stop.is_set():
            raise RuntimeError("batcher is closed")
        # grammar errors stay with this caller; the parse is kept for the
        # drain so the engine never re-parses a microbatch
        parsed = parse_variant_id(variant_id)
        if self._q.qsize() >= self.max_queue:
            raise QueueFull(
                f"serve queue full ({self.max_queue} pending queries)"
            )
        pending = _Pending(variant_id, parsed, callback, want_event,
                           deadline_t, trace)
        self._q.put(pending)
        return pending

    def drain_stats(self) -> dict:
        """Lifetime coalescing summary (the bench's batch-fill source)."""
        with self._lock:
            batches, queries = self._batches, self._queries
        return {
            "batches": batches,
            "queries": queries,
            "batch_fill": round(
                queries / (batches * self.max_batch), 4
            ) if batches else 0.0,
            "queue": self.stats.as_dict(),
        }

    def close(self, timeout: float = 5.0) -> None:
        """Stop the drain thread; queued-but-undrained queries fail with a
        closed error rather than hang their callers."""
        self._stop.set()
        self._thread.join(timeout=timeout)
        self._fail_queued(RuntimeError("serve batcher closed"))

    # -- drain thread -------------------------------------------------------

    def _run(self) -> None:
        q, stats = self._q, self.stats
        while True:
            t0 = time.perf_counter()
            try:
                first = q.get(timeout=0.05)
            except queue.Empty:
                stats.consumer_wait_s += time.perf_counter() - t0
                if self._stop.is_set():
                    return
                continue
            batch = [first]
            deadline = time.perf_counter() + self.max_wait_s
            while len(batch) < self.max_batch:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                try:
                    batch.append(q.get(timeout=remaining))
                except queue.Empty:
                    break
            depth = q.qsize()
            if depth > stats.max_depth:
                stats.max_depth = depth
            self._drain(batch)
            if self._stop.is_set():
                self._fail_queued(RuntimeError("serve batcher closed"))
                return

    def _drain(self, batch: list) -> None:
        stats = self.stats
        stats.items += len(batch)
        batch = self._shed_expired(batch)
        if not batch:
            return
        t_exec = time.perf_counter()
        try:
            # crash point: the microbatch is assembled, nothing executed —
            # a failure here must fail exactly this batch's callers and
            # leave the drain thread serving
            faults.fire("serve.batch")
            span = (
                self.tracer.span("serve.batch", n=len(batch))
                if self.tracer is not None else contextlib.nullcontext()
            )
            with span:
                results = self.engine.lookup_many(
                    [p.qid for p in batch], parsed=[p.parsed for p in batch],
                )
        except Exception as exc:
            for pending in batch:
                pending.error = exc
                pending.finish()
            return
        dt_device = time.perf_counter() - t_exec
        for pending, result in zip(batch, results):
            if pending.trace is not None:
                # queue-wait = enqueue -> drain execution; device = the
                # whole microbatch's engine time (co-batched requests
                # share the span, the continuous-batching reality)
                pending.trace.add("queue", t_exec - pending.t_enq)
                pending.trace.add("device", dt_device)
            pending.result = result
            pending.finish()
        with self._lock:
            self._batches += 1
            self._queries += len(batch)
        if self._m_batches is not None:
            self._m_batches.inc()
            self._m_fill.observe(len(batch) / self.max_batch)
            self._m_depth.set(self._q.qsize())

    def _shed_expired(self, batch: list) -> list:
        """Drop already-dead pendings BEFORE device work: their callers
        stopped waiting, so executing them only delays live requests.
        Each shed pending fails with :class:`DeadlineExceeded` (a caller
        still blocked in ``submit`` — clock skew between its wait and
        this check — gets the honest 504 cause)."""
        now = time.monotonic()
        live = []
        shed = 0
        for pending in batch:
            if pending.deadline_t is not None and now >= pending.deadline_t:
                pending.error = DeadlineExceeded(
                    f"query {pending.qid!r} exceeded its deadline in the "
                    "serve queue"
                )
                pending.finish()
                shed += 1
            else:
                live.append(pending)
        if shed and self._m_deadline_shed is not None:
            self._m_deadline_shed.inc(shed)
        return live

    def _fail_queued(self, error: BaseException) -> None:
        while True:
            try:
                pending = self._q.get_nowait()
            except queue.Empty:
                return
            pending.error = error
            pending.finish()
