"""Host-side pipeline plumbing: bounded background stages.

Copy of ``annotatedvdb_tpu/utils/pipeline.py``.  The overlapped VCF load
(``loaders/vcf_loader.py``) runs ingest, dispatch and process as
concurrent stages, and the VEP load's block reader (``io/prefetch.py``)
runs on one.  A :class:`BoundedStage` is a daemon thread that pulls items
from its source iterator, applies a stage function, and hands results
downstream through a bounded queue — a full queue is backpressure (the
producer blocks), so a fast reader can never race an unbounded pile of
chunks into memory.

Contract:

- items flow strictly in order (one worker, FIFO queue) — the executor's
  byte-for-byte parity with the serial path depends on this;
- an exception upstream travels the queue and re-raises at the consumer's
  ``next()``, never dies silently on a daemon thread;
- ``close()`` stops the producer promptly even mid-``put`` (the put loop
  polls a stop event), drains, and joins — safe to call repeatedly.

:class:`Resequencer` restores source order over ``(seq, item)`` pairs
that a shuffled prefetcher emits out of order.
"""

from __future__ import annotations

import queue
import threading
import time

_END = object()


class StageStats:
    """Backpressure accounting for one stage boundary.

    ``producer_block_s`` is cumulative seconds the stage thread spent
    blocked on a FULL downstream queue (the consumer is the bottleneck);
    ``consumer_wait_s`` is cumulative seconds the consumer spent waiting on
    an EMPTY queue (this stage is the bottleneck).  Granularity is per
    item — items are whole blocks, so two clock reads per block.

    Thread-safety by partition, not locks: the producer-side fields
    (``items``, ``producer_block_s``, ``max_depth``) are only written by
    the stage thread, ``consumer_wait_s`` only by the consuming thread.
    Reads from other threads (summaries after ``close()``) see a settled
    value; a mid-run read is a monotone snapshot, good enough for gauges.
    """

    __slots__ = ("name", "items", "producer_block_s", "consumer_wait_s",
                 "max_depth")

    def __init__(self, name: str = "stage"):
        self.name = name
        self.items = 0
        self.producer_block_s = 0.0
        self.consumer_wait_s = 0.0
        self.max_depth = 0

    def as_dict(self) -> dict:
        return {
            "items": self.items,
            "producer_block_s": round(self.producer_block_s, 4),
            "consumer_wait_s": round(self.consumer_wait_s, 4),
            "max_depth": self.max_depth,
        }


def merge_stage_stats(table: dict, name: str, stats: "StageStats") -> None:
    """Fold one settled boundary's :class:`StageStats` into a cumulative
    ``queue_stalls`` table (one per loader) — loads accumulate across
    files, so the table sums rather than replaces."""
    rec = table.setdefault(name, {
        "items": 0, "producer_block_s": 0.0, "consumer_wait_s": 0.0,
        "max_depth": 0,
    })
    d = stats.as_dict()
    rec["items"] += d["items"]
    rec["producer_block_s"] = round(
        rec["producer_block_s"] + d["producer_block_s"], 4
    )
    rec["consumer_wait_s"] = round(
        rec["consumer_wait_s"] + d["consumer_wait_s"], 4
    )
    rec["max_depth"] = max(rec["max_depth"], d["max_depth"])


class _StageError:
    """Exception envelope: raised at the consumer, not on the stage thread."""

    __slots__ = ("exc",)

    def __init__(self, exc: BaseException):
        self.exc = exc


class BoundedStage:
    """One pipeline stage on a daemon thread.

    ``source`` is any iterator (often another stage), consumed on the
    stage's thread; ``fn`` maps each item (identity when None).  At most
    ``depth`` results sit unconsumed before the producer blocks.
    """

    def __init__(self, source, fn=None, depth: int = 2, name: str = "stage"):
        self._fn = fn
        self._q: queue.Queue = queue.Queue(maxsize=max(1, depth))
        self._stop = threading.Event()
        self._done = False
        # protects the first-error-wins update below: the stage thread and
        # a concurrent close() can both discover the error (the thread as
        # it raises, close() as it drains the envelope) — without the lock,
        # two check-then-set writers could both pass the `is None` check
        self._lock = threading.Lock()
        #: first exception raised on the stage thread, preserved even when
        #: its _StageError envelope never reaches the consumer (dropped by a
        #: concurrent close(), or the thread died while the stop flag was
        #: set) — abort paths report the root cause, not a generic teardown.
        #: guarded by self._lock
        self.error: BaseException | None = None
        #: backpressure accounting (always on: two clock reads per block)
        self.stats = StageStats(name)
        self._thread = threading.Thread(
            target=self._run, args=(source,), name=f"avdbc-{name}",
            daemon=True,
        )
        self._thread.start()

    def depth(self) -> int:
        """Current unconsumed-item count (the queue-depth gauge)."""
        return self._q.qsize()

    def _put(self, item) -> bool:
        """Blocking put that stays responsive to ``close()``; time spent
        blocked on a full queue lands in ``stats.producer_block_s``."""
        stats = self.stats
        is_data = item is not _END and not isinstance(item, _StageError)
        try:
            self._q.put_nowait(item)  # fast path: no clock read when open
            if is_data:
                stats.items += 1
                d = self._q.qsize()
                if d > stats.max_depth:
                    stats.max_depth = d
            return True
        except queue.Full:
            pass
        t0 = time.perf_counter()
        try:
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.05)
                    if is_data:
                        stats.items += 1
                        stats.max_depth = max(
                            stats.max_depth, self._q.qsize()
                        )
                    return True
                except queue.Full:
                    continue
            return False
        finally:
            stats.producer_block_s += time.perf_counter() - t0

    def _run(self, source) -> None:
        try:
            for item in source:
                if self._stop.is_set():
                    return
                if self._fn is not None:
                    item = self._fn(item)
                if not self._put(item):
                    return
            self._put(_END)
        except BaseException as exc:  # re-raised at the consumer
            # record BEFORE the put: if close() races us (stop set, the put
            # returns False and the envelope is dropped), the root cause
            # still survives on self.error
            with self._lock:
                if self.error is None:
                    self.error = exc
            self._put(_StageError(exc))

    def __iter__(self):
        return self

    def __next__(self):
        # polling get, never a bare blocking one: when the producer is torn
        # down (close() stops the thread without a terminal sentinel), this
        # consumer must observe that within one poll interval instead of
        # blocking forever.  Time spent on an EMPTY
        # queue is this stage starving its consumer: it accumulates in
        # ``stats.consumer_wait_s`` (one clock read pair per wait episode,
        # none on the fast path).
        if self._done or self._stop.is_set():
            raise StopIteration
        try:
            item = self._q.get_nowait()
        except queue.Empty:
            t0 = time.perf_counter()
            try:
                while True:
                    if self._done or self._stop.is_set():
                        raise StopIteration
                    try:
                        item = self._q.get(timeout=0.05)
                    except queue.Empty:
                        if not self._thread.is_alive():
                            # producer gone without _END: closed upstream —
                            # or CRASHED with its error envelope dropped.
                            # Silently stopping would truncate the stream
                            # and report success; surface the root cause
                            self._done = True
                            with self._lock:
                                err = self.error
                            if err is not None:
                                raise err
                            raise StopIteration
                        continue
                    break
            finally:
                self.stats.consumer_wait_s += time.perf_counter() - t0
        if item is _END:
            self._done = True
            raise StopIteration
        if isinstance(item, _StageError):
            self._done = True
            raise item.exc
        return item

    def close(self, timeout: float = 10.0) -> bool:
        """Stop the producer and reclaim the thread (idempotent).  Pending
        items are discarded — callers own any cross-stage cleanup.

        Returns True when the thread is gone.  False means the source is
        stuck in a long uninterruptible call — the daemon thread is
        abandoned and will exit when that call returns and its next put or
        pull observes the stop flag."""
        self._stop.set()
        deadline = None
        while True:
            while True:  # unblock a producer waiting on a full queue
                try:
                    item = self._q.get_nowait()
                except queue.Empty:
                    break
                # a drained item may be the stage's error envelope — keep
                # the FIRST one on self.error instead of discarding it with
                # the data items (abort paths read it for the root cause)
                if isinstance(item, _StageError):
                    with self._lock:
                        if self.error is None:
                            self.error = item.exc
            self._thread.join(timeout=0.25)
            if not self._thread.is_alive():
                return True
            if deadline is None:
                deadline = time.monotonic() + timeout
            elif time.monotonic() >= deadline:
                return False


_MISSING = object()


class Resequencer:
    """Restore source order over a ``(seq, item)`` stream.

    Shuffled chunk scheduling (``io/prefetch.py``) lets order-independent
    stages (device dispatch) run chunks out of source order; everything
    order-bearing — identity first-wins, checkpoint cursors,
    ``--maxErrors`` accounting — sits downstream of this adapter, which
    holds early arrivals and releases items strictly by ascending ``seq``.
    Retention is bounded by the producer's shuffle window.

    ``seq`` values must be exactly ``0, 1, ...`` with no gaps —
    the prefetcher tags every scheduled chunk, including zero-row ones.
    ``held()`` is the current out-of-order retention (a gauge).
    """

    __slots__ = ("_source", "_next", "_held")

    def __init__(self, source):
        self._source = source
        self._next = 0
        self._held: dict = {}

    def held(self) -> int:
        return len(self._held)

    def __iter__(self):
        return self

    def __next__(self):
        while True:
            item = self._held.pop(self._next, _MISSING)
            if item is not _MISSING:
                self._next += 1
                return item
            # StopIteration (and any upstream stage error) propagates; a
            # complete stream can never end with held items because seqs
            # are gapless, so nothing is silently dropped here
            seq, payload = next(self._source)
            if seq == self._next:
                self._next += 1
                return payload
            self._held[seq] = payload
