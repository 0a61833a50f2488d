"""Asyncio event-loop serving front end: the default ``serve`` front end.

Port of ``annotatedvdb_tpu/serve/aio.py`` for one process.  The
thread-per-connection front end (``serve/http.py``) spends a thread per
connection, and every handler thread's Python shares one interpreter
lock.  This front end is the same route surface on ONE event loop:
requests parse in-line, point lookups coalesce in a loop-native batcher
(:class:`LoopBatcher`, no cross-thread handoff) and a connection costs a
coroutine, not a thread.

**Pipelining.**  Connections are fully pipelined: the read loop keeps
parsing requests while earlier ones execute, and a per-connection writer
task emits responses strictly in request order (HTTP/1.1 semantics), up
to ``PIPELINE_DEPTH`` in flight per connection.

Route/status/body bytes are identical to the threaded front end and to
the reference's aio server; what this layer adds:

- **weighted per-client admission** — a token bucket per client key
  (``X-Client-Id`` header scoped to the peer address, at most
  ``PEER_KEY_CAP`` distinct id buckets per peer; no header means the peer
  bucket), refilling at ``AVDB_SERVE_CLIENT_RATE`` requests/sec times the
  client's declared ``X-Client-Weight`` (clamped to [1, 16]).  Over-rate
  clients get the queue bound's 429 + Retry-After; ``0`` (default)
  disables per-client limiting;
- **chunked region streaming** — region bodies above
  ``AVDB_SERVE_STREAM_THRESHOLD`` rows (default 2048) stream with
  ``Transfer-Encoding: chunked``, rows rendered lazily off a
  :class:`~annotatedvdb_tpu_torch.serve.engine.RegionPage`; cursor paging
  rides the same machinery;
- **coalesced snapshot freshness** — one manifest ``stat`` per
  ``AVDB_SERVE_SNAPSHOT_TTL_MS`` window, the (rare) generation load on the
  executor pool.

Bulk, region, ``/regions``, ``/stats/region`` and ``/export/stream`` run
on a four-thread executor pool; the engine's kernels (``bits_spans``,
``stats_panel``, ``export_pack``) launch from there, on the card unless
the caller asks for the CPU.  :func:`build_aio_server` wires the engine
exactly as ``serve/http.py::build_server`` does.

``POST /variants/upsert`` (``serve --upserts``) takes the bulk admission
shape; its WAL fsync runs on the pool, never on the loop, and the loop's
maintenance tick checks the memtable's flush triggers.  In a fleet worker
the tick also writes this worker's 24-byte heartbeat slot
(``serve/fleet.py::HB_SLOT``: beat time, p99-exceedance EWMA, brownout
level, queue depth) into the supervisor's mmap'd file, which the
wedged-worker watchdog reads.

The replication ship routes (``GET /repl/manifest``, ``/repl/segment``,
``/repl/wal``) read files, so they run on the pool through the threaded
server's shared builders; a follower's upserts answer the same 403 and
its ``/readyz`` the same lag gate (``serve/http.py``).

The health plane rides the same tick: this worker's metric snapshot is
published into the fleet telemetry directory (``--_telemetryDir``) for
any sibling's ``/metrics?fleet=1``, the flight recorder's buffered
request summaries are flushed, and the health plane (time-series sample,
SLO evaluation, history persist) ticks; each is pushed onto the executor
pool with at most one in flight, beside the panels.  ``GET /alerts`` and
its ``?fleet=1`` view, ``GET /metrics/history`` and ``/metrics?fleet=1``
answer through the threaded server's shared payload functions (the file-reading
views on the pool).

The chaos plane (``AVDB_SERVE_CHAOS=1``): ``POST /_chaos {"spec": ...,
"ttl_s": ...}`` arms (or, with an empty spec, disarms) this process's
``AVDB_FAULT`` slot at run time, a ``ttl_s`` disarming it again on the
loop; ``GET /debug/trace`` dumps the span ring.  Without the variable
both answer the unknown-route 404.  Fault points here: ``serve.accept``
(per accepted connection), ``serve.wedge`` (per maintenance tick: a long
``delay`` parks the loop, which the fleet watchdog must kill) and
``serve.batch`` (per loop-batcher drain).  With ``--traceOut`` each
loop-batcher drain is one ``serve.batch`` span of the Chrome tracer.  With
``AVDB_SERVE_MESH`` resolving a mesh, the engine carries a
:class:`~annotatedvdb_tpu_torch.serve.mesh_exec.MeshExecutor`.
"""

from __future__ import annotations

import asyncio
import contextlib
import json
import mmap
import os
import struct
import threading
import time
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from urllib.parse import unquote, urlparse

from annotatedvdb_tpu_torch.export.stream import (
    STREAM_ROUTE as EXPORT_STREAM_ROUTE,
)
from annotatedvdb_tpu_torch.export.stream import (
    parse_stream_query,
    stream_payload,
)
from annotatedvdb_tpu_torch.obs import reqtrace as reqtrace_mod
from annotatedvdb_tpu_torch.obs.metrics import MetricsRegistry
from annotatedvdb_tpu_torch.serve.batcher import QueueFull
from annotatedvdb_tpu_torch.serve.engine import (
    QueryEngine,
    QueryError,
    parse_variant_id,
)
from annotatedvdb_tpu_torch.serve.fleet import HB_SLOT
from annotatedvdb_tpu_torch.serve.http import (
    _RETURNED_RE,
    BULK_BODY_ERROR,
    HISTORY_ROUTE,
    MSG_BROWNOUT_BULK,
    MSG_BROWNOUT_EXPORT,
    MSG_BROWNOUT_REGION,
    MSG_BROWNOUT_STATS,
    MSG_BROWNOUT_UPSERT,
    MSG_CAPACITY_BULK,
    MSG_CAPACITY_EXPORT,
    MSG_CAPACITY_REGION,
    MSG_CAPACITY_STATS,
    MSG_CAPACITY_UPSERT,
    MSG_DEADLINE_ADMISSION,
    MSG_DEADLINE_EXECUTE,
    REGIONS_BODY_ERROR,
    REPL_MANIFEST_ROUTE,
    REPL_SEGMENT_ROUTE,
    REPL_WAL_ROUTE,
    STATS_BODY_ERROR,
    STATS_ROUTE,
    TRACE_HEADER,
    UPSERT_BODY_ERROR,
    UPSERT_ROUTE,
    ServeContext,
    alerts_payload,
    chaos_enabled_from_env,
    debug_trace_payload,
    healthz_payload,
    metrics_history_payload,
    metrics_payload,
    parse_region_params,
    parse_regions_body,
    parse_stats_body,
    readyz_payload,
    repl_file_response,
    repl_manifest_payload,
    resolve_trace_id,
    stats_payload,
)
from annotatedvdb_tpu_torch.serve.resilience import (
    DeadlineExceeded,
    DeviceBreaker,
)
from annotatedvdb_tpu_torch.serve.snapshot import SnapshotManager
from annotatedvdb_tpu_torch.utils import faults
from annotatedvdb_tpu_torch.utils.locks import make_lock

#: request body cap (bulk id lists); larger bodies are 413, never buffered
MAX_BODY = 1 << 26

#: max responses in flight per connection before the read loop stops
#: parsing (TCP backpressure to the client) — bounds per-connection memory
PIPELINE_DEPTH = 512

#: client-weight clamp: a header is a claim, not a blank check
MAX_CLIENT_WEIGHT = 16

#: response head templates (status line); bodies are JSON
_STATUS = {
    200: b"HTTP/1.1 200 OK\r\n",
    400: b"HTTP/1.1 400 Bad Request\r\n",
    403: b"HTTP/1.1 403 Forbidden\r\n",
    404: b"HTTP/1.1 404 Not Found\r\n",
    413: b"HTTP/1.1 413 Payload Too Large\r\n",
    429: b"HTTP/1.1 429 Too Many Requests\r\n",
    431: b"HTTP/1.1 431 Request Header Fields Too Large\r\n",
    500: b"HTTP/1.1 500 Internal Server Error\r\n",
    501: b"HTTP/1.1 501 Not Implemented\r\n",
    503: b"HTTP/1.1 503 Service Unavailable\r\n",
    504: b"HTTP/1.1 504 Gateway Timeout\r\n",
    507: b"HTTP/1.1 507 Insufficient Storage\r\n",
}

_CT_JSON = b"Content-Type: application/json\r\nContent-Length: "
_CT_TEXT = b"Content-Type: text/plain; version=0.0.4\r\nContent-Length: "
_CT_BIN = b"Content-Type: application/octet-stream\r\nContent-Length: "

#: rows rendered between flow-control drains while streaming a region
_STREAM_ROWS_PER_CHUNK = 256

#: coalescing-buffer bound for the per-connection writer: responses
#: batch into one transport write up to this many bytes, then flush —
#: a pipelined batch of large bulk responses must never accumulate
#: batch-count x response-size bytes before the first write
_WRITE_HIGH_WATER = 1 << 18


def _client_rate_from_env() -> float:
    """``AVDB_SERVE_CLIENT_RATE`` — admitted requests/sec per weight unit
    (0 disables per-client limiting)."""
    return max(float(os.environ.get("AVDB_SERVE_CLIENT_RATE", "") or 0), 0.0)


def _stream_threshold_from_env() -> int:
    """``AVDB_SERVE_STREAM_THRESHOLD`` — region row count above which the
    response streams chunked instead of buffering (default 2048)."""
    return max(
        int(os.environ.get("AVDB_SERVE_STREAM_THRESHOLD", "") or 2048), 0
    )


def _resp(status: int, body: str, retry_after: int | None = None,
          content_type: bytes = _CT_JSON) -> bytes:
    """One fully-formed HTTP/1.1 response."""
    payload = body.encode()
    head = _STATUS[status] + content_type + str(len(payload)).encode()
    if retry_after is not None:
        head += b"\r\nRetry-After: " + str(retry_after).encode()
    elif status in (429, 503):
        head += b"\r\nRetry-After: 1"
    return head + b"\r\n\r\n" + payload


def _error(status: int, message: str,
           retry_after: int | None = None) -> bytes:
    return _resp(status, json.dumps({"error": message}), retry_after)


_TRACE_HEADER_B = TRACE_HEADER.encode() + b": "


def _add_trace(resp: bytes, trace_id: str | None) -> bytes:
    """Splice the trace-id echo header into a fully-formed response —
    one insertion after the status line, so every route's prebuilt bytes
    gain the header without threading the id through ``_resp``'s thirty
    call sites."""
    if not trace_id:
        return resp
    i = resp.find(b"\r\n")
    if i < 0:
        return resp
    return (resp[:i + 2] + _TRACE_HEADER_B + trace_id.encode("latin-1")
            + b"\r\n" + resp[i + 2:])


def _status_of(resp: bytes) -> int:
    """The status code of a prebuilt response (``HTTP/1.1 NNN ...``) —
    the writer finishes exec traces centrally, and the bytes already
    know their status."""
    try:
        return int(resp[9:12])
    except ValueError:
        return 0

class LoopBatcher:
    """Loop-native continuous batching: the asyncio twin of
    :class:`~annotatedvdb_tpu_torch.serve.batcher.QueryBatcher`.

    The thread-based batcher costs every request two cross-thread
    handoffs (submit -> drain thread -> loop wakeup); on a host with as
    many hot threads as cores those handoffs are where tail latency goes
    to die — each one is a scheduler timeslice boundary.  Here the drain
    runs ON the event loop: submissions append to a list, a
    ``call_later(max_wait_s)`` timer (or a full batch) triggers the
    drain, and the engine executes the microbatch inline — a few
    milliseconds of loop occupancy buys zero handoffs, zero extra hot
    threads, and the same coalescing.

    API-compatible with the front end's use of ``QueryBatcher``:
    ``depth`` / ``max_queue`` / ``drain_stats`` / ``close`` and the batch
    metrics."""

    def __init__(self, engine, max_batch: int | None = None,
                 max_wait_s: float | None = None,
                 max_queue: int | None = None,
                 tracer=None, registry=None, timeout_s: float = 30.0):
        from annotatedvdb_tpu_torch.serve.batcher import resolve_batch_knobs

        self.engine = engine
        self.max_batch, self.max_wait_s, self.max_queue = \
            resolve_batch_knobs(max_batch, max_wait_s, max_queue)
        self.timeout_s = timeout_s
        self.tracer = tracer
        self._pending: list = []  # (future, qid, parsed), loop-only state
        self._timer = None
        self._drain_soon = False  # a call_soon(_drain) is already queued
        self._loop: asyncio.AbstractEventLoop | None = None
        self._closed = False
        self._batches = 0
        self._queries = 0
        self._max_depth = 0
        if registry is not None:
            from annotatedvdb_tpu_torch.serve.batcher import BATCH_FILL_EDGES

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

    # -- caller side (event loop only) --------------------------------------

    def depth(self) -> int:
        return len(self._pending)

    def submit_future(self, variant_id: str,
                      deadline_t: float | None = None,
                      trace=None) -> asyncio.Future:
        """Enqueue one point query; returns the future of its JSON text
        (or None).  Admission/grammar contract of ``QueryBatcher``:
        ``QueueFull`` / ``QueryError`` raise synchronously.  A pending
        whose ``deadline_t`` (absolute monotonic) lapses before its drain
        fails with ``DeadlineExceeded`` instead of occupying device
        work."""
        if self._closed:
            raise RuntimeError("batcher is closed")
        parsed = parse_variant_id(variant_id)
        if len(self._pending) >= self.max_queue:
            raise QueueFull(
                f"serve queue full ({self.max_queue} pending queries)"
            )
        if self._loop is None:
            self._loop = asyncio.get_running_loop()
        fut = self._loop.create_future()
        self._pending.append((
            fut, variant_id, parsed, deadline_t, trace,
            time.perf_counter() if trace is not None else 0.0,
        ))
        depth = len(self._pending)
        if depth > self._max_depth:
            self._max_depth = depth
        if depth >= self.max_batch:
            # one queued drain serves the whole burst: a second call_soon
            # here would leave an orphan handle behind that later fires
            # into a fresh single-item queue and defeats its max_wait
            # coalescing window
            if not self._drain_soon:
                if self._timer is not None:
                    self._timer.cancel()
                    self._timer = None
                self._drain_soon = True
                self._loop.call_soon(self._drain)
        elif self._timer is None and not self._drain_soon:
            self._timer = self._loop.call_later(self.max_wait_s, self._drain)
        return fut

    def _drain(self) -> None:
        self._drain_soon = False
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None
        if not self._pending:
            return
        batch, self._pending = (
            self._pending[: self.max_batch],
            self._pending[self.max_batch:],
        )
        if self._pending:  # backlog: keep draining without a fresh wait
            self._drain_soon = True
            self._loop.call_soon(self._drain)
        # shed already-dead pendings BEFORE device work: their clients
        # stopped waiting, so probing for them only delays live requests
        now = time.monotonic()
        live = []
        shed = 0
        for item in batch:
            fut, qid, _p, deadline_t, _t, _e = item
            if deadline_t is not None and now >= deadline_t:
                if not fut.done():
                    fut.set_exception(DeadlineExceeded(
                        f"query {qid!r} exceeded its deadline in the "
                        "serve queue"
                    ))
                shed += 1
            else:
                live.append(item)
        if shed and self._m_deadline_shed is not None:
            self._m_deadline_shed.inc(shed)
        batch = live
        if not batch:
            return
        t_exec = time.perf_counter()
        try:
            # crash point: the microbatch is assembled, nothing executed —
            # a failure here must fail exactly this batch's callers and
            # leave the loop serving
            faults.fire("serve.batch")
            span = (
                self.tracer.span("serve.batch", n=len(batch))
                if self.tracer is not None else contextlib.nullcontext()
            )
            with span:
                results = self.engine.lookup_many(
                    [q for _f, q, _p, _d, _t, _e in batch],
                    parsed=[p for _f, _q, p, _d, _t, _e in batch],
                )
        except Exception as exc:
            for fut, _q, _p, _d, _t, _e in batch:
                if not fut.done():
                    fut.set_exception(exc)
            return
        dt_device = time.perf_counter() - t_exec
        for (fut, _q, _p, _d, trace, t_enq), result in zip(batch, results):
            if trace is not None:
                # queue-wait = enqueue -> drain; device = the microbatch's
                # engine time, shared by every co-batched request
                trace.add("queue", t_exec - t_enq)
                trace.add("device", dt_device)
            if not fut.done():
                fut.set_result(result)
        self._batches += 1
        self._queries += len(batch)
        if self._m_batches is not None:
            self._m_batches.inc()
            self._m_fill.observe(len(batch) / self.max_batch)
            self._m_depth.set(len(self._pending))

    def drain_stats(self) -> dict:
        return {
            "batches": self._batches,
            "queries": self._queries,
            "batch_fill": round(
                self._queries / (self._batches * self.max_batch), 4
            ) if self._batches else 0.0,
            "queue": {"items": self._queries, "producer_block_s": 0.0,
                      "consumer_wait_s": 0.0, "max_depth": self._max_depth},
        }

    def close(self, timeout: float = 5.0) -> None:
        """Fail whatever is still queued; safe to call off-loop after the
        loop has stopped (the futures' waiters are gone with it)."""
        self._closed = True
        pending, self._pending = self._pending, []
        for fut, _q, _p, _d, _t, _e in pending:
            try:
                if not fut.done():
                    fut.cancel()
            except RuntimeError:
                pass  # loop already closed: the waiters died with it
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None
        self._drain_soon = False


class _CompletionBridge:
    """Drain-thread -> event-loop completion batching.

    One ``call_soon_threadsafe`` per request would pay a self-pipe write
    (a syscall) per query ON THE DRAIN THREAD — serialized against engine
    work.  A batcher drain completes hundreds of pendings back-to-back,
    so completions accumulate in a plain deque and the loop wakes ONCE
    per burst to resolve them all."""

    __slots__ = ("loop", "_lock", "_ready", "_scheduled")

    def __init__(self, loop: asyncio.AbstractEventLoop):
        self.loop = loop
        self._lock = make_lock("serve.aio.bridge")
        #: guarded by self._lock
        self._ready: list = []
        #: guarded by self._lock
        self._scheduled = False

    def complete(self, fut: asyncio.Future, pending) -> None:
        """Called on the drain thread (the pending's completion hook)."""
        with self._lock:
            self._ready.append((fut, pending))
            schedule = not self._scheduled
            if schedule:
                self._scheduled = True
        if schedule:
            self.loop.call_soon_threadsafe(self._flush)

    def _flush(self) -> None:  # runs on the loop
        with self._lock:
            items = self._ready
            self._ready = []
            self._scheduled = False
        for fut, pending in items:
            _resolve_pending(fut, pending)


#: refillable-debt horizon: an admitted bulk may indebt its bucket by at
#: most this many seconds of refill.  Bulks whose per-id cost exceeds it
#: are REJECTED at parse time (429) rather than served-then-forgiven —
#: a capped debt on work already done would let one oversized /variants
#: body bypass the per-client rate.  The clamp in ``charge`` is only a
#: backstop for direct API users.
MAX_DEBT_S = 30.0


class _TokenBucket:
    """One client's admission budget: ``rate`` tokens/sec, capped at
    ``burst``; a take below one whole token reports the wait instead."""

    __slots__ = ("rate", "burst", "tokens", "t")

    def __init__(self, rate: float, burst: float, now: float):
        self.rate = rate
        self.burst = burst
        self.tokens = burst
        self.t = now

    def take(self, now: float) -> float:
        """0.0 = admitted (one token spent); else seconds until a token."""
        self.tokens = min(
            self.burst, self.tokens + (now - self.t) * self.rate
        )
        self.t = now
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            return 0.0
        return (1.0 - self.tokens) / self.rate

    def charge(self, cost: float) -> None:
        """Debit ``cost`` tokens, allowing bounded debt: the bucket must
        refill back above one whole token before the next admit."""
        self.tokens = max(self.tokens - cost, -self.rate * MAX_DEBT_S)


class ClientGovernor:
    """Weighted per-client fairness: each client key owns a token bucket
    refilling at ``base_rate * weight``.  Single-threaded by construction
    (all calls happen on the event loop).  The key population is
    LRU-bounded so an address-spraying client cannot balloon memory."""

    MAX_KEYS = 4096

    #: distinct client-id buckets one peer address may hold.  The id
    #: header is client-supplied — without a cap a hog rotating
    #: ``X-Client-Id`` per request would mint a fresh burst every time
    #: (never throttled) while its spray evicts other clients' buckets
    #: (and their accumulated bulk debt) from the LRU.  Beyond the cap
    #: an UNSEEN id degrades to the peer's aggregate bucket.
    PEER_KEY_CAP = 32

    def __init__(self, base_rate: float, clock=time.monotonic):
        self.base_rate = float(base_rate)
        #: seconds source for the buckets (tests inject a fake clock)
        self._clock = clock
        self._buckets: OrderedDict = OrderedDict()
        self._peer_keys: dict[str, int] = {}  # peer -> live id-bucket count

    def resolve_key(self, peer: str, client_id: str | None) -> str:
        """The bucket key for this request.  Ids are scoped to the peer
        address (an id is a claim, not an identity) and capped per peer;
        no header means the peer's aggregate bucket."""
        if not client_id:
            return peer
        key = f"{peer}|{client_id}"
        if key in self._buckets:
            return key
        if self._peer_keys.get(peer, 0) >= self.PEER_KEY_CAP:
            return peer
        return key

    def _evict_oldest(self) -> None:
        key, _bucket = self._buckets.popitem(last=False)
        peer, sep, _cid = key.partition("|")
        if sep:
            n = self._peer_keys.get(peer, 0) - 1
            if n > 0:
                self._peer_keys[peer] = n
            else:
                self._peer_keys.pop(peer, None)

    def admit(self, key: str, weight: int) -> float:
        """0.0 = admitted; else retry-after seconds (the 429 header)."""
        now = self._clock()
        weight = min(max(int(weight), 1), MAX_CLIENT_WEIGHT)
        rate = self.base_rate * weight
        bucket = self._buckets.get(key)
        if bucket is None:
            bucket = _TokenBucket(rate, max(rate * 0.25, 4.0), now)
            self._buckets[key] = bucket
            peer, sep, _cid = key.partition("|")
            if sep:
                self._peer_keys[peer] = self._peer_keys.get(peer, 0) + 1
            while len(self._buckets) > self.MAX_KEYS:
                self._evict_oldest()
        else:
            self._buckets.move_to_end(key)
            if bucket.rate != rate:
                # the declared weight binds per REQUEST, not per bucket
                # lifetime: a client that first arrived without the header
                # (weight 1) must not stay throttled at 1/16th of the
                # share it declares later (take() re-clamps tokens to the
                # new burst)
                bucket.rate = rate
                bucket.burst = max(rate * 0.25, 4.0)
        return bucket.take(now)

    def charge(self, key: str, cost: float) -> None:
        """Debit extra work (bulk ids beyond the admit token) against the
        client's bucket — batching must not bypass the per-client rate.
        Callers must keep ``cost`` within :meth:`bulk_budget` (the front
        end rejects bigger bulks before executing them); the debt clamp
        in ``_TokenBucket.charge`` is a backstop, not a forgiveness
        policy.  A key evicted from the LRU between admit and charge
        forfeits the debt (self-correcting; only possible past MAX_KEYS
        clients)."""
        bucket = self._buckets.get(key)
        if bucket is not None:
            bucket.charge(cost)

    def bulk_budget(self, weight: int) -> int:
        """Max ids one admitted bulk may carry for a client of this
        weight: the per-id debt must be repayable within ``MAX_DEBT_S``
        of refill.  Anything larger is rejected outright — served work
        whose debt the clamp would cap is rate-limit bypass."""
        weight = min(max(int(weight), 1), MAX_CLIENT_WEIGHT)
        return max(int(self.base_rate * weight * MAX_DEBT_S), 1)


class AioServer:
    """The event-loop server.  Build with :func:`build_aio_server`; run
    blocking via :meth:`serve_forever` (installs SIGTERM/SIGINT graceful
    drain when on the main thread) or on a helper thread via
    :meth:`start_background` / :meth:`shutdown` (tests, smoke).

    Shutdown order mirrors the threaded server: stop the server, then
    ``ctx.batcher.close()`` (the caller owns the batcher)."""

    #: loop maintenance-tick cadence: the heartbeat write and the
    #: brownout-ladder evaluation run ON the loop — a parked loop stops
    #: beating, which is what the fleet watchdog detects
    TICK_S = 0.25

    def __init__(self, ctx: ServeContext, host: str = "127.0.0.1",
                 port: int = 0, sock=None,
                 client_rate: float | None = None,
                 stream_threshold: int | None = None,
                 drain_s: float = 5.0,
                 heartbeat_file: str | None = None,
                 heartbeat_index: int = 0):
        self.ctx = ctx
        self.host = host
        self.port = port
        self.sock = sock  # a pre-bound listening socket, or None
        #: fleet watchdog handshake: this worker's slot in the shared
        #: mmap'd heartbeat file (None outside a fleet).  Mapped here, at
        #: worker start: the tick runs on the event loop and only packs
        #: into the established mapping, never touching the filesystem
        self.heartbeat_file = heartbeat_file
        self.heartbeat_index = int(heartbeat_index)
        self._hb_mm = None
        if heartbeat_file is not None:
            try:
                with open(heartbeat_file, "r+b") as f:
                    self._hb_mm = mmap.mmap(f.fileno(), 0)
            except (OSError, ValueError) as err:
                ctx.log(f"heartbeat file unusable ({err}); "
                        "watchdog will not see this worker")
                self._hb_mm = None
        #: runtime fault arming (POST /_chaos) — gated hard on the
        #: environment so the route does not exist on a production server
        #: (404, byte-identical to any unknown route); /debug/trace shares
        #: the same gate
        self._chaos_enabled = chaos_enabled_from_env()
        #: arming generation: each /_chaos arm bumps it so a stale ttl
        #: timer can never disarm a NEWER arming's fault
        self._chaos_seq = 0
        if client_rate is None:
            client_rate = _client_rate_from_env()
        self.governor = (
            ClientGovernor(client_rate) if client_rate > 0 else None
        )
        self.stream_threshold = (
            _stream_threshold_from_env()
            if stream_threshold is None else max(int(stream_threshold), 0)
        )
        self.drain_s = drain_s
        self.server_address = (host, port)
        self._pool = ThreadPoolExecutor(
            max_workers=4, thread_name_prefix="avdb-serve-exec"
        )
        self._loop: asyncio.AbstractEventLoop | None = None
        self._stop: asyncio.Event | None = None
        self._startup_error: BaseException | None = None
        self._started = threading.Event()
        self._thread: threading.Thread | None = None
        self._conns: set = set()
        # bound once: per-request getattr on the manager is hot-path waste
        self._refresh_due = getattr(ctx.manager, "refresh_due", None)
        self._refresh_inflight = False
        self._bridge: _CompletionBridge | None = None
        #: fleet telemetry publishing: the maintenance tick schedules a
        #: snapshot-file write (on the POOL — the loop never does file
        #: I/O) so any sibling's /metrics?fleet=1 can sum this worker in
        self._telemetry_last = 0.0
        self._telemetry_inflight = False
        self._telemetry_error_logged = False
        #: flight flushes run from the tick on the POOL, never inline on
        #: the loop (the whole point of buffering the request summaries)
        self._flight_flush_inflight = False
        if ctx.flight is not None:
            ctx.flight_flush_inline = False
        #: health-plane ticks likewise run from the tick on the POOL
        #: (the persist half is file I/O, banned on the loop)
        self._health_tick_inflight = False
        if ctx.health is not None:
            ctx.health_tick_inline = False
        self._loop_batcher = isinstance(ctx.batcher, LoopBatcher)

    # -- lifecycle ----------------------------------------------------------

    def serve_forever(self) -> None:
        """Run the loop on THIS thread until :meth:`shutdown` (or, on the
        main thread, SIGTERM/SIGINT) — then drain gracefully.  A bind
        failure raises here (``OSError``, e.g. EADDRINUSE) rather than
        leaving a zombie loop."""
        asyncio.run(self._main())
        if self._startup_error is not None:
            raise self._startup_error

    def start_background(self, timeout: float = 30.0) -> None:
        """Run the loop on a daemon thread; returns once the socket is
        bound (``server_address`` is then concrete).  Re-raises a bind
        failure from the loop thread (the caller gets the real
        ``OSError``, not a timeout)."""
        self._thread = threading.Thread(
            target=self._serve_quietly, name="avdb-serve-aio", daemon=True
        )
        self._thread.start()
        if not self._started.wait(timeout):
            raise RuntimeError("aio server did not start in time")
        if self._startup_error is not None:
            raise self._startup_error

    def _serve_quietly(self) -> None:
        """Background-thread target: a startup failure is re-raised to
        the foreground by :meth:`start_background`, not the thread
        excepthook."""
        try:
            self.serve_forever()
        except BaseException:
            if self._startup_error is None:
                raise

    def shutdown(self) -> None:
        """Threadsafe stop; joins the background thread when one exists."""
        loop, stop = self._loop, self._stop
        if loop is not None and stop is not None:
            with contextlib.suppress(RuntimeError):
                loop.call_soon_threadsafe(stop.set)
        if self._thread is not None \
                and self._thread is not threading.current_thread():
            self._thread.join(timeout=self.drain_s + 10)
        self._pool.shutdown(wait=False)

    async def _main(self) -> None:
        self._loop = asyncio.get_running_loop()
        self._stop = asyncio.Event()
        self._bridge = _CompletionBridge(self._loop)
        if threading.current_thread() is threading.main_thread():
            import signal as _signal

            for signame in ("SIGTERM", "SIGINT"):
                with contextlib.suppress(
                    NotImplementedError, RuntimeError, ValueError
                ):
                    self._loop.add_signal_handler(
                        getattr(_signal, signame), self._stop.set
                    )
        try:
            if self.sock is not None:
                server = await asyncio.start_server(
                    self._handle, sock=self.sock
                )
            else:
                server = await asyncio.start_server(
                    self._handle, self.host, self.port
                )
        except OSError as err:
            # bind failure (EADDRINUSE, EACCES...): record and wake the
            # starter — serve_forever/start_background re-raise it as the
            # clean startup error instead of a 30s hang
            self._startup_error = err
            self._started.set()
            return
        self.server_address = server.sockets[0].getsockname()[:2]
        self._started.set()
        self._start_tick()
        try:
            await self._stop.wait()
        finally:
            server.close()
            await server.wait_closed()
            # graceful drain: in-flight connections finish their current
            # responses within the drain budget; stragglers are cancelled
            pending = [t for t in self._conns if not t.done()]
            if pending:
                _done, still = await asyncio.wait(
                    pending, timeout=self.drain_s
                )
                for t in still:
                    t.cancel()

    # -- loop maintenance tick ----------------------------------------------

    def _start_tick(self) -> None:
        self._loop.call_soon(self._tick)

    def _tick(self) -> None:
        """One maintenance pass ON the event loop: the wedge fault point
        first (a long ``delay`` here parks the loop — requests stall AND
        heartbeats stop, the alive-but-stuck worker), then one heartbeat
        slot write, a brownout-ladder evaluation and the memtable flush
        check, then the telemetry publish, the flight flush and the health
        tick, each handed to the executor pool with at most one in flight.
        Everything that proves this loop makes progress runs here, so a
        wedged loop cannot look healthy from a helper thread."""
        if self._stop is not None and self._stop.is_set():
            return
        try:
            try:
                # crash point: fires per maintenance tick; delay = a
                # wedged loop the fleet watchdog must SIGKILL, kill = a
                # worker death
                faults.fire("serve.wedge")
            except Exception as err:
                self.ctx.log(f"wedge fault injected: {err}")
            if self._hb_mm is not None:
                # beside the beat, the slot publishes this worker's health
                # (p99-exceedance EWMA, brownout level, queue depth) for a
                # supervisor-side reader; losing one beat is survivable,
                # losing the tick chain is not
                with contextlib.suppress(OSError, ValueError, struct.error):
                    gov = self.ctx.governor
                    HB_SLOT.pack_into(
                        self._hb_mm,
                        self.heartbeat_index * HB_SLOT.size,
                        time.time(), gov.exceedance, gov.level,
                        self.ctx.batcher.depth(),
                    )
            with contextlib.suppress(Exception):
                self.ctx.governor.maybe_step()
            with contextlib.suppress(Exception):
                # memtable age/size flush triggers (the flush itself runs
                # on its own thread; this is one lock and a compare)
                self.ctx.maybe_flush_memtable()
            with contextlib.suppress(Exception):
                self._maybe_publish_telemetry()
            with contextlib.suppress(Exception):
                self._maybe_flush_flight()
            with contextlib.suppress(Exception):
                self._maybe_tick_health()
        finally:
            # the next tick is unconditional: whatever one pass hit, the
            # heartbeat and brownout machinery must keep running
            self._loop.call_later(self.TICK_S, self._tick)

    #: seconds between fleet-telemetry snapshot publishes
    TELEMETRY_S = 1.0

    def _maybe_publish_telemetry(self) -> None:
        """Time-gated, one in flight: schedule this worker's metric
        snapshot write onto the executor pool (the tick runs ON the
        loop, where file I/O is banned)."""
        tdir = self.ctx.telemetry_dir
        if tdir is None or self._telemetry_inflight:
            return
        now = time.monotonic()
        if now - self._telemetry_last < self.TELEMETRY_S:
            return
        self._telemetry_last = now
        self._telemetry_inflight = True
        fut = self._pool.submit(self._publish_telemetry)
        fut.add_done_callback(
            lambda _f: setattr(self, "_telemetry_inflight", False)
        )

    def _maybe_flush_flight(self) -> None:
        """Drain the flight recorder's buffered request summaries on the
        executor pool (one in flight at a time; the tick itself only
        schedules)."""
        flight = self.ctx.flight
        if flight is None or self._flight_flush_inflight:
            return
        self._flight_flush_inflight = True

        def run():
            try:
                flight.flush(limit=flight.FLUSH_BATCH)
            finally:
                self._flight_flush_inflight = False

        self._pool.submit(run)

    def _maybe_tick_health(self) -> None:
        """Health-plane tick (time-series sample + SLO evaluation +
        history persist) on the executor pool — the persist half is file
        I/O, banned on the loop.  One in flight; the plane's own
        ``due()`` gates the cadence, and ``tick()`` absorbs its own
        failures."""
        health = self.ctx.health
        if health is None or self._health_tick_inflight \
                or not health.due():
            return
        self._health_tick_inflight = True

        def run():
            try:
                health.tick()
            finally:
                self._health_tick_inflight = False

        self._pool.submit(run)

    def _publish_telemetry(self) -> None:
        """Pool half: atomically replace this worker's snapshot file —
        a sibling scraping ``?fleet=1`` must never read a torn JSON."""
        try:
            path = os.path.join(
                self.ctx.telemetry_dir,
                f"worker-{self.ctx.worker_index}.json",
            )
            tmp = f"{path}.tmp{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump({
                    "index": self.ctx.worker_index,
                    "pid": os.getpid(),
                    "t": time.time(),
                    "metrics": self.ctx.registry.snapshot(),
                }, f)
            os.replace(tmp, path)
        except (OSError, ValueError, TypeError) as err:
            if not self._telemetry_error_logged:
                self._telemetry_error_logged = True
                self.ctx.log(f"telemetry publish failed ({err}); "
                             "fleet view will miss this worker")

    # -- connection handling ------------------------------------------------

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        task = asyncio.current_task()
        if task is not None:
            self._conns.add(task)
            task.add_done_callback(self._conns.discard)
        try:
            # crash point: the connection is accepted, nothing parsed —
            # a raise here must cost exactly this connection; kill is the
            # fleet's dead-worker case (supervisor restarts)
            faults.fire("serve.accept")
        except Exception as err:
            self.ctx.log(f"accept failed: {err}")
            writer.close()
            return
        out_q: asyncio.Queue = asyncio.Queue(maxsize=PIPELINE_DEPTH)
        wtask = self._loop.create_task(self._write_responses(writer, out_q))
        try:
            while True:
                try:
                    head = await reader.readuntil(b"\r\n\r\n")
                except (asyncio.IncompleteReadError, ConnectionResetError,
                        BrokenPipeError):
                    break  # client closed between requests
                except asyncio.LimitOverrunError:
                    await out_q.put(_error(431, "request head too large"))
                    break
                item, keep = await self._route(reader, writer, head)
                if item is not None:
                    await out_q.put(item)
                if not keep:
                    break
        except asyncio.CancelledError:
            wtask.cancel()
            raise  # shutdown drain: let the cancellation propagate
        except Exception as err:
            self.ctx.log(f"connection handler error: {err}")
        finally:
            try:
                out_q.put_nowait(None)  # sentinel: emit the tail, then stop
            except asyncio.QueueFull:
                # a full pipeline at teardown: wait for the writer to make
                # room rather than dropping the sentinel (a dropped
                # sentinel stalls teardown until the watchdog cancel)
                with contextlib.suppress(Exception):
                    await asyncio.wait_for(out_q.put(None), timeout=10)
            if not wtask.done():
                try:
                    await asyncio.wait_for(wtask, timeout=self.drain_s + 25)
                except (asyncio.TimeoutError, asyncio.CancelledError):
                    wtask.cancel()
            # a cancelled writer abandons whatever is still queued —
            # settle those items or their admission slots leak for the
            # life of the (otherwise healthy) server
            while True:
                try:
                    item = out_q.get_nowait()
                except asyncio.QueueEmpty:
                    break
                if item is not None:
                    with contextlib.suppress(Exception):
                        await self._settle(item)
            with contextlib.suppress(Exception):
                writer.close()
                await writer.wait_closed()

    async def _write_responses(self, writer, q: asyncio.Queue) -> None:
        """Emit responses strictly in request order, COALESCING ready
        responses into one transport write — per-response ``send`` calls
        dominate the profile at serving QPS (a batcher drain completes
        ~hundreds of futures at once; their bytes should leave in one
        syscall, not hundreds).  A dead client stops the writes but NOT
        the accounting: remaining items are still awaited (admission
        slots release, executor work completes)."""
        dead = False
        out = bytearray()
        stop = False
        while not stop:
            item = await q.get()
            batch = [item]
            # opportunistically take everything already queued — their
            # futures resolved with the same microbatch drain
            while True:
                try:
                    batch.append(q.get_nowait())
                except asyncio.QueueEmpty:
                    break
            for idx, it in enumerate(batch):
                if it is None:
                    stop = True
                    break
                try:
                    if dead:
                        await self._settle(it)
                        continue
                    await self._emit(writer, it, out)
                    if len(out) > _WRITE_HIGH_WATER:
                        writer.write(bytes(out))
                        out.clear()
                        await writer.drain()
                except (ConnectionResetError, BrokenPipeError, OSError):
                    # the item whose _emit raised has already settled its
                    # own accounting (the stream path releases in its
                    # finally) — only LATER items go the settle path
                    dead = True
                    out.clear()
                except asyncio.CancelledError:
                    # cancelled (watchdog/shutdown) with items in hand:
                    # they left the queue, so the handler's teardown
                    # drain cannot see them — settle the LATER ones here
                    # without awaiting (the current item settles itself
                    # in _emit/_settle)
                    for later in batch[idx + 1:]:
                        if isinstance(later, tuple) and later[0] == "exec":
                            self._settle_when_done(later[1])
                    raise
            if out and not dead:
                try:
                    writer.write(bytes(out))
                    out.clear()
                    if (writer.transport.get_write_buffer_size()
                            > _WRITE_HIGH_WATER):
                        await writer.drain()
                except (ConnectionResetError, BrokenPipeError, OSError):
                    dead = True
                    out.clear()
        if not dead:
            with contextlib.suppress(Exception):
                await writer.drain()

    async def _emit(self, writer, item, out: bytearray) -> None:
        """Append one response's bytes to the coalescing buffer (or, for
        a streamed region, flush the buffer and stream directly)."""
        if isinstance(item, bytes):
            out += item
            return
        kind = item[0]
        if kind == "point":
            _k, fut, t0, vid, generation, tid, trace = item
            out += await self._finish_point(fut, t0, vid, generation,
                                            tid, trace)
            return
        # ("exec", future, kind, t0, tid, trace): buffered bytes or a
        # stream marker
        _k, fut, qkind, t0, tid, trace = item
        try:
            result = await fut
        except asyncio.CancelledError:
            # the writer was cancelled mid-wait (watchdog/shutdown); the
            # executor half still finishes, and a streamed region would
            # hold its admission slot forever — settle it when it lands
            self._settle_when_done(fut)
            raise
        if isinstance(result, bytes):
            # the exec trace seals HERE, centrally: the bytes already
            # know their status, so the work functions never fork on it
            self.ctx.reqtrace.finish(trace, _status_of(result))
            out += _add_trace(result, tid)
            return
        page = result[1]  # RegionPage or RegionsResult: same stream surface
        try:
            if out:  # ordering: everything before the stream goes first
                writer.write(bytes(out))
                out.clear()
            await self._stream_region(writer, page, tid)
            self.ctx.observe(qkind, time.perf_counter() - t0,
                             rows=page.returned)
            self.ctx.reqtrace.finish(trace, 200)
        finally:
            self.ctx.release()

    async def _settle(self, item) -> None:
        """Account for an item that will never reach the wire (the client
        connection died first): release whatever it holds, and make the
        abandonment visible — a chaos run's killed connections should
        show up in a counter, not vanish."""
        self.ctx.abandoned()
        if isinstance(item, bytes):
            return
        fut = item[1]
        try:
            result = await fut
        except asyncio.CancelledError:
            if item[0] == "exec":
                self._settle_when_done(fut)
            raise
        except Exception:
            return
        # seal the abandoned request's trace (status 0 = undelivered)
        self.ctx.reqtrace.finish(item[-1], 0)
        if not isinstance(result, bytes) and item[0] == "exec":
            self.ctx.release()  # undelivered stream: free its slot

    def _settle_when_done(self, fut) -> None:
        """Non-awaiting twin of :meth:`_settle` for an exec future the
        cancelled writer abandoned mid-await."""
        def settle(f):
            with contextlib.suppress(Exception):
                if not isinstance(f.result(), bytes):
                    self.ctx.release()
        fut.add_done_callback(settle)

    async def _finish_point(self, fut, t0, vid: str, generation: int,
                            tid: str | None = None, trace=None) -> bytes:
        ctx = self.ctx
        try:
            # no wait_for wrapper (it costs a Task + timer per request):
            # every submitted pending is GUARANTEED to finish — the drain
            # thread completes it, fails it, sheds it past its deadline,
            # or close() fails the queue
            record = await fut
        except DeadlineExceeded as err:
            # the batcher shed it (and counted stage="batcher")
            ctx.reqtrace.finish(trace, 504)
            return _add_trace(_error(504, str(err)), tid)
        except Exception as err:
            ctx.errored("point")
            ctx.reqtrace.finish(trace, 500)
            return _add_trace(
                _error(500, f"{type(err).__name__}: {err}"), tid
            )
        t_render = time.perf_counter()
        ctx.remember_point(generation, vid, record)
        if record is None:
            ctx.observe("point", time.perf_counter() - t0)
            ctx.reqtrace.finish(trace, 404)
            return _add_trace(
                _error(404, f"variant {vid!r} not in store"), tid
            )
        resp = _resp(200, record)
        ctx.observe("point", time.perf_counter() - t0, rows=1)
        if trace is not None:
            trace.add("render", time.perf_counter() - t_render)
        ctx.reqtrace.finish(trace, 200)
        return _add_trace(resp, tid)

    # -- routing ------------------------------------------------------------


    @staticmethod
    def _parse_head(head: bytes):
        """(method, target, keep_alive, http11, headers) from one request
        head.  ``http11`` gates chunked streaming: RFC 9112 forbids
        ``Transfer-Encoding`` toward a 1.0 peer."""
        lines = head.split(b"\r\n")
        parts = lines[0].split(b" ")
        if len(parts) != 3:
            raise ValueError(f"malformed request line {lines[0][:80]!r}")
        method = parts[0].decode("latin-1")
        target = parts[1].decode("latin-1")
        version = parts[2].decode("latin-1")
        headers: dict[str, str] = {}
        for line in lines[1:]:
            if not line:
                continue
            name, sep, value = line.partition(b":")
            if sep:
                headers[name.decode("latin-1").strip().lower()] = \
                    value.decode("latin-1").strip()
        conn = headers.get("connection", "").lower()
        http11 = version == "HTTP/1.1"
        keep = (http11 and conn != "close") or conn == "keep-alive"
        return method, target, keep, http11, headers

    async def _route(self, reader, writer, head: bytes):
        """One parsed request -> (queue item | None, keep_alive).  The
        trace-id echo header splices into prebuilt byte responses HERE
        (one insertion point); deferred items (point/exec tuples) carry
        the id and the writer splices when their bytes materialize."""
        item, keep, tid = await self._route_inner(reader, writer, head)
        if isinstance(item, bytes):
            item = _add_trace(item, tid)
        return item, keep

    async def _route_inner(self, reader, writer, head: bytes):
        """The routing body: returns ``(item, keep_alive, trace_id)``."""
        ctx = self.ctx
        # fast path: the dominant serving request is a plain point GET on
        # a keep-alive connection; skip the full head parse for it (the
        # governor, when on, needs headers — it takes the slow path; so
        # does a client-sent trace id, which must echo byte-identically)
        if self.governor is None and head.startswith(b"GET /variant/"):
            eol = head.find(b"\r\n")
            line = head[:eol]
            hlow = head.lower()
            # any Connection header (rare on this hot path; the token is
            # case-insensitive per RFC 9112) routes to the full parser —
            # a substring guess here would misread "Connection: Close";
            # a client-sent deadline header likewise needs the real parse
            if line.endswith(b" HTTP/1.1") and b"?" not in line \
                    and b"connection:" not in hlow \
                    and b"x-deadline-ms:" not in hlow \
                    and b"x-request-id:" not in hlow \
                    and b"traceparent:" not in hlow:
                vid = line[13:-9].decode("latin-1")
                if "%" in vid:
                    vid = unquote(vid)
                self._maybe_refresh_snapshot()
                tid = resolve_trace_id(None, None)
                return self._point_item(
                    vid, self._default_deadline(), tid
                ), True, tid
        try:
            method, target, keep, http11, headers = self._parse_head(head)
        except ValueError as err:
            return _error(400, str(err)), False, None
        tid = resolve_trace_id(
            headers.get("traceparent"), headers.get("x-request-id")
        )
        url = urlparse(target)
        path = unquote(url.path)
        self._maybe_refresh_snapshot()
        deadline_t = ctx.request_deadline(headers.get("x-deadline-ms"))
        if method == "GET":
            if path.startswith("/variant/"):
                retry = self._admit_client(headers, writer)
                if retry:
                    ctx.rejected("point")
                    return _error(
                        429, "client over rate (point admission)",
                        retry_after=max(int(retry + 0.999), 1),
                    ), keep, tid
                return self._point_item(
                    path[len("/variant/"):], deadline_t, tid
                ), keep, tid
            if path.startswith("/region/"):
                if ctx.governor.shed_bulk():
                    ctx.brownout_shed()
                    return _error(503, MSG_BROWNOUT_REGION), keep, tid
                retry = self._admit_client(headers, writer)
                if retry:
                    ctx.rejected("region")
                    return _error(
                        429, "client over rate (region admission)",
                        retry_after=max(int(retry + 0.999), 1),
                    ), keep, tid
                return self._region_item(
                    path[len("/region/"):], url.query, http11,
                    deadline_t, tid,
                ), keep, tid
            if path == "/healthz":
                return _resp(200, healthz_payload(ctx)), keep, tid
            if path == "/readyz":
                status, body = readyz_payload(ctx)
                return _resp(status, body), keep, tid
            if path == "/metrics":
                if "fleet" in (url.query or ""):
                    # the fleet view reads sibling snapshot FILES — that
                    # is executor work, never event-loop work
                    fut = self._loop.run_in_executor(
                        self._pool,
                        lambda: _resp(200, metrics_payload(ctx, url.query),
                                      content_type=_CT_TEXT),
                    )
                    return ("exec", fut, "metrics", time.perf_counter(),
                            tid, None), keep, tid
                return _resp(200, metrics_payload(ctx, url.query),
                             content_type=_CT_TEXT), keep, tid
            if path == "/stats":
                return _resp(200, stats_payload(ctx)), keep, tid
            if path == "/alerts":
                if "fleet" in (url.query or ""):
                    # the fleet view reads sibling history FILES — that
                    # is executor work, never event-loop work
                    fut = self._loop.run_in_executor(
                        self._pool,
                        lambda: _resp(200, alerts_payload(ctx, url.query)),
                    )
                    return ("exec", fut, "alerts", time.perf_counter(),
                            tid, None), keep, tid
                return _resp(200, alerts_payload(ctx, url.query)), keep, tid
            if path == HISTORY_ROUTE:
                # even the solo view walks the whole ring deriving
                # rates/quantiles per sample — executor work like the
                # fleet file reads, never event-loop work
                fut = self._loop.run_in_executor(
                    self._pool,
                    lambda: _resp(
                        200, metrics_history_payload(ctx, url.query)
                    ),
                )
                return ("exec", fut, "history", time.perf_counter(),
                        tid, None), keep, tid
            if path == "/debug/trace" and ctx.debug_trace_enabled:
                # chaos-gated like /_chaos: a production server 404s this
                # byte-identically to any unknown route
                return _resp(200, debug_trace_payload(ctx)), keep, tid
            if path == REPL_MANIFEST_ROUTE:
                # the ship document stats the manifest and scans WAL
                # stable prefixes — file I/O, executor work
                fut = self._loop.run_in_executor(
                    self._pool,
                    lambda: _resp(*repl_manifest_payload(ctx)),
                )
                return ("exec", fut, "repl", time.perf_counter(),
                        tid, None), keep, tid
            if path in (REPL_SEGMENT_ROUTE, REPL_WAL_ROUTE):
                fut = self._loop.run_in_executor(
                    self._pool, self._repl_file_work, url.query
                )
                return ("exec", fut, "repl", time.perf_counter(),
                        tid, None), keep, tid
            if path == EXPORT_STREAM_ROUTE:
                if ctx.governor.shed_bulk():
                    ctx.brownout_shed()
                    return _error(503, MSG_BROWNOUT_EXPORT), keep, tid
                retry = self._admit_client(headers, writer)
                if retry:
                    ctx.rejected("export")
                    return _error(
                        429, "client over rate (export admission)",
                        retry_after=max(int(retry + 0.999), 1),
                    ), keep, tid
                return self._export_item(
                    url.query, deadline_t, tid
                ), keep, tid
            return _error(404, f"no such route: {path}"), keep, tid
        if method == "POST":
            try:
                length = int(headers.get("content-length", 0))
            except ValueError:
                # parity with the threaded front end: a malformed
                # Content-Length is a bad body-carrying request (400),
                # not a too-large one; the body length is unknowable, so
                # the connection cannot be reused
                if path == "/variants":
                    ctx.errored("bulk")
                    return _error(400, BULK_BODY_ERROR), False, tid
                if path == UPSERT_ROUTE:
                    ctx.errored("upsert")
                    return _error(400, UPSERT_BODY_ERROR), False, tid
                if path == "/regions":
                    ctx.errored("regions")
                    return _error(400, REGIONS_BODY_ERROR), False, tid
                if path == STATS_ROUTE:
                    ctx.errored("stats")
                    return _error(400, STATS_BODY_ERROR), False, tid
                return _error(404, f"no such route: {path}"), False, tid
            if length < 0 or length > MAX_BODY:
                return _error(
                    413, f"body too large (cap {MAX_BODY} bytes)"
                ), False, tid
            try:
                body = await reader.readexactly(length) if length else b""
            except asyncio.IncompleteReadError:
                return None, False, None
            if path == "/variants":
                if ctx.governor.shed_bulk():
                    ctx.brownout_shed()
                    return _error(503, MSG_BROWNOUT_BULK), keep, tid
                retry = self._admit_client(headers, writer)
                if retry:
                    ctx.rejected("bulk")
                    return _error(
                        429, "client over rate (bulk admission)",
                        retry_after=max(int(retry + 0.999), 1),
                    ), keep, tid
                client = max_ids = None
                if self.governor is not None:
                    client, weight = self._client_key(headers, writer)
                    max_ids = self.governor.bulk_budget(weight)
                return self._bulk_item(
                    body, client, max_ids, deadline_t, tid
                ), keep, tid
            if path == UPSERT_ROUTE:
                if ctx.governor.shed_bulk():
                    ctx.brownout_shed()
                    return _error(503, MSG_BROWNOUT_UPSERT), keep, tid
                retry = self._admit_client(headers, writer)
                if retry:
                    ctx.rejected("upsert")
                    return _error(
                        429, "client over rate (upsert admission)",
                        retry_after=max(int(retry + 0.999), 1),
                    ), keep, tid
                client = max_ids = None
                if self.governor is not None:
                    client, weight = self._client_key(headers, writer)
                    max_ids = self.governor.bulk_budget(weight)
                return self._upsert_item(
                    body, client, max_ids, deadline_t, tid
                ), keep, tid
            if path == "/regions":
                if ctx.governor.shed_bulk():
                    ctx.brownout_shed()
                    return _error(503, MSG_BROWNOUT_REGION), keep, tid
                retry = self._admit_client(headers, writer)
                if retry:
                    ctx.rejected("regions")
                    return _error(
                        429, "client over rate (region admission)",
                        retry_after=max(int(retry + 0.999), 1),
                    ), keep, tid
                client = max_ids = None
                if self.governor is not None:
                    client, weight = self._client_key(headers, writer)
                    max_ids = self.governor.bulk_budget(weight)
                return self._regions_item(
                    body, http11, client, max_ids, deadline_t, tid
                ), keep, tid
            if path == STATS_ROUTE:
                if ctx.governor.shed_bulk():
                    ctx.brownout_shed()
                    return _error(503, MSG_BROWNOUT_STATS), keep, tid
                retry = self._admit_client(headers, writer)
                if retry:
                    ctx.rejected("stats")
                    return _error(
                        429, "client over rate (stats admission)",
                        retry_after=max(int(retry + 0.999), 1),
                    ), keep, tid
                client = max_ids = None
                if self.governor is not None:
                    client, weight = self._client_key(headers, writer)
                    max_ids = self.governor.bulk_budget(weight)
                return self._stats_item(
                    body, client, max_ids, deadline_t, tid
                ), keep, tid
            if path == "/_chaos" and self._chaos_enabled:
                return self._chaos_item(body), keep, tid
            return _error(404, f"no such route: {path}"), keep, tid
        return _error(501, f"method {method} not supported"), False, tid

    def _chaos_item(self, body: bytes) -> bytes:
        """Runtime fault arming (``AVDB_SERVE_CHAOS=1`` only): the chaos
        harness's worker-side lever — environment arming cannot reach a
        running fleet, and respawned workers come up clean because this
        is in-process state.  ``ttl_s`` schedules an automatic disarm so a
        probabilistic fault cannot outlive its chaos window when the
        disarm request would land on a different worker."""
        try:
            obj = json.loads(body or b"{}")
            if not isinstance(obj, dict):
                raise TypeError("chaos body must be a JSON object")
            spec = obj.get("spec", "") or ""
            ttl = obj.get("ttl_s")
            # validate EVERYTHING before arming: a bad ttl must not leave
            # the fault armed with the auto-disarm it promised missing
            ttl_s = max(float(ttl), 0.0) if ttl is not None else None
            faults.reset(spec)
        except (ValueError, TypeError) as err:
            return _error(400, f"bad chaos spec: {err}")
        self._chaos_seq += 1
        if ttl_s is not None and spec:
            seq = self._chaos_seq

            def expire():
                # only disarm the arming this timer belongs to: a newer
                # arm owns the (single) fault slot and its own ttl
                if self._chaos_seq == seq:
                    faults.reset("")

            self._loop.call_later(ttl_s, expire)
        return _resp(200, json.dumps(
            {"armed": spec or None, "pid": os.getpid()}
        ))

    def _default_deadline(self) -> float | None:
        """Absolute deadline from the configured default budget alone
        (the fast path's case: no headers were parsed, and the fast path
        already guaranteed no X-Deadline-Ms header is present)."""
        d = self.ctx.default_deadline_s
        return time.monotonic() + d if d > 0 else None

    def _point_item(self, variant_id: str, deadline_t: float | None = None,
                    tid: str | None = None):
        ctx = self.ctx
        t0 = time.perf_counter()
        trace = ctx.reqtrace.begin(tid, "point") if tid is not None else None
        action, payload = ctx.point_preflight(variant_id, deadline_t)
        if action == "shed":
            ctx.reqtrace.finish(trace, 504)
            return _error(504, MSG_DEADLINE_ADMISSION)
        if action == "cached":
            if payload is None:
                ctx.observe("point", time.perf_counter() - t0)
                ctx.reqtrace.finish(trace, 404)
                return _error(404, f"variant {variant_id!r} not in store")
            ctx.observe("point", time.perf_counter() - t0, rows=1)
            ctx.reqtrace.finish(trace, 200)
            return _resp(200, payload)
        generation = payload
        if trace is not None:
            trace.add("admission", time.perf_counter() - t0)
        try:
            if self._loop_batcher:
                # loop-native coalescing: no cross-thread handoffs
                fut = ctx.batcher.submit_future(variant_id, deadline_t,
                                                trace=trace)
            else:
                # thread-based batcher: completions cross back through
                # the (drain-batched) bridge
                fut = self._loop.create_future()
                bridge = self._bridge

                def on_done(pending, fut=fut, bridge=bridge):
                    bridge.complete(fut, pending)

                ctx.batcher.submit_nowait(
                    variant_id, on_done, want_event=False,
                    deadline_t=deadline_t, trace=trace,
                )
        except QueueFull as err:
            ctx.rejected("point")
            ctx.reqtrace.finish(trace, 429)
            return _error(429, str(err), retry_after=1)
        except QueryError as err:
            ctx.errored("point")
            ctx.reqtrace.finish(trace, 400)
            return _error(400, str(err))
        except Exception as err:
            ctx.errored("point")
            ctx.reqtrace.finish(trace, 500)
            return _error(500, f"{type(err).__name__}: {err}")
        return ("point", fut, t0, variant_id, generation, tid, trace)


    def _upsert_item(self, body: bytes, client: str | None = None,
                     max_rows: int | None = None,
                     deadline_t: float | None = None,
                     tid: str | None = None):
        """Live write path: the bulk admission shape (slot + per-client
        budget); the WAL fsync runs on the executor pool — the ack barrier
        is blocking I/O and must never touch the event loop."""
        ctx = self.ctx
        t0 = time.perf_counter()
        if deadline_t is not None and time.monotonic() >= deadline_t:
            ctx.deadline_shed("admission")
            return _error(504, MSG_DEADLINE_ADMISSION)
        if not ctx.admit():
            ctx.rejected("upsert")
            return _error(429, MSG_CAPACITY_UPSERT, retry_after=1)
        trace = ctx.reqtrace.begin(tid, "upsert") if tid is not None \
            else None
        fut = self._loop.run_in_executor(
            self._pool, self._upsert_work, body, t0, client, max_rows,
            deadline_t, trace
        )
        return ("exec", fut, "upsert", t0, tid, trace)

    def _upsert_work(self, body: bytes, t0: float,
                     client: str | None = None,
                     max_rows: int | None = None,
                     deadline_t: float | None = None, trace=None) -> bytes:
        """Executor half of an upsert (parse, WAL append + fsync, memtable
        insert, ack) through the shared
        :meth:`ServeContext.upsert_execute`; never raises — errors become
        response bytes."""
        ctx = self.ctx
        try:
            if deadline_t is not None and time.monotonic() >= deadline_t:
                # executor-queue lag ate the budget: shed before the WAL
                # write (nothing durable happened, nothing acknowledged)
                ctx.deadline_shed("execute")
                return _error(504, MSG_DEADLINE_EXECUTE)
            if trace is not None:
                trace.add("admission", time.perf_counter() - t0)
            status, text, rows = ctx.upsert_execute(body, max_rows=max_rows,
                                                    trace=trace)
            if client is not None and rows > 1 and status == 200:
                # admission spent one token; the other acknowledged rows
                # debit the bucket too (on the loop thread)
                self._loop.call_soon_threadsafe(
                    self.governor.charge, client, float(rows - 1)
                )
            if status == 200:
                ctx.maybe_flush_memtable()
            retry = 1 if status in (429, 503) else None
            return _resp(status, text, retry_after=retry)
        finally:
            ctx.release()

    def _repl_file_work(self, query: str) -> bytes:
        """Executor half of ``GET /repl/{segment,wal}``: raw range bytes
        (the shared builder clamps WAL and ledger reads to their stable
        prefixes, so a torn frame never leaves this worker)."""
        status, body = repl_file_response(self.ctx, query)
        if isinstance(body, bytes):
            head = _STATUS[status] + _CT_BIN + str(len(body)).encode()
            return head + b"\r\n\r\n" + body
        return _resp(status, body)

    def _bulk_item(self, body: bytes, client: str | None = None,
                   max_ids: int | None = None,
                   deadline_t: float | None = None,
                   tid: str | None = None):
        ctx = self.ctx
        t0 = time.perf_counter()
        if deadline_t is not None and time.monotonic() >= deadline_t:
            ctx.deadline_shed("admission")
            return _error(504, MSG_DEADLINE_ADMISSION)
        if not ctx.admit():
            ctx.rejected("bulk")
            return _error(429, MSG_CAPACITY_BULK, retry_after=1)
        trace = ctx.reqtrace.begin(tid, "bulk") if tid is not None else None
        fut = self._loop.run_in_executor(
            self._pool, self._bulk_work, body, t0, client, max_ids,
            deadline_t, trace
        )
        return ("exec", fut, "bulk", t0, tid, trace)

    def _bulk_work(self, body: bytes, t0: float,
                   client: str | None = None,
                   max_ids: int | None = None,
                   deadline_t: float | None = None, trace=None) -> bytes:
        """Executor half of a bulk request (parse, probe, render, account);
        never raises — errors become response bytes."""
        ctx = self.ctx
        try:
            if deadline_t is not None and time.monotonic() >= deadline_t:
                # executor-queue lag ate the budget: shed BEFORE the probe
                ctx.deadline_shed("execute")
                return _error(504, MSG_DEADLINE_EXECUTE)
            if trace is not None:
                # admission = arrival -> this executor slot (pool wait
                # included: that IS where an overloaded worker queues)
                trace.add("admission", time.perf_counter() - t0)
            try:
                parsed = json.loads(body or b"{}")
                ids = parsed["ids"]
                if not isinstance(ids, list) \
                        or not all(isinstance(i, str) for i in ids):
                    raise KeyError("ids")
            except (ValueError, KeyError, TypeError):
                ctx.errored("bulk")
                return _error(400, BULK_BODY_ERROR)
            if max_ids is not None and len(ids) > max_ids:
                # a bulk the bucket could never repay within MAX_DEBT_S:
                # executing it and capping the debt would be rate-limit
                # bypass — reject before any lookup runs
                ctx.rejected("bulk")
                return _error(429, (
                    f"bulk of {len(ids)} ids exceeds client rate budget "
                    f"({max_ids} ids); split the request"
                ), retry_after=1)
            if client is not None and len(ids) > 1:
                # admission spent ONE token; the other len-1 lookups debit
                # the bucket too (on the loop thread — the governor is
                # single-threaded by construction), or a hog would bypass
                # the per-client rate entirely by batching
                self._loop.call_soon_threadsafe(
                    self.governor.charge, client, float(len(ids) - 1)
                )
            try:
                t_dev = time.perf_counter()
                with reqtrace_mod.activate(trace):
                    results = ctx.engine.lookup_many(ids)
                if trace is not None:
                    trace.add("device", time.perf_counter() - t_dev)
            except QueryError as err:
                ctx.errored("bulk")
                return _error(400, str(err))
            except Exception as err:
                ctx.errored("bulk")
                return _error(500, f"{type(err).__name__}: {err}")
            t_render = time.perf_counter()
            found = sum(1 for r in results if r is not None)
            resp = _resp(200, (
                f'{{"n":{len(results)},"found":{found},"results":['
                + ",".join(r if r is not None else "null" for r in results)
                + "]}"
            ))
            ctx.observe("bulk", time.perf_counter() - t0, rows=found)
            if trace is not None:
                trace.add("render", time.perf_counter() - t_render)
            return resp
        finally:
            ctx.release()

    def _regions_item(self, body: bytes, http11: bool = True,
                      client: str | None = None, max_ids: int | None = None,
                      deadline_t: float | None = None,
                      tid: str | None = None):
        """Batch region join: the bulk admission shape (slot + per-client
        budget) with the region streaming shape (a panel whose total row
        count exceeds the threshold streams chunked)."""
        ctx = self.ctx
        t0 = time.perf_counter()
        if deadline_t is not None and time.monotonic() >= deadline_t:
            ctx.deadline_shed("admission")
            return _error(504, MSG_DEADLINE_ADMISSION)
        if not ctx.admit():
            ctx.rejected("regions")
            return _error(429, MSG_CAPACITY_REGION, retry_after=1)
        trace = ctx.reqtrace.begin(tid, "regions") if tid is not None \
            else None
        fut = self._loop.run_in_executor(
            self._pool, self._regions_work, body, t0, http11, client,
            max_ids, deadline_t, trace
        )
        return ("exec", fut, "regions", t0, tid, trace)

    def _regions_work(self, body: bytes, t0: float, http11: bool = True,
                      client: str | None = None,
                      max_ids: int | None = None,
                      deadline_t: float | None = None, trace=None):
        """Executor half of a batch-region request.  Returns response
        bytes, or ``("stream", RegionsResult)`` for a panel whose total
        rendered rows exceed the stream threshold — the writer streams
        per-interval envelopes chunked and releases the admission slot
        when the body is done (exactly the single-region stream
        contract)."""
        ctx = self.ctx
        stream_holds_slot = False
        try:
            if deadline_t is not None and time.monotonic() >= deadline_t:
                ctx.deadline_shed("execute")
                return _error(504, MSG_DEADLINE_EXECUTE)
            if trace is not None:
                trace.add("admission", time.perf_counter() - t0)
            try:
                specs, min_cadd, max_rank, limit, tokenize = \
                    parse_regions_body(body)
            except QueryError as err:
                ctx.errored("regions")
                return _error(400, str(err))
            if max_ids is not None and len(specs) > max_ids:
                # same bounded-debt contract as bulk /variants: a panel
                # the bucket could never repay within MAX_DEBT_S is
                # rejected before any scan runs
                ctx.rejected("regions")
                return _error(429, (
                    f"regions batch of {len(specs)} exceeds client rate "
                    f"budget ({max_ids} intervals); split the request"
                ), retry_after=1)
            if client is not None and len(specs) > 1:
                # admission spent ONE token; the other intervals debit
                # the bucket too (on the loop thread — the governor is
                # single-threaded by construction)
                self._loop.call_soon_threadsafe(
                    self.governor.charge, client, float(len(specs) - 1)
                )
            try:
                cap = ctx.governor.region_limit_cap()
                if cap is not None:
                    # brownout level >= 1: bound per-interval render work
                    limit = min(limit, cap)
                t_dev = time.perf_counter()
                with reqtrace_mod.activate(trace):
                    result = ctx.engine.regions_serve(
                        specs,
                        min_cadd=min_cadd,
                        max_conseq_rank=max_rank,
                        limit=limit,
                        tokenize=tokenize,
                    )
                if trace is not None:
                    trace.add("device", time.perf_counter() - t_dev)
            except QueryError as err:
                ctx.errored("regions")
                return _error(400, str(err))
            except Exception as err:
                ctx.errored("regions")
                return _error(500, f"{type(err).__name__}: {err}")
            if http11 and result.returned > self.stream_threshold:
                stream_holds_slot = True
                return ("stream", result)  # the writer releases that slot
            t_render = time.perf_counter()
            resp = _resp(200, result.assemble())
            ctx.observe("regions", time.perf_counter() - t0,
                        rows=result.returned)
            if trace is not None:
                trace.add("render", time.perf_counter() - t_render)
            return resp
        finally:
            if not stream_holds_slot:
                ctx.release()

    def _stats_item(self, body: bytes, client: str | None = None,
                    max_ids: int | None = None,
                    deadline_t: float | None = None,
                    tid: str | None = None):
        """Analytics panel: the bulk admission shape (slot + per-client
        budget); bodies are summaries, so there is no streaming shape."""
        ctx = self.ctx
        t0 = time.perf_counter()
        if deadline_t is not None and time.monotonic() >= deadline_t:
            ctx.deadline_shed("admission")
            return _error(504, MSG_DEADLINE_ADMISSION)
        if not ctx.admit():
            ctx.rejected("stats")
            return _error(429, MSG_CAPACITY_STATS, retry_after=1)
        trace = ctx.reqtrace.begin(tid, "stats") if tid is not None \
            else None
        fut = self._loop.run_in_executor(
            self._pool, self._stats_work, body, t0, client, max_ids,
            deadline_t, trace
        )
        return ("exec", fut, "stats", t0, tid, trace)

    def _stats_work(self, body: bytes, t0: float,
                    client: str | None = None,
                    max_ids: int | None = None,
                    deadline_t: float | None = None, trace=None) -> bytes:
        """Executor half of a stats request (parse, fused panel, render,
        account); never raises — errors become response bytes."""
        ctx = self.ctx
        try:
            if deadline_t is not None and time.monotonic() >= deadline_t:
                ctx.deadline_shed("execute")
                return _error(504, MSG_DEADLINE_EXECUTE)
            if trace is not None:
                trace.add("admission", time.perf_counter() - t0)
            try:
                specs, metrics, windows = parse_stats_body(body)
            except QueryError as err:
                ctx.errored("stats")
                return _error(400, str(err))
            if max_ids is not None and len(specs) > max_ids:
                # the bounded-debt contract of bulk /variants: a panel
                # the bucket could never repay within MAX_DEBT_S is
                # rejected before any scan runs
                ctx.rejected("stats")
                return _error(429, (
                    f"stats batch of {len(specs)} exceeds client rate "
                    f"budget ({max_ids} intervals); split the request"
                ), retry_after=1)
            if client is not None and len(specs) > 1:
                # admission spent ONE token; the other intervals debit
                # the bucket too (on the loop thread — the governor is
                # single-threaded by construction)
                self._loop.call_soon_threadsafe(
                    self.governor.charge, client, float(len(specs) - 1)
                )
            try:
                t_dev = time.perf_counter()
                with reqtrace_mod.activate(trace):
                    result = ctx.engine.stats_serve(
                        specs, metrics=metrics, windows=windows,
                    )
                if trace is not None:
                    trace.add("device", time.perf_counter() - t_dev)
            except QueryError as err:
                ctx.errored("stats")
                return _error(400, str(err))
            except Exception as err:
                ctx.errored("stats")
                return _error(500, f"{type(err).__name__}: {err}")
            t_render = time.perf_counter()
            resp = _resp(200, result.assemble())
            ctx.observe("stats", time.perf_counter() - t0,
                        rows=result.returned)
            if trace is not None:
                trace.add("render", time.perf_counter() - t_render)
            return resp
        finally:
            ctx.release()

    def _export_item(self, query: str, deadline_t: float | None = None,
                     tid: str | None = None):
        """``GET /export/stream``: the stats admission shape (inflight
        slot + deadline), execution through the shared payload builder
        on the executor (kernel pack + allele render are CPU/device
        work, never event-loop work — AVDB701)."""
        ctx = self.ctx
        t0 = time.perf_counter()
        if deadline_t is not None and time.monotonic() >= deadline_t:
            ctx.deadline_shed("admission")
            return _error(504, MSG_DEADLINE_ADMISSION)
        if not ctx.admit():
            ctx.rejected("export")
            return _error(429, MSG_CAPACITY_EXPORT, retry_after=1)
        trace = ctx.reqtrace.begin(tid, "export") if tid is not None \
            else None
        fut = self._loop.run_in_executor(
            self._pool, self._export_work, query, t0, deadline_t, trace
        )
        return ("exec", fut, "export", t0, tid, trace)

    def _export_work(self, query: str, t0: float,
                     deadline_t: float | None = None, trace=None) -> bytes:
        """Executor half of an export-stream request (parse, pack,
        render, account); never raises — errors become response bytes."""
        ctx = self.ctx
        try:
            if deadline_t is not None and time.monotonic() >= deadline_t:
                ctx.deadline_shed("execute")
                return _error(504, MSG_DEADLINE_EXECUTE)
            if trace is not None:
                trace.add("admission", time.perf_counter() - t0)
            try:
                params = parse_stream_query(query)
            except ValueError as err:  # QueryError subclasses ValueError
                ctx.errored("export")
                return _error(400, str(err))
            try:
                t_dev = time.perf_counter()
                with reqtrace_mod.activate(trace):
                    body, n_valid = stream_payload(ctx.engine, params)
                if trace is not None:
                    trace.add("device", time.perf_counter() - t_dev)
            except QueryError as err:
                ctx.errored("export")
                return _error(400, str(err))
            except Exception as err:
                ctx.errored("export")
                return _error(500, f"{type(err).__name__}: {err}")
            resp = _resp(200, body)
            ctx.observe("export", time.perf_counter() - t0, rows=n_valid)
            return resp
        finally:
            ctx.release()

    def _region_item(self, spec: str, query: str, http11: bool = True,
                     deadline_t: float | None = None,
                     tid: str | None = None):
        ctx = self.ctx
        t0 = time.perf_counter()
        if deadline_t is not None and time.monotonic() >= deadline_t:
            ctx.deadline_shed("admission")
            return _error(504, MSG_DEADLINE_ADMISSION)
        if not ctx.admit():
            ctx.rejected("region")
            return _error(429, MSG_CAPACITY_REGION, retry_after=1)
        trace = ctx.reqtrace.begin(tid, "region") if tid is not None \
            else None
        fut = self._loop.run_in_executor(
            self._pool, self._region_work, spec, query, t0, http11,
            deadline_t, trace
        )
        return ("exec", fut, "region", t0, tid, trace)

    def _region_work(self, spec: str, query: str, t0: float,
                     http11: bool = True,
                     deadline_t: float | None = None, trace=None):
        """Executor half of a region request.  Returns response bytes, or
        ``("stream", page)`` — the writer task then streams it chunked and
        releases the admission slot when the body is done.  A non-1.1
        request always buffers (``stream_threshold=None``): chunked
        framing toward an HTTP/1.0 peer corrupts the body it cannot
        de-chunk."""
        ctx = self.ctx
        stream_holds_slot = False
        try:
            if deadline_t is not None and time.monotonic() >= deadline_t:
                ctx.deadline_shed("execute")
                return _error(504, MSG_DEADLINE_EXECUTE)
            if trace is not None:
                trace.add("admission", time.perf_counter() - t0)
            try:
                min_cadd, max_rank, limit, cursor = \
                    parse_region_params(query)
                cap = ctx.governor.region_limit_cap()
                if cap is not None:
                    # brownout level >= 1: bound per-request render work
                    limit = min(limit, cap)
                t_dev = time.perf_counter()
                with reqtrace_mod.activate(trace):
                    kind, payload = ctx.engine.region_serve(
                        spec,
                        min_cadd=min_cadd,
                        max_conseq_rank=max_rank,
                        limit=limit,
                        cursor=cursor,
                        stream_threshold=(
                            self.stream_threshold if http11 else None
                        ),
                    )
                if trace is not None:
                    trace.add("device", time.perf_counter() - t_dev)
            except QueryError as err:
                ctx.errored("region")
                return _error(400, str(err))
            except Exception as err:
                ctx.errored("region")
                return _error(500, f"{type(err).__name__}: {err}")
            if kind == "text":
                m = _RETURNED_RE.search(payload[:256])
                returned = int(m.group(1)) if m else 0
                ctx.observe("region", time.perf_counter() - t0,
                            rows=returned)
                return _resp(200, payload)
            stream_holds_slot = True
            return ("stream", payload)  # the writer releases that slot
        finally:
            if not stream_holds_slot:
                ctx.release()

    # -- admission / freshness ----------------------------------------------

    def _client_key(self, headers: dict, writer) -> tuple:
        """(bucket key, clamped weight) for this request.  Only called
        with a live governor — key scoping lives in ``resolve_key``."""
        peer = writer.get_extra_info("peername")
        peer_key = str(peer[0]) if peer else "anonymous"
        key = self.governor.resolve_key(peer_key, headers.get("x-client-id"))
        try:
            weight = int(headers.get("x-client-weight", "1"))
        except ValueError:
            weight = 1
        return key, weight

    def _admit_client(self, headers: dict, writer) -> float:
        """Per-client weighted admission: 0.0 = run it, else retry-after."""
        if self.governor is None:
            return 0.0
        key, weight = self._client_key(headers, writer)
        return self.governor.admit(key, weight)

    def _maybe_refresh_snapshot(self) -> None:
        """TTL-coalesced freshness: the cheap due-check runs in-line; the
        (rare) stat+load runs on the pool so a commit swap never stalls
        the event loop — readers serve the old pin meanwhile."""
        due = self._refresh_due
        if due is not None and not self._refresh_inflight and due():
            # one in-flight refresh at a time: a saturated pool must not
            # accumulate duplicate no-op tasks behind slow region renders
            # (the flag flips on the loop thread only; the done-callback
            # reset races at worst into one extra due() check)
            self._refresh_inflight = True
            fut = self._pool.submit(self.ctx.refresh_snapshot)
            fut.add_done_callback(
                lambda _f: setattr(self, "_refresh_inflight", False)
            )

    # -- streaming ----------------------------------------------------------

    async def _stream_region(self, writer, page,
                             trace_id: str | None = None) -> None:
        """Chunked transfer of one RegionPage — or one RegionsResult,
        whose "rows" are whole per-interval envelopes (same
        prefix/rows/suffix surface): prefix, rows in
        ``_STREAM_ROWS_PER_CHUNK`` batches (rendered lazily — RSS holds
        one batch, not the body), suffix.  De-chunked, the bytes are
        exactly ``page.assemble()``.

        A SIGTERM drain (or the drain-budget cancellation) arriving
        mid-stream must not tear the chunked framing: the stream CLEANLY
        TRUNCATES — close the variants array at a row boundary, append a
        ``"truncated": true`` trailer field, and emit the terminating
        0-chunk — so the client holds valid JSON that SAYS it is partial
        instead of a connection reset it must guess about."""
        head = _STATUS[200]
        if trace_id:
            head += _TRACE_HEADER_B + trace_id.encode("latin-1") + b"\r\n"
        writer.write(
            head
            + b"Content-Type: application/json\r\n"
            + b"Transfer-Encoding: chunked\r\n\r\n"
        )
        _write_chunk(writer, page.prefix().encode())
        buf: list[str] = []
        buf_bytes = 0
        first = True
        truncated = cancelled = False
        try:
            for row in page.rows():
                if self._stop is not None and self._stop.is_set():
                    # graceful drain: finish THIS response as truncated
                    # within the budget instead of racing the cancel
                    truncated = True
                    break
                buf.append(("" if first else ",") + row)
                buf_bytes += len(buf[-1])
                first = False
                # flush on a byte bound too: a RegionsResult "row" is a
                # whole per-interval envelope, and 256 of those must not
                # accumulate panel-sized RSS before the first write
                if len(buf) >= _STREAM_ROWS_PER_CHUNK \
                        or buf_bytes >= _WRITE_HIGH_WATER:
                    _write_chunk(writer, "".join(buf).encode())
                    buf.clear()
                    buf_bytes = 0
                    await writer.drain()  # flow control + loop fairness
        except asyncio.CancelledError:
            # the drain budget expired with this stream still writing:
            # terminate the framing before the cancellation propagates
            # (the writes below are synchronous buffer appends)
            truncated = cancelled = True
        if buf:
            _write_chunk(writer, "".join(buf).encode())
        if truncated:
            _write_chunk(writer, b'],"truncated":true}')
        else:
            _write_chunk(writer, page.suffix().encode())
        writer.write(b"0\r\n\r\n")
        if cancelled:
            raise asyncio.CancelledError
        await writer.drain()


def _resolve_pending(fut: asyncio.Future, pending) -> None:
    """Completion hook target (runs on the loop via call_soon_threadsafe)."""
    if fut.cancelled():
        return
    if pending.error is not None:
        fut.set_exception(pending.error)
    else:
        fut.set_result(pending.result)


def _write_chunk(writer, data: bytes) -> None:
    if data:
        writer.write(b"%x\r\n" % len(data) + data + b"\r\n")




def build_aio_server(store_dir: str | None = None, manager=None,
                     host: str = "127.0.0.1", port: int = 0, sock=None,
                     max_batch: int | None = None,
                     max_wait_s: float | None = None,
                     max_queue: int | None = None,
                     region_cache_size: int | None = None,
                     registry: MetricsRegistry | None = None,
                     residency=None, memtable=None,
                     client_rate: float | None = None,
                     stream_threshold: int | None = None,
                     heartbeat_file: str | None = None,
                     heartbeat_index: int = 0,
                     log=None, device=None, flight=None,
                     telemetry_dir: str | None = None,
                     health=None, tracer=None) -> AioServer:
    """Wire manager -> engine (on ``device``: ``cuda`` unless the caller
    asks for ``cpu``) -> loop batcher -> event-loop server (not yet
    serving; call ``serve_forever`` or ``start_background``).  The engine
    gets the same breaker, residency and kernels as ``build_server``'s.
    The caller owns shutdown order: ``server.shutdown()`` then
    ``server.ctx.batcher.close()`` — same contract as ``build_server``.
    ``heartbeat_file``/``heartbeat_index`` are a fleet worker's watchdog
    slot; ``memtable`` enables ``POST /variants/upsert``; ``tracer`` (a
    ``serve --traceOut`` Chrome tracer) gets one ``serve.batch`` span a
    drain."""
    if manager is None:
        if store_dir is None:
            raise ValueError("build_aio_server needs store_dir or manager")
        manager = SnapshotManager(store_dir, log=log)
    registry = registry if registry is not None else MetricsRegistry()
    from annotatedvdb_tpu_torch.serve.mesh_exec import serve_mesh_executor

    breaker = DeviceBreaker(registry=registry, log=log)
    engine = QueryEngine(
        manager, registry=registry, region_cache_size=region_cache_size,
        residency=residency, breaker=breaker, device=device,
        # the mesh state budget rides the residency manager's already-
        # split per-device share (env/flag -> per-worker -> per-device),
        # never the raw env
        mesh=serve_mesh_executor(
            registry=registry, breaker=breaker, log=log,
            budget_bytes=residency.budget if residency is not None
            else None,
            device=device,
        ),
    )
    batcher = LoopBatcher(
        engine, max_batch=max_batch, max_wait_s=max_wait_s,
        max_queue=max_queue, tracer=tracer, registry=registry,
    )
    ctx = ServeContext(manager, engine, batcher, registry,
                       memtable=memtable, log=log, flight=flight,
                       telemetry_dir=telemetry_dir, tracer=tracer,
                       worker_index=heartbeat_index, health=health)
    return AioServer(
        ctx, host=host, port=port, sock=sock, client_rate=client_rate,
        stream_threshold=stream_threshold,
        heartbeat_file=heartbeat_file, heartbeat_index=heartbeat_index,
    )
