"""Stdlib JSON API over the query engine: the thread-per-connection front
end (``serve --frontend threaded``).

Port of ``annotatedvdb_tpu/serve/http.py``'s threaded server, the
reference's byte-parity front end: ``ThreadingHTTPServer`` (one thread per
connection; point queries coalesce in the batcher) with these routes:

====================================  =====================================
``GET /healthz``, ``GET /readyz``     liveness / readiness
``GET /metrics``                      Prometheus exposition of the registry
``GET /stats``                        batcher, residency, brownout, breaker
``GET /variant/<chr:pos:ref:alt>``    point lookup (through the batcher)
``POST /variants``                    bulk: ``{"ids": [...]}``
``GET /region/<chr:start-end>``       ``?minCadd=&maxConseqRank=&limit=
                                      &cursor=``
``POST /regions``                     batch region join (BITS), count-only
                                      and ``tokenize``
``POST /stats/region``                the fused analytics panel
                                      (``metrics``, ``windows``)
``GET /export/stream``                one packed corpus batch of a region
                                      slice (``region``, ``batch``,
                                      ``batch_rows``, ``seed``,
                                      ``ordered``)
====================================  =====================================

Admission is bounded everywhere (429), the brownout ladder sheds bulk
work (503), deadlines shed dead requests (504), client errors are 400,
engine faults 500; error bodies are JSON.  Every other path — among them
the reference's ``/variants/upsert``, the replication routes
(``/repl/manifest``, ``/repl/segment``, ``/repl/wal``), ``/alerts``,
``/metrics/history``, ``/debug/trace`` and ``/_chaos``, not ported yet —
answers the reference's unknown-route 404.  ``/metrics``
renders this process's registry (the reference's ``?fleet=1`` view is not
ported).
"""

from __future__ import annotations

import itertools
import json
import os
import re
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, unquote, urlparse

from annotatedvdb_tpu_torch.export.stream import (
    STREAM_ROUTE as EXPORT_STREAM_ROUTE,
)
from annotatedvdb_tpu_torch.export.stream import (
    parse_stream_query,
    stream_payload,
)
from annotatedvdb_tpu_torch.obs import reqtrace as reqtrace_mod
from annotatedvdb_tpu_torch.obs.metrics import MetricsRegistry
from annotatedvdb_tpu_torch.obs.reqtrace import TraceRecorder
from annotatedvdb_tpu_torch.serve import resilience
from annotatedvdb_tpu_torch.serve.batcher import QueryBatcher, QueueFull
from annotatedvdb_tpu_torch.serve.engine import QueryEngine, QueryError
from annotatedvdb_tpu_torch.serve.resilience import (
    DeadlineExceeded,
    DeviceBreaker,
    OverloadGovernor,
    PointCache,
)
from annotatedvdb_tpu_torch.serve.snapshot import SnapshotManager
from annotatedvdb_tpu_torch.utils.locks import make_lock

#: pulls "returned":N out of the region envelope prefix (fixed field order)
_RETURNED_RE = re.compile(r'"returned":(\d+)')

#: per-request latency histogram edges (seconds; sub-ms to 2.5 s)
QUERY_SECONDS_EDGES = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5,
)

#: default row cap for region responses (explicit ``?limit=`` overrides)
DEFAULT_REGION_LIMIT = 10_000

#: the query kinds with their own request/latency/rows series
QUERY_KINDS = ("point", "bulk", "region", "regions", "stats", "export")


def healthz_payload(ctx) -> str:
    """The ``/healthz`` body (liveness; ``ready`` mirrors ``/readyz``).
    The health plane is not ported, so its alert fields read 0 and
    ``"disabled"``, as the reference's do without one."""
    snap = ctx.manager.current()
    ready, _reason = ctx.ready_state()
    return json.dumps({
        "status": "ok",
        "ready": ready,
        "generation": snap.generation,
        "rows": snap.store.n,
        "shards": len(snap.store.shards),
        "queue_depth": ctx.batcher.depth(),
        "brownout_level": ctx.governor.level,
        "brownout": ctx.governor.level_name,
        "breaker_open": len(
            ctx.engine.breaker.open_groups()
        ) if ctx.engine.breaker is not None else 0,
        "alerts_firing": 0,
        "alerts": "disabled",
    })


def readyz_payload(ctx) -> tuple[int, str]:
    """(status, body) for ``/readyz``: 503 while a snapshot swap loads or
    the brownout ladder sheds bulk work."""
    ready, reason = ctx.ready_state()
    body = json.dumps({"ready": ready, "reason": reason})
    return (200 if ready else 503), body


def stats_payload(ctx) -> str:
    """The ``/stats`` body."""
    snap = ctx.manager.current()
    stats = {
        "generation": snap.generation,
        "rows": snap.store.n,
        "snapshot_swaps": ctx.manager.swaps,
        "batcher": ctx.batcher.drain_stats(),
    }
    if ctx.engine.residency is not None:
        stats["residency"] = ctx.engine.residency.stats()
    stats["brownout"] = {
        "level": ctx.governor.level, "name": ctx.governor.level_name,
    }
    if ctx.engine.breaker is not None:
        stats["breaker"] = ctx.engine.breaker.stats()
    return json.dumps(stats)


#: the trace-id echo header returned on every response
TRACE_HEADER = "X-Request-Id"

_TRACEPARENT_RE = re.compile(
    r"^[0-9a-f]{2}-([0-9a-f]{32})-[0-9a-f]{16}-[0-9a-f]{2}$"
)
_TRACE_ID_STRIP_RE = re.compile(r"[^0-9A-Za-z._:\-]")

#: minted-id generator state: 96 random bits drawn once per process + a
#: 32-bit counter (no syscall per request)
_MINT_PREFIX = os.urandom(12).hex()
_MINT_SEQ = itertools.count(1)


def resolve_trace_id(traceparent: str | None,
                     x_request_id: str | None) -> str:
    """The request's trace id: a well-formed W3C ``traceparent``'s trace-id
    field, else a client ``X-Request-Id`` (sanitized, capped at 64), else
    a fresh 128-bit hex id."""
    if traceparent:
        m = _TRACEPARENT_RE.match(traceparent.strip().lower())
        if m and m.group(1) != "0" * 32:
            return m.group(1)
    if x_request_id:
        tid = _TRACE_ID_STRIP_RE.sub("", x_request_id.strip())[:64]
        if tid:
            return tid
    return _MINT_PREFIX + format(next(_MINT_SEQ) & 0xFFFFFFFF, "08x")


def parse_region_params(query: str):
    """``(min_cadd, max_conseq_rank, limit, cursor)`` from a region query
    string.  Raises :class:`QueryError` on a bad value;
    ``keep_blank_values`` so ``?cursor=`` (start a paged walk) survives."""
    params = parse_qs(query, keep_blank_values=True)

    def num(name, cast):
        vals = params.get(name)
        # a blank value is an absent filter
        if not vals or vals[0] == "":
            return None
        try:
            return cast(vals[0])
        except ValueError:
            raise QueryError(
                f"bad query parameter {name}={vals[0]!r}"
            ) from None

    limit = num("limit", int)  # explicit 0 = count-only query
    return (
        num("minCadd", float),
        num("maxConseqRank", int),
        DEFAULT_REGION_LIMIT if limit is None else limit,
        params.get("cursor", [None])[0],  # "" starts paging
    )


#: the grammar message for a malformed /regions body
REGIONS_BODY_ERROR = (
    'regions body must be {"regions": ["chr:start-end", ...]} with '
    'optional numeric "minCadd"/"maxConseqRank"/"limit" and boolean '
    '"tokenize"'
)

#: response-shaping messages
BULK_BODY_ERROR = 'bulk body must be {"ids": ["chr:pos:ref:alt", ...]}'
MSG_DEADLINE_ADMISSION = "deadline exhausted at admission"
MSG_DEADLINE_EXECUTE = "deadline exhausted before execution"
MSG_BROWNOUT_BULK = (
    "brownout: bulk reads shed (point reads keep serving)"
)
MSG_BROWNOUT_REGION = (
    "brownout: region reads shed (point reads keep serving)"
)
MSG_BROWNOUT_STATS = (
    "brownout: analytics queries shed (point reads keep serving)"
)
MSG_CAPACITY_BULK = "server at capacity (bulk admission bound)"
MSG_CAPACITY_REGION = "server at capacity (region admission bound)"
MSG_CAPACITY_STATS = "server at capacity (stats admission bound)"
MSG_BROWNOUT_EXPORT = (
    "brownout: export reads shed (point reads keep serving)"
)
MSG_CAPACITY_EXPORT = "server at capacity (export admission bound)"

#: the analytics route path
STATS_ROUTE = "/stats/region"

#: the grammar message for a malformed /stats/region body
STATS_BODY_ERROR = (
    'stats body must be {"regions": ["chr:start-end", ...]} with '
    'optional "metrics" (a non-empty subset of ["af", "cadd", '
    '"conseq"]) and integer "windows"'
)


def parse_stats_body(body: bytes):
    """``(specs, metrics, windows)`` from a ``POST /stats/region`` body.
    Shape/type errors raise :class:`QueryError` here; per-spec grammar,
    metric names and the windows range are the engine's to check."""
    try:
        obj = json.loads(body or b"{}")
    except ValueError:
        raise QueryError(STATS_BODY_ERROR) from None
    if not isinstance(obj, dict):
        raise QueryError(STATS_BODY_ERROR)
    specs = obj.get("regions")
    if not isinstance(specs, list) \
            or not all(isinstance(s, str) for s in specs):
        raise QueryError(STATS_BODY_ERROR)
    metrics = obj.get("metrics")
    if metrics is not None and (
            not isinstance(metrics, list)
            or not all(isinstance(m, str) for m in metrics)):
        raise QueryError(STATS_BODY_ERROR)
    windows = obj.get("windows")
    if windows is not None and (isinstance(windows, bool)
                                or not isinstance(windows, int)):
        raise QueryError(f"bad stats field windows={windows!r}")
    return specs, metrics, windows


def parse_regions_body(body: bytes):
    """``(specs, min_cadd, max_conseq_rank, limit, tokenize)`` from a
    ``POST /regions`` body.  Raises :class:`QueryError` on any malformed
    field; the per-spec region grammar is the engine's to check."""
    try:
        obj = json.loads(body or b"{}")
    except ValueError:
        raise QueryError(REGIONS_BODY_ERROR) from None
    if not isinstance(obj, dict):
        raise QueryError(REGIONS_BODY_ERROR)
    specs = obj.get("regions")
    if not isinstance(specs, list) \
            or not all(isinstance(s, str) for s in specs):
        raise QueryError(REGIONS_BODY_ERROR)

    def num(name, kinds):
        v = obj.get(name)
        if v is None:
            return None
        if isinstance(v, bool) or not isinstance(v, kinds):
            raise QueryError(f"bad regions field {name}={v!r}")
        return v

    limit = num("limit", int)
    tokenize = obj.get("tokenize", False)
    if not isinstance(tokenize, bool):
        raise QueryError(f"bad regions field tokenize={tokenize!r}")
    return (
        specs,
        num("minCadd", (int, float)),
        num("maxConseqRank", int),
        DEFAULT_REGION_LIMIT if limit is None else limit,
        tokenize,
    )


class ServeContext:
    """Everything a handler thread needs, shared across requests."""

    def __init__(self, manager, engine: QueryEngine, batcher: QueryBatcher,
                 registry: MetricsRegistry, max_inflight: int | None = None,
                 log=None):
        self.manager = manager
        self.engine = engine
        self.batcher = batcher
        self.registry = registry
        self.max_inflight = (
            max_inflight if max_inflight is not None else batcher.max_queue
        )
        self.log = log if log is not None else (lambda msg: None)
        self._lock = make_lock("serve.ctx.inflight")
        #: guarded by self._lock
        self._inflight = 0
        #: default per-request deadline budget (0 = none unless the client
        #: sends X-Deadline-Ms)
        self.default_deadline_s = resilience.default_deadline_s()
        #: the brownout ladder, stepped on request completion and probes
        self.governor = OverloadGovernor(
            depth_fn=batcher.depth, max_queue=batcher.max_queue,
            registry=registry,
        )
        self.reqtrace = TraceRecorder(registry, log=self.log)
        #: generation-keyed id -> record cache (the cache_first rung)
        self.point_cache = PointCache()
        self._m_inflight = registry.gauge(
            "avdb_serve_inflight", "bulk/region requests being executed"
        )
        self._m_swaps = registry.counter(
            "avdb_serve_snapshot_swaps_total",
            "store generation swaps observed by the server",
        )
        self._m_deadline_shed = {
            stage: registry.counter(
                "avdb_deadline_shed_total",
                "requests shed because their deadline budget ran out",
                {"stage": stage},
            )
            for stage in ("admission", "execute")
        }
        self._m_brownout_shed = registry.counter(
            "avdb_serve_brownout_shed_total",
            "bulk/region requests rejected by the brownout ladder",
        )
        self._m_point_cache_hits = registry.counter(
            "avdb_serve_point_cache_hits_total",
            "point reads served cache-first under brownout",
        )
        self._m_abandoned = registry.counter(
            "avdb_serve_abandoned_responses_total",
            "responses dropped because the client connection died first",
        )
        # per-kind series resolved once (the registry probe is measurable
        # at serving QPS)
        self._kind = {}
        for kind in QUERY_KINDS:
            labels = {"kind": kind}
            self._kind[kind] = (
                registry.counter(
                    "avdb_query_requests_total", "queries served", labels
                ),
                registry.histogram(
                    "avdb_query_seconds", QUERY_SECONDS_EDGES,
                    "request latency by query kind", labels,
                ),
                registry.counter(
                    "avdb_query_rows_total", "result rows returned", labels
                ),
                registry.counter(
                    "avdb_query_rejected_total",
                    "queries rejected at the admission bound (HTTP 429)",
                    labels,
                ),
                registry.counter(
                    "avdb_query_errors_total",
                    "queries that failed (HTTP 4xx grammar / 5xx engine)",
                    labels,
                ),
            )

    # -- per-kind metrics ---------------------------------------------------

    def observe(self, kind: str, seconds: float, rows: int = 0) -> None:
        requests, seconds_h, rows_c, _rej, _err = self._kind[kind]
        requests.inc()
        seconds_h.observe(seconds)
        if rows:
            rows_c.inc(rows)
        self.governor.note_latency(seconds)
        self.governor.maybe_step()

    def rejected(self, kind: str) -> None:
        self._kind[kind][3].inc()

    def errored(self, kind: str) -> None:
        self._kind[kind][4].inc()

    # -- resilience ---------------------------------------------------------

    def request_deadline(self, header_value: str | None) -> float | None:
        """Absolute monotonic deadline for a request arriving now."""
        return resilience.deadline_at(header_value, self.default_deadline_s)

    def deadline_shed(self, stage: str) -> None:
        self._m_deadline_shed[stage].inc()

    def brownout_shed(self) -> None:
        self._m_brownout_shed.inc()

    def abandoned(self) -> None:
        """A response that never reached the wire (the aio front end's
        client died first)."""
        self._m_abandoned.inc()

    def point_preflight(self, variant_id: str, deadline_t: float | None):
        """The point-read admission decision: ``("shed", None)`` (deadline
        dead at admission), ``("cached", record)`` (cache-first answer;
        None = cached absence) or ``("submit", generation)`` (through the
        batcher, caching the result under that generation)."""
        if deadline_t is not None and time.monotonic() >= deadline_t:
            self.deadline_shed("admission")
            return "shed", None
        if self.governor.cache_first():
            hit, record = self.point_cache.get(
                self.manager.current().generation, variant_id
            )
            if hit:
                self._m_point_cache_hits.inc()
                return "cached", record
        return "submit", self.manager.current().generation

    def remember_point(self, generation: int, variant_id: str,
                       record) -> None:
        self.point_cache.put(generation, variant_id, record)

    def ready_state(self) -> tuple[bool, str]:
        """(ready, reason): not ready while a snapshot swap loads or the
        brownout ladder sheds bulk work.  Probes step the ladder too, so
        an idle server de-escalates."""
        self.governor.maybe_step()
        if getattr(self.manager, "swapping", False):
            return False, "snapshot swap in progress"
        if self.governor.shed_bulk():
            return False, f"brownout level {self.governor.level} " \
                          f"({self.governor.level_name})"
        return True, "ok"

    # -- admission ----------------------------------------------------------

    def admit(self) -> bool:
        """Reserve one bulk/region execution slot; False = reject (429)."""
        with self._lock:
            if self._inflight >= self.max_inflight:
                return False
            self._inflight += 1
            depth = self._inflight
        self._m_inflight.set(depth)
        return True

    def release(self) -> None:
        with self._lock:
            self._inflight -= 1
            depth = self._inflight
        self._m_inflight.set(depth)

    def refresh_snapshot(self) -> None:
        """Pick up a loader commit if one landed (at most one manifest
        ``stat`` per TTL window); a refresh failure keeps serving the
        pinned generation."""
        try:
            if self.manager.maybe_refresh():
                self._m_swaps.inc()
        except Exception as err:
            self.log(f"snapshot refresh errored: {err}")


class ServeHandler(BaseHTTPRequestHandler):
    """Routes one request; all state lives on ``self.server.ctx``."""

    server_version = "avdb-serve/1"
    protocol_version = "HTTP/1.1"

    #: this request's resolved trace id, echoed on every response
    _trace_id: str | None = None

    # -- plumbing -----------------------------------------------------------

    def log_message(self, format, *args):  # stdlib signature
        self.server.ctx.log(f"{self.address_string()} {format % args}")

    def _reply(self, status: int, body,
               content_type: str = "application/json") -> None:
        payload = body.encode() if isinstance(body, str) else body
        self.send_response(status)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(payload)))
        if self._trace_id is not None:
            self.send_header(TRACE_HEADER, self._trace_id)
        if status in (429, 503):
            self.send_header("Retry-After", "1")
        self.end_headers()
        try:
            self.wfile.write(payload)
        except (BrokenPipeError, ConnectionResetError):
            pass  # client hung up mid-response

    def _error(self, status: int, message: str) -> None:
        self._reply(status, json.dumps({"error": message}))

    # -- routes -------------------------------------------------------------

    def do_GET(self):
        ctx = self.server.ctx
        url = urlparse(self.path)
        path = unquote(url.path)
        self._trace_id = resolve_trace_id(
            self.headers.get("traceparent"),
            self.headers.get(TRACE_HEADER),
        )
        if path == "/healthz":
            ctx.refresh_snapshot()
            self._reply(200, healthz_payload(ctx))
            return
        if path == "/readyz":
            ctx.refresh_snapshot()
            status, body = readyz_payload(ctx)
            self._reply(status, body)
            return
        if path == "/metrics":
            self._reply(200, ctx.registry.render_prometheus(),
                        content_type="text/plain; version=0.0.4")
            return
        if path == "/stats":
            self._reply(200, stats_payload(ctx))
            return
        if path == EXPORT_STREAM_ROUTE:
            self._export_stream(ctx, url.query)
            return
        if path.startswith("/variant/"):
            self._point(ctx, path[len("/variant/"):])
            return
        if path.startswith("/region/"):
            self._region(ctx, path[len("/region/"):], url.query)
            return
        self._error(404, f"no such route: {path}")

    def do_POST(self):
        ctx = self.server.ctx
        path = unquote(urlparse(self.path).path)
        self._trace_id = resolve_trace_id(
            self.headers.get("traceparent"),
            self.headers.get(TRACE_HEADER),
        )
        if path == "/variants":
            self._bulk(ctx)
            return
        if path == "/regions":
            self._regions(ctx)
            return
        if path == STATS_ROUTE:
            self._stats(ctx)
            return
        self._error(404, f"no such route: {path}")

    # -- query kinds --------------------------------------------------------

    def _point(self, ctx: ServeContext, variant_id: str) -> None:
        t0 = time.perf_counter()
        trace = ctx.reqtrace.begin(self._trace_id, "point")
        ctx.refresh_snapshot()
        deadline_t = ctx.request_deadline(self.headers.get("X-Deadline-Ms"))
        action, payload = ctx.point_preflight(variant_id, deadline_t)
        if action == "shed":
            ctx.reqtrace.finish(trace, 504)
            self._error(504, MSG_DEADLINE_ADMISSION)
            return
        if action == "cached":
            if payload is None:
                ctx.observe("point", time.perf_counter() - t0)
                ctx.reqtrace.finish(trace, 404)
                self._error(404, f"variant {variant_id!r} not in store")
            else:
                ctx.observe("point", time.perf_counter() - t0, rows=1)
                ctx.reqtrace.finish(trace, 200)
                self._reply(200, payload)
            return
        generation = payload
        if trace is not None:
            trace.add("admission", time.perf_counter() - t0)
        try:
            record = ctx.batcher.submit(variant_id, deadline_t=deadline_t,
                                        trace=trace)
        except QueueFull as err:
            ctx.rejected("point")
            ctx.reqtrace.finish(trace, 429)
            self._error(429, str(err))
            return
        except DeadlineExceeded as err:
            ctx.reqtrace.finish(trace, 504)
            self._error(504, str(err))
            return
        except QueryError as err:
            ctx.errored("point")
            ctx.reqtrace.finish(trace, 400)
            self._error(400, str(err))
            return
        except Exception as err:
            ctx.errored("point")
            ctx.reqtrace.finish(trace, 500)
            self._error(500, f"{type(err).__name__}: {err}")
            return
        t_render = time.perf_counter()
        ctx.remember_point(generation, variant_id, record)
        if record is None:
            ctx.observe("point", time.perf_counter() - t0)
            ctx.reqtrace.finish(trace, 404)
            self._error(404, f"variant {variant_id!r} not in store")
            return
        ctx.observe("point", time.perf_counter() - t0, rows=1)
        if trace is not None:
            trace.add("render", time.perf_counter() - t_render)
        ctx.reqtrace.finish(trace, 200)
        self._reply(200, record)

    def _admit_bulk(self, ctx: ServeContext, kind: str, brownout_msg: str,
                    capacity_msg: str):
        """The bulk admission shape shared by bulk, region, regions and
        stats: brownout shed (503), deadline at admission (504), an
        in-flight slot (429).  Returns the request's deadline, or False
        when the request was answered here."""
        if ctx.governor.shed_bulk():
            ctx.brownout_shed()
            self._error(503, brownout_msg)
            return False
        deadline_t = ctx.request_deadline(self.headers.get("X-Deadline-Ms"))
        if deadline_t is not None and time.monotonic() >= deadline_t:
            ctx.deadline_shed("admission")
            self._error(504, MSG_DEADLINE_ADMISSION)
            return False
        if not ctx.admit():
            ctx.rejected(kind)
            self._error(429, capacity_msg)
            return False
        return deadline_t

    def _read_body(self) -> bytes:
        length = int(self.headers.get("Content-Length", 0))
        return self.rfile.read(length) if length else b""

    def _execute(self, ctx: ServeContext, kind: str, t0: float, run) -> None:
        """Run ``run()`` (the engine call, returning ``(body, rows)``) under
        the request's trace, mapping QueryError to 400 and any other
        failure to 500."""
        trace = ctx.reqtrace.begin(self._trace_id, kind)
        if trace is not None:
            trace.add("admission", time.perf_counter() - t0)
        try:
            t_dev = time.perf_counter()
            with reqtrace_mod.activate(trace):
                body, rows = run()
            if trace is not None:
                trace.add("device", time.perf_counter() - t_dev)
        except QueryError as err:
            ctx.errored(kind)
            ctx.reqtrace.finish(trace, 400)
            self._error(400, str(err))
            return
        except Exception as err:
            ctx.errored(kind)
            ctx.reqtrace.finish(trace, 500)
            self._error(500, f"{type(err).__name__}: {err}")
            return
        ctx.observe(kind, time.perf_counter() - t0, rows=rows)
        ctx.reqtrace.finish(trace, 200)
        self._reply(200, body)

    def _bulk(self, ctx: ServeContext) -> None:
        t0 = time.perf_counter()
        deadline_t = self._admit_bulk(ctx, "bulk", MSG_BROWNOUT_BULK,
                                      MSG_CAPACITY_BULK)
        if deadline_t is False:
            return
        try:
            ctx.refresh_snapshot()
            try:
                body = json.loads(self._read_body() or b"{}")
                ids = body["ids"]
                if not isinstance(ids, list) \
                        or not all(isinstance(i, str) for i in ids):
                    raise KeyError("ids")
            except (ValueError, KeyError, TypeError):
                ctx.errored("bulk")
                self._error(400, BULK_BODY_ERROR)
                return
            if deadline_t is not None and time.monotonic() >= deadline_t:
                ctx.deadline_shed("execute")
                self._error(504, MSG_DEADLINE_EXECUTE)
                return

            def run():
                results = ctx.engine.lookup_many(ids)
                found = sum(1 for r in results if r is not None)
                return (
                    f'{{"n":{len(results)},"found":{found},"results":['
                    + ",".join(r if r is not None else "null"
                               for r in results)
                    + "]}"
                ), found

            self._execute(ctx, "bulk", t0, run)
        finally:
            ctx.release()

    def _regions(self, ctx: ServeContext) -> None:
        """Batch region join through the engine's batched BITS path."""
        t0 = time.perf_counter()
        deadline_t = self._admit_bulk(ctx, "regions", MSG_BROWNOUT_REGION,
                                      MSG_CAPACITY_REGION)
        if deadline_t is False:
            return
        try:
            ctx.refresh_snapshot()
            try:
                specs, min_cadd, max_rank, limit, tokenize = \
                    parse_regions_body(self._read_body())
            except (ValueError, QueryError) as err:
                ctx.errored("regions")
                self._error(400, str(err) if isinstance(err, QueryError)
                            else REGIONS_BODY_ERROR)
                return
            if deadline_t is not None and time.monotonic() >= deadline_t:
                ctx.deadline_shed("execute")
                self._error(504, MSG_DEADLINE_EXECUTE)
                return
            cap = ctx.governor.region_limit_cap()
            if cap is not None:
                limit = min(limit, cap)  # brownout level >= 1

            def run():
                result = ctx.engine.regions_serve(
                    specs, min_cadd=min_cadd, max_conseq_rank=max_rank,
                    limit=limit, tokenize=tokenize,
                )
                return result.assemble(), result.returned

            self._execute(ctx, "regions", t0, run)
        finally:
            ctx.release()

    def _stats(self, ctx: ServeContext) -> None:
        """Analytics panel through the engine's fused stats path."""
        t0 = time.perf_counter()
        deadline_t = self._admit_bulk(ctx, "stats", MSG_BROWNOUT_STATS,
                                      MSG_CAPACITY_STATS)
        if deadline_t is False:
            return
        try:
            ctx.refresh_snapshot()
            try:
                specs, metrics, windows = parse_stats_body(self._read_body())
            except (ValueError, QueryError) as err:
                ctx.errored("stats")
                self._error(400, str(err) if isinstance(err, QueryError)
                            else STATS_BODY_ERROR)
                return
            if deadline_t is not None and time.monotonic() >= deadline_t:
                ctx.deadline_shed("execute")
                self._error(504, MSG_DEADLINE_EXECUTE)
                return

            def run():
                result = ctx.engine.stats_serve(specs, metrics=metrics,
                                                windows=windows)
                return result.assemble(), result.returned

            self._execute(ctx, "stats", t0, run)
        finally:
            ctx.release()

    def _export_stream(self, ctx: ServeContext, query: str) -> None:
        """One packed corpus batch of a region slice: the bulk admission
        shape, then :func:`stream_payload` (the ``export_pack`` kernel
        behind the engine's breaker)."""
        t0 = time.perf_counter()
        if self._admit_bulk(ctx, "export", MSG_BROWNOUT_EXPORT,
                            MSG_CAPACITY_EXPORT) is False:
            return
        try:
            ctx.refresh_snapshot()
            try:
                params = parse_stream_query(query)
            except ValueError as err:
                ctx.errored("export")
                self._error(400, str(err))
                return
            self._execute(ctx, "export", t0,
                          lambda: stream_payload(ctx.engine, params))
        finally:
            ctx.release()

    def _region(self, ctx: ServeContext, spec: str, query: str) -> None:
        t0 = time.perf_counter()
        if self._admit_bulk(ctx, "region", MSG_BROWNOUT_REGION,
                            MSG_CAPACITY_REGION) is False:
            return
        try:
            ctx.refresh_snapshot()

            def run():
                min_cadd, max_rank, limit, cursor = parse_region_params(query)
                cap = ctx.governor.region_limit_cap()
                if cap is not None:
                    limit = min(limit, cap)  # brownout level >= 1
                text = ctx.engine.region(
                    spec, min_cadd=min_cadd, max_conseq_rank=max_rank,
                    limit=limit, cursor=cursor,
                )
                # the row count sits in the fixed-format envelope prefix
                m = _RETURNED_RE.search(text[:256])
                return text, int(m.group(1)) if m else 0

            self._execute(ctx, "region", t0, run)
        finally:
            ctx.release()


def build_server(store_dir: str | None = None, manager=None,
                 host: str = "127.0.0.1", port: int = 0,
                 max_batch: int | None = None,
                 max_wait_s: float | None = None,
                 max_queue: int | None = None,
                 region_cache_size: int | None = None,
                 registry: MetricsRegistry | None = None,
                 residency=None, log=None, device=None) -> ThreadingHTTPServer:
    """Wire manager -> engine (on ``device``: ``cuda`` unless the caller
    asks for ``cpu``) -> batcher -> HTTP server (not yet serving; call
    ``serve_forever`` or run it on a thread).  The server carries its
    :class:`ServeContext` as ``httpd.ctx``; callers own shutdown order:
    ``httpd.shutdown()`` then ``httpd.ctx.batcher.close()``."""
    if manager is None:
        if store_dir is None:
            raise ValueError("build_server needs store_dir or manager")
        manager = SnapshotManager(store_dir, log=log)
    registry = registry if registry is not None else MetricsRegistry()
    breaker = DeviceBreaker(registry=registry, log=log)
    engine = QueryEngine(
        manager, registry=registry, region_cache_size=region_cache_size,
        residency=residency, breaker=breaker, device=device,
    )
    batcher = QueryBatcher(
        engine, max_batch=max_batch, max_wait_s=max_wait_s,
        max_queue=max_queue, registry=registry,
    )
    httpd = ThreadingHTTPServer((host, port), ServeHandler)
    httpd.daemon_threads = True
    httpd.ctx = ServeContext(manager, engine, batcher, registry, log=log)
    return httpd
