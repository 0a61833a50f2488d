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

``POST /variants/upsert`` is the live write path (``serve --upserts``):
``{"variants": [{"id", "ref_snp"?, "annotations"?}, ...]}`` rows go to the
worker's memtable, and the 200 is sent only after their WAL frame is
fsynced.  Without a memtable it answers 403; under the free-disk reserve
507; on a replication follower (``serve --follow``) 403 with the leader's
location.

The replication ship surface (``store/replication.py``) serves any
on-disk store: ``GET /repl/manifest`` (the ship document: the manifest,
its fingerprint and fencing epoch, the WAL and ledger stable-prefix
listing) and ``GET /repl/segment`` / ``GET /repl/wal``
(``?name=&offset=&limit=``: raw bytes of one segment container, WAL file
or ``ledger.jsonl``, the last two clamped to their stable prefix).  A
follower's ``/readyz`` answers 503 while its replication lag exceeds
``AVDB_REPL_MAX_LAG_S``.

Admission is bounded everywhere (429), the brownout ladder sheds bulk
work (503), deadlines shed dead requests (504), client errors are 400,
engine faults 500; error bodies are JSON.

The health plane answers on both front ends: ``GET /metrics`` renders this
process's registry, and ``?fleet=1`` the fleet view (the workers'
published snapshots summed, gauges maxed, plus the supervisor's
``avdb_fleet_*`` series); ``GET /alerts`` the SLO alert states and
``GET /metrics/history`` the time-series ring as derived series (both
with ``?fleet=1`` views over the siblings' persisted history mirrors);
``/healthz`` carries the firing count and the worst alert state.

The chaos plane: under ``AVDB_SERVE_CHAOS=1`` both front ends answer
``GET /debug/trace`` (this process's span ring as Chrome trace events)
and the ``aio`` front end ``POST /_chaos`` (runtime fault arming); without
it both paths answer the unknown-route 404, byte for byte.
"""

from __future__ import annotations

import itertools
import json
import os
import re
import threading
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
from annotatedvdb_tpu_torch.obs.slo import worst_of
from annotatedvdb_tpu_torch.obs.timeseries import derive_series, load_history
from annotatedvdb_tpu_torch.serve import resilience
from annotatedvdb_tpu_torch.serve.batcher import QueryBatcher, QueueFull
from annotatedvdb_tpu_torch.serve.engine import (
    QueryEngine,
    QueryError,
    parse_variant_id,
)
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
QUERY_KINDS = ("point", "bulk", "region", "regions", "stats", "export",
               "upsert")


def healthz_payload(ctx) -> str:
    """The ``/healthz`` body (liveness; ``ready`` mirrors ``/readyz``),
    with the alert plane's one-glance summary: SLOs firing and the worst
    alert state (``"disabled"`` without a health plane)."""
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
        "alerts_firing": ctx.health.slos.firing()
        if ctx.health is not None else 0,
        "alerts": ctx.health.slos.worst_state()
        if ctx.health is not None else "disabled",
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


def chaos_enabled_from_env() -> bool:
    """``AVDB_SERVE_CHAOS`` — gates the runtime fault-arming route
    (``POST /_chaos``, aio only) AND the on-demand trace dump
    (``GET /debug/trace``, both front ends).  On a production server both
    routes 404 byte-identically to any unknown route."""
    return os.environ.get("AVDB_SERVE_CHAOS", "") == "1"


def debug_trace_payload(ctx) -> str:
    """The ``GET /debug/trace`` body — this process's span ring as Chrome
    trace-event JSON, shared by both front ends.  (The reference also
    merges a ``--traceOut`` batcher tracer's spans; that flag is refused
    here, so the ring is the whole dump, as in the reference without
    it.)"""
    events = ctx.reqtrace.chrome_events(base_ns=ctx.reqtrace.t0_ns)
    events.sort(key=lambda e: e.get("ts", 0))
    return json.dumps({"traceEvents": events, "displayTimeUnit": "ms"})


def metrics_payload(ctx, query: str) -> str:
    """The ``GET /metrics`` body — the ONE handler both front ends
    share.  Plain scrape = this worker's registry; ``?fleet=1`` = the
    fleet-wide view (workers' published snapshots summed/maxed, plus the
    supervisor's ``avdb_fleet_*`` series), answered by WHICHEVER worker
    the kernel handed the connection to."""
    params = parse_qs(query or "")
    if params.get("fleet", ["0"])[0] not in ("1", "true"):
        return ctx.registry.render_prometheus()
    return ctx.fleet_metrics()


def _fleet_wanted(query: str) -> bool:
    return parse_qs(query or "").get("fleet", ["0"])[0] in ("1", "true")


def _health_sibling_docs(ctx) -> dict:
    """Sibling workers' persisted health documents for the ``?fleet=1``
    alert/history views, keyed by worker index: the live ``w*.ts.json``
    mirrors under ``<store>/history``, TTL-aged exactly like the fleet
    metric snapshots (a dead worker's last mirror must age out — its
    HARVESTED history is ``doctor slo``'s business, not the live view's).
    Self is excluded; the live plane is fresher."""
    h = ctx.health
    docs: dict[int, dict] = {}
    if h is None or h.ring.path is None:
        return docs
    d = os.path.dirname(h.ring.path)
    now = time.time()
    if os.path.isdir(d):
        for fname in sorted(os.listdir(d)):
            if not fname.endswith(".ts.json"):
                continue
            try:
                doc = load_history(os.path.join(d, fname))
            except (OSError, ValueError, TypeError):
                continue  # torn persist race: skip, never fail a read
            idx = int(doc.get("worker", -1))
            if idx == ctx.worker_index:
                continue  # self: the live plane is fresher
            if now - float(doc.get("t", 0)) > ctx.FLEET_SNAPSHOT_TTL_S:
                continue  # a dead worker's stale mirror
            docs[idx] = doc
    return docs


def alerts_payload(ctx, query: str) -> str:
    """The ``GET /alerts`` body, shared by both front ends (the parity
    contract).  Plain = this worker's live SLO alert states;
    ``?fleet=1`` = per-worker states (self live, siblings from their
    persisted history mirrors, which carry the alert rows), rolled up
    into a fleet-wide ``firing`` count and worst ``state``."""
    h = ctx.health

    def solo() -> dict:
        if h is None or not h.enabled:
            return {"enabled": False, "worker": ctx.worker_index,
                    "state": "disabled", "firing": 0, "alerts": []}
        return {
            "enabled": True,
            "worker": ctx.worker_index,
            "state": h.slos.worst_state(),
            "firing": h.slos.firing(),
            "burn_threshold": h.slos.burn_threshold,
            "windows": {"fast_s": h.slos.fast_s, "slow_s": h.slos.slow_s},
            "alerts": h.slos.alerts(),
        }

    me = solo()
    if not _fleet_wanted(query):
        return json.dumps(me)
    workers = {str(ctx.worker_index): me}
    for idx, doc in _health_sibling_docs(ctx).items():
        rows = doc.get("alerts") or []
        workers[str(idx)] = {
            "enabled": True,
            "worker": idx,
            "state": worst_of(a.get("state", "ok") for a in rows),
            "firing": int(doc.get("firing") or 0),
            "alerts": rows,
        }
    return json.dumps({
        "fleet": True,
        "firing": sum(w["firing"] for w in workers.values()),
        "state": worst_of(w["state"] for w in workers.values()
                          if w["state"] != "disabled"),
        "workers": workers,
    })


#: the history route spelling, single-sourced for both front ends
HISTORY_ROUTE = "/metrics/history"


def metrics_history_payload(ctx, query: str) -> str:
    """The ``GET /metrics/history`` body — the time-series ring rendered
    as derived series (counters as per-interval rates, histograms as
    rate + p50/p99).  ``?window=S`` trims to the trailing S seconds (an
    unparsable value is ignored — a read surface does not 400 on a
    sloppy dashboard); ``?fleet=1`` = per-worker documents, self live
    and siblings from their persisted mirrors."""
    h = ctx.health
    params = parse_qs(query or "")
    try:
        window = float(params.get("window", [""])[0])
    except (ValueError, IndexError):
        window = 0.0

    def trim(samples: list) -> list:
        if window <= 0 or len(samples) < 2:
            return samples
        cutoff = float(samples[-1]["t"]) - window
        return [s for s in samples if float(s["t"]) >= cutoff]

    def render(worker: int, tick_s, history_s, samples: list) -> dict:
        samples = trim(samples)
        return {
            "enabled": True,
            "worker": worker,
            "tick_s": tick_s,
            "history_s": history_s,
            "samples": len(samples),
            "span_s": round(
                float(samples[-1]["t"]) - float(samples[0]["t"]), 3
            ) if len(samples) >= 2 else 0.0,
            "series": derive_series(samples),
        }

    def solo() -> dict:
        if h is None or not h.enabled:
            return {"enabled": False, "worker": ctx.worker_index,
                    "samples": 0, "span_s": 0.0, "series": []}
        return render(ctx.worker_index, h.ring.tick_s, h.ring.history_s,
                      h.ring.samples())

    me = solo()
    if not _fleet_wanted(query):
        return json.dumps(me)
    workers = {str(ctx.worker_index): me}
    for idx, doc in _health_sibling_docs(ctx).items():
        workers[str(idx)] = render(
            idx, doc.get("tick_s"), doc.get("history_s"),
            doc.get("samples") or [],
        )
    return json.dumps({"fleet": True, "workers": workers})


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
MSG_BROWNOUT_UPSERT = (
    "brownout: upserts shed (point reads keep serving)"
)
MSG_CAPACITY_UPSERT = "server at capacity (upsert admission bound)"
MSG_UPSERTS_DISABLED = (
    "upserts are not enabled on this server (start with --upserts or "
    "AVDB_SERVE_UPSERTS=1)"
)
#: the 507 body: free disk under the store fell below the configured
#: reserve, so new writes are refused while reads and flushes keep running
MSG_DISK_RESERVE = (
    "insufficient storage: free disk space is below the configured "
    "reserve (AVDB_STORE_DISK_RESERVE_BYTES); upserts are suspended "
    "until space is freed — reads, flushes of acknowledged rows, and "
    "compaction keep running"
)

#: the one grammar message for a malformed /variants/upsert body
UPSERT_BODY_ERROR = (
    'upsert body must be {"variants": [{"id": "chr:pos:ref:alt", '
    '"ref_snp": N?, "annotations": {<jsonb column>: <value>, ...}?}, ...]}'
)

#: rows per upsert call cap (a request is one WAL frame + one ack fsync;
#: bigger batches belong to the offline loaders)
UPSERT_MAX_ROWS = 4096

#: the live-write route, shared by both front ends
UPSERT_ROUTE = "/variants/upsert"


def parse_upsert_body(body: bytes) -> list[dict]:
    """Validated entries from a ``POST /variants/upsert`` JSON body, the
    one grammar both front ends share.  Returns ``[{"id", "ref_snp",
    "annotations"}, ...]``; raises :class:`QueryError` on any malformed
    field (the whole call fails: an upsert is atomic per request)."""
    from annotatedvdb_tpu_torch.store.variant_store import JSONB_COLUMNS

    try:
        obj = json.loads(body or b"{}")
    except ValueError:
        raise QueryError(UPSERT_BODY_ERROR) from None
    if not isinstance(obj, dict):
        raise QueryError(UPSERT_BODY_ERROR)
    variants = obj.get("variants")
    if not isinstance(variants, list) or not variants \
            or not all(isinstance(v, dict) for v in variants):
        raise QueryError(UPSERT_BODY_ERROR)
    if len(variants) > UPSERT_MAX_ROWS:
        raise QueryError(
            f"upsert of {len(variants)} rows exceeds the "
            f"{UPSERT_MAX_ROWS}-row cap; split the request (bulk loads "
            "belong to the offline loader CLIs)"
        )
    out = []
    for v in variants:
        vid = v.get("id")
        if not isinstance(vid, str):
            raise QueryError(UPSERT_BODY_ERROR)
        rs = v.get("ref_snp")
        if rs is not None and (isinstance(rs, bool)
                               or not isinstance(rs, int) or rs < 0):
            raise QueryError(f"bad upsert field ref_snp={rs!r}")
        ann = v.get("annotations")
        if ann is not None:
            if not isinstance(ann, dict):
                raise QueryError(UPSERT_BODY_ERROR)
            for col in ann:
                if col not in JSONB_COLUMNS:
                    raise QueryError(
                        f"unknown annotation column {col!r} (one of: "
                        + ", ".join(JSONB_COLUMNS) + ")"
                    )
        out.append({"id": vid, "ref_snp": rs, "annotations": ann})
    return out

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


#: the replication ship route spellings, shared by both front ends; the
#: follower's tailer (``store/replication.py``) fetches exactly these paths
REPL_MANIFEST_ROUTE = "/repl/manifest"
REPL_SEGMENT_ROUTE = "/repl/segment"
REPL_WAL_ROUTE = "/repl/wal"

#: server-side ceiling on one ship range read (the follower chunks at
#: AVDB_REPL_CHUNK_BYTES; this bounds a misconfigured client's single-
#: request memory on the leader)
REPL_MAX_RANGE_BYTES = 64 << 20

#: the 404 body when the ship surface has no on-disk store to serve from
#: (in-memory stores) — shared by both front ends
MSG_REPL_UNAVAILABLE = (
    "replication ship surface unavailable: this server has no on-disk "
    "store directory"
)


def follower_upsert_payload(ctx) -> str:
    """The 403 body an upsert gets on a replication follower — carries
    the leader's location so a well-behaved client redirects its writes
    (one builder for both front ends)."""
    return json.dumps({
        "error": "this server is a replication follower (read-only); "
                 "send writes to the leader",
        "leader": ctx.follow_url,
    })


def repl_manifest_payload(ctx) -> tuple[int, str]:
    """(status, body) for ``GET /repl/manifest`` — the leader's ship
    document (the consistent snapshot cut plus the WAL/ledger stable-
    prefix listing), built by
    :func:`annotatedvdb_tpu_torch.store.replication.ship_manifest`.  ONE
    builder for both front ends; the aio front end runs it on the
    executor pool (it stats and reads files)."""
    if ctx.repl_store_dir is None:
        return 404, json.dumps({"error": MSG_REPL_UNAVAILABLE})
    from annotatedvdb_tpu_torch.store.replication import ReplError, ship_manifest

    try:
        return 200, json.dumps(ship_manifest(ctx.repl_store_dir))
    except ReplError as err:
        return 503, json.dumps({"error": str(err)})


def repl_file_response(ctx, query: str) -> tuple[int, "bytes | str"]:
    """(status, body) for ``GET /repl/{segment,wal}?name=&offset=&limit=``
    — raw bytes (200) of one shippable file range, clamped to the file's
    stable prefix for WAL/ledger streams; a JSON error string otherwise.
    Both ship routes share this builder: the NAME (validated against the
    ship namespace by ``ship_file_range``) decides the clamping, never
    the route spelling — so a torn frame can never ship regardless of
    which route a client picked."""
    if ctx.repl_store_dir is None:
        return 404, json.dumps({"error": MSG_REPL_UNAVAILABLE})
    params = parse_qs(query or "")
    name = (params.get("name") or [""])[0]
    try:
        offset = int((params.get("offset") or ["0"])[0])
        limit = int((params.get("limit") or [str(REPL_MAX_RANGE_BYTES)])[0])
    except ValueError:
        return 400, json.dumps(
            {"error": "repl range: offset/limit must be integers"}
        )
    from annotatedvdb_tpu_torch.store.replication import ship_file_range

    blob = ship_file_range(
        ctx.repl_store_dir, name, offset, min(limit, REPL_MAX_RANGE_BYTES)
    )
    if blob is None:
        return 404, json.dumps({"error": f"not a shippable file: {name!r}"})
    return 200, blob


class ServeContext:
    """Everything a handler thread needs, shared across requests."""

    #: published worker metric snapshots older than this are a dead
    #: worker's leavings and drop out of the fleet view
    FLEET_SNAPSHOT_TTL_S = 15.0

    def __init__(self, manager, engine: QueryEngine, batcher: QueryBatcher,
                 registry: MetricsRegistry, max_inflight: int | None = None,
                 memtable=None, log=None, flight=None,
                 telemetry_dir: str | None = None, worker_index: int = 0,
                 health=None):
        self.manager = manager
        self.engine = engine
        self.batcher = batcher
        self.registry = registry
        #: the observability plane: the crash flight recorder
        #: (``obs/flight.py``, None = disabled) and the fleet telemetry
        #: directory workers publish metric snapshots into
        self.flight = flight
        self.telemetry_dir = telemetry_dir
        #: the health plane (``obs/slo.HealthPlane``, None = disabled):
        #: the metrics time-series ring and the SLO burn-rate evaluator.
        #: The threaded front end ticks it inline (time-gated, riding
        #: request completions and health probes); the aio front end
        #: clears ``health_tick_inline`` and ticks from its maintenance
        #: loop on the executor pool.  Flight flushes split the same way.
        self.health = health
        self.health_tick_inline = True
        self.worker_index = int(worker_index)
        self.started_t = time.time()
        self.debug_trace_enabled = chaos_enabled_from_env()
        self.flight_flush_inline = True
        self._flight_flush_last = 0.0
        #: the live write path (``store/memtable.py``), or None for a
        #: read-only server — the upsert route answers 403 when unset
        self.memtable = memtable
        #: replication plane.  The ship surface (``GET /repl/*``) serves
        #: from the snapshot manager's on-disk store directory (None for
        #: in-memory stores: the routes 404).  A follower's serve path
        #: sets ``repl`` to its ReplicaTailer (lag gates /readyz) and
        #: ``follow_url`` to the leader base URL (upserts answer 403
        #: pointing there).
        self.repl_store_dir = getattr(
            getattr(manager, "base", manager), "store_dir", None
        )
        self.repl = None
        self.follow_url = None
        self.max_inflight = (
            max_inflight if max_inflight is not None else batcher.max_queue
        )
        self.log = log if log is not None else (lambda msg: None)
        #: disk-pressure guard: while free disk under the store sits below
        #: AVDB_STORE_DISK_RESERVE_BYTES, upserts answer 507 (None when
        #: the server is read-only or the store has no directory)
        self.disk_guard = None
        if memtable is not None and getattr(memtable, "store_dir", None):
            from annotatedvdb_tpu_torch.store.maintenance import (
                DiskReserveGuard,
            )

            self.disk_guard = DiskReserveGuard(
                memtable.store_dir, log=self.log
            )
        self._lock = make_lock("serve.ctx.inflight")
        #: guarded by self._lock
        self._inflight = 0
        #: default per-request deadline budget (0 = none unless the client
        #: sends X-Deadline-Ms)
        self.default_deadline_s = resilience.default_deadline_s()
        #: the brownout ladder, stepped on request completion and probes
        self.governor = OverloadGovernor(
            depth_fn=batcher.depth, max_queue=batcher.max_queue,
            registry=registry, on_change=self._brownout_event,
        )
        self.reqtrace = TraceRecorder(registry, log=self.log, flight=flight)
        # background writers (memtable flushes, compaction groups, WAL
        # rotations) join this worker's observability plane through the
        # module sink — the store layer never imports serve code
        reqtrace_mod.set_background_sink(
            self.reqtrace.background,
            flight.event if flight is not None else None,
        )
        if engine.breaker is not None and flight is not None:
            # breaker trips / re-closes land on the flight timeline
            engine.breaker.events = flight.event
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
        self._m_upsert_requests = registry.counter(
            "avdb_upsert_requests_total", "upsert requests acknowledged"
        )
        self._m_upsert_rows = registry.counter(
            "avdb_upsert_rows_total", "upsert rows accepted into the memtable"
        )
        self._m_upsert_rejected = registry.counter(
            "avdb_upsert_rejected_total",
            "upsert rows not applied (shadowed by an existing row under "
            "the first-wins policy, or duplicated within the batch)",
        )
        self._m_upsert_ack = registry.histogram(
            "avdb_upsert_ack_seconds", QUERY_SECONDS_EDGES,
            "upsert latency from arrival to durable acknowledgement",
        )
        self._m_upsert_disk_shed = registry.counter(
            "avdb_upsert_disk_shed_total",
            "upserts answered 507 under the free-disk reserve guard "
            "(AVDB_STORE_DISK_RESERVE_BYTES)",
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
        if self.flight is not None and self.flight_flush_inline:
            now = time.monotonic()
            if now - self._flight_flush_last >= self.flight.FLUSH_S:
                self._flight_flush_last = now
                try:
                    self.flight.flush(limit=self.flight.FLUSH_BATCH)
                except Exception:  # avdb: noqa[AVDB602] -- the recorder already logs; a flush failure must never fail the request riding it
                    pass
        if self.health is not None and self.health_tick_inline \
                and self.health.due():
            self.health.tick()  # absorbs its own failures (obs/slo.py)

    def request_counts(self) -> dict:
        """{kind: requests answered} for the kinds that saw any (the
        serve CLI's shutdown record)."""
        return {kind: int(series[0].value)
                for kind, series in self._kind.items() if series[0].value}

    def rejected(self, kind: str) -> None:
        self._kind[kind][3].inc()

    def errored(self, kind: str) -> None:
        self._kind[kind][4].inc()

    def _brownout_event(self, old: int, new: int) -> None:
        """Brownout ladder transitions land on the flight timeline — the
        black box's answer to "what was this worker shedding when it
        died"."""
        if self.flight is not None:
            self.flight.event(
                "brownout",
                f"level {old}->{new} ({resilience.LEVEL_NAMES[new]})",
            )

    def fleet_metrics(self) -> str:
        """The ``?fleet=1`` exposition body: this worker's live registry
        merged with every sibling's published snapshot file (sum for
        counters/histograms, max for gauges) plus the supervisor's
        ``avdb_fleet_*`` series.  Outside a fleet the same surface
        answers from the one process (workers_live 1) — the contract is
        the VIEW, not the process count."""
        from annotatedvdb_tpu_torch.obs.metrics import (
            merge_snapshots,
            render_snapshot,
        )

        snaps = [self.registry.snapshot()]
        info = None
        now = time.time()
        tdir = self.telemetry_dir
        if tdir and os.path.isdir(tdir):
            for fname in sorted(os.listdir(tdir)):
                path = os.path.join(tdir, fname)
                try:
                    if fname == "fleet.json":
                        with open(path) as f:
                            doc = json.load(f)
                        if now - float(doc.get("t", 0)) \
                                <= self.FLEET_SNAPSHOT_TTL_S:
                            # a dead supervisor's last facts must age out
                            # exactly like a dead worker's snapshot — the
                            # gauges exist to SURFACE that death
                            info = doc
                        continue
                    if not (fname.startswith("worker-")
                            and fname.endswith(".json")):
                        continue
                    with open(path) as f:
                        doc = json.load(f)
                    if int(doc.get("index", -1)) == self.worker_index:
                        continue  # self: the live registry is fresher
                    if now - float(doc.get("t", 0)) \
                            > self.FLEET_SNAPSHOT_TTL_S:
                        continue  # a dead worker's stale snapshot
                    snaps.append(doc.get("metrics") or {})
                except (OSError, ValueError, TypeError):
                    continue  # torn publish race: skip, never fail a scrape
        merged = merge_snapshots(snaps)
        fleet = MetricsRegistry()
        if info:
            live = int(info.get("workers_live", 0))
            respawns = int(info.get("respawns_total", 0))
            age = float(info.get("worker_age_seconds", 0.0))
        else:
            live, respawns = 1, 0
            age = now - self.started_t
        fleet.gauge(
            "avdb_fleet_workers_live",
            "serve worker processes alive in the fleet",
        ).set(live)
        fleet.counter(
            "avdb_fleet_respawns_total",
            "worker respawns since the fleet supervisor started",
        ).inc(respawns)
        fleet.gauge(
            "avdb_fleet_worker_age_seconds",
            "age of the oldest live worker process",
        ).set(round(age, 3))
        return fleet.render_prometheus() + render_snapshot(merged)

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

    # -- upserts (the live write path) --------------------------------------

    def upsert_execute(self, body: bytes,
                       max_rows: int | None = None, trace=None):
        """The upsert decision and execution both front ends share;
        returns ``(status, json_body, rows_in_request)``.  The 200 is the
        ack: it is built only after the accepted rows' WAL frame is
        fsynced (``Memtable.upsert`` orders WAL before visibility)."""
        if self.follow_url is not None:
            # a follower is read-only by role: its overlay memtable exists
            # to apply the leader's shipped stream, so a client write is
            # refused with the leader's location
            return 403, follower_upsert_payload(self), 0
        memtable = self.memtable
        if memtable is None:
            return 403, json.dumps({"error": MSG_UPSERTS_DISABLED}), 0
        if self.disk_guard is not None and self.disk_guard.breached():
            # writes shed first (507); reads and flushes of acknowledged
            # rows keep running.  Nothing durable happened.
            self._m_upsert_disk_shed.inc()
            return 507, json.dumps({"error": MSG_DISK_RESERVE}), 0
        t0 = time.perf_counter()
        try:
            entries = parse_upsert_body(body)
            parsed = self.upsert_parse_entries(entries)
        except QueryError as err:
            self.errored("upsert")
            return 400, json.dumps({"error": str(err)}), 0
        if max_rows is not None and len(parsed) > max_rows:
            # a batch the client bucket could never repay is rejected
            # before any WAL or memtable work runs
            self.rejected("upsert")
            return 429, json.dumps({"error": (
                f"upsert of {len(parsed)} rows exceeds client rate "
                f"budget ({max_rows} rows); split the request"
            )}), len(parsed)
        base = getattr(self.manager, "base", self.manager)
        try:
            accepted, shadowed, _wal_bytes = memtable.upsert(
                base.current().store, parsed, trace=trace
            )
        except (ValueError, KeyError, TypeError) as err:
            self.errored("upsert")
            return 400, json.dumps({"error": str(err)}), len(parsed)
        except Exception as err:
            # a WAL append or fsync failure included: nothing became
            # visible, nothing was acknowledged — the client retries
            self.errored("upsert")
            return 500, json.dumps(
                {"error": f"{type(err).__name__}: {err}"}
            ), len(parsed)
        generation = self.manager.current().generation
        dt = time.perf_counter() - t0
        self._m_upsert_requests.inc()
        if accepted:
            self._m_upsert_rows.inc(accepted)
        if shadowed:
            self._m_upsert_rejected.inc(shadowed)
        self._m_upsert_ack.observe(dt)
        self.observe("upsert", dt, rows=accepted)
        return 200, (
            f'{{"n":{len(parsed)},"accepted":{accepted},'
            f'"shadowed":{shadowed},"generation":{generation}}}'
        ), len(parsed)

    def upsert_parse_entries(self, entries: list[dict]) -> list[dict]:
        """Validated body entries -> the memtable's plain-data rows: ids
        resolve through the grammar every read path uses
        (:func:`~annotatedvdb_tpu_torch.serve.engine.parse_variant_id`),
        and alleles are bounded by the store width (long-allele rows
        belong to the offline loaders)."""
        width = self.manager.current().store.width
        parsed = []
        for e in entries:
            code, pos, ref, alt = parse_variant_id(e["id"])
            if len(ref) > width or len(alt) > width:
                raise QueryError(
                    f"upsert {e['id']!r}: allele length "
                    f"{max(len(ref), len(alt))} exceeds the store width "
                    f"{width}; load long-allele rows through the offline "
                    "loader CLIs"
                )
            parsed.append({
                "code": code, "pos": pos, "ref": ref, "alt": alt,
                "ref_snp": e.get("ref_snp"),
                "ann": e.get("annotations"),
            })
        return parsed

    def maybe_flush_memtable(self, force: bool = False) -> bool:
        """Start a background memtable flush when a trigger
        (``AVDB_MEMTABLE_BYTES`` / ``AVDB_MEMTABLE_FLUSH_S``) is due.  The
        flush writes segment files and fsyncs a manifest, so it runs on
        its own thread, never on a request thread or the event loop."""
        m = self.memtable
        if m is None:
            return False
        if not (force or m.should_flush()):
            return False
        base = getattr(self.manager, "base", self.manager)
        threading.Thread(
            target=self._flush_memtable, args=(base,), daemon=True,
            name="memtable-flush",
        ).start()
        return True

    def _flush_memtable(self, base_manager) -> None:
        from annotatedvdb_tpu_torch.utils import retry

        try:
            # a full disk or a transient I/O blip gets a bounded retry on
            # this thread; after that the next trigger retries from
            # scratch (acknowledged rows stay in memtable + WAL)
            retry.with_backoff(
                lambda: self.memtable.flush(base_manager=base_manager),
                attempts=3, base_delay=0.5,
                retryable=lambda exc: (retry.is_disk_full(exc)
                                       or retry.is_transient_io(exc)),
            )
        except Exception as err:
            self.log(f"memtable flush failed ({type(err).__name__}: "
                     f"{err}); rows stay in the memtable")

    def ready_state(self) -> tuple[bool, str]:
        """(ready, reason): not ready while a snapshot swap loads, while a
        follower's replication lag exceeds its bound, or while the
        brownout ladder sheds bulk work.  Probes step the ladder too, so
        an idle server de-escalates, and check the memtable's flush
        triggers, so an idle threaded server's age flush fires."""
        self.governor.maybe_step()
        self.maybe_flush_memtable()
        # the health plane ticks off probes too: an idle (or drained)
        # threaded worker completes no requests, and its alert states
        # must still advance — resolution especially
        if self.health is not None and self.health_tick_inline \
                and self.health.due():
            self.health.tick()
        if getattr(self.manager, "swapping", False):
            return False, "snapshot swap in progress"
        if self.repl is not None and self.repl.lag_exceeded():
            # the bounded-staleness contract: a follower past its declared
            # lag bound (AVDB_REPL_MAX_LAG_S) drains out of the router
            # rotation; it re-enters once a tail cycle catches up
            return False, (
                f"replication lag {self.repl.lag_s():.1f}s exceeds the "
                f"declared staleness bound ({self.repl.max_lag_s:g}s)"
            )
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
            self._reply(200, metrics_payload(ctx, url.query),
                        content_type="text/plain; version=0.0.4")
            return
        if path == "/stats":
            self._reply(200, stats_payload(ctx))
            return
        if path == "/alerts":
            self._reply(200, alerts_payload(ctx, url.query))
            return
        if path == HISTORY_ROUTE:
            self._reply(200, metrics_history_payload(ctx, url.query))
            return
        if path == REPL_MANIFEST_ROUTE:
            status, body = repl_manifest_payload(ctx)
            self._reply(status, body)
            return
        if path in (REPL_SEGMENT_ROUTE, REPL_WAL_ROUTE):
            status, body = repl_file_response(ctx, url.query)
            self._reply(status, body,
                        content_type="application/octet-stream"
                        if isinstance(body, bytes) else "application/json")
            return
        if path == "/debug/trace" and ctx.debug_trace_enabled:
            # chaos-gated like /_chaos: on a production server this path
            # 404s byte-identically to any unknown route
            self._reply(200, debug_trace_payload(ctx))
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
        if path == UPSERT_ROUTE:
            self._upsert(ctx)
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

    def _execute(self, ctx: ServeContext, kind: str, t0: float, run,
                 render=None) -> None:
        """Run ``run()`` (the engine call) under the request's trace,
        mapping QueryError to 400 and any other failure to 500.  With
        ``render``, ``render(result)`` makes ``(body, rows)`` as the trace's
        ``render`` stage (bulk, ``/regions``, ``/stats/region``, as the
        reference times them); without it ``run()`` returns them."""
        trace = ctx.reqtrace.begin(self._trace_id, kind)
        if trace is not None:
            trace.add("admission", time.perf_counter() - t0)
        try:
            t_dev = time.perf_counter()
            with reqtrace_mod.activate(trace):
                result = run()
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
        t_render = time.perf_counter()
        body, rows = result if render is None else render(result)
        ctx.observe(kind, time.perf_counter() - t0, rows=rows)
        if render is not None and trace is not None:
            trace.add("render", time.perf_counter() - t_render)
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

            def render(results):
                found = sum(1 for r in results if r is not None)
                return (
                    f'{{"n":{len(results)},"found":{found},"results":['
                    + ",".join(r if r is not None else "null"
                               for r in results)
                    + "]}"
                ), found

            self._execute(ctx, "bulk", t0,
                          lambda: ctx.engine.lookup_many(ids), render)
        finally:
            ctx.release()

    def _upsert(self, ctx: ServeContext) -> None:
        """Live write path: the bulk admission shape (brownout shed,
        deadline at admission and before execution, in-flight slot, 429)
        around the shared :meth:`ServeContext.upsert_execute`; the 200 is
        the durable ack."""
        if ctx.governor.shed_bulk():
            ctx.brownout_shed()
            self._error(503, MSG_BROWNOUT_UPSERT)
            return
        deadline_t = ctx.request_deadline(self.headers.get("X-Deadline-Ms"))
        if deadline_t is not None and time.monotonic() >= deadline_t:
            ctx.deadline_shed("admission")
            self._error(504, MSG_DEADLINE_ADMISSION)
            return
        if not ctx.admit():
            ctx.rejected("upsert")
            self._error(429, MSG_CAPACITY_UPSERT)
            return
        try:
            ctx.refresh_snapshot()
            try:
                raw = self._read_body()
            except ValueError:
                ctx.errored("upsert")
                self._error(400, UPSERT_BODY_ERROR)
                return
            if deadline_t is not None and time.monotonic() >= deadline_t:
                # the body read ate the budget: shed before the WAL write
                ctx.deadline_shed("execute")
                self._error(504, MSG_DEADLINE_EXECUTE)
                return
            trace = ctx.reqtrace.begin(self._trace_id, "upsert")
            status, body, _rows = ctx.upsert_execute(raw, trace=trace)
            ctx.reqtrace.finish(trace, status)
            self._reply(status, body)
            ctx.maybe_flush_memtable()
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
                return ctx.engine.regions_serve(
                    specs, min_cadd=min_cadd, max_conseq_rank=max_rank,
                    limit=limit, tokenize=tokenize,
                )

            self._execute(ctx, "regions", t0, run, _assembled)
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

            self._execute(
                ctx, "stats", t0,
                lambda: ctx.engine.stats_serve(specs, metrics=metrics,
                                               windows=windows),
                _assembled)
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


def _assembled(result) -> tuple[str, int]:
    """A ``/regions`` or ``/stats/region`` result's body and row count."""
    return result.assemble(), result.returned


def build_server(store_dir: str | None = None, manager=None,
                 host: str = "127.0.0.1", port: int = 0,
                 max_batch: int | None = None,
                 max_wait_s: float | None = None,
                 max_queue: int | None = None,
                 region_cache_size: int | None = None,
                 registry: MetricsRegistry | None = None,
                 residency=None, memtable=None, log=None,
                 device=None, flight=None,
                 telemetry_dir: str | None = None,
                 worker_index: int = 0, health=None) -> ThreadingHTTPServer:
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
    httpd.ctx = ServeContext(manager, engine, batcher, registry,
                             memtable=memtable, log=log, flight=flight,
                             telemetry_dir=telemetry_dir,
                             worker_index=worker_index, health=health)
    return httpd
