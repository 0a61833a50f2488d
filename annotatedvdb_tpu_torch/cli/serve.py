"""CLI: serve point/bulk/region/stats queries over a loaded variant store.

Port of ``annotatedvdb_tpu/cli/serve.py`` for one serving process, with
both of the reference's front ends:

    python -m annotatedvdb_tpu_torch serve --storeDir ./vdb --port 8080 \\
        [--frontend aio|threaded] [--platform cpu] [--hbmBudget 2g]
    curl localhost:8080/variant/8:1000:A:G
    curl 'localhost:8080/region/8:1000-250000?minCadd=20'
    curl -d '{"regions":["8:1000-2000","8:9000-9500"],"limit":50}' \\
        localhost:8080/regions

``--port 0`` binds an ephemeral port (printed in the banner).  The
default front end is the asyncio event loop (``serve/aio.py``), as in the
reference; ``--frontend threaded`` keeps the thread-per-connection server
(``serve/http.py``), where ``--clientRate`` and ``--streamThreshold`` do
not apply.  The flags and their ``AVDB_SERVE_*`` defaults are the
reference's, plus ``--platform`` (``cuda`` by default, an error when no
card is present; ``cpu`` on request).  On ``cuda`` the BITS, stats and
export-pack kernels are built before the port is bound, and a failed
build exits 1.  Refused (not ported yet): the serve fleet (``--workers``
above 1), ``--upserts``, ``--follow``, ``--maintain``, ``--metricsOut``
and ``--traceOut``.  On shutdown (SIGINT or SIGTERM) the server logs one
``run summary`` line to stderr: the kernels' launches, the plain
versions' calls by device, the breaker's state, the device bytes held,
and the seconds spent loading the store, building interval indexes and
decoding feature columns.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from annotatedvdb_tpu_torch.runtime import PLATFORMS


def _build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="HTTP query API over a variant store (PyTorch/CUDA port)"
    )
    parser.add_argument("--storeDir", required=True,
                        help="variant store directory (opened read-only)")
    parser.add_argument("--host", default="127.0.0.1",
                        help="bind address (default 127.0.0.1)")
    parser.add_argument("--port", type=int, default=8080,
                        help="bind port (0 = ephemeral, printed on startup)")
    parser.add_argument("--workers", type=int, default=None,
                        help="serve fleet size (default: AVDB_SERVE_WORKERS "
                             "or 1); above 1 is not yet ported")
    parser.add_argument("--frontend", choices=("aio", "threaded"),
                        default="aio",
                        help="event-loop front end (default) or the "
                             "thread-per-connection server")
    parser.add_argument("--upserts", action="store_true", default=None,
                        help="the live write path (not yet ported)")
    parser.add_argument("--follow", default=None, metavar="LEADER-URL",
                        help="replication follower mode (not yet ported)")
    parser.add_argument("--maintain", action="store_true", default=None,
                        help="the maintenance daemon (not yet ported)")
    parser.add_argument("--maxBatch", type=int, default=None,
                        help="max point queries per coalesced microbatch "
                             "(default: AVDB_SERVE_BATCH_MAX or 256)")
    parser.add_argument("--batchWaitMs", type=float, default=None,
                        help="batcher drain deadline in ms "
                             "(default: AVDB_SERVE_BATCH_WAIT_MS or 2)")
    parser.add_argument("--maxQueue", type=int, default=None,
                        help="admission bound: pending queries beyond this "
                             "are rejected 429 "
                             "(default: AVDB_SERVE_MAX_QUEUE or 1024)")
    parser.add_argument("--regionCache", type=int, default=None,
                        help="rendered hot-region LRU capacity "
                             "(default: AVDB_SERVE_REGION_CACHE or 64)")
    parser.add_argument("--clientRate", type=float, default=None,
                        help="weighted per-client admission: requests/sec "
                             "per weight unit, 0 disables "
                             "(default: AVDB_SERVE_CLIENT_RATE or 0)")
    parser.add_argument("--streamThreshold", type=int, default=None,
                        help="region row count above which responses "
                             "stream chunked instead of buffering "
                             "(default: AVDB_SERVE_STREAM_THRESHOLD or 2048)")
    parser.add_argument("--hbmBudget", default=None, metavar="BYTES",
                        help="device residency budget for probe segment "
                             "caches, e.g. 512m / 2g; unset = unmanaged "
                             "(default: AVDB_SERVE_HBM_BUDGET)")
    parser.add_argument("--snapshotTtlMs", type=float, default=None,
                        help="coalesced manifest freshness window in ms "
                             "(default: AVDB_SERVE_SNAPSHOT_TTL_MS or 250)")
    parser.add_argument("--metricsOut", default=None, metavar="FILE",
                        help="not yet ported (scrape GET /metrics)")
    parser.add_argument("--traceOut", default=None, metavar="FILE",
                        help="not yet ported")
    parser.add_argument("--platform", default="cuda", choices=PLATFORMS,
                        help="device: cuda (default; an error when no card "
                             "is present) or cpu")
    return parser


def _upserts_enabled(args) -> bool:
    """Flag wins over ``AVDB_SERVE_UPSERTS``."""
    if args.upserts is not None:
        return bool(args.upserts)
    return os.environ.get("AVDB_SERVE_UPSERTS", "").lower() \
        not in ("", "0", "false")


def _effective_workers(args) -> int:
    if args.workers is not None:
        return max(int(args.workers), 1)
    return max(int(os.environ.get("AVDB_SERVE_WORKERS", "") or 1), 1)


def _resolve_budget(args):
    """The residency budget in bytes (flag wins over env), or None when
    unmanaged."""
    from annotatedvdb_tpu_torch.serve.residency import budget_from_env
    from annotatedvdb_tpu_torch.utils.strings import parse_bytes

    return (
        parse_bytes(args.hbmBudget) if args.hbmBudget is not None
        else budget_from_env()
    )


def main(argv=None) -> int:
    ap = _build_parser()
    args = ap.parse_args(argv)

    def log(msg):
        print(f"serve: {msg}", file=sys.stderr)

    try:
        workers = _effective_workers(args)
    except ValueError as err:
        print(f"serve: cannot start: bad AVDB_SERVE_WORKERS ({err})",
              file=sys.stderr)
        return 1
    if workers > 1:
        ap.error("--workers above 1 (the serve fleet) is not yet ported to "
                 "annotatedvdb_tpu_torch")
    if _upserts_enabled(args):
        ap.error("--upserts (the live write path) is not yet ported to "
                 "annotatedvdb_tpu_torch")
    for flag in ("follow", "maintain", "metricsOut", "traceOut"):
        if getattr(args, flag):
            ap.error(f"--{flag} is not yet ported to annotatedvdb_tpu_torch")
    if args.frontend == "threaded":
        dead = [flag for flag, val, env in (
            ("--clientRate", args.clientRate, "AVDB_SERVE_CLIENT_RATE"),
            ("--streamThreshold", args.streamThreshold,
             "AVDB_SERVE_STREAM_THRESHOLD"),
        ) if val is not None or os.environ.get(env)]
        if dead:
            print(f"serve: {', '.join(dead)} only apply to the aio front "
                  "end and are ignored with --frontend threaded",
                  file=sys.stderr)
    return _run_single(args, log)


def _run_single(args, log) -> int:
    from annotatedvdb_tpu_torch.obs.metrics import MetricsRegistry
    from annotatedvdb_tpu_torch.runtime import resolve_device
    from annotatedvdb_tpu_torch.serve.residency import ResidencyManager
    from annotatedvdb_tpu_torch.serve.snapshot import SnapshotManager

    try:
        device = resolve_device(args.platform)
    except RuntimeError as err:
        print(f"serve: cannot start: {err}", file=sys.stderr)
        return 1
    if device.type == "cuda":
        # a kernel that does not build must stop the server here, never
        # reach the circuit breaker as a runtime fault
        from annotatedvdb_tpu_torch.ops.build import build

        try:
            build(["bits_spans", "stats_panel", "export_pack"])
        except RuntimeError as err:
            print(f"serve: cannot start: {err}", file=sys.stderr)
            return 1
    registry = MetricsRegistry()
    try:
        budget = _resolve_budget(args)
        residency = None if budget is None else ResidencyManager(
            budget, registry=registry, log=log, device=device
        )
        t0 = time.perf_counter()
        manager = SnapshotManager(
            args.storeDir, log=log,
            ttl_s=(args.snapshotTtlMs / 1000.0
                   if args.snapshotTtlMs is not None else None),
        )
        load_s = time.perf_counter() - t0
    except (OSError, ValueError) as err:
        print(f"serve: cannot start: {err}", file=sys.stderr)
        return 1
    max_wait_s = (
        args.batchWaitMs / 1000.0 if args.batchWaitMs is not None else None
    )
    if args.frontend == "threaded":
        return _run_threaded(args, manager, registry, residency, max_wait_s,
                             log, device, load_s)
    return _run_aio(args, manager, registry, residency, max_wait_s, log,
                    device, load_s)


def _run_aio(args, manager, registry, residency, max_wait_s, log, device,
             load_s: float) -> int:
    """The event-loop server (the default front end)."""
    import gc
    import signal
    import threading

    from annotatedvdb_tpu_torch.serve.aio import build_aio_server

    try:
        server = build_aio_server(
            manager=manager, host=args.host, port=args.port,
            max_batch=args.maxBatch, max_wait_s=max_wait_s,
            max_queue=args.maxQueue, region_cache_size=args.regionCache,
            registry=registry, residency=residency,
            client_rate=args.clientRate,
            stream_threshold=args.streamThreshold, log=log, device=device,
        )
    except (OSError, ValueError) as err:
        # an unparseable AVDB_SERVE_* knob: the same clean exit as every
        # other startup failure
        print(f"serve: cannot start: {err}", file=sys.stderr)
        return 1
    ctx = server.ctx
    snap = manager.current()

    # GC hygiene for a latency-sensitive process: the loaded store is
    # millions of long-lived objects — freeze them out of the collector
    # so a mid-request gen2 pass never walks the whole store, and widen
    # gen0 so request-rate allocation does not trigger collections
    # thousands of times per second
    gc.collect()
    gc.freeze()
    gc.set_threshold(50_000, 25, 25)
    # a 5 ms interpreter-lock slice (the default) stacks whole-slice
    # stalls onto request tails whenever an executor thread runs hot;
    # 1 ms trades a little switching overhead for p99
    sys.setswitchinterval(0.001)

    try:
        # bind on a helper thread first so the concrete (possibly
        # ephemeral) address prints before we block
        server.start_background()
        host, port = server.server_address[:2]
        print(f"serving {args.storeDir} (generation {snap.generation}, "
              f"{snap.store.n} rows) on http://{host}:{port}", flush=True)
        stop = threading.Event()
        for sig in (signal.SIGTERM, signal.SIGINT):
            signal.signal(sig, lambda *_a: stop.set())
        stop.wait()
        log("shutting down")
    except OSError as err:
        # bind failure: same clean exit as the threaded front end
        print(f"serve: cannot start: {err}", file=sys.stderr)
        return 1
    except KeyboardInterrupt:
        log("shutting down")
    finally:
        server.shutdown()
        ctx.batcher.close()
        log("run summary " + json.dumps(run_summary(ctx.engine, load_s)))
    return 0


def _run_threaded(args, manager, registry, residency, max_wait_s, log,
                  device, load_s: float) -> int:
    """The thread-per-connection server (byte-parity reference)."""
    import signal

    from annotatedvdb_tpu_torch.serve.http import build_server

    try:
        httpd = build_server(
            manager=manager, host=args.host, port=args.port,
            max_batch=args.maxBatch, max_wait_s=max_wait_s,
            max_queue=args.maxQueue, region_cache_size=args.regionCache,
            registry=registry, residency=residency, log=log, device=device,
        )
    except (OSError, ValueError) as err:
        print(f"serve: cannot start: {err}", file=sys.stderr)
        return 1
    ctx = httpd.ctx

    def stop(_signum, _frame):
        raise KeyboardInterrupt

    signal.signal(signal.SIGTERM, stop)
    snap = ctx.manager.current()
    host, port = httpd.server_address[:2]
    print(f"serving {args.storeDir} (generation {snap.generation}, "
          f"{snap.store.n} rows) on http://{host}:{port}", flush=True)
    try:
        httpd.serve_forever(poll_interval=0.2)
    except KeyboardInterrupt:
        log("shutting down")
    finally:
        httpd.server_close()
        ctx.batcher.close()
        log("run summary " + json.dumps(run_summary(ctx.engine, load_s)))
    return 0


def run_summary(engine, load_s: float) -> dict:
    """What the server's run did on the device, for the shutdown log."""
    import torch

    from annotatedvdb_tpu_torch.ops import export_pack, intervals, stats

    held = {"index_and_columns": engine.device_bytes()}
    if engine.residency is not None:
        held["resident_segments"] = engine.residency.resident_bytes()
    if engine.device.type == "cuda":
        held["allocated"] = torch.cuda.memory_allocated(engine.device)
        held["peak_allocated"] = torch.cuda.max_memory_allocated(engine.device)
    return {
        "device": str(engine.device),
        "launches": {**intervals.LAUNCHES, **stats.LAUNCHES,
                     **export_pack.LAUNCHES},
        "plain_calls": {"bits_spans_reference": dict(intervals.CALLS),
                        "stats_references": dict(stats.CALLS),
                        "export_pack_reference": dict(export_pack.CALLS)},
        "breaker": engine.breaker.stats() if engine.breaker is not None
        else None,
        "device_bytes": held,
        "store_load_s": load_s,
        "index_build_s": engine.index_build_s,
        "decode_s": engine.decode_s,
    }


if __name__ == "__main__":
    raise SystemExit(main())
