"""CLI: serve point/bulk/region/stats queries over a loaded variant store.

Port of ``annotatedvdb_tpu/cli/serve.py``, with both of the reference's
front ends, its multi-process fleet and its live write path:

    python -m annotatedvdb_tpu_torch serve --storeDir ./vdb --port 8080 \\
        [--frontend aio|threaded] [--platform cpu] [--hbmBudget 2g]
    python -m annotatedvdb_tpu_torch serve --storeDir ./vdb --port 8080 \\
        --workers 4 --hbmBudget 2g --upserts     # fleet + write path
    curl localhost:8080/variant/8:1000:A:G
    curl 'localhost:8080/region/8:1000-250000?minCadd=20'
    curl -d '{"regions":["8:1000-2000","8:9000-9500"],"limit":50}' \\
        localhost:8080/regions
    curl -d '{"variants":[{"id":"8:1003:C:T","ref_snp":7}]}' \\
        localhost:8080/variants/upsert

``--port 0`` binds an ephemeral port (printed in the banner).  The
default front end is the asyncio event loop (``serve/aio.py``), as in the
reference; ``--frontend threaded`` keeps the thread-per-connection server
(``serve/http.py``), where ``--clientRate`` and ``--streamThreshold`` do
not apply.  The flags and their ``AVDB_SERVE_*`` defaults are the
reference's, plus ``--platform`` (``cuda`` by default, an error when no
card is present; ``cpu`` on request).  On ``cuda`` the BITS, stats and
export-pack kernels are built before the port is bound, and a failed
build exits 1.

``--workers N`` (default ``AVDB_SERVE_WORKERS`` or 1) runs the fleet
(``serve/fleet.py``): a supervisor that never imports ``torch`` and N
worker interpreters sharing the port (SO_REUSEPORT, or the supervisor's
listening fd) and, on ``cuda``, one card.  Every worker resolves its
device as a single process does: a worker with no card, or whose kernel
does not build, exits 1, and a fleet whose workers keep dying gives up
with exit code 1.  ``--hbmBudget`` is the whole fleet's budget, split
equally across the workers, and each worker's share again across the
devices of the serving mesh when ``AVDB_SERVE_MESH`` resolves one
(``serve/mesh_exec.py``: ``1`` over ``AVDBC_VIRTUAL_DEVICES`` shards of
one card, ``auto`` over several cards).  The fleet needs the ``aio`` front
end.

``--upserts`` (or ``AVDB_SERVE_UPSERTS``) enables ``POST
/variants/upsert``: each worker keeps its own memtable and WAL
(``serve-w<idx>.*.wal`` in the store directory), replays it before the
first request, and flushes it into ordinary store segments
(``AVDB_MEMTABLE_BYTES`` / ``AVDB_MEMTABLE_FLUSH_S``).  A write is visible
at once on the worker that took it, and on every worker once it is
flushed and one snapshot TTL has passed.

``--maintain`` (or ``AVDB_MAINTAIN``) hosts the maintenance daemon in the
fleet supervisor (``store/maintenance.py``): a group whose segment files
reach ``AVDB_MAINTAIN_SEGMENTS_HIGH`` is compacted while the workers
serve, and the workers pick the compacted generation up through their
snapshot swaps.  It forces fleet mode even at ``--workers 1`` (the daemon
outlives any worker's respawn) and needs the ``aio`` front end; a bad
``AVDB_MAINTAIN_*`` knob fails startup with exit code 1.

``--follow LEADER-URL`` runs a replication follower
(``store/replication.py``): on an empty directory it bootstraps the
leader's snapshot cut before serving, then tails the leader's WAL stream
into a memory-only overlay, re-syncing the cut after every leader commit
(a flush, a compaction, a load).  Its reads are the leader's bytes; its
upserts answer 403 with the leader's location; its ``/readyz`` answers
503 past ``AVDB_REPL_MAX_LAG_S``.  In a follower fleet only worker 0
mirrors the shipped bytes into the store directory.  ``--follow`` is
refused beside ``--upserts`` or ``--maintain`` (exit code 2), as in the
reference: the leader owns writes and compaction, and ``doctor
promote`` turns a follower into a leader.

``--metricsOut FILE`` writes the process's metrics at shutdown (a
Prometheus textfile and ``FILE.json``); ``--traceOut FILE`` records one
``serve.batch`` span around each drained point batch, writes the Chrome
trace at shutdown, and merges those spans into ``GET /debug/trace``.  Both
are per-process exports: a fleet warns, as the reference does, and does
not collect them.  On shutdown (SIGINT or SIGTERM) every serving process
logs one ``run summary`` line to stderr: the kernels' launches,
the plain versions' calls by device, the breaker's state, the device
bytes held, the seconds spent loading the store, building interval
indexes and decoding feature columns, and, in a fleet, the worker index.
A one-process ``aio`` server logs the same record as a ``counts so far``
line on SIGUSR1 and goes on serving (a caller reads one window's kernel
launches as the difference of two such lines).
Every serving process runs the reference's health plane by default: a
crash flight recorder (``<store>/flight/w<i>.ring``, ``AVDB_FLIGHT_EVENTS``
slots, 0 disables it) and a health plane (the metrics time-series ring
persisted to ``<store>/history/w<i>.ts.json`` and the SLO burn-rate
alerts behind ``/alerts`` and ``/healthz``; ``AVDB_OBS_TICK_S=0`` or
``AVDB_OBS_HISTORY_S=0`` disables it).  The fleet supervisor harvests a
dead worker's ring and history for ``doctor flight`` and ``doctor slo``.
``--_workerIndex``, ``--_listenFd``, ``--_heartbeatFile`` and
``--_telemetryDir`` (where a fleet worker publishes its metric snapshot
for ``/metrics?fleet=1``) are the fleet's internal worker handshake.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

#: ``runtime.PLATFORMS``, spelled here: the fleet supervisor runs this
#: module and never imports ``torch``
PLATFORMS = ("cuda", "cpu")


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
                        help="serve fleet size: N>1 runs N worker processes "
                             "sharing the port, one readonly store "
                             "generation and the card "
                             "(default: AVDB_SERVE_WORKERS or 1)")
    parser.add_argument("--frontend", choices=("aio", "threaded"),
                        default="aio",
                        help="event-loop front end (default) or the "
                             "thread-per-connection server")
    parser.add_argument("--upserts", action="store_true", default=None,
                        help="enable the live write path: POST "
                             "/variants/upsert with a per-worker "
                             "write-ahead log, replayed on start "
                             "(default: AVDB_SERVE_UPSERTS or off)")
    parser.add_argument("--follow", default=None, metavar="LEADER-URL",
                        help="replication follower: bootstrap the leader's "
                             "snapshot cut into --storeDir, then tail its "
                             "WAL stream and serve reads (writes answer "
                             "403 toward the leader)")
    parser.add_argument("--maintain", action="store_true", default=None,
                        help="host the maintenance daemon in the fleet "
                             "supervisor: compact groups whose segment "
                             "files reach AVDB_MAINTAIN_SEGMENTS_HIGH "
                             "(forces fleet mode; default: AVDB_MAINTAIN "
                             "or off)")
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
                             "(default: AVDB_SERVE_HBM_BUDGET). In fleet "
                             "mode this is the whole fleet's budget, split "
                             "equally across the workers")
    parser.add_argument("--snapshotTtlMs", type=float, default=None,
                        help="coalesced manifest freshness window in ms "
                             "(default: AVDB_SERVE_SNAPSHOT_TTL_MS or 250)")
    parser.add_argument("--metricsOut", default=None, metavar="FILE",
                        help="write serving metrics on shutdown: Prometheus "
                             "textfile at FILE plus JSON at FILE.json "
                             "(live scrape: GET /metrics)")
    parser.add_argument("--traceOut", default=None, metavar="FILE",
                        help="write a Chrome trace of batcher drain spans "
                             "on shutdown")
    parser.add_argument("--platform", default="cuda", choices=PLATFORMS,
                        help="device: cuda (default; an error when no card "
                             "is present) or cpu")
    parser.add_argument("--_workerIndex", type=int, default=None,
                        help=argparse.SUPPRESS)  # fleet-internal
    parser.add_argument("--_listenFd", type=int, default=None,
                        help=argparse.SUPPRESS)  # fleet-internal
    parser.add_argument("--_heartbeatFile", default=None,
                        help=argparse.SUPPRESS)  # fleet-internal (watchdog)
    parser.add_argument("--_telemetryDir", default=None,
                        help=argparse.SUPPRESS)  # fleet-internal (?fleet=1)
    parser.add_argument("--_forceHandoff", action="store_true",
                        help=argparse.SUPPRESS)  # tests: the shared-fd path
    return parser


def _upserts_enabled(args) -> bool:
    """Flag wins over ``AVDB_SERVE_UPSERTS``."""
    if args.upserts is not None:
        return bool(args.upserts)
    return os.environ.get("AVDB_SERVE_UPSERTS", "").lower() \
        not in ("", "0", "false")


def _maintain_enabled(args) -> bool:
    """Flag wins over ``AVDB_MAINTAIN`` (spelled once, in
    ``store.maintenance``)."""
    if args.maintain is not None:
        return bool(args.maintain)
    from annotatedvdb_tpu_torch.store.maintenance import (
        maintain_enabled_from_env,
    )

    return maintain_enabled_from_env()


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


def _knob_args(args, workers: int) -> list[str]:
    """Flags forwarded to every fleet worker: the platform, the front end,
    ``--upserts`` (every worker runs its own memtable and WAL) and the
    knobs, and ``--follow`` (every follower worker tails the leader; only
    worker 0 persists the mirror).  The budget is the exception to
    verbatim forwarding: it caps one shared card, so each worker gets an
    equal share (an explicit flag also overrides the inherited
    ``AVDB_SERVE_HBM_BUDGET``, which would give every worker the whole
    budget)."""
    out: list[str] = ["--platform", args.platform,
                      "--frontend", args.frontend]
    if _upserts_enabled(args):
        out.append("--upserts")
    if args.follow:
        out += ["--follow", args.follow]
    for flag, val in (
        ("--maxBatch", args.maxBatch),
        ("--batchWaitMs", args.batchWaitMs),
        ("--maxQueue", args.maxQueue),
        ("--regionCache", args.regionCache),
        ("--clientRate", args.clientRate),
        ("--streamThreshold", args.streamThreshold),
        ("--snapshotTtlMs", args.snapshotTtlMs),
    ):
        if val is not None:
            out += [flag, str(val)]
    budget = _resolve_budget(args)
    if budget is not None:
        out += ["--hbmBudget", str(budget // workers)]
    return out


def main(argv=None) -> int:
    ap = _build_parser()
    args = ap.parse_args(argv)

    def log(msg):
        # one write a line: a fleet's workers share the supervisor's
        # stderr, and print's separate newline write lets their lines
        # interleave (the shutdown summaries are read back from it)
        sys.stderr.write(f"serve: {msg}\n")
        sys.stderr.flush()

    try:
        workers = _effective_workers(args)
    except ValueError as err:
        print(f"serve: cannot start: bad AVDB_SERVE_WORKERS ({err})",
              file=sys.stderr)
        return 1
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
    if args.follow:
        if _upserts_enabled(args):
            # a follower is read-only by role: a second writer would fork
            # the replica — the write path belongs to the leader
            print("serve: --follow and --upserts are mutually exclusive "
                  "(a follower forwards writes to its leader; promote it "
                  "with 'doctor promote' to accept writes)",
                  file=sys.stderr)
            return 2
        if _maintain_enabled(args):
            # compaction rewrites segments the ship stream mirrors: the
            # leader compacts, the follower re-syncs the cut
            print("serve: --follow and --maintain are mutually exclusive "
                  "(the leader owns compaction; the follower mirrors its "
                  "commits)", file=sys.stderr)
            return 2
        if args._workerIndex is None and not os.path.exists(
            os.path.join(args.storeDir, "manifest.json")
        ):
            # first start on an empty directory: bootstrap the snapshot
            # cut before any worker loads the store
            from annotatedvdb_tpu_torch.store.replication import (
                ReplError,
                ReplicaTailer,
            )

            try:
                ReplicaTailer(
                    args.storeDir, args.follow, log=log, persist=True
                ).bootstrap()
            except (ReplError, OSError, ValueError) as err:
                print(f"serve: cannot bootstrap from {args.follow}: {err}",
                      file=sys.stderr)
                return 1
    maintain = args._workerIndex is None and _maintain_enabled(args)
    if args._workerIndex is None and (workers > 1 or maintain):
        if args.frontend == "threaded":
            # the threaded server binds its own port and cannot join a
            # shared-socket fleet (nor write the heartbeat health the
            # maintenance daemon reads): refusing beats a crash loop
            what = "--workers > 1" if workers > 1 else "--maintain"
            print(f"serve: {what} requires the aio front end "
                  "(--frontend threaded is single-process only)",
                  file=sys.stderr)
            return 2
        if args.metricsOut or args.traceOut:
            print("serve: --metricsOut/--traceOut are per-process exports "
                  "and are not collected in fleet mode; scrape GET "
                  "/metrics instead", file=sys.stderr)
        from annotatedvdb_tpu_torch.serve.fleet import ServeFleet

        try:
            # --maintain hosts the daemon in the supervisor, so it forces
            # fleet mode even at --workers 1
            fleet = ServeFleet(
                args.storeDir, host=args.host, port=args.port,
                workers=workers, worker_args=_knob_args(args, workers),
                log=log, maintain=maintain,
                reuseport=False if args._forceHandoff else None,
            )
        except (OSError, ValueError) as err:
            print(f"serve: cannot start fleet: {err}", file=sys.stderr)
            return 1
        print(f"serving {args.storeDir} on http://{args.host}:{fleet.port} "
              f"with {workers} workers", flush=True)
        return fleet.run()
    return _run_single(args, log)


def _open_memtable(args, manager, registry, log):
    """The worker's memtable and WAL (``serve-w<idx>``), with the WAL
    replayed into it before the first request: acknowledged but unflushed
    upserts of a previous incarnation (a crash, a SIGKILL, a wedge kill)
    come back.  Idempotent, so a death mid-replay just replays again."""
    from annotatedvdb_tpu_torch.store.memtable import Memtable
    from annotatedvdb_tpu_torch.store.wal import WriteAheadLog

    worker = args._workerIndex or 0
    # replication fence: the manifest epoch this writer opened under; a
    # flush commit observing a higher epoch aborts
    fence = 0
    try:
        with open(os.path.join(args.storeDir, "manifest.json")) as f:
            fence = int((json.load(f) or {}).get("repl_epoch", 0) or 0)
    except (OSError, ValueError):
        pass
    wal = WriteAheadLog(args.storeDir, name=f"serve-w{worker}", log=log)
    memtable = Memtable(
        width=manager.current().store.width, store_dir=args.storeDir,
        wal=wal, registry=registry, log=log, fence_epoch=fence,
    )
    replayed = memtable.replay(manager.current().store)
    if replayed:
        log(f"wal: replayed {replayed} acknowledged upsert row(s) into "
            "the memtable")
    return memtable


def _worker_socket(args):
    """A fleet worker's listening socket: the supervisor's fd (the shared
    accept queue) or its own SO_REUSEPORT socket on the fleet port."""
    import socket as socket_mod

    from annotatedvdb_tpu_torch.serve.fleet import bind_reuseport

    if args._listenFd is not None:
        return socket_mod.socket(fileno=args._listenFd)
    return bind_reuseport(args.host, args.port)


def _run_single(args, log) -> int:
    from annotatedvdb_tpu_torch.obs.metrics import MetricsRegistry
    from annotatedvdb_tpu_torch.obs.trace import Tracer
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
            build(["bits_spans", "stats_panel", "export_pack", "lookup_multi"])
        except RuntimeError as err:
            print(f"serve: cannot start: {err}", file=sys.stderr)
            return 1
    tracer = Tracer(process_name="avdb-serve") if args.traceOut else None
    registry = MetricsRegistry()
    try:
        budget = _resolve_budget(args)
        # None = unmanaged; an EXPLICIT 0 is the managed degenerate case.
        # With mesh serving on (serve_mesh_on, never the bare device
        # count) the worker's budget splits PER DEVICE and segments pin to
        # their chromosome's placed device — the mesh twin of the fleet's
        # per-worker split
        residency = None
        if budget is not None:
            from annotatedvdb_tpu_torch.serve.mesh_exec import serve_mesh_on

            mesh = serve_mesh_on(device)
            if mesh is not None:
                from annotatedvdb_tpu_torch.parallel.mesh import (
                    chromosome_placement,
                )

                residency = ResidencyManager(
                    budget // mesh.size, registry=registry, log=log,
                    device=device,
                    placement=chromosome_placement(mesh.size),
                    devices=mesh.devices,
                )
            else:
                residency = ResidencyManager(budget, registry=registry,
                                             log=log, device=device)
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
    try:
        flight, health = _open_observers(args, registry, log)
    except ValueError as err:
        print(f"serve: cannot start: {err}", file=sys.stderr)
        return 1
    memtable = None
    if _upserts_enabled(args):
        from annotatedvdb_tpu_torch.serve.snapshot import MemtableSnapshots

        try:
            memtable = _open_memtable(args, manager, registry, log)
        except (OSError, ValueError) as err:
            print(f"serve: cannot start: {err}", file=sys.stderr)
            return 1
        # reads resolve through the overlay from here on: upserted rows
        # are visible at once, first wins against the base store
        manager = MemtableSnapshots(manager, memtable)
    tailer = None
    if args.follow:
        try:
            manager, tailer = _open_follower(args, manager, registry, log)
        except (OSError, ValueError) as err:
            print(f"serve: cannot start follower: {err}", file=sys.stderr)
            return 1
    max_wait_s = (
        args.batchWaitMs / 1000.0 if args.batchWaitMs is not None else None
    )
    sock = None
    if args._workerIndex is not None:
        try:
            sock = _worker_socket(args)
        except OSError as err:
            print(f"serve: worker cannot bind: {err}", file=sys.stderr)
            return 1
    obs = (flight, health)
    if args.frontend == "threaded":
        return _run_threaded(args, manager, registry, residency, max_wait_s,
                             log, device, load_s, memtable, tailer, obs,
                             tracer)
    return _run_aio(args, manager, registry, residency, max_wait_s, log,
                    device, load_s, memtable, sock, tailer, obs, tracer)


def _open_observers(args, registry, log):
    """``(flight, health)`` as the reference builds them for every serving
    process.  The crash flight recorder is this worker's mmap'd black box
    under ``<store>/flight/`` (it survives SIGKILL; the supervisor
    harvests it on any death); a recorder that cannot start never blocks
    serving.  The health plane is the metrics time-series ring and the SLO
    burn-rate alerts, persisted under ``<store>/history/``; a knob typo
    raises ValueError (startup fails loudly), and a plane that resolves
    to disabled (tick or retention 0) stays None."""
    from annotatedvdb_tpu_torch.obs import flight as flight_mod
    from annotatedvdb_tpu_torch.obs.slo import HealthPlane
    from annotatedvdb_tpu_torch.obs.timeseries import (
        obs_history_from_env,
        obs_tick_from_env,
    )

    flight = None
    if flight_mod.flight_events_from_env() > 0:
        try:
            flight = flight_mod.FlightRecorder(
                flight_mod.ring_path(args.storeDir, args._workerIndex or 0),
                log=log,
            )
        except (OSError, ValueError) as err:
            log(f"flight: recorder unavailable ({err}); serving without "
                "a black box")
    health = None
    if obs_tick_from_env() > 0 and obs_history_from_env() > 0:
        health = HealthPlane(
            registry, store_dir=args.storeDir,
            worker=args._workerIndex or 0, log=log,
        )
    return flight, health


def _close_observers(obs) -> None:
    """Uninstall the process-global background sink before closing the
    flight recorder it points at (a later store-layer operation in this
    process must not record into a dead ring), then close the recorder
    and force the health plane's final persist (a clean shutdown leaves
    the full history tail on disk for ``doctor slo``)."""
    from annotatedvdb_tpu_torch.obs import reqtrace

    flight, health = obs
    reqtrace.set_background_sink(None, None)
    if flight is not None:
        flight.close()
    if health is not None:
        health.close()


def _open_follower(args, base_manager, registry, log):
    """A follower's read view and its tailer: a memory-only overlay
    memtable over the mirrored base cut (the mirrored WAL files on disk
    are the durability; worker 0 fsyncs them before records count as
    applied), swapped for a fresh one at every re-sync.  Records already
    mirrored by a previous incarnation re-enter the overlay before the
    first request.  Returns ``(manager, tailer)``; the tail thread starts
    once the server's context exists."""
    from annotatedvdb_tpu_torch.serve.snapshot import MemtableSnapshots
    from annotatedvdb_tpu_torch.store.memtable import Memtable
    from annotatedvdb_tpu_torch.store.replication import ReplicaTailer

    def overlay_mem():
        # flush triggers off: a follower never writes segments, it
        # mirrors the leader's
        return Memtable(
            width=base_manager.current().store.width, store_dir=None,
            wal=None, flush_bytes=0, flush_age_s=0.0, log=log,
        )

    mem_ref = {"mem": overlay_mem()}
    manager = MemtableSnapshots(base_manager, mem_ref["mem"])

    def apply_rows(rows):
        mem_ref["mem"].upsert(
            base_manager.current().store, rows, durable=False
        )

    def on_resync():
        # a leader commit landed: pick up the new base cut, then swap in
        # a fresh overlay (rows now covered by the cut leave memory;
        # first wins keeps the overlap byte-stable)
        try:
            base_manager.refresh()
        except Exception as err:
            log(f"repl: base refresh after re-sync failed ({err})")
        fresh = overlay_mem()
        mem_ref["mem"] = fresh
        manager.reset_memtable(fresh)

    # only worker 0 mirrors bytes into the shared store directory; its
    # siblings apply shipped frames straight from memory
    tailer = ReplicaTailer(
        args.storeDir, args.follow.rstrip("/"), log=log, registry=registry,
        apply_rows=apply_rows, on_resync=on_resync,
        persist=(args._workerIndex or 0) == 0,
    )
    recovered = tailer.resume()
    if recovered:
        for record in tailer.local_records():
            rows = record.get("rows")
            if isinstance(rows, list):
                apply_rows(rows)
        log(f"repl: re-applied {recovered} mirrored WAL record(s) into "
            "the overlay")
    return manager, tailer


def _attach_follower(ctx, tailer) -> None:
    """The staleness contract flows through the context (lag gates
    ``/readyz``, writes answer 403 toward the leader); the tail thread
    starts only once the context that reads its lag exists."""
    if tailer is not None:
        ctx.repl = tailer
        ctx.follow_url = tailer.leader_url
        tailer.start()


def _run_aio(args, manager, registry, residency, max_wait_s, log, device,
             load_s: float, memtable=None, sock=None, tailer=None,
             obs=(None, None), tracer=None) -> int:
    """The event-loop server (the default front end): one process, or a
    fleet worker on the supervisor's port."""
    import gc
    import signal
    import threading

    from annotatedvdb_tpu_torch.serve.aio import build_aio_server

    try:
        server = build_aio_server(
            manager=manager, host=args.host, port=args.port, sock=sock,
            max_batch=args.maxBatch, max_wait_s=max_wait_s,
            max_queue=args.maxQueue, region_cache_size=args.regionCache,
            registry=registry, residency=residency, memtable=memtable,
            client_rate=args.clientRate,
            stream_threshold=args.streamThreshold,
            heartbeat_file=args._heartbeatFile,
            heartbeat_index=args._workerIndex or 0,
            log=log, device=device, flight=obs[0],
            telemetry_dir=args._telemetryDir, health=obs[1], tracer=tracer,
        )
    except (OSError, ValueError) as err:
        # an unparseable AVDB_SERVE_* knob: the same clean exit as every
        # other startup failure (a fleet worker dying with a traceback
        # here would respawn into a crash loop)
        print(f"serve: cannot start: {err}", file=sys.stderr)
        return 1
    ctx = server.ctx
    _attach_follower(ctx, tailer)
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
        if args._workerIndex is not None:
            # fleet worker: the event loop owns the main thread (and its
            # SIGTERM graceful drain); a watcher fires the worker fault
            # point and prints readiness once the socket is accepting
            from annotatedvdb_tpu_torch.utils import faults

            def ready():
                server._started.wait()
                try:
                    # crash point: this worker is accepting; a failure
                    # here is a worker death the SUPERVISOR must absorb
                    # and restart
                    faults.fire("serve.worker")
                except Exception as err:
                    print(f"serve: worker fault injected: {err}",
                          file=sys.stderr)
                    os._exit(1)
                host, port = server.server_address[:2]
                # one write for the line and its newline: the fleet's
                # workers share the supervisor's stdout, and with it
                # unbuffered a print's two writes interleave with a
                # sibling's line
                sys.stdout.write(
                    f"worker {args._workerIndex} serving {args.storeDir} "
                    f"(generation {snap.generation}, {snap.store.n} rows)"
                    f" on http://{host}:{port}\n")
                sys.stdout.flush()

            threading.Thread(target=ready, daemon=True).start()
            server.serve_forever()
            log("shutting down")
        else:
            # bind on a helper thread first so the concrete (possibly
            # ephemeral) address prints before we block
            server.start_background()
            host, port = server.server_address[:2]
            print(f"serving {args.storeDir} (generation {snap.generation}, "
                  f"{snap.store.n} rows) on http://{host}:{port}",
                  flush=True)
            stop = threading.Event()
            for sig in (signal.SIGTERM, signal.SIGINT):
                signal.signal(sig, lambda *_a: stop.set())
            signal.signal(signal.SIGUSR1, lambda *_a: log(
                "counts so far " + json.dumps(run_summary(ctx, load_s))))
            stop.wait()
            log("shutting down")
    except OSError as err:
        # bind failure: same clean exit as the threaded front end
        print(f"serve: cannot start: {err}", file=sys.stderr)
        return 1
    except KeyboardInterrupt:
        log("shutting down")
    finally:
        if tailer is not None:
            tailer.stop()
        server.shutdown()
        ctx.batcher.close()
        _close_memtable(memtable)
        _close_observers(obs)
        _export(args, ctx.registry, tracer, log)
        log("run summary " + json.dumps(
            run_summary(ctx, load_s, args._workerIndex)))
    return 0


def _close_memtable(memtable) -> None:
    """Clean-shutdown WAL close: record-free WAL files protect nothing and
    are removed (files with records stay: they are the durability of
    unflushed acknowledged upserts)."""
    if memtable is not None and memtable.wal is not None:
        memtable.wal.close(remove_if_empty=True)


def _run_threaded(args, manager, registry, residency, max_wait_s, log,
                  device, load_s: float, memtable=None, tailer=None,
                  obs=(None, None), tracer=None) -> int:
    """The thread-per-connection server (byte-parity reference)."""
    import signal

    from annotatedvdb_tpu_torch.serve.http import build_server

    try:
        httpd = build_server(
            manager=manager, host=args.host, port=args.port,
            max_batch=args.maxBatch, max_wait_s=max_wait_s,
            max_queue=args.maxQueue, region_cache_size=args.regionCache,
            registry=registry, residency=residency, memtable=memtable,
            log=log, device=device, flight=obs[0],
            telemetry_dir=args._telemetryDir,
            worker_index=args._workerIndex or 0, health=obs[1],
            tracer=tracer,
        )
    except (OSError, ValueError) as err:
        print(f"serve: cannot start: {err}", file=sys.stderr)
        return 1
    ctx = httpd.ctx
    _attach_follower(ctx, tailer)

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
        if tailer is not None:
            tailer.stop()
        httpd.server_close()
        ctx.batcher.close()
        _close_memtable(memtable)
        _close_observers(obs)
        _export(args, ctx.registry, tracer, log)
        log("run summary " + json.dumps(run_summary(ctx, load_s)))
    return 0


def _export(args, registry, tracer, log) -> None:
    """``--metricsOut`` / ``--traceOut`` at shutdown (a failed write is
    logged, never raised)."""
    if args.metricsOut:
        try:
            registry.write_textfile(args.metricsOut)
            registry.write_json(args.metricsOut + ".json")
        except OSError as err:
            log(f"metrics export failed ({err})")
    if tracer is not None and args.traceOut:
        try:
            tracer.save(args.traceOut)
        except OSError as err:
            log(f"trace export failed ({err})")


def run_summary(ctx, load_s: float, worker: int | None = None) -> dict:
    """What the server's run did, for the shutdown log: the requests it
    answered by kind, what it did on the device, and its health plane's
    samples in the ring (one a tick, within ``AVDB_OBS_HISTORY_S``) and
    absorbed failures (``worker`` is a fleet worker's index, absent in one
    process)."""
    import torch

    from annotatedvdb_tpu_torch.ops import dedup, export_pack, intervals, stats

    engine = ctx.engine
    held = {"index_and_columns": engine.device_bytes()}
    if engine.residency is not None:
        held["resident_segments"] = engine.residency.resident_bytes()
    if engine.device.type == "cuda":
        held["allocated"] = torch.cuda.memory_allocated(engine.device)
        held["peak_allocated"] = torch.cuda.max_memory_allocated(engine.device)
    out = {} if worker is None else {"worker": int(worker)}
    return {
        **out,
        "requests": ctx.request_counts(),
        "device": str(engine.device),
        "launches": {**intervals.LAUNCHES, **stats.LAUNCHES,
                     **export_pack.LAUNCHES, **dedup.LAUNCHES},
        "plain_calls": {"bits_spans_reference": dict(intervals.CALLS),
                        "stats_references": dict(stats.CALLS),
                        "export_pack_reference": dict(export_pack.CALLS),
                        "lookup_multi_reference": dict(dedup.CALLS)},
        "breaker": engine.breaker.stats() if engine.breaker is not None
        else None,
        "device_bytes": held,
        "store_load_s": load_s,
        "index_build_s": engine.index_build_s,
        "decode_s": engine.decode_s,
        "health": None if ctx.health is None else {
            "samples": len(ctx.health.ring.samples()),
            "span_s": ctx.health.ring.span_s(),
            "errors": ctx.health.errors,
        },
    }


if __name__ == "__main__":
    raise SystemExit(main())
