"""Deterministic fault injection for crash/recovery testing.

Copy of ``annotatedvdb_tpu/utils/faults.py``, whole: the same grammar,
registry, actions, seeded ``prob`` coin and error texts, so one
``AVDB_FAULT`` spec arms both packages alike and fires on the same
passes.  Every point is wired in this package at the counterpart of the
reference's site, ``mesh.dispatch`` included (the two sharded calls of
``serve/mesh_exec.py``).

``AVDB_FAULT=<point>:<when>[:<action>[:<ms>]]`` arms exactly one named
injection point.  ``<when>`` selects WHICH passes fire:

- ``<nth>``      the <nth> time (1-based) the point is reached in this
                 process, the action fires ONCE;
- ``prob:<p>``   every pass flips a coin: the action fires with
                 probability ``p`` (0 < p <= 1) on EVERY matching pass —
                 the sustained-degradation mode the chaos harness drives.
                 The coin sequence is deterministic: seeded from
                 ``AVDB_FAULT_SEED`` (default 0xA5DB), re-seeded by every
                 :func:`reset`, so two identically-armed runs inject at
                 identical passes.

Unarmed processes pay one module-global ``is None`` check per point, so
the points stay compiled into production code paths — the failure model
is tested against the real code, not a test double.

Actions:

- ``raise``      raise :class:`InjectedFault` (default) — the in-process
                 abort path (exception ordering, ledger witnessing)
- ``kill``       SIGKILL the process: no ``finally``/atexit runs, the OS
                 state is exactly what was durably written — a true crash
- ``torn_write`` flush the in-flight file, truncate the CURRENT write
                 session to half its bytes, then SIGKILL — simulates a torn
                 page write (power loss mid-append)
- ``eio``        raise ``OSError(EIO)`` — the transient-I/O error the
                 bounded-retry paths (``utils.retry``) must absorb
- ``delay:<ms>`` sleep ``ms`` milliseconds ON the firing thread, then
                 continue normally — injected latency (with ``prob``) or a
                 parked event loop (``serve.wedge`` with a long delay: the
                 wedged-worker case the fleet watchdog must detect)

Points wired in this repo (the canonical registry is :data:`POINTS`;
arming any other name is a ``ValueError`` at parse time):

======================== ====================================================
``store.save.pre_manifest`` just before the manifest tmp write — every
                            segment of the checkpoint is on disk, the commit
                            point has not happened
``store.save.mid_segment``  mid-way through a segment container body (the
                            tmp file is torn, the manifest still references
                            only intact files)
``ledger.append``           around one ledger JSONL append (torn_write tears
                            the appended line, the classic torn-tail case)
``egress.flush``            per COPY-file write in ``io.pg_egress``
``ingest.chunk``            per parsed chunk handed to a loader (fires on
                            the ingest thread under the overlapped pipeline)
``ingest.prefetch``         per chunk scheduled by the ingest prefetcher
                            (``io.prefetch.ChunkPrefetcher``) — on the
                            prefetch thread, after the scan, before the
                            chunk enters the bounded queue
``serve.batch``             per batcher drain in ``serve.batcher`` — just
                            before the coalesced microbatch executes (fires
                            on the batcher thread; every caller of the batch
                            observes the failure)
``serve.regions``           per batch-region drain in ``serve.engine``
                            (``regions_serve``) — the batch is parsed,
                            nothing executed; a failure must fail exactly
                            this batch's caller (HTTP 500) and leave the
                            engine serving the next batch
``serve.stats``             per analytics panel in ``serve.engine``
                            (``stats_serve``) — the panel is parsed,
                            nothing executed; a failure must fail exactly
                            this request's caller (HTTP 500) and leave
                            the engine answering the next panel
                            byte-identically
``snapshot.swap``           in ``serve.snapshot`` after the new generation
                            loaded but before the atomic swap — a failure
                            must leave the old pinned generation serving
``serve.accept``            per accepted connection in the asyncio front
                            end (``serve.aio``), before anything parses —
                            ``raise`` must cost exactly that connection;
                            ``kill`` is a worker death mid-accept
``serve.worker``            in a fleet worker (``cli.serve --_workerIndex``)
                            right after its server starts accepting — the
                            supervisor must restart it and the fleet keeps
                            serving (respawned workers come up with
                            serve-side AVDB_FAULT stripped: the injection
                            tests the restart path, not a crash loop)
``serve.wedge``             per event-loop maintenance tick in the asyncio
                            front end — a long ``delay`` here parks the
                            LOOP (heartbeats stop, requests stall) while
                            the process stays alive: the wedged worker the
                            fleet watchdog must SIGKILL and respawn
``engine.device_probe``     per device-eligible chromosome-group membership
                            probe in ``serve.engine`` — ``eio``/``raise``
                            models a device probe/upload failure; the
                            serving circuit breaker must absorb it on the
                            byte-identical host path and re-close via
                            half-open probes
``compact.plan``            in ``store.compact.compact_store`` after the
                            plan is chosen, before any segment is read —
                            a death here must leave the store byte-
                            untouched
``compact.merge``           mid-way through a compaction temp container
                            body (``torn_write`` tears the ``*.compact.tmp``
                            file; the manifested store must not notice)
``compact.swap``            after the new segments are renamed into place,
                            before the atomic manifest replace — a death
                            here must leave the OLD manifest serving with
                            the new files as prunable orphans
``compact.gc``              after the manifest swap, before the replaced
                            segment files are unlinked — a death here
                            leaves the NEW layout serving with the old
                            files as prunable orphans; ``eio`` must be
                            absorbed (gc is best-effort)
``wal.append``              in ``store.wal`` before an upsert's CRC frame
                            is written — raise/eio fail the request with
                            nothing durable; ``torn_write`` lands half
                            the frame then kills (the torn tail replay
                            must drop: the request was never acked)
``wal.fsync``               after the frame write, before its fsync — a
                            death here may leave the record durable but
                            UNACKNOWLEDGED; replay applies it in full or
                            not at all, never a hybrid
``wal.replay``              once per WAL file during worker-start replay
                            — a death mid-replay must be recoverable by
                            replaying again on respawn
``memtable.flush``          twice per memtable flush: after the plan is
                            captured (nothing written — a death leaves
                            the store byte-untouched), and mid-manifest-
                            commit (the tmp is written, the atomic
                            replace has not happened — the OLD manifest
                            keeps serving, the WAL still covers every
                            acknowledged row)
``maintain.tick``           per maintenance-daemon tick
                            (``store.maintenance``), before the watermark
                            evaluation — a dying tick must be absorbed by
                            the daemon (logged, backed off), never kill
                            the hosting fleet supervisor
``maintain.disk_guard``     per free-disk reading in the
                            ``AVDB_STORE_DISK_RESERVE_BYTES`` guard —
                            ``raise``/``eio`` model an unreadable
                            statvfs, which the guard treats as a LOW-DISK
                            reading (fail toward refusing writes): the
                            lever tests use to flip upserts to 507
                            without filling a real disk
``mesh.dispatch``           per sharded mesh call in ``serve.mesh_exec``
                            (bulk lookup AND region-panel spans), after
                            the inputs are prepared, before the program
                            runs — ``raise``/``eio`` model a device
                            failure inside the sharded gather; the mesh
                            breaker group must absorb it on the byte-
                            identical single-device path, never wrong
                            bytes
``obs.flight``              per flight-recorder ring write
                            (``obs.flight.FlightRecorder``) AND per
                            supervisor harvest of a dead worker's ring —
                            ``raise``/``eio`` must be ABSORBED both
                            places: observability never takes down the
                            serving (or respawn) path it records
``obs.tick``                per health-plane tick (``obs.timeseries``):
                            the registry snapshot, the atomic history
                            persist, AND the supervisor's history
                            harvest — ``raise``/``eio`` must be ABSORBED
                            everywhere (logged once, next tick runs):
                            the maintenance chains hosting the tick and
                            the respawn loop never die of their observer
``repl.ship``               in ``store.replication``: on the LEADER once
                            per ship-document build, and on the FOLLOWER
                            before a fetched chunk lands on local disk —
                            ``torn_write`` tears the mirrored WAL/segment
                            tail, which the resume-time stable-prefix
                            scan (or the bootstrap CRC verify) must
                            catch; a death leaves a resumable cursor
``repl.apply``              in the follower tail: after shipped bytes
                            are durable locally, before the overlay
                            applies them (and once per bootstrap before
                            the manifest mirror installs) — a death at
                            either site must land the follower on a
                            consistent applied-LSN prefix, never a
                            hybrid (restart replays the mirrored files)
``repl.promote``            twice in ``replication.promote``: before
                            anything mutates (a kill leaves an intact
                            follower that promotes again), and mid-
                            epoch-commit (``torn_write`` tears the
                            manifest tmp; the atomic replace never
                            happens, the store stays a follower)
``export.plan``             in ``export.core.run_export`` after the corpus
                            plan (and allele dictionaries) are computed,
                            before anything touches the output directory —
                            a death here must leave the corpus directory
                            byte-untouched
``export.pack``             per packed batch in the export materializer —
                            the batch is tokenized, nothing staged; a
                            death must land on a committed-part prefix of
                            the reference corpus, resumable via the ledger
``export.commit``           twice per durable export commit: on a part's
                            staged ``*.export.tmp*`` after the body,
                            before its fsync/rename (``torn_write`` tears
                            only the temp), and on the corpus manifest tmp
                            via the blessed ``replace_manifest`` pre-sync
                            hook
======================== ====================================================

**Process-death actions are subprocess-only.**  ``kill``/``torn_write``
SIGKILL the CURRENT process; arming them explicitly in-process
(``faults.reset(spec)`` from a test) would kill the test harness itself,
which used to fail obscurely.  :func:`reset` therefore rejects an
explicit arm of a death action unless the point is a WORKER point
(:data:`WORKER_POINTS` — points that fire inside a disposable serve
worker, the chaos harness's lever); environment arming
(``AVDB_FAULT=...`` in a spawned subprocess) remains unrestricted — that
IS the subprocess path.

``fired()`` exposes per-point fire counts for the observability exports.
"""

from __future__ import annotations

import errno
import os
import random
import signal
import time

_ACTIONS = ("raise", "kill", "torn_write", "eio", "delay")

#: canonical registry of every injection point compiled into the tree.
#: ``_parse`` rejects unknown points at ARM time (a typo'd AVDB_FAULT used
#: to arm silently and never fire — the crash test then "passed" without
#: crashing anything); the static analyzer (AVDB301) rejects unregistered
#: ``faults.fire("<point>")`` literals at the call site, and AVDB302
#: requires every entry here to appear in tests/test_fault_matrix.py.
POINTS = frozenset({
    "store.save.pre_manifest",
    "store.save.mid_segment",
    "ledger.append",
    "egress.flush",
    "ingest.chunk",
    "ingest.prefetch",
    "serve.batch",
    "serve.regions",
    "serve.stats",
    "serve.accept",
    "serve.worker",
    "serve.wedge",
    "engine.device_probe",
    "snapshot.swap",
    "compact.plan",
    "compact.merge",
    "compact.swap",
    "compact.gc",
    "wal.append",
    "wal.fsync",
    "wal.replay",
    "memtable.flush",
    "maintain.tick",
    "maintain.disk_guard",
    "mesh.dispatch",
    "obs.flight",
    "obs.tick",
    "repl.ship",
    "repl.apply",
    "repl.promote",
    "fsck.repair",
    "export.plan",
    "export.pack",
    "export.commit",
})

#: points that fire inside a disposable serve WORKER process: the one
#: place an explicit in-process arm of a death action (``kill``/
#: ``torn_write``) is intentional — the chaos harness arms live workers
#: through POST /_chaos and the supervisor absorbs the death.  Everywhere
#: else a death action must be armed via a subprocess environment.
WORKER_POINTS = frozenset({"serve.accept", "serve.worker", "serve.wedge"})

#: actions that SIGKILL the current process (see WORKER_POINTS)
DEATH_ACTIONS = ("kill", "torn_write")


class InjectedFault(RuntimeError):
    """The exception the ``raise`` action throws (never caught by library
    code — it must propagate to the abort path like any real error)."""


#: (point, nth|None, prob|None, action, delay_ms) or None — parsed once
#: from AVDB_FAULT; tests re-arm via :func:`reset` after mutating the
#: environment.  Exactly one of nth/prob is set.
_ARMED: tuple[str, int | None, float | None, str, int] | None = None
_SEEN: dict[str, int] = {}
_FIRED: dict[str, int] = {}
_RNG = random.Random()

#: default deterministic seed for ``prob`` mode (``AVDB_FAULT_SEED``
#: overrides): chaos runs are replayable by construction
_DEFAULT_SEED = 0xA5DB


def _parse(spec: str | None) -> tuple | None:
    if not spec:
        return None
    parts = spec.split(":")
    if len(parts) < 2:
        raise ValueError(
            f"AVDB_FAULT={spec!r}: expected <point>:<when>[:<action>[:<ms>]]"
        )
    point = parts[0]
    if point not in POINTS:
        raise ValueError(
            f"AVDB_FAULT={spec!r}: unknown injection point {point!r} "
            f"(known points: {', '.join(sorted(POINTS))})"
        )
    nth: int | None = None
    prob: float | None = None
    if parts[1] == "prob":
        if len(parts) < 3:
            raise ValueError(
                f"AVDB_FAULT={spec!r}: prob mode needs a probability "
                "(<point>:prob:<p>[:<action>[:<ms>]])"
            )
        try:
            prob = float(parts[2])
        except ValueError:
            raise ValueError(
                f"AVDB_FAULT={spec!r}: probability must be a number"
            ) from None
        if not 0.0 < prob <= 1.0:
            raise ValueError(
                f"AVDB_FAULT={spec!r}: probability must be in (0, 1] "
                f"(got {prob})"
            )
        rest = parts[3:]
    else:
        try:
            nth = int(parts[1])
        except ValueError:
            raise ValueError(
                f"AVDB_FAULT={spec!r}: nth must be an integer "
                "(or 'prob:<p>')"
            ) from None
        if nth < 1:
            raise ValueError(f"AVDB_FAULT={spec!r}: nth is 1-based (got {nth})")
        rest = parts[2:]
    action = rest[0] if rest else "raise"
    if action not in _ACTIONS:
        raise ValueError(
            f"AVDB_FAULT={spec!r}: unknown action {action!r} "
            f"(one of {', '.join(_ACTIONS)})"
        )
    delay_ms = 0
    if action == "delay":
        if len(rest) < 2:
            raise ValueError(
                f"AVDB_FAULT={spec!r}: delay action needs milliseconds "
                "(<point>:<when>:delay:<ms>)"
            )
        try:
            delay_ms = int(rest[1])
        except ValueError:
            raise ValueError(
                f"AVDB_FAULT={spec!r}: delay milliseconds must be an integer"
            ) from None
        if delay_ms < 0:
            raise ValueError(
                f"AVDB_FAULT={spec!r}: delay milliseconds must be >= 0"
            )
        extra = rest[2:]
    else:
        extra = rest[1:]
    if extra:
        raise ValueError(
            f"AVDB_FAULT={spec!r}: unexpected trailing fields {extra!r}"
        )
    return point, nth, prob, action, delay_ms


def reset(spec: str | None = None) -> None:
    """Re-arm from ``spec`` (or the current environment), zero the hit
    counters, and re-seed the ``prob`` coin (``AVDB_FAULT_SEED``) — the
    test-suite entry point for in-process fault runs.

    An EXPLICIT spec arming a death action (``kill``/``torn_write``) at a
    non-worker point is rejected: those actions SIGKILL the current
    process, so arming them in-process would kill the test harness —
    the valid in-process actions are named in the error, and the
    subprocess path (``AVDB_FAULT`` in a child environment, which the
    import-time arm below parses) stays unrestricted."""
    global _ARMED
    armed = _parse(
        spec if spec is not None else os.environ.get("AVDB_FAULT")
    )
    if spec is not None and armed is not None:
        point, _nth, _prob, action, _ms = armed
        if action in DEATH_ACTIONS and point not in WORKER_POINTS:
            raise ValueError(
                f"AVDB_FAULT={spec!r}: action {action!r} at point "
                f"{point!r} is subprocess-only (it SIGKILLs the current "
                "process) — arm it via AVDB_FAULT in the child process "
                f"environment; valid in-process actions for {point!r}: "
                "raise, eio, delay"
            )
    _ARMED = armed
    _SEEN.clear()
    _FIRED.clear()
    try:
        seed = int(os.environ.get("AVDB_FAULT_SEED", "") or _DEFAULT_SEED)
    except ValueError:
        raise ValueError(
            "AVDB_FAULT_SEED must be an integer"
        ) from None
    _RNG.seed(seed)


def armed_point() -> str | None:
    """Name of the armed injection point, or None."""
    return _ARMED[0] if _ARMED is not None else None


def fired() -> dict[str, int]:
    """{point: times an action actually fired} — the obs export surface.
    (``kill``/``torn_write`` never return to report, but the ``raise``/
    ``eio``/``delay`` counts matter for retry/abort/latency accounting.)"""
    return dict(_FIRED)


def fire(point: str, fileobj=None, tear_base: int = 0,
         payload=None) -> None:
    """One pass through the named injection point.

    Placed BEFORE the guarded write, so ``raise``/``kill``/``eio`` model a
    death in which the write never happened.  ``torn_write`` instead
    simulates the write landing HALFWAY: with ``payload`` (the bytes/str
    about to be written) it writes the first half itself then SIGKILLs;
    without a payload it truncates the current write session back to
    ``tear_base + (written - tear_base) // 2``.  Points with no file fall
    back to a plain kill.  ``delay`` sleeps on the firing thread and
    continues — injected latency, or a parked loop when the point sits on
    an event loop's maintenance tick.
    """
    armed = _ARMED
    if armed is None or armed[0] != point:
        return
    _point, nth, prob, action, delay_ms = armed
    n = _SEEN[point] = _SEEN.get(point, 0) + 1
    if prob is not None:
        if _RNG.random() >= prob:
            return
    elif n != nth:
        return
    _FIRED[point] = _FIRED.get(point, 0) + 1
    if action == "delay":
        time.sleep(delay_ms / 1000.0)
        return
    if action == "raise":
        raise InjectedFault(f"injected fault at {point} (hit {n})")
    if action == "eio":
        raise OSError(errno.EIO, f"injected EIO at {point} (hit {n})")
    if action == "torn_write" and fileobj is not None:
        try:
            if payload is not None:
                fileobj.write(payload[: max(len(payload) // 2, 1)])
            fileobj.flush()
            if payload is None:
                end = fileobj.tell()
                cut = tear_base + max((end - tear_base) // 2, 0)
                fileobj.truncate(cut)
            os.fsync(fileobj.fileno())
        except OSError:
            pass  # the kill below is the point; a failed tear still crashes
    os.kill(os.getpid(), signal.SIGKILL)


# arm from the environment at import: loader CLIs run as subprocesses whose
# AVDB_FAULT is set at spawn time
reset()
