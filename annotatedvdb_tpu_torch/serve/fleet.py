"""Multi-process serve fleet: N workers, one port, one readonly store.

Port of ``annotatedvdb_tpu/serve/fleet.py``.  One Python serving process
is held by its interpreter lock: the event-loop front end (``serve/aio.py``)
removes thread overhead but still executes on one core.  The fleet runs N
worker **processes**, each a full snapshot-pinned serving stack over the
same store directory; workers share one readonly store generation through
``snapshot.py``'s atomic manifest swaps, so there is no cross-process
coordination on the data path.  On a card, the N workers share it: each
makes its own CUDA context, loads the kernel libraries and uploads its own
interval indexes and stats columns.

Port sharing, in preference order:

- **SO_REUSEPORT**: every worker binds its own listening socket on the
  shared port and the kernel balances accepts across them.  The
  supervisor holds a bound (never listening) reservation socket so the
  port cannot be taken between worker restarts.
- **shared listening fd** (everywhere else): the supervisor binds and
  listens once and passes the fd to every worker (``--_listenFd``);
  workers accept from the shared queue.

The supervisor spawns, watches and signals; it never opens the store and
never imports ``torch``.  Each worker is a fresh interpreter
(``python -m annotatedvdb_tpu_torch serve``), so no CUDA context is ever
forked.  A worker that dies is respawned (with backoff after rapid deaths;
``MAX_RAPID_DEATHS`` in a row end the fleet with exit code 1); SIGTERM or
SIGINT drains the fleet: workers get SIGTERM, stragglers are killed after
a timeout.  The **wedged-worker watchdog** covers the alive-but-stuck
case: every worker beats through a shared mmap'd slot file from its event
loop (``--_heartbeatFile``), and the supervisor SIGKILLs and respawns a
worker whose beat goes stale past ``AVDB_SERVE_WEDGE_TIMEOUT_S``.  On a
respawn it strips a write-path or serve-side ``AVDB_FAULT`` from the
child's environment, as the reference does: an injected worker death
(``serve.worker``, ``serve.accept``, ``serve.wedge``, ``wal.*``,
``memtable.flush``) tests the restart path once, not a crash loop.

``maintain=True`` (``serve --maintain``) hosts the maintenance daemon
(``store/maintenance.py``) in the supervisor beside the restart loop: it
compacts the store while the workers serve, reading their health from the
heartbeat slots (:meth:`ServeFleet.worker_health`), and the workers pick
the compacted generation up through their snapshot swaps.  The daemon's
first pass imports the store's segment reader, and with it ``torch``
(no CUDA context is made: compaction is host work).  A daemon that fails
to start is logged and the fleet serves on, as in the reference.

The supervisor also runs the fleet's health plane: a telemetry directory
(``--_telemetryDir``) where every worker publishes its metric snapshot and
the supervisor its ``fleet.json`` (live workers, respawns, oldest worker
age), which any worker's ``/metrics?fleet=1`` merges; its own flight ring
(``<store>/flight/supervisor.ring``) for the daemon's and the watchdog's
lifecycle events; and, on any worker death, the harvest of the dead
worker's flight ring into ``<store>/flight/<ms>-w<i>.jsonl`` and of its
history mirror into ``<store>/history/<ms>-w<i>.json`` before the
respawn (``doctor flight`` and ``doctor slo`` read both).  The
``AVDB_OBS_*``/``AVDB_SLO_*`` knobs resolve at construction, so a typo
fails the fleet's startup.
"""

from __future__ import annotations

import contextlib
import json
import mmap
import os
import shutil
import signal
import socket
import struct
import subprocess
import sys
import tempfile
import time

from annotatedvdb_tpu_torch.obs import reqtrace

#: one heartbeat slot per worker in the shared mmap'd file:
#: ``(beat_time, p99_exceedance_ewma, brownout_level, queue_depth)``.
#: The beat (written from the worker's event loop) is the watchdog's
#: liveness signal; the other three fields are the worker-health feed a
#: supervisor-side maintenance daemon reads.
HB_SLOT = struct.Struct("<ddii")


def wedge_timeout_from_env() -> float:
    """``AVDB_SERVE_WEDGE_TIMEOUT_S`` (default 10; 0 disables the
    watchdog): how stale a worker's heartbeat may grow before the
    supervisor declares it wedged and SIGKILLs it."""
    return max(
        float(os.environ.get("AVDB_SERVE_WEDGE_TIMEOUT_S", "") or 10.0), 0.0
    )


def reuseport_available() -> bool:
    """Whether SO_REUSEPORT exists and the kernel accepts it."""
    if not hasattr(socket, "SO_REUSEPORT"):
        return False
    try:
        with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
        return True
    except OSError:
        return False


def bind_reuseport(host: str, port: int) -> socket.socket:
    """A bound, listening SO_REUSEPORT socket (worker side)."""
    sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
    sock.bind((host, port))
    sock.listen(1024)
    return sock


class ServeFleet:
    """Supervisor for N serve worker processes on one port.

    ``worker_args`` is the tail of CLI flags forwarded verbatim to every
    worker (``--platform``, batching/admission/residency knobs,
    ``--upserts``)."""

    #: a worker that survived this long resets its rapid-death streak
    HEALTHY_RUN_S = 30.0

    #: consecutive rapid deaths after which the fleet gives up and exits
    #: non-zero: a worker that can never start (no card, a bad inherited
    #: knob, a kernel that does not build) surfaces as a startup failure,
    #: not an endless respawn loop
    MAX_RAPID_DEATHS = 5

    def __init__(self, store_dir: str, host: str = "127.0.0.1",
                 port: int = 0, workers: int = 2, worker_args=(),
                 log=None, restart_backoff_s: float = 0.5,
                 drain_s: float = 10.0, reuseport: bool | None = None,
                 wedge_timeout_s: float | None = None,
                 maintain: bool = False):
        self.store_dir = store_dir
        self.host = host
        self.workers = max(int(workers), 1)
        self.worker_args = list(worker_args)
        self.log = log if log is not None else (lambda msg: None)
        self.restart_backoff_s = restart_backoff_s
        self.drain_s = drain_s
        # a typo'd AVDB_STORE_DISK_RESERVE_BYTES would otherwise surface
        # inside every spawned worker (the upsert guard reads it): a
        # rapid-death loop instead of a startup failure
        from annotatedvdb_tpu_torch.store.maintenance import (
            disk_reserve_from_env,
        )

        disk_reserve_from_env()
        #: host a MaintenanceDaemon beside the restart loop; the watermark
        #: knobs resolve now, so a typo'd AVDB_MAINTAIN_* fails startup
        #: (rc 1) instead of silently disabling autonomy mid-flight
        self.maintain = bool(maintain)
        self._maintain_knobs = None
        if self.maintain:
            from annotatedvdb_tpu_torch.store.maintenance import (
                cooldown_from_env,
                segments_high_from_env,
                segments_low_from_env,
                tick_from_env,
            )

            self._maintain_knobs = {
                "high": segments_high_from_env(),
                "low": segments_low_from_env(),
                "tick_s": tick_from_env(),
                "cooldown_s": cooldown_from_env(),
            }
        # wedged-worker watchdog: a slot still at 0.0 is a worker that has
        # not come up yet (startup is covered by the rapid-death logic,
        # not the wedge timeout)
        self.wedge_timeout_s = (
            wedge_timeout_from_env() if wedge_timeout_s is None
            else max(float(wedge_timeout_s), 0.0)
        )
        fd, self._hb_path = tempfile.mkstemp(prefix="avdb_serve_hb_")
        os.write(fd, b"\x00" * (HB_SLOT.size * self.workers))
        os.close(fd)
        with open(self._hb_path, "r+b") as f:
            self._hb_mm = mmap.mmap(f.fileno(), HB_SLOT.size * self.workers)
        # reuseport=False forces the shared-fd path (how tests exercise it
        # where SO_REUSEPORT exists)
        self.reuseport = (
            reuseport_available() if reuseport is None else bool(reuseport)
        )
        # resolve the concrete port up front (--port 0 must advertise one
        # address for the whole fleet)
        self._reserve = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        if self.reuseport:
            self._reserve.setsockopt(
                socket.SOL_SOCKET, socket.SO_REUSEPORT, 1
            )
            # bound, never listening: reserves the port without joining
            # the kernel's accept distribution group
            self._reserve.bind((host, port))
        else:
            self._reserve.setsockopt(
                socket.SOL_SOCKET, socket.SO_REUSEADDR, 1
            )
            self._reserve.bind((host, port))
            self._reserve.listen(1024)
        self.port = self._reserve.getsockname()[1]
        self._procs: dict[int, subprocess.Popen] = {}  # worker idx -> proc
        self._respawns: dict[int, int] = {}
        self._spawn_time: dict[int, float] = {}
        self._stopping = False
        self._respawns_total = 0  # never resets: the avdb_fleet_ series
        self._wedged: set[int] = set()  # killed-by-watchdog markers
        # fleet telemetry plane: workers publish per-worker metric
        # snapshot files here (their aio tick writes them) and the
        # supervisor publishes fleet.json — any worker's
        # /metrics?fleet=1 reads the directory and answers for the fleet
        self._telemetry_dir = tempfile.mkdtemp(prefix="avdb_serve_tm_")
        self._telemetry_last = 0.0
        # crash flight recorder: the supervisor harvests a dead/wedged
        # worker's mmap'd ring into <store>/flight/ and keeps its own
        # ring for daemon/lifecycle events (observability failures are
        # absorbed — the fleet serves with or without a black box)
        from annotatedvdb_tpu_torch.obs import flight as flight_mod

        self._flight_enabled = flight_mod.flight_events_from_env() > 0
        self._sup_flight = None
        if self._flight_enabled:
            try:
                self._sup_flight = flight_mod.FlightRecorder(
                    os.path.join(store_dir, flight_mod.FLIGHT_DIR,
                                 "supervisor.ring"),
                    log=self.log,
                )
                # daemon pass transitions / lifecycle events from THIS
                # process land on the supervisor's ring
                reqtrace.set_background_sink(None, self._sup_flight.event)
            except OSError as err:
                self.log(f"flight: supervisor ring unavailable ({err}); "
                         "continuing without it")
        # the health plane's knobs resolve NOW, for the same reason as
        # disk_reserve above: a typo'd AVDB_OBS_*/AVDB_SLO_* must fail
        # fleet startup (rc 1), not crash every spawned worker in a loop.
        # The supervisor also harvests dead workers' history mirrors, so
        # it needs the enablement fact itself.
        from annotatedvdb_tpu_torch.obs.slo import (
            slo_avail_target_from_env,
            slo_burn_from_env,
            slo_load_floor_from_env,
            slo_slow_window_from_env,
        )
        from annotatedvdb_tpu_torch.obs.timeseries import (
            obs_history_from_env,
            obs_tick_from_env,
        )

        self._history_enabled = (
            obs_tick_from_env() > 0 and obs_history_from_env() > 0
        )
        slo_slow_window_from_env()  # also validates AVDB_SLO_FAST_S
        slo_burn_from_env()
        slo_avail_target_from_env()
        slo_load_floor_from_env()

    # -- worker lifecycle ---------------------------------------------------

    def _worker_cmd(self, index: int) -> list[str]:
        cmd = [
            sys.executable, "-m", "annotatedvdb_tpu_torch", "serve",
            "--storeDir", self.store_dir,
            "--host", self.host, "--port", str(self.port),
            "--_workerIndex", str(index),
            "--_heartbeatFile", self._hb_path,
            "--_telemetryDir", self._telemetry_dir,
        ]
        if not self.reuseport:
            cmd += ["--_listenFd", str(self._reserve.fileno())]
        return cmd + self.worker_args

    def _spawn(self, index: int, respawn: bool = False) -> None:
        # zero the slot: a stale beat from the previous incarnation must
        # not get the replacement killed before it comes up
        self._hb_mm[index * HB_SLOT.size:(index + 1) * HB_SLOT.size] = \
            b"\x00" * HB_SLOT.size
        env = dict(os.environ)
        if respawn and env.get("AVDB_FAULT", "").startswith(
                ("serve.", "wal.", "memtable.")):
            # an injected worker-side fault killed the previous
            # incarnation; the replacement must come up clean — a
            # wal.replay kill re-armed on every respawn would be a crash
            # loop by construction, not a crash test
            self.log(f"worker {index}: respawning with AVDB_FAULT cleared")
            env.pop("AVDB_FAULT")
        proc = subprocess.Popen(
            self._worker_cmd(index),
            env=env,
            pass_fds=() if self.reuseport else (self._reserve.fileno(),),
        )
        self._procs[index] = proc
        self._spawn_time[index] = time.monotonic()
        self.log(f"worker {index}: pid {proc.pid} "
                 f"({'SO_REUSEPORT' if self.reuseport else 'shared fd'})")

    def worker_health(self) -> dict:
        """Aggregate health across live, beating workers, read straight
        from the heartbeat slots (no HTTP poll).  Workers that are dead or
        have not ticked yet contribute nothing."""
        levels: list[int] = []
        exceeds: list[float] = []
        depth_max = 0
        for i, proc in list(self._procs.items()):
            if proc.poll() is not None:
                continue
            try:
                beat, exceed, level, depth = HB_SLOT.unpack_from(
                    self._hb_mm, i * HB_SLOT.size
                )
            except (struct.error, ValueError):
                continue
            if beat <= 0.0:
                continue
            levels.append(int(level))
            exceeds.append(float(exceed))
            depth_max = max(depth_max, int(depth))
        return {
            "workers": len(levels),
            "brownout_max": max(levels, default=0),
            "exceed_max": max(exceeds, default=0.0),
            "queue_depth_max": depth_max,
        }

    def _start_maintenance(self):
        """Arm the maintenance daemon (``--maintain``/``AVDB_MAINTAIN``).
        A daemon that cannot start is logged and skipped — the fleet
        serves either way; knob errors were already caught at
        construction."""
        if not self.maintain:
            return None
        try:
            from annotatedvdb_tpu_torch.store.maintenance import (
                MaintenanceDaemon,
            )

            daemon = MaintenanceDaemon(
                self.store_dir, health=self.worker_health,
                log=self.log, **self._maintain_knobs,
            )
            daemon.start()
            self.log(
                f"maintain: daemon armed (high {daemon.high} / low "
                f"{daemon.low} segment files per group, tick "
                f"~{daemon.tick_s:g}s, cooldown {daemon.cooldown_s:g}s)"
            )
            return daemon
        except Exception as err:
            self.log(f"maintain: daemon failed to start "
                     f"({type(err).__name__}: {err}); fleet serves "
                     "without autonomous maintenance")
            return None

    def run(self) -> int:
        """Spawn the fleet and supervise until SIGTERM/SIGINT; returns the
        exit code (0 on a clean drain)."""
        def _request_stop(signum, frame):
            self._stopping = True

        old_term = signal.signal(signal.SIGTERM, _request_stop)
        old_int = signal.signal(signal.SIGINT, _request_stop)
        daemon = None
        try:
            for i in range(self.workers):
                self._spawn(i)
            daemon = self._start_maintenance()
            self.log(
                f"fleet: serving {self.store_dir} on "
                f"http://{self.host}:{self.port} with {self.workers} "
                f"workers"
            )
            failed = False
            while not self._stopping:
                time.sleep(0.1)
                self._check_wedged()
                self._publish_fleet_telemetry()
                for i, proc in list(self._procs.items()):
                    rc = proc.poll()
                    if rc is None or self._stopping:
                        continue
                    # harvest the black box first: the respawn will
                    # truncate the ring for its fresh incarnation
                    reason = "wedged (watchdog SIGKILL)" \
                        if i in self._wedged else f"died rc={rc}"
                    self._wedged.discard(i)
                    self._harvest_flight(i, reason)
                    self._harvest_history(i, reason)
                    lived = time.monotonic() - self._spawn_time.get(i, 0.0)
                    if lived >= self.HEALTHY_RUN_S:
                        self._respawns[i] = 0  # streak broken: healthy run
                    n = self._respawns[i] = self._respawns.get(i, 0) + 1
                    if n >= self.MAX_RAPID_DEATHS:
                        self.log(
                            f"worker {i}: died {n} consecutive times "
                            f"within {self.HEALTHY_RUN_S:.0f}s of spawn "
                            f"(last rc={rc}); fleet cannot start — "
                            f"giving up"
                        )
                        failed = True
                        self._stopping = True
                        break
                    self.log(f"worker {i}: died rc={rc} after "
                             f"{lived:.1f}s; restart #{n}")
                    # backoff grows with consecutive rapid deaths; the
                    # wait stays responsive to SIGTERM
                    deadline = time.monotonic() + min(
                        self.restart_backoff_s * (n - 1), 5.0
                    )
                    while time.monotonic() < deadline \
                            and not self._stopping:
                        time.sleep(0.1)
                    if not self._stopping:
                        self._respawns_total += 1
                        self._spawn(i, respawn=True)
            if daemon is not None:
                # stop maintenance before draining workers: an in-flight
                # pass aborts cleanly between chunks (cancel observes
                # stop), and no new pass starts under a dying fleet
                daemon.stop()
                daemon = None
            rc = self._drain()
            return 1 if failed else rc
        finally:
            if daemon is not None:  # exception path
                daemon.stop()
            signal.signal(signal.SIGTERM, old_term)
            signal.signal(signal.SIGINT, old_int)
            self._reserve.close()
            with contextlib.suppress(OSError, ValueError):
                self._hb_mm.close()
            with contextlib.suppress(OSError):
                os.unlink(self._hb_path)
            reqtrace.set_background_sink(None, None)
            if self._sup_flight is not None:
                self._sup_flight.close()
            shutil.rmtree(self._telemetry_dir, ignore_errors=True)

    #: seconds between fleet.json publishes
    TELEMETRY_S = 1.0

    def _publish_fleet_telemetry(self) -> None:
        """Atomically publish the supervisor's fleet facts (live worker
        count, cumulative respawns, oldest worker age) next to the
        workers' metric snapshots — the ``avdb_fleet_*`` series any
        worker's ``?fleet=1`` scrape renders.  Best-effort: telemetry
        must never stall the restart loop."""
        now = time.monotonic()
        if now - self._telemetry_last < self.TELEMETRY_S:
            return
        self._telemetry_last = now
        live_ages = [
            now - self._spawn_time.get(i, now)
            for i, p in self._procs.items() if p.poll() is None
        ]
        doc = {
            "t": time.time(),
            "workers_live": len(live_ages),
            "respawns_total": self._respawns_total,
            "worker_age_seconds": round(max(live_ages, default=0.0), 3),
        }
        tmp = os.path.join(self._telemetry_dir,
                           f".fleet.json.tmp{os.getpid()}")
        try:
            with open(tmp, "w") as f:
                json.dump(doc, f)
            os.replace(tmp, os.path.join(self._telemetry_dir, "fleet.json"))
        except OSError as err:
            self.log(f"fleet: telemetry publish failed ({err})")

    def _harvest_flight(self, index: int, reason: str) -> None:
        """Harvest a dead worker's flight ring into
        ``<store>/flight/<ts>-w<idx>.jsonl``.  Every failure is absorbed
        (incl. the ``obs.flight`` fault point): the black box must never
        stall a respawn."""
        if not self._flight_enabled:
            return
        from annotatedvdb_tpu_torch.obs import flight as flight_mod

        try:
            flight_mod.harvest(
                flight_mod.ring_path(self.store_dir, index),
                self.store_dir, index, reason, log=self.log,
            )
        except Exception as err:
            self.log(f"flight: harvest of worker {index} failed "
                     f"({type(err).__name__}: {err}); continuing")

    def _harvest_history(self, index: int, reason: str) -> None:
        """Harvest a dead worker's time-series history mirror into
        ``<store>/history/<ms>-w<idx>.json`` for ``doctor slo``.  Every
        failure is absorbed (incl. the ``obs.tick`` fault point): the
        health plane must never stall a respawn."""
        if not self._history_enabled:
            return
        from annotatedvdb_tpu_torch.obs import timeseries

        try:
            timeseries.harvest(
                timeseries.history_path(self.store_dir, index),
                self.store_dir, index, reason, log=self.log,
            )
        except Exception as err:
            self.log(f"timeseries: harvest of worker {index} failed "
                     f"({type(err).__name__}: {err}); continuing")

    def _check_wedged(self) -> None:
        """SIGKILL workers that are alive but stuck: a worker whose
        heartbeat slot went stale past the wedge timeout holds a parked
        event loop and owns accepted connections that will never answer,
        so the restart loop kills and respawns it (backoff included).  A
        slot still at 0.0 is a worker that has not ticked yet."""
        if self.wedge_timeout_s <= 0 or self._stopping:
            return
        now = time.time()
        for i, proc in self._procs.items():
            if proc.poll() is not None:
                continue  # already dead: the restart loop handles it
            beat = struct.unpack_from("<d", self._hb_mm,
                                      i * HB_SLOT.size)[0]
            if beat <= 0.0:
                continue
            stale = now - beat
            if stale > self.wedge_timeout_s:
                self.log(
                    f"worker {i}: wedged (alive, no heartbeat for "
                    f"{stale:.1f}s > {self.wedge_timeout_s:.1f}s); killing"
                )
                self._hb_mm[i * HB_SLOT.size:(i + 1) * HB_SLOT.size] = \
                    b"\x00" * HB_SLOT.size
                # the death loop harvests the flight ring; this marker
                # gives the harvest its honest reason
                self._wedged.add(i)
                if self._sup_flight is not None:
                    self._sup_flight.event(
                        "watchdog", f"worker {i} wedged; SIGKILL"
                    )
                with contextlib.suppress(OSError):
                    proc.kill()

    def _drain(self) -> int:
        """Graceful stop: SIGTERM every worker, wait out the drain budget,
        SIGKILL stragglers."""
        self.log("fleet: draining")
        for proc in self._procs.values():
            if proc.poll() is None:
                # the worker may vanish between poll and signal
                with contextlib.suppress(OSError):
                    proc.send_signal(signal.SIGTERM)
        deadline = time.monotonic() + self.drain_s
        clean = True
        for i, proc in self._procs.items():
            timeout = max(deadline - time.monotonic(), 0.1)
            try:
                proc.wait(timeout=timeout)
            except subprocess.TimeoutExpired:
                self.log(f"worker {i}: did not drain; killing")
                with contextlib.suppress(OSError):
                    proc.kill()
                proc.wait(timeout=5)
                clean = False
        self.log("fleet: stopped")
        return 0 if clean else 1
