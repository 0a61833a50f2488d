"""Autonomous storage management: the watermark-driven maintenance daemon,
the disk-pressure write guard and the ``doctor status`` report.

Port of ``annotatedvdb_tpu/store/maintenance.py``:

- :class:`MaintenanceDaemon` — hosted in the serve fleet supervisor
  (``serve --maintain``): polls the live manifest on a jittered tick,
  computes per-group segment-file counts (the read-amplification
  surface), and when any group reaches ``AVDB_MAINTAIN_SEGMENTS_HIGH``
  files runs a compaction pass (``store/compact.py``, its cooperative
  commit protocol), staying engaged until every group is at or below
  ``AVDB_MAINTAIN_SEGMENTS_LOW`` (hysteresis).  Worker health (brownout
  level and p99-target exceedance from the fleet's heartbeat slots)
  pauses a pass before it starts and aborts one mid-run through the
  ``cancel`` callable; setbacks back off exponentially, and after
  :data:`MaintenanceDaemon.MAX_CONSEC_FAILURES` consecutive hard failures
  the daemon disables itself loudly.
- :class:`DiskReserveGuard` — the upsert path's write guard (the 507 of
  ``POST /variants/upsert`` below ``AVDB_STORE_DISK_RESERVE_BYTES``).
- :func:`store_status` — reads only the manifest, the directory listing,
  WAL frames and the ledger: it never loads a segment and never touches
  the card.

The daemon operates on the store directory plus an injected health
callable; it never imports from ``serve/``.  Compaction is host work, as
in the reference: a pass runs no kernel.  Its lifecycle events and its
``maintain.pass`` background span go to the process's flight recorder
through ``obs/reqtrace.py``'s sink (the fleet supervisor's ring).  The
``maintain.tick`` fault point fires per tick (absorbed: logged, backed
off), and ``maintain.disk_guard`` per free-disk reading (an injected
failure reads as a low disk: upserts answer 507).
"""

from __future__ import annotations

import json
import os
import random
import threading
import time

from annotatedvdb_tpu_torch.obs import reqtrace
from annotatedvdb_tpu_torch.utils import faults
from annotatedvdb_tpu_torch.utils.locks import make_lock
from annotatedvdb_tpu_torch.utils.retry import retry_preempted

#: worker p99-target exceedance at/above which the daemon treats the
#: fleet as hot and yields (``OverloadGovernor.EXCEED_ENTER``, duplicated
#: because store/ must not import from serve/)
P99_EXCEED_HOT = 0.05


def maintain_enabled_from_env() -> bool:
    """``AVDB_MAINTAIN``: 1 arms the maintenance daemon in the fleet
    supervisor (the ``--maintain`` flag is the CLI spelling)."""
    return os.environ.get("AVDB_MAINTAIN", "").lower() \
        not in ("", "0", "false")


def _parse_int(name: str, raw: str, default: int, minimum: int) -> int:
    if not raw:
        return default
    try:
        v = int(raw)
    except ValueError:
        raise ValueError(
            f"{name} must be an integer (got {raw!r})"
        ) from None
    return max(v, minimum)


def _parse_float(name: str, raw: str, default: float,
                 minimum: float) -> float:
    if not raw:
        return default
    try:
        v = float(raw)
    except ValueError:
        raise ValueError(
            f"{name} must be a number (got {raw!r})"
        ) from None
    return max(v, minimum)


def segments_high_from_env() -> int:
    """``AVDB_MAINTAIN_SEGMENTS_HIGH`` (default 8, floor 2): per-group
    segment-file count at which the daemon engages."""
    return _parse_int(
        "AVDB_MAINTAIN_SEGMENTS_HIGH",
        os.environ.get("AVDB_MAINTAIN_SEGMENTS_HIGH", "").strip(), 8, 2,
    )


def segments_low_from_env() -> int:
    """``AVDB_MAINTAIN_SEGMENTS_LOW`` (default 2, floor 1): the
    hysteresis exit — engaged until every group is at/below this."""
    return _parse_int(
        "AVDB_MAINTAIN_SEGMENTS_LOW",
        os.environ.get("AVDB_MAINTAIN_SEGMENTS_LOW", "").strip(), 2, 1,
    )


def tick_from_env() -> float:
    """``AVDB_MAINTAIN_TICK_S`` (default 2 s, floor 0.05): daemon poll
    cadence; each sleep is jittered ±25% so daemons never phase-lock
    their manifest polls."""
    return _parse_float(
        "AVDB_MAINTAIN_TICK_S",
        os.environ.get("AVDB_MAINTAIN_TICK_S", "").strip(), 2.0, 0.05,
    )


def cooldown_from_env() -> float:
    """``AVDB_MAINTAIN_COOLDOWN_S`` (default 5 s): base cool-down after a
    paused, preempted or failed pass, doubling per consecutive setback."""
    return _parse_float(
        "AVDB_MAINTAIN_COOLDOWN_S",
        os.environ.get("AVDB_MAINTAIN_COOLDOWN_S", "").strip(), 5.0, 0.0,
    )


def disk_reserve_from_env() -> int:
    """``AVDB_STORE_DISK_RESERVE_BYTES`` (default 0 = disabled): free
    bytes under the store below which upserts shed 507.  ``512m``/``2g``
    suffixes via the shared parser — a typo'd reserve errors loudly
    instead of silently disabling the guard."""
    raw = os.environ.get("AVDB_STORE_DISK_RESERVE_BYTES", "").strip()
    if not raw or raw == "0":
        return 0
    from annotatedvdb_tpu_torch.utils.strings import parse_bytes

    try:
        return parse_bytes(raw)
    except ValueError as err:
        raise ValueError(f"AVDB_STORE_DISK_RESERVE_BYTES: {err}") from None


def free_disk_bytes(path: str) -> int:
    """Unprivileged-available bytes on the filesystem holding ``path``."""
    st = os.statvfs(path)
    return int(st.f_bavail) * int(st.f_frsize)


class DiskReserveGuard:
    """The disk-pressure write guard: ``breached()`` is True while free
    disk under the store sits below the configured reserve.

    One ``statvfs`` per TTL window (default 1 s), so the upsert path does
    not pay a syscall per request.  An unreadable reading counts as
    breached: when the guard cannot see free space it refuses writes
    rather than acknowledge rows a full disk may not hold.  State flips
    are logged once per transition."""

    TTL_S = 1.0

    def __init__(self, store_dir: str, reserve: int | None = None,
                 ttl_s: float | None = None, log=None):
        self.store_dir = store_dir
        self.reserve = (
            disk_reserve_from_env() if reserve is None
            else max(int(reserve), 0)
        )
        self.ttl_s = self.TTL_S if ttl_s is None else max(float(ttl_s), 0.0)
        self.log = log if log is not None else (lambda msg: None)
        self._lock = make_lock("store.disk_guard")
        #: guarded by self._lock
        self._cached: tuple[bool, int] = (False, -1)
        #: guarded by self._lock
        self._check_at = 0.0
        #: guarded by self._lock
        self._was_breached = False

    def state(self, force: bool = False) -> tuple[bool, int]:
        """(breached, free_bytes); ``free_bytes`` is -1 when the reading
        failed (treated as breached) or the guard is disabled."""
        if self.reserve <= 0:
            return False, -1
        now = time.monotonic()
        with self._lock:
            if not force and now < self._check_at:
                return self._cached
            self._check_at = now + self.ttl_s
        why = ""
        try:
            # crash point: fires per free-disk reading — an injected
            # failure IS a low-disk observation (see class docstring)
            faults.fire("maintain.disk_guard")
            free = free_disk_bytes(self.store_dir)
            breached = free < self.reserve
        except Exception as err:
            free, breached = -1, True
            why = f" (free-space reading failed: {err})"
        with self._lock:
            flipped = breached != self._was_breached
            self._was_breached = breached
            self._cached = (breached, free)
        if flipped:
            if breached:
                self.log(
                    f"disk guard: free space "
                    f"{free if free >= 0 else 'unknown'} bytes below the "
                    f"{self.reserve}-byte reserve{why}; upserts answer 507 "
                    "until space is freed (reads/flushes/compaction keep "
                    "running)"
                )
            else:
                self.log("disk guard: reserve satisfied again; "
                         "upserts resume")
        return breached, free

    def breached(self) -> bool:
        return self.state()[0]


def _metrics(registry):
    if registry is None:
        return None
    return {
        "passes": registry.counter(
            "avdb_maintain_passes_total",
            "watermark-driven compaction passes committed by the "
            "maintenance daemon",
        ),
        "preemptions": registry.counter(
            "avdb_maintain_preemptions_total",
            "maintenance passes preempted cleanly (another writer "
            "committed mid-pass, or the pass was cancelled)",
        ),
        "paused": registry.counter(
            "avdb_maintain_paused_total",
            "maintenance passes paused or aborted because worker health "
            "was hot (brownout active / p99 target breached)",
        ),
        "failures": registry.counter(
            "avdb_maintain_failures_total",
            "maintenance passes that failed hard (I/O, corrupt segment)",
        ),
    }


class MaintenanceDaemon:
    """Background compactor with watermark hysteresis and load-aware
    yielding.  See the module docstring for the policy; the mechanics:

    - :meth:`tick` is one full evaluation and NEVER raises — it is what
      the daemon thread runs per jittered interval, and what tests call
      directly for deterministic stepping.
    - ``health`` is a zero-arg callable returning
      ``{"brownout_max": int, "exceed_max": float, ...}`` (the fleet's
      :meth:`~annotatedvdb_tpu_torch.serve.fleet.ServeFleet.worker_health`);
      ``None`` means no health source — the daemon never pauses.
    - The compaction pass itself is ``store.compact.compact_store`` with
      ``min_stems = max(low + 1, AVDB_COMPACT_MIN_SEGMENTS)``: groups
      already at/below the low watermark are not re-merged, and the
      existing compactor floor always wins over the watermark (a floor
      above the high watermark makes every pass a no-op, which
      disengages the daemon instead of spinning it).
    """

    MAX_BACKOFF_S = 60.0
    #: consecutive HARD failures after which the daemon disables itself
    #: (pauses/preemptions are healthy yields and never count) — the
    #: fleet's MAX_RAPID_DEATHS precedent: never a compact-crash loop
    MAX_CONSEC_FAILURES = 5
    #: health readings are cached this long (the cancel callable runs
    #: per merge chunk)
    HEALTH_TTL_S = 0.25

    def __init__(self, store_dir: str, health=None, registry=None,
                 log=None, high: int | None = None, low: int | None = None,
                 tick_s: float | None = None,
                 cooldown_s: float | None = None, retries: int = 1,
                 rng_seed: int | None = None):
        self.store_dir = store_dir
        self.health = health
        self.log = log if log is not None else (lambda msg: None)
        self.high = segments_high_from_env() if high is None \
            else max(int(high), 2)
        low = segments_low_from_env() if low is None else max(int(low), 1)
        #: hysteresis needs low < high to exist at all
        self.low = min(low, self.high - 1)
        self.tick_s = tick_from_env() if tick_s is None \
            else max(float(tick_s), 0.05)
        self.cooldown_s = cooldown_from_env() if cooldown_s is None \
            else max(float(cooldown_s), 0.0)
        self.retries = max(int(retries), 0)
        self.registry = registry
        self._m = _metrics(registry)
        self._rng = random.Random(
            0xA5DB ^ os.getpid() if rng_seed is None else rng_seed
        )
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._lock = make_lock("store.maintenance")
        #: guarded by self._lock
        self._engaged = False
        #: guarded by self._lock
        self._disabled = False
        #: guarded by self._lock — consecutive setbacks of ANY kind
        #: (pause/preempt/failure): drives the exponential backoff
        self._consec = 0
        #: guarded by self._lock — consecutive HARD failures only:
        #: drives MAX_CONSEC_FAILURES self-disable
        self._consec_failures = 0
        #: guarded by self._lock
        self._resume_at = 0.0
        #: guarded by self._lock
        self._counts = {"passes": 0, "preemptions": 0, "paused": 0,
                        "failures": 0, "ticks": 0}
        self._hot_cached = False
        self._hot_check_at = 0.0

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._run, name="avdb-maintain", daemon=True
        )
        self._thread.start()

    def stop(self, timeout: float = 15.0) -> None:
        """Cooperative shutdown: an in-flight pass aborts cleanly between
        chunks (the cancel callable observes the stop flag)."""
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout)

    def _run(self) -> None:
        while not self._stop.wait(self._jitter()):
            self.tick()

    def _jitter(self) -> float:
        """Tick interval jittered ±25%: manifest polls from many daemons
        must not phase-lock."""
        return self.tick_s * (0.75 + 0.5 * self._rng.random())

    # -- one evaluation -----------------------------------------------------

    def tick(self) -> str:
        """One daemon tick; never raises.  Returns the decision taken
        (``idle``/``cooldown``/``paused``/``pass``/``preempted``/
        ``noop``/``failed``/``error``/``disabled``) — the observable the
        watermark-semantics tests step on."""
        with self._lock:
            self._counts["ticks"] += 1
        try:
            # crash point: a dying tick (unreadable manifest, injected
            # fault) must never kill the supervisor or the fleet — the
            # daemon logs, backs off, and keeps ticking
            faults.fire("maintain.tick")
            return self._step()
        except Exception as err:
            backoff = self._note_setback()
            self.log(f"maintain: tick failed ({type(err).__name__}: "
                     f"{err}); next attempt in {backoff:.1f}s")
            return "error"

    def _step(self) -> str:
        now = time.monotonic()
        with self._lock:
            if self._disabled:
                return "disabled"
            if now < self._resume_at:
                return "cooldown"
            engaged = self._engaged
        spans = self.read_amp()
        amp = max(spans.values(), default=0)
        if not engaged:
            if amp < self.high:
                return "idle"
            with self._lock:
                self._engaged = True
            self.log(
                f"maintain: watermark tripped (a group holds {amp} "
                f"segment files >= high {self.high}); compaction engaged"
            )
            reqtrace.lifecycle_event(
                "maintain", f"engaged (read-amp {amp} >= high {self.high})"
            )
        if self._hot():
            self._count("paused")
            backoff = self._note_setback()
            self.log(
                "maintain: pass paused (worker brownout active or p99 "
                f"target breached); next attempt in {backoff:.1f}s"
            )
            reqtrace.lifecycle_event("maintain", "pass paused (hot health)")
            return "paused"
        reqtrace.lifecycle_event("maintain", "pass starting")
        try:
            report = retry_preempted(
                self._compact_once, retries=self.retries,
                # our own cancel (stop request / hot health) is not a
                # preemption to retry: the re-run would abort against
                # the same condition
                cancel=self._cancel,
                log=lambda m: self.log(f"maintain: {m}"),
                what="maintenance pass",
            )
        except Exception as err:
            self._count("failures")
            backoff = self._note_setback()
            with self._lock:
                self._consec_failures += 1
                n = self._consec_failures
                give_up = n >= self.MAX_CONSEC_FAILURES
                if give_up:
                    self._disabled = True
            if give_up:
                self.log(
                    f"maintain: {n} consecutive pass failures (last: "
                    f"{type(err).__name__}: {err}); daemon DISABLED — "
                    "run `doctor --storeDir ...` and restart the fleet "
                    "to re-arm autonomy"
                )
            else:
                self.log(
                    f"maintain: pass failed ({type(err).__name__}: "
                    f"{err}); retry in {backoff:.1f}s"
                )
            reqtrace.lifecycle_event(
                "maintain",
                f"pass failed ({type(err).__name__})"
                + ("; daemon DISABLED" if give_up else ""),
            )
            return "failed"
        status = report.get("status")
        if status == "compacted":
            self._count("passes")
            with self._lock:
                self._consec = 0
                self._consec_failures = 0
                self._resume_at = 0.0
            spans = self.read_amp()
            amp = max(spans.values(), default=0)
            self.log(
                f"maintain: pass merged {report['files_before']} -> "
                f"{report['files_after']} segment file(s); max read-amp "
                f"now {amp}"
            )
            reqtrace.lifecycle_event(
                "maintain",
                f"pass committed ({report['files_before']}->"
                f"{report['files_after']} files, read-amp {amp})",
            )
            if amp <= self.low:
                with self._lock:
                    self._engaged = False
                self.log(f"maintain: converged (max {amp} <= low "
                         f"{self.low}); disengaged")
            return "pass"
        if status == "noop":
            # nothing eligible: the AVDB_COMPACT_MIN_SEGMENTS floor (or
            # scope) wins over the watermark — disengage AND back off
            # (the watermark condition persists, so without a cooldown
            # the next tick would re-engage, re-plan, and re-log this
            # same pair forever; the backoff caps the spin at one pair
            # per MAX_BACKOFF_S while the misconfiguration lasts)
            with self._lock:
                self._engaged = False
            backoff = self._note_setback()
            self.log("maintain: nothing eligible (the "
                     "AVDB_COMPACT_MIN_SEGMENTS floor wins); disengaged, "
                     f"next evaluation in {backoff:.1f}s")
            return "noop"
        # cleanly aborted after retries: another writer preempted us, or
        # our own health cancel fired mid-pass
        self._count("preemptions")
        backoff = self._note_setback()
        if self._hot(force=True):
            self._count("paused")
            self.log(
                "maintain: pass paused mid-run (worker health went hot); "
                f"next attempt in {backoff:.1f}s"
            )
            reqtrace.lifecycle_event(
                "maintain", "pass aborted mid-run (hot health)"
            )
            return "paused"
        self.log(
            f"maintain: pass preempted ({report.get('reason')}); "
            f"retry in {backoff:.1f}s"
        )
        reqtrace.lifecycle_event(
            "maintain", f"pass preempted ({report.get('reason')})"
        )
        return "preempted"

    # -- helpers ------------------------------------------------------------

    def read_amp(self) -> dict:
        """{label: on-disk segment-file count} from the live manifest —
        the read-amplification surface the watermarks judge."""
        from annotatedvdb_tpu_torch.store.compact import segment_spans

        return segment_spans(self.store_dir)

    def _compact_once(self) -> dict:
        from annotatedvdb_tpu_torch.store.compact import (
            _min_stems,
            compact_store,
        )

        with reqtrace.background_span("maintain.pass"):
            return compact_store(
                self.store_dir,
                min_stems=max(self.low + 1, _min_stems()),
                cancel=self._cancel,
                registry=self.registry,
                log=lambda m: self.log(f"maintain: {m}"),
            )

    def _cancel(self) -> bool:
        """The cooperative-abort hook handed to the compactor: stop
        requests and hot worker health both end the pass cleanly between
        chunks."""
        return self._stop.is_set() or self._hot()

    def _hot(self, force: bool = False) -> bool:
        if self.health is None:
            return False
        now = time.monotonic()
        if not force and now < self._hot_check_at:
            return self._hot_cached
        try:
            h = self.health() or {}
        except Exception:
            h = {}
        hot = (int(h.get("brownout_max") or 0) >= 1
               or float(h.get("exceed_max") or 0.0) >= P99_EXCEED_HOT)
        self._hot_cached = hot
        self._hot_check_at = now + self.HEALTH_TTL_S
        return hot

    def _count(self, name: str) -> None:
        with self._lock:
            self._counts[name] += 1
        if self._m is not None:
            self._m[name].inc()

    def _note_setback(self) -> float:
        """Exponential backoff on consecutive setbacks (pause/preempt/
        failure); returns the cool-down installed."""
        with self._lock:
            self._consec += 1
            backoff = min(
                self.cooldown_s * (2 ** (self._consec - 1)),
                self.MAX_BACKOFF_S,
            ) if self.cooldown_s > 0 else 0.0
            self._resume_at = time.monotonic() + backoff
        return backoff

    def stats(self) -> dict:
        with self._lock:
            return {
                **self._counts,
                "engaged": self._engaged,
                "disabled": self._disabled,
                "consecutive_setbacks": self._consec,
                "backoff_s": round(
                    max(self._resume_at - time.monotonic(), 0.0), 3
                ),
                "high": self.high,
                "low": self.low,
            }


# ---------------------------------------------------------------------------
# doctor status


def store_status(store_dir: str) -> dict:
    """One-screen store health report (the ``doctor status`` verb): what
    an operator — or the soak harness — needs to assert health without
    parsing the manifest by hand."""
    from annotatedvdb_tpu_torch.store.compact import _min_stems, _normalize_groups
    from annotatedvdb_tpu_torch.store.memtable import is_flush_tmp
    from annotatedvdb_tpu_torch.store.wal import (
        count_records,
        is_wal_file,
        is_wal_tmp,
    )

    mpath = os.path.join(store_dir, "manifest.json")
    with open(mpath) as f:
        manifest = json.load(f)
    if not isinstance(manifest, dict) or "shards" not in manifest:
        raise ValueError(f"{mpath}: not a store manifest")
    stats_rows = (manifest.get("stats") or {}).get("rows") or {}
    groups = {}
    for label, glist in sorted(_normalize_groups(manifest).items()):
        stems = sum(len(g) for g in glist)
        groups[label] = {
            "segments": stems,
            "rows": stats_rows.get(label),
        }
    amps = [g["segments"] for g in groups.values()]
    high = segments_high_from_env()
    low = segments_low_from_env()

    wal_files = []
    debris = {"flush_tmp": 0, "compact_tmp": 0, "wal_tmp": 0,
              "stale_tmp": 0}
    from annotatedvdb_tpu_torch.store.compact import is_compact_tmp

    for fname in sorted(os.listdir(store_dir)):
        fp = os.path.join(store_dir, fname)
        if not os.path.isfile(fp):
            continue
        if is_wal_tmp(fname):
            debris["wal_tmp"] += 1
        elif is_wal_file(fname):
            try:
                nbytes = os.path.getsize(fp)
            except OSError:
                nbytes = 0
            wal_files.append({
                "file": fname,
                "records": count_records(fp),
                "bytes": int(nbytes),
            })
        elif is_flush_tmp(fname):
            debris["flush_tmp"] += 1
        elif is_compact_tmp(fname):
            debris["compact_tmp"] += 1
        elif fname.startswith(".") and ".tmp" in fname:
            debris["stale_tmp"] += 1

    reserve = disk_reserve_from_env()
    try:
        free = free_disk_bytes(store_dir)
    except OSError:
        free = -1
    last_compact = last_flush = None
    runs = 0
    lpath = os.path.join(store_dir, "ledger.jsonl")
    if os.path.exists(lpath):
        try:
            from annotatedvdb_tpu_torch.store.ledger import AlgorithmLedger

            ledger = AlgorithmLedger(lpath, log=lambda m: None)
            compacts = ledger.compactions()
            flushes = ledger.flushes()
            last_compact = compacts[-1] if compacts else None
            last_flush = flushes[-1] if flushes else None
            runs = len(ledger.runs())
        except (OSError, ValueError, KeyError):
            # an unreadable ledger is fsck's finding, not status's: the
            # report still carries everything the directory itself shows
            last_compact = last_flush = None
    # mesh placement: devices + groups-per-device from the manifest's
    # advisory block (written at save time under AVDB_MESH_SHAPE) or from
    # the env itself.  Resident bytes are an ESTIMATE from row counts
    # (rows x identity-cache bytes/row) — status must never touch CUDA
    # (a busy or absent card must not hang or fail the report), so it
    # reports what WOULD be resident per device against the per-device
    # share of AVDB_SERVE_HBM_BUDGET.
    placement = manifest.get("mesh_placement")
    if not isinstance(placement, dict):
        from annotatedvdb_tpu_torch.parallel.placement import placement_hint

        placement = placement_hint()
    mesh_block = None
    if placement and placement.get("devices", 0) > 1:
        n_dev = int(placement["devices"])
        width = int(manifest.get("width", 0))
        per_device_groups: dict = {}
        per_device_bytes: dict = {}
        for label, dev in (placement.get("groups") or {}).items():
            if label not in groups:
                continue
            key = str(dev)
            per_device_groups[key] = per_device_groups.get(key, 0) + 1
            rows = groups[label]["rows"] or 0
            per_device_bytes[key] = (
                per_device_bytes.get(key, 0) + rows * (16 + 2 * width)
            )
        from annotatedvdb_tpu_torch.utils.strings import parse_bytes

        budget_spec = os.environ.get("AVDB_SERVE_HBM_BUDGET", "").strip()
        budget = parse_bytes(budget_spec) if budget_spec else 0
        mesh_block = {
            "devices": n_dev,
            "groups_per_device": dict(sorted(per_device_groups.items())),
            "est_resident_bytes_per_device": dict(
                sorted(per_device_bytes.items())
            ),
            "per_device_budget_bytes": budget // n_dev if budget else 0,
        }
    return {
        "store_dir": store_dir,
        "rows": sum(
            int(g["rows"]) for g in groups.values()
            if g["rows"] is not None
        ),
        "groups": groups,
        "mesh": mesh_block,
        "read_amp": {
            "max": max(amps, default=0),
            "mean": round(sum(amps) / len(amps), 2) if amps else 0.0,
        },
        "watermarks": {
            "high": high,
            "low": low,
            "min_segments": _min_stems(),
            "over_high": sorted(
                lb for lb, g in groups.items() if g["segments"] >= high
            ),
        },
        "wal": {
            "files": len(wal_files),
            "records_pending_replay": sum(w["records"] for w in wal_files),
            "bytes": sum(w["bytes"] for w in wal_files),
            "by_file": wal_files,
        },
        "debris": debris,
        "disk": {
            "free_bytes": int(free),
            "reserve_bytes": int(reserve),
            # an UNREADABLE reading (free -1) reports breached, exactly
            # like the serving guard: when free space cannot be seen the
            # workers are refusing writes, and this report must say so
            "breached": bool(reserve > 0
                             and (free < 0 or free < reserve)),
        },
        "ledger": {
            "runs": runs,
            "last_compact": last_compact,
            "last_flush": last_flush,
        },
    }
