"""Resilience primitives for the serve stack: deadlines, brownout, breaker.

Port of ``annotatedvdb_tpu/serve/resilience.py``:

- **deadline propagation** (:class:`DeadlineExceeded`, :func:`deadline_at`):
  requests carry ``X-Deadline-Ms`` (default
  ``AVDB_SERVE_DEFAULT_DEADLINE_MS``); admission, the batcher queue and the
  bulk/region executors shed already-dead requests with a 504 before any
  device work.
- **brownout ladder** (:class:`OverloadGovernor`): queue depth and the share
  of requests over ``AVDB_SERVE_BROWNOUT_P99_MS`` step the server through
  ``normal`` -> ``limit`` (region limits shrink to
  :data:`BROWNOUT_REGION_LIMIT`) -> ``cache_first`` (point reads answer
  from :class:`PointCache`) -> ``shed_bulk`` (bulk/region/stats answer 503),
  with hysteresis.
- **device circuit breaker** (:class:`DeviceBreaker`): repeated device
  failures of a chromosome group trip that group to the byte-identical
  host path; after a cooldown one half-open trial is let through, and a
  success re-closes the group.

The port's store probe raises on a device error (no store-side fallback),
so the engine catches it and reports to the breaker directly: the
reference's store-side failure hook (``install``/``observing``) is not
ported.  The mesh executor's pre-check reads :meth:`DeviceBreaker.
would_allow` (no trial slot spent).  Ladder transitions
(``on_change``) and breaker trips and re-closes (``events``) feed the
flight recorder's lifecycle timeline (``serve/http.py::ServeContext``).
"""

from __future__ import annotations

import os
import time
from collections import OrderedDict
from annotatedvdb_tpu_torch.utils.locks import make_lock

#: region row ceiling under brownout level >= 1 (the "limit" rung): a hot
#: serving process must bound per-request render work before it starts
#: shedding whole request classes
BROWNOUT_REGION_LIMIT = 256

#: ladder levels (names are the /healthz vocabulary)
LEVEL_NORMAL = 0
LEVEL_LIMIT = 1
LEVEL_CACHE_FIRST = 2
LEVEL_SHED_BULK = 3

LEVEL_NAMES = ("normal", "limit", "cache_first", "shed_bulk")


class DeadlineExceeded(RuntimeError):
    """The request's deadline budget ran out before (or while) it executed
    — the front ends map this to HTTP 504.  Raised for SHED work: the
    response says "we did not do this", never "we failed doing it"."""


def default_deadline_s() -> float:
    """``AVDB_SERVE_DEFAULT_DEADLINE_MS`` as seconds (0 = requests carry no
    deadline unless the client sends ``X-Deadline-Ms``)."""
    return max(
        float(os.environ.get("AVDB_SERVE_DEFAULT_DEADLINE_MS", "") or 0), 0.0
    ) / 1000.0


def deadline_at(header_value: str | None, default_s: float,
                now: float | None = None) -> float | None:
    """Absolute monotonic deadline for a request arriving ``now``.

    ``header_value`` is the raw ``X-Deadline-Ms`` header (milliseconds of
    budget from arrival); an unparseable or non-positive value falls back
    to the default budget (lenient by design: a garbled deadline header
    must not turn a degraded client's requests into 400s).  Returns None
    when neither source sets a budget."""
    budget_s = default_s
    if header_value:
        try:
            ms = float(header_value)
        except ValueError:
            ms = 0.0
        if ms > 0:
            budget_s = ms / 1000.0
    if budget_s <= 0:
        return None
    if now is None:
        now = time.monotonic()
    return now + budget_s


class PointCache:
    """Generation-keyed point-result cache by VARIANT ID — the brownout
    ladder's ``cache_first`` rung.

    The engine's render LRU is keyed by (generation, chromosome, row id),
    which only exists AFTER a probe; this cache fronts the whole lookup by
    the raw id string so a brownout-level-2 point read can answer without
    touching the batcher queue at all.  Populated on every completed point
    read (one lock + dict move per request — measured noise next to the
    render itself); entries carry the generation they were computed
    against, so a stale generation can never serve (its keys age out).
    Negative results (id not in store) cache too: absence is immutable
    per generation, exactly like presence."""

    #: ("miss" sentinel distinct from "not cached")
    _ABSENT = object()

    def __init__(self, capacity: int = 8192):
        self.capacity = int(capacity)
        self._lock = make_lock("serve.resilience.point_cache")
        #: guarded by self._lock
        self._cache: OrderedDict = OrderedDict()

    def get(self, generation: int, variant_id: str):
        """(hit, record_or_None).  ``hit`` False = not cached."""
        key = (generation, variant_id)
        with self._lock:
            v = self._cache.get(key, self._ABSENT)
            if v is self._ABSENT:
                return False, None
            self._cache.move_to_end(key)
            return True, v

    def put(self, generation: int, variant_id: str, record) -> None:
        if self.capacity <= 0:
            return
        key = (generation, variant_id)
        with self._lock:
            self._cache[key] = record
            self._cache.move_to_end(key)
            while len(self._cache) > self.capacity:
                self._cache.popitem(last=False)



def brownout_p99_target_s() -> float:
    """``AVDB_SERVE_BROWNOUT_P99_MS`` as seconds (default 250; 0 disables
    the latency trigger — the queue-depth trigger still governs)."""
    return max(
        float(os.environ.get("AVDB_SERVE_BROWNOUT_P99_MS", "") or 250), 0.0
    ) / 1000.0


class OverloadGovernor:
    """The brownout ladder's state machine.

    Two overload signals, evaluated at most once per ``eval_interval_s``:

    - **queue depth** — the batcher's pending-query depth as a fraction of
      its admission bound (``depth_fn()/max_queue``);
    - **latency-target exceedance** — an EWMA of the indicator
      ``latency > p99_target``: when more than ~5% of recent requests run
      over the target, the true p99 is far past it (1% exceedance == p99
      AT the target, so enter/exit at 5%/1% gives real hysteresis).

    Either signal hot steps the ladder UP one level per evaluation; both
    signals cool (below the exit thresholds) for ``hold_s`` steps it back
    DOWN one level.  One level per step means load spikes brown out in
    under a second while flapping is structurally impossible — a level
    change always out-waits the hold.

    Thread-safe; :meth:`maybe_step` rides request completion and health
    probes (time-gated, so per-request cost is one lock + compare).
    """

    EVAL_INTERVAL_S = 0.25
    HOLD_S = 1.0
    DEPTH_ENTER = 0.5
    DEPTH_EXIT = 0.125
    EXCEED_ENTER = 0.05
    EXCEED_EXIT = 0.01
    EWMA_ALPHA = 0.02

    def __init__(self, depth_fn, max_queue: int,
                 p99_target_s: float | None = None, registry=None,
                 clock=time.monotonic, eval_interval_s: float | None = None,
                 hold_s: float | None = None, on_change=None):
        self._depth_fn = depth_fn
        #: level-transition observer ``on_change(old, new)`` — the flight
        #: recorder's brownout timeline; invoked outside the lock,
        #: failures swallowed
        self.on_change = on_change
        self._max_queue = max(int(max_queue), 1)
        self.p99_target_s = (
            brownout_p99_target_s() if p99_target_s is None
            else max(float(p99_target_s), 0.0)
        )
        self._clock = clock
        self.eval_interval_s = (
            self.EVAL_INTERVAL_S if eval_interval_s is None
            else max(float(eval_interval_s), 0.0)
        )
        self.hold_s = self.HOLD_S if hold_s is None else max(float(hold_s), 0.0)
        self._lock = make_lock("serve.resilience.governor")
        #: guarded by self._lock
        self._level = LEVEL_NORMAL
        #: guarded by self._lock
        self._exceed_ewma = 0.0
        #: guarded by self._lock
        self._samples = 0  # since the last evaluation
        #: guarded by self._lock
        self._next_eval = 0.0
        #: guarded by self._lock
        self._last_change = self._clock()
        if registry is not None:
            self._m_level = registry.gauge(
                "avdb_serve_brownout_level",
                "current brownout degradation level (0=normal..3=shed_bulk)",
            )
        else:
            self._m_level = None

    # -- signals ------------------------------------------------------------

    def note_latency(self, seconds: float) -> None:
        """Feed one completed request's latency (every kind counts: an
        overloaded executor pool shows up in region latency first)."""
        if self.p99_target_s <= 0:
            return
        exceed = 1.0 if seconds > self.p99_target_s else 0.0
        with self._lock:
            self._exceed_ewma += self.EWMA_ALPHA * (exceed - self._exceed_ewma)
            self._samples += 1

    # -- evaluation ---------------------------------------------------------

    def maybe_step(self) -> int:
        """Evaluate the ladder if the interval lapsed; returns the level."""
        now = self._clock()
        with self._lock:
            if now < self._next_eval:
                return self._level
            self._next_eval = now + self.eval_interval_s
            try:
                depth_ratio = self._depth_fn() / self._max_queue
            except Exception:
                depth_ratio = 0.0
            if self._samples == 0:
                # idle window: decay the exceedance signal toward calm —
                # a burst that ended must not pin the ladder up forever
                self._exceed_ewma *= 0.5
            self._samples = 0
            exceed = self._exceed_ewma
            hot = (depth_ratio >= self.DEPTH_ENTER
                   or exceed >= self.EXCEED_ENTER)
            cool = (depth_ratio <= self.DEPTH_EXIT
                    and exceed <= self.EXCEED_EXIT)
            level = self._level
            if hot and level < LEVEL_SHED_BULK:
                level += 1
                self._last_change = now
            elif cool and level > LEVEL_NORMAL \
                    and now - self._last_change >= self.hold_s:
                level -= 1
                self._last_change = now
            old = self._level
            changed = level != old
            self._level = level
        if changed:
            if self._m_level is not None:
                self._m_level.set(level)
            if self.on_change is not None:
                try:
                    self.on_change(old, level)
                except Exception:  # avdb: noqa[AVDB602] -- an observer must never fail the ladder evaluation it watches
                    pass
        return level

    # -- level queries (the front ends' contract) ---------------------------

    @property
    def level(self) -> int:
        with self._lock:
            return self._level

    @property
    def level_name(self) -> str:
        return LEVEL_NAMES[self.level]

    @property
    def exceedance(self) -> float:
        """Current latency-over-target EWMA, published through the fleet
        heartbeat slot."""
        with self._lock:
            return self._exceed_ewma

    def region_limit_cap(self) -> int | None:
        """Row ceiling to clamp region ``limit`` to, or None."""
        return BROWNOUT_REGION_LIMIT if self.level >= LEVEL_LIMIT else None

    def cache_first(self) -> bool:
        return self.level >= LEVEL_CACHE_FIRST

    def shed_bulk(self) -> bool:
        return self.level >= LEVEL_SHED_BULK


class DeviceBreaker:
    """Per-chromosome-group circuit breaker over the device path.

    States per group: ``closed`` (device allowed), ``open`` (host path
    only, until ``reopen_at``), ``half_open`` (exactly one trial in
    flight — success closes, failure re-opens with doubled cooldown).
    The engine reports each device failure of a group (a probe, a BITS or
    stats kernel call) and serves that request from the byte-identical
    host path; the breaker stops paying the failing-device attempt per
    request (open) and recovers when the device heals (half-open).
    """

    FAILURE_THRESHOLD = 3
    COOLDOWN_S = 5.0
    COOLDOWN_MAX_S = 60.0

    def __init__(self, registry=None, log=None, clock=time.monotonic,
                 cooldown_s: float | None = None,
                 failure_threshold: int | None = None):
        self.log = log if log is not None else (lambda msg: None)
        #: lifecycle-event observer ``events(name, detail)`` — the flight
        #: recorder's breaker timeline (ServeContext installs it);
        #: invoked outside the lock, failures swallowed
        self.events = None
        self._clock = clock
        self.cooldown_s = (
            self.COOLDOWN_S if cooldown_s is None else max(float(cooldown_s), 0.0)
        )
        self.failure_threshold = (
            self.FAILURE_THRESHOLD if failure_threshold is None
            else max(int(failure_threshold), 1)
        )
        self._lock = make_lock("serve.resilience.breaker")
        #: guarded by self._lock; code -> {state, failures, reopen_at, cooldown}
        self._groups: dict[int, dict] = {}
        if registry is not None:
            self._m_open = registry.gauge(
                "avdb_serve_breaker_open_groups",
                "chromosome groups currently tripped to the host path",
            )
            self._m_trips = registry.counter(
                "avdb_serve_breaker_trips_total",
                "circuit-breaker trips (group moved closed/half_open -> open)",
            )
            self._m_probes = registry.counter(
                "avdb_serve_breaker_half_open_probes_total",
                "half-open trial probes allowed through a cooled-down group",
            )
        else:
            self._m_open = self._m_trips = self._m_probes = None

    # -- state machine ------------------------------------------------------

    def _group(self, code: int) -> dict:
        g = self._groups.get(code)  # avdb: noqa[AVDB201] -- helper only called with self._lock already held (record_failure)
        if g is None:
            g = self._groups[code] = {  # avdb: noqa[AVDB201] -- helper only called with self._lock already held (record_failure)
                "state": "closed", "failures": 0, "reopen_at": 0.0,
                "cooldown": self.cooldown_s,
            }
        return g

    def allow_device(self, code: int) -> bool:
        """Whether this group's probe may take the device path right now.
        An open group whose cooldown lapsed transitions to half_open and
        admits exactly ONE trial."""
        now = self._clock()
        with self._lock:
            g = self._groups.get(code)
            if g is None or g["state"] == "closed":
                return True
            if g["state"] == "open":
                if now < g["reopen_at"]:
                    return False
                g["state"] = "half_open"
                probe = True
            else:  # half_open: one trial already in flight
                probe = False
        if probe:
            if self._m_probes is not None:
                self._m_probes.inc()
            return True
        return False

    def would_allow(self, code: int) -> bool:
        """:meth:`allow_device`'s verdict WITHOUT consuming the half-open
        trial slot or changing state — for pre-flight gates (the mesh
        executor's ``would_dispatch``) that run before the real admission;
        calling ``allow_device`` twice per dispatch would spend the one
        half-open trial on the pre-check."""
        now = self._clock()
        with self._lock:
            g = self._groups.get(code)
            if g is None or g["state"] == "closed":
                return True
            if g["state"] == "open":
                return now >= g["reopen_at"]
            return False  # half_open: the one trial is already in flight

    def record_failure(self, code: int, exc: BaseException) -> None:
        now = self._clock()
        tripped = False
        with self._lock:
            g = self._group(code)
            if g["state"] == "half_open":
                # the trial failed: re-open, back off harder
                g["cooldown"] = min(g["cooldown"] * 2, self.COOLDOWN_MAX_S)
                g["state"] = "open"
                g["reopen_at"] = now + g["cooldown"]
                g["failures"] = 0
                tripped = True
            elif g["state"] == "closed":
                g["failures"] += 1
                if g["failures"] >= self.failure_threshold:
                    g["state"] = "open"
                    g["reopen_at"] = now + g["cooldown"]
                    g["failures"] = 0
                    tripped = True
            open_count = self._open_count_locked()
        if tripped:
            self.log(
                f"breaker: chromosome group {code} tripped to host path "
                f"({type(exc).__name__}: {exc})"
            )
            if self._m_trips is not None:
                self._m_trips.inc()
            if self.events is not None:
                try:
                    self.events(
                        "breaker",
                        f"group {code} tripped open "
                        f"({type(exc).__name__})",
                    )
                except Exception:  # avdb: noqa[AVDB602] -- an observer must never fail the breaker transition it watches
                    pass
        if self._m_open is not None:
            self._m_open.set(open_count)

    def record_success(self, code: int) -> None:
        closed = False
        with self._lock:
            g = self._groups.get(code)
            if g is None:
                return
            if g["state"] == "half_open":
                g["state"] = "closed"
                g["cooldown"] = self.cooldown_s
                closed = True
            g["failures"] = 0
            open_count = self._open_count_locked()
        if closed:
            self.log(f"breaker: chromosome group {code} re-closed "
                     "(half-open probe succeeded)")
            if self.events is not None:
                try:
                    self.events("breaker", f"group {code} re-closed")
                except Exception:  # avdb: noqa[AVDB602] -- an observer must never fail the breaker transition it watches
                    pass
        if self._m_open is not None:
            self._m_open.set(open_count)

    def _open_count_locked(self) -> int:
        return sum(
            1 for g in self._groups.values() if g["state"] != "closed"  # avdb: noqa[AVDB201] -- _locked suffix contract: every caller holds self._lock
        )

    # -- introspection ------------------------------------------------------

    def open_groups(self) -> list[int]:
        with self._lock:
            return sorted(
                c for c, g in self._groups.items() if g["state"] != "closed"
            )

    def state(self, code: int) -> str:
        with self._lock:
            g = self._groups.get(code)
            return g["state"] if g is not None else "closed"

    def stats(self) -> dict:
        with self._lock:
            return {
                "open_groups": sorted(
                    c for c, g in self._groups.items()
                    if g["state"] != "closed"
                ),
                "groups": {
                    str(c): {"state": g["state"], "failures": g["failures"]}
                    for c, g in self._groups.items()
                },
            }
