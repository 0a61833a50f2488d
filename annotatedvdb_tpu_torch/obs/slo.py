"""Declarative SLOs evaluated as multi-window burn rates over the ring.

Port of ``annotatedvdb_tpu/obs/slo.py``: the same declared SLOs, knobs,
burn arithmetic, state machine and replay, over the port's own
``serve/resilience.py`` and ``store/replication.py`` knob readers.

An SLO here is a *judgment* the database makes about itself from the
time-series ring (``obs/timeseries.py``): availability (non-error answer
fraction), point-read p99 and upsert durable-ack p99 against the
brownout target (``AVDB_SERVE_BROWNOUT_P99_MS`` — the ONE latency
contract the serving stack already enforces), a load variants/sec
floor (``AVDB_SLO_LOAD_FLOOR``; 0 keeps it declared but dormant), and
follower replication lag vs the declared staleness bound
(``AVDB_REPL_MAX_LAG_S`` — the same bound ``/readyz`` enforces, so the
alert plane and the readiness plane never disagree about "stale").

**Burn rate** is budget spend speed: 1.0 means the error budget drains
exactly at the rate the objective allows, N means N times faster.  For
availability the budget is ``1 - target`` of requests erroring; for a
latency SLO it is ``1 - objective`` of requests allowed over the target
(the window fraction above target comes from the histogram-bucket delta,
interpolated — no raw latencies are ever kept); for a rate floor it is
the floor/measured ratio; for a gauge ceiling it is the fraction of the
window's sampled points past the ceiling over the allowed fraction
(``1 - objective``).  An alert needs BOTH windows of a fast+slow
pair (``AVDB_SLO_FAST_S`` / ``AVDB_SLO_SLOW_S``) burning past
``AVDB_SLO_BURN``: the fast window proves the problem is happening NOW,
the slow window proves it is sustained — a single hot sample moves
neither far enough to page.

On top of the window pair sits tick hysteresis: ``ok -> pending`` on the
first breached evaluation, ``pending -> firing`` only after
:data:`SloRegistry.PENDING_TICKS` consecutive breaches, ``firing ->
resolved`` only after :data:`SloRegistry.CLEAR_TICKS` consecutive clean
evaluations (``resolved`` is ``ok`` that remembers it fired).  State is
exported as ``avdb_slo_burn_rate{slo=...}`` / ``avdb_alerts_firing`` on
the worker's own registry — so the alert plane is scraped, snapshotted
into the ring, and fleet-merged like every other metric.

:class:`HealthPlane` bundles one worker's ring + SLO registry behind a
single absorb-everything ``tick()`` — the serving contract ("obs must
never take down serving") stated once, enforced here.
"""

from __future__ import annotations

import os
import time

from annotatedvdb_tpu_torch.obs import timeseries
from annotatedvdb_tpu_torch.obs.timeseries import (
    TimeSeriesRing,
    counter_delta,
    counter_rate,
    gauge_value,
    histogram_window,
    history_path,
    trailing_samples,
    window_samples,
)

#: burn rates are capped here: a dead-stopped rate floor divides by
#: (nearly) zero, and an unbounded gauge export helps nobody
BURN_CAP = 1000.0

#: alert-state severity order (the /healthz and fleet-view rollup)
_STATE_RANK = {"firing": 3, "pending": 2, "resolved": 1, "ok": 0}


def worst_of(states) -> str:
    """The worst of a set of alert states — how a fleet view (or
    ``/healthz``) rolls many SLOs / many workers into one word."""
    return max(states, key=lambda s: _STATE_RANK.get(s, 0), default="ok")


def _parse_float(name: str, raw: str, what: str) -> float:
    try:
        return float(raw)
    except ValueError:
        raise ValueError(f"{name}={raw!r}: not a number ({what})") from None


def slo_fast_window_from_env() -> float:
    """``AVDB_SLO_FAST_S`` — the fast burn window in seconds (default
    60).  Malformed or non-positive values fail startup loudly."""
    raw = os.environ.get("AVDB_SLO_FAST_S", "") or "60"
    v = _parse_float("AVDB_SLO_FAST_S", raw, "fast burn window seconds")
    if v <= 0:
        raise ValueError(f"AVDB_SLO_FAST_S={v}: must be > 0")
    return v


def slo_slow_window_from_env() -> float:
    """``AVDB_SLO_SLOW_S`` — the slow (confirming) burn window in
    seconds (default 300); must be >= the fast window."""
    raw = os.environ.get("AVDB_SLO_SLOW_S", "") or "300"
    v = _parse_float("AVDB_SLO_SLOW_S", raw, "slow burn window seconds")
    if v <= 0:
        raise ValueError(f"AVDB_SLO_SLOW_S={v}: must be > 0")
    if v < slo_fast_window_from_env():
        raise ValueError(
            f"AVDB_SLO_SLOW_S={v}: must be >= AVDB_SLO_FAST_S (the slow "
            "window CONFIRMS the fast one)"
        )
    return v


def slo_burn_from_env() -> float:
    """``AVDB_SLO_BURN`` — the burn-rate threshold both windows must
    exceed for an alert to breach (default 2.0)."""
    raw = os.environ.get("AVDB_SLO_BURN", "") or "2.0"
    v = _parse_float("AVDB_SLO_BURN", raw, "burn-rate threshold")
    if v <= 0:
        raise ValueError(f"AVDB_SLO_BURN={v}: must be > 0")
    return v


def slo_avail_target_from_env() -> float:
    """``AVDB_SLO_AVAIL_TARGET`` — the availability objective (default
    0.999); must sit strictly inside (0, 1) or the error budget is
    zero/everything."""
    raw = os.environ.get("AVDB_SLO_AVAIL_TARGET", "") or "0.999"
    v = _parse_float("AVDB_SLO_AVAIL_TARGET", raw,
                     "availability objective in (0, 1)")
    if not 0.0 < v < 1.0:
        raise ValueError(
            f"AVDB_SLO_AVAIL_TARGET={v}: must be strictly between 0 and 1"
        )
    return v


def slo_load_floor_from_env() -> float:
    """``AVDB_SLO_LOAD_FLOOR`` — minimum load-pipeline variants/sec
    while a load is running (default 0 = declared but dormant)."""
    raw = os.environ.get("AVDB_SLO_LOAD_FLOOR", "") or "0"
    v = _parse_float("AVDB_SLO_LOAD_FLOOR", raw, "variants/sec floor")
    if v < 0:
        raise ValueError(f"AVDB_SLO_LOAD_FLOOR={v}: must be >= 0")
    return v


def fraction_above(edges, counts, count, threshold: float) -> float | None:
    """Fraction of a bucketed window's observations above ``threshold``
    (linear interpolation inside the bucket the threshold splits; the
    +Inf tail is always above).  None for an empty window."""
    count = int(count)
    if count <= 0:
        return None
    below = 0.0
    for i, n in enumerate(counts[:-1]):
        hi = float(edges[i])
        lo = float(edges[i - 1]) if i > 0 else min(0.0, float(edges[0]))
        if hi <= threshold:
            below += n
        elif lo < threshold:
            below += n * (threshold - lo) / (hi - lo)
            break
        else:
            break
    return max(0.0, min(1.0, 1.0 - below / count))


class SloSpec:
    """One declared SLO: a name, an evaluation kind, and its params.

    Kinds:

    - ``availability``: ``target`` objective over
      ``avdb_query_requests_total`` vs ``avdb_query_errors_total``;
    - ``latency``: ``objective`` fraction of ``metric`` observations
      (optionally label-pinned) must finish under ``target_s`` seconds;
    - ``rate_floor``: the windowed rate of ``metric`` must hold
      ``floor`` per second (0 = dormant; absent metric = no judgment);
    - ``gauge_ceiling``: at most ``1 - objective`` of the window's
      sampled ``metric`` gauge points may sit above ``ceiling`` (0 =
      dormant; absent metric — e.g. the replication-lag gauge on a
      process that is not a follower — = no judgment).  A gauge carries
      no delta, so the burn is the breached-sample fraction over the
      window's POINTS, not over a bracketing pair.
    """

    def __init__(self, name: str, kind: str, description: str, **params):
        if kind not in ("availability", "latency", "rate_floor",
                        "gauge_ceiling"):
            raise ValueError(f"slo {name}: unknown kind {kind!r}")
        self.name = name
        self.kind = kind
        self.description = description
        self.params = params

    def target_note(self) -> dict:
        """The target facts an alert payload carries (stable keys per
        kind, so dashboards need no spec lookup)."""
        p = self.params
        if self.kind == "availability":
            return {"target": p.get("target")}
        if self.kind == "latency":
            return {"target_ms": round(
                float(p.get("target_s", 0.0)) * 1000, 3
            ), "objective": p.get("objective")}
        if self.kind == "gauge_ceiling":
            return {"ceiling": p.get("ceiling"),
                    "objective": p.get("objective")}
        return {"floor_per_s": p.get("floor")}

    def burn(self, pair, window: list | None = None) -> float | None:
        """Burn rate over one ``(first, last)`` sample pair, or None
        when the window carries no judgment (no traffic, metric absent,
        dormant floor/ceiling).  ``window`` is the full sample sublist
        the pair brackets — only the gauge kind reads it (point
        fractions need points); pair-only callers get the honest
        two-point fallback."""
        if pair is None:
            return None
        first, last = pair
        p = self.params
        if self.kind == "gauge_ceiling":
            ceiling = float(p.get("ceiling") or 0.0)
            if ceiling <= 0:
                return None
            points = window if window is not None else [first, last]
            vals = [
                gauge_value(s.get("metrics") or {}, p["metric"],
                            p.get("labels"))
                for s in points
            ]
            vals = [v for v in vals if v is not None]
            if not vals:
                return None
            frac = sum(1 for v in vals if v > ceiling) / len(vals)
            budget = 1.0 - float(p.get("objective", 0.9))
            return min(frac / budget, BURN_CAP)
        if self.kind == "availability":
            errors = counter_delta(
                first, last, "avdb_query_errors_total"
            ) or 0.0
            served = counter_delta(
                first, last, "avdb_query_requests_total"
            )
            if served is None:
                return None
            total = served + errors
            if total <= 0:
                return None
            budget = 1.0 - float(p["target"])
            return min((errors / total) / budget, BURN_CAP)
        if self.kind == "latency":
            win = histogram_window(
                first, last, p["metric"], p.get("labels")
            )
            if win is None:
                return None
            edges, counts, count = win
            frac = fraction_above(edges, counts, count,
                                  float(p["target_s"]))
            if frac is None:
                return None
            budget = 1.0 - float(p.get("objective", 0.99))
            return min(frac / budget, BURN_CAP)
        # rate_floor
        floor = float(p.get("floor") or 0.0)
        if floor <= 0:
            return None
        rate = counter_rate(first, last, p["metric"], p.get("labels"))
        if rate is None:
            return None
        return min(floor / max(rate, floor / BURN_CAP), BURN_CAP)


def default_slos() -> list:
    """The declared SLO set every serving worker evaluates.  The p99
    targets resolve from the same ``AVDB_SERVE_BROWNOUT_P99_MS`` knob
    the brownout governor enforces — the alert plane and the shedding
    plane must never disagree about what "too slow" means.  The
    replication-lag ceiling resolves from ``AVDB_REPL_MAX_LAG_S`` for
    the same reason: the bound past which ``/readyz`` declares a
    follower stale IS the bound the alert plane burns against (0
    disables both planes together; on a non-follower the gauge never
    exists, so the objective stays declared-but-silent)."""
    from annotatedvdb_tpu_torch.serve.resilience import brownout_p99_target_s
    from annotatedvdb_tpu_torch.store.replication import repl_max_lag_from_env

    p99_t = brownout_p99_target_s()
    return [
        SloSpec(
            "availability", "availability",
            "non-error answer fraction across every query kind",
            target=slo_avail_target_from_env(),
        ),
        SloSpec(
            "point_read_p99", "latency",
            "point-read p99 vs the brownout latency target",
            metric="avdb_query_seconds", labels={"kind": "point"},
            target_s=p99_t, objective=0.99,
        ),
        SloSpec(
            "upsert_ack_p99", "latency",
            "upsert durable-acknowledgement p99 vs the brownout target",
            metric="avdb_upsert_ack_seconds", labels=None,
            target_s=p99_t, objective=0.99,
        ),
        SloSpec(
            "load_rate", "rate_floor",
            "load-pipeline variants/sec vs the declared floor",
            metric="avdb_rows_total", floor=slo_load_floor_from_env(),
        ),
        SloSpec(
            "replication_lag", "gauge_ceiling",
            "follower staleness vs the declared AVDB_REPL_MAX_LAG_S "
            "bound",
            metric="avdb_replication_lag_seconds",
            ceiling=repl_max_lag_from_env(), objective=0.9,
        ),
    ]


class SloRegistry:
    """The declared SLOs + their alert state machines + the exported
    gauges, evaluated over a sample list each tick."""

    #: consecutive breached evaluations before pending escalates to
    #: firing — with the window pair this is the "one hot sample never
    #: pages" guarantee stated twice
    PENDING_TICKS = 2

    #: consecutive clean evaluations before firing resolves — a flapping
    #: burn rate holds the alert instead of re-paging per tick
    CLEAR_TICKS = 3

    def __init__(self, registry, specs: list | None = None, log=None,
                 fast_s: float | None = None, slow_s: float | None = None,
                 burn_threshold: float | None = None, clock=time.time):
        self.registry = registry
        self.specs = default_slos() if specs is None else list(specs)
        self.log = log if log is not None else (lambda msg: None)
        self.fast_s = slo_fast_window_from_env() if fast_s is None \
            else float(fast_s)
        self.slow_s = slo_slow_window_from_env() if slow_s is None \
            else float(slow_s)
        self.burn_threshold = slo_burn_from_env() \
            if burn_threshold is None else float(burn_threshold)
        self.clock = clock
        self._state: dict[str, dict] = {
            s.name: {
                "state": "ok", "burn_fast": None, "burn_slow": None,
                "breach_ticks": 0, "clear_ticks": 0, "since": None,
                "fired_total": 0,
            }
            for s in self.specs
        }
        self._g_burn = {
            s.name: registry.gauge(
                "avdb_slo_burn_rate",
                "fast-window SLO error-budget burn rate",
                {"slo": s.name},
            )
            for s in self.specs
        }
        self._g_firing = registry.gauge(
            "avdb_alerts_firing", "SLO alerts currently in the firing state"
        )

    def evaluate(self, samples: list, now: float | None = None) -> list:
        """One evaluation pass over the ring: burn rates per window pair,
        state machines stepped, gauges updated.  Returns
        :meth:`alerts`."""
        now = self.clock() if now is None else now
        pair_fast = window_samples(samples, self.fast_s, now=now)
        pair_slow = window_samples(samples, self.slow_s, now=now)
        win_fast = trailing_samples(samples, self.fast_s, now=now)
        win_slow = trailing_samples(samples, self.slow_s, now=now)
        firing = 0
        for spec in self.specs:
            st = self._state[spec.name]
            bf = spec.burn(pair_fast, window=win_fast)
            bs = spec.burn(pair_slow, window=win_slow)
            st["burn_fast"], st["burn_slow"] = bf, bs
            self._g_burn[spec.name].set(bf or 0.0)
            breach = (
                bf is not None and bf > self.burn_threshold
                and bs is not None and bs > self.burn_threshold
            )
            state = st["state"]
            if breach:
                st["clear_ticks"] = 0
                st["breach_ticks"] += 1
                if state in ("ok", "resolved"):
                    st["state"] = "pending"
                    st["since"] = now
                elif state == "pending" \
                        and st["breach_ticks"] >= self.PENDING_TICKS:
                    st["state"] = "firing"
                    st["since"] = now
                    st["fired_total"] += 1
                    self.log(f"slo: {spec.name} FIRING (burn fast="
                             f"{bf:.2f} slow={bs:.2f} > "
                             f"{self.burn_threshold})")
            else:
                st["breach_ticks"] = 0
                if state == "pending":
                    st["state"] = "ok"
                    st["since"] = None
                elif state == "firing":
                    st["clear_ticks"] += 1
                    if st["clear_ticks"] >= self.CLEAR_TICKS:
                        st["state"] = "resolved"
                        st["since"] = now
                        self.log(f"slo: {spec.name} resolved")
            if st["state"] == "firing":
                firing += 1
        self._g_firing.set(firing)
        return self.alerts()

    def alerts(self) -> list:
        """Current alert states, one dict per declared SLO (the
        ``/alerts`` payload rows)."""
        out = []
        for spec in self.specs:
            st = self._state[spec.name]
            out.append({
                "slo": spec.name,
                "kind": spec.kind,
                "description": spec.description,
                "state": st["state"],
                "burn_fast": None if st["burn_fast"] is None
                else round(st["burn_fast"], 4),
                "burn_slow": None if st["burn_slow"] is None
                else round(st["burn_slow"], 4),
                "threshold": self.burn_threshold,
                "since": st["since"],
                "fired_total": st["fired_total"],
                **spec.target_note(),
            })
        return out

    def firing(self) -> int:
        return sum(
            1 for st in self._state.values() if st["state"] == "firing"
        )

    def worst_state(self) -> str:
        return worst_of(st["state"] for st in self._state.values())


class HealthPlane:
    """One worker's health plane: the time-series ring and the SLO
    registry ticked as a unit, behind ONE absorb-everything boundary.

    The persisted history document carries the live alert states, so a
    harvested file (or a sibling's live file, for the ``?fleet=1``
    views) answers both "what were the metrics doing" and "what was the
    alert plane saying" without a second file.
    """

    def __init__(self, registry, store_dir: str | None = None,
                 worker: int = 0, log=None, tick_s: float | None = None,
                 history_s: float | None = None, specs: list | None = None,
                 fast_s: float | None = None, slow_s: float | None = None,
                 burn_threshold: float | None = None, clock=time.time):
        self.log = log if log is not None else (lambda msg: None)
        self.ring = TimeSeriesRing(
            registry, worker=worker,
            path=history_path(store_dir, worker) if store_dir else None,
            tick_s=tick_s, history_s=history_s, log=self.log, clock=clock,
        )
        self.slos = SloRegistry(
            registry, specs=specs, log=self.log, fast_s=fast_s,
            slow_s=slow_s, burn_threshold=burn_threshold, clock=clock,
        )
        self._errors = 0
        self._error_logged = False

    @property
    def enabled(self) -> bool:
        return self.ring.enabled

    @property
    def errors(self) -> int:
        return self._errors + self.ring.errors

    def due(self, now: float | None = None) -> bool:
        return self.ring.due(now)

    def _extra(self) -> dict:
        return {"alerts": self.slos.alerts(),
                "firing": self.slos.firing()}

    def tick(self) -> bool:
        """Sample -> evaluate -> persist, absorbing every failure: the
        maintenance chains driving this (the aio tick, the threaded
        request hook) must never die — or even log per-tick — because
        the observer did."""
        if not self.ring.enabled:
            return False
        try:
            self.ring.sample()
            self.slos.evaluate(self.ring.samples())
            self.ring.persist(self._extra())
            return True
        except Exception as err:
            self._errors += 1
            if not self._error_logged:
                self._error_logged = True
                self.log(
                    f"health: tick failed ({type(err).__name__}: {err}); "
                    "the health plane continues best-effort"
                )
            return False

    def close(self) -> None:
        """Final forced persist (best-effort) so a clean shutdown leaves
        the full tail on disk for ``doctor slo``."""
        try:
            self.ring.persist(self._extra(), force=True)
        except Exception:  # avdb: noqa[AVDB602] -- best-effort final mirror; shutdown must never fail on the observer
            pass


def replay_history(samples: list, specs: list | None = None,
                   fast_s: float | None = None,
                   slow_s: float | None = None,
                   burn_threshold: float | None = None) -> dict:
    """Offline re-evaluation of a harvested (or live) sample list, tick
    by tick — ``doctor slo``'s engine.  Returns the final alert states,
    every state transition with its timestamp, and the per-SLO maximum
    fast burn observed."""
    from annotatedvdb_tpu_torch.obs.metrics import MetricsRegistry

    slos = SloRegistry(
        MetricsRegistry(), specs=specs, fast_s=fast_s, slow_s=slow_s,
        burn_threshold=burn_threshold,
    )
    episodes: list[dict] = []
    max_burn: dict[str, float] = {}
    prev = {s.name: "ok" for s in slos.specs}
    for i in range(len(samples)):
        t = float(samples[i].get("t", 0.0))
        for a in slos.evaluate(samples[: i + 1], now=t):
            if a["burn_fast"] is not None:
                max_burn[a["slo"]] = max(
                    max_burn.get(a["slo"], 0.0), a["burn_fast"]
                )
            if a["state"] != prev[a["slo"]]:
                episodes.append({
                    "t": t, "slo": a["slo"],
                    "from": prev[a["slo"]], "to": a["state"],
                    "burn_fast": a["burn_fast"],
                    "burn_slow": a["burn_slow"],
                })
                prev[a["slo"]] = a["state"]
    return {
        "ticks": len(samples),
        "span_s": round(
            float(samples[-1]["t"]) - float(samples[0]["t"]), 3
        ) if len(samples) >= 2 else 0.0,
        "alerts": slos.alerts(),
        "episodes": episodes,
        "max_burn": {k: round(v, 4) for k, v in max_burn.items()},
    }


# re-exported for the serving layer: the history surfaces and the plane
# live behind one import
__all__ = [
    "BURN_CAP",
    "HealthPlane",
    "SloRegistry",
    "SloSpec",
    "default_slos",
    "fraction_above",
    "replay_history",
    "slo_avail_target_from_env",
    "slo_burn_from_env",
    "slo_fast_window_from_env",
    "slo_load_floor_from_env",
    "slo_slow_window_from_env",
    "timeseries",
    "worst_of",
]
