"""Metrics time-series history: a bounded ring of registry snapshots.

Port of ``annotatedvdb_tpu/obs/timeseries.py``, whole: the ring, the
window and quantile helpers, and the history files are the reference's,
byte for byte on disk, and the ``obs.tick`` fault point fires at its three
sites (sample, persist, harvest).

The metrics registry answers "what is the worker doing right now"; this
module gives it MEMORY.  Every ``AVDB_OBS_TICK_S`` seconds a worker
appends one full :meth:`MetricsRegistry.snapshot` to an in-process ring
bounded to ``AVDB_OBS_HISTORY_S`` of retention, and derives what raw
snapshots cannot say directly:

- **counter -> rate/delta**: two samples bracket a window; the counter
  delta over it (clamped at zero — a respawned worker restarts its
  counters) divided by the elapsed time is the window rate;
- **histogram -> quantile**: the bucket-count DELTA between two samples
  is itself a histogram of exactly the window's observations, so
  :func:`annotatedvdb_tpu_torch.obs.metrics.bucket_quantile` over the delta
  estimates the window's p50/p99 — the signal the SLO burn-rate
  evaluation (``obs/slo.py``) feeds on.

Persistence follows the crash flight recorder's harvest model: the ring
is written (time-gated, every :data:`TimeSeriesRing.PERSIST_S`) to
``<store>/history/w<idx>.ts.json`` with the registry's atomic
tmp+rename discipline, so the fleet supervisor can :func:`harvest` the
history of a SIGKILLed or wedge-killed worker into
``<store>/history/<ms>-w<idx>.json`` exactly like a flight black box —
``doctor slo`` replays either.  A SIGKILL loses at most the un-persisted
tail (<= PERSIST_S seconds), the same explicit trade the flight
recorder's FLUSH_S makes.

Failure policy: observability must never take down serving: the
serving-side callers (:meth:`TimeSeriesRing.tick`, the health plane's
tick) absorb any failure — logged once, counted, next tick runs.
"""

from __future__ import annotations

import json
import os
import threading
import time

from annotatedvdb_tpu_torch.obs.metrics import bucket_quantile
from annotatedvdb_tpu_torch.utils import faults

#: the history subdirectory under a store (live rings + harvests)
HISTORY_DIR = "history"


def obs_tick_from_env() -> float:
    """``AVDB_OBS_TICK_S`` — seconds between time-series snapshots
    (default 1.0; 0 disables the history ring).  A malformed value fails
    startup loudly (the parse_bytes precedent): a typo silently
    disabling the health plane is how an outage goes unwatched."""
    raw = os.environ.get("AVDB_OBS_TICK_S", "") or "1.0"
    try:
        v = float(raw)
    except ValueError:
        raise ValueError(
            f"AVDB_OBS_TICK_S={raw!r}: not a number (seconds between "
            "snapshots; 0 disables)"
        ) from None
    if v < 0:
        raise ValueError(f"AVDB_OBS_TICK_S={raw!r}: must be >= 0")
    return v


def obs_history_from_env() -> float:
    """``AVDB_OBS_HISTORY_S`` — time-series retention in seconds
    (default 300; 0 disables the history ring).  Malformed values fail
    startup loudly, like :func:`obs_tick_from_env`."""
    raw = os.environ.get("AVDB_OBS_HISTORY_S", "") or "300"
    try:
        v = float(raw)
    except ValueError:
        raise ValueError(
            f"AVDB_OBS_HISTORY_S={raw!r}: not a number (seconds of "
            "retention; 0 disables)"
        ) from None
    if v < 0:
        raise ValueError(f"AVDB_OBS_HISTORY_S={raw!r}: must be >= 0")
    return v


def history_path(store_dir: str, worker: int) -> str:
    """The live history file of worker ``worker`` under ``store_dir``."""
    return os.path.join(store_dir, HISTORY_DIR, f"w{int(worker)}.ts.json")


# -- sample arithmetic (shared by the ring, the SLO evaluator, doctor) ------


def _matches(entry: dict, labels: dict | None) -> bool:
    """Entry-label SUBSET match: ``labels=None`` matches every series of
    the name, ``{"kind": "point"}`` matches exactly the point series —
    so availability can sum across kinds while a latency SLO pins one."""
    have = entry.get("labels") or {}
    return all(have.get(k) == v for k, v in (labels or {}).items())


def counter_value(snapshot: dict, name: str,
                  labels: dict | None = None) -> float | None:
    """Sum of the matching counter series' values in one snapshot, or
    None when the metric has no matching series yet."""
    vals = [
        float(e.get("value") or 0.0)
        for e in snapshot.get(name, [])
        if e.get("kind") == "counter" and _matches(e, labels)
    ]
    return sum(vals) if vals else None


def gauge_value(snapshot: dict, name: str,
                labels: dict | None = None) -> float | None:
    """Max of the matching gauge series (the fleet-merge convention)."""
    vals = [
        float(e.get("value") or 0.0)
        for e in snapshot.get(name, [])
        if e.get("kind") == "gauge" and _matches(e, labels)
    ]
    return max(vals) if vals else None


def histogram_state(snapshot: dict, name: str,
                    labels: dict | None = None):
    """``(edges, counts, count)`` summed over the matching histogram
    series of one snapshot (bucket-wise, first-edges-win on mismatch —
    the :func:`merge_snapshots` rule), or None when absent."""
    edges = None
    counts: list[int] = []
    total = 0
    for e in snapshot.get(name, []):
        if e.get("kind") != "histogram" or not _matches(e, labels):
            continue
        ee = [float(x) for x in (e.get("edges") or [])]
        cc = [int(x) for x in (e.get("counts") or [])]
        if edges is None:
            edges, counts = ee, cc
        elif ee == edges and len(cc) == len(counts):
            counts = [a + b for a, b in zip(counts, cc)]
        else:
            continue
        total += int(e.get("count") or 0)
    if edges is None:
        return None
    return edges, counts, total


def counter_delta(first: dict, last: dict, name: str,
                  labels: dict | None = None) -> float | None:
    """Counter increase between two samples' metric snapshots, clamped
    at zero (a respawned worker restarts its counters — a negative delta
    is a restart, not negative work)."""
    a = counter_value(first.get("metrics") or {}, name, labels)
    b = counter_value(last.get("metrics") or {}, name, labels)
    if b is None:
        return None
    return max(b - (a or 0.0), 0.0)


def counter_rate(first: dict, last: dict, name: str,
                 labels: dict | None = None) -> float | None:
    """Per-second counter rate between two samples (None when the metric
    is absent or the samples do not span time)."""
    d = counter_delta(first, last, name, labels)
    dt = float(last.get("t", 0.0)) - float(first.get("t", 0.0))
    if d is None or dt <= 0:
        return None
    return d / dt


def histogram_window(first: dict, last: dict, name: str,
                     labels: dict | None = None):
    """``(edges, counts, count)`` of exactly the observations that
    landed BETWEEN two samples: the bucket-count delta is itself a
    histogram of the window (clamped at zero per bucket across worker
    restarts).  None when the metric is absent from the newer sample."""
    b = histogram_state(last.get("metrics") or {}, name, labels)
    if b is None:
        return None
    a = histogram_state(first.get("metrics") or {}, name, labels)
    edges, bc, bn = b
    if a is None or a[0] != edges or len(a[1]) != len(bc):
        return edges, bc, bn
    counts = [max(x - y, 0) for x, y in zip(bc, a[1])]
    return edges, counts, max(bn - a[2], 0)


def window_quantile(first: dict, last: dict, name: str, q: float,
                    labels: dict | None = None) -> float | None:
    """Bucket-interpolated quantile of the observations between two
    samples (the histogram delta through :func:`bucket_quantile`)."""
    win = histogram_window(first, last, name, labels)
    if win is None:
        return None
    edges, counts, count = win
    return bucket_quantile(edges, counts, count, q)


def window_samples(samples: list, window_s: float,
                   now: float | None = None):
    """``(first, last)`` bracketing the trailing ``window_s`` seconds of
    a sample list (oldest sample inside the window, newest overall), or
    None when fewer than two samples exist — a single point has no
    delta.  A young ring spans less than the asked window; the honest
    answer is the span it has."""
    if len(samples) < 2:
        return None
    last = samples[-1]
    cutoff = (float(last["t"]) if now is None else now) - float(window_s)
    first = samples[0]
    for s in samples:
        if float(s["t"]) >= cutoff:
            first = s
            break
    if first is last:
        first = samples[-2]
    return first, last


def trailing_samples(samples: list, window_s: float,
                     now: float | None = None):
    """Every sample inside the trailing ``window_s`` seconds of a sample
    list (oldest first), or None when fewer than two samples exist.
    Falls back to the newest two samples when the window catches fewer —
    the same young-ring honesty as :func:`window_samples`.  Gauge-kind
    SLOs feed on this: a gauge carries no delta, so its window judgment
    is the FRACTION of sampled points past the bound, which needs the
    points themselves rather than a bracketing pair."""
    if len(samples) < 2:
        return None
    cutoff = (float(samples[-1]["t"]) if now is None else now) \
        - float(window_s)
    win = [s for s in samples if float(s["t"]) >= cutoff]
    if len(win) < 2:
        win = samples[-2:]
    return win


def derive_series(samples: list) -> list:
    """The ``/metrics/history`` derivation: every metric in the ring as
    a point list — counters as per-interval rates, gauges as sampled
    values, histograms as per-interval observation rate + p50/p99
    estimates.  Returns ``[{"name", "labels", "kind", "points"}]``."""
    series: dict[tuple, dict] = {}

    def slot(name, entry):
        key = (name, tuple(sorted((entry.get("labels") or {}).items())))
        s = series.get(key)
        if s is None:
            s = series[key] = {
                "name": name,
                "labels": dict(entry.get("labels") or {}),
                "kind": entry.get("kind"),
                "points": [],
            }
        return s

    prev = None
    for sample in samples:
        t = round(float(sample.get("t", 0.0)), 3)
        snap = sample.get("metrics") or {}
        dt = (float(sample["t"]) - float(prev["t"])) if prev else 0.0
        for name, entries in snap.items():
            for e in entries:
                kind = e.get("kind")
                s = slot(name, e)
                if kind == "gauge":
                    s["points"].append(
                        {"t": t, "value": float(e.get("value") or 0.0)}
                    )
                    continue
                if prev is None or dt <= 0:
                    continue  # deltas need a preceding sample
                labels = e.get("labels") or None
                if kind == "counter":
                    rate = counter_rate(prev, sample, name, labels)
                    if rate is not None:
                        s["points"].append({"t": t, "rate": round(rate, 4)})
                elif kind == "histogram":
                    win = histogram_window(prev, sample, name, labels)
                    if win is None:
                        continue
                    edges, counts, count = win
                    point = {"t": t, "rate": round(count / dt, 4)}
                    if count:
                        for label, q in (("p50", 0.5), ("p99", 0.99)):
                            v = bucket_quantile(edges, counts, count, q)
                            if v is not None:
                                point[label] = round(v, 6)
                    s["points"].append(point)
        prev = sample
    return [series[k] for k in sorted(series)]


# -- the ring ---------------------------------------------------------------


class TimeSeriesRing:
    """One worker's in-process snapshot ring + its persisted mirror.

    :meth:`sample` and :meth:`persist` are the raw halves (they raise);
    :meth:`tick` is the
    serving-side composition that absorbs every failure — logged once,
    counted, the maintenance tick chain never dies of its observer.
    """

    #: persisted-mirror cadence: the ring samples every tick_s but
    #: rewrites its file only this often — a SIGKILL loses at most this
    #: much history (the flight recorder's FLUSH_S trade, made explicit)
    PERSIST_S = 5.0

    def __init__(self, registry, worker: int = 0, path: str | None = None,
                 tick_s: float | None = None,
                 history_s: float | None = None, log=None,
                 clock=time.time):
        self.registry = registry
        self.worker = int(worker)
        self.path = path
        self.tick_s = obs_tick_from_env() if tick_s is None \
            else float(tick_s)
        self.history_s = obs_history_from_env() if history_s is None \
            else float(history_s)
        self.log = log if log is not None else (lambda msg: None)
        self.clock = clock
        #: serializes sample/prune against payload reads (both front
        #: ends read while the tick writes).  Plain stdlib lock: obs-
        #: layer locks stay outside the serve lock-order tracer
        self._lock = threading.Lock()
        #: guarded by self._lock
        self._samples: list[dict] = []
        self._last_tick = 0.0
        self._last_persist = 0.0
        self._errors = 0
        self._error_logged = False

    @property
    def enabled(self) -> bool:
        return self.tick_s > 0 and self.history_s > 0

    @property
    def errors(self) -> int:
        return self._errors

    def due(self, now: float | None = None) -> bool:
        """Time-gate for the serving-side callers (the aio maintenance
        tick, the threaded front end's request-completion hook)."""
        if not self.enabled:
            return False
        now = time.monotonic() if now is None else now
        return now - self._last_tick >= self.tick_s

    def samples(self) -> list:
        """The current ring contents, oldest first (a copied list — the
        payload functions and SLO evaluator iterate without the lock)."""
        with self._lock:
            return list(self._samples)

    def span_s(self) -> float:
        with self._lock:
            if len(self._samples) < 2:
                return 0.0
            return float(self._samples[-1]["t"]) \
                - float(self._samples[0]["t"])

    def sample(self) -> dict:
        """Append one registry snapshot and prune past retention.
        RAISES on failure (and on an injected ``obs.tick`` fault) — the
        serving-side caller absorbs (:meth:`tick`)."""
        # crash point: a failing snapshot must cost one tick, never the
        # maintenance chain that drives it
        faults.fire("obs.tick")
        self._last_tick = time.monotonic()
        t = self.clock()
        doc = {"t": t, "metrics": self.registry.snapshot()}
        with self._lock:
            self._samples.append(doc)
            cutoff = t - self.history_s
            while self._samples and float(self._samples[0]["t"]) < cutoff:
                self._samples.pop(0)
        return doc

    def document(self, extra: dict | None = None) -> dict:
        """The persisted-mirror JSON document (also the fleet-view and
        harvest shape)."""
        doc = {
            "type": "timeseries",
            "worker": self.worker,
            "t": self.clock(),
            "tick_s": self.tick_s,
            "history_s": self.history_s,
            "samples": self.samples(),
        }
        if extra:
            doc.update(extra)
        return doc

    def persist(self, extra: dict | None = None,
                force: bool = False) -> bool:
        """Atomically rewrite the history file (tmp+rename — a harvester
        or fleet view must never read a torn document).  Time-gated to
        :data:`PERSIST_S` unless ``force``.  RAISES on failure (and on
        an injected ``obs.tick`` fault); :meth:`tick` absorbs."""
        if self.path is None:
            return False
        now = time.monotonic()
        if not force and now - self._last_persist < self.PERSIST_S:
            return False
        self._last_persist = now
        # crash point: a failing history persist must cost one mirror
        # write, never the tick chain (and the previous file survives —
        # the write is tmp+rename)
        faults.fire("obs.tick")
        d = os.path.dirname(os.path.abspath(self.path))
        os.makedirs(d, exist_ok=True)
        tmp = os.path.join(
            d, f".{os.path.basename(self.path)}.tmp{os.getpid()}"
        )
        with open(tmp, "w") as f:
            json.dump(self.document(extra), f, separators=(",", ":"))
        os.replace(tmp, self.path)
        return True

    def tick(self, extra: dict | None = None) -> bool:
        """One serving-side tick: sample + (time-gated) persist, every
        failure absorbed — logged once, counted, next tick runs."""
        if not self.enabled:
            return False
        try:
            self.sample()
            self.persist(extra)
            return True
        except Exception as err:
            self._errors += 1
            if not self._error_logged:
                self._error_logged = True
                self.log(
                    f"timeseries: tick failed ({type(err).__name__}: "
                    f"{err}); history continues best-effort"
                )
            return False


# -- read side (harvest / fleet view / doctor) ------------------------------


def load_history(path: str) -> dict:
    """One persisted history document back (raises OSError/ValueError on
    a missing or foreign file — callers absorb per the fleet-view
    convention)."""
    with open(path) as f:
        doc = json.load(f)
    if not isinstance(doc, dict) or doc.get("type") != "timeseries":
        raise ValueError(f"{path}: not a timeseries history file")
    doc.setdefault("samples", [])
    return doc


def harvest(history_file: str, store_dir: str, worker: int, reason: str,
            log=None) -> str | None:
    """Preserve a dead worker's live history file as
    ``<store>/history/<ms>-w<idx>.json`` (with the death reason stamped
    in) and return the path — or None when there is nothing to harvest.
    The SUPERVISOR wraps this call (a failed harvest must never stall
    the respawn loop); the ``obs.tick`` fault point injects here."""
    log = log if log is not None else (lambda msg: None)
    # crash point: an injected failure inside the harvest must be
    # absorbed by the supervisor (serving and respawn continue)
    faults.fire("obs.tick")
    if not os.path.isfile(history_file):
        return None
    doc = load_history(history_file)
    if not doc["samples"]:
        return None
    doc["harvested"] = {"reason": reason, "t": time.time()}
    out_dir = os.path.join(store_dir, HISTORY_DIR)
    os.makedirs(out_dir, exist_ok=True)
    out = os.path.join(
        out_dir, f"{int(time.time() * 1000)}-w{int(worker)}.json"
    )
    tmp = out + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f, separators=(",", ":"))
    os.replace(tmp, out)
    log(f"timeseries: harvested {len(doc['samples'])} sample(s) from "
        f"worker {worker} ({reason}) -> {out}")
    return out


def list_history(store_dir: str) -> dict:
    """``{"harvested": [paths newest-first], "live": [paths]}`` under
    ``<store>/history`` — what ``doctor slo`` and the fleet views have
    to work with."""
    d = os.path.join(store_dir, HISTORY_DIR)
    harvested: list[str] = []
    live: list[str] = []
    if os.path.isdir(d):
        for fname in sorted(os.listdir(d)):
            p = os.path.join(d, fname)
            if fname.endswith(".ts.json"):
                live.append(p)
            elif fname.endswith(".json") and not fname.startswith("."):
                harvested.append(p)
    harvested.sort(reverse=True)
    return {"harvested": harvested, "live": live}
