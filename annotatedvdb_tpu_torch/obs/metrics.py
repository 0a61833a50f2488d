"""Thread-safe metrics registry: counters, gauges, fixed-bucket histograms.

Port of ``annotatedvdb_tpu/obs/metrics.py`` for the query server and its
health plane: get-or-create accessors, the Prometheus exposition of
``GET /metrics``, the JSON snapshot the time-series ring samples
(``obs/timeseries.py``), :func:`bucket_quantile` (window quantiles from
snapshot deltas), and the fleet merge and rendering behind
``/metrics?fleet=1``.  The textfile writers (``--metricsOut``) and the
loaders' ``LoadObserver`` are not ported.

Histograms use fixed bucket edges chosen at creation, so two snapshots are
bucket-comparable by construction and rendering is O(buckets).
"""

from __future__ import annotations

import bisect
import math
import re
import threading

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")

#: histogram edges (seconds) for per-pass wall times (``avdb_compact_seconds``)
CHUNK_SECONDS_EDGES = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5,
    5.0, 10.0, 30.0,
)


def _fmt(v: float) -> str:
    """Prometheus exposition float formatting (integers stay integral)."""
    if isinstance(v, float) and (math.isinf(v) or math.isnan(v)):
        return "+Inf" if v > 0 else ("-Inf" if math.isinf(v) else "NaN")
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def bucket_quantile(edges, counts, count, q: float) -> float | None:
    """Quantile estimate from fixed histogram buckets (the Prometheus
    ``histogram_quantile`` interpolation): locate the bucket holding rank
    ``q*count`` and interpolate linearly inside it.  Works on the
    ``{"edges", "counts", "count"}`` triple every histogram snapshot
    carries, so the time-series ring can estimate quantiles from
    persisted snapshot DELTAS without live metric objects.

    Returns None for an empty histogram (no rank to locate).  A rank
    landing in the open-ended +Inf tail returns the highest finite edge —
    the honest answer is "at least this", and a finite number keeps SLO
    arithmetic total.
    """
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"quantile {q} outside [0, 1]")
    edges = tuple(float(e) for e in edges)
    counts = [int(c) for c in counts]
    count = int(count)
    if count <= 0 or not edges or len(counts) != len(edges) + 1:
        return None
    rank = q * count
    cum = 0
    for i, n in enumerate(counts[:-1]):
        prev_cum = cum
        cum += n
        if cum >= rank and n > 0:
            hi = edges[i]
            lo = edges[i - 1] if i > 0 else min(0.0, edges[0])
            return lo + (hi - lo) * ((rank - prev_cum) / n)
    return edges[-1]


def _label_str(labels: dict | None) -> str:
    if not labels:
        return ""
    def esc(v) -> str:
        return str(v).replace("\\", "\\\\").replace('"', '\\"')
    inner = ",".join(
        f'{k}="{esc(v)}"' for k, v in sorted(labels.items())
    )
    return "{" + inner + "}"


class Counter:
    """Monotonic counter.  ``inc`` only; negative increments are rejected."""

    kind = "counter"

    def __init__(self, name: str, help: str = "", labels: dict | None = None):
        self.name, self.help, self.labels = name, help, dict(labels or {})
        self._lock = threading.Lock()
        #: guarded by self._lock
        self._value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name}: negative increment {n}")
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def snapshot(self) -> dict:
        return {"value": self.value}

    def render(self, lines: list) -> None:
        lines.append(f"{self.name}{_label_str(self.labels)} {_fmt(self.value)}")


class Gauge:
    """Point-in-time value (queue depth, resident rows, overlap factor)."""

    kind = "gauge"

    def __init__(self, name: str, help: str = "", labels: dict | None = None):
        self.name, self.help, self.labels = name, help, dict(labels or {})
        self._lock = threading.Lock()
        #: guarded by self._lock
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def snapshot(self) -> dict:
        return {"value": self.value}

    def render(self, lines: list) -> None:
        lines.append(f"{self.name}{_label_str(self.labels)} {_fmt(self.value)}")


class Histogram:
    """Fixed-bucket histogram (cumulative ``le`` semantics on export).

    ``edges`` are the finite upper bounds, strictly increasing; an implicit
    +Inf bucket catches the tail.  ``observe`` is O(log buckets) and takes
    one lock — cheap enough for chunk-granularity observation, NOT meant for
    per-row loops (loaders observe per chunk by design).
    """

    kind = "histogram"

    def __init__(self, name: str, edges, help: str = "",
                 labels: dict | None = None):
        edges = tuple(float(e) for e in edges)
        if not edges:
            raise ValueError(f"histogram {name}: needs at least one edge")
        if any(b <= a for a, b in zip(edges, edges[1:])):
            raise ValueError(
                f"histogram {name}: edges must be strictly increasing"
            )
        self.name, self.help, self.labels = name, help, dict(labels or {})
        self.edges = edges
        self._lock = threading.Lock()
        #: guarded by self._lock
        self._counts = [0] * (len(edges) + 1)  # +1: the +Inf tail
        #: guarded by self._lock
        self._sum = 0.0
        #: guarded by self._lock
        self._count = 0

    def observe(self, v: float) -> None:
        i = bisect.bisect_left(self.edges, float(v))
        with self._lock:
            self._counts[i] += 1
            self._sum += float(v)
            self._count += 1

    def snapshot(self) -> dict:
        with self._lock:
            counts = list(self._counts)
            return {
                "edges": list(self.edges),
                "counts": counts,
                "sum": self._sum,
                "count": self._count,
            }

    def render(self, lines: list) -> None:
        snap = self.snapshot()
        cum = 0
        for edge, n in zip(self.edges, snap["counts"]):
            cum += n
            labels = dict(self.labels, le=_fmt(edge))
            lines.append(f"{self.name}_bucket{_label_str(labels)} {cum}")
        labels = dict(self.labels, le="+Inf")
        lines.append(
            f"{self.name}_bucket{_label_str(labels)} {snap['count']}"
        )
        ls = _label_str(self.labels)
        lines.append(f"{self.name}_sum{ls} {_fmt(snap['sum'])}")
        lines.append(f"{self.name}_count{ls} {snap['count']}")


class MetricsRegistry:
    """Named metric store: get-or-create accessors, JSON + Prometheus export.

    Creation is idempotent per (name, frozen labels) — a loader re-run in the
    same process reuses its metrics; asking for an existing name with a
    different TYPE is a bug and raises.
    """

    def __init__(self):
        self._lock = threading.Lock()
        #: guarded by self._lock
        self._metrics: dict[tuple, object] = {}

    def _get(self, cls, name: str, help: str, labels: dict | None, **kw):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        key = (name, tuple(sorted((labels or {}).items())))
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = cls(name, help=help, labels=labels, **kw)
                self._metrics[key] = m
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as {m.kind}"
                )
            return m

    def counter(self, name: str, help: str = "",
                labels: dict | None = None) -> Counter:
        return self._get(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "",
              labels: dict | None = None) -> Gauge:
        return self._get(Gauge, name, help, labels)

    def histogram(self, name: str, edges, help: str = "",
                  labels: dict | None = None) -> Histogram:
        h = self._get(Histogram, name, help, labels, edges=edges)
        if tuple(float(e) for e in edges) != h.edges:
            raise ValueError(
                f"histogram {name!r} already registered with different edges"
            )
        return h

    def metrics(self) -> list:
        with self._lock:
            return list(self._metrics.values())

    def snapshot(self) -> dict:
        """{name: [{labels, kind, ...values}]} — the JSON export shape."""
        out: dict[str, list] = {}
        for m in self.metrics():
            entry = {"kind": m.kind, "labels": m.labels, **m.snapshot()}
            out.setdefault(m.name, []).append(entry)
        return out

    def render_prometheus(self) -> str:
        """Prometheus exposition text (textfile-collector compatible)."""
        lines: list[str] = []
        seen_meta: set[str] = set()
        for m in sorted(self.metrics(), key=lambda m: m.name):
            if m.name not in seen_meta:
                seen_meta.add(m.name)
                if m.help:
                    lines.append(f"# HELP {m.name} {m.help}")
                lines.append(f"# TYPE {m.name} {m.kind}")
            m.render(lines)
        return "\n".join(lines) + "\n"


def merge_snapshots(snaps: list) -> dict:
    """Merge several registries' :meth:`MetricsRegistry.snapshot` dicts
    into one fleet-wide view — the ``/metrics?fleet=1`` aggregation:

    - **counters / histograms sum** (requests served by any worker are
      requests served by the fleet; histogram counts add bucket-wise when
      the edges agree, and a mismatched-edge series keeps the first
      worker's view rather than inventing a hybrid);
    - **gauges take the max** (queue depth, brownout level, resident
      bytes: the fleet-level question is "how hot is the hottest
      worker", and summing a level would be meaningless).
    """
    out: dict[str, list] = {}
    index: dict[tuple, dict] = {}
    for snap in snaps:
        for name, entries in snap.items():
            for e in entries:
                key = (name, tuple(sorted((e.get("labels") or {}).items())))
                have = index.get(key)
                if have is None:
                    have = index[key] = {
                        "kind": e.get("kind"),
                        "labels": dict(e.get("labels") or {}),
                    }
                    if e.get("kind") == "histogram":
                        have["edges"] = list(e.get("edges") or [])
                        have["counts"] = list(e.get("counts") or [])
                        have["sum"] = float(e.get("sum") or 0.0)
                        have["count"] = int(e.get("count") or 0)
                    else:
                        have["value"] = float(e.get("value") or 0.0)
                    out.setdefault(name, []).append(have)
                    continue
                if have["kind"] != e.get("kind"):
                    continue  # cross-worker kind clash: keep the first
                if have["kind"] == "histogram":
                    if list(e.get("edges") or []) != have["edges"]:
                        continue
                    counts = list(e.get("counts") or [])
                    if len(counts) == len(have["counts"]):
                        have["counts"] = [
                            a + b for a, b in zip(have["counts"], counts)
                        ]
                    have["sum"] += float(e.get("sum") or 0.0)
                    have["count"] += int(e.get("count") or 0)
                elif have["kind"] == "counter":
                    have["value"] += float(e.get("value") or 0.0)
                else:  # gauge
                    have["value"] = max(
                        have["value"], float(e.get("value") or 0.0)
                    )
    return out


def render_snapshot(snapshot: dict) -> str:
    """Prometheus exposition text from a snapshot dict (the shape
    :meth:`MetricsRegistry.snapshot` and :func:`merge_snapshots` emit) —
    the fleet view renders from merged FILES, so rendering cannot go
    through live metric objects."""
    lines: list[str] = []
    for name in sorted(snapshot):
        entries = snapshot[name]
        if not entries:
            continue
        lines.append(f"# TYPE {name} {entries[0].get('kind')}")
        for e in sorted(entries,
                        key=lambda e: _label_str(e.get("labels"))):
            labels = e.get("labels") or {}
            if e.get("kind") == "histogram":
                cum = 0
                for edge, n in zip(e.get("edges") or [],
                                   e.get("counts") or []):
                    cum += n
                    ls = _label_str(dict(labels, le=_fmt(edge)))
                    lines.append(f"{name}_bucket{ls} {cum}")
                ls = _label_str(dict(labels, le="+Inf"))
                lines.append(f"{name}_bucket{ls} {e.get('count', 0)}")
                ls = _label_str(labels)
                lines.append(f"{name}_sum{ls} {_fmt(e.get('sum', 0.0))}")
                lines.append(f"{name}_count{ls} {e.get('count', 0)}")
            else:
                lines.append(
                    f"{name}{_label_str(labels)} "
                    f"{_fmt(e.get('value', 0.0))}"
                )
    return "\n".join(lines) + "\n"
