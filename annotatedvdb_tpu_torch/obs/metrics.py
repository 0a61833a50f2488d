"""Thread-safe metrics registry: counters, gauges, fixed-bucket histograms.

Port of ``annotatedvdb_tpu/obs/metrics.py``, trimmed to what the query
server uses: get-or-create accessors and the Prometheus text exposition of
``GET /metrics``.  The JSON snapshot, the textfile writers (``--metricsOut``,
profiling work) and the fleet merge are not ported.
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

    def render(self, lines: list) -> None:
        lines.append(f"{self.name}{_label_str(self.labels)} {_fmt(self.value)}")


class Gauge:
    """Point-in-time value (queue depth, resident bytes, brownout level)."""

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

    def render(self, lines: list) -> None:
        lines.append(f"{self.name}{_label_str(self.labels)} {_fmt(self.value)}")


class Histogram:
    """Fixed-bucket histogram (cumulative ``le`` semantics on export);
    ``edges`` are the finite upper bounds, an implicit +Inf bucket catches
    the tail."""

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
            return {"edges": list(self.edges), "counts": list(self._counts),
                    "sum": self._sum, "count": self._count}

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
    """Named metric store: get-or-create accessors and the Prometheus
    exposition.  Creation is idempotent per (name, labels); asking for an
    existing name with a different type raises."""

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

    def render_prometheus(self) -> str:
        """Prometheus exposition text."""
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
