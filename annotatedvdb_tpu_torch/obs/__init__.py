"""Unified telemetry: metrics registry, host trace timeline, run ledger,
request tracing, and the crash flight recorder.

Port of ``annotatedvdb_tpu/obs/__init__.py``.  Five layers, one import
surface:

- :mod:`~annotatedvdb_tpu_torch.obs.metrics` — thread-safe counters /
  gauges / fixed-bucket histograms with JSON-snapshot and
  Prometheus-textfile export (``--metricsOut``), plus the fleet snapshot
  merge (``?fleet=1``);
- :mod:`~annotatedvdb_tpu_torch.obs.trace` — Chrome trace-event host spans,
  one track per pipeline thread, Perfetto-mergeable with the
  ``torch.profiler`` device trace (``--traceOut``);
- :mod:`~annotatedvdb_tpu_torch.obs.reqtrace` — request-scoped tracing: the
  per-worker span ring, ``avdb_stage_seconds`` stage histograms, the
  slow-request log, and the background-writer sink;
- :mod:`~annotatedvdb_tpu_torch.obs.flight` — the mmap'd crash flight
  recorder (last-N request summaries + lifecycle events, SIGKILL-durable,
  supervisor-harvested, ``doctor flight``);
- :mod:`~annotatedvdb_tpu_torch.obs.session` — the per-CLI lifecycle gluing
  metrics+trace to a load and appending the ``type: "run"`` ledger record.

The serving health plane (:mod:`~annotatedvdb_tpu_torch.obs.timeseries`,
:mod:`~annotatedvdb_tpu_torch.obs.slo`) is imported from its modules.
Nothing here imports ``torch``: the fleet supervisor imports this package.
"""

from annotatedvdb_tpu_torch.obs.flight import FlightRecorder
from annotatedvdb_tpu_torch.obs.metrics import (
    CHUNK_ROW_EDGES,
    CHUNK_SECONDS_EDGES,
    Counter,
    Gauge,
    Histogram,
    LoadObserver,
    MetricsRegistry,
)
from annotatedvdb_tpu_torch.obs.reqtrace import RequestTrace, TraceRecorder
from annotatedvdb_tpu_torch.obs.session import (
    ObsSession,
    add_obs_args,
    config_hash,
    run_record,
)
from annotatedvdb_tpu_torch.obs.trace import Tracer

__all__ = [
    "CHUNK_ROW_EDGES",
    "CHUNK_SECONDS_EDGES",
    "Counter",
    "FlightRecorder",
    "Gauge",
    "Histogram",
    "LoadObserver",
    "MetricsRegistry",
    "ObsSession",
    "RequestTrace",
    "TraceRecorder",
    "Tracer",
    "add_obs_args",
    "config_hash",
    "run_record",
]
