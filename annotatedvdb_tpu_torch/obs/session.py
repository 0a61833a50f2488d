"""Per-load observability session: CLI flags, export wiring, run ledger.

Port of ``annotatedvdb_tpu/obs/session.py``.  Every loader CLI (and
``export``) builds one :class:`ObsSession` around its load:

- ``attach(loader)`` hands the loader a chunk-granularity
  :class:`~annotatedvdb_tpu_torch.obs.metrics.LoadObserver` and (when
  ``--traceOut`` was passed) points the loader's ``StageTimer`` at a
  :class:`~annotatedvdb_tpu_torch.obs.trace.Tracer`, so every stage span
  lands on the host trace timeline under its pipeline thread's track;
- ``finish``/``abort`` export the metrics textfile + JSON snapshot and the
  Chrome trace, then append ONE ``type: "run"`` record to the store's
  ``ledger.jsonl`` — input path, config hash, per-stage seconds, counters,
  queue stalls, error class if the load died — the machine-readable load
  history ``undo_load``/resume tooling and ops audits read back.

Observability must never kill a load: every export path is wrapped — a full
disk or read-only metrics target degrades to a stderr warning, the load's
own exit status is untouched.
"""

from __future__ import annotations

import hashlib
import json
import sys
import time

from annotatedvdb_tpu_torch.obs.metrics import LoadObserver, MetricsRegistry
from annotatedvdb_tpu_torch.obs.trace import Tracer


def add_obs_args(parser) -> None:
    """The telemetry flag pair every loader CLI shares."""
    parser.add_argument(
        "--metricsOut", default=None, metavar="FILE",
        help="write load metrics on exit: a Prometheus textfile at FILE "
             "plus a JSON snapshot at FILE.json",
    )
    parser.add_argument(
        "--traceOut", default=None, metavar="FILE",
        help="write a Chrome trace-event JSON of host pipeline spans "
             "(one track per pipeline thread; open in Perfetto alongside "
             "--profile's device trace)",
    )


def config_hash(params: dict) -> str:
    """Short stable digest of a load's configuration — two runs with the
    same inputs and flags hash identically, so the run ledger groups them."""
    blob = json.dumps(params, sort_keys=True, default=str)
    return hashlib.sha256(blob.encode()).hexdigest()[:12]


def run_record(script: str, input_path: str | None, params: dict,
               counters: dict, wall_seconds: float,
               stages: dict | None = None,
               queue_stalls: dict | None = None,
               error: BaseException | None = None) -> dict:
    """Build one run-ledger record (the ``type: "run"`` JSONL payload)."""
    rec = {
        "script": script,
        "input": input_path,
        "config_hash": config_hash(params),
        "params": {k: v for k, v in params.items()},
        "wall_seconds": round(wall_seconds, 4),
        "counters": {
            k: (int(v) if isinstance(v, (int, bool)) else v)
            for k, v in (counters or {}).items()
        },
        "status": "aborted" if error is not None else "completed",
    }
    if stages:
        rec["stages"] = stages
    if queue_stalls:
        rec["queue_stalls"] = queue_stalls
    if error is not None:
        rec["error_class"] = type(error).__name__
        rec["error"] = str(error)[:500]
    variants = (counters or {}).get("variant") or (counters or {}).get("update")
    if variants and wall_seconds > 0:
        rec["throughput_per_sec"] = round(variants / wall_seconds, 1)
    return rec


def export_counters(reg: MetricsRegistry, counters: dict,
                    loader: str) -> None:
    """Fold a loader's counter dict into the registry as counters (the
    per-load totals a textfile scrape reads)."""
    for key, v in (counters or {}).items():
        if key == "alg_id" or not isinstance(v, (int, float)):
            continue
        reg.counter(
            f"avdb_load_{key}_total", f"loader counter {key!r}",
            {"loader": loader},
        ).inc(v)


def export_stages(reg: MetricsRegistry, stages: dict, wall: float,
                  loader: str) -> None:
    """Per-stage busy seconds + items as labeled counters, wall as gauge."""
    for stage, rec in (stages or {}).items():
        labels = {"loader": loader, "stage": stage}
        reg.counter(
            "avdb_stage_busy_seconds_total",
            "busy seconds per pipeline stage (per-thread, sums past wall "
            "under overlap)", labels,
        ).inc(rec.get("seconds", 0.0))
        if rec.get("items"):
            reg.counter(
                "avdb_stage_items_total", "items per pipeline stage", labels,
            ).inc(rec["items"])
    if wall:
        reg.gauge(
            "avdb_load_wall_seconds", "wall clock of the load",
            {"loader": loader},
        ).set(wall)


def export_queue_stalls(reg: MetricsRegistry, stalls: dict,
                        loader: str) -> None:
    for boundary, rec in (stalls or {}).items():
        labels = {"loader": loader, "boundary": boundary}
        reg.counter(
            "avdb_queue_producer_block_seconds_total",
            "seconds the producer spent blocked on a full stage queue",
            labels,
        ).inc(rec.get("producer_block_s", 0.0))
        reg.counter(
            "avdb_queue_consumer_wait_seconds_total",
            "seconds the consumer spent waiting on an empty stage queue",
            labels,
        ).inc(rec.get("consumer_wait_s", 0.0))
        reg.gauge(
            "avdb_queue_max_depth", "high-water unconsumed items", labels,
        ).set(rec.get("max_depth", 0))


def export_store_stats(reg: MetricsRegistry, store) -> None:
    """Store residency gauges (rows per chromosome shard + total)."""
    try:
        total = 0
        for code, shard in sorted(store.shards.items()):
            from annotatedvdb_tpu_torch.store.variant_store import chromosome_label

            reg.gauge(
                "avdb_store_rows", "resident rows per chromosome shard",
                {"chrom": chromosome_label(code)},
            ).set(shard.n)
            total += shard.n
        reg.gauge(
            "avdb_store_rows_total", "resident rows across all shards"
        ).set(total)
    except Exception as err:  # store introspection must never kill a load
        print(f"obs: store stats skipped ({err})", file=sys.stderr)


class ObsSession:
    """One load's telemetry lifecycle (see module docstring)."""

    def __init__(self, script: str, input_path: str | None, params: dict,
                 metrics_out: str | None = None,
                 trace_out: str | None = None,
                 registry: MetricsRegistry | None = None):
        self.script = script
        self.input_path = input_path
        self.params = dict(params or {})
        self.metrics_out = metrics_out
        self.trace_out = trace_out
        # fresh registry per session by default: the textfile then describes
        # THIS load, not the process's whole history
        self.registry = registry if registry is not None else MetricsRegistry()
        self.tracer = Tracer(process_name=script) if trace_out else None
        self._t0 = time.perf_counter()
        self._loader = None
        self._closed = False
        # baselines for the process-global fault/retry tallies: exports
        # report THIS session's delta, so two loads in one process never
        # double-attribute each other's counts
        from annotatedvdb_tpu_torch.utils import faults as _faults
        from annotatedvdb_tpu_torch.utils import retry as _retry

        self._faults_base = _faults.fired()
        self._retry_base = dict(_retry.stats)

    @classmethod
    def from_args(cls, script: str, args, params: dict) -> "ObsSession":
        return cls(
            script, getattr(args, "fileName", None), params,
            metrics_out=getattr(args, "metricsOut", None),
            trace_out=getattr(args, "traceOut", None),
        )

    def attach(self, loader):
        """Wire a loader into this session (chainable)."""
        self._loader = loader
        loader.obs = LoadObserver(
            self.registry, getattr(loader, "obs_name", type(loader).__name__)
        )
        timer = getattr(loader, "timer", None)
        if timer is not None and self.tracer is not None:
            timer.tracer = self.tracer
        return loader

    # -- closing ------------------------------------------------------------

    def finish(self, ledger, counters: dict, store=None) -> None:
        """Successful load end: export + append the run record."""
        self._close(ledger, counters, None, store)

    def abort(self, ledger, error: BaseException, store=None) -> None:
        """Failed load end: same exports, ``status: "aborted"`` + error
        class in the run record.  Call from the CLI's except path and
        re-raise — the ledger must witness crashes too."""
        counters = dict(getattr(self._loader, "counters", {}) or {})
        self._close(ledger, counters, error, store)

    def _close(self, ledger, counters, error, store) -> None:
        if self._closed:  # abort-then-finish double calls are harmless
            return
        self._closed = True
        wall = time.perf_counter() - self._t0
        loader = self._loader
        name = getattr(loader, "obs_name", self.script)
        timer = getattr(loader, "timer", None)
        stages = timer.as_dict() if timer is not None else None
        if timer is not None and timer.wall_seconds:
            wall = timer.wall_seconds
        stalls = dict(getattr(loader, "queue_stalls", {}) or {})
        try:
            export_counters(self.registry, counters, name)
            export_stages(self.registry, stages or {}, wall, name)
            export_queue_stalls(self.registry, stalls, name)
            # robustness surface: injected-fault fires, bounded-retry
            # attempts, quarantined-row totals (the 'rejected' counter is
            # already folded in via export_counters).  All deltas against
            # the session baseline — the underlying tallies are
            # process-global
            from annotatedvdb_tpu_torch.utils import faults as _faults
            from annotatedvdb_tpu_torch.utils import retry as _retry

            for point, count in _faults.fired().items():
                count -= self._faults_base.get(point, 0)
                if count > 0:
                    self.registry.counter(
                        "avdb_faults_fired_total",
                        "injected faults fired (AVDB_FAULT harness)",
                        {"point": point},
                    ).inc(count)
            retries = _retry.stats["retries"] - self._retry_base["retries"]
            if retries > 0:
                self.registry.counter(
                    "avdb_io_retries_total",
                    "transient-failure retries (I/O + device transfers)",
                    {"loader": name},
                ).inc(retries)
            gave_up = _retry.stats["gave_up"] - self._retry_base["gave_up"]
            if gave_up > 0:
                self.registry.counter(
                    "avdb_io_retries_exhausted_total",
                    "operations that failed after exhausting retries",
                    {"loader": name},
                ).inc(gave_up)
            if store is not None:
                export_store_stats(self.registry, store)
            if self.metrics_out:
                self.registry.write_textfile(self.metrics_out)
                self.registry.write_json(self.metrics_out + ".json")
            if self.tracer is not None and self.trace_out:
                self.tracer.save(self.trace_out)
        except Exception as err:
            print(f"obs: metric/trace export failed ({err})", file=sys.stderr)
        try:
            if ledger is not None:
                ledger.run(run_record(
                    self.script, self.input_path, self.params, counters,
                    wall, stages=stages, queue_stalls=stalls, error=error,
                ))
        except Exception as err:
            print(f"obs: run-ledger append failed ({err})", file=sys.stderr)
