"""Load telemetry, unit by unit: the PyTorch port against the JAX package.

``obs/trace.py`` (the host span tracer), the ``StageTimer`` tracer mirror
and accounting, ``run_record`` and ``config_hash``, the registry's
textfile and JSON writers, ``LoadObserver`` and the session's export
helpers get the same calls in both packages; every comparison is exact
(tolerance 0: no arithmetic here is anything but sums of the same floats
in the same order), with trace clocks pinned by a fake
``time.perf_counter_ns`` so timestamps are equal too.  ``device_trace``
(``torch.profiler``, the port's ``--profile``) is checked on the CPU: it
writes a Chrome trace holding the CPU operators of every thread, and it
refuses a CUDA capture the profiler cannot record.
"""

import collections
import glob
import json
import os
import threading
import time

import pytest
import torch

from annotatedvdb_tpu.obs import metrics as ref_metrics
from annotatedvdb_tpu.obs import session as ref_session
from annotatedvdb_tpu.obs.trace import Tracer as RefTracer
from annotatedvdb_tpu.utils.profiling import StageTimer as RefTimer

from annotatedvdb_tpu_torch import obs as port_obs
from annotatedvdb_tpu_torch.obs import metrics as port_metrics
from annotatedvdb_tpu_torch.obs import session as port_session
from annotatedvdb_tpu_torch.obs.trace import Tracer
from annotatedvdb_tpu_torch.utils import profiling
from annotatedvdb_tpu_torch.utils.profiling import StageTimer


def check_trace_events(evs):
    """The reference's well-formedness contract (``tests/test_obs.py``):
    sorted ts, per-(pid, tid) matched B/E pairs, named thread tracks."""
    ts = [e["ts"] for e in evs]
    assert ts == sorted(ts), "trace events not sorted by ts"
    stacks = collections.defaultdict(list)
    for e in evs:
        key = (e["pid"], e["tid"])
        if e["ph"] == "B":
            stacks[key].append(e["name"])
        elif e["ph"] == "E":
            assert stacks[key], f"E without B on {key}: {e['name']}"
            assert stacks[key].pop() == e["name"], "interleaved B/E pair"
    assert all(not s for s in stacks.values()), "unclosed B span"
    named = {e["tid"] for e in evs
             if e["ph"] == "M" and e["name"] == "thread_name"}
    assert {e["tid"] for e in evs if e["ph"] != "M"} <= named


def check_obs_outputs(flag, path, loader, store_dir) -> dict:
    """What one CLI telemetry flag left behind, and the store's one run
    record (returned): ``--metricsOut`` a textfile whose load counters are
    the record's and its JSON snapshot, ``--traceOut`` a well-formed trace
    of stage spans (the process track alone for ``export``, which attaches
    no loader, as in the reference), ``--profile`` a ``torch.profiler``
    Chrome trace holding CPU operators."""
    with open(os.path.join(store_dir, "ledger.jsonl")) as f:
        recs = [json.loads(line) for line in f if line.strip()]
    runs = [r for r in recs if r.get("type") == "run"]
    assert len(runs) == 1 and runs[0]["status"] == "completed", runs
    if flag == "--metricsOut":
        with open(path) as f:
            text = f.read()
        ints = {k: v for k, v in runs[0]["counters"].items()
                if type(v) is int and k != "alg_id"}
        assert ints
        for key, v in ints.items():
            assert f'avdb_load_{key}_total{{loader="{loader}"}} {v}\n' \
                in text, (key, v)
        with open(path + ".json") as f:
            assert f"avdb_load_{next(iter(ints))}_total" in json.load(f)
    elif flag == "--traceOut":
        with open(path) as f:
            evs = json.load(f)["traceEvents"]
        check_trace_events(evs)
        if loader == "export":
            assert [(e["name"], e["args"]) for e in evs] == [
                ("process_name", {"name": "export"})]
        else:
            assert [e for e in evs if e["ph"] == "B"]
    else:
        assert flag == "--profile", flag
        paths = glob.glob(os.path.join(path, "*.pt.trace.json"))
        assert len(paths) == 1, paths
        with open(paths[0]) as f:
            evs = json.load(f)["traceEvents"]
        assert [e for e in evs if e.get("cat") == "cpu_op"]
    return runs[0]


def masked(evs, keys=("ts", "pid", "tid")):
    return [{k: v for k, v in e.items() if k not in keys} for e in evs]


class FakeNs:
    """A ``perf_counter_ns`` that advances ``step`` ns a call (0 = a
    frozen clock: every event at one timestamp)."""

    def __init__(self, step):
        self.t, self.step = 10_000_000, step

    def __call__(self):
        self.t += self.step
        return self.t


def _emit(tracer):
    """One emission sequence: nested spans, nested zero-width spans, an
    instant, a counter, a second thread, and a renamed thread on the same
    ident (a fresh track, as when a finished thread's ident is reused)."""
    with tracer.span("outer", items=3):
        with tracer.span("inner"):
            with tracer.span("zero"):
                pass
        tracer.instant("mark", chunk=1)
    tracer.counter("queue_depth", ingest=2, dispatch=0)

    def worker():
        with tracer.span("worker-stage", items=7):
            pass
        me = threading.current_thread()
        me.name = "avdb-renamed"
        tracer.begin("after-rename")
        tracer.end("after-rename", rows=5)

    t = threading.Thread(target=worker, name="avdb-ingest")
    t.start()
    t.join()
    tracer.begin("tail")
    tracer.end("tail")


@pytest.mark.parametrize("step", [0, 1000], ids=["frozen", "ticking"])
def test_tracer_events_match_reference(monkeypatch, tmp_path, step):
    out = {}
    for tag, cls in (("ref", RefTracer), ("port", Tracer)):
        monkeypatch.setattr(time, "perf_counter_ns", FakeNs(step))
        tracer = cls(process_name="avdb-load")
        _emit(tracer)
        evs = tracer.events()
        check_trace_events(evs)
        path = tmp_path / f"{tag}.json"
        tracer.save(str(path))
        doc = json.loads(path.read_text())
        assert doc == {"traceEvents": json.loads(json.dumps(evs)),
                       "displayTimeUnit": "ms"}
        assert not [q for q in tmp_path.iterdir() if ".tmp" in q.name]
        out[tag] = evs
    # the clocks are pinned, so only the process id may differ
    assert masked(out["port"], ("pid",)) == masked(out["ref"], ("pid",))
    assert masked(out["port"]) == masked(out["ref"])
    tracks = [e["args"]["name"] for e in out["port"]
              if e["ph"] == "M" and e["name"] == "thread_name"]
    assert tracks == ["MainThread", "avdb-ingest", "avdb-renamed"]


def test_stage_timer_mirror_and_accounting_match_reference(monkeypatch):
    out = {}
    for tag, timer_cls, tracer_cls in (("ref", RefTimer, RefTracer),
                                       ("port", StageTimer, Tracer)):
        monkeypatch.setattr(time, "perf_counter_ns", FakeNs(500))
        clock = iter(x * 0.125 for x in range(1000))
        timer = timer_cls(clock=lambda: next(clock))
        assert timer.overlap() is None
        assert timer.wall_dict() == {"wall_seconds": 0.0, "busy_seconds": 0.0}
        timer.tracer = tracer_cls()
        with timer.wall():
            with timer.stage("ingest", items=100):
                with timer.stage("annotate", items=100):
                    pass
            with timer.stage("persist"):
                pass
            with pytest.raises(ValueError):
                with timer.stage("egress", items=3):
                    raise ValueError("stage bodies may raise")
        with timer.wall():
            with timer.stage("ingest", items=28):
                pass
        evs = timer.tracer.events()
        check_trace_events(evs)
        out[tag] = {
            "as_dict": timer.as_dict(), "wall_dict": timer.wall_dict(),
            "overlap": timer.overlap(), "total": timer.total(),
            "wall": timer.wall_seconds, "events": masked(evs, ("pid",)),
        }
    assert out["port"] == out["ref"]
    assert [e["name"] for e in out["port"]["events"]
            if e["ph"] == "B"].count("load") == 2
    assert out["port"]["as_dict"]["ingest"] == {"seconds": 0.5, "items": 128}


def test_stage_timer_without_tracer_emits_nothing():
    timer = StageTimer()
    with timer.wall(), timer.stage("apply", items=4):
        pass
    assert timer.tracer is None
    assert timer.as_dict()["apply"]["items"] == 4
    assert timer.overlap() > 0


RUN_CASES = {
    "completed": dict(
        counters={"line": 10, "variant": 12, "skipped": True, "alg_id": 3},
        wall_seconds=2.5, stages={"ingest": {"seconds": 1.0, "items": 10}},
        queue_stalls={"ingest": {"producer_block_s": 0.1, "max_depth": 2}}),
    "update": dict(counters={"update": 400, "not_found": 2},
                   wall_seconds=0.123456),
    "aborted": dict(counters={"variant": 5}, wall_seconds=0.5,
                    error=RuntimeError("failAt variant reached: rs7" * 40)),
    "no-wall": dict(counters={"variant": 5}, wall_seconds=0.0),
    "empty": dict(counters=None, wall_seconds=1.0, stages={},
                  queue_stalls={}, error=KeyboardInterrupt()),
}
RUN_PARAMS = {"file": "in.vcf", "store": "vdb", "commit": True,
              "batch_size": 128, "datasource": None, "chromosomes": ["1", "X"]}


@pytest.mark.parametrize("case", sorted(RUN_CASES))
def test_run_record_and_config_hash_match_reference(case):
    kw = RUN_CASES[case]
    ref = ref_session.run_record("load-vcf", "in.vcf", RUN_PARAMS, **kw)
    port = port_session.run_record("load-vcf", "in.vcf", RUN_PARAMS, **kw)
    assert json.dumps(port, sort_keys=True) == json.dumps(ref, sort_keys=True)
    assert port["config_hash"] == ref_session.config_hash(RUN_PARAMS)
    assert port_session.config_hash(dict(RUN_PARAMS, commit=False)) \
        != port["config_hash"]


def _fill(mod, session_mod, registry):
    """The same calls on one package's registry: every metric kind, a
    LoadObserver, and the session's export helpers."""
    registry.counter("avdb_parity_calls_total", "a counter", {"k": "v"}).inc(3)
    registry.gauge("avdb_parity_level", "a gauge").set(0.25)
    h = registry.histogram("avdb_parity_sizes", (1.0, 2.0, 4.0), "a histogram",
                           {"loader": "t"})
    for v in (0.5, 1.0, 3.0, 9.0):
        h.observe(v)
    obs = mod.LoadObserver(registry, "load-vcf")
    for rows, s in ((65_536, 0.02), (1000, None), (0, 0.5), (2 ** 21, 40.0)):
        obs.chunk(rows, seconds=s)
    obs.stage_seconds("annotate", 1.5)
    obs.stage_seconds("annotate", 0.25)
    obs.stage_seconds("persist", 0.0)
    obs.device_idle(1.7)
    session_mod.export_counters(registry, {"variant": 10, "alg_id": 4,
                                           "line": 12, "note": "x"}, "load-vcf")
    session_mod.export_stages(registry, {"ingest": {"seconds": 1.25,
                                                    "items": 9},
                                         "persist": {"seconds": 0.5}},
                              3.0, "load-vcf")
    session_mod.export_queue_stalls(registry, {"ingest": {
        "producer_block_s": 0.5, "consumer_wait_s": 0.25, "max_depth": 4}},
        "load-vcf")

    class Shard:
        def __init__(self, n):
            self.n = n

    class Store:
        shards = {23: Shard(5), 1: Shard(7), 22: Shard(2)}

    session_mod.export_store_stats(registry, Store())


def test_registry_writers_and_load_observer_match_reference(tmp_path):
    files = {}
    for tag, mod, session_mod in (("ref", ref_metrics, ref_session),
                                  ("port", port_metrics, port_session)):
        registry = mod.MetricsRegistry()
        _fill(mod, session_mod, registry)
        path = tmp_path / tag / "sub" / "m.prom"
        registry.write_textfile(str(path))
        registry.write_json(str(path) + ".json")
        assert sorted(p.name for p in path.parent.iterdir()) == [
            "m.prom", "m.prom.json"]
        files[tag] = (path.read_bytes(), (tmp_path / tag / "sub"
                                          / "m.prom.json").read_bytes())
    assert files["port"] == files["ref"]
    text = files["port"][0].decode()
    assert "# TYPE avdb_chunk_rows histogram" in text
    assert 'avdb_load_device_idle_fraction{loader="load-vcf"} 1' in text
    assert 'avdb_store_rows{chrom="X"} 5' in text
    assert port_metrics.CHUNK_ROW_EDGES == ref_metrics.CHUNK_ROW_EDGES
    assert port_metrics.CHUNK_SECONDS_EDGES == ref_metrics.CHUNK_SECONDS_EDGES


def test_obs_package_exports_the_reference_names():
    from annotatedvdb_tpu import obs as ref_obs

    assert sorted(port_obs.__all__) == sorted(ref_obs.__all__)
    for name in port_obs.__all__:
        assert getattr(port_obs, name) is not None


class _Loader:
    """The attributes ``ObsSession`` reads off a loader."""

    obs_name = "load-vcf"

    def __init__(self, timer_cls):
        self.counters = {"line": 3, "variant": 4}
        self.queue_stalls = {"ingest": {"producer_block_s": 0.0,
                                        "consumer_wait_s": 0.0,
                                        "max_depth": 1}}
        clock = iter(x * 0.5 for x in range(100))
        self.timer = timer_cls(clock=lambda: next(clock))


@pytest.mark.parametrize("end", ["finish", "abort"])
def test_session_lifecycle_matches_reference(tmp_path, monkeypatch, end):
    """attach / finish-or-abort through both sessions: the tracer mirror
    reaches the loader's timer, the exports land, the ledger gets one run
    record, and a second close is a no-op."""
    got = {}
    for tag, session_mod, timer_cls in (("ref", ref_session, RefTimer),
                                        ("port", port_session, StageTimer)):
        monkeypatch.setattr(time, "perf_counter_ns", FakeNs(100))
        d = tmp_path / tag
        session = session_mod.ObsSession(
            "load-vcf", "in.vcf", {"file": "in.vcf"},
            metrics_out=str(d / "m.prom"), trace_out=str(d / "t.json"))
        loader = session.attach(_Loader(timer_cls))
        assert loader.timer.tracer is session.tracer
        with loader.timer.wall(), loader.timer.stage("ingest", items=3):
            loader.obs.chunk(3, seconds=0.5)
        records = []

        class Ledger:
            def run(self, rec):
                records.append(rec)

        if end == "finish":
            session.finish(Ledger(), {"line": 3, "variant": 4, "alg_id": 1})
        else:
            session.abort(Ledger(), ValueError("bad row"))
        session.finish(Ledger(), {})
        assert len(records) == 1
        got[tag] = (records[0], (d / "m.prom").read_text(),
                    masked(json.loads((d / "t.json").read_text())
                           ["traceEvents"], ("pid",)))
    assert got["port"] == got["ref"]
    assert got["port"][0]["status"] == (
        "completed" if end == "finish" else "aborted")


def test_session_export_failure_never_masks_the_load(tmp_path, capsys):
    """A metrics target that cannot be written and a ledger that raises
    print ``obs: ... failed`` and return, as in the reference."""
    blocker = tmp_path / "file"
    blocker.write_text("x")
    session = port_session.ObsSession(
        "export", None, {}, metrics_out=str(blocker / "m.prom"))

    class Ledger:
        def run(self, rec):
            raise OSError("disk full")

    session.finish(Ledger(), {"rows": 1})
    err = capsys.readouterr().err
    assert "obs: metric/trace export failed" in err
    assert "obs: run-ledger append failed (disk full)" in err


def _torch_work(n=3):
    for _ in range(n):
        torch.ones(8).mul_(2).sum()


def test_device_trace_writes_cpu_ops_of_every_thread(tmp_path):
    trace_dir = tmp_path / "prof"
    with profiling.device_trace(str(trace_dir), torch.device("cpu")):
        t = threading.Thread(target=_torch_work, name="avdb-vcf-dispatch")
        t.start()
        t.join()
        torch.zeros(4)
    paths = glob.glob(str(trace_dir / "*.pt.trace.json"))
    assert len(paths) == 1
    evs = json.load(open(paths[0]))["traceEvents"]
    ops = [e for e in evs if e.get("cat") == "cpu_op"]
    assert {"aten::mul_", "aten::zeros"} <= {e["name"] for e in ops}
    # the side thread's operators are there, on a thread of their own
    assert len({e["tid"] for e in ops}) >= 2
    assert not [e for e in evs if e.get("cat") == "kernel"]


def test_device_trace_without_a_directory_does_nothing(tmp_path):
    with profiling.device_trace(None, torch.device("cpu")):
        _torch_work(1)
    with profiling.device_trace("", "cuda:0"):
        pass
    assert not list(tmp_path.iterdir())


def test_device_trace_refuses_an_unrecordable_cuda_capture(tmp_path,
                                                           monkeypatch):
    """No fallback: asked for CUDA activity the profiler cannot record,
    the capture raises before the body runs instead of leaving a CPU-only
    trace."""
    from torch.profiler import ProfilerActivity

    monkeypatch.setattr(torch.profiler, "supported_activities",
                        lambda: {ProfilerActivity.CPU})
    ran = []
    with pytest.raises(RuntimeError, match="cannot record CUDA activity"):
        with profiling.device_trace(str(tmp_path / "p"), "cuda:0"):
            ran.append(1)
    assert not ran and not (tmp_path / "p").exists()
