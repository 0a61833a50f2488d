"""The serving and health-plane fault points and the chaos routes, crossed
between the two packages: the reference's serve cases
(``tests/test_fault_matrix.py``: ``serve.batch``, ``serve.regions``,
``serve.stats``, ``snapshot.swap``, ``serve.accept``,
``engine.device_probe``, ``obs.flight``, ``obs.tick``, ``serve.worker``)
run against each package on byte-equal copies of one store, and
``POST /_chaos`` and ``GET /debug/trace`` answer as the reference's under
``AVDB_SERVE_CHAOS=1`` and with its unknown-route 404 without it.  The
span ring behind ``/debug/trace`` runs the reference's own cases
(``tests/test_reqtrace.py``: small rings that wrap, concurrent writers,
sampling, histograms, Chrome events) in both packages.
"""

import http.client
import json
import os
import re
import shutil
import threading
import time

import numpy as np
import pytest

from annotatedvdb_tpu_torch.store import VariantStore
from annotatedvdb_tpu_torch.store.variant_store import Segment
from test_fault_matrix import _tiny_store
from test_torch_faults import PORT, REF, armed, same

PKGS = (REF, PORT)


@pytest.fixture(autouse=True)
def _disarm():
    yield
    for pkg in PKGS:
        pkg.faults.reset("")


@pytest.fixture(scope="module")
def tiny_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("tiny") / "store")
    _tiny_store().save(d)
    return d


def _quiet(_m):
    pass


def _engine(pkg, store_dir, **kw):
    snaps = pkg.mod("serve.snapshot")
    store = pkg.mod("store").VariantStore.load(store_dir, readonly=True)
    return pkg.mod("serve.engine").QueryEngine(
        snaps.StaticSnapshots(store), region_cache_size=0, **kw, **pkg.kw)


# ---------------------------------------------------------------------------
# serve.batch / serve.regions / serve.stats / snapshot.swap


def test_serve_batch_fault_fails_only_that_batch_alike(tiny_dir):
    got = {}
    for pkg in PKGS:
        batcher = pkg.mod("serve.batcher").QueryBatcher(
            _engine(pkg, tiny_dir), max_batch=4, max_wait_s=0.001)
        try:
            first = armed(pkg, "serve.batch:1:raise", batcher.submit,
                          "3:10:A:C")
            second = batcher.submit("3:10:A:C")
            got[pkg] = (first, second, batcher.drain_stats()["batches"])
        finally:
            batcher.close()
    want = same(got)
    assert want[0] == "raised InjectedFault" and want[2] == 1


@pytest.mark.parametrize("fault", ["serve.regions:1:raise",
                                   "serve.regions:1:eio"])
def test_serve_regions_fault_fails_only_that_batch_alike(tiny_dir, fault):
    specs = ["3:1-100", "3:5-25"]
    got = {}
    for pkg in PKGS:
        engine = _engine(pkg, tiny_dir)
        first = armed(pkg, fault, engine.regions_serve, specs)
        pages = [p.assemble() for p in engine.regions_serve(specs).pages]
        got[pkg] = (first, pages, [engine.region(s) for s in specs])
    want = same(got)
    assert want[0].startswith("raised") and want[1] == want[2]


@pytest.mark.parametrize("fault", ["serve.stats:1:raise", "serve.stats:1:eio"])
def test_serve_stats_fault_fails_only_that_panel_alike(tiny_dir, fault):
    specs = ["3:1-100", "3:5-25"]
    got = {}
    for pkg in PKGS:
        engine = _engine(pkg, tiny_dir)
        before = engine.stats_serve(specs).assemble()
        first = armed(pkg, fault, engine.stats_serve, specs)
        got[pkg] = (first, before, engine.stats_serve(specs).assemble())
    want = same(got)
    assert want[0].startswith("raised") and want[1] == want[2]


def test_snapshot_swap_fault_keeps_the_old_generation_alike(tmp_path,
                                                            tiny_dir):
    got = {}
    for pkg in PKGS:
        d = str(tmp_path / str(pkg))
        shutil.copytree(tiny_dir, d)
        manager = pkg.mod("serve.snapshot").SnapshotManager(d, log=_quiet)
        rows = manager.current().store.n
        # a loader commit lands a second generation on disk (written by
        # the port; both packages read the same bytes)
        store = VariantStore.load(d)
        store.shard(3).append_segment(Segment.build(
            {"pos": np.asarray([40], np.int32),
             "h": np.asarray([11], np.uint32),
             "ref_len": np.full(1, 1, np.int32),
             "alt_len": np.full(1, 1, np.int32)},
            np.full((1, 8), 65, np.uint8), np.full((1, 8), 71, np.uint8)))
        store.save(d)
        first = armed(pkg, "snapshot.swap:1:raise", manager.refresh)
        pinned = (manager.current().generation, manager.current().store.n)
        second = manager.refresh()
        got[pkg] = (rows, first, pinned, second,
                    (manager.current().generation, manager.current().store.n))
    want = same(got)
    assert want[1] == "raised InjectedFault" and want[2] == (1, want[0])
    assert want[3] is True and want[4] == (2, want[0] + 1)


# ---------------------------------------------------------------------------
# engine.device_probe: the breaker absorbs it on the host path


def test_engine_device_probe_eio_trips_and_recloses_the_breaker_alike(
        tiny_dir):
    got = {}
    for pkg in PKGS:
        clock = {"t": 0.0}
        breaker = pkg.mod("serve.resilience").DeviceBreaker(
            cooldown_s=5.0, clock=lambda c=clock: c["t"])
        engine = _engine(pkg, tiny_dir, breaker=breaker)
        want = engine.lookup("3:10:A:C")
        f = pkg.faults
        f.reset("engine.device_probe:prob:1.0:eio")
        answers = [engine.lookup("3:10:A:C")
                   for _ in range(breaker.failure_threshold)]
        opened = breaker.stats()["groups"]["3"]["state"]
        fired = f.fired()["engine.device_probe"]
        answers.append(engine.lookup("3:10:A:C"))  # open: host only
        fired_open = f.fired()["engine.device_probe"]
        f.reset("")
        clock["t"] = 10.0
        answers.append(engine.lookup("3:10:A:C"))  # half-open trial
        got[pkg] = (want, answers == [want] * len(answers), opened, fired,
                    fired_open, breaker.stats())
    result = same(got)
    assert result[1:5] == (True, "open", 3, 3)
    assert result[5] == {"open_groups": [],
                         "groups": {"3": {"state": "closed", "failures": 0}}}


# ---------------------------------------------------------------------------
# HTTP front ends: serve.accept, /_chaos, /debug/trace


class _Server:
    """One front end of ``pkg`` over ``store_dir``, serving on a thread."""

    def __init__(self, pkg, store_dir, frontend):
        store = pkg.mod("store").VariantStore.load(store_dir, readonly=True)
        manager = pkg.mod("serve.snapshot").StaticSnapshots(store)
        if frontend == "aio":
            self.srv = pkg.mod("serve.aio").build_aio_server(
                manager=manager, port=0, **pkg.kw)
            self.srv.start_background()
        else:
            self.srv = pkg.mod("serve.http").build_server(
                manager=manager, port=0, **pkg.kw)
            threading.Thread(target=self.srv.serve_forever,
                             daemon=True).start()
        self.frontend = frontend
        self.port = self.srv.server_address[1]
        self.ctx = self.srv.ctx

    def request(self, method, path, body=None, headers=None):
        conn = http.client.HTTPConnection("127.0.0.1", self.port, timeout=10)
        try:
            conn.request(method, path,
                         body=None if body is None else (
                             body if isinstance(body, bytes)
                             else json.dumps(body).encode()),
                         headers=headers or {})
            resp = conn.getresponse()
            return resp.status, resp.read()
        finally:
            conn.close()

    def close(self):
        if self.frontend == "aio":
            self.srv.shutdown()
        else:
            self.srv.shutdown()
            self.srv.server_close()
        self.ctx.batcher.close()


#: how a client sees a connection the server dropped unanswered: a reset
#: or an empty response, whichever the TCP race gives (the reference's
#: case accepts both)
DROPPED = ("raised RemoteDisconnected:None", "raised ConnectionResetError:104",
           "raised BrokenPipeError:32")


def test_serve_accept_raise_costs_one_connection_alike(tiny_dir):
    got = {}
    for pkg in PKGS:
        srv = _Server(pkg, tiny_dir, "aio")
        try:
            first = srv.request("GET", "/variant/3:10:A:C")
            second = armed(pkg, "serve.accept:1:raise", srv.request, "GET",
                           "/variant/3:10:A:C")
            assert second in DROPPED, second
            got[pkg] = (first, srv.request("GET", "/variant/3:10:A:C"))
        finally:
            srv.close()
    want = same(got)
    assert want[0][0] == 200 and want[1] == want[0]


@pytest.mark.parametrize("frontend", ["aio", "threaded"])
def test_serve_batch_fault_answers_one_500_over_http_alike(tiny_dir,
                                                           frontend):
    """``serve.batch`` through each front end's batcher (``aio``'s loop
    batcher, the threaded server's drain thread): the faulted point read
    answers the same 500 body, the next the same 200."""
    got = {}
    for pkg in PKGS:
        srv = _Server(pkg, tiny_dir, frontend)
        try:
            pkg.faults.reset("serve.batch:1:raise")
            first = srv.request("GET", "/variant/3:10:A:C")
            pkg.faults.reset("")
            got[pkg] = (first, srv.request("GET", "/variant/3:10:A:C"))
        finally:
            srv.close()
    want = same(got)
    assert want[0][0] == 500 and want[1][0] == 200


#: (body, label) for ``POST /_chaos``: arm, bad spec, bad ttl, bad body,
#: a death action at a worker point, disarm
CHAOS_BODIES = [
    ({"spec": "serve.batch:1:raise"}, "arm"),
    ({"spec": "serve.batch:1:explode"}, "bad-action"),
    ({"spec": "nope:1"}, "bad-point"),
    ({"spec": "serve.batch:1:raise", "ttl_s": "soon"}, "bad-ttl"),
    ({"spec": "ingest.chunk:1:kill"}, "death-not-worker"),
    (["serve.batch:1:raise"], "not-an-object"),
    (b"{not json", "not-json"),
    ({"spec": "serve.accept:3:kill", "ttl_s": 30}, "worker-death-ttl"),
    ({"spec": ""}, "disarm"),
]


def _pid_masked(body: bytes) -> bytes:
    return re.sub(rb'"pid": \d+', b'"pid": 0', body)


def test_chaos_route_answers_as_the_reference(tiny_dir, monkeypatch):
    """``POST /_chaos`` on ``aio``: status and body of each case equal the
    reference's (``pid`` masked), and each leaves the same arming."""
    monkeypatch.setenv("AVDB_SERVE_CHAOS", "1")
    got = {}
    for pkg in PKGS:
        srv = _Server(pkg, tiny_dir, "aio")
        try:
            out = []
            for body, label in CHAOS_BODIES:
                status, text = srv.request("POST", "/_chaos", body)
                out.append((label, status, _pid_masked(text),
                            pkg.faults._ARMED))
            got[pkg] = out
        finally:
            srv.close()
    want = same(got)
    assert [s for _l, s, _t, _a in want] == [200, 400, 400, 400, 400, 400,
                                             400, 200, 200]
    assert want[0][3] == ("serve.batch", 1, None, "raise", 0)
    assert want[-1][3] is None


def test_chaos_ttl_disarms_only_its_own_arming(tiny_dir, monkeypatch):
    monkeypatch.setenv("AVDB_SERVE_CHAOS", "1")
    got = {}
    for pkg in PKGS:
        srv = _Server(pkg, tiny_dir, "aio")
        try:
            srv.request("POST", "/_chaos", {"spec": "serve.batch:prob:0.5",
                                            "ttl_s": 0.2})
            time.sleep(0.5)
            expired = pkg.faults.armed_point()
            srv.request("POST", "/_chaos", {"spec": "serve.batch:prob:0.5",
                                            "ttl_s": 0.3})
            srv.request("POST", "/_chaos", {"spec": "serve.stats:1:raise"})
            time.sleep(0.6)  # the first ttl lapsed: a newer arm owns it
            got[pkg] = (expired, pkg.faults.armed_point())
        finally:
            srv.close()
    assert same(got) == (None, "serve.stats")


@pytest.mark.parametrize("frontend", ["aio", "threaded"])
def test_chaos_routes_are_the_unknown_route_without_the_gate(
        tiny_dir, monkeypatch, frontend):
    monkeypatch.delenv("AVDB_SERVE_CHAOS", raising=False)
    got = {}
    for pkg in PKGS:
        srv = _Server(pkg, tiny_dir, frontend)
        try:
            got[pkg] = [srv.request("POST", "/_chaos",
                                    {"spec": "serve.batch:1:raise"}),
                        srv.request("GET", "/debug/trace"),
                        pkg.faults.armed_point()]
        finally:
            srv.close()
    want = same(got)
    assert want[1] == (404, b'{"error": "no such route: /debug/trace"}')
    assert want[0][0] in (404, 501) and want[2] is None


def _trace_shape(body: bytes):
    """The dump with times masked: event names, phases, tids, categories
    and args, in order."""
    doc = json.loads(body)
    assert doc["displayTimeUnit"] == "ms"
    return [(e["ph"], e["name"], e.get("cat"), e["tid"], e.get("args"))
            for e in doc["traceEvents"]]


@pytest.mark.parametrize("frontend", ["aio", "threaded"])
def test_debug_trace_matches_the_reference(tiny_dir, monkeypatch, frontend):
    """The same request sequence (with client trace ids) on both
    packages' servers: the same Chrome trace events, times masked."""
    monkeypatch.setenv("AVDB_SERVE_CHAOS", "1")
    seq = [("GET", "/variant/3:10:A:C", None),
           ("GET", "/variant/3:11:A:C", None),
           ("POST", "/variants", {"ids": ["3:20:A:C", "3:30:A:C"]}),
           ("GET", "/region/3:1-100?limit=2", None),
           ("POST", "/regions", {"regions": ["3:1-100", "3:5-25"]}),
           ("POST", "/stats/region", {"regions": ["3:1-100"]})]
    got = {}
    for pkg in PKGS:
        srv = _Server(pkg, tiny_dir, frontend)
        try:
            answers = []
            for k, (method, path, body) in enumerate(seq):
                status, _text = srv.request(method, path, body,
                                            {"X-Request-Id": f"req-{k}"})
                answers.append(status)
            status, dump = srv.request("GET", "/debug/trace")
            events = json.loads(dump)["traceEvents"]
            assert all(e["pid"] == os.getpid() for e in events)
            got[pkg] = (answers, status, _trace_shape(dump))
        finally:
            srv.close()
    want = same(got)
    assert want[0] == [200, 404, 200, 200, 200, 200] and want[1] == 200
    ids = {e[4]["trace_id"] for e in want[2] if e[2] == "request"}
    assert ids == {f"req-{k}" for k in range(len(seq))}


# ---------------------------------------------------------------------------
# the span ring behind /debug/trace (the cases of tests/test_reqtrace.py)


def _recorder(pkg, **kw):
    return pkg.mod("obs.reqtrace").TraceRecorder(**kw)


def _timeless(records):
    """Ring records less their start and total times."""
    return [(r[0], r[1], r[2], r[5], r[6]) for r in records]


@pytest.mark.parametrize("slots,n", [(4, 10), (4, 4), (4, 3), (64, 200)])
def test_ring_records_stages_and_wraps_alike(slots, n):
    """A ring of ``slots`` after ``n`` requests: once it wraps only the
    newest ``slots`` records survive, oldest first, in both packages."""
    got = {}
    for pkg in PKGS:
        rec = _recorder(pkg, slots=slots, sample=1.0)
        for i in range(n):
            t = rec.begin(f"id{i}", "point")
            t.add("queue", 0.001 * i)
            t.add("device", 0.002)
            rec.finish(t, 200)
        records = rec.records()
        assert all(r[4] >= 0 for r in records)
        got[pkg] = (rec.slots, _timeless(records))
    want = same(got)
    assert want[0] == slots
    assert [r[0] for r in want[1]] == [f"id{i}" for i in range(max(0, n - slots), n)]
    assert all(r[1:3] == ("point", 200) and dict(r[3])["device"] == 0.002
               for r in want[1])


def test_ring_default_slots_equal_the_reference():
    assert _recorder(PORT).slots == _recorder(REF).slots == 2048
    assert PORT.mod("obs.reqtrace").TraceRecorder.SLOTS == 2048


def test_ring_concurrent_writers_never_tear():
    """Eight writers on a 64-slot ring, no lock: every surviving slot is
    one whole record, never a hybrid of two."""
    rec = _recorder(PORT, slots=64, sample=1.0)
    errors: list = []

    def writer(wid: int):
        try:
            for i in range(200):
                t = rec.begin(f"w{wid}-{i}", "bulk")
                t.add("device", 0.001)
                rec.finish(t, 200)
        except Exception as err:  # pragma: no cover
            errors.append(err)

    threads = [threading.Thread(target=writer, args=(w,)) for w in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert not errors
    records = rec.records()
    assert len(records) == 64
    for r in records:
        assert len(r) == 7 and r[1] == "bulk" and r[2] == 200
        assert dict(r[5]) == {"device": 0.001}


def test_ring_sampling_alike():
    """``sample=0`` disarms the ring; a fraction samples the same requests
    in both packages (one seeded coin)."""
    got = {}
    for pkg in PKGS:
        off = _recorder(pkg, sample=0.0)
        assert off.begin("x", "point") is None
        off.finish(None, 200)
        frac = _recorder(pkg, sample=0.5)
        got[pkg] = (off.records(), [i for i in range(400)
                                    if frac.begin(str(i), "point") is not None])
    want = same(got)
    assert want[0] == [] and 100 < len(want[1]) < 300


def test_ring_stage_histograms_and_slow_log_alike():
    got = {}
    for pkg in PKGS:
        reg = pkg.mod("obs.metrics").MetricsRegistry()
        lines: list = []
        rec = _recorder(pkg, registry=reg, slow_ms=5.0, sample=1.0,
                        log=lines.append)
        rec.finish(rec.begin("fast", "point"), 200)
        t = rec.begin("slowone", "region")
        t.add("device", 0.02)
        t.t0_ns -= int(20e6)  # backdated 20 ms: over the 5 ms threshold
        rec.finish(t, 200)
        slow = [re.sub(r"total=[\d.]+ms", "total=<ms>", ln)
                for ln in lines if "slow request" in ln]
        text = reg.render_prometheus()
        got[pkg] = (slow, [ln for ln in text.splitlines()
                           if ln.startswith(("avdb_stage_seconds_count",
                                             "avdb_trace_slow_requests_total"))])
    want = same(got)
    assert want[0] == ["slow request trace=slowone kind=region status=200 "
                       "total=<ms> device=20.00ms"]
    assert 'avdb_stage_seconds_count{stage="device"} 1' in want[1]
    assert 'avdb_stage_seconds_count{stage="total"} 2' in want[1]
    assert "avdb_trace_slow_requests_total 1" in want[1]


def test_ring_span_cap_and_active_trace_alike():
    got = {}
    for pkg in PKGS:
        mod = pkg.mod("obs.reqtrace")
        rec = _recorder(pkg, sample=1.0)
        capped = rec.begin("panel", "regions")
        for i in range(200):
            capped.span(f"regions.chr{i}", 0.001)
        t = rec.begin("x", "regions")
        mod.span_active("orphan", 1.0)  # no active trace: a no-op
        with mod.activate(t):
            mod.span_active("regions.chr8", 0.003)
        mod.span_active("late", 1.0)
        with mod.activate(None):
            mod.span_active("nope", 1.0)
        got[pkg] = (len(capped.spans), capped.MAX_SPANS, list(t.spans))
    want = same(got)
    assert want[0] == want[1] and want[2] == [("regions.chr8", 0.003)]


def test_ring_chrome_events_alike():
    """The ring as Chrome events from a shared time base: the same tracks,
    names, categories and args, each stage's duration in microseconds."""
    got = {}
    for pkg in PKGS:
        rec = _recorder(pkg, sample=1.0)
        t = rec.begin("abc", "point")
        t.add("queue", 0.001)
        t.add("device", 0.002)
        t.span("regions.chr8", 0.0005)
        rec.finish(t, 200)
        rec.background("memtable.flush", 0.25, {"rows": 3})
        events = json.loads(json.dumps(rec.chrome_events(base_ns=rec.t0_ns)))
        assert all(e["pid"] == os.getpid() for e in events)
        got[pkg] = [(e["ph"], e["name"], e.get("cat"), e["tid"], e.get("args"),
                     e.get("dur") if e.get("cat") in ("stage", "span") else None)
                    for e in events]
    want = same(got)
    assert ("X", "queue", "stage", 1, {"trace_id": "abc"},
            pytest.approx(1000.0)) in want
    assert any(e[1] == "memtable.flush" and e[3] == 2 for e in want)


# ---------------------------------------------------------------------------
# obs.flight / obs.tick


def test_obs_flight_ring_write_failure_absorbed_alike(tmp_path, tiny_dir):
    got = {}
    for pkg in PKGS:
        fmod = pkg.mod("obs.flight")
        ring = str(tmp_path / f"{pkg}.ring")
        flight = fmod.FlightRecorder(ring, slots=16, log=_quiet)
        httpd = pkg.mod("serve.http").build_server(
            store_dir=tiny_dir, port=0, flight=flight, **pkg.kw)
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        try:
            conn = http.client.HTTPConnection(
                "127.0.0.1", httpd.server_address[1], timeout=10)

            def get(path, conn=conn):
                conn.request("GET", path)
                resp = conn.getresponse()
                return resp.status, resp.read()

            first = armed(pkg, "obs.flight:1:raise", get, "/variant/3:10:A:C")
            second = get("/variant/3:20:A:C")
            conn.close()
            flight.flush()
            event = armed(pkg, "obs.flight:1:eio", flight.event, "breaker",
                          "x")
            reqs = [e["trace"] for e in fmod.decode_ring(ring)["events"]
                    if e["type"] == "request"]
            got[pkg] = (first[0], second[0], flight.errors, len(reqs), event)
        finally:
            httpd.shutdown()
            httpd.server_close()
            httpd.ctx.batcher.close()
            flight.close()
    want = same(got)
    assert want[:4] == (200, 200, 2, 1) and want[4] is None


def _supervisor(pkg, store_dir):
    return pkg.mod("serve.fleet").ServeFleet(store_dir, port=0, workers=1,
                                             log=_quiet)


def _close_supervisor(pkg, fleet):
    fleet._reserve.close()
    if fleet._sup_flight is not None:
        fleet._sup_flight.close()
    pkg.mod("obs.reqtrace").set_background_sink(None, None)
    shutil.rmtree(fleet._telemetry_dir, ignore_errors=True)
    fleet._hb_mm.close()
    os.unlink(fleet._hb_path)


def test_obs_harvest_failures_absorbed_by_the_supervisor_alike(tmp_path,
                                                               tiny_dir):
    """``obs.flight`` in the flight harvest and ``obs.tick`` in the
    history harvest: the supervisor logs and goes on; unarmed, the same
    harvests land."""
    got = {}
    for pkg in PKGS:
        d = str(tmp_path / str(pkg))
        shutil.copytree(tiny_dir, d)
        fmod, ts = pkg.mod("obs.flight"), pkg.mod("obs.timeseries")
        fr = fmod.FlightRecorder(fmod.ring_path(d, 0), slots=8)
        fr.request("abc", "point", 200, 0.001, [])
        fr.close()
        ring = ts.TimeSeriesRing(
            pkg.mod("obs.metrics").MetricsRegistry(), worker=0,
            path=ts.history_path(d, 0), tick_s=1.0, history_s=60.0)
        ring.sample()
        ring.persist(force=True)
        fleet = _supervisor(pkg, d)
        try:
            out = []
            for fault, harvest, listing in (
                    ("obs.flight:1:eio", fleet._harvest_flight,
                     fmod.list_blackboxes),
                    ("obs.tick:1:eio", fleet._harvest_history,
                     ts.list_history)):
                out.append(armed(pkg, fault, harvest, 0, "died rc=-9"))
                out.append(len(listing(d)["harvested"]))
                harvest(0, "died rc=-9")
                out.append(len(listing(d)["harvested"]))
            got[pkg] = out
        finally:
            _close_supervisor(pkg, fleet)
    assert same(got) == [None, 0, 1, None, 0, 1]


@pytest.mark.parametrize("fault", ["obs.tick:1:raise", "obs.tick:1:eio",
                                   "obs.tick:2:eio"])
def test_obs_tick_faults_cost_one_tick_alike(tmp_path, fault):
    """A failing snapshot (hit 1) or mirror write (hit 2) costs one tick:
    absorbed, counted, logged once; the next tick and persist catch up."""
    got = {}
    for pkg in PKGS:
        ts = pkg.mod("obs.timeseries")
        logs = []
        ring = ts.TimeSeriesRing(
            pkg.mod("obs.metrics").MetricsRegistry(), worker=0,
            path=str(tmp_path / f"{pkg}.ts.json"), tick_s=0.01,
            history_s=60.0, log=logs.append)
        ring.sample()
        ring.persist(force=True)
        ring._last_persist = -1e9  # the tick attempts its persist
        first = armed(pkg, fault, ring.tick)
        state = (ring.errors, len(ring.samples()),
                 len(ts.load_history(ring.path)["samples"]))
        ring.persist(force=True)
        got[pkg] = (first, state, len(ts.load_history(ring.path)["samples"]),
                    [m.split(":")[0] for m in logs])
    want = same(got)
    assert want[0] is False and want[1][0] == 1


# ---------------------------------------------------------------------------
# serve.worker: a killed fleet worker is respawned clean


def test_serve_worker_kill_respawns_clean_and_serves(tmp_path, tiny_dir):
    """``serve.worker:1:kill`` SIGKILLs each of the port fleet's first
    workers as it starts accepting; the supervisor respawns them with the
    fault stripped and the fleet then answers every request."""
    from test_torch_fleet import _Fleet

    env = dict(os.environ, AVDB_FAULT="serve.worker:1:kill")
    fleet = _Fleet(tiny_dir, str(tmp_path / "err.log"), workers=2, env=env)
    try:
        fleet.wait_log(r"worker \d: respawning with AVDB_FAULT cleared",
                       count=2)
        fleet.wait_workers(2)
        for _ in range(10):
            assert fleet.request("GET", "/variant/3:10:A:C")[0] == 200
        err = fleet.stderr()
        assert len(re.findall(r"worker \d: died rc=-9", err)) == 2, err
        assert fleet.stop() == 0
    finally:
        fleet.kill()
