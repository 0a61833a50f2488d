"""The health plane: the PyTorch port against the JAX package, on the CPU.

Bottom up, each case runs both packages on the same inputs, built from a
numpy seed, and compares what they return or write:

- the sample arithmetic (``bucket_quantile``, counter deltas and rates
  across a worker restart, histogram windows and window quantiles,
  ``fraction_above``, the window brackets, ``derive_series``);
- the SLO knobs, the declared SLO set, the state machine tick by tick and
  ``replay_history`` on seeded streams: an availability breach, a worker
  restart, a sustained replication-lag breach, a point-read latency
  breach and a dormant-then-armed load floor;
- the time-series ring's persisted mirror and its harvest, byte for
  byte (clocks injected; the harvest's wall clock patched to one value
  for both);
- ``/healthz``, ``/metrics``, ``/alerts``, ``/alerts?fleet=1``,
  ``/metrics/history`` (and ``?window=``, ``?fleet=1``) and
  ``/metrics?fleet=1`` from both packages' threaded and ``aio`` servers
  over byte-equal stores with sibling history mirrors and a telemetry
  directory; the one wall-clock field masked is
  ``avdb_fleet_worker_age_seconds`` of the view outside a fleet (the
  process's own age);
- the disabled plane (``AVDB_OBS_TICK_S=0``, ``AVDB_OBS_HISTORY_S=0``,
  ``AVDB_FLIGHT_EVENTS=0``) and the default one through both serve CLIs,
  both packages' default ``serve --workers 2`` fleets' views (burn rates
  and ``since`` stamps masked: the processes' own clocks), and a bad
  health knob failing startup as the reference's does.

The flight recorder's ring bytes and the three doctor verbs are in
``tests/test_torch_flight.py``.
"""

import json
import os
import shutil
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from annotatedvdb_tpu.obs import metrics as ref_metrics
from annotatedvdb_tpu.obs import slo as ref_slo
from annotatedvdb_tpu.obs import timeseries as ref_ts
from annotatedvdb_tpu.serve import aio as ref_aio
from annotatedvdb_tpu.serve import http as ref_http

from annotatedvdb_tpu_torch.obs import metrics
from annotatedvdb_tpu_torch.obs import slo
from annotatedvdb_tpu_torch.obs import timeseries as ts
from annotatedvdb_tpu_torch.serve import aio
from annotatedvdb_tpu_torch.serve import http

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke as smoke  # noqa: E402

PKGS = {"ref": (ref_metrics, ref_slo, ref_ts), "port": (metrics, slo, ts)}

EDGES = [0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
         1.0, 2.5]


def _both(fn):
    """``fn(metrics, slo, timeseries)`` for each package; asserts equal
    results (exceptions compared by type and message) and returns one."""
    out = {}
    for key, mods in PKGS.items():
        try:
            out[key] = ("ok", fn(*mods))
        except Exception as err:  # compared below
            out[key] = ("raise", type(err).__name__, str(err))
    assert out["port"] == out["ref"], out
    return out["ref"]


# ---------------------------------------------------------------- streams


def stream(seed, n=40, restart_at=None, lag=None, slow_share=0.0,
           error_share=0.0, rows_rate=0.0):
    """A seeded worker sample stream as the ring records it: per-kind
    request and error counters, the point-read latency histogram, the
    upsert ack histogram, the load rows counter, a queue-depth gauge and
    (for a follower) the replication-lag gauge.  ``restart_at`` resets
    every counter and histogram there (a respawned worker)."""
    rng = np.random.default_rng(seed)
    t = 1_000.0 + float(rng.uniform(0, 100))
    req = {"point": 0.0, "bulk": 0.0}
    err = {"point": 0.0, "bulk": 0.0}
    lat = [0] * (len(EDGES) + 1)
    ack = [0] * (len(EDGES) + 1)
    rows = 0.0
    out = []
    for i in range(n):
        if restart_at is not None and i == restart_at:
            req = {k: 0.0 for k in req}
            err = {k: 0.0 for k in err}
            lat = [0] * len(lat)
            ack = [0] * len(ack)
            rows = 0.0
        t += float(rng.uniform(0.8, 1.2))
        for kind in req:
            k = int(rng.integers(50, 150))
            req[kind] += k
            err[kind] += float(rng.binomial(k, error_share))
        for _ in range(int(rng.integers(20, 60))):
            v = float(rng.exponential(0.3 if rng.random() < slow_share else 0.002))
            lat[int(np.searchsorted(EDGES, v))] += 1
        for _ in range(int(rng.integers(0, 5))):
            ack[int(np.searchsorted(EDGES, float(rng.exponential(0.004))))] += 1
        rows += rows_rate * float(rng.uniform(0.5, 1.5))
        snap = {
            "avdb_query_requests_total": [
                {"kind": "counter", "labels": {"kind": k}, "value": v}
                for k, v in req.items()],
            "avdb_query_errors_total": [
                {"kind": "counter", "labels": {"kind": k}, "value": v}
                for k, v in err.items()],
            "avdb_query_seconds": [
                {"kind": "histogram", "labels": {"kind": "point"},
                 "edges": list(EDGES), "counts": list(lat), "sum": 0.0,
                 "count": sum(lat)}],
            "avdb_upsert_ack_seconds": [
                {"kind": "histogram", "labels": {}, "edges": list(EDGES),
                 "counts": list(ack), "sum": 0.0, "count": sum(ack)}],
            "avdb_rows_total": [
                {"kind": "counter", "labels": {}, "value": rows}],
            "avdb_serve_queue_depth": [
                {"kind": "gauge", "labels": {}, "value": float(rng.integers(0, 9))}],
        }
        if lag is not None:
            snap["avdb_replication_lag_seconds"] = [
                {"kind": "gauge", "labels": {}, "value": float(lag(i))}]
        out.append({"t": round(t, 6), "metrics": snap})
    return out


CASES = {
    "clean": dict(seed=1),
    "availability-breach": dict(seed=2, error_share=0.2),
    "worker-restart": dict(seed=3, restart_at=17, error_share=0.01),
    "replication-lag": dict(seed=4, lag=lambda i: 30.0 if 10 <= i < 30 else 0.2),
    "latency-breach": dict(seed=5, slow_share=0.5),
    "load-floor": dict(seed=6, rows_rate=10.0),
}


# ---------------------------------------------------------------- arithmetic


@pytest.mark.parametrize("seed", range(5))
def test_bucket_quantile_matches_reference(seed):
    rng = np.random.default_rng(seed)
    edges = np.cumsum(rng.uniform(0.001, 1.0, int(rng.integers(1, 20)))).tolist()
    for _ in range(20):
        counts = rng.integers(0, 30, len(edges) + 1).tolist()
        counts[int(rng.integers(0, len(counts)))] = 0
        count = sum(counts)
        for q in (0.0, 0.01, 0.5, 0.9, 0.99, 1.0, float(rng.random())):
            _both(lambda m, s, t: m.bucket_quantile(edges, counts, count, q))
    _both(lambda m, s, t: m.bucket_quantile(edges, [0] * (len(edges) + 1), 0, 0.5))
    _both(lambda m, s, t: m.bucket_quantile(edges, [1] * (len(edges) + 1), 9, 1.5))


@pytest.mark.parametrize("case", sorted(CASES))
def test_window_arithmetic_matches_reference(case):
    samples = stream(**CASES[case])
    names = [("avdb_query_requests_total", None),
             ("avdb_query_requests_total", {"kind": "point"}),
             ("avdb_query_errors_total", {"kind": "bulk"}),
             ("avdb_rows_total", None), ("absent_total", None)]
    for i in range(1, len(samples)):
        a, b = samples[i - 1], samples[max(0, i - 5)]
        for first, last in ((a, samples[i]), (b, samples[i])):
            for name, labels in names:
                _both(lambda m, s, t: (t.counter_delta(first, last, name, labels),
                                       t.counter_rate(first, last, name, labels)))
            for name, labels in (("avdb_query_seconds", {"kind": "point"}),
                                 ("avdb_upsert_ack_seconds", None)):
                _both(lambda m, s, t: t.histogram_window(first, last, name, labels))
                for q in (0.5, 0.99):
                    _both(lambda m, s, t: t.window_quantile(first, last, name, q,
                                                            labels))
                win = ref_ts.histogram_window(first, last, name, labels)
                for thr in (0.0001, 0.003, 0.1, 0.25, 3.0):
                    _both(lambda m, s, t: s.fraction_above(*win, thr))
        for window in (0.0, 1.0, 5.0, 60.0):
            _both(lambda m, s, t: t.window_samples(samples[:i + 1], window))
            _both(lambda m, s, t: t.trailing_samples(samples[:i + 1], window))
            _both(lambda m, s, t: t.window_samples(
                samples[:i + 1], window, now=samples[i]["t"] + 2.5))
    got = _both(lambda m, s, t: t.derive_series(samples))
    assert len(got[1]) >= 8


# ---------------------------------------------------------------- SLOs

KNOBS = {
    "AVDB_OBS_TICK_S": ("0.5", "0", "-1", "x"),
    "AVDB_OBS_HISTORY_S": ("30", "0", "-2", "y"),
    "AVDB_SLO_FAST_S": ("5", "0", "nan?"),
    "AVDB_SLO_SLOW_S": ("30", "1", "0"),
    "AVDB_SLO_BURN": ("1.5", "0", "z"),
    "AVDB_SLO_AVAIL_TARGET": ("0.99", "1", "0", "1.5"),
    "AVDB_SLO_LOAD_FLOOR": ("100", "-1", "q"),
}

READERS = {
    "AVDB_OBS_TICK_S": lambda m, s, t: t.obs_tick_from_env(),
    "AVDB_OBS_HISTORY_S": lambda m, s, t: t.obs_history_from_env(),
    "AVDB_SLO_FAST_S": lambda m, s, t: s.slo_fast_window_from_env(),
    "AVDB_SLO_SLOW_S": lambda m, s, t: s.slo_slow_window_from_env(),
    "AVDB_SLO_BURN": lambda m, s, t: s.slo_burn_from_env(),
    "AVDB_SLO_AVAIL_TARGET": lambda m, s, t: s.slo_avail_target_from_env(),
    "AVDB_SLO_LOAD_FLOOR": lambda m, s, t: s.slo_load_floor_from_env(),
}


@pytest.mark.parametrize("var", sorted(KNOBS))
def test_knobs_match_reference(monkeypatch, var):
    _both(READERS[var])  # the default
    for raw in KNOBS[var]:
        monkeypatch.setenv(var, raw)
        _both(READERS[var])


def _specs_view(specs):
    return [(sp.name, sp.kind, sp.description, sp.params, sp.target_note())
            for sp in specs]


@pytest.mark.parametrize("env", [
    {}, {"AVDB_SERVE_BROWNOUT_P99_MS": "40", "AVDB_REPL_MAX_LAG_S": "0"},
    {"AVDB_SLO_LOAD_FLOOR": "5", "AVDB_SLO_AVAIL_TARGET": "0.95"},
], ids=["defaults", "brownout-lag", "floor-target"])
def test_default_slos_match_reference(monkeypatch, env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    _both(lambda m, s, t: _specs_view(s.default_slos()))


@pytest.mark.parametrize("case", sorted(CASES))
def test_slo_walk_and_replay_match_reference(monkeypatch, case):
    """The state machine tick by tick (alert rows, the exported gauges'
    exposition) and ``replay_history`` over the same stream, with short
    windows so each breach walks ok -> pending -> firing -> resolved."""
    monkeypatch.setenv("AVDB_SERVE_BROWNOUT_P99_MS", "25")
    if case == "load-floor":
        monkeypatch.setenv("AVDB_SLO_LOAD_FLOOR", "40")
    samples = stream(**CASES[case])
    kw = dict(fast_s=3.0, slow_s=8.0, burn_threshold=2.0)

    def walk(m, s, t):
        reg = m.MetricsRegistry()
        reg_slos = s.SloRegistry(reg, **kw)
        rows = [reg_slos.evaluate(samples[:i + 1], now=samples[i]["t"])
                for i in range(len(samples))]
        return rows, reg.render_prometheus(), reg_slos.worst_state()

    rows, _prom, _worst = _both(walk)[1]
    replay = _both(lambda m, s, t: s.replay_history(samples, **kw))[1]
    if case != "clean":
        assert any(e["to"] == "firing" for e in replay["episodes"]), replay
    states = {r["state"] for step in rows for r in step}
    assert states <= {"ok", "pending", "firing", "resolved"}
    _both(lambda m, s, t: s.replay_history(samples[:1], **kw))
    _both(lambda m, s, t: s.worst_of(["ok", "resolved", "pending"]))


# ---------------------------------------------------------------- the ring


def _feed(reg, rng_seed, step):
    rng = np.random.default_rng(rng_seed * 1000 + step)
    reg.counter("avdb_query_requests_total", "", {"kind": "point"}).inc(
        int(rng.integers(1, 50)))
    reg.gauge("avdb_serve_queue_depth", "").set(float(rng.integers(0, 5)))
    h = reg.histogram("avdb_query_seconds", EDGES, "", {"kind": "point"})
    for v in rng.exponential(0.01, int(rng.integers(0, 9))):
        h.observe(float(v))


@pytest.mark.parametrize("seed", range(3))
def test_ring_mirror_and_harvest_bytes_match_reference(tmp_path, monkeypatch, seed):
    files = {}
    for key, (m, s, t) in PKGS.items():
        store = str(tmp_path / key)
        clk = {"t": 5_000.0 + seed}
        reg = m.MetricsRegistry()
        plane = s.HealthPlane(reg, store_dir=store, worker=seed,
                              tick_s=1.0, history_s=6.0, fast_s=2.0,
                              slow_s=4.0, burn_threshold=2.0,
                              clock=lambda c=clk: c["t"])
        for step in range(12):
            _feed(reg, seed, step)
            assert plane.tick()
            clk["t"] += 1.0
        plane.close()
        path = t.history_path(store, seed)
        with open(path, "rb") as f:
            files[key] = [f.read()]
        monkeypatch.setattr(time, "time", lambda: 1_700_000_000.25)
        out = t.harvest(path, store, seed, "died rc=-9")
        monkeypatch.undo()
        with open(out, "rb") as f:
            files[key].append((os.path.basename(out), f.read()))
        files[key].append(t.load_history(out)["harvested"])
        files[key].append({k: [os.path.basename(p) for p in v]
                           for k, v in t.list_history(store).items()})
        # an event-less mirror harvests nothing; a foreign file refuses
        empty = str(tmp_path / key / "history" / "w99.ts.json")
        with open(empty, "w") as f:
            json.dump({"type": "timeseries", "samples": []}, f)
        files[key].append(t.harvest(empty, store, 99, "x"))
        with open(str(tmp_path / key / "history" / "junk.ts.json"), "w") as f:
            json.dump({"type": "flight"}, f)
        with pytest.raises(ValueError):
            t.load_history(str(tmp_path / key / "history" / "junk.ts.json"))
    assert files["port"] == files["ref"]
    doc = json.loads(files["ref"][0])
    assert doc["worker"] == seed and len(doc["samples"]) == 7


def test_disabled_ring_matches_reference():
    for tick_s, history_s in ((0.0, 300.0), (1.0, 0.0)):
        _both(lambda m, s, t: (
            lambda r: (r.enabled, r.due(), r.tick(), r.samples(), r.span_s()))(
                t.TimeSeriesRing(m.MetricsRegistry(), tick_s=tick_s,
                                 history_s=history_s)))


# ---------------------------------------------------------------- servers


def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=30) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as err:
        return err.code, err.read()


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    return smoke.build_serve_store(str(tmp_path_factory.mktemp("health")), "cpu")


def _sibling_files(store, tdir):
    """Worker 1's and 2's live history mirrors (fresh, so inside the
    fleet views' TTL; worker 2's alert firing), a dead worker 3's stale
    mirror, and a telemetry directory with the supervisor's fleet facts
    and worker 1's published metric snapshot, written once by the
    reference and copied to every store."""
    for idx, state in ((1, "ok"), (2, "firing")):
        reg = ref_metrics.MetricsRegistry()
        reg.counter("avdb_query_requests_total", "", {"kind": "point"}).inc(7 * idx)
        ring = ref_ts.TimeSeriesRing(reg, worker=idx,
                                     path=ref_ts.history_path(store, idx),
                                     tick_s=1.0, history_s=60.0)
        ring.sample()
        reg.counter("avdb_query_requests_total", "", {"kind": "point"}).inc(3)
        ring.sample()
        ring.persist({"alerts": [{"slo": "availability", "state": state}],
                      "firing": int(state == "firing")}, force=True)
    stale = ref_ts.TimeSeriesRing(ref_metrics.MetricsRegistry(), worker=3,
                                  path=ref_ts.history_path(store, 3),
                                  tick_s=1.0, history_s=60.0,
                                  clock=lambda: time.time() - 3600)
    stale.sample()
    stale.persist(force=True)
    os.makedirs(tdir)
    reg = ref_metrics.MetricsRegistry()
    reg.counter("avdb_query_requests_total", "", {"kind": "point"}).inc(11)
    reg.gauge("avdb_serve_queue_depth", "").set(4)
    with open(os.path.join(tdir, "worker-1.json"), "w") as f:
        json.dump({"index": 1, "pid": 1, "t": time.time(),
                   "metrics": reg.snapshot()}, f)
    with open(os.path.join(tdir, "worker-5.json"), "w") as f:
        json.dump({"index": 5, "pid": 5, "t": time.time() - 3600,
                   "metrics": reg.snapshot()}, f)
    with open(os.path.join(tdir, "fleet.json"), "w") as f:
        json.dump({"t": time.time(), "workers_live": 3, "respawns_total": 2,
                   "worker_age_seconds": 12.5}, f)


@pytest.fixture()
def planes(served, tmp_path):
    """Per package: a byte-equal copy of the store (with the sibling
    mirrors), one registry and one HealthPlane (default SLOs, injected
    clock, a tick cadence only the test's manual ticks reach), and its
    threaded and aio servers; the port's with ``device="cpu"``."""
    base = str(tmp_path / "base")
    shutil.copytree(served["store"], base)
    _sibling_files(base, str(tmp_path / "base.tm"))
    out = {}
    servers = []
    for key, (m, s, t) in PKGS.items():
        store = str(tmp_path / key)
        shutil.copytree(base, store)
        tdir = str(tmp_path / f"{key}.tm")
        shutil.copytree(str(tmp_path / "base.tm"), tdir)
        clk = {"t": 9_000.0}
        reg = m.MetricsRegistry()
        plane = s.HealthPlane(reg, store_dir=store, worker=0, tick_s=3600.0,
                              history_s=600.0, fast_s=3.0, slow_s=6.0,
                              burn_threshold=2.0, clock=lambda c=clk: c["t"])
        plane.ring._last_tick = time.monotonic()
        hmod, amod = (ref_http, ref_aio) if key == "ref" else (http, aio)
        kw = {} if key == "ref" else {"device": "cpu"}
        httpd = hmod.build_server(store_dir=store, port=0, registry=reg,
                                  health=plane, telemetry_dir=tdir, **kw)
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        asrv = amod.build_aio_server(store_dir=store, port=0, registry=reg,
                                     health=plane, telemetry_dir=tdir, **kw)
        asrv.start_background()
        servers.append((httpd, asrv))
        out[key] = {"reg": reg, "plane": plane, "clk": clk, "store": store,
                    "ports": (httpd.server_address[1], asrv.server_address[1]),
                    "ctxs": (httpd.ctx, asrv.ctx)}
    try:
        yield out
    finally:
        for httpd, asrv in servers:
            httpd.shutdown()
            httpd.server_close()
            httpd.ctx.batcher.close()
            asrv.shutdown()
            asrv.ctx.batcher.close()


def _step(planes, step, errors=0):
    """One identical tick on both packages' planes: the same counter and
    histogram moves on each registry, then a manual tick."""
    for p in planes.values():
        reg = p["reg"]
        reg.counter("avdb_query_requests_total", "", {"kind": "point"}).inc(100)
        if errors:
            reg.counter("avdb_query_errors_total", "", {"kind": "point"}).inc(errors)
        h = reg.histogram("avdb_query_seconds", http.QUERY_SECONDS_EDGES, "",
                          {"kind": "point"})
        for v in (0.0007, 0.003, 0.004, 0.03 * (step % 3)):
            h.observe(v)
        assert p["plane"].tick()
        p["clk"]["t"] += 1.0


ROUTES = ("/healthz", "/alerts", "/alerts?fleet=1", "/alerts?fleet=true",
          "/metrics/history", "/metrics/history?window=2.5",
          "/metrics/history?window=junk", "/metrics/history?fleet=1",
          "/metrics/history?fleet=1&window=1", "/metrics", "/metrics?fleet=1")


def _bodies(planes):
    out = {}
    for key, p in planes.items():
        for fe, port in zip(("threaded", "aio"), p["ports"]):
            out[(key, fe)] = [_get(port, r) for r in ROUTES]
    return out


def test_health_routes_match_reference(planes):
    """Every health-plane route answers the reference's status and bytes
    on both front ends, before any tick, through an availability breach
    (pending, firing) and its resolution."""
    seen = set()
    for step in range(14):
        bodies = _bodies(planes)
        want = bodies[("ref", "threaded")]
        for k, got in bodies.items():
            assert got == want, (k, [ROUTES[i] for i in range(len(ROUTES))
                                     if got[i] != want[i]])
        alerts = json.loads(want[1][1])
        seen.add(alerts["state"])
        _step(planes, step, errors=40 if 2 <= step < 6 else 0)
    assert {"ok", "pending", "firing", "resolved"} <= seen, seen
    fleet = json.loads(want[2][1])
    assert set(fleet["workers"]) == {"0", "1", "2"}  # worker 3 aged out
    assert fleet["state"] == "firing" and fleet["firing"] >= 1
    hist = json.loads(want[7][1])
    assert hist["workers"]["1"]["samples"] == 2
    prom = want[10][1].decode()
    assert "avdb_fleet_workers_live 3" in prom
    assert "avdb_fleet_respawns_total 2" in prom
    # 13 ticks' 100 requests each on this worker, and worker 1's 11
    assert 'avdb_query_requests_total{kind="point"} 1311' in prom
    assert "avdb_serve_queue_depth 4" in prom


def test_fleet_metrics_outside_a_fleet_match_reference(planes):
    """Without a telemetry directory the ``?fleet=1`` view answers from
    the one process (one live worker); its age gauge is the process's
    own wall-clock age, the one masked field."""
    import re

    bodies = {}
    for key, p in planes.items():
        for ctx in p["ctxs"]:
            ctx.telemetry_dir = None
        for fe, port in zip(("threaded", "aio"), p["ports"]):
            status, body = _get(port, "/metrics?fleet=1")
            assert status == 200
            bodies[(key, fe)] = re.sub(rb"avdb_fleet_worker_age_seconds \S+",
                                       b"avdb_fleet_worker_age_seconds AGE", body)
    assert len(set(bodies.values())) == 1
    assert b"avdb_fleet_workers_live 1\n" in bodies[("port", "aio")]


# ---------------------------------------------------------------- CLIs


def _cli(pkg, store, extra=(), env=()):
    cmd = [sys.executable, "-m", pkg, "serve", "--storeDir", store,
           "--port", "0", *extra]
    if pkg.endswith("torch"):
        cmd += ["--platform", "cpu"]
    return subprocess.Popen(cmd, cwd=ROOT,
                            env=dict(os.environ, JAX_PLATFORMS="cpu", **dict(env)),
                            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
                            text=True, start_new_session=True)


@pytest.mark.parametrize("env", [
    {"AVDB_OBS_TICK_S": "0"}, {"AVDB_OBS_HISTORY_S": "0"},
    {"AVDB_FLIGHT_EVENTS": "0", "AVDB_OBS_TICK_S": "0"},
], ids=["tick-0", "history-0", "flight-0"])
def test_disabled_plane_through_the_cli_matches_reference(served, tmp_path, env):
    """The reference's own opt-outs turn the plane off in both CLIs: the
    disabled ``/alerts``, ``/metrics/history`` and ``/healthz`` bodies,
    and no history mirror (nor, with ``AVDB_FLIGHT_EVENTS=0``, flight
    ring) written."""
    answers = {}
    procs = []
    try:
        for pkg in ("annotatedvdb_tpu", "annotatedvdb_tpu_torch"):
            store = str(tmp_path / pkg)
            shutil.copytree(served["store"], store)
            proc = _cli(pkg, store, ("--frontend", "threaded"), env)
            procs.append(proc)
            banner = proc.stdout.readline()
            assert banner.startswith("serving "), banner
            port = int(banner.rsplit(":", 1)[1])
            answers[pkg] = [_get(port, r) for r in
                            ("/alerts", "/alerts?fleet=1", "/metrics/history",
                             "/healthz")]
    finally:
        for proc in procs:
            os.killpg(proc.pid, signal.SIGTERM)
            proc.wait(timeout=60)
    assert answers["annotatedvdb_tpu_torch"] == answers["annotatedvdb_tpu"]
    assert json.loads(answers["annotatedvdb_tpu"][0][1])["state"] == "disabled"
    for pkg in answers:
        store = str(tmp_path / pkg)
        assert not os.path.exists(os.path.join(store, "history"))
        assert os.path.exists(os.path.join(store, "flight", "w0.ring")) == (
            "AVDB_FLIGHT_EVENTS" not in env)


def test_default_cli_plane_is_on_and_persists(served, tmp_path):
    """A default ``serve`` of either package runs the plane: ``/alerts``
    enabled with the declared SLOs, a history mirror and a flight ring
    under the store after a clean stop, both readable by the other
    package's readers."""
    docs = {}
    for pkg in ("annotatedvdb_tpu", "annotatedvdb_tpu_torch"):
        store = str(tmp_path / pkg)
        shutil.copytree(served["store"], store)
        proc = _cli(pkg, store, env={"AVDB_OBS_TICK_S": "0.2"})
        try:
            banner = proc.stdout.readline()
            port = int(banner.rsplit(":", 1)[1])
            _get(port, f"/variant/{served['ids'][0]}")
            deadline = time.monotonic() + 30
            while json.loads(_get(port, "/metrics/history")[1])["samples"] < 3:
                assert time.monotonic() < deadline
                time.sleep(0.1)
            alerts = json.loads(_get(port, "/alerts")[1])
        finally:
            os.killpg(proc.pid, signal.SIGTERM)
            assert proc.wait(timeout=60) == 0
        assert alerts["enabled"] is True and alerts["state"] == "ok"
        docs[pkg] = [a["slo"] for a in alerts["alerts"]]
        other_ts = ref_ts if pkg.endswith("torch") else ts
        doc = other_ts.load_history(other_ts.history_path(store, 0))
        assert len(doc["samples"]) >= 3 and doc["firing"] == 0
        from annotatedvdb_tpu.obs import flight as ref_flight

        from annotatedvdb_tpu_torch.obs import flight

        other_flight = ref_flight if pkg.endswith("torch") else flight
        ring = other_flight.decode_ring(other_flight.ring_path(store, 0))
        assert [e["kind"] for e in ring["events"]
                if e["type"] == "request"] == ["point"]
    assert docs["annotatedvdb_tpu_torch"] == docs["annotatedvdb_tpu"] == [
        "availability", "point_read_p99", "upsert_ack_p99", "load_rate",
        "replication_lag"]


def _views(port):
    import re

    def mask(obj):
        # the answering worker's own entry also carries its burn threshold
        # and windows; which worker answers is the kernel's choice
        if isinstance(obj, dict):
            return {k: (None if k in ("burn_fast", "burn_slow", "since") else mask(v))
                    for k, v in obj.items() if k not in ("burn_threshold", "windows")}
        if isinstance(obj, list):
            return [mask(v) for v in obj]
        return obj

    alerts = json.loads(_get(port, "/alerts?fleet=1")[1])
    history = json.loads(_get(port, "/metrics/history")[1])
    prom = _get(port, "/metrics?fleet=1")[1].decode()
    return {"alerts": mask(alerts),
            "history": (sorted(history), sorted({s["name"] for s in history["series"]})),
            "types": sorted(set(re.findall(r"^# TYPE (\S+ \S+)$", prom, re.M))),
            "live": re.search(r"^avdb_fleet_workers_live (\S+)$", prom, re.M).group(1),
            "healthz": json.loads(_get(port, "/healthz")[1])}


def test_fleet_cli_views_match_reference(served, tmp_path):
    """Both packages' default ``serve --workers 2``: once every worker has
    ticked and published, any worker's ``/alerts?fleet=1`` (burn rates
    and ``since`` stamps masked: they are the processes' own clocks),
    ``/metrics/history`` (its fields and series), ``/metrics?fleet=1``
    (its series and two live workers) and ``/healthz`` agree."""
    import re

    views = {}
    procs = []
    try:
        for pkg in ("annotatedvdb_tpu", "annotatedvdb_tpu_torch"):
            store = str(tmp_path / pkg)
            shutil.copytree(served["store"], store)
            cmd = [sys.executable, "-m", pkg, "serve", "--storeDir", store,
                   "--port", "0", "--workers", "2"]
            if pkg.endswith("torch"):
                cmd += ["--platform", "cpu"]
            out_path = str(tmp_path / f"{pkg}.out")
            with open(out_path, "w") as out_f:
                proc = subprocess.Popen(
                    cmd, cwd=ROOT, stdout=out_f, stderr=subprocess.DEVNULL,
                    env=dict(os.environ, JAX_PLATFORMS="cpu", AVDB_OBS_TICK_S="0.2"),
                    start_new_session=True)
            procs.append(proc)
            deadline = time.monotonic() + 120
            while sum(ln.startswith("worker ") for ln in open(out_path)) < 2:
                assert time.monotonic() < deadline and proc.poll() is None
                time.sleep(0.1)
            port = int(re.search(r":(\d+) with 2 workers",
                                 open(out_path).read()).group(1))
            for vid in served["ids"][:20]:
                _get(port, f"/variant/{vid}")
            while True:
                got = _views(port)
                if got["live"] == "2" and len(got["alerts"]["workers"]) == 2:
                    break
                assert time.monotonic() < deadline
                time.sleep(0.2)
            views[pkg] = got
    finally:
        for proc in procs:
            os.killpg(proc.pid, signal.SIGTERM)
            proc.wait(timeout=60)
    assert views["annotatedvdb_tpu_torch"] == views["annotatedvdb_tpu"]
    assert views["annotatedvdb_tpu"]["alerts"]["state"] == "ok"


@pytest.mark.parametrize("knob,raw", [
    ("AVDB_OBS_TICK_S", "x"), ("AVDB_OBS_HISTORY_S", "-1"),
    ("AVDB_SLO_BURN", "0"), ("AVDB_SLO_AVAIL_TARGET", "2"),
    ("AVDB_SLO_FAST_S", "z"),
])
def test_bad_health_knob_fails_startup_as_the_reference(served, tmp_path, capsys,
                                                         monkeypatch, knob, raw):
    """A malformed health-plane knob fails a one-process server's startup
    (exit 1, the reference's message) and the fleet supervisor's
    construction, before any worker is spawned."""
    from annotatedvdb_tpu.cli import serve as ref_serve_cli
    from annotatedvdb_tpu.serve import fleet as ref_fleet

    from annotatedvdb_tpu_torch.cli import serve as serve_cli
    from annotatedvdb_tpu_torch.serve import fleet

    monkeypatch.setenv(knob, raw)
    got = {}
    for key, main, extra in (("ref", ref_serve_cli.main, []),
                             ("port", serve_cli.main, ["--platform", "cpu"])):
        store = str(tmp_path / key)
        shutil.copytree(served["store"], store)
        rc = main(["--storeDir", store, "--port", "0", "--frontend", "threaded",
                   *extra])
        got[key] = (rc, capsys.readouterr().err.replace(store, "STORE"))
    assert got["port"] == got["ref"] and got["ref"][0] == 1
    assert knob in got["ref"][1]
    errs = []
    try:
        for mod in (ref_fleet, fleet):
            with pytest.raises(ValueError) as exc:
                mod.ServeFleet(str(tmp_path / "fleet"), port=0, workers=1)
            errs.append(str(exc.value))
    finally:
        # the knobs resolve after the supervisor's ring installed the
        # process-wide lifecycle sink (in both packages): clear it
        from annotatedvdb_tpu.obs import reqtrace as ref_reqtrace

        from annotatedvdb_tpu_torch.obs import reqtrace

        ref_reqtrace.set_background_sink(None, None)
        reqtrace.set_background_sink(None, None)
    assert errs[0] == errs[1]
