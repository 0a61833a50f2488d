"""The query server (``serve --frontend threaded``, and the CLI's default
aio front end): the PyTorch port against the JAX package, on the CPU.

One store is built with the port's ``load-vcf`` (two files: the second
overlaps the first, and duplicate and over-width lines), ``load-vep``
(consequence ranks, colocated frequencies) and ``load-cadd``, all through
its CLI on the CPU.  Both packages' ``QueryEngine`` then answer points,
bulk lookups, regions with filters and a cursor walk, batch regions (rows,
count-only, ``tokenize``) and stats panels (every metric, windows), and
both packages' threaded HTTP servers answer the same requests; every
body, status and echoed trace header must be the same bytes, including
the 400s of bad grammar and the batch caps, and ``GET /export/stream``
(ordered and shuffled batches, ragged and empty slices, its 400s and the
over-cap slice).  The routes the port does not serve yet answer the
reference's unknown-route 404.  The port's engine
runs the plain versions of its kernels on the CPU, on the device path
(groups at or above the device minimums) and on the host twins alike.
Also: the read-only store contract, a residency budget of 64 KiB (the
same bytes as an unmanaged engine), the breaker's host fallback (and the
failed request when there is no breaker), the card engine loading its
kernels when it is made, and the CLI's banner, shutdown summary and
refusals.
"""

import http.client
import json
import os
import re
import signal
import subprocess
import sys
import threading
import time

import pytest
import torch

from annotatedvdb_tpu.export import stream as ref_stream
from annotatedvdb_tpu.serve.engine import QueryEngine as RefEngine
from annotatedvdb_tpu.serve.http import build_server as ref_build_server
from annotatedvdb_tpu.serve.snapshot import SnapshotManager as RefManager
from annotatedvdb_tpu.serve.snapshot import StaticSnapshots as RefSnaps
from annotatedvdb_tpu.store import VariantStore as RefStore

from annotatedvdb_tpu_torch.export import stream as port_stream
from annotatedvdb_tpu_torch.ops import export_pack as port_export_pack
from annotatedvdb_tpu_torch.ops import intervals as port_intervals
from annotatedvdb_tpu_torch.ops import stats as port_stats
from annotatedvdb_tpu_torch.serve.engine import QueryEngine
from annotatedvdb_tpu_torch.serve.http import build_server
from annotatedvdb_tpu_torch.serve.residency import ResidencyManager
from annotatedvdb_tpu_torch.serve.resilience import DeviceBreaker
from annotatedvdb_tpu_torch.serve.snapshot import SnapshotManager, StaticSnapshots
from annotatedvdb_tpu_torch.store import VariantStore

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke as smoke  # noqa: E402

#: the routes of the reference the port does not serve yet, and the
#: upsert route, which a server started without ``--upserts`` refuses
#: with the reference's 403
UNPORTED = (("GET", "/repl/manifest"),
            ("GET", "/repl/segment"), ("GET", "/repl/wal"),
            ("GET", "/alerts"), ("GET", "/metrics/history"),
            ("GET", "/debug/trace"), ("POST", "/variants/upsert"),
            ("POST", "/_chaos"))


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """A store built by the port's CLIs on the CPU, and its variant ids
    (``chip_smoke.build_serve_store``)."""
    return smoke.build_serve_store(str(tmp_path_factory.mktemp("serve")), "cpu")


def _engines(served, **kw):
    ref = RefEngine(RefSnaps(RefStore.load(served["store"], readonly=True)))
    port = QueryEngine(StaticSnapshots(VariantStore.load(served["store"],
                                                         readonly=True)),
                       device="cpu", **kw)
    return ref, port


_panel = smoke.serve_panel


def test_points_and_bulk_match_reference(served):
    ref, port = _engines(served)
    ids = served["ids"]
    assert port.lookup_many(ids) == ref.lookup_many(ids)
    for vid in ids[::97] + ["22:16000001:A:C"]:
        assert port.lookup(vid) == ref.lookup(vid)
    assert sum(r is not None for r in port.lookup_many(ids)) > 2000


@pytest.mark.parametrize("kw", [
    {}, {"limit": 5}, {"min_cadd": 20.0, "limit": 50},
    {"max_conseq_rank": 20}, {"min_cadd": 5, "max_conseq_rank": 30, "limit": 0},
], ids=lambda kw: ",".join(f"{k}={v}" for k, v in kw.items()) or "plain")
def test_region_matches_reference(served, kw):
    ref, port = _engines(served)
    for spec in _panel(served, per_group=6, width=20_000, seed=3):
        assert port.region(spec, **kw) == ref.region(spec, **kw), spec


def test_cursor_walk_matches_reference(served):
    ref, port = _engines(served)
    spec = f"22:{served['pos22'][0]}-{served['pos22'][0] + 20_000}"
    for kw in ({}, {"min_cadd": 20.0}):
        tok = {"ref": "", "port": ""}
        pages = 0
        while tok["ref"] is not None:
            a = ref.region(spec, limit=60, cursor=tok["ref"], **kw)
            b = port.region(spec, limit=60, cursor=tok["port"], **kw)
            assert a == b
            tok = {"ref": json.loads(a)["next"], "port": json.loads(b)["next"]}
            pages += 1
        assert pages >= 3


@pytest.mark.parametrize("kw", [
    {"limit": 5}, {"limit": 0}, {"limit": 0, "tokenize": True},
    {"limit": 3, "tokenize": True, "min_cadd": 10},
    {"limit": 10, "max_conseq_rank": 25},
], ids=lambda kw: ",".join(f"{k}={v}" for k, v in kw.items()))
def test_regions_match_reference(served, kw):
    ref, port = _engines(served)
    specs = _panel(served, seed=5)
    before = dict(port_intervals.CALLS)
    want = ref.regions_serve(specs, **kw).assemble()
    assert port.regions_serve(specs, **kw).assemble() == want
    # both groups reached the device minimum: the plain BITS ran, on the CPU
    assert port_intervals.CALLS["cpu"] == before["cpu"] + 2
    assert port.regions_serve(specs, host_only=True, **kw).assemble() == want


@pytest.mark.parametrize("kw", [
    {}, {"windows": 16}, {"metrics": ["cadd"], "windows": 7},
    {"metrics": ["af", "conseq"]}, {"windows": 1},
], ids=lambda kw: ",".join(f"{k}={v}" for k, v in kw.items()) or "plain")
def test_stats_match_reference(served, kw):
    ref, port = _engines(served)
    specs = _panel(served, per_group=20, width=30_000, seed=7)
    before = dict(port_stats.CALLS)
    want = ref.stats_serve(specs, **kw).assemble()
    assert port.stats_serve(specs, **kw).assemble() == want
    calls = 2 * (2 if "windows" in kw else 1)
    assert port_stats.CALLS["cpu"] == before["cpu"] + calls
    assert port.stats_serve(specs, host_only=True, **kw).assemble() == want
    results = json.loads(want)["results"]
    for metric in kw.get("metrics", port_stats.STATS_METRICS):
        assert any(r[metric]["present"] for r in results), metric


def test_small_groups_on_the_device_path_match_reference(served):
    """Device minimums of 0 send every group, however small, through the
    kernels' plain versions."""
    ref, port = _engines(served, regions_device_min=0, stats_device_min=0)
    specs = _panel(served, per_group=3, seed=9)
    for kw in ({"limit": 4}, {"limit": 0, "tokenize": True}):
        assert port.regions_serve(specs, **kw).assemble() \
            == ref.regions_serve(specs, **kw).assemble()
    assert port.stats_serve(specs, windows=5).assemble() \
        == ref.stats_serve(specs, windows=5).assemble()
    spec = specs[0]
    assert port.region(spec, min_cadd=1.0) == ref.region(spec, min_cadd=1.0)


def test_device_failure_feeds_the_breaker_and_answers_from_the_host(served,
                                                                    monkeypatch):
    ref, port = _engines(served, breaker=DeviceBreaker(failure_threshold=2))
    specs = _panel(served, seed=11)

    def broken(*_a, **_k):
        raise RuntimeError("device lost")

    monkeypatch.setattr(port, "_device_spans", broken)
    monkeypatch.setattr(port, "_device_stats", broken)
    want_regions = ref.regions_serve(specs, limit=2).assemble()
    want_stats = ref.stats_serve(specs).assemble()
    for _ in range(2):
        assert port.regions_serve(specs, limit=2).assemble() == want_regions
        assert port.stats_serve(specs).assemble() == want_stats
    assert port.breaker.open_groups() == [8, 22]
    assert port.regions_serve(specs, limit=2).assemble() == want_regions


@pytest.mark.parametrize("seam", ["_device_spans", "_device_stats",
                                  "_device_windows"])
def test_device_failure_without_a_breaker_fails_the_request(served,
                                                            monkeypatch, seam):
    _ref, port = _engines(served)
    specs = _panel(served, seed=11)

    def broken(*_a, **_k):
        raise RuntimeError("device lost")

    monkeypatch.setattr(port, seam, broken)
    serve = {"_device_spans": lambda: port.regions_serve(specs, limit=2),
             "_device_stats": lambda: port.stats_serve(specs),
             "_device_windows": lambda: port.stats_serve(specs, windows=4)}[seam]
    with pytest.raises(RuntimeError, match="device lost"):
        serve()


def test_card_engine_loads_its_kernels_when_made(served, monkeypatch):
    """On the card the engine loads its kernel libraries in its
    constructor, so a failed build raises there, before any request."""
    loaded = []

    def failing_build():
        loaded.append("bits_spans")
        raise RuntimeError("nvcc failed")

    monkeypatch.setattr(port_intervals, "_library", failing_build)
    snaps = StaticSnapshots(VariantStore.load(served["store"], readonly=True))
    with pytest.raises(RuntimeError, match="nvcc failed"):
        QueryEngine(snaps, device=torch.device("cuda"))
    monkeypatch.setattr(port_intervals, "_library", lambda: loaded.append("bits_spans"))
    monkeypatch.setattr(port_stats, "_library", lambda: loaded.append("stats_panel"))
    monkeypatch.setattr(port_export_pack, "_library",
                        lambda: loaded.append("export_pack"))
    QueryEngine(snaps, device=torch.device("cuda"))
    QueryEngine(snaps, device="cpu")
    assert loaded == ["bits_spans", "bits_spans", "stats_panel", "export_pack"]


def test_residency_budget_gives_the_unmanaged_bytes(served):
    ref, port = _engines(served)
    res = ResidencyManager(64 << 10, upload=True, min_rows=1,
                           async_upload=False, plan_interval_s=0,
                           device="cpu")
    managed = QueryEngine(StaticSnapshots(VariantStore.load(served["store"],
                                                            readonly=True)),
                          device="cpu", residency=res)
    ids = served["ids"]
    for chunk in (ids[:700], ids[700:1900], ids):
        assert managed.lookup_many(chunk) == port.lookup_many(chunk) \
            == ref.lookup_many(chunk)
    stats = res.stats()
    assert stats["candidates"] > 0 and 0 < stats["resident_bytes"] <= 64 << 10
    specs = _panel(served, seed=13)
    assert managed.regions_serve(specs, limit=3).assemble() \
        == ref.regions_serve(specs, limit=3).assemble()


def test_readonly_open_contract(served):
    store = VariantStore.load(served["store"], readonly=True)
    assert store.readonly
    with pytest.raises(RuntimeError, match="readonly"):
        store.save(served["store"])
    with pytest.raises(RuntimeError, match="readonly"):
        store.shard(2)  # a missing shard must not be materialized
    assert store.shards.get(2) is None
    assert store.shard(22).n > 0  # existing shards stay accessible
    assert not VariantStore.load(served["store"]).readonly


def _stream_queries(served):
    """``GET /export/stream`` query strings over the store: ``batch_rows``
    8, 256 and 4,096, ordered and shuffled, a ragged last batch, an empty
    slice, chr8 and the defaults."""
    p22, p8 = served["pos22"], served["pos8"]
    whole = f"22:{int(p22[0])}-{int(p22[-1]) + 20}"
    part = f"22:{int(p22[100])}-{int(p22[900])}"
    return [
        f"region={whole}&batch_rows=8&batch=3&ordered=1",
        f"region={whole}&batch_rows=8&batch=17&seed=5",
        f"region={part}&batch_rows=256&batch=3&ordered=1",
        f"region={part}&batch_rows=256&batch=2&seed=2",
        f"region=chr{whole}&batch_rows=4096&batch=0&seed=9",
        f"region={whole}&batch_rows=4096&ordered=true",
        f"region=8:{int(p8[0])}-{int(p8[-1])}&batch_rows=64&batch=7&seed=1",
        "region=22:1-100&batch_rows=8",  # no rows: one empty batch
        f"region={part}",
    ]


def test_export_stream_matches_reference(served):
    ref, port = _engines(served)
    before = dict(port_export_pack.CALLS)
    queries = _stream_queries(served)
    for q in queries:
        want = ref_stream.stream_payload(ref, ref_stream.parse_stream_query(q))
        params = port_stream.parse_stream_query(q)
        assert params == ref_stream.parse_stream_query(q)
        assert port_stream.stream_payload(port, params) == want, q
        assert port_stream.stream_payload(port, params, host_only=True) == want, q
    # the device path ran the plain version once a call, on the CPU
    assert port_export_pack.CALLS["cpu"] == before["cpu"] + len(queries)
    doc = json.loads(port_stream.stream_payload(
        port, port_stream.parse_stream_query(queries[4]))[0])
    assert doc["n_valid"] == doc["rows"] < 4096 and sum(doc["arrays"]["mask"]) == doc["n_valid"]


def test_export_stream_device_failure_feeds_the_breaker(served, monkeypatch):
    ref, port = _engines(served, breaker=DeviceBreaker(failure_threshold=2))
    q = _stream_queries(served)[1]
    want = ref_stream.stream_payload(ref, ref_stream.parse_stream_query(q))

    def broken(*_a, **_k):
        raise RuntimeError("device lost")

    monkeypatch.setattr(port_export_pack, "pack_part", broken)
    for _ in range(3):
        assert port_stream.stream_payload(
            port, port_stream.parse_stream_query(q)) == want
    assert port.breaker.open_groups() == [22]
    _ref, bare = _engines(served)
    with pytest.raises(RuntimeError, match="device lost"):
        port_stream.stream_payload(bare, port_stream.parse_stream_query(q))


# ------------------------------------------------------------------- HTTP


def _fetch(port, method, path, body=None, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        data = body if body is None or isinstance(body, bytes) \
            else json.dumps(body).encode()
        conn.request(method, path, body=data, headers=headers or {})
        resp = conn.getresponse()
        return resp.status, resp.read(), dict(resp.getheaders())
    finally:
        conn.close()


@pytest.fixture(scope="module")
def servers(served):
    """Both packages' threaded servers over the store, each on port 0."""
    ref = ref_build_server(manager=RefManager(served["store"]), port=0)
    port = build_server(manager=SnapshotManager(served["store"]), port=0,
                        device="cpu")
    threads = [threading.Thread(target=s.serve_forever, daemon=True)
               for s in (ref, port)]
    for t in threads:
        t.start()
    yield {"ref": ref.server_address[1], "port": port.server_address[1]}
    for s in (ref, port):
        s.shutdown()
        s.server_close()
        s.ctx.batcher.close()


def _same(servers, method, path, body=None, status=None):
    """The two servers' answers to one request: the same status, body and
    echoed trace id."""
    hdr = {"X-Request-Id": "parity-1"}
    a = _fetch(servers["ref"], method, path, body, hdr)
    b = _fetch(servers["port"], method, path, body, hdr)
    assert b[0] == a[0], (path, a[1][:300], b[1][:300])
    assert b[1] == a[1], path
    assert b[2].get("X-Request-Id") == a[2].get("X-Request-Id") == "parity-1"
    assert b[2].get("Content-Type") == a[2].get("Content-Type")
    if status is not None:
        assert a[0] == status, (path, a[1][:300])
    return a


def test_http_points_and_bulk_match_reference(servers, served):
    ids = served["ids"]
    for vid in ids[::53] + ["22:16000001:A:C", "3:100:A:C"]:
        _same(servers, "GET", f"/variant/{vid}")
    for bad in ("22:abc:A:C", "99:1:A:C", "22:5:A:Z", "22:0:A:C", "x"):
        _same(servers, "GET", f"/variant/{bad}", status=400)
    _same(servers, "POST", "/variants", {"ids": ids}, status=200)
    for bad in ({}, [1], {"ids": [1]}, {"ids": ids[:3] + ["22:x:A:C"]}):
        _same(servers, "POST", "/variants", bad, status=400)
    _same(servers, "POST", "/variants", b"not json", status=400)


def test_http_region_and_cursor_match_reference(servers, served):
    for spec in _panel(served, per_group=4, width=20_000, seed=17):
        for q in ("", "?minCadd=20&limit=5", "?maxConseqRank=25&limit=0",
                  "?minCadd=&limit=7"):
            _same(servers, "GET", f"/region/{spec}{q}", status=200)
    spec = f"22:{served['pos22'][0]}-{served['pos22'][0] + 20_000}"
    tok, pages = "", 0
    while tok is not None:
        _s, body, _h = _same(servers, "GET",
                             f"/region/{spec}?limit=70&minCadd=10&cursor={tok}")
        tok = json.loads(body)["next"]
        pages += 1
    assert pages >= 3
    for bad in ("22:5-1", "22:1-64000002", "22:1-10?limit=x", "zz:1-5",
                f"{spec}?limit=5&cursor=bogus", "22:10-20?minCadd=abc"):
        _same(servers, "GET", f"/region/{bad}", status=400)
    _same(servers, "GET", "/region/22:2147483645-2147483650", status=200)


def test_http_regions_and_stats_match_reference(servers, served):
    specs = _panel(served, seed=19)
    for body in ({"regions": specs, "limit": 5},
                 {"regions": specs, "limit": 0},
                 {"regions": specs, "limit": 0, "tokenize": True},
                 {"regions": specs, "limit": 2, "tokenize": True, "minCadd": 15}):
        _same(servers, "POST", "/regions", body, status=200)
    for body in ({"regions": specs, "windows": 16},
                 {"regions": specs, "metrics": ["af"]},
                 {"regions": specs[:5], "metrics": ["cadd", "conseq"],
                  "windows": 3}):
        _same(servers, "POST", "/stats/region", body, status=200)
    for path, body in (
            ("/regions", {"regions": "22:1-5"}),
            ("/regions", {"regions": specs, "limit": True}),
            ("/regions", {"regions": specs, "tokenize": 1}),
            ("/regions", {"regions": ["22:9-1"]}),
            ("/regions", {"regions": ["22:1-2"] * 4097}),
            ("/regions", b"nope"),
            ("/stats/region", {"regions": specs, "windows": 0}),
            ("/stats/region", {"regions": specs, "windows": 65}),
            ("/stats/region", {"regions": specs, "windows": True}),
            ("/stats/region", {"regions": specs, "metrics": ["gc"]}),
            ("/stats/region", {"regions": specs, "metrics": []}),
            ("/stats/region", {"regions": ["22:1-2"] * 4097}),
            ("/stats/region", b"[1, 2]")):
        _same(servers, "POST", path, body, status=400)


def test_http_health_routes_match_reference(servers):
    for path in ("/healthz", "/readyz"):
        _same(servers, "GET", path, status=200)
    a = json.loads(_fetch(servers["ref"], "GET", "/stats")[1])
    b = json.loads(_fetch(servers["port"], "GET", "/stats")[1])
    assert sorted(b) == sorted(a)
    assert sorted(b["batcher"]) == sorted(a["batcher"])
    assert b["breaker"] == a["breaker"] and b["brownout"] == a["brownout"]
    assert (b["generation"], b["rows"]) == (a["generation"], a["rows"])
    for key in ("ref", "port"):
        status, text, hdr = _fetch(servers[key], "GET", "/metrics")
        assert status == 200 and hdr["Content-Type"].startswith("text/plain")
        assert b"avdb_query_requests_total" in text


def test_http_export_stream_matches_reference(servers, served, monkeypatch):
    for q in _stream_queries(served):
        _same(servers, "GET", f"/export/stream?{q}", status=200)
    whole = _stream_queries(served)[0].split("&")[0]
    for bad in ("batch=0", f"{whole}&batch_rows=7", f"{whole}&batch_rows=4097",
                f"{whole}&batch=-1", f"{whole}&batch_rows=4096&batch=1",
                f"{whole}&batch=x", "region=3:1-100", "region=Q:1-5",
                "region=22:9-1", ""):
        _same(servers, "GET", f"/export/stream?{bad}", status=400)
    for mod in (ref_stream, port_stream):
        monkeypatch.setattr(mod, "STREAM_MAX_ROWS", 100)
    _same(servers, "GET", f"/export/stream?{whole}", status=400)
    _same(servers, "GET", "/export/stream?region=22:1-100", status=200)


def test_http_counts_match_reference(servers, served):
    """The same traffic leaves the same per-kind request and error
    counts on both servers."""
    _same(servers, "GET", f"/variant/{served['ids'][1]}")
    pat = re.compile(rb'^avdb_query_(requests|errors)_total\{kind="(\w+)"\} (\S+)$',
                     re.M)
    got = {key: sorted(pat.findall(_fetch(servers[key], "GET", "/metrics")[1]))
           for key in ("ref", "port")}
    kinds = {b"point", b"bulk", b"region", b"regions", b"stats", b"export",
             b"upsert"}
    assert {k for _c, k, _v in got["port"]} == kinds
    assert [r for r in got["ref"] if r[1] in kinds] == got["port"]


@pytest.mark.parametrize("route", UNPORTED, ids=lambda r: r[1])
def test_unported_routes_answer_the_unknown_route_404(servers, route):
    method, path = route
    status, body, _h = _fetch(servers["port"], method, path, b"{}")
    if path == "/variants/upsert":
        # ported: without a memtable both packages refuse the write alike
        want = _fetch(servers["ref"], method, path, b"{}")
        assert (status, body) == (want[0], want[1]) and status == 403
        return
    if path.startswith("/repl/"):
        # ported: both packages serve the ship surface of the one store
        # (the ship document, its clock masked; an unnamed file is a 404)
        want = _fetch(servers["ref"], method, path, b"{}")
        clock = re.compile(rb'"now": [0-9.e+-]+')
        assert (status, clock.sub(b"", body)) == (want[0], clock.sub(b"", want[1]))
        assert status == (200 if path == "/repl/manifest" else 404)
        return
    if path in ("/alerts", "/metrics/history"):
        # ported: a server built without a health plane (the reference's
        # own default context) answers the disabled views, fleet or not
        for query in ("", "?fleet=1"):
            got = _fetch(servers["port"], method, path + query, b"{}")
            want = _fetch(servers["ref"], method, path + query, b"{}")
            assert (got[0], got[1]) == (want[0], want[1]) and got[0] == 200
        assert json.loads(body)["enabled"] is False
        return
    assert status == 404
    # the reference's own answer to a route it does not have
    ref_status, ref_body, _h = _fetch(servers["ref"], method, "/no/such/route",
                                      b"{}")
    assert ref_status == 404
    assert body == ref_body.replace(b"/no/such/route", path.encode())


# -------------------------------------------------------------------- CLI


def _start(cmd, env):
    return subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _banner(proc):
    line = proc.stdout.readline()
    assert line.startswith("serving "), (line, proc.stderr.read()
                                         if proc.poll() is not None else "")
    return line.strip()


def test_cli_banner_summary_and_shutdown_match_reference(served):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    args = ["serve", "--storeDir", served["store"], "--port", "0",
            "--frontend", "threaded"]
    port_proc = _start([sys.executable, "-m", "annotatedvdb_tpu_torch", *args,
                        "--platform", "cpu"], env)
    ref_proc = _start([sys.executable, "-m", "annotatedvdb_tpu", *args], env)
    try:
        banners = [_banner(p) for p in (port_proc, ref_proc)]
        strip = [re.sub(r":\d+$", ":PORT", b) for b in banners]
        assert strip[0] == strip[1]
        port_no = int(banners[0].rsplit(":", 1)[1])
        status, body, _h = _fetch(port_no, "GET", "/healthz")
        assert status == 200 and json.loads(body)["rows"] > 2000
        _fetch(port_no, "POST", "/regions", {"regions": _panel(served)})
    finally:
        for p in (port_proc, ref_proc):
            p.send_signal(signal.SIGINT)
    assert port_proc.wait(timeout=60) == 0
    ref_proc.wait(timeout=60)
    err = port_proc.stderr.read()
    summary = json.loads(err.split("run summary ", 1)[1].splitlines()[0])
    assert summary["device"] == "cpu"
    assert summary["plain_calls"]["bits_spans_reference"]["cpu"] == 2
    assert summary["launches"] == {"bits_spans": 0, "stats_panel": 0,
                                   "windowed_stats": 0, "export_pack": 0}
    assert summary["breaker"] == {"open_groups": [], "groups": {}}


@pytest.mark.parametrize("flags", [[], ["--frontend", "aio"]],
                         ids=["default-aio", "aio"])
def test_cli_serves_the_aio_front_end(servers, served, flags):
    """No ``--frontend`` flag starts the aio front end, as in the
    reference: the banner, a ``/healthz`` with the reference's bytes (the
    CLI runs the default health plane, so its alert state reads ``ok``
    where the in-process server without one reads ``disabled``), the
    ``counts so far`` record SIGUSR1 logs while it serves, and the
    shutdown summary."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = _start([sys.executable, "-m", "annotatedvdb_tpu_torch", "serve",
                   "--storeDir", served["store"], "--port", "0", *flags,
                   "--platform", "cpu"], env)
    try:
        banner = _banner(proc)
        assert re.fullmatch(rf"serving {re.escape(served['store'])} "
                            r"\(generation 1, \d+ rows\) on "
                            r"http://127\.0\.0\.1:\d+", banner), banner
        port_no = int(banner.rsplit(":", 1)[1])
        got = _fetch(port_no, "GET", "/healthz")
        want = _fetch(servers["ref"], "GET", "/healthz")
        assert want[0] == 200 and (got[0], got[1]) == (
            want[0], want[1].replace(b'"alerts": "disabled"', b'"alerts": "ok"'))
        _s, body, _h = _fetch(port_no, "POST", "/regions",
                              {"regions": _panel(served), "limit": 0})
        assert _s == 200 and json.loads(body)["n"] == len(_panel(served))
        proc.send_signal(signal.SIGUSR1)
        time.sleep(1.0)
        assert _fetch(port_no, "GET", "/healthz")[0] == 200  # still serving
    finally:
        proc.send_signal(signal.SIGINT)
    assert proc.wait(timeout=60) == 0
    err = proc.stderr.read()
    assert "serve: shutting down" in err
    summary = json.loads(err.split("run summary ", 1)[1].splitlines()[0])
    assert summary["device"] == "cpu"
    assert summary["plain_calls"]["bits_spans_reference"]["cpu"] == 2
    so_far = err.split("counts so far ")
    assert len(so_far) == 2, err[-2000:]
    counts = json.loads(so_far[1].splitlines()[0])
    assert err.index("counts so far ") < err.index("serve: shutting down")
    for key in ("device", "launches", "plain_calls", "breaker"):
        assert counts[key] == summary[key], key


@pytest.mark.parametrize("flags,pattern", [
    # the fleet needs the aio front end (the reference's refusal)
    (["--frontend", "threaded", "--workers", "2"],
     "--workers > 1 requires the aio front end"),
    # --upserts, --follow and --maintain are ported; the reference's own
    # refusals of their combinations remain
    (["--frontend", "threaded", "--upserts", "--follow", "http://x"],
     "--follow and --upserts are mutually exclusive"),
    (["--frontend", "threaded", "--maintain"],
     "--maintain requires the aio front end"),
    (["--frontend", "threaded", "--metricsOut", "m.prom"], "--metricsOut"),
    (["--workers", "2", "--follow", "http://x", "--upserts"],
     "--follow and --upserts are mutually exclusive"),
    (["--maintain", "--follow", "http://x"],
     "--follow and --maintain are mutually exclusive"),
    (["--traceOut", "t.json"], "--traceOut"),
], ids=["workers", "upserts", "follow", "metricsOut", "aio-workers",
        "aio-maintain", "aio-traceOut"])
def test_cli_refuses_unported_modes(served, capsys, flags, pattern):
    from annotatedvdb_tpu_torch.cli.serve import main

    try:
        rc = main(["--storeDir", served["store"], "--port", "0", *flags])
    except SystemExit as exc:
        rc = exc.code
    assert rc == 2
    assert pattern in capsys.readouterr().err


def test_cli_defaults_to_cuda_and_never_falls_back(served, capsys):
    import torch

    from annotatedvdb_tpu_torch.cli.serve import main

    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    rc = main(["--storeDir", served["store"], "--port", "0",
               "--frontend", "threaded"])
    assert rc == 1
    assert "no CUDA device" in capsys.readouterr().err
