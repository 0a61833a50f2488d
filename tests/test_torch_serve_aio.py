"""The asyncio front end (``serve``'s default, ``serve/aio.py``): the
PyTorch port against the JAX package's aio server and the port's own
threaded server, on the CPU.

One store is built with the port's CLIs (``chip_smoke.build_serve_store``).
Both packages' aio servers (streaming threshold 50 rows) and the port's
threaded server answer the same requests: points, bulk, regions with
filters, paging walks, chunked region and ``/regions`` streams (the
de-chunked body equal to the threaded server's), ``/stats/region``,
``/export/stream``, health routes, bad bodies and bad ``Content-Length``;
every status and body must be the same bytes.  Also: pipelined answers in
request order, the 429 at the queue bound, ``submit_nowait`` completing on
the drain thread, the per-kind request counts, the loop batcher's burst
drains, the CLI's knob checks, and the weighted token buckets (held
against the reference's bucket and driven through an injected clock, no
sockets and no sleeps).
"""

import asyncio
import http.client
import json
import os
import re
import socket
import sys
import threading
import time

import pytest

from annotatedvdb_tpu.serve import aio as ref_aio
from annotatedvdb_tpu.serve.snapshot import SnapshotManager as RefManager

from annotatedvdb_tpu_torch.ops import intervals as port_intervals
from annotatedvdb_tpu_torch.ops import stats as port_stats
from annotatedvdb_tpu_torch.serve import aio
from annotatedvdb_tpu_torch.serve.batcher import QueryBatcher
from annotatedvdb_tpu_torch.serve.engine import QueryEngine
from annotatedvdb_tpu_torch.serve.http import build_server
from annotatedvdb_tpu_torch.serve.snapshot import SnapshotManager, StaticSnapshots
from annotatedvdb_tpu_torch.store import VariantStore

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke as smoke  # noqa: E402

#: region rows above which both aio servers stream chunked
THRESHOLD = 50

#: the reference routes the port does not serve yet, and the upsert route
#: (ported: 403 on a server started without ``--upserts``)
UNPORTED = (("GET", "/repl/manifest"), ("GET", "/repl/segment"),
            ("GET", "/repl/wal"), ("GET", "/alerts"),
            ("GET", "/metrics/history"), ("GET", "/debug/trace"),
            ("POST", "/variants/upsert"), ("POST", "/_chaos"))


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    return smoke.build_serve_store(str(tmp_path_factory.mktemp("aio")), "cpu")


@pytest.fixture(scope="module")
def servers(served):
    """The reference's aio server, the port's aio server and the port's
    threaded server over one store, each on port 0."""
    ref = ref_aio.build_aio_server(manager=RefManager(served["store"]), port=0,
                                   stream_threshold=THRESHOLD)
    port = aio.build_aio_server(manager=SnapshotManager(served["store"]), port=0,
                                stream_threshold=THRESHOLD, device="cpu")
    threaded = build_server(manager=SnapshotManager(served["store"]), port=0,
                            device="cpu")
    ref.start_background()
    port.start_background()
    t = threading.Thread(target=threaded.serve_forever, daemon=True)
    t.start()
    yield {"ref": ref.server_address[1], "port": port.server_address[1],
           "threaded": threaded.server_address[1], "port_server": port}
    for s in (ref, port):
        s.shutdown()
        s.ctx.batcher.close()
    threaded.shutdown()
    threaded.server_close()
    threaded.ctx.batcher.close()


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


def _same(servers, method, path, body=None, status=None, chunked=None):
    """The three servers' answers to one request: the same status, body
    and echoed trace id; both aio servers frame it alike."""
    hdr = {"X-Request-Id": "aio-1"}
    a = _fetch(servers["ref"], method, path, body, hdr)
    b = _fetch(servers["port"], method, path, body, hdr)
    c = _fetch(servers["threaded"], method, path, body, hdr)
    assert b[0] == a[0] == c[0], (path, a[1][:300], b[1][:300], c[1][:300])
    assert b[1] == a[1], path
    assert c[1] == a[1], path
    for got in (a, b, c):
        assert got[2].get("X-Request-Id") == "aio-1"
    te = b[2].get("Transfer-Encoding")
    assert te == a[2].get("Transfer-Encoding"), path
    if chunked is not None:
        assert (te == "chunked") is chunked, (path, te)
    if status is not None:
        assert a[0] == status, (path, a[1][:300])
    return a


def test_points_and_bulk_match_reference(servers, served):
    ids = served["ids"]
    for vid in ids[::61] + ["22:16000001:A:C", "3:100:A:C"]:
        _same(servers, "GET", f"/variant/{vid}")
    for bad in ("22:abc:A:C", "99:1:A:C", "22:5:A:Z", "22:0:A:C", "x"):
        _same(servers, "GET", f"/variant/{bad}", status=400)
    _same(servers, "POST", "/variants", {"ids": ids}, status=200)
    for bad in ({}, [1], {"ids": [1]}, {"ids": ids[:3] + ["22:x:A:C"]}):
        _same(servers, "POST", "/variants", bad, status=400)
    _same(servers, "POST", "/variants", b"not json", status=400)


def test_region_filters_paging_and_streaming_match_reference(servers, served):
    for spec in smoke.serve_panel(served, per_group=3, width=20_000, seed=29):
        for q in ("?limit=5", "?minCadd=20&limit=30", "?maxConseqRank=25&limit=0",
                  "?minCadd=&limit=7"):
            _same(servers, "GET", f"/region/{spec}{q}", status=200, chunked=False)
    p0 = int(served["pos22"][0])
    wide = f"22:{p0}-{p0 + 20_000}"
    # above the threshold the aio servers stream; de-chunked, the bytes
    # are the threaded server's buffered body
    _same(servers, "GET", f"/region/{wide}", status=200, chunked=True)
    _same(servers, "GET", f"/region/{wide}?minCadd=10&limit=400", status=200,
          chunked=True)
    tok, pages = "", 0
    while tok is not None:
        _s, body, _h = _same(servers, "GET",
                             f"/region/{wide}?limit=70&minCadd=10&cursor={tok}",
                             chunked=True)
        tok = json.loads(body)["next"]
        pages += 1
    assert pages >= 3
    for bad in ("22:5-1", "22:1-64000002", "22:1-10?limit=x", "zz:1-5",
                f"{wide}?limit=5&cursor=bogus", "22:10-20?minCadd=abc"):
        _same(servers, "GET", f"/region/{bad}", status=400)


def test_regions_and_stats_match_reference(servers, served):
    specs = smoke.serve_panel(served, seed=31)
    before = dict(port_intervals.CALLS), dict(port_stats.CALLS)
    _same(servers, "POST", "/regions", {"regions": specs, "limit": 0},
          status=200, chunked=False)
    _same(servers, "POST", "/regions", {"regions": specs, "limit": 5},
          status=200, chunked=True)
    _same(servers, "POST", "/regions",
          {"regions": specs, "limit": 2, "tokenize": True, "minCadd": 15},
          status=200, chunked=True)
    _same(servers, "POST", "/regions", {"regions": specs[:3], "limit": 4},
          status=200, chunked=False)
    for body in ({"regions": specs, "windows": 16},
                 {"regions": specs, "metrics": ["af"]},
                 {"regions": specs[:5], "metrics": ["cadd", "conseq"],
                  "windows": 3}):
        _same(servers, "POST", "/stats/region", body, status=200)
    # the port's aio and threaded servers each reached the device path
    # (the plain versions on the CPU) for both chromosome groups
    assert port_intervals.CALLS["cpu"] - before[0]["cpu"] == 2 * 3 * 2
    assert port_stats.CALLS["cpu"] > before[1]["cpu"]
    for path, body in (
            ("/regions", {"regions": "22:1-5"}),
            ("/regions", {"regions": specs, "limit": True}),
            ("/regions", {"regions": ["22:9-1"]}),
            ("/regions", {"regions": ["22:1-2"] * 4097}),
            ("/regions", b"nope"),
            ("/stats/region", {"regions": specs, "windows": 0}),
            ("/stats/region", {"regions": specs, "metrics": ["gc"]}),
            ("/stats/region", {"regions": ["22:1-2"] * 4097}),
            ("/stats/region", b"[1, 2]")):
        _same(servers, "POST", path, body, status=400)


def test_export_stream_matches_reference(servers, served):
    p0 = int(served["pos22"][0])
    for q in (f"region=22:{p0}-{p0 + 9000}&batch_rows=64",
              f"region=22:{p0}-{p0 + 9000}&batch_rows=64&batch=2&seed=3",
              f"region=22:{p0}-{p0 + 9000}&batch_rows=4096&ordered=1",
              "region=8:1-2000000&batch_rows=8&batch=5"):
        _same(servers, "GET", f"/export/stream?{q}", status=200)
    for bad in ("batch=0", f"region=22:{p0}-{p0 + 9}&batch_rows=7",
                "region=Q:1-5", ""):
        _same(servers, "GET", f"/export/stream?{bad}", status=400)


def _bad_content_length(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.putrequest("POST", path)
        conn.putheader("Content-Length", "abc")
        conn.endheaders()
        r = conn.getresponse()
        return r.status, r.read()
    finally:
        conn.close()


def test_health_routes_and_bad_content_length_match_reference(servers):
    for path in ("/healthz", "/readyz"):
        _same(servers, "GET", path, status=200)
    a = json.loads(_fetch(servers["ref"], "GET", "/stats")[1])
    b = json.loads(_fetch(servers["port"], "GET", "/stats")[1])
    assert sorted(b) == sorted(a)
    assert sorted(b["batcher"]) == sorted(a["batcher"])
    assert b["breaker"] == a["breaker"] and b["brownout"] == a["brownout"]
    for path in ("/variants", "/regions", "/stats/region", "/nope"):
        want = _bad_content_length(servers["ref"], path)
        assert _bad_content_length(servers["port"], path) == want, path
        if path != "/nope":
            assert want[0] == 400
            assert _bad_content_length(servers["threaded"], path) == want, path
    for method in ("PUT", "DELETE"):
        a = _fetch(servers["ref"], method, "/healthz")
        b = _fetch(servers["port"], method, "/healthz")
        assert (b[0], b[1]) == (a[0], a[1]) and a[0] == 501


@pytest.mark.parametrize("route", UNPORTED, ids=lambda r: r[1])
def test_unported_routes_answer_the_unknown_route_404(servers, route):
    method, path = route
    got = _fetch(servers["port"], method, path, b"{}")
    want = _fetch(servers["threaded"], method, path, b"{}")
    if path == "/variants/upsert":
        # ported: without a memtable all three servers refuse the write
        ref = _fetch(servers["ref"], method, path, b"{}")
        assert got[0] == want[0] == ref[0] == 403
        assert got[1] == want[1] == ref[1]
        return
    if path.startswith("/repl/"):
        # ported: all three serve the ship surface of the one store (the
        # ship document, its clock masked; an unnamed file is a 404)
        ref = _fetch(servers["ref"], method, path, b"{}")
        bodies = {re.sub(rb'"now": [0-9.e+-]+', b"", r[1])
                  for r in (got, want, ref)}
        assert got[0] == want[0] == ref[0] == (
            200 if path == "/repl/manifest" else 404)
        assert len(bodies) == 1
        return
    if path in ("/alerts", "/metrics/history"):
        # ported: servers built without a health plane (the reference's
        # own default context) answer the disabled views, fleet or not
        for query in ("", "?fleet=1"):
            answers = [_fetch(servers[k], method, path + query, b"{}")[:2]
                       for k in ("port", "threaded", "ref")]
            assert answers[0] == answers[1] == answers[2]
            assert answers[0][0] == 200
        assert json.loads(got[1])["enabled"] is False
        return
    assert got[0] == want[0] == 404
    assert got[1] == want[1] == json.dumps(
        {"error": f"no such route: {path}"}).encode()


def _pipelined(port, requests):
    """Send every request on one socket up front; return (status, body)
    in arrival order (Content-Length framed answers only)."""
    with socket.create_connection(("127.0.0.1", port), timeout=60) as sock:
        sock.sendall(b"".join(requests))
        buf, out = b"", []
        while len(out) < len(requests):
            chunk = sock.recv(1 << 16)
            assert chunk, "server closed mid-pipeline"
            buf += chunk
            while True:
                he = buf.find(b"\r\n\r\n")
                if he < 0:
                    break
                m = re.search(rb"Content-Length: (\d+)", buf[:he])
                n = int(m.group(1))
                if len(buf) < he + 4 + n:
                    break
                out.append((int(buf[9:12]), buf[he + 4:he + 4 + n]))
                buf = buf[he + 4 + n:]
    return out


def test_pipelined_answers_arrive_in_request_order(servers, served, monkeypatch):
    ids = served["ids"][::37][:40] + ["22:5:A:C", "x"]
    bulk = json.dumps({"ids": ids[:9]}).encode()
    reqs = []
    for i, vid in enumerate(ids):
        reqs.append(f"GET /variant/{vid} HTTP/1.1\r\nHost: t\r\n\r\n".encode())
        if i % 10 == 3:
            reqs.append(b"POST /variants HTTP/1.1\r\nHost: t\r\nContent-Length: "
                        + str(len(bulk)).encode() + b"\r\n\r\n" + bulk)
    want = _pipelined(servers["ref"], reqs)
    assert len(want) == len(reqs) and {s for s, _b in want} == {200, 404, 400}
    assert _pipelined(servers["port"], reqs) == want
    # a tiny coalescing buffer flushes mid-batch: same bytes, same order
    # (both servers get the traffic again, so their counts stay equal)
    monkeypatch.setattr(aio, "_WRITE_HIGH_WATER", 8)
    assert _pipelined(servers["port"], reqs) == _pipelined(servers["ref"], reqs)


def test_429_at_the_queue_bound_matches_reference(served):
    """``max_queue=0``: every point is over the batcher's bound and every
    bulk over the in-flight bound (which defaults to it)."""
    vid = served["ids"][3]
    ref = ref_aio.build_aio_server(manager=RefManager(served["store"]), port=0,
                                   max_queue=0)
    port = aio.build_aio_server(manager=SnapshotManager(served["store"]), port=0,
                                max_queue=0, device="cpu")
    for s in (ref, port):
        s.start_background()
    try:
        for method, path, body in (("GET", f"/variant/{vid}", None),
                                   ("POST", "/variants", {"ids": [vid]}),
                                   ("POST", "/regions", {"regions": ["22:1-9"]})):
            a = _fetch(ref.server_address[1], method, path, body)
            b = _fetch(port.server_address[1], method, path, body)
            assert (b[0], b[1]) == (a[0], a[1]) and a[0] == 429, path
            assert b[2].get("Retry-After") == a[2].get("Retry-After") == "1"
    finally:
        for s in (ref, port):
            s.shutdown()
            s.ctx.batcher.close()


def test_submit_nowait_completes_on_the_drain_thread(served):
    engine = QueryEngine(StaticSnapshots(VariantStore.load(served["store"],
                                                           readonly=True)),
                         device="cpu")
    batcher = QueryBatcher(engine, max_batch=16, max_wait_s=0.001)
    ids = served["ids"][:20]
    try:
        done, got = threading.Event(), {}

        def cb(pending):
            got[pending.qid] = (pending.result, pending.error,
                                threading.current_thread().name)
            if len(got) == len(ids):
                done.set()

        pendings = [batcher.submit_nowait(v, cb, want_event=False) for v in ids]
        assert all(p.done is None for p in pendings)  # no Event on this path
        assert done.wait(30)
        assert [got[v][0] for v in ids] == engine.lookup_many(ids)
        assert {got[v][1] for v in ids} == {None}
        assert {got[v][2] for v in ids} == {"avdb-serve-batcher"}
        # the blocking submit rides the same path
        assert batcher.submit(ids[0]) == engine.lookup(ids[0])
        with pytest.raises(ValueError):
            batcher.submit_nowait("22:x:A:C", cb)
    finally:
        batcher.close()


def test_aio_rides_a_thread_batcher_through_submit_nowait(served):
    """Given the thread-based batcher, the aio server submits points with
    ``submit_nowait`` and completes them through its bridge."""
    from annotatedvdb_tpu_torch.obs.metrics import MetricsRegistry
    from annotatedvdb_tpu_torch.serve.http import ServeContext

    engine = QueryEngine(SnapshotManager(served["store"]), device="cpu")
    registry = MetricsRegistry()
    batcher = QueryBatcher(engine, max_batch=8, max_wait_s=0.001,
                           registry=registry)
    server = aio.AioServer(ServeContext(SnapshotManager(served["store"]),
                                        engine, batcher, registry), port=0)
    assert not server._loop_batcher
    server.start_background()
    try:
        ids = served["ids"][:25] + ["22:5:A:C"]
        got = _pipelined(server.server_address[1], [
            f"GET /variant/{v} HTTP/1.1\r\nHost: t\r\n\r\n".encode() for v in ids])
        assert [b.decode() if s == 200 else None for s, b in got] \
            == engine.lookup_many(ids)
        # the drain thread counts a batch just after it completes the
        # batch's callers (as the reference's does): the last response
        # can arrive first
        deadline = time.monotonic() + 30
        while batcher.drain_stats()["queries"] < len(ids) \
                and time.monotonic() < deadline:
            time.sleep(0.01)
        assert batcher.drain_stats()["queries"] == len(ids)
    finally:
        server.shutdown()
        batcher.close()


def test_metrics_count_the_same_requests_per_kind(servers, served):
    _same(servers, "GET", f"/variant/{served['ids'][2]}")
    pat = re.compile(rb'^avdb_query_(requests|errors|rejected)_total\{kind="(\w+)"\} (\S+)$',
                     re.M)
    got = {key: sorted(pat.findall(_fetch(servers[key], "GET", "/metrics")[1]))
           for key in ("ref", "port")}
    kinds = {b"point", b"bulk", b"region", b"regions", b"stats", b"export",
             b"upsert"}
    assert [r for r in got["ref"] if r[1] in kinds] == got["port"]
    assert dict((k, float(v)) for c, k, v in got["port"] if c == b"requests")[b"point"] > 0


def test_loop_batcher_burst_leaves_no_orphan_drain():
    class _Engine:
        def lookup_many(self, ids, parsed=None):
            return [None] * len(ids)

    async def scenario():
        b = aio.LoopBatcher(_Engine(), max_batch=4, max_wait_s=30.0,
                            max_queue=64)
        loop = asyncio.get_running_loop()
        burst = [b.submit_future(f"1:{100 + i}:A:T") for i in range(5)]
        lone = []
        loop.call_soon(lambda: lone.append(b.submit_future("1:900:A:T")))
        for _ in range(4):
            await asyncio.sleep(0)
        assert all(f.done() for f in burst)
        assert lone and lone[0].done()
        assert b._batches == 2 and b.depth() == 0
        assert b._timer is None and not b._drain_soon
        b.close()

    asyncio.run(scenario())


# ------------------------------------------------------------ token buckets


class _Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


def test_token_bucket_matches_reference():
    """The bucket (its clock passed in explicitly in both packages): the
    same admissions, retry-after waits and debt under one schedule."""
    ref = ref_aio._TokenBucket(3.0, 4.0, 0.0)
    port = aio._TokenBucket(3.0, 4.0, 0.0)
    t = 0.0
    for step in range(200):
        t += (0.05, 0.0, 0.4, 0.013)[step % 4]
        assert port.take(t) == ref.take(t)
        if step % 17 == 5:
            port.charge(7.5)
            ref.charge(7.5)
        assert (port.tokens, port.t) == (ref.tokens, ref.t)
    port.charge(1e9)
    ref.charge(1e9)
    assert port.tokens == ref.tokens == -3.0 * aio.MAX_DEBT_S
    assert aio.MAX_DEBT_S == ref_aio.MAX_DEBT_S
    assert aio.ClientGovernor.PEER_KEY_CAP == ref_aio.ClientGovernor.PEER_KEY_CAP


def test_weighted_client_gets_its_share():
    clock = _Clock()
    gov = aio.ClientGovernor(10.0, clock=clock)
    heavy = sum(gov.admit("heavy", 4) == 0.0 for _ in range(200))
    light = sum(gov.admit("light", 1) == 0.0 for _ in range(200))
    # bursts: max(rate / 4, 4) tokens at 40/s and 10/s
    assert (heavy, light) == (10, 4)
    assert gov.admit("light", 1) == pytest.approx(0.1)  # one token at 10/s
    clock.t += 1.0
    heavy = sum(gov.admit("heavy", 4) == 0.0 for _ in range(200))
    light = sum(gov.admit("light", 1) == 0.0 for _ in range(200))
    assert (heavy, light) == (10, 4)  # refilled to the bursts, capped
    clock.t += 0.0625
    # weight 99 is clamped to 16: 160 tokens/s refill 10 in 1/16 s
    assert sum(gov.admit("heavy", 99) == 0.0 for _ in range(50)) == 10
    # the declared weight binds per request, clamped to 16
    assert gov._buckets["heavy"].rate == 160.0
    gov.admit("heavy", 1)
    assert gov._buckets["heavy"].rate == 10.0


def test_client_id_rotation_is_capped_per_peer():
    clock = _Clock()
    gov = aio.ClientGovernor(1.0, clock=clock)
    victim = gov.resolve_key("10.0.0.2", "steady")
    assert victim == "10.0.0.2|steady" and gov.admit(victim, 1) == 0.0
    admitted = 0
    for i in range(1000):
        key = gov.resolve_key("10.0.0.9", f"spray-{i}")
        admitted += gov.admit(key, 1) == 0.0
    cap = gov.PEER_KEY_CAP
    # one request on each of the first cap ids, then the peer's aggregate
    # bucket's burst of 4: the other ids share it
    assert admitted == cap + 4
    assert gov._peer_keys["10.0.0.9"] == cap
    assert gov.resolve_key("10.0.0.9", "spray-3") == "10.0.0.9|spray-3"
    assert gov.resolve_key("10.0.0.9", "new") == "10.0.0.9"
    assert gov.resolve_key("10.0.0.9", None) == "10.0.0.9"
    assert victim in gov._buckets


def test_bulk_is_charged_per_id():
    clock = _Clock()
    gov = aio.ClientGovernor(2.0, clock=clock)
    assert gov.bulk_budget(1) == 60 and gov.bulk_budget(40) == 960
    assert gov.admit("c", 1) == 0.0           # 3 tokens left of 4
    gov.charge("c", 59.0)                     # a 60-id bulk: 59 more
    assert gov._buckets["c"].tokens == -56.0
    wait = gov.admit("c", 1)
    assert wait == pytest.approx(57.0 / 2.0)  # repaid at 2 tokens/s
    clock.t += wait
    assert gov.admit("c", 1) == 0.0
    gov.charge("missing", 5.0)                # an evicted key forfeits


def test_cli_knob_checks(served, capsys, monkeypatch):
    from annotatedvdb_tpu_torch.cli.serve import main

    monkeypatch.delenv("AVDB_SERVE_CLIENT_RATE", raising=False)
    monkeypatch.delenv("AVDB_SERVE_STREAM_THRESHOLD", raising=False)
    missing = os.path.join(os.path.dirname(served["store"]), "no_store")
    rc = main(["--storeDir", missing, "--frontend", "threaded",
               "--clientRate", "10", "--streamThreshold", "5",
               "--platform", "cpu"])
    assert rc == 1
    err = capsys.readouterr().err
    assert "--clientRate, --streamThreshold only apply to the aio front end " \
           "and are ignored with --frontend threaded" in err
    rc = main(["--storeDir", missing, "--clientRate", "10", "--platform", "cpu"])
    assert rc == 1
    assert "ignored" not in capsys.readouterr().err
    monkeypatch.setenv("AVDB_SERVE_BATCH_MAX", "abc")
    for frontend in ("aio", "threaded"):
        rc = main(["--storeDir", served["store"], "--port", "0", "--frontend",
                   frontend, "--platform", "cpu"])
        assert rc == 1
        assert "serve: cannot start" in capsys.readouterr().err
    # a fleet worker's heartbeat slot: a missing file is logged and the
    # worker serves unwatched (the reference's behaviour); a real one maps
    monkeypatch.delenv("AVDB_SERVE_BATCH_MAX")
    lines = []
    server = aio.build_aio_server(
        store_dir=served["store"], device="cpu", log=lines.append,
        heartbeat_file=os.path.join(os.path.dirname(served["store"]), "hb"))
    assert server._hb_mm is None
    assert any("heartbeat file unusable" in ln for ln in lines), lines
    server.ctx.batcher.close()
    hb = os.path.join(os.path.dirname(served["store"]), "hb2")
    with open(hb, "wb") as f:
        f.write(b"\0" * 48)
    server = aio.build_aio_server(store_dir=served["store"], device="cpu",
                                  heartbeat_file=hb, heartbeat_index=1)
    assert server._hb_mm is not None and server.heartbeat_index == 1
    server._hb_mm.close()
    server.ctx.batcher.close()
