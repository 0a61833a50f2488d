"""The live write path (``serve --upserts``): the PyTorch port against the
JAX package, on the CPU.

One small store (three chr3 SNVs with real identity hashes, one with a
CADD annotation) is written by the reference and copied, so each package
serves its own copy of the same bytes.  Each package runs both front ends
over its copy, each front end with its own memtable and WAL (the fleet's
shape: per-worker write state, one shared read generation), and the same
requests go to all four servers: acknowledgements, read-your-writes
through every read path (points, bulk, regions with filters, ``/regions``,
``/stats/region``), first-wins shadowing, a cursor walk across an upsert,
the 403 with upserts off, the grammar 400s, metrics, the flush (read
bytes unchanged, WAL truncated, segment files, manifests, WAL files and
ledger records equal to the reference's), strictly increasing
generations, a WAL replay after a kill, and a loader whose save adopts a
concurrent flush while an undo still drops its own rows (store bytes equal
to the reference's).  Every body is compared byte for byte.
"""

import json
import os
import re
import shutil
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from annotatedvdb_tpu.loaders.lookup import identity_hashes as ref_identity_hashes
from annotatedvdb_tpu.obs.metrics import MetricsRegistry as RefRegistry
from annotatedvdb_tpu.serve import MemtableSnapshots as RefOverlay
from annotatedvdb_tpu.serve import QueryEngine as RefEngine
from annotatedvdb_tpu.serve import QueryError as RefQueryError
from annotatedvdb_tpu.serve import SnapshotManager as RefManager
from annotatedvdb_tpu.serve import StaticSnapshots as RefStatic
from annotatedvdb_tpu.serve import http as ref_http
from annotatedvdb_tpu.serve.aio import build_aio_server as ref_build_aio
from annotatedvdb_tpu.store import VariantStore as RefStore
from annotatedvdb_tpu.store import memtable as ref_memtable
from annotatedvdb_tpu.store import wal as ref_wal
from annotatedvdb_tpu.types import encode_allele_array as ref_encode

from annotatedvdb_tpu_torch.obs.metrics import MetricsRegistry
from annotatedvdb_tpu_torch.serve import http
from annotatedvdb_tpu_torch.serve.aio import build_aio_server
from annotatedvdb_tpu_torch.serve.engine import QueryEngine, QueryError
from annotatedvdb_tpu_torch.serve.snapshot import (
    MemtableSnapshots,
    SnapshotManager,
    StaticSnapshots,
)
from annotatedvdb_tpu_torch.store import VariantStore, memtable, wal
from annotatedvdb_tpu_torch.store.ledger import AlgorithmLedger
from annotatedvdb_tpu_torch.store.variant_store import Segment
from annotatedvdb_tpu_torch.types import encode_allele_array

WIDTH = 8
QUIET = dict(log=lambda m: None)


def _seed_store() -> RefStore:
    """Three chr3 A->C SNVs (pos 10/20/30) with real identity hashes and
    a CADD annotation on the middle one, stamped with invocation 9."""
    store = RefStore(width=WIDTH)
    ref, ref_len = ref_encode(["A"] * 3, WIDTH)
    alt, alt_len = ref_encode(["C"] * 3, WIDTH)
    store.shard(3).append(
        {"pos": np.asarray([10, 20, 30], np.int32),
         "h": ref_identity_hashes(WIDTH, ref, alt, ref_len, alt_len),
         "ref_len": ref_len, "alt_len": alt_len,
         "row_algorithm_id": np.asarray([9, 9, 9], np.int32)},
        ref, alt,
        annotations={"cadd_scores": [None, {"CADD_phred": 22.5}, None]},
    )
    return store


def _two_copies(tmp_path):
    """The seeded store written once by the reference, copied: (the
    reference's directory, the port's directory)."""
    ref_dir = str(tmp_path / "ref")
    _seed_store().save(ref_dir)
    port_dir = str(tmp_path / "port")
    shutil.copytree(ref_dir, port_dir)
    return ref_dir, port_dir


def _request(port, method, path, body=None, timeout=30):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", method=method,
        data=(body if isinstance(body, bytes) else json.dumps(body).encode())
        if body is not None else None,
    )
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as err:
        return err.code, err.read()


def _files(store_dir, masked=("ledger.jsonl",)):
    """{name: bytes} of every file in a store directory (the ledger's
    timestamps and flush seconds masked)."""
    out = {}
    for name in sorted(os.listdir(store_dir)):
        with open(os.path.join(store_dir, name), "rb") as f:
            blob = f.read()
        if name in masked:
            blob = re.sub(rb'"(ts|seconds)": [0-9.e+-]+', rb'"\1": 0', blob)
        out[name] = blob
    return out


class _Pair:
    """One package's two front ends over one store directory, each with
    its own memtable and WAL (``serve-t``, ``serve-a``)."""

    def __init__(self, pkg, store_dir):
        self.store_dir = store_dir
        self.servers = []
        if pkg == "ref":
            registry, manager, table, log_ = RefRegistry, RefManager, \
                ref_memtable.Memtable, ref_wal.WriteAheadLog
            overlay, threaded, aio = RefOverlay, ref_http.build_server, \
                ref_build_aio
            kw = {}
        else:
            registry, manager, table, log_ = MetricsRegistry, SnapshotManager, \
                memtable.Memtable, wal.WriteAheadLog
            overlay, threaded, aio = MemtableSnapshots, http.build_server, \
                build_aio_server
            kw = {"device": "cpu"}
        for tag, build in (("t", threaded), ("a", aio)):
            reg = registry()
            mgr = manager(store_dir, **QUIET)
            mem = table(width=WIDTH, store_dir=store_dir,
                        wal=log_(store_dir, f"serve-{tag}", **QUIET),
                        registry=reg, **QUIET)
            srv = build(manager=overlay(mgr, mem), port=0, memtable=mem,
                        registry=reg, **kw)
            setattr(self, f"mem_{tag}", mem)
            setattr(self, f"mgr_{tag}", mgr)
            setattr(self, f"ctx_{tag}", srv.ctx)
            self.servers.append(srv)
        httpd, aiosrv = self.servers
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        aiosrv.start_background()
        self.pt = httpd.server_address[1]
        self.pa = aiosrv.server_address[1]

    def close(self):
        httpd, aiosrv = self.servers
        aiosrv.shutdown()
        aiosrv.ctx.batcher.close()
        httpd.shutdown()
        httpd.server_close()
        httpd.ctx.batcher.close()


@pytest.fixture()
def quad(tmp_path):
    """Both packages' front-end pairs over byte-equal copies of one
    store."""
    ref_dir, port_dir = _two_copies(tmp_path)
    ref = _Pair("ref", ref_dir)
    port = _Pair("port", port_dir)
    yield {"ref": ref, "port": port}
    port.close()
    ref.close()


def _all_four(quad, method, path, body=None, fronts=("t", "a")):
    """The same request to the port's and the reference's servers (both
    front ends each): one status and one body, returned."""
    got = []
    for pkg in ("ref", "port"):
        for front in fronts:
            got.append(_request(getattr(quad[pkg], "p" + front), method,
                                path, body))
    assert len({g[0] for g in got}) == 1, (path, got)
    assert len({g[1] for g in got}) == 1, (path, got)
    return got[0]


UPSERT_BODY = {"variants": [
    {"id": "3:15:A:G", "ref_snp": 42,
     "annotations": {"cadd_scores": {"CADD_phred": 31.0},
                     "other_annotation": {"src": "live"}}},
    {"id": "3:25:AT:A"},
]}

READS = [
    ("GET", "/variant/3:15:A:G", None),
    ("GET", "/variant/3:25:AT:A", None),
    ("GET", "/variant/3:20:A:C", None),
    ("POST", "/variants",
     {"ids": ["3:15:A:G", "3:25:AT:A", "3:10:A:C", "3:99:A:C"]}),
    ("GET", "/region/3:1-100", None),
    ("GET", "/region/3:1-100?minCadd=30", None),
    ("POST", "/regions", {"regions": ["3:1-100", "3:14-16"]}),
    ("POST", "/regions", {"regions": ["3:1-100"], "limit": 0,
                          "tokenize": True}),
    ("POST", "/stats/region", {"regions": ["3:1-100", "3:12-26"],
                               "windows": 2}),
]


# ---------------------------------------------------------------------------
# WAL: both packages' files


def _wal_pair(d, name="serve-w0"):
    return (ref_wal.WriteAheadLog(os.path.join(d, "ref"), name, **QUIET),
            wal.WriteAheadLog(os.path.join(d, "port"), name, **QUIET))


@pytest.fixture()
def wal_dirs(tmp_path):
    for sub in ("ref", "port"):
        os.makedirs(tmp_path / sub)
    return str(tmp_path)


def test_wal_roundtrip_and_rotation_match_reference(wal_dirs):
    for w in _wal_pair(wal_dirs):
        w.append({"rows": [{"a": 1}]})
        w.append({"rows": [{"b": 2}]})
        assert w.rotate() == 1
        w.append({"rows": [{"c": 3}]})
    assert _files(os.path.join(wal_dirs, "port")) \
        == _files(os.path.join(wal_dirs, "ref"))
    fresh = _wal_pair(wal_dirs)
    want = [{"rows": [{"a": 1}]}, {"rows": [{"b": 2}]}, {"rows": [{"c": 3}]}]
    assert [list(w.replay_records()) for w in fresh] == [want, want]
    # each package replays the other's files
    ref_dir, port_dir = (os.path.join(wal_dirs, s) for s in ("ref", "port"))
    assert list(wal.WriteAheadLog(ref_dir, "serve-w0", **QUIET)
                .replay_records()) == want
    # a fresh incarnation's rotation seals both earlier files; discard
    # removes exactly those
    port_w = wal.WriteAheadLog(port_dir, "serve-w0", **QUIET)
    ref_w = ref_wal.WriteAheadLog(ref_dir, "serve-w0", **QUIET)
    assert port_w.rotate() == ref_w.rotate() == 3
    assert port_w.discard_sealed() == ref_w.discard_sealed() == 2
    assert _files(port_dir) == _files(ref_dir)
    assert list(wal.WriteAheadLog(port_dir, "serve-w0", **QUIET)
                .replay_records()) == []


@pytest.mark.parametrize("damage", ["torn_tail", "corrupt_frame",
                                    "alien_header"])
def test_wal_damage_drops_what_the_reference_drops(wal_dirs, damage):
    for w in _wal_pair(wal_dirs):
        w.append({"k": 1})
        w.append({"k": 2})
        w.close()
        path = w.pending_files()[0][1]
        blob = bytearray(open(path, "rb").read())
        if damage == "torn_tail":
            blob = blob[:-5]
        elif damage == "corrupt_frame":
            blob[-3] ^= 0xFF
        else:
            blob[:5] = b"nope\n"
        open(path, "wb").write(bytes(blob))
    ref_w, port_w = _wal_pair(wal_dirs)
    want = list(ref_w.replay_records())
    assert list(port_w.replay_records()) == want
    assert want == ([] if damage == "alien_header" else [{"k": 1}])
    path = port_w.pending_files()[0][1]
    assert wal.count_records(path) == ref_wal.count_records(path) \
        == len(want)


def test_wal_close_and_per_worker_names_match_reference(wal_dirs):
    for w in _wal_pair(wal_dirs):
        w.append({"k": 1})
        w.rotate()  # the active file is now header-only
        w.close(remove_if_empty=True)
        assert len(w.pending_files()) == 1
    for sub, mod in (("ref", ref_wal), ("port", wal)):
        d = os.path.join(wal_dirs, sub)
        mod.WriteAheadLog(d, "serve-w1", **QUIET).append({"w": 1})
        assert list(mod.WriteAheadLog(d, "serve-w0", **QUIET)
                    .replay_records()) == [{"k": 1}]
        assert list(mod.WriteAheadLog(d, "serve-w1", **QUIET)
                    .replay_records()) == [{"w": 1}]
    assert _files(os.path.join(wal_dirs, "port")) \
        == _files(os.path.join(wal_dirs, "ref"))
    assert sorted(os.listdir(os.path.join(wal_dirs, "port"))) \
        == ["serve-w0.000001.wal", "serve-w1.000001.wal"]


# ---------------------------------------------------------------------------
# body grammar


@pytest.mark.parametrize("body", [
    json.dumps(UPSERT_BODY).encode(),
    b'{"variants": [{"id": "3:15:A:G", "ref_snp": 0, "annotations": {}}]}',
    b"not json",
    b"[]",
    b"{}",
    b'{"variants": []}',
    b'{"variants": ["3:15:A:G"]}',
    b'{"variants": [{"id": 7}]}',
    b'{"variants": [{"id": "3:15:A:G", "ref_snp": -1}]}',
    b'{"variants": [{"id": "3:15:A:G", "ref_snp": true}]}',
    b'{"variants": [{"id": "3:15:A:G", "annotations": ["x"]}]}',
    b'{"variants": [{"id": "3:15:A:G", "annotations": {"nope": 1}}]}',
    json.dumps({"variants": [{"id": "3:10:A:C"}]
                * (http.UPSERT_MAX_ROWS + 1)}).encode(),
    json.dumps({"variants": [{"id": "3:10:A:C"}]
                * http.UPSERT_MAX_ROWS}).encode(),
], ids=["canonical", "empty-annotations", "not-json", "list", "no-variants",
        "empty", "bare-id", "int-id", "negative-rs", "bool-rs",
        "list-annotations", "unknown-column", "over-cap", "at-cap"])
def test_parse_upsert_body_matches_reference(body):
    assert http.UPSERT_MAX_ROWS == ref_http.UPSERT_MAX_ROWS
    try:
        want = ref_http.parse_upsert_body(body)
    except RefQueryError as err:
        with pytest.raises(QueryError) as got:
            http.parse_upsert_body(body)
        assert str(got.value) == str(err)
        return
    assert http.parse_upsert_body(body) == want


# ---------------------------------------------------------------------------
# read-your-writes, both front ends, both packages


def test_upsert_read_your_writes_parity_both_front_ends(quad):
    for front in ("t", "a"):
        for pkg in ("ref", "port"):
            status, body = _request(getattr(quad[pkg], "p" + front), "POST",
                                    "/variants/upsert", UPSERT_BODY)
            assert status == 200, body
            assert json.loads(body)["accepted"] == 2
    for method, path, body in READS:
        status, got = _all_four(quad, method, path, body)
        assert status == 200, (path, got)
    _s, region = _request(quad["port"].pt, "GET", "/region/3:1-100")
    assert json.loads(region)["count"] == 5
    _s, rec = _request(quad["port"].pt, "GET", "/variant/3:15:A:G")
    assert b'"rs42"' in rec and b'"src": "live"' in rec


def test_upsert_shadowed_by_loaded_row_first_wins(quad):
    _s, before = _all_four(quad, "GET", "/variant/3:20:A:C")
    status, body = _all_four(quad, "POST", "/variants/upsert", {"variants": [
        {"id": "3:20:A:C",
         "annotations": {"other_annotation": {"hijack": True}}},
    ]})
    assert status == 200
    assert json.loads(body)["shadowed"] == 1
    assert json.loads(body)["accepted"] == 0
    _s, after = _all_four(quad, "GET", "/variant/3:20:A:C")
    assert after == before
    # the same identity twice in one batch: the first occurrence wins
    status, body = _all_four(quad, "POST", "/variants/upsert", {"variants": [
        {"id": "3:40:A:G", "ref_snp": 1},
        {"id": "3:40:A:G", "ref_snp": 2},
    ]})
    assert json.loads(body)["accepted"] == 1
    assert json.loads(body)["shadowed"] == 1
    _s, rec = _all_four(quad, "GET", "/variant/3:40:A:G")
    assert b'"rs1"' in rec


def test_upsert_visible_through_concurrent_cursor_walk(quad):
    status, page1 = _all_four(quad, "GET", "/region/3:1-100?limit=1&cursor=",
                              fronts=("t",))
    env1 = json.loads(page1)
    assert status == 200 and env1["count"] == 3 and env1["next"]
    _all_four(quad, "POST", "/variants/upsert",
              {"variants": [{"id": "3:25:AT:A"}]}, fronts=("t",))
    seen = [v["position"] for v in env1["variants"]]
    cursor = env1["next"]
    while cursor:
        _s, page = _all_four(
            quad, "GET", f"/region/3:1-100?limit=1&cursor={cursor}",
            fronts=("t",))
        env = json.loads(page)
        assert env["count"] == 4
        seen += [v["position"] for v in env["variants"]]
        cursor = env["next"]
    assert seen == [10, 20, 25, 30]


def test_upserts_disabled_route_403_parity(tmp_path):
    ref_dir, port_dir = _two_copies(tmp_path)
    servers = [ref_http.build_server(store_dir=ref_dir, port=0),
               http.build_server(store_dir=port_dir, port=0, device="cpu")]
    for s in servers:
        threading.Thread(target=s.serve_forever, daemon=True).start()
    aios = [ref_build_aio(store_dir=ref_dir, port=0),
            build_aio_server(store_dir=port_dir, port=0, device="cpu")]
    for a in aios:
        a.start_background()
    try:
        got = {_request(s.server_address[1], "POST", "/variants/upsert",
                        UPSERT_BODY) for s in servers + aios}
        assert len(got) == 1
        status, body = got.pop()
        assert status == 403 and b"not enabled" in body
    finally:
        for a in aios:
            a.shutdown()
            a.ctx.batcher.close()
        for s in servers:
            s.shutdown()
            s.server_close()
            s.ctx.batcher.close()


def test_upsert_grammar_errors_are_parity_400s(quad):
    for body in ({"nope": 1},
                 {"variants": [{"id": "3:15:A:G",
                                "annotations": {"bogus": 1}}]},
                 {"variants": [{"id": "not-an-id"}]},
                 {"variants": [{"id": "3:15:" + "A" * 20 + ":G"}]},
                 b"{bad json"):
        status, _b = _all_four(quad, "POST", "/variants/upsert", body)
        assert status == 400, body


def _metric_lines(registry, names):
    """The exposition lines of the named series (``avdb_upsert_ack_seconds``
    by its count only: the latencies themselves differ)."""
    return sorted(
        line for line in registry.render_prometheus().splitlines()
        if line.split("{")[0].split(" ")[0] in names
    )


def test_upsert_metrics_move(quad):
    for pkg in ("ref", "port"):
        _request(quad[pkg].pa, "POST", "/variants/upsert", {"variants": [
            {"id": "3:60:A:G"}, {"id": "3:10:A:C"}]})
    names = {"avdb_upsert_requests_total", "avdb_upsert_rows_total",
             "avdb_upsert_rejected_total", "avdb_upsert_wal_bytes_total",
             "avdb_memtable_bytes", "avdb_upsert_ack_seconds_count",
             "avdb_upsert_flushes_total", "avdb_upsert_disk_shed_total",
             "avdb_query_requests_total", "avdb_query_errors_total",
             "avdb_query_rejected_total"}
    got = {pkg: _metric_lines(quad[pkg].ctx_a.registry, names)
           for pkg in quad}
    assert got["port"] == got["ref"]
    assert "avdb_upsert_rows_total 1.0" in got["port"] \
        or "avdb_upsert_rows_total 1" in got["port"], got["port"]
    assert any(line.startswith('avdb_query_requests_total{kind="upsert"} 1')
               for line in got["port"]), got["port"]
    assert any(line.startswith("avdb_upsert_rejected_total 1")
               for line in got["port"]), got["port"]
    for pkg in ("ref", "port"):
        assert quad[pkg].mem_a.flush(
            base_manager=quad[pkg].mgr_a)["status"] == "flushed"
    got = {pkg: _metric_lines(quad[pkg].ctx_a.registry, names)
           for pkg in quad}
    assert got["port"] == got["ref"]
    assert any(line.startswith("avdb_upsert_flushes_total 1")
               for line in got["port"]), got["port"]
    assert any(line.startswith("avdb_memtable_bytes 0")
               for line in got["port"]), got["port"]


# ---------------------------------------------------------------------------
# flush


def test_flush_matches_reference_and_truncates_wal(quad):
    _all_four(quad, "POST", "/variants/upsert", UPSERT_BODY, fronts=("t",))
    before = [_all_four(quad, m, p, b, fronts=("t",)) for m, p, b in READS]
    wal_before = {pkg: _files(quad[pkg].store_dir) for pkg in quad}
    assert wal_before["port"] == wal_before["ref"]
    assert "serve-t.000001.wal" in wal_before["port"]
    results = {pkg: quad[pkg].mem_t.flush(base_manager=quad[pkg].mgr_t)
               for pkg in quad}
    for pkg in quad:
        assert results[pkg]["status"] == "flushed" \
            and results[pkg]["finalized"], results[pkg]
        assert quad[pkg].mem_t.rows == 0
    drop = ("seconds", "fingerprint")
    assert {k: v for k, v in results["port"].items() if k not in drop} \
        == {k: v for k, v in results["ref"].items() if k not in drop}
    after = [_all_four(quad, m, p, b, fronts=("t",)) for m, p, b in READS]

    def scrub(pairs):
        return [(s, re.sub(rb'"generation":\d+', b'"generation":G', b))
                for s, b in pairs]

    assert scrub(before) == scrub(after)
    # segment files, manifest, WAL files and the ledger's flush record:
    # the reference's bytes
    files = {pkg: _files(quad[pkg].store_dir) for pkg in quad}
    assert files["port"] == files["ref"]
    assert "serve-t.000001.wal" not in files["port"]
    assert json.loads(files["port"]["manifest.json"])["stats"]["rows"] \
        == {"3": 5}
    flushes = AlgorithmLedger(os.path.join(quad["port"].store_dir,
                                           "ledger.jsonl"), **QUIET).flushes()
    assert flushes[-1]["rows"] == 2 and flushes[-1]["labels"] == ["3"]
    # a fresh worker replays nothing: the store holds every row
    fresh = memtable.Memtable(
        width=WIDTH, store_dir=quad["port"].store_dir,
        wal=wal.WriteAheadLog(quad["port"].store_dir, "serve-t", **QUIET),
        **QUIET)
    assert fresh.replay(VariantStore.load(quad["port"].store_dir,
                                          readonly=True)) == 0


def test_generation_strictly_increases_across_upserts_and_flush(quad):
    gens = {pkg: [] for pkg in quad}

    def healthz_gen(pkg):
        _s, b = _request(quad[pkg].pt, "GET", "/healthz")
        gens[pkg].append(json.loads(b)["generation"])

    for pkg in quad:
        healthz_gen(pkg)
    for k in range(3):
        _all_four(quad, "POST", "/variants/upsert",
                  {"variants": [{"id": f"3:{50 + k}:A:G"}]}, fronts=("t",))
        for pkg in quad:
            healthz_gen(pkg)
    for pkg in quad:
        assert quad[pkg].mem_t.flush(
            base_manager=quad[pkg].mgr_t)["status"] == "flushed"
        healthz_gen(pkg)
    assert gens["port"] == gens["ref"]
    g = gens["port"]
    assert g == sorted(g) and len(set(g)) == len(g), g


def test_flush_triggers_and_env_knobs(tmp_path, monkeypatch):
    _ref_dir, store_dir = _two_copies(tmp_path)
    base = VariantStore.load(store_dir, readonly=True)
    row = {"code": 3, "pos": 15, "ref": "A", "alt": "G", "ref_snp": None,
           "ann": None}
    mem = memtable.Memtable(width=WIDTH, store_dir=store_dir, flush_bytes=1,
                            flush_age_s=0, **QUIET)
    assert not mem.should_flush()
    mem.upsert(base, [row])
    assert mem.should_flush()
    mem2 = memtable.Memtable(width=WIDTH, store_dir=store_dir, flush_bytes=0,
                             flush_age_s=0.05, **QUIET)
    mem2.upsert(base, [dict(row, pos=16)])
    assert not mem2.should_flush()
    time.sleep(0.08)
    assert mem2.should_flush()
    for name, value in (("AVDB_MEMTABLE_BYTES", "64m"),
                        ("AVDB_MEMTABLE_BYTES", "64mb"),
                        ("AVDB_MEMTABLE_BYTES", "off"),
                        ("AVDB_MEMTABLE_FLUSH_S", "2.5"),
                        ("AVDB_MEMTABLE_FLUSH_S", "soon"),
                        ("AVDB_MEMTABLE_FLUSH_S", "-3")):
        monkeypatch.setenv(name, value)
        for fn in ("flush_bytes_from_env", "flush_age_from_env"):
            try:
                want = getattr(ref_memtable, fn)()
            except ValueError as err:
                with pytest.raises(ValueError) as got:
                    getattr(memtable, fn)()
                assert str(got.value) == str(err)
                continue
            assert getattr(memtable, fn)() == want


def test_overlay_is_passthrough_until_first_upsert(tmp_path):
    _ref_dir, store_dir = _two_copies(tmp_path)
    mgr = SnapshotManager(store_dir, **QUIET)
    mem = memtable.Memtable(width=WIDTH, store_dir=store_dir, **QUIET)
    prov = MemtableSnapshots(mgr, mem)
    snap = prov.current()
    assert snap is mgr.current()
    mem.upsert(VariantStore.load(store_dir, readonly=True),
               [{"code": 3, "pos": 15, "ref": "A", "alt": "G",
                 "ref_snp": None, "ann": None}])
    over = prov.current()
    assert over is not snap and over.generation > snap.generation
    assert over.store.n == 4
    assert prov.current() is over


def test_replayed_worker_serves_acked_rows_byte_identical(tmp_path):
    """Worker A acks rows and dies (its memtable abandoned); worker B
    replays the WAL and serves the same bytes — and the reference's."""
    ref_dir, store_dir = _two_copies(tmp_path)
    rows = [
        {"code": 3, "pos": 15, "ref": "A", "alt": "G", "ref_snp": 42,
         "ann": {"other_annotation": {"k": [1, 2]}}},
        {"code": 3, "pos": 25, "ref": "AT", "alt": "A", "ref_snp": None,
         "ann": None},
    ]

    def reads(engine):
        return [engine.lookup("3:15:A:G"), engine.lookup("3:25:AT:A"),
                engine.region("3:1-100"),
                engine.regions_serve(["3:1-100", "3:14-26"],
                                     limit=10).assemble()]

    base = VariantStore.load(store_dir, readonly=True)
    mem_a = memtable.Memtable(
        width=WIDTH, store_dir=store_dir,
        wal=wal.WriteAheadLog(store_dir, "serve-w0", **QUIET), **QUIET)
    assert mem_a.upsert(base, rows)[0] == 2
    want = reads(QueryEngine(MemtableSnapshots(StaticSnapshots(base), mem_a),
                             region_cache_size=0, device="cpu"))
    mem_b = memtable.Memtable(
        width=WIDTH, store_dir=store_dir,
        wal=wal.WriteAheadLog(store_dir, "serve-w0", **QUIET), **QUIET)
    assert mem_b.replay(base) == 2
    got = reads(QueryEngine(MemtableSnapshots(StaticSnapshots(base), mem_b),
                            region_cache_size=0, device="cpu"))
    assert got == want
    # the reference replays the port's WAL into the same answers
    ref_base = RefStore.load(ref_dir, readonly=True)
    shutil.copy(os.path.join(store_dir, "serve-w0.000001.wal"), ref_dir)
    ref_mem = ref_memtable.Memtable(
        width=WIDTH, store_dir=ref_dir,
        wal=ref_wal.WriteAheadLog(ref_dir, "serve-w0", **QUIET), **QUIET)
    assert ref_mem.replay(ref_base) == 2
    assert reads(RefEngine(RefOverlay(RefStatic(ref_base), ref_mem),
                           region_cache_size=0)) == want


# ---------------------------------------------------------------------------
# cooperative writers: a loader's save adopts a concurrent flush


def _append_row(store, encode, hashes, pos):
    ref, ref_len = encode(["A"], WIDTH)
    alt, alt_len = encode(["G"], WIDTH)
    rows = {"pos": np.asarray([pos], np.int32),
            "h": hashes(WIDTH, ref, alt, ref_len, alt_len),
            "ref_len": ref_len, "alt_len": alt_len}
    shard = store.shard(3)
    if hasattr(shard, "append"):
        shard.append(rows, ref, alt)
    else:
        shard.append_segment(Segment.build(rows, ref, alt))
        shard.maintain()


def test_loader_save_adopts_concurrent_flush_groups(tmp_path):
    """A loader that loaded the store before a memtable flush committed
    (whose WAL was then truncated) saves twice on its stale view: the
    flushed rows survive both saves, and each package leaves the same
    bytes."""
    from annotatedvdb_tpu.loaders.lookup import identity_hashes as ref_hashes
    from annotatedvdb_tpu_torch.loaders.lookup import identity_hashes

    dirs = dict(zip(("ref", "port"), _two_copies(tmp_path)))
    mods = {
        "ref": (RefStore, ref_memtable, ref_wal, ref_encode, ref_hashes),
        "port": (VariantStore, memtable, wal, encode_allele_array,
                 identity_hashes),
    }
    answers = {}
    for pkg, (store_cls, mt, wl, encode, hashes) in mods.items():
        d = dirs[pkg]
        loader_store = store_cls.load(d)
        mem = mt.Memtable(width=WIDTH, store_dir=d,
                          wal=wl.WriteAheadLog(d, "serve-w0", **QUIET),
                          **QUIET)
        accepted, _s, _b = mem.upsert(store_cls.load(d, readonly=True), [
            {"code": 3, "pos": 15, "ref": "A", "alt": "G", "ref_snp": 7,
             "ann": {"other_annotation": {"live": True}}}])
        assert accepted == 1
        assert mem.flush(base_manager=None)["status"] == "flushed"
        _append_row(loader_store, encode, hashes, 40)
        loader_store.save(d)
        _append_row(loader_store, encode, hashes, 50)
        loader_store.save(d)
        final = store_cls.load(d)
        assert final.shard(3).n == 6, pkg
        answers[pkg] = final
    assert _files(dirs["port"]) == _files(dirs["ref"])
    engine = QueryEngine(StaticSnapshots(answers["port"]),
                         region_cache_size=0, device="cpu")
    ref_engine = RefEngine(RefStatic(answers["ref"]), region_cache_size=0)
    for vid in ("3:15:A:G", "3:40:A:G", "3:50:A:G", "3:20:A:C"):
        assert engine.lookup(vid) == ref_engine.lookup(vid)
    assert '"live": true' in engine.lookup("3:15:A:G")


def test_undo_still_drops_rows_despite_adoption(tmp_path):
    """Adoption never resurrects rows an undo deleted: groups below the
    load-time floor are the store's own — and a flushed group above it
    survives the undo's save."""
    dirs = dict(zip(("ref", "port"), _two_copies(tmp_path)))
    for pkg, (store_cls, mt, wl) in {
        "ref": (RefStore, ref_memtable, ref_wal),
        "port": (VariantStore, memtable, wal),
    }.items():
        d = dirs[pkg]
        undoer = store_cls.load(d)
        mem = mt.Memtable(width=WIDTH, store_dir=d,
                          wal=wl.WriteAheadLog(d, "serve-w0", **QUIET),
                          **QUIET)
        mem.upsert(store_cls.load(d, readonly=True), [
            {"code": 3, "pos": 15, "ref": "A", "alt": "G", "ref_snp": 7,
             "ann": None}])
        assert mem.flush(base_manager=None)["status"] == "flushed"
        assert undoer.delete_by_algorithm(9) == 3
        undoer.save(d)
        assert store_cls.load(d).n == 1, pkg
    assert _files(dirs["port"]) == _files(dirs["ref"])
