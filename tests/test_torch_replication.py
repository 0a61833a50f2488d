"""Replication (``serve --follow``, the ``/repl/*`` ship surface, ``doctor
promote``): the PyTorch port against the JAX package, on the CPU.

Leaders are in-process servers of either package (a memtable and WAL
over an on-disk store, as ``serve --upserts`` runs them); followers are
either package's ``ReplicaTailer`` with the serve path's overlay wiring
(the port's own ``cli/serve.py`` helpers).  Held equal: the WAL stable
prefixes and frame parsers on intact, torn, corrupt and alien files; the
ship document and the byte ranges (clamps, namespace, 400/404) through
both front ends of both packages; bootstrap then tail, with the mirror's
files byte-equal to the leader's and the follower's reads equal to the
leader's (generations masked: the two processes number their
generations apart); the re-sync after a leader flush and after a
compaction; restart and resume, a torn mirror tail; the non-persisting
worker; the lag gate on ``/readyz`` and the follower's 403; ``promote``
(files, report, epoch), the fence on a deposed leader's flush, and
``doctor promote``; the crossed-package bootstrap in both directions;
and a real ``serve --follow`` fleet of two workers, bootstrapping,
tailing and re-syncing across a flush and a compaction.  Every test that
drives a server runs under a 120 s limit.  The reference's ``repl.*``
fault points are not ported.
"""

import json
import os
import re
import shutil
import signal
import subprocess
import sys
import threading
import time
import types

import pytest

from annotatedvdb_tpu.cli import doctor as ref_doctor
from annotatedvdb_tpu.obs.metrics import MetricsRegistry as RefRegistry
from annotatedvdb_tpu.serve import MemtableSnapshots as RefOverlay
from annotatedvdb_tpu.serve import SnapshotManager as RefManager
from annotatedvdb_tpu.serve import StaticSnapshots as RefStatic
from annotatedvdb_tpu.serve import http as ref_http
from annotatedvdb_tpu.serve.aio import build_aio_server as ref_build_aio
from annotatedvdb_tpu.store import VariantStore as RefStore
from annotatedvdb_tpu.store import compact as ref_compact
from annotatedvdb_tpu.store import memtable as ref_memtable
from annotatedvdb_tpu.store import replication as ref_repl
from annotatedvdb_tpu.store import wal as ref_wal

from annotatedvdb_tpu_torch.cli import doctor
from annotatedvdb_tpu_torch.cli import serve as serve_cli
from annotatedvdb_tpu_torch.obs.metrics import MetricsRegistry
from annotatedvdb_tpu_torch.serve import http
from annotatedvdb_tpu_torch.serve.aio import build_aio_server
from annotatedvdb_tpu_torch.serve.snapshot import (
    MemtableSnapshots,
    SnapshotManager,
    StaticSnapshots,
)
from annotatedvdb_tpu_torch.store import VariantStore, compact, fsck, memtable
from annotatedvdb_tpu_torch.store import replication as repl
from annotatedvdb_tpu_torch.store import wal

import test_torch_upsert as tu

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WIDTH = tu.WIDTH
QUIET = dict(log=lambda m: None)
LIMIT_S = 120


@pytest.fixture()
def time_limit():
    """A 120-second limit on a test that drives servers: SIGALRM raises
    in the test's thread, so a hung request fails the test instead of
    stalling the run."""
    def expired(_signum, _frame):
        raise TimeoutError(f"test ran past its {LIMIT_S} s limit")

    previous = signal.signal(signal.SIGALRM, expired)
    signal.alarm(LIMIT_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, previous)


def _mask(body: bytes) -> bytes:
    return re.sub(rb'"generation": ?\d+', b'"generation":0', body)


def _files(d, skip=()):
    """{name: bytes} of a store directory (ledger timings masked)."""
    out = {}
    for name in sorted(os.listdir(d)):
        path = os.path.join(d, name)
        if name in skip or not os.path.isfile(path):
            continue
        with open(path, "rb") as f:
            blob = f.read()
        if name == "ledger.jsonl":
            blob = re.sub(rb'"(ts|seconds)": [0-9.e+-]+', rb'"\1": 0', blob)
        out[name] = blob
    return out


PKG = {
    "ref": types.SimpleNamespace(
        Registry=RefRegistry, Manager=RefManager, Overlay=RefOverlay,
        Memtable=ref_memtable.Memtable, Wal=ref_wal.WriteAheadLog,
        threaded=ref_http.build_server, aio=ref_build_aio, kw={},
        repl=ref_repl, compact=ref_compact, Store=RefStore,
        Static=RefStatic),
    "port": types.SimpleNamespace(
        Registry=MetricsRegistry, Manager=SnapshotManager,
        Overlay=MemtableSnapshots, Memtable=memtable.Memtable,
        Wal=wal.WriteAheadLog, threaded=http.build_server,
        aio=build_aio_server, kw={"device": "cpu"}, repl=repl,
        compact=compact, Store=VariantStore, Static=StaticSnapshots),
}


def _start(pkg, frontend, **kw):
    p = PKG[pkg]
    srv = getattr(p, frontend)(port=0, **kw, **p.kw)
    if frontend == "threaded":
        threading.Thread(target=srv.serve_forever, daemon=True).start()
    else:
        srv.start_background()
    return srv


def _stop(srv):
    if hasattr(srv, "server_close"):
        srv.shutdown()
        srv.server_close()
    else:
        srv.shutdown()
    srv.ctx.batcher.close()


class _Leader:
    """One package's leader: a memtable and WAL over an on-disk store
    (the port's upsert tests' seeded store), on the front end asked."""

    def __init__(self, pkg, store_dir, frontend="threaded", seed=True):
        p = PKG[pkg]
        self.pkg, self.store_dir = pkg, store_dir
        if seed:
            tu._seed_store().save(store_dir)
        self.mgr = p.Manager(store_dir, ttl_s=0.0, **QUIET)
        self.mem = p.Memtable(width=WIDTH, store_dir=store_dir,
                              wal=p.Wal(store_dir, "serve-w0", **QUIET),
                              flush_bytes=0, flush_age_s=0, **QUIET)
        self.srv = _start(pkg, frontend,
                          manager=p.Overlay(self.mgr, self.mem),
                          memtable=self.mem, registry=p.Registry())
        self.port = self.srv.server_address[1]
        self.url = f"http://127.0.0.1:{self.port}"

    def upsert(self, variants):
        status, body = tu._request(self.port, "POST", "/variants/upsert",
                                   {"variants": variants})
        assert status == 200, body
        return json.loads(body)

    def flush(self):
        assert self.mem.flush(self.mgr)["status"] == "flushed"

    def close(self):
        _stop(self.srv)


class _Follower:
    """One package's follower: a tailer and the serve path's overlay
    wiring over ``fdir`` (the port's through ``cli/serve.py``'s own
    helpers), served on the front end asked; tail cycles are stepped
    with :meth:`sync`."""

    def __init__(self, pkg, fdir, leader_url, frontend="threaded",
                 persist=True, bootstrap=True, **tail_kw):
        p = PKG[pkg]
        self.pkg, self.fdir = pkg, fdir
        if bootstrap:
            p.repl.ReplicaTailer(fdir, leader_url, persist=True,
                                 **QUIET).bootstrap()
        base = p.Manager(fdir, ttl_s=0.0, **QUIET)
        registry = p.Registry()
        if pkg == "port":
            args = types.SimpleNamespace(storeDir=fdir, follow=leader_url,
                                         _workerIndex=0 if persist else 1)
            self.manager, self.tailer = serve_cli._open_follower(
                args, base, registry, lambda m: None)
            for k, v in tail_kw.items():
                setattr(self.tailer, k, v)
        else:
            # the reference's serve --follow wiring, inline in its CLI
            def overlay():
                return p.Memtable(width=WIDTH, store_dir=None, wal=None,
                                  flush_bytes=0, flush_age_s=0.0, **QUIET)
            mem = {"m": overlay()}
            self.manager = p.Overlay(base, mem["m"])

            def apply_rows(rows):
                mem["m"].upsert(base.current().store, rows, durable=False)

            def on_resync():
                base.refresh()
                mem["m"] = overlay()
                self.manager.reset_memtable(mem["m"])

            self.tailer = p.repl.ReplicaTailer(
                fdir, leader_url, registry=registry, apply_rows=apply_rows,
                on_resync=on_resync, persist=persist, **tail_kw, **QUIET)
            if self.tailer.resume():
                for rec in self.tailer.local_records():
                    apply_rows(rec["rows"])
        self.srv = _start(pkg, frontend, manager=self.manager,
                          registry=registry)
        self.srv.ctx.repl = self.tailer
        self.srv.ctx.follow_url = self.tailer.leader_url
        self.port = self.srv.server_address[1]

    def sync(self):
        return self.tailer.sync_once()

    def close(self):
        self.tailer.stop()
        _stop(self.srv)


READS = [
    ("GET", "/variant/3:15:A:G", None),
    ("GET", "/variant/3:25:AT:A", None),
    ("GET", "/variant/3:20:A:C", None),
    ("POST", "/variants", {"ids": ["3:15:A:G", "3:25:AT:A", "3:10:A:C",
                                   "3:40:G:T", "3:99:A:C"]}),
    ("GET", "/region/3:1-100", None),
    ("GET", "/region/3:1-100?minCadd=30", None),
    ("POST", "/regions", {"regions": ["3:1-100", "3:14-16"]}),
    ("POST", "/regions", {"regions": ["3:1-100"], "limit": 0,
                          "tokenize": True}),
    ("POST", "/stats/region", {"regions": ["3:1-100", "3:12-26"],
                               "windows": 2}),
]

ROWS = [
    [{"id": "3:15:A:G", "ref_snp": 42,
      "annotations": {"cadd_scores": {"CADD_phred": 31.0},
                      "other_annotation": {"src": "live"}}},
     {"id": "3:25:AT:A"}],
    [{"id": "3:40:G:T", "ref_snp": 7}, {"id": "3:15:A:G", "ref_snp": 1}],
    [{"id": "3:45:C:CA", "annotations": {"other_annotation": {"k": 3}}}],
]


def _reads(port):
    return [(st, _mask(body)) for st, body in
            (tu._request(port, m, path, body) for m, path, body in READS)]


def _assert_reads_equal(leader, followers):
    want = _reads(leader.port)
    for f in followers:
        assert _reads(f.port) == want, f.pkg


# ---------------------------------------------------------------------------
# stable prefixes


def _wal_file(d, records, header_only=False):
    """A WAL file holding ``records``, or (``header_only``) the
    header-only active file a rotation leaves."""
    w = wal.WriteAheadLog(d, "serve-w0", **QUIET)
    for r in records:
        w.append(r)
    if header_only:
        w.rotate()
    w.close()
    return w.pending_files()[-1][1]


@pytest.mark.parametrize("damage", ["intact", "torn_1", "torn_7", "torn_20",
                                    "corrupt_last", "alien", "header_only",
                                    "missing"])
def test_stable_prefix_and_frame_readers_match_reference(tmp_path, damage):
    records = [{"rows": [{"id": f"3:{100 + i}:A:G"}]} for i in range(3)]
    path = _wal_file(str(tmp_path), records,
                     header_only=damage == "header_only")
    if damage == "header_only":
        records = []
    size = os.path.getsize(path)
    if damage.startswith("torn"):
        with open(path, "r+b") as f:
            f.truncate(size - int(damage.split("_")[1]))
    elif damage == "corrupt_last":
        with open(path, "r+b") as f:
            f.seek(size - 2)
            b = f.read(1)
            f.seek(size - 2)
            f.write(bytes([b[0] ^ 0xFF]))
    elif damage == "alien":
        with open(path, "w") as f:
            f.write("this is not a wal header\n")
    elif damage == "missing":
        os.unlink(path)
    got = repl.stable_wal_prefix(path)
    assert got == ref_repl.stable_wal_prefix(path)
    assert got[1] == wal.count_records(path) == ref_wal.count_records(path)
    if damage in ("alien", "missing"):
        assert got == (0, 0)
        return
    stable = got[0]
    assert repl.read_wal_records(path, 0, stable) \
        == ref_repl.read_wal_records(path, 0, stable) \
        == records[:got[1]]
    with open(path, "rb") as f:
        blob = f.read()
    for skip in (True, False):
        start = 0 if skip else blob.index(b"\n") + 1
        assert repl._parse_frames(blob[start:], skip_header=skip) \
            == ref_repl._parse_frames(blob[start:], skip_header=skip)
    ledger = str(tmp_path / "ledger.jsonl")
    with open(ledger, "wb") as f:
        f.write(b'{"a": 1}\n{"b": 2}\n{"c"')
    assert repl.stable_ledger_prefix(ledger) \
        == ref_repl.stable_ledger_prefix(ledger) == 18


def test_rotation_race_reader_sees_stable_prefix(tmp_path):
    """Every prefix captured while a writer appends and rotates parses
    to whole records."""
    w = wal.WriteAheadLog(str(tmp_path), "serve-w0", **QUIET)
    w.append({"rows": [{"id": "3:1:A:G"}]})
    paths = [w.pending_files()[0][1]]
    stop = threading.Event()
    seen = []

    def reader():
        while not stop.is_set():
            p = paths[-1]
            stable, records = repl.stable_wal_prefix(p)
            seen.append((records, len(repl.read_wal_records(p, 0, stable))))

    t = threading.Thread(target=reader)
    t.start()
    for i in range(60):
        w.append({"rows": [{"id": f"3:{i + 2}:A:G"}]})
        if i % 20 == 19:
            w.rotate()
            paths.append(w.pending_files()[-1][1])
    stop.set()
    t.join()
    w.close()
    assert seen and all(a == b for a, b in seen)


# ---------------------------------------------------------------------------
# the ship surface


def test_ship_document_and_ranges_match_reference(tmp_path):
    leader = _Leader("ref", str(tmp_path / "leader"))
    try:
        leader.upsert(ROWS[0])
        leader.flush()  # a ledger record to ship
        leader.upsert(ROWS[1])
        d = leader.store_dir
        doc = repl.ship_manifest(d)
        want = ref_repl.ship_manifest(d)
        assert {**doc, "now": 0} == {**want, "now": 0}
        assert doc["wal"] and doc["ledger"]["bytes"] > 0
        assert repl.manifest_segment_files(doc["manifest"]) \
            == ref_repl.manifest_segment_files(doc["manifest"])
        names = (sorted(repl.manifest_segment_files(doc["manifest"]))
                 + repl.wal_files(d) + ["ledger.jsonl", "manifest.json",
                                        "../etc/passwd", ".hidden",
                                        "repl.cursor.json", "nope.npz"])
        wpath = os.path.join(d, repl.wal_files(d)[0])
        with open(wpath, "ab") as f:
            f.write(b"\x99" * 9)  # a torn tail beyond the stable prefix
        for name in names:
            for off, lim in ((0, 1 << 30), (2, 3), (10_000, 5), (0, 0)):
                assert repl.ship_file_range(d, name, off, lim) \
                    == ref_repl.ship_file_range(d, name, off, lim), name
        assert repl.wal_names(d) == ref_repl.wal_names(d) == ["serve-w0"]
    finally:
        leader.close()
    with pytest.raises(repl.ReplError):
        repl.ship_manifest(str(tmp_path))


def test_repl_routes_match_reference_on_both_front_ends(tmp_path,
                                                        time_limit):
    ref_dir = str(tmp_path / "ref")
    leader = _Leader("ref", ref_dir)
    leader.upsert(ROWS[0])
    leader.flush()
    leader.upsert(ROWS[1])
    leader.close()
    port_dir = str(tmp_path / "port")
    shutil.copytree(ref_dir, port_dir)
    seg = sorted(n for n in os.listdir(ref_dir) if n.endswith(".npz"))[0]
    wname = repl.wal_files(ref_dir)[0]
    paths = ["/repl/manifest", f"/repl/segment?name={seg}",
             f"/repl/segment?name={seg}&offset=3&limit=10",
             f"/repl/wal?name={wname}&offset=5",
             f"/repl/wal?name={wname}&limit=99999999999",
             "/repl/wal?name=ledger.jsonl", "/repl/segment?name=manifest.json",
             "/repl/wal?name=x&offset=abc", "/repl/segment"]
    servers = {}
    try:
        for pkg, d in (("ref", ref_dir), ("port", port_dir)):
            for fe in ("threaded", "aio"):
                servers[pkg, fe] = _start(pkg, fe, manager=PKG[pkg].Manager(
                    d, **QUIET), registry=PKG[pkg].Registry())
        for path in paths:
            got = set()
            for srv in servers.values():
                st, body = tu._request(srv.server_address[1], "GET", path)
                if path == "/repl/manifest":
                    # the two copies' manifests differ in inode and mtime
                    body = re.sub(rb'"now": [0-9.e+-]+', b"", body)
                    body = re.sub(rb'"fingerprint": \[[0-9, ]+\]', b"", body)
                got.add((st, body))
            assert len(got) == 1, (path, got)
        # no on-disk store: 404 on every ship route
        for pkg in PKG:
            srv = _start(pkg, "threaded", manager=PKG[pkg].Static(
                PKG[pkg].Store.load(ref_dir, readonly=True)))
            try:
                for path in ("/repl/manifest", "/repl/wal?name=x",
                             "/repl/segment"):
                    st, body = tu._request(srv.server_address[1], "GET",
                                           path)
                    assert st == 404 and b"unavailable" in body
            finally:
                _stop(srv)
    finally:
        for srv in servers.values():
            _stop(srv)


# ---------------------------------------------------------------------------
# bootstrap, tail, re-sync


@pytest.mark.parametrize("leader_pkg", ["port", "ref"])
@pytest.mark.parametrize("frontend", ["threaded", "aio"])
def test_bootstrap_tail_and_resync_across_flush_and_compaction(
        tmp_path, time_limit, leader_pkg, frontend):
    """Both packages' followers on one leader (the port's, or the
    reference's: the crossed directions): after bootstrap, after each
    tailed upsert, after a leader flush and after a leader compaction,
    the mirrors are equal to each other and to the leader's cut, and
    every read body equals the leader's."""
    leader = _Leader(leader_pkg, str(tmp_path / "leader"), frontend)
    followers = []
    try:
        for pkg in ("port", "ref"):
            followers.append(_Follower(pkg, str(tmp_path / f"f-{pkg}"),
                                       leader.url, frontend))
        _assert_reads_equal(leader, followers)
        for k, rows in enumerate(ROWS):
            leader.upsert(rows)
            for f in followers:
                out = f.sync()
                assert out == {"applied": 1, "resynced": False, "epoch": 0}
                assert f.sync()["applied"] == 0
            _assert_reads_equal(leader, followers)
            if k == 1:
                leader.flush()
                for f in followers:
                    assert f.sync()["resynced"]
                _assert_reads_equal(leader, followers)
        # a leader compaction is a commit the followers re-sync onto
        leader.flush()
        report = PKG[leader_pkg].compact.compact_store(leader.store_dir,
                                                       **QUIET)
        assert report["status"] == "compacted"
        leader.mgr.refresh()
        for f in followers:
            assert f.sync()["resynced"]
            assert f.sync() == {"applied": 0, "resynced": False, "epoch": 0}
        _assert_reads_equal(leader, followers)
        # the mirrored cut is the leader's store: its manifest (compact
        # separators), every segment file it references, the ledger and
        # the WAL files; the reference's mirror also keeps the segment
        # files of the cuts it re-synced past (orphans fsck warns of),
        # which the port's re-sync removes
        port_m, ref_m = (_files(f.fdir, skip=(repl.CURSOR_FILE,))
                         for f in followers)
        lead = _files(leader.store_dir)
        assert json.loads(port_m.pop("manifest.json")) \
            == json.loads(lead.pop("manifest.json")) \
            == json.loads(ref_m.pop("manifest.json"))
        assert port_m == lead
        orphans = set(ref_m) - set(port_m)
        assert {n: ref_m[n] for n in port_m} == port_m
        assert orphans and all(re.match(r"chr3\.\d{6}\.", n)
                               for n in orphans)
        codes = [f["code"] for f in fsck.fsck(
            followers[0].fdir, deep=True, **QUIET)["findings"]]
        assert "segment-orphan" not in codes and "repl-cursor" in codes
        cursors = [json.load(open(os.path.join(f.fdir, repl.CURSOR_FILE)))
                   for f in followers]
        assert cursors[0] == cursors[1]
        # promoted, the port's follower is a clean store
        repl.promote(followers[0].fdir, **QUIET)
        assert fsck.fsck(followers[0].fdir, deep=True,
                         **QUIET)["status"] == "clean"
    finally:
        for f in followers:
            f.close()
        leader.close()


@pytest.mark.parametrize("leader_pkg", ["port", "ref"])
def test_rows_tailed_before_a_compaction_survive_the_resync(
        tmp_path, time_limit, leader_pkg):
    """A WAL record the followers tailed before a leader compaction
    survives the leader's commit (compaction does not flush): the port's
    follower re-applies it from its mirror after the re-sync and keeps
    serving the leader's bytes.  The reference's follower drops it from
    its overlay (its persisting tailer takes the non-empty mirror for
    drift), the fault ``ROADMAP.md`` section C records."""
    leader = _Leader(leader_pkg, str(tmp_path / "leader"))
    followers = []
    try:
        leader.upsert(ROWS[0])
        leader.flush()
        leader.upsert(ROWS[1])
        for pkg in ("port", "ref"):
            followers.append(_Follower(pkg, str(tmp_path / f"f-{pkg}"),
                                       leader.url))
            followers[-1].sync()
        _assert_reads_equal(leader, followers)
        report = PKG[leader_pkg].compact.compact_store(leader.store_dir,
                                                       **QUIET)
        assert report["labels"] == ["3"]
        leader.mgr.refresh()
        outs = [f.sync() for f in followers]
        assert outs[0] == {"applied": 1, "resynced": True, "epoch": 0}
        assert outs[1] == {"applied": 0, "resynced": True, "epoch": 0}
        want = _reads(leader.port)
        assert _reads(followers[0].port) == want
        assert _reads(followers[1].port) != want
        leader.upsert(ROWS[2])
        followers[0].sync()
        _assert_reads_equal(leader, followers[:1])
    finally:
        for f in followers:
            f.close()
        leader.close()


def test_restart_resume_and_torn_mirror_tail(tmp_path, time_limit):
    leader = _Leader("port", str(tmp_path / "leader"))
    try:
        leader.upsert(ROWS[0])
        dirs = {pkg: str(tmp_path / f"f-{pkg}") for pkg in PKG}
        offsets = {}
        for pkg, fdir in dirs.items():
            t = PKG[pkg].repl.ReplicaTailer(fdir, leader.url, **QUIET)
            t.bootstrap()
            t.sync_once()
            offsets[pkg] = dict(t._offsets)
            wpath = os.path.join(fdir, repl.wal_files(fdir)[0])
            with open(wpath, "ab") as f:
                f.write(b"\x01\x02\x03")  # a kill mid-mirror
        leader.upsert(ROWS[1])
        applied = {}
        for pkg, fdir in dirs.items():
            t = PKG[pkg].repl.ReplicaTailer(fdir, leader.url, **QUIET)
            got = []
            t.apply_rows = got.extend
            assert t.resume() == 1
            assert t._offsets == offsets[pkg]
            assert [r["pos"] for rec in t.local_records()
                    for r in rec["rows"]] == [15, 25]
            t.sync_once()
            applied[pkg] = [r["pos"] for r in got]
        # the leader shadowed ROWS[1]'s repeat of 3:15:A:G: one new row
        assert applied == {"port": [40], "ref": [40]}
        assert _files(dirs["port"]) == _files(dirs["ref"])
        wname = repl.wal_files(dirs["port"])[0]
        assert _files(dirs["port"])[wname] \
            == _files(leader.store_dir)[wname]
        # a restarted follower server re-applies the mirrored records
        # into its overlay before serving
        f = _Follower("port", dirs["port"], leader.url, bootstrap=False)
        try:
            _assert_reads_equal(leader, [f])
        finally:
            f.close()
    finally:
        leader.close()


def test_nonpersisting_worker_applies_without_touching_disk(tmp_path,
                                                            time_limit):
    leader = _Leader("port", str(tmp_path / "leader"))
    try:
        leader.upsert(ROWS[0])
        follower = _Follower("port", str(tmp_path / "f0"), leader.url)
        sibling_dir = str(tmp_path / "f0")
        before = _files(sibling_dir)
        # worker 1 of the same follower fleet: tails without mirroring
        sibling = _Follower("port", sibling_dir, leader.url,
                            persist=False, bootstrap=False)
        try:
            assert not sibling.tailer.persist
            for f in (follower, sibling):
                f.sync()
            leader.upsert(ROWS[1])
            assert sibling.sync()["applied"] == 1
            assert _files(sibling_dir) != before  # worker 0's mirror moved
            snapshot = _files(sibling_dir)
            assert sibling.sync()["applied"] == 0
            follower.sync()
            _assert_reads_equal(leader, [follower, sibling])
            # a persist=False tailer writes nothing into an empty dir
            bare = repl.ReplicaTailer(str(tmp_path / "bare"), leader.url,
                                      persist=False, **QUIET)
            got = []
            bare.apply_rows = got.extend
            bare.bootstrap()
            bare.sync_once()
            assert [r["pos"] for r in got] == [15, 25, 40]
            assert not os.path.exists(tmp_path / "bare") \
                or not os.listdir(tmp_path / "bare")
            assert _files(sibling_dir)["manifest.json"] \
                == snapshot["manifest.json"]
        finally:
            sibling.close()
            follower.close()
    finally:
        leader.close()


@pytest.mark.parametrize("frontend", ["threaded", "aio"])
def test_lag_gate_readyz_and_follower_403(tmp_path, time_limit, frontend):
    leader = _Leader("port", str(tmp_path / "leader"))
    followers = []
    try:
        leader.upsert(ROWS[0])
        for pkg in PKG:
            followers.append(_Follower(pkg, str(tmp_path / f"f-{pkg}"),
                                       leader.url, frontend,
                                       max_lag_s=0.5))
        got = []
        for f in followers:
            f.sync()
            assert not f.tailer.lag_exceeded()
            steps = [tu._request(f.port, "GET", "/readyz")]
            steps.append(tu._request(f.port, "POST", "/variants/upsert",
                                     {"variants": [{"id": "3:77:A:G"}]}))
            f.tailer._caught_up_t -= 10.0  # the ship stream stalled
            assert f.tailer.lag_exceeded()
            steps.append(tu._request(f.port, "GET", "/readyz"))
            st, body = tu._request(f.port, "GET", "/healthz")
            steps.append((st, json.loads(body)["ready"]))
            f.sync()  # catch-up clears the gate
            steps.append(tu._request(f.port, "GET", "/readyz"))
            got.append([(st, re.sub(rb"lag [0-9.]+s", b"lag Ns", body))
                        if isinstance(body, bytes) else (st, body)
                        for st, body in steps])
        assert got[0] == got[1]
        statuses = [s[0] for s in got[0]]
        assert statuses == [200, 403, 503, 200, 200]
        assert json.loads(got[0][1][1])["leader"] == leader.url
        assert b"exceeds the declared staleness bound (0.5s)" in got[0][2][1]
        assert got[0][3][1] is False
    finally:
        for f in followers:
            f.close()
        leader.close()


def test_deposed_leader_epoch_refused_and_metrics(tmp_path, time_limit):
    leader = _Leader("port", str(tmp_path / "leader"))
    try:
        registry = MetricsRegistry()
        t = repl.ReplicaTailer(str(tmp_path / "f"), leader.url,
                               registry=registry, poll_s=0.05, **QUIET)
        got = []
        t.apply_rows = got.extend
        t.bootstrap()
        t.start()
        leader.upsert(ROWS[0])
        deadline = time.monotonic() + 30
        while not got and time.monotonic() < deadline:
            time.sleep(0.02)
        t.stop()
        assert [r["pos"] for r in got] == [15, 25]
        text = registry.render_prometheus()
        for name in ("avdb_replication_lag_seconds",
                     "avdb_repl_records_applied_total 1",
                     "avdb_repl_ship_bytes_total"):
            assert name in text
        t._epoch = 7  # as if this follower already saw epoch 7
        with pytest.raises(repl.ReplError, match="deposed"):
            t.sync_once()
    finally:
        leader.close()


def test_env_knobs_match_reference(monkeypatch):
    fns = ("repl_max_lag_from_env", "repl_poll_from_env",
           "repl_chunk_from_env", "repl_timeout_from_env")
    for env in ({}, {"AVDB_REPL_MAX_LAG_S": "0", "AVDB_REPL_POLL_S": "0.001",
                     "AVDB_REPL_CHUNK_BYTES": "512k",
                     "AVDB_REPL_TIMEOUT_S": "0.01"},
                {"AVDB_REPL_CHUNK_BYTES": "1"}):
        for var in ("AVDB_REPL_MAX_LAG_S", "AVDB_REPL_POLL_S",
                    "AVDB_REPL_CHUNK_BYTES", "AVDB_REPL_TIMEOUT_S"):
            monkeypatch.delenv(var, raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        assert [getattr(repl, f)() for f in fns] \
            == [getattr(ref_repl, f)() for f in fns]
    for var, fn in zip(("AVDB_REPL_MAX_LAG_S", "AVDB_REPL_POLL_S",
                        "AVDB_REPL_CHUNK_BYTES", "AVDB_REPL_TIMEOUT_S"), fns):
        monkeypatch.setenv(var, "bogus")
        with pytest.raises(ValueError, match=var):
            getattr(repl, fn)()
        monkeypatch.delenv(var)


# ---------------------------------------------------------------------------
# promote


def _tailed_follower_pair(tmp_path, leader):
    """One port-tailed follower directory, copied: (the reference's copy,
    the port's copy)."""
    fdir = str(tmp_path / "follower")
    t = repl.ReplicaTailer(fdir, leader.url, **QUIET)
    t.bootstrap()
    t.sync_once()
    ref_dir = str(tmp_path / "promote-ref")
    port_dir = str(tmp_path / "promote-port")
    shutil.copytree(fdir, ref_dir)
    shutil.copytree(fdir, port_dir)
    return ref_dir, port_dir


def test_promote_seals_tail_bumps_epoch_and_fences(tmp_path, time_limit):
    leader = _Leader("port", str(tmp_path / "leader"))
    try:
        leader.upsert(ROWS[0])
        leader.upsert(ROWS[1])
        ref_dir, port_dir = _tailed_follower_pair(tmp_path, leader)
    finally:
        leader.close()
    want = ref_repl.promote(ref_dir, **QUIET)
    got = repl.promote(port_dir, **QUIET)
    assert got == want == {"status": "promoted", "epoch": 1, "rows": 3}
    assert _files(port_dir) == _files(ref_dir)
    assert not repl.wal_files(port_dir)
    assert not os.path.exists(os.path.join(port_dir, repl.CURSOR_FILE))
    store = VariantStore.load(port_dir, readonly=True)
    assert store.n == 6
    # idempotent: nothing left to replay, the epoch moves on
    assert repl.promote(port_dir, **QUIET) \
        == ref_repl.promote(ref_dir, **QUIET) \
        == {"status": "promoted", "epoch": 2, "rows": 0}
    assert _files(port_dir) == _files(ref_dir)
    # fencing: a writer opened before the promote cannot commit
    row = [{"code": 3, "pos": 99, "ref": "A", "alt": "G"}]
    for pkg, d in (("port", port_dir), ("ref", ref_dir)):
        deposed = PKG[pkg].Memtable(width=WIDTH, store_dir=d, wal=None,
                                    fence_epoch=0, **QUIET)
        deposed.upsert(None, row, durable=False)
        result = deposed.flush()
        assert result["status"] == "aborted" and "fenced" in result["reason"]
    assert _files(port_dir) == _files(ref_dir)
    # a writer opened at the current epoch commits
    fresh = memtable.Memtable(width=WIDTH, store_dir=port_dir, wal=None,
                              fence_epoch=2, **QUIET)
    fresh.upsert(None, row, durable=False)
    assert fresh.flush()["status"] == "flushed"


def test_deposed_serve_worker_flush_aborts_as_fenced(tmp_path, time_limit):
    """A leader serving with ``--upserts`` opened at epoch 0; its store is
    then promoted past it (the fencing epoch bumps), and its next flush
    aborts as fenced, leaving the rows in its memtable and WAL."""
    d = str(tmp_path / "leader")
    leader = _Leader("port", d)
    try:
        leader.mem.fence_epoch = 0  # what serve --upserts opens with
        leader.upsert(ROWS[0])
        repl.promote(d, **QUIET)  # another node took over this store
        before = {n: b for n, b in _files(d).items()
                  if not n.endswith(".wal")}
        result = leader.mem.flush(leader.mgr)
        assert result["status"] == "aborted" and "fenced" in result["reason"]
        # the store is untouched; the rows stay in the memtable
        assert {n: b for n, b in _files(d).items()
                if not n.endswith(".wal")} == before
        assert leader.mem.rows == 2
    finally:
        leader.close()


def test_doctor_promote_cli_matches_reference(tmp_path, capsys, time_limit):
    leader = _Leader("port", str(tmp_path / "leader"))
    try:
        leader.upsert(ROWS[0])
        ref_dir, port_dir = _tailed_follower_pair(tmp_path, leader)
    finally:
        leader.close()
    for json_flag in (["--json"], []):
        outs = []
        for main, d in ((ref_doctor.main, ref_dir), (doctor.main, port_dir)):
            rc = main(["promote", "--storeDir", d, *json_flag])
            cap = capsys.readouterr()
            outs.append((rc, cap.out, cap.err.replace(d, "S")))
        assert outs[0] == outs[1]
        assert outs[1][0] == 0
    assert _files(port_dir) == _files(ref_dir)
    assert json.load(open(os.path.join(port_dir, "manifest.json")))[
        "repl_epoch"] == 2
    for main in (ref_doctor.main, doctor.main):
        assert main(["promote", "--storeDir", str(tmp_path / "nope")]) == 2
    assert capsys.readouterr().err.count("doctor promote:") == 2


# ---------------------------------------------------------------------------
# the serve CLI


def _wait(test, deadline, what, err_path, last=None):
    while True:
        got = test()
        if got:
            return got
        assert time.monotonic() < deadline, \
            f"timed out waiting for {what} ({last}): " \
            f"{open(err_path).read()[-3000:]}"
        time.sleep(0.1)


def test_serve_follow_fleet_bootstraps_tails_and_resyncs(tmp_path,
                                                         time_limit):
    """``serve --follow URL --workers 2`` on an empty directory, under a
    100 s deadline with its process group killed at the end: the
    supervisor bootstraps the cut, both workers tail the leader (only
    worker 0 mirrors into the directory), every read on fresh
    connections equals the leader's after an upsert, a flush and a
    compaction, and an upsert answers 403."""
    leader = _Leader("port", str(tmp_path / "leader"), "aio")
    fdir = str(tmp_path / "follower")
    err_path = str(tmp_path / "err")
    env = dict(os.environ, AVDB_REPL_POLL_S="0.05",
               AVDB_REPL_TIMEOUT_S="5", AVDB_SERVE_SNAPSHOT_TTL_MS="50")
    with open(err_path, "w") as err_f:
        proc = subprocess.Popen(
            [sys.executable, "-m", "annotatedvdb_tpu_torch", "serve",
             "--storeDir", fdir, "--port", "0", "--workers", "2",
             "--follow", leader.url, "--platform", "cpu"],
            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=err_f,
            text=True, start_new_session=True)
    deadline = time.monotonic() + 100
    try:
        banner = proc.stdout.readline()
        port = int(re.search(r":(\d+) with 2 workers", banner).group(1))
        assert os.path.exists(os.path.join(fdir, "manifest.json"))

        last = {}

        def converged():
            want = _reads(leader.port)
            try:
                for _ in range(6):
                    got = _reads(port)
                    if got != want:
                        last["diff"] = [(g, w) for g, w in zip(got, want)
                                        if g != w]
                        return False
                return True
            except OSError:
                return False

        _wait(converged, deadline, "the bootstrap", err_path)
        for k, rows in enumerate(ROWS):
            leader.upsert(rows)
            _wait(converged, deadline, f"upsert {k}", err_path)
        leader.flush()
        _wait(converged, deadline, "the flush re-sync", err_path)
        leader.upsert([{"id": "3:50:T:A"}])
        compact.compact_store(leader.store_dir, **QUIET)
        _wait(converged, deadline, "the compaction re-sync", err_path,
              last)
        st, body = tu._request(port, "POST", "/variants/upsert",
                               {"variants": [{"id": "3:77:A:G"}]})
        assert st == 403 and json.loads(body)["leader"] == leader.url
    finally:
        os.killpg(proc.pid, signal.SIGTERM)
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
        leader.close()
    err = open(err_path).read()
    assert proc.returncode == 0, err[-3000:]
    assert "repl: bootstrapped cut" in err
    # only worker 0 mirrored: the directory holds the leader's store
    lead = _files(leader.store_dir)
    mirror = _files(fdir, skip=(repl.CURSOR_FILE,))
    assert json.loads(mirror.pop("manifest.json")) \
        == json.loads(lead.pop("manifest.json"))
    assert mirror == lead
