"""The store and write-path fault points, crossed between the two packages:
the reference's WAL, memtable, compaction, maintenance, replication, fsck
and export cases (``tests/test_fault_matrix.py``) run once against each
package, on byte-equal copies of one store built by the reference's own
helpers, under the same ``AVDB_FAULT`` spec.

Each case holds three things equal: what the faulted call did (its
result, or the fault it raised), the directory it left (store, WAL,
ledger with ``ts`` masked, quarantine, export debris; byte for byte), and
after the retry, resume, replay or repair the final bytes.  ``raise`` and
``eio`` are armed in-process; ``kill`` and ``torn_write`` run a small
script per package in a subprocess whose exit must be SIGKILL.
"""

import json
import os
import shutil
import signal
import subprocess
import sys
import textwrap
import threading

import pytest

from test_fault_matrix import (
    _REPL_ROWS,
    _UPSERT_ROW,
    _fragmented_store,
    _tiny_store,
)
from test_torch_faults import (
    PORT,
    REF,
    ROOT,
    armed,
    dir_state,
    masked,
    same,
)

PKGS = (REF, PORT)


@pytest.fixture(autouse=True)
def _disarm():
    yield
    for pkg in PKGS:
        pkg.faults.reset("")


def copies(tmp_path, build, name="store"):
    """``build(dir)`` once, then one byte-equal copy per package, as
    ``<tmp>/<pkg>/<name>`` (so one mask, ``<tmp>/<pkg>``, hides every
    path a package records)."""
    src = str(tmp_path / f"{name}-src")
    build(src)
    out = {}
    for pkg in PKGS:
        out[pkg] = str(tmp_path / str(pkg) / name)
        shutil.copytree(src, out[pkg])
    return out


def _quiet(_m):
    pass


# ---------------------------------------------------------------------------
# wal.append / wal.fsync / wal.replay


def _memtable(pkg, store_dir, wal=True):
    mt = pkg.mod("store.memtable")
    w = pkg.mod("store.wal").WriteAheadLog(store_dir, "serve-w0",
                                           log=_quiet) if wal else None
    return mt.Memtable(width=8, store_dir=store_dir, wal=w, log=_quiet)


def _base(pkg, store_dir):
    return pkg.mod("store").VariantStore.load(store_dir, readonly=True)


def _replayed(pkg, store_dir):
    mem = _memtable(pkg, store_dir)
    return mem, mem.replay(_base(pkg, store_dir))


def _lookup(pkg, store_dir, mem, vid="3:15:A:G"):
    snaps = pkg.mod("serve.snapshot")
    engine = pkg.mod("serve.engine").QueryEngine(
        snaps.MemtableSnapshots(snaps.StaticSnapshots(_base(pkg, store_dir)),
                                mem),
        region_cache_size=0, **pkg.kw)
    return engine.lookup(vid)


@pytest.mark.parametrize("fault", ["wal.append:1:raise", "wal.append:1:eio",
                                   "wal.fsync:1:raise"])
def test_wal_write_faults_match_the_reference(tmp_path, fault):
    dirs = copies(tmp_path, lambda d: _tiny_store().save(d))
    got = {}
    for pkg in PKGS:
        d = dirs[pkg]
        mem = _memtable(pkg, d)
        outcome = armed(pkg, fault, mem.upsert, _base(pkg, d),
                        [dict(_UPSERT_ROW)])
        crashed = dir_state(d)
        replayed, applied = _replayed(pkg, d)
        answer = _lookup(pkg, d, replayed)
        retry = mem.upsert(_base(pkg, d), [dict(_UPSERT_ROW)])[:2]
        got[pkg] = (outcome, mem.rows, crashed, applied, answer, retry,
                    _replayed(pkg, d)[1], dir_state(d))
        mem.wal.close()
    want = same(got)
    assert want[0].startswith("raised")
    assert want[1] == 1 and want[5] == (1, 0)


def test_wal_replay_fault_then_retry_recovers_alike(tmp_path):
    dirs = copies(tmp_path, lambda d: _tiny_store().save(d))
    got = {}
    for pkg in PKGS:
        d = dirs[pkg]
        mem = _memtable(pkg, d)
        assert mem.upsert(_base(pkg, d), [dict(_UPSERT_ROW)])[0] == 1
        mem.wal.close()
        outcome = armed(pkg, "wal.replay:1:raise", _replayed, pkg, d)
        replayed, applied = _replayed(pkg, d)
        again = replayed.upsert(_base(pkg, d), [dict(_UPSERT_ROW)],
                                durable=False)[:2]
        got[pkg] = (outcome, applied, replayed.rows, again, dir_state(d))
    want = same(got)
    assert want[0] == "raised InjectedFault" and want[1:4] == (1, 1, (0, 1))


_SCRIPT = textwrap.dedent("""
    import sys
    pkg, store_dir, action = sys.argv[1:4]
    import importlib
    mt = importlib.import_module(pkg + ".store.memtable")
    wal = importlib.import_module(pkg + ".store.wal")
    vs = importlib.import_module(pkg + ".store")
    w = wal.WriteAheadLog(store_dir, "serve-w0", log=lambda m: None)
    mem = mt.Memtable(width=8, store_dir=store_dir, wal=w,
                      log=lambda m: None)
    base = vs.VariantStore.load(store_dir, readonly=True)
    row = {"code": 3, "pos": 15, "ref": "A", "alt": "G", "ref_snp": 7,
           "ann": {"other_annotation": {"k": 1}}}
    if action == "flush":
        mem.replay(base)
        mem.flush(base_manager=None)
    else:
        mem.upsert(base, [row])
    print("survived")
""")


def _script(pkg, store_dir, action, fault):
    env = dict(os.environ, JAX_PLATFORMS="cpu", AVDB_FAULT=fault)
    return subprocess.Popen([sys.executable, "-c", _SCRIPT, pkg.root,
                             store_dir, action], cwd=ROOT, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _wait_killed(procs):
    for pkg, p in procs.items():
        out, err = p.communicate(timeout=120)
        assert p.returncode == -signal.SIGKILL, (pkg, p.returncode, out,
                                                 err[-2000:])


@pytest.mark.parametrize("fault", ["wal.append:1:torn_write",
                                   "wal.fsync:1:torn_write",
                                   "wal.fsync:1:kill"])
def test_wal_deaths_tear_the_same_bytes(tmp_path, fault):
    """A worker killed mid-append: the same WAL bytes (torn at the same
    byte), and a replay that drops the torn tail (or applies the whole
    frame) alike."""
    dirs = copies(tmp_path, lambda d: _tiny_store().save(d))
    _wait_killed({pkg: _script(pkg, dirs[pkg], "upsert", fault)
                  for pkg in PKGS})
    got = {}
    for pkg in PKGS:
        crashed = dir_state(dirs[pkg])
        mem, applied = _replayed(pkg, dirs[pkg])
        got[pkg] = (crashed, applied, _lookup(pkg, dirs[pkg], mem))
        mem.wal.close()
    want = same(got)
    # only a kill after a whole frame landed leaves a record to replay
    assert want[1] == (fault == "wal.fsync:1:kill")


# ---------------------------------------------------------------------------
# memtable.flush


@pytest.mark.parametrize("fault", [
    "memtable.flush:1:raise", "memtable.flush:1:eio",
    "memtable.flush:2:raise", "memtable.flush:2:eio",
])
def test_memtable_flush_faults_match_the_reference(tmp_path, fault):
    dirs = copies(tmp_path, lambda d: _tiny_store().save(d))
    got = {}
    for pkg in PKGS:
        d = dirs[pkg]
        mem = _memtable(pkg, d)
        assert mem.upsert(_base(pkg, d), [dict(_UPSERT_ROW)])[0] == 1
        outcome = armed(pkg, fault, mem.flush, base_manager=None)
        crashed = dir_state(d)
        report = pkg.mod("store.fsck").fsck(d, repair=True, log=_quiet)
        repaired = dir_state(d)
        result = mem.flush(base_manager=None)
        got[pkg] = (outcome, mem.rows, crashed, masked(report, d), repaired,
                    (result["status"], result["rows"]), dir_state(d))
        mem.wal.close(remove_if_empty=True)
    want = same(got)
    assert want[0].startswith("raised") and want[5] == ("flushed", 1)


def test_memtable_flush_commit_kill_leaves_the_same_store(tmp_path):
    """``memtable.flush:2:kill`` (the commit point: segments renamed,
    manifest tmp staged) in a process that replays an acknowledged WAL
    and flushes: the same pre-state with the same debris; a clean replay
    and flush then converge on the same store."""
    dirs = copies(tmp_path, lambda d: _tiny_store().save(d))
    for pkg in PKGS:
        mem = _memtable(pkg, dirs[pkg])
        assert mem.upsert(_base(pkg, dirs[pkg]), [dict(_UPSERT_ROW)])[0] == 1
        mem.wal.close()
    _wait_killed({pkg: _script(pkg, dirs[pkg], "flush",
                               "memtable.flush:2:kill") for pkg in PKGS})
    got = {}
    for pkg in PKGS:
        crashed = dir_state(dirs[pkg])
        mem, applied = _replayed(pkg, dirs[pkg])
        result = mem.flush(base_manager=None)
        mem.wal.close(remove_if_empty=True)
        report = pkg.mod("store.fsck").fsck(dirs[pkg], repair=True,
                                            log=_quiet)
        got[pkg] = (crashed, applied, result["status"],
                    masked(report, dirs[pkg]), dir_state(dirs[pkg]))
    want = same(got)
    assert any(".manifest.json.tmp" in name for name in want[0])
    assert want[1:3] == (1, "flushed")


# ---------------------------------------------------------------------------
# compact.plan / .merge / .swap / .gc


@pytest.mark.parametrize("fault", [
    "compact.plan:1:raise", "compact.plan:1:eio",
    "compact.merge:1:raise", "compact.merge:1:eio",
    "compact.swap:1:raise", "compact.gc:1:eio",
])
def test_compact_faults_match_the_reference(tmp_path, fault):
    dirs = copies(tmp_path, _fragmented_store)
    got = {}
    for pkg in PKGS:
        d = dirs[pkg]
        compact_store = pkg.mod("store.compact").compact_store
        outcome = armed(pkg, fault, compact_store, d, log=_quiet)
        if isinstance(outcome, dict):
            outcome = (outcome["status"], outcome["files_before"],
                       outcome["files_after"])
        crashed = dir_state(d)
        report = pkg.mod("store.fsck").fsck(d, repair=True, log=_quiet)
        repaired = dir_state(d)
        final = compact_store(d, log=_quiet)["status"]
        got[pkg] = (outcome, crashed, masked(report, d), repaired, final,
                    dir_state(d))
    want = same(got)
    assert want[0] == ("compacted", 4, 1) if fault.startswith("compact.gc") \
        else want[0].startswith("raised")


def _doctor_compact(pkg, store_dir, fault):
    env = dict(os.environ, JAX_PLATFORMS="cpu", AVDB_FAULT=fault)
    return subprocess.Popen(
        [sys.executable, "-m", pkg.root, "doctor", "compact", "--storeDir",
         store_dir], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)


@pytest.mark.parametrize("fault", [
    "compact.merge:1:kill", "compact.merge:1:torn_write",
    "compact.swap:1:kill", "compact.gc:1:kill",
])
def test_compact_deaths_through_doctor_compact_match(tmp_path, fault):
    """True process death through each package's ``doctor compact``: the
    same pre- or post-state on disk, the same repair, and the same store
    after an unarmed pass."""
    dirs = copies(tmp_path, _fragmented_store)
    _wait_killed({pkg: _doctor_compact(pkg, dirs[pkg], fault)
                  for pkg in PKGS})
    got = {}
    for pkg in PKGS:
        d = dirs[pkg]
        crashed = dir_state(d)
        report = pkg.mod("store.fsck").fsck(d, repair=True, log=_quiet)
        repaired = dir_state(d)
        final = pkg.mod("store.compact").compact_store(d, log=_quiet)
        got[pkg] = (crashed, masked(report, d), repaired, final["status"],
                    dir_state(d))
    want = same(got)
    groups = want[0]["manifest.json"]["shards"]["6"]
    assert (len(groups) == 1) == fault.startswith("compact.gc")


# ---------------------------------------------------------------------------
# maintain.tick / maintain.disk_guard


@pytest.mark.parametrize("fault", ["maintain.tick:1:raise",
                                   "maintain.tick:1:eio"])
def test_maintain_tick_fault_absorbed_alike(tmp_path, fault):
    dirs = copies(tmp_path, _fragmented_store)
    got = {}
    for pkg in PKGS:
        logs = []
        daemon = pkg.mod("store.maintenance").MaintenanceDaemon(
            dirs[pkg], high=4, low=2, tick_s=0.05, cooldown_s=0.0,
            log=logs.append)
        first = armed(pkg, fault, daemon.tick)
        second = daemon.tick()
        failed = [m.split("; next")[0] for m in logs if "tick failed" in m]
        got[pkg] = (first, failed, second, daemon.read_amp(),
                    daemon.stats()["disabled"], dir_state(dirs[pkg]))
    want = same(got)
    assert want[0] == "error" and want[2] == "pass" and len(want[1]) == 1


def test_maintain_disk_guard_fault_flips_507_alike(tmp_path):
    """An injected free-space reading failure is a low disk: the guard
    reads breached, the shared upsert gate answers the same 507 in both
    packages, and the next clean reading acks the same upsert."""
    dirs = copies(tmp_path, _fragmented_store)
    body = json.dumps({"variants": [{"id": "6:999999:A:G"}]}).encode()
    got = {}
    for pkg in PKGS:
        d = dirs[pkg]
        maint = pkg.mod("store.maintenance")
        guard = maint.DiskReserveGuard(d, reserve=1, ttl_s=0.0, log=_quiet)
        states = [armed(pkg, "maintain.disk_guard:1:eio", guard.state,
                        force=True)[0], guard.state(force=True)[0]]
        snaps = pkg.mod("serve.snapshot")
        mem = _memtable(pkg, d)
        httpd = pkg.mod("serve.http").build_server(
            manager=snaps.MemtableSnapshots(
                snaps.SnapshotManager(d, log=_quiet), mem),
            port=0, memtable=mem, **pkg.kw)
        ctx = httpd.ctx
        try:
            ctx.disk_guard = maint.DiskReserveGuard(d, reserve=1, ttl_s=0.0,
                                                    log=_quiet)
            first = armed(pkg, "maintain.disk_guard:1:raise",
                          ctx.upsert_execute, body)[:2]
            rows_after_507 = mem.rows
            second = ctx.upsert_execute(body)[:2]
            got[pkg] = (states, first, rows_after_507, masked(second, d),
                        mem.rows)
        finally:
            httpd.server_close()
            ctx.batcher.close()
            mem.wal.close(remove_if_empty=True)
    want = same(got)
    assert want[0] == [True, False] and want[1][0] == 507
    assert want[2] == 0 and want[3][0] == 200 and want[4] == 1


# ---------------------------------------------------------------------------
# fsck.repair


@pytest.mark.parametrize("fault", ["fsck.repair:1:raise", "fsck.repair:1:eio"])
def test_fsck_repair_commit_fault_matches_the_reference(tmp_path, fault):
    def build(d):
        _fragmented_store(d)
        seg = sorted(f for f in os.listdir(d) if f.endswith(".npz"))[1]
        with open(os.path.join(d, seg), "r+b") as f:
            f.truncate(16)

    dirs = copies(tmp_path, build)
    got = {}
    for pkg in PKGS:
        d = dirs[pkg]
        fsck = pkg.mod("store.fsck").fsck
        outcome = armed(pkg, fault, fsck, d, repair=True, log=_quiet)
        crashed = dir_state(d)
        report = fsck(d, repair=True, log=_quiet)
        deep = fsck(d, deep=True, log=_quiet)["exit_code"]
        got[pkg] = (outcome, crashed, masked(report, d), deep, dir_state(d))
    want = same(got)
    assert want[0].startswith("raised") and want[3] == 0
    assert any("tmp<pid>" in name for name in want[1])


# ---------------------------------------------------------------------------
# repl.ship / repl.apply / repl.promote


class _Leader:
    """One in-process leader of ``pkg`` (store, memtable, WAL, threaded
    front end) with the matrix's rows upserted."""

    def __init__(self, pkg, store_dir):
        mem = _memtable(pkg, store_dir)
        store = _base(pkg, store_dir)
        for row in _REPL_ROWS:
            mem.upsert(store, [dict(row)], durable=True)
        snaps = pkg.mod("serve.snapshot")
        self.httpd = pkg.mod("serve.http").build_server(
            manager=snaps.MemtableSnapshots(
                snaps.SnapshotManager(store_dir, log=_quiet), mem),
            port=0, memtable=mem, **pkg.kw)
        threading.Thread(target=self.httpd.serve_forever, daemon=True).start()
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}"
        self.mem = mem

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.httpd.ctx.batcher.close()
        self.mem.wal.close()


def _repl_case(tmp_path, run):
    dirs = copies(tmp_path, lambda d: _tiny_store().save(d), "leader")
    got = {}
    for pkg in PKGS:
        leader = _Leader(pkg, dirs[pkg])
        fdir = str(tmp_path / str(pkg) / "follower")
        try:
            got[pkg] = masked(run(pkg, pkg.mod("store.replication"),
                                  leader.url, fdir), fdir, leader.url)
        finally:
            leader.close()
    return same(got)


def _rows(applied):
    return [(r["pos"], r["ref"], r["alt"]) for r in applied]


@pytest.mark.parametrize("fault", ["repl.ship:1:raise", "repl.ship:1:eio"])
def test_repl_ship_fault_cycle_retries_alike(tmp_path, fault):
    def run(pkg, repl, url, fdir):
        applied = []
        tailer = repl.ReplicaTailer(fdir, url, log=_quiet,
                                    apply_rows=applied.extend)
        outcome = armed(pkg, fault, tailer.sync_once)
        first = (outcome, _rows(applied), dir_state(fdir))
        tailer.sync_once()
        return first, _rows(applied), dir_state(fdir)

    want = _repl_case(tmp_path, run)
    assert want[0][0] == "raised ReplError" and want[0][1] == []
    assert [r[0] for r in want[1]] == [15, 25]


def test_repl_apply_fault_restart_lands_on_the_same_prefix(tmp_path):
    def run(pkg, repl, url, fdir):
        t1 = repl.ReplicaTailer(fdir, url, log=_quiet)
        t1.bootstrap()
        applied = []
        t1.apply_rows = applied.extend
        outcome = armed(pkg, "repl.apply:1:raise", t1.sync_once)
        crashed = dir_state(fdir)
        t2 = repl.ReplicaTailer(fdir, url, log=_quiet)
        recovered = t2.resume()
        replayed = [r["pos"] for rec in t2.local_records()
                    for r in rec["rows"]]
        live = []
        t2.apply_rows = live.extend
        t2.sync_once()
        return (outcome, applied, crashed, recovered, replayed,
                _rows(live), dir_state(fdir))

    want = _repl_case(tmp_path, run)
    assert want[0] == "raised InjectedFault" and want[1] == []
    assert sorted(want[4] + [r[0] for r in want[5]]) == [15, 25]


@pytest.mark.parametrize("fault", ["repl.promote:1:raise",
                                   "repl.promote:2:raise",
                                   "repl.promote:2:eio"])
def test_repl_promote_fault_leaves_the_same_follower(tmp_path, fault):
    def run(pkg, repl, url, fdir):
        tailer = repl.ReplicaTailer(fdir, url, log=_quiet)
        tailer.bootstrap()
        tailer.sync_once()
        before = dir_state(fdir)
        outcome = armed(pkg, fault, repl.promote, fdir, log=_quiet)
        crashed = dir_state(fdir)
        out = repl.promote(fdir, log=_quiet)
        return (before == crashed, outcome, crashed, out["status"],
                out["epoch"], dir_state(fdir))

    want = _repl_case(tmp_path, run)
    assert want[1] == ("raised InjectedFault" if "raise" in fault
                       else "raised OSError:5")
    assert want[3:5] == ["promoted", 1]
    # hit 1 mutates nothing; hit 2 (the staged epoch manifest) leaves the
    # sealed tail's flush behind it, never the epoch bump
    assert want[0] == fault.startswith("repl.promote:1")
    assert want[2]["manifest.json"].get("repl_epoch", 0) == 0


# ---------------------------------------------------------------------------
# export.plan / export.pack / export.commit


def _export_store(d):
    _tiny_store().save(d)


def _run_export(pkg, store_dir, out_dir, **kw):
    store, ledger = _open(pkg, store_dir)
    return pkg.mod("export.core").run_export(
        store, ledger, store_dir, out_dir, seed=5, batch_rows=2,
        part_bytes=1, **kw, **pkg.kw)


def _open(pkg, store_dir):
    store_mod = pkg.mod("store")
    return (store_mod.VariantStore.load(store_dir, readonly=True),
            store_mod.AlgorithmLedger(os.path.join(store_dir,
                                                   "ledger.jsonl")))


def _summary(s):
    if not isinstance(s, dict):
        return s
    return {k: v for k, v in s.items()
            if k != "seconds" and "per_s" not in k and "stage" not in k}


@pytest.mark.parametrize("fault", [
    "export.plan:1:raise", "export.plan:1:eio",
    "export.pack:2:raise", "export.pack:2:eio",
    "export.commit:1:raise", "export.commit:2:raise",
    "export.commit:2:eio", "export.commit:3:raise",
])
def test_export_faults_match_the_reference(tmp_path, fault):
    """Each fault leaves the same committed-part prefix (or no directory),
    the same debris and the same ledger; the resume (or re-run) writes the
    reference's corpus, byte for byte, equal to an uninterrupted run."""
    dirs = copies(tmp_path, _export_store)
    got = {}
    for pkg in PKGS:
        root = str(tmp_path / str(pkg))
        d, out = dirs[pkg], os.path.join(root, "out")
        clean = os.path.join(root, "clean")
        shutil.copytree(d, clean)
        _run_export(pkg, clean, os.path.join(root, "clean-out"))
        outcome = armed(pkg, fault, _run_export, pkg, d, out)
        crashed = (dir_state(out), dir_state(d, mask=root))
        resumed = _run_export(pkg, d, out, resume=True)
        got[pkg] = (outcome, crashed, masked(_summary(resumed), root),
                    dir_state(out), dir_state(d, mask=root))
        assert dir_state(out) == dir_state(os.path.join(root, "clean-out"))
    want = same(got)
    assert want[0].startswith("raised")
    assert (want[1][0] is None) == fault.startswith("export.plan")


def test_reference_resumes_what_the_killed_port_cli_left(tmp_path):
    """The mirror of ``test_torch_export``'s crossed resume: the PORT's
    ``export`` CLI dies at ``export.commit:2:kill`` (after its one part,
    on the manifest temp),
    and the REFERENCE's CLI resumes that directory to the corpus an
    uninterrupted reference run writes."""
    dirs = copies(tmp_path, _export_store)
    flags = ["--seed", "5", "--batchRows", "8", "--partBytes", "1",
             "--commit"]
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               AVDB_FAULT="export.commit:2:kill")
    out = str(tmp_path / "out")
    p = subprocess.run(
        [sys.executable, "-m", PORT.root, "export", "--storeDir", dirs[PORT],
         "--out", out, "--platform", "cpu", *flags],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert p.returncode == -signal.SIGKILL, p.stderr[-2000:]
    crashed = dir_state(out)
    assert "part-000000.npz" in crashed
    assert "corpus.manifest.json" not in crashed
    assert ".corpus.manifest.json.tmp<pid>" in crashed
    env.pop("AVDB_FAULT")
    for store_dir, out_dir in ((dirs[PORT], out),
                               (dirs[REF], str(tmp_path / "clean"))):
        p = subprocess.run(
            [sys.executable, "-m", REF.root, "export", "--storeDir",
             store_dir, "--out", out_dir, *flags],
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=240)
        assert p.returncode == 0, p.stderr[-2000:]
    assert dir_state(out) == dir_state(str(tmp_path / "clean"))
