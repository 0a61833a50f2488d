"""The lock-order / deadlock detector (``AVDB_LOCK_TRACE=1``) in the port:
``utils.locks`` and ``analysis.lockorder``, against the JAX package's, on
the CPU.

- The reference's ``tests/test_locks.py`` on the port's modules: the
  wrapper's mechanics (a plain stdlib lock unarmed, a recording
  ``TracedLock`` armed), the detector's semantics (an ABBA inversion is a
  cycle, consistent orders and reentrant re-acquires are not, held time
  lands in ``avdb_lock_held_seconds`` of the port's metrics registry),
  and the 4-thread serve battery traced with no cycle.
- Parity: one threaded server of each package, built with tracing armed
  over byte-equal copies of one store and driven sequentially through a
  point, a bulk, a region, a stats panel and an upsert with its flush,
  records the same lock names and the same acquisition-order edges, and
  no cycle.
"""

from __future__ import annotations

import threading

import pytest

from annotatedvdb_tpu.analysis.lockorder import RECORDER as REF_RECORDER

from annotatedvdb_tpu_torch.analysis.lockorder import (
    RECORDER,
    LockOrderRecorder,
)
from annotatedvdb_tpu_torch.utils.locks import TracedLock, make_lock

import test_locks as ref_locks
import test_torch_replication as tr
import test_torch_upsert as tu
from test_torch_replication import time_limit  # noqa: F401 (fixture)


# ---------------------------------------------------------------------------
# wrapper mechanics


def test_make_lock_unarmed_is_plain_stdlib_lock(monkeypatch):
    monkeypatch.delenv("AVDB_LOCK_TRACE", raising=False)
    lock = make_lock("x")
    assert type(lock) is type(threading.Lock())
    rlock = make_lock("x", reentrant=True)
    assert type(rlock) is type(threading.RLock())


def test_make_lock_armed_returns_traced(monkeypatch):
    monkeypatch.setenv("AVDB_LOCK_TRACE", "1")
    lock = make_lock("test.armed")
    assert isinstance(lock, TracedLock)
    with lock:
        assert lock.locked()
    assert not lock.locked()


def test_traced_lock_api_matches_stdlib():
    rec = LockOrderRecorder()
    lock = TracedLock("test.api", recorder=rec)
    assert lock.acquire()
    assert not lock.acquire(blocking=False)  # held: non-blocking fails
    lock.release()
    assert lock.acquire(timeout=1.0)
    lock.release()
    assert rec.held_stats()["test.api"]["count"] == 2


def test_failed_acquire_records_nothing():
    rec = LockOrderRecorder()
    a = TracedLock("test.a", recorder=rec)
    b = TracedLock("test.b", recorder=rec)
    with a:
        done = threading.Event()

        def contender():
            # a is held by the main thread: this acquire must fail and
            # leave no (b -> a) ordering edge behind
            with b:
                assert not a.acquire(blocking=False)
            done.set()

        t = threading.Thread(target=contender)
        t.start()
        assert done.wait(5)
        t.join()
    assert ("test.b", "test.a") not in rec.snapshot_edges()


# ---------------------------------------------------------------------------
# detector semantics


def _run_threads(*fns):
    threads = [threading.Thread(target=fn) for fn in fns]
    for t in threads:
        t.start()
    for t in threads:
        t.join(10)


def test_abba_inversion_is_a_cycle():
    rec = LockOrderRecorder()
    a = TracedLock("order.a", recorder=rec)
    b = TracedLock("order.b", recorder=rec)
    gate = threading.Event()

    def t1():
        with a:
            with b:
                pass
        gate.set()

    def t2():
        gate.wait(5)  # sequential: records the inverted ORDER, no hang
        with b:
            with a:
                pass

    _run_threads(t1, t2)
    cycles = rec.cycles()
    assert len(cycles) == 1
    assert set(cycles[0]) == {"order.a", "order.b"}


def test_consistent_order_is_clean():
    rec = LockOrderRecorder()
    a = TracedLock("order.a", recorder=rec)
    b = TracedLock("order.b", recorder=rec)

    def worker():
        for _ in range(50):
            with a:
                with b:
                    pass

    _run_threads(worker, worker, worker)
    assert rec.cycles() == []
    assert rec.snapshot_edges() == {("order.a", "order.b"): 150}


def test_three_lock_cycle_detected():
    rec = LockOrderRecorder()
    locks = {n: TracedLock(f"tri.{n}", recorder=rec) for n in "abc"}

    def pair(x, y):
        with locks[x]:
            with locks[y]:
                pass

    pair("a", "b")
    pair("b", "c")
    pair("c", "a")
    cycles = rec.cycles()
    assert len(cycles) == 1
    assert set(cycles[0]) == {"tri.a", "tri.b", "tri.c"}


def test_reentrant_acquire_no_self_edge():
    rec = LockOrderRecorder()
    r = TracedLock("re.lock", reentrant=True, recorder=rec)
    with r:
        with r:
            pass
    assert rec.cycles() == []
    assert rec.snapshot_edges() == {}
    # both nesting levels accounted as holds
    assert rec.held_stats()["re.lock"]["count"] == 2


def test_hand_over_hand_release_order():
    rec = LockOrderRecorder()
    a = TracedLock("hoh.a", recorder=rec)
    b = TracedLock("hoh.b", recorder=rec)
    a.acquire()
    b.acquire()
    a.release()  # release order != acquire order
    b.release()
    assert rec.cycles() == []
    stats = rec.held_stats()
    assert stats["hoh.a"]["count"] == 1 and stats["hoh.b"]["count"] == 1


def test_held_histogram_exported_through_obs_registry():
    from annotatedvdb_tpu_torch.obs.metrics import MetricsRegistry

    rec = LockOrderRecorder()
    lock = TracedLock("hist.lock", recorder=rec)
    for _ in range(5):
        with lock:
            pass
    assert isinstance(rec.registry, MetricsRegistry)
    snap = rec.registry.snapshot()
    series = snap["avdb_lock_held_seconds"]
    (entry,) = [e for e in series if e["labels"] == {"lock": "hist.lock"}]
    assert entry["count"] == 5
    assert "avdb_lock_held_seconds_bucket" in rec.render_prometheus()


def test_report_shape_and_reset():
    rec = LockOrderRecorder()
    a = TracedLock("rep.a", recorder=rec)
    with a:
        pass
    rep = rec.report()
    assert rep["locks"] == ["rep.a"]
    assert rep["cycles"] == []
    assert rep["held"]["rep.a"]["count"] == 1
    rec.reset()
    assert rec.report() == {
        "locks": [], "edges": {}, "cycles": [], "held": {},
    }


# ---------------------------------------------------------------------------
# the serve stack under AVDB_LOCK_TRACE=1


@pytest.fixture()
def traced_recorders(monkeypatch):
    """Arm tracing on both packages' GLOBAL recorders for serve-stack
    builds (the flag is read when a lock is made: build after this)."""
    monkeypatch.setenv("AVDB_LOCK_TRACE", "1")
    for rec in (RECORDER, REF_RECORDER):
        rec.reset()
    yield RECORDER
    for rec in (RECORDER, REF_RECORDER):
        rec.reset()


def test_serve_battery_traces_clean(tmp_path, traced_recorders):
    """The port's serve stack — point batching, bulk lookup, region reads
    (index build + LRU), admission accounting, snapshot refresh — driven
    from four threads under tracing: the acquisition-order graph must be
    acyclic, and the stack's named locks must show up."""
    from annotatedvdb_tpu_torch.obs.metrics import MetricsRegistry
    from annotatedvdb_tpu_torch.serve.batcher import QueryBatcher
    from annotatedvdb_tpu_torch.serve.engine import QueryEngine
    from annotatedvdb_tpu_torch.serve.http import ServeContext
    from annotatedvdb_tpu_torch.serve.snapshot import SnapshotManager

    store_dir = str(tmp_path / "store")
    ref_locks._tiny_store(store_dir)
    manager = SnapshotManager(store_dir)
    registry = MetricsRegistry()
    engine = QueryEngine(manager, registry=registry, region_cache_size=8,
                         device="cpu")
    batcher = QueryBatcher(engine, max_batch=16, max_wait_s=0.001,
                           registry=registry)
    ctx = ServeContext(manager, engine, batcher, registry)
    try:
        errors: list = []

        def hammer(salt: int):
            try:
                for i in range(20):
                    pos = 1000 + 97 * ((i + salt) % 64)
                    ref = ["A", "C", "G", "T"][(i + salt) % 4]
                    alt = ["G", "T", "A", "C"][(i + salt) % 4]
                    batcher.submit(f"8:{pos}:{ref}:{alt}")
                    engine.lookup_many(
                        [f"8:{1000 + 97 * j}:A:G" for j in range(4)]
                    )
                    engine.region("8:1-100000", limit=5,
                                  min_cadd=1.0 if i % 2 else None)
                    assert ctx.admit()
                    ctx.observe("point", 0.001, rows=1)
                    ctx.release()
                    ctx.refresh_snapshot()
            except Exception as err:  # surfaced below, not swallowed
                errors.append(err)

        _run_threads(*(lambda s=s: hammer(s) for s in range(4)))
        assert not errors, errors
    finally:
        batcher.close()
    rep = traced_recorders.report()
    assert rep["cycles"] == [], rep
    seen = set(rep["locks"])
    assert {"serve.engine.cache", "serve.batcher.stats",
            "serve.ctx.inflight", "serve.snapshot.pin"} <= seen, seen
    assert rep["held"]["serve.ctx.inflight"]["count"] >= 80


#: the sequential drive: a point, a bulk, a region, a stats panel and an
#: upsert (its flush follows)
DRIVE = [
    ("GET", "/variant/3:20:A:C", None),
    ("POST", "/variants", {"ids": ["3:10:A:C", "3:30:A:C", "3:99:A:C"]}),
    ("GET", "/region/3:1-100", None),
    ("POST", "/stats/region", {"regions": ["3:1-100", "3:12-26"],
                               "windows": 2}),
    ("POST", "/variants/upsert", {"variants": [{"id": "3:15:A:G",
                                                "ref_snp": 42}]}),
]

#: background ticks off, so only the drive takes locks
QUIET_ENV = {"AVDB_OBS_TICK_S": "0", "AVDB_OBS_HISTORY_S": "0",
             "AVDB_FLIGHT_EVENTS": "0", "AVDB_MEMTABLE_BYTES": "0",
             "AVDB_MEMTABLE_FLUSH_S": "0"}


def _drive(pkg, store_dir):
    """Package ``pkg``'s threaded server over ``store_dir`` with a memtable
    and WAL, built now (under the armed flag), driven through
    :data:`DRIVE` one request at a time, then flushed and stopped."""
    p = tr.PKG[pkg]
    mgr = p.Manager(store_dir, ttl_s=0.0, **tu.QUIET)
    mem = p.Memtable(width=tu.WIDTH, store_dir=store_dir,
                     wal=p.Wal(store_dir, "serve-t", **tu.QUIET), **tu.QUIET)
    srv = tr._start(pkg, "threaded", manager=p.Overlay(mgr, mem),
                    memtable=mem, registry=p.Registry())
    try:
        for method, path, body in DRIVE:
            status, out = tu._request(srv.server_address[1], method, path,
                                      body)
            assert status == 200, (pkg, path, out)
        assert mem.flush(mgr)["status"] == "flushed"
    finally:
        tr._stop(srv)
        mem.wal.close(remove_if_empty=True)


def test_serve_drive_takes_the_references_locks_in_its_order(
        tmp_path, traced_recorders, monkeypatch, time_limit):
    for k, v in QUIET_ENV.items():
        monkeypatch.setenv(k, v)
    ref_dir, port_dir = tu._two_copies(tmp_path)
    _drive("ref", ref_dir)
    _drive("port", port_dir)
    want, got = REF_RECORDER.report(), RECORDER.report()
    assert got["cycles"] == [] == want["cycles"]
    assert got["locks"] == want["locks"]
    assert sorted(got["edges"]) == sorted(want["edges"])
    assert {"serve.engine.cache", "serve.ctx.inflight",
            "serve.snapshot.pin"} <= set(got["locks"]), got["locks"]
