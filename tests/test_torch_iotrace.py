"""The crash-consistency sanitizer (``AVDB_IO_TRACE=1``) in the port: the
``utils/io`` traced wrappers, the ``analysis/iotrace`` happens-before
recorder, and the port's store, replication and export writers driven end
to end with tracing armed, against the JAX package's on the same
operations, on the CPU.

The first cases are the reference's ``tests/test_iotrace.py`` run on the
port's modules.  The parity cases run one lifecycle through each package
in turn, each over its own directory and reporting to its own recorder —
a store built in three saves, a memtable upsert and flush, a compaction,
an fsck repair of planted debris, a leader's upserts shipped to a
bootstrapped, tailed and promoted follower, and a corpus export — once
with and once without ``AVDB_FSYNC=1``: the two reports must be equal
with paths relative to each package's directory (``events``,
``violations`` — ``[]`` in both —, ``dirty``, ``pending_dir_fsync``).
"""

import json
import os
import types

import numpy as np
import pytest

from annotatedvdb_tpu.analysis.iotrace import RECORDER as REF_RECORDER
from annotatedvdb_tpu.loaders.lookup import identity_hashes as ref_identity_hashes
from annotatedvdb_tpu.store import compact as ref_compact
from annotatedvdb_tpu.store import fsck as ref_fsck
from annotatedvdb_tpu.store import memtable as ref_memtable
from annotatedvdb_tpu.store import replication as ref_repl
from annotatedvdb_tpu.store import wal as ref_wal
from annotatedvdb_tpu.store.variant_store import Segment as RefSegment
from annotatedvdb_tpu.store.variant_store import VariantStore as RefStore
from annotatedvdb_tpu.types import encode_allele_array as ref_encode

from annotatedvdb_tpu_torch.analysis.iotrace import (
    RECORDER,
    IoTraceRecorder,
    _durable_class,
    _manifest_refs,
)
from annotatedvdb_tpu_torch.loaders.lookup import identity_hashes
from annotatedvdb_tpu_torch.store import compact, fsck, memtable, wal
from annotatedvdb_tpu_torch.store import replication as repl
from annotatedvdb_tpu_torch.store.variant_store import Segment, VariantStore
from annotatedvdb_tpu_torch.types import encode_allele_array
from annotatedvdb_tpu_torch.utils import io as tio

import test_torch_export as te
import test_torch_replication as tr
from test_torch_replication import time_limit  # noqa: F401 (fixture)

WIDTH = 8
QUIET = dict(log=lambda m: None)

PKG = {
    "ref": types.SimpleNamespace(
        Store=RefStore, Segment=RefSegment, encode=ref_encode,
        hashes=ref_identity_hashes, Memtable=ref_memtable.Memtable,
        Wal=ref_wal.WriteAheadLog, compact=ref_compact.compact_store,
        fsck=ref_fsck.fsck, repl=ref_repl, export=te._ref_export,
        recorder=REF_RECORDER),
    "port": types.SimpleNamespace(
        Store=VariantStore, Segment=Segment, encode=encode_allele_array,
        hashes=identity_hashes, Memtable=memtable.Memtable,
        Wal=wal.WriteAheadLog, compact=compact.compact_store,
        fsck=fsck.fsck, repl=repl, export=te._port_export,
        recorder=RECORDER),
}


@pytest.fixture()
def traced(monkeypatch):
    """Arm tracing around one test, with both packages' recorders clean
    on both sides."""
    monkeypatch.setenv("AVDB_IO_TRACE", "1")
    for rec in (RECORDER, REF_RECORDER):
        rec.reset()
    yield RECORDER
    for rec in (RECORDER, REF_RECORDER):
        rec.reset()


def _kinds(recorder) -> set:
    return {v["kind"] for v in recorder.violations()}


# -- wrapper semantics -------------------------------------------------------


def test_unarmed_wrappers_are_passthrough(tmp_path, monkeypatch):
    """Unarmed, tio.open returns the raw file (no proxy) and no wrapper
    call touches the recorder."""
    monkeypatch.delenv("AVDB_IO_TRACE", raising=False)
    RECORDER.reset()
    p = str(tmp_path / "a.txt")
    f = tio.open(p, "w")
    assert type(f).__name__ != "TracedFile"
    f.write("x")
    tio.fsync(f)
    f.close()
    tio.replace(p, str(tmp_path / "b.txt"))
    tio.rename(str(tmp_path / "b.txt"), str(tmp_path / "c.txt"))
    tio.unlink(str(tmp_path / "c.txt"))
    tio.fsync_dir(str(tmp_path))
    assert RECORDER.report()["events"] == 0
    assert RECORDER.violations() == []


def test_traced_file_api_parity(tmp_path, traced):
    """The proxy answers every file-API surface the writers use."""
    p = str(tmp_path / "a.txt")
    with tio.open(p, "w") as f:
        assert type(f).__name__ == "TracedFile"
        f.write("line1\n")
        f.flush()
        assert isinstance(f.fileno(), int)
        assert f.tell() > 0
        assert f.name == p
        assert not f.closed
    assert f.closed
    # read opens stay raw even when armed (only writes are judged)
    with tio.open(p) as rf:
        assert type(rf).__name__ != "TracedFile"
        assert list(rf) == ["line1\n"]
    assert traced.report()["events"] >= 2  # the open + at least one write


def test_traced_file_serves_the_writers_callers(tmp_path, traced):
    """``np.lib.format.write_array`` writes through the proxy, an ``r+b``
    open (the replication mirror's) truncates through it, and a fault
    hook's tear (``truncate`` at ``tell() // 2``) reaches the real file."""
    p = str(tmp_path / "a.npy")
    arr = np.arange(100, dtype=np.int64)
    with tio.open(p, "wb") as f:
        np.lib.format.write_array(f, arr, allow_pickle=False)
        f.flush()
        tio.fsync(f)
    assert np.array_equal(np.load(p), arr)
    assert traced.report()["dirty"] == []
    with tio.open(p, "r+b") as f:
        assert type(f).__name__ == "TracedFile"
        f.seek(0, os.SEEK_END)
        f.truncate(f.tell() // 2)
        f.seek(0, os.SEEK_END)
        f.write(b"\0")
    assert os.path.getsize(p) == (arr.nbytes + 128) // 2 + 1
    assert traced.report()["dirty"] == [p]  # written, never synced since


def test_manifest_refs_both_formats(tmp_path):
    m1 = tmp_path / "m1.json"
    m1.write_text(json.dumps({"shards": {"8": [0, 1]}}))
    assert _manifest_refs(str(m1)) == {
        "chr8.000000.npz", "chr8.000000.ann.jsonl",
        "chr8.000001.npz", "chr8.000001.ann.jsonl",
    }
    m2 = tmp_path / "m2.json"
    m2.write_text(json.dumps({"format": 2, "shards": {"X": [3]}}))
    assert _manifest_refs(str(m2)) == {
        "chrX.000003.npz", "chrX.000003.ann.jsonl",
    }
    assert _manifest_refs(str(tmp_path / "absent.json")) == set()


def test_durable_class_taxonomy():
    assert _durable_class("manifest.json") == "manifest"
    assert _durable_class("serve-w0.wal") == "wal"
    assert _durable_class("chr8.000000.npz") == "data"
    assert _durable_class(".manifest.json.tmp123") is None
    assert _durable_class("chr8.000000.flush.tmp.npz") is None


# -- recorder judgments ------------------------------------------------------


def test_clean_commit_protocol_records_no_violation(tmp_path, traced):
    mpath = str(tmp_path / "manifest.json")
    tmp = mpath + ".t"
    with tio.open(tmp, "w") as f:
        f.write(json.dumps({"shards": {}}))
        f.flush()
        tio.fsync(f)
    tio.replace(tmp, mpath)
    assert traced.violations() == []


def test_misordered_writer_detected(tmp_path, traced, monkeypatch):
    """A writer that renames before fsync and never dir-fsyncs trips
    both judgments — the shape AVDB1001 proves statically, seen live."""
    monkeypatch.setenv("AVDB_FSYNC", "1")
    mpath = str(tmp_path / "manifest.json")
    tmp = mpath + ".t"
    with tio.open(tmp, "w") as f:
        f.write(json.dumps({"shards": {}}))
    tio.replace(tmp, mpath)  # dirty source: no fsync ever happened
    assert _kinds(traced) == {
        "rename-before-fsync", "manifest-replace-without-dir-fsync",
    }


def test_data_class_judged_only_under_avdb_fsync(tmp_path, traced,
                                                 monkeypatch):
    """Segment-data durability is the AVDB_FSYNC opt-in; the recorder
    mirrors it instead of inventing a stricter contract."""
    seg = str(tmp_path / "chr8.000000.npz")
    monkeypatch.delenv("AVDB_FSYNC", raising=False)
    with tio.open(seg + ".t", "wb") as f:
        f.write(b"x")
    tio.replace(seg + ".t", seg)
    assert traced.violations() == []  # unarmed: page-cache durability ok
    monkeypatch.setenv("AVDB_FSYNC", "1")
    with tio.open(seg + ".t", "wb") as f:
        f.write(b"x")
    tio.rename(seg + ".t", seg)
    assert _kinds(traced) == {"rename-before-fsync"}


def test_unlink_of_manifest_referenced_file_detected(tmp_path, traced):
    store = tmp_path / "store"
    store.mkdir()
    live = store / "chr8.000000.npz"
    live.write_bytes(b"seg")
    stale = store / ".manifest.json.tmp999"
    stale.write_bytes(b"junk")
    tio.replace_manifest(str(store / "manifest.json"),
                         {"shards": {"8": [0]}})
    tio.unlink(str(stale))  # debris: not referenced, no violation
    assert traced.violations() == []
    tio.unlink(str(live))
    assert _kinds(traced) == {"unlink-live-file"}


def test_dir_fsync_discharges_manifest_obligation(tmp_path, traced,
                                                  monkeypatch):
    monkeypatch.setenv("AVDB_FSYNC", "1")
    mpath = str(tmp_path / "manifest.json")
    tmp = mpath + ".t"
    with tio.open(tmp, "w") as f:
        f.write(json.dumps({"shards": {}}))
        tio.fsync(f)
    tio.replace(tmp, mpath)
    assert _kinds(traced) == {"manifest-replace-without-dir-fsync"}
    tio.fsync_dir(str(tmp_path))
    assert traced.violations() == []


def test_replace_manifest_helper_is_clean_under_full_durability(
        tmp_path, traced, monkeypatch):
    """The helper discharges every obligation it creates, the directory
    fsync included."""
    monkeypatch.setenv("AVDB_FSYNC", "1")
    tio.replace_manifest(str(tmp_path / "manifest.json"), {"shards": {}})
    assert traced.violations() == []
    # pre-serialized bytes land byte-identical (the repl mirror's format)
    blob = b'{"shards": {}}\n'
    tio.replace_manifest(str(tmp_path / "manifest.json"), blob)
    assert traced.violations() == []
    with open(str(tmp_path / "manifest.json"), "rb") as f:
        assert f.read() == blob


def test_recorder_reset_and_report_shape(traced):
    rec = IoTraceRecorder()
    rec.note_write("/x/a")
    rec.note_rename("/x/a", "/x/serve-w0.wal")
    assert len(rec.violations()) == 1
    report = rec.report()
    assert set(report) == {"events", "violations", "dirty",
                          "pending_dir_fsync"}
    rec.reset()
    assert rec.report() == {"events": 0, "violations": [], "dirty": [],
                            "pending_dir_fsync": []}


# -- the real writers, traced, against the reference ------------------------


def _segment(p, code, base, salt, n=24):
    """One segment of ``n`` rows of chromosome ``code`` built by package
    ``p`` (real identity hashes, CADD on every third row)."""
    bases = "ACGT"
    refs = [bases[(i + salt) % 4] + ("GT" if i % 7 == 3 else "")
            for i in range(n)]
    alts = [bases[(i + salt + 1) % 4] for i in range(n)]
    ref, ref_len = p.encode(refs, WIDTH)
    alt, alt_len = p.encode(alts, WIDTH)
    h = p.hashes(WIDTH, ref, alt, ref_len, alt_len, refs, alts)
    return p.Segment.build(
        {"pos": np.arange(base, base + 37 * n, 37, dtype=np.int32), "h": h,
         "ref_len": ref_len, "alt_len": alt_len},
        ref, alt,
        annotations={"cadd_scores": [{"CADD_phred": float(i)} if i % 3 == 0
                                     else None for i in range(n)]},
    )


def _build(p, store_dir):
    """A store saved three times (one new segment a save, two groups)."""
    store = p.Store(width=WIDTH)
    for salt, (code, base) in enumerate(((3, 100), (8, 500), (3, 5000))):
        store.shard(code).append_segment(_segment(p, code, base, salt))
        store.save(store_dir)
    return store


def _lifecycle(pkg, root):
    """Every durable writer of package ``pkg`` once, under ``root``."""
    p = PKG[pkg]
    store_dir = os.path.join(root, "vdb")
    store = _build(p, store_dir)
    mem = p.Memtable(width=WIDTH, store_dir=store_dir,
                     wal=p.Wal(store_dir, "trace-w0", **QUIET), **QUIET)
    mem.upsert(store, [{"code": 3, "pos": 77, "ref": "A", "alt": "G"}],
               durable=True)
    assert mem.flush()["status"] == "flushed"
    mem.wal.close(remove_if_empty=True)
    assert p.compact(store_dir, **QUIET)["status"] == "compacted"
    with open(os.path.join(store_dir, ".manifest.json.tmp42"), "w") as f:
        f.write("junk")
    report = p.fsck(store_dir, repair=True, **QUIET)
    assert report["status"] == "repaired" and report["repairs"]
    # a leader's upserts shipped to a follower, which is promoted
    leader_dir = os.path.join(root, "leader")
    _build(p, leader_dir)
    leader = tr._Leader(pkg, leader_dir, seed=False)
    try:
        leader.upsert([{"id": "3:15:A:G"}, {"id": "3:25:AT:A", "ref_snp": 9}])
        follower = os.path.join(root, "follower")
        tailer = p.repl.ReplicaTailer(follower, leader.url, **QUIET)
        tailer.bootstrap()
        assert tailer.sync_once()["applied"] == 1
        out = p.repl.promote(follower, **QUIET)
        assert out["status"] == "promoted" and out["rows"] == 2
    finally:
        leader.close()
    summary = p.export(store_dir, os.path.join(root, "corpus"))
    assert summary["parts"]
    return p.recorder.report()


def _relative(report, root):
    def rel(path):
        return os.path.relpath(path, root)

    return {"events": report["events"],
            "violations": [dict(v, path=rel(v["path"]))
                           for v in report["violations"]],
            "dirty": sorted(rel(x) for x in report["dirty"]),
            "pending_dir_fsync": sorted(rel(x)
                                        for x in report["pending_dir_fsync"])}


@pytest.mark.parametrize("fsync", ["1", None], ids=["fsync", "no-fsync"])
def test_writers_trace_as_the_reference(tmp_path, traced, monkeypatch,
                                        time_limit, fsync):
    if fsync:
        monkeypatch.setenv("AVDB_FSYNC", fsync)
    else:
        monkeypatch.delenv("AVDB_FSYNC", raising=False)
    reports = {pkg: _relative(_lifecycle(pkg, str(tmp_path / pkg)),
                              str(tmp_path / pkg))
               for pkg in ("ref", "port")}
    assert reports["port"] == reports["ref"]
    assert reports["port"]["violations"] == []
    assert reports["port"]["events"] > 300
    assert bool(reports["port"]["dirty"]) == (fsync is None)
