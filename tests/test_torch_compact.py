"""Online compaction (``doctor compact``): the PyTorch port against the JAX
package, on the CPU.

Each case writes one store with the reference and copies it, so each
package compacts its own copy of the same bytes.  Two stores: the
reference's fragmented serving store (three chromosomes, ten segment
files, one shadowed duplicate, one over-width row) and a store written
by memtable flushes, one of them a retried flush whose rows are shadowed
duplicates of the flush before it.  Held equal: every output file byte
for byte (segment containers with their dictionary-coded alleles,
compressed sidecars, the manifest, the ledger with its timing fields
masked), the reports (``seconds`` masked), the dry-run plan and its
``--group`` / ``--maxBytes`` scoping, a pass preempted by a commit
between merge and swap (a real memtable flush), a cancelled pass, the
CLI's exit codes and output, fsck's handling of a killed pass's temps,
and the read bodies of both front ends before and after compaction.
The spill tier (``AVDB_STORE_SPILL_BYTES``): segment containers at or
above the threshold load as copy-on-write memmaps; stores loaded,
updated and re-saved under it (the port reading the reference's store
and the reverse) hold the same bytes, the read bodies and a compaction
over a spilled store are unchanged, and a malformed value raises with
the variable's name.  Its ``compact.*`` fault points are crossed in
``test_torch_faults_store.py``.
"""

import json
import os
import re
import shutil
import threading

import numpy as np
import pytest

import test_serve as ts
from annotatedvdb_tpu.cli import doctor as ref_doctor
from annotatedvdb_tpu.serve import QueryEngine as RefEngine
from annotatedvdb_tpu.serve import SnapshotManager as RefManager
from annotatedvdb_tpu.serve import http as ref_http
from annotatedvdb_tpu.serve.aio import build_aio_server as ref_build_aio
from annotatedvdb_tpu.store import VariantStore as RefStore
from annotatedvdb_tpu.store import compact as ref_compact
from annotatedvdb_tpu.store import fsck as ref_fsck
from annotatedvdb_tpu.store import memtable as ref_memtable

from annotatedvdb_tpu_torch.cli import doctor
from annotatedvdb_tpu_torch.obs.metrics import MetricsRegistry
from annotatedvdb_tpu_torch.serve import http
from annotatedvdb_tpu_torch.serve.aio import build_aio_server
from annotatedvdb_tpu_torch.serve.engine import QueryEngine
from annotatedvdb_tpu_torch.serve.snapshot import SnapshotManager
from annotatedvdb_tpu_torch.store import compact, fsck, memtable
from annotatedvdb_tpu_torch.store.variant_store import VariantStore

QUIET = dict(log=lambda m: None)
FLUSH_WIDTH = 8


def _files(store_dir):
    """{name: bytes} of every file in a store directory, the ledger's
    timestamps and seconds masked."""
    out = {}
    for name in sorted(os.listdir(store_dir)):
        path = os.path.join(store_dir, name)
        if not os.path.isfile(path):
            continue
        with open(path, "rb") as f:
            blob = f.read()
        if name == "ledger.jsonl":
            blob = re.sub(rb'"(ts|seconds)": [0-9.e+-]+', rb'"\1": 0', blob)
        out[name] = blob
    return out


def _masked(report):
    return {k: (0 if k == "seconds" else v) for k, v in report.items()}


def _flushed_rows(k, n=96, code=3, tag=None):
    """``n`` upsert rows of flush ``k`` on chromosome ``code``: mixed SNVs
    and indels, every third row annotated (``tag`` marks a re-submission),
    allele texts drawn from a small set (so the compacted segment's
    dictionary coding engages)."""
    rng = np.random.default_rng(100 + k)
    bases = ["A", "C", "G", "T", "AT", "CGA", "TTG"]
    out = []
    for i in range(n):
        ref = bases[int(rng.integers(len(bases)))]
        alt = bases[int(rng.integers(len(bases)))]
        if alt == ref:
            alt = ref + "C"
        row = {"code": code, "pos": 1000 + 37 * i + 5 * k, "ref": ref,
               "alt": alt, "ref_snp": 700 + 1000 * k + i, "ann": None}
        if i % 3 == 0:
            row["ann"] = {"cadd_scores": {"CADD_phred": round(i * 0.37, 2)},
                          "other_annotation": {"flush": k, "tag": tag}}
        out.append(row)
    return out


def _flushed_store(store_dir):
    """The port's upsert tests' seeded store, then three memtable flushes
    through the reference's flush path (chr5 gets 20 rows in each of the
    first two: a 40-row group, below the dictionary's 64-row floor), and
    a fourth that re-submits the third flush's identities, with other
    annotations, into a memtable that never saw the store: every row of
    it is a shadowed duplicate, and first wins must keep the third's."""
    import test_torch_upsert as tu

    tu._seed_store().save(store_dir)
    for k, base, tag in ((0, True, None), (1, True, None), (2, True, None),
                         (2, False, "again")):
        store = RefStore.load(store_dir, readonly=True) if base else None
        mem = ref_memtable.Memtable(width=FLUSH_WIDTH, store_dir=store_dir,
                                    wal=None, flush_bytes=0, flush_age_s=0,
                                    **QUIET)
        rows = _flushed_rows(k, tag=tag)
        if k < 2:
            rows += _flushed_rows(k, n=20, code=5)
        mem.upsert(store, rows, durable=False)
        assert mem.flush()["status"] == "flushed"


STORES = {"fragmented": ts._build_store, "flushed": _flushed_store}


def _pair(tmp_path, kind):
    ref_dir = str(tmp_path / "ref")
    STORES[kind](ref_dir)
    port_dir = str(tmp_path / "port")
    shutil.copytree(ref_dir, port_dir)
    return ref_dir, port_dir


@pytest.mark.parametrize("kind", sorted(STORES))
@pytest.mark.parametrize("chunk_rows", [None, 1024])
def test_compacted_store_bytes_match_reference(tmp_path, kind, chunk_rows):
    ref_dir, port_dir = _pair(tmp_path, kind)
    assert _files(port_dir) == _files(ref_dir)
    want = ref_compact.compact_store(ref_dir, chunk_rows=chunk_rows, **QUIET)
    got = compact.compact_store(port_dir, chunk_rows=chunk_rows, **QUIET)
    assert want["status"] == "compacted"
    assert _masked(got) == _masked(want)
    assert _files(port_dir) == _files(ref_dir)
    if kind == "flushed":
        # the retried flush's rows are the dropped duplicates
        assert got["rows_dropped"] == 96 and got["labels"] == ["3", "5"]
    else:
        assert got["rows_dropped"] == 1 and got["files_after"] == 3
    # the compacted container codes its alleles with a dictionary and the
    # sidecar is zlib (both read back by the port's own store reader)
    names = set()
    for name in os.listdir(port_dir):
        if name.endswith(".npz"):
            with open(os.path.join(port_dir, name), "rb") as f:
                names |= set(json.loads(f.readline())["names"])
    assert {"ref_dict", "ref_codes"} <= names
    assert compact.segment_spans(port_dir) \
        == ref_compact.segment_spans(ref_dir)
    port = VariantStore.load(port_dir, readonly=True)
    ref = RefStore.load(ref_dir, readonly=True)
    assert port.n == ref.n
    assert fsck.fsck(port_dir, deep=True, **QUIET)["exit_code"] == 0
    # a second pass has nothing left to merge
    assert compact.compact_store(port_dir, **QUIET)["status"] == "noop"


def _cli(main, argv, capsys):
    rc = main(argv)
    cap = capsys.readouterr()
    return rc, cap.out, cap.err


@pytest.mark.parametrize("flags", [
    [], ["--group", "chr8"], ["--group", "8", "--group", "X"],
    ["--maxBytes", "20000"], ["--maxBytes", "0"], ["--group", "22"],
])
def test_dry_run_plan_and_scoping_match_reference(tmp_path, capsys, flags):
    ref_dir, port_dir = _pair(tmp_path, "fragmented")
    before = _files(port_dir)
    for json_flag in ([], ["--json"]):
        argv = ["compact", "--dry-run", *flags, *json_flag]
        want = _cli(ref_doctor.main, argv + ["--storeDir", ref_dir], capsys)
        got = _cli(doctor.main, argv + ["--storeDir", port_dir], capsys)
        assert got[0] == want[0] == 0
        assert got[1].replace(port_dir, "S") == want[1].replace(ref_dir, "S")
        assert got[2].replace(port_dir, "S") == want[2].replace(ref_dir, "S")
    assert _files(port_dir) == before
    scope = {"groups": flags[1::2]} if flags[:1] == ["--group"] else \
        {"max_bytes": int(flags[1])} if flags else {}
    plan = compact.plan_compaction(port_dir, **scope)
    assert plan == {**ref_compact.plan_compaction(ref_dir, **scope),
                    "store_dir": port_dir}
    # a scoped pass compacts exactly the scoped groups
    argv = ["compact", *flags, "--json"]
    want = _cli(ref_doctor.main, argv + ["--storeDir", ref_dir], capsys)
    got = _cli(doctor.main, argv + ["--storeDir", port_dir], capsys)
    assert got[0] == want[0] == 0
    assert _masked(json.loads(got[1].replace(port_dir, "S"))) \
        == _masked(json.loads(want[1].replace(ref_dir, "S")))
    assert _files(port_dir) == _files(ref_dir)


def _commit_between_merge_and_swap(module, store_pkg, store_dir, monkeypatch):
    """Patch ``module._merge_label_to_temp`` so that, after the first
    group's merge, another writer commits: a memtable flush of one new
    row through ``store_pkg``'s flush path."""
    real = module._merge_label_to_temp
    fired = {"n": 0}

    def merge_then_commit(*args, **kw):
        rec = real(*args, **kw)
        if not fired["n"]:
            fired["n"] += 1
            mem = store_pkg.Memtable(width=ts.WIDTH, store_dir=store_dir,
                                     wal=None, flush_bytes=0, flush_age_s=0,
                                     **QUIET)
            mem.upsert(None, [{"code": 8, "pos": 777, "ref": "G", "alt": "A",
                               "ref_snp": 5, "ann": None}], durable=False)
            assert mem.flush()["status"] == "flushed"
        return rec

    monkeypatch.setattr(module, "_merge_label_to_temp", merge_then_commit)
    return fired


def test_commit_mid_pass_preempts_like_reference(tmp_path, monkeypatch):
    ref_dir, port_dir = _pair(tmp_path, "fragmented")
    _commit_between_merge_and_swap(ref_compact, ref_memtable, ref_dir,
                                   monkeypatch)
    _commit_between_merge_and_swap(compact, memtable, port_dir, monkeypatch)
    want = ref_compact.compact_store(ref_dir, **QUIET)
    got = compact.compact_store(port_dir, **QUIET)
    assert got["status"] == "aborted"
    assert got["reason"] == "a loader committed a new generation mid-pass"
    assert _masked(got) == _masked(want)
    files = _files(port_dir)
    assert not [n for n in files if compact.is_compact_tmp(n)]
    # the store holds the original segments plus the flush, nothing else
    assert files == _files(ref_dir)
    assert fsck.fsck(port_dir, deep=True, **QUIET)["exit_code"] == 0


@pytest.mark.parametrize("after", [0, 1, 5])
def test_cancel_aborts_cleanly_like_reference(tmp_path, after):
    ref_dir, port_dir = _pair(tmp_path, "fragmented")
    before = _files(port_dir)
    reports = []
    for module, d in ((ref_compact, ref_dir), (compact, port_dir)):
        calls = {"n": 0}

        def cancel():
            calls["n"] += 1
            return calls["n"] > after

        reports.append(module.compact_store(d, cancel=cancel, **QUIET))
    want, got = reports
    assert got["status"] == "aborted"
    assert _masked(got) == _masked(want)
    assert _files(port_dir) == before == _files(ref_dir)


def test_stale_plan_label_preempts(tmp_path, monkeypatch):
    """A plan naming a group the fingerprinted manifest no longer holds
    preempts instead of raising."""
    ref_dir, port_dir = _pair(tmp_path, "fragmented")
    reports = []
    for module, d in ((ref_compact, ref_dir), (compact, port_dir)):
        real = module.plan_compaction

        def stale(*a, real=real, **kw):
            plan = real(*a, **kw)
            plan["eligible"].append({**plan["eligible"][0], "label": "Y"})
            return plan

        monkeypatch.setattr(module, "plan_compaction", stale)
        reports.append(module.compact_store(d, **QUIET))
    assert reports[1]["status"] == "aborted"
    assert _masked(reports[1]) == _masked(reports[0])
    assert _files(port_dir) == _files(ref_dir)


def test_ledger_record_and_metrics(tmp_path):
    ref_dir, port_dir = _pair(tmp_path, "fragmented")
    ref_compact.compact_store(ref_dir, **QUIET)
    registry = MetricsRegistry()
    report = compact.compact_store(port_dir, registry=registry, **QUIET)
    with open(os.path.join(port_dir, "ledger.jsonl")) as f:
        records = [json.loads(ln) for ln in f if ln.strip()]
    rec = records[-1]
    assert rec["type"] == "compact"
    assert {k: rec[k] for k in ("labels", "files_before", "files_after",
                                "bytes_before", "bytes_after",
                                "bytes_reclaimed", "rows", "rows_dropped")} \
        == {k: report[k] for k in ("labels", "files_before", "files_after",
                                   "bytes_before", "bytes_after",
                                   "bytes_reclaimed", "rows", "rows_dropped")}
    assert _files(port_dir)["ledger.jsonl"] == _files(ref_dir)["ledger.jsonl"]
    text = registry.render_prometheus()
    assert "avdb_compact_passes_total 1" in text
    assert "avdb_compact_segments_merged_total 7" in text
    assert f"avdb_compact_bytes_reclaimed_total {report['bytes_reclaimed']}" \
        in text
    assert "avdb_compact_aborts_total 0" in text
    assert "avdb_compact_seconds_count 1" in text


def test_fsck_flags_and_prunes_compact_tmp(tmp_path):
    ref_dir, port_dir = _pair(tmp_path, "fragmented")
    for d in (ref_dir, port_dir):
        for suffix in (compact.COMPACT_TMP_NPZ, compact.COMPACT_TMP_JSONL):
            with open(os.path.join(d, "chr8.000099" + suffix), "wb") as f:
                f.write(b"partial")
    want = ref_fsck.fsck(ref_dir, **QUIET)
    got = fsck.fsck(port_dir, **QUIET)
    assert json.dumps(got, sort_keys=True).replace(port_dir, "S") \
        == json.dumps(want, sort_keys=True).replace(ref_dir, "S")
    assert any(f["code"] == "compact-tmp" for f in got["findings"])
    want = ref_fsck.fsck(ref_dir, repair=True, **QUIET)
    got = fsck.fsck(port_dir, repair=True, **QUIET)
    assert got["exit_code"] == want["exit_code"]
    assert _files(port_dir) == _files(ref_dir)
    assert not [n for n in os.listdir(port_dir) if compact.is_compact_tmp(n)]


def test_cli_exit_codes_match_reference(tmp_path, capsys, monkeypatch):
    # missing store: 2, on both the dry run and the pass
    for argv in (["compact", "--dry-run"], ["compact"]):
        argv = argv + ["--storeDir", str(tmp_path / "none")]
        want = _cli(ref_doctor.main, argv, capsys)
        got = _cli(doctor.main, argv, capsys)
        assert got[0] == want[0] == 2
        assert got[2] == want[2]
    # a hard failure (a truncated segment file) is 2, the store untouched
    ref_dir, port_dir = _pair(tmp_path, "fragmented")
    victim = sorted(n for n in os.listdir(port_dir)
                    if n.startswith("chr8.") and n.endswith(".npz"))[1]
    for d in (ref_dir, port_dir):
        with open(os.path.join(d, victim), "r+b") as f:
            f.truncate(40)
    want = _cli(ref_doctor.main, ["compact", "--storeDir", ref_dir], capsys)
    got = _cli(doctor.main, ["compact", "--storeDir", port_dir], capsys)
    assert got[0] == want[0] == 2
    assert got[2].replace(port_dir, "S").splitlines()[-1] \
        == want[2].replace(ref_dir, "S").splitlines()[-1]
    assert _files(port_dir) == _files(ref_dir)
    # a pass preempted by a commit: 1 without retries, 0 with one retry
    for retries, rc in (("0", 1), ("1", 0)):
        ref_dir, port_dir = _pair(tmp_path / f"r{retries}", "fragmented")
        _commit_between_merge_and_swap(ref_compact, ref_memtable, ref_dir,
                                       monkeypatch)
        _commit_between_merge_and_swap(compact, memtable, port_dir,
                                       monkeypatch)
        argv = ["compact", "--retries", retries, "--json"]
        want = _cli(ref_doctor.main, argv + ["--storeDir", ref_dir], capsys)
        got = _cli(doctor.main, argv + ["--storeDir", port_dir], capsys)
        assert got[0] == want[0] == rc
        assert _masked(json.loads(got[1])) == _masked(json.loads(want[1]))
        assert _files(port_dir) == _files(ref_dir)
        monkeypatch.undo()
    # nothing eligible: 0
    argv = ["compact", "--storeDir", port_dir]
    assert _cli(doctor.main, argv, capsys)[0] == 0


@pytest.fixture()
def time_limit():
    """A 120-second limit on a test that drives servers: SIGALRM raises in
    the test's thread, so a hung request fails the test instead of
    stalling the run."""
    import signal

    def expired(_signum, _frame):
        raise TimeoutError("test ran past its 120 s limit")

    previous = signal.signal(signal.SIGALRM, expired)
    signal.alarm(120)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, previous)


def _bodies(engine, truth):
    out = [engine.lookup(ts._vid(r)) for r in truth[:30]]
    out.append(engine.lookup_many([ts._vid(r) for r in truth]))
    for spec, mc, lim in (("8:1-10000", None, None), ("8:1-3000000", 5.0, 64),
                          ("1:100000-2500000", None, None), ("X:1-999", None, 0)):
        out.append(engine.region(spec, min_cadd=mc, limit=lim))
    out.append([p.assemble() for p in engine.regions_serve(
        ["8:1-10000", "8:400-700", "1:1-3000000"], limit=16).pages])
    out.append(engine.stats_serve(["8:1-3000000", "1:1-3000000"],
                                  windows=4).assemble())
    return out


def _http_bodies(port, truth):
    import test_torch_upsert as tu

    out = [tu._request(port, "GET", f"/variant/{ts._vid(r)}")
           for r in truth[:20]]
    out.append(tu._request(port, "GET", "/region/8:1-10000?minCadd=5&limit=8"))
    out.append(tu._request(port, "POST", "/variants",
                           {"ids": [ts._vid(r) for r in truth[:40]]}))
    out.append(tu._request(port, "POST", "/regions",
                           {"regions": ["8:1-10000", "8:400-700"], "limit": 8}))
    out.append(tu._request(port, "POST", "/stats/region",
                           {"regions": ["8:1-3000000"], "windows": 2}))
    return out


def _front_end_bodies(store_dir, truth, pkg):
    """Both front ends' bodies over ``store_dir`` on fresh managers (one
    generation each side, so the generation fields agree)."""
    out = []
    if pkg == "ref":
        mgr, threaded, aio, kw = RefManager, ref_http.build_server, \
            ref_build_aio, {}
    else:
        mgr, threaded, aio, kw = SnapshotManager, http.build_server, \
            build_aio_server, {"device": "cpu"}
    httpd = threaded(manager=mgr(store_dir, **QUIET), port=0, **kw)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    srv = aio(manager=mgr(store_dir, **QUIET), port=0, **kw)
    srv.start_background()
    try:
        for port in (httpd.server_address[1], srv.server_address[1]):
            out.append(_http_bodies(port, truth))
    finally:
        srv.shutdown()
        srv.ctx.batcher.close()
        httpd.shutdown()
        httpd.server_close()
        httpd.ctx.batcher.close()
    return out


def test_reads_on_both_front_ends_before_and_after_compaction(tmp_path,
                                                             time_limit):
    ref_dir = str(tmp_path / "ref")
    truth = ts._build_store(ref_dir)
    port_dir = str(tmp_path / "port")
    shutil.copytree(ref_dir, port_dir)
    engine_pre = _bodies(QueryEngine(SnapshotManager(port_dir, **QUIET),
                                     device="cpu"), truth)
    http_pre = _front_end_bodies(port_dir, truth, "port")
    assert http_pre[0] == http_pre[1]
    assert http_pre == _front_end_bodies(ref_dir, truth, "ref")
    compact.compact_store(port_dir, **QUIET)
    ref_compact.compact_store(ref_dir, **QUIET)
    assert _bodies(QueryEngine(SnapshotManager(port_dir, **QUIET),
                               device="cpu"), truth) == engine_pre
    assert _bodies(RefEngine(RefManager(ref_dir, **QUIET)), truth) \
        == engine_pre
    assert _front_end_bodies(port_dir, truth, "port") == http_pre
    assert _front_end_bodies(ref_dir, truth, "ref") == http_pre


def test_live_manager_swaps_onto_the_compacted_generation(tmp_path):
    """A serving manager pinned before the pass keeps answering from its
    generation, then picks the compacted one up on refresh with the same
    bodies."""
    store_dir = str(tmp_path / "s")
    truth = ts._build_store(store_dir)
    manager = SnapshotManager(store_dir, ttl_s=0.0, **QUIET)
    engine = QueryEngine(manager, device="cpu", region_cache_size=0)
    gen0 = manager.current().generation
    pre = [engine.lookup(ts._vid(r)) for r in truth]
    assert compact.compact_store(store_dir, **QUIET)["status"] == "compacted"
    assert manager.refresh()
    assert manager.current().generation > gen0
    assert [engine.lookup(ts._vid(r)) for r in truth] == [
        p.replace(f'"generation": {gen0}',
                  f'"generation": {manager.current().generation}')
        if isinstance(p, str) else p for p in pre]


# ---------------------------------------------------------------------------
# out-of-core spill tier


def _memmapped(store) -> bool:
    return any(isinstance(seg.cols["pos"], np.memmap)
               for sh in store.shards.values() for seg in sh.segments)


def _spill_update(store_pkg, src, dest, value):
    """``src`` loaded, one column and one annotation updated, saved to
    ``dest`` (a new directory); returns whether the load was memmapped."""
    store = store_pkg.load(src)
    mapped = _memmapped(store)
    sh = store.shard(8)
    sh.set_col("ref_snp", [0, 5], [value, value + 1])
    sh.update_annotation(np.array([3]), "other_annotation", [{"spill": value}])
    assert int(sh.get_col("ref_snp", [0])[0]) == value
    store.save(dest)
    return mapped


def test_spill_tier_round_trips_across_packages(tmp_path, monkeypatch):
    """Under ``AVDB_STORE_SPILL_BYTES=1`` both packages load the same store
    memmapped, take the same updates (they land in copy-on-write pages)
    and save the same bytes; then each reads the other's saved store and
    updates it again, with the same result."""
    ref_dir = str(tmp_path / "ref")
    truth = ts._build_store(ref_dir)  # and one shadowed duplicate
    monkeypatch.setenv("AVDB_STORE_SPILL_BYTES", "1")
    a, b = str(tmp_path / "a_ref"), str(tmp_path / "a_port")
    assert _spill_update(RefStore, ref_dir, a, 424242)
    assert _spill_update(VariantStore, ref_dir, b, 424242)
    assert _files(a) == _files(b)
    c, d = str(tmp_path / "b_ref_on_port"), str(tmp_path / "b_port_on_ref")
    assert _spill_update(RefStore, b, c, 7)
    assert _spill_update(VariantStore, a, d, 7)
    assert _files(c) == _files(d)
    monkeypatch.delenv("AVDB_STORE_SPILL_BYTES")
    assert not _memmapped(VariantStore.load(d))
    assert fsck.fsck(d, deep=True, **QUIET)["exit_code"] == 0
    assert VariantStore.load(d).n == RefStore.load(ref_dir).n == len(truth) + 1


def test_spill_tier_reads_and_compaction_unchanged(tmp_path, monkeypatch):
    """The port's read bodies over a spilled store equal the materialized
    store's, and a compaction pass over a spilled store writes the
    reference's bytes (mirrors the reference's spill-tier case)."""
    ref_dir = str(tmp_path / "ref")
    truth = ts._build_store(ref_dir)
    port_dir = str(tmp_path / "port")
    shutil.copytree(ref_dir, port_dir)
    pre = _bodies(QueryEngine(SnapshotManager(port_dir, **QUIET), device="cpu"), truth)
    monkeypatch.setenv("AVDB_STORE_SPILL_BYTES", "1")
    assert _memmapped(VariantStore.load(port_dir))
    assert _bodies(QueryEngine(SnapshotManager(port_dir, **QUIET), device="cpu"),
                   truth) == pre
    assert compact.compact_store(port_dir, **QUIET)["status"] == "compacted"
    assert ref_compact.compact_store(ref_dir, **QUIET)["status"] == "compacted"
    assert _files(port_dir) == _files(ref_dir)
    monkeypatch.delenv("AVDB_STORE_SPILL_BYTES")
    assert _bodies(QueryEngine(SnapshotManager(port_dir, **QUIET), device="cpu"),
                   truth) == pre


@pytest.mark.parametrize("value,mapped", [("1g", False), ("0", False), ("off", False),
                                          ("", False), ("1k", True)])
def test_spill_threshold_gates_by_file_size(tmp_path, monkeypatch, value, mapped):
    store_dir = str(tmp_path / "vdb")
    ts._build_store(store_dir)
    monkeypatch.setenv("AVDB_STORE_SPILL_BYTES", value)
    assert _memmapped(VariantStore.load(store_dir)) is mapped
    assert _memmapped(RefStore.load(store_dir)) is mapped


def test_malformed_spill_knob_raises(tmp_path, monkeypatch):
    """A typo'd value raises with the variable's name in both packages
    instead of silently disabling the tier."""
    store_dir = str(tmp_path / "vdb")
    ts._build_store(store_dir)
    monkeypatch.setenv("AVDB_STORE_SPILL_BYTES", "512mb")
    for pkg in (VariantStore, RefStore):
        with pytest.raises(ValueError, match="AVDB_STORE_SPILL_BYTES"):
            pkg.load(store_dir)
