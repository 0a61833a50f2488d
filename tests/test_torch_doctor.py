"""``doctor`` (fsck and ``--repair``, ``status``, ``profile``,
``replay-rejects``): the PyTorch port against the JAX package, on the CPU.

One store is built with the port's CLIs (``chip_smoke.build_serve_store``:
two VCF loads, a VEP update and a CADD join, two chromosome groups and
several backing groups).  Each case copies it, damages the copy, and runs
both packages' ``doctor`` on the same directory in turn (the directory is
restored between the runs, so paths in the messages are the same): the
report, the exit code and every file the run leaves must be the same
bytes (a ledger heal's timestamp masked).  Cases: clean, a missing
manifest, orphans and debris of every kind (stale, compaction, flush,
WAL, WAL-rotation, replication and export temps, a follower cursor), a
foreign file, a torn segment rolled back by ``--repair``, a deep-verify
flipped byte, a dangling undo intent, a torn ledger line and the
checked-in corrupted-store fixture.  ``status`` and ``profile`` outputs
are compared with only ``disk.free_bytes`` and ``seconds`` masked, and
``replay-rejects`` output files on a loader's rejects file.  The
reference's ``doctor`` finds the port-written store clean, and neither
package's ``doctor`` touches CUDA.
"""

import json
import os
import re
import shutil
import struct
import sys
import zlib

import numpy as np
import pytest
import torch

from annotatedvdb_tpu.cli import doctor as ref_doctor
from annotatedvdb_tpu.serve.engine import QueryEngine as RefEngine
from annotatedvdb_tpu.serve.snapshot import StaticSnapshots as RefSnaps
from annotatedvdb_tpu.store import VariantStore as RefStore
from annotatedvdb_tpu.store import ledger as ref_ledger
from annotatedvdb_tpu.store import wal as ref_wal

from annotatedvdb_tpu_torch.cli import doctor
from annotatedvdb_tpu_torch.parallel import placement
from annotatedvdb_tpu_torch.serve.engine import QueryEngine
from annotatedvdb_tpu_torch.serve.snapshot import StaticSnapshots
from annotatedvdb_tpu_torch.store import VariantStore, ledger, wal

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke as smoke  # noqa: E402

FIXTURE = os.path.join(ROOT, "tests", "data", "corrupt_store")


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    return smoke.build_serve_store(str(tmp_path_factory.mktemp("doctor")), "cpu")


@pytest.fixture
def store(served, tmp_path):
    d = str(tmp_path / "vdb")
    shutil.copytree(served["store"], d)
    return d


def _tree(d) -> dict:
    """Every file under ``d`` by relative path: its bytes, the ledger's
    records with a ``store-fsck`` heal record's timestamp dropped."""
    out = {}
    for base, _dirs, files in os.walk(d):
        for f in files:
            p = os.path.join(base, f)
            rel = os.path.relpath(p, d)
            with open(p, "rb") as fh:
                data = fh.read()
            if f == "ledger.jsonl":
                recs = []
                for line in data.decode().splitlines():
                    try:
                        rec = json.loads(line)
                    except ValueError:
                        recs.append(line)
                        continue
                    if rec.get("script") == "store-fsck":
                        rec.pop("ts")
                    recs.append(rec)
                data = recs
            out[rel] = data
    return out


def _run(main, argv, capsys):
    rc = main(list(argv))
    cap = capsys.readouterr()
    return rc, cap.out, cap.err


def _pair(d, argv, capsys, mask=None):
    """Run the reference's and then the port's ``doctor argv`` on ``d``,
    restoring ``d`` in between; both must print the same, exit the same
    and leave the same files.  Returns the reference's (rc, out, err)."""
    backup = d + ".before"
    if os.path.isdir(d):
        shutil.copytree(d, backup)
    want = _run(ref_doctor.main, argv, capsys)
    want_tree = _tree(d) if os.path.isdir(d) else None
    if os.path.isdir(backup):
        shutil.rmtree(d)
        shutil.copytree(backup, d)
        shutil.rmtree(backup)
    got = _run(doctor.main, argv, capsys)
    if mask is not None:
        want, got = mask(want), mask(got)
    assert got == want, (argv, want, got)
    if want_tree is not None:
        assert _tree(d) == want_tree, argv
    return want


def _fsck(d, capsys, *flags):
    rc, out, _err = _pair(d, ["--storeDir", d, "--json", *flags], capsys)
    return rc, json.loads(out)


def _codes(report):
    return {f["code"] for f in report["findings"]}


def _segments(d, ext=".npz", label="22"):
    return sorted(f for f in os.listdir(d)
                  if f.startswith(f"chr{label}.") and f.endswith(ext)
                  and ".tmp" not in f)


def _write_wal(path, records, torn=False):
    with open(path, "wb") as f:
        f.write(json.dumps({"wal": 1, "name": "serve-w0", "seq": 1}).encode() + b"\n")
        for rec in records:
            blob = json.dumps(rec).encode()
            f.write(struct.pack("<II", len(blob), zlib.crc32(blob)) + blob)
        if torn:
            f.write(struct.pack("<II", 99, 0) + b"{\"rows")


def test_clean_store_matches_reference(store, capsys):
    for flags in ((), ("--deep",)):
        rc, report = _fsck(store, capsys, *flags)
        assert rc == 0 and report["status"] == "clean"
        assert _codes(report) == {"loads-ok"}
    # the text form: findings on stderr, the verdict last
    rc, out, err = _pair(store, ["--storeDir", store], capsys)
    assert rc == 0 and out == ""
    assert err.splitlines()[-1] == f"doctor: {store}: clean"


def test_reference_doctor_accepts_the_port_store(served, capsys):
    """The north star's check: the reference's own ``doctor --deep``
    finds a store the port wrote clean."""
    rc, out, _err = _run(ref_doctor.main,
                         ["--storeDir", served["store"], "--deep", "--json"], capsys)
    assert rc == 0
    assert json.loads(out)["status"] == "clean"


def test_missing_store_and_manifest_match_reference(store, tmp_path, capsys):
    rc, report = _fsck(str(tmp_path / "absent"), capsys)
    assert rc == 2 and _codes(report) == {"no-store"}
    os.unlink(os.path.join(store, "manifest.json"))
    rc, report = _fsck(store, capsys)
    assert rc == 2 and "manifest-missing" in _codes(report)
    with open(os.path.join(store, "manifest.json"), "w") as f:
        f.write("{not json")
    rc, report = _fsck(store, capsys, "--repair")
    assert rc == 2 and "manifest-corrupt" in _codes(report)


def test_debris_of_every_kind_matches_reference(store, capsys):
    def put(name, data=b"x"):
        with open(os.path.join(store, name), "wb") as f:
            f.write(data)

    put("chr5.000050.npz")
    put("chr5.000050.ann.jsonl", b"")
    put(".chr22.000001.tmp99.npz")
    put(".manifest.json.tmp77", b"{}")
    put("chr22.000090.compact.tmp.npz")
    put("chr22.000091.compact.tmp.ann.jsonl")
    put("chr22.000060.flush.tmp.ann.jsonl", b"")
    put("chr8.000061.flush.tmp.npz")
    _write_wal(os.path.join(store, "serve-w0.000001.wal"),
               [{"rows": [{"code": 22, "pos": 150}]}, {"rows": []}], torn=True)
    put("serve-w1.000003.wal.tmp", b'{"wal": 1}\n')
    put("chr22.000001.npz.repl.tmp", b"half")
    put("repl.cursor.json", b"{}")
    put("part-000001.npz.export.tmp4242")
    put(".corpus.manifest.json.tmp9")
    put("notours.npz", b"someone else's")
    put("notes.ann.jsonl", b"")
    rc, report = _fsck(store, capsys)
    assert rc == 1
    assert {"segment-orphan", "stale-tmp", "compact-tmp", "flush-tmp",
            "wal-pending", "wal-tmp", "repl-tmp", "repl-cursor", "export-tmp",
            "foreign-file", "loads-ok"} == _codes(report)
    rc, out, _err = _pair(store, ["status", "--storeDir", store, "--json"], capsys,
                          mask=_mask_free)
    status = json.loads(out)
    assert status["wal"]["records_pending_replay"] == 2
    assert status["debris"] == {"flush_tmp": 2, "compact_tmp": 2, "wal_tmp": 1,
                                "stale_tmp": 3}
    rc, report = _fsck(store, capsys, "--repair")
    assert rc == 1 and len(report["repairs"]) == 14
    # the foreign files stay, and keep the store at "warnings"
    rc, report = _fsck(store, capsys)
    assert rc == 1 and _codes(report) == {"foreign-file", "loads-ok"}
    assert os.path.exists(os.path.join(store, "notours.npz"))


@pytest.mark.parametrize("ext", [".npz", ".ann.jsonl"])
def test_torn_segment_rolled_back_like_reference(store, capsys, ext):
    seg = os.path.join(store, _segments(store, ext)[-1])
    with open(seg, "r+b") as f:
        f.truncate(os.path.getsize(seg) // 2)
    rc, report = _fsck(store, capsys)
    assert rc == 2 and {"segment-torn", "repair-available"} <= _codes(report)
    rc, report = _fsck(store, capsys, "--repair")
    assert rc == 1 and "segment-torn" in _codes(report)
    assert any("store reloads cleanly after repair" in r for r in report["repairs"])
    rc, report = _fsck(store, capsys, "--deep")
    assert rc == 0 and report["status"] == "clean"
    # the repaired store loads in both packages, with the same rows
    assert VariantStore.load(store).n == RefStore.load(store).n > 0


def test_missing_segment_file_rolled_back_like_reference(store, capsys):
    os.unlink(os.path.join(store, _segments(store, ".npz", "8")[0]))
    rc, report = _fsck(store, capsys)
    assert rc == 2 and "segment-missing" in _codes(report)
    rc, report = _fsck(store, capsys, "--repair")
    assert rc == 1
    assert _fsck(store, capsys)[0] == 0


@pytest.mark.parametrize("ext", [".npz", ".ann.jsonl"])
def test_deep_verify_flipped_byte_matches_reference(store, capsys, ext):
    seg = os.path.join(store, _segments(store, ext)[0])
    blob = bytearray(open(seg, "rb").read())
    blob[len(blob) // 2] ^= 0xFF
    open(seg, "wb").write(bytes(blob))
    rc, report = _fsck(store, capsys, "--deep")
    assert rc == 2 and "segment-bitrot" in _codes(report)
    _fsck(store, capsys)  # size-only: whatever the load makes of it, alike


def test_ledger_damage_and_undo_intent_match_reference(store, capsys):
    led = os.path.join(store, "ledger.jsonl")
    with open(led, "a") as f:
        f.write(json.dumps({"type": "undo_intent", "alg_id": 3, "ts": 1.5}) + "\n")
        f.write(json.dumps({"type": "run", "script": "load-vcf",
                            "input": "demo.vcf", "ts": 2.5}) + "\n")
        f.write('{"type": "checkpoint", "alg_id": 9, "fi\n')
    rc, report = _fsck(store, capsys)
    assert rc == 1 and {"undo-intent-dangling", "ledger-torn"} <= _codes(report)
    assert any("--algId 3" in f["message"] for f in report["findings"])
    # a torn segment now prescribes the run record's re-load
    seg = os.path.join(store, _segments(store)[0])
    with open(seg, "r+b") as f:
        f.truncate(100)
    rc, report = _fsck(store, capsys, "--repair")
    assert rc == 1 and "reload-hint" in _codes(report)
    assert any("--fileName demo.vcf" in f["message"] for f in report["findings"])
    rc, report = _fsck(store, capsys)
    assert "ledger-torn" not in _codes(report)


def test_corrupt_fixture_repairs_like_reference(tmp_path, capsys):
    d = str(tmp_path / "vdb")
    shutil.copytree(FIXTURE, d)
    rc, report = _fsck(d, capsys)
    assert rc == 2
    assert {"segment-torn", "segment-orphan", "stale-tmp", "compact-tmp",
            "wal-pending", "wal-tmp", "flush-tmp", "repl-tmp", "repl-cursor",
            "export-tmp", "ledger-torn", "undo-intent-dangling"} <= _codes(report)
    rc, report = _fsck(d, capsys, "--repair", "--deep")
    assert rc == 1
    assert VariantStore.load(d).shard(1).n == 6


def _mask_free(result):
    rc, out, err = result
    out = re.sub(r'"free_bytes": \d+', '"free_bytes": 0', out)
    err = re.sub(r"disk: \d+ free", "disk: 0 free", err)
    return rc, out, err


@pytest.mark.parametrize("mesh", [None, "1", "4"], ids=["unset", "one", "four"])
def test_status_matches_reference(store, capsys, monkeypatch, mesh):
    if mesh is None:
        monkeypatch.delenv("AVDB_MESH_SHAPE", raising=False)
    else:
        monkeypatch.setenv("AVDB_MESH_SHAPE", mesh)
    monkeypatch.setenv("AVDB_SERVE_HBM_BUDGET", "1g")
    monkeypatch.setenv("AVDB_STORE_DISK_RESERVE_BYTES", str(1 << 60))
    monkeypatch.setenv("AVDB_MAINTAIN_SEGMENTS_HIGH", "3")
    _rc, out, _err = _pair(store, ["status", "--storeDir", store, "--json"],
                           capsys, mask=_mask_free)
    report = json.loads(out)
    assert report["rows"] > 2000 and sorted(report["groups"]) == ["22", "8"]
    assert (report["mesh"] is None) == (mesh != "4")
    assert report["disk"]["breached"] is True
    assert report["watermarks"]["high"] == 3 and report["read_amp"]["max"] >= 1
    rc, out, err = _pair(store, ["status", "--storeDir", store], capsys,
                         mask=_mask_free)
    assert rc == 0 and "read-amp" in err and "BREACHED" in err


def test_status_of_a_non_store_matches_reference(tmp_path, capsys):
    rc, _out, err = _pair(str(tmp_path), ["status", "--storeDir", str(tmp_path)],
                          capsys)
    assert rc == 2 and "FileNotFoundError" in err


def _mask_seconds(result):
    rc, out, err = result
    return (rc, re.sub(r'"seconds": [0-9.e-]+', '"seconds": 0', out),
            re.sub(r", [0-9.e-]+s\)", ", 0s)", err))


@pytest.mark.parametrize("chunk", ["262144", "100"])
def test_profile_matches_reference(store, capsys, chunk):
    _rc, out, _err = _pair(store, ["profile", "--storeDir", store,
                                   "--chunkRows", chunk], capsys,
                           mask=_mask_seconds)
    report = json.loads(out)
    assert report["rows"] > 2000 and sorted(report["groups"]) == ["22", "8"]
    dest = os.path.join(os.path.dirname(store), "profile.json")
    rc, out, err = _pair(store, ["profile", "--storeDir", store, "--out", dest],
                         capsys, mask=_mask_seconds)
    assert rc == 0 and out == "" and "doctor profile: wrote" in err
    with open(dest) as f:
        assert json.loads(f.read())["totals"] == report["totals"]


def test_profile_groups_equal_whole_chromosome_stats(served, capsys):
    """A group's profile is the ``/stats/region`` answer over the whole
    chromosome, in the reference and in the port (phase 13 holds the card
    engine to it)."""
    rc, out, _err = _run(doctor.main, ["profile", "--storeDir", served["store"]],
                         capsys)
    groups = json.loads(out)["groups"]
    specs = ["22:1-50818468", "8:1-63999999"]
    ref = RefEngine(RefSnaps(RefStore.load(served["store"], readonly=True)))
    port = QueryEngine(StaticSnapshots(VariantStore.load(served["store"],
                                                         readonly=True)),
                       device="cpu", stats_device_min=0)
    want = json.loads(ref.stats_serve(specs).assemble())["results"]
    assert json.loads(port.stats_serve(specs).assemble())["results"] == want
    for label, res in zip(("22", "8"), want):
        g = dict(groups[label])
        assert g.pop("segments") == g.pop("read_amp") >= 1
        assert {k: v for k, v in res.items() if k != "region"} == g
    assert smoke.profile_matches_stats(groups, want, ("22", "8"))


def test_profile_of_a_non_store_matches_reference(tmp_path, capsys):
    rc, _out, err = _pair(str(tmp_path), ["profile", "--storeDir", str(tmp_path)],
                          capsys)
    assert rc == 2 and "doctor profile: FileNotFoundError" in err


def test_replay_rejects_matches_reference(tmp_path, capsys, monkeypatch):
    vcf = str(tmp_path / "bad.vcf")
    lines = smoke.rejects_vcf(vcf, 40)
    d = str(tmp_path / "vdb")
    from annotatedvdb_tpu_torch.__main__ import main as port_cli

    monkeypatch.setenv("AVDB_INGEST_ENGINE", "python")
    assert port_cli(["load-vcf", "--fileName", vcf, "--storeDir", d, "--commit",
                     "--platform", "cpu"]) == 0
    capsys.readouterr()
    rejects = os.path.join(d, "quarantine", "bad.vcf.rejects.jsonl")
    outs = {}
    for key, main in (("ref", ref_doctor.main), ("port", doctor.main)):
        out = str(tmp_path / f"fixed.{key}.vcf")
        outs[key] = _run(main, ["replay-rejects", "--rejects", rejects,
                                "--out", out], capsys)
        with open(out) as f:
            outs[key] = (outs[key][0], outs[key][1],
                         outs[key][2].replace(out, "OUT"), f.read())
    assert outs["port"] == outs["ref"]
    assert outs["port"][0] == 0 and outs["port"][3] == "".join(lines["bad"])
    # a TSV loader's rejects file: the meta header comes back first
    tsv = str(tmp_path / "x.rejects.jsonl")
    with open(tsv, "w") as f:
        f.write(json.dumps({"meta": {"input": "x.tsv", "loader": "update-annotation",
                                     "header": "id\tcol\n"}}) + "\n")
        f.write(json.dumps({"line": 3, "reason": "r", "raw": "a\tb\n"}) + "\n")
        f.write(json.dumps({"line": None, "reason": "s", "count": 4,
                            "raw": None}) + "\n")
    for key, main in (("ref", ref_doctor.main), ("port", doctor.main)):
        out = str(tmp_path / f"fixed.{key}.tsv")
        rc, _o, err = _run(main, ["replay-rejects", "--rejects", tsv, "--out", out],
                           capsys)
        outs[key] = (rc, err.replace(out, "OUT"), open(out).read())
    assert outs["port"] == outs["ref"] == (
        0, "1 quarantined line(s) written to OUT; load with update-annotation\n",
        "id\tcol\na\tb\n")


@pytest.mark.parametrize("verb", ["compact", "promote", "flight", "trace", "slo"])
def test_unported_verbs_refuse(store, capsys, verb):
    if verb in ("compact", "promote"):
        # ported: the verb answers as the reference's does on the store
        # (output, exit code and files; its timings masked)
        want = _pair(store, [verb, "--storeDir", store, "--json"], capsys,
                     mask=lambda r: (r[0], re.sub(r'"seconds": [0-9.e+-]+',
                                                  '"seconds": 0', r[1]), r[2]))
        assert want[0] == 0 and json.loads(want[1])["status"] in (
            "compacted", "noop", "promoted")
        return
    # ported with the health plane: on a store no server ran on (and no
    # run, compact or flush record in its ledger) each verb finds nothing
    # to show and exits 2, as the reference's does
    rc, out, err = _pair(store, [verb, "--storeDir", store], capsys)
    assert rc == 2 and out == "" and f"doctor {verb}: {store}: no" in err


def test_doctor_never_touches_cuda(store, capsys, monkeypatch):
    """fsck (with a repair's load and save), status and profile run on
    the host: any CUDA call fails the test."""
    def no_cuda(*_a, **_k):
        raise AssertionError("doctor touched CUDA")

    for name in ("init", "is_available", "device_count", "current_device",
                 "synchronize"):
        monkeypatch.setattr(torch.cuda, name, no_cuda)
    monkeypatch.setattr(torch.Tensor, "cuda", no_cuda)
    seg = os.path.join(store, _segments(store)[-1])
    with open(seg, "r+b") as f:
        f.truncate(64)
    assert doctor.main(["--storeDir", store, "--repair", "--json", "--deep"]) == 1
    assert doctor.main(["status", "--storeDir", store, "--json"]) == 0
    assert doctor.main(["profile", "--storeDir", store, "--chunkRows", "500"]) == 0
    capsys.readouterr()


def test_placement_hint_matches_reference(monkeypatch):
    from annotatedvdb_tpu.parallel import mesh as ref_mesh

    for n in range(1, 9):
        assert placement.placement_hint(n) == ref_mesh.placement_hint(n)
        assert placement.chromosome_placement(n) == ref_mesh.chromosome_placement(n)
    for spec in ("", "3", "x", "0"):
        monkeypatch.setenv("AVDB_MESH_SHAPE", spec)
        try:
            want = ref_mesh.placement_hint()
        except ValueError as err:
            with pytest.raises(ValueError, match=re.escape(str(err))):
                placement.placement_hint()
            continue
        assert placement.placement_hint() == want


def test_wal_rules_and_counts_match_reference(tmp_path):
    names = ("serve-w0.000001.wal", "x.000001.wal.tmp", "a.b.123456.wal",
             "serve-w0.00001.wal", "chr1.000001.flush.tmp.npz", "wal")
    for name in names:
        assert wal.is_wal_file(name) == ref_wal.is_wal_file(name), name
        assert wal.is_wal_tmp(name) == ref_wal.is_wal_tmp(name), name
    rng = np.random.default_rng(5)
    for k, torn in enumerate((False, True, False)):
        p = str(tmp_path / f"w{k}.000001.wal")
        _write_wal(p, [{"rows": [int(x)]} for x in rng.integers(0, 9, 4 + k)], torn)
        assert wal.count_records(p) == ref_wal.count_records(p) == 4 + k
    bad = str(tmp_path / "bad.000001.wal")
    for data in (b"", b"not json\n", b'{"wal": 2}\n', b'{"wal": 1}\n\x05\x00\x00\x00'):
        open(bad, "wb").write(data)
        assert wal.count_records(bad) == ref_wal.count_records(bad) == 0
    assert wal.count_records(str(tmp_path / "absent")) == 0


def test_ledger_readers_match_reference(tmp_path):
    p = str(tmp_path / "ledger.jsonl")
    with open(p, "w") as f:
        for i, kind in enumerate(("run", "compact", "flush", "invocation", "run",
                                  "flush", "export", "compact", "run")):
            f.write(json.dumps({"type": kind, "i": i, "ts": float(i)}) + "\n")
        f.write("torn\n")
    a = ledger.AlgorithmLedger(p, log=lambda m: None)
    b = ref_ledger.AlgorithmLedger(p, log=lambda m: None)
    assert a.runs() == b.runs() and len(a.runs()) == 3
    assert a.compactions() == b.compactions() and len(a.compactions()) == 2
    assert a.flushes() == b.flushes() and len(a.flushes()) == 2
    assert a.skipped_lines == b.skipped_lines == 1
