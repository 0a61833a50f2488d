"""The VCF load's default configuration, end to end: port against reference.

With no engine or pipeline variable set, both packages read with the
native tokenizer, run the overlapped executor and commit through the
async store writer.  ``READ_SIZE`` is 16 KiB on both sides, so read
windows cut chunks as they do in a real load.  Every comparison is
exact (tolerance 0): segments, sidecars, the manifest less ``store_uid``,
quarantine files and ledger records byte for byte, counters equal.
Also held here: the port's serial, synchronous-store and shuffled runs
against its default run, ``--failAt`` then resume, ``--maxErrors``
tripping at the same chunk, duplicates of rows that are still in flight
to the writer, and the VEP update (its Python transform) merging onto a
native-loaded store's raw-JSON frequencies.
"""

import os
import sys
import time

import numpy as np
import pytest

from annotatedvdb_tpu.loaders import TpuVcfLoader, TpuVepLoader
from annotatedvdb_tpu.conseq import ConsequenceRanker as RefRanker
from annotatedvdb_tpu.native import vcf as ref_native_vcf
from annotatedvdb_tpu.store import AlgorithmLedger, VariantStore
from annotatedvdb_tpu.utils.quarantine import ErrorBudget as RefBudget
from annotatedvdb_tpu.utils.quarantine import QuarantineSink as RefSink

from annotatedvdb_tpu_torch.conseq import ConsequenceRanker
from annotatedvdb_tpu_torch.loaders import VcfLoader, VepLoader
from annotatedvdb_tpu_torch.native import vcf as port_native_vcf
from annotatedvdb_tpu_torch.store import AlgorithmLedger as TorchLedger
from annotatedvdb_tpu_torch.store import VariantStore as TorchStore
from annotatedvdb_tpu_torch.store.variant_store import RawJson
from annotatedvdb_tpu_torch.utils.quarantine import ErrorBudget, QuarantineSink
from test_torch_load_vcf import COUNTER_KEYS, _ledger_records, _persisted_bytes, _write_vcf

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from chip_smoke import write_phase4_vcf, write_vep_json  # noqa: E402

BATCH = 128
WINDOW = 16 << 10
MODE_VARS = ("AVDB_PIPELINE", "AVDB_INGEST_ENGINE", "AVDB_ASYNC_STORE",
             "AVDB_INGEST_SHUFFLE_SEED")


@pytest.fixture(autouse=True)
def default_configuration(monkeypatch):
    """No engine or pipeline variable; 16 KiB read windows on both sides."""
    for name in MODE_VARS:
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setattr(ref_native_vcf, "READ_SIZE", WINDOW)
    monkeypatch.setattr(port_native_vcf, "READ_SIZE", WINDOW)


def _load(pkg, vcf, d, fail_at=None, max_errors=-1, persist_delay=0.0):
    """One commit load into ``d`` (resuming a store already there);
    returns (counters, raised exception or None, loader)."""
    os.makedirs(d, exist_ok=True)
    port = pkg == "port"
    Store = TorchStore if port else VariantStore
    Ledger = TorchLedger if port else AlgorithmLedger
    Sink, Budget = (QuarantineSink, ErrorBudget) if port else (RefSink, RefBudget)
    store = (Store.load(d) if os.path.exists(os.path.join(d, "manifest.json"))
             else Store(width=49))
    sink = Sink(d, vcf, "load-vcf", budget=Budget(max_errors))
    kw = {"device": "cpu"} if port else {}
    loader = (VcfLoader if port else TpuVcfLoader)(
        store, Ledger(os.path.join(d, "ledger.jsonl")), batch_size=BATCH,
        log=lambda *a: None, quarantine=sink, **kw)

    def persist():
        time.sleep(persist_delay)
        store.save(d)

    error = None
    try:
        counters = loader.load_file(vcf, commit=True, fail_at=fail_at,
                                    persist=persist)
    except RuntimeError as exc:  # failAt and ErrorBudgetExceeded
        counters, error = dict(loader.counters), exc
    finally:
        loader.close()
        sink.close()
    store.save(d)
    return counters, error, loader


def _counters(c):
    return {k: c.get(k) for k in COUNTER_KEYS}


def _assert_same_store(dir_a, dir_b):
    files_a, files_b = _persisted_bytes(dir_a), _persisted_bytes(dir_b)
    assert list(files_a) == list(files_b)
    for name in files_a:
        assert files_a[name] == files_b[name], f"{name} bytes diverge"
    assert _ledger_records(os.path.join(dir_a, "ledger.jsonl")) == \
        _ledger_records(os.path.join(dir_b, "ledger.jsonl"))
    qa, qb = (os.path.join(d, "quarantine") for d in (dir_a, dir_b))
    assert os.path.isdir(qa) == os.path.isdir(qb)
    if os.path.isdir(qa):
        assert sorted(os.listdir(qa)) == sorted(os.listdir(qb))
        for name in os.listdir(qa):
            with open(os.path.join(qa, name), "rb") as a, \
                    open(os.path.join(qb, name), "rb") as b:
                assert a.read() == b.read(), name


def _checkpoints(d):
    return len(_ledger_records(os.path.join(d, "ledger.jsonl"), ("checkpoint",)))


@pytest.fixture(scope="module")
def defaults(tmp_path_factory):
    """The reference's and the port's default loads of one VCF."""
    tmp = tmp_path_factory.mktemp("modes")
    vcf = str(tmp / "m.vcf")
    _write_vcf(vcf, n_lines=2000, seed=41)
    mp = pytest.MonkeyPatch()
    try:
        for name in MODE_VARS:
            mp.delenv(name, raising=False)
        mp.setattr(ref_native_vcf, "READ_SIZE", WINDOW)
        mp.setattr(port_native_vcf, "READ_SIZE", WINDOW)
        c_ref, _, _ = _load("ref", vcf, str(tmp / "ref"))
        c_port, _, loader = _load("port", vcf, str(tmp / "port"))
    finally:
        mp.undo()
    return {"vcf": vcf, "tmp": tmp, "ref": (c_ref, str(tmp / "ref")),
            "port": (c_port, str(tmp / "port"), loader)}


def test_default_load_matches_reference(defaults):
    c_ref, ref_dir = defaults["ref"]
    c_port, port_dir, loader = defaults["port"]
    assert _counters(c_port) == _counters(c_ref)
    assert c_ref["duplicates"] > 0 and c_ref["malformed"] == 1
    _assert_same_store(ref_dir, port_dir)
    # the windows cut chunks: more checkpoints than full batches need
    rows = c_ref["variant"] + c_ref["duplicates"]
    assert _checkpoints(port_dir) > -(-rows // BATCH)
    # the overlapped executor and the async writer ran
    assert set(loader.queue_stalls) == {"ingest", "dispatch", "store-writer"}
    assert loader.queue_stalls["store-writer"]["items"] == _checkpoints(port_dir)
    assert 0.0 <= loader.device_idle_fraction <= 1.0


@pytest.mark.parametrize("env", [
    {"AVDB_PIPELINE": "serial"},
    {"AVDB_ASYNC_STORE": "0"},
    {"AVDB_PIPELINE": "serial", "AVDB_ASYNC_STORE": "0"},
    {"AVDB_INGEST_SHUFFLE_SEED": "7", "AVDB_INGEST_PREFETCH_DEPTH": "3"},
], ids=["serial", "sync-store", "serial-sync-store", "shuffled"])
def test_port_modes_write_the_default_store(defaults, tmp_path, monkeypatch, env):
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    c_port, _, loader = _load("port", defaults["vcf"], str(tmp_path / "p"))
    assert _counters(c_port) == _counters(defaults["port"][0])
    _assert_same_store(defaults["port"][1], str(tmp_path / "p"))
    assert ("ingest" in loader.queue_stalls) == ("AVDB_PIPELINE" not in env)
    assert ("store-writer" in loader.queue_stalls) == ("AVDB_ASYNC_STORE" not in env)


def test_shuffled_schedule_matches_reference(defaults, tmp_path, monkeypatch):
    monkeypatch.setenv("AVDB_INGEST_SHUFFLE_SEED", "1234")
    c_ref, _, _ = _load("ref", defaults["vcf"], str(tmp_path / "ref"))
    c_port, _, _ = _load("port", defaults["vcf"], str(tmp_path / "port"))
    assert _counters(c_port) == _counters(c_ref)
    _assert_same_store(str(tmp_path / "ref"), str(tmp_path / "port"))


def test_cli_default_matches_reference(tmp_path):
    """``load-vcf --platform cpu --commit`` against the reference CLI, no
    engine or pipeline variable: store, quarantine, mapping sidecar and
    ledger records byte for byte."""
    from annotatedvdb_tpu.cli.load_vcf import main as ref_main
    from annotatedvdb_tpu_torch.cli.load_vcf import main as torch_main

    vcf = str(tmp_path / "cli.vcf")
    _write_vcf(vcf, n_lines=900, seed=43)
    common = ["--fileName", vcf, "--commit", "--commitAfter", str(BATCH),
              "--logAfter", "0"]
    ref_dir, port_dir = str(tmp_path / "ref"), str(tmp_path / "port")
    assert ref_main(common + ["--storeDir", ref_dir]) == 0
    with open(vcf + ".mapping", "rb") as f:
        mapping_ref = f.read()
    assert torch_main(common + ["--storeDir", port_dir, "--platform", "cpu"]) == 0
    with open(vcf + ".mapping", "rb") as f:
        assert f.read() == mapping_ref and mapping_ref
    _assert_same_store(ref_dir, port_dir)
    assert _checkpoints(port_dir) > 0


def test_fail_at_then_resume_matches_reference(tmp_path):
    vcf = str(tmp_path / "f.vcf")
    _write_vcf(vcf, n_lines=1600, seed=44)
    out = {}
    for pkg in ("ref", "port"):
        d = str(tmp_path / pkg)
        _c, err, _ = _load(pkg, vcf, d, fail_at="failhere")
        assert "failAt" in str(err)
        first = (_persisted_bytes(d), _checkpoints(d))
        c, err, _ = _load(pkg, vcf, d)
        assert err is None
        out[pkg] = (first, _counters(c), d)
    (first_ref, c_ref, ref_dir), (first_port, c_port, port_dir) = out["ref"], out["port"]
    assert first_port == first_ref and first_ref[1] > 0
    assert c_port == c_ref and c_ref["skipped"] > 0
    _assert_same_store(ref_dir, port_dir)


def _with_malformed(src, dst, every):
    """``src`` with a malformed line after every ``every`` data lines."""
    with open(src) as fh:
        lines = fh.readlines()
    out, k = [], 0
    for line in lines:
        out.append(line)
        if not line.startswith("#"):
            k += 1
            if k % every == 0:
                out.append(f"1\tbad{k}\t.\tA\tC\t.\t.\t.\n")
    with open(dst, "w") as fh:
        fh.writelines(out)


def test_max_errors_trips_at_the_same_chunk(tmp_path):
    """The native engine counts malformed lines without content; the
    budget is checked on the process thread in chunk order, so both
    packages stop at the same chunk with the same committed prefix."""
    base = str(tmp_path / "base.vcf")
    vcf = str(tmp_path / "e.vcf")
    _write_vcf(base, n_lines=1500, seed=45)
    _with_malformed(base, vcf, every=250)
    out = {}
    for pkg in ("ref", "port"):
        d = str(tmp_path / pkg)
        c, err, _ = _load(pkg, vcf, d, max_errors=3)
        assert type(err).__name__ == "ErrorBudgetExceeded", err
        out[pkg] = (_counters(c), d)
    assert out["port"][0] == out["ref"][0] and out["ref"][0]["rejected"] == 4
    _assert_same_store(out["ref"][1], out["port"][1])
    assert 0 < _checkpoints(out["port"][1])


def test_duplicates_of_rows_in_flight_are_found(tmp_path, monkeypatch):
    """Each block of lines is repeated right after itself, so duplicates
    fall in the next chunk or two; a slow writer keeps those earlier
    chunks in flight while the duplicates are probed.  The probe must find
    them among the pending segments."""
    src = str(tmp_path / "src.vcf")
    _write_vcf(src, n_lines=1200, seed=46)
    with open(src) as fh:
        lines = fh.readlines()
    header = [ln for ln in lines if ln.startswith("#")]
    data = [ln for ln in lines if not ln.startswith("#")]
    vcf = str(tmp_path / "dup.vcf")
    with open(vcf, "w") as fh:
        fh.writelines(header)
        for i in range(0, len(data), 100):
            fh.writelines(data[i:i + 100] * 2)
    pending = []
    original = VcfLoader._membership_segments

    def spy(self, code):
        pending.append(len(self._inflight))
        return original(self, code)

    c_ref, _, _ = _load("ref", vcf, str(tmp_path / "ref"), persist_delay=0.02)
    monkeypatch.setattr(VcfLoader, "_membership_segments", spy)
    c_port, _, _ = _load("port", vcf, str(tmp_path / "port"), persist_delay=0.02)
    assert _counters(c_port) == _counters(c_ref)
    assert c_port["duplicates"] >= len(data) - 2  # every repeated row
    assert max(pending) > 0  # probes ran while commits were in flight
    _assert_same_store(str(tmp_path / "ref"), str(tmp_path / "port"))


def test_vep_update_onto_native_store_matches_reference(tmp_path, monkeypatch):
    """The port's VEP update merges colocated frequencies onto the raw-JSON
    FREQ values a native load left in memory; the reference's Python
    transform (``AVDB_NATIVE_VEP=0``) does the same onto its store."""
    vcf, vep = str(tmp_path / "v.vcf"), str(tmp_path / "v.vep.json")
    lines, _rows, _dups = write_phase4_vcf(vcf, 3000)
    want, _novel = write_vep_json(vep, lines, 700, seed=8, n_novel=2)
    monkeypatch.setenv("AVDB_NATIVE_VEP", "0")
    out = {}
    for pkg in ("ref", "port"):
        d = str(tmp_path / pkg)
        os.makedirs(d)
        port = pkg == "port"
        store = (TorchStore if port else VariantStore)(width=49)
        ledger = (TorchLedger if port else AlgorithmLedger)(
            os.path.join(d, "ledger.jsonl"))
        kw = {"device": "cpu"} if port else {}
        vcf_loader = (VcfLoader if port else TpuVcfLoader)(
            store, ledger, batch_size=BATCH, log=lambda *a: None, **kw)
        vcf_loader.load_file(vcf, commit=True)
        vcf_loader.close()
        if port:
            raw = [v for sh in store.shards.values() for s in sh.segments
                   if s.obj["allele_frequencies"] is not None
                   for v in s.obj["allele_frequencies"] if isinstance(v, RawJson)]
            assert raw  # the merge targets are raw JSON text
        sink = (QuarantineSink if port else RefSink)(d, vep, "load-vep")
        vep_loader = (VepLoader if port else TpuVepLoader)(
            store, ledger, (ConsequenceRanker if port else RefRanker)(),
            datasource="dbSNP", log=lambda *a: None, quarantine=sink, **kw)
        try:
            counters = vep_loader.load_file(vep, commit=True)
        finally:
            sink.close()
        store.save(d)
        out[pkg] = ({k: counters.get(k, 0) for k in want}, d)
    assert out["port"][0] == out["ref"][0] == want
    _assert_same_store(out["ref"][1], out["port"][1])


def test_shared_raw_json_is_never_mutated(tmp_path):
    """One RawJson backing several rows: a merge (also with duplicate ids
    in one call) and ``get_ann`` materialize a fresh object on the row
    they touch, and the rows that share the value keep its text; both
    packages end with the same values and saved bytes."""
    from annotatedvdb_tpu.store.variant_store import RawJson as RefRawJson

    vcf = str(tmp_path / "r.vcf")
    _write_vcf(vcf, n_lines=300, seed=47)
    text = '{"GnomAD": {"gmaf": 0.25}}'
    out = {}
    for pkg, raw_cls in (("ref", RefRawJson), ("port", RawJson)):
        d = str(tmp_path / pkg)
        _load(pkg, vcf, d)
        store = (TorchStore if pkg == "port" else VariantStore).load(d)
        sh = store.shard(1)
        shared = raw_cls(text)
        seg = sh.segments[0]
        col = seg.obj_dense("allele_frequencies")
        col[:4] = [shared] * 4
        seg.dirty = True
        sh.update_annotation(np.array([0, 2, 2]), "allele_frequencies",
                             [{"GnomAD": {"af": 1}}, {"X": 1},
                              raw_cls('{"X": {"y": 2}}')])
        sh.update_annotation(np.array([1]), "allele_frequencies",
                             [{"Y": {"z": 3}}])
        got = sh.get_ann("allele_frequencies", 3)
        got["mutated"] = True
        assert shared.text == text and shared == {"GnomAD": {"gmaf": 0.25}}
        assert col[3] is got and col[3] is not shared
        out[pkg] = [sh.get_ann("allele_frequencies", i) for i in range(4)]
        store.save(d)
    assert out["port"] == out["ref"]
    assert out["port"][0] == {"GnomAD": {"gmaf": 0.25, "af": 1}}
    assert out["port"][1] == {"GnomAD": {"gmaf": 0.25}, "Y": {"z": 3}}
    assert out["port"][2] == {"GnomAD": {"gmaf": 0.25}, "X": {"y": 2}}
    _assert_same_store(str(tmp_path / "ref"), str(tmp_path / "port"))
