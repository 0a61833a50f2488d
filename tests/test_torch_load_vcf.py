"""The VCF insert load, end to end: the PyTorch port against the JAX package.

One seeded VCF (the shapes of ``test_pipeline_modes._write_vcf`` plus
indels, over-width alleles that take the host-fallback and digest-PK
path, and exact duplicates) is loaded by the reference ``TpuVcfLoader``
(Python tokenizer, serial pipeline) and by the port's ``VcfLoader`` on the
CPU, with the same batch size.  The stores must be byte-identical; the
comparison is exact everywhere (tolerance 0): every function on this path
is integer math or string assembly.
"""

import json
import os
import shutil

import numpy as np
import pytest

from annotatedvdb_tpu.loaders import TpuVcfLoader
from annotatedvdb_tpu.store import AlgorithmLedger, VariantStore
from annotatedvdb_tpu.store.fsck import fsck

from annotatedvdb_tpu_torch.loaders import VcfLoader
from annotatedvdb_tpu_torch.store import AlgorithmLedger as TorchLedger
from annotatedvdb_tpu_torch.store import VariantStore as TorchStore

BATCH = 256
COUNTER_KEYS = ("variant", "duplicates", "line", "skipped", "malformed",
                "update", "rejected", "out_of_bounds")


def _write_vcf(path, n_lines: int = 2000, seed: int = 11, start: int = 500,
               replay_from=None) -> None:
    """Multi-chunk VCF with every counter-bearing shape: exact duplicate
    lines, multi-allelic sites, '.' alts, unplaceable contigs, a malformed
    line, FREQ annotations, rs ids, indels and over-width alleles.
    ``replay_from``: a VCF whose data lines are copied in (every other
    line), so a reload meets identities the store already holds; the new
    lines then come shuffled, so every chunk's segment overlaps the
    store's and the shard cascade-merges."""
    rng = np.random.default_rng(seed)
    bases = "ACGT"
    copied = []
    if replay_from is not None:
        with open(replay_from) as fh:
            copied = [ln for ln in fh if not ln.startswith("#")][::2]
    lines = []
    pos = start
    for k in range(n_lines):
        pos += int(rng.integers(1, 6))
        ref = bases[int(rng.integers(4))]
        alt = bases[(bases.index(ref) + 1 + int(rng.integers(3))) % 4]
        if k % 13 == 0:  # insertion of 2-6 bp
            alt = ref + "".join(bases[int(i)] for i in rng.integers(0, 4, int(rng.integers(2, 7))))
        elif k % 17 == 0:  # deletion of 2-6 bp
            ref = ref + "".join(bases[int(i)] for i in rng.integers(0, 4, int(rng.integers(2, 7))))
        elif k % 401 == 0:  # over-width: host fallback + digest PK
            ref = ref + "".join(bases[int(i)] for i in rng.integers(0, 4, 60))
        elif k % 409 == 0:  # in width, but ref+alt > 50: digest PK
            ref = ref + "".join(bases[int(i)] for i in rng.integers(0, 4, 30))
            alt = alt + "".join(bases[int(i)] for i in rng.integers(0, 4, 30))
        if k % 97 == 0:
            alt = alt + ",."  # skipped '.' alt
        elif k % 53 == 0:
            alt = alt + "," + bases[int(rng.integers(4))]
        info = (
            f"RS={k};FREQ=GnomAD:0.9,{0.001 * (k % 9 + 1):.4f}"
            if k % 31 == 0 else f"RS={k}" if k % 3 == 0 else "."
        )
        chrom = "1" if k % 7 else "2"
        vid = "failhere" if k == n_lines // 2 else f"rs{k}"
        line = f"{chrom}\t{pos}\t{vid}\t{ref}\t{alt}\t.\t.\t{info}\n"
        lines.append(line)
        if k % 211 == 0:  # exact duplicate of the line just written
            lines.append(line)
    if replay_from is not None:
        lines = copied + [lines[i] for i in rng.permutation(len(lines))]
    with open(path, "w") as fh:
        fh.write("##fileformat=VCFv4.2\n")
        fh.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n")
        fh.writelines(lines)
        fh.write("weird_contig\t100\t.\tA\tC\t.\t.\t.\n")
        fh.write("1\tnot_a_pos\t.\tA\tC\t.\t.\t.\n")  # malformed


def _persisted_bytes(save_dir) -> dict:
    """Every persisted store file's bytes, the manifest normalized for the
    per-store uid (the only legitimately differing byte) — the
    normalization of ``test_pipeline_modes._persisted_bytes``."""
    out = {}
    for name in sorted(os.listdir(save_dir)):
        fp = os.path.join(save_dir, name)
        if not os.path.isfile(fp) or name == "ledger.jsonl":
            continue
        with open(fp, "rb") as f:
            data = f.read()
        if name == "manifest.json":
            m = json.loads(data)
            m.pop("store_uid", None)
            data = json.dumps(m, sort_keys=True).encode()
        out[name] = data
    return out


def _ledger_records(path, types=("invocation", "checkpoint", "finish")) -> list:
    with open(path) as f:
        recs = [json.loads(line) for line in f if line.strip()]
    return [{k: v for k, v in r.items() if k != "ts"}
            for r in recs if r.get("type") in types]


def _ref_load(vcf, store_dir, monkeypatch, fail_at=None):
    monkeypatch.setenv("AVDB_PIPELINE", "serial")
    monkeypatch.setenv("AVDB_INGEST_ENGINE", "python")
    os.makedirs(store_dir, exist_ok=True)
    if os.path.exists(os.path.join(store_dir, "manifest.json")):
        store = VariantStore.load(store_dir)
    else:
        store = VariantStore(width=49)
    ledger = AlgorithmLedger(os.path.join(store_dir, "ledger.jsonl"))
    loader = TpuVcfLoader(store, ledger, batch_size=BATCH, log=lambda *a: None)
    try:
        counters = loader.load_file(
            vcf, commit=True, fail_at=fail_at,
            persist=lambda: store.save(store_dir),
        )
    except RuntimeError:
        counters = None
    finally:
        loader.close()
    store.save(store_dir)
    return counters, loader


def _torch_load(vcf, store_dir, fail_at=None):
    os.makedirs(store_dir, exist_ok=True)
    if os.path.exists(os.path.join(store_dir, "manifest.json")):
        store = TorchStore.load(store_dir)
    else:
        store = TorchStore(width=49)
    ledger = TorchLedger(os.path.join(store_dir, "ledger.jsonl"))
    loader = VcfLoader(store, ledger, batch_size=BATCH, log=lambda *a: None,
                       device="cpu")
    try:
        counters = loader.load_file(
            vcf, commit=True, fail_at=fail_at,
            persist=lambda: store.save(store_dir),
        )
    except RuntimeError:
        counters = None
    finally:
        loader.close()
    store.save(store_dir)
    return counters, loader


def _counters(c):
    return {k: c.get(k) for k in COUNTER_KEYS}


def _assert_same_store(dir_a, dir_b):
    files_a, files_b = _persisted_bytes(dir_a), _persisted_bytes(dir_b)
    assert list(files_a) == list(files_b)
    for name in files_a:
        assert files_a[name] == files_b[name], f"{name} bytes diverge"
    assert _ledger_records(os.path.join(dir_a, "ledger.jsonl")) == \
        _ledger_records(os.path.join(dir_b, "ledger.jsonl"))


@pytest.fixture(scope="module")
def loads(tmp_path_factory):
    """One first load and one device-probed reload, through both
    packages (module-scoped: the reference loads dominate the cost)."""
    tmp = tmp_path_factory.mktemp("torch_load")
    vcf = str(tmp / "first.vcf")
    vcf2 = str(tmp / "second.vcf")
    _write_vcf(vcf)
    _write_vcf(vcf2, n_lines=600, seed=5, start=700, replay_from=vcf)
    mp = pytest.MonkeyPatch()
    try:
        ref_dir, torch_dir = str(tmp / "ref"), str(tmp / "torch")
        c_ref, _ = _ref_load(vcf, ref_dir, mp)
        c_torch, _ = _torch_load(vcf, torch_dir)
        first = (c_ref, c_torch, _persisted_bytes(ref_dir),
                 _persisted_bytes(torch_dir))
        # the reference on CPU-JAX probes with numpy whatever the knob says
        # (and latches the knob process-wide), so only the port's load
        # runs under AVDB_DEVICE_LOOKUP=always
        c2_ref, _ = _ref_load(vcf2, ref_dir, mp)
        mp.setenv("AVDB_DEVICE_LOOKUP", "always")
        c2_torch, torch_loader = _torch_load(vcf2, torch_dir)
    finally:
        mp.undo()
    return {
        "first": first, "reload": (c2_ref, c2_torch),
        "dirs": (ref_dir, torch_dir), "probe_stats": torch_loader.probe_stats,
        "vcf": vcf,
    }


def test_first_load_counters_match(loads):
    c_ref, c_torch, _, _ = loads["first"]
    assert _counters(c_ref) == _counters(c_torch)
    # the fixture exercises every counter-bearing path
    assert c_ref["duplicates"] > 0 and c_ref["skipped"] > 0
    assert c_ref["malformed"] == 1 and c_ref["rejected"] == 1


def test_first_load_store_bytes_identical(loads):
    _, _, files_ref, files_torch = loads["first"]
    assert list(files_ref) == list(files_torch)
    for name in files_ref:
        assert files_ref[name] == files_torch[name], f"{name} bytes diverge"


def test_reload_device_probe_duplicates_match(loads):
    c2_ref, c2_torch = loads["reload"]
    assert _counters(c2_ref) == _counters(c2_torch)
    assert c2_ref["duplicates"] > 300  # the copied half of the first VCF
    # AVDB_DEVICE_LOOKUP=always: the port's torch probe answered
    assert loads["probe_stats"].get("device", 0) > 0
    assert "host" not in loads["probe_stats"]
    _assert_same_store(*loads["dirs"])


def test_reference_opens_and_fscks_port_store(loads):
    ref_dir, torch_dir = loads["dirs"]
    store = VariantStore.load(torch_dir)
    assert store.n == VariantStore.load(ref_dir).n > 0
    report = fsck(torch_dir, deep=True, log=lambda m: None)
    assert report["status"] == "clean", report


def test_port_resumes_reference_store(tmp_path, monkeypatch):
    """A load the reference left half done (failAt) resumes through the
    port exactly as it resumes through the reference: same cursor, same
    skipped replay, same store bytes and ledger records."""
    vcf = str(tmp_path / "r.vcf")
    _write_vcf(vcf, n_lines=1200, seed=3)
    base = str(tmp_path / "base")
    c0, _ = _ref_load(vcf, base, monkeypatch, fail_at="failhere")
    assert c0 is None
    assert 0 < VariantStore.load(base).n
    ref_dir, torch_dir = str(tmp_path / "ref"), str(tmp_path / "torch")
    shutil.copytree(base, ref_dir)
    shutil.copytree(base, torch_dir)
    c_ref, _ = _ref_load(vcf, ref_dir, monkeypatch)
    c_torch, _ = _torch_load(vcf, torch_dir)
    assert _counters(c_ref) == _counters(c_torch)
    assert c_torch["skipped"] > 0  # the committed prefix replays as skipped
    _assert_same_store(ref_dir, torch_dir)


def test_cli_writes_reference_store(tmp_path, monkeypatch):
    """``load-vcf --platform cpu --commit`` through the port CLI against the
    reference CLI (Python tokenizer): segments, sidecars, manifest (minus
    store_uid), quarantine file and mapping sidecar byte for byte; ledger
    invocation/checkpoint/finish records on every field but ``ts``."""
    from annotatedvdb_tpu.cli.load_vcf import main as ref_main
    from annotatedvdb_tpu_torch.cli.load_vcf import main as torch_main

    vcf = str(tmp_path / "cli.vcf")
    _write_vcf(vcf, n_lines=900, seed=23)
    monkeypatch.setenv("AVDB_INGEST_ENGINE", "python")
    monkeypatch.setenv("AVDB_PIPELINE", "serial")
    common = ["--fileName", vcf, "--commit", "--commitAfter", str(BATCH),
              "--logAfter", "0"]
    ref_dir, torch_dir = str(tmp_path / "ref"), str(tmp_path / "torch")
    assert ref_main(common + ["--storeDir", ref_dir]) == 0
    with open(vcf + ".mapping", "rb") as f:
        mapping_ref = f.read()
    assert torch_main(common + ["--storeDir", torch_dir,
                                "--platform", "cpu"]) == 0
    with open(vcf + ".mapping", "rb") as f:
        mapping_torch = f.read()
    assert mapping_ref == mapping_torch and mapping_ref
    _assert_same_store(ref_dir, torch_dir)
    quarantine = os.path.join("quarantine", "cli.vcf.rejects.jsonl")
    with open(os.path.join(ref_dir, quarantine), "rb") as a, \
            open(os.path.join(torch_dir, quarantine), "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("flags", [
    ["--refGenome", "g.npz"], ["--profile", "prof"], ["--metricsOut", "m.prom"],
    ["--traceOut", "t.json"], ["--maxWorkers", "4"],
], ids=lambda f: f[0])
def test_cli_refuses_unported_flags(tmp_path, flags):
    from annotatedvdb_tpu_torch.cli.load_vcf import main as torch_main

    with pytest.raises(SystemExit) as exc:
        torch_main(["--fileName", str(tmp_path / "x.vcf"), "--storeDir",
                    str(tmp_path / "vdb"), "--platform", "cpu", *flags])
    assert exc.value.code == 2
    assert not (tmp_path / "vdb").exists()


def test_cli_defaults_to_cuda_and_never_falls_back(tmp_path):
    import torch

    from annotatedvdb_tpu_torch.cli.load_vcf import main as torch_main

    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    vcf = str(tmp_path / "x.vcf")
    _write_vcf(vcf, n_lines=10)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        torch_main(["--fileName", vcf, "--storeDir", str(tmp_path / "vdb")])
    assert not (tmp_path / "vdb").exists()
