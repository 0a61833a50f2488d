"""Mesh loads through the port's loaders against the reference's, on the
CPU.

``tests/test_distributed_load.py``'s cases for ``annotatedvdb_tpu_torch``:
a chromosome-sorted single-chromosome VCF (every row routes to one owner:
the lossless default capacity must absorb it) and an interleaved
multi-chromosome VCF through ``VcfLoader(mesh=...)``; a VEP update through
the sharded update step (``VepLoader(mesh=...)``, native transform); the
CADD join through the sharded step (``CaddUpdater(mesh=...)``), with its
edge cases (several flushes, several chromosomes, an indel pass, long
table alleles, an over-width store variant).  Each mesh run's saved store
(segments, sidecars, manifest) and ledger records equal the reference's
mesh run's and the port's own single-device run's, byte for byte, at 2, 4
and 8 shards where the case says so.  The reference meshes are its 8
virtual CPU devices; the port's are virtual CPU shards.
"""

from __future__ import annotations

import gzip
import json
import os

import numpy as np
import pytest
import torch

from annotatedvdb_tpu.loaders import TpuVcfLoader
from annotatedvdb_tpu.parallel import make_mesh as ref_make_mesh
from annotatedvdb_tpu.store import AlgorithmLedger as RefLedger
from annotatedvdb_tpu.store import VariantStore as RefStore

from annotatedvdb_tpu_torch.loaders import VcfLoader
from annotatedvdb_tpu_torch.parallel import mesh as meshlib
from annotatedvdb_tpu_torch.store import AlgorithmLedger
from annotatedvdb_tpu_torch.store import VariantStore

from test_distributed_load import _write_vep_json, write_sorted_vcf
from test_torch_load_vcf import _ledger_records, _persisted_bytes

CPU = torch.device("cpu")
BASES = "ACGT"


def cpu_mesh(n):
    return meshlib.make_mesh(n, devices=[CPU] * n) if n > 1 else None


def _same_dirs(a, b):
    fa, fb = _persisted_bytes(a), _persisted_bytes(b)
    assert list(fa) == list(fb)
    for name in fa:
        assert fa[name] == fb[name], f"{name} bytes diverge"
    assert _ledger_records(os.path.join(a, "ledger.jsonl")) == \
        _ledger_records(os.path.join(b, "ledger.jsonl"))


def _vcf_load(pkg, vcf, out, mesh, batch_size=256):
    os.makedirs(out, exist_ok=True)
    if pkg == "ref":
        store = RefStore(width=49)
        ledger = RefLedger(os.path.join(out, "ledger.jsonl"))
        loader = TpuVcfLoader(store, ledger, mesh=mesh, batch_size=batch_size,
                              log=lambda *a: None)
    else:
        store = VariantStore(width=49)
        ledger = AlgorithmLedger(os.path.join(out, "ledger.jsonl"))
        loader = VcfLoader(store, ledger, mesh=mesh, batch_size=batch_size,
                           log=lambda *a: None, device="cpu")
    try:
        counters = loader.load_file(vcf, commit=True)
    finally:
        loader.close()
    store.save(out)
    return counters


def _multi_vcf(path, n=800, seed=11):
    rng = np.random.default_rng(seed)
    lines = ["##fileformat=VCFv4.2",
             "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO"]
    per_chrom = {}
    chroms = [str(c) for c in range(1, 23)] + ["X", "Y", "M"]
    for _ in range(n):
        chrom = chroms[int(rng.integers(len(chroms)))]
        pos = per_chrom.get(chrom, 1000) + int(rng.integers(1, 51))
        per_chrom[chrom] = pos
        ref = BASES[int(rng.integers(4))]
        alt = BASES[(BASES.index(ref) + 1 + int(rng.integers(3))) % 4]
        lines.append(f"{chrom}\t{pos}\t.\t{ref}\t{alt}\t.\t.\t.")
    path.write_text("\n".join(lines) + "\n")
    return str(path)


@pytest.mark.parametrize("n_shards", [2, 4, 8])
def test_mesh_load_matches_single_device(tmp_path, monkeypatch, n_shards):
    """Sorted single-chromosome VCF (and a long-allele tail row): the
    port's mesh load writes the bytes of its single-device load and of
    the reference's mesh load."""
    monkeypatch.setenv("AVDB_INGEST_ENGINE", "python")
    vcf = write_sorted_vcf(tmp_path / "chr22.vcf")
    dirs = {t: str(tmp_path / t) for t in ("ref", "mesh", "single")}
    c_ref = _vcf_load("ref", vcf, dirs["ref"], ref_make_mesh(n_shards))
    c_mesh = _vcf_load("port", vcf, dirs["mesh"], cpu_mesh(n_shards))
    c_single = _vcf_load("port", vcf, dirs["single"], None)
    for key in ("line", "variant", "skipped", "duplicates"):
        assert c_mesh[key] == c_single[key] == c_ref[key], key
    _same_dirs(dirs["ref"], dirs["mesh"])
    _same_dirs(dirs["single"], dirs["mesh"])


@pytest.mark.parametrize("engine", ["python", "native"])
def test_mesh_load_multi_chromosome(tmp_path, monkeypatch, engine):
    """Interleaved chromosomes route across owners without loss, with
    either tokenizer (the native one carries the hash in its chunks)."""
    monkeypatch.setenv("AVDB_INGEST_ENGINE", engine)
    vcf = _multi_vcf(tmp_path / "multi.vcf")
    dirs = {t: str(tmp_path / t) for t in ("ref", "mesh", "single")}
    _vcf_load("ref", vcf, dirs["ref"], ref_make_mesh(4), batch_size=128)
    c = _vcf_load("port", vcf, dirs["mesh"], cpu_mesh(4), batch_size=128)
    _vcf_load("port", vcf, dirs["single"], None, batch_size=128)
    assert c["variant"] == 800
    _same_dirs(dirs["ref"], dirs["mesh"])
    _same_dirs(dirs["single"], dirs["mesh"])


def _vep_base(tmp_path):
    """A 600-line multi-chromosome VCF (and an over-width row), its store
    (the reference's load, saved) and a VEP file of 400 results and two
    novel variants."""
    rng = np.random.default_rng(31)
    lines = ["##fileformat=VCFv4.2",
             "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO"]
    per_chrom = {}
    chroms = [str(c) for c in range(1, 23)] + ["X"]
    for i in range(600):
        chrom = chroms[int(rng.integers(len(chroms)))]
        pos = per_chrom.get(chrom, 1000) + int(rng.integers(1, 51))
        per_chrom[chrom] = pos
        ref = BASES[int(rng.integers(4))]
        alt = BASES[(BASES.index(ref) + 1 + int(rng.integers(3))) % 4]
        lines.append(f"{chrom}\t{pos}\trs{i}\t{ref}\t{alt}\t.\t.\tRS={i}")
    lines.append(f"22\t{per_chrom.get('22', 1000) + 60}\t.\t{'A' * 60}\tG\t.\t.\t.")
    vcf = tmp_path / "m.vcf"
    vcf.write_text("\n".join(lines) + "\n")
    base = str(tmp_path / "base")
    _vcf_load("ref", str(vcf), base, None)
    vep_json = str(tmp_path / "m.vep.json")
    n_results = _write_vep_json(vep_json, str(vcf), 400)
    return base, vep_json, n_results


@pytest.mark.parametrize("n_shards", [2, 4, 8])
def test_mesh_vep_update_matches_single_device(tmp_path, n_shards):
    """The native VEP update through the sharded update step writes the
    bytes of the port's single-device update and of the reference's mesh
    update; counters equal, both novel variants miss."""
    import shutil

    from annotatedvdb_tpu.conseq import ConsequenceRanker as RefRanker
    from annotatedvdb_tpu.loaders.vep_loader import TpuVepLoader

    from annotatedvdb_tpu_torch.conseq import ConsequenceRanker
    from annotatedvdb_tpu_torch.loaders import VepLoader

    base, vep_json, n_results = _vep_base(tmp_path)
    out = {}
    for tag, mesh in (("ref", ref_make_mesh(n_shards)),
                      ("mesh", cpu_mesh(n_shards)), ("single", None)):
        d = str(tmp_path / tag)
        shutil.copytree(base, d)
        if tag == "ref":
            store = RefStore.load(d)
            loader = TpuVepLoader(store, RefLedger(os.path.join(d, "ledger.jsonl")),
                                  RefRanker(), datasource="dbSNP", mesh=mesh,
                                  log=lambda *a: None)
        else:
            store = VariantStore.load(d)
            loader = VepLoader(store, AlgorithmLedger(os.path.join(d, "ledger.jsonl")),
                               ConsequenceRanker(), datasource="dbSNP", mesh=mesh,
                               log=lambda *a: None, device="cpu")
        out[tag] = loader.load_file(vep_json, commit=True)
        store.save(d)
        if tag == "mesh":
            assert loader._dev_snapshot is not None
    for key in ("line", "variant", "update", "not_found", "skipped"):
        assert out["mesh"][key] == out["single"][key] == out["ref"][key], key
    assert out["mesh"]["update"] == n_results - 2
    _same_dirs(str(tmp_path / "ref"), str(tmp_path / "mesh"))
    _same_dirs(str(tmp_path / "single"), str(tmp_path / "mesh"))


def _cadd_run(pkg, store_dir, cadd_dir, mesh, log_dir):
    if pkg == "ref":
        from annotatedvdb_tpu.loaders.cadd_loader import TpuCaddUpdater

        store = RefStore.load(store_dir)
        up = TpuCaddUpdater(store, RefLedger(os.path.join(store_dir, "ledger.jsonl")),
                            cadd_dir, mesh=mesh, log=lambda *a: None)
    else:
        from annotatedvdb_tpu_torch.loaders.cadd_loader import CaddUpdater

        store = VariantStore.load(store_dir)
        up = CaddUpdater(store, AlgorithmLedger(os.path.join(store_dir, "ledger.jsonl")),
                         cadd_dir, mesh=mesh, log=lambda *a: None, device="cpu")
    counters = up.update_all(commit=True)
    store.save(store_dir)
    return counters


def _cadd_trio(tmp_path, base, cadd_dir, n_shards):
    import shutil

    out = {}
    for tag, pkg, mesh in (("ref", "ref", ref_make_mesh(n_shards)),
                           ("mesh", "port", cpu_mesh(n_shards)),
                           ("single", "port", None)):
        d = str(tmp_path / tag)
        shutil.copytree(base, d)
        out[tag] = _cadd_run(pkg, d, cadd_dir, mesh, tmp_path)
    for key in ("snv", "indel", "update", "not_matched", "skipped"):
        assert out["mesh"][key] == out["single"][key] == out["ref"][key], key
    _same_dirs(str(tmp_path / "ref"), str(tmp_path / "mesh"))
    _same_dirs(str(tmp_path / "single"), str(tmp_path / "mesh"))
    return out


@pytest.mark.parametrize("n_shards", [2, 4, 8])
def test_mesh_cadd_join_matches_sequential(tmp_path, n_shards):
    """The CADD table pass through the sharded step (both allele
    orientations) writes the bytes of the block join and of the
    reference's mesh pass; the SNV count is the synthetic truth."""
    from annotatedvdb_tpu.io.synth import synthetic_cadd_setup

    cadd_dir = str(tmp_path / "cadd")
    store, expected = synthetic_cadd_setup(cadd_dir, 3000, 9000)
    base = str(tmp_path / "base")
    store.save(base)
    out = _cadd_trio(tmp_path, base, cadd_dir, n_shards)
    assert out["mesh"]["snv"] == expected


def test_mesh_cadd_join_edge_cases(tmp_path, monkeypatch):
    """Mesh CADD parity under the risky branches: several flushes
    (cross-flush first-wins), several chromosomes, an indel-table pass,
    long TABLE alleles (host rows) and an over-width STORE variant."""
    from annotatedvdb_tpu.loaders.cadd_loader import TpuCaddUpdater
    from annotatedvdb_tpu.loaders.vcf_loader import _fnv32_str
    from annotatedvdb_tpu.ops.hashing import allele_hash_np

    from annotatedvdb_tpu_torch.loaders.cadd_loader import CaddUpdater

    monkeypatch.setattr(TpuCaddUpdater, "MESH_FLUSH_ROWS", 256)
    monkeypatch.setattr(CaddUpdater, "MESH_FLUSH_ROWS", 256)
    width = 8
    store = RefStore(width=width)
    for code, start, n in ((1, 1000, 600), (2, 5000, 400)):
        pos = np.arange(start, start + n, dtype=np.int32)
        ref = np.zeros((n, width), np.uint8)
        alt = np.zeros((n, width), np.uint8)
        for j in range(n):
            ref[j, 0] = ord(BASES[j % 4])
            alt[j, 0] = ord(BASES[(j + 1 + j % 3) % 4])
        ones = np.ones(n, np.int32)
        store.shard(code).append(
            {"pos": pos, "h": allele_hash_np(ref, alt, ones, ones),
             "ref_len": ones, "alt_len": ones}, ref, alt)
    extra = [("AC", "A", 6000), ("A" * 20, "G", 6100)]
    ref = np.zeros((2, width), np.uint8)
    alt = np.zeros((2, width), np.uint8)
    rl, al, h, las = (np.zeros(2, np.int32), np.zeros(2, np.int32),
                      np.zeros(2, np.uint32), [])
    for j, (r, a, _p) in enumerate(extra):
        rb, ab = r.encode(), a.encode()
        ref[j, :min(len(rb), width)] = list(rb[:width])
        alt[j, :min(len(ab), width)] = list(ab[:width])
        rl[j], al[j] = len(rb), len(ab)
        if len(rb) > width or len(ab) > width:
            h[j] = _fnv32_str(r, a)
            las.append((r, a))
        else:
            h[j] = allele_hash_np(ref[j:j + 1], alt[j:j + 1], rl[j:j + 1],
                                  al[j:j + 1])[0]
            las.append(None)
    store.shard(2).append(
        {"pos": np.array([p for _, _, p in extra], np.int32), "h": h,
         "ref_len": rl, "alt_len": al}, ref, alt, long_alleles=las)
    base = str(tmp_path / "base")
    store.save(base)
    cadd_dir = str(tmp_path / "cadd")
    os.makedirs(cadd_dir)
    with gzip.open(os.path.join(cadd_dir, "whole_genome_SNVs.tsv.gz"), "wt") as f:
        f.write("## CADD\n#Chrom\tPos\tRef\tAlt\tRawScore\tPHRED\n")
        for code, start, n in ((1, 1000, 600), (2, 5000, 400)):
            for p in range(start, start + n):
                b = BASES[p % 4]
                for a in BASES:
                    if a != b:
                        f.write(f"{code}\t{p}\t{b}\t{a}\t0.25\t5.0\n")
    with gzip.open(os.path.join(cadd_dir, "gnomad.genomes.r3.0.indel.tsv.gz"),
                   "wt") as f:
        f.write("## CADD\n#Chrom\tPos\tRef\tAlt\tRawScore\tPHRED\n")
        f.write("2\t6000\tAC\tA\t0.75\t15.0\n")
        f.write(f"2\t6100\t{'A' * 20}\tG\t0.9\t20.0\n")
        f.write(f"2\t6100\t{'C' * 30}\tG\t0.1\t1.0\n")
    out = _cadd_trio(tmp_path, base, cadd_dir, 8)
    assert out["mesh"]["indel"] >= 2


def test_vcf_cli_mesh_load_records_the_reference_params(tmp_path, monkeypatch):
    """A ``load-vcf --maxWorkers 4`` run record carries the reference's
    ``params`` (the mesh changes no field), and the CLI says it annotated
    across four devices, as the reference's does."""
    import contextlib
    import io

    from annotatedvdb_tpu_torch.cli.load_vcf import main

    monkeypatch.setenv(meshlib.VIRTUAL_DEVICES_ENV, "4")
    meshlib.reset_global_mesh()
    vcf = _multi_vcf(tmp_path / "m.vcf", n=300)
    store = str(tmp_path / "vdb")
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        assert main(["--fileName", vcf, "--storeDir", store, "--commit",
                     "--platform", "cpu", "--maxWorkers", "4"]) == 0
    assert "annotating across 4 devices" in err.getvalue()
    with open(os.path.join(store, "ledger.jsonl")) as f:
        runs = [json.loads(ln) for ln in f if '"type": "run"' in ln
                or '"type":"run"' in ln]
    assert runs and runs[-1]["status"] == "completed"
    assert "maxWorkers" not in json.dumps(runs[-1]["params"])
    meshlib.reset_global_mesh()
