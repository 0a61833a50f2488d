"""The host-only store commands of the PyTorch port — ``undo``,
``export-vcf`` and ``split-vcf`` — against the JAX package's CLIs.

Each test copies one reference-built store (two VCF loads, so two
invocations and several segments per shard: SNVs, indels, multi-allelic
sites, over-width alleles with digest primary keys, an allele with an
invalid single-letter code) and runs the reference's CLI on one copy and
the port's on the other.  ``undo``: the rows removed, the store bytes
after the save and the ledger's ``undo_intent``/``undo`` records (time
stamps aside), with and without ``--commit``; ``export-vcf``: every
exported file byte for byte, with ``--chr``, ``--variantsPerFile`` and the
``<chr>_invalid.txt`` file; ``split-vcf``: every per-chromosome file byte
for byte, with and without a chromosome map.
"""

import gzip
import os
import shutil

import numpy as np
import pytest

from annotatedvdb_tpu.cli.export_variant2vcf import main as ref_export
from annotatedvdb_tpu.cli.split_vcf_by_chr import main as ref_split
from annotatedvdb_tpu.cli.undo_load import main as ref_undo
from annotatedvdb_tpu.loaders import TpuVcfLoader
from annotatedvdb_tpu.store import AlgorithmLedger, VariantStore

from annotatedvdb_tpu_torch.__main__ import main as torch_main
from annotatedvdb_tpu_torch.store import AlgorithmLedger as TorchLedger
from annotatedvdb_tpu_torch.store import VariantStore as TorchStore
from test_torch_load_vcf import _ledger_records, _persisted_bytes
from test_torch_qc_update import base_sites, write_base_vcf

UNDO_TYPES = ("invocation", "checkpoint", "finish", "undo_intent", "undo")


def _tree(d) -> dict:
    out = {}
    for dirpath, _dirs, files in os.walk(d):
        for name in files:
            fp = os.path.join(dirpath, name)
            with open(fp, "rb") as f:
                out[os.path.relpath(fp, d)] = f.read()
    return out


@pytest.fixture(scope="module")
def store_dir(tmp_path_factory):
    """Two reference loads into one store (alg 1: the base sites on
    chromosomes 1, 2 and X; alg 2: more sites, an 'N' allele and a second
    over-width row), saved after each."""
    work = tmp_path_factory.mktemp("store_cmds")
    d = str(work / "vdb")
    mp = pytest.MonkeyPatch()
    try:
        mp.setenv("AVDB_INGEST_ENGINE", "python")
        mp.setenv("AVDB_PIPELINE", "serial")
        store = VariantStore(width=49)
        ledger = AlgorithmLedger(os.path.join(d, "ledger.jsonl"))
        os.makedirs(d)
        first, second = str(work / "first.vcf"), str(work / "second.vcf")
        write_base_vcf(first, base_sites(seed=21, n=300))
        with open(second, "w") as fh:
            fh.write("##fileformat=VCFv4.2\n#CHROM\tPOS\tID\tREF\tALT\tQUAL\t"
                     "FILTER\tINFO\n")
            rng = np.random.default_rng(4)
            for chrom in ("1", "2", "X"):
                for k, pos in enumerate(sorted(rng.integers(900, 20_000, 40))):
                    ref = "ACGT"[k % 4]
                    alt = "N" if k == 7 else "ACGT"[(k + 1) % 4]
                    if k == 11:
                        alt = ref + "G" * 70
                    fh.write(f"{chrom}\t{pos * 2 + 1}\trs9{k}\t{ref}\t{alt}\t.\t.\t.\n")
        for vcf in (first, second):
            loader = TpuVcfLoader(store, ledger, log=lambda *a: None)
            try:
                loader.load_file(vcf, commit=True, persist=lambda: store.save(d))
            finally:
                loader.close()
            store.save(d)
    finally:
        mp.undo()
    return d


def _pair(store_dir, tmp_path):
    dirs = {}
    for pkg in ("ref", "port"):
        dirs[pkg] = str(tmp_path / pkg)
        shutil.copytree(store_dir, dirs[pkg])
    return dirs


@pytest.mark.parametrize("alg_id", [1, 2, 9])
@pytest.mark.parametrize("commit", [True, False], ids=["commit", "dry_run"])
def test_undo_matches_reference(store_dir, tmp_path, capsys, alg_id, commit):
    dirs = _pair(store_dir, tmp_path)
    flags = ["--algId", str(alg_id)] + (["--commit"] if commit else [])
    capsys.readouterr()
    assert ref_undo(["--storeDir", dirs["ref"], *flags]) == 0
    ref_err = capsys.readouterr().err
    assert torch_main(["undo", "--storeDir", dirs["port"], *flags]) == 0
    port_err = capsys.readouterr().err
    assert port_err.splitlines()[-1] == ref_err.splitlines()[-1]
    ref_files, port_files = _persisted_bytes(dirs["ref"]), _persisted_bytes(dirs["port"])
    assert list(port_files) == list(ref_files)
    for name in ref_files:
        assert port_files[name] == ref_files[name], name
    ledgers = [_ledger_records(os.path.join(dirs[p], "ledger.jsonl"), UNDO_TYPES)
               for p in ("ref", "port")]
    assert ledgers[1] == ledgers[0]
    undo = [r for r in ledgers[1] if r["type"].startswith("undo")]
    if commit:
        assert [r["type"] for r in undo] == ["undo_intent", "undo"]
        removed = undo[1]["removed"]
        assert (removed > 0) == (alg_id in (1, 2))
        port = TorchStore.load(dirs["port"])
        assert port.n == VariantStore.load(store_dir).n - removed
        assert not any((sh.column("row_algorithm_id") == alg_id).any()
                       for sh in port.shards.values())
    else:
        assert undo == [] and port_files == _persisted_bytes(store_dir)


def test_undo_ledger_records_and_resume(store_dir, tmp_path):
    """``pending_undo_intents`` and ``last_checkpoint`` read the undo
    records as the reference's ledger does."""
    d = str(tmp_path / "vdb")
    shutil.copytree(store_dir, d)
    path = os.path.join(d, "ledger.jsonl")
    port, ref = TorchLedger(path), AlgorithmLedger(path)
    files = sorted({r["file"] for r in _ledger_records(path, ("checkpoint",))})
    assert files
    port.checkpoint(2, files[-1], 3)  # a crashed re-run of the second load
    port.undo_intent(2)
    for led in (TorchLedger(path), AlgorithmLedger(path)):
        assert led.pending_undo_intents() == [2]
    port.undo(2, 7)
    for f in files:
        assert TorchLedger(path).last_checkpoint(f) == \
            AlgorithmLedger(path).last_checkpoint(f)
    assert TorchLedger(path).pending_undo_intents() == []
    del ref


def test_store_delete_and_compact_match_reference(store_dir):
    """``delete_by_algorithm`` keeps untouched segments and filters the
    rest; ``compact`` merges each shard into one; the flat views and
    ``alleles`` then read the reference's rows."""
    port, ref = TorchStore.load(store_dir), VariantStore.load(store_dir)
    assert port.delete_by_algorithm(2) == ref.delete_by_algorithm(2) > 0
    port.compact()
    ref.compact()
    for code, shard in ref.shards.items():
        mine = port.shards[code]
        assert len(mine.segments) == len(shard.segments) == 1
        for name in shard.cols:
            np.testing.assert_array_equal(mine.cols[name], shard.cols[name])
        np.testing.assert_array_equal(mine.ref, shard.ref)
        np.testing.assert_array_equal(mine.alt, shard.alt)
        assert [mine.alleles(i) for i in range(mine.n)] == \
            [shard.alleles(i) for i in range(shard.n)]


@pytest.mark.parametrize("flags", [[], ["--chr", "X"], ["--variantsPerFile", "37"],
                                   ["--chr", "2", "--variantsPerFile", "5"],
                                   ["--chr", "Y"]],
                         ids=["all", "chrX", "per37", "chr2-per5", "absent"])
def test_export_vcf_matches_reference(store_dir, tmp_path, capsys, flags):
    outs = {}
    for pkg in ("ref", "port"):
        out = str(tmp_path / f"out_{pkg}")
        capsys.readouterr()
        args = ["--storeDir", store_dir, "--outputDir", out, *flags]
        assert (ref_export(args) if pkg == "ref"
                else torch_main(["export-vcf", *args])) == 0
        outs[pkg] = (capsys.readouterr().out, _tree(out))
    assert outs["port"] == outs["ref"]
    files = outs["port"][1]
    if flags == ["--chr", "Y"]:
        assert files == {}
        return
    assert any(name.endswith("_invalid.txt") and data for name, data in files.items())
    if "--variantsPerFile" in flags:
        assert sum(name.endswith(".vcf") for name in files) > 3


def test_export_vcf_rejects_unknown_chromosome(store_dir, tmp_path):
    with pytest.raises(SystemExit) as err:
        torch_main(["export-vcf", "--storeDir", store_dir,
                    "--outputDir", str(tmp_path / "out"), "--chr", "23q"])
    assert err.value.code == 2


SPLIT_VCF = """##fileformat=VCFv4.2
#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO
NC_000001.10\t100\t.\tA\tG\t.\t.\t.
NC_000001.10\t200\t.\tC\tT\t.\t.\tDP=3
chr2\t300\trs5\tG\tGA\t10\tPASS\t.
NC_000023.10\t50\t.\tG\tA\t.\t.\t.
NC_999999.1\t10\t.\tT\tC\t.\t.\t.
MT\t263\t.\tA\tG\t.\t.\t.

X\t70\t.\tC\tT\t.\t.\t.
"""


@pytest.mark.parametrize("mapped", [True, False], ids=["map", "no_map"])
@pytest.mark.parametrize("gz", [True, False], ids=["gz", "plain"])
def test_split_vcf_matches_reference(tmp_path, capsys, mapped, gz):
    src = tmp_path / ("all.vcf.gz" if gz else "all.vcf")
    if gz:
        with gzip.open(src, "wt") as fh:
            fh.write(SPLIT_VCF)
    else:
        src.write_text(SPLIT_VCF)
    map_file = tmp_path / "map.tsv"
    map_file.write_text(
        "source_id\tchromosome\tchromosome_order_num\tlength\n"
        "NC_000001.10\tchr1\t1\t249250621\n"
        "NC_000023.10\tchrX\t23\t155270560\n"
    )
    outs = {}
    for pkg in ("ref", "port"):
        out = str(tmp_path / f"out_{pkg}")
        args = ["-f", str(src), "-o", out] + (["-c", str(map_file)] if mapped else [])
        capsys.readouterr()
        assert (ref_split(args) if pkg == "ref"
                else torch_main(["split-vcf", *args])) == 0
        outs[pkg] = (capsys.readouterr().out, _tree(out))
    assert outs["port"] == outs["ref"]
    assert len(outs["port"][1]) == 25
    assert "'unmapped': " + ("1" if mapped else "4") in outs["port"][0]
