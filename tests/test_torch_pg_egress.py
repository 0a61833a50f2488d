"""The Postgres egress (``install-schema``): the PyTorch port against the
JAX package.

One store is built through the port's CLIs on the CPU (a VCF with
multi-allelic sites, FREQ annotations, over-width rows that take the
host-fallback display path and digest-PK rows, then a VEP update and a
CADD join over it).  ``export_store`` and the ``install-schema`` CLI of
both packages read it: schema files, COPY files and ``load.sql`` must be
byte-identical, in both CLI modes (schema only, and ``--storeDir``), with
the egress window shrunk on both sides so the display recompute runs over
several windows.  A reference-built store that keeps its display
attributes exports identically too, and ``pg_escape`` answers the cases of
``tests/test_pg_egress.py``.  Every comparison is exact.
"""

import os
import shutil

import pytest

from annotatedvdb_tpu.io import egress as ref_egress
from annotatedvdb_tpu.io.pg_egress import export_store as ref_export_store
from annotatedvdb_tpu.io.pg_egress import pg_escape as ref_pg_escape
from annotatedvdb_tpu.loaders import TpuVcfLoader
from annotatedvdb_tpu.sql import full_schema as ref_full_schema
from annotatedvdb_tpu.store import AlgorithmLedger, VariantStore

from annotatedvdb_tpu_torch.io import egress as port_egress
from annotatedvdb_tpu_torch.io import pg_egress
from annotatedvdb_tpu_torch.sql import full_schema
from annotatedvdb_tpu_torch.store import AlgorithmLedger as TorchLedger
from annotatedvdb_tpu_torch.store import VariantStore as TorchStore
from chip_smoke import tree_bytes, vcf_sites, write_cadd_tables, write_vep_json
from test_pg_egress import VCF as SMALL_VCF
from test_torch_load_vcf import _write_vcf

WINDOW = 300


@pytest.fixture(scope="module")
def port_store(tmp_path_factory):
    """A store loaded, VEP-annotated and CADD-joined by the port's CLIs on
    the CPU."""
    from annotatedvdb_tpu_torch.__main__ import main as cli

    tmp = tmp_path_factory.mktemp("pg")
    vcf = str(tmp / "pg.vcf")
    _write_vcf(vcf, n_lines=1300, seed=29)
    store = str(tmp / "vdb")
    common = ["--storeDir", store, "--commit", "--logAfter", "0",
              "--platform", "cpu"]
    assert cli(["load-vcf", "--fileName", vcf, "--commitAfter", "256",
                *common]) == 0
    with open(vcf) as f:
        lines = [ln for ln in f if not ln.startswith("#")]
    vep = str(tmp / "pg.vep.json")
    write_vep_json(vep, [ln for ln in lines if ln[:2] in ("1\t", "2\t")], 300,
                   seed=4, n_novel=0)
    assert cli(["load-vep", "--fileName", vep, *common]) == 0
    sites = [s for s in vcf_sites(lines) if s[0] in ("1", "2")]
    spans = {label: (min(s[1] for s in sites if s[0] == label),
                     max(s[1] for s in sites if s[0] == label))
             for label in ("1", "2")}
    db = str(tmp / "cadd")
    write_cadd_tables(db, sites, spans, seed=3, block_rows=64)
    assert cli(["load-cadd", "--databaseDir", db, "--logFilePath",
                str(tmp / "cadd.log"), *common]) == 0
    return store


@pytest.fixture
def small_window(monkeypatch):
    monkeypatch.setattr(ref_egress, "EGRESS_WINDOW", WINDOW)
    monkeypatch.setattr(port_egress, "EGRESS_WINDOW", WINDOW)


def _assert_same_tree(ref_dir, port_dir):
    a, b = tree_bytes(ref_dir), tree_bytes(port_dir)
    assert sorted(a) == sorted(b)
    for name in a:
        assert a[name] == b[name], f"{name} bytes diverge"
    return a


def test_export_store_matches_reference(port_store, tmp_path, small_window):
    ledger = os.path.join(port_store, "ledger.jsonl")
    ref_counts = ref_export_store(VariantStore.load(port_store), str(tmp_path / "ref"),
                                  AlgorithmLedger(ledger))
    store = TorchStore.load(port_store)
    port_counts = pg_egress.export_store(store, str(tmp_path / "port"),
                                         TorchLedger(ledger), device="cpu")
    assert port_counts == ref_counts
    files = _assert_same_tree(str(tmp_path / "ref"), str(tmp_path / "port"))
    assert sum(port_counts.values()) == store.n > 1000
    rows = files["data/variant_chr1.copy"].decode().splitlines()
    cols = {c: i for i, c in enumerate(pg_egress.VARIANT_COPY_COLUMNS)}
    fields = [r.split("\t") for r in rows]
    # every path the export takes is reached: VEP and CADD values, digest
    # PKs, host-fallback display attributes (over-width rows)
    assert any(f[cols["vep_output"]] != "\\N" for f in fields)
    assert any(f[cols["cadd_scores"]] != "\\N" for f in fields)
    assert any(len(f[cols["record_primary_key"]].split(":")[2]) == 32 for f in fields)
    assert any(len(f[cols["metaseq_id"]]) > 60 for f in fields)
    assert all(f[cols["display_attributes"]] != "\\N" for f in fields)
    assert len(files["data/algorithm_invocation.copy"].splitlines()) == 3


def test_export_without_ledger_matches_reference(port_store, tmp_path):
    ref_export_store(VariantStore.load(port_store), str(tmp_path / "ref"))
    pg_egress.export_store(TorchStore.load(port_store), str(tmp_path / "port"),
                           device="cpu")
    files = _assert_same_tree(str(tmp_path / "ref"), str(tmp_path / "port"))
    assert "data/algorithm_invocation.copy" not in files


def test_stored_display_attributes_export_verbatim(tmp_path):
    """A reference store that keeps its display attributes: the export
    writes them as stored (no recompute) in both packages."""
    store_dir = str(tmp_path / "vdb")
    vcf = tmp_path / "t.vcf"
    vcf.write_text(SMALL_VCF)
    store = VariantStore(width=16)
    ledger = AlgorithmLedger(os.path.join(store_dir, "ledger.jsonl"))
    os.makedirs(store_dir)
    loader = TpuVcfLoader(store, ledger, log=lambda *a: None,
                          store_display_attributes=True)
    try:
        loader.load_file(str(vcf), commit=True)
    finally:
        loader.close()
    store.save(store_dir)
    calls = []
    original = pg_egress.computed_display_attributes

    def spy(*args):
        calls.append(args)
        return original(*args)

    pg_egress.computed_display_attributes = spy
    try:
        ref_export_store(VariantStore.load(store_dir), str(tmp_path / "ref"), ledger)
        pg_egress.export_store(TorchStore.load(store_dir), str(tmp_path / "port"),
                               TorchLedger(os.path.join(store_dir, "ledger.jsonl")),
                               device="cpu")
    finally:
        pg_egress.computed_display_attributes = original
    assert not calls
    _assert_same_tree(str(tmp_path / "ref"), str(tmp_path / "port"))


def _run_cli(pkg, argv, capsys):
    from annotatedvdb_tpu.cli.install_schema import main as ref_main

    from annotatedvdb_tpu_torch.__main__ import main as port_main

    capsys.readouterr()
    if pkg == "ref":
        assert ref_main(argv) == 0
    else:
        assert port_main(["install-schema", *argv, "--platform", "cpu"]) == 0
    return capsys.readouterr().out.replace(argv[1], "<out>")


@pytest.mark.parametrize("mode", ["schema", "store"])
def test_install_schema_cli_matches_reference(port_store, tmp_path, monkeypatch,
                                              capsys, small_window, mode):
    monkeypatch.setenv("AVDB_JAX_PLATFORM", "cpu")  # the reference pins it
    printed = {}
    for pkg in ("ref", "port"):
        argv = ["--outputDir", str(tmp_path / pkg)]
        if mode == "store":
            argv += ["--storeDir", port_store]
        printed[pkg] = _run_cli(pkg, argv, capsys)
    assert printed["port"] == printed["ref"]
    files = _assert_same_tree(str(tmp_path / "ref"), str(tmp_path / "port"))
    if mode == "schema":
        assert sorted(files) == [f"schema/{name}.sql" for name, _ in full_schema()]
    else:
        assert "load.sql" in files and printed["port"].startswith("exported ")


def test_install_schema_ledger_file_flag(port_store, tmp_path, monkeypatch, capsys):
    """``--ledgerFile`` names the AlgorithmInvocation source; a store
    without a ledger exports no invocation rows."""
    monkeypatch.setenv("AVDB_JAX_PLATFORM", "cpu")
    bare = str(tmp_path / "bare")
    shutil.copytree(port_store, bare)
    ledger = str(tmp_path / "elsewhere.jsonl")
    shutil.move(os.path.join(bare, "ledger.jsonl"), ledger)
    for pkg in ("ref", "port"):
        _run_cli(pkg, ["--outputDir", str(tmp_path / pkg), "--storeDir", bare,
                       "--ledgerFile", ledger], capsys)
        _run_cli(pkg, ["--outputDir", str(tmp_path / f"{pkg}.none"),
                       "--storeDir", bare], capsys)
    files = _assert_same_tree(str(tmp_path / "ref"), str(tmp_path / "port"))
    assert "data/algorithm_invocation.copy" in files
    files = _assert_same_tree(str(tmp_path / "ref.none"), str(tmp_path / "port.none"))
    assert "data/algorithm_invocation.copy" not in files


def test_schema_matches_reference():
    assert full_schema() == ref_full_schema()


@pytest.mark.parametrize("value, want", [
    (None, "\\N"), (True, "t"), (False, "f"), ("a\tb\nc\\d", "a\\tb\\nc\\\\d"),
    (42, "42"), ("x\r\b\f\vy", "x\\r\\b\\f\\vy"), ("plain", "plain"),
])
def test_pg_escape_matches_reference(value, want):
    assert pg_egress.pg_escape(value) == ref_pg_escape(value) == want


def test_install_schema_defaults_to_cuda(port_store, tmp_path):
    """``--storeDir`` without ``--platform`` needs a card: without one the
    command raises before writing anything; a schema-only run needs no
    device."""
    import torch

    from annotatedvdb_tpu_torch.cli.install_schema import main

    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--outputDir", str(tmp_path / "pg"), "--storeDir", port_store])
    assert not (tmp_path / "pg" / "data").exists()
    assert main(["--outputDir", str(tmp_path / "schema")]) == 0


def test_copy_write_retries_transient_io_and_leaves_no_tmp(port_store, tmp_path,
                                                           monkeypatch):
    """A transient EIO on a COPY file's rename re-writes the file (the
    export completes, byte-identical to the reference's); a persistent
    one propagates and strands no tmp file."""
    import errno

    monkeypatch.setattr("annotatedvdb_tpu_torch.utils.retry.time.sleep", lambda s: None)
    real_replace = os.replace
    fails = {"left": 1}

    def flaky(src, dst):
        if fails["left"] and dst.endswith(".copy"):
            fails["left"] -= 1
            raise OSError(errno.EIO, "transient")
        return real_replace(src, dst)

    monkeypatch.setattr(pg_egress.os, "replace", flaky)
    pg_egress.export_store(TorchStore.load(port_store), str(tmp_path / "port"),
                           device="cpu")
    ref_export_store(VariantStore.load(port_store), str(tmp_path / "ref"))
    _assert_same_tree(str(tmp_path / "ref"), str(tmp_path / "port"))
    fails["left"] = 10
    with pytest.raises(OSError):
        pg_egress.export_store(TorchStore.load(port_store), str(tmp_path / "bad"),
                               device="cpu")
    assert not [n for n in os.listdir(tmp_path / "bad" / "data") if ".tmp" in n]
