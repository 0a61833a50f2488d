"""The SnpEff loss-of-function update (``load-snpeff-lof``), end to end:
the PyTorch port against the JAX package.

The base store is the reference's load of ``test_torch_qc_update``'s
seeded VCF; each test runs the reference's ``TpuSnpEffLofLoader`` and the
port's ``SnpEffLofLoader`` (on the CPU) on copies of it with one input.
The seeded SnpEff file holds ``LOF=`` and/or ``NMD=`` on a share of its
lines (multi-record values, a bare ``LOF`` flag, short and non-numeric
records), ``ANN=`` on others, no INFO on some, variants the store lacks
(update only: never inserted), a malformed line and a repeated line.
Both engines, two batch sizes; counters, persisted store bytes,
quarantine files and ledger records compared exactly.
"""

import json
import os
import shutil

import numpy as np
import pytest

from annotatedvdb_tpu.loaders.lof_loader import SnpEffLofStrategy as RefStrategy
from annotatedvdb_tpu.loaders.lof_loader import parse_lof_string as ref_parse

from annotatedvdb_tpu_torch.loaders.lof_loader import (
    SnpEffLofStrategy,
    parse_lof_string,
)
from annotatedvdb_tpu_torch.store import VariantStore as TorchStore
from test_lof_update import BASE_VCF, LOF_VCF
from test_torch_load_vcf import _ledger_records, _persisted_bytes
from test_torch_qc_update import (
    BATCHES,
    ENGINES,
    assert_same,
    base_sites,
    build_base,
    other,
    run_pair,
    set_engine,
)


def lof_value(rng, k):
    n = 1 + k % 3
    return ",".join(
        f"(G{k}_{j}|ENSG{int(rng.integers(10**8)):011d}|"
        f"{int(rng.integers(1, 40))}|{float(rng.random()):.2f})"
        for j in range(n))


def write_snpeff_vcf(path, sites, seed=3):
    """SnpEff-annotated lines over ``sites``; returns the data line count."""
    rng = np.random.default_rng(seed)
    lines = []
    for k, (chrom, pos, ref, alts, _vid) in enumerate(sites):
        alt = ",".join(alts)
        if k % 9 == 4:  # an allele the store does not hold
            alt = next(b for b in "ACGT" if b != ref[0] and b not in alts)
        u = rng.random()
        if u < 0.2:
            info = f"AC=3;LOF={lof_value(rng, k)}"
        elif u < 0.3:
            info = f"NMD={lof_value(rng, k)};AC=1"
        elif u < 0.35:
            info = f"LOF={lof_value(rng, k)};NMD={lof_value(rng, k + 1)}"
        elif u < 0.37:
            info = ("LOF", "LOF=(GENE|ENSG0)", "NMD=(GENE|ENSG0|x|y)",
                    "AC=1;XLOF=1")[k % 4]  # values the strategy rejects
        elif u < 0.7:
            info = f"ANN=A|missense_variant|MODERATE|G{k};AC=2"
        else:
            info = "."
        line = f"{chrom}\t{pos}\t.\t{ref}\t{alt}\t.\t.\t{info}\n"
        lines.append(line)
        if k % 31 == 0:
            lines.append(line)
    lines.insert(len(lines) // 2, "1\tnot_a_pos\t.\tA\tC\t.\t.\tLOF=(G|E|1|1.0)\n")
    with open(path, "w") as fh:
        fh.write("##fileformat=VCFv4.2\n"
                 "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n")
        fh.writelines(lines)
    return len(lines)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_lof")
    sites = base_sites()
    lof = str(tmp / "lof.vcf")
    n_lines = write_snpeff_vcf(lof, sites)
    return {"base": build_base(sites, str(tmp / "base")), "lof": lof,
            "n_lines": n_lines}


def test_parse_lof_string():
    """The reference's cases and the seeded file's values parse equal."""
    rng = np.random.default_rng(0)
    cases = [None, True, "(GENE|ENSG0)", "(GENE|ENSG0|x|y)", "",
             "(SFI1|ENSG00000198089|30|0.17),(X|ENSGX|2|0.5)",
             "GENE|ENSG1|3|1e-2", "(A|B|3|nan),(C|D|4)"]
    cases += [lof_value(rng, k) for k in range(20)]
    for value in cases:
        assert parse_lof_string(value) == ref_parse(value), value
    assert parse_lof_string(cases[5])[1]["num_transcripts"] == 2


@pytest.mark.parametrize("batch", sorted(BATCHES))
@pytest.mark.parametrize("engine", ENGINES)
def test_lof_update(inputs, tmp_path, monkeypatch, engine, batch):
    set_engine(monkeypatch, engine)
    _ref, port, _ = run_pair(inputs["base"], tmp_path, "lof", "SnpEffLofLoader",
                             inputs["lof"], "load-snpeff-lof", **BATCHES[batch])
    c = port["counters"]
    assert c["update"] > 80 and c["not_found"] >= 5 and c["skipped"] > 150
    assert c["inserted"] == 0 and c["rejected"] == 1
    assert c["line"] == inputs["n_lines"]
    assert port["store"].n == TorchStore.load(inputs["base"]).n  # update only
    assert any(b'"NMD"' in v for v in port["files"].values())


@pytest.mark.parametrize("engine", ENGINES)
def test_lof_small_file_matches_reference(tmp_path, monkeypatch, engine):
    """The reference test's file: the reference's values."""
    set_engine(monkeypatch, engine)
    base = build_base(BASE_VCF, str(tmp_path / "base"))
    lof = tmp_path / "lof.vcf"
    lof.write_text(LOF_VCF)
    _ref, port, _ = run_pair(base, tmp_path, "small", "SnpEffLofLoader",
                             str(lof), "load-snpeff-lof")
    c = port["counters"]
    assert (c["update"], c["not_found"], port["store"].n) == (2, 1, 3)
    assert port["store"].shard(1).get_ann("loss_of_function", 0) == {
        "LOF": [{"gene_symbol": "SFI1", "gene_id": "ENSG00000198089",
                 "num_transcripts": 30, "fraction_affected_transcripts": 0.17}]}


@pytest.mark.parametrize("engine", ENGINES)
def test_lof_skip_existing_unless_update_existing(inputs, tmp_path, monkeypatch,
                                                  engine):
    set_engine(monkeypatch, engine)
    dirs, got = None, []
    for kw in ({}, {}, {"update_existing": True}):
        _ref, port, dirs = run_pair(inputs["base"], tmp_path, "passes",
                                    "SnpEffLofLoader", inputs["lof"],
                                    "load-snpeff-lof", dirs=dirs, **kw)
        got.append(port["counters"])
    first, again, forced = got
    assert again["update"] == 0 and forced["update"] == first["update"] > 0


@pytest.mark.parametrize("engine", ENGINES)
def test_prefilter_matches_unfiltered(inputs, tmp_path, monkeypatch, engine):
    """The LOF/NMD screen before the lookup: the port's mask equals the
    reference's on every chunk, and without it (both packages) the stored
    values and the update count stay; the screened-out rows the store
    lacks move from skipped to not_found."""
    from annotatedvdb_tpu.io.vcf import VcfBatchReader as RefReader

    from annotatedvdb_tpu_torch.io.vcf import VcfBatchReader

    set_engine(monkeypatch, engine)
    masks = [[SnpEffLofStrategy().prefilter(c).tolist()
              for c in VcfBatchReader(inputs["lof"], batch_size=64)],
             [RefStrategy().prefilter(c).tolist()
              for c in RefReader(inputs["lof"], batch_size=64)]]
    assert masks[0] == masks[1] and sum(map(sum, masks[0])) > 80
    _ref, on, _ = run_pair(inputs["base"], tmp_path, "on", "SnpEffLofLoader",
                           inputs["lof"], "load-snpeff-lof")
    monkeypatch.setattr(SnpEffLofStrategy, "prefilter", lambda self, chunk: None)
    monkeypatch.setattr(RefStrategy, "prefilter", lambda self, chunk: None)
    _ref, off, _ = run_pair(inputs["base"], tmp_path, "off", "SnpEffLofLoader",
                            inputs["lof"], "load-snpeff-lof")
    con, coff = on["counters"], off["counters"]
    assert con["update"] == coff["update"] and con["variant"] == coff["variant"]
    assert (con["skipped"] + con["not_found"]
            == coff["skipped"] + coff["not_found"])
    assert con["not_found"] < coff["not_found"]
    for name, data in on["files"].items():
        if name.endswith(".ann.jsonl"):
            assert data == off["files"][name]


@pytest.mark.parametrize("engine", ENGINES)
def test_lof_cli(inputs, tmp_path, monkeypatch, capsys, engine):
    """``load-snpeff-lof --platform cpu --commit`` against the reference
    CLI: printed counters and alg_id, store bytes, ledger records."""
    from annotatedvdb_tpu.cli.load_snpeff_lof import main as ref_main

    from annotatedvdb_tpu_torch.__main__ import main as torch_main

    set_engine(monkeypatch, engine)
    printed, out = {}, {}
    for tag in ("ref", "port"):
        d = str(tmp_path / tag)
        shutil.copytree(inputs["base"], d)
        args = ["--fileName", inputs["lof"], "--storeDir", d, "--commit",
                "--logAfter", "0"]
        capsys.readouterr()
        if tag == "ref":
            assert ref_main(args) == 0
        else:
            assert torch_main(["load-snpeff-lof", *args, "--platform", "cpu"]) == 0
        printed[tag] = capsys.readouterr().out.strip().splitlines()[-2:]
        qpath = os.path.join(d, "quarantine", "lof.vcf.rejects.jsonl")
        out[tag] = {"error": None, "counters": None, "files": _persisted_bytes(d),
                    "ledger": _ledger_records(os.path.join(d, "ledger.jsonl")),
                    "quarantine": open(qpath, "rb").read()}
    assert printed["port"] == printed["ref"]
    assert json.loads(printed["port"][0])["update"] > 80
    assert_same(out["ref"], out["port"])
    meta = json.loads(out["port"]["quarantine"].splitlines()[0])["meta"]
    assert meta["loader"] == "load-snpeff-lof"


@pytest.mark.parametrize("flags", [["--metricsOut", "m.prom"],
                                   ["--traceOut", "t.json"]],
                         ids=lambda f: f[0])
def test_lof_cli_refuses_unported_flags(inputs, tmp_path, flags):
    """``--metricsOut`` and ``--traceOut`` are ported: each writes its file
    and the store gets the run record."""
    from annotatedvdb_tpu_torch.cli.load_snpeff_lof import main as torch_main
    from test_torch_obs import check_obs_outputs

    store = str(tmp_path / "vdb")
    shutil.copytree(inputs["base"], store)
    out = str(tmp_path / flags[1])
    assert torch_main(["--fileName", inputs["lof"], "--storeDir", store,
                       "--platform", "cpu", "--commit", flags[0],
                       out]) == 0
    run = check_obs_outputs(flags[0], out, "load-snpeff-lof", store)
    assert run["script"] == "load-snpeff-lof" and run["counters"]["update"] > 0


def test_lof_cli_defaults_to_cuda_and_never_falls_back(inputs, tmp_path):
    import torch

    from annotatedvdb_tpu_torch.cli.load_snpeff_lof import main as torch_main

    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    d = str(tmp_path / "vdb")
    shutil.copytree(inputs["base"], d)
    before = _persisted_bytes(d)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        torch_main(["--fileName", inputs["lof"], "--storeDir", d, "--commit"])
    assert _persisted_bytes(d) == before


def test_unknown_site_never_inserted(tmp_path, monkeypatch):
    """A LOF line for a variant the store lacks counts not_found through
    both packages and adds no row."""
    set_engine(monkeypatch, "native")
    base = build_base(BASE_VCF, str(tmp_path / "base"))
    lof = tmp_path / "lof.vcf"
    rng = np.random.default_rng(1)
    lof.write_text("##fileformat=VCFv4.2\n#CHROM\tPOS\tID\tREF\tALT\tQUAL\t"
                   "FILTER\tINFO\n"
                   f"1\t100\t.\tA\t{other(rng, 'G')}\t.\t.\tLOF=(G|E|1|1.0)\n")
    _ref, port, _ = run_pair(base, tmp_path, "unknown", "SnpEffLofLoader",
                             str(lof), "load-snpeff-lof")
    assert port["counters"]["not_found"] == 1 and port["store"].n == 3
