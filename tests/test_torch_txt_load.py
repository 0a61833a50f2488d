"""The TSV annotation update (``update-annotation``), end to end: the
PyTorch port against the JAX package.

The base store is the reference's load of ``test_torch_qc_update``'s
seeded VCF; each test runs the reference's ``TpuTextLoader`` and the
port's ``TextLoader`` (on the CPU) on copies of it with one TSV.  The
seeded METASEQ file names every row of a share of the store's variants
(each alt of a multi-allelic site on its own line), 5% novel ids (some
over the width, some with an rs id column), JSON, boolean and rs-id
columns with NULL and empty cells, repeated ids (merged in order), ids
with a ``chr`` prefix, a bad JSON cell and malformed ids (quarantined).
REFSNP and digest-form PRIMARY_KEY files key the same store.  The TSV
path reads no VCF, so no engine variable applies; batch sizes are the
default and 7.  Counters, persisted store bytes, quarantine files and
ledger records are compared exactly.
"""

import json
import os
import shutil

import numpy as np
import pytest

from annotatedvdb_tpu.loaders.txt_loader import coerce_update_value as ref_coerce
from annotatedvdb_tpu.loaders.txt_loader import parse_variant_id as ref_parse
from annotatedvdb_tpu.store import VariantStore

from annotatedvdb_tpu_torch.loaders.txt_loader import (
    coerce_update_value,
    parse_variant_id,
)
from test_torch_load_vcf import _ledger_records, _persisted_bytes
from test_torch_qc_update import (
    assert_same,
    base_sites,
    build_base,
    other,
    run_pair,
    seq,
)
from test_txt_load import BASE_VCF

BATCHES = {"default": {}, "batch7": {"batch_size": 7}}
HEADER = ["variant", "other_annotation", "ref_snp_id", "gwas_flags",
          "is_adsp_variant", "not_a_column"]


def write_tsv(path, header, rows):
    with open(path, "w") as fh:
        fh.write("\n".join("\t".join(r) for r in [header] + rows) + "\n")


def metaseq_rows(sites, seed=4, novel_share=0.05):
    rng = np.random.default_rng(seed)
    rows = []
    for k, (chrom, pos, ref, alts, _vid) in enumerate(sites):
        if k % 3 == 2:
            continue  # a third of the store is not named
        ids = []
        if rng.random() < novel_share:
            nref = "ACGT"[int(rng.integers(4))]
            if k % 4 == 0:
                nref += seq(rng, 55)  # novel and over the width
            ids.append(f"{chrom}:{pos + 1}:{nref}:{other(rng, nref)}")
        else:
            ids += [f"{chrom}:{pos}:{ref}:{a}" for a in alts]
        for vid in ids:
            if k % 10 == 1:
                vid = "chr" + vid
            rs = ("NULL", "", f"rs{9000 + k}")[k % 3]
            flags = "NULL" if k % 4 else json.dumps({"ADGC": {"p": k * 1e-9}})
            ann = json.dumps({"src": f"s{k}", "n": k, "nested": {"k": [k, "x"]}})
            rows.append([vid, ann, rs, flags, ("true", "False", "")[k % 3], "z"])
            if k % 23 == 0:  # the same id again: merged in order
                rows.append([vid, json.dumps({"src": "again", "m": 1}), "NULL",
                             json.dumps({"IGAP": {"p": 0.5}}), "t", "z"])
    rows.insert(len(rows) // 2, ["1:100", "{}", "NULL", "NULL", "", "z"])
    rows.insert(len(rows) // 3, ["GL000219.1:100:A:G", "{}", "", "NULL", "", "z"])
    rows.insert(2 * len(rows) // 3, [rows[5][0], "{notjson", "", "NULL", "", "z"])
    return rows


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_txt")
    sites = base_sites()
    base = build_base(sites, str(tmp / "base"))
    meta = str(tmp / "meta.tsv")
    write_tsv(meta, HEADER, metaseq_rows(sites))
    refsnp = str(tmp / "refsnp.tsv")
    write_tsv(refsnp, ["variant", "gwas_flags", "other_annotation"],
              [[f"rs{100 + k}" if k % 7 else f"rs{77000 + k}",
                json.dumps({"hit": k}), "NULL"]
               for k in range(1, 360, 2)] + [["rs", "{}", "NULL"]])
    digests = []
    ref_store = VariantStore.load(base)
    for code, shard in sorted(ref_store.shards.items()):
        pos = shard.column("pos")
        for i, pk in enumerate(shard.object_column("_digest_pk")):
            if pk is not None:
                digests.append((pk, int(pos[i])))
    assert len(digests) >= 10
    pk_rows = [[pk, json.dumps({"pk": j})] for j, (pk, _p) in enumerate(digests)]
    pk_rows += [["chr" + digests[0][0], json.dumps({"chr": 1})],
                [digests[1][0].rsplit(":", 1)[0] + ":rs1", json.dumps({"no_rs": 1})],
                ["1:100", "{}"], ["1:12:GnDKL2Ax6uVVmPPDKEC17BsPB4ACKEHx", "{}"]]
    pk = str(tmp / "pk.tsv")
    write_tsv(pk, ["variant", "other_annotation"], pk_rows)
    return {"base": base, "meta": meta, "refsnp": refsnp, "pk": pk}


# ------------------------------------------------------------ parsing


PARSE_CASES = [
    ("1:100:A:G", "METASEQ"), ("X:5:AC:-", "METASEQ"), ("chrM:7:a:t", "METASEQ"),
    ("1:100:A:G:rs11", "PRIMARY_KEY"),
    ("1:100:GnDKL2Ax6uVVmPPDKEC17BsPB4ACKEHx:rs99", "PRIMARY_KEY"),
    ("rs22", "REFSNP"), ("1:100", "PRIMARY_KEY"), ("1:100:A", "METASEQ"),
    ("1:100:GnDKL2Ax6uVVmPPDKEC17BsPB4ACKEHx", "METASEQ"), ("1:100", "METASEQ"),
    ("GL000219.1:100:A:G", "METASEQ"), ("1", "METASEQ"), ("1:x:A:G", "METASEQ"),
    ("1:100:A:G:rs1:extra", "PRIMARY_KEY"), ("MT:3:N:U", "METASEQ"),
]


def _outcome(fn, *args):
    try:
        return ("ok", fn(*args))
    except ValueError as err:
        return ("error", str(err))


def test_parse_variant_id():
    for case in PARSE_CASES:
        assert _outcome(parse_variant_id, *case) == _outcome(ref_parse, *case), case
    assert parse_variant_id("1:100:A:G", "METASEQ") == (1, 100, "A", "G", None)


def test_parse_variant_id_malformed_and_contigs():
    with pytest.raises(ValueError, match="without alleles"):
        parse_variant_id("1:100", "METASEQ")
    with pytest.raises(ValueError, match="unplaceable"):
        parse_variant_id("GL000219.1:100:A:G", "METASEQ")
    assert parse_variant_id("1:100", "PRIMARY_KEY") == (1, 100, None, None, None)


def test_coerce_update_value():
    cases = [("gwas_flags", '{"AD": true}'), ("gwas_flags", "NULL"),
             ("gwas_flags", ""), ("gwas_flags", {"a": 1}),
             ("is_adsp_variant", "true"), ("is_adsp_variant", "False"),
             ("is_multi_allelic", " T "), ("ref_snp_id", "rs123"),
             ("ref_snp_id", 5), ("other", "12"), ("other", "1.5e3"),
             ("other", "abc"), ("vep_output", "[1, 2]"), ("gwas_flags", "{notjson")]
    for field, value in cases:
        assert (_outcome(coerce_update_value, field, value)
                == _outcome(ref_coerce, field, value)), (field, value)


# ------------------------------------------------------------ loads


@pytest.mark.parametrize("batch", sorted(BATCHES))
def test_tsv_update_known_and_insert_novel(inputs, tmp_path, batch):
    """The seeded METASEQ file: updates, inserts, repeated ids, rejects."""
    _ref, port, _ = run_pair(inputs["base"], tmp_path, "meta", "TextLoader",
                             inputs["meta"], "update-variant-annotation",
                             **BATCHES[batch])
    c = port["counters"]
    assert c["update"] > 200 and c["inserted"] >= 5 and c["rejected"] == 3
    assert c["duplicates"] == c["update"] and c["not_found"] == 0
    assert any(b'"again"' in v for v in port["files"].values())


def test_tsv_adsp_datasource_and_skip_existing(inputs, tmp_path):
    """``datasource=ADSP`` flags every updated row; ``skip_existing``
    leaves known rows alone and still inserts the novel ones."""
    for tag, kw in (("adsp", {"datasource": "ADSP"}),
                    ("skip", {"update_existing": False, "skip_existing": True})):
        _ref, port, _ = run_pair(inputs["base"], tmp_path, tag, "TextLoader",
                                 inputs["meta"], "update-variant-annotation", **kw)
    c = port["counters"]
    assert c["update"] == 0 and c["skipped"] == c["duplicates"] + 3
    assert c["inserted"] >= 5


def test_tsv_refsnp_lookup_and_not_found(inputs, tmp_path):
    _ref, port, _ = run_pair(inputs["base"], tmp_path, "rs", "TextLoader",
                             inputs["refsnp"], "update-variant-annotation",
                             variant_id_type="REFSNP", batch_size=16)
    c = port["counters"]
    assert c["update"] > 100 and c["not_found"] > 10 and c["inserted"] == 0


def test_tsv_digest_primary_keys(inputs, tmp_path):
    """Digest-form primary keys resolve by a scan of the digest column
    (a ``chr`` prefix included); short and unknown keys count not_found."""
    _ref, port, _ = run_pair(inputs["base"], tmp_path, "pk", "TextLoader",
                             inputs["pk"], "update-variant-annotation",
                             variant_id_type="PRIMARY_KEY", batch_size=5)
    c = port["counters"]
    assert c["update"] >= 12 and c["not_found"] >= 2


def test_tsv_dry_run(inputs, tmp_path):
    _ref, port, _ = run_pair(inputs["base"], tmp_path, "dry", "TextLoader",
                             inputs["meta"], "update-variant-annotation",
                             commit=False)
    assert port["counters"]["update"] > 200 and port["counters"]["inserted"] >= 5
    assert port["files"] == _persisted_bytes(inputs["base"])


def test_tsv_small_files_match_reference(tmp_path):
    """The reference tests' small files, through both packages: known
    updates then a merge, a novel insert, refSNP hit and miss, skip
    existing, a dry run, malformed ids, a short primary key and a novel
    dry run counted once."""
    base = build_base(BASE_VCF, str(tmp_path / "base"))
    cases = [
        ("known", ["variant", "gwas_flags", "ref_snp_id"],
         [["1:100:A:G", '{"ADGC": {"pvalue": 1e-8}}', "NULL"],
          ["1:200:C:T", '{"IGAP": {"pvalue": 0.5}}', "rs33"]], {}),
        ("merge", ["variant", "gwas_flags"],
         [["1:100:A:G", '{"IGAP": {"pvalue": 0.01}}']], {}),
        ("novel", ["variant", "other_annotation"],
         [["2:900:G:GAT", '{"src": "x"}']], {}),
        ("refsnp", ["variant", "gwas_flags"],
         [["rs22", '{"hit": 1}'], ["rs404", '{"miss": 1}']],
         {"variant_id_type": "REFSNP"}),
        ("skip", ["variant", "gwas_flags"], [["1:100:A:G", '{"x": 1}']],
         {"update_existing": False, "skip_existing": True}),
        ("malformed", ["variant", "gwas_flags"],
         [["1:100", '{"x": 1}'], ["GL000219.1:100:A:G", '{"x": 1}'],
          ["1:100:A:G", '{"x": 2}']], {}),
        ("shortpk", ["variant", "gwas_flags"], [["1:100", '{"x": 1}']],
         {"variant_id_type": "PRIMARY_KEY"}),
    ]
    dirs = None
    got = {}
    for tag, header, rows, kw in cases:
        tsv = tmp_path / f"{tag}.tsv"
        write_tsv(tsv, header, rows)
        _ref, port, dirs = run_pair(base, tmp_path, "small", "TextLoader",
                                    str(tsv), "update-variant-annotation",
                                    dirs=dirs, **kw)
        got[tag] = port["counters"]
    assert got["known"]["update"] == 2 and got["novel"]["inserted"] == 1
    assert (got["refsnp"]["update"], got["refsnp"]["not_found"]) == (1, 1)
    assert got["skip"]["skipped"] == 1 and got["malformed"]["skipped"] == 2
    assert got["shortpk"]["not_found"] == 1
    shard = port["store"].shard(1)
    assert set(shard.get_ann("gwas_flags", 0)) == {"ADGC", "IGAP", "x"}
    assert shard.get_col("ref_snp", [1]).tolist() == [33]
    tsv = tmp_path / "novel2.tsv"
    write_tsv(tsv, ["variant", "gwas_flags"],
              [["5:777:T:TG", '{"n": 1}'], ["5:778:C:A", '{"n": 2}']])
    for commit in (False, True):
        _ref, port, dirs = run_pair(base, tmp_path, "small", "TextLoader",
                                    str(tsv), "update-variant-annotation",
                                    dirs=dirs, commit=commit)
        c = port["counters"]
        assert c["inserted"] == 2 and c["update"] == 0
    assert port["store"].shard(5).get_ann("gwas_flags", 0) == {"n": 1}


def test_tsv_cli(inputs, tmp_path, capsys):
    """``update-annotation --platform cpu --commit`` against the reference
    CLI: printed counters and alg_id, store bytes, quarantine (with the
    TSV header bound late), ledger records."""
    from annotatedvdb_tpu.cli.update_variant_annotation import main as ref_main

    from annotatedvdb_tpu_torch.__main__ import main as torch_main

    printed, out = {}, {}
    for tag in ("ref", "port"):
        d = str(tmp_path / tag)
        shutil.copytree(inputs["base"], d)
        args = ["--fileName", inputs["meta"], "--storeDir", d, "--commit",
                "--datasource", "ADSP", "--logAfter", "0"]
        capsys.readouterr()
        if tag == "ref":
            assert ref_main(args) == 0
        else:
            assert torch_main(["update-annotation", *args, "--platform", "cpu"]) == 0
        printed[tag] = capsys.readouterr().out.strip().splitlines()[-2:]
        qpath = os.path.join(d, "quarantine", "meta.tsv.rejects.jsonl")
        out[tag] = {"error": None, "counters": None, "files": _persisted_bytes(d),
                    "ledger": _ledger_records(os.path.join(d, "ledger.jsonl")),
                    "quarantine": open(qpath, "rb").read()}
    assert printed["port"] == printed["ref"]
    assert json.loads(printed["port"][0])["inserted"] >= 5
    assert_same(out["ref"], out["port"])
    meta = json.loads(out["port"]["quarantine"].splitlines()[0])["meta"]
    assert meta["loader"] == "update-variant-annotation"
    assert meta["header"] == "\t".join(HEADER)


@pytest.mark.parametrize("flags", [["--metricsOut", "m.prom"],
                                   ["--traceOut", "t.json"]],
                         ids=lambda f: f[0])
def test_tsv_cli_refuses_unported_flags(inputs, tmp_path, flags):
    """``--metricsOut`` and ``--traceOut`` are ported: each writes its file
    and the store gets the run record."""
    from annotatedvdb_tpu_torch.cli.update_variant_annotation import main as torch_main
    from test_torch_obs import check_obs_outputs

    store = str(tmp_path / "vdb")
    shutil.copytree(inputs["base"], store)
    out = str(tmp_path / flags[1])
    assert torch_main(["--fileName", inputs["meta"], "--storeDir", store,
                       "--platform", "cpu", "--commit", flags[0],
                       out]) == 0
    run = check_obs_outputs(flags[0], out, "update-variant-annotation", store)
    assert run["script"] == "update-variant-annotation" and run["counters"]["update"] > 0


def test_tsv_cli_defaults_to_cuda_and_never_falls_back(inputs, tmp_path):
    import torch

    from annotatedvdb_tpu_torch.cli.update_variant_annotation import main as torch_main

    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    d = str(tmp_path / "vdb")
    shutil.copytree(inputs["base"], d)
    before = _persisted_bytes(d)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        torch_main(["--fileName", inputs["meta"], "--storeDir", d, "--commit"])
    assert _persisted_bytes(d) == before
