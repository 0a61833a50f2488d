"""The ADSP QC pVCF update (``update-qc``), end to end: the PyTorch port
against the JAX package.

One seeded base VCF is loaded by the reference; each test copies that
store twice and runs the reference's ``TpuQcPvcfLoader`` on one copy and
the port's ``QcPvcfLoader`` (on the CPU) on the other, with the same input
and options.  The seeded QC pVCF holds QUAL, FILTER (PASS on most lines,
LowQual and '.' on the rest), INFO of numeric keys, a flag, escapes and a
repeated key, FORMAT and a sample column; 90% of its lines are identities
the store holds (whole multi-allelic sites and single alts of them), 10%
are novel, over-width alleles on both sides, repeated lines (duplicates
within a chunk, known and novel), a malformed line, an unplaceable contig
and a '.' alt.  Each run happens under both engines (``native``: no
engine variable, 8 KiB read windows on both sides; ``python``:
``AVDB_INGEST_ENGINE=python``) and at two batch sizes.  The comparison is
exact: counters, persisted store bytes, quarantine files and ledger
records (invocation, checkpoint, finish; ``ts`` excluded).
"""

import json
import os
import shutil

import numpy as np
import pytest

import annotatedvdb_tpu.loaders as ref_loaders
from annotatedvdb_tpu.loaders import TpuVcfLoader
from annotatedvdb_tpu.native import vcf as ref_native_vcf
from annotatedvdb_tpu.store import AlgorithmLedger, VariantStore
from annotatedvdb_tpu.utils.quarantine import QuarantineSink as RefSink

import annotatedvdb_tpu_torch.loaders as port_loaders
from annotatedvdb_tpu_torch.native import vcf as port_native_vcf
from annotatedvdb_tpu_torch.store import AlgorithmLedger as TorchLedger
from annotatedvdb_tpu_torch.store import VariantStore as TorchStore
from annotatedvdb_tpu_torch.utils.quarantine import QuarantineSink
from test_qc_update import BASE_VCF, QC_VCF
from test_torch_load_vcf import _ledger_records, _persisted_bytes

ENGINES = ("native", "python")
WINDOW = 8 << 10
BATCHES = {"default": {}, "batch64": {"batch_size": 64}}
BASES = "ACGT"
#: the port's class -> the reference's
REF_NAMES = {"QcPvcfLoader": "TpuQcPvcfLoader",
             "SnpEffLofLoader": "TpuSnpEffLofLoader",
             "TextLoader": "TpuTextLoader"}


# ------------------------------------------------------------------ inputs


def seq(rng, n):
    return "".join(BASES[int(i)] for i in rng.integers(0, 4, n))


def other(rng, base):
    return BASES[(BASES.index(base[0]) + 1 + int(rng.integers(3))) % 4]


def base_sites(seed=1, n=360):
    """(chrom, pos, ref, alts, vid) of the base VCF: SNVs, indels,
    multi-allelic sites and over-width alleles, on chromosomes 1, 2 and X."""
    rng = np.random.default_rng(seed)
    sites, pos = [], {"1": 1000, "2": 5000, "X": 900}
    for k in range(n):
        chrom = ("1", "2", "X")[k % 3]
        pos[chrom] += int(rng.integers(4, 30)) * 2  # even positions
        ref = BASES[int(rng.integers(4))]
        kind = k % 11
        if kind == 1:
            alts = [ref + seq(rng, int(rng.integers(1, 5)))]
        elif kind == 2:
            ref += seq(rng, int(rng.integers(1, 5)))
            alts = [ref[0]]
        elif kind == 3:
            a = other(rng, ref)
            alts = [a, next(b for b in BASES if b not in (ref, a))]
        elif kind == 4 and k % 22 == 4:
            ref += seq(rng, 60)  # over width
            alts = [ref[0]]
        elif kind == 5 and k % 22 == 5:
            alts = [ref + seq(rng, 55)]  # over width
        else:
            alts = [other(rng, ref)]
        vid = f"rs{100 + k}" if k % 2 else "."
        sites.append((chrom, pos[chrom], ref, alts, vid))
    return sites


def write_base_vcf(path, sites):
    with open(path, "w") as fh:
        fh.write("##fileformat=VCFv4.2\n"
                 "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n")
        for chrom in ("1", "2", "X"):
            for c, pos, ref, alts, vid in sites:
                if c == chrom:
                    fh.write(f"{c}\t{pos}\t{vid}\t{ref}\t{','.join(alts)}\t.\t.\t.\n")


def qc_info(rng, k):
    ac = int(rng.integers(1, 50))
    info = f"AC={ac};AF={float(rng.random()):.4g};DP={int(rng.integers(5, 500))}"
    if k % 5 == 0:
        info += ";DB"
    if k % 53 == 0:
        info = f"AC=1;{info}"  # a repeated key: the later one wins
    if k % 29 == 0:
        info += ";ANN=A\\x2cB;NOTE=a#b;VQ=1e-3;S=x y"
    if k % 41 == 0:
        info = "."
    return info


def write_qc_vcf(path, sites, seed=2, novel_share=0.1, extra=()):
    """A QC pVCF over ``sites``: 90% of lines identities the store holds,
    ``novel_share`` novel (odd positions), repeated lines, one malformed
    line, an unplaceable contig and a '.' alt; ``extra`` lines appended.
    Returns the number of data lines."""
    rng = np.random.default_rng(seed)
    lines = []
    for k, (chrom, pos, ref, alts, _vid) in enumerate(sites):
        if rng.random() < novel_share:  # a novel variant beside the site
            nref = BASES[int(rng.integers(4))]
            nalt = other(rng, nref)
            if k % 7 == 0:
                nalt += "," + next(b for b in BASES if b not in (nref, nalt))
            elif k % 13 == 0:
                nref += seq(rng, 58)  # novel and over width
                nalt = nref[0]
            cpos, cref, calt = pos + 1, nref, nalt
        elif len(alts) > 1 and k % 2:
            cpos, cref, calt = pos, ref, alts[int(rng.integers(len(alts)))]
        else:
            cpos, cref, calt = pos, ref, ",".join(alts)
        u = rng.random()
        filt = "PASS" if u < 0.85 else ("LowQual" if u < 0.95 else ".")
        qual = "." if k % 10 == 3 else f"{float(rng.random()) * 100:.2f}"
        fmt = "." if k % 17 == 0 else "GT:DP:GQ"
        line = (f"{chrom}\t{cpos}\t.\t{cref}\t{calt}\t{qual}\t{filt}\t"
                f"{qc_info(rng, k)}\t{fmt}\t0/1:12:99\n")
        lines.append(line)
        if k % 37 == 0:
            lines.append(line)  # the same variant twice in one chunk
    lines.insert(len(lines) // 3, "1\tnot_a_pos\t.\tA\tC\t.\tPASS\t.\tGT\n")
    lines.insert(len(lines) // 2, "GL000219.1\t100\t.\tA\tC\t10\tPASS\tAC=1\tGT\n")
    lines.insert(2 * len(lines) // 3, "2\t7\t.\tA\t.\t10\tPASS\tAC=1\tGT\n")
    lines.extend(extra)
    with open(path, "w") as fh:
        fh.write("##fileformat=VCFv4.2\n"
                 "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tS1\n")
        fh.writelines(lines)
    return len(lines)


# ------------------------------------------------------------------ runs


def set_engine(mp, engine):
    """``python``: AVDB_INGEST_ENGINE=python for both packages; ``native``:
    no engine variable.  Read windows of 8 KiB on both sides either way."""
    if engine == "python":
        mp.setenv("AVDB_INGEST_ENGINE", "python")
    else:
        mp.delenv("AVDB_INGEST_ENGINE", raising=False)
    mp.setattr(ref_native_vcf, "READ_SIZE", WINDOW)
    mp.setattr(port_native_vcf, "READ_SIZE", WINDOW)


def build_base(vcf_text_or_sites, store_dir, width=49):
    """The reference's insert load of the base VCF (Python tokenizer,
    serial executor) into ``store_dir``."""
    mp = pytest.MonkeyPatch()
    try:
        mp.setenv("AVDB_INGEST_ENGINE", "python")
        mp.setenv("AVDB_PIPELINE", "serial")
        os.makedirs(store_dir)
        vcf = os.path.join(store_dir + ".vcf")
        if isinstance(vcf_text_or_sites, str):
            with open(vcf, "w") as fh:
                fh.write(vcf_text_or_sites)
        else:
            write_base_vcf(vcf, vcf_text_or_sites)
        store = VariantStore(width=width)
        loader = TpuVcfLoader(
            store, AlgorithmLedger(os.path.join(store_dir, "ledger.jsonl")),
            log=lambda *a: None)
        try:
            loader.load_file(vcf, commit=True)
        finally:
            loader.close()
        store.save(store_dir)
    finally:
        mp.undo()
    return store_dir


def run_one(pkg, cls, store_dir, path, sink_name, commit=True, **kw):
    """One update run of ``path`` on the store in ``store_dir`` through
    ``pkg`` ("ref" or "port"); returns what the comparison reads."""
    port = pkg == "port"
    Store, Ledger, Sink = ((TorchStore, TorchLedger, QuarantineSink) if port
                           else (VariantStore, AlgorithmLedger, RefSink))
    store = Store.load(store_dir)
    ledger = Ledger(os.path.join(store_dir, "ledger.jsonl"))
    sink = Sink(store_dir, path, sink_name)
    if port:
        loader = getattr(port_loaders, cls)(
            store, ledger, log=lambda *a: None, quarantine=sink, device="cpu", **kw)
    else:
        loader = getattr(ref_loaders, REF_NAMES[cls])(
            store, ledger, log=lambda *a: None, quarantine=sink, **kw)
    counters = error = None
    try:
        counters = loader.load_file(
            path, commit=commit,
            persist=(lambda: store.save(store_dir)) if commit else None)
    except ValueError as err:
        error = str(err)
    finally:
        sink.close()
        loader.insert_loader.close()
    qpath = os.path.join(store_dir, "quarantine",
                         os.path.basename(path) + ".rejects.jsonl")
    quarantine = open(qpath, "rb").read() if os.path.exists(qpath) else None
    return {"counters": counters, "error": error, "loader": loader,
            "store": store, "files": _persisted_bytes(store_dir),
            "quarantine": quarantine,
            "ledger": _ledger_records(os.path.join(store_dir, "ledger.jsonl"))}


def run_pair(base, work, tag, cls, path, sink_name, commit=True, dirs=None,
             **kw):
    """The same update through both packages, each on its own copy of the
    ``base`` store (or on ``dirs`` from an earlier pair); returns
    ``(ref, port)`` results and asserts they agree."""
    if dirs is None:
        dirs = (str(work / f"{tag}.ref"), str(work / f"{tag}.port"))
        for d in dirs:
            shutil.copytree(base, d)
    out = tuple(run_one(pkg, cls, d, path, sink_name, commit=commit, **kw)
                for pkg, d in zip(("ref", "port"), dirs))
    assert_same(*out)
    return out + (dirs,)


def assert_same(ref, port):
    assert port["error"] == ref["error"]
    assert port["counters"] == ref["counters"]
    assert list(port["files"]) == list(ref["files"])
    for name in ref["files"]:
        assert port["files"][name] == ref["files"][name], f"{name} bytes diverge"
    assert port["quarantine"] == ref["quarantine"]
    assert port["ledger"] == ref["ledger"]


# ------------------------------------------------------------------ tests


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_qc")
    sites = base_sites()
    qc = str(tmp / "qc.vcf")
    n_lines = write_qc_vcf(qc, sites)
    return {"base": build_base(sites, str(tmp / "base")), "qc": qc,
            "n_lines": n_lines, "tmp": tmp}


@pytest.mark.parametrize("batch", sorted(BATCHES))
@pytest.mark.parametrize("engine", ENGINES)
def test_qc_update_and_novel_insert(inputs, tmp_path, monkeypatch, engine, batch):
    """The seeded pVCF: same counters, store bytes, quarantine and ledger;
    every path reached (updates, inserts, the within-chunk duplicates, the
    rejects, both FILTER outcomes)."""
    set_engine(monkeypatch, engine)
    ref, port, _ = run_pair(inputs["base"], tmp_path, "qc", "QcPvcfLoader",
                            inputs["qc"], "update-qc", version="R4",
                            datasource="ADSP", **BATCHES[batch])
    c = port["counters"]
    assert c["update"] > 250 and c["inserted"] > 20 and c["skipped"] == 0
    assert c["rejected"] == 1 and c["malformed"] == 1
    assert c["line"] == inputs["n_lines"]
    assert port["loader"].insert_loader.counters["duplicates"] >= 1
    shard = port["store"].shard(1)
    flags = shard.column("is_adsp_variant")
    assert (flags == 1).any() and (flags == -1).any()
    assert any(b'"_long_alleles"' in v for v in port["files"].values())


@pytest.mark.parametrize("engine", ENGINES)
def test_qc_small_file_matches_reference(tmp_path, monkeypatch, engine):
    """The reference test's three-line file: the reference's values."""
    set_engine(monkeypatch, engine)
    base = build_base(BASE_VCF, str(tmp_path / "base"))
    qc = tmp_path / "qc.vcf"
    qc.write_text(QC_VCF)
    _ref, port, _ = run_pair(base, tmp_path, "small", "QcPvcfLoader", str(qc),
                             "update-qc", version="r4")
    assert port["counters"]["update"] == 2 and port["store"].n == 4
    shard = port["store"].shard(1)
    assert shard.get_ann("adsp_qc", 0) == {
        "r4": {"info": {"ABHet": 0.5, "AC": 3}, "filter": "PASS",
               "qual": "50", "format": "GT:DP"}}
    assert shard.get_col("is_adsp_variant", [0, 1]).tolist() == [1, -1]


@pytest.mark.parametrize("engine", ENGINES)
def test_qc_skip_existing_release_and_merge(inputs, tmp_path, monkeypatch, engine):
    """r4, r4 again (every known row skipped), r5 (merged beside r4), r4
    with ``update_existing``: each pass equal through both packages."""
    set_engine(monkeypatch, engine)
    dirs, got = None, []
    for version, kw in (("r4", {}), ("r4", {}), ("r5", {}),
                        ("r4", {"update_existing": True})):
        _ref, port, dirs = run_pair(inputs["base"], tmp_path, "passes",
                                    "QcPvcfLoader", inputs["qc"], "update-qc",
                                    dirs=dirs, version=version,
                                    datasource="ADSP", **kw)
        got.append(port["counters"])
    first, again, r5, forced = got
    assert again["update"] == 0 and again["inserted"] == 0
    assert again["skipped"] == r5["update"] == forced["update"]
    assert again["skipped"] > first["update"]  # the first pass's inserts too
    row = port["store"].shard(1).get_ann("adsp_qc", 0)
    assert set(row) == {"r4", "r5"}


@pytest.mark.parametrize("engine", ENGINES)
def test_qc_dry_run(inputs, tmp_path, monkeypatch, engine):
    """commit=False: same counters, nothing inserted or written."""
    set_engine(monkeypatch, engine)
    ref, port, (_, port_dir) = run_pair(inputs["base"], tmp_path, "dry",
                                        "QcPvcfLoader", inputs["qc"],
                                        "update-qc", commit=False, version="r4")
    assert port["counters"]["update"] > 250 and port["counters"]["inserted"] > 20
    assert port["store"].n == TorchStore.load(inputs["base"]).n
    assert port["files"] == _persisted_bytes(inputs["base"])


@pytest.mark.parametrize("where", ["known", "novel", "overwritten"])
@pytest.mark.parametrize("engine", ENGINES)
def test_qc_infinity_rejected(inputs, tmp_path, monkeypatch, engine, where):
    """An Infinity/NaN QC value aborts at the same row in both packages,
    through the batch path (a known row) and the per-row path (a novel
    row), after the same checkpoints; one overwritten by a later
    duplicate key does not abort."""
    set_engine(monkeypatch, engine)
    chrom, pos, ref, alts, _ = base_sites()[300]  # beyond the file's sites
    info = {"known": "AB=Infinity", "novel": "AC=2;AB=nan",
            "overwritten": "AB=inf;AB=1"}[where]
    p = pos + 1 if where == "novel" else pos
    a = other(np.random.default_rng(0), ref) if where == "novel" else ",".join(alts)
    line = f"{chrom}\t{p}\t.\t{ref}\t{a}\t50\tPASS\t{info}\tGT\t0/1\n"
    qc = str(tmp_path / "inf.vcf")
    write_qc_vcf(qc, base_sites()[:240], extra=[line])
    ref_out, port, _ = run_pair(inputs["base"], tmp_path, "inf", "QcPvcfLoader",
                                qc, "update-qc", version="r4", batch_size=64)
    if where == "overwritten":
        assert port["error"] is None
    else:
        assert "Infinity/NaN found among QC scores" in port["error"]
        assert port["ledger"][-1]["type"] == "checkpoint"


@pytest.mark.parametrize("engine", ENGINES)
def test_qc_cli(inputs, tmp_path, monkeypatch, capsys, engine):
    """``update-qc --platform cpu --commit`` through the port's CLI against
    the reference CLI on copies of one store: same printed counters and
    alg_id, store bytes, quarantine file and ledger records."""
    from annotatedvdb_tpu.cli.update_qc import main as ref_main

    from annotatedvdb_tpu_torch.__main__ import main as torch_main

    set_engine(monkeypatch, engine)
    printed, outs = {}, {}
    for tag in ("ref", "port"):
        d = str(tmp_path / tag)
        shutil.copytree(inputs["base"], d)
        args = ["--fileName", inputs["qc"], "--storeDir", d, "--version", "r4",
                "--commit", "--logAfter", "0"]
        capsys.readouterr()
        if tag == "ref":
            assert ref_main(args) == 0
        else:
            assert torch_main(["update-qc", *args, "--platform", "cpu"]) == 0
        printed[tag] = capsys.readouterr().out.strip().splitlines()[-2:]
        outs[tag] = d
    assert printed["port"] == printed["ref"]
    assert json.loads(printed["port"][0])["inserted"] > 20
    for d in outs.values():
        assert os.path.exists(os.path.join(
            d, "quarantine", "qc.vcf.rejects.jsonl"))
    ref = {"error": None, "counters": None, "files": _persisted_bytes(outs["ref"]),
           "ledger": _ledger_records(os.path.join(outs["ref"], "ledger.jsonl")),
           "quarantine": open(os.path.join(outs["ref"], "quarantine",
                                           "qc.vcf.rejects.jsonl"), "rb").read()}
    port = {"error": None, "counters": None,
            "files": _persisted_bytes(outs["port"]),
            "ledger": _ledger_records(os.path.join(outs["port"], "ledger.jsonl")),
            "quarantine": open(os.path.join(outs["port"], "quarantine",
                                            "qc.vcf.rejects.jsonl"), "rb").read()}
    assert_same(ref, port)
    assert json.loads(port["quarantine"].splitlines()[0])["meta"]["loader"] == "update-qc"


@pytest.mark.parametrize("flags", [["--metricsOut", "m.prom"],
                                   ["--traceOut", "t.json"]],
                         ids=lambda f: f[0])
def test_qc_cli_refuses_unported_flags(inputs, tmp_path, flags):
    """``--metricsOut`` and ``--traceOut`` are ported: each writes its file
    and the store gets the run record."""
    from annotatedvdb_tpu_torch.cli.update_qc import main as torch_main
    from test_torch_obs import check_obs_outputs

    store = str(tmp_path / "vdb")
    shutil.copytree(inputs["base"], store)
    out = str(tmp_path / flags[1])
    assert torch_main(["--fileName", inputs["qc"], "--storeDir", store,
                       *["--version", "r4"], "--platform", "cpu", "--commit", flags[0],
                       out]) == 0
    run = check_obs_outputs(flags[0], out, "update-qc", store)
    assert run["script"] == "update-qc" and run["counters"]["update"] > 0


def test_qc_cli_defaults_to_cuda_and_never_falls_back(inputs, tmp_path):
    import torch

    from annotatedvdb_tpu_torch.cli.update_qc import main as torch_main

    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    d = str(tmp_path / "vdb")
    shutil.copytree(inputs["base"], d)
    before = _persisted_bytes(d)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        torch_main(["--fileName", inputs["qc"], "--storeDir", d,
                    "--version", "r4", "--commit"])
    assert _persisted_bytes(d) == before
