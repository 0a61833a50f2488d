"""The corpus export (``export``, ``export/core.py``, ``ops/export_pack.py``):
the PyTorch port against the JAX package, on the CPU.

The pack kernel's plain version (``export_pack_reference``), the port's
numpy twin and the CPU path of the wrapper are held exactly, dtypes
included, against the reference's jitted ``export_pack_kernel_jit`` and its
twin ``export_pack_host``: seeded random int32 rows, edge positions (the
int32 ends, the leaf-bin edges at 15,625, ``MAX_QUERY_POS``), ``end <
pos``, ``a ^ b`` at each power of two and every ``n_valid`` case; stacks
of 1, 2 and 37 batches (B a multiple of 4 and not) with mixed ``n_valid``,
the stacked plain version and wrapper held batch by batch against the
jitted kernel, and the wrapper's refusals of counts that do not match.

One store is built with the port's ``VariantStore``: two chromosomes, three
runs of rows each with CADD scores, consequence ranks and allele
frequencies present and missing, multi-base and over-width alleles and a
newer segment that repeats some identities (shadowed).  Both packages'
``run_export`` then export copies of it with seed 3, 16-row batches and
2 KiB parts: every part and the manifest byte-equal, the summaries and the
ledger records equal but for timings, paths and timestamps, for the whole
store shuffled, ``ordered``, a ``region`` and a ``chromosome``, and the
port's ``host_only`` path, with one plain-version call a part (the export
packs a part's staged batches at once); a plan whose last part is short,
and an export cut by ``max_parts`` then resumed.  Then the dry run, resume
after the reference's CLI was killed at its ``export.commit`` fault point
(the mirror case and the ``export.*`` matrix are in
``test_torch_faults_store.py``), the port's ``--test`` followed by
``--resume``, the
resume refusals and the CLI's errors.
"""

import json
import os
import shutil
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

from annotatedvdb_tpu.cli.export_corpus import main as ref_main
from annotatedvdb_tpu.config import StoreConfig
from annotatedvdb_tpu.export.core import run_export as ref_run_export
from annotatedvdb_tpu.export.stream import emission_order as ref_emission_order
from annotatedvdb_tpu.ops.export_pack import export_pack_host as ref_host
from annotatedvdb_tpu.ops.export_pack import export_pack_kernel_jit

from annotatedvdb_tpu_torch.cli.export_corpus import main as port_main
from annotatedvdb_tpu_torch.export import core
from annotatedvdb_tpu_torch.export.stream import emission_order
from annotatedvdb_tpu_torch.export.writer import read_manifest, read_part
from annotatedvdb_tpu_torch.loaders.lookup import identity_hashes
from annotatedvdb_tpu_torch.ops import export_pack as pack_ops
from annotatedvdb_tpu_torch.ops.intervals import MAX_QUERY_POS
from annotatedvdb_tpu_torch.ops.stats import feature_values
from annotatedvdb_tpu_torch.store import AlgorithmLedger, VariantStore
from annotatedvdb_tpu_torch.store.variant_store import Segment
from annotatedvdb_tpu_torch.types import encode_allele_array

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from chip_smoke import (  # noqa: E402
    export_edge_columns,
    export_random_columns,
    export_stack_counts,
    export_store_columns,
)

# ------------------------------------------------------------ the kernel

def n_valid_cases(b):
    return (-1, 0, 1, b - 1, b, b + 5)


def assert_outputs_equal(got, want):
    assert len(got) == len(want) == 9
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def check_pack(cols):
    """Plain version, numpy twin and the wrapper's CPU path against the
    jitted kernel and the reference's twin, for every ``n_valid`` case."""
    b = cols[0].shape[0]
    tensors = [torch.from_numpy(c) for c in cols]
    stacked = torch.from_numpy(np.stack(cols))
    for n in n_valid_cases(b):
        want = [np.asarray(a) for a in export_pack_kernel_jit(*cols, np.int32(n))]
        assert_outputs_equal(ref_host(*cols, np.int32(n)), want)
        assert_outputs_equal(
            [t.numpy() for t in pack_ops.export_pack_reference(*tensors, n)], want)
        assert_outputs_equal(pack_ops.export_pack_host(*cols, n), want)
        buf = pack_ops.export_pack(stacked, n)
        assert buf.dtype == torch.uint8 and buf.shape == (30 * b,)
        assert_outputs_equal(pack_ops.unpack(buf.numpy(), b), want)
        chunk = {"n_valid": n, **dict(zip(pack_ops.COLUMNS, cols))}
        [got] = pack_ops.pack_part([chunk], torch.device("cpu"))
        assert_outputs_equal(got, want)


@pytest.mark.parametrize("b", [8, 16, 4096])
def test_pack_matches_reference_on_random_rows(b):
    check_pack(export_random_columns(b, b))


@pytest.mark.parametrize("b", [8, 16, 4096])
def test_pack_matches_reference_on_store_shaped_rows(b):
    """Positions and ends as a chr22 store gives them, features -1 or
    fixed point."""
    check_pack(export_store_columns(100 + b, b))


def test_pack_matches_reference_on_edge_rows():
    """Every pair of edge positions (the int32 ends, the leaf-bin edges at
    15,625, ``MAX_QUERY_POS``) as (pos, end) in both orders, and ``a ^ b``
    at each power of two and negative."""
    cols = export_edge_columns()
    assert MAX_QUERY_POS in cols[0].tolist()
    x = (cols[0].astype(np.int64) - 1) // 15625 ^ (cols[1].astype(np.int64) - 1) // 15625
    assert (x < 0).any() and {1 << k for k in range(17)} <= set(x.tolist())
    check_pack(cols)


@pytest.mark.parametrize("nb,b", [(1, 16), (2, 16), (37, 64), (2, 37)])
def test_stacked_pack_matches_reference_batch_by_batch(nb, b):
    """A stack of ``nb`` batches with mixed ``n_valid`` through the plain
    version and the wrapper's CPU path (one call each), against the
    jitted kernel batch by batch."""
    batches = [export_random_columns(1000 * nb + k, b) if k % 2 else
               export_store_columns(1000 * nb + k, b) for k in range(nb)]
    counts = export_stack_counts(nb, b)[nb % 8]
    stacked = torch.from_numpy(np.stack([np.stack(c) for c in batches]))
    wants = [[np.asarray(a) for a in export_pack_kernel_jit(*cols, np.int32(n))]
             for cols, n in zip(batches, counts)]
    before = dict(pack_ops.CALLS)
    outs = pack_ops.export_pack_reference(*stacked.unbind(1), counts)
    for k, want in enumerate(wants):
        assert_outputs_equal([o[k].numpy() for o in outs], want)
    buf = pack_ops.export_pack(stacked, np.asarray(counts, np.int64))
    assert buf.dtype == torch.uint8 and buf.shape == (nb * 30 * b,)
    size = 30 * b
    for k, want in enumerate(wants):
        assert_outputs_equal(pack_ops.unpack(buf.numpy()[k * size:(k + 1) * size], b), want)
    chunks = [{"n_valid": n, **dict(zip(pack_ops.COLUMNS, cols))}
              for cols, n in zip(batches, counts)]
    for got, want in zip(pack_ops.pack_part(chunks, torch.device("cpu")), wants):
        assert_outputs_equal(got, want)
    assert pack_ops.CALLS["cpu"] == before["cpu"] + 3


def test_stacked_pack_refuses_bad_counts():
    good = torch.from_numpy(np.stack([np.stack(export_random_columns(k, 16))
                                      for k in range(3)]))
    before = dict(pack_ops.LAUNCHES)
    with pytest.raises(ValueError, match="n_valid"):
        pack_ops.export_pack(good, [4, 5])
    with pytest.raises(ValueError, match="n_valid"):
        pack_ops.export_pack(good, 4)
    with pytest.raises(ValueError, match="n_valid"):
        pack_ops.export_pack(good[0], [4])
    with pytest.raises(TypeError, match="n_valid"):
        pack_ops.export_pack(good, [1.5, 2, 3])
    with pytest.raises(TypeError, match="int32"):
        pack_ops.export_pack(good.to(torch.int64), [1, 2, 3])
    with pytest.raises(ValueError, match="contiguous"):
        pack_ops.export_pack(good.transpose(0, 1), [1] * 7)
    assert pack_ops.LAUNCHES == before


def test_pack_wrapper_refuses_bad_inputs():
    good = np.stack(export_random_columns(1, 16))
    before = dict(pack_ops.LAUNCHES)
    with pytest.raises(TypeError, match="int32"):
        pack_ops.export_pack(torch.from_numpy(good.astype(np.int64)), 4)
    with pytest.raises(ValueError, match="contiguous"):
        pack_ops.export_pack(torch.from_numpy(good).t(), 4)
    with pytest.raises(ValueError, match="contiguous"):
        pack_ops.export_pack(torch.from_numpy(good[:6]), 4)
    with pytest.raises(TypeError, match="n_valid"):
        pack_ops.export_pack(torch.from_numpy(good), torch.tensor(4))
    meta = torch.empty((7, 16), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        pack_ops.export_pack(meta, 4)
    assert pack_ops.LAUNCHES == before


def test_emission_order_matches_reference():
    for n, seed in ((0, 1), (1, 3), (7, 3), (8, 0), (29, 5), (300, 11)):
        order = emission_order(n, seed)
        assert order == ref_emission_order(n, seed)
        assert sorted(order) == list(range(n))


# ------------------------------------------------------------ the corpus

WIDTH = 8
CHROMS = (1, 8)
BASES = ("A", "C", "G", "T")
SEED = 3
BATCH_ROWS = 16
PART_BYTES = "2k"  # 16-row batches -> 2 batches a part
LONG = ("ACGTACGTACGTA", "TTGACCATGGA")  # past the store width


def _rows_for(code, base_pos, n, salt):
    rows = []
    for i in range(n):
        k = (i + salt) % 4
        ref, alt = BASES[k], BASES[(k + 1) % 4]
        if i % 7 == 3:
            ref, alt = ref + "GT", alt  # a deletion
        if i % 11 == 5:
            ref, alt = ref, alt + "CA"  # an insertion
        if i == 17:
            ref, alt = LONG[salt % 2], alt  # over-width
        rows.append({
            "pos": base_pos + 977 * i, "ref": ref, "alt": alt,
            "cadd": round(0.5 * i + code, 2) if i % 3 == 0 else None,
            "rank": (i % 30) + 1 if i % 4 == 0 else None,
            "af": round((i % 50) / 50.0, 4) if i % 2 == 0 else None,
        })
    return rows


def _segment(rows):
    refs = [r["ref"] for r in rows]
    alts = [r["alt"] for r in rows]
    ref, ref_len = encode_allele_array(refs, WIDTH)
    alt, alt_len = encode_allele_array(alts, WIDTH)
    h = identity_hashes(WIDTH, ref, alt, ref_len, alt_len, refs, alts)
    over = (ref_len > WIDTH) | (alt_len > WIDTH)
    return Segment.build(
        {"pos": np.asarray([r["pos"] for r in rows], np.int32), "h": h,
         "ref_len": ref_len, "alt_len": alt_len},
        ref, alt,
        annotations={
            "cadd_scores": [{"CADD_phred": r["cadd"]} if r["cadd"] is not None
                            else None for r in rows],
            "adsp_most_severe_consequence": [
                {"conseq": "missense_variant", "rank": r["rank"]}
                if r["rank"] is not None else None for r in rows],
            "allele_frequencies": [{"GnomAD": {"af": r["af"]}}
                                   if r["af"] is not None else None
                                   for r in rows],
        },
        long_alleles=[(r["ref"], r["alt"]) if over[i] else None
                      for i, r in enumerate(rows)] if over.any() else None,
    )


@pytest.fixture(scope="module")
def base_store(tmp_path_factory):
    """The store directory (see the module docstring)."""
    store_dir = str(tmp_path_factory.mktemp("export_store"))
    store = VariantStore(width=WIDTH)
    for code in CHROMS:
        shard = store.shard(code)
        runs = []
        for run, base in enumerate((500, 120_000, 2_000_000)):
            rows = _rows_for(code, base, 40, salt=run + code)
            runs.append(rows)
            shard.append_segment(_segment(rows))
        # a newer segment repeating six identities of the first run with
        # other annotations: the older rows win
        shadow = [dict(r, cadd=99.0, af=None) for r in runs[0][:6]]
        shard.append_segment(_segment(shadow))
    store.save(store_dir)
    return store_dir


@pytest.fixture()
def store_dir(base_store, tmp_path):
    """A private copy of the store: each test's ledger records stay its own."""
    path = str(tmp_path / "vdb")
    shutil.copytree(base_store, path)
    return path


def _corpus_bytes(out_dir):
    out = {}
    for name in sorted(os.listdir(out_dir)):
        if name.endswith(".npz") or name == "corpus.manifest.json":
            with open(os.path.join(out_dir, name), "rb") as f:
                out[name] = f.read()
    return out


def _ref_export(store_dir, out_dir, **kw):
    store, ledger = StoreConfig(store_dir).open(create=False, readonly=True)
    kw = {"seed": SEED, "batch_rows": BATCH_ROWS, "part_bytes": PART_BYTES, **kw}
    return ref_run_export(store, ledger, store_dir, out_dir, **kw)


def _port_export(store_dir, out_dir, **kw):
    store = VariantStore.load(store_dir, readonly=True)
    ledger = AlgorithmLedger(os.path.join(store_dir, "ledger.jsonl"))
    kw = {"seed": SEED, "batch_rows": BATCH_ROWS, "part_bytes": PART_BYTES,
          "device": "cpu", **kw}
    return core.run_export(store, ledger, store_dir, out_dir, **kw)


#: summary keys that hold timings or this run's paths
TIMING_KEYS = ("seconds", "tokens_per_sec", "device_idle_frac", "queue_stalls")


def _strip(summary):
    out = {k: v for k, v in summary.items() if k not in TIMING_KEYS + ("out",)}
    if "parts" in out:
        out["parts"] = [{k: v for k, v in p.items() if k != "out"}
                        for p in out["parts"]]
    return out


def _export_records(store_dir, out_dir):
    with open(os.path.join(store_dir, "ledger.jsonl")) as f:
        recs = [json.loads(line) for line in f if line.strip()]
    out_dir = os.path.abspath(out_dir)
    return [{k: v for k, v in r.items() if k not in ("ts", "out")}
            for r in recs if r.get("type") == "export" and r.get("out") == out_dir]


CASES = {
    "shuffled": {},
    "ordered": {"ordered": True},
    "region": {"region": "chr8:100000-2020000"},
    "chromosome": {"chromosome": "1"},
}


@pytest.mark.parametrize("case", list(CASES))
def test_corpus_matches_reference(store_dir, tmp_path, case):
    kw = CASES[case]
    ref_out, port_out = str(tmp_path / "ref"), str(tmp_path / "port")
    before = dict(pack_ops.CALLS)
    want = _ref_export(store_dir, ref_out, **kw)
    got = _port_export(store_dir, port_out, **kw)
    corpus = _corpus_bytes(ref_out)
    assert len(corpus) == want["n_parts"] + 1 >= 3
    assert _corpus_bytes(port_out) == corpus
    assert sorted(got) == sorted(want)
    assert _strip(got) == _strip(want)
    assert got["complete"] and got["rows"] == want["total_rows"] > 0
    assert _export_records(store_dir, port_out) == _export_records(store_dir, ref_out)
    assert len(_export_records(store_dir, port_out)) == want["n_parts"]
    # one plain-version call a part, on the CPU
    assert pack_ops.CALLS["cpu"] == before["cpu"] + want["n_parts"]


@pytest.mark.parametrize("case", ["trailing-short-part", "max-parts-then-resume"])
def test_part_staging_matches_reference(store_dir, tmp_path, case):
    """Parts pack their staged batches at commit: a plan whose last part is
    short (three batches a part), and an export cut after two parts by
    ``max_parts`` then resumed, each byte-equal to the reference's
    uninterrupted ``run_export``, one plain-version call a part written."""
    ref_out, port_out = str(tmp_path / "ref"), str(tmp_path / "port")
    kw = {"part_bytes": "3k"} if case == "trailing-short-part" else {}
    want = _ref_export(store_dir, ref_out, **kw)
    before = pack_ops.CALLS["cpu"]
    if case == "trailing-short-part":
        assert want["batches_per_part"] == 3 and want["n_batches"] % 3 != 0
        got = _port_export(store_dir, port_out, **kw)
        assert got["parts_written"] == want["n_parts"]
    else:
        first = _port_export(store_dir, port_out, max_parts=2)
        assert first["parts_written"] == 2 and not first["complete"]
        got = _port_export(store_dir, port_out, resume=True)
        assert got["resumed_parts"] == 2
        assert got["parts_written"] == want["n_parts"] - 2
    assert pack_ops.CALLS["cpu"] - before == want["n_parts"]
    assert got["complete"]
    assert _corpus_bytes(port_out) == _corpus_bytes(ref_out)


def test_corpus_decodes_to_the_store(store_dir, tmp_path):
    """Every valid lane of the port's corpus decodes to a store row once:
    alleles through the manifest's dictionary, the shadowed copies absent,
    the over-width alleles whole, and the padded lanes -1."""
    out = str(tmp_path / "port")
    summary = _port_export(store_dir, out)
    manifest = read_manifest(out)
    seen = []
    for part in manifest["parts"]:
        arrays = read_part(os.path.join(out, part["file"]))
        for b in range(arrays["n_valid"].shape[0]):
            n = int(arrays["n_valid"][b])
            label = {c["code"]: c["label"] for c in manifest["chromosomes"]}[
                int(arrays["chrom_code"][b])]
            alleles = manifest["alleles"][label]
            assert arrays["mask"][b].sum() == n
            assert (arrays["pos"][b][n:] == -1).all()
            assert (arrays["bin_level"][b][n:] == -1).all()
            assert set(arrays["bin_index"][b][n:].tolist()) <= {""}
            for i in range(n):
                seen.append((label, int(arrays["pos"][b][i]),
                             alleles[int(arrays["ref_code"][b][i])],
                             alleles[int(arrays["alt_code"][b][i])],
                             int(arrays["cadd_fp"][b][i])))
    want = {(label, r["pos"], r["ref"], r["alt"])
            for code, label in zip(CHROMS, ("1", "8"))
            for run, base in enumerate((500, 120_000, 2_000_000))
            for r in _rows_for(code, base, 40, salt=run + code)}
    assert len(seen) == summary["rows"] == len(want) == 2 * 3 * 40
    assert {s[:4] for s in seen} == want
    assert {s[2] for s in seen} >= set(LONG)
    shadow_cadd = feature_values({"CADD_phred": 99.0}, None, None)[3]
    assert shadow_cadd != -1 and shadow_cadd not in {s[4] for s in seen}


def test_host_only_matches_the_device_path(store_dir, tmp_path):
    ref_out, port_out = str(tmp_path / "ref"), str(tmp_path / "port")
    before = dict(pack_ops.CALLS)
    _ref_export(store_dir, ref_out)
    got = _port_export(store_dir, port_out, host_only=True, device=None)
    assert pack_ops.CALLS == before  # the numpy twin only
    assert got["complete"]
    assert _corpus_bytes(port_out) == _corpus_bytes(ref_out)


def test_dry_run_writes_nothing_and_reports_the_reference_plan(store_dir,
                                                               tmp_path):
    out = str(tmp_path / "corpus")
    want = _ref_export(store_dir, out, commit=False)
    got = _port_export(store_dir, out, commit=False)
    assert not os.path.exists(out)
    assert got.pop("seconds") >= 0 and want.pop("seconds") >= 0
    assert got == want and got["committed"] is False
    assert not os.path.exists(os.path.join(store_dir, "ledger.jsonl"))


def _cli(store_dir, out_dir, *flags):
    return ["--storeDir", store_dir, "--out", out_dir, "--seed", str(SEED),
            "--batchRows", str(BATCH_ROWS), "--partBytes", PART_BYTES, *flags]


def test_cli_dry_run_prints_the_plan(store_dir, tmp_path, capsys):
    out = str(tmp_path / "corpus")
    assert port_main(_cli(store_dir, out, "--platform", "cpu")) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    want = _ref_export(store_dir, out, commit=False)
    assert summary.pop("seconds") >= 0 and want.pop("seconds") >= 0
    assert summary == want and not os.path.exists(out)


def test_resume_after_the_reference_was_killed(store_dir, tmp_path, capsys):
    """The reference's CLI, armed at its own ``export.commit`` fault point,
    dies by SIGKILL mid-commit; the port's CLI resumes the same directory
    and the corpus equals an uninterrupted reference export."""
    ref_out, out = str(tmp_path / "ref"), str(tmp_path / "out")
    _ref_export(store_dir, ref_out)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               AVDB_FAULT="export.commit:3:kill")
    proc = subprocess.run(
        [sys.executable, "-m", "annotatedvdb_tpu", "export",
         *_cli(store_dir, out, "--commit")],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=480)
    assert proc.returncode == -signal.SIGKILL, proc.stderr[-2000:]
    names = os.listdir(out)
    assert any(".export.tmp" in n for n in names)
    assert "corpus.manifest.json" not in names
    assert port_main(_cli(store_dir, out, "--commit", "--resume",
                          "--platform", "cpu")) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["complete"] and summary["resumed_parts"] == 2
    assert not any(".export.tmp" in n for n in os.listdir(out))
    assert _corpus_bytes(out) == _corpus_bytes(ref_out)


def test_cli_test_then_resume(store_dir, tmp_path, capsys):
    ref_out, out = str(tmp_path / "ref"), str(tmp_path / "out")
    _ref_export(store_dir, ref_out)
    assert port_main(_cli(store_dir, out, "--commit", "--test",
                          "--platform", "cpu")) == 0
    first = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert first["parts_written"] == 1 and not first["complete"]
    assert read_manifest(out)["complete"] is False
    assert port_main(_cli(store_dir, out, "--commit", "--resume",
                          "--platform", "cpu")) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["complete"] and summary["resumed_parts"] == 1
    assert _corpus_bytes(out) == _corpus_bytes(ref_out)


def _resume_errors(store_dir, out):
    msgs = []
    for run in (_ref_export, _port_export):
        with pytest.raises(ValueError) as exc:
            run(store_dir, out, resume=True)
        msgs.append(str(exc.value))
    return msgs


def test_resume_refuses_a_gap_in_the_ledger(store_dir, tmp_path):
    out = str(tmp_path / "out")
    summary = _port_export(store_dir, out)
    ledger = AlgorithmLedger(os.path.join(store_dir, "ledger.jsonl"))
    ledger.export({"out": summary["out"], "plan_sig": summary["plan_sig"],
                   "part": summary["n_parts"] + 1, "file": "x", "sha256": "0",
                   "bytes": 0, "batches": 1, "rows": 1})
    ref_msg, port_msg = _resume_errors(store_dir, out)
    assert port_msg == ref_msg and "not a contiguous part prefix" in ref_msg


def test_resume_refuses_a_missing_part(store_dir, tmp_path):
    out = str(tmp_path / "out")
    _port_export(store_dir, out)
    os.unlink(os.path.join(out, "part-000001.npz"))
    ref_msg, port_msg = _resume_errors(store_dir, out)
    assert port_msg == ref_msg and "records part 1" in ref_msg


def test_cli_refuses_chromosome_with_region(store_dir, tmp_path, capsys):
    errs = []
    for main in (ref_main, port_main):
        with pytest.raises(SystemExit) as exc:
            main(_cli(store_dir, str(tmp_path / "o"), "--chromosome", "1",
                      "--region", "1:1-5"))
        assert exc.value.code == 2
        errs.append(capsys.readouterr().err.strip().splitlines()[-1])
    assert errs[0] == errs[1]
    assert errs[0].endswith("error: --chromosome and --region are mutually exclusive")


@pytest.mark.parametrize("region", ["chr1:5-1", "1:x-9", "Q:1-5", "chr8:0-10"])
def test_cli_refuses_a_bad_region(store_dir, tmp_path, region):
    msgs = []
    for main, flags in ((ref_main, ("--platform", "cpu")),
                        (port_main, ("--platform", "cpu"))):
        with pytest.raises(ValueError) as exc:
            main(_cli(store_dir, str(tmp_path / "o"), "--region", region,
                      "--commit", *flags))
        msgs.append(str(exc.value))
    assert msgs[0] == msgs[1] and msgs[0].startswith("bad --region")
    assert not os.path.exists(str(tmp_path / "o"))


@pytest.mark.parametrize("flags,pattern", [
    (["--profile", "p"], "--profile"), (["--metricsOut", "m"], "--metricsOut"),
    (["--traceOut", "t"], "--traceOut"),
], ids=["profile", "metricsOut", "traceOut"])
def test_cli_refuses_unported_flags(store_dir, tmp_path, capsys, flags, pattern):
    with pytest.raises(SystemExit) as exc:
        port_main(_cli(store_dir, str(tmp_path / "o"), *flags))
    assert exc.value.code == 2
    assert pattern in capsys.readouterr().err


def test_cli_defaults_to_cuda(store_dir, tmp_path):
    """Without a card the CLI refuses to start unless it is asked for the
    CPU or for the host-only pack; it never carries on on the host."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_main(_cli(store_dir, str(tmp_path / "o"), "--commit"))
    assert not os.path.exists(str(tmp_path / "o"))
    assert port_main(_cli(store_dir, str(tmp_path / "o"), "--commit",
                          "--hostOnly")) == 0
