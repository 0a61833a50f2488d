"""The CADD score join (``load-cadd``), end to end: the PyTorch port
against the JAX package.

- The join's plain version (``ops/cadd_join.cadd_join_reference``, the CPU
  path of the ``cadd_join`` wrapper) against the reference's jitted
  ``cadd_join_kernel`` (CPU) and its numpy twin ``cadd_join_host``, on the
  seeded edge blocks of ``chip_smoke.cadd_edge_cases`` at W = 16, 31, 32,
  33, 49, 64, 65 and 96, on seeded random blocks of both table shapes and on
  hypothesis-drawn sorted blocks at probe depths 4 and 32.
- The table reader (``io/cadd.CaddFileReader``) of both engines against
  the reference's, block by block and field by field, with a small block
  capacity that forces trailing-run peels; the native tokenizer's source
  pinned to the reference's; BGZF round trips and seeks, and the
  block-offset index (``CaddIndex``), against the reference's.
- The updater (``loaders/cadd_loader.CaddUpdater``, on the CPU) and the
  ``load-cadd`` CLI against the reference's ``TpuCaddUpdater`` and CLI on
  copies of one reference-built store, under both CADD engines: the whole
  store, ``--chr``, ``--fileName`` sequential and through the index,
  ``--updateExisting``, ``--test``, a dry run, the long-allele host
  replay and the ``max_run > probe`` refusal.  Store bytes, counters,
  quarantine files and ledger records compare exactly.
"""

import gzip
import json
import os
import re
import shutil

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import annotatedvdb_tpu.loaders.cadd_loader as ref_cadd_loader
from annotatedvdb_tpu.io import bgzf as ref_bgzf
from annotatedvdb_tpu.io.cadd import CaddFileReader as RefReader
from annotatedvdb_tpu.io.cadd import CaddIndex as RefIndex
from annotatedvdb_tpu.io.cadd import open_random as ref_open_random
from annotatedvdb_tpu.loaders.cadd_loader import TpuCaddUpdater
from annotatedvdb_tpu.ops.cadd_join import cadd_join_host, cadd_join_kernel
from annotatedvdb_tpu.store import AlgorithmLedger, VariantStore
from annotatedvdb_tpu.utils.quarantine import QuarantineSink as RefSink

import annotatedvdb_tpu_torch.loaders.cadd_loader as port_cadd_loader
from annotatedvdb_tpu_torch.io import bgzf
from annotatedvdb_tpu_torch.io.cadd import CaddFileReader, CaddIndex, open_random
from annotatedvdb_tpu_torch.loaders.cadd_loader import CaddUpdater
from annotatedvdb_tpu_torch.native import cadd as native_cadd
from annotatedvdb_tpu_torch.ops import cadd_join as port_join
from annotatedvdb_tpu_torch.store import AlgorithmLedger as TorchLedger
from annotatedvdb_tpu_torch.store import VariantStore as TorchStore
from annotatedvdb_tpu_torch.utils.quarantine import QuarantineSink
from chip_smoke import cadd_edge_cases, cadd_random_block
from test_cadd import INDEL_TSV, SNV_TSV, VCF
from test_cadd_random_access import make_snv_table
from test_torch_load_vcf import _ledger_records, _persisted_bytes
from test_torch_qc_update import base_sites, build_base

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENGINES = ("native", "python")
LEDGER_TYPES = ("invocation", "checkpoint", "finish")


# ------------------------------------------------------------------ join


def _port_join(args, probe):
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in args]
    m, idx = port_join.cadd_join(*t, probe=probe)
    assert m.dtype == torch.bool and idx.dtype == torch.int32
    return m.numpy(), idx.numpy()


def _assert_join_matches(args, probe):
    m, idx = _port_join(args, probe)
    hm, hidx = cadd_join_host(*args, probe=probe)
    np.testing.assert_array_equal(m, hm)
    np.testing.assert_array_equal(idx, hidx)
    if args[0].shape[0]:
        km, kidx = cadd_join_kernel(*args, probe=probe)
        np.testing.assert_array_equal(m, np.asarray(km))
        np.testing.assert_array_equal(idx, np.asarray(kidx))
    return m, idx


@pytest.mark.parametrize("width", [16, 31, 32, 33, 49, 64, 65, 96])
def test_join_edge_blocks_match_reference(width):
    results = {}
    for label, args, probe in cadd_edge_cases(width):
        m, idx = _assert_join_matches(args, probe)
        results[label] = m, idx
        kind = label.rsplit("-", 1)[-1]
        k_rows = args[3].shape[0]
        if kind == "n0":
            assert m.shape == (0,)
        elif kind == "k1":
            assert m.tolist() == [True, True, False, False, False]
        elif kind == "unsorted":
            sm, sidx = results[label.replace("unsorted", "sentinels")]
            np.testing.assert_array_equal(m, sm[::-1])
            np.testing.assert_array_equal(idx, sidx[::-1])
        elif kind == "tail":
            # the run of `probe` rows ends at row K - 1, the deep match
            assert idx.tolist() == [k_rows - 1, k_rows - 1, 2, -1, -1, -1, 1]
        elif kind == "cross":
            # run rows 30-69: offsets 0, 2, 31, 32 and 39 match within the
            # probe window only
            offsets = [0, 2, 31, 32, 39]
            want = [30 + o if o < probe else -1 for o in offsets] + [-1, 70, 15, -1]
            assert idx.tolist() == want
        elif kind.startswith("k"):
            # runs of two: the first row, the last row (K - 1), a swapped
            # middle row; wrong alleles and positions before and after
            assert k_rows == int(kind[1:])
            assert idx.tolist() == [0, k_rows - 1, k_rows // 2, -1, -1, -1]
        else:
            # the deep match sits at probe offset probe - 1; the first of
            # two matching rows wins; the swapped orientation matches
            deep = 3 + probe - 1
            assert idx[3] == deep and idx[4] == deep and not m[5]
            assert idx[6] == idx[7] == deep + 1
            assert m[8] and m[9] and not m[10] and m[11] and m[12] and not m[13]
            assert not m[14:].any()
        np.testing.assert_array_equal(m, idx >= 0)


@pytest.mark.parametrize("shape", ["snv", "indel"])
@pytest.mark.parametrize("seed", [1, 2])
def test_join_random_blocks_match_reference(shape, seed):
    snv = shape == "snv"
    probe = port_join.SNV_PROBE if snv else port_join.INDEL_PROBE
    args = cadd_random_block(seed, 3000, 20_000, 49, probe, snv)
    m, _idx = _assert_join_matches(args, probe)
    assert 0.4 < m.mean() < 0.95


@st.composite
def _sorted_block(draw):
    width = draw(st.integers(1, 6))
    alleles = st.text(alphabet="AC", min_size=1, max_size=min(width, 3))
    k = draw(st.integers(1, 40))
    spos = sorted(draw(st.lists(st.integers(1, 12), min_size=k, max_size=k)))
    rows = [(p, draw(alleles), draw(alleles)) for p in spos]
    n = draw(st.integers(0, 30))
    variants = [(draw(st.integers(0, 14)), draw(alleles), draw(alleles))
                for _ in range(n)]
    pad = draw(st.integers(0, 3))
    rows += [(2**31 - 1, "", "")] * pad
    variants += [(2**31 - 1, "A", "C")] * draw(st.integers(0, 1))

    def enc(xs):
        out = np.zeros((len(xs), width), np.uint8)
        for i, x in enumerate(xs):
            out[i, :len(x)] = np.frombuffer(x.encode(), np.uint8)
        return out

    return (np.array([p for p, _, _ in variants], np.int32).reshape(-1),
            enc([r for _, r, _ in variants]), enc([a for _, _, a in variants]),
            np.array([p for p, _, _ in rows], np.int32),
            enc([r for _, r, _ in rows]), enc([a for _, _, a in rows]))


@settings(max_examples=60, deadline=None)
@given(block=_sorted_block(), probe=st.sampled_from([4, 32]))
def test_join_hypothesis_blocks_match_reference(block, probe):
    _assert_join_matches(block, probe)


def test_join_counts_plain_calls_by_device():
    args = cadd_edge_cases(16)[0][1]
    before = dict(port_join.CALLS)
    launches = dict(port_join.LAUNCHES)
    _port_join(args, 4)
    assert port_join.CALLS["cpu"] == before["cpu"] + 1
    assert port_join.CALLS["cuda"] == before["cuda"]
    assert port_join.LAUNCHES == launches


def test_join_wrapper_refuses_other_devices():
    """A non-CPU tensor never takes the plain version: the wrapper launches
    or raises (here: the meta device, which no kernel serves)."""
    before = dict(port_join.CALLS), dict(port_join.LAUNCHES)
    p = torch.empty((4,), dtype=torch.int32, device="meta")
    a = torch.empty((4, 8), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        port_join.cadd_join(p, a, a, p, a, a)
    assert (dict(port_join.CALLS), dict(port_join.LAUNCHES)) == before


# ------------------------------------------------------------------ reader


def _parity_table(path):
    """The shape of ``test_cadd.test_native_cadd_blocks_parity``'s table,
    larger: runs of 3 across capacity boundaries, malformed rows, long
    alleles at host positions, several chromosomes, a lone run that fills a
    whole block."""
    with gzip.open(path, "wt") as f:
        f.write("## CADD v1.6\n#Chrom\tPos\tRef\tAlt\tRawScore\tPHRED\n")
        for p in range(100, 160):
            for a in "CGT":
                f.write(f"1\t{p}\tA\t{a}\t{p / 7:.4f}\t{p % 13}.5\n")
        f.write("1\tnotanum\tA\tC\t0.1\t1\n")
        f.write("1\t200\n")
        f.write("GL000\t300\tA\tC\t0.1\t1\n")
        f.write("1\t201\tA\tC\tx\t1\n")
        f.write("1\t0\tA\tC\t0.1\t1\n")
        f.write("1\t202\t\tC\t0.1\t1\n")
        for k in range(70):  # one position whose run fills a block
            f.write(f"1\t300\tA\t{'C' * (k + 1)}\t{k}.25\t{k}\n")
        f.write(f"2\t500\t{'A' * 40}\tG\t0.9\t9\n")
        f.write("2\t500\tA\tG\t0.8\t8\n")
        f.write(f"2\t501\tT\t{'G' * 30}\t0.7\t7\n")
        for p in range(600, 640):
            f.write(f"2\t{p}\tC\tCA\t{p}e-3\t{p % 7}\n")
        f.write("chrX\t700\tT\tC\t1e-3\t2.5\n")
        f.write("MT\t263\tA\tG\t1.1\t11.0\n")


def _blocks(reader):
    out = []
    for code, block in reader.blocks_all():
        n = block.n
        out.append((
            code, n, block.pos.tolist(), block.ref.tolist(), block.alt.tolist(),
            block.raw.tolist(), block.phred.tolist(), block.max_run,
            {k: v for k, v in block.host_rows.items()},
            block.min_pos, block.max_pos,
        ))
    return out


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("block_rows", [8, 64, 1 << 18])
def test_reader_blocks_match_reference(tmp_path, monkeypatch, engine, block_rows):
    path = str(tmp_path / "t.tsv.gz")
    _parity_table(path)
    monkeypatch.setenv("AVDB_NATIVE_CADD", "0" if engine == "python" else "1")
    rejects = {"ref": [], "port": []}
    want = _blocks(RefReader(path, width=16, block_rows=block_rows,
                             on_reject=lambda *a: rejects["ref"].append(a)))
    got = _blocks(CaddFileReader(path, width=16, block_rows=block_rows,
                                 on_reject=lambda *a: rejects["port"].append(a)))
    assert got == want
    assert rejects["port"] == rejects["ref"]
    assert len(rejects["port"]) == (5 if engine == "python" else 0)
    if block_rows == 8:
        assert len(got) > 20
    # the two engines cut identical blocks
    monkeypatch.setenv("AVDB_NATIVE_CADD", "1" if engine == "python" else "0")
    assert _blocks(CaddFileReader(path, width=16, block_rows=block_rows)) == want


def test_reader_engine_selection(tmp_path, monkeypatch):
    """The Python scanner runs only under AVDB_NATIVE_CADD=0 or
    engine="python"; a failed native build raises instead of falling
    back."""
    path = str(tmp_path / "t.tsv.gz")
    _parity_table(path)
    calls = []
    scan = native_cadd.scan
    monkeypatch.setattr(native_cadd, "scan",
                        lambda *a, **k: calls.append(a) or scan(*a, **k))
    monkeypatch.delenv("AVDB_NATIVE_CADD", raising=False)
    list(CaddFileReader(path, width=16).blocks_all())
    assert len(calls) == 1
    list(CaddFileReader(path, width=16, engine="python").blocks_all())
    monkeypatch.setenv("AVDB_NATIVE_CADD", "0")
    list(CaddFileReader(path, width=16).blocks_all())
    assert len(calls) == 1
    monkeypatch.delenv("AVDB_NATIVE_CADD")

    def broken(*a, **k):
        raise RuntimeError("native CADD tokenizer build failed: no g++")

    monkeypatch.setattr(native_cadd.native, "build_shared_lib", broken)
    monkeypatch.setattr(native_cadd, "_lib", None)
    monkeypatch.setattr(native_cadd, "scan", scan)
    with pytest.raises(RuntimeError, match="build failed"):
        list(CaddFileReader(path, width=16).blocks_all())


def test_tokenizer_source_is_the_reference_but_for_comments():
    def code(path):
        with open(path) as f:
            return [re.sub(r"\s*//.*$", "", line) for line in f]

    ref = code(os.path.join(ROOT, "native", "avdb_cadd.cpp"))
    assert code(native_cadd.SOURCE) == ref and len(ref) > 150


# ------------------------------------------------------------------ BGZF


def test_bgzf_roundtrip_and_seek_match_reference(tmp_path):
    text, _ = make_snv_table(4000)
    paths = {}
    for tag, mod in (("ref", ref_bgzf), ("port", bgzf)):
        paths[tag] = str(tmp_path / f"{tag}.bgz")
        with mod.BgzfWriter(paths[tag]) as w:
            w.write(text.encode())
    with open(paths["ref"], "rb") as a, open(paths["port"], "rb") as b:
        assert a.read() == b.read()
    assert bgzf.is_bgzf(paths["port"])
    # incompressible data exercises the writer's split path
    noise = np.random.default_rng(5).integers(0, 256, 300_000, np.uint8).tobytes()
    for tag, mod in (("ref", ref_bgzf), ("port", bgzf)):
        with mod.BgzfWriter(str(tmp_path / f"{tag}.noise")) as w:
            w.write(noise)
    assert (tmp_path / "ref.noise").read_bytes() == (tmp_path / "port.noise").read_bytes()
    with bgzf.BgzfReader(paths["port"]) as r, ref_bgzf.BgzfReader(paths["ref"]) as q:
        r.seek(0)
        q.seek(0)
        marks = []
        for k in range(2000):
            if k % 97 == 0:
                marks.append(r.tell())
                assert r.tell() == q.tell()
            line = r.readline()
            assert line == q.readline()
        for voff in reversed(marks):
            r.seek(voff)
            q.seek(voff)
            assert r.readline() == q.readline()
        assert r.bytes_read == q.bytes_read
    plain = tmp_path / "plain.tsv.gz"
    with gzip.open(plain, "wt") as f:
        f.write(text)
    assert not bgzf.is_bgzf(str(plain))
    with pytest.raises(ValueError, match="not seekable"):
        open_random(str(plain))
    out = bgzf.compress_to_bgzf(str(plain), str(tmp_path / "re.bgz"))
    ref_out = ref_bgzf.compress_to_bgzf(str(plain), str(tmp_path / "re_ref.bgz"))
    assert open(out, "rb").read() == open(ref_out, "rb").read()


def test_index_build_and_fetch_match_reference(tmp_path):
    text, rows = make_snv_table(20000)
    for tag, mod in (("ref", ref_bgzf), ("port", bgzf)):
        with mod.BgzfWriter(str(tmp_path / f"{tag}.bgz")) as w:
            w.write(text.encode())
    ref_ix = RefIndex.build(str(tmp_path / "ref.bgz"), stride=256)
    ix = CaddIndex.build(str(tmp_path / "port.bgz"), stride=256)
    for name in ("chrom", "pos", "voffset"):
        np.testing.assert_array_equal(getattr(ix, name), getattr(ref_ix, name))
    with np.load(str(tmp_path / "ref.bgz") + ".avdx.npz") as a, \
            np.load(str(tmp_path / "port.bgz") + ".avdx.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])
    assert CaddIndex.load(str(tmp_path / "port.bgz")) is not None
    keys = list(rows)[::53] + [("1", 49, "A", "C"), ("2", 10**6, "A", "C")]
    with open_random(str(tmp_path / "port.bgz")) as r, \
            ref_open_random(str(tmp_path / "ref.bgz")) as q:
        for chrom, pos, _ref, _alt in keys:
            assert ix.fetch(r, int(chrom), pos) == ref_ix.fetch(q, int(chrom), pos)
        assert r.bytes_read == q.bytes_read
    # a re-written table makes the index stale
    with bgzf.BgzfWriter(str(tmp_path / "port.bgz")) as w:
        w.write(text.encode() + b"2\t99999999\tA\tC\t0.1\t1.0\n")
    assert CaddIndex.load(str(tmp_path / "port.bgz")) is None
    unsorted = tmp_path / "unsorted.tsv"
    unsorted.write_text("1\t200\tA\tC\t1\t1\n1\t100\tA\tC\t1\t1\n")
    with pytest.raises(ValueError, match="not sorted"):
        CaddIndex.build(str(unsorted))


@pytest.mark.parametrize("stride", [7, 256, 4096])
@pytest.mark.parametrize("fmt", ["bgzf", "plain"])
def test_sorted_fetch_matches_reference_fetches(tmp_path, stride, fmt):
    """The resuming scan gives each position the rows of the reference's
    own fetch, and inflates the same BGZF blocks: ascending positions with
    repeats, gaps, a descent, and positions before the first and past the
    last row of each chromosome."""
    text, rows = make_snv_table(8000)
    path = str(tmp_path / ("t.bgz" if fmt == "bgzf" else "t.tsv"))
    if fmt == "bgzf":
        with bgzf.BgzfWriter(path) as w:
            w.write(text.encode())
    else:
        with open(path, "w") as f:
            f.write(text)
    ref_ix = RefIndex.build(path, stride=stride)
    ix = CaddIndex.load(path)
    rng = np.random.default_rng(stride)
    by_chrom = {}
    for chrom, pos, _ref, _alt in rows:
        by_chrom.setdefault(int(chrom), []).append(pos)
    with open_random(path) as r, ref_open_random(path) as q:
        for code, positions in sorted(by_chrom.items()):
            picked = sorted(rng.choice(positions, 60).tolist())
            picked += [picked[-1]] + [p + 1 for p in picked[-3:]]
            wanted = [1, *picked, 10**8, 10**8 + 5, picked[0], picked[1]]
            got = list(ix.fetch_sorted(r, code, wanted))
            assert got == [ref_ix.fetch(q, code, p) for p in wanted]
            assert sum(map(len, got)) > len(picked)
        if fmt == "bgzf":  # blocks are cached: the same blocks inflated
            assert r.bytes_read == q.bytes_read
        else:  # lines: the resumed scans skip what was read already
            assert 0 < r.bytes_read < q.bytes_read


# ------------------------------------------------------------------ updater

WIDTH = 49


def _sites(sites):
    """``write_cadd_tables``'s sites from ``base_sites`` tuples."""
    return [(c, p, r, [a for a in alts if a != "."]) for c, p, r, alts, _v in sites]


def _spans(sites):
    """Per chromosome, from its first site to 200 bp before its last, so
    the last rows stay outside the tables (the placeholder path)."""
    out = {}
    for c, p, _r, _a, _v in sites:
        lo, hi = out.get(c, (p, p))
        out[c] = (min(lo, p), max(hi, p))
    return {c: (lo, hi - 200) for c, (lo, hi) in out.items()}


@pytest.fixture(scope="module")
def cadd_inputs(tmp_path_factory):
    """A reference-built store of ``base_sites`` (SNVs, indels,
    multi-allelic sites, over-width alleles on chromosomes 1, 2 and X), two
    table sets over it, and a subset VCF of 40% of its lines plus two
    variants the store lacks."""
    from chip_smoke import write_cadd_tables

    work = tmp_path_factory.mktemp("cadd")
    sites = base_sites(seed=11, n=420)
    base = build_base(sites, str(work / "base"))
    dbs, preds = {}, {}
    for tag, seed in (("a", 1), ("b", 2)):
        dbs[tag] = str(work / f"db_{tag}")
        preds[tag] = write_cadd_tables(dbs[tag], _sites(sites), _spans(sites),
                                       seed=seed, block_rows=64)
    rng = np.random.default_rng(3)
    sub = str(work / "subset.vcf")
    with open(sub, "w") as fh:
        fh.write("##fileformat=VCFv4.2\n#CHROM\tPOS\tID\tREF\tALT\tQUAL\t"
                 "FILTER\tINFO\n")
        picked = [s for s in sites if rng.random() < 0.4]
        for chrom in ("1", "2", "X"):
            for c, pos, ref, alts, vid in picked:
                if c == chrom:
                    fh.write(f"{c}\t{pos}\t{vid}\t{ref}\t{','.join(alts)}\t.\t.\t.\n")
        fh.write("X\t99999999\t.\tA\tC\t.\t.\t.\n5\t1000\t.\tA\tC\t.\t.\t.\n")
    return {"base": base, "dbs": dbs, "preds": preds, "subset": sub,
            "work": work}


def _set_cadd_engine(mp, engine):
    """Both packages read the tables with the same engine."""
    mp.setenv("AVDB_NATIVE_CADD", "0" if engine == "python" else "1")


def _quarantine(store_dir):
    q = os.path.join(store_dir, "quarantine", "cadd-scores.rejects.jsonl")
    return open(q, "rb").read() if os.path.exists(q) else None


def _run_cli(pkg, store_dir, db, extra, capsys, log):
    from annotatedvdb_tpu.cli.load_cadd import main as ref_main

    from annotatedvdb_tpu_torch.__main__ import main as torch_main

    # --maxWorkers off: the reference's single-device join, the path the
    # port carries (the test harness gives JAX eight CPU devices)
    args = ["--databaseDir", db, "--storeDir", store_dir, "--logAfter", "0",
            "--logFilePath", log, "--maxWorkers", "off", *extra]
    capsys.readouterr()
    error = None
    try:
        if pkg == "ref":
            rc = ref_main(args)
        else:
            rc = torch_main(["load-cadd", *args, "--platform", "cpu"])
        assert rc == 0
    except (ValueError, RuntimeError) as err:
        error = f"{type(err).__name__}: {err}"
    out = capsys.readouterr().out.strip().splitlines()
    return {"printed": out[-2:] if error is None else None, "error": error,
            "files": _persisted_bytes(store_dir),
            "ledger": _ledger_records(os.path.join(store_dir, "ledger.jsonl"),
                                      LEDGER_TYPES),
            "quarantine": _quarantine(store_dir)}


def _cli_pair(cadd_inputs, tmp_path, capsys, steps, base=None):
    """Run ``steps`` (lists of CLI flags, each with a ``db`` tag first) on a
    copy of the base store per package, in turn; assert the two agree after
    each step.  Returns the port's results and store directory."""
    dirs = {}
    for pkg in ("ref", "port"):
        dirs[pkg] = str(tmp_path / pkg)
        shutil.copytree(base or cadd_inputs["base"], dirs[pkg])
    results = []
    for k, (db_tag, *extra) in enumerate(steps):
        db = cadd_inputs["dbs"][db_tag]
        got = {pkg: _run_cli(pkg, dirs[pkg], db, extra, capsys,
                             str(tmp_path / f"{pkg}.{k}.log"))
               for pkg in ("ref", "port")}
        ref, port = got["ref"], got["port"]
        assert port["error"] == ref["error"], extra
        assert port["printed"] == ref["printed"], extra
        assert list(port["files"]) == list(ref["files"])
        for name in ref["files"]:
            assert port["files"][name] == ref["files"][name], f"{extra}: {name}"
        assert port["ledger"] == ref["ledger"], extra
        assert port["quarantine"] == ref["quarantine"], extra
        results.append(port)
    return results, dirs["port"]


def _counters(result):
    return json.loads(result["printed"][0])


@pytest.mark.parametrize("engine", ENGINES)
def test_whole_store_matches_reference(cadd_inputs, tmp_path, monkeypatch,
                                       capsys, engine):
    """The whole-store join, then a second pass (everything skipped), then
    ``--updateExisting`` against another table set (everything re-scored,
    replacement semantics)."""
    _set_cadd_engine(monkeypatch, engine)
    res, port_dir = _cli_pair(cadd_inputs, tmp_path, capsys, [
        ("a", "--commit"), ("a", "--commit"), ("b", "--commit", "--updateExisting"),
    ])
    pred = cadd_inputs["preds"]["a"]
    got = _counters(res[0])
    assert {k: got[k] for k in ("snv", "indel", "not_matched", "update", "skipped")} == \
        {k: pred[k] for k in ("snv", "indel", "not_matched", "update", "skipped")}
    assert got.get("rejected", 0) == (2 if engine == "python" else 0)
    assert got["indel"] >= 20 and got["not_matched"] > 20
    second = _counters(res[1])
    assert second["update"] == 0 and second["skipped"] == pred["candidates"]
    third = _counters(res[2])
    assert third["update"] == cadd_inputs["preds"]["b"]["update"]
    # the scores are the tables' text-parsed floats
    store = TorchStore.load(port_dir)
    exp = cadd_inputs["preds"]["b"]["expected"]
    seen = 0
    for code, label in ((1, "1"), (2, "2"), (23, "X")):
        shard = store.shards[code]
        for i in range(shard.n):
            ref, alt = shard.alleles(i)
            key = (label, int(shard.cols["pos"][i]), ref, alt)
            if key in exp:
                seen += 1
                raw, phred = exp[key]
                assert shard.get_ann("cadd_scores", i) == {
                    "CADD_raw_score": float(raw), "CADD_phred": float(phred)}
    assert seen == cadd_inputs["preds"]["b"]["indel"]


@pytest.mark.parametrize("engine", ENGINES)
def test_chromosome_subsets_match_reference(cadd_inputs, tmp_path, monkeypatch,
                                            capsys, engine):
    _set_cadd_engine(monkeypatch, engine)
    res, _d = _cli_pair(cadd_inputs, tmp_path, capsys, [
        ("a", "--commit", "--chr", "2"), ("a", "--commit", "--chr", "1,X"),
        ("a", "--commit", "--chr", "autosome"),
    ])
    assert _counters(res[0])["update"] > 0
    assert _counters(res[2])["skipped"] > 0


@pytest.mark.parametrize("engine", ENGINES)
def test_file_subset_sequential_and_random_access_match_reference(
        cadd_inputs, tmp_path, monkeypatch, capsys, engine):
    """``--fileName`` through the sequential pass (no index), then, after
    ``--buildIndex``, through indexed seeks with ``--updateExisting``; a
    ``--randomAccess`` request without an index is refused by both."""
    _set_cadd_engine(monkeypatch, engine)
    db = cadd_inputs["dbs"]["b"]
    for name in os.listdir(db):
        if name.endswith(".avdx.npz"):
            os.remove(os.path.join(db, name))
    sub = cadd_inputs["subset"]
    res, _d = _cli_pair(cadd_inputs, tmp_path, capsys, [
        ("b", "--commit", "--fileName", sub),
        ("b", "--commit", "--fileName", sub, "--randomAccess"),
        ("b", "--buildIndex"),
        ("b", "--commit", "--fileName", sub, "--updateExisting"),
        ("b", "--commit", "--fileName", sub, "--updateExisting", "--test"),
        ("b", "--commit"),
    ])
    first, refused, _built, indexed = res[:4]
    assert _counters(first)["update"] > 0 and "bytes_read" not in _counters(first)
    assert "random_access requires" in refused["error"]
    got = _counters(indexed)
    assert got["bytes_read"] > 0 and got["update"] == _counters(first)["update"]
    assert _counters(res[4])["update"] <= got["update"]


@pytest.mark.parametrize("engine", ENGINES)
def test_test_mode_and_dry_run_match_reference(cadd_inputs, tmp_path,
                                               monkeypatch, capsys, engine):
    """``--test`` stops after one block (small blocks on both sides), rows
    past it stay unset; a dry run changes no store byte; a full run after
    them scores what they left."""
    _set_cadd_engine(monkeypatch, engine)

    def small(cls):
        class Small(cls):
            def __init__(self, path, width, block_rows=64, **kw):
                super().__init__(path, width, block_rows=64, **kw)
        return Small

    monkeypatch.setattr(ref_cadd_loader, "CaddFileReader",
                        small(ref_cadd_loader.CaddFileReader))
    monkeypatch.setattr(port_cadd_loader, "CaddFileReader",
                        small(port_cadd_loader.CaddFileReader))
    before = _persisted_bytes(cadd_inputs["base"])
    res, port_dir = _cli_pair(cadd_inputs, tmp_path, capsys, [
        ("a", "--commit", "--test"), ("a",), ("a", "--commit"),
    ])
    assert _counters(res[0])["update"] < cadd_inputs["preds"]["a"]["update"]
    assert res[1]["ledger"][-2]["commit_mode"] is False
    assert _counters(res[2])["skipped"] == _counters(res[0])["update"] + \
        _counters(res[0])["not_matched"]
    assert _persisted_bytes(cadd_inputs["base"]) == before


def test_max_errors_pins_the_python_scanner(cadd_inputs, tmp_path, monkeypatch,
                                            capsys):
    """An armed ``--maxErrors`` reads with the Python scanner in both
    packages (each table's malformed line is quarantined), and a budget
    of 0 aborts on the first reject, identically."""
    monkeypatch.delenv("AVDB_NATIVE_CADD", raising=False)
    res, _d = _cli_pair(cadd_inputs, tmp_path, capsys, [
        ("a", "--commit", "--maxErrors", "5"),
    ])
    assert _counters(res[0])["rejected"] == 2
    assert len(res[0]["quarantine"].splitlines()) == 3
    res, _d = _cli_pair(cadd_inputs, tmp_path / "zero", capsys, [
        ("a", "--commit", "--maxErrors", "0", "--updateExisting"),
    ])
    assert "ErrorBudgetExceeded" in res[0]["error"]


@pytest.mark.parametrize("engine", ENGINES)
def test_long_allele_host_replay_matches_reference(tmp_path, monkeypatch, engine):
    """Over-width alleles match on full strings, never on the shared
    49-byte prefix (``test_cadd.test_long_allele_host_replay``'s case, both
    packages on copies of one store)."""
    _set_cadd_engine(monkeypatch, engine)
    long_a, long_b = "A" * 60, "A" * 59 + "T"
    base = build_base("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n"
                      f"1\t700\t.\tG\t{long_b}\t.\t.\t.\n"
                      f"1\t710\t.\tG\tA\t.\t.\t.\n", str(tmp_path / "base"))
    db = tmp_path / "cadd"
    db.mkdir()
    with gzip.open(db / "gnomad.genomes.r3.0.indel.tsv.gz", "wt") as f:
        f.write("#Chrom\tPos\tRef\tAlt\tRawScore\tPHRED\n"
                f"1\t700\tG\t{long_a}\t3.0\t30.0\n"
                f"1\t700\tG\t{long_b}\t3.5\t35.0\n")
    with gzip.open(db / "whole_genome_SNVs.tsv.gz", "wt") as f:
        f.write("1\t710\tG\tA\t0.5\t5.0\n1\t710\tG\tC\t0.6\t6.0\n")
    out = {}
    for pkg in ("ref", "port"):
        d = str(tmp_path / pkg)
        shutil.copytree(base, d)
        Store, Ledger = (TorchStore, TorchLedger) if pkg == "port" else (
            VariantStore, AlgorithmLedger)
        store = Store.load(d)
        ledger = Ledger(os.path.join(d, "ledger.jsonl"))
        if pkg == "port":
            upd = CaddUpdater(store, ledger, str(db), log=lambda *a: None,
                              device="cpu")
        else:
            upd = TpuCaddUpdater(store, ledger, str(db), log=lambda *a: None)
        counters = upd.update_all(commit=True)
        with pytest.raises(ValueError, match="unrecognized chromosome"):
            upd.update_all(chromosomes=["nonsense"], commit=False)
        store.save(d)
        out[pkg] = (counters, _persisted_bytes(d),
                    _ledger_records(os.path.join(d, "ledger.jsonl"), LEDGER_TYPES))
    assert out["port"] == out["ref"]
    assert out["port"][0]["indel"] == 1 and out["port"][0]["snv"] == 1
    scores = [v for v in TorchStore.load(str(tmp_path / "port")).shard(1)
              .object_column("cadd_scores")]
    assert {"CADD_raw_score": 3.5, "CADD_phred": 35.0} in scores


@pytest.mark.parametrize("engine", ENGINES)
def test_run_longer_than_probe_refused_like_reference(tmp_path, monkeypatch,
                                                      capsys, engine):
    """Five SNV rows at one position exceed the 4-deep window: both
    packages refuse with the same error and leave the same ledger."""
    _set_cadd_engine(monkeypatch, engine)
    base = build_base("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n"
                      "1\t100\t.\tA\tG\t.\t.\t.\n", str(tmp_path / "base"))
    db = tmp_path / "cadd"
    db.mkdir()
    with gzip.open(db / "whole_genome_SNVs.tsv.gz", "wt") as f:
        for k, a in enumerate("CGTCG"):
            f.write(f"1\t100\tA\t{a}\t0.{k}\t{k}.0\n")
    inputs = {"base": base, "dbs": {"x": str(db)}}
    res, _d = _cli_pair(inputs, tmp_path, capsys, [("x", "--commit")])
    assert "exceeding the 4-deep probe window" in res[0]["error"]


def test_updater_defaults_to_cuda_and_never_falls_back(cadd_inputs):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    store = TorchStore.load(cadd_inputs["base"])
    ledger = TorchLedger(str(cadd_inputs["work"] / "unused.jsonl"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CaddUpdater(store, ledger, cadd_inputs["dbs"]["a"])


@pytest.mark.parametrize("flags", [["--metricsOut", "m.prom"],
                                   ["--traceOut", "t.json"],
                                   ["--profile", "p"], ["--maxWorkers", "4"]],
                         ids=lambda f: f[0])
def test_cli_refuses_unported_flags(cadd_inputs, tmp_path, capsys,
                                   monkeypatch, flags):
    """``--metricsOut`` and ``--traceOut`` are ported: each writes its file
    and the store gets the run record.  ``--profile``, which the
    reference's ``load-cadd`` does not define, fails with the reference's
    argparse error.  ``--maxWorkers 4`` over four virtual CPU shards joins
    through the sharded update step and writes the bytes of the
    reference's 4-device mesh join and of the port's single-device join
    (store, ledger, quarantine, printed counters)."""
    from annotatedvdb_tpu.cli.load_cadd import main as ref_main

    from annotatedvdb_tpu_torch.cli.load_cadd import main as torch_main
    from test_torch_obs import check_obs_outputs

    if flags[0] == "--maxWorkers":
        from annotatedvdb_tpu.parallel import mesh as ref_mesh

        from annotatedvdb_tpu_torch.parallel import distributed
        from annotatedvdb_tpu_torch.parallel import mesh as port_mesh

        steps = []
        step = distributed.distributed_update_step

        def counted(mesh, *a, **kw):
            steps.append(mesh.size)
            return step(mesh, *a, **kw)

        monkeypatch.setattr(distributed, "distributed_update_step", counted)
        monkeypatch.setenv("AVDBC_VIRTUAL_DEVICES", "4")
        ref_mesh.reset_global_mesh()
        port_mesh.reset_global_mesh()
        res, port_dir = _cli_pair(cadd_inputs, tmp_path, capsys,
                                  [("a", "--commit", *flags)])
        assert steps and set(steps) == {4}
        single = str(tmp_path / "single")
        shutil.copytree(cadd_inputs["base"], single)
        got = _run_cli("port", single, cadd_inputs["dbs"]["a"], ["--commit"],
                       capsys, str(tmp_path / "single.log"))
        for key in ("printed", "error", "files", "ledger", "quarantine"):
            assert got[key] == res[0][key], key
        assert _counters(got)["update"] > 0
        return
    if flags[0] == "--profile":
        errs = []
        for main, extra in ((torch_main, ["--platform", "cpu"]),
                            (ref_main, [])):
            with pytest.raises(SystemExit) as exc:
                main(["--databaseDir", str(tmp_path), "--storeDir",
                      str(tmp_path / "vdb"), *extra, *flags])
            assert exc.value.code == 2
            errs.append(capsys.readouterr().err.strip().splitlines()[-1])
        assert errs[0] == errs[1]
        assert errs[0].endswith("unrecognized arguments: --profile p")
        assert not (tmp_path / "vdb").exists()
        return
    store = str(tmp_path / "vdb")
    shutil.copytree(cadd_inputs["base"], store)
    out = str(tmp_path / flags[1])
    assert torch_main(["--databaseDir", cadd_inputs["dbs"]["a"], "--storeDir",
                       store, "--platform", "cpu", "--commit", flags[0],
                       out]) == 0
    run = check_obs_outputs(flags[0], out, "load-cadd", store)
    assert run["script"] == "load-cadd" and run["counters"]["update"] > 0


def test_quarantine_sink_matches_reference_names(tmp_path):
    """The score tables' rejects land in one sink named for the tables,
    in both packages."""
    ref = RefSink(str(tmp_path), os.path.join("db", "cadd-scores"), "load-cadd")
    port = QuarantineSink(str(tmp_path), os.path.join("db", "cadd-scores"),
                          "load-cadd")
    assert port.path == ref.path


def test_reference_fixture_end_to_end(tmp_path):
    """``tests/test_cadd.py``'s fixture through the port's updater on the
    CPU: its expected counters and scores."""
    from annotatedvdb_tpu_torch.cli.load_vcf import main as load_vcf

    (tmp_path / "v.vcf").write_text(VCF)
    db = tmp_path / "cadd"
    db.mkdir()
    with gzip.open(db / "whole_genome_SNVs.tsv.gz", "wt") as f:
        f.write(SNV_TSV)
    with gzip.open(db / "gnomad.genomes.r3.0.indel.tsv.gz", "wt") as f:
        f.write(INDEL_TSV)
    d = str(tmp_path / "vdb")
    assert load_vcf(["--fileName", str(tmp_path / "v.vcf"), "--storeDir", d,
                     "--commit", "--platform", "cpu", "--logAfter", "0"]) == 0
    store = TorchStore.load(d)
    upd = CaddUpdater(store, TorchLedger(os.path.join(d, "ledger.jsonl")),
                      str(db), log=lambda *a: None, device="cpu")
    counters = upd.update_all(commit=True)
    assert (counters["snv"], counters["indel"], counters["not_matched"],
            counters["update"]) == (4, 1, 1, 5)
    assert upd.join_stats["blocks"] == 4  # chr1, chr2 and chrM SNVs; chr1 indels
    scores = {(c, sh.alleles(i)): sh.get_ann("cadd_scores", i)
              for c, sh in store.shards.items() for i in range(sh.n)}
    assert scores[(1, ("A", "G"))] == {"CADD_raw_score": 0.2, "CADD_phred": 2.0}
    assert scores[(25, ("A", "G"))] == {"CADD_raw_score": 1.1, "CADD_phred": 11.0}
    assert scores[(1, ("TC", "T"))] == {}
