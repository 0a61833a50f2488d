"""The port's native VEP transform against the JAX package's.

``annotatedvdb_tpu_torch/native/vep.py`` and ``native/pyfast.py`` (with
their C++ sources) are held against the reference's ``native/vep.py`` and
``native/pyfast.py``: the transformer's output column by column on
``DOCS``, the seeded file of ``test_torch_vep.py`` and three seeded fuzz
files (spans compared as text, not as offsets into pooled buffers),
``ranking_blob`` byte for byte before and after a learned combo, and
``raw_rows`` on an ASCII arena.  Whole VEP updates in the default (native)
configuration of both packages then compare store bytes, counters,
quarantine files and ledger records: a fuzz file written with raw UTF-8
(the non-ASCII arena path), a block whose flagged docs learn more combos
than the restart cap allows, interleaved with native docs updating the
same rows, and a store from a native VCF load whose FREQ values are raw
JSON text.  A failed build and a failed probe raise.  All exact
(tolerance 0).
"""

import json
import os
import random
import re
import shutil

import numpy as np
import pytest

from annotatedvdb_tpu.conseq import ConsequenceRanker as RefRanker
from annotatedvdb_tpu.loaders import TpuVcfLoader, TpuVepLoader
from annotatedvdb_tpu.native import pyfast as ref_pyfast
from annotatedvdb_tpu.native import vep as ref_vep
from annotatedvdb_tpu.store import AlgorithmLedger as RefLedger
from annotatedvdb_tpu.store import VariantStore as RefStore
from annotatedvdb_tpu.store.variant_store import RawJson as RefRawJson
from annotatedvdb_tpu.utils.quarantine import QuarantineSink as RefSink

from annotatedvdb_tpu_torch import native
from annotatedvdb_tpu_torch.conseq import ConseqGroup, ConsequenceRanker
from annotatedvdb_tpu_torch.conseq.ranker import DEFAULT_RANKING_FILE
from annotatedvdb_tpu_torch.loaders import VcfLoader, VepLoader
from annotatedvdb_tpu_torch.loaders.vep_loader import MAX_RESTARTS, _blocks
from annotatedvdb_tpu_torch.native import pyfast
from annotatedvdb_tpu_torch.native import vep as port_vep
from annotatedvdb_tpu_torch.store import AlgorithmLedger, VariantStore
from annotatedvdb_tpu_torch.store.variant_store import RawJson
from annotatedvdb_tpu_torch.utils.quarantine import QuarantineSink
from test_torch_load_vcf import _ledger_records, _persisted_bytes
from test_torch_vep import _ref_vcf, _write_inputs
from test_vep_native import DOCS

WIDTH = 49
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARRAYS = ("doc_of_row", "chrom", "pos", "ref", "alt", "ref_len", "alt_len",
          "ref_slen", "alt_slen", "is_multi", "hash", "host_fb",
          "doc_fallback", "doc_skipped", "doc_off")
SPANS = ("ms", "rk", "fq", "vo")


@pytest.fixture
def default_config(monkeypatch):
    """Both packages' default configuration: no AVDB_NATIVE_VEP, no VCF
    engine or pipeline variable."""
    for name in ("AVDB_NATIVE_VEP", "AVDB_INGEST_ENGINE", "AVDB_PIPELINE",
                 "AVDB_ASYNC_STORE"):
        monkeypatch.delenv(name, raising=False)


def _fuzz(seed: int, n: int = 200, ascii_only: bool = True):
    """(VCF text, VEP JSON text) of ``n`` seeded docs at chr1 sites: odd
    keys, unicode, escapes, numbers in several formats, multi-allelic
    sites, missing blocks, colocated variants with and without the site's
    rs id (the shape of ``test_vep_native.py``'s fuzz)."""
    rng = random.Random(seed)
    terms = ["missense_variant", "intron_variant", "stop_gained",
             "synonymous_variant", "downstream_gene_variant",
             "3_prime_UTR_variant", "NMD_transcript_variant"]

    def seq():
        if rng.random() < 0.7:
            return rng.choice("ACGT")
        return "".join(rng.choice("ACGT") for _ in range(rng.randint(2, 5)))

    def value(depth=0):
        r = rng.random()
        if depth > 2 or r < 0.3:
            return rng.choice([1, -2.5, 1e-7, 0.30000000000000004, True, False,
                               None, "plain", "esc\taped", "uniécode",
                               'q"uote', 12345678901234])
        if r < 0.6:
            return {rng.choice(["a", "b", "weird key", "x\ty"]): value(depth + 1)
                    for _ in range(rng.randint(0, 3))}
        return [value(depth + 1) for _ in range(rng.randint(0, 3))]

    def key(ref, alt):
        p = 0
        while p < min(len(ref), len(alt)) and ref[p] == alt[p]:
            p += 1
        return alt[p:] or "-"

    vcf, docs = [], []
    for i in range(n):
        pos, ref = 1000 + i * 10, seq()
        alts = [seq() for _ in range(rng.randint(1, 3))]
        alt_col = ",".join(alts)
        vcf.append(f"1\t{pos}\trs{i}\t{ref}\t{alt_col}\t.\t.\t.\n")
        doc = {"input": f"1\t{pos}\trs{i}\t{ref}\t{alt_col}",
               "most_severe_consequence": rng.choice(terms)}
        for ctype in ("transcript", "regulatory_feature", "motif_feature",
                      "intergenic"):
            if rng.random() < 0.6:
                doc[ctype + "_consequences"] = [{
                    "consequence_terms": sorted(
                        {rng.choice(terms) for _ in range(rng.randint(1, 2))}),
                    "variant_allele": rng.choice(
                        [key(ref, a := rng.choice(alts)), a, "Z"]),
                    "extra": value(),
                } for _ in range(rng.randint(0, 3))]
        if rng.random() < 0.5:
            covars = []
            for _ in range(rng.randint(1, 3)):
                cv = {"id": rng.choice([f"rs{i}", "rsX", "COSV9"]),
                      "allele_string": rng.choice([f"{ref}/{alts[0]}",
                                                   "COSMIC_MUTATION"])}
                if rng.random() < 0.8:
                    cv["frequencies"] = {
                        rng.choice([key(ref, rng.choice(alts)), "T"]): {
                            rng.choice(["af", "aa", "gnomad", "gnomad_afr",
                                        "eas"]): rng.random()
                            for _ in range(rng.randint(1, 3))}}
                covars.append(cv)
            doc["colocated_variants"] = covars
        if rng.random() < 0.4:
            doc[f"junk_{i}"] = value()
        docs.append(doc)
    header = "##fileformat=VCFv4.2\n#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n"
    vep = "".join(json.dumps(d, ensure_ascii=ascii_only) + "\n" for d in docs)
    return header + "".join(vcf), vep.encode()


# ------------------------------------------------------- the transformer


def _columns(res):
    """A transform's columns, copied out of the pooled buffers, with every
    span as the text it covers."""
    out = {name: np.array(getattr(res, name)) for name in ARRAYS}
    out["n_rows"] = res.n_rows
    for side in ("ref", "alt"):
        out[side + "_text"] = [
            res.text[o:o + n] for o, n in zip(getattr(res, side + "_off").tolist(),
                                              getattr(res, side + "_slen").tolist())]
    for col in SPANS:
        out[col] = [res.arena[o:o + n] for o, n in zip(
            getattr(res, col + "_off").tolist(), getattr(res, col + "_len").tolist())]
    return out


def _assert_same_transform(text: bytes, is_dbsnp: bool, width: int = WIDTH):
    want = ref_vep.transform_text(text, ref_vep.ranking_blob(RefRanker()),
                                  is_dbsnp, width)
    assert want is not None
    want = _columns(want)
    got = _columns(port_vep.transform_text(
        text, port_vep.ranking_blob(ConsequenceRanker()), is_dbsnp, width))
    assert got["n_rows"] == want["n_rows"]
    for name in ARRAYS:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    for name in ("ref_text", "alt_text") + SPANS:
        assert got[name] == want[name], name
    return got


@pytest.mark.parametrize("is_dbsnp", [True, False], ids=["dbsnp", "other"])
def test_transform_matches_reference_on_docs(is_dbsnp):
    text = "".join(json.dumps(d) + "\n" for d in DOCS).encode()
    got = _assert_same_transform(text, is_dbsnp)
    assert got["n_rows"] == 10 and (got["doc_fallback"] == 0).all()


def test_transform_matches_reference_on_the_update_fixture(tmp_path):
    """Both 4 MiB blocks of the seeded VEP file of test_torch_vep.py: the
    broken lines and the novel combos come back flagged, the unknown
    contig skipped, over-width rows re-hashed."""
    _vcf, vep = _write_inputs(tmp_path)
    with open(vep, "rb") as fh:
        blocks = list(_blocks(fh, test=False))
    assert len(blocks) == 2
    flags = np.zeros(3, np.int64)
    for text in blocks:
        got = _assert_same_transform(text, is_dbsnp=True)
        flags += np.bincount(got["doc_fallback"], minlength=3)
        over = got["host_fb"].astype(bool)
        assert over.any() == (got["ref_len"] > WIDTH).any() | (got["alt_len"] > WIDTH).any()
    assert flags[1] == 6 and flags[2] == 1


@pytest.mark.parametrize("seed", [20260730, 7, 991])
def test_transform_matches_reference_on_fuzz(seed):
    _vcf, vep = _fuzz(seed)
    got = _assert_same_transform(vep, is_dbsnp=True, width=16)
    assert got["n_rows"] > 0 and (got["doc_fallback"] == 1).any()


def test_ranking_blob_matches_reference():
    """Before and after a learned combo (the re-rank renumbers the table),
    and for a ranking file kept unranked (its ranks as the file has them)."""
    ref, port = RefRanker(), ConsequenceRanker()
    assert port_vep.ranking_blob(port) == ref_vep.ranking_blob(ref)
    terms = ["stop_gained", "NMD_transcript_variant", "intron_variant"]
    assert port.rank_of(",".join(terms)) is None
    v0 = port.version
    ref.find_matching_consequence(terms)
    port.find_matching_consequence(terms)
    assert port.version == ref.version == v0 + 1
    blob = port_vep.ranking_blob(port)
    assert blob == ref_vep.ranking_blob(ref)
    assert b"NMD_transcript_variant,intron_variant,stop_gained\x1f" in blob
    ref = RefRanker(DEFAULT_RANKING_FILE, rank_on_load=False)
    port = ConsequenceRanker(DEFAULT_RANKING_FILE, rank_on_load=False)
    assert port_vep.ranking_blob(port) == ref_vep.ranking_blob(ref)


def test_raw_rows_matches_reference():
    """The C column assembly on an ASCII arena: the same texts, empty spans
    as fresh dicts, consecutive equal spans as one instance."""
    assert ref_pyfast.available()
    arena = '{"a": 1}{"b": [2, 3]}{"c": {"d": null}}'
    offs = np.array([0, 8, 8, 0, 21, 8, 21, 21], np.int64)
    lens = np.array([8, 13, 13, 0, 17, 13, 17, 17], np.int32)
    want = ref_pyfast.raw_rows(arena, offs, lens, RefRawJson)
    got = pyfast.raw_rows(arena, offs, lens, RawJson)
    assert [type(v) for v in got] == [RawJson, RawJson, RawJson, dict,
                                      RawJson, RawJson, RawJson, RawJson]
    assert ([v.text if isinstance(v, RawJson) else v for v in got]
            == [v.text if isinstance(v, RefRawJson) else v for v in want])
    shared = [got[i] is got[i + 1] for i in range(len(got) - 1)]
    assert shared == [want[i] is want[i + 1] for i in range(len(want) - 1)]
    assert shared == [False, True, False, False, False, False, True]
    with pytest.raises(TypeError, match="int64 offs / int32 lens"):
        pyfast.raw_rows(arena, offs.astype(np.int32), lens, RawJson)


def test_sources_are_the_reference_but_for_comments():
    """The port's copies of the transformer and the extension differ from
    the reference's sources in comments alone."""

    def code(path):
        with open(path) as f:
            return [re.sub(r"\s*//.*$", "", line) for line in f]

    for port_src, name, lines in ((port_vep.SOURCE, "avdb_vep.cpp", 1000),
                                  (pyfast.SOURCE, "avdb_pyfast.cpp", 100)):
        ref = code(os.path.join(ROOT, "native", name))
        assert code(port_src) == ref and len(ref) > lines, name


# ------------------------------------------------------ whole VEP updates


def _update_both(base, vep, tmp_path, batch_size=1 << 14, ref_ranker=None,
                 port_ranker=None, datasource="dbSNP"):
    """The reference's and the port's VEP update of copies of the store at
    ``base``: (reference counters, port loader, reference dir, port dir)."""
    dirs = {}
    for tag in ("ref", "port"):
        d = dirs[tag] = str(tmp_path / f"vep_{tag}")
        shutil.copytree(base, d)
        if tag == "ref":
            store, sink = RefStore.load(d), RefSink(d, vep, "load-vep")
            loader = TpuVepLoader(store, RefLedger(f"{d}/ledger.jsonl"),
                                  ref_ranker or RefRanker(), datasource=datasource,
                                  batch_size=batch_size, log=lambda *a: None,
                                  quarantine=sink)
        else:
            store, sink = VariantStore.load(d), QuarantineSink(d, vep, "load-vep")
            loader = VepLoader(store, AlgorithmLedger(f"{d}/ledger.jsonl"),
                               port_ranker or ConsequenceRanker(),
                               datasource=datasource, batch_size=batch_size,
                               log=lambda *a: None, quarantine=sink, device="cpu")
        try:
            counters = loader.load_file(vep, commit=True)
        finally:
            sink.close()
        store.save(d)
        dirs[tag + "_counters"] = counters
        dirs[tag + "_loader"] = loader
    return dirs


def _assert_same_update(dirs, vep):
    assert dirs["ref_counters"] == dirs["port_counters"]
    a, b = _persisted_bytes(dirs["ref"]), _persisted_bytes(dirs["port"])
    assert list(a) == list(b)
    for name in a:
        assert a[name] == b[name], f"{name} bytes diverge"
    q = os.path.join("quarantine", os.path.basename(vep) + ".rejects.jsonl")
    if os.path.exists(os.path.join(dirs["ref"], q)):
        with open(os.path.join(dirs["ref"], q), "rb") as fa, \
                open(os.path.join(dirs["port"], q), "rb") as fb:
            assert fa.read() == fb.read()
    assert (_ledger_records(os.path.join(dirs["ref"], "ledger.jsonl"))
            == _ledger_records(os.path.join(dirs["port"], "ledger.jsonl")))


def _ref_base(tmp_path, vcf_text):
    vcf = str(tmp_path / "base.vcf")
    with open(vcf, "w") as f:
        f.write(vcf_text)
    base = str(tmp_path / "base")
    mp = pytest.MonkeyPatch()
    try:
        _ref_vcf(vcf, base, mp)
    finally:
        mp.undo()
    return base


def test_non_ascii_update_matches_reference(tmp_path, default_config):
    """Raw UTF-8 in the values: the transformer's arena is not ASCII, so
    the values are sliced from bytes one by one instead of in C."""
    vcf_text, vep_text = _fuzz(5, ascii_only=False)
    res = port_vep.transform_text(
        vep_text, port_vep.ranking_blob(ConsequenceRanker()), True, WIDTH)
    assert not res.arena.isascii()
    base = _ref_base(tmp_path, vcf_text)
    vep = str(tmp_path / "u.vep.json")
    with open(vep, "wb") as f:
        f.write(vep_text)
    dirs = _update_both(base, vep, tmp_path, batch_size=64)
    _assert_same_update(dirs, vep)
    stats = dirs["port_loader"].transform_stats
    assert stats["native_rows"] > 0 and stats["fallback_docs"] > 0


def _learning_block(n_learn: int):
    """A VCF of three sites and one block of VEP docs: ``n_learn`` docs,
    each with a combo the seed ranking lacks, each followed by a native doc
    for the same row with a conflicting key (the merge order shows in the
    stored value).  Returns (VCF text, VEP text, learned combos)."""
    ranker = ConsequenceRanker()
    rnd = random.Random(11)
    high, mod = ConseqGroup.HIGH_IMPACT.value, ConseqGroup.MODIFIER.value
    novel = []
    while len(novel) < n_learn:
        terms = rnd.sample(high, 2) + [rnd.choice(mod)]
        canon = ",".join(sorted(terms))
        if ranker.rank_of(canon) is None and canon not in [
                ",".join(sorted(t)) for t in novel]:
            novel.append(terms)
    sites = [("1", 1000, "rs1", "A", "G"), ("1", 2000, "rs2", "CA", "C"),
             ("2", 3000, "rs3", "T", "TA,TG")]
    vcf = ("##fileformat=VCFv4.2\n#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n"
           + "".join(f"{c}\t{p}\t{i}\t{r}\t{a}\t.\t.\t.\n" for c, p, i, r, a in sites))
    docs = []
    for k, terms in enumerate(novel):
        chrom, pos, vid, ref, alt = sites[k % len(sites)]
        allele = {"G": "G", "C": "-", "TA,TG": "A"}[alt]
        for tag, conseq in ((f"learn{k}", terms), (f"after{k}", ["intron_variant"])):
            docs.append({
                "input": f"{chrom}\t{pos}\t{vid}\t{ref}\t{alt}",
                "most_severe_consequence": conseq[0],
                "custom_key": {"from": tag, "k": k},
                "transcript_consequences": [
                    {"consequence_terms": conseq, "variant_allele": allele}],
                "colocated_variants": [{
                    "id": vid, "allele_string": f"{ref}/{alt}",
                    "frequencies": {allele: {"af": k / 10, "gnomad": 0.5}}}]})
    return vcf, "".join(json.dumps(d) + "\n" for d in docs), novel


@pytest.mark.parametrize("n_learn", [3, MAX_RESTARTS + 2])
def test_fallback_interleave_and_restart_cap(tmp_path, default_config, n_learn):
    """Flagged docs apply in document order between the native ranges; each
    learned combo restarts the transformer after its doc; past the cap the
    rest of the block takes the Python transform.  Store bytes, counters
    and learned combos equal the reference's."""
    vcf_text, vep_text, novel = _learning_block(n_learn)
    base = _ref_base(tmp_path, vcf_text)
    vep = str(tmp_path / "learn.vep.json")
    with open(vep, "w") as f:
        f.write(vep_text)
    dirs = _update_both(base, vep, tmp_path)
    _assert_same_update(dirs, vep)
    loader = dirs["port_loader"]
    assert loader.parser.ranker.added == [",".join(sorted(t)) for t in novel]
    # n_learn=3: every learning doc restarts the transformer, and the
    # "after" docs (1 + 1 + 2 rows) apply natively.  Past the cap the
    # fourth restart hands the rest of the block to the Python transform.
    native_rows, flagged, restarts, python = {
        3: (4, 3, 3, 0), MAX_RESTARTS + 2: (4, 4, 4, 1)}[n_learn]
    assert loader.transform_stats == {
        "native_rows": native_rows, "fallback_docs": flagged,
        "restarts": restarts, "python_blocks": python}
    store = VariantStore.load(dirs["port"])
    last = {}
    for k in range(n_learn):
        last[k % 3] = f"after{k}"
    for site, tag in last.items():
        code = 1 if site < 2 else 2
        shard = store.shard(code)
        every = np.arange(shard.n)
        pos = shard.get_col("pos", every)
        i = int(np.flatnonzero(pos == (1000, 2000, 3000)[site])[0])
        assert shard.get_ann("vep_output", i)["custom_key"]["from"] == tag


def test_update_of_native_vcf_store_merges_raw_freq(tmp_path, default_config):
    """Both packages' default VCF load (the native tokenizer keeps FREQ
    values as raw JSON text in memory), then the default VEP update of that
    same in-memory store: frequency values merge RawJson onto RawJson (each
    materialized fresh first); the saved stores are byte-identical."""
    from chip_smoke import write_phase4_vcf, write_vep_json

    vcf = str(tmp_path / "f.vcf")
    lines, _rows, _dups = write_phase4_vcf(vcf, 3000)
    vep = str(tmp_path / "f.vep.json")
    write_vep_json(vep, lines, 1500, seed=3, n_novel=2)
    out = {}
    for tag in ("ref", "port"):
        d = str(tmp_path / tag)
        os.makedirs(d)
        sink = (RefSink if tag == "ref" else QuarantineSink)(d, vep, "load-vep")
        if tag == "ref":
            store, ledger = RefStore(width=WIDTH), RefLedger(f"{d}/ledger.jsonl")
            vcf_loader = TpuVcfLoader(store, ledger, log=lambda *a: None)
            vep_loader = TpuVepLoader(store, ledger, RefRanker(),
                                      datasource="dbSNP", log=lambda *a: None,
                                      quarantine=sink)
        else:
            store, ledger = VariantStore(width=WIDTH), AlgorithmLedger(f"{d}/ledger.jsonl")
            vcf_loader = VcfLoader(store, ledger, log=lambda *a: None, device="cpu")
            vep_loader = VepLoader(store, ledger, ConsequenceRanker(),
                                   datasource="dbSNP", log=lambda *a: None,
                                   quarantine=sink, device="cpu")
        try:
            vcf_loader.load_file(vcf, commit=True)
        finally:
            vcf_loader.close()
        if tag == "port":
            raw = {}
            for code, shard in store.shards.items():
                for si, seg in enumerate(shard.segments):
                    col = seg.obj["allele_frequencies"]
                    for j, v in enumerate([] if col is None else col):
                        if isinstance(v, RawJson):
                            raw[(code, si, j)] = v.text
            assert raw
        try:
            out[tag] = vep_loader.load_file(vep, commit=True)
        finally:
            sink.close()
        store.save(d)
    assert out["ref"] == out["port"]
    assert _persisted_bytes(str(tmp_path / "ref")) == _persisted_bytes(str(tmp_path / "port"))
    merged = 0
    for (code, si, j), text in raw.items():
        v = store.shard(code).segments[si].obj["allele_frequencies"][j]
        value = v.fresh() if isinstance(v, RawJson) else v
        if value != json.loads(text):
            merged += 1
            assert set(json.loads(text)) < set(value)
    assert merged > 0


# ------------------------------------------------------------- no fallback


def _tiny_update(tmp_path):
    text = "".join(json.dumps(d) + "\n" for d in DOCS)
    base = _ref_base(tmp_path, "##fileformat=VCFv4.2\n#CHROM\tPOS\tID\tREF\tALT"
                     "\tQUAL\tFILTER\tINFO\n1\t1000\trs1\tA\tG\t.\t.\tRS=1\n")
    vep = str(tmp_path / "t.vep.json")
    with open(vep, "w") as f:
        f.write(text)
    return base, vep


def _port_loader(store_dir):
    store = VariantStore.load(store_dir)
    return store, VepLoader(store, AlgorithmLedger(f"{store_dir}/ledger.jsonl"),
                            ConsequenceRanker(), log=lambda *a: None,
                            device="cpu")


def test_failed_transformer_build_raises(tmp_path, monkeypatch, default_config):
    """A transformer source that does not compile: the default load raises
    with the compiler's stderr before the ledger records a run, and
    AVDB_NATIVE_VEP=0 still loads through the Python transform."""
    base, vep = _tiny_update(tmp_path)
    bad = tmp_path / "broken.cpp"
    bad.write_text("int avdb_vep_transform( { this is not C++\n")
    monkeypatch.setattr(port_vep, "SOURCE", str(bad))
    monkeypatch.setattr(port_vep, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    with open(f"{base}/ledger.jsonl", "rb") as f:
        ledger = f.read()
    store, loader = _port_loader(base)
    with pytest.raises(RuntimeError,
                       match="native VEP transformer build failed:\n.*error"):
        loader.load_file(vep, commit=True)
    assert loader.counters["line"] == 0
    with open(f"{base}/ledger.jsonl", "rb") as f:
        assert f.read() == ledger
    monkeypatch.setenv("AVDB_NATIVE_VEP", "0")
    counters = loader.load_file(vep, commit=True)
    assert counters["update"] == 3 and loader.transform_stats["python_blocks"] == 1


def test_failed_pyfast_probe_raises(tmp_path, monkeypatch, default_config):
    """A RawJson whose layout the C assembly cannot fill (no slots): the
    probe fails and the default load raises with the cause."""

    class DictRawJson:
        def __init__(self, text):
            self.text = text

    base, vep = _tiny_update(tmp_path)
    monkeypatch.setattr(pyfast, "RawJson", DictRawJson)
    monkeypatch.setattr(pyfast, "_mod", None)
    with pytest.raises(RuntimeError, match="avdb_pyfast probe failed"):
        pyfast.load()
    _store, loader = _port_loader(base)
    with pytest.raises(RuntimeError, match="avdb_pyfast probe failed"):
        loader.load_file(vep, commit=True)
    assert loader.counters["line"] == 0
