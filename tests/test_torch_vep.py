"""The VEP annotation update, end to end: the PyTorch port against the JAX
package.

One seeded VCF is loaded by the reference ``TpuVcfLoader`` (Python
tokenizer, serial pipeline) and by the port's ``VcfLoader``; one seeded VEP
JSON file then updates each store — the reference's ``TpuVepLoader`` and
the port's ``VepLoader`` on the CPU, in both VEP configurations: ``python``
(``AVDB_NATIVE_VEP=0`` for both packages, the pure-Python transform) and
``native`` (no variable for either: the C++ transform and raw-JSON
values, with the docs it flags re-run through the Python transform).  The
file covers multi-allelic sites (shared
``cleaned`` dicts and a shared frequency bucket), '.' alts, variants the
store does not hold, deletions keyed '-', over-width alleles, unknown
contigs, repeated results for one variant with conflicting keys (the
deep-merge order is observable) and for one alt of a multi-allelic site
(a row that aliased its sibling's stored dict would change with it),
malformed and broken lines (quarantine),
novel consequence combos mid-file (learn-on-miss re-ranks) and results
large enough to cut the file into two 4 MiB blocks (two flushes).  The
comparison is exact everywhere: counters, store files byte for byte,
quarantine files, ledger records and decoded values.
"""

import copy
import json
import os
import shutil

import numpy as np
import pytest

from annotatedvdb_tpu.conseq import ConsequenceRanker as RefRanker
from annotatedvdb_tpu.io.vep import VepResultParser as RefParser
from annotatedvdb_tpu.loaders import TpuVcfLoader, TpuVepLoader
from annotatedvdb_tpu.store import AlgorithmLedger, VariantStore
from annotatedvdb_tpu.store.fsck import fsck
from annotatedvdb_tpu.store.variant_store import JSONB_COLUMNS, RawJson
from annotatedvdb_tpu.utils.quarantine import QuarantineSink as RefSink

from annotatedvdb_tpu_torch.conseq import ConsequenceRanker
from annotatedvdb_tpu_torch.io.vep import VepResultParser
from annotatedvdb_tpu_torch.loaders import VcfLoader, VepLoader
from annotatedvdb_tpu_torch.store import AlgorithmLedger as TorchLedger
from annotatedvdb_tpu_torch.store import VariantStore as TorchStore
from annotatedvdb_tpu_torch.utils.quarantine import QuarantineSink
from test_torch_load_vcf import _ledger_records, _persisted_bytes
from test_vep_load import vep_result
from test_vep_native import DOCS
from test_vep_native import VCF as NATIVE_VCF

COUNTER_KEYS = ("line", "variant", "skipped", "duplicates", "update",
                "not_found", "rejected", "alg_id")
BASES = "ACGT"
VCF_BATCH = 256
PAD_BYTES = 1_200_000  # four such results put the file past one 4 MiB block


def _norm(ref: str, alt: str) -> str:
    """VEP's allele key: the alt past the shared prefix, '-' when empty
    (SNVs untouched) — what the loaders match consequences against."""
    if len(ref) == 1 and len(alt) == 1:
        return alt
    p = 0
    while p < len(ref) and p < len(alt) and ref[p] == alt[p]:
        p += 1
    return (alt[p:] or "-") if p else alt


def _write_inputs(work, seed: int = 3, n_sites: int = 160):
    """(vcf path, vep path) of the seeded inputs described above."""
    rng = np.random.default_rng(seed)
    combos = [c.split(",") for c in ConsequenceRanker().rankings]

    def seq(n):
        return "".join(BASES[int(i)] for i in rng.integers(0, 4, n))

    def other(base):
        return BASES[(BASES.index(base) + 1 + int(rng.integers(3))) % 4]

    def doc(chrom, pos, vid, ref, alt_col, alts, tag):
        keys = [_norm(ref, a) for a in alts] or ["-"]
        d = {"input": f"{chrom}\t{pos}\t{vid}\t{ref}\t{alt_col}",
             "id": vid, "assembly_name": "GRCh38", "start": pos, "strand": 1,
             "allele_string": "/".join([ref] + alts),
             "most_severe_consequence": "intron_variant",
             "custom_key": {"from": tag, "n": int(rng.integers(100))}}
        d["transcript_consequences"] = [
            {"gene_id": f"ENSG{int(rng.integers(10**6)):011d}",
             "transcript_id": f"ENST{int(rng.integers(10**6)):011d}",
             "variant_allele": (keys[int(rng.integers(len(keys)))]
                                if rng.random() < 0.9 else "Z"),
             "consequence_terms": list(combos[int(rng.integers(len(combos)))]),
             "impact": "MODERATE", "cadd_phred": round(float(rng.random()) * 30, 3)}
            for _ in range(int(rng.integers(1, 5)))
        ]
        for ctype, terms, share in (
                ("regulatory_feature", ["regulatory_region_variant"], 0.3),
                ("motif_feature", ["TF_binding_site_variant"], 0.15),
                ("intergenic", ["intergenic_variant"], 0.1)):
            if rng.random() < share:
                d[ctype + "_consequences"] = [
                    {"variant_allele": keys[0], "consequence_terms": terms,
                     "biotype": "promoter"}]
        if rng.random() < 0.6:
            covars = []
            if rng.random() < 0.3:
                covars.append({"id": f"COSV{int(rng.integers(10**6))}",
                               "allele_string": "COSMIC_MUTATION",
                               "frequencies": {keys[0]: {"af": 0.5}}})
            covars.append({
                "id": vid if rng.random() < 0.8 else "rsOTHER",
                "allele_string": "/".join([ref] + alts),
                "minor_allele": keys[0], "minor_allele_freq": 0.01,
                "frequencies": {k: {"gnomad": round(float(rng.random()), 4),
                                    "gnomad_afr": 0.25, "af": 0.5,
                                    "aa": 0.125, "ea": 0.0625}
                                for k in keys}})
            d["colocated_variants"] = covars
        return d

    vcf = {"1": [], "2": []}
    docs, repeats = [], []
    pos = 10_000
    for k in range(n_sites):
        pos += int(rng.integers(2, 40))
        chrom = "1" if k % 3 else "2"
        ref = BASES[int(rng.integers(4))]
        kind = k % 9
        if kind == 1:
            alts = [ref + seq(int(rng.integers(2, 6)))]          # insertion
        elif kind == 2:
            ref = ref + seq(int(rng.integers(2, 6)))
            alts = [ref[0]]                                     # deletion: '-'
        elif kind == 3:
            a = other(ref)
            alts = [a, next(b for b in BASES if b not in (ref, a))]
        elif kind == 4:
            ref = ref + "T"
            alts = [ref[0], ref + "T"]                          # GT -> G,GTT
        elif kind == 5:
            a = other(ref)
            alts = [a, ref + a]   # both key a: one shared frequency bucket
        elif kind == 6 and k % 18 == 6:
            ref = ref + seq(60)
            alts = [ref[0]]                                     # over width
        elif kind == 7 and k % 18 == 7:
            alts = [ref + seq(55)]                              # over width
        else:
            alts = [other(ref)]
        alt_col = ",".join(alts) + (",." if k % 13 == 0 else "")
        vid = f"rs{k + 100}"
        vcf[chrom].append(f"{chrom}\t{pos}\t{vid}\t{ref}\t{alt_col}\t.\t.\tRS={k + 100}\n")
        if k % 10 == 9:
            continue  # a stored variant without a VEP result
        docs.append(doc(chrom, pos, vid, ref, alt_col, alts, f"site{k}"))
        if k % 7 == 0:
            repeats.append(doc(chrom, pos, vid, ref, alt_col, alts, f"again{k}"))
        if len(alts) > 1 and k % 2 == 0:
            # later, one alt alone: a merge into that row only, which shows
            # whether the site's rows shared a stored dict
            repeats.append(doc(chrom, pos, vid, ref, alts[0], alts[:1], f"one{k}"))
        if k % 8 == 0:  # the same site, an allele the store does not hold
            alt = next(b for b in BASES if b != ref[0] and b not in alts)
            docs.append(doc(chrom, pos, vid, ref, alt, [alt], f"absent{k}"))
        if k % 17 == 0:  # a position the store does not hold
            docs.append(doc(chrom, pos + 1, ".", ref, alts[0], alts[:1], "nopos"))
    docs.append(doc("chrUn_KI270742v1", 500, ".", "A", "G", ["G"], "contig"))
    docs.append(doc("1", 777, ".", "A", ".", [], "dot"))
    # novel combos in each half of the file (the first block and the second)
    novel = [["stop_gained", "NMD_transcript_variant", "intron_variant"],
             ["missense_variant", "upstream_gene_variant", "TF_binding_site_variant"]]
    for terms, at in zip(novel, (len(docs) // 4, -5)):
        assert ConsequenceRanker().rank_of(",".join(terms)) is None
        docs[at]["transcript_consequences"][0]["consequence_terms"] = terms
    pads = []
    for i in range(4):
        d = doc("1", 1000, "rs1", "A", "G", ["G"], f"pad{i}")
        d["padding"] = "N" * PAD_BYTES
        pads.append(d)
    half = len(docs) // 2
    lines = [json.dumps(d) for d in docs[:half] + pads[:3]]
    lines += ['{"input": "1\\t10\\trs0\\tA\\tC", "transcript_consequences": [',
              "[1, 2]", '{"no_input": true}',
              json.dumps({"input": "1\tnot_a_pos\trs0\tA\tC"})]
    lines += [json.dumps(d) for d in copy.deepcopy(DOCS)]
    lines += [json.dumps(d) for d in docs[half:] + repeats + pads[3:]]
    native = [ln + "\n" for ln in NATIVE_VCF.splitlines()[2:]]
    vcf_path, vep_path = str(work / "sites.vcf"), str(work / "sites.vep.json")
    with open(vcf_path, "w") as fh:
        fh.write("##fileformat=VCFv4.2\n"
                 "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n")
        fh.writelines([ln for ln in native if ln.startswith("1\t")] + vcf["1"])
        fh.writelines([ln for ln in native if ln.startswith("2\t")] + vcf["2"])
        fh.writelines(ln for ln in native if ln.startswith("X\t"))
    with open(vep_path, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    assert os.path.getsize(vep_path) > 4 << 20
    return vcf_path, vep_path


def _ref_vcf(vcf, store_dir, mp):
    mp.setenv("AVDB_PIPELINE", "serial")
    mp.setenv("AVDB_INGEST_ENGINE", "python")
    os.makedirs(store_dir)
    store = VariantStore(width=49)
    ledger = AlgorithmLedger(os.path.join(store_dir, "ledger.jsonl"))
    loader = TpuVcfLoader(store, ledger, batch_size=VCF_BATCH, log=lambda *a: None)
    try:
        loader.load_file(vcf, commit=True)
    finally:
        loader.close()
    store.save(store_dir)


def _torch_vcf(vcf, store_dir):
    os.makedirs(store_dir)
    store = TorchStore(width=49)
    ledger = TorchLedger(os.path.join(store_dir, "ledger.jsonl"))
    loader = VcfLoader(store, ledger, batch_size=VCF_BATCH,
                       log=lambda *a: None, device="cpu")
    try:
        loader.load_file(vcf, commit=True)
    finally:
        loader.close()
    store.save(store_dir)


def _set_config(mp, config):
    """``python``: AVDB_NATIVE_VEP=0; ``native``: the variable unset (the
    default of both packages)."""
    if config == "python":
        mp.setenv("AVDB_NATIVE_VEP", "0")
    else:
        mp.delenv("AVDB_NATIVE_VEP", raising=False)


def _ref_vep(vep, store_dir, mp, config="python", **kw):
    _set_config(mp, config)
    store = VariantStore.load(store_dir)
    ledger = AlgorithmLedger(os.path.join(store_dir, "ledger.jsonl"))
    sink = RefSink(store_dir, vep, "load-vep")
    loader = TpuVepLoader(store, ledger, RefRanker(), log=lambda *a: None,
                          quarantine=sink, **kw)
    try:
        counters = loader.load_file(vep, commit=True)
    finally:
        sink.close()
    store.save(store_dir)
    return counters, loader, store


def _torch_vep(vep, store_dir, mp, config="python", **kw):
    _set_config(mp, config)
    store = TorchStore.load(store_dir)
    ledger = TorchLedger(os.path.join(store_dir, "ledger.jsonl"))
    sink = QuarantineSink(store_dir, vep, "load-vep")
    loader = VepLoader(store, ledger, ConsequenceRanker(), log=lambda *a: None,
                       quarantine=sink, device="cpu", **kw)
    try:
        counters = loader.load_file(vep, commit=True)
    finally:
        sink.close()
    store.save(store_dir)
    return counters, loader, store


def _counters(c):
    return {k: c.get(k) for k in COUNTER_KEYS}


def _quarantine(store_dir, vep):
    path = os.path.join(store_dir, "quarantine",
                        os.path.basename(vep) + ".rejects.jsonl")
    with open(path, "rb") as f:
        return f.read()


def _assert_same_store(dir_a, dir_b):
    files_a, files_b = _persisted_bytes(dir_a), _persisted_bytes(dir_b)
    assert list(files_a) == list(files_b)
    for name in files_a:
        assert files_a[name] == files_b[name], f"{name} bytes diverge"


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """The seeded inputs and both packages' VCF stores of them."""
    tmp = tmp_path_factory.mktemp("torch_vep")
    vcf, vep = _write_inputs(tmp)
    mp = pytest.MonkeyPatch()
    try:
        base_ref, base_torch = str(tmp / "base_ref"), str(tmp / "base_torch")
        _ref_vcf(vcf, base_ref, mp)
        _torch_vcf(vcf, base_torch)
    finally:
        mp.undo()
    return {"vcf": vcf, "vep": vep, "tmp": tmp, "base": (base_ref, base_torch)}


@pytest.fixture(scope="module", params=["python", "native"])
def runs(inputs, request):
    """In one VEP configuration: the VEP load through both packages at the
    default batch size and at batch_size=8, the port over the reference's
    own store, and a skip_existing second pass."""
    config = request.param
    vep, (base_ref, base_torch) = inputs["vep"], inputs["base"]
    tmp = inputs["tmp"] / config
    tmp.mkdir()
    mp = pytest.MonkeyPatch()
    out = {**inputs, "tmp": tmp, "config": config}
    try:
        for tag, kw in (("default", {}), ("batch8", {"batch_size": 8})):
            ref_dir, torch_dir = str(tmp / f"ref_{tag}"), str(tmp / f"torch_{tag}")
            shutil.copytree(base_ref, ref_dir)
            shutil.copytree(base_torch, torch_dir)
            c_ref, l_ref, _ = _ref_vep(vep, ref_dir, mp, config, **kw)
            c_torch, l_torch, _ = _torch_vep(vep, torch_dir, mp, config, **kw)
            out[tag] = {
                "counters": (c_ref, c_torch), "dirs": (ref_dir, torch_dir),
                "bytes": (_persisted_bytes(ref_dir), _persisted_bytes(torch_dir)),
                "added": (l_ref.parser.ranker.added, l_torch.parser.ranker.added),
                "loader": l_torch,
            }
        on_ref = str(tmp / "torch_on_ref")
        shutil.copytree(base_ref, on_ref)
        out["on_ref"] = (_torch_vep(vep, on_ref, mp, config)[0], on_ref)
        ref_dir, torch_dir = out["default"]["dirs"]
        out["second"] = (
            _ref_vep(vep, ref_dir, mp, config, skip_existing=True)[0],
            _torch_vep(vep, torch_dir, mp, config, skip_existing=True)[0],
        )
    finally:
        mp.undo()
    return out


def test_vcf_base_stores_identical(inputs):
    _assert_same_store(*inputs["base"])


@pytest.mark.parametrize("tag", ["default", "batch8"])
def test_vep_load_counters_match(runs, tag):
    c_ref, c_torch = runs[tag]["counters"]
    assert _counters(c_ref) == _counters(c_torch)
    added_ref, added_torch = runs[tag]["added"]
    assert added_ref == added_torch and len(added_torch) >= 2


@pytest.mark.parametrize("tag", ["default", "batch8"])
def test_vep_load_store_bytes_identical(runs, tag):
    files_ref, files_torch = runs[tag]["bytes"]
    assert list(files_ref) == list(files_torch)
    for name in files_ref:
        assert files_ref[name] == files_torch[name], f"{name} bytes diverge"
    ref_dir, torch_dir = runs[tag]["dirs"]
    assert _quarantine(ref_dir, runs["vep"]) == _quarantine(torch_dir, runs["vep"])
    assert (_ledger_records(os.path.join(ref_dir, "ledger.jsonl"))
            == _ledger_records(os.path.join(torch_dir, "ledger.jsonl")))


def test_vep_load_covers_every_path(runs):
    """The input reaches each counter-bearing path, two blocks, and (at
    batch_size=8) the row split; the identity step ran once per batch of
    the Python transform."""
    c = runs["default"]["counters"][1]
    assert c["update"] > 150 and c["not_found"] >= 20
    assert c["skipped"] >= 14 and c["rejected"] == 4
    default, batch8 = runs["default"]["loader"], runs["batch8"]["loader"]
    stats = default.transform_stats
    if runs["config"] == "python":
        assert default.identity_batches == 2  # one per 4 MiB block
        assert batch8.identity_batches > 10   # rows split at 2 * next_pow2(8)
        assert stats == {"native_rows": 0, "fallback_docs": 0, "restarts": 0,
                         "python_blocks": 2}
    else:
        # the Python transform takes only the six flagged docs: the four
        # broken lines (rejected there, no rows) and the two planted novel
        # combos (three rows; each learned, so each restarts the
        # transformer after it), one identity batch for each
        assert default.identity_batches == batch8.identity_batches == 2
        assert stats["fallback_docs"] == 6 and stats["restarts"] == 2
        assert stats["python_blocks"] == 0
        assert stats["native_rows"] + 3 == c["variant"]
        assert batch8.transform_stats == stats
    assert default.queue_stalls["ingest"]["items"] == 2
    assert default.probe_stats == {"host": default.probe_stats["host"]}
    over = [s for s in runs["default"]["bytes"][1].values()
            if b'"_long_alleles"' in s]
    assert over  # over-width rows exist in the store and were updated


def test_port_updates_reference_store(runs):
    """The port's VEP load over the reference's own VCF store writes the
    reference's VEP store; the reference opens and fscks it."""
    counters, on_ref = runs["on_ref"]
    ref_dir, _ = runs["default"]["dirs"]
    assert _counters(counters) == _counters(runs["default"]["counters"][0])
    files_ref = runs["default"]["bytes"][0]
    files = _persisted_bytes(on_ref)
    assert list(files) == list(files_ref)
    for name in files:
        assert files[name] == files_ref[name], f"{name} bytes diverge"
    assert VariantStore.load(on_ref).n == VariantStore.load(ref_dir).n > 0
    report = fsck(on_ref, deep=True, log=lambda m: None)
    assert report["status"] == "clean", report


def test_skip_existing_second_pass_matches(runs):
    c_ref, c_torch = runs["second"]
    assert _counters(c_ref) == _counters(c_torch)
    assert c_torch["update"] == 0 and c_torch["duplicates"] > 150
    ref_dir, torch_dir = runs["default"]["dirs"]
    files_ref, files_torch = runs["default"]["bytes"]
    assert _persisted_bytes(torch_dir) == files_torch
    assert _persisted_bytes(ref_dir) == files_ref


def _materialize(v):
    return v.fresh() if isinstance(v, RawJson) else v


def test_decoded_values_match_native_reference(runs, monkeypatch):
    """The reference's default path (the C++ transform, raw-JSON values)
    decodes to the same values as the port's store, row by row."""
    ref_dir = str(runs["tmp"] / "ref_native")
    shutil.copytree(runs["base"][0], ref_dir)
    c_nat, _, s_nat = _ref_vep(runs["vep"], ref_dir, monkeypatch, "native")
    c_torch = runs["default"]["counters"][1]
    for k in ("variant", "skipped", "update", "not_found", "line"):
        assert c_nat[k] == c_torch[k], k
    s_torch = VariantStore.load(runs["default"]["dirs"][1])
    assert set(s_nat.shards) == set(s_torch.shards)
    for code in s_nat.shards:
        a, b = s_nat.shard(code), s_torch.shard(code)
        a.compact(), b.compact()
        np.testing.assert_array_equal(a.cols["pos"], b.cols["pos"])
        np.testing.assert_array_equal(a.cols["row_algorithm_id"],
                                      b.cols["row_algorithm_id"])
        for col in JSONB_COLUMNS:
            av, bv = a.annotations[col], b.annotations[col]
            for i in range(a.n):
                assert _materialize(av[i]) == bv[i], (code, col, i)


# ---------------------------------------------------------------- parser


def _parser_docs():
    docs = copy.deepcopy(DOCS)
    docs.append(vep_result("1", 10039, "rs978760828", "A", "C", "C",
                           ["missense_variant", "splice_region_variant"],
                           freqs={"C": {"gnomad": 0.015, "af": 0.02}}))
    docs.append(vep_result("2", 955, "rs1234", "CA", "C", "-",
                           ["frameshift_variant"]))
    docs.append(vep_result("2", 960, "rs1235", "G", "T", "T",
                           ["stop_gained", "NMD_transcript_variant",
                            "intron_variant"]))  # a novel combo
    return docs


def test_parser_matches_reference():
    """rank_and_sort (in-place, key order included), frequencies,
    cleaned_result, most_severe_consequence and allele_consequences on the
    native-parity DOCS and the vep_result fixture, learn-on-miss included."""
    ref, port = RefParser(RefRanker()), VepResultParser(ConsequenceRanker())
    for a, b in zip(_parser_docs(), _parser_docs()):
        ref.rank_and_sort(a)
        port.rank_and_sort(b)
        assert json.dumps(b) == json.dumps(a)
        for vid in (None, a.get("colocated_variants", [{}])[0].get("id")):
            assert (VepResultParser.frequencies(b, vid)
                    == RefParser.frequencies(a, vid))
        assert (json.dumps(VepResultParser.cleaned_result(b))
                == json.dumps(RefParser.cleaned_result(a)))
        alleles = {k for key in a if key.endswith("_consequences")
                   for k in a[key]} | {"-", "Z"}
        for allele in sorted(alleles):
            assert (VepResultParser.most_severe_consequence(b, allele)
                    == RefParser.most_severe_consequence(a, allele))
            assert (VepResultParser.allele_consequences(b, allele)
                    == RefParser.allele_consequences(a, allele))
    assert port.ranker.added == ref.ranker.added and port.ranker.added
    assert port.ranker.version == ref.ranker.version


def test_prefetch_ranks_device_path_matches_host_ranker():
    """A flush with at least DEVICE_RANK_MIN novel combos resolves them
    through the rank table's device lookup (here the CPU); the memo then
    holds the host ranker's ranks."""
    from annotatedvdb_tpu_torch.io.vep import DEVICE_RANK_MIN

    port = VepResultParser(ConsequenceRanker())
    combos = list(port.ranker.rankings)
    assert len(combos) >= DEVICE_RANK_MIN
    ann = {"transcript_consequences": [
        {"consequence_terms": c.split(","), "variant_allele": "A"}
        for c in combos]}
    assert port.prefetch_ranks([ann]) == len(combos)
    for c in combos:
        assert port._rank_memo[c]["rank"] == port.ranker.rank_of(c)
        assert type(port._rank_memo[c]["rank"]) is int


# ------------------------------------------------------------- the store


def test_store_update_half_matches_reference(inputs, tmp_path):
    """update_annotation (fresh column, merge, duplicate ids, replace, -1
    ids), set_col, set_flag, get_col and get_ann on the same store through
    both packages: same values, same saved bytes."""
    ref_dir, torch_dir = str(tmp_path / "ref"), str(tmp_path / "torch")
    shutil.copytree(inputs["base"][0], ref_dir)
    shutil.copytree(inputs["base"][0], torch_dir)
    ref, port = VariantStore.load(ref_dir), TorchStore.load(torch_dir)
    for store in (ref, port):
        sh = store.shard(1)
        n = sh.n
        ids = np.array([0, 3, n - 1, 3, -1], np.int64)
        sh.update_annotation(ids[:3], "other_annotation",
                             [{"a": {"x": 1}}, {"b": 2}, {"c": [1]}])
        sh.update_annotation(ids, "other_annotation",
                             [{"a": {"y": 2}}, {"b": {"z": 1}}, [5],
                              {"b": {"w": 2}}, {"never": 1}])
        sh.update_annotation(ids[:2], "gwas_flags", [{"k": 1}, {"k": 2}],
                             merge=False)
        sh.update_annotation(ids[:2], "gwas_flags", [{"j": 1}, {"j": 2}],
                             merge=False)
        sh.set_col("row_algorithm_id", ids[:3], 7)
        sh.set_flag(ids, "is_adsp_variant", np.array([1, 0, 1, 1, 1], np.int8))
        with pytest.raises(ValueError, match="immutable"):
            sh.set_col("pos", ids[:1], 5)
    for code in ref.shards:
        a, b = ref.shard(code), port.shard(code)
        every = np.arange(a.n)
        for col in ("row_algorithm_id", "is_adsp_variant", "pos"):
            np.testing.assert_array_equal(a.get_col(col, every),
                                          b.get_col(col, every))
        for col in ("other_annotation", "gwas_flags", "vep_output"):
            for i in sorted({0, min(3, a.n - 1), a.n - 1}):
                assert b.get_ann(col, i) == a.get_ann(col, i)
    ref.save(ref_dir)
    port.save(torch_dir)
    _assert_same_store(ref_dir, torch_dir)


# ------------------------------------------------------------------- CLI


def test_cli_writes_reference_store(runs, tmp_path, monkeypatch, capsys):
    """``load-vep --platform cpu --commit`` through the port's CLI against
    the reference CLI, in the fixture's VEP configuration, on copies of one
    store: same store bytes, quarantine file, printed alg_id and ranking
    files saved on each learned combo."""
    from annotatedvdb_tpu.cli.load_vep import main as ref_main
    from annotatedvdb_tpu_torch.__main__ import main as torch_main
    from annotatedvdb_tpu_torch.conseq.ranker import DEFAULT_RANKING_FILE

    _set_config(monkeypatch, runs["config"])
    vep = runs["vep"]
    printed, ranks = {}, {}
    for tag in ("ref", "torch"):
        store_dir = str(tmp_path / f"store_{tag}")
        shutil.copytree(runs["base"][0], store_dir)
        rank_dir = tmp_path / f"ranks_{tag}"
        rank_dir.mkdir()
        shutil.copy(DEFAULT_RANKING_FILE, rank_dir / "ranks.txt")
        args = ["--fileName", vep, "--storeDir", store_dir, "--commit",
                "--datasource", "ADSP", "--rankingFile",
                str(rank_dir / "ranks.txt"), "--rankOnLoad",
                "--saveOnAddConsequence", "--logAfter", "0",
                "--platform", "cpu"]
        capsys.readouterr()
        if tag == "ref":
            assert ref_main(args) == 0
        else:
            assert torch_main(["load-vep"] + args) == 0
        printed[tag] = capsys.readouterr().out.strip().splitlines()[-1]
        ranks[tag] = {p.name: p.read_bytes() for p in sorted(rank_dir.iterdir())}
    assert printed["ref"] == printed["torch"] == "2"
    assert ranks["ref"] == ranks["torch"] and len(ranks["torch"]) >= 3
    ref_dir, torch_dir = str(tmp_path / "store_ref"), str(tmp_path / "store_torch")
    _assert_same_store(ref_dir, torch_dir)
    assert _quarantine(ref_dir, vep) == _quarantine(torch_dir, vep)
    assert (_ledger_records(os.path.join(ref_dir, "ledger.jsonl"))
            == _ledger_records(os.path.join(torch_dir, "ledger.jsonl")))


@pytest.mark.parametrize("flags", [
    ["--metricsOut", "m.prom"], ["--traceOut", "t.json"], ["--maxWorkers", "4"],
], ids=lambda f: f[0])
def test_cli_refuses_unported_flags(tmp_path, flags):
    from annotatedvdb_tpu_torch.cli.load_vep import main as torch_main

    with pytest.raises(SystemExit) as exc:
        torch_main(["--fileName", str(tmp_path / "x.json"), "--storeDir",
                    str(tmp_path / "vdb"), "--platform", "cpu", *flags])
    assert exc.value.code == 2
    assert not (tmp_path / "vdb").exists()


def test_cli_defaults_to_cuda_and_never_falls_back(inputs, tmp_path):
    import torch

    from annotatedvdb_tpu_torch.cli.load_vep import main as torch_main

    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    store_dir = str(tmp_path / "vdb")
    shutil.copytree(inputs["base"][1], store_dir)
    before = _persisted_bytes(store_dir)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        torch_main(["--fileName", inputs["vep"], "--storeDir", store_dir,
                    "--commit"])
    assert _persisted_bytes(store_dir) == before
