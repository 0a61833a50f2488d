"""The update legs' shared pieces against the JAX package: the identity
rule (``loaders/lookup.py``), the site columns of both engines' chunks,
``info_to_json``, ``_subset_chunk``, the shard's whole-column views and
the quarantine's late header.

Exact comparisons throughout (tolerance 0: hashes, lookups and text).
"""

import json
import os

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from annotatedvdb_tpu.io.vcf import VcfBatchReader as RefReader
from annotatedvdb_tpu.io.vcf import info_to_json as ref_info_to_json
from annotatedvdb_tpu.io.vcf import parse_info as ref_parse_info
from annotatedvdb_tpu.loaders.lookup import chunk_hashes as ref_chunk_hashes
from annotatedvdb_tpu.loaders.lookup import chunk_lookup as ref_chunk_lookup
from annotatedvdb_tpu.loaders.lookup import identity_hashes as ref_identity_hashes
from annotatedvdb_tpu.loaders.update_loader import _subset_chunk as ref_subset
from annotatedvdb_tpu.store import VariantStore
from annotatedvdb_tpu.utils.quarantine import QuarantineSink as RefSink

from annotatedvdb_tpu_torch.io.vcf import VcfBatchReader, info_to_json
from annotatedvdb_tpu_torch.loaders.lookup import (
    chunk_hashes,
    chunk_lookup,
    identity_hashes,
)
from annotatedvdb_tpu_torch.loaders.update_loader import _subset_chunk
from annotatedvdb_tpu_torch.native.vcf import LazyColumn
from annotatedvdb_tpu_torch.store import VariantStore as TorchStore
from annotatedvdb_tpu_torch.utils.quarantine import QuarantineSink
from test_torch_qc_update import base_sites, build_base, set_engine, write_qc_vcf

SITE_COLUMNS = ("info", "info_raw", "qual", "filter", "format")


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_lookup")
    sites = base_sites()
    qc = str(tmp / "qc.vcf")
    write_qc_vcf(qc, sites, novel_share=0.3)
    return {"base": build_base(sites, str(tmp / "base")), "qc": qc}


def _chunks(reader_cls, path, batch_size=64):
    return [c for c in reader_cls(path, batch_size=batch_size, width=49)
            if c.batch.n]


def _plain(column):
    return None if column is None else list(column)


# ------------------------------------------------------------ info_to_json


INFO_CASES = [
    "ABHet=0.5;AC=3", "RS=12;RSPOS=100;FREQ=GnomAD:0.5,0.25|TOPMED:.,0.1",
    "DP=100;VDB=1.3e-2;INDEL;MQ0F=0", "K=007;NEG=-5;PLUS=+12;UND=1_0",
    "S=INDEL;T=NA;U=GT:DP;EMPTY=;DOT=.", "WS= 12 ;TAB=\t3\t",
    "ESC=a\\x2cb;HASH=a#b;SLASH=c\\x59d", 'QUOTE="x";BACK=a\\b',
    "BIG=123456789012345678901234567890", "F=.5;G=5.;H=1e3;I=-1.5E-3",
    "MIXED=12ab;UNI=é", "NANISH=nankeeper;INFY=infinite", "X=abc\n", "X=5\n",
    "AC=1;AC=2", "AC=1;DP=9;AC=2", "FLAG;FLAG", "AC;AC=3", "AC=3;AC",
    "A=1;B=2;A=x;C=3;B=0.5", "X=1;X=1e400;X=2", "AB=inf;AB=1",
    "X=inf", "X=Infinity", "X=nan", "X=NaN", "X=-inf", "X= inf ", "X=1e400",
    "X=-1e999", "X=inf\n", "", ";;", "=", "=5;k=",
]


def _json_outcome(fn, s):
    try:
        return ("ok", fn(s))
    except ValueError as err:
        return ("error", type(err).__name__)


def test_info_to_json_matches_reference():
    """The reference's cases (fast paths, fallbacks, duplicate keys, the
    non-finite aborts): the same text, or the same error."""
    for s in INFO_CASES:
        assert _json_outcome(info_to_json, s) == _json_outcome(ref_info_to_json, s), s
    # the engines differ only in separators: compact here, spaced in the
    # Python engine's json.dumps of the dict
    assert info_to_json("AC=1;AB=0.5;AC=2;DB") == '{"AC":2,"AB":0.5,"DB":true}'
    assert json.dumps(ref_parse_info("AC=1;AB=0.5;AC=2;DB")) == \
        '{"AC": 2, "AB": 0.5, "DB": true}'


_TOKEN = st.text(alphabet="AC=;.,-+eE0123456789#_xnaifINF \\|:é\"", max_size=12)


@settings(max_examples=300, deadline=None, database=None)
@given(st.lists(st.tuples(st.sampled_from(["AC", "AF", "DB", "X", "é", "a b"]),
                          st.one_of(st.none(), _TOKEN)), max_size=6),
       _TOKEN)
def test_info_to_json_fuzzed(items, tail):
    """Fuzzed INFO strings (repeated keys, flags, numbers, escapes,
    non-ASCII, stray separators): the same text or the same error as the
    reference."""
    s = ";".join(k if v is None else f"{k}={v}" for k, v in items) + tail
    assert _json_outcome(info_to_json, s) == _json_outcome(ref_info_to_json, s)


# ------------------------------------------------------------ site columns


@pytest.mark.parametrize("engine", ["native", "python"])
def test_site_columns_match_reference(inputs, monkeypatch, engine):
    """``info``, ``info_raw``, ``qual``, ``filter`` and ``format`` of every
    chunk equal the reference's chunk's, in both engines."""
    set_engine(monkeypatch, engine)
    ours, theirs = _chunks(VcfBatchReader, inputs["qc"]), _chunks(RefReader, inputs["qc"])
    assert len(ours) == len(theirs) > 3
    for a, b in zip(ours, theirs):
        for name in SITE_COLUMNS:
            assert _plain(getattr(a, name)) == _plain(getattr(b, name)), name
    if engine == "native":
        assert isinstance(ours[0].info_raw, LazyColumn)
        assert any(q is None for c in ours for q in c.qual)
        assert any(r is None for c in ours for r in c.info_raw)
    else:
        assert all(c.info_raw is None for c in ours)


def test_empty_native_chunk_has_site_columns(tmp_path, monkeypatch):
    set_engine(monkeypatch, "native")
    vcf = tmp_path / "contig.vcf"
    vcf.write_text("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n"
                   "GL000219.1\t100\t.\tA\tC\t10\tPASS\tAC=1\n")
    (chunk,) = list(VcfBatchReader(str(vcf)))
    assert chunk.batch.n == 0 and chunk.counters["skipped_contig"] == 1
    assert [getattr(chunk, n) for n in SITE_COLUMNS] == [[], None, [], [], []]


# ------------------------------------------------------------ identity rule


@pytest.mark.parametrize("engine", ["native", "python"])
def test_chunk_hashes_match_reference(inputs, monkeypatch, engine):
    """Hashes equal the reference's on every row, over-width rows
    included: ``h_native`` (native) or the identity step, once a chunk
    (Python engine)."""
    from annotatedvdb_tpu_torch.ops import annotate_cuda

    set_engine(monkeypatch, engine)
    steps = []
    real = annotate_cuda.annotate_bin_identity_reference

    def step(*args):
        steps.append(args[0].shape[0])
        return real(*args)

    monkeypatch.setattr(annotate_cuda, "annotate_bin_identity_reference", step)
    ref_store, store = VariantStore(width=49), TorchStore(width=49)
    over, rows = 0, []
    for a, b in zip(_chunks(VcfBatchReader, inputs["qc"]),
                    _chunks(RefReader, inputs["qc"])):
        assert (a.h_native is None) == (engine == "python")
        np.testing.assert_array_equal(chunk_hashes(store, a, device="cpu"),
                                      ref_chunk_hashes(ref_store, b))
        over += int(((a.batch.ref_len > 49) | (a.batch.alt_len > 49)).sum())
        rows.append(a.batch.n)
    assert over >= 2
    assert steps == (rows if engine == "python" else [])


def test_identity_hashes_match_reference(inputs, monkeypatch):
    set_engine(monkeypatch, "python")
    for c in _chunks(VcfBatchReader, inputs["qc"])[:3]:
        b = c.batch
        args = (49, b.ref, b.alt, b.ref_len, b.alt_len)
        np.testing.assert_array_equal(identity_hashes(*args),
                                      ref_identity_hashes(*args))
        np.testing.assert_array_equal(
            identity_hashes(*args, refs=c.refs, alts=c.alts),
            ref_identity_hashes(*args, refs=c.refs, alts=c.alts))


@pytest.mark.parametrize("engine", ["native", "python"])
def test_chunk_lookup_matches_reference(inputs, tmp_path, monkeypatch, engine):
    """Per chromosome: the same rows, found flags and global ids; a
    chromosome the store lacks yields no shard and creates none."""
    set_engine(monkeypatch, engine)
    ref_store, store = VariantStore.load(inputs["base"]), TorchStore.load(inputs["base"])
    del ref_store.shards[2], store.shards[2]
    found_any = 0
    for a, b in zip(_chunks(VcfBatchReader, inputs["qc"]),
                    _chunks(RefReader, inputs["qc"])):
        ours = list(chunk_lookup(store, a, device="cpu"))
        theirs = list(ref_chunk_lookup(ref_store, b))
        assert [o[0] for o in ours] == [t[0] for t in theirs]
        for (code, shard, sel, found, idx), t in zip(ours, theirs):
            assert (shard is None) == (t[1] is None) == (code == 2)
            np.testing.assert_array_equal(sel, t[2])
            np.testing.assert_array_equal(found, t[3])
            np.testing.assert_array_equal(idx, t[4])
            found_any += int(found.sum())
    assert found_any > 100 and 2 not in store.shards


def test_subset_chunk_every_field(inputs, monkeypatch):
    """``_subset_chunk`` of a native chunk: every dataclass field equals
    the reference's subset of its own chunk."""
    import dataclasses

    set_engine(monkeypatch, "native")
    a = _chunks(VcfBatchReader, inputs["qc"], batch_size=128)[1]
    b = _chunks(RefReader, inputs["qc"], batch_size=128)[1]
    rows = [0, 3, 5, a.batch.n - 1, 3]
    sa, sb = _subset_chunk(a, rows), ref_subset(b, rows)
    assert sa.batch.n == len(rows) and sa.counters == {} == sb.counters
    for f in dataclasses.fields(sa):
        va = getattr(sa, f.name)
        vb = getattr(sb, f.name)
        if f.name == "batch":
            for x, y in zip(va, vb):
                np.testing.assert_array_equal(x, y)
        elif isinstance(va, np.ndarray):
            np.testing.assert_array_equal(va, vb)
        elif isinstance(va, bool):  # alleles_packable: a chunk-level flag
            assert va == vb, f.name
        else:
            assert _plain(va) == _plain(vb), f.name
    assert sa.filter == [a.filter[i] for i in rows]
    assert sa.h_native.tolist() == [int(a.h_native[i]) for i in rows]


# ------------------------------------------------------------ store, sink


def test_shard_column_views_match_reference(inputs):
    ref_store, store = VariantStore.load(inputs["base"]), TorchStore.load(inputs["base"])
    for code, shard in store.shards.items():
        for name in ("pos", "ref_snp", "h"):
            np.testing.assert_array_equal(shard.column(name),
                                          ref_store.shards[code].column(name))
        assert (shard.object_column("_digest_pk").tolist()
                == ref_store.shards[code].object_column("_digest_pk").tolist())
    empty = store.shard(25)
    assert empty.column("pos").shape == (0,) and empty.object_column("adsp_qc").size == 0


def test_quarantine_late_header(tmp_path):
    """A header bound after the sink is built lands in its meta record."""
    for Sink, d in ((QuarantineSink, "port"), (RefSink, "ref")):
        sink = Sink(str(tmp_path / d), "in.tsv", "update-variant-annotation")
        sink.set_header("variant\tgwas_flags")
        sink.reject(3, "1:1\t{", "bad")
        sink.close()
    read = [open(os.path.join(tmp_path, d, "quarantine", "in.tsv.rejects.jsonl"),
                 "rb").read() for d in ("port", "ref")]
    assert read[0] == read[1]
    assert json.loads(read[0].splitlines()[0])["meta"]["header"] == "variant\tgwas_flags"
