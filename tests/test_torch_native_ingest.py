"""The port's native VCF tokenizer against the JAX package's.

The same seeded VCFs (plain and gzip) go through the reference's
``native/vcf.py::iter_native_chunks`` and the port's, with ``READ_SIZE``
shrunk to 16 KiB on both sides so that read windows cut chunks.  Every
array column, the in-scan hash ``h_native``, line numbers, counters and
the lazy sidecar columns must be equal, exactly (tolerance 0: integer
columns and strings); the FREQ sidecar compares as JSON text.  Also: the
in-scan hash against the reference's ``allele_hash_jit`` and the port's
plain ``allele_hash``, ``freq_sidecar`` against the reference's, a line
with more alts than the row buffer, a trailing counters-only chunk, and
the engine routing — a failed native build under ``auto`` raises and
never reads with the Python tokenizer.
"""

import gzip
import os
import re
import shutil

import numpy as np
import pytest
import torch

from annotatedvdb_tpu.io.vcf import freq_sidecar as ref_freq_sidecar
from annotatedvdb_tpu.native import vcf as ref_native_vcf
from annotatedvdb_tpu.ops.hashing import allele_hash_jit

from annotatedvdb_tpu_torch import native
from annotatedvdb_tpu_torch.io.vcf import VcfBatchReader, freq_sidecar
from annotatedvdb_tpu_torch.native import vcf as port_native_vcf
from annotatedvdb_tpu_torch.ops.hashing import allele_hash, hash_bits, to_uint32
from test_ingest_spine import FREQ_CASES
from test_torch_load_vcf import _write_vcf

WINDOW = 16 << 10
ARRAY_COLUMNS = ("line_number", "is_multi_allelic", "rs_number", "rs_weird",
                 "id_verbatim", "has_freq", "h_native")
LAZY_COLUMNS = ("refs", "alts", "variant_id", "ref_snp", "rs_position")


@pytest.fixture
def small_windows(monkeypatch):
    monkeypatch.setattr(ref_native_vcf, "READ_SIZE", WINDOW)
    monkeypatch.setattr(port_native_vcf, "READ_SIZE", WINDOW)


def _text(v):
    return None if v is None else v.text


def _assert_same_chunks(path, batch, width=49):
    ref = list(ref_native_vcf.iter_native_chunks(path, batch, width, False,
                                                 False))
    got = list(port_native_vcf.iter_native_chunks(path, batch, width))
    assert len(got) == len(ref)
    for a, b in zip(ref, got):
        assert b.counters == a.counters
        for name in a.batch._fields:
            np.testing.assert_array_equal(getattr(b.batch, name),
                                          getattr(a.batch, name), err_msg=name)
        for name in ARRAY_COLUMNS:
            if getattr(a, name) is None:
                assert getattr(b, name) is None, name
            else:
                np.testing.assert_array_equal(getattr(b, name),
                                              getattr(a, name), err_msg=name)
        for name in LAZY_COLUMNS:
            assert list(getattr(b, name)) == list(getattr(a, name)), name
        assert [_text(v) for v in b.frequencies] == \
            [_text(v) for v in a.frequencies]
    return got


@pytest.mark.parametrize("gz", [False, True], ids=["plain", "gzip"])
def test_native_chunks_match_reference(tmp_path, small_windows, gz):
    path = str(tmp_path / "w.vcf")
    _write_vcf(path, n_lines=3000, seed=31)
    if gz:
        with open(path, "rb") as src, gzip.open(path + ".gz", "wb") as dst:
            shutil.copyfileobj(src, dst)
        path += ".gz"
    chunks = _assert_same_chunks(path, 256)
    sizes = [c.batch.n for c in chunks]
    # windows cut chunks: short chunks before the last one
    assert sum(0 < n < 256 for n in sizes[:-2]) >= 3, sizes
    assert any(c.has_freq.any() for c in chunks)
    assert any(int(c.batch.ref_len.max()) > 49 for c in chunks if c.batch.n)


def test_native_hash_matches_both_plain_hashes(tmp_path, small_windows):
    path = str(tmp_path / "h.vcf")
    _write_vcf(path, n_lines=1500, seed=32)
    for chunk in VcfBatchReader(path, batch_size=200, engine="native"):
        if chunk.batch.n == 0:
            continue
        b = chunk.batch
        want = np.asarray(allele_hash_jit(b.ref, b.alt, b.ref_len, b.alt_len))
        np.testing.assert_array_equal(chunk.h_native, want)
        plain = allele_hash(*(torch.from_numpy(x)
                              for x in (b.ref, b.alt, b.ref_len, b.alt_len)))
        np.testing.assert_array_equal(chunk.h_native,
                                      to_uint32(hash_bits(plain)))


@pytest.mark.parametrize("info,n_alts", FREQ_CASES)
def test_freq_sidecar_matches_reference(info, n_alts):
    got, want = freq_sidecar(info, n_alts), ref_freq_sidecar(info, n_alts)
    assert [_text(v) for v in got] == [_text(v) for v in want]


def _write(path, lines):
    with open(path, "w") as fh:
        fh.write("##fileformat=VCFv4.2\n"
                 "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n")
        fh.writelines(line + "\n" for line in lines)


def test_line_wider_than_the_buffer_grows_it(tmp_path):
    """A site with more alts than the row buffer: the scanner doubles the
    buffer and keeps the line whole (a chunk larger than batch_size)."""
    path = str(tmp_path / "g.vcf")
    alts = ",".join(f"A{'C' * i}" for i in range(1, 10))
    _write(path, ["1\t100\trs1\tA\tC\t.\t.\t.",
                  f"1\t200\trs2\tA\t{alts}\t.\t.\tFREQ=X:0.1,{','.join(['0.01'] * 9)}",
                  "1\t300\trs3\tA\tG\t.\t.\t."])
    chunks = _assert_same_chunks(path, 4)
    # the grown buffer (16 rows) keeps the next line too
    assert [c.batch.n for c in chunks] == [1, 10]


def test_over_width_malformed_and_trailing_counters(tmp_path, monkeypatch):
    """Over-width alleles keep their full strings and true lengths;
    malformed lines and unplaceable contigs after the last row (here in
    later 64-byte windows) ride a zero-row chunk so the totals
    reconcile."""
    monkeypatch.setattr(ref_native_vcf, "READ_SIZE", 64)
    monkeypatch.setattr(port_native_vcf, "READ_SIZE", 64)
    path = str(tmp_path / "t.vcf")
    _write(path, [f"2\t10\t.\tA{'G' * 80}\tA\t.\t.\tRS=9;RSPOS=10",
                  "2\t20\trs5\tA\tT,.\t.\t.\t.",
                  "2\tnot_a_pos\t.\tA\tC\t.\t.\t.",
                  "weird_contig_name\t30\t.\tA\tC\t.\t.\t.",
                  "2\t40",
                  "another_weird_contig\t50\t.\tA\tC\t.\t.\t."])
    chunks = _assert_same_chunks(path, 8)
    assert [c.batch.n for c in chunks] == [2, 0]
    assert chunks[0].refs[0] == "A" + "G" * 80
    assert chunks[0].batch.ref_len[0] == 81
    assert chunks[0].rs_position[0] == 10 and chunks[0].ref_snp[0] == "rs9"
    totals = {k: sum(c.counters[k] for c in chunks) for k in chunks[0].counters}
    assert totals == {"line": 6, "skipped_contig": 2, "skipped_alt": 1,
                      "malformed": 2}


def test_engine_routing(tmp_path, monkeypatch):
    path = str(tmp_path / "r.vcf")
    _write(path, ["1\t100\trs1\tA\tC\t.\t.\t."])
    monkeypatch.delenv("AVDB_INGEST_ENGINE", raising=False)
    (chunk,) = VcfBatchReader(path)
    assert chunk.h_native is not None  # auto reads with the native engine
    monkeypatch.setenv("AVDB_INGEST_ENGINE", "python")
    (chunk,) = VcfBatchReader(path)
    assert chunk.h_native is None
    monkeypatch.delenv("AVDB_INGEST_ENGINE")
    # an accession map routes auto to the Python scanner; native refuses it
    (chunk,) = VcfBatchReader(path, chromosome_map={"NC_1": "1"})
    assert chunk.h_native is None
    with pytest.raises(RuntimeError, match="chromosome_map"):
        list(VcfBatchReader(path, engine="native", chromosome_map={}))
    with pytest.raises(ValueError, match="unknown engine"):
        VcfBatchReader(path, engine="rust")


def test_failed_native_build_raises_under_auto(tmp_path, monkeypatch):
    """No quiet fallback: with a source that does not compile, ``auto``
    raises with the compiler's stderr, from the reader and from the load,
    and no chunk is read with the Python tokenizer."""
    from annotatedvdb_tpu_torch.loaders import VcfLoader
    from annotatedvdb_tpu_torch.store import AlgorithmLedger, VariantStore

    bad = tmp_path / "broken.cpp"
    bad.write_text("int avdb_parse_vcf_chunk( { this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", str(bad))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.delenv("AVDB_INGEST_ENGINE", raising=False)
    path = str(tmp_path / "b.vcf")
    _write(path, ["1\t100\trs1\tA\tC\t.\t.\t."])
    with pytest.raises(RuntimeError, match="native tokenizer build failed:\n.*error"):
        list(VcfBatchReader(path))
    store = VariantStore(width=49)
    loader = VcfLoader(store, AlgorithmLedger(str(tmp_path / "ledger.jsonl")),
                       log=lambda *a: None, device="cpu")
    with pytest.raises(RuntimeError, match="native tokenizer build failed"):
        loader.load_file(path, commit=True)
    loader.close()
    assert store.n == 0 and loader.counters["line"] == 0


def test_tokenizer_source_is_the_reference_but_for_comments():
    """The port's copy of the C++ tokenizer differs from the reference's
    source in comments alone, so its in-scan hash stays the twin."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

    def code(path):
        with open(path) as f:
            return [re.sub(r"\s*//.*$", "", line) for line in f]

    ref = code(os.path.join(root, "native", "avdb_native.cpp"))
    assert code(native.SOURCE) == ref and len(ref) > 400
