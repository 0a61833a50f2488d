"""The reference genome (``index-genome``, ``load-vcf --refGenome``): the
PyTorch port against the JAX package.

- ``ReferenceGenome.from_fasta`` on the fixture FASTA of
  ``tests/test_refgenome.py`` and on a seeded FASTA (lowercase and N runs,
  IUPAC codes, ragged lines, a duplicate header, a ``chrUn_*`` record):
  the same arrays and dicts; ``save``/``load`` across the two packages and
  uncompressed; ``fetch``, the sequence digests and ``lazy_digests``.
- ``validate_ref_reference`` (the CPU path of the ``validate_ref``
  wrapper) against the reference's jitted ``validate_ref_kernel`` on
  CPU-JAX: the edge rows of ``chip_smoke.validate_edge_rows`` at W = 16,
  31, 32, 33, 49, 64, 65 and 96, 20,000 seeded rows and 5,000 seeded
  position-sorted rows on one chromosome; ``validate_ref_batch`` with
  over-width rows re-validated on the host.
- ``load-vcf --refGenome`` through the port's CLI (``--platform cpu``)
  against the reference's CLI, under both tokenizer engines and two
  ``--commitAfter`` sizes, on a VCF with planted mismatches, lowercase and
  N refs, spans across chromosome ends, an absent chromosome and
  over-width rows with valid, swapped and invalid refs (the digest-PK
  fallback): store bytes, ledger records, counters, the mapping sidecar
  and the mismatch log lines.

Every comparison is exact.
"""

import gzip
import os

import numpy as np
import pytest
import torch

from annotatedvdb_tpu.genome import ReferenceGenome as RefGenome
from annotatedvdb_tpu.genome.refgenome import validate_ref_batch as ref_validate_batch
from annotatedvdb_tpu.genome.refgenome import validate_ref_kernel
from annotatedvdb_tpu.native import vcf as ref_native_vcf
from annotatedvdb_tpu.types import VariantBatch as RefBatch

from annotatedvdb_tpu_torch.genome import ReferenceGenome
from annotatedvdb_tpu_torch.genome import refgenome as port_rg
from annotatedvdb_tpu_torch.native import vcf as port_native_vcf
from annotatedvdb_tpu_torch.types import VariantBatch
from chip_smoke import validate_edge_rows, validate_random_rows
from test_refgenome import FASTA as FIXTURE_FASTA
from test_torch_load_vcf import _ledger_records, _persisted_bytes

ENGINES = ("native", "python")
WINDOW = 8 << 10
IUPAC = "RYKMSWBDHV"

# seeded FASTA records: (header, length, IUPAC codes) in file order; the
# second ``chr1`` is a duplicate header (ignored), ``chrUn_*`` is skipped
RECORDS = (("chr1 seeded", 20_000, False), ("2", 3_000, False),
           ("chrUn_gl000220", 500, False), ("chr3", 1_500, True),
           ("chr1", 100, False), ("chrX", 5_000, False), ("MT", 300, False))


def write_seeded_fasta(path, seed=5) -> dict:
    """The seeded FASTA at ``path`` (gzip when it ends in .gz); returns
    {header name: uppercase text with every non-ACGT base as N} of each
    record, the first of a duplicated name kept."""
    rng = np.random.default_rng(seed)
    texts, parts = {}, []
    for header, n, iupac in RECORDS:
        seq = np.array(list("ACGT"))[rng.integers(0, 4, n)]
        for s in rng.integers(0, n - 60, 4):
            seq[s: s + int(rng.integers(1, 60))] = "N"
        if iupac:
            seq[rng.integers(0, n, 12)] = np.array(list(IUPAC))[rng.integers(0, 10, 12)]
        shown = seq.copy()
        for s in rng.integers(0, max(n - 400, 1), 6):
            k = int(rng.integers(1, 400))
            shown[s: s + k] = np.char.lower(shown[s: s + k])
        body = "".join(shown)
        cuts = np.cumsum(rng.integers(1, 90, n))
        cuts = [0] + [int(c) for c in cuts if c < n] + [n]
        parts.append(f">{header}\n" + "".join(
            body[a:b] + "\n" for a, b in zip(cuts, cuts[1:])))
        name = header.split()[0]
        texts.setdefault(name, "".join(
            b if b in "ACGT" else "N" for b in seq))
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "wt") as f:
        f.write("".join(parts))
    return texts


@pytest.fixture(scope="module")
def fastas(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("refgenome")
    fixture = str(tmp / "fixture.fa.gz")
    with gzip.open(fixture, "wt") as f:
        f.write(FIXTURE_FASTA)
    seeded = str(tmp / "seeded.fa")
    texts = write_seeded_fasta(seeded)
    return {"fixture": fixture, "seeded": seeded, "texts": texts, "tmp": tmp}


@pytest.fixture(scope="module")
def genomes(fastas):
    path = fastas["seeded"]
    return RefGenome.from_fasta(path), ReferenceGenome.from_fasta(path)


def _assert_same_genome(ref, port):
    np.testing.assert_array_equal(port.packed, ref.packed)
    np.testing.assert_array_equal(port.n_mask, ref.n_mask)
    assert port.packed.dtype == ref.packed.dtype == np.uint8
    for name in ("byte_offset", "mask_offset", "length", "lossy", "_digests"):
        assert getattr(port, name) == getattr(ref, name), name


@pytest.mark.parametrize("which", ["fixture", "seeded"])
def test_from_fasta_matches_reference(fastas, which):
    ref = RefGenome.from_fasta(fastas[which])
    port = ReferenceGenome.from_fasta(fastas[which])
    _assert_same_genome(ref, port)
    if which == "seeded":
        assert port.length == {1: 20_000, 2: 3_000, 3: 1_500, 23: 5_000, 25: 300}
        assert port.lossy == {1: False, 2: False, 3: True, 23: False, 25: False}


@pytest.mark.parametrize("direction", ["reference-to-port", "port-to-reference",
                                       "uncompressed"])
def test_save_load_across_packages(genomes, tmp_path, direction):
    ref, port = genomes
    ref.sequence_digest(2)  # a cached digest travels in the meta
    port.sequence_digest(2)
    path = str(tmp_path / "g.npz")
    if direction == "reference-to-port":
        ref.save(path)
        _assert_same_genome(ref, ReferenceGenome.load(path))
    elif direction == "port-to-reference":
        port.save(path)
        _assert_same_genome(RefGenome.load(path), port)
    else:  # np.savez with the same keys, as chip_smoke writes its genome
        compressed = str(tmp_path / "ref.npz")
        ref.save(compressed)
        with np.load(compressed) as z:
            np.savez(path, **{k: z[k] for k in ("packed", "n_mask", "meta")})
        with open(path, "rb") as f:
            assert port.packed.tobytes() in f.read()  # stored, not deflated
        _assert_same_genome(RefGenome.load(path[:-4]), ReferenceGenome.load(path))


def test_fetch_and_digests_match_reference(genomes, fastas):
    ref, port = genomes
    rng = np.random.default_rng(3)
    for code in sorted(port.length):
        n = port.length[code]
        for _ in range(60):
            a = int(rng.integers(-10, n + 10))
            b = a + int(rng.integers(-2, 120))
            assert port.fetch(code, a, b) == ref.fetch(code, a, b)
        assert port.sequence_digest(code) == ref.sequence_digest(code)
    texts = fastas["texts"]
    assert port.fetch("chr1", 0, 20_000) == texts["chr1"]
    assert port.fetch("X", 0, 5_000) == texts["chrX"]
    with pytest.raises(KeyError):
        port.fetch("Y", 0, 5)
    fresh = ReferenceGenome.from_fasta(fastas["seeded"])
    assert fresh.sequence_digests() == RefGenome.from_fasta(
        fastas["seeded"]).sequence_digests()
    lazy, ref_lazy = port.lazy_digests(), ref.lazy_digests()
    for label in ("1", "chr1", "2", "3", "X", "M", "MT", "Y", "22"):
        assert (label in lazy) == (label in ref_lazy), label
        if label in lazy:
            assert lazy[label] == ref_lazy[label]
    assert "3" not in lazy  # lossy: IUPAC codes
    with pytest.raises(KeyError):
        lazy["3"]


def _both(genomes, rows):
    """The rows through the reference's jitted kernel (CPU-JAX) and the
    port's wrapper on CPU tensors."""
    import jax

    ref, port = genomes
    chrom, pos, refs, rlen = rows[:4]
    want = np.asarray(jax.jit(validate_ref_kernel)(
        *ref.device_arrays(), chrom, pos, refs, rlen))
    got = port_rg.validate_ref(
        *port.device_arrays("cpu"),
        *(torch.from_numpy(np.ascontiguousarray(x)) for x in (chrom, pos, refs, rlen)))
    assert got.dtype == torch.bool
    return want, got.numpy()


@pytest.mark.parametrize("width", [16, 31, 32, 33, 49, 64, 65, 96])
def test_validate_edge_rows_match_reference(genomes, width):
    rows = validate_edge_rows(genomes[1], width)
    want, got = _both(genomes, rows)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, rows[4])


@pytest.mark.parametrize("width", [16, 49])
def test_validate_random_rows_match_reference(genomes, width):
    rows = validate_random_rows(genomes[1], 20_000, width, seed=width)
    want, got = _both(genomes, rows)
    np.testing.assert_array_equal(got, want)
    assert 0.55 < got.mean() < 0.85


@pytest.mark.parametrize("width", [16, 49, 65])
def test_validate_sorted_rows_match_reference(genomes, width):
    """The rows of a load's chunk (one chromosome, position-sorted, the
    random rows' mix of lengths and mismatches), as phase 3's
    ``chunk_sorted`` shape times them."""
    rows = validate_random_rows(genomes[1], 5_000, width, seed=width, code=1)
    # 3% move to an absent code, the rest stay on chromosome 1
    assert np.unique(rows[0]).tolist() == [1, 4] and (rows[0] == 1).mean() > 0.95
    assert (np.diff(rows[1]) >= 0).all()
    want, got = _both(genomes, rows)
    np.testing.assert_array_equal(got, want)
    assert 0.55 < got.mean() < 0.85


def test_validate_ref_batch_over_width_rows_match_reference(genomes, fastas):
    """Rows wider than the batch re-validate on the host from ``refs``:
    valid, wrong, clipped at the chromosome's end, on an absent code (kept
    from the device result), lowercase."""
    ref, port = genomes
    t1, t2 = fastas["texts"]["chr1"], fastas["texts"]["2"]
    variants = [
        ("1", 21, t1[20:60], "A"), ("1", 21, "G" * 40, "A"),
        ("2", 2_981, t2[2_980:], "T"), ("2", 2_981, t2[2_980:] + "AC", "T"),
        ("5", 10, "A" * 30, "C"), ("1", 101, t1[100:130].lower(), "C"),
        ("1", 5, t1[4:9], "A"), ("1", 5, "TTTTT", "A"), ("X", 1, "N", "A"),
    ]
    refs = [v[2] for v in variants]
    want = ref_validate_batch(ref, RefBatch.from_tuples(variants, width=16), refs)
    got = port_rg.validate_ref_batch(
        port, VariantBatch.from_tuples(variants, width=16), refs, device="cpu")
    np.testing.assert_array_equal(got, want)
    assert got.tolist()[:4] == [True, False, True, False]
    no_refs = port_rg.validate_ref_batch(
        port, VariantBatch.from_tuples(variants, width=16), device="cpu")
    np.testing.assert_array_equal(no_refs, ref_validate_batch(
        ref, RefBatch.from_tuples(variants, width=16)))


def test_wrapper_counts_plain_calls_and_refuses_other_devices(genomes):
    """A CPU tensor takes the plain version (counted by device type, never
    as a launch); a tensor on another device never does: the wrapper
    raises before any launch.  The device tables cache per device, with
    length 0 for absent codes."""
    port = genomes[1]
    arrays = port.device_arrays("cpu")
    assert port.device_arrays(torch.device("cpu")) is arrays
    lengths = arrays[4].numpy()
    assert lengths.dtype == np.int32 and lengths.shape == (26,)
    assert lengths[0] == lengths[4] == lengths[24] == 0 and lengths[1] == 20_000
    rows = [torch.from_numpy(x) for x in validate_edge_rows(port, 16)[:4]]
    calls, launches = dict(port_rg.CALLS), dict(port_rg.LAUNCHES)
    port_rg.validate_ref(*arrays, *rows)
    assert port_rg.CALLS["cpu"] == calls["cpu"] + 1
    assert port_rg.LAUNCHES == launches
    meta = [torch.empty(t.shape, dtype=t.dtype, device="meta")
            for t in (*arrays, *rows)]
    with pytest.raises(ValueError, match="unsupported device"):
        port_rg.validate_ref(*meta)
    assert port_rg.LAUNCHES == launches
    assert port_rg.CALLS["cuda"] == calls["cuda"]


# ------------------------------------------------------------- the load


def write_genome_vcf(path, texts, seed=17) -> int:
    """A position-sorted VCF over the seeded genome: SNVs, deletions and
    insertions whose refs come from the genome, ~10% with one base
    changed, lowercase refs, refs on N runs, multi-allelic sites, '.'
    alts, duplicate lines, a malformed line, spans at and across each
    chromosome's end and past it, lines on chromosome 5 (absent from the
    genome), and over-width and >50bp rows with valid, swapped and
    invalid refs (not on chromosome 5).  Returns the data lines
    written."""
    rng = np.random.default_rng(seed)
    lines = []

    def other(b):
        return "ACGT"[("ACGT".index(b) + 1) % 4] if b in "ACGT" else "A"

    for label, key in (("1", "chr1"), ("2", "2"), ("3", "chr3"), ("5", None),
                       ("X", "chrX")):
        text = texts[key] if key else "ACGT" * 1000
        n = len(text)
        pos = 1
        chrom_lines = []
        while True:
            pos += int(rng.integers(1, 40))
            if pos + 80 >= n:
                break
            u = rng.random()
            k = 1 if u < 0.6 else int(rng.integers(2, 7))
            ref = text[pos - 1: pos - 1 + k]
            v = rng.random()
            if v < 0.10:
                j = int(rng.integers(0, len(ref)))
                ref = ref[:j] + other(ref[j]) + ref[j + 1:]
            if u >= 0.9:
                alt = ref[0] + "".join("ACGT"[int(i)] for i in rng.integers(0, 4, 3))
            elif k > 1:
                alt = ref[0]
            else:
                alt = other(ref)
            if 0.10 <= v < 0.15:
                ref = ref.lower()
            if rng.random() < 0.05 and len(ref) == 1:
                alt += "," + ("T" if "T" not in (ref.upper(), alt) else "G")
            elif rng.random() < 0.01:
                alt = "."
            # no digest-PK rows on the absent chromosome: the reference's
            # digester raises KeyError there, which aborts its load
            w = rng.random() if key else 1.0
            if w < 0.015:  # over-width ref from the genome, or wrong
                ref = text[pos - 1: pos + 59]
                if w < 0.005:
                    ref = other(ref[0]) + ref[1:]
                alt = ref[0]
            elif w < 0.025:  # >50bp combined: valid, swapped, invalid
                g = text[pos - 1: pos + 29]
                r = "".join("ACGT"[int(i)] for i in rng.integers(0, 4, 30))
                ref, alt = ((g, r) if w < 0.018 else (r, g) if w < 0.022 else (r, r[::-1]))
            chrom_lines.append(f"{label}\t{pos}\trs{len(lines) + len(chrom_lines)}"
                               f"\t{ref}\t{alt}\t.\t.\t.\n")
            if rng.random() < 0.01:
                chrom_lines.append(chrom_lines[-1])
        # at and across the end, and past it
        chrom_lines += [
            f"{label}\t{n - 2}\t.\t{text[n - 3:]}\tA\t.\t.\t.\n",
            f"{label}\t{n}\t.\t{text[n - 1:]}{text[n - 1:]}\t{text[n - 1:]}\t.\t.\t.\n",
            f"{label}\t{n + 2}\t.\tA\tC\t.\t.\t.\n",
        ]
        lines += chrom_lines
    with open(path, "w") as fh:
        fh.write("##fileformat=VCFv4.2\n#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n")
        fh.writelines(lines[:100])
        fh.write("1\tnot_a_pos\t.\tA\tC\t.\t.\t.\n")
        fh.writelines(lines[100:])
    return len(lines)


@pytest.fixture(scope="module")
def load_inputs(fastas, genomes):
    tmp = fastas["tmp"]
    index = str(tmp / "seeded.npz")
    genomes[0].save(index)  # the reference's index, read by both CLIs
    vcf = str(tmp / "genome.vcf")
    n_lines = write_genome_vcf(vcf, fastas["texts"])
    return {"index": index, "vcf": vcf, "n_lines": n_lines, "tmp": tmp}


def _mismatch_lines(log_path):
    with open(log_path) as f:
        return [ln.split(" INFO ", 1)[1] for ln in f
                if "ref-allele mismatches" in ln]


def _run_load(pkg, load_inputs, store_dir, commit_after, capsys):
    from annotatedvdb_tpu.cli.load_vcf import main as ref_main

    from annotatedvdb_tpu_torch.__main__ import main as port_main

    vcf = load_inputs["vcf"]
    log = f"{store_dir}.log"
    args = ["--fileName", vcf, "--storeDir", store_dir, "--commit",
            "--commitAfter", str(commit_after), "--logAfter", "0",
            "--logFilePath", log, "--refGenome", load_inputs["index"],
            "--maxWorkers", "off"]
    capsys.readouterr()
    if pkg == "ref":
        assert ref_main(args) == 0
    else:
        assert port_main(["load-vcf", *args, "--platform", "cpu"]) == 0
    printed = capsys.readouterr().out.strip().splitlines()[-1]
    with open(vcf + ".mapping", "rb") as f:
        mapping = f.read()
    quarantine = os.path.join(store_dir, "quarantine", "genome.vcf.rejects.jsonl")
    with open(quarantine, "rb") as f:
        rejects = f.read()
    return {"printed": printed, "mapping": mapping, "rejects": rejects,
            "files": _persisted_bytes(store_dir),
            "ledger": _ledger_records(os.path.join(store_dir, "ledger.jsonl")),
            "log": _mismatch_lines(log)}


@pytest.mark.parametrize("commit_after", [128, 65_536])
@pytest.mark.parametrize("engine", ENGINES)
def test_load_vcf_ref_genome_matches_reference(load_inputs, tmp_path, monkeypatch,
                                               capsys, engine, commit_after):
    if engine == "python":
        monkeypatch.setenv("AVDB_INGEST_ENGINE", "python")
    else:
        monkeypatch.delenv("AVDB_INGEST_ENGINE", raising=False)
    monkeypatch.setattr(ref_native_vcf, "READ_SIZE", WINDOW)
    monkeypatch.setattr(port_native_vcf, "READ_SIZE", WINDOW)
    ref = _run_load("ref", load_inputs, str(tmp_path / "ref"), commit_after, capsys)
    port = _run_load("port", load_inputs, str(tmp_path / "port"), commit_after, capsys)
    assert port["printed"] == ref["printed"]
    assert list(port["files"]) == list(ref["files"])
    for name in ref["files"]:
        assert port["files"][name] == ref["files"][name], f"{name} bytes diverge"
    assert port["ledger"] == ref["ledger"]
    assert port["mapping"] == ref["mapping"]
    assert port["rejects"] == ref["rejects"]
    assert port["log"] == ref["log"] and port["log"]
    counters = [r for r in port["ledger"] if r["type"] == "finish"][-1]["counters"]
    assert counters["ref_mismatch"] > 50 and counters["variant"] > 500
    segments = b"".join(port["files"].values())
    assert b'"_digest_pk"' in segments and b'"_long_alleles"' in segments


@pytest.mark.parametrize("digests", [False, True], ids=["plain", "digests"])
def test_index_genome_cli_matches_reference(fastas, tmp_path, monkeypatch, capsys,
                                            digests):
    """``index-genome`` prints the reference CLI's lines and writes an index
    each package loads equal to the reference CLI's."""
    from annotatedvdb_tpu.cli.index_genome import main as ref_main

    from annotatedvdb_tpu_torch.__main__ import main as port_main

    monkeypatch.setenv("AVDB_JAX_PLATFORM", "cpu")  # the reference pins it
    flags = ["--digests"] if digests else []
    printed = {}
    for pkg in ("ref", "port"):
        out = str(tmp_path / f"{pkg}.npz")
        capsys.readouterr()
        argv = ["--fasta", fastas["seeded"], "--output", out, *flags]
        assert (ref_main(argv) if pkg == "ref"
                else port_main(["index-genome", *argv])) == 0
        printed[pkg] = capsys.readouterr().out.replace(out, "<out>")
    assert printed["port"] == printed["ref"]
    assert ("chr3: SQ." in printed["port"]) == digests
    _assert_same_genome(RefGenome.load(str(tmp_path / "ref.npz")),
                        ReferenceGenome.load(str(tmp_path / "port.npz")))


def test_index_genome_refuses_a_fasta_without_standard_chromosomes(tmp_path):
    from annotatedvdb_tpu_torch.cli.index_genome import main

    fasta = tmp_path / "un.fa"
    fasta.write_text(">chrUn_x\nACGT\n")
    with pytest.raises(SystemExit) as exc:
        main(["--fasta", str(fasta), "--output", str(tmp_path / "g.npz")])
    assert exc.value.code == 2
    assert not (tmp_path / "g.npz").exists()
