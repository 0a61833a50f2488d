"""The port's CUDA kernel on the card (marked ``cuda``; skipped without one).

Run from the repository root on a machine with the card (which has no JAX,
hence ``--noconftest``)::

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

The kernel is held against its plain PyTorch version on the same CUDA
tensors, exactly (tolerance 0) under the selection contract, with the
allele hash exact on every row, over the copy paths of its staging: full
tiles, a ragged last tile, a single row, unaligned bases (tensors with a
storage offset), width 1 and the widest width it takes.  The wrapper's
refusals are checked, and the load's dispatch on the card is shown to take
the hash from the kernel, on the loader's own stream, into pinned host
memory.  The VCF load's default configuration (native tokenizer,
overlapped executor, async store writer) and the VEP update on the card,
through either transform, must write the stores the same loads write on
the CPU, with one kernel launch per chunk or identity batch; the native
VEP transformer's allele hash must equal the kernel's, and the rank
table's lookup on the card must equal its host lookup.  The update legs'
identity hash (``loaders/lookup.py::chunk_hashes``) on the card must equal
the CPU's, and the QC, SnpEff and TSV updates on the card must write the
CPU's stores with the predicted launches and no plain hash.
``chip_smoke.py`` runs the same comparisons at the loads' real sizes."""

import os
import sys

import numpy as np
import pytest
import torch

from annotatedvdb_tpu_torch.ops import hashing
from annotatedvdb_tpu_torch.ops.annotate_cuda import (
    EVERY_ROW,
    FIELDS,
    LAUNCHES,
    MAX_WIDTH,
    annotate_bin,
    annotate_bin_reference,
)
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from chip_smoke import (  # noqa: E402
    edge_batch,
    random_batch,
    run_update,
    store_bytes,
    update_launches_predicted,
    vep_hash_check,
    write_metaseq_tsv,
    write_phase4_vcf,
    write_qc_pvcf,
    write_snpeff_vcf,
    write_vep_json,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _offset_copy(x: np.ndarray, device, offset: int) -> torch.Tensor:
    """``x`` on the card as a contiguous view ``offset`` elements into a
    larger buffer (a non-zero storage offset, an unaligned base)."""
    flat = torch.zeros(x.size + offset, dtype=torch.from_numpy(x[:0]).dtype,
                       device=device)
    view = flat[offset:].view(x.shape)
    view.copy_(torch.from_numpy(np.ascontiguousarray(x)))
    assert view.is_contiguous() and view.storage_offset() == offset
    return view


def _assert_kernel_matches(args):
    before = LAUNCHES["annotate_bin"]
    got = annotate_bin(*args)
    want = annotate_bin_reference(*args)
    torch.cuda.synchronize()
    assert LAUNCHES["annotate_bin"] == before + 1
    ok = ~want["host_fallback"]
    assert list(got) == [name for name, _ in FIELDS]
    for name, dtype in FIELDS:
        assert got[name].dtype == dtype
        if name in EVERY_ROW:
            assert torch.equal(got[name], want[name]), name
        else:
            assert torch.equal(got[name][ok], want[name][ok]), name


@pytest.mark.parametrize("width", [1, 8, 16, 49, 96, MAX_WIDTH])
@pytest.mark.parametrize("inputs", ["edge", "random"])
def test_kernel_matches_plain_version(cuda, inputs, width):
    rows = edge_batch(width) if inputs == "edge" else random_batch(width, 4099, width)
    _assert_kernel_matches([torch.from_numpy(x).to(cuda) for x in rows])


@pytest.mark.parametrize("rows", [1, 127, 128, 129, 65_537])
def test_kernel_ragged_last_tile(cuda, rows):
    _assert_kernel_matches([torch.from_numpy(x).to(cuda)
                            for x in random_batch(rows, rows, 49)])


@pytest.mark.parametrize("width", [1, 49, 96])
@pytest.mark.parametrize("offsets", [(1, 3, 7), (0, 5, 16), (2, 15, 1)])
def test_kernel_unaligned_bases(cuda, width, offsets):
    """ref and alt start at byte offsets of their own (so the bulk copies'
    heads and tails differ between them); the scalars too."""
    scalar_off, ref_off, alt_off = offsets
    pos, ref, alt, rl, al = random_batch(17 + width, 1000, width)
    _assert_kernel_matches([
        _offset_copy(pos, cuda, scalar_off), _offset_copy(ref, cuda, ref_off),
        _offset_copy(alt, cuda, alt_off), _offset_copy(rl, cuda, scalar_off),
        _offset_copy(al, cuda, scalar_off),
    ])


def test_wrapper_refuses_bad_inputs(cuda):
    pos, ref, alt, rl, al = (torch.from_numpy(x).to(cuda)
                             for x in random_batch(0, 64, 16))
    with pytest.raises(TypeError):
        annotate_bin(pos.long(), ref, alt, rl, al)
    with pytest.raises(ValueError):
        annotate_bin(pos, ref.t().contiguous().t(), alt, rl, al)
    wide = torch.zeros((64, MAX_WIDTH + 1), dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError):
        annotate_bin(pos, wide, wide, rl, al)
    empty = annotate_bin(pos[:0], ref[:0], alt[:0], rl[:0], al[:0])
    assert all(v.numel() == 0 for v in empty.values())


def test_dispatch_takes_the_hash_from_the_kernel(cuda):
    """The load's annotate-and-hash step on the card: one launch, no call
    of the plain hash, the same uint32 values as the plain hash."""
    from annotatedvdb_tpu_torch.io.synth import synthetic_batch
    from annotatedvdb_tpu_torch.models.pipeline import annotate_hash_fn

    batch = synthetic_batch(3000, width=49)
    fn = annotate_hash_fn(cuda)
    calls, launches = dict(hashing.CALLS), LAUNCHES["annotate_bin"]
    ann, h = fn(*(torch.from_numpy(x).to(cuda) for x in batch))
    torch.cuda.synchronize()
    assert hashing.CALLS == calls
    assert LAUNCHES["annotate_bin"] == launches + 1
    want = hashing.allele_hash(*(torch.from_numpy(x) for x in batch[2:]))
    np.testing.assert_array_equal(hashing.to_uint32(h),
                                  hashing.to_uint32(hashing.hash_bits(want)))
    assert ann.bin_level.device.type == "cuda"


def test_rank_table_lookup_on_card_matches_host(cuda):
    """The rank table's searchsorted on the card, after a learn-on-miss
    re-rank, over every table mask, the same masks with the unknown-term
    bit 63 set, and seeded random masks."""
    from annotatedvdb_tpu_torch.conseq import ConsequenceRanker, RankTable

    ranker = ConsequenceRanker()
    ranker.find_matching_consequence(
        ["stop_gained", "NMD_transcript_variant", "intron_variant"])
    table = RankTable(ranker, cuda)
    rng = np.random.default_rng(5)
    rand = rng.integers(0, 1 << 40, 1000).astype(np.uint64)
    top = np.uint64(1) << np.uint64(63)
    masks = np.concatenate([table._masks, table._masks | top, rand])
    hi = (masks >> np.uint64(32)).astype(np.uint32)
    lo = (masks & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    got = table.lookup_device(hi, lo)
    assert got.device.type == "cuda"
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  table.lookup_host(masks).astype(np.int32))
    assert (got[: len(table._masks)] >= 0).all()


@pytest.mark.parametrize("config", ["python", "native"])
def test_vep_load_on_card_matches_cpu(cuda, tmp_path, monkeypatch, config):
    """The VEP update of one store on the card and on the CPU, through the
    Python transform (``AVDB_NATIVE_VEP=0``) and the default native one:
    the same counters, transform counts and store bytes; on the card one
    kernel launch per identity batch, membership probed on the card, no
    plain hash."""
    from annotatedvdb_tpu_torch.cli.load_vcf import main as load_vcf
    from annotatedvdb_tpu_torch.conseq import ConsequenceRanker
    from annotatedvdb_tpu_torch.loaders import VepLoader
    from annotatedvdb_tpu_torch.models.pipeline import annotate_hash_fn
    from annotatedvdb_tpu_torch.store import AlgorithmLedger, VariantStore
    from annotatedvdb_tpu_torch.utils.quarantine import QuarantineSink

    if config == "python":
        monkeypatch.setenv("AVDB_NATIVE_VEP", "0")
    else:
        monkeypatch.delenv("AVDB_NATIVE_VEP", raising=False)
    annotate_hash_fn(cuda)  # its once-per-process check launches the kernel too
    vcf, vep = str(tmp_path / "v.vcf"), str(tmp_path / "v.vep.json")
    lines, _rows, _dups = write_phase4_vcf(vcf, 20_000)
    want, novel = write_vep_json(vep, lines, 5_000, seed=9, n_novel=3)
    out = {}
    for plat in ("cuda", "cpu"):
        d = str(tmp_path / f"store_{plat}")
        assert load_vcf(["--fileName", vcf, "--storeDir", d, "--commit",
                         "--logAfter", "0", "--platform", "cpu"]) == 0
        if plat == "cuda":
            monkeypatch.setenv("AVDB_DEVICE_LOOKUP", "always")
        store = VariantStore.load(d)
        sink = QuarantineSink(d, vep, "load-vep")
        loader = VepLoader(store, AlgorithmLedger(f"{d}/ledger.jsonl"),
                           ConsequenceRanker(), datasource="dbSNP",
                           log=lambda *a: None, quarantine=sink, device=plat)
        calls, launches = dict(hashing.CALLS), LAUNCHES["annotate_bin"]
        counters = loader.load_file(vep, commit=True)
        sink.close()
        store.save(d)
        monkeypatch.delenv("AVDB_DEVICE_LOOKUP", raising=False)
        assert {k: counters.get(k, 0) for k in want} == want
        assert sorted(loader.parser.ranker.added) == sorted(novel)
        assert (loader.transform_stats["native_rows"] > 0) == (config == "native")
        if plat == "cuda":
            assert LAUNCHES["annotate_bin"] - launches == loader.identity_batches > 0
            assert hashing.CALLS["cuda"] == calls["cuda"]
            assert set(loader.probe_stats) == {"device"}
        out[plat] = (store_bytes(d), loader.transform_stats)
    assert out["cuda"] == out["cpu"]


def test_vep_transformer_hash_matches_kernel(cuda, tmp_path):
    """The native VEP transformer's hash of every row against the kernel's
    on the card (the host's full-string hash on over-width rows)."""
    vcf, vep = str(tmp_path / "v.vcf"), str(tmp_path / "v.vep.json")
    lines, _rows, _dups = write_phase4_vcf(vcf, 20_000)
    write_vep_json(vep, lines, 5_000, seed=9, n_novel=3)
    assert vep_hash_check(torch, cuda, vep)["rows"] > 5_000


def test_dispatch_runs_on_the_loaders_stream(cuda, tmp_path):
    """The dispatch stage enqueues uploads, one launch and the copies back
    on the loader's own stream, into pinned host tensors, and hands the
    process stage one event; the tokenizer's hash is not copied back."""
    from annotatedvdb_tpu_torch.io.vcf import VcfBatchReader
    from annotatedvdb_tpu_torch.loaders import VcfLoader
    from annotatedvdb_tpu_torch.loaders.vcf_loader import COPY_BACK
    from annotatedvdb_tpu_torch.store import AlgorithmLedger, VariantStore

    vcf = str(tmp_path / "d.vcf")
    write_phase4_vcf(vcf, 3000)
    chunk = next(iter(VcfBatchReader(vcf, batch_size=1024, engine="native")))
    loader = VcfLoader(VariantStore(width=49),
                       AlgorithmLedger(str(tmp_path / "ledger.jsonl")),
                       log=lambda *a: None, device=cuda)
    loader._dispatch_chunk(chunk)  # the first call also checks the kernel
    launches = LAUNCHES["annotate_bin"]
    handles = loader._dispatch_chunk(chunk)
    assert LAUNCHES["annotate_bin"] == launches + 1
    assert loader._stream != torch.cuda.default_stream(cuda)
    assert isinstance(handles["event"], torch.cuda.Event)
    handles["event"].synchronize()
    assert set(handles["cols"]) == set(COPY_BACK)
    for t in handles["cols"].values():
        assert t.device.type == "cpu" and t.is_pinned()
    want = annotate_bin_reference(*(torch.from_numpy(x) for x in (
        chunk.batch.pos, chunk.batch.ref, chunk.batch.alt,
        chunk.batch.ref_len, chunk.batch.alt_len)))
    ok = ~want["host_fallback"]
    for name, t in handles["cols"].items():
        assert torch.equal(t[ok], want[name][ok]), name
    loader.close()


def test_default_vcf_load_on_card_matches_cpu(cuda, tmp_path, monkeypatch):
    """The CLI's default configuration on the card and on the CPU, with
    64 KiB read windows so windows cut chunks: the same store bytes; on the
    card one kernel launch per chunk and no plain hash."""
    from annotatedvdb_tpu_torch.cli.load_vcf import main as load_vcf
    from annotatedvdb_tpu_torch.models.pipeline import annotate_hash_fn
    from annotatedvdb_tpu_torch.native import vcf as native_vcf

    for name in ("AVDB_INGEST_ENGINE", "AVDB_PIPELINE", "AVDB_ASYNC_STORE"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setattr(native_vcf, "READ_SIZE", 64 << 10)
    annotate_hash_fn(cuda)  # its once-per-process check launches the kernel too
    vcf = str(tmp_path / "v.vcf")
    write_phase4_vcf(vcf, 20_000)
    out = {}
    for plat in ("cuda", "cpu"):
        d = str(tmp_path / f"store_{plat}")
        calls, launches = dict(hashing.CALLS), LAUNCHES["annotate_bin"]
        assert load_vcf(["--fileName", vcf, "--storeDir", d, "--commit",
                         "--commitAfter", "4096", "--logAfter", "0",
                         "--platform", plat]) == 0
        if plat == "cuda":
            with open(f"{d}/ledger.jsonl") as f:
                chunks = sum('"checkpoint"' in line for line in f)
            assert LAUNCHES["annotate_bin"] - launches == chunks > 20000 // 4096
            assert hashing.CALLS["cuda"] == calls["cuda"]
        out[plat] = store_bytes(d)
    assert out["cuda"] == out["cpu"]


def test_chunk_hashes_on_card_match_cpu(cuda, tmp_path, monkeypatch):
    """A Python-engine chunk (no tokenizer hash) hashed on the card by one
    ``annotate_bin`` launch: equal to the CPU's hash on every row, the
    over-width override included; no plain hash on the card."""
    from annotatedvdb_tpu_torch.io.vcf import VcfBatchReader
    from annotatedvdb_tpu_torch.loaders.lookup import chunk_hashes
    from annotatedvdb_tpu_torch.models.pipeline import annotate_hash_fn
    from annotatedvdb_tpu_torch.store import VariantStore

    monkeypatch.setenv("AVDB_INGEST_ENGINE", "python")
    annotate_hash_fn(cuda)
    vcf = str(tmp_path / "h.vcf")
    write_phase4_vcf(vcf, 30_000)
    store = VariantStore(width=49)
    over = 0
    for chunk in VcfBatchReader(vcf, batch_size=8192):
        if not chunk.batch.n:
            continue
        assert chunk.h_native is None
        calls, launches = dict(hashing.CALLS), LAUNCHES["annotate_bin"]
        got = chunk_hashes(store, chunk, device=cuda)
        assert LAUNCHES["annotate_bin"] == launches + 1
        assert hashing.CALLS["cuda"] == calls["cuda"]
        np.testing.assert_array_equal(got, chunk_hashes(store, chunk, device="cpu"))
        over += int((chunk.batch.ref_len > 49).sum())
    assert over >= 1


@pytest.mark.parametrize("engine", ["native", "python"])
def test_update_legs_on_card_match_cpu(cuda, tmp_path, monkeypatch, engine):
    """``update-qc`` (novel rows inserted), ``load-snpeff-lof`` and
    ``update-annotation`` on copies of one store, on the card and on the
    CPU: the same store bytes after each, the predicted counters, the
    predicted ``annotate_bin`` launches and no plain hash on the card."""
    import shutil

    from annotatedvdb_tpu_torch.cli.load_vcf import main as load_vcf
    from annotatedvdb_tpu_torch.models.pipeline import annotate_hash_fn

    if engine == "python":
        monkeypatch.setenv("AVDB_INGEST_ENGINE", "python")
    else:
        monkeypatch.delenv("AVDB_INGEST_ENGINE", raising=False)
    annotate_hash_fn(cuda)
    vcf = str(tmp_path / "v.vcf")
    lines, _rows, _dups = write_phase4_vcf(vcf, 20_000)
    base = str(tmp_path / "base")
    assert load_vcf(["--fileName", vcf, "--storeDir", base, "--commit",
                     "--logAfter", "0", "--platform", "cpu"]) == 0
    specs = {}
    for name, fn, n in (("qc", write_qc_pvcf, 10_000),
                        ("lof", write_snpeff_vcf, 10_000),
                        ("tsv", write_metaseq_tsv, 4_000)):
        path = str(tmp_path / f"u.{name}")
        specs[name] = (path, fn(path, lines, n, seed=len(specs) + 30))
    out = {}
    for plat in ("cuda", "cpu"):
        d = str(tmp_path / f"store_{plat}")
        shutil.copytree(base, d)
        out[plat] = []
        for name, (path, want) in specs.items():
            calls, launches = dict(hashing.CALLS), LAUNCHES["annotate_bin"]
            run = run_update(torch, plat, name, path, d)
            assert {k: run["counters"].get(k, 0) for k in want} == want
            predicted = update_launches_predicted(name, run, engine == "native")
            if plat == "cuda":
                assert LAUNCHES["annotate_bin"] - launches == predicted
                assert hashing.CALLS["cuda"] == calls["cuda"]
            out[plat].append(store_bytes(d))
    assert out["cuda"] == out["cpu"]
