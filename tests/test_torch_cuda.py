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
CPU's stores with the predicted launches and no plain hash.  The CADD join
kernel (``csrc/cadd_join.cu``) is held against its plain version exactly
on edge and random blocks at W = 16 to 96, unsorted variants, probes
across 32-row windows and unaligned bases, and ``load-cadd`` (whole
store, ``--buildIndex``, indexed ``--fileName``), ``export-vcf`` and
``undo`` on the card must leave the CPU's stores and export files, with the
predicted ``cadd_join`` launches and no plain join on the card.  The
reference-genome kernel (``csrc/validate_ref.cu``) is held against its
plain version exactly on edge, random and position-sorted rows at W = 16
to 96, unaligned bases and genome arrays viewed at odd offsets, and
``load-vcf --refGenome`` and ``install-schema --storeDir`` on the card
must write the CPU's stores and output trees with the predicted
``validate_ref`` and ``annotate_bin`` launches and no plain version on the
card.  The query server's kernels (``csrc/bits_spans.cu``,
``csrc/stats_panel.cu``) are held against their plain versions exactly on
edge and seeded panels at windows 1 to 64, spans ending at every row
offset of the stats kernels' tiles, and unaligned bases; the stats entry
points refuse a short or misaligned scratch; and the
card's ``QueryEngine`` must answer the CPU engine's bytes with the
predicted launches, no plain version on the card and no breaker failure.
The packed transport's kernels (``csrc/pack.cu``: the inflate and the two
packs) are held against their plain versions byte for byte, their
wrappers' refusals checked, a wrong pack shown to fail its probe and the
load (no fallback), and the load's packed dispatch shown to run on the
loader's stream; ``load-vcf`` under ``AVDB_PACK_TRANSPORT`` auto, always
and never on the card writes the CPU's store with one launch of the
annotate kernel's packed entry a chunk where it packs (no inflate, no
pack), and display attributes and the spill tier on the card write the
CPU's stores.  The packed entry is held against the three-kernel route it
replaces byte for byte and against its plain composition under the
selection contract (``chip_smoke.annotate_packed_checks``: W = 1 to 192,
two column counts, 0 to 257 rows, every packed byte value, 65,536 and
1,048,576 rows, unaligned bases), its wrapper's refusals checked, and a
wrong entry shown to fail its first-use check and the load.  The identity
entry is held against its plain composition on every byte and against
the two-launch route it replaces (``chip_smoke.annotate_identity_checks``:
W = 1 to 255, 0 to 257 rows, shared runs, over-width, SNV and empty rows,
65,536 and 1,048,576 rows, unaligned bases and output), its wrapper's
refusals checked, and a wrong entry shown to fail its first-use check and
the VEP update; the VEP update and the update legs' lookup hashes take it
on the card, one launch a batch, with no ``annotate_bin`` or
``pack_vep_outputs``.
The export's pack kernel (``csrc/export_pack.cu``) is held against its
plain version byte for byte on edge rows, 1,048,576 random rows,
store-shaped batches and stacks of batches (B = 4 mod 8, B not a multiple
of 4, an unaligned base) at every ``n_valid`` case; its wrapper refuses
int64, non-contiguous and mixed inputs and counts that do not match the
stack; ``pack_batches`` on the card equals the numpy twin with one launch
a part, and ``export`` and ``/export/stream`` on the card write and answer
the ``--hostOnly`` bytes with one launch a part or call.  ``bits_spans``
is also held against its plain version on its own search edges.
``device_trace`` (``load-vcf --profile``) on the card records a kernel
launched from another thread.  The mesh's kernels (``csrc/lookup_multi.cu``
and the stacked entry of ``csrc/bits_spans.cu``) are held against their
plain versions exactly on the smoke's edge inputs, with unaligned allele
bases, and their wrappers' refusals checked; over four virtual shards of
the card (``AVDBC_VIRTUAL_DEVICES``) the step programs equal a CPU mesh's,
a ``load-vcf --maxWorkers 4`` writes the single-device load's store, and
a ``MeshExecutor`` engine answers as a host-only engine, each with the
predicted launches and no plain version on the card.  ``chip_smoke.py``
runs the same comparisons at the loads' and the server's real sizes."""

import json
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
    WARMUP_PACKED,
    annotate_launches,
    cadd_edge_cases,
    cadd_random_block,
    cadd_steps,
    check_cadd_parity,
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
    vcf_sites,
    write_cadd_tables,
    validate_edge_rows,
    validate_random_rows,
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


def test_device_trace_records_the_kernel(cuda, tmp_path):
    """``load-vcf --profile``'s capture (``utils.profiling.device_trace``)
    on the card around one ``annotate_bin`` launch made on a thread of its
    own, as the load's dispatch thread makes it: the trace written holds
    that kernel once, and the CPU operators of both threads."""
    import glob
    import threading

    from annotatedvdb_tpu_torch.utils.profiling import device_trace

    args = [torch.from_numpy(x).to(cuda) for x in random_batch(1, 4096, 49)]
    annotate_bin(*args)  # built and loaded before the capture
    torch.cuda.synchronize()
    before = LAUNCHES["annotate_bin"]
    with device_trace(str(tmp_path / "prof"), cuda):
        t = threading.Thread(target=annotate_bin, args=args,
                             name="avdb-vcf-dispatch")
        t.start()
        t.join()
        torch.zeros(4, device=cuda)
    assert LAUNCHES["annotate_bin"] == before + 1
    (path,) = glob.glob(str(tmp_path / "prof" / "*.pt.trace.json"))
    with open(path) as f:
        evs = json.load(f)["traceEvents"]
    kernels = [e for e in evs if e.get("cat") == "kernel"
               and "annotate" in e["name"]]
    assert len(kernels) == 1, [e["name"] for e in evs
                               if e.get("cat") == "kernel"]
    ops = [e for e in evs if e.get("cat") == "cpu_op"]
    assert len({e["tid"] for e in ops}) >= 2


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
    from annotatedvdb_tpu_torch.models.pipeline import annotate_identity_fn
    from annotatedvdb_tpu_torch.ops import pack
    from annotatedvdb_tpu_torch.store import AlgorithmLedger, VariantStore
    from annotatedvdb_tpu_torch.utils.quarantine import QuarantineSink

    if config == "python":
        monkeypatch.setenv("AVDB_NATIVE_VEP", "0")
    else:
        monkeypatch.delenv("AVDB_NATIVE_VEP", raising=False)
    annotate_identity_fn(cuda)  # its once-per-process check launches the entry too
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
        calls, launches = dict(hashing.CALLS), dict(LAUNCHES)
        packs = pack.LAUNCHES["pack_vep_outputs"]
        counters = loader.load_file(vep, commit=True)
        sink.close()
        store.save(d)
        monkeypatch.delenv("AVDB_DEVICE_LOOKUP", raising=False)
        assert {k: counters.get(k, 0) for k in want} == want
        assert sorted(loader.parser.ranker.added) == sorted(novel)
        assert (loader.transform_stats["native_rows"] > 0) == (config == "native")
        if plat == "cuda":
            got = {k: LAUNCHES[k] - launches[k] for k in LAUNCHES}
            assert got == {"annotate_bin": 0, "annotate_bin_packed": 0,
                           "annotate_bin_identity": loader.identity_batches}
            assert loader.identity_batches > 0
            assert pack.LAUNCHES["pack_vep_outputs"] == packs
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


def test_dispatch_runs_on_the_loaders_stream(cuda, tmp_path, monkeypatch):
    """With the packed transport off (``AVDB_PACK_TRANSPORT=never``), the
    dispatch stage enqueues uploads, one launch and the copies back on the
    loader's own stream, into pinned host tensors, and hands the process
    stage one event; the tokenizer's hash is not copied back."""
    from annotatedvdb_tpu_torch.io.vcf import VcfBatchReader
    from annotatedvdb_tpu_torch.loaders import VcfLoader
    from annotatedvdb_tpu_torch.loaders.vcf_loader import COPY_BACK
    from annotatedvdb_tpu_torch.store import AlgorithmLedger, VariantStore

    monkeypatch.setenv("AVDB_PACK_TRANSPORT", "never")
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


def test_packed_dispatch_runs_on_the_loaders_stream(cuda, tmp_path, monkeypatch):
    """The default on the card: the tokenizer's pre-packed alleles go up,
    one launch of the annotate kernel's packed entry on the loader's own
    stream (no inflate, no ``annotate_bin``, no pack), and one ``[n, 10]``
    pinned copy comes back whose columns are the plain versions' on the
    chunk; no plain version runs on the card."""
    from annotatedvdb_tpu_torch.io.vcf import VcfBatchReader
    from annotatedvdb_tpu_torch.loaders import VcfLoader
    from annotatedvdb_tpu_torch.ops import pack
    from annotatedvdb_tpu_torch.store import AlgorithmLedger, VariantStore

    monkeypatch.delenv("AVDB_PACK_TRANSPORT", raising=False)
    vcf = str(tmp_path / "d.vcf")
    write_phase4_vcf(vcf, 3000)
    chunk = next(iter(VcfBatchReader(vcf, batch_size=1024, engine="native")))
    assert chunk.ref_packed is not None
    loader = VcfLoader(VariantStore(width=49),
                       AlgorithmLedger(str(tmp_path / "ledger.jsonl")),
                       log=lambda *a: None, device=cuda)
    loader._dispatch_chunk(chunk)  # the first call also checks the kernels
    before = dict(pack.LAUNCHES), dict(LAUNCHES), dict(pack.CALLS)
    handles = loader._dispatch_chunk(chunk)
    assert LAUNCHES == dict(before[1], annotate_bin_packed=before[1]["annotate_bin_packed"] + 1)
    assert pack.LAUNCHES == before[0]
    assert pack.CALLS == before[2]
    handles["event"].synchronize()
    (buf,) = handles["cols"].values()
    assert buf.is_pinned() and buf.shape == (chunk.batch.n, pack.WIDTH)
    cols = pack.unpack_outputs(buf.numpy())
    want = annotate_bin_reference(*(torch.from_numpy(x) for x in (
        chunk.batch.pos, chunk.batch.ref, chunk.batch.alt,
        chunk.batch.ref_len, chunk.batch.alt_len)))
    ok = ~want["host_fallback"].numpy()
    np.testing.assert_array_equal(cols["h"], chunk.h_native)
    for name in ("needs_digest", "host_fallback"):
        np.testing.assert_array_equal(cols[name], want[name].numpy())
    for name in ("bin_level", "leaf_bin"):
        np.testing.assert_array_equal(cols[name][ok], want[name].numpy()[ok])
    assert not cols["dup"].any()
    loader.close()


def test_transport_kernels_match_plain_versions(cuda):
    """The three entry points of ``csrc/pack.cu`` against their plain
    versions byte for byte: every packed byte value at W = 1 to 96 aligned
    and off, the packs' hash, leaf, level and flag edges, and 65,536 and
    1,048,576 rows (``chip_smoke.transport_kernel_checks``), one launch a
    call."""
    from annotatedvdb_tpu_torch.ops import pack
    from chip_smoke import transport_kernel_checks

    before = dict(pack.LAUNCHES)
    checks, worst = transport_kernel_checks(torch, cuda)
    assert worst == 0 and all(c["equal"] for c in checks)
    for name in pack.LAUNCHES:
        n = sum(c["kernel"] == name for c in checks)
        assert n > 0 and pack.LAUNCHES[name] - before[name] >= n


def test_transport_wrappers_refuse_bad_inputs(cuda):
    from annotatedvdb_tpu_torch.ops import pack

    h = torch.zeros(8, dtype=torch.int32, device=cuda)
    b = torch.zeros(8, dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError, match="inputs on"):
        pack.pack_outputs(h, None, b, h, b.cpu(), b)
    with pytest.raises(TypeError, match="leaf_bin"):
        pack.pack_outputs(h, None, b, h.to(torch.int64), b, b)
    with pytest.raises(ValueError, match="contiguous"):
        pack.pack_vep_outputs(h, torch.zeros(16, dtype=torch.int32, device=cuda)[::2], b)
    p = torch.zeros((8, 3), dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError, match="packed columns"):
        pack.inflate_alleles(p, p, 7)
    with pytest.raises(ValueError, match="contiguous"):
        pack.inflate_alleles(p[:, :2], p[:, :2], 3)


def test_transport_probe_raises_on_a_wrong_kernel(cuda, tmp_path, monkeypatch):
    """A pack whose bytes are wrong on the card makes the transport probe
    raise, and a load that wants the transport fails with it: no quiet
    fallback to per-field copies."""
    from annotatedvdb_tpu_torch.loaders import VcfLoader
    from annotatedvdb_tpu_torch.ops import pack
    from annotatedvdb_tpu_torch.store import AlgorithmLedger, VariantStore

    real = pack.pack_outputs

    def wrong(*args):
        out = real(*args)
        out[:, 9] ^= 1
        return out

    monkeypatch.setattr(pack, "_VERIFIED", set())
    monkeypatch.setattr(pack, "pack_outputs", wrong)
    with pytest.raises(RuntimeError, match="packed transport probe mismatched on cuda:0"):
        pack.ensure_transport(cuda)
    monkeypatch.delenv("AVDB_PACK_TRANSPORT", raising=False)
    vcf = str(tmp_path / "w.vcf")
    write_phase4_vcf(vcf, 2000)
    loader = VcfLoader(VariantStore(width=49),
                       AlgorithmLedger(str(tmp_path / "ledger.jsonl")),
                       log=lambda *a: None, device=cuda)
    with pytest.raises(RuntimeError, match="probe mismatched"):
        loader.load_file(vcf, commit=True)
    loader.close()
    assert loader.transport["fields"] == 0


def test_packed_entry_matches_three_kernel_route(cuda):
    """The annotate kernel's packed entry against the card's three-kernel
    route (inflate, ``annotate_bin``, pack) byte for byte and against its
    plain composition under the selection contract, at W = 1 to 192, both
    column counts, 0 to 257 rows, every packed byte value, 65,536 and
    1,048,576 rows, all from unaligned bases
    (``chip_smoke.annotate_packed_checks``): one launch a call."""
    from chip_smoke import PACKED_ROWS, PACKED_WIDTHS, annotate_packed_checks

    before = LAUNCHES["annotate_bin_packed"]
    checks, worst = annotate_packed_checks(torch, cuda)
    assert worst == 0 and all(c["equal_three_kernels"] and not c["plain_mismatched"]
                              for c in checks)
    assert len(checks) == len(PACKED_WIDTHS) * 2 * len(PACKED_ROWS) + 2
    assert sum(c["host_fallback_rows"] for c in checks) > 0
    # a launch a call with rows (the first-use check's own probe included)
    calls = sum(c["rows"] > 0 for c in checks)
    assert LAUNCHES["annotate_bin_packed"] - before in (calls, calls + 1)


def test_packed_entry_aligned_and_offset_outputs_agree(cuda):
    """The same rows through the packed entry from aligned and from
    unaligned inputs, at 65,536 and 129 rows: the same bytes, and the
    columns ``unpack_outputs`` reads equal the plain fields."""
    from annotatedvdb_tpu_torch.ops.annotate_cuda import annotate_bin_packed
    from annotatedvdb_tpu_torch.ops.pack import inflate_alleles_np, unpack_outputs
    from chip_smoke import packed_inputs

    for rows in (65_536, 129):
        host = packed_inputs(rows, 41)
        aligned = annotate_bin_packed(*(torch.from_numpy(x).to(cuda) for x in host), 49)
        shifted = annotate_bin_packed(*(_offset_copy(x, cuda, off) for x, off in
                                        zip(host, (3, 5, 9, 1, 2))), 49)
        torch.cuda.synchronize()
        assert torch.equal(aligned, shifted)
        cols = unpack_outputs(aligned.cpu().numpy())
        ref, alt = inflate_alleles_np(host[1], host[2], 49)
        want = annotate_bin_reference(*(torch.from_numpy(np.ascontiguousarray(x))
                                        for x in (host[0], ref, alt, host[3], host[4])))
        ok = ~want["host_fallback"].numpy()
        np.testing.assert_array_equal(cols["h"], want["allele_hash"].numpy().view(np.uint32))
        np.testing.assert_array_equal(cols["host_fallback"], want["host_fallback"].numpy())
        np.testing.assert_array_equal(cols["needs_digest"], want["needs_digest"].numpy())
        np.testing.assert_array_equal(cols["leaf_bin"][ok], want["leaf_bin"].numpy()[ok])
        np.testing.assert_array_equal(cols["bin_level"][ok], want["bin_level"].numpy()[ok])
        assert not cols["dup"].any()


def test_packed_entry_refuses_bad_inputs(cuda):
    from annotatedvdb_tpu_torch.ops.annotate_cuda import MAX_WIDTH, annotate_bin_packed

    i32 = torch.zeros(8, dtype=torch.int32, device=cuda)
    p = torch.zeros((8, 25), dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError, match="is on"):
        annotate_bin_packed(i32, p, p.cpu(), i32, i32, 49)
    with pytest.raises(TypeError, match="ref_len must be"):
        annotate_bin_packed(i32, p, p, i32.to(torch.int64), i32, 49)
    with pytest.raises(ValueError, match="contiguous"):
        annotate_bin_packed(i32, p[:, ::2], p[:, ::2], i32, i32, 25)
    with pytest.raises(ValueError, match="packed columns"):
        annotate_bin_packed(i32, p, p, i32, i32, 51)
    wide = torch.zeros((8, MAX_WIDTH + 1), dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError, match="packed columns"):
        annotate_bin_packed(i32, wide, wide, i32, i32, MAX_WIDTH)
    with pytest.raises(ValueError, match="allele width"):
        annotate_bin_packed(i32, wide, wide, i32, i32, MAX_WIDTH + 1)
    assert annotate_bin_packed(i32[:0], p[:0], p[:0], i32[:0], i32[:0], 49).shape == (0, 10)


def test_packed_probe_raises_on_a_wrong_kernel(cuda, tmp_path, monkeypatch):
    """A packed entry whose rows are wrong on the card fails its first-use
    check, and a load on the card that packs fails with it (no fallback
    to the three-kernel route); nothing is latched."""
    from annotatedvdb_tpu_torch.loaders import VcfLoader
    from annotatedvdb_tpu_torch.models import pipeline
    from annotatedvdb_tpu_torch.ops import annotate_cuda
    from annotatedvdb_tpu_torch.store import AlgorithmLedger, VariantStore

    real = annotate_cuda.annotate_bin_packed

    def wrong(*args):
        out = real(*args)
        out[:, 0] ^= 1
        return out

    monkeypatch.setattr(pipeline, "_VERIFIED", set())
    monkeypatch.setattr(annotate_cuda, "annotate_bin_packed", wrong)
    with pytest.raises(RuntimeError, match="packed entry disagrees"):
        pipeline.annotate_packed_fn(cuda)
    assert ("verify_packed_kernel", str(cuda)) not in pipeline._VERIFIED
    monkeypatch.delenv("AVDB_PACK_TRANSPORT", raising=False)
    vcf = str(tmp_path / "w.vcf")
    write_phase4_vcf(vcf, 2000)
    loader = VcfLoader(VariantStore(width=49),
                       AlgorithmLedger(str(tmp_path / "ledger.jsonl")),
                       log=lambda *a: None, device=cuda)
    with pytest.raises(RuntimeError, match="packed entry disagrees"):
        loader.load_file(vcf, commit=True)
    loader.close()
    assert loader.transport["packed"] == 0


def test_identity_entry_matches_plain_version(cuda):
    """The annotate kernel's identity entry against its plain composition
    on every byte and against the two-launch route (``annotate_bin``,
    ``pack_vep_outputs``) where ``annotate_bin`` takes the width, at W = 1
    to 255, 0 to 257 rows, shared runs, over-width, SNV and empty rows,
    65,536 and 1,048,576 rows, all from unaligned bases and also into an
    unaligned output (``chip_smoke.annotate_identity_checks``): one launch
    a call."""
    from chip_smoke import IDENTITY_ROWS, IDENTITY_WIDTHS, annotate_identity_checks

    before = LAUNCHES["annotate_bin_identity"]
    checks, worst = annotate_identity_checks(torch, cuda)
    assert worst == 0 and all(c["equal_plain"] and c["equal_unaligned_out"]
                              and c["equal_two_launches"] is not False
                              and not c["plain_mismatched"] for c in checks)
    assert len(checks) == len(IDENTITY_WIDTHS) * len(IDENTITY_ROWS) + 2
    assert sum(c["equal_two_launches"] is not None for c in checks) > len(checks) // 2
    assert sum(c["host_fallback_rows"] for c in checks) > 0
    # a launch a call with rows (the first-use check's own probe included)
    calls = sum(c["rows"] > 0 for c in checks)
    assert LAUNCHES["annotate_bin_identity"] - before in (calls, calls + 1)


def test_identity_entry_refuses_bad_inputs(cuda):
    from annotatedvdb_tpu_torch.ops.annotate_cuda import (
        IDENTITY_MAX_WIDTH,
        annotate_bin_identity,
    )

    i32 = torch.zeros(8, dtype=torch.int32, device=cuda)
    m = torch.zeros((8, 49), dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError, match="is on"):
        annotate_bin_identity(m, m.cpu(), i32, i32)
    with pytest.raises(TypeError, match="alt_len must be"):
        annotate_bin_identity(m, m, i32, i32.to(torch.int64))
    with pytest.raises(ValueError, match="contiguous"):
        annotate_bin_identity(m[:, ::2], m[:, ::2], i32, i32)
    wide = torch.zeros((8, IDENTITY_MAX_WIDTH + 1), dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError, match="allele width"):
        annotate_bin_identity(wide, wide, i32, i32)
    assert annotate_bin_identity(m[:0], m[:0], i32[:0], i32[:0]).shape == (0, 6)


def test_identity_probe_raises_on_a_wrong_kernel(cuda, tmp_path, monkeypatch):
    """An identity entry whose rows are wrong on the card fails its
    first-use check, and a VEP update on the card fails with it (no
    fallback to the two-launch route); nothing is latched."""
    from annotatedvdb_tpu_torch.conseq import ConsequenceRanker
    from annotatedvdb_tpu_torch.loaders import VepLoader
    from annotatedvdb_tpu_torch.models import pipeline
    from annotatedvdb_tpu_torch.ops import annotate_cuda
    from annotatedvdb_tpu_torch.store import AlgorithmLedger, VariantStore

    real = annotate_cuda.annotate_bin_identity

    def wrong(*args):
        out = real(*args)
        out[:, 5] ^= 1
        return out

    monkeypatch.setattr(pipeline, "_VERIFIED", set())
    monkeypatch.setattr(annotate_cuda, "annotate_bin_identity", wrong)
    with pytest.raises(RuntimeError, match="identity entry disagrees"):
        pipeline.annotate_identity_fn(cuda)
    assert ("verify_identity_kernel", str(cuda)) not in pipeline._VERIFIED
    loader = VepLoader(VariantStore(width=49),
                       AlgorithmLedger(str(tmp_path / "l.jsonl")),
                       ConsequenceRanker(), log=lambda *a: None, device=cuda)
    batches = loader.identity_batches
    with pytest.raises(RuntimeError, match="identity entry disagrees"):
        loader.warmup()
    assert loader.identity_batches == batches


def test_transport_modes_on_card_match_cpu(cuda, tmp_path, monkeypatch):
    """``load-vcf`` on the card under ``AVDB_PACK_TRANSPORT`` auto, always
    and never, and on the CPU: one store, byte for byte; on the card auto
    and always launch the packed entry once a chunk (and once in the
    warmup) and no inflate, ``annotate_bin`` or pack, never launches
    ``annotate_bin`` once a chunk and neither transport kernel;
    ``store_display_attributes`` and the spill tier on the card write the
    CPU's stores (``chip_smoke.display_spill_parity``)."""
    import chip_smoke
    from annotatedvdb_tpu_torch.cli.load_vcf import main as load_vcf
    from annotatedvdb_tpu_torch.models.pipeline import annotate_hash_fn, annotate_packed_fn
    from annotatedvdb_tpu_torch.ops import pack

    for name in ("AVDB_INGEST_ENGINE", "AVDB_PIPELINE", "AVDB_ASYNC_STORE"):
        monkeypatch.delenv(name, raising=False)
    pack.ensure_transport(cuda)
    pack.ensure_nibble(cuda)
    annotate_hash_fn(cuda)  # the entries' once-per-process checks launch too
    annotate_packed_fn(cuda)
    vcf = str(tmp_path / "m.vcf")
    lines, _rows, _dups = write_phase4_vcf(vcf, 20_000)
    out = {}
    for plat, mode in (("cuda", "auto"), ("cuda", "always"), ("cuda", "never"),
                       ("cpu", "auto")):
        d = str(tmp_path / f"store_{plat}_{mode}")
        monkeypatch.setenv("AVDB_PACK_TRANSPORT", mode)
        before = dict(pack.LAUNCHES), dict(LAUNCHES)
        assert load_vcf(["--fileName", vcf, "--storeDir", d, "--commit",
                         "--commitAfter", "4096", "--logAfter", "0",
                         "--platform", plat]) == 0
        with open(f"{d}/ledger.jsonl") as f:
            chunks = sum('"checkpoint"' in line for line in f)
        got = {**{k: pack.LAUNCHES[k] - before[0][k] for k in ("inflate_alleles", "pack_outputs")},
               **{k: LAUNCHES[k] - before[1][k] for k in LAUNCHES}}
        packs = plat == "cuda" and mode != "never"
        want = dict.fromkeys(("inflate_alleles", "pack_outputs", "annotate_bin",
                              "annotate_bin_packed", "annotate_bin_identity"), 0)
        if packs:
            want["annotate_bin_packed"] = chunks + WARMUP_PACKED
        elif plat == "cuda":
            want["annotate_bin"] = chunks
        assert got == want, (mode, got)
        out[(plat, mode)] = store_bytes(d)
    assert all(v == out[("cpu", "auto")] for v in out.values())
    monkeypatch.delenv("AVDB_PACK_TRANSPORT")
    monkeypatch.setattr(chip_smoke, "WORK", str(tmp_path / "work"))
    os.makedirs(chip_smoke.WORK)
    vep = str(tmp_path / "m.vep.json")
    write_vep_json(vep, lines[:3000], 800, seed=4, n_novel=2)
    small = str(tmp_path / "s.vcf")
    with open(vcf) as src, open(small, "w") as dst:
        dst.writelines(ln for k, ln in enumerate(src) if k < 3002)
    res = chip_smoke.display_spill_parity("cuda", {"vcf6": small, "vep6": vep})
    assert res["display_rows"] > 0 and not res["differ_display"]
    assert not res["differ_spill"] and all(res["spill_mapped"].values())


def test_vep_warmup_stays_out_of_the_identity_counts(cuda, tmp_path):
    """``VepLoader.warmup`` on the card sends one identity batch at the
    loader's batch shape through one launch of the identity entry (no
    ``annotate_bin``, no ``pack_vep_outputs``), and leaves the identity
    batch count and the identity timer's seconds and items as they were."""
    from annotatedvdb_tpu_torch.conseq import ConsequenceRanker
    from annotatedvdb_tpu_torch.loaders import VepLoader
    from annotatedvdb_tpu_torch.models.pipeline import annotate_identity_fn
    from annotatedvdb_tpu_torch.ops import pack
    from annotatedvdb_tpu_torch.store import AlgorithmLedger, VariantStore

    annotate_identity_fn(cuda)  # its once-per-process check launches the entry too
    loader = VepLoader(VariantStore(width=49),
                       AlgorithmLedger(str(tmp_path / "l.jsonl")),
                       ConsequenceRanker(), log=lambda *a: None, device=cuda)
    launches, packs = dict(LAUNCHES), pack.LAUNCHES["pack_vep_outputs"]
    loader.warmup()
    assert ({k: LAUNCHES[k] - launches[k] for k in LAUNCHES},
            pack.LAUNCHES["pack_vep_outputs"] - packs) == (
        {"annotate_bin": 0, "annotate_bin_packed": 0, "annotate_bin_identity": 1}, 0)
    assert loader.identity_batches == 0
    assert loader.identity_timer.seconds == {} and loader.identity_timer.items == {}


def test_bucketed_load_on_card_matches_cpu(cuda, tmp_path, monkeypatch):
    """``AVDB_PACK_TRANSPORT=never`` on the card: the native engine's chunks
    upload at the widths 8, 16, 32 and 49 (``chip_smoke.write_bucket_vcf``),
    one ``annotate_bin`` launch each at its width and no transport launch,
    and the store is the CPU's, byte for byte."""
    from annotatedvdb_tpu_torch.loaders import VcfLoader
    from annotatedvdb_tpu_torch.models.pipeline import annotate_hash_fn
    from annotatedvdb_tpu_torch.ops import pack
    from annotatedvdb_tpu_torch.store import AlgorithmLedger, VariantStore
    from chip_smoke import write_bucket_vcf

    for name in ("AVDB_INGEST_ENGINE", "AVDB_PIPELINE", "AVDB_ASYNC_STORE"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("AVDB_PACK_TRANSPORT", "never")
    annotate_hash_fn(cuda)  # its once-per-process check launches the kernel too
    vcf = str(tmp_path / "b.vcf")
    write_bucket_vcf(vcf)
    out = {}
    for plat in ("cuda", "cpu"):
        d = str(tmp_path / f"store_{plat}")
        store = VariantStore(width=49)
        loader = VcfLoader(store, AlgorithmLedger(f"{d}.ledger.jsonl"), batch_size=256,
                           log=lambda *a: None, device=plat)
        launches, transport = LAUNCHES["annotate_bin"], dict(pack.LAUNCHES)
        try:
            loader.load_file(vcf, commit=True)
        finally:
            loader.close()
        store.save(d)
        assert set(loader.transport["widths"]) == {8, 16, 32, 49}, loader.transport
        if plat == "cuda":
            assert LAUNCHES["annotate_bin"] - launches == loader.transport["raw"] > 4
            assert pack.LAUNCHES == transport
        out[plat] = store_bytes(d)
    assert out["cuda"] == out["cpu"]


def test_default_vcf_load_on_card_matches_cpu(cuda, tmp_path, monkeypatch):
    """The CLI's default configuration on the card and on the CPU, with
    64 KiB read windows so windows cut chunks: the same store bytes; on the
    card one launch of the packed entry per chunk (and the warmup's) and no
    plain hash."""
    from annotatedvdb_tpu_torch.cli.load_vcf import main as load_vcf
    from annotatedvdb_tpu_torch.models.pipeline import annotate_hash_fn, annotate_packed_fn
    from annotatedvdb_tpu_torch.native import vcf as native_vcf

    for name in ("AVDB_INGEST_ENGINE", "AVDB_PIPELINE", "AVDB_ASYNC_STORE",
                 "AVDB_PACK_TRANSPORT"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setattr(native_vcf, "READ_SIZE", 64 << 10)
    annotate_hash_fn(cuda)  # their once-per-process checks launch the kernel too
    annotate_packed_fn(cuda)
    vcf = str(tmp_path / "v.vcf")
    write_phase4_vcf(vcf, 20_000)
    out = {}
    for plat in ("cuda", "cpu"):
        d = str(tmp_path / f"store_{plat}")
        calls, launches = dict(hashing.CALLS), dict(LAUNCHES)
        assert load_vcf(["--fileName", vcf, "--storeDir", d, "--commit",
                         "--commitAfter", "4096", "--logAfter", "0",
                         "--platform", plat]) == 0
        if plat == "cuda":
            with open(f"{d}/ledger.jsonl") as f:
                chunks = sum('"checkpoint"' in line for line in f)
            assert LAUNCHES["annotate_bin_packed"] - launches["annotate_bin_packed"] \
                == chunks + WARMUP_PACKED and chunks > 20000 // 4096
            assert LAUNCHES["annotate_bin"] == launches["annotate_bin"]
            assert hashing.CALLS["cuda"] == calls["cuda"]
        out[plat] = store_bytes(d)
    assert out["cuda"] == out["cpu"]


def test_chunk_hashes_on_card_match_cpu(cuda, tmp_path, monkeypatch):
    """A Python-engine chunk (no tokenizer hash) hashed on the card by one
    launch of the identity entry: equal to the CPU's hash on every row, the
    over-width override included; no plain hash on the card."""
    from annotatedvdb_tpu_torch.io.vcf import VcfBatchReader
    from annotatedvdb_tpu_torch.loaders.lookup import chunk_hashes
    from annotatedvdb_tpu_torch.models.pipeline import annotate_identity_fn
    from annotatedvdb_tpu_torch.store import VariantStore

    monkeypatch.setenv("AVDB_INGEST_ENGINE", "python")
    annotate_identity_fn(cuda)
    vcf = str(tmp_path / "h.vcf")
    write_phase4_vcf(vcf, 30_000)
    store = VariantStore(width=49)
    over = 0
    for chunk in VcfBatchReader(vcf, batch_size=8192):
        if not chunk.batch.n:
            continue
        assert chunk.h_native is None
        calls, launches = dict(hashing.CALLS), dict(LAUNCHES)
        got = chunk_hashes(store, chunk, device=cuda)
        assert {k: LAUNCHES[k] - launches[k] for k in LAUNCHES} == {
            "annotate_bin": 0, "annotate_bin_packed": 0, "annotate_bin_identity": 1}
        assert hashing.CALLS["cuda"] == calls["cuda"]
        np.testing.assert_array_equal(got, chunk_hashes(store, chunk, device="cpu"))
        over += int((chunk.batch.ref_len > 49).sum())
    assert over >= 1


@pytest.mark.parametrize("engine", ["native", "python"])
def test_update_legs_on_card_match_cpu(cuda, tmp_path, monkeypatch, engine):
    """``update-qc`` (novel rows inserted), ``load-snpeff-lof`` and
    ``update-annotation`` on copies of one store, on the card and on the
    CPU: the same store bytes after each, the predicted counters, the
    predicted annotate launches (the packed entry for each insert) and no
    plain hash on the card."""
    import shutil

    from annotatedvdb_tpu_torch.cli.load_vcf import main as load_vcf
    from annotatedvdb_tpu_torch.models.pipeline import (
        annotate_hash_fn,
        annotate_identity_fn,
        annotate_packed_fn,
    )

    if engine == "python":
        monkeypatch.setenv("AVDB_INGEST_ENGINE", "python")
    else:
        monkeypatch.delenv("AVDB_INGEST_ENGINE", raising=False)
    annotate_hash_fn(cuda)
    annotate_packed_fn(cuda)
    annotate_identity_fn(cuda)
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
            calls, launches = dict(hashing.CALLS), annotate_launches(LAUNCHES)
            run = run_update(torch, plat, name, path, d)
            assert {k: run["counters"].get(k, 0) for k in want} == want
            predicted = update_launches_predicted(name, run, engine == "native")
            if plat == "cuda":
                assert annotate_launches(LAUNCHES) - launches == predicted
                assert hashing.CALLS["cuda"] == calls["cuda"]
            out[plat].append(store_bytes(d))
    assert out["cuda"] == out["cpu"]


def _assert_join_matches(args, probe):
    from annotatedvdb_tpu_torch.ops import cadd_join

    before = cadd_join.LAUNCHES["cadd_join"]
    got = cadd_join.cadd_join(*args, probe=probe)
    want = cadd_join.cadd_join_reference(*args, probe=probe)
    torch.cuda.synchronize()
    assert cadd_join.LAUNCHES["cadd_join"] == before + int(args[0].shape[0] > 0)
    assert got[0].dtype == torch.bool and got[1].dtype == torch.int32
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    return got


EDGE_WIDTHS = [16, 31, 32, 33, 49, 64, 65, 96]


@pytest.mark.parametrize("width", EDGE_WIDTHS)
def test_cadd_join_matches_plain_version(cuda, width):
    """Edge blocks; random blocks of both shapes with their variants
    sorted and in no order, and probes across two 32-row windows."""
    for _label, args, probe in cadd_edge_cases(width):
        _assert_join_matches([torch.from_numpy(a).to(cuda) for a in args], probe)
    for snv, probe in ((True, 4), (False, 32), (False, 45)):
        args = cadd_random_block(7, 5000, 40_000, width, min(probe, 32), snv)
        perm = np.random.default_rng(probe).permutation(args[0].shape[0])
        for order in (slice(None), perm):
            v = [np.ascontiguousarray(a[order]) for a in args[:3]]
            m, _ = _assert_join_matches(
                [torch.from_numpy(a).to(cuda) for a in (*v, *args[3:])], probe)
            assert 0.4 < float(m.float().mean()) < 0.95


@pytest.mark.parametrize("offsets", [(1, 3, 7), (2, 5, 1)])
def test_cadd_join_unaligned_bases(cuda, offsets):
    """Allele matrices at odd byte offsets and positions one element in."""
    vpos, vref, valt, spos, sref, salt = cadd_random_block(8, 3000, 20_000, 49,
                                                           32, False)
    o_pos, o_a, o_b = offsets
    args = [_offset_copy(vpos, cuda, o_pos), _offset_copy(vref, cuda, o_a),
            _offset_copy(valt, cuda, o_b), _offset_copy(spos, cuda, o_pos),
            _offset_copy(sref, cuda, o_b), _offset_copy(salt, cuda, o_a)]
    _assert_join_matches(args, 32)


def test_cadd_join_refuses_bad_inputs(cuda):
    from annotatedvdb_tpu_torch.ops.cadd_join import cadd_join

    args = [torch.from_numpy(a).to(cuda)
            for a in cadd_random_block(9, 100, 1000, 16, 4, True)]
    vpos, vref, valt, spos, sref, salt = args
    with pytest.raises(TypeError):
        cadd_join(vpos.to(torch.int64), vref, valt, spos, sref, salt)
    with pytest.raises(ValueError, match="width"):
        cadd_join(vpos, vref, valt, spos, sref[:, :8].contiguous(),
                  salt[:, :8].contiguous())
    with pytest.raises(ValueError, match="empty"):
        cadd_join(vpos, vref, valt, spos[:0], sref[:0], salt[:0])
    with pytest.raises(ValueError, match="is on"):
        cadd_join(vpos, vref, valt, spos.cpu(), sref, salt)
    with pytest.raises(ValueError, match="contiguous"):
        cadd_join(vpos, vref[:, ::2], valt[:, ::2], spos, sref[:, ::2],
                  salt[:, ::2])


@pytest.mark.parametrize("config", ["python", "default"])
def test_cadd_steps_on_card_match_cpu(cuda, tmp_path, monkeypatch, config):
    """``load-cadd`` over both tables, ``--buildIndex``, an indexed
    ``--fileName`` update, ``export-vcf`` and ``undo`` on copies of one
    store, on the card and on the CPU: identical stores and export files,
    the predicted ``cadd_join`` launches, no plain join on the card."""
    import shutil

    import chip_smoke
    from annotatedvdb_tpu_torch.cli.load_vcf import main as load_vcf
    from annotatedvdb_tpu_torch.models.pipeline import annotate_hash_fn, annotate_identity_fn

    annotate_hash_fn(cuda)  # their one-time checks launch the entries
    annotate_identity_fn(cuda)
    monkeypatch.setattr(chip_smoke, "WORK", str(tmp_path))
    if config == "python":
        monkeypatch.setenv("AVDB_INGEST_ENGINE", "python")
        monkeypatch.setenv("AVDB_NATIVE_CADD", "0")
    else:
        monkeypatch.delenv("AVDB_INGEST_ENGINE", raising=False)
        monkeypatch.delenv("AVDB_NATIVE_CADD", raising=False)
    vcf = str(tmp_path / "v.vcf")
    lines, _rows, _dups = write_phase4_vcf(vcf, 20_000)
    base = str(tmp_path / "base")
    assert load_vcf(["--fileName", vcf, "--storeDir", base, "--commit",
                     "--logAfter", "0", "--platform", "cpu"]) == 0
    sites = vcf_sites(lines)
    head = str(tmp_path / "head.vcf")
    with open(head, "w") as f:
        f.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n")
        f.writelines(lines[:300])
    db = str(tmp_path / "cadd")
    inp = {"head6": head, "cadd6": {"db": db, "head_lines": 300, "pred":
           write_cadd_tables(db, sites, {"22": (sites[0][1], sites[-1][1])},
                             seed=5)}}
    steps = []
    for plat in ("cuda", "cpu"):
        d = str(tmp_path / f"store_{plat}")
        shutil.copytree(base, d)
        steps.append(cadd_steps(torch, plat, d, inp, config, 1, bool(steps)))
    check_cadd_parity(steps[0], steps[1], "python-serial" if config == "python"
                      else "default", inp["cadd6"], "cuda")


# ------------------------------------------------------ reference genome


@pytest.fixture(scope="module")
def genome_inputs(tmp_path_factory):
    """A 20,000-line phase-4 VCF, chr22 written over its sites by
    ``chip_smoke.write_genome_inputs`` (up to just past the last site, N
    and lowercase runs, 2% of sites with a changed base; chr21 with IUPAC
    codes) and its index from ``index-genome``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import chip_smoke
    from annotatedvdb_tpu_torch.__main__ import main as cli
    from annotatedvdb_tpu_torch.genome import ReferenceGenome

    tmp = tmp_path_factory.mktemp("genome")
    vcf = str(tmp / "v.vcf")
    lines, _rows, _dups = write_phase4_vcf(vcf, 20_000)
    last = max(int(ln.split("\t", 2)[1]) for ln in lines)
    g = chip_smoke.write_genome_inputs(str(tmp), lines, length=last + 1000,
                                       grch38=False)
    index = str(tmp / "g.npz")
    assert cli(["index-genome", "--fasta", g["fasta"], "--output", index]) == 0
    with open(vcf) as f:
        data = [ln for ln in f if not ln.startswith("#")]
    return {"vcf": vcf, "index": index, "genome": ReferenceGenome.load(index),
            "want": chip_smoke.ref_mismatches(g["text"], data), "tmp": tmp}


@pytest.mark.parametrize("width", EDGE_WIDTHS)
def test_validate_ref_matches_plain_version(cuda, genome_inputs, width):
    from annotatedvdb_tpu_torch.genome import refgenome

    genome = genome_inputs["genome"]
    tables = genome.device_arrays(cuda)
    edge = validate_edge_rows(genome, width)
    for rows in (edge, validate_random_rows(genome, 100_000, width, seed=width),
                 validate_random_rows(genome, 70_000, width, seed=width, code=22)):
        args = [torch.from_numpy(x).to(cuda) for x in rows[:4]]
        before = refgenome.LAUNCHES["validate_ref"]
        got = refgenome.validate_ref(*tables, *args)
        want = refgenome.validate_ref_reference(*tables, *args)
        torch.cuda.synchronize()
        assert refgenome.LAUNCHES["validate_ref"] == before + 1
        assert got.dtype == torch.bool and torch.equal(got, want)
    np.testing.assert_array_equal(
        refgenome.validate_ref(*tables, *(torch.from_numpy(x).to(cuda)
                                          for x in edge[:4])).cpu().numpy(), edge[4])


@pytest.mark.parametrize("offsets", [(1, 3, 7, 1), (5, 1, 2, 3)])
def test_validate_ref_unaligned_bases(cuda, genome_inputs, offsets):
    from annotatedvdb_tpu_torch.genome import refgenome

    genome = genome_inputs["genome"]
    tables = genome.device_arrays(cuda)
    rows = validate_random_rows(genome, 4099, 49, seed=7)
    args = [_offset_copy(x, cuda, off) for x, off in zip(rows[:4], offsets)]
    got = refgenome.validate_ref(*tables, *args)
    want = refgenome.validate_ref_reference(*tables, *args)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("offsets", [(0, 0), (3, 5), (7, 1)])
def test_validate_ref_genome_views(cuda, genome_inputs, offsets):
    """The genome arrays as views starting ``offsets`` bytes into their
    buffers, sized exactly: the kernel's 8-byte words at either end of
    both arrays (the first bases, and the edge rows that end at the last
    base of the chromosome stored last) read only bytes inside them."""
    from annotatedvdb_tpu_torch.genome import refgenome

    genome = genome_inputs["genome"]
    tables = list(genome.device_arrays(cuda))
    tables[0] = _offset_copy(genome.packed, cuda, offsets[0])
    tables[1] = _offset_copy(genome.n_mask, cuda, offsets[1])
    for width in (16, 49, 96):
        edge = validate_edge_rows(genome, width)
        args = [torch.from_numpy(x).to(cuda) for x in edge[:4]]
        got = refgenome.validate_ref(*tables, *args)
        want = refgenome.validate_ref_reference(*tables, *args)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        np.testing.assert_array_equal(got.cpu().numpy(), edge[4])


def test_validate_ref_refuses_bad_inputs(cuda, genome_inputs):
    from annotatedvdb_tpu_torch.genome import refgenome

    tables = genome_inputs["genome"].device_arrays(cuda)
    chrom, pos, ref, rl = (torch.from_numpy(x).to(cuda) for x in
                           validate_random_rows(genome_inputs["genome"], 100, 16, 1))
    before = refgenome.LAUNCHES["validate_ref"]
    with pytest.raises(TypeError):
        refgenome.validate_ref(*tables, chrom, pos.to(torch.int64), ref, rl)
    with pytest.raises(ValueError, match="is on"):
        refgenome.validate_ref(*tables, chrom, pos.cpu(), ref, rl)
    with pytest.raises(ValueError, match="contiguous"):
        refgenome.validate_ref(*tables, chrom, pos, ref[:, ::2], rl)
    with pytest.raises(ValueError, match="26 entries"):
        refgenome.validate_ref(*tables[:4], tables[4][:25].contiguous(), chrom,
                               pos, ref, rl)
    with pytest.raises(ValueError, match="disagree"):
        refgenome.validate_ref(*tables, chrom[:50], pos, ref, rl)
    assert refgenome.LAUNCHES["validate_ref"] == before


def _ref_genome_load(genome_inputs, d, plat):
    from annotatedvdb_tpu_torch.cli.load_vcf import main as load_vcf

    assert load_vcf(["--fileName", genome_inputs["vcf"], "--storeDir", d,
                     "--commit", "--commitAfter", "4096", "--logAfter", "0",
                     "--platform", plat, "--refGenome", genome_inputs["index"]]) == 0


@pytest.mark.parametrize("engine", ["native", "python"])
def test_ref_genome_load_on_card_matches_cpu(cuda, genome_inputs, tmp_path,
                                             monkeypatch, engine):
    """``load-vcf --refGenome`` on the card and on the CPU: the same store
    bytes and ledger records, ``ref_mismatch`` as the generator counts it;
    on the card one ``validate_ref`` launch per chunk that inserts rows,
    one annotate launch per chunk (the packed entry) and the warmup's, no
    plain version of either."""
    from annotatedvdb_tpu_torch.genome import refgenome
    from annotatedvdb_tpu_torch.models.pipeline import annotate_hash_fn, annotate_packed_fn
    from annotatedvdb_tpu_torch.native import vcf as native_vcf
    from chip_smoke import inserting_chunks, ledger_records

    if engine == "python":
        monkeypatch.setenv("AVDB_INGEST_ENGINE", "python")
    else:
        monkeypatch.delenv("AVDB_INGEST_ENGINE", raising=False)
    monkeypatch.setattr(native_vcf, "READ_SIZE", 64 << 10)
    annotate_hash_fn(cuda)  # their once-per-process checks launch the kernel too
    annotate_packed_fn(cuda)
    out = {}
    for plat in ("cuda", "cpu"):
        d = str(tmp_path / f"store_{plat}")
        before = (annotate_launches(LAUNCHES), refgenome.LAUNCHES["validate_ref"],
                  refgenome.CALLS["cuda"], hashing.CALLS["cuda"])
        _ref_genome_load(genome_inputs, d, plat)
        counters = ledger_records(d, "finish")[-1]["counters"]
        assert (counters["variant"], counters["ref_mismatch"]) == genome_inputs["want"]
        if plat == "cuda":
            chunks = len(ledger_records(d, "checkpoint"))
            assert annotate_launches(LAUNCHES) - before[0] == chunks + WARMUP_PACKED
            assert chunks > 20_000 // 4096
            assert refgenome.LAUNCHES["validate_ref"] - before[1] == \
                inserting_chunks(d, 1) == chunks
            assert (refgenome.CALLS["cuda"], hashing.CALLS["cuda"]) == before[2:]
        out[plat] = store_bytes(d)
    assert out["cuda"] == out["cpu"]


def test_install_schema_on_card_matches_cpu(cuda, genome_inputs, tmp_path, monkeypatch):
    """``install-schema --storeDir`` of one store on the card and on the
    CPU, with 4,096-row egress windows: identical output trees; on the
    card one ``annotate_bin`` launch per window, no plain hash."""
    from annotatedvdb_tpu_torch.io import egress
    from annotatedvdb_tpu_torch.models.pipeline import annotate_hash_fn
    from chip_smoke import run_install_schema, tree_bytes

    monkeypatch.setattr(egress, "EGRESS_WINDOW", 4096)
    annotate_hash_fn(cuda)
    d = str(tmp_path / "store")
    _ref_genome_load(genome_inputs, d, "cpu")
    runs = {plat: run_install_schema(torch, plat, d, str(tmp_path / f"pg_{plat}"))
            for plat in ("cuda", "cpu")}
    assert runs["cuda"]["tree"] == runs["cpu"]["tree"] == tree_bytes(str(tmp_path / "pg_cpu"))
    assert runs["cuda"]["printed"] == [ln.replace("pg_cpu", "pg_cuda")
                                       for ln in runs["cpu"]["printed"]]
    want = sum(-(-n // 4096) for n in runs["cuda"]["rows"].values())
    assert runs["cuda"]["launches"] == want > 4
    assert runs["cuda"]["plain_cuda"] == 0


# ------------------------------------------------------ the query server


def test_serve_kernels_match_plain_versions(cuda):
    """``bits_spans``, ``stats_panel`` and ``windowed_stats`` against their
    plain versions on the card, exactly, on the smoke's edge cases and a
    262,144-row panel of 1,024 intervals, at windows 1, 7, 16 and 64."""
    from annotatedvdb_tpu_torch.ops import intervals, stats
    from annotatedvdb_tpu_torch.ops.intervals import clamped_queries
    from chip_smoke import serve_columns, serve_edge_cases, serve_kernel_checks

    big = serve_columns(41, 1 << 18, 1024)
    before = (dict(intervals.LAUNCHES), dict(stats.LAUNCHES))
    cases = serve_edge_cases() + [("panel", *big[:4], *clamped_queries(*big[4:]))]
    checks, worst = serve_kernel_checks(torch, cuda, cases)
    assert worst == 0 and all(c["equal"] for c in checks)
    assert intervals.LAUNCHES["bits_spans"] == before[0]["bits_spans"] + len(cases)
    assert stats.LAUNCHES["stats_panel"] == before[1]["stats_panel"] + len(cases)
    assert stats.LAUNCHES["windowed_stats"] == \
        before[1]["windowed_stats"] + 4 * len(cases)


@pytest.mark.parametrize("offsets", [(1, 3, 7), (5, 2, 1)])
def test_serve_kernels_unaligned_bases(cuda, offsets):
    from annotatedvdb_tpu_torch.ops import intervals, stats
    from annotatedvdb_tpu_torch.ops.intervals import clamped_queries
    from annotatedvdb_tpu_torch.utils.arrays import POS_SENTINEL, pad_pow2
    from chip_smoke import serve_columns

    pos, af, cadd, rank, s, e = serve_columns(43, 5000, 300, span=(1000, 200_000))
    s, e = clamped_queries(s, e)
    o_pos, o_col, o_q = offsets
    p = _offset_copy(pad_pow2(pos, POS_SENTINEL), cuda, o_pos)
    cols = [_offset_copy(pad_pow2(a, -1), cuda, o_col) for a in (af, cadd, rank)]
    qs = [_offset_copy(x, cuda, o_q) for x in (s, e)]
    for got, want in (
            (intervals.bits_spans(p, *qs), intervals.bits_spans_reference(p, *qs)),
            (stats.stats_panel(p, *cols, *qs), stats.stats_panel_reference(p, *cols, *qs)),
            (stats.windowed_stats(p, cols[1], *qs, 9),
             stats.windowed_stats_reference(p, cols[1], *qs, 9))):
        torch.cuda.synchronize()
        assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("rows", [70_001, (60_000, 65_536)])
def test_stats_kernels_every_table_offset(cuda, rows):
    """Spans whose searches land on every row offset inside the 64- and
    256-row tiles and across many 4,096-row super-tiles, unpadded (70,001
    rows, the last tile partial) and padded (60,000 real rows to 65,536),
    exactly against the plain versions at windows 1, 7, 16 and 64."""
    from annotatedvdb_tpu_torch.ops import stats
    from annotatedvdb_tpu_torch.utils.arrays import POS_SENTINEL, pad_pow2
    from chip_smoke import serve_columns

    n, k = (rows, rows) if isinstance(rows, int) else rows
    pos = (np.arange(n, dtype=np.int32) + 1) * 3
    _p, af, cadd, rank, _s, _e = serve_columns(44, n, 1, missing=(0.3, 0.3, 0.3))
    rng = np.random.default_rng(45)
    a = np.concatenate([np.arange(600), rng.integers(0, n, 1400)])
    b = np.minimum(a + rng.integers(0, 3 * n // 2, a.size), n)
    starts = (3 * (np.minimum(a, n - 1) + 1)).astype(np.int32)
    ends = (3 * b + 2).astype(np.int32)  # upper bound b: the rows < b
    cols = [torch.from_numpy(pad_pow2(pos, POS_SENTINEL) if k > n else pos).to(cuda)]
    cols += [torch.from_numpy(pad_pow2(c, -1) if k > n else c).to(cuda)
             for c in (af, cadd, rank)]
    assert cols[0].shape[0] == k
    qs = [torch.from_numpy(x).to(cuda) for x in (starts, ends)]
    got = stats.stats_panel(*cols, *qs)
    want = stats.stats_panel_reference(*cols, *qs)
    torch.cuda.synchronize()
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert set(range(256)) <= set((got[0].cpu().numpy() % 256).tolist())
    for w in (1, 7, 16, 64):
        got = stats.windowed_stats(cols[0], cols[2], *qs, w)
        want = stats.windowed_stats_reference(cols[0], cols[2], *qs, w)
        torch.cuda.synchronize()
        assert all(torch.equal(g, x) for g, x in zip(got, want)), w


def test_stats_kernels_refuse_short_or_misaligned_scratch(cuda):
    """The C entry points check the scratch the wrapper sizes: one word
    short, or not 16-byte aligned, is refused before any launch."""
    from annotatedvdb_tpu_torch.ops import stats

    lib = stats._library()
    k, q, w = 5000, 64, 16
    p = torch.arange(1, k + 1, dtype=torch.int32, device=cuda)
    qs = torch.arange(1, q + 1, dtype=torch.int32, device=cuda)
    stream = torch.cuda.current_stream(cuda).cuda_stream
    outs = [torch.empty((q, 32), dtype=torch.int32, device=cuda) for _ in range(7)]
    for kind in ("panel", "windows"):
        words = stats.scratch_words(kind, k, q, w)
        scratch = torch.empty((words + 4,), dtype=torch.int32, device=cuda)
        for ptr, n in ((scratch.data_ptr(), words - 1), (scratch.data_ptr() + 4, words)):
            if kind == "panel":
                rc = lib.stats_panel_launch(p.data_ptr(), p.data_ptr(), p.data_ptr(),
                                            p.data_ptr(), k, qs.data_ptr(), qs.data_ptr(),
                                            q, ptr, n, *(o.data_ptr() for o in outs),
                                            stream)
            else:
                rc = lib.windowed_stats_launch(p.data_ptr(), p.data_ptr(), k,
                                               qs.data_ptr(), qs.data_ptr(), q, w, ptr, n,
                                               *(o.data_ptr() for o in outs[:3]), stream)
            assert rc == 1, (kind, n)  # cudaErrorInvalidValue
    torch.cuda.synchronize()


def test_serve_kernel_wrappers_refuse_bad_inputs(cuda):
    from annotatedvdb_tpu_torch.ops import intervals, stats

    p = torch.arange(1, 65, dtype=torch.int32, device=cuda)
    q = torch.arange(1, 9, dtype=torch.int32, device=cuda)
    before = (dict(intervals.LAUNCHES), dict(stats.LAUNCHES),
              dict(intervals.CALLS), dict(stats.CALLS))
    with pytest.raises(TypeError):
        intervals.bits_spans(p.long(), q, q)
    with pytest.raises(ValueError):
        intervals.bits_spans(p, q, q[:4])
    with pytest.raises(ValueError):
        intervals.bits_spans(p, q.cpu(), q)
    with pytest.raises(ValueError):
        stats.stats_panel(p, p, p[::2].contiguous(), p, q, q)
    with pytest.raises(ValueError):
        stats.stats_panel(p, p, p, torch.stack([p, p], 1), q, q)
    for w in (0, 65):
        with pytest.raises(ValueError):
            stats.windowed_stats(p, p, q, q, w)
    assert (intervals.LAUNCHES, stats.LAUNCHES, intervals.CALLS, stats.CALLS) == before


def test_query_engine_on_card_matches_cpu(cuda, tmp_path):
    """One store built on the card; the card engine's regions and stats
    panels (one launch per chromosome group at the device minimums), bulk
    lookups and region walks equal the CPU engine's bytes, with no plain
    version called on the card and no breaker failure."""
    from annotatedvdb_tpu_torch.ops import intervals, stats
    from annotatedvdb_tpu_torch.serve.engine import QueryEngine
    from annotatedvdb_tpu_torch.serve.resilience import DeviceBreaker
    from annotatedvdb_tpu_torch.serve.snapshot import StaticSnapshots
    from annotatedvdb_tpu_torch.store import VariantStore
    from chip_smoke import build_serve_store, serve_panel

    served = build_serve_store(str(tmp_path), "cuda")
    engines = {plat: QueryEngine(StaticSnapshots(VariantStore.load(
        served["store"], readonly=True)), device=plat, breaker=DeviceBreaker())
        for plat in ("cuda", "cpu")}
    specs = serve_panel(served, seed=3)
    before = (dict(intervals.LAUNCHES), dict(stats.LAUNCHES),
              intervals.CALLS["cuda"], stats.CALLS["cuda"])
    out = {}
    for plat, eng in engines.items():
        out[plat] = [
            eng.regions_serve(specs, limit=4).assemble(),
            eng.regions_serve(specs, limit=0, tokenize=True).assemble(),
            eng.stats_serve(specs, windows=16).assemble(),
            eng.stats_serve(specs, metrics=["cadd"]).assemble(),
            json.dumps(eng.lookup_many(served["ids"])),
            eng.region(specs[0], min_cadd=10.0, limit=3, cursor=""),
        ]
    assert out["cuda"] == out["cpu"]
    assert intervals.LAUNCHES["bits_spans"] - before[0]["bits_spans"] == 4
    assert stats.LAUNCHES["stats_panel"] - before[1]["stats_panel"] == 4
    assert stats.LAUNCHES["windowed_stats"] - before[1]["windowed_stats"] == 2
    assert (intervals.CALLS["cuda"], stats.CALLS["cuda"]) == before[2:]
    assert engines["cuda"].breaker.stats() == {"open_groups": [], "groups": {}}
    assert engines["cuda"].device_bytes() > 0


def test_export_pack_matches_plain_version(cuda):
    """``export_pack`` against its plain version on the card, byte for byte,
    at n_valid -1, 0, 1, B - 1, B and B + 5: edge rows, 1,048,576 random
    rows, store-shaped and random batches of 4,096, 8 and 4,097 rows."""
    from annotatedvdb_tpu_torch.ops import export_pack as P
    from chip_smoke import (
        export_edge_columns,
        export_pack_checks,
        export_random_columns,
        export_store_columns,
    )

    cases = [("edge", export_edge_columns()),
             ("random-1m", export_random_columns(1, 1 << 20)),
             ("store-4096", export_store_columns(3, 4096)),
             ("random-4096", export_random_columns(2, 4096)),
             ("random-8", export_random_columns(4, 8)),
             ("random-4097", export_random_columns(5, 4097))]
    before = P.LAUNCHES["export_pack"]
    checks, worst = export_pack_checks(torch, cuda, cases)
    assert worst == 0 and all(c["equal"] for c in checks)
    assert P.LAUNCHES["export_pack"] == before + 6 * len(cases)


def test_export_pack_stacks_match_plain_version(cuda):
    """Stacks of 1, 2 and 37 batches, B = 4 mod 8, B not a multiple of 4
    and an unaligned base, each batch at each ``n_valid`` case, byte for
    byte against the plain version on the same stack, one launch a stack
    and vector of counts."""
    from annotatedvdb_tpu_torch.ops import export_pack as P
    from chip_smoke import export_stack_checks, export_stacks

    stacks = export_stacks()
    before = P.LAUNCHES["export_pack"]
    checks, worst = export_stack_checks(torch, cuda, stacks)
    assert worst == 0 and all(c["equal"] for c in checks)
    assert P.LAUNCHES["export_pack"] == before + 8 * len(stacks)


def test_bits_spans_edge_cases_match_plain_version(cuda):
    """``bits_spans``' own search edges (long runs across the rounds, 0 to
    65 rows, K not a power of two, the sentinel tail, Q not a multiple of
    8) against the plain version, exactly, one launch a case."""
    from annotatedvdb_tpu_torch.ops import intervals
    from chip_smoke import bits_edge_cases, bits_kernel_checks

    cases = bits_edge_cases()
    before = dict(intervals.LAUNCHES), intervals.CALLS["cuda"]
    checks, worst = bits_kernel_checks(torch, cuda, cases)
    assert worst == 0 and all(c["equal"] for c in checks)
    assert intervals.LAUNCHES["bits_spans"] == before[0]["bits_spans"] + len(cases)
    assert intervals.CALLS["cuda"] == before[1] + len(cases)  # the plain versions


def test_export_pack_refuses_bad_inputs(cuda):
    from annotatedvdb_tpu_torch.ops import export_pack as P

    cols = torch.zeros((7, 64), dtype=torch.int32, device=cuda)
    before = dict(P.LAUNCHES)
    with pytest.raises(TypeError, match="int32"):
        P.export_pack(cols.to(torch.int64), 8)
    with pytest.raises(ValueError, match="contiguous"):
        P.export_pack(torch.zeros((64, 7), dtype=torch.int32, device=cuda).t(), 8)
    with pytest.raises(ValueError, match="contiguous"):
        P.export_pack(cols[:6], 8)
    with pytest.raises(TypeError, match="n_valid"):
        P.export_pack(cols, torch.tensor(8))
    stack = torch.zeros((3, 7, 64), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="n_valid"):
        P.export_pack(stack, [8, 8])
    with pytest.raises(ValueError, match="n_valid"):
        P.export_pack(stack, 8)
    with pytest.raises(TypeError, match="int32"):
        P.export_pack(stack.to(torch.int64), [8, 8, 8])
    with pytest.raises(ValueError, match="contiguous"):
        P.export_pack(torch.zeros((7, 3, 64), dtype=torch.int32, device=cuda)
                      .transpose(0, 1), [8, 8, 8])
    assert P.LAUNCHES == before
    P.export_pack(cols, 8)
    torch.cuda.synchronize()
    assert P.LAUNCHES["export_pack"] == before["export_pack"] + 1


def test_pack_batch_on_card_matches_host_only(cuda):
    """A part's batches packed on the card in one launch equal the numpy
    twin's, batch by batch, for parts of one and of several batches."""
    from annotatedvdb_tpu_torch.export.core import pack_batches
    from annotatedvdb_tpu_torch.ops import export_pack as P
    from chip_smoke import export_store_columns

    for b, counts in ((4096, [4096]), (4096, [4096, 4096, 1000]), (8, [0]),
                      (16, [16, 3, 16, 0, 16])):
        chunks = [{"code": 22, "n_valid": n,
                   **dict(zip(P.COLUMNS, export_store_columns(b + k, b)))}
                  for k, n in enumerate(counts)]
        before = P.LAUNCHES["export_pack"]
        got = pack_batches(chunks, device=cuda)
        assert P.LAUNCHES["export_pack"] == before + 1
        want = pack_batches(chunks, host_only=True)
        for g, w in zip(got, want, strict=True):
            assert list(g) == list(w)
            for key, x in w.items():
                if isinstance(x, np.ndarray):
                    assert g[key].dtype == x.dtype, key
                    np.testing.assert_array_equal(g[key], x)
                else:
                    assert g[key] == x, key


def test_export_and_stream_on_card_match_host_only(cuda, tmp_path, capsys):
    """``export`` on the card writes the ``--hostOnly`` corpus with one launch
    a part; ``stream_payload`` on a card engine answers the ``host_only``
    bytes with one launch a call; no plain version on the card."""
    from annotatedvdb_tpu_torch.__main__ import main as port
    from annotatedvdb_tpu_torch.export import stream
    from annotatedvdb_tpu_torch.ops import export_pack as P
    from annotatedvdb_tpu_torch.serve.engine import QueryEngine
    from annotatedvdb_tpu_torch.serve.resilience import DeviceBreaker
    from annotatedvdb_tpu_torch.serve.snapshot import StaticSnapshots
    from annotatedvdb_tpu_torch.store import VariantStore
    from chip_smoke import _file_digests, build_serve_store, stream_queries

    served = build_serve_store(str(tmp_path / "s"), "cuda")
    digests, summaries = {}, {}
    for tag, flags in (("cuda", []), ("host", ["--hostOnly"])):
        before = (P.LAUNCHES["export_pack"], P.CALLS["cuda"])
        out = str(tmp_path / tag)
        capsys.readouterr()
        assert port(["export", "--storeDir", served["store"], "--out", out,
                     "--commit", "--seed", "7", "--batchRows", "64", *flags]) == 0
        summaries[tag] = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        launched = P.LAUNCHES["export_pack"] - before[0]
        assert launched == (summaries[tag]["parts_written"] if tag == "cuda" else 0)
        assert P.CALLS["cuda"] == before[1]
        digests[tag] = _file_digests(out)
    assert digests["cuda"] == digests["host"] and len(digests["cuda"]) >= 2
    engine = QueryEngine(StaticSnapshots(VariantStore.load(served["store"], readonly=True)),
                         device=cuda, breaker=DeviceBreaker())
    snap = engine.snapshots.current()
    queries = stream_queries(engine._interval_index(snap, 22),
                             np.random.default_rng(5), 16, 1 << 16)
    before = (P.LAUNCHES["export_pack"], P.CALLS["cuda"])
    bodies = [stream.stream_payload(engine, stream.parse_stream_query(q)) for q in queries]
    assert P.LAUNCHES["export_pack"] == before[0] + len(queries)
    assert P.CALLS["cuda"] == before[1]
    for q, body in zip(queries, bodies):
        assert stream.stream_payload(engine, stream.parse_stream_query(q),
                                     host_only=True) == body, q
    assert engine.breaker.stats() == {"open_groups": [], "groups": {}}


def test_aio_server_on_card_matches_cpu(cuda, tmp_path):
    """The default front end (``serve/aio.py``) with a card engine answers
    a CPU aio server's bytes on the device routes, one ``bits_spans`` a
    ``/regions`` group, one ``stats_panel`` a ``/stats/region`` group and
    one ``export_pack`` a stream call, no plain version on the card."""
    import http.client

    from annotatedvdb_tpu_torch.ops import export_pack as P
    from annotatedvdb_tpu_torch.ops import intervals as I
    from annotatedvdb_tpu_torch.ops import stats as S
    from annotatedvdb_tpu_torch.serve.aio import build_aio_server
    from annotatedvdb_tpu_torch.serve.snapshot import SnapshotManager
    from chip_smoke import build_serve_store, serve_panel

    served = build_serve_store(str(tmp_path / "s"), "cuda")
    servers = {dev: build_aio_server(manager=SnapshotManager(served["store"]), port=0,
                                     stream_threshold=50, device=dev)
               for dev in (cuda, "cpu")}
    for s in servers.values():
        s.start_background()

    def fetch(server, method, path, body=None):
        conn = http.client.HTTPConnection("127.0.0.1", server.server_address[1],
                                          timeout=120)
        try:
            conn.request(method, path, body=None if body is None
                         else json.dumps(body).encode())
            r = conn.getresponse()
            return r.status, r.read()
        finally:
            conn.close()

    specs = serve_panel(served, seed=41)
    p0 = int(served["pos22"][0])
    reqs = [("POST", "/regions", {"regions": specs, "limit": 3, "tokenize": True}),
            ("POST", "/regions", {"regions": specs, "limit": 0}),
            ("POST", "/stats/region", {"regions": specs, "windows": 16}),
            ("GET", f"/export/stream?region=22:{p0}-{p0 + 9000}&batch_rows=64", None),
            ("GET", f"/region/22:{p0}-{p0 + 20000}?limit=80&cursor=", None)]
    try:
        before = (dict(I.LAUNCHES), dict(S.LAUNCHES), dict(P.LAUNCHES),
                  I.CALLS["cuda"], S.CALLS["cuda"], P.CALLS["cuda"])
        got = [fetch(servers[cuda], *r) for r in reqs]
        launched = (I.LAUNCHES["bits_spans"] - before[0]["bits_spans"],
                    S.LAUNCHES["stats_panel"] - before[1]["stats_panel"],
                    S.LAUNCHES["windowed_stats"] - before[1]["windowed_stats"],
                    P.LAUNCHES["export_pack"] - before[2]["export_pack"])
        assert launched == (4, 2, 2, 1)
        assert (I.CALLS["cuda"], S.CALLS["cuda"], P.CALLS["cuda"]) == before[3:]
        want = [fetch(servers["cpu"], *r) for r in reqs]
        assert got == want and {s for s, _b in got} == {200}
    finally:
        for s in servers.values():
            s.shutdown()
            s.ctx.batcher.close()


def test_health_plane_beside_card_kernels(cuda, tmp_path):
    """The default health plane and flight recorder on an aio server with
    a card engine: the ticks run on its pool beside the kernels (which
    launch as predicted, no plain version on the card), ``/alerts`` and
    ``/metrics/history`` answer 200 with the requests' series, and the
    flight ring holds the device requests' summaries."""
    import http.client
    import time

    from annotatedvdb_tpu_torch.obs import flight
    from annotatedvdb_tpu_torch.obs.metrics import MetricsRegistry
    from annotatedvdb_tpu_torch.obs.slo import HealthPlane
    from annotatedvdb_tpu_torch.ops import intervals as I
    from annotatedvdb_tpu_torch.ops import stats as S
    from annotatedvdb_tpu_torch.serve.aio import build_aio_server
    from annotatedvdb_tpu_torch.serve.snapshot import SnapshotManager
    from chip_smoke import build_serve_store, serve_panel

    served = build_serve_store(str(tmp_path / "s"), "cuda")
    registry = MetricsRegistry()
    health = HealthPlane(registry, store_dir=served["store"], tick_s=0.05)
    recorder = flight.FlightRecorder(flight.ring_path(served["store"], 0))
    server = build_aio_server(manager=SnapshotManager(served["store"]), port=0,
                              registry=registry, device=cuda, flight=recorder,
                              health=health)
    server.start_background()

    def fetch(method, path, body=None):
        conn = http.client.HTTPConnection("127.0.0.1", server.server_address[1],
                                          timeout=120)
        try:
            conn.request(method, path, body=None if body is None
                         else json.dumps(body).encode())
            r = conn.getresponse()
            return r.status, r.read()
        finally:
            conn.close()

    specs = serve_panel(served, seed=43)
    try:
        before = (I.LAUNCHES["bits_spans"], S.LAUNCHES["stats_panel"],
                  I.CALLS["cuda"], S.CALLS["cuda"])
        for _ in range(3):
            assert fetch("POST", "/regions", {"regions": specs, "limit": 0})[0] == 200
            assert fetch("POST", "/stats/region", {"regions": specs})[0] == 200
        assert (I.LAUNCHES["bits_spans"] - before[0],
                S.LAUNCHES["stats_panel"] - before[1]) == (6, 6)
        assert (I.CALLS["cuda"], S.CALLS["cuda"]) == before[2:]
        deadline = time.monotonic() + 30
        while len(health.ring.samples()) < 4:
            assert time.monotonic() < deadline
            time.sleep(0.05)
        st, raw = fetch("GET", "/alerts")
        alerts = json.loads(raw)
        assert st == 200 and alerts["enabled"] is True
        assert {a["slo"]: a["state"] for a in alerts["alerts"]}["availability"] == "ok"
        st, raw = fetch("GET", "/metrics/history")
        names = {s["name"] for s in json.loads(raw)["series"]}
        assert st == 200 and "avdb_query_seconds" in names
    finally:
        server.shutdown()
        server.ctx.batcher.close()
        recorder.close()
        health.close()
    assert health.errors == 0
    kinds = [e["kind"] for e in flight.decode_ring(recorder.path)["events"]
             if e["type"] == "request"]
    assert kinds.count("regions") == 3 and kinds.count("stats") == 3


def _upsert_rows(served, n, seed):
    """``n`` new chr22 identities beside the store's rows (REF + an
    insertion no line carries) and one the store holds (shadowed)."""
    rng = np.random.default_rng(seed)
    pos = np.sort(rng.choice(served["pos22"], n, replace=False))
    alt = "ATTGACCAGTC" + "".join("ACGT"[(seed >> (2 * i)) & 3] for i in range(4))
    rows = [{"code": 22, "pos": int(p), "ref": "A", "alt": alt,
             "ref_snp": 700 + i,
             "ann": {"cadd_scores": {"CADD_phred": float(i % 40)},
                     "other_annotation": {"seed": seed}}}
            for i, p in enumerate(pos.tolist())]
    _c, p, ref, alt = next(i for i in served["ids"] if i.startswith("22:")).split(":")
    rows.append({"code": 22, "pos": int(p), "ref": ref, "alt": alt,
                 "ref_snp": None, "ann": None})
    return rows


def test_upserts_on_card_engine_match_cpu(cuda, tmp_path):
    """Upserts into a card engine's memtable overlay: ``/regions`` and
    ``/stats/region`` over the overlay generation equal a CPU engine's
    over the same rows, one launch a group, no plain version on the
    card."""
    from annotatedvdb_tpu_torch.ops import intervals, stats
    from annotatedvdb_tpu_torch.serve.engine import QueryEngine
    from annotatedvdb_tpu_torch.serve.resilience import DeviceBreaker
    from annotatedvdb_tpu_torch.serve.snapshot import MemtableSnapshots, StaticSnapshots
    from annotatedvdb_tpu_torch.store import VariantStore
    from annotatedvdb_tpu_torch.store.memtable import Memtable
    from chip_smoke import build_serve_store, serve_panel

    served = build_serve_store(str(tmp_path), "cuda")
    rows = _upsert_rows(served, 200, 5)
    engines = {}
    for plat in ("cuda", "cpu"):
        base = VariantStore.load(served["store"], readonly=True)
        mem = Memtable(width=base.width, flush_bytes=0, flush_age_s=0)
        assert mem.upsert(base, rows, durable=False)[:2] == (len(rows) - 1, 1)
        engines[plat] = QueryEngine(MemtableSnapshots(StaticSnapshots(base), mem),
                                    device=plat, breaker=DeviceBreaker())
    specs = serve_panel(served, seed=17)
    before = (dict(intervals.LAUNCHES), dict(stats.LAUNCHES),
              intervals.CALLS["cuda"], stats.CALLS["cuda"])
    out = {plat: [eng.regions_serve(specs, limit=4).assemble(),
                  eng.regions_serve(specs, limit=0).assemble(),
                  eng.stats_serve(specs, windows=8).assemble(),
                  eng.lookup(f"22:{rows[0]['pos']}:A:{rows[0]['alt']}")]
           for plat, eng in engines.items()}
    assert out["cuda"] == out["cpu"]
    assert '"ref_snp":"rs700"' in out["cuda"][3]
    assert intervals.LAUNCHES["bits_spans"] - before[0]["bits_spans"] == 2 * 2
    assert stats.LAUNCHES["stats_panel"] - before[1]["stats_panel"] == 2
    assert stats.LAUNCHES["windowed_stats"] - before[1]["windowed_stats"] == 2
    assert (intervals.CALLS["cuda"], stats.CALLS["cuda"]) == before[2:]
    assert engines["cuda"].breaker.stats() == {"open_groups": [], "groups": {}}


def test_two_worker_fleet_answers_from_the_card(cuda, tmp_path):
    """``serve --workers 2`` on the card: both workers take ``/regions``
    and ``/stats/region`` batches on fresh connections, every body equal
    to a CPU engine's, and each worker's shutdown record shows its own
    kernel launches, no plain version on the card."""
    import http.client
    import re
    import signal
    import subprocess
    import time

    from annotatedvdb_tpu_torch.serve.engine import QueryEngine
    from annotatedvdb_tpu_torch.serve.snapshot import StaticSnapshots
    from annotatedvdb_tpu_torch.store import VariantStore
    from chip_smoke import ROOT, build_serve_store, serve_diagnosis, serve_panel

    served = build_serve_store(str(tmp_path / "s"), "cuda")
    host = QueryEngine(StaticSnapshots(VariantStore.load(served["store"], readonly=True)),
                       device="cpu")
    specs = serve_panel(served, seed=23)
    want = {"/regions": host.regions_serve(specs, limit=2).assemble().encode(),
            "/stats/region": host.stats_serve(specs, windows=4).assemble().encode()}
    bodies = {"/regions": {"regions": specs, "limit": 2},
              "/stats/region": {"regions": specs, "windows": 4}}
    out_path, err_path = str(tmp_path / "out"), str(tmp_path / "err")
    with open(out_path, "w") as out_f, open(err_path, "w") as err_f:
        # faulthandler: a worker sent SIGABRT prints every thread's stack
        proc = subprocess.Popen(
            [sys.executable, "-m", "annotatedvdb_tpu_torch", "serve",
             "--storeDir", served["store"], "--port", "0", "--workers", "2"],
            cwd=ROOT, stdout=out_f, stderr=err_f, start_new_session=True,
            env=dict(os.environ, PYTHONFAULTHANDLER="1"))
    try:
        t_end = time.monotonic() + 240
        while True:
            assert time.monotonic() < t_end and proc.poll() is None, \
                serve_diagnosis(proc, out_path, err_path)
            text = open(out_path).read()
            if text.count("\nworker ") + text.startswith("worker ") >= 2:
                break
            time.sleep(0.2)
        port = int(re.search(r"http://[\d.]+:(\d+) with 2 workers", text).group(1))
        for i in range(32):
            path = "/regions" if i % 2 == 0 else "/stats/region"
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
            try:
                conn.request("POST", path, body=json.dumps(bodies[path]).encode())
                resp = conn.getresponse()
                assert (resp.status, resp.read()) == (200, want[path]), path
            finally:
                conn.close()
        proc.send_signal(signal.SIGINT)
        assert proc.wait(timeout=120) == 0, open(err_path).read()[-3000:]
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait(timeout=30)
    err = open(err_path).read()
    summaries = sorted((json.loads(t.splitlines()[0])
                        for t in err.split("run summary ")[1:]),
                       key=lambda s: s["worker"])
    assert [s["worker"] for s in summaries] == [0, 1], err[-3000:]
    for s in summaries:
        assert s["device"] == "cuda:0"
        assert s["launches"]["bits_spans"] > 0, s
        assert s["launches"]["stats_panel"] > 0, s
        assert not any(v["cuda"] for v in s["plain_calls"].values()), s
    # one launch a chromosome group (chr22 and chr8) a request
    assert sum(s["launches"]["bits_spans"] for s in summaries) == 32
    assert sum(s["launches"]["stats_panel"] for s in summaries) == 32


def test_device_bytes_stay_bounded_across_memtable_epochs(cuda, tmp_path):
    """Each upsert is a new serving generation whose interval index and
    feature columns are uploaded again; over 32 memtable epochs the
    engine's device ledger (capped here at three generations' bytes)
    evicts old generations, so its bytes and the card's allocated bytes
    stay bounded, and every answer equals a CPU engine's."""
    from annotatedvdb_tpu_torch.serve.engine import QueryEngine
    from annotatedvdb_tpu_torch.serve.snapshot import MemtableSnapshots, StaticSnapshots
    from annotatedvdb_tpu_torch.store import VariantStore
    from annotatedvdb_tpu_torch.store.memtable import Memtable
    from chip_smoke import build_serve_store, serve_panel

    served = build_serve_store(str(tmp_path), "cuda")
    specs = serve_panel(served, seed=29)
    engines, mems, bases = {}, {}, {}
    for plat in ("cuda", "cpu"):
        bases[plat] = VariantStore.load(served["store"], readonly=True)
        mems[plat] = Memtable(width=bases[plat].width, flush_bytes=0, flush_age_s=0)
        engines[plat] = QueryEngine(MemtableSnapshots(StaticSnapshots(bases[plat]),
                                                      mems[plat]), device=plat)
    eng = engines["cuda"]

    def epoch(k):
        rows = _upsert_rows(served, 3, 100 + k)
        for plat in ("cuda", "cpu"):
            mems[plat].upsert(bases[plat], rows, durable=False)
        got = {plat: (e.regions_serve(specs, limit=0).assemble(),
                      e.stats_serve(specs, windows=4).assemble())
               for plat, e in engines.items()}
        assert got["cuda"] == got["cpu"], k
        torch.cuda.synchronize()
        return eng.device_bytes(), torch.cuda.memory_allocated(cuda)

    one, _alloc = epoch(0)
    per_generation = len(eng._index_device)  # an index and columns a group
    assert one > 0 and per_generation == 4
    eng.INDEX_DEVICE_BYTES = 3 * one
    seen = [epoch(k) for k in range(1, 32)]
    assert all(b <= 3 * one for b, _a in seen), seen
    assert len(eng._index_device) <= 3 * per_generation
    # the allocated bytes plateau once the ledger is full
    assert seen[-1][1] <= max(a for _b, a in seen[2:6]) + (1 << 20), seen
    assert mems["cuda"].epoch == 32


def _engines_over(store_dir, manager_for):
    """A card engine and a host-only engine, each over its own manager
    from ``manager_for(store_dir)``."""
    from annotatedvdb_tpu_torch.serve.engine import QueryEngine
    from annotatedvdb_tpu_torch.serve.resilience import DeviceBreaker

    return {"cuda": QueryEngine(manager_for(store_dir), device="cuda",
                                breaker=DeviceBreaker()),
            "cpu": QueryEngine(manager_for(store_dir), device="cpu")}


def _card_reads_match_host(engines, specs, probe):
    """``/regions`` (three rows and count-only) and ``/stats/region`` on
    both engines: equal bodies, one ``bits_spans`` launch a group a
    ``/regions`` call and one ``stats_panel`` a group (of the groups at
    the device minimums), no plain version on the card."""
    from annotatedvdb_tpu_torch.ops import intervals, stats

    before = (intervals.LAUNCHES["bits_spans"], stats.LAUNCHES["stats_panel"],
              intervals.CALLS["cuda"], stats.CALLS["cuda"])
    out = {plat: [eng.regions_serve(specs, limit=3).assemble(),
                  eng.regions_serve(specs, limit=0).assemble(),
                  eng.stats_serve(specs, windows=4).assemble(),
                  eng.lookup(probe)]
           for plat, eng in engines.items()}
    assert out["cuda"] == out["cpu"]
    assert out["cuda"][3] is not None
    # the groups at the device minimums (32 intervals; chr3, absent from
    # the store, has two)
    per = {}
    for spec in specs:
        per[spec.split(":")[0]] = per.get(spec.split(":")[0], 0) + 1
    groups = sum(n >= 32 for n in per.values())
    assert intervals.LAUNCHES["bits_spans"] - before[0] == 2 * groups
    assert stats.LAUNCHES["stats_panel"] - before[1] == groups
    assert (intervals.CALLS["cuda"], stats.CALLS["cuda"]) == before[2:]
    assert engines["cuda"].breaker.stats() == {"open_groups": [], "groups": {}}


def test_compacted_flushed_store_serves_from_the_card(cuda, tmp_path):
    """A store grown by three memtable flushes (the last a retried flush
    of shadowed duplicates), compacted to one segment a group, served on
    the card: the bodies equal a host-only engine's and the kernels
    launch."""
    from annotatedvdb_tpu_torch.serve.snapshot import SnapshotManager
    from annotatedvdb_tpu_torch.store import VariantStore
    from annotatedvdb_tpu_torch.store.compact import compact_store, segment_spans
    from annotatedvdb_tpu_torch.store.memtable import Memtable
    from chip_smoke import build_serve_store, serve_panel

    served = build_serve_store(str(tmp_path), "cuda")
    store_dir = served["store"]
    batches = [_upsert_rows(served, 300, 31), _upsert_rows(served, 300, 32)]
    for rows, base in ((batches[0], True), (batches[1], True),
                       (batches[1], False)):
        mem = Memtable(width=VariantStore.load(store_dir, readonly=True).width,
                       store_dir=store_dir, wal=None, flush_bytes=0,
                       flush_age_s=0)
        mem.upsert(VariantStore.load(store_dir, readonly=True) if base else None,
                   rows, durable=False)
        assert mem.flush()["status"] == "flushed"
    assert segment_spans(store_dir)["22"] > 1
    report = compact_store(store_dir)
    # the retried flush's rows (its stored identity too) are the dropped
    assert report["status"] == "compacted" \
        and report["rows_dropped"] == len(batches[1])
    assert set(segment_spans(store_dir).values()) == {1}
    engines = _engines_over(store_dir, SnapshotManager)
    probe = f"22:{batches[1][0]['pos']}:A:{batches[1][0]['alt']}"
    _card_reads_match_host(engines, serve_panel(served, seed=29), probe)


def test_follower_generation_serves_from_the_card(cuda, tmp_path):
    """A follower bootstrapped from a host-only leader (the serve store
    with a WAL-tailed upsert, then a leader flush and a compaction it
    re-syncs across), served on the card through the follower's overlay
    wiring: the bodies equal a host-only engine's over the same
    generation."""
    import threading
    import types
    import urllib.request

    from annotatedvdb_tpu_torch.cli.serve import _open_follower
    from annotatedvdb_tpu_torch.obs.metrics import MetricsRegistry
    from annotatedvdb_tpu_torch.serve.engine import QueryEngine
    from annotatedvdb_tpu_torch.serve.http import build_server
    from annotatedvdb_tpu_torch.serve.resilience import DeviceBreaker
    from annotatedvdb_tpu_torch.serve.snapshot import (
        MemtableSnapshots,
        SnapshotManager,
    )
    from annotatedvdb_tpu_torch.store import VariantStore
    from annotatedvdb_tpu_torch.store.compact import compact_store
    from annotatedvdb_tpu_torch.store.memtable import Memtable
    from annotatedvdb_tpu_torch.store.replication import ReplicaTailer
    from annotatedvdb_tpu_torch.store.wal import WriteAheadLog
    from chip_smoke import build_serve_store, serve_panel

    served = build_serve_store(str(tmp_path / "leader"), "cuda")
    lead_dir = served["store"]
    mgr = SnapshotManager(lead_dir, ttl_s=0.0)
    mem = Memtable(width=mgr.current().store.width, store_dir=lead_dir,
                   wal=WriteAheadLog(lead_dir, "serve-w0"), flush_bytes=0,
                   flush_age_s=0)
    httpd = build_server(manager=MemtableSnapshots(mgr, mem), port=0,
                         memtable=mem, device="cpu")
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"

    def upsert(rows):
        body = {"variants": [{"id": f"22:{r['pos']}:{r['ref']}:{r['alt']}",
                              "ref_snp": r["ref_snp"],
                              "annotations": r["ann"]} for r in rows]}
        req = urllib.request.Request(url + "/variants/upsert",
                                     data=json.dumps(body).encode())
        with urllib.request.urlopen(req, timeout=60) as r:
            assert r.status == 200

    fdir = str(tmp_path / "follower")
    try:
        ReplicaTailer(fdir, url).bootstrap()
        followers = {}
        for plat in ("cuda", "cpu"):
            args = types.SimpleNamespace(storeDir=fdir, follow=url,
                                         _workerIndex=0 if plat == "cuda" else 1)
            followers[plat] = _open_follower(args, SnapshotManager(fdir, ttl_s=0.0),
                                             MetricsRegistry(), lambda m: None)
        rows = [_upsert_rows(served, 200, 41), _upsert_rows(served, 200, 42)]
        upsert(rows[0][:-1])
        for _m, tailer in followers.values():
            assert tailer.sync_once()["applied"] == 1
        engines = {plat: QueryEngine(m, device=plat, breaker=DeviceBreaker())
                   for plat, (m, _t) in followers.items()}
        specs = serve_panel(served, seed=37)
        probe = f"22:{rows[0][0]['pos']}:A:{rows[0][0]['alt']}"
        _card_reads_match_host(engines, specs, probe)
        assert mem.flush(mgr)["status"] == "flushed"
        upsert(rows[1][:-1])
        assert compact_store(lead_dir)["status"] == "compacted"
        for _m, tailer in followers.values():
            assert tailer.sync_once()["resynced"]
        _card_reads_match_host(engines, specs, probe)
        assert VariantStore.load(fdir, readonly=True).n \
            == VariantStore.load(lead_dir, readonly=True).n
    finally:
        httpd.shutdown()
        httpd.server_close()
        httpd.ctx.batcher.close()


# ------------------------------------------------------------ the mesh


def _multi_cols(cols, device, allele_offset=0):
    """The smoke's slice or query columns as the kernel takes them on
    ``device`` (the mixed hash as int64), the allele matrices
    ``allele_offset`` bytes into a larger buffer."""
    out = []
    for k, c in enumerate(cols):
        c = np.ascontiguousarray(c.astype(np.int64) if k == 2 else c)
        if k in (3, 4) and allele_offset:
            out.append(_offset_copy(c, device, allele_offset))
        else:
            out.append(torch.from_numpy(c).to(device))
    return out


@pytest.mark.parametrize("offset", [0, 1, 3])
@pytest.mark.parametrize("width", [1, 16, 31, 32, 33, 49, 65, 96])
def test_lookup_multi_matches_plain_version(cuda, width, offset):
    """Every edge slice (``lookup_multi_edge_cases``: warps mixing 0, 1
    and 4 pending candidates, rows off a 4-byte boundary among them) at
    widths below, at and past a warp's 32 lanes, the allele matrices
    aligned and off by one and three bytes."""
    from annotatedvdb_tpu_torch.ops import dedup
    from chip_smoke import lookup_multi_edge_cases

    for label, store, query in lookup_multi_edge_cases(width):
        s = _multi_cols(store, cuda, offset)
        q = _multi_cols(query, cuda, offset)
        before = dedup.LAUNCHES["lookup_multi"]
        got = dedup.lookup_in_sorted_multi(*s, *q)
        want = dedup.lookup_in_sorted_multi_reference(*s, *q)
        torch.cuda.synchronize()
        assert dedup.LAUNCHES["lookup_multi"] == before + 1
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g, w), label


def test_lookup_multi_bulk_shape_matches_plain_version(cuda):
    """The probe at a mesh serving bulk's shape on one shard: 64 queries
    against a slice of 125,000 rows padded to 131,072 (W = 49), three
    query sets."""
    from annotatedvdb_tpu_torch.ops import dedup
    from chip_smoke import (MESH_BULK_QUERIES, MESH_BULK_ROWS, WIDTH,
                            mesh_bulk_case, multi_queries)

    store, query = mesh_bulk_case()
    real = [c[:MESH_BULK_ROWS] for c in store]
    s = _multi_cols(store, cuda)
    for seed, q in ((None, query), (18, None), (19, None)):
        if q is None:
            q = multi_queries(seed, real, MESH_BULK_QUERIES, WIDTH)
        q = _multi_cols(q, cuda)
        before = dedup.LAUNCHES["lookup_multi"]
        got = dedup.lookup_in_sorted_multi(*s, *q)
        want = dedup.lookup_in_sorted_multi_reference(*s, *q)
        torch.cuda.synchronize()
        assert dedup.LAUNCHES["lookup_multi"] == before + 1
        assert int(want[0].sum()) > 0
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g, w)


def test_lookup_multi_refuses_bad_inputs(cuda):
    from annotatedvdb_tpu_torch.ops import dedup
    from chip_smoke import lookup_multi_edge_cases

    _label, store, query = lookup_multi_edge_cases(16)[0]
    s, q = _multi_cols(store, cuda), _multi_cols(query, cuda)
    with pytest.raises(TypeError, match="must be torch.int64"):
        dedup.lookup_in_sorted_multi(*s[:2], s[2].to(torch.int32), *s[3:], *q)
    with pytest.raises(ValueError, match="contiguous"):
        dedup.lookup_in_sorted_multi(*s, *q[:3], q[3].t().contiguous().t(),
                                     *q[4:])
    with pytest.raises(ValueError, match="is on cpu"):
        dedup.lookup_in_sorted_multi(*s, q[0].cpu(), *q[1:])
    with pytest.raises(ValueError, match="widths disagree"):
        dedup.lookup_in_sorted_multi(*s, *q[:3], q[3][:, :8].contiguous(),
                                     q[4][:, :8].contiguous(), *q[5:])


def test_bits_spans_stacked_matches_plain_version(cuda):
    from annotatedvdb_tpu_torch.ops import intervals
    from chip_smoke import stacked_bits_case, stacked_bits_edge_cases

    cases = stacked_bits_edge_cases()
    pos, starts, ends, _share = stacked_bits_case(152, scale=32)
    cases.append(("phase", pos, starts, ends))
    for label, pos, starts, ends in cases:
        t = [torch.from_numpy(np.ascontiguousarray(x)).to(cuda)
             for x in (pos, starts, ends)]
        before = intervals.LAUNCHES["bits_spans_stacked"]
        got = intervals.bits_spans_stacked(*t)
        want = intervals.bits_spans_stacked_reference(*t)
        torch.cuda.synchronize()
        assert intervals.LAUNCHES["bits_spans_stacked"] == before + 1
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g, w), label


def test_bits_spans_stacked_refuses_bad_inputs(cuda):
    from annotatedvdb_tpu_torch.ops import intervals

    pos = torch.zeros((3, 8), dtype=torch.int32, device=cuda)
    q = torch.zeros((3, 5), dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError, match="int32"):
        intervals.bits_spans_stacked(pos.to(torch.int64), q, q)
    with pytest.raises(ValueError, match="contiguous 2-D"):
        intervals.bits_spans_stacked(pos[:, ::2], q, q)
    with pytest.raises(ValueError, match="shapes disagree"):
        intervals.bits_spans_stacked(pos, q[:2], q[:2])
    with pytest.raises(ValueError, match="is on cpu"):
        intervals.bits_spans_stacked(pos, q.cpu(), q)


def _virtual_mesh(monkeypatch, n=4):
    """A mesh of ``n`` virtual shards of the card, the annotate kernel
    already checked there (its one-time probe launch is not counted)."""
    from annotatedvdb_tpu_torch.models.pipeline import annotate_hash_fn
    from annotatedvdb_tpu_torch.parallel import mesh as meshlib

    annotate_hash_fn(torch.device("cuda", 0))
    monkeypatch.setenv(meshlib.VIRTUAL_DEVICES_ENV, str(n))
    meshlib.reset_global_mesh()
    return meshlib.global_mesh(devices=meshlib.device_pool("cuda"))


def test_mesh_steps_on_card_match_cpu(cuda, monkeypatch, tmp_path):
    """The insert, update and serve-lookup steps over four virtual shards
    of the card equal a four-shard CPU mesh's, with one ``annotate_bin``
    and one ``lookup_multi`` launch a shard where the step runs them."""
    from annotatedvdb_tpu_torch.io.synth import synthetic_batch
    from annotatedvdb_tpu_torch.ops import dedup
    from annotatedvdb_tpu_torch.ops.hashing import allele_hash
    from annotatedvdb_tpu_torch.parallel import distributed as D
    from annotatedvdb_tpu_torch.parallel.device_store import (
        build_device_shard_store,
    )
    from annotatedvdb_tpu_torch.parallel.mesh import make_mesh
    from annotatedvdb_tpu_torch.store import VariantStore
    from annotatedvdb_tpu_torch.store.variant_store import Segment

    card = _virtual_mesh(monkeypatch)
    cpu = make_mesh(4, devices=[torch.device("cpu")] * 4)
    batch = synthetic_batch(1024, width=49, seed=5)
    for f in batch._fields:
        getattr(batch, f)[40:60] = getattr(batch, f)[0:20]
    h = allele_hash(*(torch.from_numpy(x) for x in batch[2:])).numpy().astype(np.uint32)
    store = VariantStore(width=49)
    for code in np.unique(batch.chrom[:300]):
        k = np.flatnonzero(batch.chrom[:300] == code)
        store.shard(int(code)).append_segment(Segment.build(
            {"pos": batch.pos[k], "h": h[k], "ref_len": batch.ref_len[k],
             "alt_len": batch.alt_len[k]}, batch.ref[k], batch.alt[k]))
    snap = build_device_shard_store(store, 4)
    pos_snap = build_device_shard_store(store, 4, routing="position")

    def run(mesh):
        hm = h ^ (batch.chrom.astype(np.uint32) * np.uint32(dedup.CHROM_MIX))
        return (D.distributed_insert_step(mesh, batch, dev_store=snap),
                D.distributed_update_step(mesh, batch, pos_snap,
                                          routing="position"),
                D.distributed_serve_lookup_step(
                    mesh, batch.chrom, batch.pos, hm, *batch[2:], snap))

    calls = dedup.CALLS["cuda"]
    before = (LAUNCHES["annotate_bin"], dedup.LAUNCHES["lookup_multi"])
    got = run(card)
    torch.cuda.synchronize()
    assert LAUNCHES["annotate_bin"] - before[0] == 8  # insert + update
    assert dedup.LAUNCHES["lookup_multi"] - before[1] == 12
    assert dedup.CALLS["cuda"] == calls
    want = run(cpu)
    assert int(want[0][3]["n_store_dup"]) > 0 and int(want[1][3]["n_matched"]) > 0
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            if isinstance(b, dict):
                for k in b:
                    np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            elif hasattr(b, "_fields"):
                ok = ~b.host_fallback
                for f in b._fields:
                    np.testing.assert_array_equal(getattr(a, f)[ok],
                                                  getattr(b, f)[ok], err_msg=f)
            else:
                np.testing.assert_array_equal(a, b)


def test_mesh_load_on_card_matches_single_device(cuda, monkeypatch, tmp_path):
    """``load-vcf --maxWorkers 4`` over four virtual shards of the card
    writes the single-device card load's store, with four ``annotate_bin``
    launches a chunk where the single-device load launches the packed
    entry once a chunk (and once in its warmup)."""
    from annotatedvdb_tpu_torch.cli.load_vcf import main
    from annotatedvdb_tpu_torch.models.pipeline import annotate_hash_fn, annotate_packed_fn

    vcf = str(tmp_path / "in.vcf")
    write_phase4_vcf(vcf, 20_000, seed=8)
    _virtual_mesh(monkeypatch)
    annotate_hash_fn(cuda)  # their once-per-process checks launch the kernel too
    annotate_packed_fn(cuda)
    launches = {}
    for tag, workers in (("mesh", "4"), ("single", "1")):
        before = dict(LAUNCHES)
        assert main(["--fileName", vcf, "--storeDir", str(tmp_path / tag),
                     "--commit", "--commitAfter", "4096",
                     "--maxWorkers", workers]) == 0
        launches[tag] = {k: LAUNCHES[k] - before[k] for k in LAUNCHES}
    with open(tmp_path / "single" / "ledger.jsonl") as f:
        chunks = sum('"checkpoint"' in line for line in f)
    assert chunks >= 5
    assert launches["mesh"] == {"annotate_bin": 4 * chunks, "annotate_bin_packed": 0,
                                "annotate_bin_identity": 0}
    assert launches["single"] == {"annotate_bin": 0, "annotate_bin_identity": 0,
                                  "annotate_bin_packed": chunks + WARMUP_PACKED}
    assert store_bytes(str(tmp_path / "mesh")) == store_bytes(str(tmp_path / "single"))


def test_mesh_executor_on_card_matches_host_engine(cuda, monkeypatch, tmp_path):
    """A ``MeshExecutor`` over four virtual shards of the card (what
    ``serve`` builds under ``AVDB_SERVE_MESH=1``) answers bulk lookups and
    region panels with a host-only engine's bytes, through one
    ``lookup_multi`` launch a shard per bulk and one stacked BITS launch a
    shard per panel, no plain version on the card and no breaker
    failure."""
    from annotatedvdb_tpu_torch.ops import dedup, intervals
    from annotatedvdb_tpu_torch.serve.engine import QueryEngine
    from annotatedvdb_tpu_torch.serve.mesh_exec import MeshExecutor
    from annotatedvdb_tpu_torch.serve.resilience import DeviceBreaker
    from annotatedvdb_tpu_torch.serve.snapshot import StaticSnapshots
    from annotatedvdb_tpu_torch.store import VariantStore
    from chip_smoke import build_serve_store, serve_panel

    served = build_serve_store(str(tmp_path), "cuda")
    mesh = _virtual_mesh(monkeypatch)
    store = VariantStore.load(served["store"], readonly=True)
    breaker = DeviceBreaker()
    meshed = QueryEngine(StaticSnapshots(store), device="cuda", breaker=breaker,
                         region_cache_size=0,
                         mesh=MeshExecutor(mesh, breaker=breaker, bulk_min=0))
    host = QueryEngine(StaticSnapshots(store), device="cpu", region_cache_size=0)
    specs = serve_panel(served, seed=4)
    before = (dedup.LAUNCHES["lookup_multi"],
              intervals.LAUNCHES["bits_spans_stacked"],
              dedup.CALLS["cuda"], intervals.CALLS["cuda"])
    for _ in range(2):
        assert meshed.lookup_many(served["ids"]) == host.lookup_many(served["ids"])
        assert meshed.regions_serve(specs, limit=4).assemble() \
            == host.regions_serve(specs, limit=4).assemble()
    assert dedup.LAUNCHES["lookup_multi"] - before[0] == 2 * 4
    assert intervals.LAUNCHES["bits_spans_stacked"] - before[1] == 2 * 4
    assert (dedup.CALLS["cuda"], intervals.CALLS["cuda"]) == before[2:]
    assert breaker.stats() == {"open_groups": [], "groups": {}}
    assert meshed.mesh.stats()["resident_bytes"] > 0
