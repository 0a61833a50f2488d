"""The annotate kernel's packed entry: the port against the JAX package.

``annotatedvdb_tpu_torch/ops/annotate_cuda.py::annotate_bin_packed`` takes
the nibble-packed allele matrices of the packed transport and returns the
``[n, 10]`` rows of ``pack_outputs``; on the CPU it is its plain
composition (``inflate_alleles_reference`` -> ``annotate_bin_reference`` ->
``pack_outputs_reference``).  Here that route is held against the JAX
package's own chain on CPU JAX: ``ops/pack.py::inflate_alleles_jit``, the
annotate step ``models/pipeline.py::annotate_pipeline_jit`` with
``ops/hashing.py::allele_hash_jit``, then ``ops/pack.py::pack_outputs_jit``
with a zero dup lane, on the same seeded numpy inputs
(``chip_smoke.annotate_packed_cases``: W = 1, 2, 7, 8, 49, 96, 192;
``ceil(W / 2)`` and ``ceil(W / 2) + 3`` packed columns; every packed byte
value with codes 14 and 15, over-width and SNV rows, the edge rows; the
first 0, 1, 127, 128, 129 and 257 rows and all of them).  Exact under the
selection contract: bytes 0-3 (hash) and 9 (flags) on every row, bytes 4-8
(leaf bin, bin level) where host_fallback is clear.  Then the wrapper's
argument checks, the contract's own check (``packed_mismatches``), and
the VCF load's route choice on the CPU under ``AVDB_PACK_TRANSPORT=always``:
nibble-packed chunks take the packed step, the raw chunk the annotate step
and a pack, and the store is the reference's.
"""

import numpy as np
import pytest
import torch

from annotatedvdb_tpu.models.pipeline import annotate_pipeline_jit
from annotatedvdb_tpu.ops import pack as R
from annotatedvdb_tpu.ops.hashing import allele_hash_jit

from annotatedvdb_tpu_torch.models import pipeline
from annotatedvdb_tpu_torch.models.pipeline import packed_mismatches
from annotatedvdb_tpu_torch.ops import annotate_cuda
from annotatedvdb_tpu_torch.ops.annotate_cuda import MAX_WIDTH, annotate_bin_packed
from chip_smoke import annotate_packed_cases

WIDTHS = [1, 2, 7, 8, 49, 96, 192]
ROWS = [0, 1, 127, 128, 129, 257, None]


def _reference(pos, rp, ap, rl, al, width) -> np.ndarray:
    """The JAX package's chain: inflate, annotate, hash, pack."""
    ref, alt = R.inflate_alleles_jit(rp, ap, width)
    chrom = np.ones(pos.shape[0], np.int32)
    ann = annotate_pipeline_jit(chrom, pos, ref, alt, rl, al)
    h = allele_hash_jit(ref, alt, rl, al)
    dup = np.zeros(pos.shape[0], bool)
    return np.array(R.pack_outputs_jit(h, dup, ann.bin_level, ann.leaf_bin,
                                         ann.needs_digest, ann.host_fallback))


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("extra_cols", [0, 3], ids=["cols", "cols+3"])
@pytest.mark.parametrize("width", WIDTHS)
def test_packed_route_matches_reference(width, extra_cols):
    case = annotate_packed_cases(width, extra_cols)
    want = _reference(*case, width)
    assert want.shape == (case[0].shape[0], 10)
    for n in ROWS:
        cut = [x[:n] for x in case]
        got = annotate_bin_packed(*(_t(x) for x in cut), width)
        assert got.dtype == torch.uint8 and got.shape == (cut[0].shape[0], 10)
        assert packed_mismatches(_t(want[:n]), got) == [], (width, extra_cols, n)
    fallback = (want[:, 9] & 4) != 0
    assert fallback.any() and not fallback.all()


@pytest.mark.parametrize("width", [7, 49])
def test_packed_route_takes_codes_14_and_15_as_zero(width):
    """A row whose codes are all 14 or 15 is the row of zero bytes."""
    cols = (width + 1) // 2
    n = 4
    pos = np.full(n, 1000, np.int32)
    lens = np.full(n, 3, np.int32)
    for code in (0xEE, 0xFF, 0xEF, 0x00):
        packed = np.full((n, cols), code, np.uint8)
        got = annotate_bin_packed(_t(pos), _t(packed), _t(packed), _t(lens),
                                  _t(lens), width)
        zero = np.zeros((n, cols), np.uint8)
        want = annotate_bin_packed(_t(pos), _t(zero), _t(zero), _t(lens),
                                   _t(lens), width)
        assert torch.equal(got, want), hex(code)
        np.testing.assert_array_equal(got.numpy(), _reference(pos, packed, packed,
                                                              lens, lens, width))


def test_decode_table_in_the_kernel_source():
    """The packed entry decodes with the reference's table: the two 64-bit
    constants of ``csrc/pack.cu`` stand in ``csrc/annotate_bin.cu`` too."""
    lo = sum(int(R._DEC[c]) << (8 * c) for c in range(8))
    hi = sum(int(R._DEC[c + 8]) << (8 * c) for c in range(8))
    src = open(annotate_cuda.__file__.replace("ops/annotate_cuda.py",
                                              "csrc/annotate_bin.cu")).read()
    assert f"0x{lo:016X}ull" in src and f"0x{hi:016X}ull" in src


def test_packed_wrapper_checks_its_arguments():
    n = 4
    i32 = torch.zeros(n, dtype=torch.int32)
    p = torch.zeros((n, 25), dtype=torch.uint8)
    assert annotate_bin_packed(i32, p, p, i32, i32, 49).shape == (n, 10)
    assert annotate_bin_packed(i32[:0], p[:0], p[:0], i32[:0], i32[:0], 49).shape == (0, 10)
    with pytest.raises(TypeError, match="pos must be"):
        annotate_bin_packed(i32.to(torch.int64), p, p, i32, i32, 49)
    with pytest.raises(TypeError, match="ref_packed must be"):
        annotate_bin_packed(i32, p.to(torch.int8), p, i32, i32, 49)
    with pytest.raises(ValueError, match="contiguous"):
        annotate_bin_packed(i32, p[:, ::2], p[:, ::2], i32, i32, 25)
    with pytest.raises(ValueError, match="alt_packed"):
        annotate_bin_packed(i32, p, torch.zeros((n, 24), dtype=torch.uint8), i32, i32, 47)
    with pytest.raises(ValueError, match="row counts"):
        annotate_bin_packed(i32[:3], p, p, i32, i32, 49)
    with pytest.raises(ValueError, match="packed columns"):
        annotate_bin_packed(i32, p, p, i32, i32, 51)
    with pytest.raises(ValueError, match="allele width"):
        annotate_bin_packed(i32, p, p, i32, i32, 0)
    wide = torch.zeros((n, MAX_WIDTH + 1), dtype=torch.uint8)
    with pytest.raises(ValueError, match="allele width"):
        annotate_bin_packed(i32, wide, wide, i32, i32, MAX_WIDTH + 1)
    with pytest.raises(ValueError, match="packed columns"):
        annotate_bin_packed(i32, wide, wide, i32, i32, MAX_WIDTH)
    with pytest.raises(ValueError, match="is on"):
        annotate_bin_packed(i32, p, p.to("meta"), i32, i32, 49)


def test_packed_mismatches_keeps_the_selection_contract():
    """Bytes 4-8 of a host_fallback row may differ, any other byte may
    not."""
    case = annotate_packed_cases(49)
    want = annotate_bin_packed(*(_t(x) for x in case), 49)
    fb = ((want[:, 9] & 4) != 0).nonzero().flatten()
    ok = ((want[:, 9] & 4) == 0).nonzero().flatten()
    assert fb.numel() and ok.numel()
    got = want.clone()
    got[fb, 4:9] ^= 0x5A
    assert packed_mismatches(want, got) == []
    for cols, name in ((slice(0, 1), "allele_hash"), (slice(9, 10), "flags")):
        bad = want.clone()
        bad[fb[0], cols] ^= 1
        assert packed_mismatches(want, bad) == [name]
    for col, name in ((4, "leaf_bin"), (8, "bin_level")):
        bad = want.clone()
        bad[ok[0], col] ^= 1
        assert packed_mismatches(want, bad) == [name]


def test_packed_step_is_the_wrapper_on_the_cpu():
    assert pipeline.annotate_packed_fn("cpu") is annotate_bin_packed
    with pytest.raises(ValueError, match="no packed annotate step"):
        pipeline.annotate_packed_fn("meta")


@pytest.mark.parametrize("engine", ["native", "python"])
def test_load_routes_nibble_chunks_to_the_packed_step(tmp_path, monkeypatch, engine):
    """Under ``AVDB_PACK_TRANSPORT=always`` on the CPU every nibble-packed
    chunk takes the packed step (its plain composition once a chunk) and
    the one raw chunk (a symbolic allele) the annotate step and a pack;
    the store is the reference's, byte for byte."""
    from test_torch_transport import _assert_same_store, _port_load, _ref_load, _with_symbolic

    vcf = str(tmp_path / "t.vcf")
    _with_symbolic(vcf)
    ref_dir, port_dir = str(tmp_path / "ref"), str(tmp_path / "port")
    _ref_load(vcf, ref_dir, monkeypatch, engine, "overlapped", wanted=True)
    seen = {"packed": 0, "fields": 0}
    real_packed = annotate_cuda.annotate_bin_packed_reference
    real_step = pipeline.annotate_hash_pipeline

    def packed(*args):
        seen["packed"] += 1
        return real_packed(*args)

    def step(*args):
        seen["fields"] += 1
        return real_step(*args)

    monkeypatch.setattr(annotate_cuda, "annotate_bin_packed_reference", packed)
    monkeypatch.setattr(pipeline, "annotate_hash_pipeline", step)
    _c, loader = _port_load(vcf, port_dir, monkeypatch, engine, "overlapped",
                            mode="always")
    _assert_same_store(ref_dir, port_dir)
    t = loader.transport
    assert t["raw"] == 1 and t["nibble"] > 4 and t["packed"] == t["nibble"] + 1, t
    assert seen == {"packed": t["nibble"], "fields": t["raw"]}, (seen, t)
