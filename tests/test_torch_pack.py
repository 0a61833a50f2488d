"""The packed transport's device functions: the port against the JAX package.

``annotatedvdb_tpu_torch/ops/pack.py``'s plain versions (the CPU path of
``pack_outputs``, ``pack_vep_outputs`` and ``inflate_alleles``) against the
reference's jitted ``pack_outputs_jit``, ``pack_vep_outputs_jit`` and
``inflate_alleles_jit`` on CPU JAX and against the numpy twins, on the
same seeded numpy inputs (``chip_smoke.pack_outputs_cases``,
``pack_inflate_cases``: levels and prefixes of 255 and above, extreme
leaf bins, hash 0 and 0xFFFFFFFF, n = 1, widths 1 to 96 with all 16
nibble codes), exactly (tolerance 0: byte layouts).  Then the host
helpers (``encode_alleles_nibble``, the ``unpack_*`` functions) against
the reference's, the ``AVDB_PACK_TRANSPORT`` gate per device, the
wrappers' argument checks, a probe that raises on a wrong result, and
the readers: ``identity_only`` chunks and the tokenizer's pre-packed
matrices against the reference reader's, on both engines.
"""

import numpy as np
import pytest
import torch

from annotatedvdb_tpu.io.vcf import VcfBatchReader as RefReader
from annotatedvdb_tpu.ops import pack as R

from annotatedvdb_tpu_torch.io.vcf import VcfBatchReader
from annotatedvdb_tpu_torch.ops import pack as P
from chip_smoke import pack_inflate_cases, pack_outputs_cases
from test_torch_load_vcf import _write_vcf

INFLATE_WIDTHS = [1, 2, 7, 8, 16, 49, 96]


def _t(x):
    return None if x is None else torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("label", [c[0] for c in pack_outputs_cases()])
def test_pack_outputs_matches_reference(label):
    (h, dup, level, leaf, nd, hf), = [c for lb, c in pack_outputs_cases() if lb == label]
    dup_np = np.zeros(h.shape[0], bool) if dup is None else dup
    want = np.asarray(R.pack_outputs_jit(h, dup_np, level, leaf, nd, hf))
    np.testing.assert_array_equal(R.pack_outputs_np(h, dup_np, level, leaf, nd, hf), want)
    np.testing.assert_array_equal(P.pack_outputs_np(h, dup_np, level, leaf, nd, hf), want)
    for hh in (h, h.view(np.int32)):  # uint32 values, and the kernel's int32 bits
        got = P.pack_outputs(_t(hh), _t(dup), _t(level), _t(leaf), _t(nd), _t(hf))
        assert got.dtype == torch.uint8 and got.shape == (h.shape[0], P.WIDTH)
        np.testing.assert_array_equal(got.numpy(), want)
    cols = P.unpack_outputs(want)
    ref_cols = R.unpack_outputs(want)
    assert cols.keys() == ref_cols.keys()
    for k in cols:
        np.testing.assert_array_equal(cols[k], ref_cols[k])
        assert cols[k].dtype == ref_cols[k].dtype, k
    np.testing.assert_array_equal(cols["h"], h)
    np.testing.assert_array_equal(cols["leaf_bin"], leaf)
    np.testing.assert_array_equal(cols["bin_level"], level.astype(np.int64) & 0xFF)


@pytest.mark.parametrize("label", [c[0] for c in pack_outputs_cases()])
def test_pack_vep_outputs_matches_reference(label):
    (h, _dup, prefix, _leaf, _nd, hf), = [c for lb, c in pack_outputs_cases()
                                           if lb == label]
    want = np.asarray(R.pack_vep_outputs_jit(h, prefix, hf))
    np.testing.assert_array_equal(R.pack_vep_outputs_np(h, prefix, hf), want)
    np.testing.assert_array_equal(P.pack_vep_outputs_np(h, prefix, hf), want)
    got = P.pack_vep_outputs(_t(h.view(np.int32)), _t(prefix), _t(hf))
    assert got.shape == (h.shape[0], P.VEP_WIDTH)
    np.testing.assert_array_equal(got.numpy(), want)
    cols, ref_cols = P.unpack_vep_outputs(want), R.unpack_vep_outputs(want)
    for k in ref_cols:
        np.testing.assert_array_equal(cols[k], ref_cols[k])
        assert cols[k].dtype == ref_cols[k].dtype, k


@pytest.mark.parametrize("width", INFLATE_WIDTHS)
def test_inflate_alleles_matches_reference(width):
    for label, rp, ap, w in pack_inflate_cases(width):
        want = [np.asarray(x) for x in R.inflate_alleles_jit(rp, ap, w)]
        twin = R.inflate_alleles_np(rp, ap, w)
        mine = P.inflate_alleles_np(rp, ap, w)
        got = P.inflate_alleles(_t(rp), _t(ap), w)
        for k in range(2):
            np.testing.assert_array_equal(twin[k], want[k], err_msg=label)
            np.testing.assert_array_equal(mine[k], want[k], err_msg=label)
            assert got[k].shape == (rp.shape[0], w) and got[k].is_contiguous()
            np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=label)


def test_decode_table_has_all_sixteen_codes():
    """Codes 14 and 15 decode to 0 in both packages; the kernel's two
    64-bit constants are this table."""
    np.testing.assert_array_equal(P._DEC, R._DEC)
    np.testing.assert_array_equal(P._ENC, R._ENC)
    assert P._DEC[14] == P._DEC[15] == 0
    lo = sum(int(P._DEC[c]) << (8 * c) for c in range(8))
    hi = sum(int(P._DEC[c + 8]) << (8 * c) for c in range(8))
    src = open(P.__file__.replace("ops/pack.py", "csrc/pack.cu")).read()
    assert f"0x{lo:016X}ull" in src and f"0x{hi:016X}ull" in src


@pytest.mark.parametrize("width", [1, 2, 7, 16, 49])
def test_encode_alleles_nibble_matches_reference(width):
    rng = np.random.default_rng(width)
    letters = np.frombuffer(b"ACGTNacgtn*.-\0", np.uint8)
    ref = letters[rng.integers(0, letters.size, (64, width))]
    alt = letters[rng.integers(0, letters.size, (64, width))]
    want, got = R.encode_alleles_nibble(ref, alt), P.encode_alleles_nibble(ref, alt)
    for w, g in zip(want, got):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(P.inflate_alleles_np(*got, width)[0], ref)
    for bad in (b"<", b"[", b"X", b"\xff"):
        alt2 = alt.copy()
        alt2[3, 0] = bad[0]
        assert R.encode_alleles_nibble(ref, alt2) is None
        assert P.encode_alleles_nibble(ref, alt2) is None


@pytest.mark.parametrize("mode,cpu,cuda", [
    ("always", True, True), ("never", False, False), ("0", False, True),
    (None, False, True), ("auto", False, True), ("yes", False, True),
])
def test_transport_wanted_per_device(monkeypatch, mode, cpu, cuda):
    """``always`` / ``never`` everywhere; any other value (``0`` included,
    as in the reference's code) is auto: exactly a CUDA device.  Read at
    each call: the same process answers for both devices."""
    if mode is None:
        monkeypatch.delenv("AVDB_PACK_TRANSPORT", raising=False)
    else:
        monkeypatch.setenv("AVDB_PACK_TRANSPORT", mode)
    assert P.transport_wanted("cpu") is cpu
    assert P.transport_wanted(torch.device("cpu")) is cpu
    assert P.transport_wanted(torch.device("cuda", 0)) is cuda
    assert P.transport_wanted("cuda") is cuda


def test_probes_pass_on_the_cpu_and_raise_on_a_wrong_result(monkeypatch):
    """The 4-row probes pass through the plain versions; a pack whose bytes
    are wrong makes the probe raise (no quiet fallback), and the failed
    probe is not latched."""
    monkeypatch.setattr(P, "_VERIFIED", set())
    P.ensure_transport("cpu")
    P.ensure_nibble("cpu")
    assert {("transport", "cpu"), ("nibble", "cpu")} <= P._VERIFIED
    monkeypatch.setattr(P, "_VERIFIED", set())
    real = P.pack_outputs_reference
    monkeypatch.setattr(P, "pack_outputs_reference",
                        lambda *a: real(*a).flip(0))
    with pytest.raises(RuntimeError, match="packed transport probe mismatched"):
        P.ensure_transport("cpu")
    assert ("transport", "cpu") not in P._VERIFIED
    real_inflate = P.inflate_alleles_reference
    monkeypatch.setattr(P, "inflate_alleles_reference",
                        lambda r, a, w: tuple(x.roll(1, 1) for x in real_inflate(r, a, w)))
    with pytest.raises(RuntimeError, match="nibble transport probe mismatched"):
        P.ensure_nibble("cpu")


def test_wrappers_check_their_arguments():
    n = 4
    h, leaf = torch.zeros(n, dtype=torch.int32), torch.zeros(n, dtype=torch.int32)
    b = torch.zeros(n, dtype=torch.bool)
    with pytest.raises(TypeError, match="leaf_bin"):
        P.pack_outputs(h, b, b, leaf.to(torch.int64), b, b)
    with pytest.raises(TypeError, match="h must"):
        P.pack_outputs(h.to(torch.float32), b, b, leaf, b, b)
    with pytest.raises(TypeError, match="needs_digest"):
        P.pack_outputs(h, b, b, leaf, leaf, b)
    with pytest.raises(ValueError, match="contiguous"):
        P.pack_outputs(h, b, b, torch.zeros(2 * n, dtype=torch.int32)[::2], b, b)
    with pytest.raises(TypeError, match="prefix_len"):
        P.pack_vep_outputs(h, leaf.to(torch.int64), b)
    packed = torch.zeros((n, 3), dtype=torch.uint8)
    with pytest.raises(ValueError, match="packed columns"):
        P.inflate_alleles(packed, packed, 7)
    with pytest.raises(TypeError, match="uint8"):
        P.inflate_alleles(packed.to(torch.int8), packed, 5)
    with pytest.raises(ValueError, match="shaped like"):
        P.inflate_alleles(packed, torch.zeros((n, 4), dtype=torch.uint8), 5)
    # every output byte of an empty call, and a null dup
    assert P.pack_outputs(h[:0], None, b[:0], leaf[:0], b[:0], b[:0]).shape == (0, 10)
    assert P.inflate_alleles(packed, packed, 6)[0].shape == (n, 6)


# ---------------------------------------------------------------- readers


def _symbolic_vcf(path):
    """A small VCF with a symbolic and a breakend allele (unpackable) in
    its second half, INFO on every line."""
    with open(path, "w") as fh:
        fh.write("##fileformat=VCFv4.2\n#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n")
        for k in range(60):
            alt = "<DEL>" if k == 45 else "A[2:300[" if k == 50 else "ACGTn*"[k % 6]
            fh.write(f"1\t{100 + k}\t.\tC\t{alt}\t.\t.\tRS={k};FREQ=G:0.9,0.1\n")


@pytest.mark.parametrize("engine", ["python", "native"])
@pytest.mark.parametrize("identity_only", [False, True], ids=["info", "identity"])
def test_reader_chunks_match_reference(tmp_path, engine, identity_only):
    """Both readers, ``identity_only`` on and off, on both engines: the
    batch, the per-row columns, INFO and its views (``info``,
    ``info_raw``, ``ref_snp``, ``frequencies``) and the pre-packed
    matrices with their ``alleles_packable`` flag, chunk by chunk."""
    path = str(tmp_path / "r.vcf")
    _write_vcf(path, n_lines=700, seed=41)
    sym = str(tmp_path / "s.vcf")
    _symbolic_vcf(sym)
    for p in (path, sym):
        ref = list(RefReader(p, batch_size=32, engine=engine,
                             identity_only=identity_only))
        got = list(VcfBatchReader(p, batch_size=32, engine=engine,
                                  identity_only=identity_only))
        assert len(got) == len(ref)
        for a, b in zip(ref, got):
            for name in a.batch._fields:
                np.testing.assert_array_equal(getattr(b.batch, name),
                                              getattr(a.batch, name))
            for name in ("info", "info_raw", "ref_snp", "rs_position", "variant_id"):
                va, vb = getattr(a, name), getattr(b, name)
                assert (None if va is None else list(va)) == \
                    (None if vb is None else list(vb)), name
            assert [None if v is None else getattr(v, "text", v) for v in a.frequencies] \
                == [None if v is None else getattr(v, "text", v) for v in b.frequencies]
            np.testing.assert_array_equal(b.has_freq, a.has_freq)
            np.testing.assert_array_equal(b.rs_number, a.rs_number)
            assert b.alleles_packable == a.alleles_packable
            for name in ("ref_packed", "alt_packed"):
                va, vb = getattr(a, name), getattr(b, name)
                assert (va is None) == (vb is None), name
                if va is not None:
                    np.testing.assert_array_equal(vb, va)
        if identity_only:
            assert all(not any(c.info) and not c.has_freq.any() for c in got)
        if engine == "native" and p == sym:
            assert [c.alleles_packable for c in got if c.batch.n] == [True, False]


def test_reader_prepacked_matrices_match_the_host_encoder(tmp_path):
    """The tokenizer's in-scan pack equals ``encode_alleles_nibble`` on the
    chunk's matrices wherever the chunk packs, and a chunk the encoder
    refuses carries none; ``pack_alleles=False`` packs nothing."""
    path = str(tmp_path / "p.vcf")
    _write_vcf(path, n_lines=500, seed=43)
    with open(path, "a") as fh:
        fh.write("1\t99999\t.\tA\t<INS>\t.\t.\t.\n")
    chunks = list(VcfBatchReader(path, batch_size=64, engine="native"))
    assert any(c.ref_packed is None for c in chunks if c.batch.n)
    for c in chunks:
        if c.batch.n == 0:
            continue
        enc = P.encode_alleles_nibble(c.batch.ref, c.batch.alt)
        assert (c.ref_packed is None) == (enc is None)
        if enc is not None:
            np.testing.assert_array_equal(c.ref_packed, enc[0])
            np.testing.assert_array_equal(c.alt_packed, enc[1])
    for c in VcfBatchReader(path, batch_size=64, engine="native", pack_alleles=False):
        assert c.ref_packed is None and c.alleles_packable is None
