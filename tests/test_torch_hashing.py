"""The port's allele-identity hash against the JAX package's.

``ops.hashing.allele_hash`` (int64 torch state masked to 32 bits) versus
``allele_hash_np`` and ``allele_hash_jit`` on seeded allele matrices,
lengths above 255 included (only ``len & 0xFF`` is hashed).  Exact
comparison (tolerance 0).  Also: the int32 bit form the fused CUDA kernel
returns (and the CPU step hands on) reads back to the same uint32 values,
and on CPU tensors the loader's dispatch still computes the hash with the
plain version."""

import numpy as np
import pytest
import torch

from annotatedvdb_tpu.ops.hashing import allele_hash_jit, allele_hash_np

from annotatedvdb_tpu_torch.ops.hashing import CALLS, allele_hash, hash_bits, to_uint32


def _alleles(seed: int, n: int, width: int):
    rng = np.random.default_rng(seed)
    ref = rng.integers(0, 256, (n, width)).astype(np.uint8)
    alt = rng.integers(0, 256, (n, width)).astype(np.uint8)
    rl = rng.integers(0, 700, n).astype(np.int32)
    al = rng.integers(0, 700, n).astype(np.int32)
    rl[:4] = [255, 256, 511, 1]
    al[:4] = [1, 256, 0, 257]
    return ref, alt, rl, al


@pytest.mark.parametrize("width", [1, 8, 49, 96])
def test_allele_hash_matches_numpy_and_jit(width):
    ref, alt, rl, al = _alleles(width, 1000, width)
    got = to_uint32(hash_bits(allele_hash(*(torch.from_numpy(x)
                                            for x in (ref, alt, rl, al)))))
    assert got.dtype == np.uint32
    np.testing.assert_array_equal(got, allele_hash_np(ref, alt, rl, al))
    np.testing.assert_array_equal(got, np.asarray(allele_hash_jit(ref, alt, rl, al)))


def test_length_byte_wraps_at_256():
    ref = np.zeros((2, 4), np.uint8)
    h = allele_hash(torch.from_numpy(ref), torch.from_numpy(ref),
                    torch.tensor([3, 259], dtype=torch.int32),
                    torch.tensor([1, 1], dtype=torch.int32))
    assert h[0] == h[1]


@pytest.mark.parametrize("width", [1, 49])
def test_hash_bits_read_back_as_the_same_uint32(width):
    ref, alt, rl, al = _alleles(100 + width, 500, width)
    h = allele_hash(*(torch.from_numpy(x) for x in (ref, alt, rl, al)))
    bits = hash_bits(h)
    assert bits.dtype == torch.int32
    want = allele_hash_np(ref, alt, rl, al)
    assert (want >= 2**31).any() and (want < 2**31).any()
    np.testing.assert_array_equal(to_uint32(bits), want)
    np.testing.assert_array_equal(bits.numpy().view(np.uint32), want)


def test_to_uint32_reads_only_the_bit_form():
    h = allele_hash(*(torch.from_numpy(x) for x in _alleles(7, 16, 8)))
    with pytest.raises(TypeError, match="int32"):
        to_uint32(h)


def test_cpu_dispatch_calls_the_plain_hash(tmp_path):
    """On CPU tensors the loader's dispatch takes the hash from the plain
    ``allele_hash`` (one call per chunk) and never launches the kernel.
    The chunk comes from the Python engine, which carries no tokenizer
    hash, so the dispatch hands the step's hash on."""
    from annotatedvdb_tpu_torch.io.vcf import VcfBatchReader
    from annotatedvdb_tpu_torch.loaders import VcfLoader
    from annotatedvdb_tpu_torch.ops.annotate_cuda import LAUNCHES
    from annotatedvdb_tpu_torch.store import AlgorithmLedger, VariantStore

    vcf = tmp_path / "mini.vcf"
    rows = ["##fileformat=VCFv4.2",
            "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO"]
    rows += [f"1\t{100 + 7 * i}\trs{i}\t{'ACGT'[i % 4]}\t{'CGTA'[i % 4]}"
             f"{'A' * (i % 3)}\t.\t.\t." for i in range(40)]
    rows.append(f"1\t1000\t.\tA{'C' * 70}\tA\t.\t.\t.")  # over the width
    vcf.write_text("\n".join(rows) + "\n")
    loader = VcfLoader(VariantStore(width=49),
                       AlgorithmLedger(str(tmp_path / "ledger.jsonl")),
                       log=lambda *a: None, device="cpu")
    chunk = next(iter(VcfBatchReader(str(vcf), batch_size=64, width=49,
                                     engine="python")))
    assert chunk.h_native is None
    before, launches = dict(CALLS), dict(LAUNCHES)
    h = loader._dispatch_chunk(chunk)["cols"]["h"]
    assert h.dtype == torch.int32  # the kernel's form
    assert CALLS["cpu"] == before["cpu"] + 1
    assert CALLS["cuda"] == before["cuda"] and LAUNCHES == launches
    b = chunk.batch
    np.testing.assert_array_equal(
        to_uint32(h),
        allele_hash_np(b.ref, b.alt, b.ref_len, b.alt_len))
