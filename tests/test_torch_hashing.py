"""The port's allele-identity hash against the JAX package's.

``ops.hashing.allele_hash`` (int64 torch state masked to 32 bits) versus
``allele_hash_np`` and ``allele_hash_jit`` on seeded allele matrices,
lengths above 255 included (only ``len & 0xFF`` is hashed).  Exact
comparison (tolerance 0)."""

import numpy as np
import pytest
import torch

from annotatedvdb_tpu.ops.hashing import allele_hash_jit, allele_hash_np

from annotatedvdb_tpu_torch.ops.hashing import allele_hash, to_uint32


def _alleles(seed: int, n: int, width: int):
    rng = np.random.default_rng(seed)
    ref = rng.integers(0, 256, (n, width)).astype(np.uint8)
    alt = rng.integers(0, 256, (n, width)).astype(np.uint8)
    rl = rng.integers(0, 700, n).astype(np.int32)
    al = rng.integers(0, 700, n).astype(np.int32)
    rl[:4] = [255, 256, 511, 1]
    al[:4] = [1, 256, 0, 257]
    return ref, alt, rl, al


@pytest.mark.parametrize("width", [1, 8, 49])
def test_allele_hash_matches_numpy_and_jit(width):
    ref, alt, rl, al = _alleles(width, 1000, width)
    got = to_uint32(allele_hash(*(torch.from_numpy(x) for x in (ref, alt, rl, al))))
    assert got.dtype == np.uint32
    np.testing.assert_array_equal(got, allele_hash_np(ref, alt, rl, al))
    np.testing.assert_array_equal(got, np.asarray(allele_hash_jit(ref, alt, rl, al)))


def test_length_byte_wraps_at_256():
    ref = np.zeros((2, 4), np.uint8)
    h = to_uint32(allele_hash(torch.from_numpy(ref), torch.from_numpy(ref),
                              torch.tensor([3, 259], dtype=torch.int32),
                              torch.tensor([1, 1], dtype=torch.int32)))
    assert h[0] == h[1]
