"""The port's closed-form bin index against the JAX package's.

``ops.binindex.bin_index_kernel`` (plain torch) versus
``bin_index_kernel_jit`` and the scalar oracle ``closed_form_bin`` on
seeded intervals, the 15625/15626 leaf edge, 64 Mb-straddling spans and
the pad sentinel.  Exact comparison (tolerance 0)."""

import numpy as np
import pytest
import torch

from annotatedvdb_tpu.ops.binindex import bin_index_kernel_jit
from annotatedvdb_tpu.oracle.binindex import closed_form_bin

from annotatedvdb_tpu_torch.ops.binindex import bin_index_kernel

SENTINEL = np.iinfo(np.int32).max


def _intervals(seed: int, n: int = 2000):
    rng = np.random.default_rng(seed)
    start = rng.integers(1, 249_000_000, n)
    span = rng.choice([0, 1, 2, 30, 15_000, 70_000, 5_000_000, 70_000_000], n)
    edges = [
        (15_625, 15_625), (15_625, 15_626), (15_626, 15_626),
        (15_626, 31_250), (15_626, 31_251), (1, 1), (1, 15_625),
        (63_999_999, 64_000_001), (64_000_000, 64_000_001),
        (64_000_001, 64_000_001), (1, 64_000_000), (1, 64_000_001),
        (127_999_000, 128_001_000), (0, 0), (0, 5),
        (SENTINEL, SENTINEL),
    ]
    start = np.concatenate([start, [s for s, _ in edges]]).astype(np.int32)
    end = np.concatenate([
        np.minimum(start[:n].astype(np.int64) + span, SENTINEL),
        [e for _, e in edges],
    ]).astype(np.int32)
    return start, end


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bin_index_matches_jit(seed):
    start, end = _intervals(seed)
    want_level, want_leaf = bin_index_kernel_jit(start, end)
    level, leaf = bin_index_kernel(torch.from_numpy(start), torch.from_numpy(end))
    assert level.dtype == torch.int8 and leaf.dtype == torch.int32
    np.testing.assert_array_equal(level.numpy(), np.asarray(want_level))
    np.testing.assert_array_equal(leaf.numpy(), np.asarray(want_leaf))


def test_bin_index_matches_scalar_oracle():
    start, end = _intervals(7, n=300)
    level, leaf = bin_index_kernel(torch.from_numpy(start), torch.from_numpy(end))
    for i, (s, e) in enumerate(zip(start.tolist(), end.tolist())):
        if s < 1:
            continue  # the oracle is defined for 1-based positions
        assert (int(level[i]), int(leaf[i])) == closed_form_bin(s, e), (s, e)


def test_leaf_edge_and_64mb_straddle():
    start = torch.tensor([15_625, 15_626, 63_999_999], dtype=torch.int32)
    end = torch.tensor([15_626, 15_626, 64_000_001], dtype=torch.int32)
    level, leaf = bin_index_kernel(start, end)
    assert level.tolist() == [12, 13, 0]  # (] edges: 15625 | 15626 split
    assert leaf.tolist() == [0, 1, 4095]
