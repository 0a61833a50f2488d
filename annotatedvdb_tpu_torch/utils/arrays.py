"""Shared array helpers for the batch pipeline."""

from __future__ import annotations

import numpy as np

# Position padding sentinel: int32.max can never equal a real 1-based
# genomic position, so sentinel rows fall out of every position-equality
# test without an explicit row count.
POS_SENTINEL = np.iinfo(np.int32).max


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (min 1)."""
    return max(1 << (int(n) - 1).bit_length(), 1) if n > 0 else 1


def mesh_capacity(n: int, n_shards: int) -> int:
    """Padded row count for a mesh step: the pow2 shape bound rounded UP to
    a multiple of ``n_shards`` (next_pow2 alone is not divisible by a
    non-pow2 mesh, and the step prologue would raise mid-load)."""
    cap = max(next_pow2(n), n_shards)
    return cap + (-cap) % n_shards


def pad_pow2(a: np.ndarray, fill) -> np.ndarray:
    """Pad the leading axis to the next power of two with ``fill``."""
    n = a.shape[0]
    cap = next_pow2(n)
    if cap == n:
        return a
    pad = np.full((cap - n,) + a.shape[1:], fill, a.dtype)
    return np.concatenate([a, pad])
