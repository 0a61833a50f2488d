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
