"""Region token layout: the ``tokenize=True`` envelope of ``POST /regions``.

Copy of ``annotatedvdb_tpu/export/tokens.py``: one field list
(:data:`TOKEN_FIELDS`), one memoized ltree-path renderer (:func:`bin_path`)
and one function that assembles the envelope
(:func:`build_region_tokens`).
"""

from __future__ import annotations

import functools

from annotatedvdb_tpu_torch.oracle.binindex import closed_form_path
from annotatedvdb_tpu_torch.types import chromosome_label

#: the region token envelope, in wire order
TOKEN_FIELDS = (
    "generation",   # store generation the spans were computed against
    "bin_level",    # deepest enclosing bin level per interval (int8 list)
    "leaf_bin",     # leaf-bin ordinal per interval (int32 list)
    "bin_index",    # ltree path string per interval (closed-form)
    "row_lo",       # post-dedup row span start, -1 when no index group
    "row_hi",       # post-dedup row span end (exclusive), -1 when absent
    "count",        # span width == post-dedup intersection count
)


@functools.lru_cache(maxsize=8192)
def bin_path(label: str, level: int, leaf: int) -> str:
    """Memoized ltree path: rows cluster into few (level, leaf) pairs."""
    return closed_form_path(label, level, leaf)


def build_region_tokens(generation, codes, level, leaf, lo, hi, has_index):
    """The tokenize envelope for one batch of query intervals.

    ``codes`` — chromosome code per interval; ``level``/``leaf``/``lo``/
    ``hi`` — the BITS outputs (numpy, one row per interval); ``has_index``
    — whether the interval's chromosome group has any rows (spans against
    an absent group report ``-1`` bounds, count 0)."""
    n = len(codes)
    return {
        "generation": generation,
        "bin_level": level.tolist(),
        "leaf_bin": leaf.tolist(),
        "bin_index": [
            bin_path(chromosome_label(codes[i]), int(level[i]), int(leaf[i]))
            for i in range(n)
        ],
        "row_lo": [
            int(lo[i]) if has_index[i] else -1 for i in range(n)
        ],
        "row_hi": [
            int(hi[i]) if has_index[i] else -1 for i in range(n)
        ],
        "count": (hi - lo).tolist(),
    }
