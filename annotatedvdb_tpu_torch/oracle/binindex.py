"""Scalar oracle for the hierarchical genome bin index.

The reference materializes a 14-level bin tree into a ``BinIndexRef`` Postgres
table (level increments halving 64 Mb -> 15.625 kb,
``BinIndex/bin/generate_bin_index_references.py:93``) and resolves
``find_bin_index(chr, start, end)`` server-side to the smallest bin whose
``(lower, upper]`` range contains the whole interval
(``BinIndex/lib/python/bin_index.py:9-14``).

Host copy of the closed-form half of ``annotatedvdb_tpu/oracle/binindex.py``:
the scalar twin of ``ops/binindex.py`` (bins of host-fallback rows) and the
ltree path assembly of the mapping sidecar.
"""

from __future__ import annotations


# Level bin sizes for levels 1..13 (level 0 is the whole chromosome).
LEVEL_INCREMENTS = [64_000_000 >> k for k in range(13)]  # 64M, 32M, ..., 15625
NUM_LEVELS = 14  # levels 0..13
LEAF_SIZE = LEVEL_INCREMENTS[-1]  # 15625
assert LEAF_SIZE == 15_625


def closed_form_bin(start: int, end: int) -> tuple[int, int]:
    """Scalar closed-form (level, leaf_bin) — host fallback mirror of the
    device kernel (``ops/binindex.py``) for rows it cannot represent."""
    a = (start - 1) // LEAF_SIZE
    b = (end - 1) // LEAF_SIZE
    x = a ^ b
    level = 13 - min(13, x.bit_length())
    return level, a


def closed_form_path(chrom_label: str, level: int, leaf_bin: int) -> str:
    """ltree path from the closed-form (level, leaf-bin) pair the device kernel
    emits.  ``leaf_bin`` is the 0-based global level-13 bin of the start
    position; at level l the global bin is ``leaf_bin >> (13 - l)``; the local
    B label is global+1 at level 1 and (global & 1)+1 deeper (each parent holds
    exactly two half-size children)."""
    parts = [chrom_label]
    for l in range(1, level + 1):
        g = leaf_bin >> (13 - l)
        b = g + 1 if l == 1 else (g & 1) + 1
        parts.append(f"L{l}.B{b}")
    return ".".join(parts)
