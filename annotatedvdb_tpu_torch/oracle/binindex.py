"""Scalar oracle for the hierarchical genome bin index.

The reference materializes a 14-level bin tree into a ``BinIndexRef`` Postgres
table (level increments halving 64 Mb -> 15.625 kb,
``BinIndex/bin/generate_bin_index_references.py:93``) and resolves
``find_bin_index(chr, start, end)`` server-side to the smallest bin whose
``(lower, upper]`` range contains the whole interval
(``BinIndex/lib/python/bin_index.py:9-14``).

Host copy of ``annotatedvdb_tpu/oracle/binindex.py``: the recursive tree
(``bin-references`` emits its rows), the scalar twin of ``ops/binindex.py``
(bins of host-fallback rows) and the ltree path assembly of the mapping
sidecar and the Postgres egress.
"""

from __future__ import annotations

from annotatedvdb_tpu_torch.utils.strings import xstr

# Level bin sizes for levels 1..13 (level 0 is the whole chromosome).
LEVEL_INCREMENTS = [64_000_000 >> k for k in range(13)]  # 64M, 32M, ..., 15625
NUM_LEVELS = 14  # levels 0..13
LEAF_SIZE = LEVEL_INCREMENTS[-1]  # 15625
assert LEAF_SIZE == 15_625


class BinTree:
    """Recursive bin tree for one chromosome, mirroring ``generate_bins``
    (``generate_bin_index_references.py:46-77``): level-0 bin spans the whole
    chromosome; each level-k>=1 bin is an ``increments[k]``-sized slice,
    labeled ``<parent>.L<k>.B<local>``; intervals are ``(lower, upper]``,
    clamped at the sequence length."""

    def __init__(self, chrom_label: str, seq_length: int):
        self.chrom = chrom_label
        self.seq_length = seq_length
        # rows: (level, path, lower, upper) with (lower, upper] semantics
        self.rows: list[tuple[int, str, int, int]] = []
        self._generate(chrom_label, 0, seq_length, 0)

    def _generate(self, bin_root: str, loc_start: int, loc_end: int, level: int) -> None:
        if level >= NUM_LEVELS:
            return
        size = self.seq_length if level == 0 else LEVEL_INCREMENTS[level - 1]
        lower = loc_start
        upper = loc_start + size
        current = 0
        loc_end = min(loc_end, self.seq_length)
        while lower < loc_end:
            current += 1
            label = bin_root if level == 0 else f"{bin_root}.B{current}"
            upper = min(upper, self.seq_length, loc_end)
            self.rows.append((level, label, lower, upper))
            if level + 1 < NUM_LEVELS:
                self._generate(f"{label}.L{level + 1}", lower, upper, level + 1)
            lower = upper
            upper = upper + size

    def find_bin(self, start: int, end: int | None = None) -> tuple[int, str]:
        """Deepest bin whose (lower, upper] contains [start, end];
        returns (level, ltree path)."""
        if end is None:
            end = start
        best = None
        for level, path, lower, upper in self.rows:
            if lower < start and end <= upper:
                if best is None or level > best[0]:
                    best = (level, path)
        if best is None:
            raise ValueError(
                f"could not map {self.chrom}:{xstr(start)}-{xstr(end)} to a bin"
            )
        return best


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
