"""Synthetic variant batches with a realistic shape mix.

Copy of ``annotatedvdb_tpu/io/synth.py::synthetic_batch`` (the annotate
step's warm-up probe batch): gnomAD-like composition, mostly SNVs with a
tail of small insertions/deletions/MNVs, pure numpy and seeded.
"""

from __future__ import annotations

import numpy as np

from annotatedvdb_tpu_torch.types import VariantBatch

_BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def synthetic_batch(
    n: int,
    width: int = 16,
    snv_fraction: float = 0.85,
    seed: int = 7,
) -> VariantBatch:
    rng = np.random.default_rng(seed)
    chrom = rng.integers(1, 26, n).astype(np.int8)
    pos = rng.integers(1, 240_000_000, n).astype(np.int32)

    fill_ref = _BASES[rng.integers(0, 4, (n, width))]
    fill_alt = _BASES[rng.integers(0, 4, (n, width))]

    shape = rng.random(n)
    indel_len = rng.integers(2, width + 1, n)
    is_del = (shape >= snv_fraction) & (shape < snv_fraction + (1 - snv_fraction) / 2)
    is_ins = shape >= snv_fraction + (1 - snv_fraction) / 2

    ref_len = np.where(is_del, indel_len, 1).astype(np.int32)
    alt_len = np.where(is_ins, indel_len, 1).astype(np.int32)
    # anchored indels: alt (resp. ref) starts with the shared anchor base
    fill_alt[:, 0] = np.where(is_ins | is_del, fill_ref[:, 0], fill_alt[:, 0])

    cols = np.arange(width)[None, :]
    ref = np.where(cols < ref_len[:, None], fill_ref, 0).astype(np.uint8)
    alt = np.where(cols < alt_len[:, None], fill_alt, 0).astype(np.uint8)
    return VariantBatch(chrom, pos, ref, alt, ref_len, alt_len)
