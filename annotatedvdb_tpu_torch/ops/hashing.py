"""Allele-identity hash in plain torch.

Port of ``annotatedvdb_tpu/ops/hashing.py::allele_hash``: a 32-bit FNV-1a
over ``(ref_len & 0xFF, alt_len & 0xFF, ref bytes, alt bytes)``.  The hash
only orders and buckets rows — every hash match is confirmed with a full
byte compare (``ops/dedup.py``), so collisions cost a false candidate,
never a wrong answer.

torch's uint32 arithmetic is partial, so the state is int64 masked to 32
bits after every step (``(h ^ b) < 2**32`` and the prime is below
``2**25``, so the product never leaves int64), and the result comes back
to the host as a uint32 numpy array.
"""

from __future__ import annotations

import numpy as np
import torch

FNV_OFFSET = 2166136261
FNV_PRIME = 16777619
_MASK32 = 0xFFFFFFFF


def allele_hash(ref, alt, ref_len, alt_len) -> torch.Tensor:
    """[N] int64 tensor holding the uint32 hash of each allele identity.

    Pad bytes are zeros and lengths are hashed first, so e.g. ref 'AA' /
    alt 'A' and ref 'A' / alt 'AA' hash differently even though their
    padded concatenations match."""
    h = torch.full(ref.shape[:1], FNV_OFFSET, dtype=torch.int64,
                   device=ref.device)

    def step(h, byte):
        return ((h ^ byte.to(torch.int64)) * FNV_PRIME) & _MASK32

    h = step(h, ref_len.to(torch.int64) & 0xFF)
    h = step(h, alt_len.to(torch.int64) & 0xFF)
    for i in range(ref.shape[1]):
        h = step(h, ref[:, i])
    for i in range(alt.shape[1]):
        h = step(h, alt[:, i])
    return h


def to_uint32(h: torch.Tensor) -> np.ndarray:
    """Host uint32 array from :func:`allele_hash`'s int64 tensor."""
    return h.cpu().numpy().astype(np.uint32)
