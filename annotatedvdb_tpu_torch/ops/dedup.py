"""Batch-vs-store membership probe in plain torch.

Port of ``annotatedvdb_tpu/ops/dedup.py::lookup_in_sorted``, the store
membership join of ``Segment._probe_device``: ``searchsorted`` of the
query positions into the store's position-sorted column, a fixed 32-step
lower bound on the hash inside each equal-position run (runs are
multi-allelic sites), then a 4-probe full-byte confirmation over the
short run of equal ``(pos, hash)`` keys.

Hashes are int64 tensors holding uint32 values (``ops/hashing.py``), so
every comparison orders exactly as the reference's uint32 compare.  The
within-batch duplicate kernel (``mark_batch_duplicates``) is not ported:
the insert path dedups on the host.
"""

from __future__ import annotations

import torch


def lookup_in_sorted(
    store_pos, store_h, store_ref, store_alt, store_rlen, store_alen,
    pos, h, ref, alt, ref_len, alt_len,
):
    """Membership of query rows in a ``(pos, hash)``-sorted store slice.

    Returns (found [N] bool, store_index [N] int32; -1 when absent).  All
    tensors lie on one device; ``store_pos``/``pos`` are int32,
    ``store_h``/``h`` int64, the allele matrices uint8 ``[M, W]``/``[N, W]``."""
    m = store_pos.shape[0]
    lo = torch.searchsorted(store_pos, pos, right=False).to(torch.int32)
    hi = torch.searchsorted(store_pos, pos, right=True).to(torch.int32)

    # lower_bound of h in store_h[lo:hi) — 32 halvings cover any run length
    l, r = lo, hi
    for _ in range(32):
        active = l < r
        mid = (l + r) >> 1
        less = store_h[torch.clamp(mid, 0, m - 1).long()] < h
        l = torch.where(active & less, mid + 1, l)
        r = torch.where(active & ~less, mid, r)

    found = torch.zeros(pos.shape, dtype=torch.bool, device=pos.device)
    index = torch.full(pos.shape, -1, dtype=torch.int32, device=pos.device)
    for k in range(4):
        i = torch.clamp(l + k, 0, m - 1)
        il = i.long()
        cand = (
            (l + k < hi)
            & (store_pos[il] == pos)
            & (store_h[il] == h)
            & (store_rlen[il] == ref_len)
            & (store_alen[il] == alt_len)
            & (store_ref[il] == ref).all(dim=1)
            & (store_alt[il] == alt).all(dim=1)
        )
        take = cand & ~found
        found = found | cand
        index = torch.where(take, i, index)
    return found, index
