"""Shared chunk -> store identity resolution.

Port of ``annotatedvdb_tpu/loaders/lookup.py``: one definition of the
identity rule used wherever a parsed chunk is joined against the store.
The allele hash over the width-bounded alleles comes from the tokenizer
(``h_native``) when the chunk carries it, else from the loaders' device
step (``models/pipeline.py::annotate_hash_fn``: one ``annotate_bin``
launch on a card, the plain versions on the CPU); rows over the width are
re-hashed from their original strings (their device arrays are truncated,
so the device hash would collide on shared prefixes); then one
per-chromosome sorted-merge lookup against the shard.
"""

from __future__ import annotations

import numpy as np
import torch

from annotatedvdb_tpu_torch.io.vcf import VcfChunk
from annotatedvdb_tpu_torch.loaders.vcf_loader import _fnv32_str
from annotatedvdb_tpu_torch.models.pipeline import annotate_hash_fn
from annotatedvdb_tpu_torch.ops.hashing import to_uint32
from annotatedvdb_tpu_torch.runtime import to_device
from annotatedvdb_tpu_torch.store import VariantStore


def _device_hash(device, pos, ref, alt, ref_len, alt_len) -> np.ndarray:
    """[N] uint32 allele hashes from the device step on ``device``."""
    device = torch.device(device)
    args = [to_device(np.asarray(x), device)
            for x in (pos, ref, alt, ref_len, alt_len)]
    _ann, h = annotate_hash_fn(device)(None, *args)
    return to_uint32(h)


def _override_over_width(h, width, ref_len, alt_len, refs, alts) -> np.ndarray:
    over = (np.asarray(ref_len) > width) | (np.asarray(alt_len) > width)
    for i in np.where(over)[0]:
        h[i] = _fnv32_str(refs[i], alts[i])
    return h


def identity_hashes(width: int, ref: np.ndarray, alt: np.ndarray,
                    ref_len: np.ndarray, alt_len: np.ndarray,
                    refs=None, alts=None, device="cpu") -> np.ndarray:
    """[N] uint32 identity hashes of bare allele arrays (no positions):
    the device step's hash on ``device``, with the over-width host-string
    override when the original strings are supplied.  Bit-identical to
    :func:`chunk_hashes`: the hash does not read the position."""
    pos = np.zeros(np.asarray(ref_len).shape, np.int32)
    h = _device_hash(device, pos, ref, alt, ref_len, alt_len)
    if refs is None:
        return h
    return _override_over_width(h, width, ref_len, alt_len, refs, alts)


def chunk_hashes(store: VariantStore, chunk: VcfChunk,
                 device="cpu") -> np.ndarray:
    """[N] uint32 identity hashes of a chunk, with the over-width host
    override: the tokenizer's ``h_native`` when present (no device work),
    else one device step on ``device``."""
    batch = chunk.batch
    if chunk.h_native is not None:
        h = chunk.h_native.copy()
    else:
        h = _device_hash(device, batch.pos, batch.ref, batch.alt,
                         batch.ref_len, batch.alt_len)
    return _override_over_width(h, store.width, batch.ref_len, batch.alt_len,
                                chunk.refs, chunk.alts)


def chunk_lookup(store: VariantStore, chunk: VcfChunk,
                 h: np.ndarray | None = None, device="cpu",
                 stats: dict | None = None):
    """Yield (code, shard, sel, found, idx) per chromosome present in the
    chunk.  ``shard`` is None (with found all-False) for chromosomes the
    store does not hold: a lookup never creates a shard (an empty shard
    would be persisted by the next save).  Membership probes may run on
    ``device`` (``Segment.probe``), counted in ``stats``."""
    batch = chunk.batch
    if h is None:
        h = chunk_hashes(store, chunk, device)
    device = torch.device(device)
    for code in np.unique(batch.chrom):
        sel = np.where(batch.chrom == code)[0]
        shard = store.shards.get(int(code))
        if shard is None:
            yield (
                int(code), None, sel,
                np.zeros(sel.shape, bool), np.full(sel.shape, -1, np.int32),
            )
            continue
        found, idx = shard.lookup(
            batch.pos[sel], h[sel], batch.ref[sel], batch.alt[sel],
            batch.ref_len[sel], batch.alt_len[sel], device=device, stats=stats,
        )
        yield int(code), shard, sel, found, idx
