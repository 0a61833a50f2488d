"""Distributed step programs: chromosome re-shard, per-shard work, global
counters.

Port of ``annotatedvdb_tpu/parallel/distributed.py``.  The reference's
``shard_map`` programs become three phases over a :class:`~.mesh.Mesh`:

1. **bucketize** (:func:`_bucketize`): each source shard packs its rows
   into ``[n_shards * capacity]`` slots by owner, the rows beyond a
   bucket's capacity dropped and counted (``n_dropped``) — a scatter into
   one extra slot that is then sliced away;
2. **exchange** (:func:`_exchange`): bucket ``d`` of every source goes to
   shard ``d`` (``tensor.to(device)`` between the shards of one process;
   one ``torch.distributed.all_to_all_single`` on fixed-size,
   capacity-padded buffers between processes), so shard ``d`` receives
   ``[n_shards * capacity]`` rows in source order — ``all_to_all``'s
   layout;
3. **per-shard work** on the shard's device — the annotate and hash step
   (on the card one ``annotate_bin`` launch), the within-batch dedup, the
   store probe (on the card one ``lookup_multi`` launch) — and the
   counters summed over the shards (``psum``; ``all_reduce`` across
   processes).

Ownership is variant-count balanced (:func:`chromosome_owner_table`,
greedy longest-first packing over GRCh38 lengths) or, for annotate-only
fan-out and update lookups, round-robin 16 kb position blocks
(:func:`position_block_owner`).  The default exchange capacity is
lossless (:func:`exact_capacity`): a drop is then a bug, not an
accounting line.

Every step returns host numpy arrays in the reference's shapes and
post-exchange order: per-row outputs ``[n_shards * n_shards * capacity]``
(this process's shards only, inside a multi-process world), ``rid_out``
-1 for empty, pad and dropped slots, and global counters.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from annotatedvdb_tpu_torch.types import NUM_CHROMOSOMES, AnnotatedBatch, VariantBatch

#: 16 kb position blocks: fine-grained spread for chromosome-sorted input
POSITION_BLOCK_BITS = 14


# -------------------------------------------------------------- exchange


def _bucketize(owner: torch.Tensor, arrays: tuple, n_buckets: int,
               capacity: int):
    """Pack rows into ``[n_buckets * capacity]`` slots by owner (one device).

    Returns (packed arrays, valid mask, dropped rows).  Rows beyond a
    bucket's capacity go to one extra slot that is sliced away, and are
    counted."""
    dev = owner.device
    n = owner.shape[0]
    total = n_buckets * capacity
    owner = owner.to(torch.int64)
    order = torch.argsort(owner, stable=True)
    owner_sorted = owner[order]
    starts = torch.searchsorted(
        owner_sorted, torch.arange(n_buckets, dtype=torch.int64, device=dev)
    )
    rank = torch.arange(n, dtype=torch.int64, device=dev) - starts[owner_sorted]
    in_capacity = rank < capacity
    slot = torch.where(in_capacity, owner_sorted * capacity + rank,
                       torch.full_like(rank, total))

    def pack(x_sorted):
        out = torch.zeros((total + 1,) + tuple(x_sorted.shape[1:]),
                          dtype=x_sorted.dtype, device=dev)
        out[slot] = x_sorted
        return out[:total]

    packed = tuple(pack(x[order]) for x in arrays)
    valid = pack(in_capacity)
    n_dropped = (~in_capacity).sum()
    return packed, valid, n_dropped


def _exchange(mesh, parts: list, capacity: int) -> list:
    """All-to-all of packed rows: ``parts[s]`` is local source shard ``s``'s
    tuple of ``[n_shards * capacity, ...]`` tensors; returns, per local
    destination shard, the tuple of ``[n_shards * capacity, ...]`` tensors
    it receives (block ``g`` from global source shard ``g``)."""
    n_arrays = len(parts[0])
    if not mesh.distributed:
        return [
            tuple(
                torch.cat([p[a][d * capacity:(d + 1) * capacity].to(dev)
                           for p in parts])
                for a in range(n_arrays)
            )
            for d, dev in enumerate(mesh.devices)
        ]
    import torch.distributed as dist

    home = mesh.devices[0]
    world, local = mesh.world, mesh.local_size
    received: list = [[None] * n_arrays for _ in range(local)]
    for a in range(n_arrays):
        first = parts[0][a]
        rest = tuple(first.shape[1:])
        is_bool = first.dtype == torch.bool
        # [L_src, P_dst, L_dst, cap, ...] -> [P_dst, L_src, L_dst, cap, ...]
        send = torch.stack([
            (p[a].to(torch.uint8) if is_bool else p[a]).to(home).reshape(
                (world, local, capacity) + rest)
            for p in parts
        ]).transpose(0, 1).contiguous()
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send)
        # recv: [P_src, L_src, L_dst, cap, ...]
        for d, dev in enumerate(mesh.devices):
            block = recv[:, :, d].reshape((world * local * capacity,) + rest)
            received[d][a] = (block.to(torch.bool) if is_bool else block).to(dev)
    return [tuple(r) for r in received]


def _psum(mesh, parts: list) -> np.ndarray:
    """Sum of per-shard counters (same shape, any local devices) over the
    whole mesh, as host int64."""
    home = mesh.devices[0]
    total = torch.zeros_like(parts[0], dtype=torch.int64, device=home)
    for p in parts:
        total += p.to(home).to(torch.int64)
    if mesh.distributed:
        import torch.distributed as dist

        dist.all_reduce(total)
    return total.cpu().numpy()


def reshard_by_owner(mesh, owners: list, arrays: list, capacity: int):
    """Route rows to their owner shard with one exchange.

    ``owners[s]`` and ``arrays[s]`` (a tuple of tensors) are local shard
    ``s``'s rows.  Each shard sends up to ``capacity`` rows to each
    destination; returns (received tuples and validity masks, one per
    local shard, each ``[n_shards * capacity]`` rows, and the global
    dropped-row count)."""
    n_shards = mesh.size
    packed, dropped = [], []
    for own, cols in zip(owners, arrays):
        p, valid, n_dropped = _bucketize(own, cols, n_shards, capacity)
        packed.append(p + (valid,))
        dropped.append(n_dropped)
    received = _exchange(mesh, packed, capacity)
    total_dropped = int(_psum(mesh, dropped))
    return ([r[:-1] for r in received], [r[-1] for r in received],
            total_dropped)


# ------------------------------------------------------------- ownership


@lru_cache(maxsize=None)
def chromosome_owner_table(n_shards: int, build: str = "GRCh38") -> tuple:
    """[NUM_CHROMOSOMES + 1] owner table: greedy longest-first packing of
    chromosomes onto shards weighted by chromosome length.  Index 0 (pad
    rows) maps to shard 0."""
    from annotatedvdb_tpu_torch.parallel.placement import (
        chromosome_owner_table as table,
    )

    return table(n_shards, build)


def chromosome_owner(chrom: torch.Tensor, n_shards: int) -> torch.Tensor:
    """Owning shard of each row's chromosome code (balanced static table)."""
    table = torch.tensor(chromosome_owner_table(n_shards), dtype=torch.int64,
                         device=chrom.device)
    return table[torch.clamp(chrom.to(torch.int64), 0, NUM_CHROMOSOMES)]


def position_block_owner(chrom, pos, n_shards: int) -> np.ndarray:
    """Host-side owner map: round-robin 16 kb position blocks across
    shards, the chromosome entering the rotation so chromosomes do not all
    start on shard 0.  Chromosome-sorted input then spreads evenly."""
    blocks = np.asarray(pos).astype(np.int64) >> POSITION_BLOCK_BITS
    return ((blocks + np.asarray(chrom).astype(np.int64)) % n_shards).astype(
        np.int32
    )


def _position_owner(chrom: torch.Tensor, pos: torch.Tensor,
                    n_shards: int) -> torch.Tensor:
    """On-device twin of :func:`position_block_owner` (int32 is exact: pos
    < 2^31 and the shift only shrinks it)."""
    return torch.remainder(
        (pos.to(torch.int32) >> POSITION_BLOCK_BITS) + chrom.to(torch.int32),
        n_shards,
    ).to(torch.int64)


def exact_capacity(owner: np.ndarray, n_shards: int) -> int:
    """Smallest per-(source, destination) slot count that loses no rows for
    this owner map, rounded up to a power of two."""
    from annotatedvdb_tpu_torch.utils.arrays import next_pow2

    per_source = np.asarray(owner).reshape(n_shards, -1)
    cap = 1
    for s in range(n_shards):
        counts = np.bincount(per_source[s], minlength=n_shards)
        cap = max(cap, int(counts.max()))
    return next_pow2(cap)


def _step_prologue(mesh, batch: VariantBatch, capacity: int | None, row_id,
                   owner: np.ndarray | None = None):
    """Shared entry checks and defaults of the steps: divisibility, the
    lossless default capacity for the owner map, the identity row ids.
    Returns (n_shards, capacity, row_id)."""
    n_shards = mesh.size
    if batch.n % n_shards:
        raise ValueError(
            f"batch size {batch.n} not divisible by {n_shards} shards — pad "
            "with chrom-0 rows first (loaders use _pad_batch)"
        )
    n_local = batch.n // n_shards
    if capacity is None:
        if owner is None:
            owner = np.asarray(chromosome_owner_table(n_shards))[
                np.clip(np.asarray(batch.chrom, np.int32), 0, NUM_CHROMOSOMES)
            ]
        capacity = min(exact_capacity(owner, n_shards), n_local)
    if row_id is None:
        row_id = np.arange(batch.n, dtype=np.int32)
    return n_shards, capacity, row_id


def _host(parts: list) -> np.ndarray:
    """Per-shard tensors joined in shard order on the host."""
    return np.concatenate([p.cpu().numpy() for p in parts])


def reshard_rows(mesh, batch_cols: tuple, owner_of, capacity: int):
    """:func:`reshard_by_owner` of host columns: commit them batch-sharded,
    compute each shard's owners with ``owner_of(cols)`` and route.  Returns
    (received tuples, validity masks, dropped rows)."""
    from annotatedvdb_tpu_torch.parallel.mesh import shard_rows

    sharded = [shard_rows(mesh, np.asarray(c)) for c in batch_cols]
    local = [tuple(c[s] for c in sharded) for s in range(mesh.local_size)]
    owners = [owner_of(cols) for cols in local]
    return reshard_by_owner(mesh, owners, local, capacity)


def _slot_salt(real: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Positions with every unusable slot replaced by a unique negative
    value, so pad and empty slots (chrom 0, zero identities) never compare
    equal to a row or each other."""
    slot = torch.arange(pos.shape[0], dtype=torch.int32, device=pos.device)
    return torch.where(real, pos.to(torch.int32), -1 - slot)


def _class_counts(ann_class: torch.Tensor, counted: torch.Tensor) -> torch.Tensor:
    vc = ann_class.to(torch.int64)
    keep = counted & (vc >= 0) & (vc < 8)
    return torch.bincount(vc[keep], minlength=8)[:8]


# ------------------------------------------------------------- the steps


def distributed_annotate_step(
    mesh, batch: VariantBatch, capacity: int | None = None, row_id=None,
    owner: np.ndarray | None = None, with_hash: bool = False,
):
    """Sharded load step: reshard rows to their owners, annotate (and hash)
    on each shard, and count classes globally.

    Returns ``(ann, row_id_out, counts, n_dropped, n_fallback)``: the
    annotated arrays in post-exchange order, the input row id of each slot
    (-1 for empty, pad and dropped slots), the global per-class counts of
    device-annotated rows, the rows lost to capacity overflow (0 with the
    lossless default) and the rows flagged for the host long-allele path.
    ``with_hash`` appends the slots' allele hashes (uint32, from the same
    launch on the card).  ``owner`` is an optional host [N] shard
    assignment (e.g. :func:`position_block_owner`); without it rows route
    to their chromosome's owner.  Row conservation:
    ``sum(counts) + n_fallback + n_dropped == non-pad input rows``."""
    from annotatedvdb_tpu_torch.models.pipeline import annotate_hash_fn

    n_shards, capacity, row_id = _step_prologue(mesh, batch, capacity,
                                                row_id, owner)
    owner_in = (np.asarray(owner, np.int32) if owner is not None
                else np.full(batch.n, -1, np.int32))
    use_chrom = owner is None

    def owner_of(cols):
        return (chromosome_owner(cols[0], n_shards) if use_chrom
                else cols[-1].to(torch.int64))

    received, valid, dropped = reshard_rows(
        mesh, (batch.chrom, batch.pos, batch.ref, batch.alt, batch.ref_len,
               batch.alt_len, row_id, owner_in),
        owner_of, capacity,
    )
    anns, hashes, rids, counts, fallbacks = [], [], [], [], []
    for (chrom, pos, ref, alt, rl, al, rid, _own), ok, dev in zip(
            received, valid, mesh.devices):
        ann, h = annotate_hash_fn(dev)(chrom, pos, ref, alt, rl, al)
        real = ok & (chrom > 0)
        counts.append(_class_counts(ann.variant_class, real & ~ann.host_fallback))
        fallbacks.append((real & ann.host_fallback).sum())
        rids.append(torch.where(real, rid, torch.full_like(rid, -1)))
        anns.append(ann)
        hashes.append(h)
    ann_out = AnnotatedBatch(*(_host([getattr(a, f) for a in anns])
                               for f in AnnotatedBatch._fields))
    out = (ann_out, _host(rids), _psum(mesh, counts).astype(np.int32),
           np.int32(dropped), np.int32(_psum(mesh, fallbacks)))
    if with_hash:
        out += (_host(hashes).view(np.uint32),)
    return out


def distributed_insert_step(mesh, batch: VariantBatch, dev_store=None,
                            capacity: int | None = None, row_id=None):
    """Sharded INSERT step: chromosome re-shard + annotate + in-batch dedup
    + store membership, each shard on its own rows.  Rows route to their
    chromosome's owner, so each shard sees every row of its chromosomes and
    per-shard dedup is globally correct.

    ``dev_store``: an optional
    :class:`~annotatedvdb_tpu_torch.parallel.device_store.DeviceShardStore`
    snapshot (or its :func:`~.device_store.place_store` placement); each
    shard probes its slice.  Returns ``(ann, rid_out, flags, counters)``:
    ``flags`` holds per-slot ``dup_batch`` and ``in_store``, ``counters``
    the global ``class_counts``, ``n_dropped``, ``n_fallback``,
    ``n_batch_dup`` and ``n_store_dup``.  Host-fallback rows are excluded
    from both verdicts (the host re-checks them)."""
    from annotatedvdb_tpu_torch.models.pipeline import annotate_hash_fn
    from annotatedvdb_tpu_torch.ops.dedup import (
        lookup_in_sorted_multi,
        mark_batch_duplicates_multi,
        mix_chrom_hash,
    )
    from annotatedvdb_tpu_torch.parallel.device_store import place_store

    n_shards, capacity, row_id = _step_prologue(mesh, batch, capacity, row_id)
    placed = place_store(dev_store, mesh) if dev_store is not None else None
    received, valid, dropped = reshard_rows(
        mesh, (batch.chrom, batch.pos, batch.ref, batch.alt, batch.ref_len,
               batch.alt_len, row_id),
        lambda cols: chromosome_owner(cols[0], n_shards), capacity,
    )
    anns, rids, dups, stores = [], [], [], []
    counts, fallbacks, n_dup, n_store = [], [], [], []
    for s, ((chrom, pos, ref, alt, rl, al, rid), ok, dev) in enumerate(
            zip(received, valid, mesh.devices)):
        ann, h = annotate_hash_fn(dev)(chrom, pos, ref, alt, rl, al)
        real = ok & (chrom > 0)
        usable = real & ~ann.host_fallback
        h = h.to(torch.int64) & 0xFFFFFFFF
        pos_k = _slot_salt(usable, pos)
        dup_batch = mark_batch_duplicates_multi(
            chrom, pos_k, h, ref, alt, rl, al) & usable
        if placed is not None:
            s_cols = placed[s]
            in_store, _ = lookup_in_sorted_multi(
                *s_cols[:7], chrom, pos_k, mix_chrom_hash(h, chrom), ref, alt,
                rl, al,
            )
            in_store = in_store & usable & ~dup_batch
        else:
            in_store = torch.zeros_like(usable)
        counts.append(_class_counts(ann.variant_class,
                                    usable & ~dup_batch & ~in_store))
        fallbacks.append((real & ann.host_fallback).sum())
        n_dup.append(dup_batch.sum())
        n_store.append(in_store.sum())
        rids.append(torch.where(real, rid, torch.full_like(rid, -1)))
        anns.append(ann)
        dups.append(dup_batch)
        stores.append(in_store)
    ann_out = AnnotatedBatch(*(_host([getattr(a, f) for a in anns])
                               for f in AnnotatedBatch._fields))
    counters = {
        "class_counts": _psum(mesh, counts).astype(np.int32),
        "n_dropped": np.int32(dropped),
        "n_fallback": np.int32(_psum(mesh, fallbacks)),
        "n_batch_dup": np.int32(_psum(mesh, n_dup)),
        "n_store_dup": np.int32(_psum(mesh, n_store)),
    }
    flags = {"dup_batch": _host(dups), "in_store": _host(stores)}
    return ann_out, _host(rids), flags, counters


def _probe_rows(s_cols, found, idx) -> torch.Tensor:
    """Host-store global row id of each found slot (-1 otherwise)."""
    s_rid = s_cols[7]
    m = s_rid.shape[0]
    if m == 0:
        return torch.full(idx.shape, -1, dtype=torch.int64, device=idx.device)
    got = s_rid[torch.clamp(idx, 0, m - 1).long()]
    return torch.where(found, got, torch.full_like(got, -1))


def distributed_update_step(mesh, batch: VariantBatch, dev_store,
                            capacity: int | None = None, row_id=None,
                            routing: str = "chrom"):
    """Sharded UPDATE-identity step: re-shard + store lookup per shard; the
    host gets back store row ids and applies the annotation writes.  No
    annotate output is kept: each shard hashes its rows (on the card from
    the ``annotate_bin`` launch) and probes its snapshot slice.

    Returns ``(rid_out, found, store_row, counters)``: the input row id per
    slot (-1 = empty/pad), whether the identity is in the snapshot, the
    int64 host-store global row id (-1 when not found) and the global
    ``n_matched``, ``n_missing``, ``n_fallback`` and ``n_dropped``.
    Over-width rows are excluded and re-checked on the host.  ``routing``
    must match the snapshot's partition: ``"chrom"`` or ``"position"``."""
    from annotatedvdb_tpu_torch.models.pipeline import annotate_hash_fn
    from annotatedvdb_tpu_torch.ops.dedup import (
        lookup_in_sorted_multi,
        mix_chrom_hash,
    )
    from annotatedvdb_tpu_torch.parallel.device_store import place_store

    if routing not in ("chrom", "position"):
        raise ValueError(f"unknown update routing {routing!r}")
    owner = (
        position_block_owner(np.asarray(batch.chrom, np.int64),
                             np.asarray(batch.pos, np.int64), mesh.size)
        if routing == "position" else None
    )
    n_shards, capacity, row_id = _step_prologue(mesh, batch, capacity,
                                                row_id, owner)
    placed = place_store(dev_store, mesh)

    def owner_of(cols):
        if routing == "position":
            return _position_owner(cols[0], cols[1], n_shards)
        return chromosome_owner(cols[0], n_shards)

    received, valid, dropped = reshard_rows(
        mesh, (batch.chrom, batch.pos, batch.ref, batch.alt, batch.ref_len,
               batch.alt_len, row_id),
        owner_of, capacity,
    )
    rids, founds, rows = [], [], []
    matched, missing, fallbacks = [], [], []
    for s, ((chrom, pos, ref, alt, rl, al, rid), ok, dev) in enumerate(
            zip(received, valid, mesh.devices)):
        real = ok & (chrom > 0)
        width = ref.shape[1]
        fallback = real & ((rl > width) | (al > width))
        usable = real & ~fallback
        _ann, h = annotate_hash_fn(dev)(chrom, pos, ref, alt, rl, al)
        pos_k = _slot_salt(usable, pos)
        found, idx = lookup_in_sorted_multi(
            *placed[s][:7], chrom, pos_k, mix_chrom_hash(h, chrom), ref, alt,
            rl, al,
        )
        found = found & usable
        rows.append(_probe_rows(placed[s], found, idx))
        matched.append(found.sum())
        missing.append((usable & ~found).sum())
        fallbacks.append(fallback.sum())
        rids.append(torch.where(real, rid, torch.full_like(rid, -1)))
        founds.append(found)
    counters = {
        "n_matched": np.int32(_psum(mesh, matched)),
        "n_missing": np.int32(_psum(mesh, missing)),
        "n_fallback": np.int32(_psum(mesh, fallbacks)),
        "n_dropped": np.int32(dropped),
    }
    return _host(rids), _host(founds), _host(rows), counters


def distributed_serve_lookup_step(mesh, chrom, pos, hm, ref, alt,
                                  ref_len, alt_len, dev_store,
                                  capacity: int | None = None,
                                  row_id=None):
    """Sharded SERVE bulk lookup: chromosome re-shard + store membership,
    the serving read path's twin of :func:`distributed_update_step`.  The
    identity hash arrives host-computed (``hm``: the full-string hash,
    chromosome-mixed), so long-allele queries resolve with the host probe's
    semantics; no counters.

    Returns ``(rid_out, found, store_row)``, each ``[n_shards * n_shards *
    capacity]`` in post-exchange order: scatter back with ``rid_out`` (-1 =
    empty/pad slot); ``store_row`` is the host-store global row id (-1 =
    miss)."""
    from annotatedvdb_tpu_torch.ops.dedup import lookup_in_sorted_multi
    from annotatedvdb_tpu_torch.parallel.device_store import place_store

    n = chrom.shape[0]
    n_shards = mesh.size
    if n % n_shards:
        raise ValueError(
            f"query batch {n} not divisible by {n_shards} shards — pad "
            "with chrom-0 rows first"
        )
    if capacity is None:
        host_owner = np.asarray(chromosome_owner_table(n_shards))[
            np.clip(np.asarray(chrom, np.int32), 0, NUM_CHROMOSOMES)
        ]
        capacity = min(exact_capacity(host_owner, n_shards), n // n_shards)
    if row_id is None:
        row_id = np.arange(n, dtype=np.int32)
    placed = place_store(dev_store, mesh)
    hm64 = np.asarray(hm).astype(np.int64) & 0xFFFFFFFF
    received, valid, _dropped = reshard_rows(
        mesh, (chrom, pos, hm64, ref, alt, ref_len, alt_len, row_id),
        lambda cols: chromosome_owner(cols[0], n_shards), capacity,
    )
    rids, founds, rows = [], [], []
    for s, ((c, p, h, r, a, rl, al, rid), ok) in enumerate(zip(received, valid)):
        real = ok & (c > 0)
        found, idx = lookup_in_sorted_multi(
            *placed[s][:7], c, _slot_salt(real, p), h, r, a, rl, al,
        )
        found = found & real
        rows.append(_probe_rows(placed[s], found, idx))
        rids.append(torch.where(real, rid, torch.full_like(rid, -1)))
        founds.append(found)
    return _host(rids), _host(founds), _host(rows)
