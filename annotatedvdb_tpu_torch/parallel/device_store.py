"""Per-shard device-resident membership snapshot of a :class:`VariantStore`.

Port of ``annotatedvdb_tpu/parallel/device_store.py``.  The mesh steps
(``parallel.distributed``: insert, update, serve lookup) route each batch
to its owner shards and probe the store's identity columns there, sharded
the same way, with no host fan-in.

Layout: one stacked array per identity column, ``[n_shards, M, ...]``,
every shard's slice sorted by ``(pos, chrom-mixed hash)`` and padded to
the common power-of-two row count ``M`` with sentinel positions (which
sort last and never match a probe).  A shard's slice holds every
chromosome its routing assigns it, told apart inside one sorted run by
the chromosome-salted hash (``ops.dedup.mix_chrom_hash``) and the probe's
chromosome check.  The arrays equal the reference's, array for array.

:func:`place_store` uploads a snapshot's slices to their shards' devices
once (the hash as int64: torch orders no uint32); the steps take either
form.  The snapshot is frozen at build time: rows appended to the host
store afterwards are not in it.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from annotatedvdb_tpu_torch.ops.dedup import CHROM_MIX
from annotatedvdb_tpu_torch.parallel.distributed import (
    chromosome_owner_table,
    position_block_owner,
)
from annotatedvdb_tpu_torch.utils.arrays import POS_SENTINEL, next_pow2


class DeviceShardStore(NamedTuple):
    """Stacked per-shard identity columns (host numpy)."""

    chrom: np.ndarray     # [S, M] int8
    pos: np.ndarray       # [S, M] int32, POS_SENTINEL pad
    hm: np.ndarray        # [S, M] uint32 chromosome-mixed identity hash
    ref: np.ndarray       # [S, M, W] uint8
    alt: np.ndarray       # [S, M, W] uint8
    ref_len: np.ndarray   # [S, M] int32
    alt_len: np.ndarray   # [S, M] int32
    row_id: np.ndarray    # [S, M] int64 host-store global row id (-1 pad);
    #                       valid until the host shard is appended/merged
    n_rows: np.ndarray    # [S] int64 real rows per shard

    @property
    def n_shards(self) -> int:
        return self.chrom.shape[0]


class PlacedStore(list):
    """A snapshot's slices on their shards' devices: entry ``s`` is local
    shard ``s``'s tuple ``(chrom, pos, hm int64, ref, alt, ref_len,
    alt_len, row_id)`` of tensors."""

    __slots__ = ("mesh",)


def place_store(dev_store, mesh) -> PlacedStore:
    """Upload ``dev_store``'s slices of this process's shards to their
    devices (a :class:`PlacedStore` for ``mesh`` is returned as is)."""
    from annotatedvdb_tpu_torch.runtime import to_device

    if isinstance(dev_store, PlacedStore) and dev_store.mesh is mesh:
        return dev_store
    if dev_store.n_shards != mesh.size:
        raise ValueError(
            f"snapshot of {dev_store.n_shards} shards on a {mesh.size}-shard mesh"
        )
    out = PlacedStore()
    out.mesh = mesh
    for s, dev in enumerate(mesh.devices):
        g = mesh.first_shard + s
        cols = []
        for f in DeviceShardStore._fields[:8]:
            a = getattr(dev_store, f)[g]
            if f == "hm":
                a = a.astype(np.int64)
            cols.append(to_device(np.ascontiguousarray(a), dev))
        out.append(tuple(cols))
    return out


def build_device_shard_store(
    store, n_shards: int, build: str = "GRCh38", routing: str = "chrom",
) -> DeviceShardStore:
    """Snapshot ``store``'s identity columns into the stacked per-shard
    layout: one concat and one sort per shard.

    ``routing``: ``"chrom"`` puts all of a chromosome's rows on its owning
    shard (the insert step's invariant: per-shard dedup is then globally
    correct); ``"position"`` spreads 16 kb position blocks round-robin
    (``position_block_owner``), the partition of update lookups, whose
    chromosome-sorted streams would otherwise land every flush on one
    shard.  The query side must route the same way."""
    if routing not in ("chrom", "position"):
        raise ValueError(f"unknown snapshot routing {routing!r}")
    owner = chromosome_owner_table(n_shards, build)
    per_shard: list[list] = [[] for _ in range(n_shards)]
    width = store.width
    for code, shard in store.shards.items():
        starts = shard._starts()
        for si, seg in enumerate(list(shard.segments)):
            # host-store global ids (segment-list order): the update step
            # hands matches back as these
            rid = int(starts[si]) + np.arange(seg.n, dtype=np.int64)
            cols = (
                np.full(seg.n, code, np.int8),
                seg.cols["pos"],
                seg.cols["h"],
                seg.ref,
                seg.alt,
                seg.cols["ref_len"],
                seg.cols["alt_len"],
                rid,
            )
            if routing == "chrom":
                per_shard[owner[min(code, len(owner) - 1)]].append(cols)
                continue
            row_owner = position_block_owner(
                np.full(seg.n, code, np.int64), seg.cols["pos"], n_shards
            )
            for s in np.unique(row_owner):
                m = row_owner == s
                per_shard[int(s)].append(tuple(c[m] for c in cols))
    m = max(
        (sum(parts[0].shape[0] for parts in bucket) for bucket in per_shard
         if bucket),
        default=0,
    )
    m = max(next_pow2(max(m, 1)), 1)
    out = {
        "chrom": np.zeros((n_shards, m), np.int8),
        "pos": np.full((n_shards, m), POS_SENTINEL, np.int32),
        "hm": np.zeros((n_shards, m), np.uint32),
        "ref": np.zeros((n_shards, m, width), np.uint8),
        "alt": np.zeros((n_shards, m, width), np.uint8),
        "ref_len": np.zeros((n_shards, m), np.int32),
        "alt_len": np.zeros((n_shards, m), np.int32),
        "row_id": np.full((n_shards, m), -1, np.int64),
    }
    n_rows = np.zeros((n_shards,), np.int64)
    for s, bucket in enumerate(per_shard):
        if not bucket:
            continue
        chrom, pos, h, ref, alt, rl, al, rid = (
            np.concatenate([b[i] for b in bucket]) for i in range(8)
        )
        hm = h ^ (chrom.astype(np.uint32) * np.uint32(CHROM_MIX))
        key = (pos.astype(np.uint64) << np.uint64(32)) | hm
        order = np.argsort(key, kind="stable")
        k = order.shape[0]
        n_rows[s] = k
        out["chrom"][s, :k] = chrom[order]
        out["pos"][s, :k] = pos[order]
        out["hm"][s, :k] = hm[order]
        out["ref"][s, :k] = ref[order]
        out["alt"][s, :k] = alt[order]
        out["ref_len"][s, :k] = rl[order]
        out["alt_len"][s, :k] = al[order]
        out["row_id"][s, :k] = rid[order]
    return DeviceShardStore(n_rows=n_rows, **out)
