"""The advisory chromosome placement a store manifest or ``doctor status``
reports: which device a >1-device mesh WOULD serve each chromosome group
on.

A manifest-only hint, not the mesh.  Pure copies of three functions of
``annotatedvdb_tpu/parallel/mesh.py`` (``mesh_shape_from_env``,
``chromosome_placement``, ``placement_hint``) and the owner table they
read (``parallel/distributed.py::chromosome_owner_table``).  They read
``AVDB_MESH_SHAPE`` and the GRCh38 chromosome lengths and never touch a
device: ``doctor status`` must answer while the card is busy or absent.
The mesh (``torch.distributed`` over several cards) is not ported yet.
"""

from __future__ import annotations

import os

from annotatedvdb_tpu_torch.genome.assemblies import BUILD_LENGTHS
from annotatedvdb_tpu_torch.types import NUM_CHROMOSOMES, chromosome_label


def mesh_shape_from_env() -> int | None:
    """``AVDB_MESH_SHAPE`` as a device count, or None when unset/empty.
    A malformed value raises."""
    spec = os.environ.get("AVDB_MESH_SHAPE", "").strip()
    if not spec:
        return None
    try:
        n = int(spec)
    except ValueError:
        raise ValueError(
            f"AVDB_MESH_SHAPE must be a device count, not {spec!r}"
        ) from None
    if n < 1:
        raise ValueError(f"AVDB_MESH_SHAPE must be >= 1, not {n}")
    return n


def chromosome_owner_table(n_shards: int, build: str = "GRCh38") -> tuple:
    """[NUM_CHROMOSOMES + 1] owner table: greedy longest-first packing of
    chromosomes onto shards weighted by chromosome length.  Index 0 (pad
    rows) maps to shard 0."""
    lengths = dict(enumerate(BUILD_LENGTHS[build.lower()], start=1))
    table = [0] * (NUM_CHROMOSOMES + 1)
    load = [0] * n_shards
    for code in sorted(lengths, key=lambda c: -lengths[c]):
        s = min(range(n_shards), key=load.__getitem__)
        table[code] = s
        load[s] += lengths[code]
    return tuple(table)


def chromosome_placement(n_devices: int, build: str = "GRCh38") -> dict:
    """Chromosome code -> device index (the loader routing's table)."""
    table = chromosome_owner_table(n_devices, build)
    return {code: int(table[code]) for code in range(1, NUM_CHROMOSOMES + 1)}


def placement_hint(n_devices: int | None = None) -> dict | None:
    """The advisory ``mesh_placement`` manifest block: the placement map a
    >1-device mesh would serve this store with (labels, not codes).
    ``None`` on a single-device resolution."""
    if n_devices is None:
        n_devices = mesh_shape_from_env()
        if n_devices is None or n_devices <= 1:
            return None
    if n_devices <= 1:
        return None
    placement = chromosome_placement(n_devices)
    return {
        "devices": int(n_devices),
        "groups": {
            chromosome_label(code): dev for code, dev in placement.items()
        },
    }
