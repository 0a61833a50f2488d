"""The device-mesh authority: one mesh, one axis name, one sharding rule.

Port of ``annotatedvdb_tpu/parallel/mesh.py``.  A mesh here is an ordered
tuple of ``torch.device`` shards (:class:`Mesh`), not a
``jax.sharding.Mesh``:

- a **batch-sharded** array is a list of per-shard tensors, each on its
  shard's device; axis 0 is split into equal blocks in row order, after
  :func:`pad_rows` (:func:`shard_rows`);
- a kernel runs once per shard (:func:`mesh_pjit`), and the outputs are
  concatenated back in row order;
- the exchanges and sums of the step programs are in
  :mod:`.distributed`: tensor copies between the shards of one process,
  ``torch.distributed`` collectives between processes.

**The device pool.**  The counterpart of XLA's forced host device count:
``--platform cuda`` pools ``cuda:0 … cuda:{device_count() - 1}`` and
``--platform cpu`` the one CPU; ``AVDBC_VIRTUAL_DEVICES=N`` makes the
pool N shards over the one device the platform resolves (refused where
torch sees more than one card).  Virtual shards give the answers N cards
give; they show no cross-card traffic and no speed-up.

:func:`global_mesh` sizes the process-wide mesh from the pool, bounded
by ``AVDB_MESH_SHAPE`` (a device count; a typo fails loudly) and clamped
by the loaders' ``--maxWorkers``; ``None`` means a single shard, and
every caller keeps its single-device path.  The placement helpers
(:func:`chromosome_placement`, :func:`placement_hint`,
:func:`groups_per_device`) are the manifest-only ones of :mod:`.placement`.
"""

from __future__ import annotations

import os
import threading

import numpy as np
import torch

from annotatedvdb_tpu_torch.parallel.placement import (
    chromosome_placement,
    mesh_shape_from_env,
    placement_hint,
)

__all__ = [
    "SHARD_AXIS", "VIRTUAL_DEVICES_ENV", "Mesh", "device_pool", "make_mesh",
    "global_mesh", "reset_global_mesh", "batch_sharding", "replicated",
    "pad_rows", "shard_rows", "mesh_pjit", "chromosome_placement",
    "placement_hint", "groups_per_device", "mesh_shape_from_env",
    "virtual_devices_from_env",
]

SHARD_AXIS = "shard"

#: the port's own knob: N shards over the one device the platform resolves
VIRTUAL_DEVICES_ENV = "AVDBC_VIRTUAL_DEVICES"


class Mesh:
    """A 1-D mesh: the ordered ``torch.device`` shards of this process.

    Inside a ``torch.distributed`` world (:func:`make_mesh` after
    :func:`~.multihost.init_multihost`) the mesh spans every process: each
    holds ``len(devices)`` local shards, process ``rank`` the global shards
    ``rank * len(devices)`` onwards, and the step programs exchange rows
    through collectives.  ``size`` is the global shard count."""

    __slots__ = ("devices", "axis", "rank", "world", "distributed")

    def __init__(self, devices, axis: str = SHARD_AXIS, rank: int = 0,
                 world: int = 1, distributed: bool = False):
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.axis = axis
        self.rank = int(rank)
        self.world = int(world)
        #: the step programs exchange rows through ``torch.distributed``
        #: collectives (a mesh made inside a world, a one-process world
        #: included)
        self.distributed = bool(distributed) or self.world > 1

    @property
    def size(self) -> int:
        """Shards in the whole mesh (every process's)."""
        return self.world * len(self.devices)

    @property
    def local_size(self) -> int:
        return len(self.devices)

    @property
    def first_shard(self) -> int:
        """Global index of this process's first shard."""
        return self.rank * len(self.devices)

    @property
    def physical_devices(self) -> int:
        """Distinct devices under this process's shards."""
        return len({str(d) for d in self.devices})

    def __repr__(self) -> str:
        where = (f", rank={self.rank}, world={self.world}"
                 if self.distributed else "")
        return f"Mesh({[str(d) for d in self.devices]}{where})"


def virtual_devices_from_env() -> int | None:
    """``AVDBC_VIRTUAL_DEVICES`` as a shard count, or None when unset/empty.
    A malformed value raises."""
    spec = os.environ.get(VIRTUAL_DEVICES_ENV, "").strip()
    if not spec:
        return None
    try:
        n = int(spec)
    except ValueError:
        raise ValueError(
            f"{VIRTUAL_DEVICES_ENV} must be a shard count, not {spec!r}"
        ) from None
    if n < 1:
        raise ValueError(f"{VIRTUAL_DEVICES_ENV} must be >= 1, not {n}")
    return n


def device_pool(platform: str | torch.device | None = None) -> tuple:
    """The devices a mesh may take its shards from, for ``platform``
    (``cuda`` by default; a missing card raises, as every entry point's
    does).  ``AVDBC_VIRTUAL_DEVICES=N`` gives N shards over the one device
    the platform resolves; it is refused where torch sees several cards."""
    from annotatedvdb_tpu_torch.runtime import resolve_device

    n_virtual = virtual_devices_from_env()
    base = resolve_device(platform)
    if base.type == "cuda":
        count = torch.cuda.device_count()
        if n_virtual is not None:
            if count > 1:
                raise ValueError(
                    f"{VIRTUAL_DEVICES_ENV}={n_virtual} is refused: torch "
                    f"sees {count} cards; the pool is the cards themselves"
                )
            return (base,) * n_virtual
        return tuple(torch.device("cuda", i) for i in range(count))
    return (base,) * (n_virtual or 1)


def make_mesh(n_devices: int | None = None, axis: str = SHARD_AXIS,
              devices=None) -> Mesh:
    """1-D mesh over the first ``n_devices`` devices of ``devices`` (the
    default pool by default).

    Inside a ``torch.distributed`` world joined by
    :func:`~.multihost.init_multihost`, ``devices=None`` gives the global
    mesh over every process's pool (``n_devices``, when given, must be the
    world's shard count)."""
    from annotatedvdb_tpu_torch.parallel import multihost

    if devices is None and multihost.active():
        rank, world = multihost.process_info()
        local = device_pool(multihost.platform())
        if n_devices is not None and n_devices != world * len(local):
            raise ValueError(
                f"requested {n_devices} devices but the {world}-process "
                f"world holds {world * len(local)}"
            )
        return Mesh(local, axis, rank=rank, world=world, distributed=True)
    if devices is None:
        devices = device_pool()
    devices = tuple(devices)
    if n_devices is not None:
        if len(devices) < n_devices:
            raise ValueError(
                f"requested {n_devices} devices but only {len(devices)} available"
            )
        devices = devices[:n_devices]
    return Mesh(devices, axis)


_LOCK = threading.Lock()
#: (env shape, size, device names) -> Mesh; one object per resolution, so
#: the per-mesh state callers key on stays warm
_GLOBAL: dict = {}


def global_mesh(limit: int | None = None, devices=None):
    """The process-wide 1-D mesh, or ``None`` when it resolves to a single
    shard (single-device code paths stay in charge).

    Sizing: all of the pool (``devices``, or :func:`device_pool`'s default,
    the card), clamped by ``AVDB_MESH_SHAPE`` and the optional ``limit``
    (the loaders' ``--maxWorkers``).  Cached per (shape, pool)."""
    if devices is None:
        devices = device_pool()
    devices = tuple(torch.device(d) for d in devices)
    want = len(devices)
    env = mesh_shape_from_env()
    if env is not None:
        if env > len(devices):
            raise ValueError(
                f"AVDB_MESH_SHAPE={env} exceeds the {len(devices)} visible "
                "devices"
            )
        want = min(want, env)
    if limit is not None:
        want = min(want, max(int(limit), 1))
    if want <= 1:
        return None
    key = (env, want, tuple(str(d) for d in devices[:want]))
    with _LOCK:
        mesh = _GLOBAL.get(key)
        if mesh is None:
            mesh = _GLOBAL[key] = make_mesh(want, devices=devices)
        return mesh


def reset_global_mesh() -> None:
    """Drop the cached mesh resolutions (tests that change
    ``AVDB_MESH_SHAPE`` or the pool between cases)."""
    with _LOCK:
        _GLOBAL.clear()


def batch_sharding(mesh: Mesh) -> tuple:
    """The device of each local shard, in order: ``mesh.devices``.  A
    shard list carries its own layout (axis-0 blocks from
    :func:`shard_rows`, or the whole array on each device), so this and
    :func:`replicated` exist only for the reference's API."""
    return mesh.devices


replicated = batch_sharding


def pad_rows(n: int, mesh: Mesh) -> int:
    """Smallest row count >= n divisible by the mesh size."""
    d = mesh.size
    return n + (-n) % d


def _tensor(a, device: torch.device) -> torch.Tensor:
    from annotatedvdb_tpu_torch.runtime import to_device

    if isinstance(a, torch.Tensor):
        return a.to(device)
    return to_device(np.ascontiguousarray(a), device)


def shard_rows(mesh: Mesh, *arrays):
    """Commit host arrays onto the mesh batch-sharded: for each array, the
    list of this process's per-shard tensors (block ``g`` of axis 0 on
    global shard ``g``'s device).  Axis 0 must already be a multiple of
    the mesh size (:func:`pad_rows`)."""
    out = []
    for a in arrays:
        rows = a.shape[0]
        if rows % mesh.size:
            raise ValueError(
                f"axis 0 of shape {tuple(a.shape)} not divisible by the "
                f"{mesh.size}-device mesh — pad_rows() first"
            )
        block = rows // mesh.size
        out.append([
            _tensor(a[(mesh.first_shard + s) * block:
                      (mesh.first_shard + s + 1) * block], dev)
            for s, dev in enumerate(mesh.devices)
        ])
    return tuple(out) if len(out) != 1 else out[0]


def _pad_arg(a, spec: str, pad: int) -> np.ndarray:
    """One argument's pad rows for :func:`mesh_pjit`.  2-D (allele byte)
    arrays always pad with zero rows; 1-D specs: ``sentinel`` (position
    columns — sort last, never match), ``one`` (length columns — a legal
    1-base allele), ``neg_unique`` (identity-sort keys that never compare
    equal to anything), ``zero`` (everything else)."""
    from annotatedvdb_tpu_torch.utils.arrays import POS_SENTINEL

    a = a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    if a.ndim == 2:
        tail = np.zeros((pad, a.shape[1]), a.dtype)
    elif spec == "sentinel":
        tail = np.full(pad, POS_SENTINEL, a.dtype)
    elif spec == "one":
        tail = np.ones(pad, a.dtype)
    elif spec == "neg_unique":
        tail = (-1 - np.arange(pad)).astype(a.dtype)
    else:
        tail = np.zeros(pad, a.dtype)
    return np.concatenate([a, tail])


def _concat(parts: list, n: int):
    """Per-shard outputs (tensors, or tuples/dicts of them) joined along
    axis 0 on the first shard's device and cut to ``n`` rows."""
    first = parts[0]
    if isinstance(first, torch.Tensor):
        dev = first.device
        return torch.cat([p.to(dev) for p in parts])[:n]
    if isinstance(first, dict):
        return {k: _concat([p[k] for p in parts], n) for k in first}
    if isinstance(first, tuple):
        out = [_concat([p[i] for p in parts], n) for i in range(len(first))]
        return type(first)(*out) if hasattr(first, "_fields") else tuple(out)
    raise TypeError(f"mesh_pjit: unsupported kernel output {type(first)}")


def mesh_pjit(kernel, pads: tuple):
    """The sharded-call surface of a row-wise kernel: pad axis 0 to a mesh
    multiple (``pads`` names each argument's fill — see :func:`_pad_arg`),
    commit the inputs batch-sharded, run ``kernel`` once per shard on the
    shard's device, and join the outputs, pad rows sliced off.

    With no ``mesh`` and a :func:`global_mesh` of one shard, the wrapper IS
    the kernel, on the pool's device.  A mesh that spans processes is
    refused: each process would hold only its own rows."""
    def call(*args, mesh=None):
        if mesh is None:
            mesh = global_mesh()
        if mesh is None:
            dev = device_pool()[0]
            return kernel(*(_tensor(a, dev) for a in args))
        if mesh.distributed:
            raise ValueError("mesh_pjit runs on a process-local mesh")
        n = int(args[0].shape[0])
        m = pad_rows(n, mesh)
        if m != n:
            args = tuple(_pad_arg(a, spec, m - n) for a, spec in zip(args, pads))
        sharded = shard_rows(mesh, *args)
        if len(args) == 1:
            sharded = (sharded,)
        parts = [kernel(*(cols[s] for cols in sharded))
                 for s in range(mesh.local_size)]
        return _concat(parts, n)

    name = getattr(kernel, "__name__", "kernel")
    call.__name__ = f"{name}_mesh"
    call.__qualname__ = call.__name__
    return call


def groups_per_device(placement: dict, codes) -> dict:
    """device index -> sorted chromosome codes placed on it, restricted to
    the ``codes`` actually present in the store."""
    out: dict = {}
    for code in sorted(codes):
        dev = placement.get(code)
        if dev is None:
            continue
        out.setdefault(dev, []).append(code)
    return out
