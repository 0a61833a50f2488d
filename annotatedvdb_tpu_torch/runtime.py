"""Device resolution for every port entry point.

Counterpart of ``annotatedvdb_tpu/utils/runtime.py::pin_platform`` and
``utils/retry.py::device_put``.  The JAX package probes the accelerator
and falls back to the CPU when the probe fails; the port does not fall
back.  Entry points run on ``cuda:0`` unless the caller asks for the CPU,
and a missing card is an error, so a run that was meant for the card can
never finish quietly on the host.
"""

from __future__ import annotations

import numpy as np
import torch

#: the ``--platform`` choices of the port's CLIs (the reference's are
#: ``auto``/``cpu``)
PLATFORMS = ("cuda", "cpu")


def resolve_device(platform: str | torch.device | None = None) -> torch.device:
    """``"cuda"`` (the default) -> ``cuda:0``; ``"cpu"`` -> the host.

    Raises RuntimeError when CUDA is asked for and no device is present."""
    if isinstance(platform, torch.device):
        platform = platform.type if platform.index is None else str(platform)
    name = (platform or "cuda").strip().lower()
    if name == "cpu":
        return torch.device("cpu")
    if name not in ("cuda", "cuda:0"):
        raise ValueError(f"unknown platform {platform!r}: expected one of {PLATFORMS}")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass platform 'cpu' (--platform cpu) "
            "to run on the host"
        )
    return torch.device("cuda", 0)


def to_device(x: np.ndarray, device: torch.device) -> torch.Tensor:
    """Upload one host array.  On CUDA the bytes go through a pinned
    staging buffer and a ``non_blocking`` copy on the current stream (the
    caching host allocator keeps the buffer alive until the copy is done);
    on the CPU the tensor shares the array's memory."""
    x = np.ascontiguousarray(x)
    if device.type != "cuda":
        return torch.from_numpy(x)
    staging = torch.empty(x.shape, dtype=torch.from_numpy(x[:0]).dtype,
                          pin_memory=True)
    staging.numpy()[...] = x
    return staging.to(device, non_blocking=True)


def validate_max_workers(max_workers: str) -> None:
    """``--maxWorkers`` must be ``auto``, ``off`` or a count >= 1 (the
    reference's ``RuntimeConfig.validate``); raises ValueError."""
    if max_workers in ("auto", "off"):
        return
    try:
        if int(max_workers) < 1:
            raise ValueError
    except ValueError:
        raise ValueError(
            f"maxWorkers must be auto, off, or a count >= 1, "
            f"not {max_workers!r}"
        ) from None


def apply_runtime(platform: str | None, max_workers: str = "auto",
                  multihost: bool = True):
    """The counterpart of the reference's ``RuntimeConfig.apply``: resolve
    the platform (a missing card raises), join the multi-host world when
    the environment configures one (unless ``multihost`` is False), and
    return the loaders' mesh — this process's device pool, bounded by
    ``AVDB_MESH_SHAPE`` and clamped by ``--maxWorkers`` — or None for a
    single shard."""
    from annotatedvdb_tpu_torch.parallel.mesh import device_pool, global_mesh

    validate_max_workers(max_workers)
    resolve_device(platform)
    if multihost:
        from annotatedvdb_tpu_torch.parallel.multihost import init_multihost

        init_multihost(platform=platform)
    if max_workers == "off":
        return None
    # loads stay share-nothing per process: the mesh is this process's
    # shards, never the world's
    return global_mesh(
        limit=None if max_workers == "auto" else int(max_workers),
        devices=device_pool(platform),
    )
