"""Multi-host initialization on ``torch.distributed``.

Port of ``annotatedvdb_tpu/parallel/multihost.py``.  Every process runs
the same program; after :func:`init_multihost` a mesh made with
``make_mesh()`` spans every process's shards, and the step programs of
:mod:`.distributed` exchange rows with ``all_to_all_single`` and sum their
counters with ``all_reduce``.  Two regimes sit on top, as in the
reference:

- **Loads** stay share-nothing per process: each ingests its own input
  and fans its annotate out over its LOCAL shards (the runtime's loader
  mesh is process-local), with no cross-process traffic.
- **Global-mesh programs** (the step programs over ``make_mesh()``) run
  over all processes' shards.  Every process passes the same global
  batch and gets back its own shards' rows; counters are global.

Environment contract (the reference's):

- ``AVDB_COORDINATOR`` — ``host:port`` of process 0 (or
  ``JAX_COORDINATOR_ADDRESS``);
- ``AVDB_NUM_PROCESSES`` / ``AVDB_PROCESS_ID`` — world size and rank.

Nothing tells a program of a cluster here: the full triple is required,
and partial settings are reported and ignored.  The backend is ``gloo``
for a CPU pool and ``nccl`` for the card; NCCL refuses two ranks on one
card, so on one card only a one-process world runs.
"""

from __future__ import annotations

import os
import sys

_state: dict = {"platform": None}


def multihost_env() -> dict | None:
    """The multi-host settings present in the environment, or None when
    this is a plain single-host run (partial settings are reported on
    stderr and ignored)."""
    coordinator = os.environ.get(
        "AVDB_COORDINATOR", os.environ.get("JAX_COORDINATOR_ADDRESS")
    )
    n = os.environ.get("AVDB_NUM_PROCESSES")
    pid = os.environ.get("AVDB_PROCESS_ID")
    present = [v for v in (coordinator, n, pid) if v]
    if not present:
        return None
    if len(present) < 3:
        print(
            "multihost: ignoring partial settings (need AVDB_COORDINATOR + "
            "AVDB_NUM_PROCESSES + AVDB_PROCESS_ID; "
            f"got coordinator={coordinator!r} n={n!r} pid={pid!r})",
            file=sys.stderr,
        )
        return None
    try:
        return {
            "coordinator_address": coordinator,
            "num_processes": int(n),
            "process_id": int(pid),
        }
    except ValueError as err:
        raise ValueError(
            f"invalid multihost environment (AVDB_NUM_PROCESSES={n!r}, "
            f"AVDB_PROCESS_ID={pid!r}): {err}"
        ) from None


def init_multihost(settings: dict | None = None,
                   platform: str | None = None) -> bool:
    """Join the ``torch.distributed`` world when multi-host settings are
    present (or given); returns True when a world is active.

    ``platform`` (``cuda`` by default, ``cpu``) picks the backend: ``nccl``
    on the card, ``gloo`` on the CPU.  Safe to call more than once and on
    single-host runs (no-op)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return True
    if settings is None:
        settings = multihost_env()
    if settings is None:
        return False
    from annotatedvdb_tpu_torch.runtime import resolve_device

    device = resolve_device(platform)
    backend = "nccl" if device.type == "cuda" else "gloo"
    dist.init_process_group(
        backend=backend,
        init_method=f"tcp://{settings['coordinator_address']}",
        world_size=int(settings["num_processes"]),
        rank=int(settings["process_id"]),
    )
    _state["platform"] = device.type
    return True


def active() -> bool:
    """Whether this process has joined a world."""
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def platform() -> str:
    """The platform of the joined world's backend (``cuda`` by default)."""
    return _state["platform"] or "cuda"


def process_info() -> tuple[int, int]:
    """(process_id, num_processes) of the joined world (0, 1 when not
    distributed)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def shutdown() -> None:
    """Leave the world (the process can join another afterwards)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    _state["platform"] = None
