"""The port's multi-host wiring (``parallel/multihost.py``) on
``torch.distributed``, on the CPU.

``tests/test_multihost.py``'s cases for ``annotatedvdb_tpu_torch``: the
environment contract (the full ``AVDB_COORDINATOR`` /
``AVDB_NUM_PROCESSES`` / ``AVDB_PROCESS_ID`` triple, ``JAX_COORDINATOR_
ADDRESS`` as the coordinator, partial settings ignored, malformed ones
refused), a one-process ``gloo`` world running the sharded annotate step,
and two- and four-process ``gloo`` worlds on a loopback coordinator whose
global mesh spans every process's virtual CPU shards
(``AVDBC_VIRTUAL_DEVICES``): their ``COUNTS`` lines (the psum'd class
counts, dropped and fallback rows) agree across processes, with an
in-process 8-shard run of the port and with the reference's 8-device run
of the same seeded batch.  Each world has its own 50 s timeout.
"""

import os
import socket
import subprocess
import sys

import pytest

from annotatedvdb_tpu_torch.parallel.multihost import multihost_env

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD_TIMEOUT_S = 50


def test_multihost_env_contract(monkeypatch, capsys):
    from annotatedvdb_tpu.parallel.multihost import multihost_env as ref_env

    for var in ("AVDB_COORDINATOR", "AVDB_NUM_PROCESSES", "AVDB_PROCESS_ID",
                "JAX_COORDINATOR_ADDRESS"):
        monkeypatch.delenv(var, raising=False)
    assert multihost_env() is None
    monkeypatch.setenv("AVDB_COORDINATOR", "10.0.0.1:8476")
    monkeypatch.setenv("AVDB_NUM_PROCESSES", "4")
    monkeypatch.setenv("AVDB_PROCESS_ID", "2")
    assert multihost_env() == ref_env() == {
        "coordinator_address": "10.0.0.1:8476",
        "num_processes": 4,
        "process_id": 2,
    }
    monkeypatch.delenv("AVDB_COORDINATOR")
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "10.0.0.9:8476")
    assert multihost_env() == ref_env()
    assert multihost_env()["coordinator_address"] == "10.0.0.9:8476"
    # partial settings are reported and ignored, as in the reference
    monkeypatch.delenv("JAX_COORDINATOR_ADDRESS")
    capsys.readouterr()
    assert multihost_env() is None
    port_err = capsys.readouterr().err
    assert ref_env() is None
    assert port_err == capsys.readouterr().err != ""
    monkeypatch.setenv("AVDB_COORDINATOR", "h:1")
    monkeypatch.setenv("AVDB_NUM_PROCESSES", "two")
    with pytest.raises(ValueError) as port_exc:
        multihost_env()
    with pytest.raises(ValueError) as ref_exc:
        ref_env()
    assert str(port_exc.value) == str(ref_exc.value)


def test_single_process_is_not_distributed(monkeypatch):
    """Without settings nothing is joined: (0, 1), no world, and the
    runtime's loader mesh is process-local."""
    from annotatedvdb_tpu_torch.parallel import multihost
    from annotatedvdb_tpu_torch.runtime import apply_runtime

    for var in ("AVDB_COORDINATOR", "AVDB_NUM_PROCESSES", "AVDB_PROCESS_ID",
                "JAX_COORDINATOR_ADDRESS"):
        monkeypatch.delenv(var, raising=False)
    assert multihost.init_multihost(platform="cpu") is False
    assert multihost.process_info() == (0, 1) and not multihost.active()
    monkeypatch.setenv("AVDBC_VIRTUAL_DEVICES", "4")
    from annotatedvdb_tpu_torch.parallel import mesh as meshlib

    meshlib.reset_global_mesh()
    mesh = apply_runtime("cpu", "auto")
    assert mesh.size == 4 and not mesh.distributed
    assert apply_runtime("cpu", "2").size == 2
    assert apply_runtime("cpu", "off") is None
    with pytest.raises(ValueError, match="maxWorkers"):
        apply_runtime("cpu", "0")
    meshlib.reset_global_mesh()


_WORKER_SRC = """
import os, sys
port, pid, n_procs, local_dev = sys.argv[1:5]
os.environ["AVDBC_VIRTUAL_DEVICES"] = local_dev
os.environ["AVDB_COORDINATOR"] = "127.0.0.1:" + port
os.environ["AVDB_NUM_PROCESSES"] = n_procs
os.environ["AVDB_PROCESS_ID"] = pid
sys.path.insert(0, {root!r})
import numpy as np
from annotatedvdb_tpu_torch.io.synth import synthetic_batch
from annotatedvdb_tpu_torch.parallel import (
    distributed_annotate_step, init_multihost, make_mesh, process_info,
)
from annotatedvdb_tpu_torch.parallel.distributed import position_block_owner
from annotatedvdb_tpu_torch.parallel.multihost import shutdown
assert init_multihost(platform="cpu")
assert process_info() == (int(pid), int(n_procs))
n_global = int(n_procs) * int(local_dev)
mesh = make_mesh(n_global)
assert mesh.size == n_global and mesh.distributed
batch = synthetic_batch(256, width=16)  # same seed in every process
owner = position_block_owner(batch.chrom, batch.pos, n_global)
ann, rid, counts, dropped, n_fb = distributed_annotate_step(mesh, batch,
                                                            owner=owner)
# this process holds its own shards' rows: each of its rows came back
mine = rid[rid >= 0]
print("ROWS", int(pid), mine.size, flush=True)
print("COUNTS", np.asarray(counts).tolist(), int(dropped), int(n_fb),
      flush=True)
shutdown()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_world(n_procs: int, local_dev: int) -> list[str]:
    """A real ``gloo`` world on an ephemeral loopback coordinator; returns
    each process's COUNTS line (asserting they agree) and checks that the
    processes' own rows add up to the batch."""
    port = _free_port()
    src = _WORKER_SRC.format(root=ROOT)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("AVDB_COORDINATOR", "AVDB_NUM_PROCESSES",
                                "AVDB_PROCESS_ID", "JAX_COORDINATOR"))}
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", src, str(port), str(pid), str(n_procs),
             str(local_dev)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        )
        for pid in range(n_procs)
    ]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=WORLD_TIMEOUT_S)
            assert p.returncode == 0, (out[-1000:], err[-3000:])
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    lines = [next(ln for ln in out.splitlines() if ln.startswith("COUNTS"))
             for out in outs]
    assert len(set(lines)) == 1, ("processes disagree", lines)
    rows = sum(int(next(ln for ln in out.splitlines()
                        if ln.startswith("ROWS")).split()[2]) for out in outs)
    assert rows == 256
    return lines


def _ground_truth_counts() -> tuple:
    """The port's in-process 8-shard run and the reference's 8-device run
    of the same seeded batch."""
    import numpy as np
    import torch

    from annotatedvdb_tpu.io.synth import synthetic_batch as ref_batch
    from annotatedvdb_tpu.parallel import make_mesh as ref_make_mesh
    from annotatedvdb_tpu.parallel.distributed import (
        distributed_annotate_step as ref_step,
    )

    from annotatedvdb_tpu_torch.io.synth import synthetic_batch
    from annotatedvdb_tpu_torch.parallel import make_mesh
    from annotatedvdb_tpu_torch.parallel.distributed import (
        distributed_annotate_step,
        position_block_owner,
    )

    batch = synthetic_batch(256, width=16)
    owner = position_block_owner(batch.chrom, batch.pos, 8)
    _a, _r, counts, dropped, n_fb = distributed_annotate_step(
        make_mesh(8, devices=[torch.device("cpu")] * 8), batch, owner=owner)
    port = f"COUNTS {np.asarray(counts).tolist()} {int(dropped)} {int(n_fb)}"
    _a, _r, counts, dropped, n_fb = ref_step(ref_make_mesh(8), ref_batch(256, width=16),
                                             owner=owner)
    ref = (f"COUNTS {np.asarray(counts).tolist()} {int(np.asarray(dropped))} "
           f"{int(np.asarray(n_fb))}")
    return port, ref


def test_single_process_distributed_world():
    """A one-process world (the wiring the card runs under NCCL) over
    eight virtual shards exchanges through the world's collectives and
    agrees with the in-process run and the reference's."""
    lines = _run_world(n_procs=1, local_dev=8)
    port, ref = _ground_truth_counts()
    assert lines[0] == port == ref


@pytest.mark.parametrize("n_procs,local_dev", [(2, 4), (4, 2)],
                         ids=["two-process", "four-process"])
def test_multi_process_distributed_world(n_procs, local_dev):
    """Two and four real processes over a global 8-shard mesh: the
    exchange crosses processes through ``all_to_all_single`` and the
    counters through ``all_reduce``; every process prints the same
    COUNTS, the in-process run's and the reference's."""
    lines = _run_world(n_procs=n_procs, local_dev=local_dev)
    port, ref = _ground_truth_counts()
    assert lines[0] == port == ref
