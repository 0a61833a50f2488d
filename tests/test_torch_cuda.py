"""The port's CUDA kernel on the card (marked ``cuda``; skipped without one).

Run from the repository root on a machine with the card (which has no JAX,
hence ``--noconftest``)::

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

The kernel is held against its plain PyTorch version on the same CUDA
tensors, exactly (tolerance 0) under the selection contract, and the
wrapper's refusals are checked.  ``chip_smoke.py`` runs the same
comparison at the load's real sizes."""

import os
import sys

import pytest
import torch

from annotatedvdb_tpu_torch.ops.annotate_cuda import (
    FIELDS,
    LAUNCHES,
    MAX_WIDTH,
    annotate_bin,
    annotate_bin_reference,
)
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from chip_smoke import edge_batch, random_batch  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("width", [8, 16, 49, 96])
@pytest.mark.parametrize("inputs", ["edge", "random"])
def test_kernel_matches_plain_version(cuda, inputs, width):
    rows = edge_batch(width) if inputs == "edge" else random_batch(width, 4099, width)
    args = [torch.from_numpy(x).to(cuda) for x in rows]
    before = LAUNCHES["annotate_bin"]
    got = annotate_bin(*args)
    want = annotate_bin_reference(*args)
    torch.cuda.synchronize()
    assert LAUNCHES["annotate_bin"] == before + 1
    ok = ~want["host_fallback"]
    for name, dtype in FIELDS:
        assert got[name].dtype == dtype
        if name in ("host_fallback", "needs_digest"):
            assert torch.equal(got[name], want[name]), name
        else:
            assert torch.equal(got[name][ok], want[name][ok]), name


def test_wrapper_refuses_bad_inputs(cuda):
    pos, ref, alt, rl, al = (torch.from_numpy(x).to(cuda)
                             for x in random_batch(0, 64, 16))
    with pytest.raises(TypeError):
        annotate_bin(pos.long(), ref, alt, rl, al)
    with pytest.raises(ValueError):
        annotate_bin(pos, ref.t().contiguous().t(), alt, rl, al)
    wide = torch.zeros((64, MAX_WIDTH + 1), dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError):
        annotate_bin(pos, wide, wide, rl, al)
    empty = annotate_bin(pos[:0], ref[:0], alt[:0], rl[:0], al[:0])
    assert all(v.numel() == 0 for v in empty.values())
