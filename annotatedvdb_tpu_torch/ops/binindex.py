"""Closed-form hierarchical bin index, in plain torch.

Port of ``annotatedvdb_tpu/ops/binindex.py::bin_index_kernel``.  The bin
tree is a fixed halving hierarchy (64 Mb bins down to 15.625 kb leaves),
so the deepest bin holding ``[start, end]`` is integer arithmetic:

- the global leaf of a 1-based position ``p`` is ``(p - 1) // 15625``
  (bins are ``(lower, upper]``, floor division as in jnp);
- the level is ``13 - min(13, bit_length(leaf_a ^ leaf_b))``.
"""

from __future__ import annotations

import torch

from annotatedvdb_tpu_torch.parallel.mesh import mesh_pjit

LEAF_SIZE = 15_625
NUM_BIN_LEVELS = 13  # levels 1..13 below the whole-chromosome level 0


def bin_index_kernel(start: torch.Tensor, end: torch.Tensor):
    """(bin_level [N] int8 in 0..13, leaf_bin [N] int32) for int32
    ``start``/``end`` (1-based, inclusive)."""
    start = start.to(torch.int32)
    end = end.to(torch.int32)
    a = torch.div(start - 1, LEAF_SIZE, rounding_mode="floor")
    b = torch.div(end - 1, LEAF_SIZE, rounding_mode="floor")
    x = a ^ b
    # number of k in [0, 13) with (x >> k) != 0  ==  min(13, bit_length(x))
    mism = torch.zeros_like(x)
    for k in range(NUM_BIN_LEVELS):
        mism += (x >> k) != 0
    return (NUM_BIN_LEVELS - mism).to(torch.int8), a


def _bin_shard(start: torch.Tensor, end: torch.Tensor):
    """One shard's bins: on the card the ``bits_spans`` kernel's bin token
    (its row search over no rows), on the CPU :func:`bin_index_kernel`."""
    if start.device.type != "cuda":
        return bin_index_kernel(start, end)
    from annotatedvdb_tpu_torch.ops.intervals import bits_spans

    rows = torch.empty((0,), dtype=torch.int32, device=start.device)
    _lo, _hi, level, leaf = bits_spans(rows, start.to(torch.int32).contiguous(),
                                       end.to(torch.int32).contiguous())
    return level, leaf


#: the sharded-call surface: pure per-row arithmetic, one call per shard
bin_index_kernel_mesh = mesh_pjit(_bin_shard, ("one", "one"))
