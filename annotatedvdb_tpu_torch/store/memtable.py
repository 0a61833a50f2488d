"""Memtable-flush name rule.

Trimmed host copy of ``annotatedvdb_tpu/store/memtable.py``: the temp
namespace a killed memtable flush leaves behind, which ``doctor``
attributes (fsck's ``flush-tmp`` finding, ``status``'s debris count).
The memtable itself (upserts, flushes) is not ported yet.
"""

from __future__ import annotations

#: ``chr<L>.<sid>.flush.tmp.{npz,ann.jsonl}`` before the rename step
FLUSH_TMP_SUFFIX = ".flush.tmp"


def is_flush_tmp(fname: str) -> bool:
    """Whether a directory entry is an (abandoned) memtable-flush temp."""
    return fname.endswith((FLUSH_TMP_SUFFIX + ".npz",
                           FLUSH_TMP_SUFFIX + ".ann.jsonl"))
