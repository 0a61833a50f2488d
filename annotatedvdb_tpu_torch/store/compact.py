"""Compaction name rules and manifest helpers.

Trimmed host copy of ``annotatedvdb_tpu/store/compact.py``: the temp
namespace of a killed compaction pass, the eligibility floor
(``AVDB_COMPACT_MIN_SEGMENTS``) and the manifest's group normalisation,
which ``doctor`` (fsck, ``status``, ``profile``) reads.  The compactor
itself (``doctor compact``) is not ported yet.
"""

from __future__ import annotations

import os

#: temp names a compaction pass stages before its commit
COMPACT_TMP_NPZ = ".compact.tmp.npz"
COMPACT_TMP_JSONL = ".compact.tmp.ann.jsonl"


def is_compact_tmp(fname: str) -> bool:
    """Whether a directory entry is an (abandoned) compaction temp."""
    return fname.endswith(COMPACT_TMP_NPZ) or fname.endswith(COMPACT_TMP_JSONL)


def _min_stems() -> int:
    """AVDB_COMPACT_MIN_SEGMENTS: smallest on-disk segment-file count that
    makes a chromosome group eligible (default 2 — one file is already
    compact)."""
    try:
        v = int(os.environ.get("AVDB_COMPACT_MIN_SEGMENTS", "") or 2)
    except ValueError:
        return 2
    return max(v, 2)


def _normalize_groups(manifest: dict) -> dict:
    """{label: [[sid, ...], ...]} with format-2 flat lists normalized."""
    fmt2 = manifest.get("format") == 2
    return {
        label: ([[g] for g in groups] if fmt2 else [list(g) for g in groups])
        for label, groups in manifest["shards"].items()
    }
