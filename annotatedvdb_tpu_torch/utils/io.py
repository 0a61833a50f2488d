"""Filesystem I/O for the store's durable-commit protocol.

Copy of ``annotatedvdb_tpu/utils/io.py`` without its ``AVDB_IO_TRACE``
recorder: every store writer here follows the same convention — write a
temp, fsync it, rename it into place, commit via an atomic manifest
replace — through plain ``os``/``builtins`` calls.
"""

from __future__ import annotations

import json
import os


def fsync_wanted() -> bool:
    """``AVDB_FSYNC`` opt-in: full power-loss durability for segment data
    and rename metadata (see ``VariantStore.save``).  '0'/'false'
    disable."""
    return os.environ.get("AVDB_FSYNC", "").lower() not in ("", "0", "false")


def fsync(f) -> None:
    """``os.fsync`` accepting a file object or a raw fd."""
    os.fsync(f if isinstance(f, int) else f.fileno())


def replace(src, dst) -> None:
    """``os.replace`` (atomic rename)."""
    os.replace(src, dst)


def unlink(path) -> None:
    os.unlink(path)


def fsync_dir(path) -> None:
    """fsync a DIRECTORY — commits rename/unlink metadata on power loss."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def replace_manifest(path, doc) -> None:
    """The manifest-replace helper every store commit goes through.

    tmp (dot-prefixed, pid-suffixed — save()'s orphan cleanup attributes
    it) -> serialize -> flush -> fsync (UNCONDITIONAL: one tiny file per
    commit is what keeps a power-loss rename from landing a zero-length
    manifest) -> atomic replace -> directory fsync under ``AVDB_FSYNC=1``
    (segment renames of the same commit share the directory, so this one
    fsync covers them all).

    ``doc`` is a JSON-serializable dict, or pre-serialized ``str``/``bytes``
    when the caller owns the byte format (the replication mirror's
    compact separators)."""
    d, base = os.path.split(os.fspath(path))
    tmp = os.path.join(d, f".{base}.tmp{os.getpid()}")
    mode = "wb" if isinstance(doc, (bytes, bytearray)) else "w"
    with open(tmp, mode) as f:
        if isinstance(doc, (bytes, bytearray, str)):
            f.write(doc)
        else:
            json.dump(doc, f)
        f.flush()
        fsync(f)
    replace(tmp, path)
    if fsync_wanted():
        fsync_dir(d)
