"""Write-ahead-log name rules and record counting.

Trimmed host copy of ``annotatedvdb_tpu/store/wal.py``: what ``doctor``
(fsck's debris classification, ``status``'s pending-replay count) reads
from a store directory.  The live write path that writes these files
(``WriteAheadLog``, ``POST /variants/upsert``) is not ported yet; it
grows this module when it is.

File layout (one file per memtable interval, ``<name>.<seq:06d>.wal``):
one JSON header line ``{"wal": 1, "name": ..., "seq": ...}\\n``, then
CRC-framed records, an 8-byte ``<II`` header (payload length, crc32 of
the payload) followed by the JSON payload.  A rotation stages
``*.wal.tmp`` and renames it.
"""

from __future__ import annotations

import json
import re
import struct
import zlib

_FRAME = struct.Struct("<II")  # payload byte length, crc32(payload)

#: frame-length sanity bound: a corrupt length field must not make the
#: scanner try to skip gigabytes
MAX_RECORD_BYTES = 1 << 26

_WAL_RE = re.compile(r"^(?P<name>.+)\.(?P<seq>\d{6})\.wal$")


def is_wal_file(fname: str) -> bool:
    """Whether a store-directory entry is a (sealed or active) WAL file."""
    return _WAL_RE.match(fname) is not None


def is_wal_tmp(fname: str) -> bool:
    """Whether an entry is an abandoned WAL rotation temp (the rename
    never happened, so no record in it was ever acknowledged)."""
    return fname.endswith(".wal.tmp")


def count_records(path: str) -> int:
    """Intact records in one WAL file (the torn tail excluded, exactly as
    replay would see it).  Never raises: an unreadable or alien file
    counts as zero."""
    n = 0
    try:
        with open(path, "rb") as f:
            try:
                head = json.loads(f.readline())
                if not isinstance(head, dict) or head.get("wal") != 1:
                    return 0
            except ValueError:
                return 0
            while True:
                raw = f.read(_FRAME.size)
                if len(raw) < _FRAME.size:
                    return n
                length, crc = _FRAME.unpack(raw)
                if length > MAX_RECORD_BYTES:
                    return n
                blob = f.read(length)
                if len(blob) < length or zlib.crc32(blob) != crc:
                    return n
                n += 1
    except OSError:
        return n
