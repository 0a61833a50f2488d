"""Per-worker write-ahead log for the online upsert path.

Port of ``annotatedvdb_tpu/store/wal.py``.  ``VariantStore.save`` makes a
whole checkpoint durable with one atomic manifest swap; the live write
path (``POST /variants/upsert`` -> ``store/memtable.py``) acknowledges
single requests, so it needs record-grained durability between manifest
commits.  The ack contract: a serving worker writes the accepted rows
here, fsyncs, and only then answers 200, so an acknowledged upsert
survives SIGKILL at any instant; a request that never reached the fsync
leaves at most a torn tail that replay drops (it was never acknowledged).

File layout (one file per memtable interval, ``<name>.<seq:06d>.wal`` in
the store directory, ``<name>`` being ``serve-w<worker index>``):

- one JSON header line ``{"wal": 1, "name": ..., "seq": ...}\\n``;
- then CRC-framed records: an 8-byte ``<II`` header (payload length,
  crc32 of the payload) followed by the JSON payload.

Replay (worker start or respawn) reads every ``<name>.*.wal`` file in
sequence order and stops a file at its first torn, short or
crc-mismatched frame.  Rotation (``rotate()``, when a memtable flush
begins) seals the current file and creates the next one through
``.wal.tmp`` + rename, so a kill mid-rotation leaves attributable
``*.wal.tmp`` debris (``store/fsck`` prunes it); sealed files are unlinked
only after the flush's manifest commit (``discard_sealed``).

A rotation records a ``wal`` lifecycle event in the process's flight
recorder (``obs/reqtrace.py``).

Fault points: ``wal.append`` (before the frame write; ``torn_write``
tears the frame), ``wal.fsync`` (after the write, before the fsync — a
death here may leave the record durable but unacknowledged, which replay
applies in full: un-acked writes are all-or-nothing, never partial), and
``wal.replay`` (per file during replay).
"""

from __future__ import annotations

import json
import os
import re
import struct
import time
import zlib

from annotatedvdb_tpu_torch.obs import reqtrace
from annotatedvdb_tpu_torch.utils import faults
from annotatedvdb_tpu_torch.utils import io as tio
from annotatedvdb_tpu_torch.utils.locks import make_lock

_FRAME = struct.Struct("<II")  # payload byte length, crc32(payload)

#: frame-length sanity bound on replay: a corrupt length field must not
#: make the scanner try to skip gigabytes (larger than any body the front
#: ends accept)
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


class WriteAheadLog:
    """Append/fsync/replay over one worker's WAL file set.

    ``name`` scopes the files to one worker (``serve-w<idx>``): fleet
    workers share the store directory but never each other's WAL.
    Thread-safe; appends serialize under one lock so frames never
    interleave."""

    def __init__(self, store_dir: str, name: str = "serve-w0", log=None):
        self.store_dir = store_dir
        self.name = name
        self.log = log if log is not None else (lambda msg: None)
        self._lock = make_lock("store.wal")
        #: duration of the most recent append's fsync (the ack barrier's
        #: cost, attributed to the request's ``wal_fsync`` trace stage)
        self.last_fsync_s = 0.0
        #: guarded by self._lock
        self._f = None
        existing = self.pending_files()
        #: guarded by self._lock — the active sequence number; files with
        #: a lower seq are sealed (or a previous incarnation's, awaiting
        #: replay and the next flush's discard)
        self._seq = (existing[-1][0] + 1) if existing else 1

    # -- file naming --------------------------------------------------------

    def _path(self, seq: int) -> str:
        return os.path.join(self.store_dir, f"{self.name}.{seq:06d}.wal")

    def pending_files(self) -> list[tuple[int, str]]:
        """[(seq, path)] of every WAL file this worker owns, oldest first."""
        out = []
        try:
            names = os.listdir(self.store_dir)
        except OSError:
            return []
        for fname in names:
            m = _WAL_RE.match(fname)
            if m is not None and m.group("name") == self.name:
                out.append((int(m.group("seq")),
                            os.path.join(self.store_dir, fname)))
        return sorted(out)

    # -- append (the ack path) ----------------------------------------------

    def _create(self, seq: int) -> None:
        """Create one WAL file via tmp + rename: a kill mid-creation leaves
        a ``*.wal.tmp`` (attributed by fsck), never a half-headed WAL."""
        path = self._path(seq)
        tmp = path + ".tmp"
        with tio.open(tmp, "wb") as f:
            f.write((json.dumps(
                {"wal": 1, "name": self.name, "seq": seq}
            ) + "\n").encode())
            f.flush()
            tio.fsync(f)
        tio.replace(tmp, path)

    def append(self, payload: dict) -> int:
        """Write one CRC-framed record and fsync; returns the frame bytes.

        Returning at all is the durability promise the ack rides on.
        Raises on I/O failure — the caller must not acknowledge."""
        blob = json.dumps(payload, separators=(",", ":")).encode()
        if len(blob) > MAX_RECORD_BYTES:
            raise ValueError(
                f"wal record of {len(blob)} bytes exceeds the "
                f"{MAX_RECORD_BYTES}-byte frame bound; split the upsert"
            )
        frame = _FRAME.pack(len(blob), zlib.crc32(blob)) + blob
        with self._lock:
            if self._f is None:
                path = self._path(self._seq)
                if not os.path.exists(path):
                    self._create(self._seq)
                self._f = tio.open(path, "ab")
            f = self._f
            pre = f.tell()
            # crash point BEFORE the write: raise/eio/kill model a death in
            # which the record never landed (the request is never
            # acknowledged); torn_write lands HALF the frame then kills —
            # the torn tail replay must drop
            faults.fire("wal.append", f, payload=frame, tear_base=pre)
            f.write(frame)
            f.flush()
            # crash point AFTER the write, BEFORE the fsync: the record may
            # or may not be durable, but the ack was never sent — replay
            # applies it in full or not at all, never a hybrid
            faults.fire("wal.fsync", f, tear_base=pre)
            t_fsync = time.perf_counter()
            tio.fsync(f)
            self.last_fsync_s = time.perf_counter() - t_fsync
        return len(frame)

    # -- rotation / discard (the flush protocol's WAL half) ------------------

    def rotate(self) -> int:
        """Seal the active file and start the next one; returns the sealed
        sequence number.  Called by the memtable flush after it captured
        its plan under the memtable lock: records appended from here on
        belong to the next interval and survive the flush's discard."""
        with self._lock:
            if self._f is not None:
                self._f.flush()
                tio.fsync(self._f)
                self._f.close()
                self._f = None
            sealed = self._seq
            self._seq += 1
            # create the next active file now (tmp + rename) so a kill
            # between rotation and the next append still leaves a
            # well-formed (empty) WAL rather than nothing
            self._create(self._seq)
        # flight-recorder timeline: a rotation marks a flush interval
        # boundary (no-op without a sink; never fails the rotation)
        reqtrace.lifecycle_event(
            "wal", f"rotated: sealed {self.name}.{sealed:06d}"
        )
        return sealed

    def discard_sealed(self) -> int:
        """Unlink every sealed WAL file (seq < active).  Called only after
        the flush's manifest commit; returns the files removed."""
        removed = 0
        with self._lock:
            active = self._seq
        for seq, path in self.pending_files():
            if seq >= active:
                continue
            try:
                tio.unlink(path)
                removed += 1
            except OSError as err:
                self.log(f"wal: could not remove sealed {path} ({err}); "
                         "fsck --repair prunes it")
        return removed

    def close(self, remove_if_empty: bool = False) -> None:
        """Close the active file.  ``remove_if_empty=True`` (the clean
        shutdown) also unlinks WAL files that hold no records: an empty
        header-only file protects nothing and would be an fsck warning."""
        with self._lock:
            if self._f is not None:
                try:
                    self._f.close()
                finally:
                    self._f = None
            if not remove_if_empty:
                return
            for _seq, path in self.pending_files():
                try:
                    with open(path, "rb") as f:
                        f.readline()  # header
                        empty = not f.read(1)
                    if empty:
                        tio.unlink(path)
                except OSError:
                    continue

    # -- replay --------------------------------------------------------------

    def replay_records(self):
        """Yield every intact record payload from every WAL file, oldest
        file first.  A torn tail (short frame, bad length, crc mismatch,
        unparseable JSON) ends that file with a warning; earlier records
        and other files are unaffected."""
        for _seq, path in self.pending_files():
            # crash point: fires once per replayed file — a death mid-replay
            # must be recoverable by simply replaying again on respawn
            # (replay mutates nothing durable)
            faults.fire("wal.replay")
            yield from self._iter_file(path)

    def _iter_file(self, path: str):
        try:
            f = open(path, "rb")
        except OSError as err:
            self.log(f"wal: cannot open {path} ({err}); skipped")
            return
        with f:
            header = f.readline()
            try:
                head = json.loads(header)
                if not isinstance(head, dict) or head.get("wal") != 1:
                    raise ValueError("not a wal header")
            except ValueError:
                self.log(f"wal: {path}: torn/alien header; file skipped")
                return
            k = 0
            while True:
                raw = f.read(_FRAME.size)
                if not raw:
                    return  # clean end
                if len(raw) < _FRAME.size:
                    self.log(f"wal: {path}: torn frame header after "
                             f"{k} record(s); tail dropped")
                    return
                length, crc = _FRAME.unpack(raw)
                if length > MAX_RECORD_BYTES:
                    self.log(f"wal: {path}: implausible frame length "
                             f"{length} after {k} record(s); tail dropped")
                    return
                blob = f.read(length)
                if len(blob) < length or zlib.crc32(blob) != crc:
                    self.log(f"wal: {path}: torn/corrupt frame after "
                             f"{k} record(s); tail dropped")
                    return
                try:
                    payload = json.loads(blob)
                except ValueError:
                    self.log(f"wal: {path}: unparseable frame payload "
                             f"after {k} record(s); tail dropped")
                    return
                k += 1
                yield payload
