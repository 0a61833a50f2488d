"""Traced filesystem I/O for the store's durable-commit protocol.

Port of ``annotatedvdb_tpu/utils/io.py``, with its ``AVDB_IO_TRACE``
recorder (:mod:`annotatedvdb_tpu_torch.analysis.iotrace`).

Every store writer (save, memtable flush, WAL, compaction, replication,
promotion, fsck repair) follows one convention: write a temp, fsync it,
rename it into place, commit via an atomic manifest replace.  The static
AVDB10xx family (``analysis/rules_durability``) proves the SHAPE of that
protocol at every call site; this module is the dynamic half — the
``TracedLock``/``AVDB_LOCK_TRACE`` pattern applied to file I/O.

Unarmed (the default), every wrapper here is a plain passthrough to the
``os``/``builtins`` call it names — zero wrapper objects, zero per-write
overhead beyond one env lookup at the call boundary.  With
``AVDB_IO_TRACE=1`` the wrappers report each open/write/fsync/rename/
unlink to the process-global
:data:`annotatedvdb_tpu_torch.analysis.iotrace.RECORDER`, which maintains the
happens-before state (dirty files, current-manifest references, pending
directory-fsync obligations) and flags the crash-consistency orderings a
passing test run cannot otherwise see: a rename of never-fsynced bytes
onto a durable name, an unlink of a file the live manifest still
references, a manifest replace whose directory entry was never fsynced
under ``AVDB_FSYNC=1``.

``tests/test_torch_iotrace.py`` runs the store, replication and export
writers armed, against the JAX package's recorder on the same operations,
and ``chip_smoke.py`` loads and serves a store armed on the card; either
fails on any recorded violation.
"""

from __future__ import annotations

import builtins
import json
import os

_builtin_open = builtins.open


def trace_enabled() -> bool:
    """``AVDB_IO_TRACE`` — 1 arms I/O-order tracing (read per call, so a
    test can arm/disarm around individual operations; an unarmed process
    pays one env lookup per durable I/O call, which the fsync/rename it
    wraps dwarfs by orders of magnitude)."""
    return os.environ.get("AVDB_IO_TRACE", "") == "1"


def fsync_wanted() -> bool:
    """``AVDB_FSYNC`` opt-in: full power-loss durability for segment data
    and rename metadata (see ``VariantStore.save``).  '0'/'false'
    disable."""
    return os.environ.get("AVDB_FSYNC", "").lower() not in ("", "0", "false")


def _recorder():
    from annotatedvdb_tpu_torch.analysis.iotrace import RECORDER

    return RECORDER


class TracedFile:
    """Thin write-reporting proxy around a real file object.

    Only ``write`` is intercepted (it marks the path dirty in the
    recorder); everything else — ``flush``/``fileno``/``tell``/``seek``/
    ``truncate``/``close``/``name`` — delegates, so the proxy is
    API-compatible with the raw file for every use in this tree
    (``_CrcWriter`` wraps it, ``np.lib.format.write_array`` writes
    through it, ``faults.fire`` tears it).
    """

    __slots__ = ("_f", "_path", "_rec")

    def __init__(self, f, path: str, recorder):
        self._f = f
        self._path = path
        self._rec = recorder

    def write(self, data):
        self._rec.note_write(self._path)
        return self._f.write(data)

    def __getattr__(self, name):
        return getattr(self._f, name)

    def __iter__(self):
        return iter(self._f)

    def __enter__(self):
        self._f.__enter__()
        return self

    def __exit__(self, exc_type, exc, tb):
        return self._f.__exit__(exc_type, exc, tb)

    def __repr__(self) -> str:
        return f"TracedFile({self._path!r}, {self._f!r})"


#: mode characters that make an open() a WRITE open (worth tracing)
_WRITE_MODE_CHARS = frozenset("wax+")


def open(path, mode: str = "r", *args, **kwargs):
    """``builtins.open`` for store-path files.  Write opens are wrapped in
    :class:`TracedFile` when tracing is armed; read opens and unarmed
    processes get the raw file back."""
    f = _builtin_open(path, mode, *args, **kwargs)
    if not trace_enabled() or not (_WRITE_MODE_CHARS & set(mode)):
        return f
    rec = _recorder()
    spath = os.fspath(path)
    rec.note_open(spath, mode)
    return TracedFile(f, spath, rec)


def fsync(f) -> None:
    """``os.fsync`` accepting a file object (preferred — the path is then
    attributed in the trace) or a raw fd."""
    fd = f if isinstance(f, int) else f.fileno()
    os.fsync(fd)
    if trace_enabled():
        path = getattr(f, "_path", None)
        if path is None:
            path = getattr(f, "name", None)
        if isinstance(path, str):
            _recorder().note_fsync(path)


def replace(src, dst) -> None:
    """``os.replace`` (atomic rename).  Reported AFTER the rename lands so
    the recorder can read the NEW manifest when ``dst`` is one."""
    os.replace(src, dst)
    if trace_enabled():
        _recorder().note_rename(os.fspath(src), os.fspath(dst))


def rename(src, dst) -> None:
    os.rename(src, dst)
    if trace_enabled():
        _recorder().note_rename(os.fspath(src), os.fspath(dst))


def unlink(path) -> None:
    """``os.unlink``/``os.remove`` for store-path files.  The recorder
    flags an unlink of a file the CURRENT manifest still references."""
    if trace_enabled():
        # report BEFORE the unlink: the liveness judgment needs the
        # manifest state at the instant the file disappears, and an
        # OSError below must not hide an ordering violation
        _recorder().note_unlink(os.fspath(path))
    os.unlink(path)


def fsync_dir(path) -> None:
    """fsync a DIRECTORY — commits rename/unlink metadata on power loss.
    The ``AVDB_FSYNC=1`` half of the protocol (data fsyncs are the other
    half); discharges the recorder's pending-dir-fsync obligation."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)
    if trace_enabled():
        _recorder().note_dir_fsync(os.fspath(path))


def replace_manifest(path, doc, pre_sync=None) -> None:
    """The blessed manifest-replace helper: every manifest-commit site in
    the store routes through here so the protocol lives ONCE.

    tmp (dot-prefixed, pid-suffixed — save()'s orphan cleanup and fsck
    both attribute it) -> serialize -> flush -> optional ``pre_sync(f)``
    hook (the writers' torn-write crash points fire on the staged tmp) ->
    fsync (UNCONDITIONAL: one tiny file per commit is what keeps a
    power-loss rename from landing a zero-length manifest) -> atomic
    replace -> directory fsync under ``AVDB_FSYNC=1`` (commits the rename
    metadata; segment renames of the same commit share the directory, so
    this one fsync covers them all).

    ``doc`` is a JSON-serializable dict, or pre-serialized ``str``/
    ``bytes`` when the caller owns the byte format (the replication
    mirror's compact separators).
    """
    d, base = os.path.split(os.fspath(path))
    tmp = os.path.join(d, f".{base}.tmp{os.getpid()}")
    mode = "wb" if isinstance(doc, (bytes, bytearray)) else "w"
    with open(tmp, mode) as f:
        if isinstance(doc, (bytes, bytearray, str)):
            f.write(doc)
        else:
            json.dump(doc, f)
        f.flush()
        if pre_sync is not None:
            pre_sync(f)
        fsync(f)
    replace(tmp, path)
    if fsync_wanted():
        fsync_dir(d)
