"""ctypes binding for the native VEP-result transformer (``avdb_vep.cpp``).

Port of ``annotatedvdb_tpu/native/vep.py``.  :func:`transform_text` hands
one block of raw JSON lines to C++ and receives per-alt row columns: the
identity arrays (allele matrices, lengths, the allele hash) and byte spans
of ready-made JSON text for the four store-bound values, with no per-row
Python dicts.  Docs the native parser cannot handle faithfully (novel
consequence combos, escaped compared strings, malformed inputs) come back
flagged; the caller re-runs exactly those through the pure-Python path.

The library builds at first use into ``build/native/``
(``native/__init__.py``).  A failed build raises with the compiler's
stderr; ``AVDB_NATIVE_VEP=0`` is the one way to the Python transform.
"""

from __future__ import annotations

import ctypes
import json
import os
import threading
from typing import NamedTuple

import numpy as np

from annotatedvdb_tpu_torch import native

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "avdb_vep.cpp")

_lock = threading.Lock()
_lib = None


def load() -> ctypes.CDLL:
    """The loaded transformer with its C interface declared, building it
    first if needed.  Raises when the build or the load fails."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(native.build_shared_lib(
            SOURCE, "avdb_vep", "native VEP transformer",
            hint=" (set AVDB_NATIVE_VEP=0 for the Python transform)",
        ))
        c = ctypes
        lib.avdb_vep_transform.restype = c.c_int64
        lib.avdb_vep_transform.argtypes = (
            [c.c_char_p, c.c_int64, c.c_char_p, c.c_int64, c.c_int32, c.c_int32,
             c.c_int64]
            + [c.c_void_p] * 3           # doc_of_row, chrom, pos
            + [c.c_void_p] * 4           # ref_mat, alt_mat, ref_len, alt_len
            + [c.c_void_p] * 4           # ref_off/slen, alt_off/slen
            + [c.c_void_p] * 3           # is_multi, hash, host_fb
            + [c.c_void_p] * 8           # ms/rk/fq/vo off+len
            + [c.c_int64, c.c_void_p, c.c_void_p]  # docs_cap, doc_fallback, doc_skipped
            + [c.c_void_p]                          # doc_off
            + [c.c_void_p, c.c_int64]    # arena, arena_cap
            + [c.c_void_p] * 3           # out_rows, out_docs, arena_used
        )
        _lib = lib
        return _lib


def ranking_blob(ranker) -> bytes:
    """Serialize the ranker's current table for the C++ side: one line per
    canonical combo — ``canon \\x1F rank-json \\x1F sort-key \\x1F coding``.
    The rank JSON text is spliced verbatim into emitted consequences, so the
    native output's rank formatting is byte-identical to the host ranker's
    values."""
    from annotatedvdb_tpu_torch.conseq import is_coding_consequence

    lines = []
    for canon, key in ranker._canonical.items():
        rank = ranker.rankings[key]
        coding = is_coding_consequence(canon.split(","))
        lines.append(
            f"{canon}\x1f{json.dumps(rank)}\x1f{float(rank)!r}\x1f"
            f"{1 if coding else 0}"
        )
    return ("\n".join(lines) + "\n").encode()


class VepTransform(NamedTuple):
    n_rows: int
    doc_of_row: np.ndarray
    chrom: np.ndarray
    pos: np.ndarray
    ref: np.ndarray
    alt: np.ndarray
    ref_len: np.ndarray
    alt_len: np.ndarray
    ref_off: np.ndarray
    ref_slen: np.ndarray
    alt_off: np.ndarray
    alt_slen: np.ndarray
    is_multi: np.ndarray
    hash: np.ndarray           # uint32 identity hash (the kernel's bit-exact
    #                            twin; over-width rows already re-hashed over
    #                            the full strings)
    host_fb: np.ndarray        # 1 where an allele exceeds the matrix width
    ms_off: np.ndarray
    ms_len: np.ndarray
    rk_off: np.ndarray
    rk_len: np.ndarray
    fq_off: np.ndarray
    fq_len: np.ndarray
    vo_off: np.ndarray
    vo_len: np.ndarray
    doc_fallback: np.ndarray   # 0 ok, 1 python-path, 2 skipped contig
    doc_skipped: np.ndarray    # '.'-alt skips per doc (applied docs only)
    doc_off: np.ndarray        # byte offset of each doc's line in `text`
    arena: bytes
    text: bytes                # the input block (spans reference it)


# reusable output buffers, keyed by (rows_cap, width) / capacity: a block
# allocates ~40 MB of outputs, and fresh allocations pay first-touch page
# faults every block.  CONTRACT: the arrays inside a VepTransform are views
# into these buffers and are valid only until the NEXT transform_text call
# in the process — the loader drains a result before the next block;
# anything retained is copied (fancy indexing / .tobytes() do).
_ROW_POOL: dict = {}
_DOC_POOL: list = []
_ARENA_POOL: list = []


def _row_buffers(rows_cap: int, width: int) -> dict:
    key = (rows_cap, width)
    bufs = _ROW_POOL.get(key)
    if bufs is None:
        if len(_ROW_POOL) > 8:
            _ROW_POOL.clear()  # unbounded shape churn: keep the pool tiny
        bufs = _ROW_POOL[key] = {
            "doc_of_row": np.empty(rows_cap, np.int32),
            "chrom": np.empty(rows_cap, np.int8),
            "pos": np.empty(rows_cap, np.int32),
            "ref": np.empty((rows_cap, width), np.uint8),
            "alt": np.empty((rows_cap, width), np.uint8),
            "ref_len": np.empty(rows_cap, np.int32),
            "alt_len": np.empty(rows_cap, np.int32),
            "ref_off": np.empty(rows_cap, np.int64),
            "ref_slen": np.empty(rows_cap, np.int32),
            "alt_off": np.empty(rows_cap, np.int64),
            "alt_slen": np.empty(rows_cap, np.int32),
            "is_multi": np.empty(rows_cap, np.uint8),
            "hash": np.empty(rows_cap, np.uint32),
            "host_fb": np.empty(rows_cap, np.uint8),
            "ms_off": np.empty(rows_cap, np.int64),
            "ms_len": np.empty(rows_cap, np.int32),
            "rk_off": np.empty(rows_cap, np.int64),
            "rk_len": np.empty(rows_cap, np.int32),
            "fq_off": np.empty(rows_cap, np.int64),
            "fq_len": np.empty(rows_cap, np.int32),
            "vo_off": np.empty(rows_cap, np.int64),
            "vo_len": np.empty(rows_cap, np.int32),
        }
    return bufs


def _doc_buffers(n: int) -> tuple:
    if not _DOC_POOL or _DOC_POOL[0][0].shape[0] < n:
        _DOC_POOL[:] = [(np.empty(n, np.uint8), np.empty(n, np.int32),
                         np.empty(n, np.int64))]
    fb, sk, do = _DOC_POOL[0]
    return fb[:n], sk[:n], do[:n]


def _arena_buffer(cap: int) -> np.ndarray:
    if not _ARENA_POOL or _ARENA_POOL[0].shape[0] < cap:
        _ARENA_POOL[:] = [np.empty(cap, np.uint8)]
    return _ARENA_POOL[0]


def transform_text(text: bytes, blob: bytes, is_dbsnp: bool,
                   width: int) -> VepTransform:
    """Run the transformer over a byte block of complete newline-separated
    JSON lines with the rank table ``blob`` (:func:`ranking_blob`).  The
    row and doc arrays of the result are views into pooled buffers, valid
    until the next call (see the pool contract above)."""
    lib = load()
    n_docs = text.count(b"\n") + 1
    rows_cap = max(2 * n_docs + 64, 256)
    arena_cap = 4 * len(text) + (1 << 20)
    c = ctypes
    while True:
        # the transformer writes every field of every emitted row and every
        # doc's entries, so the buffers need no zeroing
        a = _row_buffers(rows_cap, width)
        doc_fallback, doc_skipped, doc_off = _doc_buffers(n_docs + 1)
        arena = _arena_buffer(arena_cap)
        out_rows = c.c_int64(0)
        out_docs = c.c_int64(0)
        arena_used = c.c_int64(0)
        rc = lib.avdb_vep_transform(
            text, len(text), blob, len(blob),
            1 if is_dbsnp else 0, width, rows_cap,
            *(x.ctypes.data_as(c.c_void_p) for x in (
                a["doc_of_row"], a["chrom"], a["pos"],
                a["ref"], a["alt"], a["ref_len"], a["alt_len"],
                a["ref_off"], a["ref_slen"], a["alt_off"], a["alt_slen"],
                a["is_multi"], a["hash"], a["host_fb"],
                a["ms_off"], a["ms_len"], a["rk_off"], a["rk_len"],
                a["fq_off"], a["fq_len"], a["vo_off"], a["vo_len"],
            )),
            n_docs + 1,
            doc_fallback.ctypes.data_as(c.c_void_p),
            doc_skipped.ctypes.data_as(c.c_void_p),
            doc_off.ctypes.data_as(c.c_void_p),
            arena.ctypes.data_as(c.c_void_p), arena_cap,
            c.byref(out_rows), c.byref(out_docs), c.byref(arena_used),
        )
        if rc == 1:
            rows_cap *= 2
            continue
        if rc == 2:
            arena_cap *= 2
            continue
        if rc != 0:
            raise RuntimeError(f"avdb_vep_transform returned {rc}")
        n = out_rows.value
        return VepTransform(
            n_rows=n,
            **{k: v[:n] for k, v in a.items()},
            doc_fallback=doc_fallback[: out_docs.value],
            doc_skipped=doc_skipped[: out_docs.value],
            doc_off=doc_off[: out_docs.value].copy(),
            arena=arena[: arena_used.value].tobytes(),
            text=text,
        )
