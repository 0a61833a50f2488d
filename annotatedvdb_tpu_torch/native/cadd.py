"""ctypes binding for the native CADD-table tokenizer (``avdb_cadd.cpp``).

Port of ``annotatedvdb_tpu/native/cadd.py``.  Streams a score table's
decompressed bytes through the C scanner and yields COLUMN arrays per fill
— the per-line Python parse loop this replaces is the dominant cost of the
sequential CADD join.  Long alleles (wider than the device width) are
materialized as strings per fill from their byte spans, so downstream block
assembly never re-touches the window.

The library builds at first use into ``build/native/``
(``native/__init__.py``).  A failed build raises with the compiler's
stderr; unlike the reference, which returns no library and lets the reader
fall back to the Python scanner in silence, the port reaches the Python
scanner only through ``AVDB_NATIVE_CADD=0`` or an explicit
``engine="python"``.
"""

from __future__ import annotations

import ctypes
import gzip
import os
import threading

import numpy as np

from annotatedvdb_tpu_torch import native

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "avdb_cadd.cpp")

READ_SIZE = 8 << 20

_lock = threading.Lock()
_lib = None


def load() -> ctypes.CDLL:
    """The loaded tokenizer with its C interface declared, building it
    first if needed.  Raises when the build or the load fails."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(native.build_shared_lib(
            SOURCE, "avdb_cadd", "native CADD tokenizer",
            hint=" (set AVDB_NATIVE_CADD=0 to read with the Python scanner)",
        ))
        c = ctypes
        lib.avdb_parse_cadd_chunk.restype = c.c_int64
        lib.avdb_parse_cadd_chunk.argtypes = [
            c.c_char_p, c.c_int64, c.c_int32, c.c_int64,
            c.c_void_p, c.c_void_p,              # chrom, pos
            c.c_void_p, c.c_void_p,              # ref, alt
            c.c_void_p, c.c_void_p,              # ref_len, alt_len
            c.c_void_p, c.c_void_p,              # ref_off, alt_off
            c.c_void_p, c.c_void_p,              # raw, phred
            c.c_void_p, c.c_void_p, c.c_void_p,  # counters, consumed, need_more
        ]
        _lib = lib
        return _lib


def scan(path: str, batch_rows: int, width: int):
    """Yield per-fill column dicts: chrom/pos/ref/alt/ref_len/alt_len/raw/
    phred arrays plus ``ref_str``/``alt_str`` object columns (None except
    for over-width rows).  Arrays are fresh copies — callers may hold them
    across fills."""
    lib = load()
    c = ctypes
    cap = max(batch_rows, 1 << 14)
    chrom = np.empty(cap, np.int8)
    pos = np.empty(cap, np.int32)
    ref = np.empty((cap, width), np.uint8)
    alt = np.empty((cap, width), np.uint8)
    ref_len = np.empty(cap, np.int32)
    alt_len = np.empty(cap, np.int32)
    ref_off = np.empty(cap, np.int64)
    alt_off = np.empty(cap, np.int64)
    raw = np.empty(cap, np.float64)
    phred = np.empty(cap, np.float64)
    counters = np.zeros(2, np.int64)
    consumed = c.c_int64(0)
    need_more = c.c_int32(0)

    def p(a):
        return a.ctypes.data_as(c.c_void_p)

    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as fh:
        tail = b""
        eof = False
        while not eof or tail:
            window = tail
            if not eof:
                block = fh.read(READ_SIZE)
                if block:
                    window = tail + block
                else:
                    eof = True
                    if window and not window.endswith(b"\n"):
                        window += b"\n"
            elif window and not window.endswith(b"\n"):
                window += b"\n"
            if not window:
                break
            window_addr = ctypes.cast(
                ctypes.c_char_p(window), ctypes.c_void_p
            ).value
            start = 0
            while True:
                n = lib.avdb_parse_cadd_chunk(
                    ctypes.cast(window_addr + start, ctypes.c_char_p),
                    len(window) - start, width, cap,
                    p(chrom), p(pos), p(ref), p(alt),
                    p(ref_len), p(alt_len), p(ref_off), p(alt_off),
                    p(raw), p(phred),
                    counters.ctypes.data_as(c.c_void_p),
                    c.byref(consumed), c.byref(need_more),
                )
                if n:
                    out = {
                        "chrom": chrom[:n].copy(),
                        "pos": pos[:n].copy(),
                        "ref": ref[:n].copy(),
                        "alt": alt[:n].copy(),
                        "ref_len": ref_len[:n].copy(),
                        "alt_len": alt_len[:n].copy(),
                        "raw": raw[:n].copy(),
                        "phred": phred[:n].copy(),
                    }
                    over = (out["ref_len"] > width) | (out["alt_len"] > width)
                    ref_str = np.full(n, None, object)
                    alt_str = np.full(n, None, object)
                    for i in np.where(over)[0]:
                        o = start + int(ref_off[i])
                        ref_str[i] = window[o:o + int(ref_len[i])].decode()
                        o = start + int(alt_off[i])
                        alt_str[i] = window[o:o + int(alt_len[i])].decode()
                    out["ref_str"] = ref_str
                    out["alt_str"] = alt_str
                    yield out
                start += consumed.value
                if not need_more.value:
                    break
            tail = window[start:]
            if eof and tail and consumed.value == 0 and not need_more.value:
                break  # malformed remainder, no newline progress possible
