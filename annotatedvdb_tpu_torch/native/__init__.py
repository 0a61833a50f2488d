"""The port's native host libraries and their one g++ build.

Port of ``annotatedvdb_tpu/native/__init__.py``.  Three C++ sources live
beside this file: the VCF tokenizer (``avdb_native.cpp``, bound here), the
VEP-result transformer (``avdb_vep.cpp``, bound in ``vep.py``) and the
CPython extension that assembles raw-JSON column lists
(``avdb_pyfast.cpp``, loaded in ``pyfast.py``).  Each builds at first use,
never at import, with the system ``g++`` into ``build/native/`` at the
root of the checkout (:func:`build_shared_lib`).  A library's name carries
a digest of its source, the flags and the host's CPU identity, so an edited
source rebuilds and a ``-march=native`` library built on another CPU is
never loaded.  A build that fails raises with the compiler's stderr: there
is no quiet fallback to the Python paths (``AVDB_INGEST_ENGINE=python``
and ``AVDB_NATIVE_VEP=0`` are the explicit ways there).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "avdb_native.cpp")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "build", "native",
)
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib = None


def _host_tag() -> bytes:
    """CPU identity folded into the build digest: a ``-march=native``
    library is valid only on the microarchitecture that built it, so a
    build directory carried to another host rebuilds instead of dying on
    an illegal instruction."""
    tag = platform.machine()
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("model name", "flags")):
                    tag += line
                    if line.startswith("flags"):
                        break
    except OSError:
        pass
    return tag.encode()


def library_path(source: str, stem: str, extra_flags: tuple = ()) -> str:
    """Where ``stem``'s library lives for the current source, flags and
    host."""
    with open(source, "rb") as f:
        digest = hashlib.sha256(
            f.read() + " ".join(GXX_FLAGS + tuple(extra_flags)).encode()
            + _host_tag()
        ).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"{stem}-{digest}.so")


def build_shared_lib(source: str, stem: str, what: str,
                     extra_flags: tuple = (), hint: str = "") -> str:
    """Compile ``source`` into ``build/native/`` unless its library exists;
    returns the path.  The tmp-then-rename publish is atomic under
    concurrent builds.  Raises RuntimeError ``"<what> build failed"`` with
    the compiler's stderr (or ``hint`` when there is no g++)."""
    so_path = library_path(source, stem, extra_flags)
    if os.path.exists(so_path):
        return so_path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so_path}.tmp{os.getpid()}"
    try:
        subprocess.run(["g++", *GXX_FLAGS, *extra_flags, "-o", tmp, source],
                       check=True, capture_output=True, text=True)
    except FileNotFoundError as err:
        raise RuntimeError(f"{what} build failed: g++ not found{hint}") from err
    except subprocess.CalledProcessError as err:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(
            f"{what} build failed:\n{err.stderr[-2000:]}"
        ) from err
    os.replace(tmp, so_path)
    return so_path


def build() -> str:
    """Compile the tokenizer unless it exists; returns its path."""
    return build_shared_lib(
        SOURCE, "avdb_native", "native tokenizer",
        hint=" (set AVDB_INGEST_ENGINE=python to read with the Python "
             "tokenizer)",
    )


def load() -> ctypes.CDLL:
    """The loaded tokenizer with its C interface declared, building it
    first if needed.  Raises when the build or the load fails."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(build())
        c = ctypes
        lib.avdb_parse_vcf_chunk.restype = c.c_int64
        lib.avdb_parse_vcf_chunk.argtypes = [
            c.c_char_p, c.c_int64, c.c_int32, c.c_int64, c.c_int64,
            c.c_void_p, c.c_void_p, c.c_void_p, c.c_void_p,   # chrom,pos,ref,alt
            c.c_void_p, c.c_void_p, c.c_void_p, c.c_void_p,   # rlen,alen,multi,line
            c.c_void_p, c.c_void_p,                            # ref_off, alt_off
            c.c_void_p, c.c_void_p, c.c_void_p, c.c_void_p,   # id, qual
            c.c_void_p, c.c_void_p, c.c_void_p, c.c_void_p,   # filter, info
            c.c_void_p, c.c_void_p,                            # format
            c.c_void_p, c.c_void_p,                            # altcol
            c.c_void_p, c.c_void_p,                            # alt_index, n_alts
            c.c_void_p, c.c_void_p,                            # rs_number, rs_weird
            c.c_void_p, c.c_void_p,                            # id_verbatim, has_freq
            c.c_void_p,                                        # hash
            c.c_void_p, c.c_void_p, c.c_void_p,               # ref_packed, alt_packed, pack_ok
            c.c_int32, c.c_int32,                              # identity_only, want_packed
            c.c_void_p, c.c_void_p, c.c_void_p,               # counters, consumed, need_more
        ]
        _lib = lib
        return _lib
