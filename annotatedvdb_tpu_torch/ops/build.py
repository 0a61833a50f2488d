"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into a shared library with
a plain C interface (loaded with ``ctypes``), for ``sm_90a``.  Builds run
at first use, never at import, into ``build/kernels/`` at the root of the
checkout; the library name carries a digest of the source and the flags,
so an edited source rebuilds and a stale library is never loaded.
:func:`build` starts one ``nvcc`` per missing library, all at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "kernels")

#: every kernel of the port, by library name -> source under ``csrc/``
KERNELS = {"annotate_bin": "annotate_bin.cu", "cadd_join": "cadd_join.cu",
           "validate_ref": "validate_ref.cu", "bits_spans": "bits_spans.cu",
           "stats_panel": "stats_panel.cu", "export_pack": "export_pack.cu",
           "lookup_multi": "lookup_multi.cu", "pack": "pack.cu"}

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(fallback):
        return fallback
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the port's kernels")


def library_path(name: str) -> str:
    """Where ``name``'s library lives for the current source and flags."""
    with open(os.path.join(CSRC_DIR, KERNELS[name]), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}.{digest.hexdigest()[:16]}.so")


def build(names=None) -> dict:
    """Compile every missing library among ``names`` (default: all), one
    ``nvcc`` process per source started together.  Returns
    ``{name: compiler log}`` for the libraries built by this call (the
    ``-Xptxas -v`` register and shared-memory report).  Raises with the
    compiler's output when a build fails."""
    names = list(KERNELS) if names is None else list(names)
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if os.path.exists(out):
            continue
        tmp = f"{out}.tmp{os.getpid()}"
        procs[name] = (out, tmp, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp,
             os.path.join(CSRC_DIR, KERNELS[name])],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    logs = {}
    failed = []
    for name, (out, tmp, proc) in procs.items():
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc rc {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``name``, building it first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build([name])
            lib = _loaded[name] = ctypes.CDLL(library_path(name))
        return lib
