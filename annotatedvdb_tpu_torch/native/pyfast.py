"""Loader for the ``avdb_pyfast`` CPython extension (``avdb_pyfast.cpp``):
C assembly of RawJson column lists for the native VEP apply path.

Port of ``annotatedvdb_tpu/native/pyfast.py``.  Unlike the ctypes
libraries this is a real extension module (it creates Python objects),
built at first use into ``build/native/`` (``native/__init__.py``, with
the interpreter's include directory) and imported from there.  A
load-time probe checks that the slot-offset construction yields working
:class:`~annotatedvdb_tpu_torch.store.variant_store.RawJson` instances.
A failed build or probe raises with its cause: there is no quiet fallback
to a Python assembly loop (``AVDB_NATIVE_VEP=0`` is the way to the Python
transform).  Callers go through :func:`raw_rows`, which validates buffer
dtypes before handing them to C.
"""

from __future__ import annotations

import importlib.machinery
import importlib.util
import os
import sysconfig
import threading

import numpy as np

from annotatedvdb_tpu_torch import native
from annotatedvdb_tpu_torch.store.variant_store import RawJson

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "avdb_pyfast.cpp")

_lock = threading.Lock()
_mod = None


def _probe(mod) -> None:
    """The slot-offset construction must yield REAL RawJson behavior: text
    round trip, lazy parse, consecutive-span sharing, empty -> dict.
    Explicit raises (not asserts): this gate keeps a broken ABI assumption
    from writing corrupt values into stores, and it must survive
    ``python -O``."""
    arena = '{"a": 1}{"b": [2, 3]}'
    offs = np.array([0, 8, 8, 0], np.int64)
    lens = np.array([8, 13, 13, 0], np.int32)
    try:
        out = mod.raw_rows(arena, offs, lens, RawJson)
    except Exception as err:  # a class whose slots the C side cannot fill
        raise RuntimeError(f"avdb_pyfast probe failed: {err!r}") from err
    checks = (
        (isinstance(out[0], RawJson), "row 0 not a RawJson"),
        (out[0].text == '{"a": 1}', "text slot wrong"),
        (out[0]["a"] == 1, "lazy parse broken"),
        (out[1] is out[2], "consecutive span not shared"),
        (out[1]["b"] == [2, 3], "shared span content wrong"),
        (out[3] == {} and isinstance(out[3], dict), "empty span not a dict"),
        (out[0].fresh() == {"a": 1}, "fresh() broken"),
    )
    for ok, what in checks:
        if not ok:
            raise RuntimeError(f"avdb_pyfast probe failed: {what}")


def load():
    """The probed extension module, building it first if needed.  Raises
    when the build, the import or the probe fails."""
    global _mod
    with _lock:
        if _mod is not None:
            return _mod
        so = native.build_shared_lib(
            SOURCE, "avdb_pyfast", "avdb_pyfast extension",
            (f"-I{sysconfig.get_paths()['include']}",),
            hint=" (set AVDB_NATIVE_VEP=0 for the Python transform)",
        )
        loader = importlib.machinery.ExtensionFileLoader("avdb_pyfast", so)
        spec = importlib.util.spec_from_loader("avdb_pyfast", loader)
        mod = importlib.util.module_from_spec(spec)
        loader.exec_module(mod)
        _probe(mod)
        _mod = mod
        return _mod


def raw_rows(arena: str, offs: np.ndarray, lens: np.ndarray, cls) -> list:
    """Validated front door for the C assembly: the extension reinterprets
    the buffers as int64/int32, so dtype mistakes must fail HERE, loudly,
    not read garbage offsets in C."""
    if offs.dtype != np.int64 or lens.dtype != np.int32:
        raise TypeError(
            f"raw_rows needs int64 offs / int32 lens, got "
            f"{offs.dtype}/{lens.dtype}"
        )
    return load().raw_rows(
        arena, np.ascontiguousarray(offs), np.ascontiguousarray(lens), cls
    )
