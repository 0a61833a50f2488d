"""The fused annotate + bin-index step: CUDA kernel and plain version.

:func:`annotate_bin` is the port of
``annotatedvdb_tpu/ops/annotate_pallas.py::annotate_bin_pallas``.  On a
CUDA tensor it launches the hand-written kernel ``csrc/annotate_bin.cu``
(one thread per variant, allele rows staged through shared memory — see
the source's note for its bound and design); on a CPU tensor it computes
the plain version :func:`annotate_bin_reference`, which composes
``ops/annotate.py`` and ``ops/binindex.py``.  There is no fallback between
the two: a CUDA input either launches or raises.

Parity contract (the reference's selection contract,
``annotatedvdb_tpu/models/pipeline.py:92-104``): ``host_fallback`` and
``needs_digest`` agree on every row; the other fields agree on every row
that is not ``host_fallback``.
"""

from __future__ import annotations

import ctypes

import torch

from annotatedvdb_tpu_torch.ops.annotate import annotate_kernel
from annotatedvdb_tpu_torch.ops.binindex import bin_index_kernel

#: kernel launches by wrapper name — incremented only where the kernel is
#: launched, so a run can show that its main path went through the kernel
LAUNCHES = {"annotate_bin": 0}

#: threads per block; must match ``kBlock`` in the source
BLOCK = 128
#: widest allele matrix the shared-memory staging takes (2 * BLOCK * W
#: bytes within the default 48 KB of dynamic shared memory)
MAX_WIDTH = (48 * 1024) // (2 * BLOCK)

#: output fields, dtypes and order of the C interface
FIELDS = (
    ("prefix_len", torch.int32),
    ("norm_ref_len", torch.int32),
    ("norm_alt_len", torch.int32),
    ("end_location", torch.int32),
    ("location_start", torch.int32),
    ("location_end", torch.int32),
    ("variant_class", torch.int8),
    ("is_dup_motif", torch.bool),
    ("bin_level", torch.int8),
    ("leaf_bin", torch.int32),
    ("needs_digest", torch.bool),
    ("host_fallback", torch.bool),
)

_lib = None


def _library():
    global _lib
    if _lib is None:
        from annotatedvdb_tpu_torch.ops.build import load

        lib = load("annotate_bin")
        lib.annotate_bin_launch.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_int]
            + [ctypes.c_void_p] * (len(FIELDS) + 1)
        )
        lib.annotate_bin_launch.restype = ctypes.c_int
        lib.annotate_bin_block.argtypes = []
        lib.annotate_bin_block.restype = ctypes.c_int
        if lib.annotate_bin_block() != BLOCK:
            raise RuntimeError("annotate_bin: library block size disagrees "
                               "with the wrapper")
        _lib = lib
    return _lib


def annotate_bin_reference(pos, ref, alt, ref_len, alt_len) -> dict:
    """Plain-torch annotate + bin index: the 12 output fields."""
    out = annotate_kernel(pos, ref, alt, ref_len, alt_len)
    out["bin_level"], out["leaf_bin"] = bin_index_kernel(
        pos, out["end_location"]
    )
    return {name: out[name] for name, _ in FIELDS}


def _check(pos, ref, alt, ref_len, alt_len) -> None:
    dev = ref.device
    for name, t, dtype, ndim in (
        ("pos", pos, torch.int32, 1), ("ref", ref, torch.uint8, 2),
        ("alt", alt, torch.uint8, 2), ("ref_len", ref_len, torch.int32, 1),
        ("alt_len", alt_len, torch.int32, 1),
    ):
        if t.device != dev:
            raise ValueError(f"annotate_bin: {name} is on {t.device}, ref on {dev}")
        if t.dtype != dtype:
            raise TypeError(f"annotate_bin: {name} must be {dtype}, not {t.dtype}")
        if t.dim() != ndim or not t.is_contiguous():
            raise ValueError(
                f"annotate_bin: {name} must be a contiguous {ndim}-D tensor"
            )
    n, w = ref.shape
    if alt.shape != ref.shape:
        raise ValueError(f"annotate_bin: alt {tuple(alt.shape)} != ref {tuple(ref.shape)}")
    if pos.shape[0] != n or ref_len.shape[0] != n or alt_len.shape[0] != n:
        raise ValueError("annotate_bin: row counts disagree")
    if not 1 <= w <= MAX_WIDTH:
        raise ValueError(
            f"annotate_bin: allele width {w} outside 1..{MAX_WIDTH} "
            "(the kernel stages [128, W] rows in shared memory)"
        )


def annotate_bin(pos, ref, alt, ref_len, alt_len) -> dict:
    """Fused annotate + bin index for one batch: ``pos``/``ref_len``/
    ``alt_len`` [N] int32, ``ref``/``alt`` [N, W] uint8 contiguous.

    CPU tensors take :func:`annotate_bin_reference`; CUDA tensors launch
    the kernel on the current stream (no synchronisation) or raise."""
    if ref.device.type == "cpu":
        return annotate_bin_reference(pos, ref, alt, ref_len, alt_len)
    if ref.device.type != "cuda":
        raise ValueError(f"annotate_bin: unsupported device {ref.device}")
    _check(pos, ref, alt, ref_len, alt_len)
    n, w = ref.shape
    out = {
        name: torch.empty((n,), dtype=dtype, device=ref.device)
        for name, dtype in FIELDS
    }
    if n == 0:
        return out
    lib = _library()
    stream = torch.cuda.current_stream(ref.device).cuda_stream
    rc = lib.annotate_bin_launch(
        pos.data_ptr(), ref.data_ptr(), alt.data_ptr(),
        ref_len.data_ptr(), alt_len.data_ptr(), n, w,
        *(out[name].data_ptr() for name, _ in FIELDS), stream,
    )
    if rc != 0:
        raise RuntimeError(f"annotate_bin: kernel launch failed (cudaError {rc})")
    LAUNCHES["annotate_bin"] += 1
    return out
