"""The fused annotate + bin-index + allele-hash step: CUDA kernel and plain
version.

:func:`annotate_bin` is the port of
``annotatedvdb_tpu/ops/annotate_pallas.py::annotate_bin_pallas`` with the
reference's next device step, ``ops/hashing.py::allele_hash``, fused into
the same pass.  On a CUDA tensor it launches the hand-written kernel
``csrc/annotate_bin.cu`` once (see the source's note for its bound and
design); on a CPU tensor it computes the plain version
:func:`annotate_bin_reference`, which composes ``ops/annotate.py``,
``ops/binindex.py`` and ``ops/hashing.py``.  There is no fallback between
the two: a CUDA input either launches or raises.

Parity contract (the reference's selection contract,
``annotatedvdb_tpu/models/pipeline.py:92-104``): ``host_fallback``,
``needs_digest`` and ``allele_hash`` agree on every row; the other fields
agree on every row that is not ``host_fallback``.
"""

from __future__ import annotations

import ctypes

import torch

from annotatedvdb_tpu_torch.ops.annotate import annotate_kernel
from annotatedvdb_tpu_torch.ops.binindex import bin_index_kernel
from annotatedvdb_tpu_torch.ops.hashing import allele_hash, hash_bits

#: kernel launches by wrapper name — incremented only where the kernel is
#: launched, so a run can show that its main path went through the kernel
LAUNCHES = {"annotate_bin": 0}

#: widest allele matrix the kernel takes (``kMaxWidth`` in the source):
#: two stages of [128, W] ref and alt tiles in shared memory
MAX_WIDTH = 192

#: output fields, dtypes and order.  ``allele_hash`` holds the uint32
#: hash's bits (``ops.hashing.to_uint32`` reads them back as uint32).
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
    ("allele_hash", torch.int32),
)
#: fields exact on every row; the others only where host_fallback is False
EVERY_ROW = ("host_fallback", "needs_digest", "allele_hash")

# the kernel's output buffer: the int32 fields in FIELDS order, then the
# one-byte fields in FIELDS order, n values each (``Word``/``Byte`` enums);
# per field: (name, int32?, index among its kind, dtype)
_WORDS = tuple(name for name, dtype in FIELDS if dtype == torch.int32)
_BYTES = tuple(name for name, dtype in FIELDS if dtype != torch.int32)
_CARVE = tuple(
    (name, dtype == torch.int32,
     (_WORDS if dtype == torch.int32 else _BYTES).index(name), dtype)
    for name, dtype in FIELDS
)
ROW_BYTES = 4 * len(_WORDS) + len(_BYTES)
_DTYPES = (torch.int32, torch.uint8, torch.uint8, torch.int32, torch.int32)
_NDIMS = (1, 2, 2, 1, 1)

_lib = None


def _library() -> ctypes.CDLL:
    """The kernel's library with its C interface declared (built at first
    use); checks its width limit."""
    global _lib
    if _lib is None:
        from annotatedvdb_tpu_torch.ops.build import load

        lib = load("annotate_bin")
        lib.annotate_bin_launch.argtypes = (
            [ctypes.c_void_p] * 5
            + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
        )
        lib.annotate_bin_launch.restype = ctypes.c_int
        for fn in ("annotate_bin_tile_rows", "annotate_bin_max_width"):
            getattr(lib, fn).argtypes = []
            getattr(lib, fn).restype = ctypes.c_int
        lib.annotate_bin_blocks_per_sm.argtypes = [ctypes.c_int]
        lib.annotate_bin_blocks_per_sm.restype = ctypes.c_int
        if lib.annotate_bin_max_width() != MAX_WIDTH:
            raise RuntimeError("annotate_bin: library width limit disagrees "
                               "with the wrapper")
        _lib = lib
    return _lib


def annotate_bin_reference(pos, ref, alt, ref_len, alt_len) -> dict:
    """Plain-torch annotate + bin index + allele hash: the 13 fields."""
    out = annotate_kernel(pos, ref, alt, ref_len, alt_len)
    out["bin_level"], out["leaf_bin"] = bin_index_kernel(
        pos, out["end_location"]
    )
    out["allele_hash"] = hash_bits(allele_hash(ref, alt, ref_len, alt_len))
    return {name: out[name] for name, _ in FIELDS}


def _check(pos, ref, alt, ref_len, alt_len) -> None:
    dev = ref.device
    args = (pos, ref, alt, ref_len, alt_len)
    n, w = ref.shape if ref.dim() == 2 else (-1, 0)
    if (all(t.device == dev and t.dtype == d and t.dim() == k and t.is_contiguous()
            for t, d, k in zip(args, _DTYPES, _NDIMS))
            and alt.shape == ref.shape
            and pos.shape[0] == ref_len.shape[0] == alt_len.shape[0] == n
            and 1 <= w <= MAX_WIDTH):
        return
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
            "(the kernel stages [128, W] tiles in shared memory)"
        )


def _outputs(n: int, device) -> tuple:
    """One byte buffer for a launch over ``n`` rows, and its 13 views."""
    buf = torch.empty((n * ROW_BYTES,), dtype=torch.uint8, device=device)
    split = 4 * len(_WORDS) * n
    words = buf[:split].view(torch.int32).view(len(_WORDS), n).unbind(0)
    rest = buf[split:].view(len(_BYTES), n).unbind(0)
    return buf, {name: words[i] if word else rest[i].view(dtype)
                 for name, word, i, dtype in _CARVE}


def annotate_bin(pos, ref, alt, ref_len, alt_len) -> dict:
    """Fused annotate + bin index + allele hash for one batch:
    ``pos``/``ref_len``/``alt_len`` [N] int32, ``ref``/``alt`` [N, W] uint8
    contiguous (any storage offset).

    CPU tensors take :func:`annotate_bin_reference`; CUDA tensors launch
    the kernel once on the current stream (no synchronisation) or raise."""
    if ref.device.type == "cpu":
        return annotate_bin_reference(pos, ref, alt, ref_len, alt_len)
    if ref.device.type != "cuda":
        raise ValueError(f"annotate_bin: unsupported device {ref.device}")
    _check(pos, ref, alt, ref_len, alt_len)
    n, w = ref.shape
    buf, out = _outputs(n, ref.device)
    if n == 0:
        return out
    rc = _library().annotate_bin_launch(
        pos.data_ptr(), ref.data_ptr(), alt.data_ptr(), ref_len.data_ptr(),
        alt_len.data_ptr(), n, w, buf.data_ptr(),
        torch.cuda.current_stream(ref.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"annotate_bin: kernel launch failed (cudaError {rc})")
    LAUNCHES["annotate_bin"] += 1
    return out
