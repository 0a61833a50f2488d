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

:func:`annotate_bin_packed` is the same kernel's second entry for the
packed transport's nibble-uploaded chunks: the ``[n, cols]`` packed allele
matrices in, the ``[n, 10]`` rows of ``ops/pack.py::pack_outputs`` (dup
lane 0) out, in one launch where the card took three (``inflate_alleles``,
``annotate_bin``, ``pack_outputs``).  Its plain version
:func:`annotate_bin_packed_reference` is the composition of those three
plain versions.  Against it, bytes 0-3 (the hash) and 9 (the flags) agree
on every row and bytes 4-8 (leaf bin, bin level) on every row whose
``host_fallback`` bit is clear; against the card's three-kernel route every
byte agrees.
"""

from __future__ import annotations

import ctypes

import torch

from annotatedvdb_tpu_torch.ops.annotate import annotate_kernel
from annotatedvdb_tpu_torch.ops.binindex import bin_index_kernel
from annotatedvdb_tpu_torch.ops.hashing import allele_hash, hash_bits
from annotatedvdb_tpu_torch.ops.pack import (
    WIDTH as PACKED_ROW,
    inflate_alleles_reference,
    pack_outputs_reference,
)

#: kernel launches by wrapper name — incremented only where a kernel entry
#: is launched, so a run can show that its main path went through it
LAUNCHES = {"annotate_bin": 0, "annotate_bin_packed": 0}

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
        lib.annotate_bin_packed_launch.argtypes = (
            [ctypes.c_void_p] * 5
            + [ctypes.c_int] * 3 + [ctypes.c_void_p, ctypes.c_void_p]
        )
        lib.annotate_bin_packed_launch.restype = ctypes.c_int
        lib.annotate_bin_packed_blocks_per_sm.argtypes = [ctypes.c_int] * 2
        lib.annotate_bin_packed_blocks_per_sm.restype = ctypes.c_int
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


def _check(fn, pos, ref, alt, ref_len, alt_len, names=("ref", "alt")) -> None:
    """One batch's tensors for entry ``fn``: one device, the dtypes, ranks
    and contiguity the kernel reads, ``alt`` shaped like ``ref`` (the two
    matrices, named ``names``) and one row count."""
    dev = ref.device
    for name, t, dtype, ndim in (
        ("pos", pos, torch.int32, 1), (names[0], ref, torch.uint8, 2),
        (names[1], alt, torch.uint8, 2), ("ref_len", ref_len, torch.int32, 1),
        ("alt_len", alt_len, torch.int32, 1),
    ):
        if t.device != dev:
            raise ValueError(f"{fn}: {name} is on {t.device}, {names[0]} on {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{fn}: {name} must be {dtype}, not {t.dtype}")
        if t.dim() != ndim or not t.is_contiguous():
            raise ValueError(f"{fn}: {name} must be a contiguous {ndim}-D tensor")
    if alt.shape != ref.shape:
        raise ValueError(f"{fn}: {names[1]} {tuple(alt.shape)} != {names[0]} "
                         f"{tuple(ref.shape)}")
    n = ref.shape[0]
    if pos.shape[0] != n or ref_len.shape[0] != n or alt_len.shape[0] != n:
        raise ValueError(f"{fn}: row counts disagree")


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
    _check("annotate_bin", pos, ref, alt, ref_len, alt_len)
    n, w = ref.shape
    if not 1 <= w <= MAX_WIDTH:
        raise ValueError(
            f"annotate_bin: allele width {w} outside 1..{MAX_WIDTH} "
            "(the kernel stages [128, W] tiles in shared memory)"
        )
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


def annotate_bin_packed_reference(pos, ref_packed, alt_packed, ref_len,
                                  alt_len, width: int) -> torch.Tensor:
    """Plain torch packed step: ``inflate_alleles_reference``, then
    :func:`annotate_bin_reference`, then ``pack_outputs_reference`` with no
    dup lane: ``[n, 10]`` uint8 rows."""
    ref, alt = inflate_alleles_reference(ref_packed, alt_packed, int(width))
    out = annotate_bin_reference(pos, ref, alt, ref_len, alt_len)
    return pack_outputs_reference(out["allele_hash"], None, out["bin_level"],
                                  out["leaf_bin"], out["needs_digest"],
                                  out["host_fallback"])


def annotate_bin_packed(pos, ref_packed, alt_packed, ref_len, alt_len,
                        width: int) -> torch.Tensor:
    """The packed step for one batch: ``pos``/``ref_len``/``alt_len`` [N]
    int32, ``ref_packed``/``alt_packed`` [N, cols] uint8 nibble codes
    (``ops/pack.py::encode_alleles_nibble``, ``ceil(width / 2) <= cols <=
    MAX_WIDTH``), all contiguous (any storage offset) -> ``[N, 10]`` uint8
    packed rows (``ops/pack.py::unpack_outputs`` reads them).

    CPU tensors take :func:`annotate_bin_packed_reference`; CUDA tensors
    launch the kernel's packed entry once on the current stream (no
    synchronisation) or raise."""
    width = int(width)
    if ref_packed.device.type not in ("cpu", "cuda"):
        raise ValueError(f"annotate_bin_packed: unsupported device {ref_packed.device}")
    _check("annotate_bin_packed", pos, ref_packed, alt_packed, ref_len, alt_len,
           ("ref_packed", "alt_packed"))
    n, cols = ref_packed.shape
    if not 1 <= width <= MAX_WIDTH:
        raise ValueError(f"annotate_bin_packed: allele width {width} outside "
                         f"1..{MAX_WIDTH}")
    if not (width + 1) // 2 <= cols <= MAX_WIDTH:
        raise ValueError(f"annotate_bin_packed: width {width} needs "
                         f"{(width + 1) // 2}..{MAX_WIDTH} packed columns, not {cols} "
                         "(the kernel stages [128, cols] tiles in shared memory)")
    if ref_packed.device.type == "cpu":
        return annotate_bin_packed_reference(pos, ref_packed, alt_packed,
                                             ref_len, alt_len, width)
    out = torch.empty((n, PACKED_ROW), dtype=torch.uint8, device=ref_packed.device)
    if n == 0:
        return out
    rc = _library().annotate_bin_packed_launch(
        pos.data_ptr(), ref_packed.data_ptr(), alt_packed.data_ptr(),
        ref_len.data_ptr(), alt_len.data_ptr(), n, cols, width, out.data_ptr(),
        torch.cuda.current_stream(ref_packed.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"annotate_bin_packed: kernel launch failed (cudaError {rc})")
    LAUNCHES["annotate_bin_packed"] += 1
    return out
