"""Batched Binary Interval Search (BITS): row spans and bin tokens of query
intervals, CUDA kernel and plain version.

Port of ``annotatedvdb_tpu/ops/intervals.py``.  The database is one
chromosome group's position-sorted, deduplicated row positions (the serve
engine's interval index); each 1-based inclusive query ``[start, end]``
is two binary searches over it:

- ``lo = searchsorted(pos, start, side="left")``  (rows before the query)
- ``hi = searchsorted(pos, end,   side="right")`` (rows not after it)

so ``[lo, hi)`` is the query's row span and ``hi - lo`` its count.  The
same call yields the closed-form hierarchical bin token of each query
(``(level, leaf)``, the arithmetic of ``ops/binindex.py``).

:func:`bits_spans` replaces ``bits_spans_kernel``: on CUDA tensors it
launches the hand-written ``csrc/bits_spans.cu`` once (a warp per query:
both bounds by k-ary ballot searches, and the bin token); on CPU tensors
it computes :func:`bits_spans_reference`, two ``torch.searchsorted`` calls
and the bin arithmetic.  There is no fallback between the two.
:func:`interval_spans` is the device entry point (clamp, pow2 padding,
numpy out) and :func:`interval_spans_host` its numpy twin, the path the
serving circuit breaker takes.

:func:`bits_spans_stacked` replaces the mesh surface of the same name: a
stack of groups' sentinel-padded rows ``[B, R]`` against each group's
zero-padded queries ``[B, Q]`` in one launch of the same kernel with a
group index (the mesh executor launches it once per shard's stack);
:func:`bits_spans_stacked_reference` is its plain version (batched
``torch.searchsorted``) and :func:`bits_spans_stacked_host` the numpy
twin.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from annotatedvdb_tpu_torch.ops.binindex import (
    LEAF_SIZE,
    NUM_BIN_LEVELS,
    bin_index_kernel,
)
from annotatedvdb_tpu_torch.utils.arrays import POS_SENTINEL, pad_pow2

#: query coordinates are clamped below the position sentinel before either
#: search path: store positions are int32 (< POS_SENTINEL by construction),
#: so the clamp never changes an answer, and the kernel's int32 arithmetic
#: can never wrap on an absurd-but-grammatical query bound
MAX_QUERY_POS = int(POS_SENTINEL) - 16

#: kernel launches by wrapper name — incremented only where the kernel is
#: launched, so a run can show that its main path went through the kernel
LAUNCHES = {"bits_spans": 0, "bits_spans_stacked": 0}

#: calls of :func:`bits_spans_reference` by device type, so a run can show
#: that its card path never took the plain version
CALLS = {"cpu": 0, "cuda": 0}

_lib = None


def _library() -> ctypes.CDLL:
    """The kernel's library with its C interface declared (built at first
    use)."""
    global _lib
    if _lib is None:
        from annotatedvdb_tpu_torch.ops.build import load

        lib = load("bits_spans")
        lib.bits_spans_launch.argtypes = (
            [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int] + [ctypes.c_void_p] * 5
        )
        lib.bits_spans_launch.restype = ctypes.c_int
        lib.bits_spans_stacked_launch.argtypes = (
            [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 5
        )
        lib.bits_spans_stacked_launch.restype = ctypes.c_int
        _lib = lib
    return _lib


def bits_spans_reference(pos, starts, ends):
    """Plain-torch BITS: ``(lo [Q] int32, hi [Q] int32, level [Q] int8,
    leaf [Q] int32)`` for sorted int32 ``pos`` [K] and int32 ``starts``/
    ``ends`` [Q]."""
    kind = pos.device.type
    CALLS[kind] = CALLS.get(kind, 0) + 1
    pos = pos.to(torch.int32)
    starts = starts.to(torch.int32)
    ends = ends.to(torch.int32)
    lo = torch.searchsorted(pos, starts, right=False).to(torch.int32)
    hi = torch.searchsorted(pos, ends, right=True).to(torch.int32)
    level, leaf = bin_index_kernel(starts, ends)
    return lo, hi, level, leaf


def _check(pos, starts, ends) -> None:
    dev = pos.device
    for name, t in (("pos", pos), ("starts", starts), ("ends", ends)):
        if t.device != dev:
            raise ValueError(f"bits_spans: {name} is on {t.device}, pos on {dev}")
        if t.dtype != torch.int32:
            raise TypeError(f"bits_spans: {name} must be int32, not {t.dtype}")
        if t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"bits_spans: {name} must be a contiguous 1-D tensor")
    if starts.shape != ends.shape:
        raise ValueError("bits_spans: starts and ends disagree in shape")
    if pos.shape[0] >= 2**31 - 1 or starts.shape[0] >= 2**31 - 1:
        raise ValueError("bits_spans: too many rows for int32 indices")


def bits_spans(pos, starts, ends):
    """Row spans and bin tokens of ``starts``/``ends`` [Q] against the
    sorted ``pos`` [K] (all int32, one device).

    CPU tensors take :func:`bits_spans_reference`; CUDA tensors launch the
    kernel once on the current stream (no synchronisation) or raise.
    Returns (lo [Q] int32, hi [Q] int32, level [Q] int8, leaf [Q] int32)."""
    if pos.device.type == "cpu":
        return bits_spans_reference(pos, starts, ends)
    if pos.device.type != "cuda":
        raise ValueError(f"bits_spans: unsupported device {pos.device}")
    _check(pos, starts, ends)
    q = starts.shape[0]
    dev = pos.device
    lo = torch.empty((q,), dtype=torch.int32, device=dev)
    hi = torch.empty((q,), dtype=torch.int32, device=dev)
    level = torch.empty((q,), dtype=torch.int8, device=dev)
    leaf = torch.empty((q,), dtype=torch.int32, device=dev)
    if q == 0:
        return lo, hi, level, leaf
    rc = _library().bits_spans_launch(
        pos.data_ptr(), pos.shape[0], starts.data_ptr(), ends.data_ptr(), q,
        lo.data_ptr(), hi.data_ptr(), level.data_ptr(), leaf.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"bits_spans: kernel launch failed (cudaError {rc})")
    LAUNCHES["bits_spans"] += 1
    return lo, hi, level, leaf


def bits_spans_stacked_reference(pos, starts, ends):
    """Plain-torch stacked BITS: ``(lo, hi, level, leaf)`` [B, Q] for
    sorted int32 rows ``pos`` [B, R] and int32 ``starts``/``ends`` [B, Q]
    (one batched ``torch.searchsorted`` per bound)."""
    kind = pos.device.type
    CALLS[kind] = CALLS.get(kind, 0) + 1
    pos = pos.to(torch.int32)
    starts = starts.to(torch.int32)
    ends = ends.to(torch.int32)
    lo = torch.searchsorted(pos, starts, right=False).to(torch.int32)
    hi = torch.searchsorted(pos, ends, right=True).to(torch.int32)
    level, leaf = bin_index_kernel(starts, ends)
    return lo, hi, level, leaf


def _check_stacked(pos, starts, ends) -> None:
    dev = pos.device
    for name, t in (("pos", pos), ("starts", starts), ("ends", ends)):
        if t.device != dev:
            raise ValueError(
                f"bits_spans_stacked: {name} is on {t.device}, pos on {dev}"
            )
        if t.dtype != torch.int32:
            raise TypeError(
                f"bits_spans_stacked: {name} must be int32, not {t.dtype}"
            )
        if t.dim() != 2 or not t.is_contiguous():
            raise ValueError(
                f"bits_spans_stacked: {name} must be a contiguous 2-D tensor"
            )
    if starts.shape != ends.shape or starts.shape[0] != pos.shape[0]:
        raise ValueError("bits_spans_stacked: the stack's shapes disagree")
    if max(pos.shape[1], starts.shape[1], pos.shape[0]) >= 2**31 - 1:
        raise ValueError("bits_spans_stacked: too many rows for int32 indices")


def bits_spans_stacked(pos, starts, ends):
    """Row spans and bin tokens for a stack of groups: ``pos`` [B, R]
    sorted rows per group, ``starts``/``ends`` [B, Q] (all int32, one
    device).  Row for row what :func:`bits_spans` gives on the same (pos
    row, query row).

    CPU tensors take :func:`bits_spans_stacked_reference`; CUDA tensors
    launch the kernel once on the current stream or raise.  Returns (lo,
    hi [B, Q] int32, level [B, Q] int8, leaf [B, Q] int32)."""
    if pos.device.type == "cpu":
        return bits_spans_stacked_reference(pos, starts, ends)
    if pos.device.type != "cuda":
        raise ValueError(f"bits_spans_stacked: unsupported device {pos.device}")
    _check_stacked(pos, starts, ends)
    b, q = starts.shape
    dev = pos.device
    lo = torch.empty((b, q), dtype=torch.int32, device=dev)
    hi = torch.empty((b, q), dtype=torch.int32, device=dev)
    level = torch.empty((b, q), dtype=torch.int8, device=dev)
    leaf = torch.empty((b, q), dtype=torch.int32, device=dev)
    if b * q == 0:
        return lo, hi, level, leaf
    rc = _library().bits_spans_stacked_launch(
        pos.data_ptr(), b, pos.shape[1], starts.data_ptr(), ends.data_ptr(),
        q, lo.data_ptr(), hi.data_ptr(), level.data_ptr(), leaf.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(
            f"bits_spans_stacked: kernel launch failed (cudaError {rc})"
        )
    LAUNCHES["bits_spans_stacked"] += 1
    return lo, hi, level, leaf


def bits_spans_stacked_host(pos, starts, ends):
    """Numpy twin of :func:`bits_spans_stacked`: the same per-row binary
    searches and bin arithmetic over the same int32 values."""
    pos = np.asarray(pos, np.int32)
    starts = np.asarray(starts, np.int32)
    ends = np.asarray(ends, np.int32)
    lo = np.stack([
        np.searchsorted(pos[i], starts[i], side="left").astype(np.int32)
        for i in range(pos.shape[0])
    ]) if pos.shape[0] else np.zeros(starts.shape, np.int32)
    hi = np.stack([
        np.searchsorted(pos[i], ends[i], side="right").astype(np.int32)
        for i in range(pos.shape[0])
    ]) if pos.shape[0] else np.zeros(ends.shape, np.int32)
    a = (starts.astype(np.int64) - 1) // LEAF_SIZE
    b = (ends.astype(np.int64) - 1) // LEAF_SIZE
    x = a ^ b
    shifts = np.arange(NUM_BIN_LEVELS, dtype=np.int64)
    mism = ((x[:, :, None] >> shifts[None, None, :]) != 0).sum(axis=2)
    level = (NUM_BIN_LEVELS - mism).astype(np.int8)
    return lo, hi, level, a.astype(np.int32)


def clamped_queries(starts, ends):
    """int32 query bounds, clamped into the representable position range
    (every search path clamps identically, so they stay byte-identical)."""
    starts = np.clip(np.asarray(starts, np.int64), 0, MAX_QUERY_POS)
    ends = np.clip(np.asarray(ends, np.int64), 0, MAX_QUERY_POS)
    return starts.astype(np.int32), ends.astype(np.int32)


def interval_spans(pos, starts, ends, *, pos_padded: bool = False,
                   device=None):
    """Device entry point: clamp the queries, pad rows to a power of two
    with the position sentinel and queries with zeros, run
    :func:`bits_spans` once, slice the padding back off.  Returns numpy
    ``(lo, hi, level, leaf)``.

    ``pos_padded=True`` marks ``pos`` as an already sentinel-padded tensor
    (the engine uploads each index once) and the call runs on its device;
    otherwise ``pos`` is a numpy array, padded and uploaded to ``device``
    (``cuda`` unless the caller asks for ``cpu``).  Sentinel rows sort
    after every real position and every clamped bound, so real spans never
    reach into the padding; padded query slots are sliced away."""
    from annotatedvdb_tpu_torch.runtime import resolve_device, to_device

    starts, ends = clamped_queries(starts, ends)
    nq = starts.shape[0]
    if pos_padded:
        pos_t = pos
    else:
        pos_t = to_device(pad_pow2(np.asarray(pos, np.int32), POS_SENTINEL),
                          resolve_device(device))
    dev = pos_t.device
    out = bits_spans(pos_t, to_device(pad_pow2(starts, 0), dev),
                     to_device(pad_pow2(ends, 0), dev))
    return tuple(o.cpu().numpy()[:nq] for o in out)


def interval_spans_host(pos: np.ndarray, starts, ends):
    """Numpy twin of :func:`interval_spans` — the circuit-breaker /
    ``host_only`` path: the same clamped int32 inputs through the same
    binary-search definition."""
    starts, ends = clamped_queries(starts, ends)
    lo = np.searchsorted(pos, starts, side="left").astype(np.int32)
    hi = np.searchsorted(pos, ends, side="right").astype(np.int32)
    level, leaf = bin_tokens_host(starts, ends)
    return lo, hi, level, leaf


def bin_tokens_host(starts, ends):
    """Vectorized closed-form (level, leaf) bins on the host, with the
    same :data:`MAX_QUERY_POS` clamp every other search path applies."""
    starts = np.clip(np.asarray(starts, np.int64), 0, MAX_QUERY_POS)
    ends = np.clip(np.asarray(ends, np.int64), 0, MAX_QUERY_POS)
    a = (starts - 1) // LEAF_SIZE
    b = (ends - 1) // LEAF_SIZE
    x = a ^ b
    shifts = np.arange(NUM_BIN_LEVELS, dtype=np.int64)
    mism = ((x[:, None] >> shifts[None, :]) != 0).sum(axis=1)
    level = (NUM_BIN_LEVELS - mism).astype(np.int8)
    return level, a.astype(np.int32)
