"""Fixed-shape corpus batch packing: bin token and mask, CUDA kernel and
plain version.

Port of ``annotatedvdb_tpu/ops/export_pack.py``.  The corpus export
(``export/core.py``) and ``GET /export/stream`` pack one batch of ``B``
rows at a time: seven int32 columns (``pos``, ``end``, ``ref_code``,
``alt_code``, ``af_fp``, ``cadd_fp``, ``rank_i``) padded to ``B`` and the
count ``n_valid`` of real rows.  Per row:

- ``leaf_bin = (pos - 1) // LEAF_SIZE`` and ``bin_level = NUM_BIN_LEVELS``
  minus the number of shifts ``s`` in ``0..12`` at which
  ``(leaf_bin ^ ((end - 1) // LEAF_SIZE)) >> s`` is still nonzero (the
  closed-form bin of ``ops/binindex.py``; int32 arithmetic that wraps and
  floors, as JAX's does);
- the mask ``row < n_valid``, and every output lane at or past
  ``n_valid`` forced to ``-1``.

:func:`export_pack_reference` is the plain PyTorch version, written from
the JAX function; :func:`export_pack_host` the numpy copy of the
reference's twin, the path of ``--hostOnly`` and of an open serving
breaker.  :func:`export_pack` takes the seven columns as one ``[7, B]``
int32 tensor (one upload a batch) and returns the nine outputs packed in
one ``[30 * B]`` byte buffer (one copy back a batch; :func:`unpack` splits
it into the reference's dtypes): on a CUDA tensor it launches the
hand-written ``csrc/export_pack.cu`` once, on a CPU tensor it packs
:func:`export_pack_reference`'s outputs.  There is no fallback between the
two.  :func:`pack_columns` is the device entry point: numpy in, numpy out.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from annotatedvdb_tpu_torch.ops.binindex import LEAF_SIZE, NUM_BIN_LEVELS

#: the input columns, in the row order of the ``[7, B]`` tensor
COLUMNS = ("pos", "end", "ref_code", "alt_code", "af_fp", "cadd_fp", "rank_i")

#: int32 outputs, in the row order of the packed buffer's first 28 B bytes
#: (then the mask's B bytes and the level's B bytes)
INT32_OUTPUTS = ("leaf_bin", "pos", "ref_code", "alt_code", "af_fp",
                 "cadd_fp", "rank_i")

#: packed bytes per row: seven int32 outputs, the mask and the level
PACKED_ROW_BYTES = 4 * len(INT32_OUTPUTS) + 2

#: kernel launches by wrapper name — incremented only where the kernel is
#: launched, so a run can show that its main path went through the kernel
LAUNCHES = {"export_pack": 0}

#: calls of :func:`export_pack_reference` by device type, so a run can show
#: that its card path never took the plain version
CALLS = {"cpu": 0, "cuda": 0}

_lib = None


def _library() -> ctypes.CDLL:
    """The kernel's library with its C interface declared (built at first
    use)."""
    global _lib
    if _lib is None:
        from annotatedvdb_tpu_torch.ops.build import load

        lib = load("export_pack")
        lib.export_pack_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_void_p]
        lib.export_pack_launch.restype = ctypes.c_int
        _lib = lib
    return _lib


def export_pack_reference(pos, end, ref_code, alt_code, af_fp, cadd_fp,
                          rank_i, n_valid):
    """Plain-torch pack of one batch (int32 ``[B]`` columns, ``n_valid`` an
    int): ``(mask bool, bin_level int8, leaf_bin, pos, ref_code, alt_code,
    af_fp, cadd_fp, rank_i)``, each ``[B]``, the int32 ones int32, every
    lane at or past ``n_valid`` ``-1`` (mask False)."""
    kind = pos.device.type
    CALLS[kind] = CALLS.get(kind, 0) + 1
    dev = pos.device
    pos = pos.to(torch.int32)
    end = end.to(torch.int32)
    valid = torch.arange(pos.shape[0], dtype=torch.int64, device=dev) \
        < int(n_valid)
    a = torch.div(pos - 1, LEAF_SIZE, rounding_mode="floor")
    b = torch.div(end - 1, LEAF_SIZE, rounding_mode="floor")
    x = a ^ b
    shifts = torch.arange(NUM_BIN_LEVELS, dtype=torch.int32, device=dev)
    mism = ((x[:, None] >> shifts[None, :]) != 0).sum(dim=1)
    level = (NUM_BIN_LEVELS - mism).to(torch.int8)
    neg1 = torch.tensor(-1, dtype=torch.int32, device=dev)

    def m(col):
        return torch.where(valid, col.to(torch.int32), neg1)

    return (
        valid,
        torch.where(valid, level, torch.tensor(-1, dtype=torch.int8,
                                                device=dev)),
        m(a), m(pos), m(ref_code), m(alt_code), m(af_fp), m(cadd_fp),
        m(rank_i),
    )


def export_pack_host(pos, end, ref_code, alt_code, af_fp, cadd_fp, rank_i,
                     n_valid):
    """Numpy copy of the reference's twin ``export_pack_host``: the same
    outputs as :func:`export_pack_reference` as numpy arrays."""
    pos = np.asarray(pos, np.int32)
    end = np.asarray(end, np.int32)
    valid = np.arange(pos.shape[0], dtype=np.int32) < np.int32(n_valid)
    a = (pos - 1) // LEAF_SIZE
    b = (end - 1) // LEAF_SIZE
    x = a ^ b
    shifts = np.arange(NUM_BIN_LEVELS, dtype=np.int32)
    mism = np.sum((x[:, None] >> shifts[None, :]) != 0, axis=1,
                  dtype=np.int32)
    level = (NUM_BIN_LEVELS - mism).astype(np.int8)

    def m(col):
        return np.where(valid, np.asarray(col, np.int32), np.int32(-1))

    return (
        valid,
        np.where(valid, level, np.int8(-1)),
        m(a), m(pos), m(ref_code), m(alt_code), m(af_fp), m(cadd_fp),
        m(rank_i),
    )


def pack_outputs(outs) -> torch.Tensor:
    """The nine outputs of :func:`export_pack_reference` in the kernel's
    ``[30 * B]`` byte layout: the seven int32 columns row after row, then
    the mask bytes, then the level bytes."""
    valid, level, *cols = outs
    return torch.cat([torch.stack(cols).view(torch.uint8).reshape(-1),
                      valid.view(torch.uint8), level.view(torch.uint8)])


def unpack(buf: np.ndarray, b: int) -> tuple:
    """Split a packed ``[30 * b]`` byte buffer into the nine outputs with
    the reference's dtypes (views into ``buf``)."""
    n32 = 4 * len(INT32_OUTPUTS) * b
    cols = buf[:n32].view(np.int32).reshape(len(INT32_OUTPUTS), b)
    return (buf[n32:n32 + b].view(np.bool_), buf[n32 + b:n32 + 2 * b].view(np.int8),
            *cols)


def _check(cols) -> None:
    if cols.dtype != torch.int32:
        raise TypeError(f"export_pack: columns must be int32, not {cols.dtype}")
    if cols.dim() != 2 or cols.shape[0] != len(COLUMNS) or not cols.is_contiguous():
        raise ValueError(
            f"export_pack: columns must be a contiguous [{len(COLUMNS)}, B] "
            f"tensor, not {tuple(cols.shape)}")
    if cols.shape[1] >= 2**31 // PACKED_ROW_BYTES:
        raise ValueError("export_pack: too many rows for int32 offsets")


def export_pack(cols, n_valid: int) -> torch.Tensor:
    """Pack one batch: ``cols`` the ``[7, B]`` int32 columns (rows in
    :data:`COLUMNS` order), ``n_valid`` the real rows.  Returns the
    ``[30 * B]`` uint8 buffer :func:`unpack` splits.

    CPU tensors take :func:`export_pack_reference`; CUDA tensors launch the
    kernel once on the current stream (no synchronisation) or raise."""
    if isinstance(n_valid, torch.Tensor):
        raise TypeError(f"export_pack: n_valid must be an integer, not a "
                        f"tensor on {n_valid.device}")
    if cols.device.type == "cpu":
        _check(cols)
        return pack_outputs(export_pack_reference(*cols, n_valid))
    if cols.device.type != "cuda":
        raise ValueError(f"export_pack: unsupported device {cols.device}")
    _check(cols)
    b = cols.shape[1]
    out = torch.empty((PACKED_ROW_BYTES * b,), dtype=torch.uint8,
                      device=cols.device)
    if b == 0:
        return out
    n = max(0, min(int(n_valid), b))  # arange(B) < n_valid, in range
    rc = _library().export_pack_launch(
        cols.data_ptr(), b, n, out.data_ptr(),
        torch.cuda.current_stream(cols.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"export_pack: kernel launch failed (cudaError {rc})")
    LAUNCHES["export_pack"] += 1
    return out


def pack_columns(cols: np.ndarray, n_valid: int, device) -> tuple:
    """Device entry point: upload the ``[7, B]`` int32 columns to
    ``device`` once, :func:`export_pack` them, copy the packed buffer back
    once and :func:`unpack` it.  Returns the nine numpy outputs."""
    from annotatedvdb_tpu_torch.runtime import to_device

    cols = np.ascontiguousarray(cols, np.int32)
    buf = export_pack(to_device(cols, device), n_valid)
    return unpack(buf.cpu().numpy(), cols.shape[1])
