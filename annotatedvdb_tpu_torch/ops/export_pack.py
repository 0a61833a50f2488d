"""Fixed-shape corpus batch packing: bin token and mask, CUDA kernel and
plain version.

Port of ``annotatedvdb_tpu/ops/export_pack.py``.  The corpus export
(``export/core.py``, a part's batches at once) and ``GET /export/stream``
(one batch) pack batches of ``B`` rows: seven int32 columns (``pos``,
``end``, ``ref_code``, ``alt_code``, ``af_fp``, ``cadd_fp``, ``rank_i``)
padded to ``B`` and the count ``n_valid`` of real rows.  Per row:

- ``leaf_bin = (pos - 1) // LEAF_SIZE`` and ``bin_level = NUM_BIN_LEVELS``
  minus the number of shifts ``s`` in ``0..12`` at which
  ``(leaf_bin ^ ((end - 1) // LEAF_SIZE)) >> s`` is still nonzero (the
  closed-form bin of ``ops/binindex.py``; int32 arithmetic that wraps and
  floors, as JAX's does);
- the mask ``row < n_valid``, and every output lane at or past
  ``n_valid`` forced to ``-1``.

:func:`export_pack_reference` is the plain PyTorch version, written from
the JAX function, for one batch or a stack of them;
:func:`export_pack_host` the numpy copy of the reference's twin, the path
of ``--hostOnly`` and of an open serving breaker.  :func:`export_pack`
takes one batch's seven columns as a ``[7, B]`` int32 tensor, or a stack
of ``nb`` batches as ``[nb, 7, B]`` (the export packs a whole part at
once), and returns the nine outputs of each batch packed in ``30 * B``
bytes, one batch after another in one buffer (one copy back;
:func:`unpack` splits a batch into the reference's dtypes): on a CUDA
tensor it launches the hand-written ``csrc/export_pack.cu`` once, on a
CPU tensor it packs :func:`export_pack_reference`'s outputs.  There is no
fallback between the two.  :func:`pack_part` is the device entry point:
numpy in, numpy out, one upload, one launch and one copy back for any
number of batches.
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
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p]
        lib.export_pack_launch.restype = ctypes.c_int
        _lib = lib
    return _lib


def export_pack_reference(pos, end, ref_code, alt_code, af_fp, cadd_fp,
                          rank_i, n_valid):
    """Plain-torch pack of one batch (int32 ``[B]`` columns, ``n_valid`` an
    int) or of a stack of batches (``[nb, B]`` columns, ``n_valid`` ``nb``
    ints): ``(mask bool, bin_level int8, leaf_bin, pos, ref_code, alt_code,
    af_fp, cadd_fp, rank_i)``, each the columns' shape, the int32 ones
    int32, every lane at or past its batch's ``n_valid`` ``-1`` (mask
    False)."""
    kind = pos.device.type
    CALLS[kind] = CALLS.get(kind, 0) + 1
    dev = pos.device
    pos = pos.to(torch.int32)
    end = end.to(torch.int32)
    counts = torch.as_tensor(np.asarray(n_valid, np.int64), device=dev)
    valid = torch.arange(pos.shape[-1], dtype=torch.int64, device=dev) \
        < counts[..., None]
    a = torch.div(pos - 1, LEAF_SIZE, rounding_mode="floor")
    b = torch.div(end - 1, LEAF_SIZE, rounding_mode="floor")
    x = a ^ b
    shifts = torch.arange(NUM_BIN_LEVELS, dtype=torch.int32, device=dev)
    mism = ((x[..., None] >> shifts) != 0).sum(dim=-1)
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
    byte layout: per batch ``30 * B`` bytes, the seven int32 columns row
    after row, then the mask bytes, then the level bytes; a stack's batches
    one after another."""
    valid, level, *cols = outs
    words = torch.stack(cols, dim=-2).view(torch.uint8)
    words = words.reshape(*valid.shape[:-1], -1)
    return torch.cat([words, valid.view(torch.uint8), level.view(torch.uint8)],
                     dim=-1).reshape(-1)


def unpack(buf: np.ndarray, b: int) -> tuple:
    """Split one batch's packed ``[30 * b]`` bytes into the nine outputs
    with the reference's dtypes (views into ``buf``)."""
    n32 = 4 * len(INT32_OUTPUTS) * b
    cols = buf[:n32].view(np.int32).reshape(len(INT32_OUTPUTS), b)
    return (buf[n32:n32 + b].view(np.bool_), buf[n32 + b:n32 + 2 * b].view(np.int8),
            *cols)


def clamped_counts(n_valid, nb: int | None, b: int) -> np.ndarray:
    """``n_valid`` as int32 counts clamped into ``[0, b]`` (so ``i <
    count`` is ``arange(B) < n_valid`` for any integer): ``nb`` of them
    from a sequence or array of that length, or one from an integer when
    ``nb`` is None (a single ``[7, B]`` batch)."""
    if isinstance(n_valid, torch.Tensor):
        raise TypeError(f"export_pack: n_valid must be host integers, not a "
                        f"tensor on {n_valid.device}")
    counts = np.asarray(n_valid)
    if counts.dtype.kind not in "iu":
        raise TypeError(f"export_pack: n_valid must be integers, not {counts.dtype}")
    want = () if nb is None else (nb,)
    if counts.shape != want:
        raise ValueError(f"export_pack: n_valid must have shape {want} for "
                         f"these columns, not {counts.shape}")
    return np.clip(counts.astype(np.int64), 0, b).astype(np.int32).reshape(-1)


def _check(cols) -> None:
    if cols.dtype != torch.int32:
        raise TypeError(f"export_pack: columns must be int32, not {cols.dtype}")
    if cols.dim() not in (2, 3) or cols.shape[-2] != len(COLUMNS) \
            or not cols.is_contiguous():
        raise ValueError(
            f"export_pack: columns must be a contiguous [{len(COLUMNS)}, B] or "
            f"[nb, {len(COLUMNS)}, B] tensor, not {tuple(cols.shape)}")
    if cols.numel() // len(COLUMNS) * PACKED_ROW_BYTES >= 2**31:
        raise ValueError("export_pack: too many rows for int32 offsets")


def export_pack(cols, n_valid) -> torch.Tensor:
    """Pack one batch or a stack of batches: ``cols`` the ``[7, B]`` int32
    columns of one batch (rows in :data:`COLUMNS` order) with ``n_valid``
    an integer, or the ``[nb, 7, B]`` columns of ``nb`` batches with
    ``n_valid`` a sequence or host array of ``nb`` integers.  Returns the
    ``[nb * 30 * B]`` uint8 buffer, batch ``k``'s bytes at ``k * 30 * B``
    (:func:`unpack` splits each).

    CPU tensors take :func:`export_pack_reference` (one call); CUDA tensors
    launch the kernel once on the current stream (no synchronisation) or
    raise."""
    if cols.device.type not in ("cpu", "cuda"):
        raise ValueError(f"export_pack: unsupported device {cols.device}")
    _check(cols)
    batched = cols.dim() == 3
    nb, b = (cols.shape[0] if batched else 1), cols.shape[-1]
    counts = clamped_counts(n_valid, nb if batched else None, b)
    if cols.device.type == "cpu":
        return pack_outputs(export_pack_reference(
            *cols.unbind(-2), counts if batched else int(counts[0])))
    out = torch.empty((nb * PACKED_ROW_BYTES * b,), dtype=torch.uint8,
                      device=cols.device)
    if out.numel() == 0:
        return out
    from annotatedvdb_tpu_torch.runtime import to_device

    counts_t = to_device(counts, cols.device)
    rc = _library().export_pack_launch(
        cols.data_ptr(), counts_t.data_ptr(), nb, b, out.data_ptr(),
        torch.cuda.current_stream(cols.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"export_pack: kernel launch failed (cudaError {rc})")
    LAUNCHES["export_pack"] += 1
    return out


def pack_part(chunks, device) -> list:
    """Device entry point for a part: the gathered batches' columns
    (``chunks``, dicts holding the :data:`COLUMNS` padded to one ``B`` and
    ``n_valid``) stacked straight into one ``[nb, 7, B]`` host buffer
    (pinned for the card), uploaded to ``device`` once, :func:`export_pack`
    once, the packed buffer copied back once and split per batch by
    :func:`unpack`.  Returns each batch's nine numpy outputs."""
    nb, b = len(chunks), int(chunks[0][COLUMNS[0]].shape[0])
    host = torch.empty((nb, len(COLUMNS), b), dtype=torch.int32,
                       pin_memory=device.type == "cuda")
    view = host.numpy()
    for k, chunk in enumerate(chunks):
        for j, name in enumerate(COLUMNS):
            view[k, j] = chunk[name]
    cols = host.to(device, non_blocking=True)
    buf = export_pack(cols, [int(c["n_valid"]) for c in chunks]).cpu().numpy()
    size = PACKED_ROW_BYTES * b
    return [unpack(buf[k * size:(k + 1) * size], b) for k in range(nb)]
