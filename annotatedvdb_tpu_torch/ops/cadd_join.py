"""Sorted score-table join: CADD evidence lookup, CUDA kernel and plain
version.

:func:`cadd_join` is the port of
``annotatedvdb_tpu/ops/cadd_join.py::cadd_join_kernel``.  For each variant
it finds the first row of the position-sorted score block at the variant's
position (a left ``searchsorted``), then probes a fixed window of ``probe``
rows from there (clipped to the last row); a row matches when both of the
variant's alleles are in the row's allele set ``{ref, alt}``, by full-width
byte equality, and the first matching row wins.  It returns ``(matched [N]
bool, match_idx [N] int32 into the block, -1 where unmatched)``; the scores
stay on the host and are gathered there by index, so the text-parsed
float64 values never round-trip through the device.

On a CUDA tensor the wrapper launches the hand-written kernel
``csrc/cadd_join.cu`` once (one warp per variant: a 32-ary search by
ballots, the run at the variant's position from one coalesced load, then
warp-wide allele compares with an early exit at the first hit); on a CPU
tensor it computes :func:`cadd_join_reference`.  There is no fallback between the
two: a CUDA input launches or raises.
"""

from __future__ import annotations

import ctypes

import torch

# Probe depths per table: the SNV table carries exactly 3 rows (alternate
# bases) per position; the indel table's per-position runs are short but
# variable.  A run longer than the window would silently miss, so the
# updater refuses a block whose longest same-position run exceeds it.
SNV_PROBE = 4
INDEL_PROBE = 32

#: kernel launches by wrapper name — incremented only where the kernel is
#: launched, so a run can show that its main path went through the kernel
LAUNCHES = {"cadd_join": 0}

#: calls of :func:`cadd_join_reference` by device type, so a run can show
#: that its card path never took the plain version
CALLS = {"cpu": 0, "cuda": 0}

_lib = None


def _library() -> ctypes.CDLL:
    """The kernel's library with its C interface declared (built at first
    use)."""
    global _lib
    if _lib is None:
        from annotatedvdb_tpu_torch.ops.build import load

        lib = load("cadd_join")
        lib.cadd_join_launch.argtypes = (
            [ctypes.c_void_p] * 6
            + [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int]
            + [ctypes.c_void_p] * 3
        )
        lib.cadd_join_launch.restype = ctypes.c_int
        _lib = lib
    return _lib


def cadd_join_reference(vpos, vref, valt, spos, sref, salt,
                        probe: int = SNV_PROBE):
    """Plain-torch join: ``searchsorted``, then ``probe`` clipped gathers
    with full-width byte equality, first match wins.  Alleles are
    zero-padded past their length and never contain NUL, so full-width
    byte equality is string equality."""
    kind = vpos.device.type
    CALLS[kind] = CALLS.get(kind, 0) + 1
    n = vpos.shape[0]
    matched = torch.zeros((n,), dtype=torch.bool, device=vpos.device)
    match_idx = torch.full((n,), -1, dtype=torch.int32, device=vpos.device)
    k_rows = spos.shape[0]
    if n == 0 or k_rows == 0:
        return matched, match_idx
    lo = torch.searchsorted(spos, vpos, side="left")
    for k in range(probe):
        idx = torch.clamp(lo + k, 0, k_rows - 1)
        at_pos = spos[idx] == vpos
        row_ref, row_alt = sref[idx], salt[idx]
        ref_in = (vref == row_ref).all(-1) | (vref == row_alt).all(-1)
        alt_in = (valt == row_ref).all(-1) | (valt == row_alt).all(-1)
        hit = at_pos & ref_in & alt_in
        take = hit & ~matched
        match_idx = torch.where(take, idx.to(torch.int32), match_idx)
        matched = matched | hit
    return matched, match_idx


def _check(vpos, vref, valt, spos, sref, salt, probe) -> None:
    dev = vpos.device
    for name, t, dtype, ndim in (
        ("vpos", vpos, torch.int32, 1), ("vref", vref, torch.uint8, 2),
        ("valt", valt, torch.uint8, 2), ("spos", spos, torch.int32, 1),
        ("sref", sref, torch.uint8, 2), ("salt", salt, torch.uint8, 2),
    ):
        if t.device != dev:
            raise ValueError(f"cadd_join: {name} is on {t.device}, vpos on {dev}")
        if t.dtype != dtype:
            raise TypeError(f"cadd_join: {name} must be {dtype}, not {t.dtype}")
        if t.dim() != ndim or not t.is_contiguous():
            raise ValueError(
                f"cadd_join: {name} must be a contiguous {ndim}-D tensor")
    n, w = vref.shape
    if valt.shape != vref.shape or vpos.shape[0] != n:
        raise ValueError("cadd_join: variant columns disagree in shape")
    k = spos.shape[0]
    if sref.shape != (k, w) or salt.shape != (k, w):
        raise ValueError(
            f"cadd_join: score rows must be [{k}, {w}] like the variants' width")
    if k < 1:
        raise ValueError("cadd_join: the score block is empty")
    if probe < 1:
        raise ValueError(f"cadd_join: probe depth {probe} is below 1")


def cadd_join(vpos, vref, valt, spos, sref, salt, probe: int = SNV_PROBE):
    """Join variants (``vpos`` [N] int32, ``vref``/``valt`` [N, W] uint8)
    against one position-sorted score block (``spos`` [K] int32,
    ``sref``/``salt`` [K, W] uint8), ``probe`` rows deep.

    CPU tensors take :func:`cadd_join_reference`; CUDA tensors launch the
    kernel once on the current stream (no synchronisation) or raise.
    Returns (matched [N] bool, match_idx [N] int32, -1 where unmatched)."""
    if vpos.device.type == "cpu":
        return cadd_join_reference(vpos, vref, valt, spos, sref, salt, probe)
    if vpos.device.type != "cuda":
        raise ValueError(f"cadd_join: unsupported device {vpos.device}")
    _check(vpos, vref, valt, spos, sref, salt, probe)
    n, w = vref.shape
    matched = torch.empty((n,), dtype=torch.bool, device=vpos.device)
    match_idx = torch.empty((n,), dtype=torch.int32, device=vpos.device)
    if n == 0:
        return matched, match_idx
    rc = _library().cadd_join_launch(
        vpos.data_ptr(), vref.data_ptr(), valt.data_ptr(),
        spos.data_ptr(), sref.data_ptr(), salt.data_ptr(),
        n, spos.shape[0], w, probe, matched.data_ptr(), match_idx.data_ptr(),
        torch.cuda.current_stream(vpos.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"cadd_join: kernel launch failed (cudaError {rc})")
    LAUNCHES["cadd_join"] += 1
    return matched, match_idx
