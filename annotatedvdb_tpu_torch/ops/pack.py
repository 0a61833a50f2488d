"""The packed host<->device transport of the VCF and VEP loads: CUDA kernels
and plain versions.

Port of ``annotatedvdb_tpu/ops/pack.py``.  Three device functions, each a
kernel of ``csrc/pack.cu`` on a CUDA tensor and its plain torch version on
a CPU tensor (no fallback between the two):

- :func:`inflate_alleles`: the allele matrices go up nibble-packed (two
  bases a byte, :func:`encode_alleles_nibble` on the host or the
  tokenizer's in-scan pack) and are inflated back to the exact ``[n, W]``
  byte matrices on the device, both in one launch;
- :func:`pack_outputs`: the insert load's six per-row outputs (hash, dup,
  bin level, leaf bin, needs-digest, host-fallback) in one ``[n, 10]``
  uint8 row, so the host copies one buffer back a chunk;
- :func:`pack_vep_outputs`: the VEP update's hash, prefix length and
  host-fallback flag in one ``[n, 6]`` row (the prefix rides one byte).
  The loaders take these rows from the annotate kernel's identity entry
  (``ops/annotate_cuda.py::annotate_bin_identity``), whose plain version
  composes :func:`pack_vep_outputs_reference`; the transport's probe
  still runs this kernel.

Rows are little-endian on both sides; :func:`unpack_outputs` and
:func:`unpack_vep_outputs` slice the columns back out with numpy views.
The ``*_np`` functions are the reference's numpy twins, byte for byte.

The gates: :func:`transport_wanted` (``AVDB_PACK_TRANSPORT``: ``always``
packs on every device, the CPU through the plain versions; ``never`` on
none; any other value, ``0`` included, means auto: exactly on a CUDA
device), decided per device and not latched, since one process may load
on the card and on the CPU.  :func:`ensure_transport` and
:func:`ensure_nibble` run the reference's 4-row probes once per device;
where the reference latches False on any exception and quietly falls back
to raw uploads and per-field copies, these raise: a probe that fails to
build, launch or agree stops the load.
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np
import torch

#: packed row layout (little-endian): uint32 hash, int32 leaf bin, uint8
#: bin level, uint8 flags (bit0 dup, bit1 needs_digest, bit2 host_fallback)
_H = slice(0, 4)
_LEAF = slice(4, 8)
_LEVEL = 8
_FLAGS = 9
WIDTH = 10

#: update-path row layout: uint32 hash, uint8 prefix_len, uint8
#: host_fallback
VEP_WIDTH = 6

#: kernel launches by wrapper name — incremented only where a kernel is
#: launched, so a run can show that its main path went through the kernels
LAUNCHES = {"inflate_alleles": 0, "pack_outputs": 0, "pack_vep_outputs": 0}

#: calls of the plain versions by device type, so a run can show that its
#: card path never took them
CALLS = {"cpu": 0, "cuda": 0}

# ---- nibble alphabet: code 0 is the zero pad byte ---------------------

_ALPHABET = b"ACGTNacgtn*.-"
_ENC = np.full(256, 255, np.uint8)
_ENC[0] = 0
for _i, _c in enumerate(_ALPHABET, start=1):
    _ENC[_c] = _i
#: code -> byte; codes 14 and 15 decode to 0, as the reference's table does
_DEC = np.zeros(16, np.uint8)
for _i, _c in enumerate(_ALPHABET, start=1):
    _DEC[_i] = _c

_lib = None
_lib_lock = threading.Lock()


def _library() -> ctypes.CDLL:
    """The kernels' library with its C interface declared (built at first
    use)."""
    global _lib
    with _lib_lock:
        if _lib is None:
            from annotatedvdb_tpu_torch.ops.build import load

            lib = load("pack")
            vp, i = ctypes.c_void_p, ctypes.c_int
            lib.inflate_alleles_launch.argtypes = [vp, vp, i, i, i, vp, vp, vp]
            lib.pack_outputs_launch.argtypes = [vp, vp, vp, i, vp, vp, vp, i, vp, vp]
            lib.pack_vep_outputs_launch.argtypes = [vp, vp, i, vp, i, vp, vp]
            for fn in (lib.inflate_alleles_launch, lib.pack_outputs_launch,
                       lib.pack_vep_outputs_launch):
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


# ---- host helpers (the reference's, byte for byte) ---------------------


def encode_alleles_nibble(ref: np.ndarray, alt: np.ndarray):
    """Host 4-bit pack of two ``[n, w]`` allele byte matrices:
    ``(ref_packed, alt_packed)`` of shape ``[n, ceil(w / 2)]``, or None when
    a byte lies outside the alphabet (the caller uploads the raw
    matrices)."""
    w = ref.shape[1]
    codes_r = _ENC[ref]
    codes_a = _ENC[alt]
    if (codes_r == 255).any() or (codes_a == 255).any():
        return None
    if w % 2:
        pad = ((0, 0), (0, 1))
        codes_r = np.pad(codes_r, pad)
        codes_a = np.pad(codes_a, pad)
    rp = codes_r[:, 0::2] | (codes_r[:, 1::2] << 4)
    ap = codes_a[:, 0::2] | (codes_a[:, 1::2] << 4)
    return rp, ap


def inflate_alleles_np(ref_packed, alt_packed, width: int):
    """Numpy twin of :func:`inflate_alleles`."""
    def one(packed):
        packed = np.asarray(packed, np.uint8)
        n, cols = packed.shape
        lo = packed & np.uint8(0xF)
        hi = packed >> np.uint8(4)
        codes = np.stack([lo, hi], axis=2).reshape(n, 2 * cols)
        return _DEC[codes][:, :width]

    return one(ref_packed), one(alt_packed)


def pack_outputs_np(h, dup, bin_level, leaf_bin, needs_digest, host_fallback):
    """Numpy twin of :func:`pack_outputs`: the same ``[n, 10]`` bytes."""
    h = np.ascontiguousarray(np.asarray(h, "<u4"))
    leaf = np.ascontiguousarray(np.asarray(leaf_bin, "<i4"))
    n = h.shape[0]
    flags = (
        np.asarray(dup).astype(np.uint8)
        | (np.asarray(needs_digest).astype(np.uint8) << 1)
        | (np.asarray(host_fallback).astype(np.uint8) << 2)
    ).reshape(n, 1)
    return np.concatenate([
        h.view(np.uint8).reshape(n, 4), leaf.view(np.uint8).reshape(n, 4),
        np.asarray(bin_level).astype(np.uint8).reshape(n, 1), flags,
    ], axis=1)


def pack_vep_outputs_np(h, prefix_len, host_fallback):
    """Numpy twin of :func:`pack_vep_outputs`: the same ``[n, 6]`` bytes."""
    h = np.ascontiguousarray(np.asarray(h, "<u4"))
    n = h.shape[0]
    return np.concatenate([
        h.view(np.uint8).reshape(n, 4),
        np.asarray(prefix_len).astype(np.uint8).reshape(n, 1),
        np.asarray(host_fallback).astype(np.uint8).reshape(n, 1),
    ], axis=1)


def unpack_outputs(packed: np.ndarray) -> dict:
    """``[n, 10]`` uint8 (host) -> the six numpy columns."""
    packed = np.asarray(packed)
    flags = packed[:, _FLAGS]
    return {
        "h": np.ascontiguousarray(packed[:, _H]).view(np.uint32).reshape(-1),
        "leaf_bin": np.ascontiguousarray(packed[:, _LEAF]).view(np.int32).reshape(-1),
        "bin_level": packed[:, _LEVEL].astype(np.int32),
        "dup": (flags & 1).astype(bool),
        "needs_digest": ((flags >> 1) & 1).astype(bool),
        "host_fallback": ((flags >> 2) & 1).astype(bool),
    }


def unpack_vep_outputs(packed: np.ndarray) -> dict:
    """``[n, 6]`` uint8 (host) -> the three numpy columns."""
    packed = np.asarray(packed)
    return {
        "h": np.ascontiguousarray(packed[:, :4]).view(np.uint32).reshape(-1),
        "prefix_len": packed[:, 4].astype(np.int32),
        "host_fallback": packed[:, 5].astype(bool),
    }


# ---- plain versions ------------------------------------------------------


def _count_plain(t: torch.Tensor) -> None:
    kind = t.device.type
    CALLS[kind] = CALLS.get(kind, 0) + 1


#: torch's uint32, where this build has it (a ``torch.from_numpy`` of a
#: uint32 array)
_UINT32 = getattr(torch, "uint32", None)


def _int64(x: torch.Tensor) -> torch.Tensor:
    if _UINT32 is not None and x.dtype == _UINT32:
        return x.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return x.to(torch.int64)


def _le_bytes(x: torch.Tensor, k: int) -> torch.Tensor:
    """``[n]`` integers -> ``[n, k]`` uint8, their low ``k`` bytes in
    little-endian order."""
    x = _int64(x)
    return torch.stack([(x >> (8 * b)) & 0xFF for b in range(k)], dim=1).to(torch.uint8)


def _low_byte(x: torch.Tensor) -> torch.Tensor:
    """``[n]`` integers or bools -> ``[n]`` their truncation to uint8."""
    return (_int64(x) & 0xFF).to(torch.uint8)


def pack_outputs_reference(h, dup, bin_level, leaf_bin, needs_digest,
                           host_fallback) -> torch.Tensor:
    """Plain torch ``[n, 10]`` pack (``dup`` None is zero)."""
    _count_plain(h)
    n = h.shape[0]
    d = (torch.zeros(n, dtype=torch.uint8, device=h.device) if dup is None
         else _low_byte(dup))
    flags = d | (_low_byte(needs_digest) << 1) | (_low_byte(host_fallback) << 2)
    return torch.cat([_le_bytes(h, 4), _le_bytes(leaf_bin, 4),
                      _low_byte(bin_level)[:, None], flags[:, None]], dim=1)


def pack_vep_outputs_reference(h, prefix_len, host_fallback) -> torch.Tensor:
    """Plain torch ``[n, 6]`` pack."""
    _count_plain(h)
    return torch.cat([_le_bytes(h, 4), _low_byte(prefix_len)[:, None],
                      _low_byte(host_fallback)[:, None]], dim=1)


def inflate_alleles_reference(ref_packed, alt_packed, width: int) -> tuple:
    """Plain torch inflate of both packed matrices to ``[n, width]``."""
    _count_plain(ref_packed)
    table = torch.from_numpy(_DEC).to(ref_packed.device)

    def one(packed):
        n, cols = packed.shape
        codes = torch.stack([packed & 0xF, packed >> 4], dim=2).reshape(n, 2 * cols)
        return table[codes.to(torch.int64)][:, :width].contiguous()

    return one(ref_packed), one(alt_packed)


# ---- wrappers ------------------------------------------------------------

#: dtypes read as one byte, and as a little-endian 4-byte word
_BYTE_TYPES = (torch.bool, torch.uint8, torch.int8)
_WORD_TYPES = (torch.int32,) + ((_UINT32,) if _UINT32 is not None else ())


def _device_of(*tensors) -> torch.device:
    dev = tensors[0].device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"pack: unsupported device {dev}")
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"pack: inputs on {dev} and {t.device}")
    return dev


def _column(name: str, t: torch.Tensor, n: int, kinds) -> int:
    """Checks one ``[n]`` column; returns its element size."""
    if t.dtype not in kinds:
        raise TypeError(f"pack: {name} must be one of {kinds}, not {t.dtype}")
    if t.dim() != 1 or t.shape[0] != n or not t.is_contiguous():
        raise ValueError(f"pack: {name} must be a contiguous [{n}] tensor, "
                         f"not {tuple(t.shape)}")
    return t.element_size()


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _check_launch(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed (cudaError {rc})")
    LAUNCHES[name] += 1


def pack_outputs(h, dup, bin_level, leaf_bin, needs_digest,
                 host_fallback) -> torch.Tensor:
    """``[n]`` columns -> ``[n, 10]`` uint8: ``h`` int32 or uint32 (the
    hash's bits), ``leaf_bin`` int32, ``bin_level`` a 1- or 4-byte integer
    (truncated to its low byte), the flags bool or 1-byte integers, ``dup``
    None for zeros.  CPU tensors take :func:`pack_outputs_reference`; CUDA
    tensors launch the kernel once on the current stream (no
    synchronisation) or raise."""
    cols = [t for t in (h, dup, bin_level, leaf_bin, needs_digest,
                        host_fallback) if t is not None]
    dev = _device_of(*cols)
    n = h.shape[0]
    _column("h", h, n, _WORD_TYPES)
    _column("leaf_bin", leaf_bin, n, (torch.int32,))
    level_bytes = _column("bin_level", bin_level, n, _BYTE_TYPES + _WORD_TYPES)
    for name, t in (("dup", dup), ("needs_digest", needs_digest),
                    ("host_fallback", host_fallback)):
        if t is not None:
            _column(name, t, n, _BYTE_TYPES)
    if dev.type == "cpu":
        return pack_outputs_reference(h, dup, bin_level, leaf_bin, needs_digest,
                                      host_fallback)
    out = torch.empty((n, WIDTH), dtype=torch.uint8, device=dev)
    rc = _library().pack_outputs_launch(
        h.data_ptr(), None if dup is None else dup.data_ptr(),
        bin_level.data_ptr(), level_bytes, leaf_bin.data_ptr(),
        needs_digest.data_ptr(), host_fallback.data_ptr(), n, out.data_ptr(),
        _stream(dev))
    _check_launch(rc, "pack_outputs")
    return out


def pack_vep_outputs(h, prefix_len, host_fallback) -> torch.Tensor:
    """``[n]`` columns -> ``[n, 6]`` uint8: ``h`` as in :func:`pack_outputs`,
    ``prefix_len`` a 1- or 4-byte integer (truncated to its low byte),
    ``host_fallback`` bool or a 1-byte integer.  CPU tensors take
    :func:`pack_vep_outputs_reference`; CUDA tensors launch the kernel or
    raise."""
    dev = _device_of(h, prefix_len, host_fallback)
    n = h.shape[0]
    _column("h", h, n, _WORD_TYPES)
    prefix_bytes = _column("prefix_len", prefix_len, n, _BYTE_TYPES + _WORD_TYPES)
    _column("host_fallback", host_fallback, n, _BYTE_TYPES)
    if dev.type == "cpu":
        return pack_vep_outputs_reference(h, prefix_len, host_fallback)
    out = torch.empty((n, VEP_WIDTH), dtype=torch.uint8, device=dev)
    rc = _library().pack_vep_outputs_launch(
        h.data_ptr(), prefix_len.data_ptr(), prefix_bytes,
        host_fallback.data_ptr(), n, out.data_ptr(), _stream(dev))
    _check_launch(rc, "pack_vep_outputs")
    return out


def inflate_alleles(ref_packed, alt_packed, width: int) -> tuple:
    """Inverse of :func:`encode_alleles_nibble`: two contiguous ``[n, cols]``
    uint8 packed matrices (``2 cols >= width``) -> ``(ref, alt)``, each
    ``[n, width]`` uint8.  CPU tensors take :func:`inflate_alleles_reference`;
    CUDA tensors launch the kernel once for both or raise."""
    dev = _device_of(ref_packed, alt_packed)
    for name, t in (("ref_packed", ref_packed), ("alt_packed", alt_packed)):
        if t.dtype != torch.uint8:
            raise TypeError(f"inflate_alleles: {name} must be uint8, not {t.dtype}")
        if t.dim() != 2 or t.shape != ref_packed.shape or not t.is_contiguous():
            raise ValueError(f"inflate_alleles: {name} must be a contiguous "
                             f"[n, cols] tensor shaped like ref_packed, not "
                             f"{tuple(t.shape)}")
    n, cols = ref_packed.shape
    width = int(width)
    if width < 0 or 2 * cols < width:
        raise ValueError(f"inflate_alleles: width {width} needs at least "
                         f"{(width + 1) // 2} packed columns, not {cols}")
    if n * max(cols, width) >= 2**31:
        raise ValueError("inflate_alleles: too many bytes for int32 offsets")
    if dev.type == "cpu":
        return inflate_alleles_reference(ref_packed, alt_packed, width)
    ref = torch.empty((n, width), dtype=torch.uint8, device=dev)
    alt = torch.empty((n, width), dtype=torch.uint8, device=dev)
    rc = _library().inflate_alleles_launch(
        ref_packed.data_ptr(), alt_packed.data_ptr(), n, cols, width,
        ref.data_ptr(), alt.data_ptr(), _stream(dev))
    _check_launch(rc, "inflate_alleles")
    return ref, alt


# ---- gates ---------------------------------------------------------------


def transport_wanted(device) -> bool:
    """Whether a load on ``device`` uploads nibble-packed alleles and fetches
    packed outputs: ``AVDB_PACK_TRANSPORT`` ``always`` (every device, the
    CPU through the plain versions), ``never`` (none), anything else auto
    (a CUDA device).  Read at every call, never latched."""
    mode = os.environ.get("AVDB_PACK_TRANSPORT", "auto")
    if mode == "always":
        return True
    if mode == "never":
        return False
    return torch.device(device).type == "cuda"


_VERIFIED: set = set()
_VERIFY_LOCK = threading.Lock()


def _once(kind: str, device, probe) -> None:
    """Runs ``probe(device)`` once per process and device (it raises when
    it fails, and runs again at the next call)."""
    key = (kind, str(torch.device(device)))
    if key not in _VERIFIED:
        with _VERIFY_LOCK:
            if key not in _VERIFIED:
                probe(torch.device(device))
                _VERIFIED.add(key)


def _nibble_probe(device: torch.device) -> None:
    probe = np.zeros((4, 7), np.uint8)  # odd width exercises the pad
    probe[0, :5] = np.frombuffer(b"ACGTN", np.uint8)
    probe[1, :3] = np.frombuffer(b"acg", np.uint8)
    probe[2, :7] = np.frombuffer(b"*.-TGCA", np.uint8)
    probe[3, :1] = np.frombuffer(b"G", np.uint8)
    enc = encode_alleles_nibble(probe, probe[::-1].copy())
    r, a = inflate_alleles(*(torch.from_numpy(np.ascontiguousarray(x)).to(device)
                             for x in enc), 7)
    if not (np.array_equal(r.cpu().numpy(), probe)
            and np.array_equal(a.cpu().numpy(), probe[::-1])):
        raise RuntimeError(f"nibble transport probe mismatched on {device}")


def _transport_probe(device: torch.device) -> None:
    h = np.array([0x01020304, 0xFFFFFFFF, 0, 0xDEADBEEF], np.uint32)
    leaf = np.array([-1, 2**31 - 1, -(2**31), 1234], np.int32)
    level = np.array([0, 13, 255, 7], np.int32)
    t = np.array([True, False, True, False])

    def dev(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    cols = unpack_outputs(pack_outputs(
        dev(h.view(np.int32)), dev(t), dev(level), dev(leaf), dev(~t), dev(t)
    ).cpu().numpy())
    ok = ((cols["h"] == h).all() and (cols["leaf_bin"] == leaf).all()
          and (cols["bin_level"] == (level & 0xFF)).all()
          and (cols["dup"] == t).all() and (cols["needs_digest"] == ~t).all()
          and (cols["host_fallback"] == t).all())
    vep = unpack_vep_outputs(pack_vep_outputs(
        dev(h.view(np.int32)), dev(level), dev(t)).cpu().numpy())
    ok = ok and ((vep["h"] == h).all() and (vep["prefix_len"] == (level & 0xFF)).all()
                 and (vep["host_fallback"] == t).all())
    if not ok:
        raise RuntimeError(f"packed transport probe mismatched on {device}")


def ensure_nibble(device) -> None:
    """The reference's probe that encode -> upload -> inflate gives back the
    exact matrices on ``device``, run once per device; raises when not."""
    _once("nibble", device, _nibble_probe)


def ensure_transport(device) -> None:
    """The reference's probe that pack -> copy back -> unpack is bit-exact on
    ``device`` (both row formats), run once per device; raises when not."""
    _once("transport", device, _transport_probe)
