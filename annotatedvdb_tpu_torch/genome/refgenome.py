"""2-bit packed reference genome and ref-allele validation on the card.

Port of ``annotatedvdb_tpu/genome/refgenome.py``, the framework's SeqRepo
equivalent (the reference reads SeqRepo inside its per-variant loop,
``Util/lib/python/primary_key_generator.py:28-30,74-96``).  The genome is
a 2-bit packed uint8 array (4 bases a byte, ~775 MB for GRCh38) plus a
1-bit ambiguity mask, with

- host ``fetch`` for the rare scalar paths (VRS digest PKs, over-width
  rows),
- :func:`validate_ref`, which checks a batch's ref alleles against the
  genome on the card: the hand-written kernel ``csrc/validate_ref.cu`` on
  CUDA tensors, its plain version :func:`validate_ref_reference` on CPU
  tensors, with no fallback between the two,
- GA4GH sequence digests (``sha512t24u`` of the uppercase sequence,
  SeqRepo's scheme), so VRS ids are canonical when a genome is indexed.

Build once from FASTA with :meth:`ReferenceGenome.from_fasta` (or the
``index-genome`` command) and persist with ``save``/``load``; ``load``
reads compressed (``np.savez_compressed``) and uncompressed
(``np.savez``) files with the keys ``packed``, ``n_mask`` and ``meta``.
"""

from __future__ import annotations

import ctypes
import gzip
import json
import os

import numpy as np
import torch

from annotatedvdb_tpu_torch.types import chromosome_code, chromosome_label

_CODE = {65: 0, 67: 1, 71: 2, 84: 3,     # A C G T
         97: 0, 99: 1, 103: 2, 116: 3}   # a c g t
_BASES = np.frombuffer(b"ACGT", dtype=np.uint8)

# byte -> 2-bit code, and byte -> is-ambiguous, as lookup tables
_CODE_LUT = np.zeros(256, np.uint8)
_AMBIG_LUT = np.ones(256, bool)
for b, c in _CODE.items():
    _CODE_LUT[b] = c
    _AMBIG_LUT[b] = False

#: chromosome-code slots of the device offset and length tables
N_CODES = 26


def _open_text(path: str):
    if path.endswith(".gz"):
        return gzip.open(path, "rt")
    return open(path, "r")


class ReferenceGenome:
    """Packed genome over the 25 standard chromosomes.

    ``packed``: uint8, 4 bases a byte, little-endian within the byte
    (base j's code sits at bit ``2*(j%4)``); every chromosome starts at a
    byte boundary.  ``n_mask``: uint8, 1 bit a base (bit ``j%8``), set for
    any non-ACGT input base."""

    def __init__(self):
        self.packed = np.zeros(0, np.uint8)
        self.n_mask = np.zeros(0, np.uint8)
        # per-code byte offsets into packed / n_mask and base lengths
        self.byte_offset: dict[int, int] = {}
        self.mask_offset: dict[int, int] = {}
        self.length: dict[int, int] = {}
        # chromosomes holding non-ACGTN IUPAC bases: their 2-bit round trip
        # is lossy (every ambiguity code reads back as 'N'), so their
        # digests are never presented as canonical GA4GH ids
        self.lossy: dict[int, bool] = {}
        self._digests: dict[int, str] = {}
        # device tensors by device name (device_arrays)
        self._device_cache: dict[str, tuple] = {}

    # ------------------------------------------------------------- build

    @classmethod
    def from_fasta(cls, path: str, log=lambda *a: None) -> "ReferenceGenome":
        genome = cls()
        packed_parts: list[np.ndarray] = []
        mask_parts: list[np.ndarray] = []
        byte_pos = 0
        mask_pos = 0

        def flush(code: int, seq_parts: list):
            nonlocal byte_pos, mask_pos
            if code == 0 or not seq_parts:
                return
            seq = np.concatenate(seq_parts)
            n = seq.size
            codes = _CODE_LUT[seq]
            ambig = _AMBIG_LUT[seq]
            pad = (-n) % 4
            if pad:
                codes = np.concatenate([codes, np.zeros(pad, np.uint8)])
            # four 2-bit codes a byte, base j at bit 2*(j%4)
            quads = codes.reshape(-1, 4)
            packed = (quads[:, 0] | (quads[:, 1] << 2) | (quads[:, 2] << 4)
                      | (quads[:, 3] << 6)).astype(np.uint8)
            mpad = (-n) % 8
            bits = np.concatenate([ambig, np.zeros(mpad, bool)]) if mpad else ambig
            mask = np.packbits(bits, bitorder="little")
            genome.byte_offset[code] = byte_pos
            genome.mask_offset[code] = mask_pos
            genome.length[code] = n
            is_n = (seq == ord("N")) | (seq == ord("n"))
            genome.lossy[code] = bool(np.any(ambig & ~is_n))
            packed_parts.append(packed)
            mask_parts.append(mask)
            byte_pos += packed.size
            mask_pos += mask.size
            log(f"indexed chr{chromosome_label(code)}: {n} bases")

        current_code = 0
        seq_parts: list = []
        with _open_text(path) as fh:
            for line in fh:
                if line.startswith(">"):
                    flush(current_code, seq_parts)
                    seq_parts = []
                    name = line[1:].split()[0]
                    current_code = chromosome_code(name)
                    if current_code in genome.length:
                        current_code = 0  # duplicate header: keep the first
                elif current_code:
                    seq_parts.append(
                        np.frombuffer(line.strip().encode("ascii"), np.uint8)
                    )
            flush(current_code, seq_parts)
        genome.packed = (
            np.concatenate(packed_parts) if packed_parts else np.zeros(0, np.uint8)
        )
        genome.n_mask = (
            np.concatenate(mask_parts) if mask_parts else np.zeros(0, np.uint8)
        )
        return genome

    # ------------------------------------------------------- persistence

    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        meta = {
            "byte_offset": self.byte_offset,
            "mask_offset": self.mask_offset,
            "length": self.length,
            "lossy": self.lossy,
            "digests": self._digests,
        }
        np.savez_compressed(
            path, packed=self.packed, n_mask=self.n_mask,
            meta=np.frombuffer(json.dumps(meta).encode(), np.uint8),
        )

    @classmethod
    def load(cls, path: str) -> "ReferenceGenome":
        """Read a ``save`` file, or an uncompressed ``np.savez`` file with
        the same keys (``packed``, ``n_mask``, ``meta``)."""
        if not path.endswith(".npz"):
            path += ".npz"
        with np.load(path) as z:
            genome = cls()
            genome.packed = z["packed"]
            genome.n_mask = z["n_mask"]
            meta = json.loads(bytes(z["meta"]).decode())
        genome.byte_offset = {int(k): v for k, v in meta["byte_offset"].items()}
        genome.mask_offset = {int(k): v for k, v in meta["mask_offset"].items()}
        genome.length = {int(k): v for k, v in meta["length"].items()}
        # absent (older index): assume lossy so digests stay non-canonical
        genome.lossy = {
            code: bool(meta.get("lossy", {}).get(str(code), True))
            for code in genome.length
        }
        genome._digests = {int(k): v for k, v in meta.get("digests", {}).items()}
        return genome

    # ------------------------------------------------------------- fetch

    def fetch(self, chrom, start0: int, end0: int) -> str:
        """Bases [start0, end0) of a chromosome (0-based, N restored),
        clipped at both ends — the SeqRepo-proxy interface VRS validation
        uses."""
        code = chrom if isinstance(chrom, int) else chromosome_code(chrom)
        if code not in self.length:
            raise KeyError(f"chromosome {chrom!r} not in genome")
        start0 = max(0, start0)
        end0 = min(end0, self.length[code])
        if end0 <= start0:
            return ""
        idx = np.arange(start0, end0, dtype=np.int64)
        byte = self.packed[self.byte_offset[code] + (idx >> 2)]
        codes = (byte >> ((idx & 3) * 2).astype(np.uint8)) & 3
        out = _BASES[codes]
        mbyte = self.n_mask[self.mask_offset[code] + (idx >> 3)]
        masked = (mbyte >> (idx & 7).astype(np.uint8)) & 1
        out = np.where(masked.astype(bool), np.uint8(ord("N")), out)
        return bytes(out).decode("ascii")

    def reference_bases(self, chrom, start0: int, end0: int) -> str:
        """The callable :class:`~annotatedvdb_tpu_torch.ops.vrs.VrsDigestGenerator`
        takes as ``reference_bases``."""
        return self.fetch(chrom, start0, end0)

    def sequence_digest(self, chrom) -> str:
        """GA4GH-scheme sequence digest (sha512t24u of the uppercase
        sequence), cached; hashed in 16M-base pieces so a GRCh38
        chromosome never materializes GB-scale index temporaries.

        Canonical only for chromosomes whose bases round-trip exactly
        (``not lossy[code]``) — :meth:`lazy_digests` enforces that."""
        import base64
        import hashlib

        code = chrom if isinstance(chrom, int) else chromosome_code(chrom)
        if code not in self._digests:
            h = hashlib.sha512()
            step = 1 << 24
            for start in range(0, self.length[code], step):
                h.update(self.fetch(code, start, start + step).encode("ascii"))
            self._digests[code] = base64.urlsafe_b64encode(
                h.digest()[:24]
            ).decode("ascii")
        return self._digests[code]

    def sequence_digests(self) -> dict:
        """{'1': digest, ...}; eager — digests every chromosome (prefer
        :meth:`lazy_digests`)."""
        return {
            chromosome_label(code): self.sequence_digest(code)
            for code in sorted(self.length)
        }

    def lazy_digests(self) -> "_LazyDigests":
        """Mapping for ``VrsDigestGenerator(sequence_digests=...)`` that
        computes each chromosome's digest on first use (only the digest-PK
        tail ever needs one)."""
        return _LazyDigests(self)

    # ------------------------------------------------------- device path

    def device_arrays(self, device) -> tuple:
        """(packed, n_mask, byte_offsets[26], mask_offsets[26],
        lengths[26]) on ``device`` for :func:`validate_ref`, uploaded once
        and cached per device.  The tables are int32; codes absent from the
        genome get length 0 (their rows always fail)."""
        device = torch.device(device)
        key = str(device)
        cached = self._device_cache.get(key)
        if cached is not None:
            return cached
        byte_off = np.zeros(N_CODES, np.int32)
        mask_off = np.zeros(N_CODES, np.int32)
        lengths = np.zeros(N_CODES, np.int32)
        for code, off in self.byte_offset.items():
            byte_off[code] = off
            mask_off[code] = self.mask_offset[code]
            lengths[code] = self.length[code]
        arrays = tuple(
            torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for a in (self.packed, self.n_mask, byte_off, mask_off, lengths)
        )
        self._device_cache[key] = arrays
        return arrays


class _LazyDigests:
    """dict-like sequence-digest source computed on first access.

    Chromosomes with non-ACGTN bases are reported absent: their 2-bit
    round-trip digest would differ from the true GA4GH digest, and the
    consumer (``VrsDigestGenerator.sequence_id``) then falls back to its
    non-canonical 'SQF.' ids instead of minting wrong 'SQ.' ones."""

    def __init__(self, genome: ReferenceGenome):
        self._genome = genome

    def __contains__(self, chrom) -> bool:
        code = chromosome_code(str(chrom))
        return code in self._genome.length and not self._genome.lossy.get(code, True)

    def __getitem__(self, chrom) -> str:
        if chrom not in self:
            raise KeyError(chrom)
        return self._genome.sequence_digest(chromosome_code(str(chrom)))


# ------------------------------------------------------ validation kernel

#: kernel launches by wrapper name — incremented only where the kernel is
#: launched, so a run can show that its main path went through the kernel
LAUNCHES = {"validate_ref": 0}

#: calls of :func:`validate_ref_reference` by device type, so a run can
#: show that its card path never took the plain version
CALLS = {"cpu": 0, "cuda": 0}

_lib = None


def _library() -> ctypes.CDLL:
    """The kernel's library with its C interface declared (built at first
    use)."""
    global _lib
    if _lib is None:
        from annotatedvdb_tpu_torch.ops.build import load

        lib = load("validate_ref")
        lib.validate_ref_launch.argtypes = (
            [ctypes.c_void_p, ctypes.c_longlong] * 2 + [ctypes.c_void_p] * 7
            + [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 2
        )
        lib.validate_ref_launch.restype = ctypes.c_int
        _lib = lib
    return _lib


def validate_ref_reference(packed, n_mask, byte_off, mask_off, lengths,
                           chrom, pos, ref, ref_len):
    """Plain-torch ref-allele validation: [N] bool, the semantics of the
    reference's ``validate_ref_kernel`` (``refgenome.py:261-296``).

    A row passes when its chromosome is in the genome, ``ref_len <= W``,
    and every stated ref base (bytes 97-122 uppercased) equals the genome
    base — or is 'N' where the genome is ambiguous — inside the
    chromosome.  Columns past ``ref_len`` are ignored whatever they hold,
    so a row with ``ref_len = 0`` passes on any chromosome of the genome;
    ``pos - 1 < 0`` fails a row only through a column inside the allele.
    A code outside [0, 26) counts as absent."""
    kind = ref.device.type
    CALLS[kind] = CALLS.get(kind, 0) + 1
    n, w = ref.shape
    dev = ref.device
    if n == 0:
        return torch.zeros((0,), dtype=torch.bool, device=dev)
    # int64 before indexing: torch takes a uint8 index as a mask and
    # refuses an int8 one
    code = chrom.to(torch.int64)
    known = (code >= 0) & (code < lengths.shape[0])
    code = torch.where(known, code, torch.zeros_like(code))
    length = torch.where(known, lengths[code].to(torch.int64),
                         torch.zeros_like(code))
    start = pos.to(torch.int64) - 1
    rlen = ref_len.to(torch.int64)
    col = torch.arange(w, dtype=torch.int64, device=dev)[None, :]
    local = start[:, None] + col                          # [N, W] 0-based
    in_allele = col < rlen[:, None]
    in_chrom = (start >= 0)[:, None] & (local < length[:, None])
    valid = (length > 0) & (rlen <= w)
    if packed.numel() == 0:  # no chromosome in the genome: nothing passes
        return torch.zeros_like(valid)
    safe = torch.where(in_allele & in_chrom, local, torch.zeros_like(local))
    byte = packed[byte_off.to(torch.int64)[code][:, None] + (safe >> 2)]
    codes = (byte.to(torch.int64) >> ((safe & 3) * 2)) & 3
    genome_base = torch.tensor(list(b"ACGT"), dtype=torch.uint8, device=dev)[codes]
    mbyte = n_mask[mask_off.to(torch.int64)[code][:, None] + (safe >> 3)]
    ambig = ((mbyte.to(torch.int64) >> (safe & 7)) & 1).to(torch.bool)
    ref_upper = torch.where((ref >= 97) & (ref <= 122), ref - 32, ref)
    base_ok = torch.where(ambig, ref_upper == ord("N"), ref_upper == genome_base)
    ok = torch.where(in_allele, base_ok & in_chrom, torch.ones_like(in_allele))
    return ok.all(dim=1) & valid


def _check(packed, n_mask, byte_off, mask_off, lengths, chrom, pos, ref,
           ref_len) -> None:
    dev = ref.device
    for name, t, dtype, ndim in (
        ("packed", packed, torch.uint8, 1), ("n_mask", n_mask, torch.uint8, 1),
        ("byte_off", byte_off, torch.int32, 1),
        ("mask_off", mask_off, torch.int32, 1),
        ("lengths", lengths, torch.int32, 1), ("chrom", chrom, torch.int8, 1),
        ("pos", pos, torch.int32, 1), ("ref", ref, torch.uint8, 2),
        ("ref_len", ref_len, torch.int32, 1),
    ):
        if t.device != dev:
            raise ValueError(f"validate_ref: {name} is on {t.device}, ref on {dev}")
        if t.dtype != dtype:
            raise TypeError(f"validate_ref: {name} must be {dtype}, not {t.dtype}")
        if t.dim() != ndim or not t.is_contiguous():
            raise ValueError(
                f"validate_ref: {name} must be a contiguous {ndim}-D tensor")
    n, w = ref.shape
    if chrom.shape[0] != n or pos.shape[0] != n or ref_len.shape[0] != n:
        raise ValueError("validate_ref: row columns disagree in length")
    for name, t in (("byte_off", byte_off), ("mask_off", mask_off),
                    ("lengths", lengths)):
        if t.shape[0] != N_CODES:
            raise ValueError(f"validate_ref: {name} must have {N_CODES} entries")
    if w < 1:
        raise ValueError("validate_ref: the allele width is below 1")
    if packed.numel() >= 2**31 or n_mask.numel() >= 2**31:
        raise ValueError("validate_ref: the genome exceeds 2^31 bytes")


def validate_ref(packed, n_mask, byte_off, mask_off, lengths, chrom, pos,
                 ref, ref_len):
    """Validate ``ref`` [N, W] uint8 (``ref_len`` [N] int32, ``pos`` [N]
    int32, ``chrom`` [N] int8) against the genome tensors of
    :meth:`ReferenceGenome.device_arrays`: [N] bool.

    CPU tensors take :func:`validate_ref_reference`; CUDA tensors launch
    ``csrc/validate_ref.cu`` once on the current stream (no
    synchronisation) or raise."""
    if ref.device.type == "cpu":
        return validate_ref_reference(packed, n_mask, byte_off, mask_off,
                                      lengths, chrom, pos, ref, ref_len)
    if ref.device.type != "cuda":
        raise ValueError(f"validate_ref: unsupported device {ref.device}")
    _check(packed, n_mask, byte_off, mask_off, lengths, chrom, pos, ref, ref_len)
    n, w = ref.shape
    ok = torch.empty((n,), dtype=torch.bool, device=ref.device)
    if n == 0:
        return ok
    rc = _library().validate_ref_launch(
        packed.data_ptr(), packed.numel(), n_mask.data_ptr(), n_mask.numel(),
        byte_off.data_ptr(), mask_off.data_ptr(), lengths.data_ptr(),
        chrom.data_ptr(), pos.data_ptr(), ref.data_ptr(), ref_len.data_ptr(), n, w,
        ok.data_ptr(), torch.cuda.current_stream(ref.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"validate_ref: kernel launch failed (cudaError {rc})")
    LAUNCHES["validate_ref"] += 1
    return ok


def validate_ref_batch(genome: ReferenceGenome, batch, refs: list | None = None,
                       device=None) -> np.ndarray:
    """Host wrapper: validate a :class:`VariantBatch`'s ref alleles on
    ``device`` (``cuda:0`` by default; ``"cpu"`` runs the plain version);
    [N] bool numpy.

    Rows whose ref exceeds the batch width re-validate on the host from
    ``refs`` (their device arrays are truncated): only rows whose code is
    in the genome, by ``fetch(...) == ref.upper()``, which clips at both
    ends."""
    from annotatedvdb_tpu_torch.runtime import resolve_device, to_device

    device = resolve_device(device)
    arrays = genome.device_arrays(device)
    cols = [to_device(np.asarray(x, dtype), device) for x, dtype in (
        (batch.chrom, np.int8), (batch.pos, np.int32), (batch.ref, np.uint8),
        (batch.ref_len, np.int32))]
    ok = validate_ref(*arrays, *cols).cpu().numpy().copy()
    if refs is not None:
        over = np.asarray(batch.ref_len) > batch.width
        for i in np.where(over)[0]:
            code = int(batch.chrom[i])
            if code not in genome.length:
                continue
            start0 = int(batch.pos[i]) - 1
            ref = refs[i].upper()
            ok[i] = genome.fetch(code, start0, start0 + len(ref)) == ref
    return ok
