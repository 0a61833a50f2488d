"""Core data types: chromosome codes, variant-class codes, and the SoA batches.

Design notes
------------
The reference (NIAGADS/AnnotatedVDB) passes one Python dict per variant through
its loaders (``Util/lib/python/loaders/variant_loader.py``).  The port keeps
the JAX package's structure-of-arrays batch (host copy of
``annotatedvdb_tpu/types.py``), so the device step sees whole columns:

- alleles are fixed-width ``uint8`` arrays of raw ASCII bytes (pad = 0).  Raw
  bytes (not 2-bit codes) keep equality semantics *identical* to the
  reference's Python string comparisons (case-sensitive, IUPAC letters allowed)
  while staying vectorizable.  Variants whose alleles exceed the device width
  take a host fallback path — the same long-allele tail the reference routes
  to VRS digests (``Util/lib/python/primary_key_generator.py:53`` uses a 50 bp
  combined-length threshold).
- chromosomes are small integer codes (1..22, X=23, Y=24, M=25), matching the
  reference's ``Human`` enum (``Util/lib/python/enums/chromosomes.py:9-38``).
"""

from __future__ import annotations

import enum
from typing import NamedTuple, Sequence

import numpy as np

# Combined ref+alt length above which the reference switches to a VRS-digest
# primary key (Util/lib/python/primary_key_generator.py:53).
MAX_PK_SEQUENCE_LENGTH = 50

# Device-side allele width (bases).  Alleles longer than this are flagged for
# the host fallback path.  49 covers every literal-PK variant (ref+alt <= 50
# with the other allele at least 1 base), so the device fallback set is
# exactly the reference's VRS-digest tail.
DEFAULT_ALLELE_WIDTH = 49


class VariantClass(enum.IntEnum):
    """Variant-class codes mirroring ``VariantAnnotator.get_display_attributes``
    (reference ``Util/lib/python/variant_annotator.py:134-241``)."""

    SNV = 0          # single nucleotide variant
    MNV = 1          # substitution (equal-length, not an inversion)
    INVERSION = 2    # equal-length, ref == reverse(alt); abbrev "MNV" in display
    INS = 3          # pure insertion
    DUP = 4          # pure insertion whose motif tiles ref[1:]
    INDEL = 5        # mixed insertion/deletion
    DEL = 6          # deletion

    @property
    def display_name(self) -> str:
        return _CLASS_DISPLAY[self][0]

    @property
    def abbrev(self) -> str:
        return _CLASS_DISPLAY[self][1]


_CLASS_DISPLAY = {
    VariantClass.SNV: ("single nucleotide variant", "SNV"),
    VariantClass.MNV: ("substitution", "MNV"),
    VariantClass.INVERSION: ("inversion", "MNV"),
    VariantClass.INS: ("insertion", "INS"),
    VariantClass.DUP: ("duplication", "DUP"),
    VariantClass.INDEL: ("indel", "INDEL"),
    VariantClass.DEL: ("deletion", "DEL"),
}


# --------------------------------------------------------------------------
# chromosomes
# --------------------------------------------------------------------------

_CHROM_TO_CODE = {str(i): i for i in range(1, 23)}
_CHROM_TO_CODE.update({"X": 23, "Y": 24, "M": 25, "MT": 25})
_CODE_TO_CHROM = {i: str(i) for i in range(1, 23)}
_CODE_TO_CHROM.update({23: "X", 24: "Y", 25: "M"})

NUM_CHROMOSOMES = 25


def chromosome_code(chrom) -> int:
    """'chr1' / '1' / 'X' / 'MT' -> integer code (1..25); 0 if unrecognized.

    Mirrors the normalization scattered through the reference: 'chr' prefix is
    stripped (``BinIndex/lib/python/bin_index.py:64``), 'MT' folds to 'M'
    (``Util/lib/python/parsers/vcf_parser.py:136-137``)."""
    s = str(chrom)
    if s.startswith("chr"):
        s = s[3:]
    return _CHROM_TO_CODE.get(s, 0)


def chromosome_label(code: int, prefix: bool = False) -> str:
    """Integer code -> '1'..'22', 'X', 'Y', 'M' (optionally 'chr'-prefixed).

    Raises ValueError for code 0 (the :func:`chromosome_code` sentinel for
    unplaceable contigs) — ingest must filter code-0 rows, the way the
    reference only ever loads the 25 standard ``Human`` chromosomes."""
    label = _CODE_TO_CHROM.get(int(code))
    if label is None:
        raise ValueError(
            f"unmapped chromosome code {code!r}: non-standard contigs must be "
            "filtered at ingest (only chr1-22, X, Y, M are loadable)"
        )
    return "chr" + label if prefix else label


def encode_allele_array(alleles: Sequence[str], width: int) -> tuple[np.ndarray, np.ndarray]:
    """Host-side encode of allele strings into a [N, width] uint8 array + lengths.

    Bytes beyond ``width`` are dropped (such rows must be routed to the host
    fallback — their length column still records the true length so the
    pipeline can flag them)."""
    n = len(alleles)
    lens = np.fromiter(map(len, alleles), np.int32, count=n)
    # one C-level join/encode instead of a per-row frombuffer loop:
    # 'replace' maps every non-ASCII CHARACTER to one '?' byte, so the
    # char-padded rows stay exactly ``width`` bytes each
    joined = "".join(a[:width].ljust(width, "\0") for a in alleles)
    out = (
        np.frombuffer(joined.encode("ascii", errors="replace"), np.uint8)
        .reshape(n, width)
        .copy()
    )
    return out, lens


def decode_allele(row: np.ndarray, length: int) -> str:
    """Inverse of :func:`encode_allele_array` for one row (device-width only)."""
    w = min(int(length), row.shape[0])
    return bytes(row[:w]).decode("ascii")


class VariantBatch(NamedTuple):
    """Structure-of-arrays batch of variants (one row per (variant, alt) pair).

    All arrays share leading dimension N; ``ref``/``alt`` are [N, W] uint8 raw
    ASCII (pad 0).  This is the unit of work fed to the jitted pipeline."""

    chrom: np.ndarray      # [N] int8    1..25, 0 = pad/invalid row
    pos: np.ndarray        # [N] int32   1-based VCF position
    ref: np.ndarray        # [N, W] uint8
    alt: np.ndarray        # [N, W] uint8
    ref_len: np.ndarray    # [N] int32   true length (may exceed W)
    alt_len: np.ndarray    # [N] int32

    @property
    def n(self) -> int:
        return self.chrom.shape[0]

    @property
    def width(self) -> int:
        return self.ref.shape[1]

    @classmethod
    def from_tuples(cls, variants: Sequence[tuple], width: int = DEFAULT_ALLELE_WIDTH) -> "VariantBatch":
        """Build from (chrom, pos, ref, alt) tuples (host-side test/ingest helper)."""
        chroms = np.array([chromosome_code(v[0]) for v in variants], dtype=np.int8)
        pos = np.array([int(v[1]) for v in variants], dtype=np.int32)
        ref, ref_len = encode_allele_array([v[2] for v in variants], width)
        alt, alt_len = encode_allele_array([v[3] for v in variants], width)
        return cls(chroms, pos, ref, alt, ref_len, alt_len)

    def metaseq_id(self, i: int) -> str:
        """chr:pos:ref:alt identity string (reference
        ``Util/lib/python/variant_annotator.py:124-126``). Host/debug use."""
        return ":".join(
            (
                chromosome_label(self.chrom[i]),
                str(int(self.pos[i])),
                decode_allele(np.asarray(self.ref[i]), int(self.ref_len[i])),
                decode_allele(np.asarray(self.alt[i]), int(self.alt_len[i])),
            )
        )


class AnnotatedBatch(NamedTuple):
    """Device outputs of the core annotate step, parallel to a VariantBatch."""

    prefix_len: np.ndarray     # [N] int32  shared left prefix removed by normalization
    norm_ref_len: np.ndarray   # [N] int32
    norm_alt_len: np.ndarray   # [N] int32
    end_location: np.ndarray   # [N] int32  inferred dbSNP-convention end
    location_start: np.ndarray # [N] int32  display start
    location_end: np.ndarray   # [N] int32  display end
    variant_class: np.ndarray  # [N] int8   VariantClass code
    is_dup_motif: np.ndarray   # [N] bool   insertion motif tiles ref[1:] ("dup" display prefix)
    bin_level: np.ndarray      # [N] int8   0..13 (0 = whole-chromosome bin)
    leaf_bin: np.ndarray       # [N] int32  global leaf (level-13) bin of location_start
    needs_digest: np.ndarray   # [N] bool   ref+alt > 50bp -> VRS-digest PK (host path)
    host_fallback: np.ndarray  # [N] bool   allele exceeds device width -> host path
