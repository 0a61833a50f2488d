"""Scalar oracle for allele math: normalization, end location, display
attributes.

Host copy of ``annotatedvdb_tpu/oracle/annotator.py``: the end location of
rows too wide for the device arrays (``host_fallback``), whose bin the
insert load recomputes on the host, and the display attributes of such
rows, which the Postgres egress recomputes on the host.

Behavioral contract (established by the reference, re-implemented from the
documented semantics in SURVEY.md §2.1):

- left-normalization strips the shared leading bases of ref/alt, except for
  1bp/1bp SNVs which are returned untouched
  (``Util/lib/python/variant_annotator.py:82-121``);
- end location follows dbSNP conventions per variant shape
  (``Util/lib/python/variant_annotator.py:36-79``);
- display attributes classify SNV / substitution / inversion / insertion /
  duplication / indel / deletion and compute display positions and alleles
  (``Util/lib/python/variant_annotator.py:134-241``).
"""

from __future__ import annotations

from annotatedvdb_tpu_torch.utils.strings import truncate, xstr

_RC = str.maketrans("ACGTacgt", "TGCAtgca")


def reverse_complement(seq: str) -> str:
    """Reverse complement; non-ACGT letters pass through unchanged
    (same mapping as ``variant_annotator.py:12-16``)."""
    return seq.translate(_RC)[::-1]


def metaseq_id(chrom, pos, ref: str, alt: str) -> str:
    """chr:pos:ref:alt (``variant_annotator.py:124-126``)."""
    return ":".join((xstr(chrom), xstr(pos), ref, alt))


def _leading_match_len(ref: str, alt: str) -> int:
    """Length of the shared leading run, scanning ref positions until the alt
    runs out or mismatches — the loop shape of ``variant_annotator.py:100-107``."""
    n = 0
    for i in range(len(ref)):
        if i < len(alt) and ref[i] == alt[i]:
            n += 1
        else:
            break
    return n


def normalize_alleles(ref: str, alt: str, snv_div_minus: bool = False) -> tuple[str, str]:
    """Left-normalize a ref/alt pair; '-' placeholders for emptied alleles when
    ``snv_div_minus`` (``variant_annotator.py:82-121``)."""
    if len(ref) == 1 and len(alt) == 1:  # SNV: untouched
        return ref, alt
    p = _leading_match_len(ref, alt)
    if p == 0:  # no shared prefix: untouched
        return ref, alt
    norm_ref, norm_alt = ref[p:], alt[p:]
    if snv_div_minus:
        norm_ref = norm_ref or "-"
        norm_alt = norm_alt or "-"
    return norm_ref, norm_alt


def infer_end_location(ref: str, alt: str, pos: int) -> int:
    """dbSNP-convention end location (``variant_annotator.py:36-79``)."""
    pos = int(pos)
    r_len, a_len = len(ref), len(alt)
    norm_ref, norm_alt = normalize_alleles(ref, alt)
    nr, na = len(norm_ref), len(norm_alt)

    if r_len == 1 and a_len == 1:  # SNV
        return pos
    if r_len == a_len:  # MNV
        if ref == alt[::-1]:  # inversion
            return pos + r_len - 1
        return pos + nr - 1  # substitution
    if na >= 1:  # insertion side
        if nr >= 1:  # indel
            return pos + nr
        if r_len > 1:  # pure insertion but anchored left of the event
            return pos + r_len - 1
        return pos + 1
    # deletion side
    if nr == 0:
        return pos + r_len - 1
    return pos + nr


def _is_dup_motif(ref: str, norm_alt: str) -> bool:
    """Duplication test: ref minus its anchor base equals whole copies of the
    inserted motif (``variant_annotator.py:197-201``, .count()-based)."""
    original_ref = ref[1:]
    if not norm_alt:
        return False
    if original_ref == norm_alt:
        return True
    n_dup = original_ref.count(norm_alt)
    return n_dup > 0 and len(original_ref) / n_dup == len(norm_alt)


def display_attributes(ref: str, alt: str, chrom, pos: int) -> dict:
    """Display attributes dict (``variant_annotator.py:134-241``): variant
    class (+abbrev), display/sequence alleles, display start/end, and the
    normalized metaseq id when it differs from the literal one."""
    pos = int(pos)
    r_len, a_len = len(ref), len(alt)
    norm_ref_acc, norm_alt_acc = normalize_alleles(ref, alt)
    nr, na = len(norm_ref_acc), len(norm_alt_acc)
    norm_ref, norm_alt = normalize_alleles(ref, alt, snv_div_minus=True)
    end = infer_end_location(ref, alt, pos)

    attrs = {"location_start": pos, "location_end": pos}

    normalized_id = metaseq_id(chrom, pos, norm_ref, norm_alt)
    if normalized_id != metaseq_id(chrom, pos, ref, alt):
        attrs["normalized_metaseq_id"] = normalized_id

    t8 = lambda v: truncate(v, 8)
    t100 = lambda v: truncate(v, 100)

    if r_len == 1 and a_len == 1:  # SNV
        attrs.update(
            variant_class="single nucleotide variant",
            variant_class_abbrev="SNV",
            display_allele=ref + ">" + alt,
            sequence_allele=ref + "/" + alt,
        )
    elif r_len == a_len:  # MNV
        if ref == alt[::-1]:
            attrs.update(
                variant_class="inversion",
                variant_class_abbrev="MNV",
                display_allele="inv" + ref,
                sequence_allele=t8(ref) + "/" + t8(alt),
                location_end=end,
            )
        else:
            attrs.update(
                variant_class="substitution",
                variant_class_abbrev="MNV",
                display_allele=norm_ref + ">" + norm_alt,
                sequence_allele=t8(norm_ref) + "/" + t8(norm_alt),
                location_start=pos,
                location_end=end,
            )
    elif na >= 1:  # insertion side
        attrs["location_start"] = pos + 1
        ins_prefix = "dup" if _is_dup_motif(ref, norm_alt) else "ins"
        if nr >= 1:  # indel
            attrs.update(
                location_end=end,
                display_allele="del" + t100(norm_ref) + ins_prefix + t100(norm_alt),
                sequence_allele=t8(norm_ref) + "/" + t8(norm_alt),
                variant_class="indel",
                variant_class_abbrev="INDEL",
            )
        elif nr == 0 and end != pos + 1:  # insertion lands downstream: indel
            attrs.update(
                location_end=end,
                display_allele="del" + t100(ref[1:]) + ins_prefix + t100(norm_alt),
                sequence_allele=t8(norm_ref) + "/" + t8(norm_alt),
                variant_class="indel",
                variant_class_abbrev="INDEL",
            )
        else:  # pure insertion / duplication
            attrs.update(
                location_end=pos + 1,
                display_allele=ins_prefix + t100(norm_alt),
                sequence_allele=ins_prefix + t8(norm_alt),
                variant_class="duplication" if ins_prefix == "dup" else "insertion",
                variant_class_abbrev=ins_prefix.upper(),
            )
    else:  # deletion
        attrs.update(
            variant_class="deletion",
            variant_class_abbrev="DEL",
            location_end=end,
            location_start=pos + 1,
            display_allele="del" + t100(norm_ref),
            sequence_allele=t8(norm_ref) + "/-",
        )
    return attrs
