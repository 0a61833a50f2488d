"""Scalar oracle for allele math: normalization and end location.

Host copy of the parts of ``annotatedvdb_tpu/oracle/annotator.py`` the
insert load needs: the end location of rows too wide for the device
arrays (``host_fallback``), whose bin is recomputed on the host.

Behavioral contract (established by the reference, re-implemented from the
documented semantics in SURVEY.md §2.1):

- left-normalization strips the shared leading bases of ref/alt, except for
  1bp/1bp SNVs which are returned untouched
  (``Util/lib/python/variant_annotator.py:82-121``);
- end location follows dbSNP conventions per variant shape
  (``Util/lib/python/variant_annotator.py:36-79``).
"""

from __future__ import annotations


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
