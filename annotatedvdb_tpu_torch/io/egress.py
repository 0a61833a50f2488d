"""Egress: materialize device outputs into the reference's exact output shapes.

Copy of the parts of ``annotatedvdb_tpu/io/egress.py`` the insert load,
the VCF export and the Postgres egress call.  String work (metaseq ids, primary keys, ltree paths) happens only
here, after the device step — the reference builds these strings inside
its per-variant hot loop (``vcf_variant_loader.py:318-341``).

Output parity target: record primary key ``chr:pos:ref:alt[:refsnp]`` for
short alleles, ``chr:pos:<VRS digest>[:refsnp]`` beyond 50bp combined
(``primary_key_generator.py:99-122``).
"""

from __future__ import annotations

from functools import reduce

import numpy as np

from annotatedvdb_tpu_torch import oracle
from annotatedvdb_tpu_torch.ops.vrs import VrsDigestGenerator
from annotatedvdb_tpu_torch.types import (
    AnnotatedBatch,
    VariantBatch,
    VariantClass,
    chromosome_label,
)
from annotatedvdb_tpu_torch.utils.strings import truncate

# chromosome code -> label lookup (index 0 unused; loaders filter code 0)
_CHROM_LABELS = np.array(
    ["?"] + [chromosome_label(c) for c in range(1, 26)], dtype="U2"
)


def _concat(*parts) -> np.ndarray:
    """Vectorized string concatenation over mixed scalar/array parts."""
    return reduce(np.char.add, parts)


def decode_alleles(batch: VariantBatch) -> tuple[np.ndarray, np.ndarray]:
    """[N] unicode arrays from the packed device bytes in one view — no
    per-row Python.  Over-width rows decode to their truncated prefix; all
    identity-bearing callers must override them with the original strings
    (``VcfChunk.refs``/``alts``)."""
    w = batch.width

    def dec(a):
        a = np.ascontiguousarray(np.asarray(a, np.uint8))
        return np.char.decode(a.view(f"S{w}")[:, 0], "ascii")

    return dec(batch.ref), dec(batch.alt)


def _as_str_array(values, n: int) -> np.ndarray:
    if isinstance(values, np.ndarray) and values.dtype.kind == "U":
        return values
    return np.array(values if values is not None else [""] * n, dtype="U")


def metaseq_ids(batch: VariantBatch, refs=None, alts=None) -> np.ndarray:
    """chr:pos:ref:alt identity strings, assembled column-wise."""
    if refs is None:
        refs, alts = decode_alleles(batch)
    return _concat(
        _CHROM_LABELS[np.asarray(batch.chrom, np.int64)], ":",
        np.asarray(batch.pos).astype("U10"), ":",
        _as_str_array(refs, batch.n), ":", _as_str_array(alts, batch.n),
    )


def primary_keys_from_ints(
    batch: VariantBatch,
    ann: AnnotatedBatch,
    rs_numbers: np.ndarray,
    digester: VrsDigestGenerator | None = None,
    refs=None,
    alts=None,
    rs_weird: np.ndarray | None = None,
    ref_snp_at=None,
    literal: np.ndarray | None = None,
) -> np.ndarray:
    """Record PKs assembled from the reader's pre-parsed rs-number column —
    no per-row refsnp string materialization.

    ``rs_numbers`` [N] int64 (-1 = none); rows flagged in ``rs_weird``
    (refsnp strings that don't round-trip through the int: unparsable ids,
    zero-padded ids) fall back to ``ref_snp_at(row) -> str`` per row
    (rare).  ``literal`` (a precomputed :func:`metaseq_ids` array) avoids
    rebuilding the id strings when the caller also needs them.  Digest-tail
    and allele-swap semantics of the reference's ``primary_keys``."""
    if refs is None:
        refs, alts = decode_alleles(batch)
    if literal is None:
        literal = metaseq_ids(batch, refs, alts)
    rs_numbers = np.asarray(rs_numbers, np.int64)
    if (rs_numbers >= 0).any():
        suffix = np.where(
            rs_numbers >= 0,
            _concat(":rs", np.char.mod("%d", rs_numbers.clip(min=0))),
            "",
        )
        out = np.char.add(literal, suffix).astype(object)
    else:
        out = literal.astype(object)
    weird_rows = (
        np.where(rs_weird)[0] if rs_weird is not None else np.empty(0, int)
    )
    for j in weird_rows:
        r = ref_snp_at(int(j)) if ref_snp_at is not None else None
        out[j] = literal[j] + (":" + str(r) if r else "")

    def rs_str(i):
        if rs_weird is not None and rs_weird[i]:
            r = ref_snp_at(int(i)) if ref_snp_at is not None else None
            return str(r) if r else None
        return f"rs{int(rs_numbers[i])}" if rs_numbers[i] >= 0 else None

    return _digest_tail(out, batch, ann, refs, alts, digester, rs_str)


def _digest_tail(out, batch, ann, refs, alts, digester, rs_str) -> np.ndarray:
    """Replace >50bp rows' literal PKs with VRS digests (rare tail);
    ``rs_str(i)`` supplies the optional refsnp suffix."""
    for i in np.where(np.asarray(ann.needs_digest))[0]:
        i = int(i)
        if digester is None:
            raise ValueError(
                "batch contains >50bp variants; a VrsDigestGenerator is required"
            )
        chrom = chromosome_label(batch.chrom[i])
        pos = int(batch.pos[i])
        ref, alt = str(refs[i]), str(alts[i])
        try:
            digest = digester.compute_identifier(chrom, pos, ref, alt)
        except ValueError:
            # allele-swap fallback for failed validation, then an
            # unvalidated digest as last resort — a bad row must not
            # abort the load (``vcf_variant_loader.py:234-256``)
            try:
                digest = digester.compute_identifier(chrom, pos, alt, ref)
            except ValueError:
                digest = digester.compute_identifier(
                    chrom, pos, ref, alt, validate=False
                )
        parts = [chrom, str(pos), digest]
        rs = rs_str(i)
        if rs:
            parts.append(rs)
        out[i] = ":".join(parts)
    return out


def bin_paths(batch: VariantBatch, ann: AnnotatedBatch) -> np.ndarray:
    """ltree paths (semantics of ``oracle.binindex.closed_form_path``).

    Position-sorted chunks touch few distinct bins (a 131k-row chunk spans
    ~dozens of 15.6kb leaves), so paths are assembled once per unique
    (chrom, level, leaf) and scattered back — the reference exploits the
    same locality with its current-bin cache (``bin_index.py:20-22``)."""
    level = np.asarray(ann.bin_level).astype(np.int64)
    leaf = np.asarray(ann.leaf_bin).astype(np.int64)
    chrom = np.asarray(batch.chrom, np.int64)
    key = (
        (chrom << np.int64(40)) | (level << np.int64(32))
        | (leaf & np.int64(0xFFFFFFFF))
    )
    uniq, inverse = np.unique(key, return_inverse=True)
    if uniq.size >= level.shape[0] // 4:
        # low locality: the column-wise assembly is cheaper than dedup
        out = np.char.add("chr", _CHROM_LABELS[chrom])
        for l in range(1, 14):
            g = leaf >> (13 - l)
            b = (g + 1) if l == 1 else ((g & 1) + 1)
            seg = np.where(
                level >= l, _concat(f".L{l}.B", b.astype("U11")), ""
            )
            out = np.char.add(out, seg)
        return out
    from annotatedvdb_tpu_torch.oracle.binindex import closed_form_path

    paths = np.array(
        [
            closed_form_path(
                # table lookup, not chromosome_label(): code 0 must emit
                # 'chr?' exactly like the column-wise branch
                "chr" + str(_CHROM_LABELS[int(k >> 40)]),
                int((k >> 32) & 0xFF), int(k & 0xFFFFFFFF),
            )
            for k in uniq.tolist()
        ],
        dtype="U",
    )
    return paths[inverse]


def shard_strings(shard, lo: int = 0, hi: int | None = None):
    """String columns for export over rows ``[lo, hi)`` of the compacted
    shard, assembled vectorized: ``(refs, alts, metaseq_ids,
    primary_keys)`` arrays in shard row order.

    One allele view-decode, one column-wise id assembly and rare-tail
    patches (retained long alleles, digest primary keys) instead of
    per-row ``shard.alleles(i)`` loops.  Callers that stream rows out
    iterate windows of ``EGRESS_WINDOW`` rows rather than materializing ~4
    Python strings per row for a whole shard at once.  Raises like
    :meth:`ChromosomeShard.alleles` when an over-width row has no retained
    original strings."""
    from annotatedvdb_tpu_torch.store.variant_store import (
        _DIGEST_PK,
        _LONG_ALLELES,
    )

    shard.compact()
    seg = shard._single()
    hi = seg.n if hi is None else min(hi, seg.n)
    sl = slice(lo, hi)
    k = max(hi - lo, 0)
    batch = VariantBatch(
        np.full((k,), shard.chrom_code, np.int8), seg.cols["pos"][sl],
        seg.ref[sl], seg.alt[sl], seg.cols["ref_len"][sl],
        seg.cols["alt_len"][sl],
    )
    refs, alts = decode_alleles(batch)
    refs, alts = refs.astype(object), alts.astype(object)
    over = (batch.ref_len > shard.width) | (batch.alt_len > shard.width)
    la = seg.obj[_LONG_ALLELES]
    for i in np.where(over)[0]:
        retained = None if la is None else la[lo + i]
        if retained is None:
            raise ValueError(
                f"row {lo + i}: allele exceeds device width {shard.width} "
                "but the original strings were not retained (store predates "
                "long-allele retention; reload from source)"
            )
        refs[i], alts[i] = retained
    mseq = metaseq_ids(batch, refs, alts)

    rs = seg.cols["ref_snp"][sl]
    suffix = np.where(
        rs >= 0, _concat(":rs", rs.clip(min=0).astype("U20")), ""
    )
    pks = np.char.add(mseq, suffix).astype(object)
    digests = seg.obj[_DIGEST_PK]
    if digests is not None:
        dwin = digests[sl]
        for i in np.where(dwin != None)[0]:  # noqa: E711 (object array)
            pks[i] = dwin[i]
    return refs, alts, mseq, pks


#: export window size: bounds transient per-row Python string residency
#: while keeping the vectorized assembly amortized
EGRESS_WINDOW = 1 << 16


_LONG = 100
_SHORT = 8


def display_attributes(
    batch: VariantBatch, ann: AnnotatedBatch, refs=None, alts=None
) -> list:
    """Per-row display-attribute dicts from device outputs.

    Uses the device class code / normalized lengths / locations; string
    assembly mirrors ``variant_annotator.py:134-241``.  Rows flagged
    host_fallback are recomputed wholesale by the scalar oracle."""
    if refs is None:
        refs, alts = decode_alleles(batch)
    cls = np.asarray(ann.variant_class)
    host = np.asarray(ann.host_fallback)
    prefix_len = np.asarray(ann.prefix_len)
    loc_start = np.asarray(ann.location_start)
    loc_end = np.asarray(ann.location_end)
    is_dup = np.asarray(ann.is_dup_motif)

    out = []
    for i in range(batch.n):
        ref, alt = refs[i], alts[i]
        pos = int(batch.pos[i])
        chrom = chromosome_label(batch.chrom[i])
        if host[i]:
            out.append(oracle.display_attributes(ref, alt, chrom, pos))
            continue
        p = int(prefix_len[i])
        norm_ref, norm_alt = ref[p:], alt[p:]
        d_ref, d_alt = norm_ref or "-", norm_alt or "-"
        c = VariantClass(int(cls[i]))
        attrs = {"location_start": int(loc_start[i]), "location_end": int(loc_end[i])}
        if p > 0 or (norm_ref != ref or norm_alt != alt):
            normalized = f"{chrom}:{pos}:{d_ref}:{d_alt}"
            if normalized != f"{chrom}:{pos}:{ref}:{alt}":
                attrs["normalized_metaseq_id"] = normalized
        ins_prefix = "dup" if is_dup[i] else "ins"
        if c == VariantClass.SNV:
            attrs.update(display_allele=f"{ref}>{alt}", sequence_allele=f"{ref}/{alt}")
        elif c == VariantClass.INVERSION:
            attrs.update(
                display_allele="inv" + ref,
                sequence_allele=f"{truncate(ref, _SHORT)}/{truncate(alt, _SHORT)}",
            )
        elif c == VariantClass.MNV:
            attrs.update(
                display_allele=f"{d_ref}>{d_alt}",
                sequence_allele=f"{truncate(d_ref, _SHORT)}/{truncate(d_alt, _SHORT)}",
            )
        elif c in (VariantClass.INS, VariantClass.DUP):
            attrs.update(
                display_allele=ins_prefix + truncate(norm_alt, _LONG),
                sequence_allele=ins_prefix + truncate(norm_alt, _SHORT),
            )
        elif c == VariantClass.INDEL:
            # deleted part: normalized ref when present, else ref minus anchor
            deleted = norm_ref if norm_ref else ref[1:]
            attrs.update(
                display_allele="del"
                + truncate(deleted, _LONG)
                + ins_prefix
                + truncate(norm_alt, _LONG),
                sequence_allele=f"{truncate(d_ref, _SHORT)}/{truncate(d_alt, _SHORT)}",
            )
        else:  # DEL
            attrs.update(
                display_allele="del" + truncate(norm_ref, _LONG),
                sequence_allele=f"{truncate(norm_ref, _SHORT)}/-",
            )
        attrs["variant_class"] = c.display_name
        attrs["variant_class_abbrev"] = c.abbrev
        out.append(attrs)
    return out
