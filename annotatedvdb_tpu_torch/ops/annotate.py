"""Core annotate step in plain torch: left-normalization, end location,
variant class.

Port of ``annotatedvdb_tpu/ops/annotate.py::annotate_kernel`` — the same
branchless program over ``[N, W]`` uint8 allele tensors, op for op:

- the shared-prefix length is a cumulative-AND scan over the width axis;
- the inversion test is a clipped gather of the reversed alt;
- the duplication-motif test is a clipped modular gather comparing
  ``ref[1:]`` against whole copies of the inserted motif;
- end location / display positions / class codes are ``torch.where``
  cascades in the reference's branch order.

Integer arithmetic stays int32 like jnp, so values that overflow wrap the
same way.  This is the plain version the CUDA kernel
(``ops/annotate_cuda.py``) is held against, and the path CPU tensors take.
"""

from __future__ import annotations

import torch

from annotatedvdb_tpu_torch.types import MAX_PK_SEQUENCE_LENGTH, VariantClass


def annotate_kernel(pos, ref, alt, ref_len, alt_len) -> dict:
    """Annotate one batch.

    Args:
      pos:     [N] int32 1-based positions
      ref/alt: [N, W] uint8 raw ASCII alleles (pad 0)
      ref_len/alt_len: [N] int32 true lengths (may exceed W; such rows are
        flagged ``host_fallback`` and their other outputs are undefined)

    Returns a dict of [N] tensors: prefix_len, norm_ref_len, norm_alt_len,
    end_location, location_start, location_end, variant_class,
    is_dup_motif, needs_digest, host_fallback.
    """
    n, w = ref.shape
    dev = ref.device
    pos = pos.to(torch.int32)
    rlen = ref_len.to(torch.int32)
    alen = alt_len.to(torch.int32)
    col = torch.arange(w, dtype=torch.int32, device=dev)[None, :]

    ref_valid = col < rlen[:, None]
    alt_valid = col < alen[:, None]

    snv = (rlen == 1) & (alen == 1)
    mnv_shape = (rlen == alen) & ~snv

    # ---- left-normalization: shared leading run; alt running out counts
    # as a mismatch
    match = (ref == alt) & ref_valid & alt_valid
    run_open = torch.cumsum((~match).to(torch.int32), dim=1) == 0
    prefix = run_open.sum(dim=1, dtype=torch.int32)
    prefix = torch.where(snv, torch.zeros_like(prefix), prefix)
    nr = rlen - prefix
    na = alen - prefix

    # ---- inversion: ref == reverse(alt) for equal-length alleles
    rev_idx = torch.clamp(alen[:, None] - 1 - col, 0, w - 1).long()
    rev_alt = torch.gather(alt, 1, rev_idx)
    inversion = mnv_shape & ((ref == rev_alt) | ~ref_valid).all(dim=1)

    # ---- end location (variant_annotator.py:36-79)
    one = torch.ones_like(pos)
    end_mnv = torch.where(inversion, pos + rlen - one, pos + nr - one)
    end_ins = torch.where(
        nr >= 1,
        pos + nr,
        torch.where((nr == 0) & (rlen > 1), pos + rlen - one, pos + one),
    )
    end_del = torch.where(nr == 0, pos + rlen - one, pos + nr)
    end = torch.where(
        snv,
        pos,
        torch.where(mnv_shape, end_mnv, torch.where(na >= 1, end_ins, end_del)),
    )

    # ---- duplication motif: (rlen-1) % na == 0 and
    # ref[1+i] == alt[prefix + (i % na)] for all i < rlen-1
    orig_len = rlen - 1
    na_safe = torch.clamp(na, min=1)
    motif_idx = torch.clamp(prefix[:, None] + col % na_safe[:, None], 0, w - 1)
    motif = torch.gather(alt, 1, motif_idx.long())
    shifted_ref = torch.cat(
        [ref[:, 1:], torch.zeros((n, 1), dtype=torch.uint8, device=dev)], dim=1
    )
    tile_cols = col < orig_len[:, None]
    tiles = ((shifted_ref == motif) | ~tile_cols).all(dim=1)
    is_dup = (
        (orig_len > 0)
        & (na > 0)
        & (torch.remainder(orig_len, na_safe) == 0)
        & tiles
    )

    # ---- class codes (variant_annotator.py:134-241 branch structure);
    # the first true condition wins, as in jnp.select
    ins_side = ~snv & ~mnv_shape & (na >= 1)
    pure_ins = ins_side & (nr == 0) & (end == pos + one)
    cls = torch.full((n,), int(VariantClass.DEL), dtype=torch.int8, device=dev)
    for cond, code in reversed((
        (snv, VariantClass.SNV),
        (inversion, VariantClass.INVERSION),
        (mnv_shape, VariantClass.MNV),
        (ins_side & ~pure_ins, VariantClass.INDEL),
        (pure_ins & is_dup, VariantClass.DUP),
        (pure_ins, VariantClass.INS),
    )):
        cls = torch.where(cond, torch.full_like(cls, int(code)), cls)

    loc_start = torch.where(cls >= VariantClass.INS, pos + one, pos)

    return {
        "prefix_len": prefix,
        "norm_ref_len": nr,
        "norm_alt_len": na,
        "end_location": end,
        "location_start": loc_start,
        "location_end": end,
        "variant_class": cls,
        "is_dup_motif": is_dup & ins_side,
        "needs_digest": (rlen + alen) > MAX_PK_SEQUENCE_LENGTH,
        "host_fallback": (rlen > w) | (alen > w),
    }
