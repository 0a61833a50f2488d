"""Scalar pure-Python golden model of the reference semantics — the host
fallback for rows the device path cannot represent (alleles wider than the
device width).  Host copy of the parts of ``annotatedvdb_tpu/oracle`` the
insert load calls."""

from .annotator import infer_end_location, normalize_alleles

__all__ = ["infer_end_location", "normalize_alleles"]
