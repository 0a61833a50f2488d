"""Scalar pure-Python golden model of the reference semantics — the host
fallback for rows the device path cannot represent (alleles wider than the
device width).  Host copy of the parts of ``annotatedvdb_tpu/oracle`` the
insert load and the Postgres egress call."""

from .annotator import display_attributes, infer_end_location, normalize_alleles

__all__ = ["display_attributes", "infer_end_location", "normalize_alleles"]
