"""The loaders' device step, and its per-device selection.

Port of ``annotatedvdb_tpu/models/pipeline.py``.  One call annotates a
whole batch — normalization, end location, variant class and bin index —
and hashes its allele identities, which the reference computes in a second
device step.  ``annotate_hash_fn(device)`` returns the step for a device:
on a CUDA device one launch of the fused hand-written kernel
(``ops/annotate_cuda.py``) computes both; on the CPU the plain-torch
``annotate_pipeline`` and ``ops/hashing.py::allele_hash``.  Either way the
hash comes back as the uint32 values' bits in an int32 tensor
(``ops.hashing.to_uint32`` reads it to the host).  Both loaders call it:
the VCF insert load for every field, the VEP update load for the hash,
``prefix_len`` and ``host_fallback``.

Calls are asynchronous on CUDA: the kernel is enqueued on the current
stream and the caller's host work overlaps it until a result is copied
back.
"""

from __future__ import annotations

import threading

import torch

from annotatedvdb_tpu_torch.ops.annotate import annotate_kernel
from annotatedvdb_tpu_torch.ops.binindex import bin_index_kernel
from annotatedvdb_tpu_torch.ops.hashing import allele_hash, hash_bits
from annotatedvdb_tpu_torch.types import AnnotatedBatch


def annotate_pipeline(chrom, pos, ref, alt, ref_len, alt_len) -> AnnotatedBatch:
    """Full annotate step for one batch (plain torch).  The bin lookup
    takes the raw VCF position and the inferred end location, matching the
    reference call site (``vcf_variant_loader.py:310-311``).  ``chrom``
    rides along untouched."""
    del chrom
    ann = annotate_kernel(pos, ref, alt, ref_len, alt_len)
    bin_level, leaf_bin = bin_index_kernel(pos, ann["end_location"])
    return AnnotatedBatch(
        prefix_len=ann["prefix_len"],
        norm_ref_len=ann["norm_ref_len"],
        norm_alt_len=ann["norm_alt_len"],
        end_location=ann["end_location"],
        location_start=ann["location_start"],
        location_end=ann["location_end"],
        variant_class=ann["variant_class"],
        is_dup_motif=ann["is_dup_motif"],
        bin_level=bin_level,
        leaf_bin=leaf_bin,
        needs_digest=ann["needs_digest"],
        host_fallback=ann["host_fallback"],
    )


def annotate_hash_pipeline(chrom, pos, ref, alt, ref_len, alt_len) -> tuple:
    """Plain annotate step and plain allele hash: ``(AnnotatedBatch, [N]
    int32 hash bits)``."""
    return (annotate_pipeline(chrom, pos, ref, alt, ref_len, alt_len),
            hash_bits(allele_hash(ref, alt, ref_len, alt_len)))


def annotate_hash_pipeline_cuda(chrom, pos, ref, alt, ref_len, alt_len) -> tuple:
    """Annotate step and allele hash from one launch of the fused CUDA
    kernel (CUDA tensors only): ``(AnnotatedBatch, [N] int32 hash bits)``."""
    from annotatedvdb_tpu_torch.ops.annotate_cuda import annotate_bin

    del chrom
    if ref.device.type != "cuda":
        raise ValueError(
            f"annotate_hash_pipeline_cuda needs CUDA tensors, got {ref.device}"
        )
    out = annotate_bin(pos, ref, alt, ref_len, alt_len)
    h = out.pop("allele_hash")
    return AnnotatedBatch(**out), h


#: fields whose parity is required on every row; the others only where
#: ``host_fallback`` is False (models/pipeline.py:92-104 of the reference)
EXACT_ON_EVERY_ROW = ("host_fallback", "needs_digest")
EXACT_IN_WIDTH = ("variant_class", "end_location", "prefix_len",
                  "bin_level", "leaf_bin", "is_dup_motif")


def parity_mismatches(want: AnnotatedBatch, got: AnnotatedBatch) -> list:
    """Names of the fields on which ``got`` breaks the selection contract
    against ``want`` (empty = parity)."""
    bad = [name for name in EXACT_ON_EVERY_ROW
           if not torch.equal(getattr(want, name), getattr(got, name))]
    ok = ~want.host_fallback
    for name in EXACT_IN_WIDTH:
        a, b = getattr(want, name), getattr(got, name)
        if not bool(((a == b) | ~ok).all()):
            bad.append(name)
    return bad


def verify_cuda_kernel(device: torch.device) -> None:
    """Warm-up check: the kernel on the card against the plain version on
    the host, on a probe batch of 257 rows at width 49 (two full tiles and
    a ragged one).  The annotate fields must keep the selection contract
    and the hash must agree on every row.  Raises on a mismatch; an
    exception from the build or the launch propagates unchanged."""
    from annotatedvdb_tpu_torch.io.synth import synthetic_batch

    probe = [torch.from_numpy(x) for x in synthetic_batch(257, width=49)]
    want, want_h = annotate_hash_pipeline(*probe)
    got, got_h = annotate_hash_pipeline_cuda(*(x.to(device) for x in probe))
    got = AnnotatedBatch(*(x.cpu() for x in got))
    bad = parity_mismatches(want, got)
    if not torch.equal(got_h.cpu(), want_h):
        bad.append("allele_hash")
    if bad:
        raise RuntimeError(
            f"annotate_bin kernel disagrees with the plain version on the "
            f"probe batch in {bad}"
        )


_VERIFIED: set = set()
_VERIFY_LOCK = threading.Lock()


def _verified(device: torch.device) -> torch.device:
    """``device`` once :func:`verify_cuda_kernel` has passed on it (checked
    once per process and device)."""
    key = str(device)
    if key not in _VERIFIED:
        with _VERIFY_LOCK:
            if key not in _VERIFIED:
                verify_cuda_kernel(device)
                _VERIFIED.add(key)
    return device


def annotate_hash_fn(device: torch.device):
    """The annotate step plus the allele hash for ``device``: the plain
    versions on the CPU; one launch of the fused kernel on a CUDA device,
    once the kernel has passed :func:`verify_cuda_kernel` there.  Each
    returns ``(AnnotatedBatch, [N] int32 hash bits)``."""
    device = torch.device(device)
    if device.type == "cpu":
        return annotate_hash_pipeline
    if device.type != "cuda":
        raise ValueError(f"no annotate step for device {device}")
    _verified(device)
    return annotate_hash_pipeline_cuda
