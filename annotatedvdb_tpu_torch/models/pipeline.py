"""The annotate step of the insert load, and its per-device selection.

Port of ``annotatedvdb_tpu/models/pipeline.py``.  One call annotates a
whole batch: normalization, end location, variant class and bin index.
``annotate_pipeline`` is the plain-torch version; ``annotate_pipeline_cuda``
runs the hand-written kernel (``ops/annotate_cuda.py``).  ``annotate_fn``
picks the kernel for a CUDA device and the plain version for the CPU.

Calls are asynchronous on CUDA: the kernel is enqueued on the current
stream and the caller's host work overlaps it until a result is copied
back — the loader does that one chunk behind dispatch.
"""

from __future__ import annotations

import threading

import torch

from annotatedvdb_tpu_torch.ops.annotate import annotate_kernel
from annotatedvdb_tpu_torch.ops.binindex import bin_index_kernel
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


def annotate_pipeline_cuda(chrom, pos, ref, alt, ref_len, alt_len) -> AnnotatedBatch:
    """Same step through the fused CUDA kernel (CUDA tensors only)."""
    from annotatedvdb_tpu_torch.ops.annotate_cuda import annotate_bin

    del chrom
    if ref.device.type != "cuda":
        raise ValueError(f"annotate_pipeline_cuda needs CUDA tensors, got {ref.device}")
    return AnnotatedBatch(**annotate_bin(pos, ref, alt, ref_len, alt_len))


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
    """Warm-up check: the kernel against the plain version on a probe
    batch, on the card.  Raises on a mismatch; an exception from the build
    or the launch propagates unchanged."""
    from annotatedvdb_tpu_torch.io.synth import synthetic_batch

    probe = synthetic_batch(256, width=16)
    args = [torch.from_numpy(x).to(device) for x in probe]
    want = annotate_pipeline(*args)
    got = annotate_pipeline_cuda(*args)
    bad = parity_mismatches(want, got)
    if bad:
        raise RuntimeError(
            f"annotate_bin kernel disagrees with the plain version on the "
            f"probe batch in {bad}"
        )


_VERIFIED: set = set()
_VERIFY_LOCK = threading.Lock()


def annotate_fn(device: torch.device):
    """The annotate step for ``device``: the CUDA kernel (checked once per
    process and device by :func:`verify_cuda_kernel`) on a CUDA device,
    the plain version on the CPU."""
    device = torch.device(device)
    if device.type == "cpu":
        return annotate_pipeline
    if device.type != "cuda":
        raise ValueError(f"no annotate step for device {device}")
    key = str(device)
    if key not in _VERIFIED:
        with _VERIFY_LOCK:
            if key not in _VERIFIED:
                verify_cuda_kernel(device)
                _VERIFIED.add(key)
    return annotate_pipeline_cuda

