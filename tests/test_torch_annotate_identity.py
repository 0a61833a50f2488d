"""The annotate kernel's identity entry: the port against the JAX package.

``annotatedvdb_tpu_torch/ops/annotate_cuda.py::annotate_bin_identity``
takes the allele matrices and their lengths and returns the ``[n, 6]`` rows
of ``pack_vep_outputs`` (hash, the shared prefix's low byte,
host_fallback); on the CPU it is its plain composition
(``annotate_hash_pipeline`` -> ``pack_vep_outputs_reference``).  Here that
route is held against the JAX package's own, on CPU JAX: the VEP loader's
device route ``pack_vep_outputs_jit(allele_hash_jit(...),
annotate_fn()(...).prefix_len, .host_fallback)`` and its host twins
``pack_vep_outputs_np(allele_hash_np(...), *vep_identity_np(...))``, on
the same seeded numpy inputs (``chip_smoke.annotate_identity_cases``:
shared leading runs across the scan's word steps and up to the width,
over-width, SNV, empty and noisy rows, the edge rows; W = 1, 7, 49, 192
and 255; the first 0, 1, 127, 128, 129 and 257 rows and all of them).
Exact, every byte of every row.  Then the wrapper's argument checks and
the contract's own check (``identity_mismatches``).  Its two callers'
route on the CPU is held in ``test_torch_transport.py`` (the VEP
update's identity batches) and ``test_torch_lookup.py`` (the update legs'
lookup hash).
"""

import numpy as np
import pytest
import torch

from annotatedvdb_tpu.models.pipeline import annotate_fn
from annotatedvdb_tpu.ops import pack as R
from annotatedvdb_tpu.ops.annotate import vep_identity_np
from annotatedvdb_tpu.ops.hashing import allele_hash_jit, allele_hash_np

from annotatedvdb_tpu_torch.models import pipeline
from annotatedvdb_tpu_torch.models.pipeline import identity_mismatches
from annotatedvdb_tpu_torch.ops.annotate_cuda import annotate_bin_identity
from chip_smoke import IDENTITY_ROWS, IDENTITY_WIDTHS, annotate_identity_cases


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("route", ["jit", "np"])
@pytest.mark.parametrize("width", IDENTITY_WIDTHS)
def test_identity_route_matches_reference(width, route):
    ref, alt, rl, al = annotate_identity_cases(width)
    n = ref.shape[0]
    if route == "jit":
        zeros = np.zeros(n, np.int32)
        ann = annotate_fn()(zeros.astype(np.int8), zeros, ref, alt, rl, al)
        want = np.asarray(R.pack_vep_outputs_jit(allele_hash_jit(ref, alt, rl, al),
                                                 ann.prefix_len, ann.host_fallback))
    else:
        want = R.pack_vep_outputs_np(allele_hash_np(ref, alt, rl, al),
                                     *vep_identity_np(ref, alt, rl, al))
    assert want.shape == (n, 6)
    fallback = want[:, 5] == 1
    assert fallback.any() and not fallback.all()
    for rows in IDENTITY_ROWS:
        got = annotate_bin_identity(*(_t(x[:rows]) for x in (ref, alt, rl, al)))
        assert got.dtype == torch.uint8 and got.shape == (want[:rows].shape[0], 6)
        np.testing.assert_array_equal(got.numpy(), want[:rows], err_msg=f"rows={rows}")


def test_identity_wrapper_checks_its_arguments():
    n = 4
    i32 = torch.zeros(n, dtype=torch.int32)
    m = torch.zeros((n, 49), dtype=torch.uint8)
    assert annotate_bin_identity(m, m, i32, i32).shape == (n, 6)
    assert annotate_bin_identity(m[:0], m[:0], i32[:0], i32[:0]).shape == (0, 6)
    # the CPU's plain composition takes any width
    wide = torch.zeros((n, 300), dtype=torch.uint8)
    assert annotate_bin_identity(wide, wide, i32, i32).shape == (n, 6)
    for args, err, match in (
        ((m.to(torch.int8), m, i32, i32), TypeError, "ref must be"),
        ((m, m, i32.to(torch.int64), i32), TypeError, "ref_len must be"),
        ((m[:, ::2], m[:, ::2], i32, i32), ValueError, "contiguous"),
        ((m, m[:, :48], i32, i32), ValueError, "alt"),
        ((m, m, i32[:3], i32), ValueError, "row counts"),
        ((m, m.to("meta"), i32, i32), ValueError, "is on"),
        ((m.to("meta"), m.to("meta"), i32.to("meta"), i32.to("meta")), ValueError,
         "unsupported device"),
    ):
        with pytest.raises(err, match=match):
            annotate_bin_identity(*args)


def test_identity_mismatches_keeps_the_selection_contract():
    """The prefix byte of a host_fallback row may differ, any other byte
    may not."""
    want = annotate_bin_identity(*(_t(x) for x in annotate_identity_cases(49)))
    fb = (want[:, 5] == 1).nonzero().flatten()
    ok = (want[:, 5] == 0).nonzero().flatten()
    assert fb.numel() and ok.numel()
    got = want.clone()
    got[fb, 4] ^= 0x5A
    assert identity_mismatches(want, got) == []
    for row, col, name in ((fb[0], 0, "allele_hash"), (fb[0], 3, "allele_hash"),
                           (ok[0], 5, "host_fallback"), (ok[0], 4, "prefix_len")):
        bad = want.clone()
        bad[row, col] ^= 1
        assert identity_mismatches(want, bad) == [name]


def test_identity_step_is_the_wrapper_on_the_cpu():
    assert pipeline.annotate_identity_fn("cpu") is annotate_bin_identity
    with pytest.raises(ValueError, match="no identity step"):
        pipeline.annotate_identity_fn("meta")
