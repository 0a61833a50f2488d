"""The port's annotate step against the JAX package's.

``annotate_kernel`` (plain torch) and ``annotate_bin_reference`` (the
plain version the CUDA kernel is held against on the card) versus the
reference's ``annotate_kernel_jit``, its numpy twin ``annotate_kernel_np``
and the Pallas kernel ``annotate_bin_pallas`` in interpret mode (as
``tests/test_annotate_pallas.py`` runs it).  Inputs come from numpy with
a seed; the comparison is exact (tolerance 0) under the selection
contract: ``host_fallback`` and ``needs_digest`` on every row, the other
fields where ``host_fallback`` is False.
"""

import numpy as np
import pytest
import torch

from annotatedvdb_tpu.ops.annotate import annotate_kernel_jit, annotate_kernel_np
from annotatedvdb_tpu.ops.annotate_pallas import annotate_bin_pallas
from annotatedvdb_tpu.ops.binindex import bin_index_kernel_jit
from annotatedvdb_tpu.types import VariantBatch

from annotatedvdb_tpu_torch.models.pipeline import annotate_fn, annotate_pipeline
from annotatedvdb_tpu_torch.ops.annotate import annotate_kernel
from annotatedvdb_tpu_torch.ops.annotate_cuda import (
    FIELDS,
    LAUNCHES,
    annotate_bin,
    annotate_bin_reference,
)
from test_annotate import HARD_VARIANTS
from test_annotate_pallas import EDGE_VARIANTS

EVERY_ROW = ("host_fallback", "needs_digest")


def _random_batch(seed: int, n: int, width: int, over_frac: float = 0.05):
    """Seeded [n, width] batch of SNV / MNV / inversion / insertion /
    duplication / deletion / indel rows, ~``over_frac`` of them wider
    than ``width`` (alleles truncated, true lengths kept), plus rows at
    the pad sentinel position."""
    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", np.uint8)
    pos = rng.integers(1, 250_000_000, n).astype(np.int32)
    pos[rng.random(n) < 0.01] = np.iinfo(np.int32).max
    kind = rng.integers(0, 7, n)
    rl = np.ones(n, np.int32)
    al = np.ones(n, np.int32)
    longer = rng.integers(2, max(width, 3), n).astype(np.int32)
    rl = np.where(kind == 1, longer, rl)                 # MNV
    al = np.where(kind == 1, longer, al)
    rl = np.where(kind == 2, longer, rl)                 # inversion
    al = np.where(kind == 2, longer, al)
    al = np.where((kind == 3) | (kind == 4), longer, al)  # ins / dup
    rl = np.where(kind == 5, longer, rl)                 # deletion
    mixed = kind == 6                                    # ragged indel
    rl = np.where(mixed, rng.integers(1, width + 1, n), rl).astype(np.int32)
    al = np.where(mixed, rng.integers(1, width + 1, n), al).astype(np.int32)
    over = rng.random(n) < over_frac
    rl = np.where(over, width + rng.integers(1, 40, n), rl).astype(np.int32)
    ref = bases[rng.integers(0, 4, (n, width))]
    alt = bases[rng.integers(0, 4, (n, width))]
    # anchored ins/del/dup share the first base; dup rows tile a motif;
    # inversions reverse the ref
    anchored = (kind >= 3) & (kind <= 5)
    alt[anchored, 0] = ref[anchored, 0]
    for i in np.where(kind == 4)[0]:
        m = int(rng.integers(1, 4))
        k = int(al[i]) - 1
        motif = ref[i, 1:1 + m]
        if k >= 1 and m <= width - 1:
            rl[i] = min(1 + m * int(rng.integers(1, 3)), width)
            tiled = np.resize(motif, width)
            ref[i, 1:] = tiled[: width - 1]
            alt[i, 1:] = tiled[: width - 1]
    inv = np.where(kind == 2)[0]
    for i in inv:
        L = int(rl[i])
        if L <= width:
            alt[i, :L] = ref[i, :L][::-1]
    col = np.arange(width)[None, :]
    ref = np.where(col < rl[:, None], ref, 0).astype(np.uint8)
    alt = np.where(col < al[:, None], alt, 0).astype(np.uint8)
    return pos, ref, alt, rl, al


def _reference_outputs(pos, ref, alt, rl, al):
    jit = {k: np.asarray(v) for k, v in
           annotate_kernel_jit(pos, ref, alt, rl, al).items()}
    lvl, leaf = bin_index_kernel_jit(pos, jit["end_location"])
    jit["bin_level"], jit["leaf_bin"] = np.asarray(lvl), np.asarray(leaf)
    return jit


def _assert_contract(want: dict, got: dict, fields):
    ok = ~np.asarray(want["host_fallback"])
    for name in fields:
        a, b = np.asarray(want[name]), np.asarray(got[name])
        assert a.dtype == b.dtype or name in ("bin_level",), (name, a.dtype, b.dtype)
        if name in EVERY_ROW:
            np.testing.assert_array_equal(b, a, err_msg=name)
        else:
            np.testing.assert_array_equal(b[ok], a[ok], err_msg=name)


def _torch_args(pos, ref, alt, rl, al):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in (pos, ref, alt, rl, al)]


def _tuples_to_arrays(variants, width):
    b = VariantBatch.from_tuples(variants, width=width)
    return b.pos, b.ref, b.alt, b.ref_len, b.alt_len


CASES = [
    ("edge-w16", lambda: _tuples_to_arrays(EDGE_VARIANTS, 16)),
    ("edge+hard-w16", lambda: _tuples_to_arrays(EDGE_VARIANTS + HARD_VARIANTS, 16)),
    ("edge+hard-w96", lambda: _tuples_to_arrays(EDGE_VARIANTS + HARD_VARIANTS, 96)),
    ("random-w8", lambda: _random_batch(1, 512, 8)),
    ("random-w16", lambda: _random_batch(2, 512, 16)),
    ("random-w49", lambda: _random_batch(3, 512, 49)),
]


@pytest.mark.parametrize("name,make", CASES, ids=[c[0] for c in CASES])
def test_annotate_kernel_matches_jit_and_numpy_twin(name, make):
    args = make()
    want = _reference_outputs(*args)
    twin = annotate_kernel_np(*args)
    got = {k: v.numpy() for k, v in annotate_kernel(*_torch_args(*args)).items()}
    _assert_contract(want, got, twin.keys())
    _assert_contract(twin, got, twin.keys())


@pytest.mark.parametrize("name,make", CASES, ids=[c[0] for c in CASES])
def test_annotate_bin_reference_matches_pallas_interpret(name, make):
    args = make()
    pal = {k: np.asarray(v) for k, v in annotate_bin_pallas(
        *args, block_n=128, interpret=True).items()}
    got = {k: v.numpy() for k, v in annotate_bin_reference(*_torch_args(*args)).items()}
    assert list(got) == [f for f, _ in FIELDS]
    _assert_contract(pal, got, [f for f, _ in FIELDS])
    _assert_contract(_reference_outputs(*args), got, [f for f, _ in FIELDS])


def test_wrapper_takes_plain_version_on_cpu_tensors():
    args = _torch_args(*_random_batch(4, 256, 49))
    before = LAUNCHES["annotate_bin"]
    got = annotate_bin(*args)
    want = annotate_bin_reference(*args)
    assert LAUNCHES["annotate_bin"] == before  # no kernel on the CPU
    for name, dtype in FIELDS:
        assert got[name].dtype == dtype
        assert torch.equal(got[name], want[name]), name


def test_annotate_fn_picks_plain_pipeline_on_cpu():
    assert annotate_fn(torch.device("cpu")) is annotate_pipeline
