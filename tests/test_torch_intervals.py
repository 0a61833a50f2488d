"""BITS spans and bin tokens: the PyTorch port against the JAX package.

``annotatedvdb_tpu_torch.ops.intervals.bits_spans_reference`` (the plain
version the wrapper runs on CPU tensors) is held exactly against the
reference's jitted ``bits_spans_kernel_jit`` and its numpy twin
``interval_spans_host``, and the port's device entry point
``interval_spans`` (clamp, pow2 padding) against the reference's, on
seeded inputs and on the edge cases: an empty position array, a single
query, runs of equal positions, queries before the first row and after
the last, ``start > end``, bounds beyond ``MAX_QUERY_POS`` (negative
included), the leaf-bin boundary (15625 / 15626), one row, and row counts
that are not powers of two holding runs of equal positions longer than the
kernel's final search windows.  The CUDA kernel
itself runs only on the card (``tests/test_torch_cuda.py``).
"""

import os
import re

import numpy as np
import pytest
import torch

from annotatedvdb_tpu.ops import intervals as ref_ops

from annotatedvdb_tpu_torch.ops import intervals as port_ops
from annotatedvdb_tpu_torch.utils.arrays import POS_SENTINEL

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.int32)))


def _assert_spans_equal(got, want):
    names = ("lo", "hi", "level", "leaf")
    for name, g, w in zip(names, got, want):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        w = np.asarray(w)
        assert g.shape == w.shape, name
        np.testing.assert_array_equal(g.astype(np.int64), w.astype(np.int64),
                                      err_msg=name)


def _positions(rng, k, runs=True):
    """Sorted int32 positions with runs of equal values (multi-allelic
    sites and cross-segment copies)."""
    pos = np.sort(rng.integers(1, 200_000, k))
    if runs and k > 3:
        at = rng.choice(k - 1, max(k // 10, 1), replace=False)
        pos[at + 1] = pos[at]
        pos = np.sort(pos)
    return pos.astype(np.int32)


def _queries(rng, q, hi=210_000):
    starts = rng.integers(-50, hi, q)
    ends = starts + rng.integers(-20, 40_000, q)
    return starts.astype(np.int32), ends.astype(np.int32)


def _kernel_cases():
    rng = np.random.default_rng(7)
    cases = []
    for seed, (k, q) in enumerate([(1, 1), (7, 33), (256, 100), (1000, 257),
                                   (4096, 4096)]):
        r = np.random.default_rng(seed)
        pos = _positions(r, k)
        cases.append((f"random-{k}-{q}", pos, *_queries(r, q)))
    pos = _positions(rng, 500)
    lo_q = np.asarray([0, 1, int(pos[0]) - 1, int(pos[0]), int(pos[-1]),
                       int(pos[-1]) + 1, 2**31 - 1], np.int32)
    cases.append(("ends", pos, lo_q, lo_q + 0))
    cases.append(("start-after-end", pos, lo_q[::-1].copy(), lo_q))
    cases.append(("one-query", pos, np.asarray([int(pos[3])], np.int32),
                  np.asarray([int(pos[3])], np.int32)))
    runs = np.asarray([5, 5, 5, 9, 9, 12, 12, 12, 12, 40], np.int32)
    q = np.arange(0, 45, dtype=np.int32)
    cases.append(("runs", runs, q, q))
    cases.append(("runs-wide", runs, q, q + 3))
    # leaf-bin boundary: positions 15625 and 15626 fall in different leaves
    edge = np.asarray([15624, 15625, 15626, 15627, 31250, 31251], np.int32)
    qs = np.asarray([15625, 15626, 15625, 1, 31250, 31251, 15626], np.int32)
    qe = np.asarray([15625, 15626, 15626, 15625, 31251, 62500, 31250], np.int32)
    cases.append(("leaf-edges", edge, qs, qe))
    # sentinel-padded positions, as the engine hands them to the kernel
    padded = np.concatenate([_positions(rng, 100),
                             np.full(28, POS_SENTINEL, np.int32)])
    cases.append(("sentinel-tail", padded, *_queries(rng, 64)))
    cases.append(("negative", pos, np.asarray([-(2**31) + 1, -5, -1], np.int32),
                  np.asarray([-3, 0, 2**31 - 1], np.int32)))
    # K not a power of two, holding runs of equal positions longer than
    # the kernel's final windows (16 and 32 rows) and across the splitters
    # of its 17- and 33-ary rounds, queried at, beside and between them
    r = np.random.default_rng(12)
    long_runs = np.sort(r.integers(1_000, 900_000, 20_011)).astype(np.int32)
    for length, at in ((17, 500), (33, 1_170), (100, 2_350), (1_500, 8_000),
                       (6_000, 12_000)):
        long_runs[at:at + length] = long_runs[at]
    vals = np.unique(long_runs[[500, 1_170, 2_350, 8_000, 12_000]]).astype(np.int64)
    pts = np.concatenate([vals - 1, vals, vals + 1, [0, int(long_runs[-1]) + 1]])
    a, b = np.meshgrid(pts, pts, indexing="ij")
    cases.append(("long-runs", long_runs, a.ravel().astype(np.int32),
                  b.ravel().astype(np.int32)))
    one = np.asarray([777], np.int32)
    near = np.asarray([0, 1, 776, 777, 778, 2**31 - 1], np.int32)
    a, b = np.meshgrid(near, near, indexing="ij")
    cases.append(("k1", one, a.ravel(), b.ravel()))
    odd = np.repeat(np.arange(10, 10 * 40, 10, dtype=np.int32), 7)[:-2]  # 271 rows
    q = np.arange(0, 410, 3, dtype=np.int32)
    cases.append(("k-not-pow2-runs-of-7", odd, q, q + 25))
    return cases


@pytest.mark.parametrize("case", _kernel_cases(), ids=lambda c: c[0])
def test_plain_version_matches_jitted_kernel(case):
    _name, pos, starts, ends = case
    got = port_ops.bits_spans(_t(pos), _t(starts), _t(ends))
    want = ref_ops.bits_spans_kernel_jit(pos, starts, ends)
    _assert_spans_equal(got, want)
    assert got[0].dtype == torch.int32 and got[2].dtype == torch.int8


def test_empty_positions_match_reference():
    pos = np.empty(0, np.int32)
    starts = np.asarray([1, 100, 0], np.int32)
    ends = np.asarray([5, 200, 0], np.int32)
    got = port_ops.bits_spans(_t(pos), _t(starts), _t(ends))
    _assert_spans_equal(got, ref_ops.interval_spans_host(pos, starts, ends))
    _assert_spans_equal(got, ref_ops.bits_spans_kernel_jit(pos, starts, ends))
    _assert_spans_equal(port_ops.interval_spans(pos, starts, ends, device="cpu"),
                        ref_ops.interval_spans(pos, starts, ends))


def _entry_cases():
    rng = np.random.default_rng(11)
    pos = _positions(rng, 3000)
    starts, ends = _queries(rng, 700)
    big = np.asarray([2**40, ref_ops.MAX_QUERY_POS + 1, ref_ops.MAX_QUERY_POS,
                      -7, 2**31 + 5, 15625, 15626], np.int64)
    return [
        ("random", pos, starts, ends),
        ("q1", pos, starts[:1], ends[:1]),
        ("beyond-max", pos, big, big[::-1].copy()),
        ("pow2-rows", pos[:2048], starts[:64], ends[:64]),
        ("start-after-end", pos, ends, starts),
    ]


@pytest.mark.parametrize("case", _entry_cases(), ids=lambda c: c[0])
def test_entry_point_matches_reference_and_twin(case):
    _name, pos, starts, ends = case
    got = port_ops.interval_spans(pos, starts, ends, device="cpu")
    _assert_spans_equal(got, ref_ops.interval_spans(pos, starts, ends))
    _assert_spans_equal(got, ref_ops.interval_spans_host(pos, starts, ends))
    _assert_spans_equal(port_ops.interval_spans_host(pos, starts, ends),
                        ref_ops.interval_spans_host(pos, starts, ends))


def test_padded_entry_point_uses_the_resident_positions():
    from annotatedvdb_tpu_torch.utils.arrays import pad_pow2

    rng = np.random.default_rng(5)
    pos = _positions(rng, 1500)
    starts, ends = _queries(rng, 90)
    resident = torch.from_numpy(pad_pow2(pos, POS_SENTINEL))
    got = port_ops.interval_spans(resident, starts, ends, pos_padded=True)
    _assert_spans_equal(got, ref_ops.interval_spans_host(pos, starts, ends))


def test_host_helpers_match_reference():
    rng = np.random.default_rng(9)
    starts = rng.integers(-(2**33), 2**33, 500)
    ends = rng.integers(-(2**33), 2**33, 500)
    for got, want in zip(port_ops.clamped_queries(starts, ends),
                         ref_ops.clamped_queries(starts, ends)):
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype
    for got, want in zip(port_ops.bin_tokens_host(starts, ends),
                         ref_ops.bin_tokens_host(starts, ends)):
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype
    assert port_ops.MAX_QUERY_POS == ref_ops.MAX_QUERY_POS


def test_plain_calls_counted_by_device():
    before = dict(port_ops.CALLS)
    launches = dict(port_ops.LAUNCHES)
    port_ops.bits_spans(_t([1, 2, 3]), _t([1]), _t([2]))
    assert port_ops.CALLS["cpu"] == before["cpu"] + 1
    assert port_ops.CALLS["cuda"] == before["cuda"]
    assert port_ops.LAUNCHES == launches


def test_wrapper_refuses_other_devices_without_fallback():
    before = dict(port_ops.CALLS)
    t = torch.empty((4,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        port_ops.bits_spans(t, t, t)
    assert port_ops.CALLS == before


def test_kernel_source_constants_match_the_module():
    with open(os.path.join(ROOT, "annotatedvdb_tpu_torch", "csrc",
                           "bits_spans.cu")) as f:
        src = f.read()
    from annotatedvdb_tpu_torch.ops.binindex import LEAF_SIZE, NUM_BIN_LEVELS

    assert int(re.search(r"kLeafSize = (\d+);", src).group(1)) == LEAF_SIZE
    assert int(re.search(r"kLevels = (\d+);", src).group(1)) == NUM_BIN_LEVELS
    assert 'extern "C" int bits_spans_launch(' in src
