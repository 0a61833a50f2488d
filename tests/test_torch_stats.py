"""The fused analytics kernels' plain versions and the stats rendering:
the PyTorch port against the JAX package.

``annotatedvdb_tpu_torch.ops.stats.stats_panel`` and ``windowed_stats``
on CPU tensors (their plain torch versions) are held exactly against the
reference's jitted ``stats_panel_kernel_jit``/``windowed_stats_kernel_jit``
and the numpy twins ``stats_panel_host``/``windowed_stats_host``, and the
port's device entry points against the reference's, on seeded columns
with all-missing features, values at ``FP_CAP`` and beyond, ranks of 32
and more, negative query bounds, ``start > end`` and windows 1, 7 and 64.
The host decode (``feature_values``) and the render functions
(``lanes_to_sums``, ``interval_summary``, ``windows_summary``,
``edges_payload``) must give the reference's JSON bytes.  The CUDA kernels
themselves run only on the card (``tests/test_torch_cuda.py``).
"""

import json
import os
import re

import numpy as np
import pytest
import torch

from annotatedvdb_tpu.ops import stats as ref_ops
from annotatedvdb_tpu.store.variant_store import RawJson as RefRawJson

from annotatedvdb_tpu_torch.ops import stats as port_ops
from annotatedvdb_tpu_torch.store.variant_store import RawJson

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.int32)))


def _assert_all_equal(got, want, names):
    assert len(got) == len(want)
    for name, g, w in zip(names, got, want):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        w = np.asarray(w)
        assert g.shape == w.shape, name
        assert g.dtype == np.int32, (name, g.dtype)
        np.testing.assert_array_equal(g, w, err_msg=name)


PANEL = ("lo", "hi", "af_lanes", "af_hist", "cadd_lanes", "cadd_hist",
         "rank_counts")
WINDOWS = ("counts", "present", "lanes")


def _columns(rng, k, missing=(0.3, 0.3, 0.3)):
    """Sorted positions with runs and int32 feature columns: missing
    shares, values at FP_CAP and beyond it, histogram edges exactly, ranks
    at and past the bucket cap."""
    pos = np.sort(rng.integers(1, 100_000, k)).astype(np.int32)
    if k > 4:
        at = rng.choice(k - 1, k // 8, replace=False)
        pos[at + 1] = pos[at]
        pos = np.sort(pos)

    def col(lo, hi, miss, specials):
        v = rng.integers(lo, hi, k)
        if k:
            pick = rng.random(k) < 0.1
            v[pick] = rng.choice(specials, int(pick.sum()))
        v[rng.random(k) < miss] = port_ops.STATS_MISSING
        return v.astype(np.int32)

    af = col(0, port_ops.AF_SCALE + 1, missing[0],
             [0, 10, 100, 1_000_000, port_ops.FP_CAP, port_ops.FP_CAP + 7])
    cadd = col(0, 120_000, missing[1],
               [0, 1_000, 100_000, port_ops.FP_CAP, 2**30])
    rank = col(0, 45, missing[2], [0, 31, 32, 33, 1000])
    return pos, af, cadd, rank


def _queries(rng, q):
    starts = rng.integers(-100, 105_000, q)
    ends = starts + rng.integers(-50, 20_000, q)
    return starts.astype(np.int32), ends.astype(np.int32)


def _panel_cases():
    cases = []
    for seed, (k, q) in enumerate([(1, 1), (50, 17), (600, 64), (3000, 300)]):
        rng = np.random.default_rng(100 + seed)
        cases.append((f"random-{k}", *_columns(rng, k), *_queries(rng, q)))
    rng = np.random.default_rng(3)
    cases.append(("all-missing", *_columns(rng, 400, (1.0, 1.0, 1.0)),
                  *_queries(rng, 40)))
    rng = np.random.default_rng(4)
    cases.append(("none-missing", *_columns(rng, 400, (0.0, 0.0, 0.0)),
                  *_queries(rng, 40)))
    rng = np.random.default_rng(5)
    pos, af, cadd, rank = _columns(rng, 300)
    pts = np.asarray([0, int(pos[0]), int(pos[-1]), int(pos[-1]) + 1,
                      2**31 - 1, -5], np.int32)
    cases.append(("ends", pos, af, cadd, rank, pts, pts[::-1].copy()))
    return cases


@pytest.mark.parametrize("case", _panel_cases(), ids=lambda c: c[0])
def test_panel_plain_version_matches_jitted_kernel_and_twin(case):
    _name, pos, af, cadd, rank, starts, ends = case
    got = port_ops.stats_panel(*(_t(a) for a in (pos, af, cadd, rank, starts,
                                                 ends)))
    _assert_all_equal(got, ref_ops.stats_panel_kernel_jit(
        pos, af, cadd, rank, starts, ends), PANEL)
    _assert_all_equal(got, ref_ops.stats_panel_host(
        pos, af, cadd, rank, starts, ends), PANEL)
    _assert_all_equal(port_ops.stats_panel_host(pos, af, cadd, rank, starts, ends),
                      ref_ops.stats_panel_host(pos, af, cadd, rank, starts, ends),
                      PANEL)


@pytest.mark.parametrize("windows", [1, 7, 64])
@pytest.mark.parametrize("case", _panel_cases()[1:4] + _panel_cases()[-1:],
                         ids=lambda c: c[0])
def test_windows_plain_version_matches_jitted_kernel_and_twin(case, windows):
    _name, pos, _af, cadd, _rank, starts, ends = case
    # the kernels take clamped bounds (every caller clamps): past
    # MAX_QUERY_POS a window boundary overflows int32 in the reference too
    starts, ends = port_ops.clamped_queries(starts, ends)
    got = port_ops.windowed_stats(_t(pos), _t(cadd), _t(starts), _t(ends),
                                  windows)
    _assert_all_equal(got, ref_ops.windowed_stats_kernel_jit(
        pos, cadd, starts, ends, windows=windows), WINDOWS)
    _assert_all_equal(got, ref_ops.windowed_stats_host(
        pos, cadd, starts, ends, windows), WINDOWS)
    _assert_all_equal(port_ops.windowed_stats_host(pos, cadd, starts, ends, windows),
                      ref_ops.windowed_stats_host(pos, cadd, starts, ends, windows),
                      WINDOWS)


@pytest.mark.parametrize("windows", [None, 1, 7, 64])
def test_entry_points_match_reference(windows):
    rng = np.random.default_rng(21)
    pos, af, cadd, rank = _columns(rng, 2500)
    starts = np.concatenate([_queries(rng, 99)[0].astype(np.int64),
                             [2**40, -9, port_ops.FP_CAP]])
    ends = np.concatenate([_queries(rng, 99)[1].astype(np.int64),
                           [2**41, 2**40, -3]])
    if windows is None:
        got = port_ops.stats_panel_batch(pos, af, cadd, rank, starts, ends,
                                         device="cpu")
        want = ref_ops.stats_panel(pos, af, cadd, rank, starts, ends)
        names = PANEL
    else:
        got = port_ops.windowed_stats_batch(pos, cadd, starts, ends, windows,
                                            device="cpu")
        want = ref_ops.windowed_stats(pos, cadd, starts, ends, windows)
        names = WINDOWS
    _assert_all_equal(got, want, names)


def test_padded_entry_points_use_the_resident_columns():
    from annotatedvdb_tpu_torch.utils.arrays import POS_SENTINEL, pad_pow2

    rng = np.random.default_rng(22)
    pos, af, cadd, rank = _columns(rng, 1100)
    starts, ends = _queries(rng, 50)
    cols = [torch.from_numpy(pad_pow2(a, f)) for a, f in (
        (pos, POS_SENTINEL), (af, -1), (cadd, -1), (rank, -1))]
    got = port_ops.stats_panel_batch(*cols, starts, ends, padded=True)
    _assert_all_equal(got, ref_ops.stats_panel_host(
        pos, af, cadd, rank, starts, ends), PANEL)
    got = port_ops.windowed_stats_batch(cols[0], cols[2], starts, ends, 16,
                                        padded=True)
    _assert_all_equal(got, ref_ops.windowed_stats_host(
        pos, cadd, starts, ends, 16), WINDOWS)


def _feature_objects():
    """(cadd_obj, af_obj, ms_obj) triples over every decode branch."""
    cadd = [None, {}, {"CADD_phred": 12.5}, {"CADD_phred": -3.0},
            {"CADD_phred": True}, {"CADD_phred": "7"}, {"CADD_phred": 5000},
            {"CADD_phred": 20, "CADD_raw": 1.5}, {"CADD_phred": 0.0004999}]
    af = [None, {}, {"gnomad": 0.5}, {"GnomAD": {"af": 0.25, "nfe": 0.75}},
          {"a": 1.5, "b": -0.1}, {"a": False, "b": {"x": True, "y": 0.0}},
          {"a": "0.3"}, {"TOPMED": 0.0000004, "GnomAD": 0.0000006},
          {"x": {"y": {"z": 0.9}}}, {"a": 0.1, "b": 0.1}]
    ms = [None, {"rank": 3}, {"rank": 40}, {"rank": -2}, {"rank": 2.9},
          {"rank": False}, {"conseq": "x"}, {"rank": 31.5}]
    out = []
    for i in range(max(len(cadd), len(af), len(ms)) * 3):
        out.append((cadd[i % len(cadd)], af[(i * 7) % len(af)],
                    ms[(i * 5) % len(ms)]))
    return out


def _raw(v, cls):
    return None if v is None else cls(json.dumps(v))


def test_feature_values_match_reference():
    for c, a, m in _feature_objects():
        want = ref_ops.feature_values(c, a, m)
        for wrap in (lambda v: v, lambda v: _raw(v, RawJson)):
            got = port_ops.feature_values(wrap(c), wrap(a), wrap(m))
            assert json.dumps(got) == json.dumps(want), (c, a, m)
        assert json.dumps(ref_ops.feature_values(
            _raw(c, RefRawJson), _raw(a, RefRawJson), _raw(m, RefRawJson))
        ) == json.dumps(want)
    assert port_ops.feature_values(RawJson("not json"), None, None)[3] \
        == ref_ops.STATS_MISSING


def test_rendered_summaries_match_reference_bytes():
    rng = np.random.default_rng(31)
    pos, af, cadd, rank = _columns(rng, 2000)
    starts, ends = _queries(rng, 60)
    panel = ref_ops.stats_panel_host(pos, af, cadd, rank, starts, ends)
    wins = ref_ops.windowed_stats_host(pos, cadd, starts, ends, 16)
    for metrics in (ref_ops.STATS_METRICS, ("af",), ("cadd", "conseq")):
        for k in range(len(starts)):
            lo, hi, af_l, af_h, c_l, c_h, rk = (p[k] for p in panel)
            blocks = [port_ops.windows_summary(wins[0][k], wins[1][k], wins[2][k]),
                      ref_ops.windows_summary(wins[0][k], wins[1][k], wins[2][k])]
            assert json.dumps(blocks[0]) == json.dumps(blocks[1])
            got = port_ops.interval_summary(int(hi - lo), af_l, af_h, c_l, c_h,
                                            rk, metrics, blocks[0])
            want = ref_ops.interval_summary(int(hi - lo), af_l, af_h, c_l, c_h,
                                            rk, metrics, blocks[1])
            assert json.dumps(got, separators=(",", ":")) \
                == json.dumps(want, separators=(",", ":"))
    np.testing.assert_array_equal(port_ops.lanes_to_sums(panel[2]),
                                  ref_ops.lanes_to_sums(panel[2]))
    assert json.dumps(port_ops.edges_payload()) == json.dumps(ref_ops.edges_payload())
    for row in ([0] * 10, [1] * 10, [0, 0, 5, 0, 0, 0, 0, 0, 0, 1]):
        assert port_ops.hist_quantiles(row, port_ops.CADD_EDGES_FP, 1000) \
            == ref_ops.hist_quantiles(row, ref_ops.CADD_EDGES_FP, 1000)
    for got, want in zip(port_ops.column_totals(cadd, port_ops.CADD_EDGES_FP),
                         ref_ops.column_totals(cadd, ref_ops.CADD_EDGES_FP)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(port_ops.rank_totals(rank),
                                  ref_ops.rank_totals(rank))


def test_constants_match_reference():
    for name in ("AF_SCALE", "CADD_SCALE", "SUM_BITS", "FP_CAP",
                 "STATS_MISSING", "RANK_BUCKETS", "MAX_WINDOWS",
                 "STATS_METRICS"):
        assert getattr(port_ops, name) == getattr(ref_ops, name), name
    np.testing.assert_array_equal(port_ops.AF_EDGES_FP, ref_ops.AF_EDGES_FP)
    np.testing.assert_array_equal(port_ops.CADD_EDGES_FP, ref_ops.CADD_EDGES_FP)


def test_kernel_source_constants_match_the_module():
    with open(os.path.join(ROOT, "annotatedvdb_tpu_torch", "csrc",
                           "stats_panel.cu")) as f:
        src = f.read()

    def table(name):
        body = re.search(name + r"\[kBins \+ 1\] = \{([^}]*)\}", src).group(1)
        return [int(x) for x in body.replace("\n", " ").split(",")]

    assert table("kAfEdges") == port_ops.AF_EDGES_FP.tolist()
    assert table("kCaddEdges") == port_ops.CADD_EDGES_FP.tolist()
    for name, value in (("kSumBits", port_ops.SUM_BITS),
                        ("kRanks", port_ops.RANK_BUCKETS),
                        ("kMaxWindows", port_ops.MAX_WINDOWS),
                        ("kTile", port_ops.TILE_ROWS),
                        ("kBins", len(port_ops.AF_EDGES_FP) - 1)):
        assert int(re.search(name + r" = (\d+);", src).group(1)) == value, name
    assert port_ops.PANEL_COUNTERS == 94 and port_ops.WINDOW_COUNTERS == 22


def test_plain_calls_counted_by_device():
    before = dict(port_ops.CALLS)
    launches = dict(port_ops.LAUNCHES)
    one = _t([5])
    port_ops.stats_panel(one, one, one, one, one, one)
    port_ops.windowed_stats(one, one, one, one, 3)
    assert port_ops.CALLS["cpu"] == before["cpu"] + 2
    assert port_ops.CALLS["cuda"] == before["cuda"]
    assert port_ops.LAUNCHES == launches


def test_wrappers_refuse_other_devices_without_fallback():
    before = dict(port_ops.CALLS)
    t = torch.empty((4,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        port_ops.stats_panel(t, t, t, t, t, t)
    with pytest.raises(ValueError, match="unsupported device"):
        port_ops.windowed_stats(t, t, t, t, 4)
    assert port_ops.CALLS == before
