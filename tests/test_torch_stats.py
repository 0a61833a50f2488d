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
    from annotatedvdb_tpu_torch.utils.arrays import POS_SENTINEL

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
                        ("kPanelTile", port_ops.PANEL_TILE_ROWS),
                        ("kWindowTile", port_ops.WINDOW_TILE_ROWS),
                        ("kSuperRows", port_ops.SUPER_ROWS),
                        ("kPanelSlots", port_ops.PANEL_SLOTS),
                        ("kWindowSlots", port_ops.WINDOW_SLOTS),
                        ("kHeaderWords", port_ops.SCRATCH_HEADER_WORDS),
                        ("kSentinel", POS_SENTINEL),
                        ("kBins", len(port_ops.AF_EDGES_FP) - 1)):
        assert int(re.search(name + r" = (\d+);", src).group(1)) == value, name
    assert "kCap = (1 << kSumBits) - 1;" in src
    assert port_ops.FP_CAP == (1 << port_ops.SUM_BITS) - 1
    assert port_ops.PANEL_COUNTERS == 94 and port_ops.WINDOW_COUNTERS == 22
    # a table row holds every counter and is a whole number of 16-byte words
    assert port_ops.PANEL_SLOTS >= port_ops.PANEL_COUNTERS
    assert port_ops.WINDOW_SLOTS >= port_ops.WINDOW_COUNTERS
    assert port_ops.PANEL_SLOTS % 4 == 0 == port_ops.WINDOW_SLOTS % 4
    assert port_ops.SCRATCH_HEADER_WORDS % 4 == 0
    # a super-tile is a whole number of tiles, a warp each (panel) or
    # whole tiles a warp (windows, 8 warps a block)
    assert port_ops.SUPER_ROWS // port_ops.PANEL_TILE_ROWS % 8 == 0
    assert port_ops.SUPER_ROWS // port_ops.WINDOW_TILE_ROWS % 8 == 0


@pytest.mark.parametrize("k", [0, 1, 63, 64, 65, 255, 256, 4095, 4096, 4097,
                               4_194_304])
def test_scratch_words_cover_the_kernel_layout(k):
    """The scratch holds the header, a table row for every tile and one
    past the last (the farthest row a combine reads is ceil(k / T)), in
    whole super-tiles, their totals and (windows) the boundary indices."""
    for kind, tile, slots in (
            ("panel", port_ops.PANEL_TILE_ROWS, port_ops.PANEL_SLOTS),
            ("windows", port_ops.WINDOW_TILE_ROWS, port_ops.WINDOW_SLOTS)):
        per = port_ops.SUPER_ROWS // tile
        rows = -(-k // tile) + 1
        supers = -(-rows // per)
        assert supers * per >= rows > (supers - 1) * per
        want = port_ops.SCRATCH_HEADER_WORDS + supers * (per + 1) * slots
        extra = 7 * 17 if kind == "windows" else 0
        assert port_ops.scratch_words(kind, k, 7, 16) == want + extra, kind


def _kernel_edge_cases():
    import sys

    sys.path.insert(0, ROOT)
    from chip_smoke import serve_edge_cases

    return serve_edge_cases()


KERNEL_EDGE_CASES = _kernel_edge_cases()


@pytest.mark.parametrize("case", KERNEL_EDGE_CASES, ids=lambda c: c[0])
def test_plain_versions_match_twins_on_kernel_edge_cases(case):
    """The smoke's kernel edge cases (the inputs the card holds each
    kernel to its plain version on) through the plain versions and the
    reference's numpy twins, with the queries clamped as the twins clamp
    them."""
    _label, pos, af, cadd, rank, starts, ends = case
    starts, ends = port_ops.clamped_queries(starts, ends)
    got = port_ops.stats_panel(*(_t(a) for a in (pos, af, cadd, rank, starts, ends)))
    _assert_all_equal(got, ref_ops.stats_panel_host(
        pos, af, cadd, rank, starts, ends), PANEL)
    for windows in (1, 7, 16, 64):
        got = port_ops.windowed_stats(_t(pos), _t(cadd), _t(starts), _t(ends), windows)
        _assert_all_equal(got, ref_ops.windowed_stats_host(
            pos, cadd, starts, ends, windows), WINDOWS)


def _edge_case(label):
    return next(c for c in KERNEL_EDGE_CASES if c[0] == label)


def _real_rows(pos):
    from annotatedvdb_tpu_torch.utils.arrays import POS_SENTINEL

    return int(np.searchsorted(pos, POS_SENTINEL, side="left"))


def test_kernel_edge_cases_cross_the_table_edges():
    """The edge cases reach what the kernels' design makes special: real
    row counts beside every tile and super-tile edge, unpadded row counts
    that end inside a tile, searches landing exactly on tile edges and on
    the half-tiles where the nearer table row changes side, windows-16
    boundaries all on 64-row edges, spans shorter than the windows,
    queries wholly in the padding, and present features in the padding
    that only a span to the sentinel counts."""
    from annotatedvdb_tpu_torch.utils.arrays import POS_SENTINEL

    t, w, sup = (port_ops.PANEL_TILE_ROWS, port_ops.WINDOW_TILE_ROWS,
                 port_ops.SUPER_ROWS)
    real = {c[0]: _real_rows(c[1]) for c in KERNEL_EDGE_CASES}
    for n in (w - 1, w, w + 1, t - 1, t, t + 1, sup - 1, sup, sup + 1):
        assert real[f"k{n}"] == n
    for label, pos, *_rest in KERNEL_EDGE_CASES:
        if label.startswith("unpadded"):
            assert real[label] == pos.size and pos.size % w != 0
        else:
            assert pos.size & (pos.size - 1) == 0 and pos.size >= real[label]
    assert any(sup - t // 2 < n < sup for n in real.values())
    assert any(2 * sup - t // 2 < n < 2 * sup for n in real.values())

    _l, pos, _af, cadd, _rk, starts, ends = _edge_case("tile-edges")
    x = np.concatenate([np.searchsorted(pos, starts, side="left"),
                        np.searchsorted(pos, ends, side="right")])
    from chip_smoke import TABLE_EDGES

    assert set(j for j in TABLE_EDGES if j < real["tile-edges"]) <= set(x.tolist())
    for tile in (t, w):
        for r in (0, 1, tile // 2 - 1, tile // 2, tile // 2 + 1, tile - 1):
            assert (x % tile == r).any(), (tile, r)
    idx = np.searchsorted(pos, port_ops.window_bounds(
        _t(starts), _t(ends), 16).numpy(), side="left")
    assert ((idx % w) == 0).all(axis=1).sum() >= 5

    _l, pos, _af, cadd, _rk, starts, ends = _edge_case("short-spans")
    spans = ends.astype(np.int64) - starts + 1
    assert spans.min() == 1 and (spans < 64).sum() > 100
    b = port_ops.window_bounds(_t(starts), _t(ends), 64).numpy()
    assert (np.diff(b, axis=1) == 0).any(axis=1).sum() > 100

    _l, pos, _af, _cadd, _rk, starts, ends = _edge_case("in-padding")
    n = real["in-padding"]
    s, e = port_ops.clamped_queries(starts, ends)
    assert (np.searchsorted(pos, s, side="left") >= n - 1).all()
    assert (np.searchsorted(pos, e, side="right") == n).all()
    assert (np.searchsorted(pos, s, side="left") == n).sum() >= 4

    _l, pos, af, cadd, rank, starts, ends = _edge_case("padding-features")
    n = real["padding-features"]
    assert n < pos.size
    for col in (af, cadd, rank):
        assert (col[n:] >= 0).all()
    assert (np.searchsorted(pos, ends, side="right") == pos.size).sum() >= 4
    assert (ends == POS_SENTINEL).sum() >= 4


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
