"""Fused analytics over interval spans: the stats panel and the windowed
scan, CUDA kernels and plain versions, plus the host decode and render.

Port of ``annotatedvdb_tpu/ops/stats.py``.  Feature values are decoded once
per (store generation, chromosome) into int32 fixed point
(``AF_SCALE``/``CADD_SCALE``, missing = ``STATS_MISSING``), and every
reduction is integer: per query interval ``[lo, hi)`` of the BITS span,
histogram and rank-bucket counts and bit-sliced sums (the ``SUM_BITS`` bits
of each value counted as separate int32 lanes, recombined on the host by
:func:`lanes_to_sums`).  Integer addition is associative, so any order of
summation gives the reference's int32 outputs exactly.

- :func:`stats_panel` replaces ``stats_panel_kernel``: spans, AF spectrum
  lanes and histogram, CADD lanes and histogram, consequence-rank counts.
- :func:`windowed_stats` replaces ``windowed_stats_kernel``: each interval
  split into ``windows`` equal bins by integer boundary arithmetic, with
  per-window row counts, CADD present counts and CADD lanes.

On CUDA tensors each launches ``csrc/stats_panel.cu`` (one C entry point
each); on CPU tensors each computes its ``*_reference``, the reference's
prefix-sum-then-gather formulation in plain torch (``[K, 94]`` int32
cumulants — the kernels never build those).  There is no fallback between
the two.  :func:`stats_panel_batch` and :func:`windowed_stats_batch` are
the device entry points (clamp, pow2 padding with sentinel rows and
``STATS_MISSING`` features, numpy out); ``stats_panel_host`` and
``windowed_stats_host`` are the numpy twins the circuit breaker takes.
"""

from __future__ import annotations

import ctypes
import json

import numpy as np
import torch

from annotatedvdb_tpu_torch.ops.intervals import clamped_queries
from annotatedvdb_tpu_torch.utils.arrays import POS_SENTINEL, pad_pow2

#: fixed-point scales: allele frequencies quantize to 1e-6, CADD phred to
#: 1e-3; both stay under 2**SUM_BITS so the bit-sliced sum is exact
AF_SCALE = 1_000_000
CADD_SCALE = 1_000

#: bits per fixed-point value in the sliced summation (values clamp to
#: FP_CAP at decode time; each lane's int32 count is bounded by the rows)
SUM_BITS = 21
FP_CAP = (1 << SUM_BITS) - 1

#: the missing-value sentinel of every int32 feature column
STATS_MISSING = -1

#: cohort-max allele-frequency spectrum edges (fixed point, ``len - 1``
#: bins; values outside the range clamp into the boundary bins)
AF_EDGES_FP = np.asarray(
    [0, 10, 100, 1_000, 5_000, 10_000, 50_000,
     100_000, 250_000, 500_000, 1_000_000],
    np.int32,
)

#: CADD-phred histogram edges (phred units x CADD_SCALE)
CADD_EDGES_FP = np.asarray(
    [0, 1_000, 5_000, 10_000, 15_000, 20_000, 25_000,
     30_000, 40_000, 50_000, 100_000],
    np.int32,
)

#: consequence-rank rollup buckets (ranks at/above the cap count in the last)
RANK_BUCKETS = 32

#: windowed-mode bound: windows are rendered arrays
MAX_WINDOWS = 64

#: the kernels' table (``csrc/stats_panel.cu``): a row of counters every
#: PANEL_TILE_ROWS (panel) or WINDOW_TILE_ROWS (windows) rows, counted a
#: SUPER_ROWS-row super-tile a block, PANEL_SLOTS or WINDOW_SLOTS int32 a row,
#: after a header of SCRATCH_HEADER_WORDS
PANEL_TILE_ROWS = 256
WINDOW_TILE_ROWS = 64
SUPER_ROWS = 4096
PANEL_SLOTS = 96
WINDOW_SLOTS = 24
SCRATCH_HEADER_WORDS = 32
#: counters per tile: AF lanes + AF bins + CADD lanes + CADD bins + ranks
PANEL_COUNTERS = 2 * SUM_BITS + 2 * (len(AF_EDGES_FP) - 1) + RANK_BUCKETS
#: counters per tile of the windowed scan: CADD present + CADD lanes
WINDOW_COUNTERS = 1 + SUM_BITS

#: kernel launches by wrapper name — incremented only where the kernel is
#: launched, so a run can show that its main path went through the kernel
LAUNCHES = {"stats_panel": 0, "windowed_stats": 0}

#: calls of the plain versions by device type, so a run can show that its
#: card path never took them
CALLS = {"cpu": 0, "cuda": 0}

_lib = None


def _library() -> ctypes.CDLL:
    """The kernels' library with its C interface declared (built at first
    use)."""
    global _lib
    if _lib is None:
        from annotatedvdb_tpu_torch.ops.build import load

        lib = load("stats_panel")
        p, i = ctypes.c_void_p, ctypes.c_int
        w = ctypes.c_longlong
        lib.stats_panel_launch.argtypes = [p, p, p, p, i, p, p, i, p, w] + [p] * 8
        lib.stats_panel_launch.restype = ctypes.c_int
        lib.windowed_stats_launch.argtypes = [p, p, i, p, p, i, i, p, w, p, p, p, p]
        lib.windowed_stats_launch.restype = ctypes.c_int
        _lib = lib
    return _lib


# ---------------------------------------------------------------------------
# plain versions (torch) — the reference's integer arithmetic


def _count(device):
    kind = device.type
    CALLS[kind] = CALLS.get(kind, 0) + 1


def _cum0(x):
    """Prefix sum along axis 0 with a leading zero row."""
    zero = torch.zeros((1,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    return torch.cat([zero, torch.cumsum(x, dim=0, dtype=x.dtype)])


def _lane_bits(v, mask):
    """[K, SUM_BITS] int32 bit planes of ``v`` where ``mask`` (else 0)."""
    shifts = torch.arange(SUM_BITS, dtype=torch.int32, device=v.device)
    bits = (v[:, None] >> shifts[None, :]) & 1
    return torch.where(mask[:, None], bits, 0).to(torch.int32)


def _bucket_onehot(v, mask, edges):
    """[K, B] int32 one-hots of ``v``'s histogram bucket where ``mask``."""
    nbins = int(edges.shape[0]) - 1
    e = torch.as_tensor(edges, dtype=torch.int32, device=v.device)
    bucket = torch.clamp(torch.searchsorted(e, v, right=True) - 1, 0, nbins - 1)
    onehot = bucket[:, None] == torch.arange(nbins, device=v.device)[None, :]
    return (onehot & mask[:, None]).to(torch.int32)


def stats_panel_reference(pos, af, cadd, rank, starts, ends):
    """Plain-torch stats panel: ``(lo, hi, af_lanes [Q, SUM_BITS], af_hist
    [Q, 10], cadd_lanes [Q, SUM_BITS], cadd_hist [Q, 10], rank_counts [Q,
    RANK_BUCKETS])``, all int32, from the [K] int32 columns and [Q] int32
    query bounds."""
    _count(pos.device)
    pos = pos.to(torch.int32)
    starts = starts.to(torch.int32)
    ends = ends.to(torch.int32)
    lo = torch.searchsorted(pos, starts, right=False)
    hi = torch.searchsorted(pos, ends, right=True)

    def feature(v, edges):
        v = v.to(torch.int32)
        mask = v >= 0
        cum_lanes = _cum0(_lane_bits(v, mask))
        cum_hist = _cum0(_bucket_onehot(v, mask, edges))
        return cum_lanes[hi] - cum_lanes[lo], cum_hist[hi] - cum_hist[lo]

    af_lanes, af_hist = feature(af, AF_EDGES_FP)
    cadd_lanes, cadd_hist = feature(cadd, CADD_EDGES_FP)
    rank = rank.to(torch.int32)
    rmask = rank >= 0
    rbucket = torch.clamp(rank, 0, RANK_BUCKETS - 1)
    ronehot = (rbucket[:, None] == torch.arange(
        RANK_BUCKETS, dtype=torch.int32, device=rank.device)[None, :])
    cum_rank = _cum0((ronehot & rmask[:, None]).to(torch.int32))
    rank_counts = cum_rank[hi] - cum_rank[lo]
    return (lo.to(torch.int32), hi.to(torch.int32), af_lanes, af_hist,
            cadd_lanes, cadd_hist, rank_counts)


def window_bounds(starts, ends, windows: int):
    """[Q, windows + 1] int32 window boundaries: ``start + q·w + (r·w) //
    W`` with ``q, r = divmod(end - start + 1, W)`` (floor division),
    exactly ``start + (span·w) // W`` without overflow."""
    w = torch.arange(windows + 1, dtype=torch.int32, device=starts.device)
    span = ends - starts + 1
    q = torch.div(span, windows, rounding_mode="floor")
    r = span - q * windows
    return (starts[:, None] + q[:, None] * w[None, :]
            + torch.div(r[:, None] * w[None, :], windows, rounding_mode="floor"))


def windowed_stats_reference(pos, cadd, starts, ends, windows: int):
    """Plain-torch windowed scan: ``(counts [Q, W], present [Q, W], lanes
    [Q, W, SUM_BITS])``, all int32."""
    _count(pos.device)
    pos = pos.to(torch.int32)
    starts = starts.to(torch.int32)
    ends = ends.to(torch.int32)
    bounds = window_bounds(starts, ends, int(windows))
    idx = torch.searchsorted(pos, bounds.reshape(-1), right=False
                             ).reshape(bounds.shape)
    counts = (idx[:, 1:] - idx[:, :-1]).to(torch.int32)
    cadd = cadd.to(torch.int32)
    mask = cadd >= 0
    cum_n = _cum0(mask.to(torch.int32))
    cum_lanes = _cum0(_lane_bits(cadd, mask))
    present = cum_n[idx[:, 1:]] - cum_n[idx[:, :-1]]
    lanes = cum_lanes[idx[:, 1:]] - cum_lanes[idx[:, :-1]]
    return counts, present, lanes


# ---------------------------------------------------------------------------
# wrappers: the kernels on CUDA tensors, the plain versions on CPU tensors


def _check(name, cols, starts, ends) -> None:
    dev = cols[0].device
    for t in (*cols, starts, ends):
        if t.device != dev:
            raise ValueError(f"{name}: inputs lie on {t.device} and {dev}")
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: every input must be int32, not {t.dtype}")
        if t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{name}: every input must be a contiguous 1-D tensor")
    k = cols[0].shape[0]
    if any(t.shape[0] != k for t in cols):
        raise ValueError(f"{name}: row columns disagree in length")
    if starts.shape != ends.shape:
        raise ValueError(f"{name}: starts and ends disagree in shape")
    if k >= 2**30 or starts.shape[0] >= 2**31 - 1:
        raise ValueError(f"{name}: too many rows for the kernel's int32 indices")


def scratch_words(kind: str, k: int, q: int = 0, windows: int = 0) -> int:
    """int32 words of a kernel's scratch (``csrc/stats_panel.cu::layout``):
    the header, the table rows of every whole super-tile up to row ``k``
    and their totals; for ``kind == "windows"`` then the [q, windows + 1]
    boundary indices."""
    tile, slots = ((PANEL_TILE_ROWS, PANEL_SLOTS) if kind == "panel"
                   else (WINDOW_TILE_ROWS, WINDOW_SLOTS))
    per = SUPER_ROWS // tile
    supers = (-(-k // tile) + per) // per
    words = SCRATCH_HEADER_WORDS + supers * (per + 1) * slots
    return words + (q * (windows + 1) if kind == "windows" else 0)


def stats_panel(pos, af, cadd, rank, starts, ends):
    """The fused panel for one chromosome group: ``pos``/``af``/``cadd``/
    ``rank`` [K] int32 (position-sorted; ``STATS_MISSING`` = absent),
    ``starts``/``ends`` [Q] int32 clamped query bounds.

    CPU tensors take :func:`stats_panel_reference`; CUDA tensors launch the
    kernel once on the current stream (no synchronisation) or raise.
    Returns ``(lo, hi, af_lanes, af_hist, cadd_lanes, cadd_hist,
    rank_counts)``, int32."""
    if pos.device.type == "cpu":
        return stats_panel_reference(pos, af, cadd, rank, starts, ends)
    if pos.device.type != "cuda":
        raise ValueError(f"stats_panel: unsupported device {pos.device}")
    _check("stats_panel", (pos, af, cadd, rank), starts, ends)
    k, q, dev = pos.shape[0], starts.shape[0], pos.device
    nbins = len(AF_EDGES_FP) - 1
    out = [torch.empty((q,), dtype=torch.int32, device=dev) for _ in range(2)]
    out += [torch.empty(shape, dtype=torch.int32, device=dev) for shape in (
        (q, SUM_BITS), (q, nbins), (q, SUM_BITS), (q, nbins), (q, RANK_BUCKETS))]
    if q == 0:
        return tuple(out)
    words = scratch_words("panel", k)
    scratch = torch.empty((words,), dtype=torch.int32, device=dev)
    rc = _library().stats_panel_launch(
        pos.data_ptr(), af.data_ptr(), cadd.data_ptr(), rank.data_ptr(), k,
        starts.data_ptr(), ends.data_ptr(), q, scratch.data_ptr(), words,
        *(o.data_ptr() for o in out), torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"stats_panel: kernel launch failed (cudaError {rc})")
    LAUNCHES["stats_panel"] += 1
    return tuple(out)


def windowed_stats(pos, cadd, starts, ends, windows: int):
    """The windowed scan for one chromosome group (``windows`` in
    1..MAX_WINDOWS).  CPU tensors take :func:`windowed_stats_reference`;
    CUDA tensors launch the kernel once (no synchronisation) or raise.
    Returns ``(counts [Q, W], present [Q, W], lanes [Q, W, SUM_BITS])``,
    int32."""
    if pos.device.type == "cpu":
        return windowed_stats_reference(pos, cadd, starts, ends, windows)
    if pos.device.type != "cuda":
        raise ValueError(f"windowed_stats: unsupported device {pos.device}")
    _check("windowed_stats", (pos, cadd), starts, ends)
    windows = int(windows)
    if not 1 <= windows <= MAX_WINDOWS:
        raise ValueError(f"windowed_stats: windows {windows} outside [1, {MAX_WINDOWS}]")
    k, q, dev = pos.shape[0], starts.shape[0], pos.device
    out = [torch.empty((q, windows), dtype=torch.int32, device=dev) for _ in range(2)]
    out.append(torch.empty((q, windows, SUM_BITS), dtype=torch.int32, device=dev))
    if q == 0:
        return tuple(out)
    words = scratch_words("windows", k, q, windows)
    scratch = torch.empty((words,), dtype=torch.int32, device=dev)
    rc = _library().windowed_stats_launch(
        pos.data_ptr(), cadd.data_ptr(), k, starts.data_ptr(), ends.data_ptr(),
        q, windows, scratch.data_ptr(), words, *(o.data_ptr() for o in out),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"windowed_stats: kernel launch failed (cudaError {rc})")
    LAUNCHES["windowed_stats"] += 1
    return tuple(out)


# ---------------------------------------------------------------------------
# numpy twins — the same integer arithmetic, byte-identical by construction


def _cum0_np(x):
    zero = np.zeros((1,) + x.shape[1:], x.dtype)
    return np.concatenate([zero, np.cumsum(x, axis=0, dtype=x.dtype)])


def _lane_bits_np(v, mask):
    shifts = np.arange(SUM_BITS, dtype=np.int32)
    bits = (v[:, None] >> shifts[None, :]) & 1
    return np.where(mask[:, None], bits, 0).astype(np.int32)


def _bucket_onehot_np(v, mask, edges):
    nbins = int(edges.shape[0]) - 1
    bucket = np.clip(
        np.searchsorted(edges, v, side="right") - 1, 0, nbins - 1
    )
    onehot = bucket[:, None] == np.arange(nbins, dtype=bucket.dtype)[None, :]
    return np.where(mask[:, None], onehot, False).astype(np.int32)


def stats_panel_host(pos, af, cadd, rank, starts, ends):
    """Numpy twin of the stats panel (the circuit breaker's path): the same
    clamped int32 inputs through the same prefix-sum/gather definitions."""
    pos = np.asarray(pos, np.int32)
    starts, ends = clamped_queries(starts, ends)
    lo = np.searchsorted(pos, starts, side="left").astype(np.int32)
    hi = np.searchsorted(pos, ends, side="right").astype(np.int32)

    def feature(v, edges):
        v = np.asarray(v, np.int32)
        mask = v >= 0
        cum_lanes = _cum0_np(_lane_bits_np(v, mask))
        cum_hist = _cum0_np(_bucket_onehot_np(v, mask, edges))
        return cum_lanes[hi] - cum_lanes[lo], cum_hist[hi] - cum_hist[lo]

    af_lanes, af_hist = feature(af, AF_EDGES_FP)
    cadd_lanes, cadd_hist = feature(cadd, CADD_EDGES_FP)
    rank = np.asarray(rank, np.int32)
    rmask = rank >= 0
    rbucket = np.clip(rank, 0, RANK_BUCKETS - 1)
    ronehot = np.where(
        rmask[:, None],
        rbucket[:, None] == np.arange(RANK_BUCKETS,
                                      dtype=rbucket.dtype)[None, :],
        False,
    ).astype(np.int32)
    cum_rank = _cum0_np(ronehot)
    rank_counts = cum_rank[hi] - cum_rank[lo]
    return lo, hi, af_lanes, af_hist, cadd_lanes, cadd_hist, rank_counts


def windowed_stats_host(pos, cadd, starts, ends, windows: int):
    """Numpy twin of the windowed scan."""
    pos = np.asarray(pos, np.int32)
    starts, ends = clamped_queries(starts, ends)
    w = np.arange(windows + 1, dtype=np.int32)
    span = ends - starts + 1
    q, r = span // windows, span % windows
    bounds = (starts[:, None] + q[:, None] * w[None, :]
              + (r[:, None] * w[None, :]) // windows)
    idx = np.searchsorted(
        pos, bounds.reshape(-1), side="left"
    ).reshape(bounds.shape).astype(np.int32)
    counts = idx[:, 1:] - idx[:, :-1]
    cadd = np.asarray(cadd, np.int32)
    mask = cadd >= 0
    cum_n = _cum0_np(mask.astype(np.int32))
    cum_lanes = _cum0_np(_lane_bits_np(cadd, mask))
    present = cum_n[idx[:, 1:]] - cum_n[idx[:, :-1]]
    lanes = cum_lanes[idx[:, 1:]] - cum_lanes[idx[:, :-1]]
    return counts, present, lanes


# ---------------------------------------------------------------------------
# device entry points (the padding discipline of ``interval_spans``)


def _rows(cols, fills, padded: bool, device):
    """Row columns as tensors: already-padded device residents as they are,
    numpy columns padded to a power of two and uploaded to ``device``."""
    from annotatedvdb_tpu_torch.runtime import resolve_device, to_device

    if padded:
        return list(cols)
    dev = resolve_device(device)
    return [to_device(pad_pow2(np.asarray(c, np.int32), f), dev)
            for c, f in zip(cols, fills)]


def _queries(starts, ends, dev):
    from annotatedvdb_tpu_torch.runtime import to_device

    starts, ends = clamped_queries(starts, ends)
    return (starts.shape[0], to_device(pad_pow2(starts, 0), dev),
            to_device(pad_pow2(ends, 0), dev))


def stats_panel_batch(pos, af, cadd, rank, starts, ends, *,
                      padded: bool = False, device=None):
    """Run :func:`stats_panel` once: clamp the queries, pad rows and queries
    to powers of two (rows with the position sentinel and MISSING
    features, queries with zeros, whose outputs are sliced away), return
    numpy outputs.  ``padded=True`` marks the row columns as already
    padded tensors (the engine uploads each generation's columns once);
    otherwise they are numpy and go to ``device`` (``cuda`` unless the
    caller asks for ``cpu``)."""
    rows = _rows((pos, af, cadd, rank),
                 (POS_SENTINEL, STATS_MISSING, STATS_MISSING, STATS_MISSING),
                 padded, device)
    nq, s, e = _queries(starts, ends, rows[0].device)
    out = stats_panel(*rows, s, e)
    return tuple(o.cpu().numpy()[:nq] for o in out)


def windowed_stats_batch(pos, cadd, starts, ends, windows: int, *,
                         padded: bool = False, device=None):
    """Run :func:`windowed_stats` once (same padding discipline)."""
    rows = _rows((pos, cadd), (POS_SENTINEL, STATS_MISSING), padded, device)
    nq, s, e = _queries(starts, ends, rows[0].device)
    out = windowed_stats(*rows, s, e, int(windows))
    return tuple(o.cpu().numpy()[:nq] for o in out)


# ---------------------------------------------------------------------------
# host-side decode: JSONB sidecar values -> fixed-point feature scalars


def _plain(v):
    """A stored JSONB value as a plain mapping (or None).  ``RawJson``
    values parse fresh and are discarded."""
    if v is None:
        return None
    if isinstance(v, dict):
        return v
    text = getattr(v, "text", None)  # RawJson duck-type: no store import
    if text is not None:
        try:
            v = json.loads(text)
        except ValueError:
            return None
        return v if isinstance(v, dict) else None
    return v if isinstance(v, dict) else None


def _num(x):
    """The filter rule's numeric check: int/float, never bool."""
    return isinstance(x, (int, float)) and not isinstance(x, bool)


def _fp(value: float, scale: int) -> int:
    return min(max(int(round(value * scale)), 0), FP_CAP)


def feature_values(cadd_obj, af_obj, ms_obj):
    """Decode one row's analytics features from its raw JSONB values.

    Returns ``(cadd_f, rank_f, af_fp, cadd_fp, rank_i)``: ``cadd_f``/
    ``rank_f`` float64 (NaN = missing), the exact values the
    ``min_cadd``/``max_conseq_rank`` filters compare; ``af_fp``/
    ``cadd_fp``/``rank_i`` int32 fixed point for the kernels
    (``STATS_MISSING`` = absent).  The AF feature is the cohort-max allele
    frequency: the largest numeric leaf of ``allele_frequencies`` (one
    level of source nesting deep), clamped to [0, 1]."""
    cadd_f = float("nan")
    cadd_fp = STATS_MISSING
    obj = _plain(cadd_obj)
    if obj is not None:
        v = obj.get("CADD_phred")
        if _num(v):
            cadd_f = float(v)
            cadd_fp = _fp(max(float(v), 0.0), CADD_SCALE)
    rank_f = float("nan")
    rank_i = STATS_MISSING
    obj = _plain(ms_obj)
    if obj is not None:
        v = obj.get("rank")
        if _num(v):
            rank_f = float(v)
            rank_i = min(max(int(v), 0), RANK_BUCKETS - 1)
    af_fp = STATS_MISSING
    obj = _plain(af_obj)
    if obj is not None:
        best = None
        for v in obj.values():
            if _num(v):
                if best is None or v > best:
                    best = v
            elif isinstance(v, dict):
                for vv in v.values():
                    if _num(vv) and (best is None or vv > best):
                        best = vv
        if best is not None:
            af_fp = _fp(min(max(float(best), 0.0), 1.0), AF_SCALE)
    return cadd_f, rank_f, af_fp, cadd_fp, rank_i


# ---------------------------------------------------------------------------
# derivation + rendering: kernel outputs -> the served summary values


def lanes_to_sums(lanes) -> np.ndarray:
    """Bit-lane counts -> exact int64 sums (``Σ lane_b << b``)."""
    lanes = np.asarray(lanes, np.int64)
    weights = np.int64(1) << np.arange(SUM_BITS, dtype=np.int64)
    return (lanes * weights).sum(axis=-1)


def _mean(total_fp: int, present: int, scale: int):
    if present <= 0:
        return None
    return round(int(total_fp) / (int(present) * scale), 9)


def hist_quantiles(hist_row, edges_fp, scale: int, qs=(50, 90, 99)):
    """Approximate quantiles from exact histogram counts: the target
    rank's bin, linearly interpolated within it."""
    hist_row = np.asarray(hist_row, np.int64)
    n = int(hist_row.sum())
    out = {}
    if n == 0:
        return {f"p{q}": None for q in qs}
    cum = np.cumsum(hist_row)
    for q in qs:
        target = -(-n * q // 100)  # ceil(n*q/100), pure int
        b = int(np.searchsorted(cum, target, side="left"))
        before = int(cum[b - 1]) if b else 0
        lo_e, hi_e = int(edges_fp[b]), int(edges_fp[b + 1])
        within = (target - before) / int(hist_row[b])
        out[f"p{q}"] = round((lo_e + (hi_e - lo_e) * within) / scale, 6)
    return out


#: the metric families a stats request may select (render-side only)
STATS_METRICS = ("af", "cadd", "conseq")


def summary_from_totals(count: int, af_sum: int, af_hist, cadd_sum: int,
                        cadd_hist, rank_counts, metrics=STATS_METRICS,
                        windows_block=None) -> dict:
    """One summary dict from exact integer totals — the envelope of
    ``POST /stats/region``."""
    out: dict = {"count": int(count)}
    if "af" in metrics:
        hist = np.asarray(af_hist, np.int64)
        present = int(hist.sum())
        out["af"] = {
            "present": present,
            "mean": _mean(int(af_sum), present, AF_SCALE),
            "spectrum": [int(c) for c in hist],
        }
    if "cadd" in metrics:
        hist = np.asarray(cadd_hist, np.int64)
        present = int(hist.sum())
        out["cadd"] = {
            "present": present,
            "mean": _mean(int(cadd_sum), present, CADD_SCALE),
            "histogram": [int(c) for c in hist],
            "quantiles": hist_quantiles(hist, CADD_EDGES_FP, CADD_SCALE),
        }
    if "conseq" in metrics:
        counts = np.asarray(rank_counts, np.int64)
        out["conseq"] = {
            "present": int(counts.sum()),
            "ranks": {str(r): int(c) for r, c in enumerate(counts) if c},
        }
    if windows_block is not None:
        out["windows"] = windows_block
    return out


def interval_summary(count: int, af_lanes, af_hist, cadd_lanes, cadd_hist,
                     rank_counts, metrics=STATS_METRICS,
                     windows_block=None) -> dict:
    """One interval's summary dict from its kernel-output rows."""
    return summary_from_totals(
        count, int(lanes_to_sums(af_lanes)), af_hist,
        int(lanes_to_sums(cadd_lanes)), cadd_hist, rank_counts,
        metrics, windows_block,
    )


def column_totals(values, edges):
    """(present, exact_sum, hist) of one fixed-point column chunk on the
    host, with the kernels' clamped bucketing."""
    v = np.asarray(values, np.int64)
    v = v[v >= 0]
    nbins = int(np.asarray(edges).shape[0]) - 1
    bucket = np.clip(
        np.searchsorted(np.asarray(edges, np.int64), v, side="right") - 1,
        0, nbins - 1,
    )
    hist = np.bincount(bucket, minlength=nbins).astype(np.int64)
    return int(v.shape[0]), int(v.sum()), hist


def rank_totals(ranks):
    """Clamped consequence-rank bucket counts of one column chunk."""
    r = np.asarray(ranks, np.int64)
    r = np.clip(r[r >= 0], 0, RANK_BUCKETS - 1)
    return np.bincount(r, minlength=RANK_BUCKETS).astype(np.int64)


def windows_summary(counts_row, present_row, lanes_row) -> dict:
    """One interval's windowed block from its kernel-output rows."""
    sums = lanes_to_sums(lanes_row)
    return {
        "n": int(np.asarray(counts_row).shape[0]),
        "counts": [int(c) for c in np.asarray(counts_row)],
        "cadd_present": [int(p) for p in np.asarray(present_row)],
        "cadd_mean": [
            _mean(int(s), int(p), CADD_SCALE)
            for s, p in zip(sums, np.asarray(present_row))
        ],
    }


def edges_payload() -> dict:
    """The bin-edge declaration rendered once per response."""
    return {
        "af": [round(int(e) / AF_SCALE, 6) for e in AF_EDGES_FP],
        "cadd": [round(int(e) / CADD_SCALE, 3) for e in CADD_EDGES_FP],
        "rank_buckets": RANK_BUCKETS,
    }
