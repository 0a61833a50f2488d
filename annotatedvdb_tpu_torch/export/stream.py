"""``GET /export/stream``: one corpus batch over HTTP.

Port of ``annotatedvdb_tpu/export/stream.py``.  A client names a
``region`` slice and a ``batch`` ordinal and gets back what the bulk
export would have packed for that slice: the same fixed-shape int32
token and feature lanes, the same validity mask, the slice's sorted allele
dictionary and the same seeded disjoint-block emission order (seed ``S``
over ``N`` batches permutes as in the corpus planner: both use
:data:`~annotatedvdb_tpu_torch.export.core.SHUFFLE_BLOCK` windows of one
``random.Random(seed)``).  The threaded front end (``serve/http.py``)
calls :func:`stream_payload`, which renders the body.

Packing runs on the engine's device (``engine.device``: one
``export_pack`` launch a call on the card) behind the engine's circuit
breaker, as ``QueryEngine._probe_group`` does: an open breaker, or a
device failure (recorded), packs on the numpy twin, with the same bytes.
Slices are capped at :data:`STREAM_MAX_ROWS` rows.
"""

from __future__ import annotations

import json
import random
from urllib.parse import parse_qs

import numpy as np

from annotatedvdb_tpu_torch.export.core import (
    SHUFFLE_BLOCK,
    TOKENS_PER_ROW,
    _pad,
    pack_batches,
    parse_region,
)
from annotatedvdb_tpu_torch.export.tokens import TOKEN_FIELDS
from annotatedvdb_tpu_torch.ops.intervals import MAX_QUERY_POS
from annotatedvdb_tpu_torch.serve.engine import QueryError, segment_alleles
from annotatedvdb_tpu_torch.types import chromosome_label

STREAM_ROUTE = "/export/stream"

#: hard per-request row cap: the route serves slices; whole-chromosome
#: pulls belong to the bulk export
STREAM_MAX_ROWS = 1 << 16

STREAM_DEFAULT_BATCH_ROWS = 256
STREAM_MAX_BATCH_ROWS = 4096

#: the one grammar message for a malformed query string
STREAM_QUERY_ERROR = (
    "export/stream query must be region=[chr]N:start-end with optional "
    "integer batch, batch_rows (8..4096), seed, and ordered=0|1"
)


def parse_stream_query(query: str) -> dict:
    """Validated params from the raw query string (``ValueError`` on any
    grammar violation; the route maps it to 400)."""
    try:
        q = parse_qs(query or "", keep_blank_values=False)
        region = q["region"][0]
        batch = int(q.get("batch", ["0"])[0])
        batch_rows = int(q.get("batch_rows",
                               [str(STREAM_DEFAULT_BATCH_ROWS)])[0])
        seed = int(q.get("seed", ["0"])[0])
        ordered = q.get("ordered", ["0"])[0] not in ("0", "", "false")
    except (KeyError, ValueError, IndexError):
        raise ValueError(STREAM_QUERY_ERROR) from None
    if batch < 0 or not 8 <= batch_rows <= STREAM_MAX_BATCH_ROWS:
        raise ValueError(STREAM_QUERY_ERROR)
    code, start, end = parse_region(region)  # ValueError on bad grammar
    return {"code": code, "start": start, "end": end, "batch": batch,
            "batch_rows": batch_rows, "seed": seed, "ordered": ordered}


def emission_order(n_batches: int, seed: int) -> list[int]:
    """Plan-order batch indices in emission order: the disjoint-block
    permutation the export's prefetcher applies
    (``random.Random(seed).shuffle`` per consecutive
    :data:`SHUFFLE_BLOCK`-batch window)."""
    rng = random.Random(seed)
    out: list[int] = []
    for i in range(0, n_batches, SHUFFLE_BLOCK):
        block = list(range(i, min(i + SHUFFLE_BLOCK, n_batches)))
        if len(block) > 1:
            rng.shuffle(block)
        out.extend(block)
    return out


def stream_payload(engine, params: dict,
                   host_only: bool = False) -> tuple[str, int]:
    """``(rendered JSON body, n_valid)`` for one packed batch of the
    requested slice.  Raises
    :class:`~annotatedvdb_tpu_torch.serve.engine.QueryError` on semantic
    errors (unknown chromosome, over-cap slice, batch out of range)."""
    code = params["code"]
    label = chromosome_label(code)
    snap = engine.snapshots.current()
    index = engine._interval_index(snap, code)
    if index is None:
        raise QueryError(f"chromosome {label} not in store")
    lo = int(np.searchsorted(index.pos, params["start"], side="left"))
    hi = int(np.searchsorted(index.pos, params["end"], side="right"))
    n_rows = hi - lo
    if n_rows > STREAM_MAX_ROWS:
        raise QueryError(
            f"export/stream slice has {n_rows} rows (cap "
            f"{STREAM_MAX_ROWS}); narrow the region or use `avdb export`"
        )
    B = params["batch_rows"]
    n_batches = (n_rows + B - 1) // B
    if params["batch"] >= max(n_batches, 1):
        raise QueryError(
            f"batch {params['batch']} out of range: slice has "
            f"{n_batches} batch(es) of {B} rows"
        )
    feats = engine._stats_features(snap, code, index)
    shard = snap.store.shards.get(code)
    # slice-local allele dictionary through the renderer's segment_alleles
    refs = np.empty(n_rows, object)
    alts = np.empty(n_rows, object)
    ref_len = np.zeros(n_rows, np.int32)
    si, jj = index.si[lo:hi], index.jj[lo:hi]
    for k in range(n_rows):
        seg = shard.segments[int(si[k])]
        j = int(jj[k])
        refs[k], alts[k] = segment_alleles(seg, j, shard.width)
        ref_len[k] = int(seg.cols["ref_len"][j])
    alleles = sorted(set(refs.tolist()) | set(alts.tolist()))
    lut = {s: i for i, s in enumerate(alleles)}
    ref_code = np.fromiter((lut[s] for s in refs.tolist()), np.int32, n_rows)
    alt_code = np.fromiter((lut[s] for s in alts.tolist()), np.int32, n_rows)
    pos = index.pos[lo:hi]
    end_col = np.minimum(pos.astype(np.int64) + ref_len - 1,
                         MAX_QUERY_POS).astype(np.int32)
    # emission slot -> plan-order batch (ordered mode is the identity)
    seq = params["batch"] if params["ordered"] or n_batches == 0 else \
        emission_order(n_batches, params["seed"])[params["batch"]]
    off = seq * B
    n = max(0, min(B, n_rows - off))
    sl = slice(off, off + n)
    chunk = {
        "code": code, "n_valid": n,
        "pos": _pad(pos, sl, n, B, 1),
        "end": _pad(end_col, sl, n, B, 1),
        "ref_code": _pad(ref_code, sl, n, B, -1),
        "alt_code": _pad(alt_code, sl, n, B, -1),
        "af_fp": _pad(feats.af_fp[lo:hi], sl, n, B, -1),
        "cadd_fp": _pad(feats.cadd_fp[lo:hi], sl, n, B, -1),
        "rank_i": _pad(feats.rank_i[lo:hi], sl, n, B, -1),
    }
    packed = _pack_breakered(engine, code, chunk, host_only)
    doc = {
        "region": f"{label}:{params['start']}-{params['end']}",
        "chromosome": label,
        "generation": snap.generation,
        "batch_rows": B,
        "seed": params["seed"],
        "ordered": params["ordered"],
        "rows": n_rows,
        "n_batches": n_batches,
        "batch": params["batch"],
        "seq": seq,
        "n_valid": n,
        "token_fields": list(TOKEN_FIELDS),
        "tokens_per_row": TOKENS_PER_ROW,
        "missing": -1,
        "alleles": alleles,
        "arrays": {name: packed[name].tolist() for name in (
            "mask", "bin_level", "leaf_bin", "pos", "ref_code", "alt_code",
            "af_fp", "cadd_fp", "rank_i", "bin_index")},
    }
    return json.dumps(doc), n


def _pack_breakered(engine, code: int, chunk: dict, host_only: bool):
    """The pack behind the engine's device circuit breaker: an open group
    packs on the numpy twin; a device failure feeds the breaker and the
    batch packs on the twin (same bytes).  With no breaker a device
    failure fails the request."""
    breaker = engine.breaker
    if host_only or (breaker is not None and not breaker.allow_device(code)):
        return pack_batches([chunk], host_only=True)[0]
    try:
        packed = pack_batches([chunk], device=engine.device)[0]
    except Exception as exc:
        if breaker is None:
            raise
        breaker.record_failure(code, exc)
        return pack_batches([chunk], host_only=True)[0]
    if breaker is not None:
        breaker.record_success(code)
    return packed
