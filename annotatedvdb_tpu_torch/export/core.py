"""Corpus planner and batch materializer: the export's engine.

Port of ``annotatedvdb_tpu/export/core.py``.  Streams a chromosome (a
``--region`` slice, or the whole store) out of the columnar segments as
fixed-shape training batches:

- **rows** come from the serve engine's :class:`IntervalIndex`
  (position-sorted, first-wins deduplicated: what a region query returns)
  with :class:`StatsColumns` supplying the fixed-point feature columns
  (AF / CADD / consequence rank as int32, ``-1`` missing);
- **alleles** are dictionary-coded per chromosome: the rendered strings
  (``serve.engine.segment_alleles``, the JSON renderer's definition) are
  collected once, sorted, and shipped once per corpus in the manifest;
  rows carry int32 codes;
- **bin token and mask** come from ``ops/export_pack.py``: a part's
  batches are staged as gathered and packed when the part commits, with
  one upload, one ``export_pack`` kernel launch and one copy back on the
  card (:func:`pack_batches`' ``device``), or batch by batch on the numpy
  twin for ``host_only``; every batch is padded to
  ``AVDB_EXPORT_BATCH_ROWS`` rows;
- **scheduling**: batches are gathered ahead on a
  :class:`~annotatedvdb_tpu_torch.io.prefetch.ChunkPrefetcher` thread with
  seeded disjoint-block shuffling, the block pinned to
  :data:`SHUFFLE_BLOCK` (never an env knob), so one ``(store, plan,
  seed)`` triple maps to one emission order and the same seed gives a
  byte-identical corpus; ``ordered`` resequences the stream back to plan
  order before anything is written;
- **durability and resume**: parts commit through ``export/writer.py``
  (tmp -> fsync -> rename), each appends a ``{"type": "export"}`` ledger
  record, and the manifest commits last.  A resume replans
  (deterministic), checks the plan signature against the ledger, prunes
  debris and skips exactly the committed batches.

Not ported: the reference's ``export.plan`` and ``export.pack`` fault
points (``faults.fire``).
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import time

import numpy as np

from annotatedvdb_tpu_torch.export import writer as corpus_writer
from annotatedvdb_tpu_torch.export.tokens import TOKEN_FIELDS, bin_path
from annotatedvdb_tpu_torch.io.prefetch import ChunkPrefetcher, _knob_int
from annotatedvdb_tpu_torch.ops import export_pack as pack_ops
from annotatedvdb_tpu_torch.ops import intervals as interval_ops
from annotatedvdb_tpu_torch.runtime import resolve_device
from annotatedvdb_tpu_torch.serve.engine import (
    IntervalIndex,
    StatsColumns,
    segment_alleles,
)
from annotatedvdb_tpu_torch.types import chromosome_code, chromosome_label
from annotatedvdb_tpu_torch.utils.pipeline import Resequencer
from annotatedvdb_tpu_torch.utils.strings import parse_bytes

#: fixed prefetch depth AND shuffle-block size of the export spine: the
#: block permutation depends on it, and corpus bytes must be a function of
#: (store, plan, seed) alone
SHUFFLE_BLOCK = 8

#: int32 token slots each valid row contributes (bin_level, leaf_bin, pos,
#: ref_code, alt_code, af_fp, cadd_fp, rank_i): the tokens/s unit
TOKENS_PER_ROW = 8

#: the [n_batches, batch_rows] arrays every part carries, in container
#: order (the per-batch scalars chrom_code/n_valid/seq ride ahead of them)
ROW_FIELDS = (
    "mask", "bin_level", "leaf_bin", "pos", "ref_code", "alt_code",
    "af_fp", "cadd_fp", "rank_i", "bin_index",
)

_REGION_RE = re.compile(r"^(?:chr)?([0-9XYM]+):(\d+)-(\d+)$")


def export_batch_rows() -> int:
    """``AVDB_EXPORT_BATCH_ROWS``: rows per fixed-shape batch (default
    4096, at least 8)."""
    return _knob_int("AVDB_EXPORT_BATCH_ROWS",
                     os.environ.get("AVDB_EXPORT_BATCH_ROWS"), 4096, 8)


def export_shuffle_seed() -> int:
    """``AVDB_EXPORT_SHUFFLE_SEED``: the corpus shuffle seed (default 0);
    ``--seed`` overrides."""
    return _knob_int("AVDB_EXPORT_SHUFFLE_SEED",
                     os.environ.get("AVDB_EXPORT_SHUFFLE_SEED"), 0, 0)


def export_part_bytes() -> int:
    """``AVDB_EXPORT_PART_BYTES``: target committed-part size (default
    ``8m``, at least ``64k``).  Parts hold a whole number of batches, so
    this is a target, not a cap."""
    raw = (os.environ.get("AVDB_EXPORT_PART_BYTES") or "").strip()
    value = parse_bytes(raw or "8m")
    if value < (1 << 16):
        raise ValueError(f"AVDB_EXPORT_PART_BYTES must be >= 64k, not {value}")
    return value


class ChromPrep:
    """One chromosome's export-ready columns, aligned to its
    :class:`IntervalIndex` rows: interval end (``pos + ref_len - 1``,
    clamped like every query path), the fixed-point feature columns,
    dictionary-coded alleles and the sorted dictionary itself."""

    __slots__ = ("code", "label", "index", "end", "af_fp", "cadd_fp",
                 "rank_i", "ref_code", "alt_code", "alleles")

    def __init__(self, code, label, index, end, af_fp, cadd_fp, rank_i,
                 ref_code, alt_code, alleles):
        self.code = code
        self.label = label
        self.index = index
        self.end = end
        self.af_fp = af_fp
        self.cadd_fp = cadd_fp
        self.rank_i = rank_i
        self.ref_code = ref_code
        self.alt_code = alt_code
        self.alleles = alleles

    @classmethod
    def build(cls, store, code: int) -> "ChromPrep":
        shard = store.shards[code]
        index = IntervalIndex.build(shard)
        stats = StatsColumns.build(shard, index)
        n = index.n
        ref_len = np.zeros(n, np.int32)
        refs = np.empty(n, object)
        alts = np.empty(n, object)
        for si, seg in enumerate(shard.segments):
            sel = np.nonzero(index.si == si)[0]
            if sel.size == 0:
                continue
            jj = index.jj[sel]
            ref_len[sel] = seg.cols["ref_len"][jj].astype(np.int32)
            for t, j in zip(sel.tolist(), jj.tolist()):
                refs[t], alts[t] = segment_alleles(seg, j, shard.width)
        alleles = sorted(set(refs.tolist()) | set(alts.tolist()))
        lut = {s: i for i, s in enumerate(alleles)}
        ref_code = np.fromiter((lut[s] for s in refs.tolist()), np.int32, n)
        alt_code = np.fromiter((lut[s] for s in alts.tolist()), np.int32, n)
        end = np.minimum(index.pos.astype(np.int64) + ref_len - 1,
                         interval_ops.MAX_QUERY_POS).astype(np.int32)
        return cls(code, chromosome_label(code), index, end, stats.af_fp,
                   stats.cadd_fp, stats.rank_i, ref_code, alt_code, alleles)


class ExportPlan:
    """A deterministic corpus plan: which index rows, batched how.

    ``chroms`` — ``[{"code", "label", "lo", "hi", "rows"}]`` in code order;
    ``batches`` — ``(code, lo, n_valid)`` in plan order; ``signature`` —
    sha256 over every plan-shaping input, the resume compatibility check."""

    __slots__ = ("batch_rows", "batches_per_part", "seed", "ordered",
                 "chroms", "batches", "total_rows", "signature", "store_sha")

    def __init__(self, batch_rows, batches_per_part, seed, ordered, chroms,
                 batches, total_rows, store_sha):
        self.batch_rows = batch_rows
        self.batches_per_part = batches_per_part
        self.seed = seed
        self.ordered = ordered
        self.chroms = chroms
        self.batches = batches
        self.total_rows = total_rows
        self.store_sha = store_sha
        self.signature = hashlib.sha256(json.dumps({
            "batch_rows": batch_rows,
            "batches_per_part": batches_per_part,
            "seed": seed,
            "ordered": ordered,
            "chroms": chroms,
            "store": store_sha,
            "shuffle_block": SHUFFLE_BLOCK,
        }, sort_keys=True).encode()).hexdigest()

    @property
    def n_batches(self) -> int:
        return len(self.batches)

    @property
    def n_parts(self) -> int:
        k = self.batches_per_part
        return (len(self.batches) + k - 1) // k


def _store_sha(store_dir: str) -> str:
    """Content identity of the store the plan was computed against (its
    manifest bytes, hashed): stable across processes."""
    with open(os.path.join(store_dir, "manifest.json"), "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()[:16]


def parse_region(region: str) -> tuple[int, int, int]:
    """``[chr]N:start-end`` -> (code, start, end); 1-based inclusive."""
    m = _REGION_RE.match(region.strip())
    if m is None:
        raise ValueError(f"bad --region {region!r}: expected [chr]N:start-end")
    code = chromosome_code(m.group(1))
    if code == 0:
        raise ValueError(
            f"bad --region {region!r}: unknown chromosome {m.group(1)!r}")
    start, end = int(m.group(2)), int(m.group(3))
    if start < 1 or end < start:
        raise ValueError(f"bad --region {region!r}: need 1 <= start <= end")
    return code, start, end


def plan_export(store, store_dir: str, preps: dict, *,
                chromosome: str | None = None, region: str | None = None,
                batch_rows: int | None = None,
                part_bytes: int | str | None = None, seed: int | None = None,
                ordered: bool = False) -> ExportPlan:
    """Build the deterministic plan, filling ``preps`` with the chromosomes'
    columns (planning needs post-dedup row counts, which are the prep)."""
    batch_rows = export_batch_rows() if batch_rows is None else batch_rows
    if part_bytes is None:
        part_bytes = export_part_bytes()
    elif isinstance(part_bytes, str):
        part_bytes = parse_bytes(part_bytes)
    seed = export_shuffle_seed() if seed is None else seed
    spans: list[tuple[int, int | None, int | None]] = []
    if region is not None:
        spans.append(parse_region(region))
    elif chromosome is not None:
        code = chromosome_code(chromosome)
        if code == 0:
            raise ValueError(f"unknown chromosome {chromosome!r}")
        spans.append((code, None, None))
    else:
        spans.extend((code, None, None) for code in sorted(store.shards))
    chroms: list[dict] = []
    batches: list[tuple[int, int, int]] = []
    total = 0
    for code, start, end in spans:
        if code not in store.shards:
            raise ValueError(f"chromosome {chromosome_label(code)} not in store")
        if code not in preps:
            preps[code] = ChromPrep.build(store, code)
        prep = preps[code]
        lo, hi = 0, prep.index.n
        if start is not None:
            lo = int(np.searchsorted(prep.index.pos, start, side="left"))
            hi = int(np.searchsorted(prep.index.pos, end, side="right"))
        chroms.append({"code": code, "label": prep.label, "lo": lo, "hi": hi,
                       "rows": hi - lo})
        total += hi - lo
        for off in range(lo, hi, batch_rows):
            batches.append((code, off, min(batch_rows, hi - off)))
    # whole-batch part sizing from the shapes alone: int32 columns, mask
    # and level bytes and a path-string estimate
    batch_bytes = batch_rows * (7 * 4 + 2 + 24)
    per_part = max(1, part_bytes // batch_bytes)
    return ExportPlan(batch_rows, per_part, seed, ordered, chroms, batches,
                      total, _store_sha(store_dir))


def _gather(plan: ExportPlan, preps: dict):
    """Plan-order batch gather (runs on the prefetch thread): slice the
    prepared columns and pad to the fixed shape, 1 for coordinates (valid
    bin arithmetic on dead lanes) and -1 for features; the pack masks every
    padded lane anyway."""
    B = plan.batch_rows
    for code, off, n in plan.batches:
        p = preps[code]
        sl = slice(off, off + n)
        yield {
            "code": code, "n_valid": n,
            "pos": _pad(p.index.pos, sl, n, B, 1),
            "end": _pad(p.end, sl, n, B, 1),
            "ref_code": _pad(p.ref_code, sl, n, B, -1),
            "alt_code": _pad(p.alt_code, sl, n, B, -1),
            "af_fp": _pad(p.af_fp, sl, n, B, -1),
            "cadd_fp": _pad(p.cadd_fp, sl, n, B, -1),
            "rank_i": _pad(p.rank_i, sl, n, B, -1),
        }


def _pad(col, sl: slice, n: int, B: int, fill: int):
    out = np.full(B, fill, np.int32)
    out[:n] = col[sl]
    return out


def pack_batches(chunks: list[dict], host_only: bool = False,
                 device=None) -> list[dict]:
    """Gathered batches through the pack: one ``pack_ops.pack_part`` call
    for all of them on ``device`` (``cuda`` unless the caller asks for
    ``cpu``, where the plain version runs once), or the numpy twin batch by
    batch with ``host_only``; then :func:`pack_batch` for each.  Returns
    the part-ready per-batch arrays, in ``chunks`` order."""
    if host_only:
        outs = [pack_ops.export_pack_host(*(c[name] for name in pack_ops.COLUMNS),
                                          np.int32(c["n_valid"]))
                for c in chunks]
    else:
        outs = pack_ops.pack_part(chunks, resolve_device(device))
    return [pack_batch(c, out) for c, out in zip(chunks, outs)]


def pack_batch(chunk: dict, out) -> dict:
    """One gathered batch and its nine pack outputs -> the part-ready
    arrays, including the ltree path strings ("" on padded lanes,
    ``export.tokens.bin_path``)."""
    n = chunk["n_valid"]
    mask, level, leaf, pos, ref, alt, af, cadd, rank = out
    label = chromosome_label(chunk["code"])
    paths = [""] * mask.shape[0]
    for i in range(n):
        paths[i] = bin_path(label, int(level[i]), int(leaf[i]))
    return {
        "chrom_code": chunk["code"], "n_valid": n,
        "mask": mask, "bin_level": level, "leaf_bin": leaf, "pos": pos,
        "ref_code": ref, "alt_code": alt, "af_fp": af, "cadd_fp": cadd,
        "rank_i": rank, "bin_index": np.asarray(paths),
    }


def _stack_part(batches: list[dict]) -> dict:
    """K packed batches -> the part's array dict, container order fixed."""
    arrays = {
        "chrom_code": np.asarray([b["chrom_code"] for b in batches], np.int32),
        "n_valid": np.asarray([b["n_valid"] for b in batches], np.int32),
        "seq": np.asarray([b["seq"] for b in batches], np.int32),
    }
    for name in ROW_FIELDS:
        arrays[name] = np.stack([b[name] for b in batches])
    return arrays


def _committed_parts(ledger, out_dir: str, signature: str) -> int:
    """Committed-part count for this (out dir, plan): the resume cursor.
    Parts commit strictly in order, so the records must be a contiguous
    prefix; anything else is a corrupted history and fails loudly."""
    if ledger is None:
        return 0
    parts = sorted(
        e["part"] for e in ledger.exports()
        if e.get("out") == out_dir and e.get("plan_sig") == signature
    )
    if parts != list(range(len(parts))):
        raise ValueError(
            f"export ledger for {out_dir} is not a contiguous part prefix "
            f"({parts}); remove the output dir and re-run without --resume"
        )
    for n in parts:
        if not os.path.exists(os.path.join(out_dir, corpus_writer.part_name(n))):
            raise ValueError(
                f"ledger records part {n} for {out_dir} but the file is "
                "missing; remove the output dir and re-run without --resume"
            )
    return len(parts)


def run_export(store, ledger, store_dir: str, out_dir: str, *,
               chromosome: str | None = None, region: str | None = None,
               batch_rows: int | None = None,
               part_bytes: int | str | None = None,
               seed: int | None = None, ordered: bool = False,
               resume: bool = False, commit: bool = True,
               host_only: bool = False, max_parts: int | None = None,
               log=None, device=None) -> dict:
    """Plan and stream one corpus export; returns the summary record.

    ``commit=False`` is the dry run: plan, report, write nothing.
    ``resume=True`` replans, checks the plan signature against the ledger's
    committed parts, prunes ``*.export.tmp*`` debris and continues after
    the last committed part.  ``max_parts`` stops early (``--test``; the
    manifest then records ``complete: false``).  Batches pack on ``device``
    (``cuda`` unless the caller asks for ``cpu``; a missing card raises
    here, before the plan) unless ``host_only``."""
    t0 = time.perf_counter()
    if not host_only:
        device = resolve_device(device)
    log = log or (lambda *a: None)
    preps: dict[int, ChromPrep] = {}
    plan = plan_export(store, store_dir, preps, chromosome=chromosome,
                       region=region, batch_rows=batch_rows,
                       part_bytes=part_bytes, seed=seed, ordered=ordered)
    summary = {
        "out": out_dir, "plan_sig": plan.signature,
        "batch_rows": plan.batch_rows,
        "batches_per_part": plan.batches_per_part,
        "seed": plan.seed, "ordered": plan.ordered,
        "n_batches": plan.n_batches, "n_parts": plan.n_parts,
        "total_rows": plan.total_rows,
        "chromosomes": [c["label"] for c in plan.chroms],
    }
    if not commit:
        summary.update(committed=False, parts_written=0, rows=0, tokens=0,
                       seconds=round(time.perf_counter() - t0, 4))
        return summary
    os.makedirs(out_dir, exist_ok=True)
    out_dir = os.path.abspath(out_dir)
    summary["out"] = out_dir
    done = _committed_parts(ledger, out_dir, plan.signature) if resume else 0
    prior_records = [] if ledger is None else sorted(
        (e for e in ledger.exports()
         if e.get("out") == out_dir and e.get("plan_sig") == plan.signature
         and e["part"] < done),
        key=lambda e: e["part"],
    )
    pruned = corpus_writer.prune_debris(out_dir)
    if pruned:
        log(f"pruned {len(pruned)} export temp(s): {', '.join(pruned)}")
    if done:
        log(f"resuming after {done} committed part(s)")
    skip = done * plan.batches_per_part
    prefetch = ChunkPrefetcher(
        _gather(plan, preps), depth=SHUFFLE_BLOCK, shuffle_seed=plan.seed,
        tagged=True, stage="export", name="export-prefetch",
    )
    # ordered: resequence the shuffled schedule back to plan order (the
    # prefetch stays overlapped; order-bearing output sits downstream)
    stream = iter(Resequencer(prefetch)) if plan.ordered else None
    rows = tokens = emitted = written = 0
    staged: list[tuple[int, dict]] = []
    part_records: list[dict] = []

    def commit_staged():
        nonlocal written
        packed = pack_batches([c for _s, c in staged], host_only=host_only,
                              device=device)
        for (seq, _c), batch in zip(staged, packed):
            batch["seq"] = seq
        part_records.append(_commit_part(ledger, out_dir, plan, done + written,
                                         packed))
        written += 1
        staged.clear()

    try:
        while True:
            if stream is not None:
                chunk = next(stream, None)
                if chunk is None:
                    break
                seq = emitted
            else:
                tagged = next(prefetch, None)
                if tagged is None:
                    break
                seq, chunk = tagged
            emitted += 1
            if emitted <= skip:
                continue  # committed in a previous run: replayed, not repacked
            rows += chunk["n_valid"]
            tokens += chunk["n_valid"] * TOKENS_PER_ROW
            staged.append((seq, chunk))
            if len(staged) == plan.batches_per_part:
                commit_staged()
                if max_parts is not None and written >= max_parts:
                    break
    finally:
        prefetch.close()
    if staged:
        commit_staged()
    complete = (done + written) == plan.n_parts
    # the manifest names every committed part (prior runs' through their
    # ledger records, this run's directly) in one fixed-key shape, so a
    # resumed run's manifest is byte-identical to a clean run's
    all_parts = [
        {"part": e["part"], "file": e["file"], "sha256": e["sha256"],
         "bytes": e["bytes"], "batches": e["batches"], "rows": e["rows"]}
        for e in (*prior_records, *part_records)
    ]
    manifest = {
        "corpus": 1,
        "store": plan.store_sha,
        "batch_rows": plan.batch_rows,
        "batches_per_part": plan.batches_per_part,
        "seed": plan.seed,
        "ordered": plan.ordered,
        "plan_sig": plan.signature,
        "token_fields": list(TOKEN_FIELDS),
        "row_fields": list(ROW_FIELDS),
        "tokens_per_row": TOKENS_PER_ROW,
        "missing": -1,
        "chromosomes": plan.chroms,
        "alleles": {preps[c["code"]].label: preps[c["code"]].alleles
                    for c in plan.chroms},
        "total_rows": plan.total_rows,
        "n_batches": plan.n_batches,
        "n_parts": plan.n_parts,
        "parts": all_parts,
        "complete": complete,
    }
    corpus_writer.write_manifest(out_dir, manifest)
    wall = time.perf_counter() - t0
    stats = prefetch.stats
    summary.update(
        committed=True, resumed_parts=done, parts_written=written,
        parts=part_records, rows=rows, tokens=tokens, complete=complete,
        seconds=round(wall, 4),
        tokens_per_sec=round(tokens / wall, 2) if wall > 0 else 0.0,
        # consumer_wait_s is time the pack/write side starved on gather
        device_idle_frac=round(min(stats.consumer_wait_s / wall, 1.0), 4)
        if wall > 0 else 0.0,
        queue_stalls={"export-prefetch": stats.as_dict()},
    )
    return summary


def _commit_part(ledger, out_dir: str, plan: ExportPlan, n: int,
                 staged: list[dict]) -> dict:
    record = corpus_writer.write_part(out_dir, n, _stack_part(staged))
    record.update(out=out_dir, plan_sig=plan.signature, batches=len(staged),
                  rows=int(sum(b["n_valid"] for b in staged)))
    if ledger is not None:
        ledger.export(record)
    return record
