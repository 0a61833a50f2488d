"""CLI: store health — fsck/repair, online compaction, status, profile,
fail-over, replay.

Port of ``annotatedvdb_tpu/cli/doctor.py``, every verb.  ``doctor``
(default verb) audits a store directory against its manifest's
write-time integrity records and the ledger, and repairs what is safely
repairable (:mod:`annotatedvdb_tpu_torch.store.fsck`); ``doctor compact``
merges each chromosome group's segment files into one columnar segment,
crash-safe and online (:mod:`annotatedvdb_tpu_torch.store.compact` — safe
while a serve fleet reads the store); ``doctor status`` prints the
one-screen store health report (per-group segment counts and read-amp
against the maintenance watermarks, WAL files pending replay, crash
debris, disk free against the reserve, last ledger compact/flush records
— :func:`annotatedvdb_tpu_torch.store.maintenance.store_status`);
``doctor profile`` is the whole-store analytics profile, the summary
shapes ``POST /stats/region`` serves; ``doctor flight`` renders the crash
flight recorder (harvested black boxes under ``<store>/flight/``, or the
live rings); ``doctor slo`` replays the SLO burn-rate state machine over
the time-series history under ``<store>/history/``; ``doctor trace``
merges the ledger's run/compact/flush records and the flight timelines
into one Chrome trace-event JSON; ``doctor promote`` fails a
replication follower over to leader
(:func:`annotatedvdb_tpu_torch.store.replication.promote`); ``doctor
replay-rejects`` reconstructs a loadable input file from a quarantine
rejects file.  Reports, exit codes and output files are the reference's.

``doctor`` is host only, as in the reference, and takes no
``--platform``: ``status`` and ``compact --dry-run`` read no segment, and
fsck, ``compact``, ``promote`` and ``profile`` read the store on the host;
``flight``, ``slo`` and ``trace`` read only ``flight/``, ``history/`` and
the ledger.

Usage:
    python -m annotatedvdb_tpu_torch doctor --storeDir ./vdb [--deep] [--repair] [--json]
    python -m annotatedvdb_tpu_torch doctor compact --storeDir ./vdb \
        [--dry-run] [--maxBytes N] [--group 8 ...] [--chunkRows N] \
        [--retries N] [--json]
    python -m annotatedvdb_tpu_torch doctor status --storeDir ./vdb [--json]
    python -m annotatedvdb_tpu_torch doctor profile --storeDir ./vdb \
        [--out report.json] [--chunkRows N]
    python -m annotatedvdb_tpu_torch doctor flight --storeDir ./vdb \
        [--all] [--limit N] [--json]
    python -m annotatedvdb_tpu_torch doctor slo --storeDir ./vdb \
        [--all] [--fast S] [--slow S] [--burn X] [--json]
    python -m annotatedvdb_tpu_torch doctor trace --storeDir ./vdb [--out FILE]
    python -m annotatedvdb_tpu_torch doctor promote --storeDir ./follower [--json]
    python -m annotatedvdb_tpu_torch doctor replay-rejects \
        --rejects ./vdb/quarantine/x.vcf.rejects.jsonl --out fixed.vcf

Exit codes (fsck verb): 0 = clean, 1 = warnings / repaired, 2 = errors.
Exit codes (compact verb): 0 = compacted / nothing to do, 1 = pass
aborted cleanly (preempted by another writer's commit or SIGTERM) even
after ``--retries``, 2 = error.
Exit codes (status verb): 0 = report printed, 2 = not a readable store.
Exit codes (promote verb): 0 = promoted, 2 = error.
"""

from __future__ import annotations

import argparse
import json
import signal
import sys

#: the reference's verbs that are not ported yet: none since the health
#: plane's ``flight``, ``slo`` and ``trace`` (every verb dispatches below)
UNPORTED: dict = {}

def _replay(argv) -> int:
    ap = argparse.ArgumentParser(
        prog="doctor replay-rejects",
        description="rebuild a loadable input from a quarantine rejects file",
    )
    ap.add_argument("--rejects", required=True,
                    help="the <input>.rejects.jsonl to replay")
    ap.add_argument("--out", required=True,
                    help="reconstructed input file (load it with the same "
                         "loader CLI that produced the rejects)")
    args = ap.parse_args(argv)
    from annotatedvdb_tpu_torch.utils.quarantine import read_rejects, write_replay

    meta, _records = read_rejects(args.rejects)
    n = write_replay(args.rejects, args.out)
    loader = meta.get("loader", "<the original loader>")
    print(f"{n} quarantined line(s) written to {args.out}; "
          f"load with {loader}", file=sys.stderr)
    return 0


def _status(argv) -> int:
    ap = argparse.ArgumentParser(
        prog="doctor status",
        description="one-screen store health report: segment counts + "
                    "read-amp vs the maintenance watermarks, WAL files "
                    "pending replay, crash debris, disk free vs reserve, "
                    "last ledger compact/flush records",
    )
    ap.add_argument("--storeDir", required=True)
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)
    from annotatedvdb_tpu_torch.store.maintenance import store_status

    try:
        report = store_status(args.storeDir)
    except (OSError, ValueError) as err:
        print(f"doctor status: {type(err).__name__}: {err} "
              "(run `doctor --storeDir ...` for repair)", file=sys.stderr)
        return 2
    if args.json:
        print(json.dumps(report, indent=1))
        return 0
    wm = report["watermarks"]
    ra = report["read_amp"]
    print(f"store {report['store_dir']}: {report['rows']} row(s), "
          f"{len(report['groups'])} chromosome group(s)", file=sys.stderr)
    print(f"  read-amp: max {ra['max']} / mean {ra['mean']} segment "
          f"file(s) per group (watermarks: high {wm['high']}, low "
          f"{wm['low']}, compact floor {wm['min_segments']})",
          file=sys.stderr)
    for label, g in report["groups"].items():
        over = "  << over high watermark" \
            if label in wm["over_high"] else ""
        rows = g["rows"] if g["rows"] is not None else "?"
        print(f"    chr{label}: {g['segments']} segment file(s), "
              f"{rows} row(s){over}", file=sys.stderr)
    mesh = report.get("mesh")
    if mesh:
        per_dev = ", ".join(
            f"dev{d}: {n} group(s) ~{mesh['est_resident_bytes_per_device'].get(d, 0)}B"
            for d, n in mesh["groups_per_device"].items()
        )
        budget = mesh["per_device_budget_bytes"]
        print(f"  mesh: {mesh['devices']} device(s); {per_dev}"
              + (f" vs {budget}B/device budget" if budget else ""),
              file=sys.stderr)
    wal = report["wal"]
    print(f"  wal: {wal['files']} file(s), "
          f"{wal['records_pending_replay']} record(s) pending replay "
          f"({wal['bytes']} bytes) — a serve worker restart replays them",
          file=sys.stderr)
    debris = {k: v for k, v in report["debris"].items() if v}
    print(f"  debris: {debris if debris else 'none'}"
          + (" — `doctor --repair` prunes it" if debris else ""),
          file=sys.stderr)
    disk = report["disk"]
    state = "BREACHED (upserts shed 507)" if disk["breached"] else "ok"
    print(f"  disk: {disk['free_bytes']} free vs "
          f"{disk['reserve_bytes']} reserve — {state}", file=sys.stderr)
    led = report["ledger"]
    print(f"  ledger: {led['runs']} load run(s); last compact: "
          f"{led['last_compact'] or 'never'}; last flush: "
          f"{led['last_flush'] or 'never'}", file=sys.stderr)
    return 0


def _fmt_t(t: float) -> str:
    import time as time_mod

    return time_mod.strftime("%H:%M:%S", time_mod.localtime(t)) \
        + f".{int((t % 1) * 1000):03d}"


def _render_blackbox(meta: dict, events: list, limit: int) -> None:
    """One harvested (or live-ring) black box to stderr: the lifecycle
    timeline leading to death, then the final requests with their stage
    breakdowns."""
    lifecycle = [e for e in events if e.get("type") == "event"]
    requests = [e for e in events if e.get("type") == "request"]
    if meta:
        import time as time_mod

        when = time_mod.strftime(
            "%Y-%m-%d %H:%M:%S", time_mod.localtime(meta.get("t", 0))
        )
        print(f"  worker {meta.get('worker')}: {meta.get('reason')} "
              f"(harvested {when}, {meta.get('events')} event(s))",
              file=sys.stderr)
    print(f"  lifecycle ({len(lifecycle)} event(s)):", file=sys.stderr)
    for e in lifecycle[-limit:]:
        print(f"    {_fmt_t(e['t'])}  {e.get('name', '?'):<10} "
              f"{e.get('detail', '')}", file=sys.stderr)
    print(f"  last requests ({len(requests)} recorded):", file=sys.stderr)
    for e in requests[-limit:]:
        stages = e.get("stages") or {}
        breakdown = " ".join(f"{k}={v}ms" for k, v in stages.items())
        print(f"    {_fmt_t(e['t'])}  {e.get('kind', '?'):<7} "
              f"{e.get('status', 0):<4} {e.get('ms', '?')}ms  "
              f"trace={e.get('trace', '-')}  {breakdown}",
              file=sys.stderr)


def _flight(argv) -> int:
    ap = argparse.ArgumentParser(
        prog="doctor flight",
        description="render the crash flight recorder: a SIGKILLed or "
                    "wedge-killed worker's last requests and lifecycle "
                    "events, harvested by the fleet supervisor into "
                    "<store>/flight/ (live rings decode too)",
    )
    ap.add_argument("--storeDir", required=True)
    ap.add_argument("--all", action="store_true",
                    help="render every harvested black box, not just "
                         "the newest")
    ap.add_argument("--limit", type=int, default=20,
                    help="events/requests shown per box (default 20)")
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)
    import os

    from annotatedvdb_tpu_torch.obs import flight as flight_mod

    if not os.path.isdir(args.storeDir):
        print(f"doctor flight: {args.storeDir}: not a directory",
              file=sys.stderr)
        return 2
    boxes = flight_mod.list_blackboxes(args.storeDir)
    harvested = boxes["harvested"] if args.all else boxes["harvested"][:1]
    out = {"store_dir": args.storeDir, "harvested": [], "rings": []}
    for path in harvested:
        try:
            data = flight_mod.load_harvest(path)
        except (OSError, ValueError) as err:
            print(f"doctor flight: {path}: unreadable ({err})",
                  file=sys.stderr)
            continue
        out["harvested"].append({"path": path, **data})
    for path in boxes["rings"]:
        try:
            decoded = flight_mod.decode_ring(path)
        except (OSError, ValueError):
            continue  # a live writer's ring mid-create: skip
        out["rings"].append({"path": path, "events": decoded["events"]})
    if not out["harvested"] and not out["rings"]:
        print(f"doctor flight: {args.storeDir}: no flight data (no "
              "harvested black box under flight/, no live rings) — the "
              "serve fleet records one when AVDB_FLIGHT_EVENTS > 0",
              file=sys.stderr)
        return 2
    if args.json:
        print(json.dumps(out, indent=1))
        return 0
    print(f"flight: {args.storeDir}: "
          f"{len(boxes['harvested'])} harvested black box(es), "
          f"{len(out['rings'])} live ring(s)", file=sys.stderr)
    for box in out["harvested"]:
        print(f"== {box['path']}", file=sys.stderr)
        _render_blackbox(box["meta"], box["events"], args.limit)
    if not out["harvested"]:
        # no harvest (single-process SIGKILL, or the supervisor died
        # too): the live rings ARE the black box — decode them directly
        for ring in out["rings"]:
            print(f"== {ring['path']} (live ring)", file=sys.stderr)
            _render_blackbox({}, ring["events"], args.limit)
    return 0


def _slo(argv) -> int:
    ap = argparse.ArgumentParser(
        prog="doctor slo",
        description="replay the SLO burn-rate state machine over metrics "
                    "time-series history under <store>/history/ — "
                    "harvested from dead workers by the fleet supervisor, "
                    "or persisted live by the serving health plane — and "
                    "report what fired, when, and how hot the error "
                    "budget burned",
    )
    ap.add_argument("--storeDir", required=True)
    ap.add_argument("--all", action="store_true",
                    help="replay every harvested history file, not just "
                         "the newest (live mirrors always replay)")
    ap.add_argument("--fast", type=float, default=None, metavar="S",
                    help="fast burn window seconds (default: "
                         "AVDB_SLO_FAST_S or 60)")
    ap.add_argument("--slow", type=float, default=None, metavar="S",
                    help="slow burn window seconds (default: "
                         "AVDB_SLO_SLOW_S or 300)")
    ap.add_argument("--burn", type=float, default=None, metavar="X",
                    help="burn-rate threshold both windows must exceed "
                         "(default: AVDB_SLO_BURN or 2.0)")
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)
    import os

    from annotatedvdb_tpu_torch.obs import timeseries
    from annotatedvdb_tpu_torch.obs.slo import replay_history

    if not os.path.isdir(args.storeDir):
        print(f"doctor slo: {args.storeDir}: not a directory",
              file=sys.stderr)
        return 2
    files = timeseries.list_history(args.storeDir)
    paths = (files["harvested"] if args.all else files["harvested"][:1]) \
        + files["live"]
    out = {"store_dir": args.storeDir, "replays": []}
    for path in paths:
        try:
            doc = timeseries.load_history(path)
            replay = replay_history(
                doc.get("samples") or [], fast_s=args.fast,
                slow_s=args.slow, burn_threshold=args.burn,
            )
        except (OSError, ValueError) as err:
            print(f"doctor slo: {path}: cannot replay ({err})",
                  file=sys.stderr)
            continue
        out["replays"].append({
            "path": path,
            "worker": doc.get("worker"),
            "harvested": doc.get("harvested"),
            **replay,
        })
    if not out["replays"]:
        print(f"doctor slo: {args.storeDir}: no time-series history (no "
              "harvested files or live mirrors under history/) — serve "
              "workers record one while AVDB_OBS_TICK_S and "
              "AVDB_OBS_HISTORY_S are > 0", file=sys.stderr)
        return 2
    if args.json:
        print(json.dumps(out, indent=1))
        return 0
    print(f"slo: {args.storeDir}: {len(out['replays'])} history "
          f"replay(s)", file=sys.stderr)
    for rep in out["replays"]:
        h = rep.get("harvested") or {}
        why = f" — harvested: {h.get('reason')}" if h else " (live mirror)"
        print(f"== {rep['path']}{why}", file=sys.stderr)
        print(f"  worker {rep['worker']}: {rep['ticks']} tick(s) over "
              f"{rep['span_s']}s", file=sys.stderr)
        for a in rep["alerts"]:
            mb = rep["max_burn"].get(a["slo"])
            print(f"    {a['slo']:<16} {a['state']:<9} max burn "
                  f"{mb if mb is not None else '-'} "
                  f"(fired {a['fired_total']} time(s))", file=sys.stderr)
        for ep in rep["episodes"]:
            print(f"    {_fmt_t(ep['t'])}  {ep['slo']}: {ep['from']} -> "
                  f"{ep['to']} (burn fast={ep['burn_fast']} "
                  f"slow={ep['burn_slow']})", file=sys.stderr)
    return 0


def _trace(argv) -> int:
    ap = argparse.ArgumentParser(
        prog="doctor trace",
        description="merge the store's background-writer history (ledger "
                    "run/compact/flush records) and the flight "
                    "recorder's request/lifecycle timeline into ONE "
                    "Chrome trace-event JSON — open it in Perfetto to "
                    "see what the daemon was doing while p99 moved",
    )
    ap.add_argument("--storeDir", required=True)
    ap.add_argument("--out", default=None, metavar="FILE",
                    help="write the trace JSON here (default: stdout)")
    args = ap.parse_args(argv)
    import os

    from annotatedvdb_tpu_torch.obs import flight as flight_mod

    lpath = os.path.join(args.storeDir, "ledger.jsonl")
    if not os.path.isdir(args.storeDir):
        print(f"doctor trace: {args.storeDir}: not a directory",
              file=sys.stderr)
        return 2
    events: list[dict] = [
        {"ph": "M", "name": "process_name", "pid": 1, "tid": 0, "ts": 0,
         "args": {"name": "avdb-store"}},
        {"ph": "M", "name": "thread_name", "pid": 1, "tid": 1, "ts": 0,
         "args": {"name": "background (ledger)"}},
    ]
    times: list[float] = []

    def emit(t: float, dur_s: float, name: str, tid: int, **extra):
        times.append(t)
        ev = {"ph": "X", "name": name, "pid": 1, "tid": tid,
              "ts": t * 1e6, "dur": max(dur_s, 0.0) * 1e6}
        if extra:
            ev["args"] = extra
        events.append(ev)

    if os.path.exists(lpath):
        from annotatedvdb_tpu_torch.store.ledger import AlgorithmLedger

        ledger = AlgorithmLedger(lpath, log=lambda m: None)
        for rec in ledger.records():
            kind = rec.get("type")
            if kind not in ("run", "compact", "flush"):
                continue
            ts = float(rec.get("ts") or 0.0)
            dur = float(rec.get("seconds") or 0.0)
            # ledger stamps at APPEND time (the end): shift back by the
            # recorded duration so the span covers the work
            emit(ts - dur, dur, f"ledger.{kind}", 1,
                 **{k: rec[k] for k in ("labels", "rows", "status")
                    if k in rec})
    boxes = flight_mod.list_blackboxes(args.storeDir)
    tid = 2
    for path in boxes["harvested"] + boxes["rings"]:
        try:
            if path.endswith(".jsonl"):
                data = flight_mod.load_harvest(path)
                evs, label = data["events"], os.path.basename(path)
            else:
                evs = flight_mod.decode_ring(path)["events"]
                label = os.path.basename(path) + " (live)"
        except (OSError, ValueError):
            continue
        events.append({
            "ph": "M", "name": "thread_name", "pid": 1, "tid": tid,
            "ts": 0, "args": {"name": f"flight {label}"},
        })
        for e in evs:
            t = float(e.get("t") or 0.0)
            if e.get("type") == "request":
                dur = float(e.get("ms") or 0.0) / 1000.0
                emit(t - dur, dur, e.get("kind", "request"), tid,
                     trace_id=e.get("trace"), status=e.get("status"))
            else:
                times.append(t)
                events.append({
                    "ph": "i", "name": e.get("name", "event"), "pid": 1,
                    "tid": tid, "ts": t * 1e6, "s": "t",
                    "args": {"detail": e.get("detail", "")},
                })
        tid += 1
    if not times:
        print(f"doctor trace: {args.storeDir}: nothing to render (no "
              "ledger records, no flight data)", file=sys.stderr)
        return 2
    # rebase to the earliest event so Perfetto opens at t=0
    base = min(times) * 1e6
    for ev in events:
        if ev.get("ph") != "M":
            ev["ts"] = round(ev["ts"] - base, 1)
    doc = json.dumps(
        {"traceEvents": events, "displayTimeUnit": "ms"}
    )
    if args.out:
        with open(args.out, "w") as f:
            f.write(doc)
        print(f"doctor trace: wrote {len(events)} event(s) to {args.out}",
              file=sys.stderr)
    else:
        print(doc)
    return 0


def _profile(argv) -> int:
    ap = argparse.ArgumentParser(
        prog="doctor profile",
        description="whole-store offline analytics profile: per-chromosome "
                    "row counts, cohort-max allele-frequency spectrum, "
                    "CADD-phred distribution (histogram + quantiles), "
                    "consequence-rank rollup, and read-amplification — "
                    "the same summary shapes POST /stats/region serves, "
                    "over the same first-wins-deduplicated row view "
                    "(shadowed duplicates never double-count), computed "
                    "chunk-by-chunk so a spill-tier store never "
                    "materializes more than one chunk of decoded features",
    )
    ap.add_argument("--storeDir", required=True)
    ap.add_argument("--out", default=None, metavar="FILE",
                    help="write the JSON report here (default: stdout)")
    ap.add_argument("--chunkRows", type=int, default=262_144, metavar="N",
                    help="rows decoded per pipeline chunk (default 262144 "
                         "— the unit of peak feature memory)")
    ap.add_argument("--json", action="store_true",
                    help="print the report as JSON on stdout too when "
                         "--out is given (without --out the report "
                         "always prints to stdout)")
    args = ap.parse_args(argv)
    import json as json_mod
    import os
    import time as time_mod

    import numpy as np

    from annotatedvdb_tpu_torch.ops import stats as stats_ops
    from annotatedvdb_tpu_torch.serve.engine import IntervalIndex
    from annotatedvdb_tpu_torch.store import VariantStore
    from annotatedvdb_tpu_torch.store.compact import _normalize_groups
    from annotatedvdb_tpu_torch.types import chromosome_label
    from annotatedvdb_tpu_torch.utils.pipeline import BoundedStage

    t0 = time_mod.perf_counter()
    try:
        store = VariantStore.load(args.storeDir, readonly=True)
        with open(os.path.join(args.storeDir, "manifest.json")) as f:
            manifest = json_mod.load(f)
    except (OSError, ValueError) as err:
        print(f"doctor profile: {type(err).__name__}: {err} "
              "(run `doctor --storeDir ...` for repair)", file=sys.stderr)
        return 2
    disk_groups = {
        label: sum(len(g) for g in glist)
        for label, glist in _normalize_groups(manifest).items()
    }
    chunk_rows = max(int(args.chunkRows), 1)

    def chunks():
        # each shard profiles through the SAME first-wins-deduplicated
        # view the serving interval index gives /stats/region — a row
        # shadowed across segments (a live upsert superseded by dedup)
        # must not double-count here and vanish there
        for code in sorted(store.shards):
            shard = store.shards[code]
            index = IntervalIndex.build(shard)
            for lo in range(0, index.n, chunk_rows):
                yield code, shard, index, lo, min(lo + chunk_rows, index.n)

    def decode(item):
        """One chunk's sidecar decode -> fixed-point feature arrays (the
        CPU-heavy half, run on the stage thread so it overlaps the
        consumer's accumulation — the loaders' overlapped-executor
        shape)."""
        code, shard, index, lo, hi = item
        n = hi - lo
        af = np.full(n, stats_ops.STATS_MISSING, np.int32)
        cadd = np.full(n, stats_ops.STATS_MISSING, np.int32)
        rank = np.full(n, stats_ops.STATS_MISSING, np.int32)
        # hoist the three object columns once per segment (the rows of a
        # chunk cluster by segment in index order) — per-row dict
        # lookups roughly double an already Python-bound decode
        cols_by_seg: dict[int, tuple] = {}
        for k in range(n):
            s = int(index.si[lo + k])
            cols = cols_by_seg.get(s)
            if cols is None:
                seg = shard.segments[s]
                cols = cols_by_seg[s] = (
                    seg.obj["cadd_scores"],
                    seg.obj["allele_frequencies"],
                    seg.obj["adsp_most_severe_consequence"],
                )
            cadd_col, af_col, ms_col = cols
            j = int(index.jj[lo + k])
            _cf, _rf, afp, cfp, ri = stats_ops.feature_values(
                cadd_col[j] if cadd_col is not None else None,
                af_col[j] if af_col is not None else None,
                ms_col[j] if ms_col is not None else None,
            )
            af[k] = afp
            cadd[k] = cfp
            rank[k] = ri
        return code, n, af, cadd, rank

    n_af_bins = len(stats_ops.AF_EDGES_FP) - 1
    n_cadd_bins = len(stats_ops.CADD_EDGES_FP) - 1
    acc: dict[int, dict] = {}
    stage = BoundedStage(chunks(), fn=decode, depth=2, name="profile.decode")
    try:
        for code, n, af, cadd, rank in stage:
            a = acc.get(code)
            if a is None:
                a = acc[code] = {
                    "rows": 0, "af_sum": 0, "cadd_sum": 0,
                    "af_hist": np.zeros(n_af_bins, np.int64),
                    "cadd_hist": np.zeros(n_cadd_bins, np.int64),
                    "ranks": np.zeros(stats_ops.RANK_BUCKETS, np.int64),
                }
            a["rows"] += n
            _p, s, hist = stats_ops.column_totals(
                af, stats_ops.AF_EDGES_FP
            )
            a["af_sum"] += s
            a["af_hist"] += hist
            _p, s, hist = stats_ops.column_totals(
                cadd, stats_ops.CADD_EDGES_FP
            )
            a["cadd_sum"] += s
            a["cadd_hist"] += hist
            a["ranks"] += stats_ops.rank_totals(rank)
    finally:
        stage.close()
    if stage.error is not None:
        print(f"doctor profile: decode failed: {stage.error}",
              file=sys.stderr)
        return 2

    groups = {}
    totals = {
        "rows": 0, "af_sum": 0, "cadd_sum": 0,
        "af_hist": np.zeros(n_af_bins, np.int64),
        "cadd_hist": np.zeros(n_cadd_bins, np.int64),
        "ranks": np.zeros(stats_ops.RANK_BUCKETS, np.int64),
    }
    for code in sorted(acc):
        a = acc[code]
        label = chromosome_label(code)
        segments = disk_groups.get(label, 0)
        groups[label] = {
            "segments": segments,
            "read_amp": segments,
            **stats_ops.summary_from_totals(
                a["rows"], a["af_sum"], a["af_hist"],
                a["cadd_sum"], a["cadd_hist"], a["ranks"],
            ),
        }
        for k in ("rows", "af_sum", "cadd_sum"):
            totals[k] += a[k]
        for k in ("af_hist", "cadd_hist", "ranks"):
            totals[k] += a[k]
    report = {
        "store_dir": args.storeDir,
        "rows": store.n,
        "chunk_rows": chunk_rows,
        "bins": stats_ops.edges_payload(),
        "groups": groups,
        "totals": stats_ops.summary_from_totals(
            totals["rows"], totals["af_sum"], totals["af_hist"],
            totals["cadd_sum"], totals["cadd_hist"], totals["ranks"],
        ),
        "read_amp": {
            "max": max(disk_groups.values(), default=0),
            "mean": round(
                sum(disk_groups.values()) / len(disk_groups), 2
            ) if disk_groups else 0.0,
        },
        "seconds": round(time_mod.perf_counter() - t0, 3),
    }
    doc = json_mod.dumps(report, indent=1)
    if args.out:
        with open(args.out, "w") as f:
            f.write(doc)
        print(f"doctor profile: wrote {args.out} ({store.n} row(s), "
              f"{len(groups)} group(s), {report['seconds']}s)",
              file=sys.stderr)
    if args.json or not args.out:
        print(doc)
    return 0


def _promote(argv) -> int:
    ap = argparse.ArgumentParser(
        prog="doctor promote",
        description="fail a replication follower over to leader: seal the "
                    "tailed WAL prefix by replaying it into segments, bump "
                    "the manifest's fencing epoch (so the deposed leader's "
                    "next flush aborts instead of committing), and clear "
                    "the follower's bootstrap cursor — after exit 0 the "
                    "store serves writable (`serve --upserts`) and the old "
                    "leader is fenced out",
    )
    ap.add_argument("--storeDir", required=True)
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)
    from annotatedvdb_tpu_torch.store.replication import ReplError, promote

    log = (lambda m: None) if args.json else (
        lambda m: print(m, file=sys.stderr)
    )
    try:
        report = promote(args.storeDir, log=log)
    except (ReplError, OSError, ValueError) as err:
        print(f"doctor promote: {type(err).__name__}: {err} "
              "(store unchanged up to the failed step; re-run after "
              "`doctor --storeDir ...`)", file=sys.stderr)
        return 2
    if args.json:
        print(json.dumps(report, indent=1))
    else:
        print(f"doctor promote: {args.storeDir}: {report['status']} at "
              f"fencing epoch {report['epoch']} ({report['rows']} tailed "
              f"row(s) sealed into segments) — start `serve --upserts` "
              f"here; the deposed leader's flushes now abort as fenced",
              file=sys.stderr)
    return 0


def _compact(argv) -> int:
    ap = argparse.ArgumentParser(
        prog="doctor compact",
        description="merge a store's checkpoint segments into one "
                    "position-sorted, deduplicated columnar segment per "
                    "chromosome (crash-safe; online — safe under a live "
                    "serve fleet)",
    )
    ap.add_argument("--storeDir", required=True)
    ap.add_argument("--dry-run", action="store_true", dest="dry_run",
                    help="print the plan (groups, segment counts, bytes) "
                         "without touching the store")
    ap.add_argument("--maxBytes", type=int, default=None, metavar="N",
                    help="cap the pass: compact groups smallest-first "
                         "until the next would push input bytes over N")
    ap.add_argument("--group", action="append", default=None, metavar="L",
                    help="chromosome label to compact (repeatable; "
                         "'8' or 'chr8'; default: every eligible group)")
    ap.add_argument("--chunkRows", type=int, default=None, metavar="N",
                    help="rows per streamed merge chunk (default "
                         "AVDB_COMPACT_CHUNK_ROWS or 262144)")
    ap.add_argument("--retries", type=int, default=0, metavar="N",
                    help="re-run a CLEANLY-preempted pass up to N times "
                         "with backoff (the shared preemption-retry "
                         "policy; default 0 — hard failures never retry)")
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)
    from annotatedvdb_tpu_torch.store.compact import (
        CompactionError,
        compact_store,
        plan_compaction,
    )

    log = (lambda m: None) if args.json else (
        lambda m: print(m, file=sys.stderr)
    )
    if args.dry_run:
        try:
            plan = plan_compaction(args.storeDir, groups=args.group,
                                   max_bytes=args.maxBytes)
        except CompactionError as err:
            print(f"doctor compact: {err}", file=sys.stderr)
            return 2
        if args.json:
            print(json.dumps(plan, indent=1))
        else:
            print(f"compact plan for {args.storeDir}:", file=sys.stderr)
            for e in plan["eligible"]:
                print(f"  chr{e['label']}: {e['stems']} segment file "
                      f"pair(s) in {e['groups']} group(s), "
                      f"{e['bytes_before']} bytes -> <= "
                      f"{e['est_bytes_after']} bytes "
                      f"(gain: {e['stems'] - 1} fewer file pairs"
                      + (f", {e['rows']} rows" if e["rows"] is not None
                         else "") + ")",
                      file=sys.stderr)
            for e in plan["skipped"]:
                print(f"  chr{e['label']}: skipped — {e['reason']}",
                      file=sys.stderr)
            print(f"  total: {len(plan['eligible'])} group(s), "
                  f"{plan['total_files_before']} file pair(s), "
                  f"{plan['total_bytes_before']} bytes",
                  file=sys.stderr)
        return 0

    # cooperative shutdown: SIGTERM flips the cancel flag, the pass aborts
    # cleanly between chunks (temps removed, store untouched)
    cancelled = {"flag": False}
    previous = signal.getsignal(signal.SIGTERM)

    def _on_term(_signum, _frame):
        cancelled["flag"] = True

    try:
        signal.signal(signal.SIGTERM, _on_term)
    except ValueError:  # non-main thread (tests): keep the default
        previous = None
    # announced AFTER the handler is live: supervisors (and the SIGTERM
    # regression test) key on this line before signaling
    log(f"doctor compact: {args.storeDir}: pass starting "
        "(SIGTERM aborts cleanly)")
    from annotatedvdb_tpu_torch.utils.retry import retry_preempted

    try:
        report = retry_preempted(
            lambda: compact_store(
                args.storeDir, groups=args.group, max_bytes=args.maxBytes,
                chunk_rows=args.chunkRows,
                cancel=lambda: cancelled["flag"], log=log,
            ),
            retries=max(args.retries, 0),
            cancel=lambda: cancelled["flag"],  # SIGTERM: never retried
            log=log, what="doctor compact pass",
        )
    except (CompactionError, OSError, ValueError) as err:
        # hard failures (bad manifest, ENOSPC mid-merge, a source segment
        # failing its integrity check — StoreCorruptError is a ValueError)
        # are the documented exit 2, never the benign "aborted cleanly" 1
        print(f"doctor compact: {type(err).__name__}: {err}",
              file=sys.stderr)
        return 2
    finally:
        if previous is not None:
            signal.signal(signal.SIGTERM, previous)
    if args.json:
        print(json.dumps(report, indent=1))
    else:
        print(f"doctor compact: {args.storeDir}: {report['status']}"
              + (f" ({report.get('reason')})"
                 if report["status"] != "compacted" else ""),
              file=sys.stderr)
    return 1 if report["status"] == "aborted" else 0


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "replay-rejects":
        return _replay(argv[1:])
    if argv and argv[0] == "compact":
        return _compact(argv[1:])
    if argv and argv[0] == "promote":
        return _promote(argv[1:])
    if argv and argv[0] == "status":
        return _status(argv[1:])
    if argv and argv[0] == "profile":
        return _profile(argv[1:])
    if argv and argv[0] == "flight":
        return _flight(argv[1:])
    if argv and argv[0] == "trace":
        return _trace(argv[1:])
    if argv and argv[0] == "slo":
        return _slo(argv[1:])

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--storeDir", required=True)
    ap.add_argument("--deep", action="store_true",
                    help="crc32-verify every segment file")
    ap.add_argument("--repair", action="store_true",
                    help="prune orphans, heal the ledger, roll damaged "
                         "backing groups back")
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)

    from annotatedvdb_tpu_torch.store.fsck import fsck

    report = fsck(
        args.storeDir, deep=args.deep, repair=args.repair,
        log=(lambda m: None) if args.json else
            (lambda m: print(m, file=sys.stderr)),
    )
    if args.json:
        print(json.dumps(report, indent=1))
    else:
        print(f"doctor: {args.storeDir}: {report['status']}", file=sys.stderr)
    return report["exit_code"]


if __name__ == "__main__":
    raise SystemExit(main())
