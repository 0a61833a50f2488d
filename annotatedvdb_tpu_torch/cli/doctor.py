"""CLI: store health — fsck/repair, online compaction, status, profile,
fail-over, replay.

Port of ``annotatedvdb_tpu/cli/doctor.py`` for six verbs.  ``doctor``
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
shapes ``POST /stats/region`` serves; ``doctor promote`` fails a
replication follower over to leader
(:func:`annotatedvdb_tpu_torch.store.replication.promote`); ``doctor
replay-rejects`` reconstructs a loadable input file from a quarantine
rejects file.  Reports, exit codes and output files are the reference's.

``doctor`` is host only, as in the reference, and takes no
``--platform``: ``status`` and ``compact --dry-run`` read no segment, and
fsck, ``compact``, ``promote`` and ``profile`` read the store on the host.
The verbs ``flight``, ``trace`` and ``slo`` are not ported yet and exit 2.

Usage:
    python -m annotatedvdb_tpu_torch doctor --storeDir ./vdb [--deep] [--repair] [--json]
    python -m annotatedvdb_tpu_torch doctor compact --storeDir ./vdb \
        [--dry-run] [--maxBytes N] [--group 8 ...] [--chunkRows N] \
        [--retries N] [--json]
    python -m annotatedvdb_tpu_torch doctor status --storeDir ./vdb [--json]
    python -m annotatedvdb_tpu_torch doctor profile --storeDir ./vdb \
        [--out report.json] [--chunkRows N]
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

#: the reference's verbs that are not ported yet, with what they do
UNPORTED = {
    "flight": "the crash flight recorder",
    "trace": "the background-writer trace",
    "slo": "the SLO burn-rate replay",
}


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
    if argv and argv[0] in UNPORTED:
        print(f"doctor {argv[0]} ({UNPORTED[argv[0]]}) is not yet ported "
              "to annotatedvdb_tpu_torch", file=sys.stderr)
        return 2

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
