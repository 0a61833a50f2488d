"""CLI: stream the store out as a tokenized training corpus.

Port of ``annotatedvdb_tpu/cli/export_corpus.py`` (``export``), with the
same flags (``--platform``: ``cuda`` by default, an error when no card is
present, ``cpu`` on request).  A chromosome (``--chromosome``), a
``--region`` slice or the whole store leaves as fixed-shape token and
feature batches (``export/core.py``; one ``export_pack`` launch a part on
the card), shuffled by ``--seed`` (same seed, byte-identical corpus), and
committed as ``part-<n>.npz`` files and a manifest.  ``--hostOnly`` packs
on the numpy twin and resolves no device.

The default is a dry run (plan and summary, nothing written) unless
``--commit`` is passed; ``--test`` stops after one part (the manifest
records ``complete: false``); ``--resume`` continues a killed export after
its last ledger-committed part, whichever package wrote the records.  The
summary JSON (sorted keys) is the last line of stdout.  As in the
reference, the export runs in an ``ObsSession``: one ``type: "run"``
ledger record on completion or abort, ``--metricsOut`` and ``--traceOut``.
``--logAfter``, ``--maxErrors``, ``--maxWorkers`` (validated: auto, off
or a count) and ``--noMultihost`` are accepted and unused, as in the
reference: the export resolves no mesh.

Usage:
    python -m annotatedvdb_tpu_torch export --storeDir ./vdb --out ./corpus \\
        [--chromosome 19 | --region chr19:1000-50000] [--commit] \\
        [--seed 7] [--ordered] [--resume] [--hostOnly] [--platform cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from annotatedvdb_tpu_torch.obs.session import add_obs_args
from annotatedvdb_tpu_torch.runtime import PLATFORMS


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="export the store as a tokenized training corpus "
                    "(PyTorch/CUDA)")
    ap.add_argument("--storeDir", required=True, help="variant store directory")
    ap.add_argument("--out", required=True,
                    help="corpus output directory (created if missing)")
    ap.add_argument("--chromosome", default=None,
                    help="export one chromosome (default: whole store)")
    ap.add_argument("--region", default=None, metavar="CHR:START-END",
                    help="export one region slice ([chr]N:start-end)")
    ap.add_argument("--seed", type=int, default=None,
                    help="corpus shuffle seed (default "
                         "AVDB_EXPORT_SHUFFLE_SEED; same seed => "
                         "byte-identical corpus)")
    ap.add_argument("--ordered", action="store_true",
                    help="emit batches in plan order (no shuffle)")
    ap.add_argument("--resume", action="store_true",
                    help="continue after the last ledger-committed part")
    ap.add_argument("--hostOnly", action="store_true",
                    help="pack on the byte-identical numpy twin (no device)")
    ap.add_argument("--batchRows", type=int, default=None,
                    help="rows per fixed-shape batch (default "
                         "AVDB_EXPORT_BATCH_ROWS)")
    ap.add_argument("--partBytes", default=None, metavar="BYTES",
                    help="target part size, e.g. 8m (default "
                         "AVDB_EXPORT_PART_BYTES)")
    ap.add_argument("--commit", action="store_true",
                    help="write the corpus (default: dry run)")
    ap.add_argument("--test", action="store_true", help="stop after one part")
    ap.add_argument("--logAfter", type=int, default=None,
                    help="accepted for compatibility; the export logs per "
                         "part")
    ap.add_argument("--logFilePath", default=None,
                    help="log file (default: <out>-export.log)")
    ap.add_argument("--maxErrors", type=int, default=-1, metavar="N",
                    help="accepted for compatibility; the export rejects "
                         "no rows")
    ap.add_argument("--platform", default="cuda", choices=PLATFORMS,
                    help="device: cuda (default; an error when no card is "
                         "present) or cpu")
    ap.add_argument("--maxWorkers", default="auto",
                    help="devices to fan out across: auto/off/count")
    ap.add_argument("--noMultihost", action="store_true",
                    help="ignore multi-host environment settings")
    add_obs_args(ap)
    return ap


def main(argv=None) -> int:
    ap = _parser()
    args = ap.parse_args(argv)
    if args.chromosome and args.region:
        ap.error("--chromosome and --region are mutually exclusive")
    from annotatedvdb_tpu_torch.runtime import validate_max_workers

    try:
        validate_max_workers(args.maxWorkers)
    except ValueError as err:
        ap.error(str(err))

    from annotatedvdb_tpu_torch.export.core import run_export
    from annotatedvdb_tpu_torch.obs import ObsSession
    from annotatedvdb_tpu_torch.runtime import resolve_device
    from annotatedvdb_tpu_torch.store import AlgorithmLedger, VariantStore
    from annotatedvdb_tpu_torch.utils.logging import load_logger

    device = None if args.hostOnly else resolve_device(args.platform)
    if not os.path.exists(os.path.join(args.storeDir, "manifest.json")):
        raise FileNotFoundError(f"no store at {args.storeDir}")
    store = VariantStore.load(args.storeDir, readonly=True)
    ledger = AlgorithmLedger(os.path.join(args.storeDir, "ledger.jsonl"))
    log, _logger, log_path = load_logger(args.out, "export", args.logFilePath)
    log(f"export {args.storeDir} -> {args.out} "
        f"(commit={args.commit}, log={log_path})")
    obs = ObsSession.from_args("export", args, {
        "store": args.storeDir, "out": args.out,
        "commit": args.commit, "test": args.test, "resume": args.resume,
        "chromosome": args.chromosome, "region": args.region,
        "seed": args.seed, "ordered": args.ordered,
        "host_only": args.hostOnly,
    })
    # the run ledger must witness every abort, not just clean exits
    try:
        summary = run_export(
            store, ledger, args.storeDir, args.out,
            chromosome=args.chromosome, region=args.region,
            batch_rows=args.batchRows, part_bytes=args.partBytes,
            seed=args.seed, ordered=args.ordered, resume=args.resume,
            commit=args.commit, host_only=args.hostOnly,
            max_parts=1 if args.test else None, log=log, device=device,
        )
    except BaseException as exc:
        obs.abort(ledger, exc, store=store)
        raise
    if args.commit:
        log(f"COMMITTED {summary['parts_written']} part(s), "
            f"{summary['rows']} rows, {summary['tokens']} tokens")
    else:
        log("DRY RUN (pass --commit to write): "
            f"{summary['n_parts']} part(s), {summary['total_rows']} rows "
            "planned")
    obs.finish(ledger, summary, store=store)
    print(json.dumps(summary, sort_keys=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
