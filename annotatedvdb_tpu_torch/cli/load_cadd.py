"""CLI: update CADD scores for stored variants.

Port of ``annotatedvdb_tpu/cli/load_cadd.py`` (the reference's
``Load/bin/load_cadd_scores.py``), with the same flags plus ``--platform``
(``cuda`` by default, an error when no card is present, ``cpu`` on
request).  Whole-store mode joins every chromosome shard against the CADD
tables in ``--databaseDir``; ``--fileName`` restricts the update to the
variants of one VCF (``load_cadd_scores.py:180-257``), through indexed
seeks when ``--buildIndex`` has written the tables' block-offset indexes.
The default is a dry run; ``--commit`` mutates the store.  The counters
(JSON) and then the algorithm-invocation id are printed on exit, so a
wrapper can undo.  As in the reference, the update runs in an
``ObsSession``: one ``type: "run"`` ledger record on completion or abort,
``--metricsOut`` and ``--traceOut``.  ``--maxWorkers`` (auto, off or a
count) resolves the table rows across this process's device pool (see
``load-vcf``); the store's bytes do not depend on it.

Usage:
    python -m annotatedvdb_tpu_torch load-cadd --databaseDir /cadd \\
        --storeDir ./vdb [--chr 22 | --chr autosome] [--fileName x.vcf.gz] \\
        [--buildIndex] [--commit] [--test] [--platform cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from annotatedvdb_tpu_torch.obs.session import add_obs_args
from annotatedvdb_tpu_torch.runtime import PLATFORMS

# chromosome set shorthands of the reference's load scripts
# (load_vep_result.py:306-309)
CHR_SETS = {
    "all": [str(c) for c in range(1, 23)] + ["X", "Y", "M"],
    "allNoM": [str(c) for c in range(1, 23)] + ["X", "Y"],
    "autosome": [str(c) for c in range(1, 23)],
}


def parse_chromosomes(spec: str | None) -> list | None:
    if spec is None:
        return None
    if spec in CHR_SETS:
        return CHR_SETS[spec]
    return [c.strip() for c in spec.split(",") if c.strip()]


def vcf_subsets(updater, path: str) -> dict[int, np.ndarray]:
    """Map a VCF's variants to shard row indices (the --fileName
    restriction).

    Compacts the store first: the join pass operates on compacted shards,
    and compaction renumbers global row ids — ids gathered here must
    already be post-compaction (``update_all`` rejects subsets on
    uncompacted shards).  Chunks without the tokenizer's hash are hashed by
    the device step on the updater's device."""
    from annotatedvdb_tpu_torch.io.vcf import VcfBatchReader
    from annotatedvdb_tpu_torch.loaders.lookup import chunk_lookup

    updater.store.compact()
    hits: dict[int, list] = {}
    for chunk in VcfBatchReader(path, width=updater.store.width,
                                pack_alleles=False):
        for code, shard, _sel, found, idx in chunk_lookup(
                updater.store, chunk, device=updater.device):
            if shard is None:
                continue
            hits.setdefault(code, []).extend(idx[found].tolist())
    return {c: np.unique(np.array(v, dtype=np.int64)) for c, v in hits.items() if v}


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="update CADD scores for stored variants (PyTorch/CUDA)")
    ap.add_argument("--databaseDir", required=True,
                    help="directory holding the CADD score tables")
    ap.add_argument("--storeDir", required=True)
    ap.add_argument("--fileName", help="restrict update to this VCF's variants")
    ap.add_argument("--chr", dest="chromosomes",
                    help="chromosome, comma list, or all/allNoM/autosome")
    ap.add_argument("--updateExisting", action="store_true",
                    help="re-score variants that already have cadd_scores")
    ap.add_argument("--buildIndex", action="store_true",
                    help="build block-offset sidecar indexes for the score "
                         "tables (enables --fileName random-access joins) "
                         "and exit")
    ap.add_argument("--randomAccess", action=argparse.BooleanOptionalAction,
                    default=None,
                    help="join subsets via indexed seeks (default: auto when "
                         "--fileName is given and indexes exist)")
    ap.add_argument("--commit", action="store_true",
                    help="persist the load (default: dry run)")
    ap.add_argument("--test", action="store_true",
                    help="stop after one batch")
    ap.add_argument("--logAfter", type=int, default=None,
                    help="log counters every N score-table rows "
                         "(default: 4,194,304; 0 disables)")
    ap.add_argument("--logFilePath", default=None,
                    help="log file (default: beside the input)")
    ap.add_argument("--maxErrors", type=int, default=-1, metavar="N",
                    help="abort once more than N score rows have been "
                         "rejected to <store>/quarantine/; default -1 = "
                         "tolerate and quarantine all")
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
    from annotatedvdb_tpu_torch.io.cadd import (
        CADD_INDEL_FILE,
        CADD_SNV_FILE,
        CaddIndex,
    )
    from annotatedvdb_tpu_torch.loaders.cadd_loader import CaddUpdater
    from annotatedvdb_tpu_torch.obs import ObsSession
    from annotatedvdb_tpu_torch.runtime import (
        apply_runtime,
        resolve_device,
        validate_max_workers,
    )
    from annotatedvdb_tpu_torch.store import AlgorithmLedger, VariantStore
    from annotatedvdb_tpu_torch.utils.logging import load_logger
    from annotatedvdb_tpu_torch.utils.quarantine import (
        ErrorBudget,
        QuarantineSink,
    )

    ap = _parser()
    args = ap.parse_args(argv)
    try:
        validate_max_workers(args.maxWorkers)
    except ValueError as err:
        ap.error(str(err))

    if args.buildIndex:
        # host only: no device is resolved for an index build
        for fname in (CADD_SNV_FILE, CADD_INDEL_FILE):
            path = os.path.join(args.databaseDir, fname)
            if os.path.exists(path):
                index = CaddIndex.build(path)
                print(f"{path}: {index.pos.size} seek points")
            else:
                print(f"{path}: absent, skipped")
        return 0

    # after the host-only --buildIndex branch, which must not block on a
    # world's rendezvous
    mesh = apply_runtime(args.platform, args.maxWorkers,
                         multihost=not args.noMultihost)
    device = resolve_device(args.platform)
    log, _logger, _log_path = load_logger(
        args.fileName or os.path.join(args.storeDir, "store"), "load-cadd",
        args.logFilePath,
    )
    store = VariantStore.load(args.storeDir)
    ledger = AlgorithmLedger(os.path.join(args.storeDir, "ledger.jsonl"))
    # rejects come from the SCORE TABLES (not --fileName): one sink named
    # for them, both tables attributed via the reject reason
    quarantine = QuarantineSink(
        args.storeDir, os.path.join(args.databaseDir, "cadd-scores"),
        "load-cadd", budget=ErrorBudget(args.maxErrors), log=log,
    )
    updater = CaddUpdater(
        store, ledger, args.databaseDir,
        skip_existing=not args.updateExisting, log=log,
        # table rows scanned, not input lines: CADD's cadence unit
        log_after=(1 << 22) if args.logAfter is None else (args.logAfter or None),
        quarantine=quarantine, max_errors=args.maxErrors, device=device,
        mesh=mesh,
    )
    obs = ObsSession.from_args("load-cadd", args, {
        "database": args.databaseDir, "store": args.storeDir,
        "file": args.fileName, "chromosomes": args.chromosomes,
        "commit": args.commit, "test": args.test,
        "update_existing": args.updateExisting,
        "random_access": args.randomAccess,
    })
    obs.attach(updater)
    try:
        subsets = vcf_subsets(updater, args.fileName) if args.fileName else None
        counters = updater.update_all(
            parse_chromosomes(args.chromosomes),
            commit=args.commit, test=args.test, subsets=subsets,
            random_access=args.randomAccess,
        )
        # inside the try: a failed commit save is an abort the run
        # ledger must witness too
        if args.commit:
            store.save(args.storeDir)
    except BaseException as exc:
        obs.abort(ledger, exc, store=store)
        raise
    finally:
        quarantine.close()
    log(f"stage breakdown: {updater.timer.summary()}")
    obs.finish(ledger, counters, store=store)
    print(json.dumps(counters))
    print(counters["alg_id"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
