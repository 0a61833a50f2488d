"""CLI: annotate stored variants from Ensembl VEP JSON output.

Port of ``annotatedvdb_tpu/cli/load_vep.py`` (the reference's
``Load/bin/load_vep_result.py``; update-only), with the same flags.  The
default is a dry run unless ``--commit`` is passed; ``--test`` stops after
one block; the algorithm-invocation id is printed on exit.  The load runs
on ``cuda:0`` unless ``--platform cpu`` is passed.

As in the reference, the VEP results go through the native C++ transform
(raw-JSON values, built at first use into ``build/native/``) unless
``AVDB_NATIVE_VEP=0`` selects the pure-Python transform; there is no flag
for it.  A failed native build raises (``loaders/vep_loader.py``).

Usage:  python -m annotatedvdb_tpu_torch load-vep --fileName results.json[.gz] \\
            --storeDir ./vdb [--rankingFile ranks.txt] [--commit] [--platform cpu] ...

Flags of paths not ported yet (``--metricsOut``, ``--traceOut``, a
``--maxWorkers`` count) raise "not yet ported".
"""

from __future__ import annotations

import argparse
import os
import sys

from annotatedvdb_tpu_torch.runtime import PLATFORMS


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="load VEP JSON results into the annotated variant store "
                    "(PyTorch/CUDA)"
    )
    parser.add_argument("--fileName", required=True)
    parser.add_argument("--storeDir", required=True)
    parser.add_argument("--rankingFile", default=None,
                        help="consequence ranking TSV; omitted -> the shipped "
                             "294-combo ADSP seed, ranked on load")
    parser.add_argument("--rankOnLoad", action="store_true", default=None,
                        help="re-rank the ranking file on load (implied for "
                             "the shipped default seed)")
    parser.add_argument("--saveOnAddConsequence", action="store_true")
    parser.add_argument("--datasource", default=None)
    # lifecycle (annotatedvdb_tpu/config.py::add_lifecycle_args)
    parser.add_argument("--commit", action="store_true",
                        help="persist the load (default: dry run)")
    parser.add_argument("--test", action="store_true",
                        help="stop after one batch")
    parser.add_argument("--logAfter", type=int, default=None,
                        help="log counters every N input results "
                             "(default: 16384; 0 disables)")
    parser.add_argument("--logFilePath", default=None,
                        help="log file (default: beside the input)")
    parser.add_argument("--maxErrors", type=int, default=-1, metavar="N",
                        help="abort once more than N input rows have been "
                             "rejected to <store>/quarantine/; default -1 = "
                             "tolerate and quarantine all")
    # runtime (config.py::add_runtime_args); cuda replaces the reference's auto
    parser.add_argument("--platform", default="cuda", choices=PLATFORMS,
                        help="device: cuda (default; an error when no card "
                             "is present) or cpu")
    parser.add_argument("--maxWorkers", default="auto",
                        help="devices to fan out across: auto/off (the port "
                             "runs on one device)")
    parser.add_argument("--noMultihost", action="store_true",
                        help="accepted for compatibility; the port is "
                             "single-host")
    parser.add_argument("--skipExisting", action="store_true",
                        help="skip variants that already have vep_output")
    # telemetry (annotatedvdb_tpu/obs: add_obs_args)
    parser.add_argument("--metricsOut", default=None, metavar="FILE",
                        help="not yet ported")
    parser.add_argument("--traceOut", default=None, metavar="FILE",
                        help="not yet ported")
    return parser


def _refuse_unported(parser, args) -> None:
    for flag in ("metricsOut", "traceOut"):
        if getattr(args, flag) is not None:
            parser.error(f"--{flag} is not yet ported to annotatedvdb_tpu_torch")
    if args.maxWorkers not in ("auto", "off", "1"):
        parser.error("--maxWorkers: multi-device loads are not yet ported "
                     "to annotatedvdb_tpu_torch")


def main(argv=None):
    from annotatedvdb_tpu_torch.conseq import ConsequenceRanker
    from annotatedvdb_tpu_torch.loaders import VepLoader
    from annotatedvdb_tpu_torch.runtime import resolve_device
    from annotatedvdb_tpu_torch.store import AlgorithmLedger, VariantStore
    from annotatedvdb_tpu_torch.utils.logging import load_logger
    from annotatedvdb_tpu_torch.utils.quarantine import (
        ErrorBudget,
        QuarantineSink,
    )

    parser = _parser()
    args = parser.parse_args(argv)
    _refuse_unported(parser, args)
    device = resolve_device(args.platform)

    log, _logger, _log_path = load_logger(
        args.fileName, "load-vep", args.logFilePath
    )
    store = VariantStore.load(args.storeDir)
    ledger = AlgorithmLedger(os.path.join(args.storeDir, "ledger.jsonl"))
    ranker = ConsequenceRanker(
        args.rankingFile,
        save_on_add=args.saveOnAddConsequence,
        rank_on_load=args.rankOnLoad,
    )
    log_after = (1 << 14) if args.logAfter is None else (args.logAfter or None)
    loader = VepLoader(
        store, ledger, ranker,
        datasource=args.datasource,
        skip_existing=args.skipExisting,
        log=log,
        log_after=log_after,
        quarantine=QuarantineSink(
            args.storeDir, args.fileName, "load-vep",
            budget=ErrorBudget(args.maxErrors), log=log,
        ),
        device=device,
    )
    try:
        counters = loader.load_file(
            args.fileName, commit=args.commit, test=args.test
        )
        if args.commit:
            store.save(args.storeDir)
    finally:
        loader.quarantine.close()
    if args.commit:
        log(f"COMMITTED {counters}")
    else:
        log(f"ROLLING BACK (dry run) {counters}")
    log(f"stage breakdown: {loader.timer.summary()}")
    print(counters["alg_id"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
