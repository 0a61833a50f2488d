"""What the update CLIs (``update-qc``, ``load-snpeff-lof``,
``update-annotation``) share: their common flags and their run.

The flags are the reference's (``annotatedvdb_tpu/config.py::
add_lifecycle_args``, ``obs.add_obs_args``) plus ``--platform``: ``cuda``
by default, an error when no card is present, ``cpu`` on request.  A run
loads the store, applies the file with a store save before each
checkpoint inside an ``ObsSession`` (one ``type: "run"`` ledger record on
completion or abort; ``--metricsOut`` and ``--traceOut``), and prints the
counters as JSON and then the algorithm invocation id, as the reference's
CLIs do.
"""

from __future__ import annotations

import argparse
import json
import os

from annotatedvdb_tpu_torch.obs.session import add_obs_args
from annotatedvdb_tpu_torch.runtime import PLATFORMS


def update_parser(description: str) -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=description)
    parser.add_argument("--fileName", required=True)
    parser.add_argument("--storeDir", required=True)
    parser.add_argument("--commit", action="store_true",
                        help="persist the load (default: dry run)")
    parser.add_argument("--test", action="store_true",
                        help="stop after one batch")
    parser.add_argument("--logAfter", type=int, default=None,
                        help="log counters every N input lines "
                             "(default: the batch size; 0 disables)")
    parser.add_argument("--logFilePath", default=None,
                        help="log file (default: beside the input)")
    parser.add_argument("--maxErrors", type=int, default=-1, metavar="N",
                        help="abort once more than N input rows have been "
                             "rejected to <store>/quarantine/; default -1 = "
                             "tolerate and quarantine all")
    parser.add_argument("--platform", default="cuda", choices=PLATFORMS,
                        help="device: cuda (default; an error when no card "
                             "is present) or cpu")
    add_obs_args(parser)
    return parser


def run_update(args, log_tag: str, script: str, params: dict,
               make_loader) -> int:
    """Run one update CLI: ``make_loader(store, ledger, **kw)`` builds the
    loader from the common keywords (log, log_after, quarantine,
    max_errors, device).  ``script`` names the quarantine sink and the run
    record, whose ``params`` are the reference CLI's."""
    from annotatedvdb_tpu_torch.obs import ObsSession
    from annotatedvdb_tpu_torch.runtime import resolve_device
    from annotatedvdb_tpu_torch.store import AlgorithmLedger, VariantStore
    from annotatedvdb_tpu_torch.utils.logging import load_logger
    from annotatedvdb_tpu_torch.utils.quarantine import (
        ErrorBudget,
        QuarantineSink,
    )

    device = resolve_device(args.platform)
    log, _logger, _log_path = load_logger(args.fileName, log_tag,
                                          args.logFilePath)
    store = VariantStore.load(args.storeDir)
    ledger = AlgorithmLedger(os.path.join(args.storeDir, "ledger.jsonl"))
    quarantine = QuarantineSink(
        args.storeDir, args.fileName, script,
        budget=ErrorBudget(args.maxErrors), log=log,
    )
    loader = make_loader(
        store, ledger, log=log,
        log_after=(1 << 15) if args.logAfter is None else (args.logAfter or None),
        quarantine=quarantine, max_errors=args.maxErrors, device=device,
    )
    obs = ObsSession.from_args(script, args, params)
    obs.attach(loader)
    try:
        counters = loader.load_file(
            args.fileName, commit=args.commit, test=args.test,
            persist=(lambda: store.save(args.storeDir)) if args.commit else None,
        )
    except BaseException as exc:
        obs.abort(ledger, exc, store=store)
        raise
    finally:
        quarantine.close()
    obs.finish(ledger, counters, store=store)
    print(json.dumps(counters))
    print(counters["alg_id"])
    return 0
