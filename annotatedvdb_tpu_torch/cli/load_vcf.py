"""CLI: load a VCF into the variant store on the card.

Port of ``annotatedvdb_tpu/cli/load_vcf.py``, with the same flags.  The
default is a dry run (full pipeline, no mutation) unless ``--commit`` is
passed; ``--test`` stops after one batch; ``--failAt`` is fault
injection; the algorithm-invocation id is printed on exit.  The load runs
on ``cuda:0`` unless ``--platform cpu`` is passed.

Usage:  python -m annotatedvdb_tpu_torch load-vcf --fileName x.vcf[.gz] \\
            --storeDir ./vdb [--commit] [--platform cpu] ...

``--refGenome`` (an ``index-genome`` ``.npz``) validates every inserted
row's ref allele on the card and makes digest PKs canonical.  As in the
reference, the load runs in an ``ObsSession``: one ``type: "run"`` record
lands in the store's ``ledger.jsonl`` whether the load completes or
aborts; ``--metricsOut FILE`` writes a Prometheus textfile and
``FILE.json``, ``--traceOut FILE`` a Chrome trace of the host pipeline's
stage spans, and ``--profile DIR`` a ``torch.profiler`` trace of the load
(CPU activity, and CUDA activity on the card).  ``--maxWorkers`` (auto,
off or a count) fans the annotate step out over this process's device
pool (``parallel.mesh.device_pool``: the cards, or
``AVDBC_VIRTUAL_DEVICES`` shards of one), bounded by ``AVDB_MESH_SHAPE``;
the multi-host variables join a ``torch.distributed`` world unless
``--noMultihost``.  The store's bytes do not depend on the mesh.
"""

from __future__ import annotations

import argparse
import os
import sys

from annotatedvdb_tpu_torch.obs.session import add_obs_args
from annotatedvdb_tpu_torch.runtime import PLATFORMS
from annotatedvdb_tpu_torch.types import DEFAULT_ALLELE_WIDTH


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="load a VCF into the annotated variant store (PyTorch/CUDA)"
    )
    parser.add_argument("--fileName", required=True, help="VCF file (.gz ok)")
    parser.add_argument("--storeDir", required=True, help="variant store directory")
    # lifecycle (annotatedvdb_tpu/config.py::add_lifecycle_args)
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
    # load (config.py::add_load_args)
    parser.add_argument("--failAt", default=None,
                        help="fail at this variant id (fault injection)")
    parser.add_argument("--noResume", action="store_true",
                        help="ignore previous checkpoints for this file")
    parser.add_argument("--commitAfter", type=int, default=1 << 16,
                        help="rows per device batch / checkpoint")
    parser.add_argument("--datasource", default=None,
                        help="e.g. dbSNP / ADSP / EVA")
    parser.add_argument("--genomeBuild", default="GRCh38")
    # runtime (config.py::add_runtime_args); cuda replaces the reference's auto
    parser.add_argument("--platform", default="cuda", choices=PLATFORMS,
                        help="device: cuda (default; an error when no card "
                             "is present) or cpu")
    parser.add_argument("--maxWorkers", default="auto",
                        help="devices to fan out across: auto/off/count")
    parser.add_argument("--noMultihost", action="store_true",
                        help="ignore multi-host environment settings")
    parser.add_argument("--chromosomeMap", default=None,
                        help="TSV mapping seq accessions to chromosomes")
    parser.add_argument("--refGenome", default=None,
                        help="packed genome .npz (index-genome); enables "
                             "ref-allele validation + canonical GA4GH digests "
                             "(the reference's --seqrepoProxyPath)")
    parser.add_argument("--skipExisting", action=argparse.BooleanOptionalAction,
                        default=True,
                        help="check the store for existing variants "
                             "(--no-skipExisting disables)")
    parser.add_argument("--profile", default=None, metavar="DIR",
                        help="capture a torch.profiler trace of the load "
                             "into DIR (view in TensorBoard/Perfetto)")
    add_obs_args(parser)
    return parser


def _runtime_mesh(parser, args):
    """Validate ``--maxWorkers`` (a bad value is a usage error), then join
    the multi-host world and resolve the loader's mesh (None = one shard)."""
    from annotatedvdb_tpu_torch.runtime import apply_runtime, validate_max_workers

    try:
        validate_max_workers(args.maxWorkers)
    except ValueError as err:
        parser.error(str(err))
    mesh = apply_runtime(args.platform, args.maxWorkers,
                         multihost=not args.noMultihost)
    if mesh is not None:
        print(f"annotating across {mesh.size} devices", file=sys.stderr)
    return mesh


def main(argv=None):
    from annotatedvdb_tpu_torch.io.vcf import read_chromosome_map
    from annotatedvdb_tpu_torch.loaders import VcfLoader
    from annotatedvdb_tpu_torch.obs import ObsSession
    from annotatedvdb_tpu_torch.runtime import resolve_device
    from annotatedvdb_tpu_torch.store import AlgorithmLedger, VariantStore
    from annotatedvdb_tpu_torch.utils.logging import load_logger
    from annotatedvdb_tpu_torch.utils.profiling import device_trace, stall_summary
    from annotatedvdb_tpu_torch.utils.quarantine import (
        ErrorBudget,
        QuarantineSink,
    )

    parser = _parser()
    args = parser.parse_args(argv)
    mesh = _runtime_mesh(parser, args)
    device = resolve_device(args.platform)

    manifest = os.path.join(args.storeDir, "manifest.json")
    if os.path.exists(manifest):
        store = VariantStore.load(args.storeDir)
    else:
        os.makedirs(args.storeDir, exist_ok=True)
        store = VariantStore(width=DEFAULT_ALLELE_WIDTH)
    ledger = AlgorithmLedger(os.path.join(args.storeDir, "ledger.jsonl"))
    chrom_map = read_chromosome_map(args.chromosomeMap) if args.chromosomeMap else None
    genome = None
    if args.refGenome:
        from annotatedvdb_tpu_torch.genome import ReferenceGenome

        genome = ReferenceGenome.load(args.refGenome)

    log, _logger, log_path = load_logger(
        args.fileName, "load-vcf", args.logFilePath
    )
    log(f"load_vcf {args.fileName} -> {args.storeDir} "
        f"(commit={args.commit}, device={device}, log={log_path})")
    log_after = args.commitAfter if args.logAfter is None else (args.logAfter or None)
    loader = VcfLoader(
        store,
        ledger,
        datasource=args.datasource,
        genome_build=args.genomeBuild,
        genome=genome,
        batch_size=args.commitAfter,
        skip_existing=args.skipExisting,
        chromosome_map=chrom_map,
        log=log,
        log_after=log_after,
        quarantine=QuarantineSink(
            args.storeDir, args.fileName, "load-vcf",
            budget=ErrorBudget(args.maxErrors), log=log,
        ),
        device=device,
        mesh=mesh,
    )
    # telemetry session: --metricsOut / --traceOut exports + the per-load
    # run-ledger record (appended on success AND abort)
    obs = ObsSession.from_args("load-vcf", args, {
        "file": args.fileName, "store": args.storeDir,
        "commit": args.commit, "test": args.test, "resume": not args.noResume,
        "datasource": args.datasource, "batch_size": args.commitAfter,
        "skip_existing": args.skipExisting,
        "pipeline": os.environ.get("AVDB_PIPELINE", "overlapped"),
    })
    obs.attach(loader)
    # the warmup, the load, the profiler's capture and the final save can
    # each die: the run ledger must witness every abort
    try:
        # build the kernels and run the transport probes before streaming
        # begins, so the first chunk does not pay for them
        loader.warmup()
        with device_trace(args.profile, device):
            counters = loader.load_file(
                args.fileName,
                commit=args.commit,
                test=args.test,
                fail_at=args.failAt,
                mapping_path=args.fileName + ".mapping",
                resume=not args.noResume,
                # persist before every checkpoint so the durable store
                # never lags the resume cursor
                persist=lambda: store.save(args.storeDir),
            )
        if args.commit:
            store.save(args.storeDir)
    except BaseException as exc:
        # witness the crash in the run ledger, then propagate unchanged
        obs.abort(ledger, exc, store=store)
        raise
    finally:
        loader.close()
        loader.quarantine.close()
    if args.commit:
        log(f"COMMITTED {counters}")
    else:
        log(f"ROLLING BACK (dry run) {counters}")
    log(f"stage breakdown: {loader.timer.summary()}")
    if loader.queue_stalls:
        log(f"queue stalls: "
            f"{stall_summary(loader.queue_stalls, loader.timer.wall_seconds)}")
    log(f"device idle fraction: {loader.device_idle_fraction}")
    obs.finish(ledger, counters, store=store)
    print(counters["alg_id"])  # undo handle, like load_vcf_file.py:220
    return 0


if __name__ == "__main__":
    sys.exit(main())
