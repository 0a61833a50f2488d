"""CLI: update ``loss_of_function`` from a SnpEff-annotated VCF.

Port of ``annotatedvdb_tpu/cli/load_snpeff_lof.py`` (the reference's
``Load/bin/load_snpeff_lof.py``; update only), with the same flags plus
``--platform`` (``cuda`` by default, ``cpu`` on request).  The default is
a dry run unless ``--commit`` is passed; the counters (JSON) and then the
algorithm-invocation id are printed on exit.

Usage:  python -m annotatedvdb_tpu_torch load-snpeff-lof \\
            --fileName snpeff.vcf[.gz] --storeDir ./vdb [--updateExisting] \\
            [--commit] [--test] [--chromosomeMap map.tsv] [--platform cpu]
"""

from __future__ import annotations

import sys

from annotatedvdb_tpu_torch.cli.update_common import run_update, update_parser


def main(argv=None) -> int:
    from annotatedvdb_tpu_torch.io.vcf import read_chromosome_map
    from annotatedvdb_tpu_torch.loaders import SnpEffLofLoader

    parser = update_parser(
        "update loss_of_function from a SnpEff VCF (PyTorch/CUDA)")
    parser.add_argument("--updateExisting", action="store_true",
                        help="overwrite existing loss_of_function values")
    parser.add_argument("--chromosomeMap")
    args = parser.parse_args(argv)
    chromosome_map = (read_chromosome_map(args.chromosomeMap)
                      if args.chromosomeMap else None)
    return run_update(
        args, "load-snpeff-lof", "load-snpeff-lof", {
            "file": args.fileName, "store": args.storeDir,
            "commit": args.commit, "test": args.test,
            "update_existing": args.updateExisting,
        },
        lambda store, ledger, **kw: SnpEffLofLoader(
            store, ledger, update_existing=args.updateExisting,
            chromosome_map=chromosome_map, **kw,
        ),
    )


if __name__ == "__main__":
    sys.exit(main())
