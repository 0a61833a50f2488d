"""CLI: update/insert from an ADSP QC pVCF.

Port of ``annotatedvdb_tpu/cli/update_qc.py`` (the reference's
``Load/bin/update_from_qc_pvcf_file.py``), with the same flags plus
``--platform`` (``cuda`` by default, ``cpu`` on request).  The default is
a dry run unless ``--commit`` is passed; the counters (JSON) and then the
algorithm-invocation id are printed on exit.

Usage:  python -m annotatedvdb_tpu_torch update-qc --fileName qc.vcf[.gz] \\
            --storeDir ./vdb --version r4 [--updateExistingValues] \\
            [--commit] [--test] [--chromosomeMap map.tsv] [--platform cpu]
"""

from __future__ import annotations

import sys

from annotatedvdb_tpu_torch.cli.update_common import parse, run_update, update_parser


def main(argv=None) -> int:
    from annotatedvdb_tpu_torch.io.vcf import read_chromosome_map
    from annotatedvdb_tpu_torch.loaders import QcPvcfLoader

    parser = update_parser("update/insert from an ADSP QC pVCF (PyTorch/CUDA)")
    parser.add_argument("--version", required=True,
                        help="ADSP release tag keying the adsp_qc JSONB (e.g. r4)")
    parser.add_argument("--updateExistingValues", action="store_true")
    parser.add_argument("--chromosomeMap")
    args = parse(parser, argv)
    chromosome_map = (read_chromosome_map(args.chromosomeMap)
                      if args.chromosomeMap else None)
    return run_update(
        args, "update-qc", "update-qc",
        lambda store, ledger, **kw: QcPvcfLoader(
            store, ledger, args.version,
            update_existing=args.updateExistingValues, datasource="ADSP",
            chromosome_map=chromosome_map, **kw,
        ),
    )


if __name__ == "__main__":
    sys.exit(main())
