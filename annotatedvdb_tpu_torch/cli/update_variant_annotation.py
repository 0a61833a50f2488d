"""CLI: TSV-driven annotation updates.

Port of ``annotatedvdb_tpu/cli/update_variant_annotation.py`` (the
reference's ``Load/bin/update_variant_annotation.py``), with the same
flags plus ``--platform`` (``cuda`` by default, ``cpu`` on request).  The
input is tab-delimited with a ``variant`` column (metaseq id, refSNP id
or record primary key per ``--variantIdType``) plus columns named after
Variant-table fields; the update fields come from the header.  The
default is a dry run unless ``--commit`` is passed; the counters (JSON)
and then the algorithm-invocation id are printed on exit.

Usage:  python -m annotatedvdb_tpu_torch update-annotation --fileName ann.tsv \\
            --storeDir ./vdb [--variantIdType METASEQ] [--datasource NIAGADS] \\
            [--skipExisting] [--commit] [--test] [--platform cpu]
"""

from __future__ import annotations

import sys

from annotatedvdb_tpu_torch.cli.update_common import parse, run_update, update_parser
from annotatedvdb_tpu_torch.loaders.txt_loader import VARIANT_ID_TYPES


def main(argv=None) -> int:
    from annotatedvdb_tpu_torch.loaders import TextLoader

    parser = update_parser("TSV-driven annotation updates (PyTorch/CUDA)")
    parser.add_argument("--variantIdType", default="METASEQ",
                        choices=VARIANT_ID_TYPES)
    parser.add_argument("--datasource", default=None)
    parser.add_argument("--skipExisting", action="store_true",
                        help="skip known variants instead of updating them")
    args = parse(parser, argv)
    return run_update(
        args, "update-annotation", "update-variant-annotation",
        lambda store, ledger, **kw: TextLoader(
            store, ledger, variant_id_type=args.variantIdType,
            datasource=args.datasource, update_existing=not args.skipExisting,
            skip_existing=args.skipExisting, **kw,
        ),
    )


if __name__ == "__main__":
    sys.exit(main())
