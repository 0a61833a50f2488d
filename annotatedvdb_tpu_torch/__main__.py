"""Umbrella CLI: ``python -m annotatedvdb_tpu_torch <command> [flags]``.

Port of ``annotatedvdb_tpu/__main__.py`` for the commands ported so far;
each delegates to its module's ``main(argv)``.
"""

from __future__ import annotations

import sys

COMMANDS = {
    "load-vcf": ("annotatedvdb_tpu_torch.cli.load_vcf",
                 "load a VCF into the store (on the card by default)"),
    "load-vep": ("annotatedvdb_tpu_torch.cli.load_vep",
                 "annotate stored variants from VEP JSON results "
                 "(on the card by default)"),
    "update-qc": ("annotatedvdb_tpu_torch.cli.update_qc",
                  "update/insert from an ADSP QC pVCF (on the card by default)"),
    "load-snpeff-lof": ("annotatedvdb_tpu_torch.cli.load_snpeff_lof",
                        "update loss_of_function from a SnpEff VCF "
                        "(on the card by default)"),
    "update-annotation": ("annotatedvdb_tpu_torch.cli.update_variant_annotation",
                          "TSV-driven annotation updates/inserts "
                          "(on the card by default)"),
    "load-cadd": ("annotatedvdb_tpu_torch.cli.load_cadd",
                  "join CADD scores (on the card by default)"),
    "undo": ("annotatedvdb_tpu_torch.cli.undo_load",
             "undo a load by invocation id (host only)"),
    "export-vcf": ("annotatedvdb_tpu_torch.cli.export_variant2vcf",
                   "dump the store back to VCF (host only)"),
    "split-vcf": ("annotatedvdb_tpu_torch.cli.split_vcf_by_chr",
                  "demux a VCF per chromosome (host only)"),
    "index-genome": ("annotatedvdb_tpu_torch.cli.index_genome",
                     "build the packed reference-genome index from a FASTA "
                     "(host only)"),
    "install-schema": ("annotatedvdb_tpu_torch.cli.install_schema",
                       "write the Postgres schema / export a store as COPY "
                       "data (display recompute on the card by default)"),
    "bin-references": ("annotatedvdb_tpu_torch.cli.generate_bin_index_references",
                       "emit the BinIndexRef table as TSV (host only)"),
    "serve": ("annotatedvdb_tpu_torch.cli.serve",
              "HTTP query server over a store (--frontend threaded; "
              "kernels on the card by default)"),
    "export": ("annotatedvdb_tpu_torch.cli.export_corpus",
               "stream the store out as a tokenized training corpus "
               "(batch pack on the card by default)"),
}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] in ("-h", "--help"):
        print("usage: python -m annotatedvdb_tpu_torch <command> [flags]\n")
        width = max(len(c) for c in COMMANDS)
        for cmd, (_, desc) in COMMANDS.items():
            print(f"  {cmd:<{width}}  {desc}")
        return 0 if argv else 2
    cmd, rest = argv[0], argv[1:]
    entry = COMMANDS.get(cmd)
    if entry is None:
        print(f"unknown command {cmd!r}; run with --help for the list",
              file=sys.stderr)
        return 2
    import importlib

    return importlib.import_module(entry[0]).main(rest) or 0


if __name__ == "__main__":
    raise SystemExit(main())
