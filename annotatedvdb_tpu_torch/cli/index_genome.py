"""CLI: build the 2-bit packed reference genome index from a FASTA.

Port of ``annotatedvdb_tpu/cli/index_genome.py``, with the same flags and
printed lines.  The framework's SeqRepo-equivalent setup step (the
reference points ``--seqrepoProxyPath`` at a pre-built SeqRepo directory,
``Load/bin/load_vcf_file.py:247-286``).  The ``.npz`` it writes feeds
``load-vcf --refGenome``: ref-allele validation on the card plus canonical
GA4GH sequence digests for VRS primary keys.  Host only: it needs no
device.

Usage:
    python -m annotatedvdb_tpu_torch index-genome \\
        --fasta GRCh38.fa.gz --output ./grch38.npz [--digests]
"""

from __future__ import annotations

import argparse

from annotatedvdb_tpu_torch.genome import ReferenceGenome
from annotatedvdb_tpu_torch.types import chromosome_label


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--fasta", required=True)
    ap.add_argument("--output", required=True, help="output .npz path")
    ap.add_argument("--digests", action="store_true",
                    help="precompute GA4GH sequence digests (slow; cached "
                         "into the index)")
    args = ap.parse_args(argv)

    genome = ReferenceGenome.from_fasta(args.fasta, log=print)
    if not genome.length:
        ap.error(f"no standard chromosomes found in {args.fasta}")
    if args.digests:
        for code in sorted(genome.length):
            d = genome.sequence_digest(code)
            print(f"chr{chromosome_label(code)}: SQ.{d}")
    genome.save(args.output)
    total = sum(genome.length.values())
    print(f"indexed {len(genome.length)} chromosomes, {total} bases "
          f"-> {args.output}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
