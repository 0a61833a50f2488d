"""CLI: demux one VCF into per-chromosome files.

Port of ``annotatedvdb_tpu/cli/split_vcf_by_chr.py`` (the reference's
``Util/bin/split_vcf_by_chr.py``).  Host only, with no device and no
platform pin.  One output file per standard human chromosome (chr1-22, X,
Y, M), each with a minimal VCF header line; sequence ids translate
through an optional chromosome map (seq accession -> chromosome number,
e.g. RefSeq ``NC_...``, ``chromosome_map_parser.py:49-62``).  Lines for
contigs that map to no standard chromosome are counted and skipped.

Usage:
    python -m annotatedvdb_tpu_torch split-vcf -f input.vcf[.gz] \\
        -o ./by_chr [-c chr_map.tsv]
"""

from __future__ import annotations

import argparse
import os
import sys

from annotatedvdb_tpu_torch.io.vcf import _open_text, read_chromosome_map
from annotatedvdb_tpu_torch.types import chromosome_code, chromosome_label

HEADER = ["#CHROM", "POS", "ID", "REF", "ALT", "QUAL", "FILTER", "INFO"]
_ALL_CODES = list(range(1, 26))  # chr1..22, X=23, Y=24, M=25


def split_file(path: str, out_dir: str, chrm_map: dict | None = None,
               log=print) -> dict:
    os.makedirs(out_dir, exist_ok=True)
    handles = {}
    for code in _ALL_CODES:
        label = chromosome_label(code)
        handles[code] = open(os.path.join(out_dir, f"chr{label}.vcf"), "w")
        print("\t".join(HEADER), file=handles[code])
    counters = {"line": 0, "unmapped": 0}
    current = None
    try:
        with _open_text(path) as fh:
            for line in fh:
                line = line.rstrip("\n")
                if not line or line.startswith("#"):
                    continue
                counters["line"] += 1
                seq_id = line.split("\t", 1)[0]
                key = chrm_map.get(seq_id, seq_id) if chrm_map else seq_id
                code = chromosome_code(key)
                if seq_id != current:
                    current = seq_id
                    log(f"new sequence: {seq_id} -> "
                        + (f"chr{chromosome_label(code)}.vcf" if code else "skip"))
                if code == 0:
                    counters["unmapped"] += 1
                    continue
                print(line, file=handles[code])
    finally:
        for fh in handles.values():
            fh.close()
    return counters


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="demux a VCF per chromosome")
    ap.add_argument("-f", "--fileName", required=True)
    ap.add_argument("-o", "--outputDir", required=True)
    ap.add_argument("-c", "--chromosomeMap", default=None)
    args = ap.parse_args(argv)

    chrm_map = (
        read_chromosome_map(args.chromosomeMap) if args.chromosomeMap else None
    )
    counters = split_file(args.fileName, args.outputDir, chrm_map)
    print(counters)
    return 0


if __name__ == "__main__":
    sys.exit(main())
