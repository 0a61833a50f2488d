"""CLI: materialize the hierarchical bin-index reference table
(``BinIndex/bin/generate_bin_index_references.py`` equivalent).

Port of ``annotatedvdb_tpu/cli/generate_bin_index_references.py``, with the
same flags, output and stderr line.  The reference recursively subdivides
each chromosome into a 14-level bin tree (increments halving 64 Mb ->
15.625 kb, ``:93``) and inserts rows ``(chromosome, level, global_bin,
global_bin_path, location '(lower,upper]')`` into a ``BinIndexRef``
Postgres table (``:79-83,98``).  Bin lookups here are closed-form, so the
table is not needed at run time; this emits the identical rows as TSV
(COPY-able into BinIndexRef).  Host only: it needs no device.

Chromosome lengths default to the shipped GRCh38 map
(``annotatedvdb_tpu_torch/data/grch38_chr_map.txt``); ``--genomeBuild
hg19`` selects the shipped hg19 table, and ``-m`` overrides with a custom
map.

Usage:
    python -m annotatedvdb_tpu_torch bin-references \\
        [--genomeBuild GRCh38 | -m custom_chr_map.txt] [-o bin_index_ref.tsv]
"""

from __future__ import annotations

import argparse
import sys

from annotatedvdb_tpu_torch.oracle.binindex import BinTree


def read_chr_map(path: str) -> dict:
    """chrom label -> sequence length (tab-delim, no header;
    ``generate_bin_index_references.py:17-25``)."""
    out = {}
    with open(path) as fh:
        for line in fh:
            line = line.rstrip()
            if not line:
                continue
            chrom, length = line.split("\t")[:2]
            out[chrom] = int(length)
    return out


def emit_rows(chr_map: dict, out) -> int:
    """Depth-first rows matching the reference's insert order; global_bin is
    the 1-based running count across all chromosomes (``:56-58``)."""
    global_bin = 0
    for chrom, seq_length in chr_map.items():
        tree = BinTree(chrom, seq_length)
        for level, path, lower, upper in tree.rows:
            global_bin += 1
            print(
                chrom, level, global_bin, path, f"({lower},{upper}]",
                sep="\t", file=out,
            )
    return global_bin


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("-m", "--chromosomeMap", default=None,
                    help="tab-delim chrom<TAB>length, no header "
                         "(overrides --genomeBuild)")
    ap.add_argument("--genomeBuild", default="GRCh38",
                    help="shipped length table to use: GRCh38 (default) or hg19")
    ap.add_argument("-o", "--output", default=None,
                    help="output TSV (default stdout)")
    args = ap.parse_args(argv)

    if args.chromosomeMap:
        chr_map = read_chr_map(args.chromosomeMap)
    else:
        from annotatedvdb_tpu_torch.genome.assemblies import build_map_path

        try:
            chr_map = read_chr_map(build_map_path(args.genomeBuild))
        except ValueError as err:
            ap.error(str(err))
    if args.output:
        with open(args.output, "w") as out:
            n = emit_rows(chr_map, out)
    else:
        n = emit_rows(chr_map, sys.stdout)
    print(f"generated {n} bins for {len(chr_map)} chromosomes", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
