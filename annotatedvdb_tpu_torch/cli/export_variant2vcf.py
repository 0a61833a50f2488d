"""CLI: dump the variant store back to VCF files for bulk re-processing.

Port of ``annotatedvdb_tpu/cli/export_variant2vcf.py`` (the reference's
``Util/bin/export_variant2vcf.py``).  Host only, with no device and no
platform pin.  Per chromosome, writes ``<chr>_<n>.vcf`` shards of at most
``--variantsPerFile`` rows (reference: 10M, ``:24``), with the record
primary key in the ID column so downstream updates can join back.
Variants whose alleles carry the invalid single-letter codes ``I|R|D|N``
are diverted to ``<chr>_invalid.txt`` (``:27,75-77``).

Usage:
    python -m annotatedvdb_tpu_torch export-vcf --storeDir ./vdb \\
        --outputDir ./export [--chr 22] [--variantsPerFile N]
"""

from __future__ import annotations

import argparse
import os
import re
import sys

from annotatedvdb_tpu_torch.store import VariantStore
from annotatedvdb_tpu_torch.types import chromosome_code, chromosome_label

VCF_HEADER = ["#CHRM", "POS", "ID", "REF", "ALT", "QUAL", "FILTER", "INFO"]
VARIANTS_PER_FILE = 10_000_000
_INVALID_ALLELE = re.compile(r"^[IRDN]$")


def export_chromosome(store: VariantStore, code: int, out_dir: str,
                      variants_per_file: int) -> dict:
    from annotatedvdb_tpu_torch.io.egress import EGRESS_WINDOW, shard_strings

    label = chromosome_label(code)
    shard = store.shards[code]
    pos = shard.cols["pos"]
    counters = {"exported": 0, "invalid": 0, "files": 0}
    file_count, rows_in_file, fh = 0, 0, None
    invalid_path = os.path.join(out_dir, f"{label}_invalid.txt")
    with open(invalid_path, "w") as invalid_fh:
        # lines buffer per window and flush in one write
        pending: list = []

        def flush_pending():
            if pending and fh:
                fh.write("\n".join(pending) + "\n")
                pending.clear()

        try:
            for lo in range(0, shard.n, EGRESS_WINDOW):
                refs, alts, _mseq, pks = shard_strings(
                    shard, lo, lo + EGRESS_WINDOW
                )
                pos_l = pos[lo:lo + EGRESS_WINDOW].tolist()
                for j in range(len(pks)):
                    ref, alt = refs[j], alts[j]
                    if _INVALID_ALLELE.match(ref) or _INVALID_ALLELE.match(alt):
                        print(pks[j], file=invalid_fh)
                        counters["invalid"] += 1
                        continue
                    if fh is None or rows_in_file >= variants_per_file:
                        flush_pending()
                        if fh:
                            fh.close()
                        file_count += 1
                        fh = open(
                            os.path.join(out_dir, f"{label}_{file_count}.vcf"),
                            "w",
                        )
                        print(*VCF_HEADER, sep="\t", file=fh)
                        rows_in_file = 0
                    pending.append(
                        f"{label}\t{pos_l[j]}\t{pks[j]}\t{ref}\t{alt}\t.\t.\t."
                    )
                    rows_in_file += 1
                    counters["exported"] += 1
                flush_pending()
        finally:
            # an exception mid-window must not drop buffered rows the
            # counters already counted
            flush_pending()
            if fh:
                fh.close()
    counters["files"] = file_count
    return counters


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="dump the store back to VCF")
    ap.add_argument("--storeDir", required=True)
    ap.add_argument("--outputDir", required=True)
    ap.add_argument("--chr", default="all",
                    help="chromosome to export (default: all)")
    ap.add_argument("--variantsPerFile", type=int, default=VARIANTS_PER_FILE)
    args = ap.parse_args(argv)

    store = VariantStore.load(args.storeDir)
    os.makedirs(args.outputDir, exist_ok=True)
    codes = sorted(store.shards)
    if args.chr != "all":
        code = chromosome_code(args.chr)
        if code == 0:
            ap.error(f"unrecognized chromosome {args.chr!r}")
        codes = [c for c in codes if c == code]
        if not codes:
            print(f"chromosome {args.chr} has no rows in this store; nothing to export")
    total = {"exported": 0, "invalid": 0, "files": 0}
    for code in codes:
        counters = export_chromosome(
            store, code, args.outputDir, args.variantsPerFile
        )
        for k in total:
            total[k] += counters[k]
        print(f"chr{chromosome_label(code)}: {counters}")
    print(total)
    return 0


if __name__ == "__main__":
    sys.exit(main())
