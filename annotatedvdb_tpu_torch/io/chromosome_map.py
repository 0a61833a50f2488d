"""Sequence-accession -> chromosome mapping.

Reference: ``Util/lib/python/parsers/chromosome_map_parser.py`` — a TSV with
header ``source_id  chromosome  [chromosome_order_num  length]`` mapping
sequence ids (e.g. RefSeq ``NC_000001.10``) to chromosome numbers
(``:49-62``), with reverse lookup (``:71-81``).  Headerless two-column files
(accession <tab> chromosome) are also accepted, since several reference CLIs
feed those (``split_vcf_by_chr.py:44``).
"""

from __future__ import annotations

import csv

from annotatedvdb_tpu_torch.io.vcf import _open_text


class ChromosomeMap:
    def __init__(self, file_name: str):
        self._file_name = file_name
        self._map: dict[str, str] = {}
        self._parse()

    def _parse(self) -> None:
        with _open_text(self._file_name) as fh:
            first = fh.readline().rstrip("\n")
            if not first:
                return
            cols = first.split("\t")
            if "source_id" in cols and "chromosome" in cols:
                reader = csv.DictReader(fh, fieldnames=cols, delimiter="\t")
                for row in reader:
                    source_id = row.get("source_id")
                    chromosome = row.get("chromosome")
                    # tolerate short/comment/blank lines (DictReader fills
                    # missing columns with None)
                    if not source_id or not chromosome or source_id.startswith("#"):
                        continue
                    self._map[source_id] = chromosome.replace("chr", "")
            else:
                for line in [first] + fh.readlines():
                    parts = line.rstrip("\n").split("\t")
                    if len(parts) >= 2 and not line.startswith("#"):
                        self._map[parts[0]] = parts[1].replace("chr", "")

    def chromosome_map(self) -> dict:
        return self._map

    def get(self, sequence_id: str) -> str:
        """Chromosome number for a sequence id; raises KeyError if unmapped
        (the reference deliberately lets the lookup fail, ``:84-92``)."""
        return self._map[sequence_id]

    def get_sequence_id(self, chrm_num) -> str | None:
        """Reverse lookup: chromosome number -> sequence id (``:71-81``)."""
        for sequence_id, cn in self._map.items():
            if cn == str(chrm_num) or "chr" + cn == str(chrm_num):
                return sequence_id
        return None

    def __contains__(self, sequence_id: str) -> bool:
        return sequence_id in self._map
