"""VEP JSON result parsing: ADSP ranking/sorting + frequency extraction.

Port of ``annotatedvdb_tpu/io/vep.py``, the host-side equivalent of the
reference's ``VepJsonParser`` (``Util/lib/python/parsers/vep_parser.py``),
operating on one VEP result dict at a time (the loader streams them in
batches):

- the four consequence blocks (transcript / regulatory_feature /
  motif_feature / intergenic) are re-keyed per variant allele, each conseq
  gets its ADSP rank + coding flag, and lists sort by
  (rank, original VEP order) (``vep_parser.py:103-175``);
- frequencies come from ``colocated_variants`` with COSMIC entries filtered
  and refsnp disambiguation when several co-located variants carry
  frequencies (``vep_parser.py:178-216``), grouped by source into
  GnomAD / 1000Genomes / ESP buckets (``vep_parser.py:235-254``);
- ``cleaned_result`` drops the extracted blocks so the stored ``vep_output``
  JSONB isn't double-loaded (``vep_variant_loader.py:111-123``).

The dicts this module builds are serialized into the store as they are,
so the order of its in-place mutations is part of the on-disk format.
"""

from __future__ import annotations

from annotatedvdb_tpu_torch.conseq import ConsequenceRanker, is_coding_consequence

CONSEQUENCE_TYPES = ["transcript", "regulatory_feature", "motif_feature", "intergenic"]

_ESP_KEYS = ("aa", "ea")

#: blocks cleaned_result strips from the stored vep_output
#: (``vep_variant_loader.py:111-123``)
_EXTRACTED_KEYS = frozenset(
    ["colocated_variants"] + [t + "_consequences" for t in CONSEQUENCE_TYPES]
)

#: unique-combo count from which the batched rank prefetch uses the rank
#: table on the loader's device instead of the numpy one
DEVICE_RANK_MIN = 256

_CONSEQ_KEYS = tuple(t + "_consequences" for t in CONSEQUENCE_TYPES)


def _conseq_sort_key(c):
    return (c["rank"], c["vep_consequence_order_num"])


class VepResultParser:
    def __init__(self, ranker: ConsequenceRanker, device="cpu"):
        self.ranker = ranker
        self.device = device
        self._rank_memo: dict[str, dict] = {}
        self._memo_version = ranker.version
        self._table = None  # RankTable snapshot, rebuilt on ranker.version bump

    # ---- batched rank prefetch -------------------------------------------

    def _check_version(self) -> None:
        """Drop memoized ranks when the ranker re-ranked (learn-on-miss):
        every rank value shifts, so stale memo entries would mix table
        versions within one load.  (The reference keeps its stale memo —
        ``_matchedConseqTerms`` survives ``__update_rankings`` — which is a
        bug we do not reproduce.)"""
        if self._memo_version != self.ranker.version:
            self._rank_memo.clear()
            self._memo_version = self.ranker.version

    def _rank_table(self):
        from annotatedvdb_tpu_torch.conseq import RankTable

        if self._table is None or self._table.version != self.ranker.version:
            self._table = RankTable(self.ranker, self.device)
        return self._table

    def prefetch_ranks(self, annotations: list) -> int:
        """Batch-resolve every consequence combo in ``annotations`` through
        the rank-table snapshot (a search on the loader's device for large
        batches, numpy below :data:`DEVICE_RANK_MIN`), seeding the per-combo
        memo so the per-row ranking loop never walks the host table.  Combos
        the snapshot doesn't know (rank -1) are left to the host ranker's
        learn-on-miss path.  Returns the number of combos resolved."""
        import numpy as np

        self._check_version()
        combos: set[str] = set()
        for ann in annotations:
            for ctype in CONSEQUENCE_TYPES:
                for conseq in ann.get(ctype + "_consequences") or []:
                    if isinstance(conseq, dict) and "consequence_terms" in conseq:
                        combos.add(",".join(conseq["consequence_terms"]))
        new = [c for c in combos if c not in self._rank_memo]
        if not new:
            return 0
        table = self._rank_table()
        masks = table.encode(new)
        # fractional tables (legacy seed ranks loaded without re-rank)
        # stay on the host path: the int32 device lane would truncate and
        # disagree with the host ranker on the same combo
        if len(new) >= DEVICE_RANK_MIN and table.integral:
            hi = (masks >> np.uint64(32)).astype(np.uint32)
            lo = (masks & np.uint64(0xFFFFFFFF)).astype(np.uint32)
            ranks = table.lookup_device(hi, lo).cpu().numpy()
        else:
            ranks = table.lookup_host(masks)
        coding = table.is_coding(masks)
        resolved = 0
        for combo, rank, is_coding in zip(new, ranks, coding):
            if rank >= 0:
                r = float(rank)
                self._rank_memo[combo] = {
                    # same int-when-integral coercion as the host ranker's
                    # to_numeric, so memo-seeded and memo-missed rows store
                    # identical rank values
                    "rank": int(r) if r.is_integer() else r,
                    "consequence_is_coding": bool(is_coding),
                }
                resolved += 1
        return resolved

    # ---- consequences -----------------------------------------------------

    def rank_and_sort(self, annotation: dict) -> dict:
        """Mutates ``annotation``: each '<ctype>_consequences' list becomes a
        per-allele dict of rank-sorted consequence dicts.

        This is the per-result hot loop of the VEP load (called once per
        JSON line): memo lookups are inlined and the version check is
        hoisted out of the loop."""
        self._check_version()
        memo = self._rank_memo
        ranker = self.ranker
        for key in _CONSEQ_KEYS:
            conseqs = annotation.get(key)
            if conseqs is None:
                continue
            by_allele: dict[str, list] = {}
            for index, conseq in enumerate(conseqs):
                conseq["vep_consequence_order_num"] = index
                terms = conseq["consequence_terms"]
                mkey = ",".join(terms)
                entry = memo.get(mkey)
                if entry is None:
                    rank = ranker.find_matching_consequence(terms)
                    # a learn-on-miss re-rank renumbers the whole table:
                    # drop every memo entry of the old version BEFORE
                    # caching this one (the table version only ever changes
                    # inside the miss path; memo is cleared in place, so the
                    # local alias sees it)
                    self._check_version()
                    entry = memo[mkey] = {
                        "rank": rank,
                        "consequence_is_coding": is_coding_consequence(terms),
                    }
                conseq.update(entry)
                lst = by_allele.get(conseq["variant_allele"])
                if lst is None:
                    by_allele[conseq["variant_allele"]] = [conseq]
                else:
                    lst.append(conseq)
            for lst in by_allele.values():
                if len(lst) > 1:
                    lst.sort(key=_conseq_sort_key)
            annotation[key] = by_allele
        return annotation

    @staticmethod
    def allele_consequences(annotation: dict, allele: str, ctype: str | None = None):
        """Consequences for one (normalized) allele; all types when
        ``ctype`` is None (``vep_parser.py:299-323``)."""
        if ctype is None:
            out = {}
            for ct in CONSEQUENCE_TYPES:
                key = ct + "_consequences"
                conseqs = annotation.get(key)
                if conseqs and allele in conseqs:
                    out[key] = conseqs[allele]
            return out or None
        conseqs = annotation.get(ctype + "_consequences")
        return conseqs.get(allele) if conseqs else None

    @classmethod
    def most_severe_consequence(cls, annotation: dict, allele: str):
        """First hit walking transcript -> regulatory -> motif -> intergenic
        (``vep_parser.py:326-340``)."""
        for ctype in CONSEQUENCE_TYPES:
            conseqs = cls.allele_consequences(annotation, allele, ctype)
            if conseqs:
                return conseqs[0]
        return None

    # ---- frequencies ------------------------------------------------------

    @classmethod
    def frequencies(cls, annotation: dict, matching_variant_id=None):
        cv = annotation.get("colocated_variants")
        if not cv:
            return None
        if len(cv) > 1:
            frequencies = None
            for covar in cv:
                if covar.get("allele_string") == "COSMIC_MUTATION":
                    continue
                if "frequencies" not in covar:
                    continue
                if matching_variant_id is not None:
                    if covar.get("id") == matching_variant_id:
                        frequencies = cls._extract_frequencies(covar)
                else:
                    frequencies = cls._extract_frequencies(covar)
            return frequencies
        if "frequencies" in cv[0]:
            return cls._extract_frequencies(cv[0])
        return None

    @classmethod
    def _extract_frequencies(cls, covar: dict) -> dict:
        out = {}
        if "minor_allele" in covar:
            out["minor_allele"] = covar["minor_allele"]
            if "minor_allele_freq" in covar:
                out["minor_allele_freq"] = covar["minor_allele_freq"]
        out["values"] = cls._group_by_source(covar.get("frequencies"))
        return out

    @staticmethod
    def _group_by_source(frequencies):
        if frequencies is None:
            return None
        result: dict = {}
        for allele, values in frequencies.items():
            gnomad: dict = {}
            esp: dict = {}
            genomes: dict = {}
            for k, v in values.items():  # one pass, not three scans
                if "gnomad" in k:
                    gnomad[k] = v
                elif k in _ESP_KEYS:
                    esp[k] = v
                else:
                    genomes[k] = v
            buckets = {}
            if gnomad:
                buckets["GnomAD"] = gnomad
            if genomes:
                buckets["1000Genomes"] = genomes
            if esp:
                buckets["ESP"] = esp
            if buckets:
                result[allele] = buckets
        return result

    # ---- cleaned result ---------------------------------------------------

    @staticmethod
    def cleaned_result(annotation: dict) -> dict:
        """The result minus the extracted blocks
        (``vep_variant_loader.py:111-123``).

        A SHALLOW copy suffices: the dropped keys are excluded from the copy
        only, the parsed annotation is never mutated after this point (its
        lifetime ends with the batch), and the retained values are disjoint
        from the extracted consequence/frequency blocks — deep-copying the
        whole annotation per result dominated the VEP load's profile."""
        return {
            k: v for k, v in annotation.items() if k not in _EXTRACTED_KEYS
        }
