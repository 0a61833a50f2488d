"""ADSP consequence groups: the term taxonomy driving consequence ranking.

Host copy of ``annotatedvdb_tpu/conseq/groups.py``.  The term lists are the Ensembl VEP consequence ontology terms grouped per the
ADSP annotation rules (reference
``Util/lib/python/enums/consequence_groups.py:40-58``; the terms themselves
are public VEP vocabulary).  Group semantics
(``consequence_groups.py:136-162``):

- MODIFIER membership requires ALL terms of a combo in the group;
- NMD / NON_CODING_TRANSCRIPT membership requires ANY overlap;
- HIGH_IMPACT membership requires overlap with HIGH_IMPACT terms and NO
  overlap with NMD or NON_CODING_TRANSCRIPT terms.

Groups are processed in the fixed order HIGH_IMPACT, NMD,
NON_CODING_TRANSCRIPT, MODIFIER when re-ranking.
"""

from __future__ import annotations

import enum


class ConseqGroup(enum.Enum):
    HIGH_IMPACT = [
        "transcript_ablation", "splice_acceptor_variant", "splice_donor_variant",
        "stop_gained", "frameshift_variant", "stop_lost", "start_lost",
        "inframe_insertion", "inframe_deletion", "missense_variant",
        "protein_altering_variant", "splice_donor_5th_base_variant",
        "splice_region_variant", "splice_donor_region_variant",
        "splice_polypyrimidine_tract_variant",
        "incomplete_terminal_codon_variant", "stop_retained_variant",
        "start_retained_variant", "synonymous_variant",
        "coding_sequence_variant", "5_prime_UTR_variant", "3_prime_UTR_variant",
        "regulatory_region_ablation",
    ]
    NMD = ["NMD_transcript_variant"]
    NON_CODING_TRANSCRIPT = [
        "non_coding_transcript_exon_variant", "non_coding_transcript_variant",
    ]
    MODIFIER = [
        "intron_variant", "mature_miRNA_variant", "non_coding_transcript_variant",
        "non_coding_transcript_exon_variant", "upstream_gene_variant",
        "downstream_gene_variant", "TF_binding_site_variant", "TFBS_ablation",
        "TFBS_amplification", "TF_binding_site_variant",
        "regulatory_region_amplification", "regulatory_region_variant",
        "intergenic_variant",
    ]

    @classmethod
    def all_terms(cls) -> list:
        """All terms in group order, skipping NON_CODING_TRANSCRIPT (a subset
        of MODIFIER whose order is preserved there,
        ``consequence_groups.py:71-76``)."""
        terms = []
        for g in cls:
            if g is not cls.NON_CODING_TRANSCRIPT:
                terms += g.value
        return terms

    @classmethod
    def complete_indexed_dict(cls) -> dict:
        """0-based term -> index (``list_to_indexed_dict`` semantics;
        duplicate terms keep their last position)."""
        return {t: i for i, t in enumerate(cls.all_terms())}

    @classmethod
    def validate_terms(cls, combos) -> bool:
        valid = set(cls.all_terms())
        for combo in combos:
            for term in combo.split(","):
                if term not in valid:
                    raise IndexError(
                        f"Consequence combination `{combo}` contains an invalid "
                        f"consequence: `{term}`. Update ConseqGroup after "
                        "reviewing the Ensembl VEP consequence list."
                    )
        return True

    def indexed_dict(self) -> dict:
        return {t: i for i, t in enumerate(self.value)}

    def members(self, combos, require_subset: bool = False) -> list:
        """Combos belonging to this group under the ADSP rules."""
        ConseqGroup.validate_terms(combos)
        own = set(self.value)
        if require_subset:
            return [c for c in combos if set(c.split(",")) <= own]
        if self is ConseqGroup.HIGH_IMPACT:
            excluded = set(ConseqGroup.NMD.value) | set(
                ConseqGroup.NON_CODING_TRANSCRIPT.value
            )
            return [
                c for c in combos
                if set(c.split(",")) & own and not set(c.split(",")) & excluded
            ]
        return [c for c in combos if set(c.split(",")) & own]


ALL_TERMS = ConseqGroup.all_terms()

# Coding consequences (``vep_parser.py:42``).
CODING_CONSEQUENCES = [
    "synonymous_variant", "missense_variant", "inframe_insertion",
    "inframe_deletion", "stop_gained", "stop_lost", "stop_retained_variant",
    "start_lost", "frameshift_variant", "coding_sequence_variant",
]


def is_coding_consequence(conseqs) -> bool:
    terms = conseqs.split(",") if isinstance(conseqs, str) else conseqs
    return any(t in CODING_CONSEQUENCES for t in terms)
