"""GA4GH VRS computed-identifier digests for long-allele primary keys.

The reference switches to a VRS digest PK when combined allele length exceeds
50bp (``primary_key_generator.py:53,110-117``), delegating to vrs-python +
SeqRepo.  This is a rare host-side path (crypto hashing has no place on the
MXU): a from-scratch implementation of the VRS 1.x computed-identifier
scheme —

    sha512t24u(blob) = base64url(sha512(blob)[:24])

over the canonical GA4GH JSON serialization of an Allele
(SequenceLocation{SequenceInterval} + LiteralSequenceExpression), producing
ids identical to ``ga4gh_identify()`` **when the per-chromosome GA4GH
sequence digests are supplied** (they are themselves sha512t24u digests of
the reference FASTA, normally obtained from SeqRepo; inject via
``sequence_digests``).  Without them, stable namespaced fallback ids are
produced from the RefSeq accession — clearly marked so they are never
mistaken for true GA4GH ids.

Reference-allele validation against a genome (SeqRepo's role in
``primary_key_generator.py:125-144``) is pluggable the same way via
``reference_bases``.
"""

from __future__ import annotations

import base64
import hashlib
import json

# RefSeq accessions for GRCh38 / GRCh37 standard chromosomes (public NCBI
# assembly metadata).
REFSEQ_ACCESSIONS = {
    "GRCh38": {
        **{str(i): f"NC_{i:06d}.{v}" for i, v in zip(range(1, 23),
           [11, 12, 12, 12, 10, 12, 14, 11, 12, 11, 10, 12, 11, 9, 10, 10, 11, 10, 10, 11, 9, 11])},
        "X": "NC_000023.11", "Y": "NC_000024.10", "M": "NC_012920.1",
    },
    "GRCh37": {
        **{str(i): f"NC_{i:06d}.{v}" for i, v in zip(range(1, 23),
           [10, 11, 11, 11, 9, 11, 13, 10, 11, 10, 9, 11, 10, 8, 9, 9, 10, 9, 9, 10, 8, 10])},
        "X": "NC_000023.10", "Y": "NC_000024.9", "M": "NC_012920.1",
    },
}


def sha512t24u(blob: bytes) -> str:
    """GA4GH truncated digest: URL-safe base64 of the first 24 bytes of
    SHA-512."""
    return base64.urlsafe_b64encode(hashlib.sha512(blob).digest()[:24]).decode("ascii")


def _canonical(obj) -> bytes:
    """GA4GH canonical JSON: sorted keys, no whitespace."""
    return json.dumps(obj, sort_keys=True, separators=(",", ":")).encode("utf-8")


class VrsDigestGenerator:
    def __init__(
        self,
        genome_build: str = "GRCh38",
        sequence_digests: dict | None = None,
        reference_bases=None,
    ):
        """
        Args:
          sequence_digests: {'1': 'SQ....', ...} true GA4GH sequence digests
            (from SeqRepo).  When absent, fallback ids are derived from the
            RefSeq accession and prefixed 'SQF' to mark them non-canonical.
          reference_bases: callable (chrom, start0, end0) -> str for ref
            validation; None disables validation (the reference's
            requireValidation=False fallback, ``vcf_variant_loader.py:250-255``).
        """
        self.genome_build = genome_build
        self.accessions = REFSEQ_ACCESSIONS[genome_build]
        self.sequence_digests = sequence_digests or {}
        self.reference_bases = reference_bases

    def sequence_id(self, chrom: str) -> str:
        chrom = chrom.removeprefix("chr")
        if chrom in self.sequence_digests:
            digest = self.sequence_digests[chrom]
            return digest if digest.startswith("SQ.") else "SQ." + digest
        # deterministic, clearly-non-canonical fallback
        return "SQF." + sha512t24u(
            f"{self.genome_build}:{self.accessions[chrom]}".encode()
        )

    def validate_reference(self, chrom: str, pos: int, ref: str) -> bool:
        if self.reference_bases is None:
            return True
        start0 = pos - 1
        genome = self.reference_bases(chrom, start0, start0 + len(ref))
        # case-insensitive, matching the device kernel
        # (genome/refgenome.py validate_ref_kernel)
        return genome.upper() == ref.upper()

    def allele(self, chrom: str, pos: int, ref: str, alt: str) -> dict:
        """VRS 1.x Allele object with inlined location digest (the
        ga4gh_serialize form)."""
        start0 = pos - 1
        location = {
            "interval": {
                "end": {"type": "Number", "value": start0 + len(ref)},
                "start": {"type": "Number", "value": start0},
                "type": "SequenceInterval",
            },
            "sequence_id": self.sequence_id(chrom),
            "type": "SequenceLocation",
        }
        loc_serial = dict(location)
        loc_serial["sequence_id"] = location["sequence_id"].split(".", 1)[1]
        location_digest = sha512t24u(_canonical(loc_serial))
        return {
            "location": location,
            "location_digest": location_digest,
            "state": {"sequence": alt, "type": "LiteralSequenceExpression"},
            "type": "Allele",
        }

    def compute_identifier(self, chrom: str, pos: int, ref: str, alt: str,
                           validate: bool = True) -> str:
        """The digest embedded in long-allele PKs — the reference strips the
        'ga4gh:VA.' prefix and keeps the digest
        (``primary_key_generator.py:163-164``).  ``validate=False`` skips the
        genome check (the reference's requireValidation=False mode)."""
        if validate and not self.validate_reference(chrom, pos, ref):
            # allele-swap fallback handled by the caller
            # (io/egress.py primary_keys); here we just refuse
            raise ValueError(f"reference mismatch at {chrom}:{pos}")
        a = self.allele(chrom, pos, ref, alt)
        serial = {
            "location": a["location_digest"],
            "state": a["state"],
            "type": "Allele",
        }
        return sha512t24u(_canonical(serial))
