#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA card.

Drives ``annotatedvdb_tpu_torch``'s VCF insert load, VEP annotation
update and the VCF/TSV-driven update legs (``update-qc``,
``load-snpeff-lof``, ``update-annotation``) on ``cuda:0`` and checks
them, phase by phase, each phase printing one JSON line:

1. device   — the card's name and power limit (``nvidia-smi``);
2. build    — compiles every kernel from ``annotatedvdb_tpu_torch/csrc``
              and, beside them, the native host libraries
              (``annotatedvdb_tpu_torch/native``: the VCF tokenizer, the
              VEP transformer and the ``avdb_pyfast`` extension), each
              compiler in its own process, all started together;
3. kernels  — each kernel against its plain PyTorch version on the card
              (seeded edge rows at W = 16, 49 and 96, 1,048,576 random
              rows, a ragged last tile and unaligned bases; exact under
              the selection contract, the allele hash exact on every
              row), the kernel's hash against the tokenizer's in-scan
              hash (``h_native``) on the first 1,048,576 rows of the
              phase-4 VCF (equal on every row), and its time at the
              load's chunk shape (65,536 rows, W = 49) and at 1,048,576
              rows beside the plain version's and the memory bound; then
              the plain allele hash alone on the card, the work the fused
              kernel took over;
4. load     — a seeded dbSNP-shaped chr22 VCF of 2,000,000 lines through
              ``python -m annotatedvdb_tpu_torch load-vcf --commit`` (the
              CLI's ``main``) with no engine or pipeline variable: the
              native tokenizer, the overlapped executor and the async
              store writer must all run.  Every kernel launch counter and
              the plain hash's call counter are reset just before and read
              just after (one launch per chunk; the card path must never
              call the plain hash); the loader's per-thread stage seconds,
              queue stalls and device idle fraction.  Then the same file
              under ``AVDB_PIPELINE=serial AVDB_ASYNC_STORE=0`` into a
              second store, whose bytes must be identical;
5. reload   — 500,000 lines, half of them copies of phase-4 lines, probed
              on the card (``AVDB_DEVICE_LOOKUP=always``); the duplicate
              count must be the one the generator predicts;
6. parity   — the first 50,000 lines loaded on the card and on the CPU,
              then updated from 12,500 VEP results for the variants of
              their first half (``load-vep``, the ranking file re-ranked
              on load and saved on each of 5 learned combos), once with
              the Python tokenizer, the serial executor and the Python
              VEP transform (``AVDB_NATIVE_VEP=0``) and once in the
              default configuration (the native tokenizer and VEP
              transform): in each, the persisted store bytes and the
              saved ranking files must be identical, the VEP counters the
              ones the generator predicts.  Then, in each configuration,
              the three update commands in turn on the same stores: a QC
              pVCF over the first 25,000 lines with 10% novel rows, a
              SnpEff file over all of them and a METASEQ TSV of 12,500
              rows with 5% novel: the stores identical after each, the
              counters as predicted, and on the card the predicted
              ``annotate_bin`` launches (one per chunk or batch hashed on
              the device, one per insert of novel rows);
7. vep      — a seeded VEP JSON of 200,000 results (1-6 transcript
              consequences from the seed ranking each, regulatory, motif
              and intergenic blocks and colocated frequencies on shares,
              ~2% for alleles the store lacks, 20 novel combos, one
              malformed line) updates phase 4's store through
              ``python -m annotatedvdb_tpu_torch load-vep --commit`` (the
              CLI's ``main``), counters reset just before and read just
              after, in the default configuration (the native C++
              transform): counters as predicted, every planted combo
              learned, one ``annotate_bin`` launch per identity batch (the
              docs the transformer hands to the Python transform), no
              plain hash on the card, the transform's own counts, the
              device's idle share (``torch.profiler``) and how the store
              save splits between JSON encoding and the rest.  Before it,
              the transformer's allele hash over the file's blocks is held
              against the kernel's on the card.  Then the same file under
              ``AVDB_NATIVE_VEP=0`` onto a copy of the store: the two
              saved stores must decode equal.  Then the kernel's time at
              the identity-batch shape;
8. updates  — on phase 7's store, through the CLIs' ``main`` with
              ``--commit`` in the default configuration, each with the
              counters reset just before and read just after: a seeded
              ADSP-QC-shaped pVCF of 400,000 phase-4 lines (QUAL, FILTER
              PASS on 85%, numeric INFO keys and a flag, a repeated key on
              1%, FORMAT and a sample; 10% new SNVs, 3% of those with two
              alts) with ``--version r4``; a SnpEff VCF of 400,000 phase-4
              identities, 6% with ``LOF=`` and/or ``NMD=``; a METASEQ TSV
              of 100,000 rows (``other_annotation`` JSON, ``ref_snp_id``),
              5% new insertions.  Each: counters as the generator
              predicts, the predicted ``annotate_bin`` launches, no plain
              hash on the card, stage seconds, wall, lines/s and the
              device's idle share (``torch.profiler``).  The first kernel
              step of a lookup hash (a 32,768-row TSV batch) and of a
              novel-row insert (a QC chunk's new rows) is kept and, after
              the run, held against the plain versions on the same inputs:
              the annotate fields under the selection contract, the hash
              exact on every row.

Then the kernel table and, as the last line,
``{"ok": true, "device": {"platform": "gpu", ...}}``.  Any failure exits
non-zero without that line.  Needs one CUDA card and the repository
checkout around this file; run as ``python3 chip_smoke.py``.
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "build", "chip_smoke")
WIDTH = 49
CHUNK_ROWS = 65_536
BIG_ROWS = 1 << 20
MEM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
INT32_OPS_PER_S = 67e12        # 32-bit rate outside the tensor cores

# curated branch-coverage rows (the shapes of tests/test_annotate_pallas.py
# EDGE_VARIANTS and tests/test_annotate.py HARD_VARIANTS): SNV, MNV,
# identical alleles, inversion, palindrome, ins, del, dup (single and
# multi-copy, lag 0), indel, leaf-bin edges, wide deletion, over-width
EDGE_ROWS = [
    (100, "A", "G"), (200, "AC", "GT"), (300, "ACGT", "ACGT"),
    (62_500_000, "AAGCTT", "TTCGAA"), (400, "ATAT", "TATA"),
    (500, "A", "AGG"), (600, "AGG", "A"), (700, "ACA", "ACACA"),
    (800, "AGCGC", "AGC"), (900, "AGC", "AGCGCGC"), (950, "AC", "C"),
    (960, "GCC", "C"), (1000, "ATTT", "GTT"), (1100, "CAAA", "CAAAA"),
    (15_625, "A", "ACCCCCCCCCCCCCCCCCCCCC"), (15_626, "AT", "A"),
    (1_000_000, "ACGTACGTACGTACGTACGT", "A"), (1, "A", "C"),
    (11_212_877, "TAAAATATCAAAGTACACCAAATACATATTATATACTGTACAC", "T"),
    (11_212_877, "TAAAATATCAAAGTACACCAAATACATATTATATACTGTACAC",
     "TAAAATATCAAAGTACACCAAATACATATTATATACTGTACACAAAATATCAAAGTACACCAAAT"
     "ACATATTATATACTGTACAC"),
    (2_147_483_647, "A", "C"),       # pad-row sentinel position
    (2_147_483_645, "ACGTAC", "A"),  # end overflows int32
    (0, "AC", "A"),                  # position 0: floor division below 0
]


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def fail(msg: str) -> int:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    return 1


# ---------------------------------------------------------------- inputs


def encode(alleles, width):
    n = len(alleles)
    lens = np.fromiter(map(len, alleles), np.int32, count=n)
    joined = "".join(a[:width].ljust(width, "\0") for a in alleles)
    return np.frombuffer(joined.encode(), np.uint8).reshape(n, width).copy(), lens


def edge_batch(width):
    pos = np.array([p for p, _, _ in EDGE_ROWS], np.int32)
    ref, rl = encode([r for _, r, _ in EDGE_ROWS], width)
    alt, al = encode([a for _, _, a in EDGE_ROWS], width)
    return pos, ref, alt, rl, al


def random_batch(seed, n, width, over_frac=0.05):
    """Seeded rows of every variant shape, ~``over_frac`` over-width."""
    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", np.uint8)
    pos = rng.integers(1, 51_000_000, n).astype(np.int32)
    kind = rng.integers(0, 7, n)
    ref = bases[rng.integers(0, 4, (n, width))]
    alt = bases[rng.integers(0, 4, (n, width))]
    span = rng.integers(2, max(width, 3), n).astype(np.int32)
    rl = np.ones(n, np.int32)
    al = np.ones(n, np.int32)
    rl = np.where((kind == 1) | (kind == 2) | (kind == 5), span, rl)
    al = np.where((kind == 1) | (kind == 2) | (kind == 3), span, al)
    mixed = kind == 6
    rl = np.where(mixed, rng.integers(1, width + 1, n), rl).astype(np.int32)
    al = np.where(mixed, rng.integers(1, width + 1, n), al).astype(np.int32)
    col = np.arange(width)[None, :]
    # inversions: alt = reverse(ref) over the allele length
    inv = kind == 2
    rev_idx = np.clip(rl[:, None] - 1 - col, 0, width - 1)
    alt = np.where(inv[:, None], np.take_along_axis(ref, rev_idx, 1), alt)
    # anchored ins/del share the first base
    anchored = (kind == 3) | (kind == 5)
    alt[anchored, 0] = ref[anchored, 0]
    # duplications: ref = anchor + motif * k, alt = ref + motif
    dup = kind == 4
    m = rng.integers(1, 4, n)
    k = rng.integers(1, 4, n)
    motif = bases[rng.integers(0, 4, (n, 3))]
    tiled = np.take_along_axis(motif, (col % m[:, None]), 1)
    body = np.concatenate([ref[:, :1], tiled[:, : width - 1]], 1)
    rl = np.where(dup, 1 + m * k, rl).astype(np.int32)
    al = np.where(dup, 1 + m * (k + 1), al).astype(np.int32)
    ref = np.where(dup[:, None], body, ref)
    alt = np.where(dup[:, None], body, alt)
    over = rng.random(n) < over_frac
    rl = np.where(over, width + rng.integers(1, 60, n), rl).astype(np.int32)
    ref = np.where(col < rl[:, None], ref, 0).astype(np.uint8)
    alt = np.where(col < al[:, None], alt, 0).astype(np.uint8)
    return pos, ref, alt, rl, al


# ------------------------------------------------------------ VCF writer

BASES = np.array(list("ACGT"))


def _seq(rng, lengths):
    """Random base strings of the given lengths ("" where 0)."""
    out = [""] * lengths.size
    for i in np.flatnonzero(lengths).tolist():
        out[i] = "".join(BASES[rng.integers(0, 4, int(lengths[i]))])
    return out


def vcf_lines(seed, n, positions):
    """``n`` dbSNP-shaped chr22 data lines at the given positions: SNVs
    with ~8% insertions and ~8% deletions of 2-6 bp, ~3% multi-allelic
    sites, ~1% '.' alts, a few over-width alleles, rs ids / RS= / FREQ=
    on shares of the lines.  Returns (lines, rows per line)."""
    rng = np.random.default_rng(seed)
    u = rng.random(n)
    ref_base = rng.integers(0, 4, n)
    alt_base = (ref_base + rng.integers(1, 4, n)) % 4
    ins = u < 0.08
    dele = (u >= 0.08) & (u < 0.16)
    over = (u >= 0.16) & (u < 0.16005)
    indel_len = rng.integers(2, 7, n)
    extra_ref = _seq(rng, np.where(dele, indel_len, np.where(over, 70, 0)))
    extra_alt = _seq(rng, np.where(ins, indel_len, 0))
    v = rng.random(n)
    multi = v < 0.03
    dot_alt = (v >= 0.03) & (v < 0.04)
    # a second alt that differs from both ref and the first alt
    second = (alt_base + 1) % 4
    second = np.where(second == ref_base, (alt_base + 2) % 4, second)
    w = rng.random(n)
    lines = []
    rows = np.zeros(n, np.int64)
    rb, ab, sb = BASES[ref_base], BASES[alt_base], BASES[second]
    for i in range(n):
        ref = rb[i] + extra_ref[i]
        if ins[i]:
            alt = rb[i] + extra_alt[i]
        elif dele[i] or over[i]:
            alt = rb[i]
        else:
            alt = ab[i]
        if multi[i] and not (ins[i] or dele[i] or over[i]):
            alt = alt + "," + sb[i]
            rows[i] = 2
        elif dot_alt[i]:
            alt = "."
        else:
            rows[i] = 1
        rs = 1000 + seed * 10_000_000 + i
        if w[i] < 0.5:
            vid, info = f"rs{rs}", "."
        elif w[i] < 0.8:
            vid, info = ".", f"RS={rs}"
        else:
            n_alt = 2 if "," in alt else 1
            freqs = ",".join(f"0.{(i * 7 + j) % 997:03d}" for j in range(n_alt))
            vid, info = f"rs{rs}", f"RS={rs};FREQ=GnomAD:0.9,{freqs}|TOPMED:0.8,{freqs}"
        lines.append(f"22\t{positions[i]}\t{vid}\t{ref}\t{alt}\t.\t.\t{info}\n")
    return lines, rows


HEADER = "##fileformat=VCFv4.2\n#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n"


def write_phase4_vcf(path, n_lines, seed=4):
    """First load: even positions over chr22, ~0.5% exact duplicate lines,
    one malformed line.  Returns the data lines (duplicates and the
    malformed line excluded), their row counts and the indices of the
    lines written twice."""
    rng = np.random.default_rng(seed + 100)
    n_dup = n_lines // 200
    n_base = n_lines - n_dup - 1
    gaps = rng.integers(1, 13, n_base)
    positions = 16_000_000 + 2 * np.cumsum(gaps)
    lines, rows = vcf_lines(seed, n_base, positions.tolist())
    dup_lines = np.sort(rng.choice(n_base, n_dup, replace=False))
    dup_after = set(dup_lines.tolist())
    with open(path, "w") as fh:
        fh.write(HEADER)
        for i, line in enumerate(lines):
            fh.write(line)
            if i in dup_after:
                fh.write(line)
            if i == n_base // 2:
                fh.write("22\tnot_a_pos\t.\tA\tC\t.\t.\t.\n")
    return lines, rows, dup_lines


def write_phase5_vcf(path, n_lines, old_lines, old_rows, seed=5):
    """Half copies of phase-4 lines, half new lines at odd positions (no
    new identity can collide with a stored one).  Returns the predicted
    (duplicates, inserts)."""
    rng = np.random.default_rng(seed + 100)
    n_copy = n_lines // 2
    pick = np.sort(rng.choice(len(old_lines), n_copy, replace=False))
    n_new = n_lines - n_copy
    gaps = rng.integers(1, 101, n_new)
    positions = 16_000_001 + 2 * np.cumsum(gaps)
    new_lines, new_rows = vcf_lines(seed, n_new, positions.tolist())
    merged = [(int(old_lines[i].split("\t", 2)[1]), old_lines[i]) for i in pick]
    merged += [(int(p), ln) for p, ln in zip(positions.tolist(), new_lines)]
    merged.sort(key=lambda t: t[0])
    with open(path, "w") as fh:
        fh.write(HEADER)
        fh.writelines(ln for _p, ln in merged)
    return int(old_rows[pick].sum()), int(new_rows.sum())


# ------------------------------------------------------------ VEP writer

IMPACTS = ("HIGH", "MODERATE", "LOW", "MODIFIER")
BIOTYPES = ("protein_coding", "lncRNA", "nonsense_mediated_decay",
            "processed_pseudogene", "miRNA")
POPULATIONS = ("af", "afr", "amr", "eas", "eur", "sas", "aa", "ea",
               "gnomad", "gnomad_afr", "gnomad_amr", "gnomad_nfe")


def vep_key(ref, alt):
    """VEP's allele key: the alt past the shared prefix, '-' when empty
    (SNVs untouched)."""
    if len(ref) == 1 and len(alt) == 1:
        return alt
    p = 0
    while p < len(ref) and p < len(alt) and ref[p] == alt[p]:
        p += 1
    return (alt[p:] or "-") if p else alt


def novel_combos(ranker, n, seed):
    """``n`` distinct consequence combos (VEP vocabulary) that ``ranker``
    does not hold: two high-impact terms and one modifier term each."""
    import random

    from annotatedvdb_tpu_torch.conseq import ConseqGroup

    rnd = random.Random(seed)
    high, mod = ConseqGroup.HIGH_IMPACT.value, ConseqGroup.MODIFIER.value
    out, seen = [], set()
    while len(out) < n:
        terms = rnd.sample(high, 2) + [rnd.choice(mod)]
        canon = ",".join(sorted(terms))
        if canon not in seen and ranker.rank_of(canon) is None:
            seen.add(canon)
            out.append(terms)
    return out


def vep_doc(rnd, combos, chrom, pos, vid, ref, alt_col):
    """One VEP result (``--json --everything`` shape) for one input line:
    1-6 transcript consequences whose combos come from ``combos``,
    regulatory, motif and intergenic blocks on shares of results, and on
    about half a colocated variant with GnomAD, 1000 Genomes and ESP
    frequencies (a COSMIC entry before it on some)."""
    alts = [a for a in alt_col.split(",") if a != "."]
    keys = [vep_key(ref, a) for a in alts] or ["-"]
    end = pos + len(ref) - 1
    allele_string = "/".join([ref] + alt_col.split(","))
    tcs = []
    for _ in range(rnd.randint(1, 6)):
        tcs.append({
            "variant_allele": rnd.choice(keys),
            "consequence_terms": list(rnd.choice(combos)),
            "impact": rnd.choice(IMPACTS),
            "gene_id": f"ENSG{rnd.randrange(10**11):011d}",
            "gene_symbol": f"GENE{rnd.randrange(5000)}",
            "transcript_id": f"ENST{rnd.randrange(10**11):011d}",
            "biotype": rnd.choice(BIOTYPES),
            "strand": rnd.choice((1, -1)),
            "cadd_phred": round(rnd.random() * 40, 3),
            "cadd_raw": round(rnd.random() * 8 - 2, 6),
        })
        if rnd.random() < 0.4:
            tcs[-1]["distance"] = rnd.randrange(5000)
    doc = {
        "input": f"{chrom}\t{pos}\t{vid}\t{ref}\t{alt_col}",
        "id": vid, "seq_region_name": chrom, "start": pos, "end": end,
        "strand": 1, "allele_string": allele_string,
        "assembly_name": "GRCh38",
        "most_severe_consequence": tcs[0]["consequence_terms"][0],
        "transcript_consequences": tcs,
    }
    if rnd.random() < 0.3:
        doc["regulatory_feature_consequences"] = [{
            "variant_allele": keys[0], "biotype": "promoter",
            "regulatory_feature_id": f"ENSR{rnd.randrange(10**11):011d}",
            "consequence_terms": ["regulatory_region_variant"],
            "impact": "MODIFIER"}]
    if rnd.random() < 0.1:
        doc["motif_feature_consequences"] = [{
            "variant_allele": keys[0], "motif_name": f"ENSPFM{rnd.randrange(999)}",
            "motif_score_change": round(rnd.random() - 0.5, 3),
            "consequence_terms": ["TF_binding_site_variant"],
            "impact": "MODIFIER"}]
    if rnd.random() < 0.1:
        doc["intergenic_consequences"] = [{
            "variant_allele": keys[0], "consequence_terms": ["intergenic_variant"],
            "impact": "MODIFIER"}]
    if rnd.random() < 0.5:
        covars = []
        if rnd.random() < 0.2:
            covars.append({"id": f"COSV{rnd.randrange(10**8)}",
                           "allele_string": "COSMIC_MUTATION",
                           "start": pos, "end": end, "strand": 1,
                           "somatic": 1})
        covars.append({
            "id": vid if vid != "." else f"rs{rnd.randrange(10**9)}",
            "allele_string": allele_string, "start": pos, "end": end,
            "strand": 1, "minor_allele": keys[0],
            "minor_allele_freq": round(rnd.random() / 2, 4),
            "frequencies": {k: {p: round(rnd.random(), 4) for p in POPULATIONS}
                            for k in keys},
        })
        doc["colocated_variants"] = covars
    return doc


def write_vep_json(path, lines, n_results, seed, n_novel):
    """A VEP JSON file of ``n_results`` results for the variants of
    ``lines`` (VCF data lines, position-sorted; each taken at most once, in
    order): ~2% of them for an allele the store does not hold, ``n_novel``
    combos outside the seed ranking planted at evenly spaced results, one
    malformed line in the middle.  Returns the counters the update load
    must report and the planted combos."""
    import random

    from annotatedvdb_tpu_torch.conseq import ConsequenceRanker

    rnd = random.Random(seed)
    ranker = ConsequenceRanker()
    combos = [c.split(",") for c in ranker.rankings]
    novel = novel_combos(ranker, n_novel, seed)
    plant = {int(i): terms for i, terms in zip(
        np.linspace(0, n_results - 1, n_novel + 2)[1:-1], novel)}
    pick = sorted(rnd.sample(range(len(lines)), n_results))
    want = {"line": n_results + 1, "rejected": 1, "update": 0,
            "not_found": 0, "skipped": 0}
    with open(path, "w") as fh:
        for r, li in enumerate(pick):
            chrom, pos, vid, ref, alt_col = lines[li].split("\t", 5)[:5]
            alts = alt_col.split(",")
            if alt_col != "." and rnd.random() < 0.02:
                # the same site with an allele the store does not hold
                alt_col = next(b for b in "ACGT" if b != ref[0] and b not in alts)
                alts = [alt_col]
                want["not_found"] += 1
            else:
                want["skipped"] += alts.count(".")
                want["update"] += len(alts) - alts.count(".")
            doc = vep_doc(rnd, combos, chrom, int(pos), vid, ref, alt_col)
            if r in plant:
                doc["transcript_consequences"][0]["consequence_terms"] = plant[r]
            fh.write(json.dumps(doc) + "\n")
            if r == n_results // 2:
                fh.write('{"input": "22\\t1\\t.\\tA\\tC", "transcript_consequences": [\n')
    want["variant"] = want["update"] + want["not_found"]
    return want, [",".join(sorted(t)) for t in novel]


# ------------------------------------------------- update-leg writers

QC_HEADER = ("##fileformat=VCFv4.2\n#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\t"
             "INFO\tFORMAT\tSAMPLE1\n")
FILTERS = ("LowQual", "VQSRTrancheSNP99.90to100.00", "ExcessHet")


def line_rows(alt_col):
    """Store rows of one VCF line (its alts less the '.' ones)."""
    alts = alt_col.split(",")
    return len(alts) - alts.count(".")


def novel_alts(ref, alt_col):
    """Single bases that make new identities at a line's position: neither
    the ref's first base nor one of its alts."""
    alts = alt_col.split(",")
    return [b for b in "ACGT" if b != ref[0] and b not in alts]


def write_qc_pvcf(path, lines, n, seed, novel_share=0.1):
    """An ADSP-QC-shaped pVCF (QUAL, FILTER, INFO of numeric keys and a
    flag, FORMAT and one sample) over ``n`` of ``lines`` (VCF data lines,
    position-sorted, taken in order): ``novel_share`` of them a new SNV at
    the line's position (3% of those with two alts), the rest the line's
    own identity; FILTER PASS on 85%; 1% repeat an INFO key.  Returns the
    counters the update must report."""
    rng = np.random.default_rng(seed)
    pick = np.sort(rng.choice(len(lines), n, replace=False))
    novel = rng.random(n) < novel_share
    two = rng.random(n) < 0.03
    u, db, dup = rng.random(n), rng.random(n) < 0.3, rng.random(n) < 0.01
    ac, dp = rng.integers(1, 5000, n), rng.integers(10, 90_000, n)
    af, qd, qual = rng.random(n), rng.random(n) * 40, rng.random(n) * 9000
    want = {"line": n, "update": 0, "skipped": 0, "not_found": 0, "inserted": 0}
    with open(path, "w") as fh:
        fh.write(QC_HEADER)
        for j, li in enumerate(pick.tolist()):
            chrom, pos, vid, ref, alt_col = lines[li].split("\t", 5)[:5]
            if novel[j]:
                free = novel_alts(ref, alt_col)
                ref, alt_col = ref[0], ",".join(free[:2 if two[j] else 1])
                want["inserted"] += line_rows(alt_col)
            else:
                want["update"] += line_rows(alt_col)
            filt = "PASS" if u[j] < 0.85 else FILTERS[j % 3]
            info = (f"AC={ac[j]};AN=10000;AF={af[j]:.5f};DP={dp[j]};"
                    f"QD={qd[j]:.2f};MQ=60.00")
            if db[j]:
                info += ";DB"
            if dup[j]:
                info = f"AC=0;{info}"  # a repeated key: the later one wins
            fh.write(f"{chrom}\t{pos}\t{vid}\t{ref}\t{alt_col}\t{qual[j]:.2f}\t"
                     f"{filt}\t{info}\tGT:AD:DP:GQ\t0/1:12,10:22:99\n")
    want["variant"] = want["update"] + want["inserted"]
    return want


def write_snpeff_vcf(path, lines, n, seed, lof_share=0.06):
    """A SnpEff-annotated VCF over ``n`` of ``lines`` (their own
    identities): ``ANN=`` on every line, ``LOF=`` and/or ``NMD=`` on
    ``lof_share`` of them.  Returns the counters the update must report
    (the rest are skipped before any lookup)."""
    rng = np.random.default_rng(seed)
    pick = np.sort(rng.choice(len(lines), n, replace=False))
    has = rng.random(n) < lof_share
    kind = rng.integers(0, 3, n)
    gene = rng.integers(0, 20_000, n)
    frac = rng.random(n)
    want = {"line": n, "update": 0, "skipped": 0, "not_found": 0, "inserted": 0}
    with open(path, "w") as fh:
        fh.write(HEADER)
        for j, li in enumerate(pick.tolist()):
            chrom, pos, vid, ref, alt_col = lines[li].split("\t", 5)[:5]
            g = f"GENE{gene[j]}|ENSG{gene[j]:011d}"
            info = f"ANN={alt_col.split(',')[0]}|intron_variant|MODIFIER|{g}"
            if has[j]:
                lof = f"({g}|{1 + gene[j] % 30}|{frac[j]:.2f})"
                info += (";LOF=" + lof, ";NMD=" + lof,
                         f";LOF={lof};NMD={lof}")[kind[j]]
                want["update"] += line_rows(alt_col)
            else:
                want["skipped"] += line_rows(alt_col)
            fh.write(f"{chrom}\t{pos}\t{vid}\t{ref}\t{alt_col}\t.\t.\t{info}\n")
    want["variant"] = want["update"] + want["skipped"]
    return want


def write_metaseq_tsv(path, lines, n, seed, novel_share=0.05):
    """A METASEQ-keyed annotation TSV (``other_annotation`` JSON and
    ``ref_snp_id`` columns) over ``n`` of ``lines`` (those with a stored
    alt): the first alt's identity, or on ``novel_share`` of them a new
    8-base insertion at the line's position (no line of the VCF writers
    has one).  Returns the counters the update must report."""
    rng = np.random.default_rng(seed)
    usable = [ln for ln in lines if ln.split("\t", 5)[4] != "."]
    pick = np.sort(rng.choice(len(usable), n, replace=False))
    novel = rng.random(n) < novel_share
    score, ins = rng.random(n), rng.integers(0, 4, (n, 7))
    want = {"line": n, "update": 0, "skipped": 0, "not_found": 0, "inserted": 0}
    with open(path, "w") as fh:
        fh.write("variant\tother_annotation\tref_snp_id\n")
        for j, li in enumerate(pick.tolist()):
            chrom, pos, vid, ref, alt_col = usable[li].split("\t", 5)[:5]
            if novel[j]:
                ref, alt = ref[0], ref[0] + "".join(BASES[ins[j]])
                want["inserted"] += 1
            else:
                alt = alt_col.split(",")[0]
                want["update"] += 1
            ann = json.dumps({"source": "smoke", "score": round(float(score[j]), 4),
                              "tags": ["a", j % 7]})
            rs = vid if vid.startswith("rs") and j % 2 else "NULL"
            fh.write(f"{chrom}:{pos}:{ref}:{alt}\t{ann}\t{rs}\n")
    want["variant"] = n
    want["duplicates"] = want["update"]
    return want


def write_update_inputs(prefix, sources, seed) -> dict:
    """The three update inputs: ``sources`` maps ``qc``, ``lof`` and
    ``tsv`` to (the VCF lines it is drawn from, its size).  Returns the
    path and the predicted counters of each under its name."""
    out = {}
    for name, ext, fn in (("qc", "qc.vcf", write_qc_pvcf),
                          ("lof", "snpeff.vcf", write_snpeff_vcf),
                          ("tsv", "annotation.tsv", write_metaseq_tsv)):
        path = f"{prefix}.{ext}"
        lines, n = sources[name]
        out[name] = {"path": path, "want": fn(path, lines, n, seed)}
        seed += 1
    return out


#: the update commands: (CLI command, its extra flags)
UPDATE_COMMANDS = {"qc": ("update-qc", ["--version", "r4"]),
                   "lof": ("load-snpeff-lof", []),
                   "tsv": ("update-annotation", [])}


# ---------------------------------------------------------------- phases


def offset_copy(torch, x, device, offset):
    """``x`` on the card as a contiguous view ``offset`` elements into a
    larger buffer: a non-zero storage offset, so an unaligned base."""
    flat = torch.zeros(x.size + offset, dtype=torch.from_numpy(x[:0]).dtype,
                       device=device)
    view = flat[offset:].view(x.shape)
    view.copy_(torch.from_numpy(np.ascontiguousarray(x)))
    return view


def annotate_bound(torch, fields, pos, ref, alt, rl, al, prefix):
    """Bytes the fused step must move (inputs read once, outputs written
    once) and the integer operations these inputs need: the scans' byte
    compares up to where they stop, the hash's xor and multiply per byte,
    and a fixed per-row epilogue."""
    n, w = ref.shape
    out_bytes = sum(torch.empty((), dtype=d).element_size() for _, d in fields)
    nbytes = n * (2 * w + 12) + n * out_bytes
    rlw = np.minimum(rl, w)
    mnv = (rl == al) & ~((rl == 1) & (al == 1))
    ops = int(n * 48 + 2 * (np.minimum(prefix + 1, w)).sum()
              + 2 * np.where(mnv, rlw, 0).sum()
              + 2 * np.maximum(np.minimum(rlw - 1, w), 0).sum()
              + 2 * (2 * w + 2) * n)
    bytes_ms = nbytes / MEM_BYTES_PER_S * 1e3
    ops_ms = ops / INT32_OPS_PER_S * 1e3
    return {"rows": n, "bytes": nbytes, "ops": ops, "bytes_ms": bytes_ms,
            "ops_ms": ops_ms, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def _run(fn, inputs, iters):
    for i in range(iters):
        fn(*inputs[i % len(inputs)])


def call_ms(torch, fn, inputs, iters):
    """Device-timeline time per call between CUDA events, cycling through
    the ``inputs`` sets: the kernel plus any gap the host's launch
    overhead leaves between calls."""
    _run(fn, inputs, 2)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    _run(fn, inputs, iters)
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def device_ms(torch, fn, inputs, iters):
    """Summed device time of every kernel a call launches (profiler), per
    call; None when the profiler sees no device time."""
    from torch.profiler import ProfilerActivity, profile

    _run(fn, inputs, 2)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _run(fn, inputs, iters)
        torch.cuda.synchronize()
    total_us = sum(getattr(e, "self_device_time_total", 0.0)
                   for e in prof.key_averages())
    return total_us / 1e3 / iters if total_us > 0 else None


def kernel_phase(torch, device):
    """Phase 3: every kernel against its plain version; returns the kernel
    table rows (launches filled in after phase 4)."""
    from annotatedvdb_tpu_torch.models.pipeline import annotate_hash_fn
    from annotatedvdb_tpu_torch.ops import annotate_cuda
    from annotatedvdb_tpu_torch.ops.annotate_cuda import (
        EVERY_ROW,
        FIELDS,
        annotate_bin,
        annotate_bin_reference,
    )
    from annotatedvdb_tpu_torch.ops.hashing import allele_hash

    def to_dev(args):
        return [torch.from_numpy(np.ascontiguousarray(x)).to(device) for x in args]

    def compare(args):
        got = annotate_bin(*args)
        want = annotate_bin_reference(*args)
        torch.cuda.synchronize()
        ok = ~want["host_fallback"]
        worst, bad = 0, []
        for name, _ in FIELDS:
            a = want[name].to(torch.int64)
            b = got[name].to(torch.int64)
            diff = (a - b).abs()
            if name not in EVERY_ROW:
                diff = torch.where(ok, diff, torch.zeros_like(diff))
            err = int(diff.max()) if diff.numel() else 0
            worst = max(worst, err)
            if err:
                bad.append(name)
        return worst, bad, want

    big = [random_batch(3, BIG_ROWS, WIDTH), random_batch(4, BIG_ROWS, WIDTH)]
    unaligned = random_batch(6, CHUNK_ROWS, WIDTH)
    checks = []
    for label, args in (
        ("edge-w16", to_dev(edge_batch(16))),
        ("edge-w49", to_dev(edge_batch(WIDTH))),
        ("edge-w96", to_dev(edge_batch(96))),
        ("random-1m-w49", to_dev(big[0])),
        ("ragged-65537-w49", to_dev(random_batch(5, CHUNK_ROWS + 1, WIDTH))),
        # ref and alt at byte offsets 3 and 7, the scalars one element in
        ("unaligned-65536-w49", [
            offset_copy(torch, x, device, off)
            for x, off in zip(unaligned, (1, 3, 7, 1, 1))]),
    ):
        worst, bad, want = compare(args)
        checks.append({"inputs": label, "rows": int(args[0].shape[0]),
                       "storage_offsets": [int(a.storage_offset()) for a in args],
                       "max_abs_err": worst, "mismatched": bad,
                       "host_fallback_rows": int(want["host_fallback"].sum())})
        if bad:
            raise AssertionError(f"annotate_bin disagrees with its plain "
                                 f"version on {label}: {bad}")
    # the annotate step's own warm-up check (kernel vs plain on a probe
    # batch) runs here, before the launch counters are reset for phase 4
    annotate_hash_fn(device)

    # timing at the load's chunk shape on ten distinct input sets (> 50 MB
    # of L2, so each launch reads its inputs from device memory), and at
    # 1,048,576 rows on two sets of 115 MB each
    sets = [to_dev(random_batch(10 + i, CHUNK_ROWS, WIDTH)) for i in range(10)]
    big_sets = [to_dev(b) for b in big]
    del big

    def timed(order, inputs):
        """``order`` of (name, fn, iters), in turns; per name, the runs'
        device and call ms."""
        runs = {}
        for name, fn, iters in order:
            runs.setdefault(name, []).append({
                "device_ms": device_ms(torch, fn, inputs, iters),
                "call_ms": call_ms(torch, fn, inputs, iters)})
        return runs

    def best(runs):
        dev = [r["device_ms"] for r in runs if r["device_ms"] is not None]
        return min(dev) if dev else min(r["call_ms"] for r in runs)

    def plain_hash(pos, ref, alt, rl, al):
        return allele_hash(ref, alt, rl, al)

    # in turns: plain, kernel, kernel, plain
    runs = timed((("plain", annotate_bin_reference, 20),
                  ("kernel", annotate_bin, 200), ("kernel", annotate_bin, 200),
                  ("plain", annotate_bin_reference, 20)), sets)
    runs_big = timed((("plain", annotate_bin_reference, 4),
                      ("kernel", annotate_bin, 50), ("kernel", annotate_bin, 50),
                      ("plain", annotate_bin_reference, 4)), big_sets)
    hash_runs = timed((("plain_hash", plain_hash, 20),
                       ("plain_hash", plain_hash, 20)), sets)["plain_hash"]

    def bound(inputs):
        host = [x.cpu().numpy() for x in inputs]
        prefix = annotate_bin_reference(*inputs)["prefix_len"].cpu().numpy()
        return annotate_bound(torch, FIELDS, *host, prefix.astype(np.int64))

    b_chunk, b_big = bound(sets[0]), bound(big_sets[0])
    ms, ms_big = best(runs["kernel"]), best(runs_big["kernel"])
    lib = annotate_cuda._library()
    row = {
        "name": "annotate_bin", "route": "cuda",
        "source": "annotatedvdb_tpu_torch/csrc/annotate_bin.cu",
        "replaces": "annotatedvdb_tpu/ops/annotate_pallas.py:206",
        "launches": None,
        "max_abs_err": max(c["max_abs_err"] for c in checks),
        "ms": ms, "plain_ms": best(runs["plain"]),
        "bound_ms": b_chunk["bound_ms"], "bound_by": b_chunk["bound_by"],
        "library_ms": None,
    }
    emit("kernels", checks=checks, width=WIDTH,
         tile_rows=lib.annotate_bin_tile_rows(),
         blocks_per_sm=lib.annotate_bin_blocks_per_sm(WIDTH),
         chunk={**b_chunk, "ms": ms, "bound_share": b_chunk["bound_ms"] / ms,
                "timing_runs": runs},
         big={**b_big, "ms": ms_big, "plain_ms": best(runs_big["plain"]),
              "bound_share": b_big["bound_ms"] / ms_big,
              "timing_runs": runs_big})
    emit("plain_hash", rows=CHUNK_ROWS, width=WIDTH, ms=best(hash_runs),
         timing_runs=hash_runs)
    return [row]


@contextlib.contextmanager
def captured_loaders(cls):
    """Every ``cls`` loader whose ``load_file`` runs inside, in call order
    (the CLIs build their loaders themselves)."""
    seen = []
    original = cls.load_file

    def load_file(self, *args, **kwargs):
        seen.append(self)
        return original(self, *args, **kwargs)

    cls.load_file = load_file
    try:
        yield seen
    finally:
        cls.load_file = original


@contextlib.contextmanager
def captured_steps():
    """The inputs and outputs of the first fused-kernel step
    (``annotate_hash_pipeline_cuda``) made inside ``lookup._device_hash``
    (key ``"hash"``) and inside ``VcfLoader._load_chunk`` (key
    ``"insert"``), kept on the card until :func:`step_mismatches` reads
    them.  The steps themselves run unchanged."""
    from annotatedvdb_tpu_torch.loaders import lookup
    from annotatedvdb_tpu_torch.loaders.vcf_loader import VcfLoader
    from annotatedvdb_tpu_torch.models import pipeline

    seen, tags = {}, []
    step = pipeline.annotate_hash_pipeline_cuda

    def traced(*args):
        out = step(*args)
        if tags and tags[-1] not in seen:
            seen[tags[-1]] = (args, out)
        return out

    def tagged(original, tag):
        def wrapper(*args, **kwargs):
            tags.append(tag)
            try:
                return original(*args, **kwargs)
            finally:
                tags.pop()
        return wrapper

    patches = [(pipeline, "annotate_hash_pipeline_cuda", traced),
               (lookup, "_device_hash", tagged(lookup._device_hash, "hash")),
               (VcfLoader, "_load_chunk", tagged(VcfLoader._load_chunk, "insert"))]
    raws = [(owner, name, owner.__dict__[name]) for owner, name, _ in patches]
    for owner, name, fn in patches:
        setattr(owner, name, fn)
    try:
        yield seen
    finally:
        for owner, name, raw in raws:
            setattr(owner, name, raw)


def step_mismatches(torch, seen) -> dict:
    """For each step :func:`captured_steps` kept: its rows and the fields
    on which the card's outputs break the contract against the plain
    versions on the same inputs copied to the host (annotate fields under
    ``parity_mismatches``, the hash exact on every row)."""
    from annotatedvdb_tpu_torch.models.pipeline import (
        annotate_hash_pipeline,
        parity_mismatches,
    )
    from annotatedvdb_tpu_torch.types import AnnotatedBatch

    out = {}
    for tag, (args, (ann, h)) in seen.items():
        want, want_h = annotate_hash_pipeline(
            *(None if a is None else a.cpu() for a in args))
        bad = parity_mismatches(want, AnnotatedBatch(*(x.cpu() for x in ann)))
        if not torch.equal(h.cpu(), want_h):
            bad.append("allele_hash")
        out[tag] = {"rows": int(h.shape[0]), "differ": bad}
    return out


@contextlib.contextmanager
def timed_calls(owner, name, sink):
    """Seconds of every call of ``owner.name`` (a method or a classmethod)
    made inside, appended to ``sink``."""
    raw = owner.__dict__[name]
    original = getattr(owner, name)

    def wrapper(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return original(*args, **kwargs)
        finally:
            sink.append(time.perf_counter() - t0)

    setattr(owner, name, wrapper)
    try:
        yield sink
    finally:
        setattr(owner, name, raw)


def ledger_records(store_dir, kind):
    with open(os.path.join(store_dir, "ledger.jsonl")) as f:
        recs = [json.loads(line) for line in f if line.strip()]
    return [r for r in recs if r.get("type") == kind]


def store_bytes(store_dir):
    out = {}
    for dirpath, _dirs, files in os.walk(store_dir):
        for name in sorted(files):
            fp = os.path.join(dirpath, name)
            rel = os.path.relpath(fp, store_dir)
            with open(fp, "rb") as f:
                data = f.read()
            if rel == "manifest.json":
                m = json.loads(data)
                m.pop("store_uid", None)
                data = json.dumps(m, sort_keys=True).encode()
            elif rel == "ledger.jsonl":
                recs = [json.loads(line) for line in data.splitlines() if line.strip()]
                data = json.dumps([{k: v for k, v in r.items() if k != "ts"}
                                   for r in recs]).encode()
            out[rel] = data
    return out


def write_inputs(n4, n5, n6, n7, n8=(400_000, 400_000, 100_000)) -> dict:
    """The seeded inputs of phases 3-8 under ``WORK``: the phase-4 VCF of
    ``n4`` lines, the phase-5 reload VCF of ``n5``, the first ``n6`` lines
    of phase 4 with a VEP file for their first half and the three update
    inputs over them (phase 6), ``n7`` VEP results over phase 4's variants
    (phase 7), and the update inputs over phase 4's lines, ``n8`` = (QC
    lines, SnpEff lines, TSV rows) (phase 8), with what each load must
    count."""
    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    inp = {name: os.path.join(WORK, f) for name, f in (
        ("vcf4", "chr22.first.vcf"), ("vcf5", "chr22.second.vcf"),
        ("vcf6", "chr22.head.vcf"), ("vep6", "chr22.head.vep.json"),
        ("vep7", "chr22.vep.json"))}
    t0 = time.perf_counter()
    lines4, rows4, dup_lines = write_phase4_vcf(inp["vcf4"], n4)
    inp["dup5"], inp["new5"] = write_phase5_vcf(inp["vcf5"], n5, lines4, rows4)
    with open(inp["vcf4"]) as src, open(inp["vcf6"], "w") as dst:
        dst.write(HEADER)
        data = (ln for ln in src if not ln.startswith("#"))
        dst.writelines(next(data) for _ in range(n6))
    inp["vcf_seconds"] = time.perf_counter() - t0
    # phase 6's VEP results: variants of the first half of its lines (all
    # in its stores); phase 7's: variants of the whole phase-4 file
    t0 = time.perf_counter()
    inp["want6"], _ = write_vep_json(inp["vep6"], lines4[: n6 // 2], n6 // 4,
                                     seed=6, n_novel=5)
    inp["want7"], inp["novel7"] = write_vep_json(inp["vep7"], lines4, n7,
                                                 seed=7, n_novel=20)
    inp["vep_seconds"] = time.perf_counter() - t0
    # the update legs: phase 6's over the identities of its 50,000 lines
    # (a QC pVCF over the first half), phase 8's over phase 4's lines
    t0 = time.perf_counter()
    with open(inp["vcf6"]) as f:
        lines6 = list(dict.fromkeys(ln for ln in f if not ln.startswith("#")))
    half = len(lines6) // 2
    inp["updates6"] = write_update_inputs(
        os.path.join(WORK, "chr22.head"),
        {"qc": (lines6[:half], half), "lof": (lines6, len(lines6)),
         "tsv": (lines6, n6 // 4)}, seed=60)
    inp["updates8"] = write_update_inputs(
        os.path.join(WORK, "chr22"),
        {name: (lines4, n) for name, n in zip(("qc", "lof", "tsv"), n8)},
        seed=80)
    inp["update_seconds"] = time.perf_counter() - t0
    inp["dup4"] = int(rows4[dup_lines].sum())
    inp["ins4"] = int(rows4.sum())
    inp.update(n4=n4, n5=n5, n6=n6, n7=n7, n8=n8)
    return inp


def native_hash_check(torch, device, vcf, rows=BIG_ROWS) -> dict:
    """The kernel's allele hash against the native tokenizer's in-scan
    hash (``h_native``) on the first ``rows`` rows of ``vcf``, read as the
    load reads it (65,536-row chunks): equal on every row.  Raises
    AssertionError on any difference."""
    from annotatedvdb_tpu_torch.io.vcf import VcfBatchReader
    from annotatedvdb_tpu_torch.ops.annotate_cuda import annotate_bin
    from annotatedvdb_tpu_torch.ops.hashing import to_uint32

    cols, h_native, got = [], [], 0
    for chunk in VcfBatchReader(vcf, batch_size=CHUNK_ROWS, width=WIDTH,
                                engine="native"):
        if chunk.batch.n:
            cols.append(chunk.batch)
            h_native.append(chunk.h_native)
            got += chunk.batch.n
        if got >= rows:
            break
    b = [np.concatenate([getattr(c, f) for c in cols])[:rows]
         for f in ("pos", "ref", "alt", "ref_len", "alt_len")]
    want = np.concatenate(h_native)[:rows]
    out = annotate_bin(*(torch.from_numpy(np.ascontiguousarray(x)).to(device)
                         for x in b))
    h = to_uint32(out["allele_hash"])
    bad = int((h != want).sum())
    res = {"rows": int(want.size), "chunks": len(cols), "mismatches": bad,
           "host_fallback_rows": int(out["host_fallback"].sum())}
    emit("native_hash", **res)
    assert want.size == rows and bad == 0, (
        f"kernel hash differs from h_native on {bad} of {want.size} rows")
    return res


@contextlib.contextmanager
def environment(**env):
    """``os.environ`` with ``env`` set inside (restored after)."""
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


#: the variables that choose the VCF load's configuration; the default
#: configuration is all of them unset
MODE_VARS = ("AVDB_INGEST_ENGINE", "AVDB_PIPELINE", "AVDB_ASYNC_STORE",
             "AVDB_INGEST_SHUFFLE_SEED", "AVDB_NATIVE_VEP")


def load_phases(torch, platform, inp, launches, hash_calls) -> dict:
    """Phases 4-6 on ``platform`` ("cuda" on the card; "cpu" rehearses the
    same control flow at a small size) over the inputs of
    :func:`write_inputs`.  ``launches`` (the kernel launch counters) and
    ``hash_calls`` (the plain hash's calls by device type) are set to 0
    just before the phase-4 load and read right after it.  Raises
    AssertionError on any failed check."""
    from annotatedvdb_tpu_torch.cli.load_vcf import main as load_vcf
    from annotatedvdb_tpu_torch.cli.load_vep import main as load_vep
    from annotatedvdb_tpu_torch.conseq.ranker import DEFAULT_RANKING_FILE
    from annotatedvdb_tpu_torch.loaders import VcfLoader, VepLoader
    from annotatedvdb_tpu_torch.native import vcf as native_vcf
    from annotatedvdb_tpu_torch.runtime import resolve_device
    from annotatedvdb_tpu_torch.store import AlgorithmLedger, VariantStore

    device = resolve_device(platform)
    n4, n6 = inp["n4"], inp["n6"]
    vcf4, vcf6 = inp["vcf4"], inp["vcf6"]
    for name in MODE_VARS:
        assert name not in os.environ, f"{name} is set: phase 4 runs the default"

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    def load(store_dir, trace=False):
        """The CLI load of ``vcf4`` into ``store_dir``: (wall s, loader,
        native chunks, mapping sidecar bytes, device-busy s).  With
        ``trace`` on the card, ``torch.profiler`` records the device's
        activity (kernels and copies) and the busy seconds are its sum
        (None when not traced or when it saw no device time)."""
        from torch.profiler import ProfilerActivity, profile

        traced = trace and device.type == "cuda"
        t0 = time.perf_counter()
        with (profile(activities=[ProfilerActivity.CUDA]) if traced
              else contextlib.nullcontext()) as prof, \
                captured_loaders(VcfLoader) as loaders, \
                timed_calls(native_vcf, "chunk_from_native", []) as native_chunks:
            rc = load_vcf(["--fileName", vcf4, "--storeDir", store_dir,
                           "--commit", "--logAfter", "0", "--platform", platform])
            sync()
        wall = time.perf_counter() - t0
        assert rc == 0, f"load-vcf exited {rc}"
        with open(vcf4 + ".mapping", "rb") as f:
            mapping = f.read()
        busy = None
        if traced:
            busy = sum(getattr(e, "self_device_time_total", 0.0)
                       for e in prof.key_averages()) / 1e6 or None
        return wall, loaders[0], len(native_chunks), mapping, busy

    # 4. the main path: the CLI load in the default configuration
    store4 = os.path.join(WORK, "store")
    for counts in (launches, hash_calls):
        for name in counts:
            counts[name] = 0
    wall, loader, native_chunks, mapping4, busy = load(store4, trace=True)
    launched, hashed = dict(launches), dict(hash_calls)
    stages = dict(loader.timer.seconds)
    counters = ledger_records(store4, "finish")[-1]["counters"]
    chunks = len(ledger_records(store4, "checkpoint"))
    emit("load", lines=counters["line"], variants=counters["variant"],
         duplicates=counters["duplicates"], skipped=counters["skipped"],
         malformed=counters.get("malformed"), chunks=chunks,
         native_chunks=native_chunks, wall_s=wall,
         loader_wall_s=loader.timer.wall_seconds,
         lines_per_s=counters["line"] / wall,
         variants_per_s=counters["variant"] / wall, launches=launched,
         plain_hash_calls=hashed, dispatch_s=stages.get("dispatch"),
         annotate_s=stages.get("annotate"), stage_seconds=stages,
         stage_sum_over_wall=sum(stages.values()) / loader.timer.wall_seconds,
         queue_stalls=loader.queue_stalls,
         device_idle_fraction=loader.device_idle_fraction,
         profiler_device_busy_s=busy,
         profiler_device_idle_fraction=None if busy is None else 1 - busy / wall,
         predicted_duplicates=inp["dup4"], predicted_inserts=inp["ins4"],
         vcf_seconds=inp["vcf_seconds"])
    assert chunks > 0
    assert counters["line"] == n4 and counters.get("malformed") == 1, counters
    assert (counters["duplicates"], counters["variant"]) == (inp["dup4"], inp["ins4"]), (
        f"load: {counters['duplicates']} duplicates / {counters['variant']} "
        f"inserts, predicted {inp['dup4']} / {inp['ins4']}")
    assert native_chunks == chunks, (
        f"load: {native_chunks} native-tokenizer chunks for {chunks} chunks")
    assert {"ingest", "dispatch", "store-writer"} <= set(loader.queue_stalls), (
        f"load: the overlapped executor or the async writer did not run "
        f"({sorted(loader.queue_stalls)})")

    # 4b. the same file, serial executor and synchronous store commits
    store4s = os.path.join(WORK, "store.serial")
    with environment(AVDB_PIPELINE="serial", AVDB_ASYNC_STORE="0"):
        wall_s, loader_s, _n, mapping4s, _busy = load(store4s)
    files4, files4s = store_bytes(store4), store_bytes(store4s)
    differ = sorted(k for k in set(files4) | set(files4s)
                    if files4.get(k) != files4s.get(k))
    del files4, files4s
    emit("load_serial", wall_s=wall_s, lines_per_s=counters["line"] / wall_s,
         stage_seconds=dict(loader_s.timer.seconds), differ=differ,
         mapping_equal=mapping4s == mapping4)
    assert not differ and mapping4s == mapping4, (
        f"serial and overlapped stores differ in {differ or ['mapping']}")
    assert not loader_s.queue_stalls, loader_s.queue_stalls
    shutil.rmtree(store4s)

    # 5. reload, membership probed on the device
    with environment(AVDB_DEVICE_LOOKUP="always"):
        store = VariantStore.load(store4)
        loader = VcfLoader(
            store, AlgorithmLedger(os.path.join(store4, "ledger.jsonl")),
            log=lambda *a: None, device=device,
        )
        t0 = time.perf_counter()
        try:
            c5 = loader.load_file(inp["vcf5"], commit=True,
                                  persist=lambda: store.save(store4))
        finally:
            loader.close()
        store.save(store4)
        sync()
        wall5 = time.perf_counter() - t0
    cached = [s for sh in store.shards.values() for s in sh.segments
              if s._device is not None]
    dup5, new5 = inp["dup5"], inp["new5"]
    emit("reload", lines=c5["line"], variants=c5["variant"],
         duplicates=c5["duplicates"], predicted_duplicates=dup5,
         predicted_inserts=new5, wall_s=wall5, lines_per_s=c5["line"] / wall5,
         probes=loader.probe_stats, device_segments=len(cached),
         device_rows=sum(s.n for s in cached),
         device_cache_bytes=sum(t.numel() * t.element_size()
                                for s in cached for t in s._device[1]))
    assert (c5["duplicates"], c5["variant"]) == (dup5, new5), (
        f"reload: {c5['duplicates']} duplicates / {c5['variant']} inserts, "
        f"predicted {dup5} / {new5}")
    assert loader.probe_stats.get("device") and not loader.probe_stats.get("host"), (
        f"reload: membership probes did not all run on the device: "
        f"{loader.probe_stats}")
    del store, loader, cached

    # 6. device vs CPU, end to end: the VCF load, then the VEP update of
    # its store (ranking file re-ranked on load, saved on each learned
    # combo); with the Python tokenizer, the serial executor and the Python
    # VEP transform, then in the default configuration
    want6 = inp["want6"]
    for config, env in (("python-serial", {"AVDB_INGEST_ENGINE": "python",
                                           "AVDB_PIPELINE": "serial",
                                           "AVDB_NATIVE_VEP": "0"}),
                        ("default", {})):
        out = {}
        for plat in (platform, "cpu"):
            d = os.path.join(WORK, f"store.{config}.{len(out)}.{plat}")
            ranks = os.path.join(WORK, f"ranks.{config}.{len(out)}.{plat}")
            os.makedirs(ranks)
            shutil.copy(DEFAULT_RANKING_FILE, os.path.join(ranks, "ranks.txt"))
            t0 = time.perf_counter()
            with environment(**env):
                rc = load_vcf(["--fileName", vcf6, "--storeDir", d, "--commit",
                               "--logAfter", "0", "--platform", plat])
            assert rc == 0, f"phase 6 ({config}) load on {plat} exited {rc}"
            with open(vcf6 + ".mapping", "rb") as f:
                mapping = f.read()
            with captured_loaders(VepLoader) as vep_loaders, environment(**env):
                rc = load_vep(["--fileName", inp["vep6"], "--storeDir", d,
                               "--commit", "--logAfter", "0", "--datasource",
                               "dbSNP", "--rankingFile",
                               os.path.join(ranks, "ranks.txt"),
                               "--rankOnLoad", "--saveOnAddConsequence",
                               "--platform", plat])
            assert rc == 0, f"phase 6 ({config}) VEP load on {plat} exited {rc}"
            got6 = {k: vep_loaders[0].counters.get(k, 0) for k in want6}
            assert got6 == want6, (
                f"phase 6 ({config}) VEP load on {plat}: {got6}, predicted {want6}")
            stats6 = vep_loaders[0].transform_stats
            assert (stats6["native_rows"] > 0) == (config == "default"), (
                f"phase 6 ({config}) VEP load on {plat} ran the wrong "
                f"transform: {stats6}")
            saved = {}
            for name in sorted(os.listdir(ranks)):
                with open(os.path.join(ranks, name), "rb") as f:
                    saved[name] = f.read()
            vep_bytes = store_bytes(d)
            # then the three update legs on the same store, in turn
            updates = {}
            for name, spec in inp["updates6"].items():
                before = launches["annotate_bin"]
                with environment(**env):
                    run = run_update(torch, plat, name, spec["path"], d)
                got = {k: run["counters"].get(k, 0) for k in spec["want"]}
                assert got == spec["want"], (
                    f"phase 6 ({config}) {name} on {plat}: {got}, predicted "
                    f"{spec['want']}")
                want_l = update_launches_predicted(name, run, config == "default")
                n_launched = launches["annotate_bin"] - before
                if plat == "cuda":
                    assert n_launched == want_l, (
                        f"phase 6 ({config}) {name}: annotate_bin launched "
                        f"{n_launched} times, predicted {want_l}")
                updates[name] = {"files": store_bytes(d), "launches": n_launched,
                                 "chunks": run["chunks"], "s": run["wall"]}
            out[len(out)] = (vep_bytes, mapping, saved,
                             time.perf_counter() - t0, stats6, updates)
        ((files_dev, map_dev, ranks_dev, s_dev, stats_dev, upd_dev),
         (files_cpu, map_cpu, ranks_cpu, s_cpu, stats_cpu, upd_cpu)) = out[0], out[1]
        for name in upd_dev:
            a, b = upd_dev[name].pop("files"), upd_cpu[name].pop("files")
            upd_dev[name]["differ"] = sorted(k for k in set(a) | set(b)
                                             if a.get(k) != b.get(k))
            upd_dev[name]["cpu_s"] = upd_cpu[name]["s"]
        emit("parity_updates", config=config, updates=upd_dev,
             predicted={k: v["want"] for k, v in inp["updates6"].items()})
        for name, rec in upd_dev.items():
            assert not rec["differ"], (
                f"phase 6 ({config}): device and CPU stores differ after "
                f"{name} in {rec['differ']}")
        differ = sorted(k for k in set(files_dev) | set(files_cpu)
                        if files_dev.get(k) != files_cpu.get(k))
        emit("parity", config=config, lines=n6, vep_results=want6["line"] - 1,
             vep_counters=want6, files=len(files_dev), differ=differ,
             mapping_equal=map_dev == map_cpu, ranking_files=sorted(ranks_dev),
             ranking_files_equal=ranks_dev == ranks_cpu, device_s=s_dev,
             cpu_s=s_cpu, transform_stats=stats_dev,
             transform_stats_equal=stats_dev == stats_cpu)
        assert not differ and map_dev == map_cpu, (
            f"phase 6 ({config}): device and CPU stores differ in "
            f"{differ or ['mapping']}")
        assert stats_dev == stats_cpu, (
            f"phase 6 ({config}): transform counts differ: {stats_dev} / {stats_cpu}")
        assert ranks_dev == ranks_cpu and len(ranks_dev) == 6, (
            f"phase 6 ({config}): device and CPU saved ranking files differ: "
            f"{sorted(ranks_dev)} / {sorted(ranks_cpu)}")
    return {"launches": launched, "plain_hash_calls": hashed, "chunks": chunks,
            "store": store4, "vep": inp["vep7"], "want": inp["want7"],
            "novel": inp["novel7"], "vep_seconds": inp["vep_seconds"]}


def run_update(torch, platform, name, path, store_dir, trace=False,
               check=False) -> dict:
    """One update command (``name`` in UPDATE_COMMANDS) through the CLI's
    ``main`` with ``--commit``: its wall, loader, printed counters, the
    chunks it checkpointed, the device hash steps of ``loaders/lookup.py``
    and the synchronous inserts it made (each launches ``annotate_bin``
    once on the card), the store's load and save seconds (the saves are
    the checkpoints' ``persist``), and with ``trace`` on the card the
    device-busy seconds (``torch.profiler``; None when it saw no device
    time).  With ``check`` on the card, the first kernel step of each kind
    (``captured_steps``) is kept as ``steps`` for :func:`step_mismatches`."""
    import io

    from torch.profiler import ProfilerActivity, profile

    from annotatedvdb_tpu_torch.__main__ import main as cli
    from annotatedvdb_tpu_torch.loaders import TextLoader, UpdateLoader, VcfLoader
    from annotatedvdb_tpu_torch.loaders import lookup
    from annotatedvdb_tpu_torch.store import VariantStore

    cmd, extra = UPDATE_COMMANDS[name]
    traced = trace and platform == "cuda"
    checked = check and platform == "cuda"
    out = io.StringIO()
    t0 = time.perf_counter()
    with (profile(activities=[ProfilerActivity.CUDA]) if traced
          else contextlib.nullcontext()) as prof, \
            captured_loaders(UpdateLoader) as loaders, \
            captured_loaders(TextLoader) as text_loaders, \
            timed_calls(lookup, "_device_hash", []) as hash_steps, \
            timed_calls(VcfLoader, "_load_chunk", []) as inserts, \
            timed_calls(VariantStore, "load", []) as load_s, \
            timed_calls(VariantStore, "save", []) as save_s, \
            (captured_steps() if checked else contextlib.nullcontext({})) as steps, \
            contextlib.redirect_stdout(out):
        rc = cli([cmd, "--fileName", path, "--storeDir", store_dir, "--commit",
                  "--logAfter", "0", "--platform", platform, *extra])
        if platform == "cuda":
            torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    assert rc == 0, f"{cmd} exited {rc}"
    printed = out.getvalue().splitlines()
    counters = json.loads(printed[-2])
    assert int(printed[-1]) == counters["alg_id"]
    busy = None
    if traced:
        busy = sum(getattr(e, "self_device_time_total", 0.0)
                   for e in prof.key_averages()) / 1e6 or None
    (loader,) = loaders + text_loaders
    # the counters after each chunk, from its checkpoint: the chunks whose
    # ``inserted`` grew are the ones that inserted novel rows
    after = [r["counters"] for r in ledger_records(store_dir, "checkpoint")
             if r["alg_id"] == counters["alg_id"]]
    novel_chunks = sum(b.get("inserted", 0) > a.get("inserted", 0)
                       for a, b in zip([{}] + after, after))
    return {"wall": wall, "loader": loader, "counters": counters,
            "chunks": len(after), "novel_chunks": novel_chunks,
            "hash_steps": len(hash_steps), "inserts": len(inserts), "busy": busy,
            "store_load_s": sum(load_s), "store_save_s": sum(save_s),
            "steps": steps}


def update_launches_predicted(name, run, native) -> int:
    """``annotate_bin`` launches an update run must make on the card: one
    per synchronous insert, made for each chunk or batch with novel rows,
    and one per chunk or batch hashed on the device (``lookup._device_hash``:
    without a tokenizer hash, that is under the Python engine and for every
    TSV batch, the lookup and the re-lookup of its inserted rows).  Checked
    against the run's own chunks and the ones whose checkpoint shows
    inserts."""
    chunks, novel = run["chunks"], run["novel_chunks"]
    assert run["inserts"] == novel, (
        f"{name}: {run['inserts']} inserts for {novel} chunks with novel rows")
    if name == "lof":
        assert novel == 0, f"lof: {novel} chunks inserted rows"
    want_steps = 0 if native and name != "tsv" else chunks + novel
    assert run["hash_steps"] == want_steps, (
        f"{name}: {run['hash_steps']} device hash steps, predicted {want_steps}")
    return run["hash_steps"] + run["inserts"]


def vep_hash_check(torch, device, vep) -> dict:
    """The native VEP transformer's allele hash against the kernel's on
    the card, over every 4 MiB block of ``vep`` as the update reads it
    (rank table of the shipped seed, W = 49): rows with ``host_fb == 0``
    equal to ``annotate_bin``'s hash, rows with ``host_fb == 1`` (an
    allele over the width) equal to the host's full-string ``_fnv32_str``.
    Raises AssertionError on any difference."""
    from annotatedvdb_tpu_torch.conseq import ConsequenceRanker
    from annotatedvdb_tpu_torch.loaders.vcf_loader import _fnv32_str
    from annotatedvdb_tpu_torch.loaders.vep_loader import _blocks
    from annotatedvdb_tpu_torch.native import vep as native_vep
    from annotatedvdb_tpu_torch.ops.annotate_cuda import annotate_bin
    from annotatedvdb_tpu_torch.ops.hashing import to_uint32

    blob = native_vep.ranking_blob(ConsequenceRanker())
    rows = blocks = over = bad = 0
    t_transform = 0.0
    with open(vep, "rb") as fh:
        for text in _blocks(fh, test=False):
            t0 = time.perf_counter()
            res = native_vep.transform_text(text, blob, True, WIDTH)
            t_transform += time.perf_counter() - t0
            blocks += 1
            if not res.n_rows:
                continue
            out = annotate_bin(*(torch.from_numpy(np.ascontiguousarray(x)).to(device)
                                 for x in (res.pos, res.ref, res.alt,
                                           res.ref_len, res.alt_len)))
            h = to_uint32(out["allele_hash"])
            fb = res.host_fb.astype(bool)
            bad += int((h[~fb] != res.hash[~fb]).sum())
            for i in np.flatnonzero(fb).tolist():
                r0, a0 = int(res.ref_off[i]), int(res.alt_off[i])
                want = _fnv32_str(
                    res.text[r0:r0 + int(res.ref_slen[i])].decode(),
                    res.text[a0:a0 + int(res.alt_slen[i])].decode())
                bad += int(res.hash[i] != want)
            rows += res.n_rows
            over += int(fb.sum())
    out = {"blocks": blocks, "rows": rows, "host_fb_rows": over,
           "mismatches": bad, "transform_s": t_transform}
    emit("vep_hash", **out)
    assert rows > 0 and bad == 0, (
        f"the VEP transformer's hash differs from the kernel's on {bad} of "
        f"{rows} rows")
    return out


@contextlib.contextmanager
def segment_writes(sink):
    """(segment, seconds) of every segment file pair the store writes
    inside, appended to ``sink``."""
    from annotatedvdb_tpu_torch.store import VariantStore

    raw = VariantStore.__dict__["_write_segment"]

    def wrapper(path, stem, seg):
        t0 = time.perf_counter()
        try:
            return raw.__func__(path, stem, seg)
        finally:
            sink.append((seg, time.perf_counter() - t0))

    VariantStore._write_segment = staticmethod(wrapper)
    try:
        yield sink
    finally:
        VariantStore._write_segment = raw


def sidecar_encode_s(segs) -> tuple:
    """(seconds, bytes) to encode the JSON sidecar lines of ``segs`` again,
    as the save does, without writing them."""
    from annotatedvdb_tpu_torch.store.variant_store import (
        OBJECT_COLUMNS,
        sidecar_line,
    )

    t0 = time.perf_counter()
    nbytes = 0
    for seg in segs:
        present = [(c, seg.obj[c]) for c in OBJECT_COLUMNS
                   if seg.obj[c] is not None]
        for i in range(seg.n) if present else ():
            line = sidecar_line(((c, col[i]) for c, col in present), i)
            if line is not None:
                nbytes += len(line.encode())
    return time.perf_counter() - t0, nbytes


def run_load_vep(torch, platform, store_dir, vep, trace=False) -> dict:
    """``load-vep --commit`` of ``vep`` into ``store_dir`` through the
    CLI's ``main``: its wall, loader, store load and save seconds, the
    segments the save wrote with their seconds, and with ``trace`` on the
    card the device-busy seconds (``torch.profiler``; None when not traced
    or when it saw no device time)."""
    from torch.profiler import ProfilerActivity, profile

    from annotatedvdb_tpu_torch.cli.load_vep import main as load_vep
    from annotatedvdb_tpu_torch.loaders import VepLoader
    from annotatedvdb_tpu_torch.store import VariantStore

    traced = trace and platform == "cuda"
    t0 = time.perf_counter()
    with (profile(activities=[ProfilerActivity.CUDA]) if traced
          else contextlib.nullcontext()) as prof, \
            captured_loaders(VepLoader) as loaders, \
            timed_calls(VariantStore, "load", []) as load_s, \
            timed_calls(VariantStore, "save", []) as save_s, \
            segment_writes([]) as writes:
        rc = load_vep(["--fileName", vep, "--storeDir", store_dir, "--commit",
                       "--logAfter", "0", "--datasource", "dbSNP",
                       "--platform", platform])
        if platform == "cuda":
            torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    assert rc == 0, f"load-vep exited {rc}"
    busy = None
    if traced:
        busy = sum(getattr(e, "self_device_time_total", 0.0)
                   for e in prof.key_averages()) / 1e6 or None
    (loader,) = loaders
    return {"wall": wall, "loader": loader, "store_load_s": sum(load_s),
            "store_save_s": sum(save_s), "writes": writes, "busy": busy}


def decoded_differences(dir_a, dir_b) -> list:
    """The files of two stores that differ once each JSON sidecar line is
    decoded: every other file byte for byte (the manifest without its
    sidecar integrity records, the ledger without time stamps)."""
    names_a, names_b = sorted(os.listdir(dir_a)), sorted(os.listdir(dir_b))
    if names_a != names_b:
        return sorted(set(names_a) ^ set(names_b))
    differ = []
    for name in names_a:
        pa, pb = os.path.join(dir_a, name), os.path.join(dir_b, name)
        if os.path.isdir(pa):
            differ += [f"{name}/{d}" for d in decoded_differences(pa, pb)]
            continue
        with open(pa, "rb") as fa, open(pb, "rb") as fb:
            if fa.read() == fb.read():
                continue
        if name.endswith(".ann.jsonl"):
            with open(pa, "rb") as fa, open(pb, "rb") as fb:
                la, lb = fa.read().splitlines(), fb.read().splitlines()
            if len(la) == len(lb) and all(
                    x == y or json.loads(x) == json.loads(y)
                    for x, y in zip(la, lb)):
                continue
        elif name == "manifest.json":
            ma, mb = (json.load(open(p)) for p in (pa, pb))
            for m in (ma, mb):
                m.pop("store_uid", None)
                for rec in m.get("integrity", {}).values():
                    rec.pop("jsonl", None)
            if ma == mb:
                continue
        elif name == "ledger.jsonl":
            ra, rb = ([{k: v for k, v in json.loads(ln).items() if k != "ts"}
                       for ln in open(p) if ln.strip()] for p in (pa, pb))
            if ra == rb:
                continue
        differ.append(name)
    return differ


def vep_phase(torch, platform, prep, launches, hash_calls) -> dict:
    """Phase 7 on ``platform``: the VEP update of phase 4's store through
    the CLI in the default configuration, then under ``AVDB_NATIVE_VEP=0``
    onto ``prep["store_python"]``, a copy of the store made before.
    ``launches`` and ``hash_calls`` are already reset; both are read right
    after the first load.  Raises AssertionError on any failed check."""
    from annotatedvdb_tpu_torch.runtime import resolve_device

    device = resolve_device(platform)
    want, novel = prep["want"], prep["novel"]
    run = run_load_vep(torch, platform, prep["store"], prep["vep"], trace=True)
    launched, hashed = dict(launches), dict(hash_calls)
    wall, loader = run["wall"], run["loader"]
    got = {k: loader.counters.get(k, 0) for k in want}
    batches = loader.identity_batches
    rows = loader.identity_timer.items.get("dispatch", 0)
    identity = loader.identity_timer.seconds
    stats = dict(loader.transform_stats)
    pinned = [s for sh in loader.store.shards.values() for s in sh.segments
              if s._device is not None]
    segs = [seg for seg, _s in run["writes"]]
    encode_s, sidecar_bytes = sidecar_encode_s(segs)
    results = want["line"] - 1
    busy = run["busy"]
    emit("vep", results=results, wall_s=wall, results_per_s=results / wall,
         loader_wall_s=loader.timer.wall_seconds,
         store_load_s=run["store_load_s"], store_save_s=run["store_save_s"],
         segments_written=len(segs),
         segment_write_s=sum(t for _seg, t in run["writes"]),
         sidecar_encode_s=encode_s, sidecar_bytes=sidecar_bytes,
         stage_seconds=dict(loader.timer.seconds), transform_stats=stats,
         identity_batches=batches, rows=rows,
         rows_per_batch=rows / batches if batches else None,
         dispatch_s=identity.get("dispatch"), copy_back_s=identity.get("copy_back"),
         counters=got, predicted=want, added=len(loader.parser.ranker.added),
         planted=len(novel), probes=loader.probe_stats,
         pinned_segments=len(pinned), pinned_rows=sum(s.n for s in pinned),
         queue_stalls=loader.queue_stalls, launches=launched,
         plain_hash_calls=hashed, profiler_device_busy_s=busy,
         profiler_device_idle_fraction=None if busy is None else 1 - busy / wall,
         vep_seconds=prep["vep_seconds"])
    assert got == want, f"vep: counters {got}, predicted {want}"
    assert sorted(loader.parser.ranker.added) == sorted(novel), (
        f"vep: learned {loader.parser.ranker.added}, planted {novel}")
    assert stats["native_rows"] > 0, (
        f"vep: the default configuration did not run the native transform: {stats}")
    assert batches > 0
    if device.type == "cuda":
        assert launched["annotate_bin"] == batches, (
            f"vep: annotate_bin launched {launched['annotate_bin']} times for "
            f"{batches} identity batches")
        assert not hashed.get("cuda"), (
            f"vep: the load called the plain allele_hash on the card "
            f"{hashed['cuda']} times")
    del loader, pinned, segs, run

    # 7b. the same file through the Python transform, onto the copy
    before = dict(launches)
    with environment(AVDB_NATIVE_VEP="0"):
        py = run_load_vep(torch, platform, prep["store_python"], prep["vep"])
    py_loader = py["loader"]
    py_launched = launches["annotate_bin"] - before["annotate_bin"]
    got_py = {k: py_loader.counters.get(k, 0) for k in want}
    t0 = time.perf_counter()
    differ = decoded_differences(prep["store"], prep["store_python"])
    emit("vep_python", wall_s=py["wall"], results_per_s=results / py["wall"],
         loader_wall_s=py_loader.timer.wall_seconds,
         store_load_s=py["store_load_s"], store_save_s=py["store_save_s"],
         stage_seconds=dict(py_loader.timer.seconds),
         transform_stats=py_loader.transform_stats,
         identity_batches=py_loader.identity_batches, launches=py_launched,
         counters=got_py, decoded_differ=differ,
         compare_s=time.perf_counter() - t0)
    assert got_py == want, f"vep (python): counters {got_py}, predicted {want}"
    assert py_loader.transform_stats["native_rows"] == 0
    if device.type == "cuda":
        assert py_launched == py_loader.identity_batches, (
            f"vep (python): annotate_bin launched {py_launched} times for "
            f"{py_loader.identity_batches} identity batches")
    assert not differ, (
        f"vep: the native and Python transforms' stores decode differently "
        f"in {differ}")
    return {"launches": launched, "identity_batches": batches,
            "rows_per_batch": rows / batches}


def update_phase(torch, platform, store_dir, updates, launches, hash_calls) -> dict:
    """Phase 8 on ``platform``: the three update commands in turn on the
    store of phase 7 (``store_dir``), through the CLIs in the default
    configuration.  ``launches`` and ``hash_calls`` are set to 0 just
    before each run and read just after it; the kernel steps kept from the
    run are held against the plain versions after that (those launches are
    not counted).  Returns each command's ``annotate_bin`` launches.
    Raises AssertionError on any failed check."""
    out = {}
    for name, spec in updates.items():
        for counts in (launches, hash_calls):
            for key in counts:
                counts[key] = 0
        run = run_update(torch, platform, name, spec["path"], store_dir,
                         trace=True, check=True)
        launched, hashed = dict(launches), dict(hash_calls)
        steps = step_mismatches(torch, run.pop("steps"))
        loader, wall, busy = run["loader"], run["wall"], run["busy"]
        got = {k: run["counters"].get(k, 0) for k in spec["want"]}
        want_l = update_launches_predicted(name, run, native=True)
        lines = run["counters"]["line"]
        emit("update", command=UPDATE_COMMANDS[name][0], lines=lines,
             wall_s=wall, lines_per_s=lines / wall,
             loader_wall_s=loader.timer.wall_seconds,
             store_load_s=run["store_load_s"], store_save_s=run["store_save_s"],
             stage_seconds=dict(loader.timer.seconds), counters=got,
             predicted=spec["want"], chunks=run["chunks"],
             hash_steps=run["hash_steps"], inserts=run["inserts"],
             launches=launched, predicted_launches=want_l,
             plain_hash_calls=hashed, probes=loader.probe_stats,
             profiler_device_busy_s=busy,
             profiler_device_idle_fraction=None if busy is None else 1 - busy / wall,
             kernel_vs_plain=steps)
        assert got == spec["want"], f"{name}: counters {got}, predicted {spec['want']}"
        if platform == "cuda":
            # the kinds of step the command makes: a lookup hash for each
            # TSV batch, an insert where rows are novel (QC and TSV)
            kinds = {"qc": {"insert"}, "lof": set(), "tsv": {"hash", "insert"}}[name]
            assert set(steps) == kinds, (
                f"{name}: kernel steps kept {sorted(steps)}, expected {sorted(kinds)}")
            for tag, rec in steps.items():
                assert not rec["differ"], (
                    f"{name}: the {tag} step's kernel outputs ({rec['rows']} rows) "
                    f"disagree with the plain versions in {rec['differ']}")
            assert launched["annotate_bin"] == want_l, (
                f"{name}: annotate_bin launched {launched['annotate_bin']} times, "
                f"predicted {want_l}")
            assert not hashed.get("cuda"), (
                f"{name}: the update called the plain allele_hash on the card "
                f"{hashed['cuda']} times")
        out[name] = launched["annotate_bin"]
    return out


def vep_kernel_timing(torch, device, rows) -> dict:
    """``annotate_bin`` at the VEP load's identity-batch shape: ten
    load-like input sets (``io/synth.py``, 85% SNVs) of ``rows`` rows at
    W = 49, device ms (profiler) and call ms (CUDA events), kernel and
    plain version in turns, beside the bound."""
    from annotatedvdb_tpu_torch.io.synth import synthetic_batch
    from annotatedvdb_tpu_torch.ops.annotate_cuda import (
        FIELDS,
        annotate_bin,
        annotate_bin_reference,
    )

    sets = [[torch.from_numpy(np.ascontiguousarray(x)).to(device)
             for x in synthetic_batch(rows, width=WIDTH, seed=20 + i)[1:]]
            for i in range(10)]
    runs = {}
    for name, fn, iters in (("plain", annotate_bin_reference, 20),
                            ("kernel", annotate_bin, 200),
                            ("kernel", annotate_bin, 200),
                            ("plain", annotate_bin_reference, 20)):
        runs.setdefault(name, []).append({
            "device_ms": device_ms(torch, fn, sets, iters),
            "call_ms": call_ms(torch, fn, sets, iters)})

    def best(rs):
        dev = [r["device_ms"] for r in rs if r["device_ms"] is not None]
        return min(dev) if dev else min(r["call_ms"] for r in rs)

    host = [x.cpu().numpy() for x in sets[0]]
    prefix = annotate_bin_reference(*sets[0])["prefix_len"].cpu().numpy()
    bound = annotate_bound(torch, FIELDS, *host, prefix.astype(np.int64))
    ms = best(runs["kernel"])
    out = {**bound, "ms": ms, "plain_ms": best(runs["plain"]),
           "call_ms": min(r["call_ms"] for r in runs["kernel"]),
           "bound_share": bound["bound_ms"] / ms, "timing_runs": runs}
    emit("vep_kernel", **out)
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is False: this smoke needs a CUDA card")
    sys.path.insert(0, ROOT)
    try:
        from annotatedvdb_tpu_torch import native
        from annotatedvdb_tpu_torch.native import pyfast
        from annotatedvdb_tpu_torch.native import vep as native_vep
        from annotatedvdb_tpu_torch.ops import annotate_cuda, build, hashing
        from annotatedvdb_tpu_torch.runtime import resolve_device
    except ImportError as err:
        return fail(f"the annotatedvdb_tpu_torch package is not beside this "
                    f"script ({err})")
    t_start = time.perf_counter()
    device = resolve_device("cuda")
    kind = torch.cuda.get_device_name(0)

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "not measured"
    print(card, flush=True)
    emit("device", name=kind, count=torch.cuda.device_count(), nvidia_smi=card,
         torch=torch.__version__, cuda=torch.version.cuda)

    # 2. build: every kernel and the native host libraries from this
    # checkout's sources, each library's g++ beside the kernels' nvcc
    import concurrent.futures

    shutil.rmtree(build.BUILD_DIR, ignore_errors=True)
    shutil.rmtree(native.BUILD_DIR, ignore_errors=True)

    def timed_build(load):
        t = time.perf_counter()
        load()
        return time.perf_counter() - t

    t0 = time.perf_counter()
    libraries = {"tokenizer": native.load, "vep_transformer": native_vep.load,
                 "pyfast": pyfast.load}
    with concurrent.futures.ThreadPoolExecutor(len(libraries)) as pool:
        futures = {name: pool.submit(timed_build, load)
                   for name, load in libraries.items()}
        logs = build.build()
        native_s = {name: f.result() for name, f in futures.items()}
    emit("build", seconds=time.perf_counter() - t0, kernels=sorted(logs),
         native_seconds=native_s,
         ptxas={k: [ln for ln in v.splitlines() if "registers" in ln or "smem" in ln]
                for k, v in logs.items()})

    def reset():
        for counts in (annotate_cuda.LAUNCHES, hashing.CALLS):
            for name in counts:
                counts[name] = 0

    try:
        inputs = write_inputs(2_000_000, 500_000, 50_000, 200_000)
        # 3. kernels against their plain versions, and the kernel's hash
        # against the tokenizer's on the phase-4 VCF
        table = kernel_phase(torch, device)
        native_hash_check(torch, device, inputs["vcf4"])
        # 4-6. the load (counters reset inside, just before it), the
        # probed reload and the card-vs-CPU parity
        results = load_phases(torch, "cuda", inputs,
                              launches=annotate_cuda.LAUNCHES,
                              hash_calls=hashing.CALLS)
        if results["launches"]["annotate_bin"] != results["chunks"]:
            return fail(f"annotate_bin launched {results['launches']['annotate_bin']}"
                        f" times for {results['chunks']} chunks")
        if results["plain_hash_calls"].get("cuda"):
            return fail(f"the load called the plain allele_hash on the card "
                        f"{results['plain_hash_calls']['cuda']} times")
        # 7. the VEP update of phase 4's store: first the transformer's
        # hash against the kernel's and a copy of the store for the
        # Python transform's run, then the counters reset just before it
        vep_hash_check(torch, device, results["vep"])
        results["store_python"] = results["store"] + ".python"
        shutil.copytree(results["store"], results["store_python"])
        reset()
        vep = vep_phase(torch, "cuda", results, launches=annotate_cuda.LAUNCHES,
                        hash_calls=hashing.CALLS)
        vep_kernel = vep_kernel_timing(torch, device,
                                       max(1, round(vep["rows_per_batch"])))
        # 8. the update legs on phase 7's store (counters reset inside,
        # just before each command)
        upd = update_phase(torch, "cuda", results["store"], inputs["updates8"],
                           launches=annotate_cuda.LAUNCHES,
                           hash_calls=hashing.CALLS)
    except AssertionError as err:
        return fail(str(err))
    emit("smoke", seconds=time.perf_counter() - t_start)
    vcf_launches = results["launches"]["annotate_bin"]
    vep_launches = vep["launches"]["annotate_bin"]
    table[0].update(launches=vcf_launches + vep_launches + sum(upd.values()),
                    launches_vcf_load=vcf_launches, launches_vep_load=vep_launches,
                    launches_update_qc=upd["qc"], launches_lof=upd["lof"],
                    launches_tsv=upd["tsv"],
                    vep_batch_rows=vep_kernel["rows"], vep_batch_ms=vep_kernel["ms"],
                    vep_batch_bound_ms=vep_kernel["bound_ms"])

    print(json.dumps({"kernels": table}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
