#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA card.

Drives ``annotatedvdb_tpu_torch``'s VCF insert load, VEP annotation
update, the VCF/TSV-driven update legs (``update-qc``,
``load-snpeff-lof``, ``update-annotation``), the CADD score join
(``load-cadd``), reference-genome validation (``index-genome``,
``load-vcf --refGenome``), the Postgres egress (``install-schema``) and
the host-only commands (``export-vcf``, ``undo``, ``bin-references``),
the query server (``serve``: both front ends and the fleet), the corpus
export (``export``, ``/export/stream``), ``doctor`` and the live write
path (``serve --upserts``) with the maintenance daemon's compaction
(``serve --maintain``) and a replication follower (``serve --follow``,
``doctor promote``) on ``cuda:0`` and checks them, phase by phase,
each phase printing one JSON line:

1. device   — the card's name and power limit (``nvidia-smi``);
2. build    — compiles every kernel from ``annotatedvdb_tpu_torch/csrc``
              and, beside them, the native host libraries
              (``annotatedvdb_tpu_torch/native``: the VCF tokenizer, the
              VEP transformer, the ``avdb_pyfast`` extension and the CADD
              table tokenizer), each compiler in its own process, all
              started together;
3. kernels  — each kernel against its plain PyTorch version on the card
              (seeded edge rows at W = 8, 16, 49 and 96, 65,536 random
              rows at W = 8 (a width-bucketed upload's narrowest), 1,048,576 random
              rows, a ragged last tile and unaligned bases; exact under
              the selection contract, the allele hash exact on every
              row), the kernel's hash against the tokenizer's in-scan
              hash (``h_native``) on the first 1,048,576 rows of the
              phase-4 VCF (equal on every row), and its time at the
              load's chunk shape (65,536 rows, W = 49) and at 1,048,576
              rows beside the plain version's and the memory bound; then
              the plain allele hash alone on the card, the work the fused
              kernel took over.  Then ``cadd_join`` against its plain
              version, exactly, on seeded edge blocks at W = 16, 31, 32,
              33, 49, 64, 65 and 96 (a match at the window's last probe,
              two matching rows, swapped alleles, probes past the last
              row, a variant at 2147483647 against sentinel rows, N = 0,
              K = 1, unsorted variants, a run of ``probe`` rows ending at
              row K - 1, a 40-row run across 32-row boundaries at probes
              4, 32 and 48, K = 5, 31, 33 and 45) and on random blocks at
              the SNV shape (8,192 variants, 262,144 rows, runs of 3,
              probe 4) and the indel shape (16,384 variants, runs of 1-32,
              probe 32); its time at both shapes beside the plain
              version's and the bound, and one score block's upload.
              Then ``validate_ref`` against its plain version, exactly, on
              the edge rows of ``validate_edge_rows`` at the same widths,
              on 1,048,576 random rows against a GRCh38-shaped genome
              (1.16 GB on the card; its load and upload timed) and on
              65,536 position-sorted chr22 rows (a load's chunk), 60-80%
              of each passing; its time at 65,536 random rows, at the
              65,536 sorted rows and at 1,048,576 random rows beside the
              plain version's and the bound.  Then the query server's
              kernels (``bits_spans``, ``stats_panel``,
              ``windowed_stats``) against their plain versions, exactly, on
              edge cases (1 to 5,000 rows beside the stats kernels' 64-
              and 256-row tiles and 4,096-row super-tiles, padded and not,
              searches landing on every tile edge and half-tile, windows
              whose boundaries are tile edges, spans shorter than the
              windows, all features missing, runs of equal positions,
              queries before, after and across the rows, wholly in the
              padding, ``start > end``, the clamp, present features in the
              padding under an end at the sentinel) and at the serving
              shape (2,274,305 seeded chr22 rows padded to 4,194,304, 4,096
              gene-panel intervals, windows 1, 7, 16 and 64), and
              ``bits_spans`` also on its own search edges (runs of 17 to
              30,000 equal positions across the search rounds, 0 to 65
              rows, row counts not powers of two, the sentinel tail, query
              counts not multiples of 8); then, in a
              spawned process, their time there by kernel name beside the
              plain versions', the bounds and two ``torch.searchsorted``
              calls, and the plain versions' device memory.  Then
              ``export_pack`` against its plain version byte for byte at
              every ``n_valid`` case (-1, 0, 1, B - 1, B, B + 5) on edge
              rows (the int32 ends, the leaf-bin edges, ``end < pos``,
              ``a ^ b`` at each power of two), 1,048,576 random rows and
              batches of 8, 4,096 and 4,097 rows, and on stacks of 1, 2
              and 37 batches of 4,096 rows, 3 of 4,092 and 2 of 4,097 rows
              and 4 at an unaligned base, each batch at each ``n_valid``
              of -5, 0, 1, B - 1, B, B + 7 and the int32 ends; then, in a
              spawned process, its time at one 4,096-row batch (a stream
              call), at a part of 37 batches (an export launch) and at
              1,048,576 rows beside the plain version's and the bound.
              Then the mesh's kernels: ``lookup_multi`` against its plain
              version exactly on :func:`lookup_multi_edge_cases` at W =
              16, 49 and 96 (runs of five and four equal keys,
              cross-chromosome collisions, unsigned hash order, the
              sentinel pad, empty and all-sentinel slices) and on a
              1,048,576-row multi-chromosome slice at W = 49 against
              65,536 queries; ``bits_spans_stacked`` on
              :func:`stacked_bits_edge_cases` and on phase 15's stack
              shape (25 groups padded to the largest, 4,096 intervals);
              then, in the second process while this one waits (no other
              phase holds the card), both timed at those shapes beside
              their plain versions, their bounds, two batched
              ``torch.searchsorted`` and the plain in-batch dedup.  Then
              the packed transport's kernels (``csrc/pack.cu``:
              ``inflate_alleles``, ``pack_outputs``,
              ``pack_vep_outputs``) against their plain versions byte for
              byte on :func:`pack_inflate_cases` (every packed byte value,
              W = 1, 2, 7, 8, 16, 49 and 96, aligned and three bytes off)
              and :func:`pack_outputs_cases` (hash, leaf and level edges,
              int32 and int8 levels, every flag) and at 65,536 and
              1,048,576 rows, the loads' 4-row probes latched.  Then the
              annotate kernel's packed entry (``annotate_bin_packed``:
              nibble-packed alleles in, the packed rows out) against the
              three-kernel route it replaces (inflate, ``annotate_bin``,
              pack) byte for byte and against its plain composition
              under the selection contract, on
              :func:`annotate_packed_cases` (W = 1, 2, 7, 8, 49, 96 and
              192, ceil(W / 2) and three more packed columns, 0 to 257
              rows and all 536, every packed byte value) and at 65,536
              and 1,048,576 rows, from unaligned bases, its first-use
              check latched; then, in the second process, the transport
              kernels' time at those shapes beside the plain versions
              and the bound, and the packed entry in turns with the
              three-kernel route.  Then the annotate kernel's identity
              entry (``annotate_bin_identity``: allele matrices and
              lengths in, the VEP pack's ``[n, 6]`` rows out) against its
              plain composition, every byte of every row, and against
              the two-launch route it replaces (``annotate_bin``,
              ``pack_vep_outputs``) where W <= 192, on
              :func:`annotate_identity_cases` (W = 1, 7, 49, 192 and
              255; shared leading runs across the scan's word steps and
              up to the width, over-width, SNV, empty and noisy rows; 0
              to 257 rows and all of them) and at 65,536 and 1,048,576
              rows, from unaligned bases and into an unaligned output,
              its first-use check latched; then, in the second process,
              in turns with the two-launch route at 1, 16,384, 65,536
              and 1,048,576 rows beside its bound and plain version.  The
              seeded inputs of phases 3-10 are written by the second
              process beside the first kernel checks, which read none of
              them;
4. load     — a seeded dbSNP-shaped chr22 VCF of 2,000,000 lines through
              ``python -m annotatedvdb_tpu_torch load-vcf --commit`` (the
              CLI's ``main``) with no engine or pipeline variable: the
              native tokenizer, the overlapped executor and the async
              store writer must all run.  Every kernel launch counter and
              the plain hash's call counter are reset just before and read
              just after (the card path must never call the plain hash;
              the packed transport on by default on the card: one launch
              of the annotate kernel's packed entry per chunk uploaded
              nibble-packed, plus one in the CLI's ``warmup`` at the chunk
              shape, and ``annotate_bin`` and ``pack_outputs`` once per
              chunk uploaded raw; no ``inflate_alleles``); the loader's
              per-thread stage seconds, queue stalls,
              device idle fraction, warmup seconds and transport counts.
              Then (4b) the same file under ``AVDB_PIPELINE=serial
              AVDB_ASYNC_STORE=0`` into a second store, whose bytes must
              be identical, and (4c) the transport's A/B: the first
              500,000 lines in turns under ``AVDB_PACK_TRANSPORT`` auto,
              never, never, auto into fresh stores (walls, ``dispatch``
              and ``annotate`` seconds, upload widths): all four stores
              byte-equal;
5. reload   — 500,000 lines, half of them copies of phase-4 lines, probed
              on the card (``AVDB_DEVICE_LOOKUP=always``); the duplicate
              count must be the one the generator predicts;
6. parity   — the first 3,125 lines loaded on the card and on the CPU,
              then updated from 781 VEP results for the variants of
              their first half (``load-vep``, the ranking file re-ranked
              on load and saved on each of 5 learned combos), once with
              the Python tokenizer, the serial executor and the Python
              VEP transform (``AVDB_NATIVE_VEP=0``) and once in the
              default configuration (the native tokenizer and VEP
              transform): in each, the persisted store bytes and the
              saved ranking files must be identical, the VEP counters the
              ones the generator predicts.  Then, in each configuration,
              the three update commands in turn on the same stores: a QC
              pVCF over the first 1,562 lines with 10% novel rows, a
              SnpEff file over all of them and a METASEQ TSV of 781
              rows with 5% novel: the stores identical after each, the
              counters as predicted, and on the card the predicted
              annotate launches (the identity entry once per chunk or
              batch hashed on the device, the packed entry once per
              insert of novel rows).  Then, in each
              configuration (the Python one also under
              ``AVDB_NATIVE_CADD=0``), ``load-cadd --commit`` against
              seeded BGZF tables over the lines' span, ``--buildIndex``
              (once per configuration: it reads only the tables), an
              indexed ``--fileName`` update of the first 625 lines with
              ``--updateExisting``, ``export-vcf`` and ``undo`` of the QC
              update: stores and export files identical card against CPU
              after each, the predicted ``cadd_join`` launches, no plain
              join on the card.  The loads run with ``--refGenome`` (the
              GRCh38-shaped genome): card and CPU stores and ledgers
              identical, one ``validate_ref`` launch per inserting chunk
              and one annotate launch per chunk (and the warmup's), no
              plain version on the card; and after
              the last step ``install-schema --storeDir`` of each store:
              identical output trees, one ``annotate_bin`` launch per
              65,536-row egress window.  Then the crash check
              (:func:`chaos_load_check`): the lines loaded at 700 rows a
              checkpoint in processes killed by ``AVDB_FAULT`` at
              ``store.save.pre_manifest:2:kill`` and
              ``ledger.append:4:torn_write``, on the card and the CPU
              (each must die by SIGKILL), then resumed: card and CPU
              stores identical, rows equal an uninterrupted card load's,
              one launch a chunk past the durable checkpoint.  Before the
              crash check: the lines loaded with display attributes stored
              on the card and on the CPU (byte-equal), then under
              ``AVDB_STORE_SPILL_BYTES=1`` (memmapped segments) and
              ``AVDB_DEVICE_LOOKUP=always`` reloaded (the device probe
              uploading from the memmaps) and VEP-updated on each device:
              byte-equal;
7. vep      — a seeded VEP JSON of 50,000 results (1-6 transcript
              consequences from the seed ranking each, regulatory, motif
              and intergenic blocks and colocated frequencies on shares,
              ~2% for alleles the store lacks, 20 novel combos, one
              malformed line) updates phase 4's store through
              ``python -m annotatedvdb_tpu_torch load-vep --commit`` (the
              CLI's ``main``), counters reset just before and read just
              after, in the default configuration (the native C++
              transform): counters as predicted, every planted combo
              learned, one launch of the annotate kernel's identity
              entry per identity batch (the docs the transformer hands
              to the Python transform) and no ``annotate_bin`` or
              ``pack_vep_outputs``, no
              plain hash on the card, the transform's own counts, the
              device's idle share (``torch.profiler``) and how the store
              save splits between JSON encoding and the rest.  Before it,
              the transformer's allele hash over the file's blocks is held
              against the kernel's on the card.  Then (7b) a 10,000-result
              file over the first tenth of the lines, in the default
              configuration and under ``AVDB_NATIVE_VEP=0``, each onto a
              copy of the store made before phase 7: the two saved stores
              must decode equal, and the Python transform's load one
              identity-entry launch per identity batch and no
              ``annotate_bin`` or ``pack_vep_outputs`` (the entry's time
              at a one-row batch is phase 3's);
8. updates  — on a store of phase 4's first 125,000 lines, loaded for
              it with ``load-vcf`` (each update command loads and saves
              its whole store, and at phase 7's 2.27M rows those, not the
              lines, set the wall), through the CLIs' ``main`` with
              ``--commit`` in the default configuration, each with the
              counters reset just before and read just after: a seeded
              ADSP-QC-shaped pVCF of 25,000 of those lines (QUAL, FILTER
              PASS on 85%, numeric INFO keys and a flag, a repeated key on
              1%, FORMAT and a sample; 10% new SNVs, 3% of those with two
              alts) with ``--version r4``; a SnpEff VCF of 25,000 phase-4
              identities, 6% with ``LOF=`` and/or ``NMD=``; a METASEQ TSV
              of 12,500 rows (``other_annotation`` JSON, ``ref_snp_id``),
              5% new insertions.  Each: counters as the generator
              predicts, the predicted annotate launches (each insert one
              of the packed entry, each lookup hash one of the identity
              entry), no plain
              hash on the card, stage seconds, wall, lines/s and the
              device's idle share (``torch.profiler``).  The first kernel
              step of a lookup hash (a TSV batch, 12,500 rows) and of a
              novel-row insert (a QC chunk's new rows) is kept and, after
              the run, held against the plain versions on the same inputs:
              the annotate fields under the selection contract, the hash
              exact on every row;
9. cadd     — ``load-cadd --commit`` through the CLI's ``main`` on a copy
              of the store of phases 4 and 5 made before phase 7 (no VEP
              sidecars), against seeded BGZF tables over chr22:16,000,001-
              19,000,000: the SNV table every position with its three
              alternate bases (9,000,000 rows; the ref base is the
              store's where it holds a row), the indel table runs of 1-6
              rows at about one position in 20 with half the store's
              indels planted (a third swapped, some twice, some beside or
              as over-width alleles, one at the end of a 32-row run), one
              malformed line in each.  Every counter reset just before,
              read just after: the counters and ``cadd_join`` launches the
              generator predicts, no plain join and no ``annotate_bin`` on
              the card; the store reloads and 100 sampled rows carry the
              tables' text-parsed floats; wall, rows scanned/s, stage and
              store seconds, blocks, bytes uploaded and the device's idle
              share (``torch.profiler``);
10. refgenome — ``index-genome`` of a FASTA of the seeded chr22 (its
              full 50,818,468 bases, N and lowercase runs) and a short
              chr21 with IUPAC codes: lossy flags, chr22's arrays equal to
              the generator's, sampled ``fetch`` windows equal to the text.
              Then ``load-vcf --refGenome --commit`` of the first 62,500
              phase-4 lines plus five at chr22's end into a fresh store,
              every counter reset just before and read just after:
              ``ref_mismatch`` and rows as the generator counts them by
              string comparison, one ``validate_ref`` launch per chunk
              that inserts rows, one annotate launch per chunk and the
              warmup's, no plain
              version on the card, digest PKs on chr22's ``SQ.`` id;
              wall, lines/s, the genome's load and upload seconds, the
              validation's seconds and the device's idle share.  Then
              ``install-schema --storeDir`` of that store (COPY rows equal
              to store rows, one launch per window; wall, rows/s) and
              ``bin-references`` for GRCh38 (395,448 rows);
11. serve   — ``python -m annotatedvdb_tpu_torch serve --port 0`` on
              phase 9's store (CADD scores and FREQ allele frequencies; no
              ranks), once with the default front end (``aio``), then
              with ``--frontend threaded``, then as a fleet of four
              ``aio`` workers on the one card (``--workers 4``: ready
              once every worker is), in turns, each with 8 client
              threads sending the same seeded mix: 1,000 point ids (5%
              absent), 5 bulk calls of 10,000 ids, 32 region walks of
              three pages (10 kb-1 Mb, ``minCadd=20``), 8 ``POST
              /regions`` batches of 4,096 gene-panel intervals (half
              count-only, half two rows each with ``tokenize``) and 8
              ``POST /stats/region`` batches of 4,096 with ``windows`` 16
              (half the earlier mix, cut for the smoke's wall).  Every body of both front ends
              equal to the host-only engine's answer (computed after the
              traffic windows by four spawned helper processes, idle while
              they run); each server's kernel launches as predicted (a
              fleet's summed over its workers' shutdown summaries), no
              breaker failure and no plain version on the card; per turn
              p50/p99 per kind, requests/s, intervals/s, the device's
              idle share (an upper bound: phase 3's kernel times times
              the launches) and bytes held (each worker's, and
              ``nvidia-smi``'s used memory in a fleet's window), the
              requests each worker answered, the store load, index build
              and feature decode seconds.  Every server runs the default
              health plane and flight recorder: each process's ticks
              (its history mirror's samples, none failed); the fleet's
              ``/metrics?fleet=1`` counting four live workers and their
              summed requests, ``/alerts?fleet=1`` (availability ``ok`` on
              every worker) and ``/metrics/history`` scraped once after its
              traffic; then a ``HealthPlane`` tick timed on the ``aio``
              server's registry, rebuilt from its last sample.  The
              ``aio`` server runs with ``AVDB_SERVE_CHAOS=1``: after its
              traffic, ``POST /_chaos`` arms
              ``engine.device_probe:prob:1.0:eio`` (ttl 1 s), bulk calls
              open the chr22 breaker, ``/regions`` and ``/stats/region``
              answer from the host path (sent from threads of their own
              while the breaker is polled), a half-open probe re-closes
              it and the kernels launch again, every body equal to the
              host-only answer; the window's launches are read apart from
              the traffic's (the server's ``counts so far`` on SIGUSR1
              before the arming, after the open window and at its end):
              none while open, one ``bits_spans``, two ``stats_panel``
              and one ``windowed_stats`` once closed; ``GET
              /debug/trace`` is parsed (:func:`chaos_serve_check`);
12. export  — ``python -m annotatedvdb_tpu_torch export --commit --seed 7``
              (the CLI's ``main``) of phase 9's store (chr22, 2,274,305
              rows), once on the card and once with ``--hostOnly``, each
              with the counters reset just before: the corpora the same
              bytes, 556 batches as the interval index predicts and one
              ``export_pack`` launch a part (37 batches a part: 16), no
              plain version on the card; wall, rows/s, tokens/s and the
              wall split (``ChromPrep.build``, the gather on the prefetch
              thread, the device round trip once a part, the ``bin_path``
              loop, part writes).  Then 32 ``/export/stream``
              payloads (``stream_payload``) of seeded slices on a card
              engine over the store, counters reset just before: one launch
              a call, every body equal to the ``host_only`` answer.  Then
              ``export`` of a copy of phase 6's card store (512-row
              batches, a part each) killed at ``export.pack:2:kill`` (by
              SIGKILL, one part committed) and resumed to a clean run's
              corpus, one launch a part written
              (:func:`chaos_export_check`);
13. doctor  — ``doctor`` through the CLI's ``main`` on card-written
              stores: ``--deep --json`` of phase 9's store (exit 0, clean),
              ``status --json`` and ``profile`` of it, every group's
              profile equal to the ``/stats/region`` body over the whole
              chromosome from phase 12's card engine (one ``stats_panel``
              launch); a copy of phase 6's card store with a segment file
              truncated (exit 2, ``--repair`` exit 1, then exit 0, and it
              loads); ``replay-rejects`` of a rejects file a Python-engine
              ``load-vcf`` of a VCF with five malformed lines wrote (the
              lines back verbatim).  The card's allocated bytes must not
              move while ``doctor`` runs; walls of each verb;
14. upsert  — ``serve --workers 2 --upserts --maintain`` on phase 9's
              store with the memtable's flush bound set so the third
              upsert crosses it and the maintenance daemon's high
              watermark one above the chr22 group's segment files:
              three upserts of 2,048 chr22 rows (half new identities, half
              stored rows, which come back shadowed), each followed on the
              same connection by a ``/regions`` and a ``/stats/region``
              read of 64 intervals tiling its 200-kb window that must count
              the new rows; the read-after-upsert and ack latencies; the
              worker whose WAL holds the first two is SIGKILLed, respawned,
              replays them and serves them byte for byte; the flush
              commits and truncates the WAL, every worker serves the rows
              after one snapshot TTL; the flush trips the daemon, which
              compacts the group under the live fleet (its ledger record:
              files, bytes, rows, dropped duplicates, seconds) and both
              workers swap onto the compacted generation; the fleet's
              ``/regions`` and ``/stats/region`` bodies equal a host-only
              engine's over the flushed store (hard-linked aside before
              the pass), the launches of the surviving workers equal the
              reads sent after the kill.  Beside the fleet, ``serve
              --follow`` (``aio``, one process, on the card) bootstraps
              into an empty directory, tails the upserts (the same reads
              give the leader's bodies after each upsert: seconds from
              the ack, replication lag), re-syncs across the flush and
              the compaction (seconds from each commit), serves the
              host-only engine's bodies over every window, answers an
              upsert with 403, and launches once a read sent to it.
              The supervisor harvests the killed worker's flight ring and
              history into ``flight/`` and ``history/``; after a clean
              stop ``doctor promote`` seals the follower and ``doctor
              --deep`` finds both stores clean, while ``doctor flight``
              (the killed worker's box and its last requests), ``doctor
              slo`` (its harvested history) and ``doctor trace`` (the
              daemon's ``ledger.compact`` span and lifecycle events) run
              on the leader's store, each timed.

15. mesh    — run by the second process beside phase 14 (which keeps
              the card mostly idle while its fleet waits), its counts
              set to 0 there just before it: the device mesh over
              ``AVDBC_VIRTUAL_DEVICES=4`` shards of ``cuda:0``: a seeded
              VCF of 500,000 lines (cut from 1,000,000 for the smoke's
              time) over chromosomes 1-22, X, Y and MT in proportion to
              their GRCh38 lengths, sorted as real VCFs are (written by
              the second process beside phases 10-13, untimed), through
              ``load-vcf --maxWorkers 4``, then ``load-vep --maxWorkers
              4`` with 20,000 results and ``load-cadd --maxWorkers 4``
              over a 1-Mbp span on three chromosomes, and the same three
              commands with ``--maxWorkers 1`` into another store: the
              two stores equal after each command (digests), the printed
              counters equal, the walls, four ``annotate_bin`` launches
              a chunk on the mesh and the ``lookup_multi`` launches.
              Then an in-process ``serve`` (``aio``) on the mesh store
              with ``AVDB_SERVE_MESH=1``: 32 bulk lookups of 256 ids
              over every chromosome, 16 ``/regions`` panels over 8
              groups and 8 ``/stats/region`` calls, every body equal to
              a host-only server's (an ``aio`` server on the CPU over the
              other store); the ``MeshExecutor`` stats and the
              ``lookup_multi`` and ``bits_spans_stacked`` launches;
              ``POST /_chaos`` arms ``mesh.dispatch``
              (``AVDB_SERVE_CHAOS=1``): the bulks answer the same bodies
              through the single-device path, the breaker's mesh group
              opens and, the fault disarmed and its cool-down (shortened
              to 1 s here) past, re-closes through the mesh.  A
              one-process ``nccl`` world on a loopback coordinator (a
              child process started with the phase) runs
              ``distributed_annotate_step`` on a seeded batch over the
              four shards: its counts equal the in-process run's.  The
              phase prints its own seconds.

Then a ``leftovers`` line (the smoke fails if any process it started
outlived its phase: those still running are listed and SIGKILLed; the
card's compute processes and used memory beside them), one ``chaos``
line (each crash check's numbers and seconds), the kernel table and, as
the last line,
``{"ok": true, "device": {"platform": "gpu", ...}}``.  Any failure exits
non-zero without that line.  Needs one CUDA card and the repository
checkout around this file; run as ``python3 chip_smoke.py``.
"""

from __future__ import annotations

import collections.abc
import contextlib
import glob
import json
import os
import shutil
import subprocess
import sys
import threading
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "build", "chip_smoke")
WIDTH = 49
#: allele widths of the kernels' edge cases: below, at and past the 32-
#: and 64-byte columns the kernels work in, and the load's 49
EDGE_WIDTHS = (16, 31, 32, 33, 49, 64, 65, 96)
CHUNK_ROWS = 65_536
BIG_ROWS = 1 << 20
#: the mesh kernels' launches in a serving process that runs no mesh (every
#: serve process's run summary counts them; phases 11 and 14 serve without)
MESH_IDLE = {"bits_spans_stacked": 0, "lookup_multi": 0}
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


#: when the module was loaded: each emitted line's ``t_s`` counts from it
T0 = time.perf_counter()


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields,
                      "t_s": time.perf_counter() - T0}), flush=True)


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


# ------------------------------------------------------------ CADD writers

POS_SENTINEL = 2**31 - 1
CADD_BLOCK_ROWS = 1 << 18       # io/cadd.py's block capacity
SNV_PROBE, INDEL_PROBE = 4, 32  # ops/cadd_join.py's probe depths
SNV_TABLE = "whole_genome_SNVs.tsv.gz"
INDEL_TABLE = "gnomad.genomes.r3.0.indel.tsv.gz"
CADD_HEADER = b"## CADD GRCh38-v1.7\n#Chrom\tPos\tRef\tAlt\tRawScore\tPHRED\n"


#: block sizes of the small-block edge cases: below one warp's 32 lanes,
#: one short of it, and past it without being a multiple of it
CADD_SMALL_K = (5, 31, 33, 45)
#: the probe depth of the window-crossing case beyond the loader's two
CADD_WIDE_PROBE = 48


def cadd_edge_cases(width):
    """Seeded edge blocks of the CADD join at ``width``: a list of (label,
    (vpos, vref, valt, spos, sref, salt), probe) at both probe depths — a
    match at probe offset ``probe - 1``, two matching rows (the first
    wins), swapped allele orientation, an allele set holding both of a
    variant's alleles, probes past the last row (``lo + k > K - 1``),
    variants before and after every row, a variant at 2147483647 against
    sentinel rows, N = 0 and K = 1; the same variants in reverse order
    (``-unsorted``); a run of exactly ``probe`` rows ending at row K - 1
    (``-tail``); a 40-row run over rows 30-69, across 32-row boundaries
    (``-cross``, also at probe :data:`CADD_WIDE_PROBE`); and blocks of
    :data:`CADD_SMALL_K` rows in runs of two (``-k5`` ...)."""
    tri = ["".join(t) for t in zip(*(np.repeat(list("ACGT"), 16),
                                     np.tile(np.repeat(list("ACGT"), 4), 4),
                                     np.tile(list("ACGT"), 16)))]

    def arrays(rows, variants, pad):
        rows = rows + [(POS_SENTINEL, "", "")] * pad
        spos = np.array([p for p, _, _ in rows], np.int32)
        vpos = np.array([p for p, _, _ in variants], np.int32)
        return (vpos, encode([r for _, r, _ in variants], width)[0],
                encode([a for _, _, a in variants], width)[0],
                spos, encode([r for _, r, _ in rows], width)[0],
                encode([a for _, _, a in rows], width)[0])

    # 30 single rows, a 40-row run at 100 (rows 30-69), one row after,
    # sentinels up to 128 rows
    cross_rows = ([(10 + 2 * j, "A", "C") for j in range(30)]
                  + [(100, "G", t) for t in tri[:40]] + [(110, "A", "T")])
    cross_variants = [(100, "G", tri[0]), (100, "G", tri[2]), (100, tri[31], "G"),
                      (100, "G", tri[32]), (100, "G", tri[39]), (100, "G", "T"),
                      (110, "A", "T"), (40, "A", "C"), (41, "A", "C")]

    def cross(probe):
        return (f"edge-p{probe}-w{width}-cross",
                arrays(cross_rows, cross_variants, 128 - len(cross_rows)), probe)

    cases = []
    for probe in (SNV_PROBE, INDEL_PROBE):
        deep = [(200, "C", t) for t in tri if t != "T"][: probe - 1] + [(200, "C", "T")]
        rows = ([(100, "A", "C"), (100, "A", "G"), (100, "A", "T")] + deep
                + [(300, "G", "A"), (300, "A", "G"), (400, "C", "T"),
                   (450, "AT", "A"), (500, "T", "G")])
        variants = [(100, "A", "G"), (100, "A", "A"), (100, "C", "G"),
                    (200, "C", "T"), (200, "T", "C"), (200, "C", "G"),
                    (300, "G", "A"), (300, "A", "G"), (400, "T", "C"),
                    (450, "A", "AT"), (450, "AT", "ATT"), (500, "T", "G"),
                    (500, "G", "T"), (500, "T", "A"), (50, "A", "C"),
                    (600, "T", "G"), (POS_SENTINEL, "A", "C")]
        cases.append((f"edge-p{probe}-w{width}", arrays(rows, variants, 0), probe))
        pad = int(2 ** np.ceil(np.log2(len(rows) + 1))) - len(rows)
        cases.append((f"edge-p{probe}-w{width}-sentinels",
                      arrays(rows, variants, pad), probe))
        cases.append((f"edge-p{probe}-w{width}-n0", arrays(rows, [], pad), probe))
        cases.append((f"edge-p{probe}-w{width}-k1", arrays(
            [(500, "T", "G")],
            [(500, "T", "G"), (500, "G", "T"), (500, "T", "A"), (499, "T", "G"),
             (501, "T", "G")], 0), probe))
        cases.append((f"edge-p{probe}-w{width}-unsorted",
                      arrays(rows, variants[::-1], pad), probe))
        # the run at 200 is the block's last `probe` rows: K - 1 is its
        # last row, the deep match
        tail = [(100, "A", "C"), (150, "G", "T")] + deep
        cases.append((f"edge-p{probe}-w{width}-tail", arrays(
            tail, [(200, "C", "T"), (200, "T", "C"), (200, "C", deep[0][2]),
                   (200, "C", "G"), (200, "G", "C"), (250, "A", "C"),
                   (150, "T", "G")], 0), probe))
        cases.append(cross(probe))
        for k in CADD_SMALL_K:
            small = [(1000 + 10 * (j // 2), "A", tri[j]) for j in range(k)]
            cases.append((f"edge-p{probe}-w{width}-k{k}", arrays(
                small, [(1000, "A", tri[0]), small[-1], (small[k // 2][0], tri[k // 2], "A"),
                        (small[k // 2][0], "A", "T"), (5, "A", tri[0]),
                        (2000, "A", tri[0])], 0), probe))
    cases.append(cross(CADD_WIDE_PROBE))
    return cases


def _bases(rng, n, lengths, width):
    """[n, width] uint8 random base rows, zero past ``lengths``."""
    b = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, (n, width))]
    return np.where(np.arange(width)[None, :] < lengths[:, None], b, 0).astype(np.uint8)


def cadd_random_block(seed, n, k, width, probe, snv):
    """A seeded position-sorted score block and ``n`` variants against it,
    as (vpos, vref, valt, spos, sref, salt).  ``snv``: the SNV table's
    shape, three rows per position (its ref and the other three bases);
    else indel-like rows (1-8 bases) in runs of 1-``probe`` (geometric,
    with one run in 97 exactly ``probe`` long).  The ``k`` real rows are
    padded with sentinel rows up to a power of two, as ``io/cadd.py`` pads
    a block.  Variants: 60% copies of a row (a third of them swapped), 20% at
    a row's position with other alleles, 20% at random positions."""
    rng = np.random.default_rng(seed)
    if snv:
        k -= k % 3
        m = k // 3
        runs = np.full(m, 3)
    else:
        runs = np.minimum(rng.geometric(0.35, k), probe)
        runs[::97] = probe
        m = int(np.searchsorted(np.cumsum(runs), k)) + 1
        runs = runs[:m]
        runs[-1] -= int(runs.sum()) - k
    site = 1000 + np.cumsum(rng.integers(1, 20, m))
    spos = np.repeat(site, runs).astype(np.int32)
    if snv:
        ref_base = rng.integers(0, 4, m)
        alt_base = (ref_base[:, None] + np.arange(1, 4)[None, :]) % 4
        lut = np.frombuffer(b"ACGT", np.uint8)
        sref = np.zeros((k, width), np.uint8)
        salt = np.zeros((k, width), np.uint8)
        sref[:, 0] = lut[np.repeat(ref_base, 3)]
        salt[:, 0] = lut[alt_base.reshape(-1)]
    else:
        sref = _bases(rng, k, rng.integers(1, 9, k), width)
        salt = _bases(rng, k, rng.integers(1, 9, k), width)
    kind = rng.random(n)
    pick = rng.integers(0, k, n)
    vpos = spos[pick].copy()
    vref, valt = sref[pick].copy(), salt[pick].copy()
    swap = (kind < 0.2)
    vref[swap], valt[swap] = salt[pick][swap], sref[pick][swap]
    other = (kind >= 0.6) & (kind < 0.8)
    lens = rng.integers(1, 2 if snv else 9, (2, n))
    vref[other] = _bases(rng, n, lens[0], width)[other]
    valt[other] = _bases(rng, n, lens[1], width)[other]
    rand = kind >= 0.8
    vpos[rand] = rng.integers(500, int(site[-1]) + 50, int(rand.sum()))
    order = np.argsort(vpos, kind="stable")
    cap = 1 << int(np.ceil(np.log2(k)))
    spos = np.concatenate([spos, np.full(cap - k, POS_SENTINEL, np.int32)])
    sref = np.concatenate([sref, np.zeros((cap - k, width), np.uint8)])
    salt = np.concatenate([salt, np.zeros((cap - k, width), np.uint8)])
    return vpos[order], vref[order], valt[order], spos, sref, salt


def cadd_snv_score_text(pos, alt_code):
    """The SNV table's (RawScore, PHRED) text at ``pos`` for the alternate
    base ``"ACGT"[alt_code]``: a fixed function of the two, so a check can
    recompute any row's scores."""
    raw = (int(pos) * 2654435761 + int(alt_code) * 40503) % 10_000_000
    phred = (int(pos) * 7919 + int(alt_code) * 104729) % 100_000
    return (f"{raw // 1_000_000}.{raw % 1_000_000:06d}",
            f"{phred // 1000:02d}.{phred % 1000:03d}")


def _digits(m, col, values, n):
    """Write ``n`` decimal digits of ``values`` into ``m[..., col:col + n]``."""
    for d in range(n):
        m[..., col + d] = 48 + (values // 10 ** (n - 1 - d)) % 10


def snv_table_bytes(label, p0, p1, ref_codes):
    """The SNV table's lines for every position of ``p0..p1`` (inclusive),
    three rows a position (the ref base ``"ACGT"[ref_codes[i]]`` and the
    other three bases in ACGT order), built as one byte matrix
    [positions, 3, line] per run of positions with the same digit count."""
    out = []
    p = p0
    lut = np.frombuffer(b"ACGT", np.uint8)
    while p <= p1:
        nd = len(str(p))
        hi = min(p1, 10 ** nd - 1)
        pos = np.arange(p, hi + 1, dtype=np.int64)
        rc = np.asarray(ref_codes[p - p0:hi - p0 + 1], np.int64)
        idx = np.arange(3)[None, :]
        ac = idx + (idx >= rc[:, None])
        head = (label + "\t").encode()
        width = len(head) + nd + 1 + 2 + 2 + 9 + 7
        m = np.empty((pos.size, 3, width), np.uint8)
        m[..., :len(head)] = np.frombuffer(head, np.uint8)
        c = len(head)
        _digits(m, c, pos[:, None].astype(np.int32), nd)
        c += nd
        m[..., c], m[..., c + 2], m[..., c + 4] = 9, 9, 9
        m[..., c + 1] = lut[rc][:, None]
        m[..., c + 3] = lut[ac]
        c += 5
        raw = ((pos[:, None] * 2654435761 + ac * 40503) % 10_000_000).astype(np.int32)
        phred = ((pos[:, None] * 7919 + ac * 104729) % 100_000).astype(np.int32)
        m[..., c] = 48 + raw // 1_000_000
        m[..., c + 1] = ord(".")
        _digits(m, c + 2, raw % 1_000_000, 6)
        m[..., c + 8] = 9
        c += 9
        _digits(m, c, phred // 1000, 2)
        m[..., c + 2] = ord(".")
        _digits(m, c + 3, phred % 1000, 3)
        m[..., c + 6] = 10
        out.append(m.tobytes())
        p = hi + 1
    return b"".join(out)


def cadd_block_ranges(rpos, block_rows=CADD_BLOCK_ROWS):
    """Row ranges of the blocks ``io/cadd.py`` cuts from one chromosome's
    sorted row positions: at capacity, the trailing same-position run is
    peeled back into the next block (a run filling a whole block is cut
    mid-run)."""
    out, start, n = [], 0, rpos.size
    while start < n:
        if n - start < block_rows:
            out.append((start, n))
            break
        end = start + block_rows
        cut = int(np.searchsorted(rpos[start:end], rpos[end - 1], side="left")) + start
        cut = end if cut == start else cut
        out.append((start, cut))
        start = cut
    return out


def cadd_join_launches(rpos, host_pos, cand_pos, cand_over, block_rows=CADD_BLOCK_ROWS):
    """``cadd_join`` launches of one chromosome's table pass: one per block
    whose window (the candidates between the block's first and last
    position) holds a candidate on the device path (not over the width,
    not at a position with an over-width table row) and whose block holds
    device rows."""
    launches = 0
    for lo, hi in cadd_block_ranges(rpos, block_rows):
        b = rpos[lo:hi]
        if np.isin(b, host_pos).all():
            continue
        wlo = np.searchsorted(cand_pos, b[0], side="left")
        whi = np.searchsorted(cand_pos, b[-1], side="right")
        if whi == wlo:
            continue
        host = cand_over[wlo:whi] | np.isin(cand_pos[wlo:whi], host_pos)
        launches += int(not host.all())
    return launches


def write_cadd_tables(db_dir, sites, spans, seed, width=49, level=6,
                      chunk=1 << 20, block_rows=CADD_BLOCK_ROWS):
    """The two CADD tables, BGZF at ``level``, for a store of ``sites``
    ((label, pos, ref, [alts]) per VCF line; '.' alts dropped), covering
    ``spans`` ({label: (start, end)}):

    - ``whole_genome_SNVs.tsv.gz``: every position of each span with its
      three alternate bases; where a store row sits, the ref base is that
      row's first ref base, so every stored SNV in a span matches;
    - ``gnomad.genomes.r3.0.indel.tsv.gz``: runs of 1-6 rows at about one
      position in 20; half of the store's indels in the spans planted in a
      run of 1-6 rows, a third of them swapped; at up to 20 planted
      positions a second matching row after the first (the first wins); at
      up to 10 positions an allele wider than ``width`` (store over-width
      deletions planted with their full strings, and long non-matching
      rows beside a planted match) for the host path; one planted run of
      exactly 32 rows whose match is its last row;
    - one malformed (two-field) line in each.

    Returns the predictions: the counters of a first whole-store update
    (``snv``, ``indel``, ``not_matched``, ``update``, ``skipped``), the
    ``cadd_join`` launches and blocks per table, the table rows, and
    ``expected`` ({(label, pos, ref, alt): (raw text, phred text)} of every
    planted indel; SNV scores come from :func:`cadd_snv_score_text`)."""
    import random

    from annotatedvdb_tpu_torch.io.bgzf import BgzfWriter

    rng = np.random.default_rng(seed)
    rnd = random.Random(seed)
    os.makedirs(db_dir, exist_ok=True)
    order = {str(c): c for c in range(1, 23)} | {"X": 23, "Y": 24, "M": 25}
    labels = sorted(spans, key=order.get)
    pool = ["".join(BASES[rng.integers(0, 4, int(n))])
            for n in rng.integers(7, 10, 4096)]
    pred = {"snv": 0, "indel": 0, "candidates": 0, "launches": {"snv": 0, "indel": 0},
            "blocks": {"snv": 0, "indel": 0}, "rows": {"snv": 0, "indel": 0},
            "expected": {}}

    def other(anchor):
        """A row that matches no store allele (one allele of 8-10 bases)."""
        s = anchor + pool[rnd.randrange(4096)]
        return (anchor, s) if rnd.random() < 0.5 else (s, anchor)

    def score():
        raw, ph = rnd.randrange(10_000_000), rnd.randrange(100_000)
        return (f"{raw // 1_000_000}.{raw % 1_000_000:06d}",
                f"{ph // 1000:02d}.{ph % 1000:03d}")

    snv_w = BgzfWriter(os.path.join(db_dir, SNV_TABLE), level=level)
    indel_w = BgzfWriter(os.path.join(db_dir, INDEL_TABLE), level=level)
    snv_w.write(CADD_HEADER)
    indel_w.write(CADD_HEADER)
    malformed = {"snv": True, "indel": True}
    for label in labels:
        table_label = "MT" if label == "M" else label
        start, end = spans[label]
        ids = [(p, r, a) for lab, p, r, alts in sites if lab == label for a in alts]
        ids.sort(key=lambda t: t[0])
        pos_a = np.array([p for p, _, _ in ids], np.int64)
        is_snv = np.array([len(r) == 1 and len(a) == 1 for _, r, a in ids], bool)
        over = np.array([len(r) > width or len(a) > width for _, r, a in ids], bool)
        pred["candidates"] += len(ids)
        in_span = (pos_a >= start) & (pos_a <= end)
        pred["snv"] += int((is_snv & in_span).sum())
        # SNV table: the store's first ref base where it has a row
        ref_codes = rng.integers(0, 4, end - start + 1)
        firsts = np.array(["ACGT".index(r[0]) for _, r, _ in ids], np.int64)
        ref_codes[pos_a[in_span] - start] = firsts[in_span]
        for p in range(start, end + 1, chunk):
            q = min(end, p + chunk - 1)
            snv_w.write(snv_table_bytes(table_label, p, q, ref_codes[p - start:q - start + 1]))
            if malformed["snv"]:
                snv_w.write(f"{table_label}\t{q}\n".encode())
                malformed["snv"] = False
        rpos = np.repeat(np.arange(start, end + 1, dtype=np.int64), 3)
        pred["rows"]["snv"] += rpos.size
        pred["blocks"]["snv"] += len(cadd_block_ranges(rpos, block_rows))
        pred["launches"]["snv"] += cadd_join_launches(
            rpos, np.empty(0, np.int64), pos_a[is_snv], over[is_snv], block_rows)
        del rpos
        # indel table: planted runs (per row, few), then background runs
        # (vectorized draws), merged in position order
        planted_runs: dict[int, list] = {}
        indel = [(i, ids[i]) for i in np.flatnonzero(~is_snv & in_span)]
        planted = [(i, t) for i, t in indel if rnd.random() < 0.5 or over[i]]
        long_store = [(i, t) for i, t in planted if over[i]][:5]
        planted = [(i, t) for i, t in planted if not over[i]] + long_store
        normal = [k for k, (i, _t) in enumerate(planted) if not over[i]]
        rnd.shuffle(normal)
        deep, dups, longs = set(normal[:1]), set(normal[1:21]), set(normal[21:26])
        for k, (_i, (pos, ref, alt)) in enumerate(planted):
            n = 32 if k in deep else rnd.randint(1, 6)
            at = n - 1 if k in deep else rnd.randrange(n)
            rows = [other(ref[0]) + score() for _ in range(n)]
            hit = (alt, ref) if rnd.random() < 1 / 3 else (ref, alt)
            rows[at] = hit + score()
            if k in dups:
                rows.insert(at + 1, (hit[1], hit[0]) + score())
            if k in longs:
                rows.append((ref[0], ref[0] + "".join(rnd.choices("ACGT", k=55)))
                            + score())
            if pos in planted_runs:
                raise ValueError(f"two planted store indels at {label}:{pos}")
            planted_runs[pos] = rows
            pred["expected"][(label, pos, ref, alt)] = rows[at][2:]
        pred["indel"] += len(planted)
        host = [p for p, rows in planted_runs.items()
                if any(len(r) > width or len(a) > width for r, a, _, _ in rows)]
        lines, rpos = [], []
        for pos, rows in planted_runs.items():
            lines += [f"{table_label}\t{pos}\t{r}\t{a}\t{raw}\t{ph}\n"
                      for r, a, raw, ph in rows]
            rpos += [pos] * len(rows)
        background = start + np.flatnonzero(rng.random(end - start + 1) < 0.05)
        background = background[~np.isin(background, list(planted_runs))]
        bpos = np.repeat(background, rng.integers(1, 7, background.size))
        n_bg = bpos.size
        anchor = np.asarray(BASES)[rng.integers(0, 4, n_bg)]
        body = np.char.add(anchor, np.asarray(pool)[rng.integers(0, len(pool), n_bg)])
        ins = rng.random(n_bg) < 0.5
        raw = rng.integers(0, 10_000_000, n_bg)
        ph = rng.integers(0, 100_000, n_bg)
        lines += [f"{table_label}\t{p}\t{r}\t{a}\t{x // 1_000_000}.{x % 1_000_000:06d}"
                  f"\t{y // 1000:02d}.{y % 1000:03d}\n"
                  for p, r, a, x, y in zip(
                      bpos.tolist(), np.where(ins, anchor, body).tolist(),
                      np.where(ins, body, anchor).tolist(), raw.tolist(), ph.tolist())]
        rpos = np.concatenate([np.array(rpos, np.int64), bpos])
        order = np.argsort(rpos, kind="stable")
        rpos = rpos[order]
        lines = [lines[i] for i in order.tolist()]
        if malformed["indel"]:
            lines.insert(min(100, len(lines)), f"{table_label}\t{rpos[0]}\n")
            malformed["indel"] = False
        indel_w.write("".join(lines).encode())
        del lines
        pred["rows"]["indel"] += rpos.size
        pred["blocks"]["indel"] += len(cadd_block_ranges(rpos, block_rows))
        pred["launches"]["indel"] += cadd_join_launches(
            rpos, np.array(host, np.int64), pos_a[~is_snv], over[~is_snv], block_rows)
    snv_w.close()
    indel_w.close()
    pred["update"] = pred["snv"] + pred["indel"]
    pred["not_matched"] = pred["candidates"] - pred["update"]
    pred["skipped"] = 0
    return pred


# ------------------------------------------------------- genome writer

ACGT = np.frombuffer(b"ACGT", np.uint8)
CHR22_LENGTH = 50_818_468          # GRCh38 chr22
FASTA_WIDTH = 60
IUPAC = np.frombuffer(b"RYKMSWBDHV", np.uint8)


def pack_bases(text):
    """``text`` (uint8 ASCII, ACGT or N) as the index's arrays: 2-bit codes
    four a byte (base j at bit 2*(j%4), N as A) and the ambiguity bits
    eight a byte (bit j%8)."""
    codes = np.zeros(text.size + (-text.size) % 4, np.uint8)
    for k, b in enumerate(b"ACGT"):
        codes[: text.size][text == b] = k
    q = codes.reshape(-1, 4)
    packed = (q[:, 0] | (q[:, 1] << 2) | (q[:, 2] << 4) | (q[:, 3] << 6)).astype(np.uint8)
    return packed, np.packbits(text == ord("N"), bitorder="little")


def genome_tables(genome):
    """The genome's [26] byte offsets, mask offsets and lengths (int64;
    absent codes 0)."""
    tables = np.zeros((3, 26), np.int64)
    for code, n in genome.length.items():
        tables[:, code] = (genome.byte_offset[code], genome.mask_offset[code], n)
    return tables


def genome_text(genome, chrom, pos, width):
    """[N, width] uint8: the genome's bases (ACGT, N where masked) from
    ``pos - 1`` on for each row, 0 outside the chromosome or where the
    code is absent — decoded here from the index's arrays."""
    byte_off, mask_off, lengths = genome_tables(genome)
    code = np.asarray(chrom, np.int64)
    j = (np.asarray(pos, np.int64) - 1)[:, None] + np.arange(width)
    inside = (j >= 0) & (j < lengths[code][:, None])
    jj = np.where(inside, j, 0)
    if genome.packed.size == 0:
        return np.zeros(j.shape, np.uint8)
    b = genome.packed[byte_off[code][:, None] + (jj >> 2)]
    base = ACGT[(b >> ((jj & 3) * 2).astype(np.uint8)) & 3]
    m = (genome.n_mask[mask_off[code][:, None] + (jj >> 3)] >> (jj & 7).astype(np.uint8)) & 1
    return np.where(inside, np.where(m == 1, np.uint8(ord("N")), base), 0).astype(np.uint8)


def validate_edge_rows(genome, width):
    """Seeded edge rows for ``validate_ref`` at ``width`` against
    ``genome``: ref_len 0 (junk bytes, on a present and an absent code),
    ref_len = W (matching, and wrong in its last base), ref_len > W, pos 0
    and negative, spans ending at and crossing the chromosome's end and
    starting past it, an absent code, lowercase, N and n on a masked base,
    N on an unmasked one, other bytes (``*``, a backtick), junk bytes past
    ref_len, pos 2147483647, the first and last bases of every
    chromosome, rows ending at the last base of the chromosome stored last
    in ``packed`` (ref_len 1-5, 32, 33 and W; matching and wrong in their
    last base), and ref_len 32, 33, 64, 65 and W on the first chromosome
    with ambiguity bits and on that last one (matching, wrong in the last
    base, wrong in base 31 or 32; rows longer than W fail).  Returns (chrom
    int8, pos int32, ref uint8 [N, W], ref_len int32, want bool) —
    ``want`` is what the rows must give."""
    codes = sorted(genome.length)
    absent = next((c for c in range(1, 26) if c not in genome.length), 0)
    _, mask_off, lengths = genome_tables(genome)

    def mask_bytes(code):
        lo = int(mask_off[code])
        return genome.n_mask[lo: lo + (int(lengths[code]) + 7) // 8]

    c0 = next((c for c in codes if mask_bytes(c).any()), codes[0])
    bits = np.unpackbits(mask_bytes(c0), bitorder="little")[: int(lengths[c0])]
    mpos = int(np.argmax(bits == 1)) + 1 if bits.any() else None
    upos = int(np.argmax(bits == 0)) + 1
    n0 = int(lengths[c0])

    def text(code, pos, k):
        return bytes(genome_text(genome, [code], [pos], k)[0])

    junk = bytes((150 + 7 * i) % 256 for i in range(width))
    w = width
    full = text(c0, 1, w)
    rows = [
        (c0, 100, junk, 0, True),
        (absent, 100, junk, 0, False),
        (c0, 1, full, w, True),
        (c0, 1, full[:-1] + (b"A" if full[-1:] != b"A" else b"C"), w, False),
        (c0, 1, full, w + 5, False),
        (c0, 0, b"A", 1, False),
        (c0, 0, b"", 0, True),
        (c0, -3, b"AC", 2, False),
        (c0, n0, text(c0, n0, 1), 1, True),
        (c0, n0, text(c0, n0, 1) + b"A", 2, False),
        (c0, n0 - 2, text(c0, n0 - 2, 3), 3, True),
        (c0, n0 + 1, b"A", 1, False),
        (absent, 5, b"ACGT", 4, False),
        (c0, 11, text(c0, 11, 5).lower(), 5, True),
        (c0, upos, b"N", 1, text(c0, upos, 1) == b"N"),
        (c0, 21, text(c0, 21, 4) + junk[: w - 4], 4, True),
        (c0, 31, b"*", 1, False),
        (c0, 31, b"`", 1, False),
        (c0, 2**31 - 1, b"A", 1, False),
    ]
    if mpos is not None:
        rows += [(c0, mpos, b"N", 1, True), (c0, mpos, b"n", 1, True),
                 (c0, mpos, b"A", 1, False)]
    for code in codes:
        n = int(lengths[code])
        k = min(w, n)
        rows += [(code, 1, text(code, 1, k), k, True),
                 (code, n - k + 1, text(code, n - k + 1, k).lower(), k, True)]

    def wrong_at(r, j):
        return r[:j] + (b"C" if r[j:j + 1] == b"A" else b"A") + r[j + 1:]

    # the chromosome stored last in packed and n_mask: word loads at its
    # end reach the end of both arrays
    last = max(codes, key=lambda c: genome.byte_offset[c])
    n = int(lengths[last])
    for k in sorted({1, 2, 3, 4, 5, 32, 33, w}):
        if k <= n:
            r = text(last, n - k + 1, k)
            rows += [(last, n - k + 1, r, k, k <= w),
                     (last, n - k + 1, wrong_at(r, k - 1), k, False)]
    for code, p in ((c0, 41), (last, 37)):
        for k in sorted({32, 33, 64, 65, w}):
            if p + k - 1 <= int(lengths[code]):
                r = text(code, p, k)
                rows += [(code, p, r, k, k <= w),
                         (code, p, wrong_at(r, k - 1), k, False)]
                rows += [(code, p, wrong_at(r, j), k, False)
                         for j in (31, 32) if j < k - 1]
    m = len(rows)
    ref = np.zeros((m, w), np.uint8)
    for i, (_c, _p, r, _l, _w) in enumerate(rows):
        r = r[:w]
        ref[i, : len(r)] = np.frombuffer(r, np.uint8)
    return (np.array([r[0] for r in rows], np.int8),
            np.array([r[1] for r in rows], np.int32), ref,
            np.array([r[3] for r in rows], np.int32),
            np.array([r[4] for r in rows], bool))


def validate_random_rows(genome, n, width, seed, code=None):
    """``n`` seeded rows for ``validate_ref`` at ``width`` against
    ``genome``: refs copied from the genome (ref_len 1 on 60%, 2-6 on
    25%, 7-W on 10%, W+1..W+10 on 3%, 0 on 2%, junk bytes past ref_len),
    then 15% with one base changed, 5% partly lowercased (still
    passing), 3% on an absent code (code 0 when the genome holds all 25),
    4% moved to cross the chromosome's end or start before it, 2% with an
    N planted on an unmasked base.  Rows sit at random places on random
    chromosomes; with ``code``, they are a load's chunk instead: on that
    chromosome, 13 bp apart on average (the phase-4 VCF's spacing) from
    16,000,000 or as far as the chromosome allows, and sorted by
    position.  Returns (chrom int8, pos int32, ref uint8 [n, W], ref_len
    int32)."""
    rng = np.random.default_rng(seed)
    _, _, lengths = genome_tables(genome)
    if code is None:
        codes = np.array(sorted(genome.length), np.int64)
        chrom = codes[rng.integers(0, codes.size, n)]
    else:
        chrom = np.full(n, code, np.int64)
    length = lengths[chrom]
    u = rng.random(n)
    rl = np.where(u < 0.60, 1, np.where(
        u < 0.85, rng.integers(2, 7, n), np.where(
            u < 0.95, rng.integers(7, width + 1, n), np.where(
                u < 0.98, rng.integers(width + 1, width + 11, n), 0))))
    rl = np.minimum(rl, length).astype(np.int64)
    if code is None:
        pos = 1 + (rng.random(n) * np.maximum(length - rl, 1)).astype(np.int64)
    else:
        span = min(13 * n, int(lengths[code]))
        lo = min(16_000_000, int(lengths[code]) - span)
        pos = 1 + lo + np.sort((rng.random(n) * span).astype(np.int64))
        pos = np.minimum(pos, np.maximum(length - rl + 1, 1))
    ref = genome_text(genome, chrom, pos, width)
    col = np.arange(width)[None, :]
    junk = rng.integers(0, 256, (n, width), dtype=np.uint8)
    ref = np.where(col < rl[:, None], ref, junk)
    v = rng.random(n)
    k = (rng.random(n) * np.clip(np.minimum(rl, width), 1, None)).astype(np.int64)
    rows = np.arange(n)
    have = (rl > 0) & (rl <= width)
    flip = have & (v < 0.15)
    old = ref[rows, k]
    swapped = ACGT[(np.searchsorted(ACGT, old).clip(0, 3) + 1 + rng.integers(0, 3, n)) % 4]
    ref[flip, k[flip]] = np.where(old[flip] == ord("N"), ord("A"), swapped[flip])
    lower = have & (v >= 0.15) & (v < 0.20)
    low = lower[:, None] & (col < rl[:, None]) & (rng.random((n, width)) < 0.5) \
        & (ref >= 65) & (ref <= 90)
    ref = np.where(low, ref + 32, ref).astype(np.uint8)
    absent = next((c for c in range(1, 26) if c not in genome.length), 0)
    chrom = np.where((v >= 0.20) & (v < 0.23), absent, chrom)
    edge = (v >= 0.23) & (v < 0.27) & (rl > 1)
    pos = np.where(edge & (rng.random(n) < 0.5), length - rl + 2,
                   np.where(edge, -rng.integers(0, 3, n), pos))
    plant = have & (v >= 0.27) & (v < 0.29) & (ref[rows, k] != ord("N"))
    ref[plant, k[plant]] = ord("N")
    if code is not None:
        order = np.argsort(pos, kind="stable")
        chrom, pos, ref, rl = chrom[order], pos[order], ref[order], rl[order]
    return (chrom.astype(np.int8), pos.astype(np.int32), ref,
            rl.astype(np.int32))


def write_genome_inputs(work, lines, seed=22, mismatch_share=0.02,
                        length=CHR22_LENGTH, grch38=True):
    """The reference-genome inputs under ``work`` for the phase-4 VCF's
    data ``lines``: chr22 at ``length`` bases (its full 50,818,468 by
    default) from ``seed`` (an N run over its first 10 Mbp, or quarter,
    and 300 short ones, about a third of it in lowercase runs), with the
    bases at every site written from the site's ref and then one base
    changed at ``mismatch_share`` of the sites; a FASTA of it in
    60-character lines plus a 1,000-base chr21 record carrying IUPAC
    codes; and, with ``grch38``, a GRCh38-shaped index (all 25
    chromosomes at the port's length table, seeded random bases outside
    chr22, no ambiguity elsewhere) written uncompressed.  Returns the
    paths, chr22's text (uppercase ACGT/N) and its packed arrays, and the
    seconds each part took."""
    from annotatedvdb_tpu_torch.genome.assemblies import BUILD_LENGTHS

    t0 = time.perf_counter()
    rng = np.random.default_rng(seed)
    n = length
    text = ACGT[rng.integers(0, 4, n, dtype=np.uint8)]
    head = min(10_000_000, n // 4)
    text[:head] = ord("N")
    for s, k in zip(rng.integers(head, n - 6000, 300),
                    rng.integers(100, 5000, 300)):
        text[s: s + k] = ord("N")
    lower = np.zeros(n, bool)
    runs = max(1, 1700 * n // CHR22_LENGTH)
    for s, k in zip(rng.integers(0, n - 20_000, runs), rng.integers(1000, 20_000, runs)):
        lower[s: s + k] = True
    sites = []
    for ln in lines:
        _c, pos, _v, ref = ln.split("\t", 4)[:4]
        if pos.isdigit():
            p = int(pos) - 1
            text[p: p + len(ref)] = np.frombuffer(ref.encode(), np.uint8)
            sites.append((p, len(ref)))
    plant = rng.random(len(sites)) < mismatch_share
    for (p, k), hit in zip(sites, plant.tolist()):
        if hit:
            j = p + int(rng.integers(0, k))
            text[j] = ACGT[(int(np.searchsorted(ACGT, text[j])) + 1) % 4]
    text_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    fasta = os.path.join(work, "chr22.fa")
    shown = np.where(lower, text | 0x20, text).astype(np.uint8)
    full = n - n % FASTA_WIDTH
    body = np.concatenate([shown[:full].reshape(-1, FASTA_WIDTH),
                           np.full((full // FASTA_WIDTH, 1), 10, np.uint8)], 1)
    chr21 = ACGT[rng.integers(0, 4, 1000, dtype=np.uint8)]
    chr21[rng.integers(0, 1000, 20)] = IUPAC[rng.integers(0, IUPAC.size, 20)]
    with open(fasta, "wb") as f:
        f.write(b">chr22 seeded\n")
        f.write(body.tobytes())
        f.write(shown[full:].tobytes() + b"\n")
        f.write(b">chr21 iupac\n" + chr21[:700].tobytes() + b"\n"
                + chr21[700:].tobytes() + b"\n")
    fasta_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    packed22, mask22 = pack_bases(text)
    out = {"fasta": fasta, "text": text, "packed22": packed22, "mask22": mask22,
           "chr21": chr21, "seconds": {"text": text_s, "fasta": fasta_s}}
    if not grch38:
        return out
    packed, masks, meta = [], [], {"byte_offset": {}, "mask_offset": {},
                                   "length": {}, "lossy": {}, "digests": {}}
    byte_pos = mask_pos = 0
    for code, length in enumerate(BUILD_LENGTHS["grch38"], start=1):
        if code == 22:
            p, m = packed22, mask22
        else:
            p = rng.integers(0, 256, (length + 3) // 4, dtype=np.uint8)
            if length % 4:  # zero codes past the chromosome's end
                p[-1] &= (1 << (2 * (length % 4))) - 1
            m = np.zeros((length + 7) // 8, np.uint8)
        for key, val in (("byte_offset", byte_pos), ("mask_offset", mask_pos),
                         ("length", length), ("lossy", False)):
            meta[key][str(code)] = val
        packed.append(p)
        masks.append(m)
        byte_pos += p.size
        mask_pos += m.size
    index = os.path.join(work, "grch38.npz")
    np.savez(index, packed=np.concatenate(packed), n_mask=np.concatenate(masks),
             meta=np.frombuffer(json.dumps(meta).encode(), np.uint8))
    out["seconds"]["index"] = time.perf_counter() - t0
    out.update(index=index, index_bytes=byte_pos + mask_pos)
    return out


def ref_mismatches(text, lines) -> tuple:
    """(rows, mismatched rows) of the unique rows the VCF data ``lines``
    insert into a fresh store ('.' alts and repeated lines dropped), by
    string comparison of each row's ref with chr22's ``text``: a row
    mismatches unless 1 <= pos and pos - 1 + len(ref) <= len(text) and the
    text there equals the ref uppercased."""
    rows = bad = 0
    n = text.size
    for ln in dict.fromkeys(lines):
        _c, pos, _v, ref, alt_col = ln.split("\t", 5)[:5]
        if not pos.isdigit():
            continue
        k = sum(a != "." for a in alt_col.split(","))
        p = int(pos) - 1
        ok = p >= 0 and p + len(ref) <= n and \
            text[p: p + len(ref)].tobytes() == ref.upper().encode()
        rows += k
        bad += 0 if ok else k
    return rows, bad


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


def _kernel_counts(prof) -> dict:
    """{device event name: (count, summed device us)} of a profile."""
    return {e.key: (e.count, e.self_device_time_total) for e in prof.key_averages()
            if getattr(e, "self_device_time_total", 0.0) > 0}


def _short_name(name: str) -> str:
    """A device event's name without its namespace, return type and
    parameter list (``search_kernel<false>``, ``Memset``)."""
    name = name.replace("(anonymous namespace)::", "")
    name = name[5:] if name.startswith("void ") else name
    return name.split("(")[0].strip()


def _profiled(torch, fn, inputs, calls) -> dict:
    """:func:`_kernel_counts` of ``calls`` calls, traced after a warm-up
    step whose events are dropped (a profiler can miss the first kernels
    it sees after it starts)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    out = {}
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: out.update(_kernel_counts(p))) as prof:
        _run(fn, inputs, 1)
        torch.cuda.synchronize()
        prof.step()
        _run(fn, inputs, calls)
        torch.cuda.synchronize()
        prof.step()
    return out


def device_profile(torch, fn, inputs, iters, probe=4):
    """Device time per call of every kernel a call launches (profiler):
    ``{"ms": total, "kernels": {name: {"launches": n, "ms": t}}}``, per
    call, by kernel name.  Each name's launches per call are the larger
    of what a profile of ``probe`` calls and the timed profile of
    ``iters`` calls hold, rounded up; None (the caller falls back to CUDA
    events) when the profiler sees no device time, or when the timed
    trace holds a name other than ``iters`` times its launches per call
    (a trace that lost events would read too low)."""
    _run(fn, inputs, 2)
    torch.cuda.synchronize()
    counts = _profiled(torch, fn, inputs, probe)
    seen = _profiled(torch, fn, inputs, iters)
    per_call = {name: max(-(-counts.get(name, (0, 0))[0] // probe),
                          -(-seen.get(name, (0, 0))[0] // iters))
                for name in set(counts) | set(seen)}
    total_us = sum(us for _n, us in seen.values())
    if total_us <= 0 or any(seen.get(name, (0, 0))[0] != iters * n
                            for name, n in per_call.items()):
        return None
    kernels = {}
    for name, n in sorted(per_call.items()):
        k = kernels.setdefault(_short_name(name), {"launches": 0, "ms": 0.0})
        k["launches"] += n
        k["ms"] += seen[name][1] / 1e3 / iters
    return {"ms": total_us / 1e3 / iters, "kernels": kernels}


def device_ms(torch, fn, inputs, iters):
    """:func:`device_profile`'s total ms per call, or None."""
    prof = device_profile(torch, fn, inputs, iters)
    return None if prof is None else prof["ms"]


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
        # W = 8: the narrowest bucket of a width-bucketed upload
        ("edge-w8", to_dev(edge_batch(8))),
        ("random-65536-w8", to_dev(random_batch(7, CHUNK_ROWS, 8))),
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


#: the join's shapes on the main path (phase 9): variants in a block's
#: window and the block's score rows, at the SNV and indel probe depths
CADD_SHAPES = {"snv": (8192, CADD_BLOCK_ROWS, SNV_PROBE),
               "indel": (16384, CADD_BLOCK_ROWS, INDEL_PROBE)}


def cadd_bound(vpos, spos, probe, matched, match_idx, width) -> dict:
    """Bytes the join must move for these inputs — each variant's position
    and alleles read once, its 5 output bytes written once, and each score
    row that some probe compares (from the lower bound through the first
    hit, or to the end of the position's run within the window) read once
    — and the operations it does: the binary search's steps and 4W byte
    compares per probed row.  Also the coarser count
    N(4 + 2W) + 5N + min(K, N probe)(4 + 2W) for comparison."""
    n, k = vpos.size, spos.size
    lo = np.searchsorted(spos, vpos, side="left")
    run_end = np.searchsorted(spos, vpos, side="right")
    end = np.where(matched, match_idx.astype(np.int64) + 1,
                   np.minimum(run_end, lo + probe))
    end = np.maximum(end, lo)
    edges = np.zeros(k + 1, np.int64)
    np.add.at(edges, lo, 1)
    np.add.at(edges, end, -1)
    rows = int((np.cumsum(edges)[:k] > 0).sum())
    row_bytes = 4 + 2 * width
    nbytes = n * row_bytes + 5 * n + rows * row_bytes
    ops = int(n * 3 * np.ceil(np.log2(k + 1)) + (end - lo).sum() * 4 * width)
    bytes_ms = nbytes / MEM_BYTES_PER_S * 1e3
    ops_ms = ops / INT32_OPS_PER_S * 1e3
    return {"variants": n, "score_rows": k, "probe": probe, "probed_rows": rows,
            "bytes": nbytes, "ops": ops, "bytes_ms": bytes_ms, "ops_ms": ops_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "coarse_bytes_ms": (n * row_bytes + 5 * n + min(k, n * probe) * row_bytes)
            / MEM_BYTES_PER_S * 1e3}


def cadd_kernel_phase(torch, device) -> dict:
    """Phase 3 for ``cadd_join``: the kernel against its plain version on
    the card, exactly (``torch.equal`` on both outputs), on the seeded edge
    blocks at :data:`EDGE_WIDTHS` and on random blocks at the SNV and indel
    shapes; its time at both shapes beside the plain version's and the
    bound; the host-to-device copy of one score block.  Returns the kernel
    table row (launches filled in after phase 9)."""
    from annotatedvdb_tpu_torch.ops.cadd_join import cadd_join, cadd_join_reference
    from annotatedvdb_tpu_torch.runtime import to_device

    def to_dev(args):
        return [torch.from_numpy(np.ascontiguousarray(x)).to(device) for x in args]

    checks, worst = [], 0
    cases = [(label, args, probe) for w in EDGE_WIDTHS
             for label, args, probe in cadd_edge_cases(w)]
    sets = {}
    for shape, (n, k, probe) in CADD_SHAPES.items():
        sets[shape] = [cadd_random_block(30 + i, n, k, WIDTH, probe, shape == "snv")
                       for i in range(3)]
        cases += [(f"random-{shape}-{i}", a, probe)
                  for i, a in enumerate(sets[shape])]
    for label, args, probe in cases:
        t = to_dev(args)
        got = cadd_join(*t, probe=probe)
        want = cadd_join_reference(*t, probe=probe)
        torch.cuda.synchronize()
        same = [torch.equal(g, w) for g, w in zip(got, want)]
        err = int((got[1].to(torch.int64) - want[1].to(torch.int64)).abs().max()) \
            if got[1].numel() else 0
        err = max(err, int((got[0] != want[0]).sum()))
        worst = max(worst, err)
        checks.append({"inputs": label, "variants": int(t[0].shape[0]),
                       "score_rows": int(t[3].shape[0]), "probe": probe,
                       "matched": int(want[0].sum()), "equal": all(same),
                       "max_abs_err": err})
        if not all(same):
            raise AssertionError(f"cadd_join disagrees with its plain version "
                                 f"on {label}")

    timing = {}
    for shape, (n, k, probe) in CADD_SHAPES.items():
        inputs = [to_dev(a) for a in sets[shape]]
        runs = {}
        for name, fn, iters in (("plain", cadd_join_reference, 10),
                                ("kernel", cadd_join, 100),
                                ("kernel", cadd_join, 100),
                                ("plain", cadd_join_reference, 10)):
            call = (lambda f: lambda *a: f(*a, probe=probe))(fn)
            runs.setdefault(name, []).append({
                "device_ms": device_ms(torch, call, inputs, iters),
                "call_ms": call_ms(torch, call, inputs, iters)})

        def best(rs):
            dev = [r["device_ms"] for r in rs if r["device_ms"] is not None]
            return min(dev) if dev else min(r["call_ms"] for r in rs)

        m, idx = cadd_join_reference(*inputs[0], probe=probe)
        a = sets[shape][0]
        bound = cadd_bound(a[0], a[3], probe, m.cpu().numpy(), idx.cpu().numpy(),
                           WIDTH)
        ms = best(runs["kernel"])
        timing[shape] = {**bound, "ms": ms, "plain_ms": best(runs["plain"]),
                         "call_ms": min(r["call_ms"] for r in runs["kernel"]),
                         "bound_share": bound["bound_ms"] / ms, "timing_runs": runs}
        del inputs

    # one score block's upload (pos, ref, alt at the block capacity): from
    # pinned memory alone (CUDA events) and through to_device (host copy
    # into the pinned staging buffer included)
    _v, _r, _a, spos, sref, salt = sets["snv"][0]
    block = (spos, sref, salt)
    nbytes = sum(x.nbytes for x in block)
    pinned = [torch.from_numpy(x).pin_memory() for x in block]
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    copies = []
    for _ in range(5):
        start.record()
        for x in pinned:
            x.to(device, non_blocking=True)
        stop.record()
        torch.cuda.synchronize()
        copies.append(start.elapsed_time(stop))
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        for x in block:
            to_device(x, device)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    h2d = {"bytes": nbytes, "copy_ms": min(copies),
           "copy_gb_per_s": nbytes / min(copies) / 1e6, "to_device_ms": min(walls)}
    emit("cadd_kernels", checks=checks, timing=timing, block_upload=h2d)
    snv, indel = timing["snv"], timing["indel"]
    return {
        "name": "cadd_join", "route": "cuda",
        "source": "annotatedvdb_tpu_torch/csrc/cadd_join.cu",
        "replaces": "annotatedvdb_tpu/ops/cadd_join.py:49",
        "launches": None, "max_abs_err": worst,
        "ms": snv["ms"], "plain_ms": snv["plain_ms"], "bound_ms": snv["bound_ms"],
        "bound_by": snv["bound_by"], "library_ms": None,
        "indel_ms": indel["ms"], "indel_plain_ms": indel["plain_ms"],
        "indel_bound_ms": indel["bound_ms"], "block_upload_ms": h2d["copy_ms"],
    }


#: the validation's shapes: the load's chunk at random places on random
#: chromosomes, the same rows as a load's chunk (chr22, position-sorted),
#: and 1,048,576 random rows
VALIDATE_SHAPES = {"chunk": CHUNK_ROWS, "chunk_sorted": CHUNK_ROWS, "big": BIG_ROWS}


def _union_size(lo, hi) -> int:
    """Integers in the union of the inclusive ranges [lo, hi]."""
    if lo.size == 0:
        return 0
    order = np.argsort(lo, kind="stable")
    lo, hi = lo[order], hi[order]
    reach = np.concatenate([[lo[0] - 1], np.maximum.accumulate(hi)[:-1]])
    return int(np.maximum(hi - np.maximum(lo, reach + 1) + 1, 0).sum())


def validate_bound(genome, chrom, pos, ref, rl) -> dict:
    """Bytes ``validate_ref`` must move for these rows — each row's chrom,
    pos and ref_len read once and its byte written once; for a row whose
    code is in the genome, with 0 < ref_len <= W and its span inside the
    chromosome, the ref bytes up to its first mismatch (all ref_len when
    it passes) and the packed and mask bytes under them, each byte once
    however many rows share it (position-sorted rows do) — and the
    operations (eight integer operations a base compared, ten a row)."""
    n, w = ref.shape
    byte_off, mask_off, lengths = genome_tables(genome)
    code = chrom.astype(np.int64)
    length = lengths[code]
    start = pos.astype(np.int64) - 1
    rl64 = rl.astype(np.int64)
    walk = (length > 0) & (rl64 > 0) & (rl64 <= w) & (start >= 0) \
        & (start + rl64 <= length)
    text = genome_text(genome, chrom, pos, w)
    up = np.where((ref >= 97) & (ref <= 122), ref - 32, ref)
    col = np.arange(w)[None, :]
    bad = (up != text) & (col < rl64[:, None])
    first = np.where(bad.any(1), bad.argmax(1) + 1, rl64)
    bases = np.where(walk, first, 0)
    last = start + bases - 1
    on = bases > 0
    packed = _union_size(byte_off[code][on] + (start[on] >> 2),
                         byte_off[code][on] + (last[on] >> 2))
    mask = _union_size(mask_off[code][on] + (start[on] >> 3),
                       mask_off[code][on] + (last[on] >> 3))
    nbytes = int(n * 10 + bases.sum() + packed + mask)
    ops = int(n * 10 + 8 * bases.sum())
    bytes_ms = nbytes / MEM_BYTES_PER_S * 1e3
    ops_ms = ops / INT32_OPS_PER_S * 1e3
    return {"rows": n, "bases": int(bases.sum()), "bytes": nbytes, "ops": ops,
            "bytes_ms": bytes_ms, "ops_ms": ops_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def validate_kernel_phase(torch, device, index) -> dict:
    """Phase 3 for ``validate_ref``: the GRCh38-shaped index loaded and
    uploaded once (both timed), then the kernel against its plain version
    on the card, exactly (``torch.equal``), on the edge rows of
    :func:`validate_edge_rows` at :data:`EDGE_WIDTHS` (also equal to what
    they must give), on 1,048,576 random rows at W = 49 (60-80% of them
    passing) and on 65,536 position-sorted chr22 rows; its time at the
    shapes of :data:`VALIDATE_SHAPES` beside the plain version's and the
    bound.  Returns the kernel table row (launches filled in after phase
    10)."""
    from annotatedvdb_tpu_torch.genome import ReferenceGenome
    from annotatedvdb_tpu_torch.genome.refgenome import (
        validate_ref,
        validate_ref_reference,
    )

    t0 = time.perf_counter()
    genome = ReferenceGenome.load(index)
    load_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tables = genome.device_arrays(device)
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    upload_bytes = sum(t.numel() * t.element_size() for t in tables)

    def to_dev(rows):
        return [torch.from_numpy(np.ascontiguousarray(x)).to(device) for x in rows[:4]]

    checks, worst = [], 0
    cases = [(f"edge-w{w}", validate_edge_rows(genome, w)) for w in EDGE_WIDTHS]
    cases.append(("random-1m-w49", validate_random_rows(genome, BIG_ROWS, WIDTH, seed=31)))
    cases.append(("sorted-chr22-w49", validate_random_rows(genome, CHUNK_ROWS, WIDTH,
                                                           seed=32, code=22)))
    for label, rows in cases:
        t = to_dev(rows)
        got = validate_ref(*tables, *t)
        want = validate_ref_reference(*tables, *t)
        torch.cuda.synchronize()
        err = int((got != want).sum())
        worst = max(worst, err)
        rec = {"inputs": label, "rows": int(t[0].shape[0]), "passing": int(want.sum()),
               "equal": bool(torch.equal(got, want)), "max_abs_err": err}
        if len(rows) > 4:
            rec["as_listed"] = bool(np.array_equal(got.cpu().numpy(), rows[4]))
        checks.append(rec)
        if not rec["equal"] or not rec.get("as_listed", True):
            raise AssertionError(f"validate_ref disagrees with its plain version "
                                 f"or its listed results on {label}")
    for rec in checks[-2:]:
        share = rec["passing"] / rec["rows"]
        if not 0.6 <= share <= 0.8:
            raise AssertionError(f"validate_ref: {share:.3f} of the {rec['inputs']} "
                                 f"rows pass")

    timing = {}
    for shape, n in VALIDATE_SHAPES.items():
        host = [validate_random_rows(genome, n, WIDTH, seed=40 + i,
                                     code=22 if shape == "chunk_sorted" else None)
                for i in range(4 if n == CHUNK_ROWS else 2)]
        inputs = [(*tables, *to_dev(h)) for h in host]
        runs = {}
        iters = 200 if n == CHUNK_ROWS else 20
        for name, fn, k in (("plain", validate_ref_reference, iters // 10),
                            ("kernel", validate_ref, iters),
                            ("kernel", validate_ref, iters),
                            ("plain", validate_ref_reference, iters // 10)):
            runs.setdefault(name, []).append({
                "device_ms": device_ms(torch, fn, inputs, k),
                "call_ms": call_ms(torch, fn, inputs, k)})

        def best(rs):
            dev = [r["device_ms"] for r in rs if r["device_ms"] is not None]
            return min(dev) if dev else min(r["call_ms"] for r in rs)

        bound = validate_bound(genome, *host[0][:4])
        ms = best(runs["kernel"])
        timing[shape] = {**bound, "ms": ms, "plain_ms": best(runs["plain"]),
                         "call_ms": min(r["call_ms"] for r in runs["kernel"]),
                         "bound_share": bound["bound_ms"] / ms, "timing_runs": runs}
        del inputs
    emit("validate_kernels", checks=checks, timing=timing, genome_load_s=load_s,
         genome_upload_s=upload_s, genome_upload_bytes=upload_bytes)
    del tables, genome
    torch.cuda.empty_cache()
    chunk, srt, big = timing["chunk"], timing["chunk_sorted"], timing["big"]
    return {
        "name": "validate_ref", "route": "cuda",
        "source": "annotatedvdb_tpu_torch/csrc/validate_ref.cu",
        "replaces": "annotatedvdb_tpu/genome/refgenome.py:261",
        "launches": None, "max_abs_err": worst,
        "ms": chunk["ms"], "plain_ms": chunk["plain_ms"], "bound_ms": chunk["bound_ms"],
        "bound_by": chunk["bound_by"], "library_ms": None,
        "sorted_ms": srt["ms"], "sorted_plain_ms": srt["plain_ms"],
        "sorted_bound_ms": srt["bound_ms"],
        "big_ms": big["ms"], "big_plain_ms": big["plain_ms"],
        "big_bound_ms": big["bound_ms"], "genome_upload_ms": upload_s * 1e3,
    }


# ------------------------------------------------- serving kernels (phase 3)

#: the serving shape: the rows of phase 9's chr22 store (phases 4 and 5,
#: padded to 4,194,304) and a 4,096-interval panel
SERVE_ROWS = 2_274_305
SERVE_QUERIES = 4096
SERVE_WINDOWS = 16


def serve_columns(seed, k, q, missing=(0.8, 0.4, 0.5), span=(16_000_000, 50_000_000)):
    """Seeded serving inputs: ``k`` position-sorted chr22 rows (3% of
    positions shared by two rows, as multi-allelic sites are), int32
    fixed-point AF, CADD and rank columns with ``missing`` shares (-1),
    values at the histogram edges, at FP_CAP and past it, ranks at and
    past the last bucket; and ``q`` gene-panel intervals (1-100 kb, 1%
    whole-chromosome, 1% wholly before the first row)."""
    from annotatedvdb_tpu_torch.ops import stats as S

    rng = np.random.default_rng(seed)
    pos = np.sort(rng.integers(span[0], span[1], k)).astype(np.int32)
    if k > 2:
        at = rng.choice(k - 1, max(k * 3 // 100, 1), replace=False)
        pos[at + 1] = pos[at]
        pos.sort()

    def col(lo, hi, miss, specials):
        v = rng.integers(lo, hi, k)
        pick = rng.random(k) < 0.05
        v[pick] = rng.choice(specials, int(pick.sum()))
        v[rng.random(k) < miss] = S.STATS_MISSING
        return v.astype(np.int32)

    af = col(0, S.AF_SCALE + 1, missing[0], [0, 10, 1_000_000, S.FP_CAP, S.FP_CAP + 1])
    cadd = col(0, 60_000, missing[1], [0, 1_000, 20_000, 100_000, S.FP_CAP])
    rank = col(0, 40, missing[2], [0, 31, 32, 500])
    starts = rng.integers(span[0] - 50_000, span[1], q)
    ends = starts + rng.integers(1_000, 100_000, q)
    u = rng.random(q)
    starts[u < 0.01], ends[u < 0.01] = 1, CHR22_LENGTH
    before = (u >= 0.01) & (u < 0.02)
    starts[before], ends[before] = 1, span[0] - 10
    return pos, af, cadd, rank, starts.astype(np.int32), ends.astype(np.int32)


#: row indices beside the stats kernels' table edges: 64-row (windows) and
#: 256-row (panel) tiles, their halves (where the nearer table row changes
#: side) and the 4,096-row super-tiles
TABLE_EDGES = (0, 1, 31, 32, 33, 63, 64, 65, 127, 128, 129, 191, 192, 193,
               255, 256, 257, 383, 384, 385, 511, 512, 513, 2047, 2048, 2049,
               4095, 4096, 4097)


def serve_edge_cases():
    """Small edge inputs of the serving kernels as the kernels take them:
    (label, pos, af, cadd, rank, starts, ends), the rows padded to a power
    of two with the position sentinel and missing features unless the
    label starts with ``unpadded``.  Real row counts at and beside the
    table edges (1; 63, 64, 65 and 255, 256, 257 around the 64- and
    256-row tiles; 1000; 4086, 4095, 4096, 4097 and 8182 around the
    4,096-row super-tiles and in their last half-tiles; 5000) and,
    unpadded, counts that end inside a tile (63, 65, 257, 2049); all
    features missing; runs of equal positions across a tile edge; queries
    before the first row, after the last, ``start > end``, at 0 and at
    the clamp; a single query; ``tile-edges``: spans whose searches land
    exactly on every :data:`TABLE_EDGES` row, and windows whose every
    boundary at windows 16 is a 64-row tile edge; ``short-spans``: spans
    of 1 to 65 positions (equal boundaries at windows 64); ``in-padding``:
    queries wholly past the last real row; ``padding-features``: padded
    rows whose features are present, which only a span reaching the
    sentinel (end 2**31 - 1, past the clamp every caller applies) counts."""
    from annotatedvdb_tpu_torch.ops.intervals import MAX_QUERY_POS
    from annotatedvdb_tpu_torch.utils.arrays import POS_SENTINEL, pad_pow2

    def padded(label, pos, af, cadd, rank, s, e):
        return (label, pad_pow2(pos, POS_SENTINEL),
                *(pad_pow2(a, -1) for a in (af, cadd, rank)), s, e)

    cases = []
    for i, k in enumerate((1, 255, 256, 257, 1000, 5000)):
        cases.append(padded(f"k{k}", *serve_columns(90 + i, k, 97, span=(1000, 100_000))))
    for i, k in enumerate((63, 64, 65, 4086, 4095, 4096, 4097, 8182)):
        cases.append(padded(f"k{k}", *serve_columns(110 + i, k, 97, span=(1000, 100_000))))
    for i, k in enumerate((63, 65, 257, 2049)):
        cases.append((f"unpadded-k{k}", *serve_columns(120 + i, k, 97, span=(1000, 100_000))))
    cases.append(padded("all-missing", *serve_columns(97, 3000, 64, missing=(1, 1, 1),
                                                      span=(1000, 100_000))))
    pos = np.repeat(np.arange(1, 301, dtype=np.int32) * 10, 3)  # runs of 3
    _p, af, cadd, rank, _s, _e = serve_columns(98, pos.size, 1, missing=(0, 0, 0))
    pts = np.asarray([0, 1, 9, 10, 11, 2560, 2561, 3000, 3001, MAX_QUERY_POS],
                     np.int32)
    cases.append(padded("runs-and-ends", pos, af, cadd, rank, pts, pts[::-1].copy()))
    cases.append(padded("one-query", pos, af, cadd, rank, pts[3:4], pts[6:7]))

    # pos[j] = 10 (j + 1): a start at pos[a] searches to a, an end at
    # pos[b] - 1 to b
    n = 5000
    pos = (np.arange(n, dtype=np.int32) + 1) * 10
    _p, af, cadd, rank, _s, _e = serve_columns(130, n, 1, missing=(0.3, 0.3, 0.3))
    at = np.asarray([j for j in TABLE_EDGES if j < n] + [n - 1, n], np.int64)
    a, b = np.meshgrid(at, at, indexing="ij")
    starts = 10 * (np.minimum(a.ravel(), n - 1) + 1)
    ends = 10 * (b.ravel() + 1) - 10 - 1
    tiles = np.asarray([0, 1, 3, 4, 7, 8, 15, 16, 30, 63, 64], np.int64)  # 64 m + 1024 <= n
    starts = np.concatenate([starts, 10 * (64 * tiles + 1)])
    ends = np.concatenate([ends, 10 * (64 * tiles + 1) + 640 * 16 - 1])
    cases.append(padded("tile-edges", pos, af, cadd, rank, starts.astype(np.int32),
                        ends.astype(np.int32)))

    rng = np.random.default_rng(131)
    pos, af, cadd, rank, _s, _e = serve_columns(131, 1500, 1, span=(1000, 3000))
    lengths = np.asarray([1, 2, 3, 7, 15, 16, 17, 63, 64, 65])
    starts = rng.integers(900, 3100, 20 * lengths.size)
    ends = starts + np.tile(lengths, 20) - 1
    cases.append(padded("short-spans", pos, af, cadd, rank, starts.astype(np.int32),
                        ends.astype(np.int32)))

    pos, af, cadd, rank, _s, _e = serve_columns(132, 700, 1, span=(1000, 100_000))
    last = int(pos[-1])
    starts = np.asarray([last, last + 1, last + 1, last + 1000, MAX_QUERY_POS - 10,
                         MAX_QUERY_POS], np.int32)
    ends = np.asarray([last, last + 5, MAX_QUERY_POS, last + 1000, MAX_QUERY_POS,
                       MAX_QUERY_POS], np.int32)
    cases.append(padded("in-padding", pos, af, cadd, rank, starts, ends))

    pos, af, cadd, rank, s, e = serve_columns(133, 1500, 64, span=(1000, 100_000))
    k = 2048
    _p, paf, pcadd, prank, _s, _e = serve_columns(134, k - pos.size, 1, missing=(0, 0, 0))
    last = int(pos[-1])
    starts = np.concatenate([s, np.asarray([0, 1000, last, last + 1, POS_SENTINEL],
                                           np.int32)])
    ends = np.concatenate([e, np.full(5, POS_SENTINEL, np.int32)])
    cases.append(("padding-features", pad_pow2(pos, POS_SENTINEL),
                  np.concatenate([af, paf]), np.concatenate([cadd, pcadd]),
                  np.concatenate([rank, prank]), starts, ends))
    return cases


def _search_sectors(pos, keys, right=False) -> set:
    """32-byte sectors of ``pos`` that the textbook binary searches for
    ``keys`` read (each a lower or upper bound)."""
    lo = np.zeros(keys.size, np.int64)
    hi = np.full(keys.size, pos.size, np.int64)
    sectors = set()
    while True:
        active = lo < hi
        if not active.any():
            return sectors
        mid = (lo + hi) >> 1
        sectors.update((mid[active] // 8).tolist())
        v = pos[np.minimum(mid, pos.size - 1)]
        go = (v <= keys) if right else (v < keys)
        lo = np.where(active & go, mid + 1, lo)
        hi = np.where(active & ~go, mid, hi)


def _rows_in_spans(lo, hi) -> int:
    """Rows in the union of the half-open spans [lo, hi)."""
    keep = hi > lo
    return _union_size(lo[keep], hi[keep] - 1)


def serve_bound(kind, pos, starts, ends, windows=SERVE_WINDOWS) -> dict:
    """Bytes the function must move for these inputs and the operations
    it does on them.  Every kind reads its query bounds and the 32-byte
    sectors of ``pos`` its searches touch, and writes its outputs once:
    ``bits`` 13 bytes a query; ``panel`` reads the AF, CADD and rank
    values (12 bytes) of every row in the union of the query spans and
    writes 376 bytes a query, counting per row 2 x (21 bit tests + 9 edge
    compares) + 2 rank ops + 94 adds; ``windows`` reads the CADD value of
    every row between each query's first and last boundary and writes
    92 W bytes a query, counting 1 + 21 tests + 22 adds a row."""
    k, q = pos.size, starts.size
    if kind == "windows":
        from annotatedvdb_tpu_torch.ops.stats import window_bounds
        import torch

        b = window_bounds(torch.from_numpy(starts), torch.from_numpy(ends),
                          windows).numpy()
        keys = b.reshape(-1)
        sectors = _search_sectors(pos, keys)
        idx = np.searchsorted(pos, b, side="left")
        rows = _rows_in_spans(idx[:, 0], idx[:, -1])
        nbytes = 8 * q + 32 * len(sectors) + 4 * rows + q * windows * 92
        ops = rows * 44 + keys.size * int(np.ceil(np.log2(k + 1))) * 3
    else:
        sectors = _search_sectors(pos, starts) | _search_sectors(pos, ends, right=True)
        lo = np.searchsorted(pos, starts, side="left")
        hi = np.searchsorted(pos, ends, side="right")
        steps = 2 * q * int(np.ceil(np.log2(k + 1))) * 3
        if kind == "bits":
            rows = 0
            nbytes = 8 * q + 32 * len(sectors) + 13 * q
            ops = steps + q * 13 * 3
        else:
            rows = _rows_in_spans(lo, hi)
            nbytes = 8 * q + 32 * len(sectors) + 12 * rows + 376 * q
            ops = steps + rows * (2 * (21 + 9) + 2 + 94)
    bytes_ms = nbytes / MEM_BYTES_PER_S * 1e3
    ops_ms = ops / INT32_OPS_PER_S * 1e3
    return {"rows": int(k), "queries": int(q), "span_rows": int(rows),
            "search_sectors": len(sectors), "bytes": int(nbytes), "ops": int(ops),
            "bytes_ms": bytes_ms, "ops_ms": ops_ms, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def serve_kernel_checks(torch, device, cases, windows_list=(1, 7, SERVE_WINDOWS, 64)):
    """Each serving kernel against its plain version on the card, exactly
    (``torch.equal`` on every output), on ``cases`` (the kernels' inputs,
    as :func:`serve_edge_cases` makes them).  Returns the checks and the
    largest absolute difference seen (0 when all agree)."""
    from annotatedvdb_tpu_torch.ops import intervals as I
    from annotatedvdb_tpu_torch.ops import stats as S

    def diff(got, want):
        return max((int((g.to(torch.int64) - w.to(torch.int64)).abs().max())
                    if g.numel() else 0) for g, w in zip(got, want))

    checks, worst = [], 0
    for label, pos, af, cadd, rank, s, e in cases:
        cols = [torch.from_numpy(np.ascontiguousarray(a)).to(device)
                for a in (pos, af, cadd, rank)]
        qs = [torch.from_numpy(np.ascontiguousarray(x)).to(device) for x in (s, e)]
        runs = [("bits_spans", I.bits_spans(cols[0], *qs),
                 I.bits_spans_reference(cols[0], *qs)),
                ("stats_panel", S.stats_panel(*cols, *qs),
                 S.stats_panel_reference(*cols, *qs))]
        for w in windows_list:
            runs.append((f"windowed_stats_{w}",
                         S.windowed_stats(cols[0], cols[2], *qs, w),
                         S.windowed_stats_reference(cols[0], cols[2], *qs, w)))
        torch.cuda.synchronize()
        for name, got, want in runs:
            same = all(g.dtype == w.dtype and torch.equal(g, w)
                       for g, w in zip(got, want))
            err = diff(got, want)
            worst = max(worst, err)
            checks.append({"kernel": name, "inputs": label, "rows": int(pos.size),
                           "queries": int(s.size), "equal": same, "max_abs_err": err})
            if not same:
                raise AssertionError(f"{name} disagrees with its plain version "
                                     f"on {label} (max |diff| {err})")
    return checks, worst


def bits_edge_cases() -> list:
    """``bits_spans``' own search edge cases as the kernel takes them:
    (label, pos, starts, ends), positions unpadded unless the label says
    so, int32 query bounds in [0, 2**31 - 1], query counts not multiples
    of 8 (a block's 8 warps).  ``runs``: 100,003 rows (not a power of two)
    holding runs of 17, 33, 100, 5,000 and 30,000 equal positions, wider
    than a final search window and across the splitters of the search
    rounds, queried at, beside and between the runs; ``k<n>``: 0, 1, 2,
    15-17, 31-33 and 63-65 rows (around windows of 16, 32 and 64 rows),
    runs included, queries before the first row, after the last and
    across; ``sentinel-padded``: 1,000 rows padded to 1,024 with the
    position sentinel, bounds at and beside the last row, the clamp and
    the sentinel itself (which counts the padding); ``serving-k``:
    4,194,303 rows (one short of the serving pad) with 3% shared
    positions."""
    from annotatedvdb_tpu_torch.ops.intervals import clamped_queries
    from annotatedvdb_tpu_torch.utils.arrays import POS_SENTINEL, pad_pow2

    cases = []
    rng = np.random.default_rng(140)
    k = 100_003
    pos = np.sort(rng.integers(1_000, 5_000_000, k)).astype(np.int32)
    for length, at in ((17, 1_000), (33, 5_870), (100, 11_760), (5_000, 40_000),
                       (30_000, 60_000)):
        pos[at:at + length] = pos[at]
    vals = np.unique(pos[[1_000, 5_870, 11_760, 40_000, 60_000]]).astype(np.int64)
    pts = np.concatenate([vals - 1, vals, vals + 1, [0, 1, int(pos[0]), int(pos[-1]),
                                                      int(pos[-1]) + 1, 2**31 - 17]])
    a, b = np.meshgrid(pts, pts, indexing="ij")
    s = np.concatenate([a.ravel(), rng.integers(0, 5_100_000, 40)])
    e = np.concatenate([b.ravel(), s[-40:] + rng.integers(0, 300_000, 40)])
    cases.append(("runs", pos, s.astype(np.int32), e.astype(np.int32)))
    for k in (0, 1, 2, 15, 16, 17, 31, 32, 33, 63, 64, 65):
        pos = np.sort(rng.integers(100, 100 + 2 * k + 1, k)).astype(np.int32)
        pts = np.arange(95, 100 + 2 * k + 6, dtype=np.int32)
        s, e = (g.ravel() for g in np.meshgrid(pts, pts[::1 + k // 8], indexing="ij"))
        q = s.size - (s.size % 8 == 0)  # not a multiple of 8
        cases.append((f"k{k}", pos, s[:q], e[:q]))
    pos = np.sort(rng.integers(1_000, 900_000, 1_000)).astype(np.int32)
    last = int(pos[-1])
    pts = np.asarray([0, 1, last - 1, last, last + 1, 2**31 - 18, 2**31 - 17,
                      POS_SENTINEL - 1, POS_SENTINEL], np.int64)
    a, b = np.meshgrid(pts, pts, indexing="ij")
    cases.append(("sentinel-padded", pad_pow2(pos, POS_SENTINEL),
                  a.ravel().astype(np.int32), b.ravel().astype(np.int32)))
    pos, _af, _cadd, _rank, s, e = serve_columns(141, (1 << 22) - 1, 999)
    cases.append(("serving-k", pos, *clamped_queries(s, e)))
    return cases


def bits_kernel_checks(torch, device, cases) -> tuple:
    """``bits_spans`` against its plain version on the card, exactly, on
    ``cases`` (:func:`bits_edge_cases`).  Returns the checks and the
    largest absolute difference seen."""
    from annotatedvdb_tpu_torch.ops import intervals as I

    checks, worst = [], 0
    for label, pos, s, e in cases:
        t = [torch.from_numpy(np.ascontiguousarray(x)).to(device) for x in (pos, s, e)]
        got, want = I.bits_spans(*t), I.bits_spans_reference(*t)
        torch.cuda.synchronize()
        err = max(int((g.to(torch.int64) - w.to(torch.int64)).abs().max())
                  if g.numel() else 0 for g, w in zip(got, want))
        same = all(g.dtype == w.dtype and torch.equal(g, w) for g, w in zip(got, want))
        worst = max(worst, err)
        checks.append({"kernel": "bits_spans", "inputs": label, "rows": int(pos.size),
                       "queries": int(s.size), "equal": same, "max_abs_err": err})
        if not same:
            raise AssertionError(f"bits_spans disagrees with its plain version on "
                                 f"{label} (max |diff| {err})")
    return checks, worst


def build_serve_store(work, platform) -> dict:
    """A small store for the query server's tests, built by the port's
    CLIs on ``platform``: two VCF loads (1,500 seeded chr22 lines and 500
    chr8 lines, a duplicate line every 60, the second file overlapping the
    first by 50 lines and adding two over-width rows), a VEP update of half
    the variants (consequence ranks, colocated frequencies) and a CADD join
    (BGZF tables over both chromosomes' rows).  Returns the store
    directory, every variant id of the files plus four the store lacks,
    and the chromosomes' positions."""
    from annotatedvdb_tpu_torch.__main__ import main as port

    def cli(*argv):
        rc = port([*argv, "--platform", platform])
        assert rc == 0, (argv, rc)

    os.makedirs(work, exist_ok=True)
    rng = np.random.default_rng(21)
    n = 1500
    pos22 = 16_000_000 + 2 * np.cumsum(rng.integers(1, 13, n))
    lines22, _ = vcf_lines(21, n, pos22.tolist())
    pos8 = 1_000_000 + 2 * np.cumsum(rng.integers(1, 40, n // 3))
    lines8 = ["8" + ln[2:] for ln in vcf_lines(22, n // 3, pos8.tolist())[0]]
    over = [f"22\t{pos22[-1] + 10}\trs9\t{'A' + 'C' * 69}\tA\t.\t.\t.\n",
            f"22\t{pos22[-1] + 12}\t.\tG\t{'G' + 'T' * 55}\t.\t.\tRS=77\n"]
    vcf_a, vcf_b = os.path.join(work, "a.vcf"), os.path.join(work, "b.vcf")
    with open(vcf_a, "w") as fh:
        fh.write(HEADER)
        fh.writelines(lines8)
        for i, ln in enumerate(lines22[: n // 2]):
            fh.write(ln)
            if i % 60 == 0:
                fh.write(ln)  # a duplicate line
    with open(vcf_b, "w") as fh:
        fh.write(HEADER)
        fh.writelines(lines22[n // 2 - 50:])  # 50 lines the first file has
        fh.writelines(over)
    store = os.path.join(work, "vdb")
    for vcf in (vcf_a, vcf_b):
        cli("load-vcf", "--fileName", vcf, "--storeDir", store, "--commit",
            "--commitAfter", "256")
    vep = os.path.join(work, "x.vep.json")
    write_vep_json(vep, lines8 + lines22, (len(lines8) + n) // 2, 21, 2)
    cli("load-vep", "--fileName", vep, "--storeDir", store, "--commit")
    db = os.path.join(work, "cadd")
    all_lines = lines8 + lines22 + over
    write_cadd_tables(db, vcf_sites(all_lines),
                      {"22": (16_000_000, int(pos22[-1]) - 500),
                       "8": (1_000_000, int(pos8[-1]) - 300)},
                      seed=21, block_rows=64)
    cli("load-cadd", "--databaseDir", db, "--storeDir", store, "--commit",
        "--logFilePath", os.path.join(work, "cadd.log"))
    ids = []
    for ln in all_lines:
        c, p, _v, r, alts = ln.split("\t")[:5]
        ids += [f"{c}:{p}:{r}:{a}" for a in alts.split(",") if a != "."]
    ids += ["22:16000001:A:C", "8:5:A:G", "3:100:A:C",
            "chr22:" + ids[7].split(":", 1)[1]]
    return {"store": store, "ids": ids, "pos22": pos22, "pos8": pos8}


def serve_panel(served, per_group=40, width=2000, seed=0) -> list:
    """Query intervals over a :func:`build_serve_store` store:
    ``per_group`` per chromosome group (so the groups reach the device
    minimums), two on a chromosome the store lacks and one as wide as
    chr22."""
    rng = np.random.default_rng(seed)
    out = []
    for label, pos in (("22", served["pos22"]), ("8", served["pos8"])):
        starts = rng.integers(int(pos[0]) - 1000, int(pos[-1]), per_group)
        for s in starts.tolist():
            out.append(f"{label}:{s}-{s + int(rng.integers(1, width))}")
    return out + ["3:1-100", "3:5000-9000", "22:1-64000000"]


def rejects_vcf(path, n, seed=13) -> dict:
    """A chr22 VCF of ``n`` seeded lines with five malformed lines
    between them (short, a non-numeric and an out-of-range POS); returns
    {"good": lines, "bad": malformed lines as written}.  A Python-engine
    load quarantines the bad lines with their text, and ``doctor
    replay-rejects`` must give them back verbatim."""
    rng = np.random.default_rng(seed)
    pos = 20_000_000 + 3 * np.cumsum(rng.integers(1, 9, n))
    good, _rows = vcf_lines(seed, n, pos.tolist())
    bad = ["22\t100\n", "22\tabc\t.\tA\tC\t.\t.\t.\n",
           "22\t2147483648\t.\tA\tC\t.\t.\t.\n", "22\t-5\t.\tG\tT\t.\t.\t.\n",
           "garbage line without tabs\n"]
    with open(path, "w") as fh:
        fh.write(HEADER)
        for i, ln in enumerate(good):
            fh.write(ln)
            if i % max(n // len(bad), 1) == 0 and i // max(n // len(bad), 1) < len(bad):
                fh.write(bad[i // max(n // len(bad), 1)])
    return {"good": good, "bad": bad}


def profile_matches_stats(groups, results, labels) -> bool:
    """Whether ``doctor profile``'s per-group summaries equal the
    ``/stats/region`` results over each whole chromosome (the same
    summary shape, less the profile's ``segments``/``read_amp`` and the
    result's ``region``)."""
    for label, res in zip(labels, results):
        g = {k: v for k, v in groups[label].items()
             if k not in ("segments", "read_amp")}
        if g != {k: v for k, v in res.items() if k != "region"}:
            return False
    return True


def serve_inputs(i):
    """Phase 3's serving-shape input set ``i`` (0, 1, 2): the host columns
    and clamped queries, and the columns padded as the kernels take them."""
    from annotatedvdb_tpu_torch.ops.intervals import clamped_queries
    from annotatedvdb_tpu_torch.utils.arrays import POS_SENTINEL, pad_pow2

    pos, af, cadd, rank, s, e = serve_columns(40 + i, SERVE_ROWS, SERVE_QUERIES)
    s, e = clamped_queries(s, e)
    padded = [pad_pow2(a, f) for a, f in zip((pos, af, cadd, rank),
                                             (POS_SENTINEL, -1, -1, -1))]
    return (pos, af, cadd, rank, s, e), padded


def serve_kernel_phase(torch, device, pool) -> list:
    """Phase 3 for the serving kernels (``bits_spans``, ``stats_panel``,
    ``windowed_stats``): each against its plain version on the card,
    exactly, on :func:`serve_edge_cases` and at the serving shape
    (:data:`SERVE_ROWS` rows padded to 4,194,304, :data:`SERVE_QUERIES`
    intervals, windows 1, 7, 16 and 64); then, in ``pool``'s spawned
    process (:func:`serve_kernel_timing`), each timed at that shape.
    Returns the kernel table rows (launches filled in after phase 11)."""
    host, padded = serve_inputs(0)
    checks, worst = serve_kernel_checks(
        torch, device, serve_edge_cases() + [("serving", *padded, *host[4:])])
    bits_checks, bits_worst = bits_kernel_checks(torch, device, bits_edge_cases())
    checks += bits_checks
    worst = max(worst, bits_worst)
    timing = pool.submit(serve_kernel_timing).result()
    emit("serve_kernels", checks=checks, timing=timing)
    sources = {"bits_spans": ("bits_spans.cu", "annotatedvdb_tpu/ops/intervals.py:60"),
               "stats_panel": ("stats_panel.cu", "annotatedvdb_tpu/ops/stats.py:139"),
               "windowed_stats": ("stats_panel.cu", "annotatedvdb_tpu/ops/stats.py:187")}
    rows = []
    for name, (src, replaces) in sources.items():
        t = timing[name]
        rows.append({
            "name": name, "route": "cuda",
            "source": f"annotatedvdb_tpu_torch/csrc/{src}", "replaces": replaces,
            "launches": None, "max_abs_err": worst, "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
        })
    return rows


def serve_kernel_timing() -> dict:
    """The serving kernels timed at the serving shape in a fresh process
    (a process that has run many profiles can lose kernel events): each
    kernel beside its plain version, its bound and (for the spans) two
    ``torch.searchsorted`` calls, device ms per call by profiler with each
    kernel name's own ms and launches per call, call ms by CUDA events,
    and the device memory of one call."""
    import torch

    from annotatedvdb_tpu_torch.ops import intervals as I
    from annotatedvdb_tpu_torch.ops import stats as S
    from annotatedvdb_tpu_torch.runtime import resolve_device

    device = resolve_device("cuda")
    sets = [serve_inputs(i) for i in range(3)]
    host = sets[0][0]
    cols = [torch.from_numpy(a).to(device) for a in sets[0][1]]
    queries = [[torch.from_numpy(np.ascontiguousarray(x)).to(device) for x in h[4:]]
               for h, _p in sets]
    del sets

    def best(rs):
        dev = [r["device"] for r in rs if r["device"] is not None]
        if dev:
            return min(dev, key=lambda d: d["ms"])
        return {"ms": min(r["call_ms"] for r in rs), "kernels": None}

    def single_ms(fn, args):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        fn(*args)
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop)

    def timed(fns, inputs):
        runs = {}
        for name, fn, iters in fns:
            if iters == 0:  # one call between CUDA events, no warm-up
                runs.setdefault(name, []).append(
                    {"device": None, "call_ms": single_ms(fn, inputs[0])})
                continue
            runs.setdefault(name, []).append({
                "device": device_profile(torch, fn, inputs, iters),
                "call_ms": call_ms(torch, fn, inputs, iters)})
        return runs

    pos_t, af_t, cadd_t, rank_t = cols
    w = SERVE_WINDOWS
    shapes = {
        "bits_spans": ([(pos_t, *q) for q in queries], I.bits_spans,
                       I.bits_spans_reference,
                       lambda p, s, e: (torch.searchsorted(p, s),
                                        torch.searchsorted(p, e, right=True)),
                       "bits"),
        "stats_panel": ([(*cols, *q) for q in queries], S.stats_panel,
                        S.stats_panel_reference, None, "panel"),
        "windowed_stats": ([(pos_t, cadd_t, *q) for q in queries],
                           lambda p, c, s, e: S.windowed_stats(p, c, s, e, w),
                           lambda p, c, s, e: S.windowed_stats_reference(p, c, s, e, w),
                           None, "windows"),
    }
    timing = {}
    for name, (inputs, kernel, plain, library, kind) in shapes.items():
        # the stats plain versions take seconds a call at this shape: one
        # timed call, after the warm call below
        slow = name != "bits_spans"
        fns = [("plain", plain, 0 if slow else 3), ("kernel", kernel, 50),
               ("kernel", kernel, 50)] + ([] if slow else [("plain", plain, 3)])
        if library is not None:
            fns += [("library", library, 50)]
        torch.cuda.reset_peak_memory_stats(device)
        base = torch.cuda.memory_allocated(device)
        plain(*inputs[0])
        torch.cuda.synchronize()
        plain_peak = torch.cuda.max_memory_allocated(device) - base
        torch.cuda.reset_peak_memory_stats(device)
        kernel(*inputs[0])
        torch.cuda.synchronize()
        kernel_peak = torch.cuda.max_memory_allocated(device) - base
        runs = timed(fns, inputs)
        bound = serve_bound(kind, host[0], host[4], host[5])
        k = best(runs["kernel"])
        timing[name] = {**bound, "ms": k["ms"], "kernels": k["kernels"],
                        "plain_ms": best(runs["plain"])["ms"],
                        "library_ms": best(runs["library"])["ms"] if library else None,
                        "call_ms": min(r["call_ms"] for r in runs["kernel"]),
                        "bound_share": bound["bound_ms"] / k["ms"],
                        "plain_peak_bytes": plain_peak, "kernel_peak_bytes": kernel_peak,
                        "timed_by": {n: "profiler" if any(
                            r["device"] is not None for r in rs) else "events"
                            for n, rs in runs.items()},
                        "timing_runs": runs}
    return timing


# ------------------------------------------------ mesh kernels (phase 3)

#: the mesh's probe shape (phase 3): a shard's multi-chromosome slice of
#: 1,048,576 rows at W = 49 against 65,536 queries
MESH_SLICE_ROWS = 1 << 20
MESH_QUERIES = 1 << 16
#: a serving bulk's probe on one shard in phase 15: 256 ids over four
#: shards against a shard's ~125,000 rows (500,000 lines over four),
#: padded to 131,072
MESH_BULK_ROWS = 125_000
MESH_BULK_QUERIES = 64
#: the probe's checked allele widths: below, at and past a warp's 32 lanes
LOOKUP_WIDTHS = (1, 16, 31, 32, 33, 49, 65, 96)
#: the stacked-BITS shape: 25 groups (chromosomes 1-22, X, Y, MT) padded
#: to the largest, 4,096 intervals over them
MESH_GROUPS = 25
MESH_INTERVALS = 4096
#: rows per 100 kb of a chromosome in phase 15's stack: 1,000,000 lines
#: over the 3.1 Gb genome (chr1's group pads to 131,072 rows)
MESH_STACK_SCALE = 32


def _multi_slice(rows, width, pad_to=0) -> tuple:
    """A shard's store slice from (chrom, pos, hm, ref, alt) rows: sorted
    by (pos, hm), stable, then padded with sentinel rows (position
    POS_SENTINEL, everything else 0) up to ``pad_to``.  Returns the seven
    columns (chrom int8, pos int32, hm uint32, ref and alt [M, W] uint8,
    ref_len and alt_len int32)."""
    from annotatedvdb_tpu_torch.utils.arrays import POS_SENTINEL

    rows = sorted(rows, key=lambda r: (r[1], r[2]))
    m = max(len(rows), pad_to)
    chrom = np.zeros(m, np.int8)
    pos = np.full(m, POS_SENTINEL, np.int32)
    hm = np.zeros(m, np.uint32)
    rl = np.zeros(m, np.int32)
    al = np.zeros(m, np.int32)
    for i, (c, p, h, _r, _a) in enumerate(rows):
        chrom[i], pos[i], hm[i] = c, p, h
    ref, rlen = encode([r[3] for r in rows], width)
    alt, alen = encode([r[4] for r in rows], width)
    ref_m = np.zeros((m, width), np.uint8)
    alt_m = np.zeros((m, width), np.uint8)
    ref_m[:len(rows)], alt_m[:len(rows)] = ref, alt
    rl[:len(rows)], al[:len(rows)] = rlen, alen
    return chrom, pos, hm, ref_m, alt_m, rl, al


def _multi_queries(rows, width) -> tuple:
    """Query columns from (chrom, pos, hm, ref, alt) rows, in order."""
    ref, rl = encode([r[3] for r in rows], width)
    alt, al = encode([r[4] for r in rows], width)
    return (np.asarray([r[0] for r in rows], np.int8),
            np.asarray([r[1] for r in rows], np.int32),
            np.asarray([r[2] for r in rows], np.uint32), ref, alt, rl, al)


def lookup_multi_edge_cases(width) -> list:
    """``lookup_in_sorted_multi``'s traps as (label, store columns, query
    columns) at allele width ``width``: a run of five equal (pos, hash)
    rows (the fifth is past the four-candidate window and must miss), a
    run of four (all hit), a cross-chromosome collision (same pos and
    mixed hash, another chromosome: miss), two chromosomes at one
    position and hash (each finds its own row), hashes at 2**31 and
    2**32 - 1 (unsigned order), an allele of exactly W bytes and one
    differing in its last byte, a length mismatch, positions before,
    after and between the rows, negative (salted) positions, the sentinel
    itself (which matches the first pad row), on a sentinel-padded slice,
    on an empty slice (M = 0) and on an all-sentinel slice; two warps
    whose lanes mix queries with 0, 1 and 4 candidates that pass every
    scalar (``mixed-warp``: a lane's fourth candidate the hit, all four
    failing, a single candidate failing on its last byte); hits on rows
    1-7 of a slice, whose alleles start off a 4-byte boundary at any
    width not a multiple of 4 (``off-word``); then a random
    multi-chromosome slice of 3,000 rows padded to 4,096 with 4,099
    queries (hits, misses, cross-chromosome collisions)."""
    from annotatedvdb_tpu_torch.utils.arrays import POS_SENTINEL

    long_a = "ACGT" * (width // 4) + "A" * (width % 4)
    run5 = [(3, 1000, 77, r, a) for r, a in
            (("A", "C"), ("A", "G"), ("A", "T"), ("C", "A"), ("C", "G"))]
    run4 = [(9, 6000, 5, "G", a) for a in ("A", "C", "T", "GA")]
    rows = run5 + run4 + [
        (3, 2000, 500, "G", "T"),
        (5, 3000, 10, "A", "C"), (5, 3000, 20, "A", "G"),
        (5, 3000, 2**31, "A", "T"), (5, 3000, 2**32 - 1, "C", "T"),
        (7, 4000, 99, long_a, "C"),
        (1, 5000, 42, "T", "G"), (2, 5000, 42, "T", "G"),
        (25, 7000, 3, "ACG", "A"),
    ]
    last_flip = long_a[:-1] + ("C" if long_a[-1] != "C" else "G")
    queries = rows + [
        (4, 2000, 500, "G", "T"),          # cross-chromosome collision
        (3, 1000, 78, "A", "C"),           # hash differs
        (7, 4000, 99, last_flip, "C"),     # last byte differs
        (25, 7000, 3, "ACGT", "A"),        # length differs
        (5, 2999, 10, "A", "C"), (5, 3001, 10, "A", "C"),
        (1, 1, 0, "A", "C"), (1, 10**9, 0, "A", "C"),
        (0, -5, 0, "", ""), (0, -1, 0, "", ""),
        (0, POS_SENTINEL, 0, "", ""),       # a pad row's identity
        (0, 0, 0, "", ""),
    ]
    q = _multi_queries(queries, width)
    cases = [("edges", _multi_slice(rows, width, pad_to=32), q),
             ("unpadded", _multi_slice(rows, width), q),
             ("empty", _multi_slice([], width), q),
             ("sentinels", _multi_slice([], width, pad_to=8), q)]
    # lanes by three: no candidate, one, four (runs of four equal keys)
    runs = [(4, 9000 + 10 * t, 1000 + t, "A", x)
            for t in range(8) for x in ("C", "G", "T", "A")]
    singles = [(4, 20000 + 10 * t, 2000 + t, long_a, "T") for t in range(8)]
    mixed = []
    for lane in range(64):
        t = lane // 3 % 8
        if lane % 3 == 0:
            mixed.append((4, 30000 + lane, 7, "A", "C"))
        elif lane % 3 == 1:
            mixed.append(singles[t] if lane % 2 else (4, 20000 + 10 * t, 2000 + t,
                                                      last_flip, "T"))
        else:
            # the fourth candidate hits, the first, none of the four
            mixed.append((4, 9000 + 10 * t, 1000 + t, "A", ("A", "C", "N")[t % 3]))
    cases.append(("mixed-warp", _multi_slice(runs + singles, width, pad_to=128),
                  _multi_queries(mixed, width)))
    word = [(6, 100 + j, 50 + j, long_a[::-1], "ACGT"[j % 4] * min(j + 1, width))
            for j in range(8)]
    cases.append(("off-word", _multi_slice(word, width),
                  _multi_queries([word[j] for j in (1, 2, 3, 5, 6, 7, 0)], width)))
    store, query = lookup_multi_random(7 + width, 3_000, 4_099, width,
                                       pad_to=4_096)
    cases.append(("random", store, query))
    return cases


def mesh_bulk_case(seed=17) -> tuple:
    """(slice, queries) at a serving bulk's shape on one shard:
    :data:`MESH_BULK_QUERIES` queries against :data:`MESH_BULK_ROWS` rows
    padded to a power of two, as ``parallel/device_store.py`` pads."""
    from annotatedvdb_tpu_torch.utils.arrays import next_pow2

    return lookup_multi_random(seed, MESH_BULK_ROWS, MESH_BULK_QUERIES, WIDTH,
                               pad_to=next_pow2(MESH_BULK_ROWS))


def lookup_multi_random(seed, m, n, width, pad_to=0) -> tuple:
    """A random multi-chromosome slice of ``m`` rows (chromosomes 1-25,
    runs of equal positions, alleles of 1 to ``width`` + 2 bytes cut to
    the width), padded to ``pad_to``, and ``n`` queries: half copies of
    rows, a quarter the same with the chromosome changed (cross-chromosome
    collisions), a quarter with an allele byte or a length changed.
    Vectorized: the phase-3 shape (1,048,576 rows) builds in seconds."""
    from annotatedvdb_tpu_torch.utils.arrays import POS_SENTINEL

    rng = np.random.default_rng(seed)
    mm = max(m, pad_to)
    chrom = rng.integers(1, 26, m).astype(np.int8)
    pos = np.sort(rng.integers(1, max(m // 2, 2), m)).astype(np.int32)
    hm = rng.integers(0, 2**32, m, dtype=np.uint64).astype(np.uint32)
    k = hm[1::7].size  # neighbours sharing a hash (equal keys at one position)
    hm[:7 * k:7] = hm[1::7]
    key = (pos.astype(np.uint64) << np.uint64(32)) | hm
    order = np.argsort(key, kind="stable")
    chrom, pos, hm = chrom[order], pos[order], hm[order]
    bases = np.frombuffer(b"ACGT", np.uint8)
    rl = rng.integers(1, width + 3, m).astype(np.int32)
    al = rng.integers(1, width + 3, m).astype(np.int32)
    cols = np.arange(width)
    ref = np.where(cols[None, :] < rl[:, None],
                   bases[rng.integers(0, 4, (m, width))], 0).astype(np.uint8)
    alt = np.where(cols[None, :] < al[:, None],
                   bases[rng.integers(0, 4, (m, width))], 0).astype(np.uint8)

    def padded(a, fill):
        out = np.full((mm,) + a.shape[1:], fill, a.dtype)
        out[:m] = a
        return out

    store = (padded(chrom, 0), padded(pos, POS_SENTINEL), padded(hm, 0),
             padded(ref, 0), padded(alt, 0), padded(rl, 0), padded(al, 0))
    return store, multi_queries(rng, (chrom, pos, hm, ref, alt, rl, al), n, width)


def multi_queries(rng, rows, n, width) -> tuple:
    """``n`` queries against the slice ``rows`` (its real rows' seven
    columns): half copies of rows, a quarter the same with the chromosome
    changed (cross-chromosome collisions), a quarter with an allele byte
    or a length changed.  ``rng`` is a numpy Generator or a seed."""
    rng = np.random.default_rng(rng)
    pick = rng.integers(0, rows[1].size, n)
    q = [a[pick].copy() for a in rows]
    kind = rng.integers(0, 4, n)
    cross = kind == 2
    q[0][cross] = (q[0][cross] % 25) + 1
    change = kind == 3
    idx = np.flatnonzero(change)
    flip = idx[::2]
    col = rng.integers(0, width, flip.size)
    q[3][flip, col] = np.where(q[3][flip, col] == ord("A"), ord("C"), ord("A"))
    q[5][idx[1::2]] += 1
    return tuple(q)


def stacked_bits_case(seed, groups=MESH_GROUPS, intervals=MESH_INTERVALS,
                      scale=1) -> tuple:
    """The mesh executor's panel stack: ``groups`` chromosome groups with
    rows in proportion to their GRCh38 lengths (``scale`` rows per 100 kb,
    one group left empty, all-sentinel), each row sentinel-padded to the
    largest group's power of two, and ``intervals`` query intervals
    spread over the groups in proportion too, zero-padded to the largest
    group's count (the pad queries come back with leaf -1).  Returns
    (pos [B, R], starts [B, Q], ends [B, Q], per-group query counts)."""
    from annotatedvdb_tpu_torch.genome.assemblies import BUILD_LENGTHS
    from annotatedvdb_tpu_torch.utils.arrays import POS_SENTINEL, next_pow2

    rng = np.random.default_rng(seed)
    lengths = np.asarray(BUILD_LENGTHS["grch38"][:groups], np.int64)
    counts = np.maximum(lengths * scale // 100_000, 1)
    counts[groups // 2] = 0
    share = np.maximum(np.round(intervals * lengths / lengths.sum()), 1).astype(int)
    share[-1] += intervals - share.sum()
    r_cap = next_pow2(int(counts.max()))
    q_cap = int(share.max())
    pos = np.full((groups, r_cap), POS_SENTINEL, np.int32)
    starts = np.zeros((groups, q_cap), np.int32)
    ends = np.zeros((groups, q_cap), np.int32)
    for g in range(groups):
        k, length = int(counts[g]), int(lengths[g])
        rows = np.sort(rng.integers(1, length, k)).astype(np.int32)
        if k > 40:
            rows[10:30] = rows[10]  # a run of equal positions
        pos[g, :k] = rows
        s = rng.integers(1, length, share[g])
        starts[g, :share[g]] = s
        ends[g, :share[g]] = np.minimum(s + rng.integers(0, 2_000_000, share[g]),
                                        length)
    return pos, starts, ends, share


def stacked_bits_edge_cases() -> list:
    """(label, pos [B, R], starts [B, Q], ends [B, Q]) for the stacked BITS
    kernel: one group (the single form), a stack with an all-sentinel
    group and zero-padded queries (leaf -1 by floor division), one row a
    group, Q not a multiple of 8 and B * Q past one block, runs of equal
    positions, bounds at the sentinel and the clamp; queries below and at
    each group's first row (``below-first``: where that row alone decides
    a bound); a stack of all-sentinel groups with real queries
    (``all-pad``); groups of 1 to 40 real rows in a 64-row pad, about a
    search window's 16 (``few-real``); ``end < start`` on either side of
    the rows (``end-before-start``); then the phase's stack at a
    hundredth of its rows."""
    from annotatedvdb_tpu_torch.utils.arrays import POS_SENTINEL

    rng = np.random.default_rng(150)
    cases = []
    pos = np.sort(rng.integers(100, 400, (1, 64)), axis=1).astype(np.int32)
    s = rng.integers(50, 450, (1, 13)).astype(np.int32)
    cases.append(("one-group", pos, s, (s + rng.integers(0, 60, s.shape)).astype(np.int32)))
    pos = np.full((5, 32), POS_SENTINEL, np.int32)
    pos[0, :20] = np.sort(rng.integers(1, 100, 20))
    pos[2, :32] = np.sort(rng.integers(1, 100_000, 32))
    pos[3, :5] = 777
    starts = np.zeros((5, 11), np.int32)
    ends = np.zeros((5, 11), np.int32)
    starts[0, :7] = [0, 1, 5, 50, 99, 100, 2**31 - 17]
    ends[0, :7] = [0, 3, 60, 50, 200, 100, 2**31 - 17]
    starts[2, :3] = [1, 15625, 15626]
    ends[2, :3] = [15625, 15626, 100_000]
    starts[3, :4] = [776, 777, 777, 778]
    ends[3, :4] = [777, 777, 778, 800]
    starts[4, :2] = [POS_SENTINEL - 16, 1]
    ends[4, :2] = [POS_SENTINEL - 16, POS_SENTINEL - 16]
    cases.append(("padded", pos, starts, ends))
    pos = np.sort(rng.integers(1, 1000, (9, 1)), axis=1).astype(np.int32)
    s = rng.integers(0, 1000, (9, 37)).astype(np.int32)
    cases.append(("one-row", pos, s, (s + 3).astype(np.int32)))
    pos = np.full((4, 64), POS_SENTINEL, np.int32)
    for g, k in enumerate((1, 16, 17, 40)):
        pos[g, :k] = np.sort(rng.integers(500, 900, k))
    first = pos[:, :1]
    starts = first + np.asarray([[-400, -2, -1, 0, 1, 3, -400, -1, 0, -5, 0, 1]])
    ends = first + np.asarray([[-400, -2, -1, 0, 1, 3, -1, 0, 0, 5, 60, 999]])
    cases.append(("below-first", pos, starts.astype(np.int32), ends.astype(np.int32)))
    s = rng.integers(0, 2**31 - 17, (3, 9)).astype(np.int32)
    cases.append(("all-pad", np.full((3, 32), POS_SENTINEL, np.int32), s,
                  np.maximum(s, rng.integers(0, 2**31 - 17, (3, 9))).astype(np.int32)))
    pos = np.full((40, 64), POS_SENTINEL, np.int32)
    for g in range(40):
        pos[g, :g + 1] = np.sort(rng.integers(1, 5_000, g + 1))
    s = rng.integers(0, 5_200, (40, 12)).astype(np.int32)
    cases.append(("few-real", pos, s, (s + rng.integers(0, 800, s.shape)).astype(np.int32)))
    pos = np.sort(rng.integers(1_000, 2_000, (3, 48)), axis=1).astype(np.int32)
    s = np.asarray([[5, 1_500, 3_000, 1_000, 2_000, 1_999]] * 3, np.int32)
    e = np.asarray([[1, 1_200, 2_500, 999, 1_000, 1_000]] * 3, np.int32)
    cases.append(("end-before-start", pos, s, e))
    pos, starts, ends, _share = stacked_bits_case(151, scale=0.01)
    cases.append(("phase-shape/100", pos, starts, ends))
    return cases


def lookup_multi_bound(store, query) -> dict:
    """Bytes ``lookup_in_sorted_multi`` must move for these inputs and the
    operations it does.  Bytes: each query's position (4) and outputs (5);
    its mixed hash (8) where its position is in the slice; its chromosome
    and lengths (9) where a candidate matches on position and hash; its
    allele bytes (2 W) where a candidate matches on every scalar.  In the
    slice: the 32-byte sectors of the position column its two searches
    touch, and of the hash column its hash search and its candidates
    touch (a candidate's position equals the query's inside ``[lo, hi)``
    and is not read); the chromosome and lengths (9) of every candidate
    whose hash matches, and the allele bytes (2 W) of every candidate
    whose scalars match.  Operations: three a search step, five a
    candidate and one a compared allele byte."""
    s_chrom, s_pos, s_hm, _s_ref, _s_alt, s_rl, s_al = store
    chrom, pos, hm, ref, _alt, rl, al = query
    n, w = pos.size, ref.shape[1]
    sectors = _search_sectors(s_pos, pos) | _search_sectors(s_pos, pos, right=True)
    lo = np.searchsorted(s_pos, pos, side="left")
    hi = np.searchsorted(s_pos, pos, side="right")
    hm64 = s_hm.astype(np.int64)
    q64 = hm.astype(np.int64)
    l, r = lo.copy(), hi.copy()
    hm_sectors = set()
    steps = 0
    while True:
        active = l < r
        if not active.any():
            break
        steps += int(active.sum())
        mid = (l + r) >> 1
        hm_sectors.update((mid[active] // 4).tolist())
        less = hm64[np.minimum(mid, s_pos.size - 1)] < q64
        l = np.where(active & less, mid + 1, l)
        r = np.where(active & ~less, mid, r)
    examined = np.minimum(np.maximum(hi - l, 0), 4)
    hash_hits = cand = 0
    scalars_q = np.zeros(n, bool)  # a candidate matches on position and hash
    alleles_q = np.zeros(n, bool)  # a candidate matches on every scalar
    if s_pos.size:
        for k in range(4):
            ii = np.minimum(l + k, s_pos.size - 1)
            seen = k < examined
            hm_sectors.update((ii[seen] // 4).tolist())
            same_h = seen & (hm64[ii] == q64)
            ok = same_h & (s_chrom[ii] == chrom) & (s_rl[ii] == rl) & (s_al[ii] == al)
            hash_hits += int(same_h.sum())
            cand += int(ok.sum())
            scalars_q |= same_h
            alleles_q |= ok
    nbytes = (9 * n + 8 * int((hi > lo).sum()) + 9 * int(scalars_q.sum())
              + 2 * w * int(alleles_q.sum()) + 32 * (len(sectors) + len(hm_sectors))
              + 9 * hash_hits + 2 * w * cand)
    log_m = int(np.ceil(np.log2(s_pos.size + 1)))
    ops = 3 * (2 * n * log_m + steps) + 5 * int(examined.sum()) + 2 * w * cand
    bytes_ms = nbytes / MEM_BYTES_PER_S * 1e3
    ops_ms = ops / INT32_OPS_PER_S * 1e3
    return {"rows": int(s_pos.size), "queries": int(n), "width": int(w),
            "candidates_examined": int(examined.sum()), "candidates_hash_equal": hash_hits,
            "candidates_matched": cand, "queries_allele_read": int(alleles_q.sum()),
            "search_sectors": len(sectors) + len(hm_sectors), "bytes": int(nbytes),
            "ops": int(ops), "bytes_ms": bytes_ms, "ops_ms": ops_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def stacked_bits_bound(pos, starts, ends) -> dict:
    """Bytes and operations of the stacked BITS call: each group's row as
    :func:`serve_bound`'s ``bits`` kind counts a single one (query bounds
    in, 13 bytes a query out, the position sectors its searches touch),
    summed over the groups, pad queries included (the call answers
    them)."""
    out = {"bytes": 0, "ops": 0, "search_sectors": 0}
    for g in range(pos.shape[0]):
        b = serve_bound("bits", pos[g], starts[g], ends[g])
        for k in out:
            out[k] += b[k]
    bytes_ms = out["bytes"] / MEM_BYTES_PER_S * 1e3
    ops_ms = out["ops"] / INT32_OPS_PER_S * 1e3
    return {"groups": int(pos.shape[0]), "rows": int(pos.shape[1]),
            "queries": int(starts.shape[1]), **out, "bytes_ms": bytes_ms,
            "ops_ms": ops_ms, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def _multi_tensors(torch, cols, device):
    """The slice or query columns on ``device`` as the probe takes them
    (the mixed hash as int64)."""
    out = []
    for k, c in enumerate(cols):
        c = np.ascontiguousarray(c.astype(np.int64) if k == 2 else c)
        out.append(torch.from_numpy(c).to(device))
    return out


def mesh_kernel_checks(torch, device) -> tuple:
    """``lookup_multi`` and ``bits_spans_stacked`` against their plain
    versions on the card, exactly, on the edge cases and at the phase
    shapes.  Returns the checks and the largest absolute difference."""
    from annotatedvdb_tpu_torch.ops import dedup
    from annotatedvdb_tpu_torch.ops import intervals as I

    checks, worst = [], 0

    def compare(kernel, label, got, want, **info):
        nonlocal worst
        torch.cuda.synchronize()
        err = max(int((g.to(torch.int64) - w.to(torch.int64)).abs().max())
                  if g.numel() else 0 for g, w in zip(got, want))
        same = all(g.dtype == w.dtype and torch.equal(g, w) for g, w in zip(got, want))
        worst = max(worst, err)
        checks.append({"kernel": kernel, "inputs": label, "equal": same,
                       "max_abs_err": err, **info})
        if not same:
            raise AssertionError(f"{kernel} disagrees with its plain version on "
                                 f"{label} (max |diff| {err})")

    cases = [(f"{label}-w{w}", st, q) for w in LOOKUP_WIDTHS
             for label, st, q in lookup_multi_edge_cases(w)]
    cases.append(("phase", *lookup_multi_random(15, MESH_SLICE_ROWS, MESH_QUERIES,
                                                WIDTH)))
    cases.append(("bulk", *mesh_bulk_case()))
    for label, store, query in cases:
        t = _multi_tensors(torch, store, device) + _multi_tensors(torch, query, device)
        got = dedup.lookup_in_sorted_multi(*t)
        want = dedup.lookup_in_sorted_multi_reference(*t)
        compare("lookup_multi", label, got, want, rows=int(store[1].size),
                queries=int(query[1].size), hits=int(want[0].sum()))
    stacks = stacked_bits_edge_cases() + [
        ("phase", *stacked_bits_case(153, scale=MESH_STACK_SCALE)[:3])]
    for label, pos, starts, ends in stacks:
        t = [torch.from_numpy(np.ascontiguousarray(x)).to(device)
             for x in (pos, starts, ends)]
        compare("bits_spans_stacked", label, I.bits_spans_stacked(*t),
                I.bits_spans_stacked_reference(*t), groups=int(pos.shape[0]),
                rows=int(pos.shape[1]), queries=int(starts.shape[1]))
    return checks, worst


def dedup_bound(rows) -> dict:
    """The in-batch dedup's bound on its inputs ``rows`` (the chained
    sorts' keys ``chrom``, ``pos``, ``h``, then ``ref``, ``alt`` and the
    lengths): each input read once and the ``[n]`` bool flags written once
    over the memory rate, or three stable sorts' key compares (``n
    log2 n`` each) and the neighbour compares of keys, lengths and allele
    bytes over the 32-bit rate."""
    n = int(rows[1].numel())
    nbytes = sum(t.numel() * t.element_size() for t in rows) + n
    ops = int(3 * n * np.log2(max(n, 2)) + n * (3 + 2 + 2 * rows[3].shape[1]))
    bytes_ms = nbytes / MEM_BYTES_PER_S * 1e3
    ops_ms = ops / INT32_OPS_PER_S * 1e3
    return {"rows": n, "bytes": nbytes, "ops": ops, "bytes_ms": bytes_ms,
            "ops_ms": ops_ms, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def mesh_kernel_timing() -> dict:
    """The mesh's kernels timed at the phase shapes in the second process,
    while the first waits (no other phase holds the card):
    ``lookup_multi`` at a 1,048,576-row slice (W = 49) against 65,536
    queries and at a serving bulk's shard (``lookup_multi_bulk``: 64
    queries, 125,000 rows), ``bits_spans_stacked`` at phase 15's stack (25 groups, 4,096
    intervals), each beside its plain version, its bound and (the stack)
    two batched ``torch.searchsorted`` calls; device ms per call by
    profiler, call ms by CUDA events.  Beside them the insert step's
    plain in-batch dedup (``mark_batch_duplicates_multi``) at one shard's
    69,632 rows."""
    import torch

    from annotatedvdb_tpu_torch.ops import dedup
    from annotatedvdb_tpu_torch.ops import intervals as I
    from annotatedvdb_tpu_torch.runtime import resolve_device

    device = resolve_device("cuda")
    store, query = lookup_multi_random(15, MESH_SLICE_ROWS, MESH_QUERIES, WIDTH)
    others = [multi_queries(16 + k, store, MESH_QUERIES, WIDTH) for k in range(2)]
    s_t = _multi_tensors(torch, store, device)
    k1_inputs = [tuple(s_t + _multi_tensors(torch, q, device))
                 for q in (query, *others)]
    stacks = [stacked_bits_case(153 + k, scale=MESH_STACK_SCALE)[:3]
              for k in range(3)]
    k2_inputs = [tuple(torch.from_numpy(np.ascontiguousarray(x)).to(device)
                       for x in st) for st in stacks]
    bulk_store, bulk_query = mesh_bulk_case()
    bulk_real = [c[:MESH_BULK_ROWS] for c in bulk_store]
    b_t = _multi_tensors(torch, bulk_store, device)
    bulk_inputs = [tuple(b_t + _multi_tensors(torch, q, device)) for q in (
        bulk_query, *(multi_queries(18 + k, bulk_real, MESH_BULK_QUERIES, WIDTH)
                      for k in range(2)))]

    def best(rs):
        dev = [r["device"] for r in rs if r["device"] is not None]
        if dev:
            return min(dev, key=lambda d: d["ms"])
        return {"ms": min(r["call_ms"] for r in rs), "kernels": None}

    shapes = {
        "lookup_multi": (k1_inputs, dedup.lookup_in_sorted_multi,
                         dedup.lookup_in_sorted_multi_reference, None,
                         lookup_multi_bound(store, query)),
        "bits_spans_stacked": (
            k2_inputs, I.bits_spans_stacked, I.bits_spans_stacked_reference,
            lambda p, s, e: (torch.searchsorted(p, s),
                             torch.searchsorted(p, e, right=True)),
            stacked_bits_bound(*stacks[0])),
        "lookup_multi_bulk": (bulk_inputs, dedup.lookup_in_sorted_multi,
                              dedup.lookup_in_sorted_multi_reference, None,
                              lookup_multi_bound(bulk_store, bulk_query)),
    }
    timing = {}
    # the insert step's in-batch dedup (plain torch: chained stable sorts)
    # on one shard's 65,536 slots of the slice's rows, a sixteenth repeated
    rows = [torch.from_numpy(np.ascontiguousarray(c[:MESH_QUERIES])).to(device)
            for c in store]
    rows[2] = rows[2].to(torch.int64)
    rows = [torch.cat([c, c[: MESH_QUERIES // 16]]) for c in rows]
    dedup_inputs = [tuple(rows)]
    runs = [{"device": device_profile(torch, dedup.mark_batch_duplicates_multi,
                                      dedup_inputs, 10),
             "call_ms": call_ms(torch, dedup.mark_batch_duplicates_multi,
                                dedup_inputs, 10)} for _ in range(2)]
    timing["mark_batch_duplicates_multi"] = {
        **dedup_bound(rows), "plain_ms": best(runs)["ms"],
        "kernels": best(runs)["kernels"],
        "call_ms": min(r["call_ms"] for r in runs)}
    for name, (inputs, kernel, plain, library, bound) in shapes.items():
        fns = [("plain", plain, 3), ("kernel", kernel, 50), ("kernel", kernel, 50),
               ("plain", plain, 3)]
        if library is not None:
            fns += [("library", library, 50)]
        runs = {}
        for tag, fn, iters in fns:
            runs.setdefault(tag, []).append({
                "device": device_profile(torch, fn, inputs, iters),
                "call_ms": call_ms(torch, fn, inputs, iters)})
        k = best(runs["kernel"])
        timing[name] = {**bound, "ms": k["ms"], "kernels": k["kernels"],
                        "plain_ms": best(runs["plain"])["ms"],
                        "library_ms": best(runs["library"])["ms"] if library else None,
                        "call_ms": min(r["call_ms"] for r in runs["kernel"]),
                        "bound_share": bound["bound_ms"] / k["ms"],
                        "timed_by": {n: "profiler" if any(
                            r["device"] is not None for r in rs) else "events"
                            for n, rs in runs.items()}}
    # the process runs later phases: hand its cached blocks back to the card
    del k1_inputs, k2_inputs, bulk_inputs, dedup_inputs, rows, s_t, b_t
    torch.cuda.empty_cache()
    return timing


def mesh_kernel_rows(checks, worst, timing) -> list:
    """The two kernel table rows of the mesh's kernels from phase 3's
    :func:`mesh_kernel_checks` and :func:`mesh_kernel_timing` (launches
    filled in after phase 15); emits them."""
    emit("mesh_kernels", checks=checks, timing=timing)
    sources = {"lookup_multi": ("lookup_multi.cu", "annotatedvdb_tpu/ops/dedup.py:141"),
               "bits_spans_stacked": ("bits_spans.cu",
                                      "annotatedvdb_tpu/ops/intervals.py:88")}
    rows = []
    for name, (src, replaces) in sources.items():
        t = timing[name]
        rows.append({
            "name": name, "route": "cuda",
            "source": f"annotatedvdb_tpu_torch/csrc/{src}", "replaces": replaces,
            "launches": None, "max_abs_err": worst, "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
        })
    return rows


# --------------------------------------------- export pack kernel (phase 3)

#: the export's batch rows (``AVDB_EXPORT_BATCH_ROWS``' default)
EXPORT_BATCH_ROWS = 4096
#: batches a part of phase 12's export holds (the 8 MB default part over
#: 4,096-row batches, ``export/core.py::plan_export``)
EXPORT_PART_BATCHES = 37
#: bytes the pack must move a row: seven int32 columns in, seven int32
#: columns, the mask and the level out
EXPORT_ROW_BYTES = 7 * 4 + 7 * 4 + 2
#: integer operations a valid row needs (two wrapping subtractions, two
#: floor divisions at four each, the xor, the bit length, the level, the
#: lane test); a padded row needs the lane test
EXPORT_ROW_OPS = 16
EXPORT_EDGE_POS = (-2**31, -15626, -15625, -1, 0, 1, 2, 15625, 15626, 15627,
                   2**31 - 1 - 16, 2**31 - 1)


def export_edge_columns(seed=0) -> list:
    """The pack's edge rows: every pair of :data:`EXPORT_EDGE_POS` as (pos,
    end), both orders (so ``end < pos`` too: the int32 ends, the leaf-bin
    edges at 15,625, ``MAX_QUERY_POS``), and pairs whose leaf bins differ
    at each bit (``a ^ b`` at each power of two, and negative), with seeded
    int32 feature columns."""
    pos, end = (g.ravel() for g in np.meshgrid(EXPORT_EDGE_POS, EXPORT_EDGE_POS))
    leaf = 15_625 * np.asarray([1 << k for k in range(17)], np.int64)
    pos = np.concatenate([pos, np.ones(17, np.int64), leaf + 1, -leaf])
    end = np.concatenate([end, leaf + 1, np.ones(17, np.int64), -leaf + 7])
    rng = np.random.default_rng(seed)
    feats = [rng.integers(-2**31, 2**31 - 1, pos.size, dtype=np.int32, endpoint=True)
             for _ in range(5)]
    return [pos.astype(np.int32), end.astype(np.int32), *feats]


def export_random_columns(seed, b) -> list:
    """Seven columns of ``b`` uniform int32 values."""
    rng = np.random.default_rng(seed)
    return [rng.integers(-2**31, 2**31 - 1, b, dtype=np.int32, endpoint=True)
            for _ in range(7)]


def export_store_columns(seed, b) -> list:
    """Seven columns shaped as an export batch of a chr22 store gives them:
    sorted positions from 16,000,000 about 11 bp apart, ends up to 60 bp
    past them, AF / CADD / rank fixed point missing on 80% / 40% / 50%."""
    rng = np.random.default_rng(seed)
    pos = (16_000_000 + np.cumsum(rng.integers(1, 22, b))).astype(np.int32)
    end = (pos + rng.integers(0, 60, b) * (rng.random(b) < 0.2)).astype(np.int32)
    feats = [np.where(rng.random(b) < miss, -1, rng.integers(0, 1 << 20, b))
             .astype(np.int32) for miss in (0.8, 0.4, 0.5)]
    codes = [rng.integers(0, 4000, b).astype(np.int32) for _ in range(2)]
    return [pos, end, *codes, *feats]


def export_bound(b, n_valid) -> dict:
    """The least time the card could take to pack ``b`` rows of which
    ``n_valid`` are real: :data:`EXPORT_ROW_BYTES` a row over the memory
    rate, or the operations over the 32-bit integer rate."""
    n = max(0, min(int(n_valid), b))
    nbytes = EXPORT_ROW_BYTES * b
    ops = EXPORT_ROW_OPS * n + (b - n)
    bytes_ms = nbytes / MEM_BYTES_PER_S * 1e3
    ops_ms = ops / INT32_OPS_PER_S * 1e3
    return {"rows": b, "bytes": nbytes, "ops": ops, "bytes_ms": bytes_ms,
            "ops_ms": ops_ms, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def export_pack_checks(torch, device, cases) -> tuple:
    """``export_pack`` against its plain version on the card for each
    ``(label, columns)`` case and each ``n_valid`` of -1, 0, 1, B - 1, B and
    B + 5: the kernel's packed buffer must equal the plain version's
    outputs packed the same way, byte for byte.  Returns the checks and the
    largest absolute difference of any output."""
    from annotatedvdb_tpu_torch.ops import export_pack as P

    checks, worst = [], 0
    for label, cols in cases:
        b = int(cols[0].shape[0])
        t = torch.from_numpy(np.ascontiguousarray(np.stack(cols))).to(device)
        for n in (-1, 0, 1, b - 1, b, b + 5):
            got = P.export_pack(t, n)
            want = P.pack_outputs(P.export_pack_reference(*t, n))
            if device.type == "cuda":
                torch.cuda.synchronize()
            g, w = (P.unpack(x.cpu().numpy(), b) for x in (got, want))
            err = max(int(np.abs(x.astype(np.int64) - y.astype(np.int64)).max())
                      for x, y in zip(g, w))
            equal = bool(torch.equal(got, want))
            worst = max(worst, err)
            checks.append({"inputs": label, "rows": b, "n_valid": n,
                           "max_abs_err": err, "equal": equal})
            if not equal:
                raise AssertionError(f"export_pack disagrees with its plain "
                                     f"version on {label} at n_valid {n}")
    return checks, worst


def export_stack_counts(nb, b) -> list:
    """Per-batch ``n_valid`` vectors for a stack of ``nb`` batches of ``b``
    rows: eight rotations of (-5, 0, 1, B - 1, B, B + 7, INT32_MIN,
    INT32_MAX) over the batches, so each batch meets each case once a
    batch count of 8 or more and neighbouring batches differ."""
    cases = [-5, 0, 1, b - 1, b, b + 7, -2**31, 2**31 - 1]
    return [[cases[(k + r) % 8] for k in range(nb)] for r in range(8)]


def export_stack_checks(torch, device, stacks) -> tuple:
    """``export_pack`` on stacks of batches against its plain version on
    the same stack, byte for byte, for each ``(label, batches, offset)``
    (the ``[nb, 7, B]`` tensor ``offset`` elements into a larger buffer: an
    unaligned base when it is not a multiple of 4) and each vector of
    :func:`export_stack_counts`.  Returns the checks and the largest
    absolute difference of any output."""
    from annotatedvdb_tpu_torch.ops import export_pack as P

    checks, worst = [], 0
    for label, batches, offset in stacks:
        nb, b = len(batches), int(batches[0][0].shape[0])
        host = np.stack([np.stack(c) for c in batches]).astype(np.int32)
        t = offset_copy(torch, host, device, offset)
        for counts in export_stack_counts(nb, b):
            got = P.export_pack(t, counts)
            want = P.pack_outputs(P.export_pack_reference(*t.unbind(1), counts))
            if device.type == "cuda":
                torch.cuda.synchronize()
            g, w = got.cpu().numpy(), want.cpu().numpy()
            err = max(int(np.abs(x.astype(np.int64) - y.astype(np.int64)).max())
                      for k in range(nb)
                      for x, y in zip(P.unpack(g[k * 30 * b:(k + 1) * 30 * b], b),
                                      P.unpack(w[k * 30 * b:(k + 1) * 30 * b], b)))
            equal = bool(torch.equal(got, want))
            worst = max(worst, err)
            checks.append({"inputs": label, "batches": nb, "rows": b, "offset": offset,
                           "n_valid": counts[:8], "max_abs_err": err, "equal": equal})
            if not equal:
                raise AssertionError(f"export_pack disagrees with its plain version on "
                                     f"the stack {label} at n_valid {counts[:8]}")
    return checks, worst


def export_stacks() -> list:
    """Phase 3's stacks: 1, 2 and 37 store-shaped and random batches of
    4,096 rows (37 is the export's part), 3 batches of 4,092 rows (B = 4
    mod 8: every other batch's output 8 bytes off 16-byte alignment), 2 of
    4,097 (B not a multiple of 4) and 4 of 4,096 one element into a buffer
    (an unaligned base)."""
    def stack(seed, nb, b):
        return [(export_store_columns if k % 2 else export_random_columns)(seed + k, b)
                for k in range(nb)]

    return [("stack-1", stack(300, 1, EXPORT_BATCH_ROWS), 0),
            ("stack-2", stack(310, 2, EXPORT_BATCH_ROWS), 0),
            ("stack-37", stack(320, 37, EXPORT_BATCH_ROWS), 0),
            ("stack-3x4092", stack(360, 3, EXPORT_BATCH_ROWS - 4), 0),
            ("stack-2x4097", stack(370, 2, EXPORT_BATCH_ROWS + 1), 0),
            ("stack-4-offset-1", stack(380, 4, EXPORT_BATCH_ROWS), 1)]


def export_kernel_phase(torch, device, pool) -> dict:
    """Phase 3 for ``export_pack``: against its plain version on the card,
    exactly, on :func:`export_edge_columns`, on 1,048,576 random rows, on
    random and store-shaped batches of 4,096 rows and on 8 and 4,097 rows,
    and on the stacks of :func:`export_stacks` at every vector of
    :func:`export_stack_counts`; then, in ``pool``'s spawned process
    (:func:`export_kernel_timing`), its time at one 4,096-row batch (the
    stream's launch), at a part of 37 such batches (the export's launch)
    and at 1,048,576 rows beside the plain version's and the bound.
    Returns the kernel table row, timed at the part (launches filled in
    after phase 12)."""
    cases = [("edge", export_edge_columns()),
             ("random-1m", export_random_columns(1, BIG_ROWS)),
             ("random-4096", export_random_columns(2, EXPORT_BATCH_ROWS)),
             ("store-4096", export_store_columns(3, EXPORT_BATCH_ROWS)),
             ("random-8", export_random_columns(4, 8)),
             ("random-4097", export_random_columns(5, EXPORT_BATCH_ROWS + 1))]
    checks, worst = export_pack_checks(torch, device, cases)
    stacked, worst_stacked = export_stack_checks(torch, device, export_stacks())
    timing = pool.submit(export_kernel_timing).result()
    emit("export_kernel", checks=checks + stacked, timing=timing)
    t = timing["part"]
    return {
        "name": "export_pack", "route": "cuda",
        "source": "annotatedvdb_tpu_torch/csrc/export_pack.cu",
        "replaces": "annotatedvdb_tpu/ops/export_pack.py:34",
        "launches": None, "max_abs_err": max(worst, worst_stacked), "ms": t["ms"],
        "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": None,
        "rows": t["rows"], "batches": EXPORT_PART_BATCHES,
        **{f"{k}_{key}": timing[key][k] for key in ("batch", "1m")
           for k in ("ms", "plain_ms", "bound_ms")},
    }


def export_kernel_timing() -> dict:
    """``export_pack`` timed in a fresh process: at one batch (4,096
    store-shaped rows, 64 input sets: a stream call's launch), at a part
    (37 such batches stacked, 8 sets: the export's launch) and at
    1,048,576 random rows (two sets of 28 MB, past the L2), kernel and
    plain version in turns (plain, kernel, kernel, plain), device ms per
    call by profiler (CUDA events where the profile lost events) and call
    ms by CUDA events, beside the bound.  ``ms`` is the kernel's own
    device time; ``device_ms`` adds the wrapper's upload of the counts."""
    import torch

    from annotatedvdb_tpu_torch.ops import export_pack as P
    from annotatedvdb_tpu_torch.runtime import resolve_device

    device = resolve_device("cuda")

    def plain(cols, n):
        return P.export_pack_reference(*cols.unbind(-2), n)

    def best(rs):
        dev = [r["device"] for r in rs if r["device"] is not None]
        return min(dev, key=lambda d: d["ms"]) if dev else \
            {"ms": min(r["call_ms"] for r in rs), "kernels": None}

    def stacked(seed, nb):
        return np.stack([np.stack(export_store_columns(seed + k, EXPORT_BATCH_ROWS))
                         for k in range(nb)])

    b = EXPORT_BATCH_ROWS
    nb = EXPORT_PART_BATCHES
    out = {}
    for key, sets, counts, iters in (
            ("batch", [np.stack(export_store_columns(100 + i, b)) for i in range(64)], b,
             (20, 200)),
            ("part", [stacked(1000 + 100 * i, nb) for i in range(8)], [b] * nb, (10, 100)),
            ("1m", [np.stack(export_random_columns(200 + i, BIG_ROWS)) for i in range(2)],
             BIG_ROWS, (4, 50))):
        inputs = [(torch.from_numpy(c).to(device), counts) for c in sets]
        runs = {}
        for name, fn, n in (("plain", plain, iters[0]), ("kernel", P.export_pack, iters[1]),
                            ("kernel", P.export_pack, iters[1]),
                            ("plain", plain, iters[0])):
            runs.setdefault(name, []).append({
                "device": device_profile(torch, fn, inputs, n),
                "call_ms": call_ms(torch, fn, inputs, n)})
        rows = sets[0][..., 0, :].size
        bound = export_bound(rows, rows)
        k = best(runs["kernel"])
        kernel = (k["kernels"] or {}).get("export_pack_kernel")
        ms = kernel["ms"] if kernel else k["ms"]
        out[key] = {**bound, "ms": ms, "device_ms": k["ms"], "kernels": k["kernels"],
                    "plain_ms": best(runs["plain"])["ms"],
                    "call_ms": min(r["call_ms"] for r in runs["kernel"]),
                    "bound_share": bound["bound_ms"] / ms,
                    "timed_by": {n: "profiler" if any(r["device"] is not None for r in rs)
                                 else "events" for n, rs in runs.items()},
                    "timing_runs": runs}
    return out


# ------------------------------------------- transport kernels (phase 3)

#: the packed transport's kernel table rows: wrapper name -> the XLA
#: program of the reference's ``ops/pack.py`` it replaces
TRANSPORT_KERNELS = {"inflate_alleles": "annotatedvdb_tpu/ops/pack.py:124",
                     "pack_outputs": "annotatedvdb_tpu/ops/pack.py:32",
                     "pack_vep_outputs": "annotatedvdb_tpu/ops/pack.py:214"}
#: integer operations an inflated byte needs (mask or shift, compare,
#: select, shift) and a packed row (the flag byte's shifts and ors)
INFLATE_BYTE_OPS = 4
PACK_ROW_OPS = 6

#: the annotate kernel's three entries (``ops/annotate_cuda.py``): where a
#: path makes "one annotate launch a chunk", any entry's launch counts
ANNOTATE_ENTRIES = ("annotate_bin", "annotate_bin_packed", "annotate_bin_identity")
#: launches of the packed entry in ``VcfLoader.warmup`` (the CLI's, at the
#: chunk shape) on a card load that packs its outputs
WARMUP_PACKED = 1
#: the packed entry's checks: widths, and row counts (None: every row of
#: :func:`annotate_packed_cases`)
PACKED_WIDTHS = (1, 2, 7, 8, 49, 96, 192)
PACKED_ROWS = (0, 1, 127, 128, 129, 257, None)


def annotate_launches(counts) -> int:
    """Launches of both annotate entries in a launch-count mapping."""
    return sum(counts.get(name, 0) for name in ANNOTATE_ENTRIES)


def pack_inflate_cases(width) -> list:
    """The inflate's edge inputs at ``width``: ``(label, ref_packed,
    alt_packed, width)``.  Every packed byte value 0-255 in every column
    (codes 14 and 15 included, which decode to 0), seeded alleles of 0 to
    ``width`` bases from the whole alphabet encoded as the loader encodes
    them, more packed columns than the width needs, and one row."""
    from annotatedvdb_tpu_torch.ops.pack import _ALPHABET, encode_alleles_nibble

    cols = (width + 1) // 2
    r = np.arange(256)[:, None]
    j = np.arange(cols)[None, :]
    every = ((r + j) % 256).astype(np.uint8), ((7 * r + 3 * j) % 256).astype(np.uint8)
    rng = np.random.default_rng(width)
    letters = np.frombuffer(_ALPHABET, np.uint8)

    def alleles(n):
        m = letters[rng.integers(0, letters.size, (n, width))]
        m[np.arange(width)[None, :] >= rng.integers(0, width + 1, n)[:, None]] = 0
        return m

    enc = encode_alleles_nibble(alleles(37), alleles(37))
    wide = tuple(rng.integers(0, 256, (5, cols + 2), dtype=np.uint8) for _ in range(2))
    one = tuple(rng.integers(0, 256, (1, cols), dtype=np.uint8) for _ in range(2))
    return [("every-byte", *every, width), ("encoded", *enc, width),
            ("extra-columns", *wide, width), ("one-row", *one, width)]


def annotate_packed_cases(width, extra_cols=0) -> tuple:
    """The packed annotate entry's inputs at ``width``: ``(pos, ref_packed,
    alt_packed, ref_len, alt_len)`` with ``ceil(width / 2) + extra_cols``
    packed columns (the extra ones random bytes, which a decode drops).
    Rows: 257 seeded rows of every variant shape (SNVs and ~5% over-width
    among them) encoded as the loader encodes them, then 256 rows whose
    packed bytes run through every value 0-255 in every column (codes 14
    and 15 included, which decode to 0) at seeded lengths of 1 to width + 3
    (some over-width, some 1 / 1), then the edge rows of
    :data:`EDGE_ROWS`.  The first ``n`` rows are a call of ``n`` rows."""
    from annotatedvdb_tpu_torch.ops.pack import encode_alleles_nibble

    cols = (width + 1) // 2
    rng = np.random.default_rng(230 + width)
    pos, ref, alt, rl, al = random_batch(width, 257, width)
    rp, ap = encode_alleles_nibble(ref, alt)
    r = np.arange(256)[:, None]
    j = np.arange(cols)[None, :]
    every = ((r + j) % 256).astype(np.uint8), ((7 * r + 3 * j) % 256).astype(np.uint8)
    lens = rng.integers(1, width + 4, (2, 256)).astype(np.int32)
    lens[:, ::9] = 1
    epos, eref, ealt, erl, eal = edge_batch(width)
    erp, eap = encode_alleles_nibble(eref, ealt)
    out = (np.concatenate([pos, rng.integers(1, 51_000_000, 256).astype(np.int32), epos]),
           np.concatenate([rp, every[0], erp]), np.concatenate([ap, every[1], eap]),
           np.concatenate([rl, lens[0], erl]), np.concatenate([al, lens[1], eal]))
    if extra_cols:
        n = out[0].shape[0]
        out = (out[0], *(np.concatenate(
            [m, rng.integers(0, 256, (n, extra_cols), dtype=np.uint8)], 1)
            for m in out[1:3]), *out[3:])
    return tuple(np.ascontiguousarray(x) for x in out)


def pack_outputs_cases() -> list:
    """The packs' edge inputs: ``(label, (h, dup, bin_level, leaf_bin,
    needs_digest, host_fallback))``, ``h`` uint32.  The edge rows: hash 0,
    0xFFFFFFFF and the sign bit; leaf bins at both int32 ends, -1, 0, 1;
    levels (and prefix lengths) of 255, 256, 300 and below 0 as int32, and
    as int8 the kernel's own type; every combination of the three flags;
    then ``dup`` None (the loader's zero lane) and random rows at n = 1, 7
    and 1,000."""
    h = np.array([0, 0xFFFFFFFF, 1, 0x80000000, 0x7FFFFFFF, 0xDEADBEEF,
                  0x01020304, 0xFEDCBA98], np.uint32)
    leaf = np.array([-2**31, 2**31 - 1, -1, 0, 1, 1234, -77, 65535], np.int32)
    level = np.array([0, 13, 255, 256, 300, -1, -256, 2**31 - 1], np.int32)
    bits = np.arange(8)
    dup, nd, hf = ((bits >> k) & 1 == 1 for k in range(3))
    rng = np.random.default_rng(22)

    def rand(n):
        return (rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32),
                rng.random(n) < 0.5, rng.integers(-2**31, 2**31, n).astype(np.int32),
                rng.integers(-2**31, 2**31, n).astype(np.int32),
                rng.random(n) < 0.3, rng.random(n) < 0.1)

    r1, r7, r1000 = rand(1), rand(7), rand(1000)
    lev8 = np.array([0, 13, 127, -128, -1, 1, 5, 12], np.int8)
    return [("edge-int32-level", (h, dup, level, leaf, nd, hf)),
            ("edge-int8-level", (h, dup, lev8, leaf, nd, hf)),
            ("edge-no-dup", (h, None, lev8, leaf, nd, hf)),
            ("random-1", r1), ("random-7", r7),
            ("random-1000-int8", r1000[:2] + (r1000[2].astype(np.int8),) + r1000[3:]),
            ("random-1000", r1000)]


def write_bucket_vcf(path, seed=62) -> None:
    """Four blocks of 600 lines whose longest alleles are at most 8, 16, 32
    and past the width of 49 (mostly SNVs, an indel of 2-4 bases every
    fifth line and of up to the block's bound every 25th), so that a
    width-bucketed load's 256-row chunks upload at every bucket."""
    rng = np.random.default_rng(seed)
    bases = "ACGT"
    pos = 1000
    with open(path, "w") as f:
        f.write(HEADER)
        for top in (8, 16, 32, 70):
            for k in range(600):
                pos += int(rng.integers(1, 9))
                ref = bases[int(rng.integers(4))]
                alt = bases[(bases.index(ref) + 1) % 4]
                if k % 5 == 0:
                    n = int(rng.integers(2, top + 1)) if k % 25 == 0 else int(rng.integers(2, 5))
                    body = "".join(bases[int(i)] for i in rng.integers(0, 4, n - 1))
                    if k % 2:
                        alt = ref + body
                    else:
                        ref, alt = ref + body, ref
                f.write(f"{1 + k % 2}\t{pos}\trs{k}\t{ref}\t{alt}\t.\t.\tRS={k}\n")


def transport_bound(kind, rows, width=WIDTH, level_bytes=1, flags=2) -> dict:
    """The least time the card could take for one call: each input byte
    read once and each output byte written once over the memory rate, or
    the integer operations over the 32-bit rate.  ``inflate_alleles``:
    two ``[rows, ceil(W / 2)]`` packed matrices in, two ``[rows, W]`` out;
    ``pack_outputs``: hash, leaf, level (``level_bytes``) and ``flags``
    flag bytes in (the loader's null ``dup`` reads nothing), 10 bytes out;
    ``pack_vep_outputs``: hash, prefix (``level_bytes``), flag in, 6 out."""
    if kind == "inflate_alleles":
        nbytes = 2 * rows * ((width + 1) // 2) + 2 * rows * width
        ops = INFLATE_BYTE_OPS * 2 * rows * width
    elif kind == "pack_outputs":
        nbytes = rows * (8 + level_bytes + flags + 10)
        ops = PACK_ROW_OPS * rows
    else:
        nbytes = rows * (4 + level_bytes + 1 + 6)
        ops = 2 * rows
    bytes_ms = nbytes / MEM_BYTES_PER_S * 1e3
    ops_ms = ops / INT32_OPS_PER_S * 1e3
    return {"rows": rows, "bytes": nbytes, "ops": ops, "bytes_ms": bytes_ms,
            "ops_ms": ops_ms, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def transport_inputs(torch, device, kind, rows, seed, width=WIDTH) -> tuple:
    """One call's inputs on ``device`` at the main path's types: seeded
    packed bytes for the inflate, the kernel's int32 hash bits, int8
    level, bool flags and no ``dup`` for the insert pack, int32 prefix
    lengths for the VEP pack."""
    rng = np.random.default_rng(seed)

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    if kind == "inflate_alleles":
        # every byte value: the codes 1-13 the encoder writes, the pad 0
        # and the 14 and 15 it never writes (the same work for the kernel)
        cols = (width + 1) // 2
        return (t(rng.integers(0, 256, (rows, cols), dtype=np.uint8)),
                t(rng.integers(0, 256, (rows, cols), dtype=np.uint8)), width)
    h = t(rng.integers(-2**31, 2**31, rows).astype(np.int32))
    fb = t(rng.random(rows) < 0.01)
    if kind == "pack_outputs":
        return (h, None, t(rng.integers(0, 14, rows).astype(np.int8)),
                t(rng.integers(0, 2**17, rows).astype(np.int32)),
                t(rng.random(rows) < 0.02), fb)
    return (h, t(rng.integers(0, 49, rows).astype(np.int32)), fb)


def transport_kernel_checks(torch, device) -> tuple:
    """The three transport entry points against their plain versions on the
    card, exactly (byte for byte): the inflate on :func:`pack_inflate_cases`
    at W = 1, 2, 7, 8, 16, 49, 96 with the packed matrices at an unaligned
    base, and the packs on :func:`pack_outputs_cases` (the VEP pack on the
    same columns); then each at 65,536 and 1,048,576 rows of
    :func:`transport_inputs`.  Returns the checks and the largest absolute
    difference of any byte."""
    from annotatedvdb_tpu_torch.ops import pack as PK

    def dev(x, offset=0):
        if x is None:
            return None
        return offset_copy(torch, np.ascontiguousarray(x), device, offset) if offset \
            else torch.from_numpy(np.ascontiguousarray(x)).to(device)

    def compare(kind, label, args):
        got = getattr(PK, kind)(*args)
        want = getattr(PK, f"{kind}_reference")(*args)
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        err = max(int((g.to(torch.int64) - w.to(torch.int64)).abs().max())
                  if g.numel() else 0 for g, w in zip(got, want))
        equal = all(torch.equal(g, w) for g, w in zip(got, want))
        checks.append({"kernel": kind, "inputs": label, "rows": int(args[0].shape[0]),
                       "max_abs_err": err, "equal": equal})
        if not equal:
            raise AssertionError(f"{kind} disagrees with its plain version on {label}")
        return err

    # the loads' 4-row probes, latched here so no later phase counts them
    PK.ensure_transport(device)
    PK.ensure_nibble(device)
    checks, worst = [], 0
    for w in (1, 2, 7, 8, 16, 49, 96):
        for label, rp, ap, width in pack_inflate_cases(w):
            for off in (0, 3):
                worst = max(worst, compare("inflate_alleles", f"{label}-w{w}-base+{off}",
                                           (dev(rp, off), dev(ap, off), width)))
    for label, (h, dup, level, leaf, nd, hf) in pack_outputs_cases():
        h = h.view(np.int32)
        worst = max(worst, compare("pack_outputs", label, tuple(
            dev(x) for x in (h, dup, level, leaf, nd, hf))))
        worst = max(worst, compare("pack_vep_outputs", label, tuple(
            dev(x) for x in (h, level, hf))))
    for kind in TRANSPORT_KERNELS:
        for rows in (CHUNK_ROWS, BIG_ROWS):
            worst = max(worst, compare(kind, f"random-{rows}",
                                       transport_inputs(torch, device, kind, rows, 7)))
    return checks, worst


def three_kernel_route(pos, ref_packed, alt_packed, ref_len, alt_len, width):
    """The card's route for a nibble-uploaded chunk before the packed
    entry: ``inflate_alleles``, ``annotate_bin``, ``pack_outputs`` (no dup
    lane), three launches: ``[n, 10]`` rows."""
    from annotatedvdb_tpu_torch.ops.annotate_cuda import annotate_bin
    from annotatedvdb_tpu_torch.ops.pack import inflate_alleles, pack_outputs

    ref, alt = inflate_alleles(ref_packed, alt_packed, width)
    out = annotate_bin(pos, ref, alt, ref_len, alt_len)
    return pack_outputs(out["allele_hash"], None, out["bin_level"], out["leaf_bin"],
                        out["needs_digest"], out["host_fallback"])


def packed_inputs(rows, seed, width=WIDTH) -> tuple:
    """``(pos, ref_packed, alt_packed, ref_len, alt_len)`` of
    :func:`random_batch` rows, nibble-packed as the loader uploads them."""
    from annotatedvdb_tpu_torch.ops.pack import encode_alleles_nibble

    pos, ref, alt, rl, al = random_batch(seed, rows, width)
    return (pos, *encode_alleles_nibble(ref, alt), rl, al)


def annotate_packed_checks(torch, device) -> tuple:
    """The packed entry on the card against the three-kernel route (every
    byte) and against its plain composition (the selection contract) on
    :func:`annotate_packed_cases` at :data:`PACKED_WIDTHS`, ``ceil(W / 2)``
    and ``ceil(W / 2) + 3`` packed columns and :data:`PACKED_ROWS` rows,
    then on 65,536 and 1,048,576 random rows at W = 49; every call at an
    unaligned base (the packed matrices 3 and 7 bytes in, the int32
    columns one element in).  Its first-use check runs first, so the
    loads' counts never see it.  Returns the checks and the largest
    absolute difference of any byte from the three-kernel route."""
    from annotatedvdb_tpu_torch.models.pipeline import annotate_packed_fn, packed_mismatches
    from annotatedvdb_tpu_torch.ops.annotate_cuda import (
        annotate_bin_packed,
        annotate_bin_packed_reference,
    )

    annotate_packed_fn(device)
    checks, worst = [], 0

    def compare(label, host, width):
        args = [offset_copy(torch, np.ascontiguousarray(x), device, off)
                for x, off in zip(host, (1, 3, 7, 1, 1))]
        got = annotate_bin_packed(*args, width)
        three = three_kernel_route(*args, width)
        want = annotate_bin_packed_reference(*args, width)
        torch.cuda.synchronize()
        err = (int((got.to(torch.int64) - three.to(torch.int64)).abs().max())
               if got.numel() else 0)
        bad = packed_mismatches(want.cpu(), got.cpu())
        checks.append({"kernel": "annotate_bin_packed", "inputs": label,
                       "rows": int(got.shape[0]), "max_abs_err": err,
                       "equal_three_kernels": err == 0, "plain_mismatched": bad,
                       "host_fallback_rows": int(((want[:, 9] & 4) != 0).sum())})
        if err or bad:
            raise AssertionError(f"annotate_bin_packed disagrees on {label}: "
                                 f"{err} from the three-kernel route, {bad} "
                                 f"against its plain composition")
        return err

    for width in PACKED_WIDTHS:
        for extra in (0, 3):
            case = annotate_packed_cases(width, extra)
            for n in PACKED_ROWS:
                worst = max(worst, compare(f"w{width}-cols+{extra}-n{n or 'all'}",
                                           [x[:n] for x in case], width))
    for rows in (CHUNK_ROWS, BIG_ROWS):
        worst = max(worst, compare(f"random-{rows}-w{WIDTH}",
                                   packed_inputs(rows, 23), WIDTH))
    return checks, worst


#: the identity entry's checks (phase 3): widths, and row counts (None:
#: every row of :func:`annotate_identity_cases`)
IDENTITY_WIDTHS = (1, 7, 49, 192, 255)
IDENTITY_ROWS = (0, 1, 127, 128, 129, 257, None)
#: the identity entry's timing shapes at W = 49: a one-row VEP identity
#: batch, 16,384 rows, the load's chunk and 1,048,576 rows, with the input
#: sets and calls a run of each
IDENTITY_TIMING = ((1, 10, 200), (16_384, 10, 200), (CHUNK_ROWS, 10, 200),
                   (BIG_ROWS, 2, 50))
#: integer operations of an identity row besides the hash's and the scan's
#: (the SNV and width tests, the row's three stores)
IDENTITY_ROW_OPS = 16


def annotate_identity_cases(width) -> tuple:
    """The identity entry's inputs at ``width``: ``(ref, alt, ref_len,
    alt_len)``.  Rows: 257 seeded rows of every variant shape (SNVs and ~5%
    over-width among them); for shared leading runs of 0-9, 15-17, 31-33,
    width - 1 and width bases (the scan's four-byte steps and its stop at
    the width): alleles that differ just past the run, one allele the run
    and the other longer (both ways), equal alleles, and both over the
    width; SNVs of equal bases; empty alleles; 32 rows whose bytes past
    their lengths, and 8 whose every byte, are random values 0-255 (hashed,
    never scanned past a length); then the edge rows of :data:`EDGE_ROWS`.
    The first ``n`` rows are a call of ``n`` rows."""
    rng = np.random.default_rng(240 + width)
    _pos, ref, alt, rl, al = random_batch(240 + width, 257, width)
    nxt = np.zeros(256, np.uint8)
    nxt[np.frombuffer(b"ACGT", np.uint8)] = np.frombuffer(b"CGTA", np.uint8)
    pairs = []
    for run in sorted({min(k, width) for k in
                       (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 15, 16, 17, 31, 32, 33,
                        width - 1, width)}):
        a = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, width + 12)]
        b = a.copy()
        b[run] = nxt[a[run]]
        pairs += [(a[:run + 1], b[:run + 1]), (a[:run], a[:run + 3]),
                  (a[:run + 3], a[:run]), (a[:run], a[:run]),
                  (a[:width + 5], b[:width + 2])]
    pairs += [(np.frombuffer(x, np.uint8), np.frombuffer(y, np.uint8))
              for x, y in ((b"A", b"A"), (b"C", b"C"), (b"", b"A"), (b"A", b""),
                           (b"", b""))]
    n = len(pairs)
    sref, salt = np.zeros((n, width), np.uint8), np.zeros((n, width), np.uint8)
    for i, (x, y) in enumerate(pairs):
        sref[i, :min(x.size, width)] = x[:width]
        salt[i, :min(y.size, width)] = y[:width]
    slen = np.array([[x.size, y.size] for x, y in pairs], np.int32).T
    col = np.arange(width)[None, :]
    _p, gref, galt, grl, gal = random_batch(250 + width, 40, width)
    noise = rng.integers(0, 256, (2, 40, width), dtype=np.uint8)
    gref = np.where(col < grl[:, None], gref, noise[0]).astype(np.uint8)
    galt = np.where(col < gal[:, None], galt, noise[1]).astype(np.uint8)
    gref[32:], galt[32:] = noise[0, 32:], noise[1, 32:]
    _e, eref, ealt, erl, eal = edge_batch(width)
    out = (np.concatenate([ref, sref, gref, eref]), np.concatenate([alt, salt, galt, ealt]),
           np.concatenate([rl, slen[0], grl, erl]), np.concatenate([al, slen[1], gal, eal]))
    return tuple(np.ascontiguousarray(x) for x in out)


def two_launch_route(pos, ref, alt, ref_len, alt_len):
    """The card's route for a VEP identity batch before the identity entry:
    ``annotate_bin``, then ``pack_vep_outputs`` of the hash, ``prefix_len``
    and ``host_fallback``: two launches, ``[n, 6]`` rows."""
    from annotatedvdb_tpu_torch.ops.annotate_cuda import annotate_bin
    from annotatedvdb_tpu_torch.ops.pack import pack_vep_outputs

    out = annotate_bin(pos, ref, alt, ref_len, alt_len)
    return pack_vep_outputs(out["allele_hash"], out["prefix_len"], out["host_fallback"])


def identity_step(pos, ref, alt, ref_len, alt_len):
    """:func:`two_launch_route`'s arguments through the identity entry (the
    position unread): one launch, ``[n, 6]`` rows."""
    from annotatedvdb_tpu_torch.ops.annotate_cuda import annotate_bin_identity

    del pos
    return annotate_bin_identity(ref, alt, ref_len, alt_len)


def annotate_identity_checks(torch, device) -> tuple:
    """The identity entry on the card against its plain composition, every
    byte of every row (the prefix byte on host_fallback rows too), and
    against the two-launch route it replaces where ``annotate_bin`` takes
    the width (W <= 192), on :func:`annotate_identity_cases` at
    :data:`IDENTITY_WIDTHS` and :data:`IDENTITY_ROWS` rows, then on 65,536
    and 1,048,576 random rows at W = 49; every call at an unaligned base
    (the allele matrices 3 and 7 bytes in, the lengths one element in), and
    its rows also written by the library's entry into an output 3 bytes
    off 16-byte alignment (byte stores).  Its first-use check runs first,
    so the loads' counts never see it.  Returns the checks and the largest
    absolute difference of any byte from the plain composition."""
    from annotatedvdb_tpu_torch.models.pipeline import (
        annotate_identity_fn,
        identity_mismatches,
    )
    from annotatedvdb_tpu_torch.ops import annotate_cuda
    from annotatedvdb_tpu_torch.ops.annotate_cuda import (
        MAX_WIDTH,
        annotate_bin_identity,
        annotate_bin_identity_reference,
    )

    annotate_identity_fn(device)
    checks, worst = [], 0

    def compare(label, host):
        args = [offset_copy(torch, np.ascontiguousarray(x), device, off)
                for x, off in zip(host, (3, 7, 1, 1))]
        n, w = args[0].shape
        got = annotate_bin_identity(*args)
        want = annotate_bin_identity_reference(*args)
        shifted = torch.zeros(n * 6 + 16, dtype=torch.uint8, device=device)[3:3 + n * 6]
        if n:
            rc = annotate_cuda._library().annotate_bin_identity_launch(
                *(a.data_ptr() for a in args), n, w, shifted.data_ptr(),
                torch.cuda.current_stream(device).cuda_stream)
            assert rc == 0, f"annotate_bin_identity_launch: cudaError {rc}"
        two = (two_launch_route(torch.zeros_like(args[2]), *args)
               if w <= MAX_WIDTH else None)
        torch.cuda.synchronize()
        err = (int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
               if got.numel() else 0)
        rec = {"kernel": "annotate_bin_identity", "inputs": label, "rows": n,
               "max_abs_err": err, "equal_plain": torch.equal(got, want),
               "plain_mismatched": identity_mismatches(want.cpu(), got.cpu()),
               "equal_unaligned_out": torch.equal(shifted.view(n, 6), got),
               "equal_two_launches": None if two is None else torch.equal(two, got),
               "host_fallback_rows": int(want[:, 5].sum())}
        checks.append(rec)
        if not (rec["equal_plain"] and rec["equal_unaligned_out"]) \
                or rec["equal_two_launches"] is False:
            raise AssertionError(f"annotate_bin_identity disagrees on {label}: {rec}")
        return err

    for width in IDENTITY_WIDTHS:
        case = annotate_identity_cases(width)
        for n in IDENTITY_ROWS:
            worst = max(worst, compare(f"w{width}-n{n if n is not None else 'all'}",
                                       [x[:n] for x in case]))
    for rows in (CHUNK_ROWS, BIG_ROWS):
        worst = max(worst, compare(f"random-{rows}-w{WIDTH}",
                                   random_batch(29, rows, WIDTH)[1:]))
    return checks, worst


def identity_bound(ref, alt, rl, al, prefix) -> dict:
    """The identity entry's bound on these host arrays: per row both allele
    rows and two int32 lengths in, a 6-byte row out, over the memory rate;
    the hash's xor and multiply per byte, the scan's compares up to where
    it stops and :data:`IDENTITY_ROW_OPS` over the 32-bit rate."""
    n, w = ref.shape
    nbytes = n * (2 * w + 8 + 6)
    snv = (rl == 1) & (al == 1)
    ops = int(2 * (2 * w + 2) * n + IDENTITY_ROW_OPS * n
              + 2 * np.where(snv, 0, np.minimum(prefix.astype(np.int64) + 1, w)).sum())
    bytes_ms = nbytes / MEM_BYTES_PER_S * 1e3
    ops_ms = ops / INT32_OPS_PER_S * 1e3
    return {"rows": n, "bytes": nbytes, "ops": ops, "bytes_ms": bytes_ms,
            "ops_ms": ops_ms, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def queued_ms(torch, fn, inputs, iters, cycles=1 << 25) -> float:
    """Device ms a call of ``fn``, its ``iters`` calls enqueued behind a
    ``torch.cuda._sleep``: the host queues every launch while the card
    sleeps, so the CUDA events time the calls back to back on the device
    (their launch gaps there included), not the host's launch rate.  The
    sleep doubles, up to six times, until the start event is still pending
    once the last call is queued; raises when it never is (``fn`` waits on
    the device)."""
    _run(fn, inputs, 2)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    for _ in range(7):
        torch.cuda._sleep(cycles)
        start.record()
        _run(fn, inputs, iters)
        stop.record()
        queued = not start.query()
        torch.cuda.synchronize()
        if queued:
            return start.elapsed_time(stop) / iters
        cycles *= 2
    raise AssertionError(f"queued_ms: {iters} calls never queued ahead of the card")


def identity_kernel_timing(torch, device) -> dict:
    """The identity entry in turns with the two-launch route it replaces
    (two, identity, identity, two), each by :func:`queued_ms` (a profile
    of this long-running process can lose events, and at one row CUDA
    events around unqueued calls time the host), at the shapes of
    :data:`IDENTITY_TIMING` (W = 49); the plain composition, which waits
    on the card and so cannot be queued, profiled once a shape (CUDA
    events a call where the profile lost events).
    Beside each: the entry's bound (:func:`identity_bound`) and share."""
    from annotatedvdb_tpu_torch.ops.annotate_cuda import annotate_bin_identity_reference

    def plain(pos, *args):
        return annotate_bin_identity_reference(*args)

    out = {}
    for rows, n_sets, iters in IDENTITY_TIMING:
        host = [random_batch(320 + i, rows, WIDTH) for i in range(n_sets)]
        sets = [[torch.from_numpy(x).to(device) for x in h] for h in host]
        runs = [{"route": name, "ms": queued_ms(torch, fn, sets, iters)}
                for name, fn in (("two", two_launch_route), ("identity", identity_step),
                                 ("identity", identity_step), ("two", two_launch_route))]
        ms = min(r["ms"] for r in runs if r["route"] == "identity")
        two_ms = min(r["ms"] for r in runs if r["route"] == "two")
        prefix = plain(*sets[0])[:, 4].cpu().numpy()
        bound = identity_bound(*host[0][1:], prefix)
        plain_iters = max(2, iters // 10)
        plain_ms = (device_ms(torch, plain, sets, plain_iters)
                    or call_ms(torch, plain, sets, plain_iters))
        out[f"annotate_bin_identity/{rows}"] = {
            **bound, "ms": ms, "plain_ms": plain_ms, "bound_share": bound["bound_ms"] / ms,
            "two_launch_ms": two_ms, "two_over_identity": two_ms / ms,
            "timed_by": "queued events", "runs": runs}
    return out


def packed_bound(torch, pos, ref_packed, alt_packed, rl, al, width=WIDTH) -> dict:
    """The packed entry's bound on these inputs (tensors, the plain
    versions run where they lie): per row the packed bytes, three int32
    scalars and a 10-byte row over the memory rate; the operations
    :func:`annotate_bound` counts, the decode's per column and the row's
    pack over the 32-bit rate."""
    from annotatedvdb_tpu_torch.ops.annotate_cuda import FIELDS, annotate_bin_reference
    from annotatedvdb_tpu_torch.ops.pack import inflate_alleles_reference

    n, cols = ref_packed.shape
    ref, alt = inflate_alleles_reference(ref_packed, alt_packed, width)
    prefix = annotate_bin_reference(pos, ref, alt, rl, al)["prefix_len"]
    host = [x.cpu().numpy() for x in (pos, ref, alt, rl, al, prefix)]
    ops = (annotate_bound(torch, FIELDS, *host[:5], host[5].astype(np.int64))["ops"]
           + INFLATE_BYTE_OPS * 2 * n * width + PACK_ROW_OPS * n)
    nbytes = n * (2 * cols + 12 + 10)
    bytes_ms = nbytes / MEM_BYTES_PER_S * 1e3
    ops_ms = ops / INT32_OPS_PER_S * 1e3
    return {"rows": n, "bytes": nbytes, "ops": ops, "bytes_ms": bytes_ms,
            "ops_ms": ops_ms, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def packed_kernel_timing(torch, device) -> dict:
    """The packed entry in turns with the three-kernel route it replaces
    (three, packed, packed, three), each profiled by kernel name, at
    65,536 rows (ten input sets) and 1,048,576 rows (two), W = 49; the
    plain composition profiled once a shape.  Beside each: the entry's
    bound (:func:`packed_bound`) and share, the route's kernels' ms and
    their sum."""
    from annotatedvdb_tpu_torch.ops.annotate_cuda import (
        annotate_bin_packed,
        annotate_bin_packed_reference,
    )

    def packed(*a):
        annotate_bin_packed(*a, WIDTH)

    def three(*a):
        three_kernel_route(*a, WIDTH)

    def plain(*a):
        annotate_bin_packed_reference(*a, WIDTH)

    route = ("inflate_kernel", "annotate_bin_kernel", "pack_outputs_kernel")
    out = {}
    for key, rows, n_sets, iters in (("chunk", CHUNK_ROWS, 10, (10, 200)),
                                     ("1m", BIG_ROWS, 2, (2, 50))):
        host = [packed_inputs(rows, 300 + i) for i in range(n_sets)]
        sets = [[torch.from_numpy(x).to(device) for x in h] for h in host]
        runs = []
        for name, fn in (("three", three), ("packed", packed), ("packed", packed),
                         ("three", three)):
            runs.append({"route": name, "device": device_profile(torch, fn, sets, iters[1]),
                         "call_ms": call_ms(torch, fn, sets, iters[1])})

        def kernel_ms(name, kernels):
            seen = [r["device"]["kernels"].get(k, {}).get("ms") for r in runs
                    if r["route"] == name and r["device"] is not None for k in kernels]
            return min(seen) if seen and all(seen) else None

        ms = kernel_ms("packed", ("annotate_bin_packed_kernel",))
        timed_by = "profiler"
        if ms is None:
            ms, timed_by = min(r["call_ms"] for r in runs if r["route"] == "packed"), "events"
        by_kernel = {k: kernel_ms("three", (k,)) for k in route}
        three_ms = (sum(by_kernel.values()) if all(by_kernel.values())
                    else min(r["call_ms"] for r in runs if r["route"] == "three"))
        bound = packed_bound(torch, *sets[0])
        plain_ms = (device_ms(torch, plain, sets, iters[0])
                    or call_ms(torch, plain, sets, iters[0]))
        out[f"annotate_bin_packed/{key}"] = {
            **bound, "ms": ms, "plain_ms": plain_ms, "bound_share": bound["bound_ms"] / ms,
            "three_kernel_ms": three_ms, "three_kernels": by_kernel,
            "three_over_packed": three_ms / ms, "timed_by": timed_by}
        out[f"packed_runs/{key}"] = runs
    return out


def transport_kernel_timing() -> dict:
    """The three transport kernels timed in a spawned process at 65,536
    rows (the load's chunk; ten input sets) and 1,048,576 rows (two sets),
    W = 49, in turns with their plain versions (plain, kernels, kernels).
    One call of ``kernels`` launches all three, so one profile a run gives
    each kernel's device ms by name; each plain version is profiled once
    (CUDA events a call where a profile lost events).  Beside each: the
    bound.  Then the annotate kernel's packed entry in turns with the
    three-kernel route it replaces (:func:`packed_kernel_timing`), its
    identity entry in turns with the two-launch route it replaces
    (:func:`identity_kernel_timing`), and the seconds the timing took
    (``seconds``).  No single PyTorch call computes any of them
    (``library_ms`` null)."""
    import torch

    from annotatedvdb_tpu_torch.ops import pack as PK
    from annotatedvdb_tpu_torch.runtime import resolve_device

    t0 = time.perf_counter()
    device = resolve_device("cuda")
    names = {"inflate_alleles": "inflate_kernel", "pack_outputs": "pack_outputs_kernel",
             "pack_vep_outputs": "pack_vep_kernel"}

    def kernels(*args):
        for kind, a in zip(TRANSPORT_KERNELS, args):
            getattr(PK, kind)(*a)

    out = {}
    for key, rows, n_sets, iters in (("chunk", CHUNK_ROWS, 10, (20, 200)),
                                     ("1m", BIG_ROWS, 2, (4, 50))):
        sets = {kind: [transport_inputs(torch, device, kind, rows, 100 + i)
                       for i in range(n_sets)] for kind in TRANSPORT_KERNELS}
        together = list(zip(*sets.values()))
        plain = {kind: device_ms(torch, getattr(PK, f"{kind}_reference"), sets[kind],
                                 iters[0])
                 or call_ms(torch, getattr(PK, f"{kind}_reference"), sets[kind], iters[0])
                 for kind in TRANSPORT_KERNELS}
        runs = [{"device": device_profile(torch, kernels, together, iters[1]),
                 "call_ms": call_ms(torch, kernels, together, iters[1])} for _ in range(2)]
        for kind in TRANSPORT_KERNELS:
            seen = [r["device"]["kernels"].get(names[kind], {}).get("ms")
                    for r in runs if r["device"] is not None]
            seen = [ms for ms in seen if ms]
            ms = min(seen) if seen else min(r["call_ms"] for r in runs)
            level_bytes = 1 if kind == "pack_outputs" else 4
            bound = transport_bound(kind, rows, level_bytes=level_bytes)
            out[f"{kind}/{key}"] = {**bound, "ms": ms, "plain_ms": plain[kind],
                                    "bound_share": bound["bound_ms"] / ms,
                                    "timed_by": "profiler" if seen else "events"}
        out[f"runs/{key}"] = runs
    out.update(packed_kernel_timing(torch, device))
    out.update(identity_kernel_timing(torch, device))
    out["seconds"] = time.perf_counter() - t0
    return out


def transport_kernel_rows(checks, timing, packed_checks, identity_checks) -> list:
    """The kernel table's rows of the three transport kernels and of the
    annotate kernel's packed and identity entries, timed at the load's
    chunk (65,536 rows; launches filled in after phases 4, 7, 8)."""
    rows = []
    for kind, replaces in TRANSPORT_KERNELS.items():
        t, big = timing[f"{kind}/chunk"], timing[f"{kind}/1m"]
        rows.append({
            "name": kind, "route": "cuda",
            "source": "annotatedvdb_tpu_torch/csrc/pack.cu", "replaces": replaces,
            "launches": None,
            "max_abs_err": max([c["max_abs_err"] for c in checks if c["kernel"] == kind]),
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None, "rows": t["rows"],
            "1m_ms": big["ms"], "1m_plain_ms": big["plain_ms"],
            "1m_bound_ms": big["bound_ms"],
        })
    t, big = timing["annotate_bin_packed/chunk"], timing["annotate_bin_packed/1m"]
    rows.append({
        "name": "annotate_bin_packed", "route": "cuda",
        "source": "annotatedvdb_tpu_torch/csrc/annotate_bin.cu",
        "replaces": "annotatedvdb_tpu/ops/annotate_pallas.py:206",
        "launches": None, "max_abs_err": max(c["max_abs_err"] for c in packed_checks),
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": None, "rows": t["rows"],
        "three_kernel_ms": t["three_kernel_ms"],
        "also_replaces": ["annotatedvdb_tpu/ops/pack.py:124", "annotatedvdb_tpu/ops/pack.py:32"],
        "1m_ms": big["ms"], "1m_plain_ms": big["plain_ms"],
        "1m_bound_ms": big["bound_ms"], "1m_three_kernel_ms": big["three_kernel_ms"],
    })
    t, big = timing[f"annotate_bin_identity/{CHUNK_ROWS}"], timing[f"annotate_bin_identity/{BIG_ROWS}"]
    one = timing["annotate_bin_identity/1"]
    rows.append({
        "name": "annotate_bin_identity", "route": "cuda",
        "source": "annotatedvdb_tpu_torch/csrc/annotate_bin.cu",
        "replaces": "annotatedvdb_tpu/ops/annotate_pallas.py:206",
        "launches": None, "max_abs_err": max(c["max_abs_err"] for c in identity_checks),
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": None, "rows": t["rows"],
        "two_launch_ms": t["two_launch_ms"], "timed_by": t["timed_by"],
        "also_replaces": ["annotatedvdb_tpu/ops/hashing.py:31",
                          "annotatedvdb_tpu/ops/pack.py:214"],
        "1m_ms": big["ms"], "1m_plain_ms": big["plain_ms"],
        "1m_bound_ms": big["bound_ms"], "1m_two_launch_ms": big["two_launch_ms"],
        "vep_batch_rows": 1, "vep_batch_ms": one["ms"], "vep_batch_bound_ms": one["bound_ms"],
        "vep_batch_two_launch_ms": one["two_launch_ms"],
    })
    return rows


@contextlib.contextmanager
def captured_loaders(cls, method="load_file"):
    """Every ``cls`` loader whose ``method`` runs inside, in call order
    (the CLIs build their loaders themselves)."""
    seen = []
    original = getattr(cls, method)

    def run(self, *args, **kwargs):
        seen.append(self)
        return original(self, *args, **kwargs)

    setattr(cls, method, run)
    try:
        yield seen
    finally:
        setattr(cls, method, original)


@contextlib.contextmanager
def captured_steps():
    """The inputs and outputs of the first annotate-kernel step (any
    entry: ``annotate_hash_pipeline_cuda``, ``annotate_bin_packed`` or
    ``annotate_bin_identity``) made inside ``lookup._device_hash`` (key
    ``"hash"``) and inside
    ``VcfLoader._load_chunk`` (key ``"insert"``), kept on the card until
    :func:`step_mismatches` reads them.  The steps themselves run
    unchanged."""
    from annotatedvdb_tpu_torch.loaders import lookup
    from annotatedvdb_tpu_torch.loaders.vcf_loader import VcfLoader
    from annotatedvdb_tpu_torch.models import pipeline
    from annotatedvdb_tpu_torch.ops import annotate_cuda

    seen, tags = {}, []

    def traced(step):
        def run(*args):
            out = step(*args)
            if tags and tags[-1] not in seen:
                seen[tags[-1]] = (args, out)
            return out
        return run

    def tagged(original, tag):
        def wrapper(*args, **kwargs):
            tags.append(tag)
            try:
                return original(*args, **kwargs)
            finally:
                tags.pop()
        return wrapper

    patches = [(pipeline, "annotate_hash_pipeline_cuda",
                traced(pipeline.annotate_hash_pipeline_cuda)),
               (annotate_cuda, "annotate_bin_packed",
                traced(annotate_cuda.annotate_bin_packed)),
               (annotate_cuda, "annotate_bin_identity",
                traced(annotate_cuda.annotate_bin_identity)),
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
    ``parity_mismatches``, the hash exact on every row; the packed entry's
    rows under ``packed_mismatches``, the identity entry's under
    ``identity_mismatches``)."""
    from annotatedvdb_tpu_torch.models.pipeline import (
        annotate_hash_pipeline,
        identity_mismatches,
        packed_mismatches,
        parity_mismatches,
    )
    from annotatedvdb_tpu_torch.ops.annotate_cuda import (
        IDENTITY_ROW,
        annotate_bin_identity_reference,
        annotate_bin_packed_reference,
    )
    from annotatedvdb_tpu_torch.types import AnnotatedBatch

    out = {}
    for tag, (args, got) in seen.items():
        host = [a.cpu() if torch.is_tensor(a) else a for a in args]
        if torch.is_tensor(got) and got.shape[1] == IDENTITY_ROW:
            bad = identity_mismatches(annotate_bin_identity_reference(*host), got.cpu())
            out[tag] = {"rows": int(got.shape[0]), "differ": bad, "entry": "identity"}
            continue
        if torch.is_tensor(got):
            bad = packed_mismatches(annotate_bin_packed_reference(*host), got.cpu())
            out[tag] = {"rows": int(got.shape[0]), "differ": bad, "entry": "packed"}
            continue
        ann, h = got
        want, want_h = annotate_hash_pipeline(*host)
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
                # the commands' run records carry their clocks and their
                # own paths: :func:`run_record_masked` compares them
                recs = [json.loads(line) for line in data.splitlines() if line.strip()]
                data = json.dumps([{k: v for k, v in r.items() if k != "ts"}
                                   for r in recs if r.get("type") != "run"]).encode()
            out[rel] = data
    return out


#: a run record's clock fields
RUN_CLOCKS = ("ts", "wall_seconds", "throughput_per_sec")


def run_record_masked(rec) -> dict:
    """A ``type: "run"`` ledger record with exactly its clocks masked:
    ``ts``, ``wall_seconds``, ``throughput_per_sec``, every stage's
    ``seconds`` and every queue-stall value."""
    out = {k: v for k, v in rec.items() if k not in RUN_CLOCKS}
    if "stages" in out:
        out["stages"] = {name: {k: (None if k == "seconds" else v)
                                for k, v in st.items()}
                         for name, st in out["stages"].items()}
    if "queue_stalls" in out:
        out["queue_stalls"] = {b: dict.fromkeys(v)
                               for b, v in out["queue_stalls"].items()}
    return out


def prom_series(path) -> dict:
    """A ``--metricsOut`` textfile as {series with its labels: value}."""
    out = {}
    with open(path) as f:
        for line in f:
            if line.strip() and not line.startswith("#"):
                key, value = line.rsplit(" ", 1)
                out[key] = float(value)
    return out


def trace_summary(path) -> dict:
    """A ``--traceOut`` Chrome trace, checked well-formed (events sorted
    by ``ts``, B/E pairs matched per thread track): its thread tracks,
    events and spans by name."""
    with open(path) as f:
        evs = json.load(f)["traceEvents"]
    ts = [e["ts"] for e in evs]
    assert ts == sorted(ts), f"{path}: events not sorted"
    open_spans, spans = {}, {}
    for e in evs:
        stack = open_spans.setdefault((e["pid"], e["tid"]), [])
        if e["ph"] == "B":
            stack.append(e["name"])
            spans[e["name"]] = spans.get(e["name"], 0) + 1
        elif e["ph"] == "E":
            assert stack and stack.pop() == e["name"], f"{path}: unmatched E"
    assert not any(open_spans.values()), f"{path}: unclosed spans"
    return {"tracks": sum(e["ph"] == "M" and e["name"] == "thread_name"
                          for e in evs),
            "events": len(evs), "spans": spans}


def profile_kernels(trace_dir) -> dict:
    """The kernel events of the one ``torch.profiler`` trace that
    ``--profile`` wrote into ``trace_dir``, by kernel name, and its CPU
    operators' threads."""
    import glob

    (path,) = glob.glob(os.path.join(trace_dir, "*.pt.trace.json"))
    with open(path) as f:
        evs = json.load(f)["traceEvents"]
    kernels = {}
    for e in evs:
        if e.get("cat") == "kernel":
            kernels[e["name"]] = kernels.get(e["name"], 0) + 1
    return {"kernels": kernels, "bytes": os.path.getsize(path),
            "cpu_op_threads": len({e["tid"] for e in evs
                                   if e.get("cat") == "cpu_op"})}


#: ``load-vcf`` through the CLI's ``main`` in a fresh interpreter (argv
#: after ``-c``): the annotate entries' own first-use checks run before
#: the counters are zeroed, as phase 3 runs them before phase 4's; the
#: capture is timed; the kernel counters are printed at the end (both
#: annotate entries' launches together)
FRESH_LOAD = """
import json, sys
import torch
from chip_smoke import timed_device_trace
from annotatedvdb_tpu_torch.cli.load_vcf import main
from annotatedvdb_tpu_torch.genome import refgenome
from annotatedvdb_tpu_torch.models.pipeline import annotate_hash_fn, annotate_packed_fn
from annotatedvdb_tpu_torch.ops import annotate_cuda, hashing
annotate_hash_fn(torch.device("cuda", 0))
annotate_packed_fn(torch.device("cuda", 0))
for name in annotate_cuda.LAUNCHES:
    annotate_cuda.LAUNCHES[name] = 0
with timed_device_trace([]) as prof_s:
    rc = main(sys.argv[1:])
print("COUNTERS " + json.dumps({
    "rc": rc, "annotate": sum(annotate_cuda.LAUNCHES.values()),
    "validate_ref": refgenome.LAUNCHES["validate_ref"],
    "plain_validate_cuda": refgenome.CALLS.get("cuda", 0),
    "plain_hash_cuda": hashing.CALLS.get("cuda", 0), "profiler_s": prof_s[0]}))
"""


def fresh_load(argv, cwd) -> dict:
    """``load-vcf argv`` on the card as a user runs it, in a fresh
    interpreter in ``cwd`` (:data:`FRESH_LOAD`; the environment is this
    process's): the counters it printed, with its wall.  A long-lived
    process's ``torch.profiler`` captures lose the GPU activity of their
    first moments (``PERF.md`` section 7), so ``--profile`` is checked
    where a user meets it."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [ROOT] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", FRESH_LOAD, *argv], cwd=cwd,
                          env=env, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("COUNTERS ")]
    assert proc.returncode == 0 and lines, (
        f"load-vcf in a fresh interpreter exited {proc.returncode}: "
        f"{proc.stderr[-2000:]}")
    return {**json.loads(lines[-1][len("COUNTERS "):]), "wall_s": wall}


def in_process_capture(torch, device, trace_dir) -> dict:
    """One ``annotate_bin`` launch inside ``device_trace`` in this
    long-lived process: the kernels its trace kept (0 when the capture
    kept no CUDA activity at all and raised), for ``PERF.md`` section 7."""
    from annotatedvdb_tpu_torch.ops.annotate_cuda import annotate_bin
    from annotatedvdb_tpu_torch.utils.profiling import device_trace

    args = [torch.from_numpy(x).to(device) for x in random_batch(1, 4096, WIDTH)]
    try:
        with device_trace(trace_dir, device):
            annotate_bin(*args)
    except RuntimeError as err:
        return {"launched": 1, "kept": 0, "error": str(err)}
    kept = profile_kernels(trace_dir)["kernels"]
    return {"launched": 1, "kept": sum(n for k, n in kept.items()
                                       if "annotate" in k)}


@contextlib.contextmanager
def timed_device_trace(sink):
    """``utils.profiling.device_trace`` timed while inside: each capture
    (a call with a directory) appends its start seconds (the profiler's start) and stop seconds (its
    stop, the CUDA-activity check and the trace's export) to ``sink``."""
    from annotatedvdb_tpu_torch.utils import profiling

    real = profiling.device_trace

    @contextlib.contextmanager
    def timed(trace_dir, device=None):
        t0 = time.perf_counter()
        with real(trace_dir, device):
            t1 = time.perf_counter()
            try:
                yield
            finally:
                t2 = time.perf_counter()
        if trace_dir:
            sink.append({"start_s": t1 - t0,
                         "stop_s": time.perf_counter() - t2})

    profiling.device_trace = timed
    try:
        yield sink
    finally:
        profiling.device_trace = real


def vcf_sites(lines) -> list:
    """(label, pos, ref, [alts]) of VCF data lines, one per position (the
    writers put one line at a position; repeated lines are copies), '.'
    alts and lines without a numeric position dropped."""
    sites = {}
    for ln in lines:
        chrom, pos, _vid, ref, alt_col = ln.split("\t", 5)[:5]
        if pos.isdigit():
            sites[int(pos)] = (chrom, ref, [a for a in alt_col.split(",") if a != "."])
    return [(c, p, r, a) for p, (c, r, a) in sorted(sites.items())]


def write_inputs(n4, n5, n6, n7, n8=(200_000, 200_000, 100_000), n7b=20_000,
                 head6=10_000, n10=500_000, genome=(CHR22_LENGTH, True),
                 n8_store=None) -> dict:
    """The seeded inputs of phases 3-8 under ``WORK``: the phase-4 VCF of
    ``n4`` lines, the phase-5 reload VCF of ``n5``, the first ``n6`` lines
    of phase 4 with a VEP file for their first half, the three update
    inputs over them, CADD tables over their span and their first
    ``head6`` lines (phase 6), ``n7`` VEP results over phase 4's variants
    (phase 7) and ``n7b`` over its first tenth (phase 7b), and the update
    inputs over phase 4's lines (its first ``n8_store`` lines, written to
    the VCF of phase 8's store, when given), ``n8`` = (QC lines, SnpEff
    lines, TSV rows) (phase 8), with what each load must count; the genome inputs of
    :func:`write_genome_inputs` at ``genome`` = (chr22's length, whether
    to write the GRCh38-shaped index) over phase 4's lines, and phase
    10's VCF: its first ``n10`` lines plus planted lines at chr22's end.
    Phase 9's tables come from :func:`write_cadd9_inputs`."""
    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    inp = {name: os.path.join(WORK, f) for name, f in (
        ("vcf4", "chr22.first.vcf"), ("vcf5", "chr22.second.vcf"),
        ("vcf6", "chr22.head.vcf"), ("vep6", "chr22.head.vep.json"),
        ("head6", "chr22.head.first.vcf"), ("vep7", "chr22.vep.json"),
        ("vep7b", "chr22.head.vep7b.json"))}
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
    inp["want7b"], inp["novel7b"] = write_vep_json(
        inp["vep7b"], lines4[: n4 // 10], n7b, seed=77, n_novel=5)
    # the update legs: phase 6's over the identities of its lines
    # (a QC pVCF over the first half), phase 8's over phase 4's lines
    t0 = time.perf_counter()
    with open(inp["vcf6"]) as f:
        lines6 = list(dict.fromkeys(ln for ln in f if not ln.startswith("#")))
    half = len(lines6) // 2
    inp["updates6"] = write_update_inputs(
        os.path.join(WORK, "chr22.head"),
        {"qc": (lines6[:half], half), "lof": (lines6, len(lines6)),
         "tsv": (lines6, n6 // 4)}, seed=60)
    lines8 = lines4
    if n8_store is not None:
        inp["vcf8"] = os.path.join(WORK, "chr22.update.vcf")
        with open(inp["vcf4"]) as src, open(inp["vcf8"], "w") as dst:
            dst.write(HEADER)
            data = (ln for ln in src if not ln.startswith("#"))
            dst.writelines(next(data) for _ in range(n8_store))
        with open(inp["vcf8"]) as f:
            lines8 = list(dict.fromkeys(ln for ln in f if not ln.startswith("#")))
    inp["updates8"] = write_update_inputs(
        os.path.join(WORK, "chr22"),
        {name: (lines8, n) for name, n in zip(("qc", "lof", "tsv"), n8)},
        seed=80)
    inp["update_seconds"] = time.perf_counter() - t0
    # the CADD tables: phase 6's over its lines' span, phase 9's over
    # span9 for the store of phases 4 and 5 (BGZF, level 1 for the big one)
    t0 = time.perf_counter()
    with open(inp["head6"], "w") as f:
        f.write(HEADER)
        f.writelines(lines6[:head6])
    sites6 = vcf_sites(lines6)
    inp["cadd6"] = {"db": os.path.join(WORK, "cadd6"), "head_lines": head6,
                    "pred": write_cadd_tables(
                        os.path.join(WORK, "cadd6"), sites6,
                        {"22": (sites6[0][1], sites6[-1][1])}, seed=61)}
    pred6 = inp["cadd6"]["pred"]
    # every block's window holds rows of the base lines, so the rows the
    # update commands insert before the join cannot add a launch
    assert pred6["launches"] == pred6["blocks"], pred6["launches"]
    inp["cadd6_seconds"] = time.perf_counter() - t0
    inp["dup4"] = int(rows4[dup_lines].sum())
    inp["ins4"] = int(rows4.sum())
    # the reference genome over phase 4's sites, and phase 10's VCF
    t0 = time.perf_counter()
    inp["genome"] = write_genome_inputs(WORK, lines4, length=genome[0],
                                        grch38=genome[1])
    inp["vcf10"], inp["want10"] = write_phase10_vcf(
        os.path.join(WORK, "chr22.refgenome.vcf"), inp["vcf4"], n10,
        inp["genome"]["text"])
    inp["genome_seconds"] = time.perf_counter() - t0
    inp.update(n4=n4, n5=n5, n6=n6, n7=n7, n8=n8, n7b=n7b, n10=n10)
    return inp


def write_phase10_vcf(path, vcf4, n_lines, text) -> tuple:
    """Phase 10's VCF: the first ``n_lines`` lines of the phase-4 file
    (its repeated lines and malformed line included) plus lines at the end
    of chr22's ``text``: the last three bases, a deletion across the end,
    a base past it, and a matching and a mismatching over-width ref
    ending at the last base.  Returns the path and (rows inserted into a
    fresh store, rows whose ref mismatches the genome) by
    :func:`ref_mismatches`."""
    n = text.size
    tail = text[n - 60:].tobytes().decode()
    wrong = ("C" if tail[0] != "C" else "G") + tail[1:]
    planted = [f"22\t{n - 59}\t.\t{tail}\t{tail[0]}\t.\t.\t.\n",
               f"22\t{n - 59}\t.\t{wrong}\tT\t.\t.\t.\n",
               f"22\t{n - 2}\t.\t{tail[-3:]}\t{tail[-3]}\t.\t.\t.\n",
               f"22\t{n - 1}\t.\t{tail[-2:]}A\t{tail[-2]}\t.\t.\t.\n",
               f"22\t{n + 1}\t.\tA\tC\t.\t.\t.\n"]
    with open(vcf4) as src, open(path, "w") as dst:
        dst.write(HEADER)
        data = (ln for ln in src if not ln.startswith("#"))
        lines = [ln for _, ln in zip(range(n_lines), data)]
        dst.writelines(lines + planted)
    return path, ref_mismatches(text, lines + planted)


#: phase 9's table span on chr22 (3 Mbp: the writer, run beside phase 6,
#: then ends before phase 6 does)
CADD9_SPAN = (16_000_001, 19_000_000)


def write_cadd9_inputs(work, vcfs, span=CADD9_SPAN) -> dict:
    """Phase 9's CADD tables (BGZF, level 1) under ``work/cadd9`` over
    ``span`` of chr22, for the store the VCF files ``vcfs`` load (phases 4
    and 5): the database directory, the span, the generator's predictions
    and the seconds it took.  Reads only the VCFs, so it can run in
    another process while the earlier phases do."""
    t0 = time.perf_counter()
    lines = []
    for path in vcfs:
        with open(path) as f:
            lines += [ln for ln in f if not ln.startswith("#")]
    db = os.path.join(work, "cadd9")
    pred = write_cadd_tables(db, vcf_sites(lines), {"22": span}, seed=90, level=1)
    return {"db": db, "span": span, "pred": pred,
            "seconds": time.perf_counter() - t0}


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
             "AVDB_INGEST_SHUFFLE_SEED", "AVDB_NATIVE_VEP", "AVDB_NATIVE_CADD",
             "AVDB_PACK_TRANSPORT")


class Launches(collections.abc.MutableMapping):
    """The launch counters of several kernel modules (each module's
    ``LAUNCHES`` dict) as one mapping: reading, setting to 0 and copying
    it reach the modules' own counters."""

    def __init__(self, *counters):
        self._counters = counters

    def _owner(self, name):
        for counts in self._counters:
            if name in counts:
                return counts
        raise KeyError(name)

    def __getitem__(self, name):
        return self._owner(name)[name]

    def __setitem__(self, name, value):
        self._owner(name)[name] = value

    def __delitem__(self, name):
        raise TypeError("launch counters are not removed")

    def __iter__(self):
        for counts in self._counters:
            yield from counts

    def __len__(self):
        return sum(len(c) for c in self._counters)


def load_phases(torch, platform, inp, launches, hash_calls,
                before_parity=None) -> dict:
    """Phases 4-6 on ``platform`` ("cuda" on the card; "cpu" rehearses the
    same control flow at a small size) over the inputs of
    :func:`write_inputs`.  ``launches`` (the kernel launch counters) and
    ``hash_calls`` (the plain hash's calls by device type) are set to 0
    just before the phase-4 load and read right after it.
    ``before_parity``, if given, is called once phases 4 and 5 (the timed
    ones) are done, before phase 6.  Raises AssertionError on any failed
    check."""
    from annotatedvdb_tpu_torch.cli.load_vcf import main as load_vcf
    from annotatedvdb_tpu_torch.cli.load_vep import main as load_vep
    from annotatedvdb_tpu_torch.conseq.ranker import DEFAULT_RANKING_FILE
    from annotatedvdb_tpu_torch.genome import refgenome
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

    def load(store_dir, trace=False, obs=()):
        """The CLI load of ``vcf4`` into ``store_dir`` (``obs``: more
        flags): (wall s, loader, native chunks, mapping sidecar bytes,
        device-busy s).  With ``trace`` on the card, ``torch.profiler``
        records the device's activity (kernels and copies) and the busy
        seconds are its sum (None when not traced or when it saw no device
        time)."""
        from torch.profiler import ProfilerActivity, profile

        traced = trace and device.type == "cuda"
        t0 = time.perf_counter()
        with (profile(activities=[ProfilerActivity.CUDA]) if traced
              else contextlib.nullcontext()) as prof, \
                captured_loaders(VcfLoader) as loaders, \
                timed_calls(native_vcf, "chunk_from_native", []) as native_chunks:
            rc = load_vcf(["--fileName", vcf4, "--storeDir", store_dir,
                           "--commit", "--logAfter", "0", "--platform", platform,
                           *obs])
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
    obs4 = os.path.join(WORK, "load4")
    wall, loader, native_chunks, mapping4, busy = load(
        store4, trace=True, obs=("--metricsOut", obs4 + ".prom",
                                 "--traceOut", obs4 + ".trace.json"))
    launched, hashed = dict(launches), dict(hash_calls)
    stages = dict(loader.timer.seconds)
    counters = ledger_records(store4, "finish")[-1]["counters"]
    chunks = len(ledger_records(store4, "checkpoint"))
    # the load's telemetry: its run record, textfile and host trace
    (run4,) = ledger_records(store4, "run")
    series4 = prom_series(obs4 + ".prom")
    trace4 = trace_summary(obs4 + ".trace.json")
    emit("load_obs", run_counters=run4["counters"], loader_counters=counters,
         run_status=run4["status"], run_wall_s=run4["wall_seconds"],
         variant_total=series4.get('avdb_load_variant_total{loader="load-vcf"}'),
         chunks_total=series4.get('avdb_chunks_total{loader="load-vcf"}'),
         series=len(series4), trace_tracks=trace4["tracks"],
         trace_events=trace4["events"], trace_spans=trace4["spans"],
         lines_per_s=counters["line"] / wall)
    assert run4["status"] == "completed" and all(
        run4["counters"].get(k) == v for k, v in counters.items()), (
        f"load: run record counters {run4['counters']}, loader's {counters}")
    assert series4.get('avdb_load_variant_total{loader="load-vcf"}') \
        == counters["variant"], "load: the textfile's variant total"
    assert trace4["tracks"] >= 4 and trace4["spans"].get("annotate") == chunks, (
        f"load: trace tracks {trace4['tracks']}, spans {trace4['spans']}")
    emit("load", lines=counters["line"], variants=counters["variant"],
         duplicates=counters["duplicates"], skipped=counters["skipped"],
         malformed=counters.get("malformed"), chunks=chunks,
         native_chunks=native_chunks, wall_s=wall,
         loader_wall_s=loader.timer.wall_seconds,
         lines_per_s=counters["line"] / wall,
         variants_per_s=counters["variant"] / wall, launches=launched,
         plain_hash_calls=hashed, dispatch_s=stages.get("dispatch"),
         annotate_s=stages.get("annotate"), stage_seconds=stages,
         warmup_s=loader.warmup_seconds, transport=loader.transport,
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
    if device.type == "cuda":
        # the default on the card packs every chunk: one launch of the
        # packed entry a chunk that went up nibble-packed, plus the
        # warmup's one at the chunk shape; a raw chunk would take
        # annotate_bin and one pack; no inflate (its probes ran in phase 3)
        t = loader.transport
        assert t["packed"] == chunks and t["nibble"] + t["raw"] == chunks, (
            f"load: transport {t} for {chunks} chunks")
        split = {name: launched[name] for name in (
            "annotate_bin_packed", "annotate_bin", "inflate_alleles", "pack_outputs")}
        assert split == {"annotate_bin_packed": t["nibble"] + WARMUP_PACKED,
                         "annotate_bin": t["raw"], "inflate_alleles": 0,
                         "pack_outputs": t["raw"]}, (
            f"load: launches {split} for {t['nibble']} nibble and {t['raw']} "
            f"raw uploads of {chunks} chunks (and the warmup's)")

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

    # 4c. the transport's A/B on the first 500,000 lines
    transport_ab(platform, vcf4, inp.get("ab_lines", AB_LINES))

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
    if before_parity is not None:
        before_parity()

    # 6. device vs CPU, end to end: the VCF load, then the VEP update of
    # its store (ranking file re-ranked on load, saved on each learned
    # combo); with the Python tokenizer, the serial executor and the Python
    # VEP transform, then in the default configuration
    want6 = inp["want6"]
    for config, env in (("python-serial", {"AVDB_INGEST_ENGINE": "python",
                                           "AVDB_PIPELINE": "serial",
                                           "AVDB_NATIVE_VEP": "0",
                                           "AVDB_NATIVE_CADD": "0"}),
                        ("default", {})):
        out, cadd, schema, loads6 = {}, {}, {}, {}
        for plat in (platform, "cpu"):
            # the store is ``store`` under a directory of its own, loaded
            # by that relative name from there: the run records of the
            # card's and the CPU's loads name the same store
            top = os.path.join(WORK, f"p6.{config}.{len(out)}.{plat}")
            d = os.path.join(top, "store")
            ranks = os.path.join(WORK, f"ranks.{config}.{len(out)}.{plat}")
            os.makedirs(ranks)
            shutil.copy(DEFAULT_RANKING_FILE, os.path.join(ranks, "ranks.txt"))
            t0 = time.perf_counter()
            before = (annotate_launches(launches), refgenome.LAUNCHES["validate_ref"],
                      refgenome.CALLS.get("cuda", 0), hash_calls.get("cuda", 0))
            os.makedirs(top)
            # --profile on every CPU load and, on the card, on the default
            # configuration's load, run in a fresh interpreter as a user
            # runs the CLI: a capture in this long-lived process loses its
            # first moments' GPU activity (in_process_capture shows it)
            in_fresh = plat == "cuda" and config == "default"
            profiled = plat == "cpu" or in_fresh
            argv6 = ["--fileName", vcf6, "--storeDir", "store", "--commit",
                     "--logAfter", "0", "--platform", plat,
                     "--refGenome", inp["genome"]["index"],
                     "--metricsOut", os.path.join(top, "load.prom"),
                     "--traceOut", os.path.join(top, "load.json"),
                     *(["--profile", os.path.join(top, "prof")] if profiled else [])]
            if in_fresh:
                with environment(**env):
                    fresh = fresh_load(argv6, top)
                prof_s = [fresh["profiler_s"]]
                capture = in_process_capture(torch, device,
                                             os.path.join(top, "in_process"))
                after = (before[0] + fresh["annotate"],
                         before[1] + fresh["validate_ref"],
                         before[2] + fresh["plain_validate_cuda"],
                         before[3] + fresh["plain_hash_cuda"])
            else:
                cwd = os.getcwd()
                os.chdir(top)
                try:
                    with environment(**env), timed_device_trace([None]) as prof_s:
                        rc = load_vcf(argv6)
                finally:
                    os.chdir(cwd)
                assert rc == 0, f"phase 6 ({config}) load on {plat} exited {rc}"
                after = (annotate_launches(launches), refgenome.LAUNCHES["validate_ref"],
                         refgenome.CALLS.get("cuda", 0), hash_calls.get("cuda", 0))
            load6 = {"files": store_bytes(d), "chunks": len(ledger_records(d, "checkpoint")),
                     "inserting_chunks": inserting_chunks(d, 1),
                     "annotate_launches": after[0] - before[0],
                     "validate_launches": after[1] - before[1],
                     "plain_cuda": {"validate_ref": after[2] - before[2],
                                    "allele_hash": after[3] - before[3]},
                     "ref_mismatch": ledger_records(d, "finish")[-1]["counters"].get(
                         "ref_mismatch", 0),
                     "run": run_record_masked(ledger_records(d, "run")[-1]),
                     "profile": profile_kernels(os.path.join(top, "prof"))
                     if profiled else None,
                     "profiler_s": prof_s[-1],
                     "trace": trace_summary(os.path.join(top, "load.json")),
                     "variant_total": prom_series(os.path.join(top, "load.prom"))
                     ['avdb_load_variant_total{loader="load-vcf"}']}
            if plat == "cuda":
                # an annotate entry a chunk and the warmup's packed one
                assert (load6["annotate_launches"], load6["validate_launches"]) == (
                    load6["chunks"] + WARMUP_PACKED, load6["inserting_chunks"]), (
                    f"phase 6 ({config}) --refGenome load: {load6['annotate_launches']} "
                    f"annotate / {load6['validate_launches']} validate_ref launches "
                    f"for {load6['chunks']} chunks, {load6['inserting_chunks']} inserting")
                assert not any(load6["plain_cuda"].values()), (
                    f"phase 6 ({config}): plain versions on the card: {load6['plain_cuda']}")
            if plat == "cuda" and profiled:
                # the capture starts after the warmup
                traced = sum(n for k, n in load6["profile"]["kernels"].items()
                             if "annotate" in k)
                assert traced == load6["annotate_launches"] - WARMUP_PACKED, (
                    f"phase 6 ({config}): --profile's trace holds {traced} "
                    f"annotate kernels for {load6['annotate_launches']} "
                    f"launches less the warmup's ({load6['profile']['kernels']})")
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
                before = annotate_launches(launches)
                with environment(**env):
                    run = run_update(torch, plat, name, spec["path"], d)
                got = {k: run["counters"].get(k, 0) for k in spec["want"]}
                assert got == spec["want"], (
                    f"phase 6 ({config}) {name} on {plat}: {got}, predicted "
                    f"{spec['want']}")
                want_l = update_launches_predicted(name, run, config == "default")
                n_launched = annotate_launches(launches) - before
                if plat == "cuda":
                    assert n_launched == want_l, (
                        f"phase 6 ({config}) {name}: the annotate entries launched "
                        f"{n_launched} times, predicted {want_l}")
                updates[name] = {"files": store_bytes(d), "launches": n_launched,
                                 "chunks": run["chunks"], "s": run["wall"],
                                 "alg_id": run["counters"]["alg_id"]}
            # then the CADD join, the export and the undo of the QC update
            with environment(**env):
                cadd[len(cadd)] = cadd_steps(torch, plat, d, inp, config,
                                             updates["qc"]["alg_id"], bool(out))
            # then the Postgres egress of the store
            schema[len(schema)] = run_install_schema(
                torch, plat, d, os.path.join(WORK, f"pg.{config}.{plat}"))
            loads6[len(loads6)] = load6
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
        check_cadd_parity(cadd[0], cadd[1], config, inp["cadd6"], platform)
        emit("parity_obs", config=config,
             in_process_capture=capture if platform == "cuda" and
             config == "default" else None,
             fresh_load_s=fresh["wall_s"] if platform == "cuda" and
             config == "default" else None,
             runs_equal=loads6[0]["run"] == loads6[1]["run"],
             run_counters=loads6[0]["run"]["counters"],
             profiles=[ld["profile"] for ld in loads6.values()],
             annotate_launches=loads6[0]["annotate_launches"],
             profiler_s=[ld["profiler_s"] for ld in loads6.values()],
             trace_tracks=[ld["trace"]["tracks"] for ld in loads6.values()],
             variant_totals=[ld["variant_total"] for ld in loads6.values()])
        assert loads6[0]["run"] == loads6[1]["run"], (
            f"phase 6 ({config}): the card's and the CPU's run records "
            f"differ: {loads6[0]['run']} / {loads6[1]['run']}")
        for ld in loads6.values():
            for k in ("run", "profile", "profiler_s", "trace", "variant_total"):
                ld.pop(k)
        check_refgenome_parity(loads6, schema, config, platform)
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
    display_spill_parity(platform, inp)
    chaos = chaos_load_check(platform, vcf6, launches)
    return {"launches": launched, "chaos": chaos, "plain_hash_calls": hashed, "chunks": chunks,
            "store": store4,
            "store6": os.path.join(WORK, f"p6.default.0.{platform}", "store"),
            "vep": inp["vep7"], "want": inp["want7"],
            "novel": inp["novel7"], "vep_seconds": inp["vep_seconds"],
            "vep7b": inp["vep7b"], "want7b": inp["want7b"],
            "novel7b": inp["novel7b"]}


def display_spill_parity(platform, inp) -> dict:
    """Phase 6's last legs, card against CPU: the phase-6 lines loaded with
    ``store_display_attributes=True`` (every annotate field copied back,
    the ``display_attributes`` sidecar stored) on each device; then the
    card's store copied twice and, under ``AVDB_STORE_SPILL_BYTES=1``
    (every segment a copy-on-write memmap) and ``AVDB_DEVICE_LOOKUP=
    always``, the same lines reloaded into each copy (every row a
    duplicate, found by the device probe, whose uploads come from the
    memmaps) and the phase-6 VEP results applied (``load-vep``, in place
    on the mapped columns), once on each device.  Both pairs of stores
    must be byte-equal."""
    from annotatedvdb_tpu_torch.cli.load_vep import main as load_vep
    from annotatedvdb_tpu_torch.loaders import VcfLoader
    from annotatedvdb_tpu_torch.store import AlgorithmLedger, VariantStore

    t0 = time.perf_counter()
    display, transport = {}, {}
    for k, plat in enumerate((platform, "cpu")):
        d = os.path.join(WORK, f"p6.display.{k}.{plat}")
        os.makedirs(d)
        store = VariantStore(width=WIDTH)
        loader = VcfLoader(store, AlgorithmLedger(os.path.join(d, "ledger.jsonl")),
                           log=lambda *a: None, device=plat,
                           store_display_attributes=True)
        try:
            loader.warmup()
            loader.load_file(inp["vcf6"], commit=True, persist=lambda: store.save(d))
        finally:
            loader.close()
        store.save(d)
        display[k], transport[plat] = store_bytes(d), loader.transport
    shown = sum(blob.count(b'"display_attributes"') for name, blob in
                display[0].items() if name.endswith(".ann.jsonl"))
    differ_display = sorted(k for k in set(display[0]) | set(display[1])
                            if display[0].get(k) != display[1].get(k))
    spill, mapped, probes = {}, {}, {}
    src = os.path.join(WORK, f"p6.display.0.{platform}")
    for k, plat in enumerate((platform, "cpu")):
        d = f"{src}.spill.{k}.{plat}"
        shutil.copytree(src, d)
        with environment(AVDB_STORE_SPILL_BYTES="1", AVDB_DEVICE_LOOKUP="always"):
            store = VariantStore.load(d)
            mapped[k] = all(isinstance(seg.cols["pos"], np.memmap)
                            for sh in store.shards.values() for seg in sh.segments)
            loader = VcfLoader(store, AlgorithmLedger(os.path.join(d, "ledger.jsonl")),
                               log=lambda *a: None, device=plat)
            try:
                counters = loader.load_file(inp["vcf6"], commit=True,
                                            persist=lambda: store.save(d))
            finally:
                loader.close()
            store.save(d)
            probes[k] = (dict(loader.probe_stats), counters["variant"],
                         counters["duplicates"])
            rc = load_vep(["--fileName", inp["vep6"], "--storeDir", d, "--commit",
                           "--logAfter", "0", "--datasource", "dbSNP",
                           "--platform", plat])
            assert rc == 0, f"phase 6 spill: load-vep on {plat} exited {rc}"
        spill[k] = store_bytes(d)
    differ_spill = sorted(k for k in set(spill[0]) | set(spill[1])
                          if spill[0].get(k) != spill[1].get(k))
    out = {"display_rows": shown, "display_files": len(display[0]),
           "differ_display": differ_display, "transport": transport,
           "spill_mapped": mapped, "spill_probes": probes,
           "differ_spill": differ_spill, "seconds": time.perf_counter() - t0}
    emit("parity_display_spill", **out)
    assert shown > 0 and not differ_display, (
        f"phase 6 display attributes: {shown} rows, stores differ in {differ_display}")
    assert all(mapped.values()) and not differ_spill, (
        f"phase 6 spill: mapped {mapped}, stores differ in {differ_spill}")
    for k, (stats, variants, dups) in probes.items():
        assert variants == 0 and dups > 0 and stats.get("device") \
            and not stats.get("host"), f"phase 6 spill reload {k}: {probes[k]}"
    return out


#: phase 4c's lines (the head of the phase-4 VCF) and its turns
AB_LINES = 500_000
AB_MODES = ("auto", "never", "never", "auto")


def transport_ab(platform, vcf, n_lines) -> list:
    """Phase 4c: the first ``n_lines`` lines of ``vcf`` through
    ``load-vcf --commit`` into fresh stores, in turns under
    ``AVDB_PACK_TRANSPORT`` ``auto`` (on the card: nibble uploads, one
    inflate and one pack a chunk, one copy back), ``never`` (raw uploads,
    width-bucketed where a chunk allows, four column copies), ``never``,
    ``auto``.  Emits each run's wall, warmup, stage seconds
    (``dispatch``, ``annotate``) and transport counts; all four stores and
    mapping sidecars must be byte-equal."""
    from annotatedvdb_tpu_torch.cli.load_vcf import main as load_vcf
    from annotatedvdb_tpu_torch.loaders import VcfLoader

    head = os.path.join(WORK, "ab.vcf")
    with open(vcf) as src, open(head, "w") as dst:
        n = 0
        for line in src:
            if not line.startswith("#"):
                if n == n_lines:
                    break
                n += 1
            dst.write(line)
    runs, files, mappings = [], [], []
    for k, mode in enumerate(AB_MODES):
        d = os.path.join(WORK, f"ab.{k}.{mode}")
        with environment(AVDB_PACK_TRANSPORT=mode), \
                captured_loaders(VcfLoader) as seen:
            t0 = time.perf_counter()
            rc = load_vcf(["--fileName", head, "--storeDir", d, "--commit",
                           "--logAfter", "0", "--platform", platform])
            wall = time.perf_counter() - t0
        assert rc == 0, f"transport A/B ({mode}) load-vcf exited {rc}"
        loader = seen[0]
        stages = dict(loader.timer.seconds)
        runs.append({"mode": mode, "wall_s": wall, "warmup_s": loader.warmup_seconds,
                     "loader_wall_s": loader.timer.wall_seconds,
                     "lines_per_s": n / wall, "dispatch_s": stages.get("dispatch"),
                     "annotate_s": stages.get("annotate"), "stage_seconds": stages,
                     "transport": loader.transport, "queue_stalls": loader.queue_stalls,
                     "device_idle_fraction": loader.device_idle_fraction})
        files.append(store_bytes(d))
        with open(head + ".mapping", "rb") as f:
            mappings.append(f.read())
        shutil.rmtree(d)
    os.remove(head)
    os.remove(head + ".mapping")
    differ = sorted({k for f in files[1:] for k in set(files[0]) | set(f)
                     if files[0].get(k) != f.get(k)})
    emit("transport_ab", lines=n, runs=runs, differ=differ)
    assert not differ, f"transport A/B: the stores differ in {differ}"
    assert all(m == mappings[0] for m in mappings), "the mapping sidecars differ"
    for run in runs:
        packs = platform == "cuda" and run["mode"] == "auto"
        assert (run["transport"]["packed"] > 0) == packs \
            and (run["transport"]["fields"] > 0) != packs, (
            f"transport A/B ({run['mode']}): {run['transport']}")
    return runs


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


def run_load_cadd(torch, platform, store_dir, db, *flags, trace=False) -> dict:
    """``load-cadd --databaseDir db --storeDir store_dir *flags`` through
    the CLI's ``main`` (log beside the work files, not in the store): its
    wall, updater, printed counters, the store's load and save seconds,
    the ``cadd_join`` launches and plain-join calls it made, and with
    ``trace`` on the card the device-busy seconds (``torch.profiler``;
    None when it saw no device time)."""
    import io

    from torch.profiler import ProfilerActivity, profile

    from annotatedvdb_tpu_torch.__main__ import main as cli
    from annotatedvdb_tpu_torch.loaders import CaddUpdater
    from annotatedvdb_tpu_torch.ops import cadd_join
    from annotatedvdb_tpu_torch.store import VariantStore

    traced = trace and platform == "cuda"
    launches, calls = cadd_join.LAUNCHES["cadd_join"], dict(cadd_join.CALLS)
    out = io.StringIO()
    t0 = time.perf_counter()
    with (profile(activities=[ProfilerActivity.CUDA]) if traced
          else contextlib.nullcontext()) as prof, \
            captured_loaders(CaddUpdater, "update_all") as updaters, \
            timed_calls(VariantStore, "load", []) as load_s, \
            timed_calls(VariantStore, "save", []) as save_s, \
            contextlib.redirect_stdout(out):
        rc = cli(["load-cadd", "--databaseDir", db, "--storeDir", store_dir,
                  "--logAfter", "0", "--logFilePath",
                  os.path.join(WORK, "load-cadd.log"), "--platform", platform,
                  *flags])
        if platform == "cuda":
            torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    assert rc == 0, f"load-cadd {' '.join(flags)} exited {rc}"
    printed = out.getvalue().splitlines()
    busy = None
    if traced:
        busy = sum(getattr(e, "self_device_time_total", 0.0)
                   for e in prof.key_averages()) / 1e6 or None
    res = {"wall": wall, "store_load_s": sum(load_s), "store_save_s": sum(save_s),
           "launches": cadd_join.LAUNCHES["cadd_join"] - launches,
           "plain_calls": {k: v - calls.get(k, 0)
                           for k, v in cadd_join.CALLS.items()}, "busy": busy}
    if "--buildIndex" not in flags:
        res["counters"] = json.loads(printed[-2])
        assert int(printed[-1]) == res["counters"]["alg_id"]
        (res["updater"],) = updaters
    return res


def run_host_command(argv) -> tuple:
    """A host-only command (``export-vcf``, ``undo``) through the umbrella
    CLI: (wall seconds, printed lines)."""
    import io

    from annotatedvdb_tpu_torch.__main__ import main as cli

    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(out):
        rc = cli(argv)
    assert rc == 0, f"{argv[0]} exited {rc}"
    return time.perf_counter() - t0, out.getvalue().splitlines()


def inserting_chunks(store_dir, alg_id) -> int:
    """Checkpointed chunks of run ``alg_id`` whose ``variant`` count grew:
    the chunks that inserted rows (one ``validate_ref`` launch each on the
    card with a genome)."""
    after = [r["counters"] for r in ledger_records(store_dir, "checkpoint")
             if r["alg_id"] == alg_id]
    return sum(b.get("variant", 0) > a.get("variant", 0)
               for a, b in zip([{}] + after, after))


def run_install_schema(torch, platform, store_dir, out_dir) -> dict:
    """``install-schema --storeDir`` of ``store_dir`` into ``out_dir``
    through the umbrella CLI: wall, printed lines, the output tree, the
    store's rows per shard, the ``annotate_bin`` launches it made and the
    plain-hash calls on the card."""
    from annotatedvdb_tpu_torch.ops import annotate_cuda, hashing
    from annotatedvdb_tpu_torch.store import VariantStore

    rows = {code: sh.n for code, sh in VariantStore.load(store_dir).shards.items()}
    launches = annotate_cuda.LAUNCHES["annotate_bin"]
    plain = hashing.CALLS.get("cuda", 0)
    wall, printed = run_host_command(["install-schema", "--outputDir", out_dir,
                                      "--storeDir", store_dir, "--platform", platform])
    if platform == "cuda":
        torch.cuda.synchronize()
    return {"s": wall, "printed": [ln.replace(out_dir, "<out>") for ln in printed],
            "tree": tree_bytes(out_dir),
            "rows": rows, "launches": annotate_cuda.LAUNCHES["annotate_bin"] - launches,
            "plain_cuda": hashing.CALLS.get("cuda", 0) - plain}


def egress_windows(rows) -> int:
    """``annotate_bin`` launches of an egress whose rows all lack stored
    display attributes: one per 65,536-row window of each shard."""
    return sum(-(-n // CHUNK_ROWS) for n in rows.values())


def check_refgenome_parity(loads, schema, config, platform) -> None:
    """Phase 6's ``--refGenome`` load and ``install-schema``, card against
    CPU: the stores (ledger records included) identical after the load,
    the output trees identical; on the card ``annotate_bin`` launched once
    per egress window and no plain hash.  Emits ``parity_refgenome``;
    raises AssertionError on any failed check."""
    dev, cpu = loads[0], loads[1]
    a, b = dev.pop("files"), cpu.pop("files")
    load_differ = sorted(k for k in set(a) | set(b) if a.get(k) != b.get(k))
    ta, tb = schema[0].pop("tree"), schema[1].pop("tree")
    tree_differ = sorted(k for k in set(ta) | set(tb) if ta.get(k) != tb.get(k))
    want = egress_windows(schema[0]["rows"])
    emit("parity_refgenome", config=config, load=dev, load_cpu=cpu,
         load_differ=load_differ, schema_files=len(ta), schema_differ=tree_differ,
         schema_s=schema[0]["s"], schema_cpu_s=schema[1]["s"],
         schema_launches=schema[0]["launches"], predicted_schema_launches=want,
         printed=schema[0]["printed"][-1:])
    assert not load_differ, (
        f"phase 6 ({config}): card and CPU --refGenome stores differ in {load_differ}")
    assert not tree_differ and ta, (
        f"phase 6 ({config}): card and CPU install-schema trees differ in {tree_differ}")
    assert schema[0]["printed"] == schema[1]["printed"], (
        f"phase 6 ({config}): install-schema printed {schema[0]['printed']} "
        f"on the card, {schema[1]['printed']} on the CPU")
    assert dev["ref_mismatch"] == cpu["ref_mismatch"] > 0, (
        f"phase 6 ({config}): ref_mismatch {dev['ref_mismatch']} on the card, "
        f"{cpu['ref_mismatch']} on the CPU")
    if platform == "cuda":
        assert schema[0]["launches"] == want, (
            f"phase 6 ({config}): install-schema launched annotate_bin "
            f"{schema[0]['launches']} times, predicted {want}")
        assert schema[0]["plain_cuda"] == 0, (
            f"phase 6 ({config}): install-schema called the plain hash on the card")


def tree_bytes(root) -> dict:
    """Every file under ``root``, by relative path."""
    out = {}
    for dirpath, _dirs, files in os.walk(root):
        for name in files:
            fp = os.path.join(dirpath, name)
            with open(fp, "rb") as f:
                out[os.path.relpath(fp, root)] = f.read()
    return out


def cadd_steps(torch, plat, d, inp, config, qc_alg, index_built) -> dict:
    """Phase 6's CADD and store-command steps on store ``d``: ``load-cadd
    --commit`` over both tables, ``--buildIndex`` (once per configuration:
    it reads only the tables), ``load-cadd --fileName`` of the first lines
    with ``--updateExisting`` (indexed seeks), ``export-vcf`` and ``undo``
    of the QC update.  Per step: the store's bytes, the ``cadd_join`` and
    annotate-entry launches and the plain-join calls on the card; the
    export's files."""
    from annotatedvdb_tpu_torch.ops import annotate_cuda

    db = inp["cadd6"]["db"]
    out = {}

    def record(step, run=None, annotate_before=None, **extra):
        rec = {"files": store_bytes(d), **extra}
        if run is not None:
            rec.update(s=run["wall"], launches=run["launches"],
                       plain_cuda=run["plain_calls"].get("cuda", 0),
                       counters=run.get("counters"))
        if annotate_before is not None:
            rec["annotate_launches"] = (annotate_launches(annotate_cuda.LAUNCHES)
                                        - annotate_before)
        out[step] = rec

    record("load-cadd", run_load_cadd(torch, plat, d, db, "--commit"))
    if not index_built:
        t0 = time.perf_counter()
        run_load_cadd(torch, plat, d, db, "--buildIndex")
        out["build-index"] = {"s": time.perf_counter() - t0}
    before = annotate_launches(annotate_cuda.LAUNCHES)
    record("load-cadd-file", run_load_cadd(
        torch, plat, d, db, "--fileName", inp["head6"], "--updateExisting",
        "--commit"), annotate_before=before)
    export = os.path.join(WORK, f"export.{config}.{plat}")
    wall, _lines = run_host_command(["export-vcf", "--storeDir", d,
                                     "--outputDir", export])
    record("export-vcf", s=wall, export=tree_bytes(export))
    wall, _lines = run_host_command(["undo", "--storeDir", d, "--algId",
                                     str(qc_alg), "--commit"])
    record("undo", s=wall)
    return out


def check_cadd_parity(dev, cpu, config, spec, platform) -> None:
    """Phase 6's CADD steps, card against CPU: the store bytes after each
    step and the export files identical; on the card, ``cadd_join``
    launched as predicted by the whole-store join and never by the indexed
    one, the annotate kernel's identity entry once for the subset VCF's
    one chunk under the Python tokenizer (none under the native one), no
    plain join.  Emits
    ``parity_cadd``; raises AssertionError on any failed check."""
    python = config != "default"
    steps = {}
    for step, rec in dev.items():
        other = cpu.get(step, {})
        if "files" in rec:
            a, b = rec.pop("files"), other.pop("files")
            rec["differ"] = sorted(k for k in set(a) | set(b)
                                   if a.get(k) != b.get(k))
        if "export" in rec:
            ea, eb = rec.pop("export"), other.pop("export")
            rec["export_files"] = len(ea)
            rec["export_differ"] = sorted(k for k in set(ea) | set(eb)
                                          if ea.get(k) != eb.get(k))
        rec["cpu_s"] = other.get("s")
        steps[step] = rec
    pred = spec["pred"]
    want = sum(pred["launches"].values())
    emit("parity_cadd", config=config, steps=steps, predicted_launches=want,
         predicted_blocks=pred["blocks"], table_rows=pred["rows"],
         subset_lines=spec["head_lines"])
    for step, rec in steps.items():
        assert not rec.get("differ") and not rec.get("export_differ"), (
            f"phase 6 ({config}): device and CPU differ after {step} in "
            f"{rec.get('differ') or rec['export_differ']}")
    assert steps["load-cadd"]["counters"].get("rejected", 0) == (2 if python else 0)
    if platform == "cuda":
        assert steps["load-cadd"]["launches"] == want, (
            f"phase 6 ({config}): cadd_join launched "
            f"{steps['load-cadd']['launches']} times, predicted {want}")
        assert steps["load-cadd-file"]["launches"] == 0
        assert steps["load-cadd-file"]["annotate_launches"] == int(python)
        assert not any(rec.get("plain_cuda") for rec in steps.values()), (
            f"phase 6 ({config}): the plain join ran on the card")


def update_launches_predicted(name, run, native) -> int:
    """Annotate launches an update run must make on the card (either
    entry: ``annotate_bin_packed`` for an insert whose alleles go up
    nibble-packed, ``annotate_bin`` for the rest): one
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
            # the run records are compared on their own (store_bytes)
            ra, rb = ([{k: v for k, v in json.loads(ln).items() if k != "ts"}
                       for ln in open(p) if ln.strip()
                       and json.loads(ln).get("type") != "run"] for p in (pa, pb))
            if ra == rb:
                continue
        differ.append(name)
    return differ


def vep_phase(torch, platform, prep, launches, hash_calls) -> dict:
    """Phase 7 on ``platform``: the VEP update of phase 4's store through
    the CLI in the default configuration; then (7b) the 10,000-result file
    in the default configuration onto ``prep["store_7b"]`` and under
    ``AVDB_NATIVE_VEP=0`` onto ``prep["store_python"]``, copies of the
    store made before phase 7 (removed after the comparison).
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
        # a store 49 wide takes one launch of the identity entry a batch,
        # and neither annotate_bin nor pack_vep_outputs
        identity_launches_check("vep", launched, batches)
        assert not hashed.get("cuda"), (
            f"vep: the load called the plain allele_hash on the card "
            f"{hashed['cuda']} times")
    del loader, pinned, segs, run

    # 7b. a 10,000-result file over the first tenth of the lines, in the
    # default configuration and through the Python transform, each onto a
    # copy of the store made before phase 7: the two must decode equal
    want_b, novel_b = prep["want7b"], prep["novel7b"]
    default = run_load_vep(torch, platform, prep["store_7b"], prep["vep7b"])
    before = dict(launches)
    with environment(AVDB_NATIVE_VEP="0"):
        py = run_load_vep(torch, platform, prep["store_python"], prep["vep7b"])
    py_loader = py["loader"]
    py_launched = {k: launches[k] - before[k] for k in launches}
    got_default = {k: default["loader"].counters.get(k, 0) for k in want_b}
    got_py = {k: py_loader.counters.get(k, 0) for k in want_b}
    learned = sorted(default["loader"].parser.ranker.added)
    t0 = time.perf_counter()
    differ = decoded_differences(prep["store_7b"], prep["store_python"])
    emit("vep_python", results=want_b["line"] - 1, wall_s=py["wall"],
         results_per_s=(want_b["line"] - 1) / py["wall"],
         default_wall_s=default["wall"],
         loader_wall_s=py_loader.timer.wall_seconds,
         store_load_s=py["store_load_s"], store_save_s=py["store_save_s"],
         stage_seconds=dict(py_loader.timer.seconds),
         transform_stats=py_loader.transform_stats,
         default_transform_stats=default["loader"].transform_stats,
         identity_batches=py_loader.identity_batches, launches=py_launched,
         counters=got_py, default_counters=got_default, predicted=want_b,
         decoded_differ=differ, compare_s=time.perf_counter() - t0)
    assert got_py == want_b and got_default == want_b, (
        f"vep 7b: counters {got_default} (default) / {got_py} (python), "
        f"predicted {want_b}")
    assert learned == sorted(novel_b), f"vep 7b: learned {learned}, planted {novel_b}"
    assert default["loader"].transform_stats["native_rows"] > 0
    assert py_loader.transform_stats["native_rows"] == 0
    if device.type == "cuda":
        identity_launches_check("vep (python)", py_launched, py_loader.identity_batches)
    assert not differ, (
        f"vep: the native and Python transforms' stores decode differently "
        f"in {differ}")
    for d in (prep["store_7b"], prep["store_python"]):
        shutil.rmtree(d)
    return {"launches": launched, "identity_batches": batches,
            "rows_per_batch": rows / batches}


def identity_launches_check(label, launched, batches) -> None:
    """A VEP update of a store at most 255 wide on the card: one launch of
    the identity entry an identity batch, no ``annotate_bin`` and no
    ``pack_vep_outputs``.  Raises AssertionError otherwise."""
    got = {k: launched[k] for k in ("annotate_bin_identity", "annotate_bin",
                                    "pack_vep_outputs")}
    assert got == {"annotate_bin_identity": batches, "annotate_bin": 0,
                   "pack_vep_outputs": 0}, (
        f"{label}: launches {got} for {batches} identity batches")


def load_update_store(vcf, platform="cuda") -> str:
    """Phase 8's store: ``vcf`` through ``load-vcf --commit`` (the CLI's
    ``main``) into a fresh directory; its wall is emitted."""
    from annotatedvdb_tpu_torch.cli.load_vcf import main as load_vcf

    store = os.path.join(WORK, "store8")
    t0 = time.perf_counter()
    rc = load_vcf(["--fileName", vcf, "--storeDir", store, "--commit",
                   "--logAfter", "0", "--platform", platform])
    assert rc == 0, f"phase 8's load-vcf exited {rc}"
    emit("update_store", vcf=os.path.basename(vcf), wall_s=time.perf_counter() - t0,
         rows=ledger_records(store, "finish")[-1]["counters"]["variant"])
    return store


def update_phase(torch, platform, store_dir, updates, launches, hash_calls) -> dict:
    """Phase 8 on ``platform``: the three update commands in turn on the
    store of phase 7 (``store_dir``), through the CLIs in the default
    configuration.  ``launches`` and ``hash_calls`` are set to 0 just
    before each run and read just after it; the kernel steps kept from the
    run are held against the plain versions after that (those launches are
    not counted).  Returns each command's launches by kernel.  Raises
    AssertionError on any failed check."""
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
            assert annotate_launches(launched) == want_l, (
                f"{name}: the annotate entries launched {annotate_launches(launched)} "
                f"times, predicted {want_l}")
            assert not hashed.get("cuda"), (
                f"{name}: the update called the plain allele_hash on the card "
                f"{hashed['cuda']} times")
            # each synchronous insert packs its outputs on the card: one
            # launch of the packed entry where its alleles went up
            # nibble-packed, a pack after annotate_bin where they went up
            # raw, and never an inflate
            packed = launched["annotate_bin_packed"] + launched["pack_outputs"]
            assert packed == run["inserts"] and not launched["inflate_alleles"], (
                f"{name}: {launched['annotate_bin_packed']} packed-entry / "
                f"{launched['pack_outputs']} pack / {launched['inflate_alleles']} "
                f"inflate launches for {run['inserts']} inserts")
            # each lookup hash takes one launch of the identity entry
            assert launched["annotate_bin_identity"] == run["hash_steps"], (
                f"{name}: {launched['annotate_bin_identity']} identity-entry "
                f"launches for {run['hash_steps']} device hash steps")
        out[name] = dict(launched)
    return out


def cadd_expected(spec, label, pos, ref, alt):
    """The ``cadd_scores`` a whole-store join must leave on a row: the
    SNV table's scores for a stored SNV in the span, the planted row's for
    a planted indel, else the ``{}`` placeholder."""
    lo, hi = spec["span"]
    if len(ref) == 1 and len(alt) == 1:
        if not lo <= pos <= hi:
            return {}
        raw, phred = cadd_snv_score_text(pos, "ACGT".index(alt))
    else:
        found = spec["pred"]["expected"].get((label, pos, ref, alt))
        if found is None:
            return {}
        raw, phred = found
    return {"CADD_raw_score": float(raw), "CADD_phred": float(phred)}


def cadd_phase(torch, platform, store_dir, spec) -> dict:
    """Phase 9 on ``platform``: ``load-cadd --commit`` of the whole store of
    phases 4 and 5 (no VEP sidecars) against the two tables over
    ``spec["span"]``, through the CLI in the default configuration, every
    launch and plain-call counter set to 0 just before and read just
    after: counters and ``cadd_join`` launches as the generator predicts,
    no plain join and no ``annotate_bin`` launch on the card; the store
    reloads and 100 sampled rows (50 of them indels in the span) carry the
    tables' text-parsed floats.  Raises AssertionError on any failed
    check."""
    from annotatedvdb_tpu_torch.ops import annotate_cuda, cadd_join
    from annotatedvdb_tpu_torch.store import VariantStore

    pred = spec["pred"]
    for counts in (cadd_join.LAUNCHES, cadd_join.CALLS, annotate_cuda.LAUNCHES):
        for key in counts:
            counts[key] = 0
    run = run_load_cadd(torch, platform, store_dir, spec["db"], "--commit",
                        trace=True)
    launched = cadd_join.LAUNCHES["cadd_join"]
    calls, annotated = dict(cadd_join.CALLS), annotate_cuda.LAUNCHES["annotate_bin"]
    upd, counters, wall, busy = run["updater"], run["counters"], run["wall"], run["busy"]
    t0 = time.perf_counter()
    store = VariantStore.load(store_dir)
    reload_s = time.perf_counter() - t0
    shard = store.shards[22]
    rng = np.random.default_rng(9)
    lo, hi = spec["span"]
    pos = shard.cols["pos"]
    indel = np.flatnonzero((pos >= lo) & (pos <= hi)
                           & ((shard.cols["ref_len"] > 1) | (shard.cols["alt_len"] > 1)))
    sample = np.union1d(rng.choice(shard.n, 50, replace=False),
                        rng.choice(indel, 50, replace=False))
    wrong, matched = [], 0
    for i in sample.tolist():
        ref, alt = shard.alleles(i)
        want = cadd_expected(spec, "22", int(pos[i]), ref, alt)
        got = shard.get_ann("cadd_scores", i)
        matched += bool(want)
        if got != want:
            wrong.append((int(pos[i]), ref, alt, got, want))
    keys = ("snv", "indel", "not_matched", "update", "skipped")
    got_c = {k: counters.get(k, 0) for k in keys}
    want_c = {k: pred[k] for k in keys}
    want_l = sum(pred["launches"].values())
    rows = sum(pred["rows"].values())
    stages = dict(upd.timer.seconds)
    emit("cadd", wall_s=wall, table_rows=rows, rows_scanned_per_s=rows / wall,
         candidates=pred["candidates"], counters=got_c, predicted=want_c,
         stage_seconds=stages, loader_wall_s=upd.timer.wall_seconds,
         store_load_s=run["store_load_s"], store_save_s=run["store_save_s"],
         blocks=upd.join_stats["blocks"], predicted_blocks=pred["blocks"],
         launches=launched, predicted_launches=pred["launches"],
         h2d_bytes=upd.join_stats["h2d_bytes"], plain_join_calls=calls,
         annotate_bin_launches=annotated, queue_stalls=upd.queue_stalls,
         profiler_device_busy_s=busy,
         profiler_device_idle_fraction=None if busy is None else 1 - busy / wall,
         reload_s=reload_s, sampled=int(sample.size), sampled_matched=matched,
         sampled_wrong=wrong[:5], span=list(spec["span"]))
    assert got_c == want_c, f"cadd: counters {got_c}, predicted {want_c}"
    assert "rejected" not in counters, counters
    assert not wrong, f"cadd: {len(wrong)} sampled rows differ, e.g. {wrong[:3]}"
    if platform == "cuda":
        assert launched == want_l, (
            f"cadd: cadd_join launched {launched} times, predicted {want_l}")
        assert not calls.get("cuda"), (
            f"cadd: the plain join ran on the card {calls['cuda']} times")
        assert annotated == 0, f"cadd: annotate_bin launched {annotated} times"
    return {"launches": launched}


def refgenome_phase(torch, platform, inp) -> dict:
    """Phase 10 on ``platform``: ``index-genome`` of the chr22/chr21 FASTA
    (lossy flags, chr22's arrays equal to the generator's, sampled
    ``fetch`` windows equal to the FASTA text uppercased with non-ACGT as
    N); then ``load-vcf --refGenome --commit`` of phase 10's VCF into a
    fresh store against the GRCh38-shaped index, every launch and plain
    counter set to 0 just before and read just after (``ref_mismatch``
    and the inserted rows as the generator counts them, one
    ``validate_ref`` launch per chunk that inserts rows, one annotate
    launch per chunk and the warmup's packed one, no plain version of
    either on the card, chr22's digest-PK rows built on its canonical ``SQ.`` sequence
    id); then ``install-schema --storeDir`` of that store (COPY rows equal
    to store rows, one ``annotate_bin`` launch per 65,536-row window);
    then ``bin-references`` for GRCh38.  Raises AssertionError on any
    failed check."""
    from torch.profiler import ProfilerActivity, profile

    from annotatedvdb_tpu_torch.cli.load_vcf import main as load_vcf
    from annotatedvdb_tpu_torch.genome import ReferenceGenome, refgenome
    from annotatedvdb_tpu_torch.loaders import VcfLoader
    from annotatedvdb_tpu_torch.ops import annotate_cuda, hashing
    from annotatedvdb_tpu_torch.ops.vrs import VrsDigestGenerator, sha512t24u
    from annotatedvdb_tpu_torch.store import VariantStore
    from annotatedvdb_tpu_torch.store.variant_store import _DIGEST_PK
    from annotatedvdb_tpu_torch.types import chromosome_label

    g = inp["genome"]
    text = g["text"]
    # index-genome of the FASTA
    index = os.path.join(WORK, "chr22.index.npz")
    index_s, printed = run_host_command(["index-genome", "--fasta", g["fasta"],
                                         "--output", index])
    built = ReferenceGenome.load(index)
    lo22, m22 = built.byte_offset[22], built.mask_offset[22]
    same_arrays = (
        np.array_equal(built.packed[lo22: lo22 + g["packed22"].size], g["packed22"])
        and np.array_equal(built.n_mask[m22: m22 + g["mask22"].size], g["mask22"]))
    rng = np.random.default_rng(10)
    chr21 = np.where(np.isin(g["chr21"], ACGT), g["chr21"], ord("N")).astype(np.uint8)
    windows = [(22, int(a), int(a) + int(k), text)
               for a, k in zip(rng.integers(0, text.size - 200, 200),
                               rng.integers(1, 200, 200))]
    windows += [(21, 0, 1000, chr21), (22, text.size - 50, text.size + 10, text)]
    bad_windows = [(c, a, b) for c, a, b, t in windows
                   if built.fetch(c, a, b) != t[a:b].tobytes().decode()]
    emit("index_genome", wall_s=index_s, printed=printed[-1:], lossy=built.lossy,
         length=built.length, arrays_equal=same_arrays, windows=len(windows),
         windows_differ=bad_windows[:5])
    assert built.lossy == {21: True, 22: False}, f"index-genome lossy {built.lossy}"
    assert built.length == {21: 1000, 22: text.size}, f"index-genome {built.length}"
    assert same_arrays, "index-genome's chr22 arrays differ from the generator's"
    assert not bad_windows, f"fetch windows differ: {bad_windows[:3]}"
    del built

    # the load, on the GRCh38-shaped index
    store_dir = os.path.join(WORK, "store.refgenome")
    rows_want, bad_want = inp["want10"]
    counts = (annotate_cuda.LAUNCHES, refgenome.LAUNCHES, refgenome.CALLS, hashing.CALLS)
    for c in counts:
        for key in c:
            c[key] = 0
    traced = platform == "cuda"
    t0 = time.perf_counter()
    with (profile(activities=[ProfilerActivity.CUDA]) if traced
          else contextlib.nullcontext()) as prof, \
            captured_loaders(VcfLoader) as loaders, \
            timed_calls(ReferenceGenome, "load", []) as load_s, \
            timed_calls(ReferenceGenome, "device_arrays", []) as upload_s, \
            timed_calls(refgenome, "validate_ref_batch", []) as validate_s:
        rc = load_vcf(["--fileName", inp["vcf10"], "--storeDir", store_dir,
                       "--commit", "--logAfter", "0", "--platform", platform,
                       "--refGenome", g.get("index", index)])
        if platform == "cuda":
            torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    assert rc == 0, f"phase 10 load exited {rc}"
    annotated, validated = annotate_launches(annotate_cuda.LAUNCHES), refgenome.LAUNCHES["validate_ref"]
    plain = {"validate_ref": refgenome.CALLS.get("cuda", 0),
             "allele_hash": hashing.CALLS.get("cuda", 0)}
    busy = None
    if traced:
        busy = sum(getattr(e, "self_device_time_total", 0.0)
                   for e in prof.key_averages()) / 1e6 or None
    counters = ledger_records(store_dir, "finish")[-1]["counters"]
    chunks = len(ledger_records(store_dir, "checkpoint"))
    inserting = inserting_chunks(store_dir, 1)
    loader = loaders[0]
    # chr22's digest-PK rows: built on the genome's own sequence digest
    digest = sha512t24u(text.tobytes())
    gen = VrsDigestGenerator(sequence_digests={"22": digest},
                             reference_bases=lambda c, a, b: text[max(a, 0): b].tobytes().decode())
    store = VariantStore.load(store_dir)
    shard = store.shards[22]
    dpk = shard.object_column(_DIGEST_PK)
    positions = shard.column("pos")
    digest_rows = [int(i) for i in np.flatnonzero(dpk != None)]  # noqa: E711
    wrong_pk = []
    for i in digest_rows:
        ref, alt = shard.alleles(i)
        pos = int(positions[i])
        try:
            d = gen.compute_identifier("22", pos, ref, alt)
        except ValueError:
            try:
                d = gen.compute_identifier("22", pos, alt, ref)
            except ValueError:
                d = gen.compute_identifier("22", pos, ref, alt, validate=False)
        if dpk[i].split(":")[2] != d:
            wrong_pk.append((pos, dpk[i]))
    stages = dict(loader.timer.seconds)
    emit("refgenome", lines=counters["line"], variants=counters["variant"],
         ref_mismatch=counters.get("ref_mismatch", 0), predicted_rows=rows_want,
         predicted_ref_mismatch=bad_want, out_of_bounds=counters.get("out_of_bounds"),
         chunks=chunks, inserting_chunks=inserting, validate_launches=validated,
         annotate_launches=annotated, plain_cuda=plain, wall_s=wall,
         lines_per_s=counters["line"] / wall, genome_load_s=sum(load_s),
         genome_upload_s=sum(upload_s), validate_calls=len(validate_s),
         validate_s=sum(validate_s), validate_s_less_upload=sum(validate_s) - sum(upload_s),
         stage_seconds=stages, loader_wall_s=loader.timer.wall_seconds,
         sequence_id=loader.digester.sequence_id("22"), digest_rows=len(digest_rows),
         digest_rows_wrong=wrong_pk[:3], profiler_device_busy_s=busy,
         profiler_device_idle_fraction=None if busy is None else 1 - busy / wall)
    assert (counters["variant"], counters.get("ref_mismatch", 0)) == (rows_want, bad_want), (
        f"phase 10: {counters['variant']} rows / {counters.get('ref_mismatch', 0)} "
        f"mismatches, predicted {rows_want} / {bad_want}")
    assert loader.digester.sequence_id("22") == "SQ." + digest, (
        f"phase 10: chr22's sequence id {loader.digester.sequence_id('22')}")
    assert digest_rows and not wrong_pk, f"phase 10: digest PKs differ: {wrong_pk[:3]}"
    if platform == "cuda":
        assert (validated, annotated) == (inserting, chunks + WARMUP_PACKED), (
            f"phase 10: {validated} validate_ref / {annotated} annotate launches "
            f"for {inserting} inserting chunks / {chunks} chunks and the warmup")
        assert not any(plain.values()), f"phase 10: plain versions on the card: {plain}"

    # install-schema of that store
    annotate_cuda.LAUNCHES["annotate_bin"] = 0
    pg = run_install_schema(torch, platform, store_dir, os.path.join(WORK, "pg.refgenome"))
    copy_rows = {k: v.count(b"\n") for k, v in pg.pop("tree").items()
                 if k.startswith("data/variant_")}
    want_rows = {f"data/variant_chr{chromosome_label(c)}.copy": n
                 for c, n in pg["rows"].items()}
    n_rows = sum(pg["rows"].values())
    emit("install_schema", wall_s=pg["s"], rows=n_rows, rows_per_s=n_rows / pg["s"],
         copy_rows=copy_rows, launches=pg["launches"],
         predicted_launches=egress_windows(pg["rows"]), plain_cuda=pg["plain_cuda"],
         printed=pg["printed"][-1:])
    assert copy_rows == want_rows, f"install-schema: {copy_rows}, store {want_rows}"
    if platform == "cuda":
        assert pg["launches"] == egress_windows(pg["rows"]), (
            f"install-schema: {pg['launches']} annotate_bin launches, predicted "
            f"{egress_windows(pg['rows'])}")
        assert pg["plain_cuda"] == 0, "install-schema called the plain hash on the card"

    # bin-references for GRCh38
    tsv = os.path.join(WORK, "bin_index_ref.tsv")
    bins_s, printed = run_host_command(["bin-references", "-o", tsv])
    with open(tsv) as f:
        lines = f.read().splitlines()
    emit("bin_references", wall_s=bins_s, rows=len(lines), first=lines[0],
         last=lines[-1], printed=printed[-1:])
    assert len(lines) == 395_448 and printed[-1] == (
        "generated 395448 bins for 25 chromosomes"), printed
    return {"launches": validated, "annotate_launches": annotated,
            "egress_launches": pg["launches"]}


# ------------------------------------------------- query server (phase 11)

#: phase 11's mix: point ids (5% absent), bulk calls of ``bulk_ids`` ids,
#: single-region walks of ``region_pages`` pages (``minCadd=20``,
#: ``page_rows`` rows a page), ``panels`` ``POST /regions`` batches and
#: ``stats`` ``POST /stats/region`` batches (windows 16) of ``intervals``
#: intervals each, sent by ``clients`` threads
SERVE_MIX = {"points": 1000, "absent_share": 0.05, "bulk_calls": 5,
             "bulk_ids": 10_000, "regions": 32, "region_pages": 3,
             "page_rows": 100, "panels": 8, "stats": 8,
             "intervals": SERVE_QUERIES, "clients": 8}


def serve_ids(lines, rng, n, absent_share):
    """``n`` variant ids drawn from VCF data ``lines``; ``absent_share`` of
    them with an alternate base no line at that position carries (the
    phase-4 file has one line a position, so such an id is absent)."""
    out = []
    pick = rng.choice(len(lines), n)
    absent = rng.random(n) < absent_share
    for li, gone in zip(pick.tolist(), absent.tolist()):
        chrom, pos, _vid, ref, alt_col = lines[li].split("\t", 5)[:5]
        alts = [a for a in alt_col.split(",") if a != "."] or ["A"]
        if gone:
            alt = next(b for b in "ACGT" if b != ref[0] and b not in alts)
        else:
            alt = alts[int(rng.integers(len(alts)))]
        out.append(f"{chrom}:{pos}:{ref}:{alt}")
    return out


def serve_intervals(rng, n, span):
    """``n`` gene-panel intervals on chr22 (1-100 kb inside ``span``), 1%
    as wide as the chromosome and 1% on chr21, which the store lacks."""
    starts = rng.integers(span[0], span[1], n)
    ends = starts + rng.integers(1_000, 100_000, n)
    u = rng.random(n)
    out = []
    for s, e, x in zip(starts.tolist(), ends.tolist(), u.tolist()):
        if x < 0.01:
            out.append(f"22:1-{CHR22_LENGTH}")
        elif x < 0.02:
            out.append(f"21:{s}-{e}")
        else:
            out.append(f"22:{s}-{e}")
    return out


def serve_jobs(vcf4, span, seed=11, mix=SERVE_MIX) -> list:
    """Phase 11's seeded jobs, shuffled: ``(job id, kind, payload)`` with
    kind ``point`` (an id), ``bulk`` (ids), ``region`` (a chr22 spec of
    10 kb-1 Mb inside the CADD span, walked page by page), ``regions``
    (a batch body: half count-only, half ``limit`` 2 with ``tokenize``)
    and ``stats`` (a batch body with ``windows`` 16)."""
    rng = np.random.default_rng(seed)
    with open(vcf4) as f:
        lines = [ln for ln in f if ln[:1] != "#" and ln.split("\t", 2)[1].isdigit()]
    jobs = [("point", v) for v in serve_ids(lines, rng, mix["points"],
                                            mix["absent_share"])]
    jobs += [("bulk", serve_ids(lines, rng, mix["bulk_ids"], mix["absent_share"]))
             for _ in range(mix["bulk_calls"])]
    lens = rng.integers(10_000, 1_000_001, mix["regions"])
    for n in lens.tolist():
        s = int(rng.integers(16_000_001, 22_000_000 - n))
        jobs.append(("region", f"22:{s}-{s + n - 1}"))
    for i in range(mix["panels"]):
        body = {"regions": serve_intervals(rng, mix["intervals"], span)}
        body.update({"limit": 0} if i % 2 else {"limit": 2, "tokenize": True})
        jobs.append(("regions", body))
    for _ in range(mix["stats"]):
        jobs.append(("stats", {"regions": serve_intervals(rng, mix["intervals"], span),
                               "windows": SERVE_WINDOWS}))
    order = rng.permutation(len(jobs))
    return [(int(j), *jobs[j]) for j in order.tolist()]


def _digest(status, body: bytes) -> tuple:
    import hashlib

    return status, len(body), hashlib.sha256(body).hexdigest()


def serve_expected(store_dir, jobs, mix=SERVE_MIX) -> dict:
    """The host-only answers to ``jobs`` (a share of :func:`serve_jobs`'s):
    a CPU engine over the same store (every group below
    the device minimums, so every span and panel comes from the numpy
    twins), each answer rendered as the HTTP handler renders it; returns
    {job id: [(status, bytes, sha256), ...]} (one entry a page for region
    walks) and the seconds taken.  Runs in a spawned helper process."""
    from annotatedvdb_tpu_torch.serve.engine import QueryEngine
    from annotatedvdb_tpu_torch.serve.snapshot import StaticSnapshots
    from annotatedvdb_tpu_torch.store import VariantStore

    t0 = time.perf_counter()
    engine = QueryEngine(StaticSnapshots(VariantStore.load(store_dir, readonly=True)),
                         device="cpu", regions_device_min=1 << 30,
                         stats_device_min=1 << 30)
    out = {}
    for jid, kind, payload in sorted(jobs, key=lambda j: j[0]):
        if kind == "point":
            rec = engine.lookup(payload)
            out[jid] = [_digest(200, rec.encode()) if rec is not None else _digest(
                404, json.dumps({"error": f"variant {payload!r} not in store"}).encode())]
        elif kind == "bulk":
            res = engine.lookup_many(payload)
            found = sum(r is not None for r in res)
            body = (f'{{"n":{len(res)},"found":{found},"results":['
                    + ",".join(r if r is not None else "null" for r in res) + "]}")
            out[jid] = [_digest(200, body.encode())]
        elif kind == "region":
            pages, tok = [], ""
            for _ in range(mix["region_pages"]):
                text = engine.region(payload, min_cadd=20.0,
                                     limit=mix["page_rows"], cursor=tok)
                pages.append(_digest(200, text.encode()))
                tok = json.loads(text)["next"]
                if tok is None:
                    break
            out[jid] = pages
        elif kind == "regions":
            res = engine.regions_serve(payload["regions"], limit=payload["limit"],
                                       tokenize=payload.get("tokenize", False))
            out[jid] = [_digest(200, res.assemble().encode())]
        else:
            res = engine.stats_serve(payload["regions"], windows=payload.get("windows"))
            out[jid] = [_digest(200, res.assemble().encode())]
    return {"answers": out, "seconds": time.perf_counter() - t0}


def _serve_client(port, queue_, results, lock, mix):
    """One client thread: take jobs until the queue is empty; each request
    on a fresh connection, timed from send to the last body byte."""
    import http.client
    import queue

    def call(method, path, body=None):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=900)
        try:
            t = time.perf_counter()
            data = None if body is None else json.dumps(body).encode()
            conn.request(method, path, body=data)
            resp = conn.getresponse()
            raw = resp.read()
            return resp.status, raw, time.perf_counter() - t
        finally:
            conn.close()

    while True:
        try:
            jid, kind, payload = queue_.get_nowait()
        except queue.Empty:
            return
        got = []
        if kind == "point":
            status, raw, dt = call("GET", f"/variant/{payload}")
            got.append((kind, status, raw, dt))
        elif kind == "bulk":
            got.append((kind, *call("POST", "/variants", {"ids": payload})))
        elif kind == "region":
            tok = ""
            for _ in range(mix["region_pages"]):
                status, raw, dt = call(
                    "GET", f"/region/{payload}?minCadd=20&limit="
                    f"{mix['page_rows']}&cursor={tok}")
                got.append((kind, status, raw, dt))
                tok = json.loads(raw).get("next") if status == 200 else None
                if tok is None:
                    break
        else:
            route = "/regions" if kind == "regions" else "/stats/region"
            got.append((kind, *call("POST", route, payload)))
        with lock:
            results[jid] = [(k, dt, _digest(status, raw)) for k, status, raw, dt in got]


#: spawned processes computing phase 11's host-only answers, in parallel
SERVE_HELPERS = 8


def _warm_serve_helper() -> None:
    """Import what :func:`serve_expected` needs, so a helper process has
    paid its start-up before the traffic window."""
    from annotatedvdb_tpu_torch.serve import engine  # noqa: F401

    time.sleep(1.0)  # hold this worker, so each warm call lands on its own


#: phase 11's turns, in the order they are driven: the default front end
#: first, then ``--frontend threaded``, then the fleet (``--workers``
#: SERVE_FLEET_WORKERS, the default ``aio`` front end in every worker)
SERVE_FRONTENDS = ("aio", "threaded", "fleet")

#: phase 11's fleet size: four worker processes sharing one card
SERVE_FLEET_WORKERS = 4


def serve_command(store_dir, platform, frontend, workers=SERVE_FLEET_WORKERS,
                  extra=()) -> list:
    """``python -m annotatedvdb_tpu_torch serve --port 0`` for one of
    :data:`SERVE_FRONTENDS` (no flag for ``aio``, the default; ``fleet``
    is ``--workers workers``)."""
    flags = {"aio": [], "threaded": ["--frontend", "threaded"],
             "fleet": ["--workers", str(workers)]}[frontend]
    return [sys.executable, "-m", "annotatedvdb_tpu_torch", "serve",
            "--storeDir", store_dir, "--port", "0", *flags, *extra,
            *(["--platform", "cpu"] if platform == "cpu" else [])]


def wait_serving(proc, out_path, err_path, workers=1, timeout=300.0) -> tuple:
    """Wait until a serve process printed its banner and, in a fleet, until
    ``workers`` workers printed their readiness lines; returns (the
    banner, the port, seconds waited)."""
    import re

    t0 = time.perf_counter()
    while True:
        if proc.poll() is not None or time.perf_counter() - t0 > timeout:
            raise AssertionError(f"serve did not start (rc {proc.poll()}) in "
                                 f"{time.perf_counter() - t0:.1f} s: "
                                 + serve_diagnosis(proc, out_path, err_path))
        with open(out_path) as f:
            text = f.read()
        lines = [ln + "\n" for ln in text.split("\n")[:-1]]
        banner = next((ln.strip() for ln in lines if ln.startswith("serving ")),
                      None)
        # the workers that printed their readiness, by index and wherever
        # in the shared output their line landed
        ready = len(set(re.findall(r"worker (\d+) serving ", text)))
        if banner is not None and (workers <= 1 or ready >= workers):
            port = int(re.search(r"http://[\d.]+:(\d+)", banner).group(1))
            return banner, port, time.perf_counter() - t0
        time.sleep(0.2)


def serve_diagnosis(proc, out_path, err_path) -> str:
    """Why a serve process (a fleet's supervisor and its workers) never got
    ready: its stdout, each worker's process state, kernel wait channel
    and threads, the card's compute processes and memory, the processes
    still running, then the Python stacks of every worker's threads (each
    is sent SIGABRT: with ``PYTHONFAULTHANDLER`` set, as the smoke's
    servers have it, it prints them to the shared stderr) and the stderr's
    tail."""
    import re
    import signal

    with open(err_path) as f:
        err = f.read()
    with open(out_path) as f:
        lines = [f"rc {proc.poll()}; stdout: {f.read()[-1000:]!r}"]
    pids = [int(p) for p in re.findall(r"worker \d+: pid (\d+)", err)]
    for pid in pids:
        try:
            with open(f"/proc/{pid}/stat") as f:
                state = f.read().rsplit(")", 1)[1].split()[0]
            with open(f"/proc/{pid}/wchan") as f:
                wchan = f.read()
            threads = len(os.listdir(f"/proc/{pid}/task"))
        except OSError as exc:
            state, wchan, threads = "gone", str(exc), 0
        lines.append(f"worker pid {pid}: state {state}, wchan {wchan}, "
                     f"{threads} threads")
    lines.append(f"card: {card_apps()}; processes: {leftover_processes()}")
    for pid in pids:  # one at a time: their dumps share one stderr
        with contextlib.suppress(OSError):
            os.kill(pid, signal.SIGABRT)
        time.sleep(1.0)
    with open(err_path) as f:
        lines.append(f.read()[-30000:])
    return "\n".join(lines)


def leftover_processes() -> list:
    """``[pid, state, command line]`` of every live process below this
    one, and of every other whose command line names this run's work
    directory (the orphans a dead parent of the smoke's left behind),
    this process and its ancestors aside.
    ``multiprocessing``'s resource tracker, which lives as long as this
    process, is left out."""
    procs = {}
    for name in os.listdir("/proc"):
        if not name.isdigit():
            continue
        try:
            with open(f"/proc/{name}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode(errors="replace")
            with open(f"/proc/{name}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
        except (OSError, IndexError):
            continue
        procs[int(name)] = (fields[0], int(fields[1]), cmd)
    me = os.getpid()
    above, pid = set(), me
    while pid in procs and pid not in above:
        above.add(pid)
        pid = procs[pid][1]
    below, grew = {me}, True
    while grew:
        grew = False
        for pid, (_state, ppid, _cmd) in procs.items():
            if ppid in below and pid not in below:
                below.add(pid)
                grew = True
    return [[pid, state, cmd[:300]] for pid, (state, _ppid, cmd) in sorted(procs.items())
            if pid not in above and state != "Z" and (pid in below or WORK in cmd)
            and "multiprocessing.resource_tracker" not in cmd]


def card_apps() -> dict:
    """``nvidia-smi``'s compute processes and used memory (MiB) on the
    card (its process ids are the host's, which a container may not
    see)."""
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-compute-apps=pid,used_memory",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.SubprocessError) as err:
        return {"error": str(err)}
    return {"compute_apps": [ln.strip() for ln in smi.stdout.splitlines() if ln.strip()],
            "memory_used_mib": gpu_memory_used_mib()}


def leftovers_check(grace_s=15.0) -> list:
    """After the last phase: wait up to ``grace_s`` for every process the
    smoke started to be gone, emit a ``leftovers`` line (those still
    running, and the card's compute processes and used memory), SIGKILL
    any still running and return them (the smoke then fails)."""
    import signal

    t0 = time.perf_counter()
    left = leftover_processes()
    while left and time.perf_counter() - t0 < grace_s:
        time.sleep(0.5)
        left = leftover_processes()
    emit("leftovers", processes=left, waited_s=time.perf_counter() - t0, **card_apps())
    for pid, _state, _cmd in left:
        with contextlib.suppress(OSError):
            os.kill(pid, signal.SIGKILL)
    return left


def gpu_memory_used_mib():
    """``nvidia-smi``'s used memory on the card (MiB), or None."""
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=memory.used",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.SubprocessError):
        return None
    return float(smi.stdout.split()[0]) if smi.returncode == 0 else None


def merge_summaries(err, workers) -> dict:
    """The shutdown ``run summary`` records in a serve process's stderr:
    one for a single process; one per worker for a fleet (every worker
    index 0..workers-1 exactly once), merged: launches and plain-version
    calls summed, the breaker state of each (all must be clean), each
    worker's device bytes and seconds."""
    summaries = [json.loads(tail.splitlines()[0])
                 for tail in err.split("run summary ")[1:]]
    if workers <= 1:
        assert len(summaries) == 1, f"{len(summaries)} run summaries"
        return summaries[0]
    got = sorted(s.get("worker", -1) for s in summaries)
    # a worker the supervisor's drain budget killed logs no summary: the
    # stderr's tail says which and why
    assert got == list(range(workers)), \
        f"fleet run summaries of workers {got}: {err[-3000:]}"
    merged = {"launches": {}, "plain_calls": {}, "breaker": summaries[0]["breaker"]}
    for s in summaries:
        for k, n in s["launches"].items():
            merged["launches"][k] = merged["launches"].get(k, 0) + n
        for k, calls in s["plain_calls"].items():
            dst = merged["plain_calls"].setdefault(k, {})
            for dev, n in calls.items():
                dst[dev] = dst.get(dev, 0) + n
        assert s["breaker"] == merged["breaker"], s["breaker"]
    by_worker = sorted(summaries, key=lambda s: s["worker"])
    merged["device_bytes"] = {"per_worker": [s["device_bytes"] for s in by_worker]}
    for key in ("store_load_s", "index_build_s", "decode_s"):
        merged[key] = [s[key] for s in by_worker]
    merged["launches_per_worker"] = [s["launches"] for s in by_worker]
    merged["requests_per_worker"] = [s["requests"] for s in by_worker]
    merged["health_per_worker"] = [s["health"] for s in by_worker]
    return merged


def _get(port, path) -> tuple:
    """(status, body, seconds) of one GET on a fresh connection."""
    conn = _Conn(port)
    try:
        return conn.call("GET", path)
    finally:
        conn.close()


def prom_sum(text, name) -> float:
    """The sum of every series of counter ``name`` in a Prometheus
    exposition."""
    import re

    return sum(float(v) for v in re.findall(
        rf"^{name}(?:{{[^}}]*}})? (\S+)$", text, re.M))


def fleet_health_views(port, workers, timeout=20.0) -> dict:
    """Phase 11's fleet turn, after its traffic: ``/metrics?fleet=1``
    once every worker has published a snapshot since the traffic ended
    (each publishes once a second) and the supervisor counts ``workers``
    live, then ``/alerts?fleet=1`` and ``/metrics/history`` once each.
    Returns their statuses, walls and what the checks read."""
    import re

    time.sleep(2.0)  # two publish ticks: every snapshot is post-traffic
    t0 = time.perf_counter()
    while True:
        st, raw, dt = _get(port, "/metrics?fleet=1")
        text = raw.decode()
        live = re.search(r"^avdb_fleet_workers_live (\S+)$", text, re.M)
        if st == 200 and live and float(live.group(1)) == workers:
            break
        assert time.perf_counter() - t0 < timeout, \
            f"/metrics?fleet=1: {st} {text[:2000]}"
        time.sleep(0.5)
    st_a, raw_a, dt_a = _get(port, "/alerts?fleet=1")
    st_h, raw_h, dt_h = _get(port, "/metrics/history")
    alerts, history = json.loads(raw_a), json.loads(raw_h)
    assert st_a == 200 and alerts["fleet"] is True, raw_a[:2000]
    assert st_h == 200 and history["enabled"] is True, raw_h[:2000]
    return {"metrics_fleet_ms": dt * 1e3, "workers_live": float(live.group(1)),
            "requests_summed": prom_sum(text, "avdb_query_requests_total"),
            "alerts_fleet_ms": dt_a * 1e3, "alerts_state": alerts["state"],
            "alerts_firing": alerts["firing"],
            "alerts_workers": sorted(alerts["workers"]),
            "alert_states": {w: {a["slo"]: a["state"] for a in doc["alerts"]}
                             for w, doc in alerts["workers"].items()},
            "history_ms": dt_h * 1e3, "history_worker": history["worker"],
            "history_samples": history["samples"],
            "history_series": len(history["series"])}


def history_docs(store_dir, workers) -> list:
    """Each worker's persisted history mirror (``<store>/history/
    w<i>.ts.json``), read after its server stopped (the final forced
    persist holds every tick)."""
    from annotatedvdb_tpu_torch.obs.timeseries import history_path, load_history

    return [load_history(history_path(store_dir, i)) for i in range(workers)]


def health_tick_timing(doc, ticks=40) -> dict:
    """The health plane's tick on phase 11's registry: a registry rebuilt
    from the ``aio`` server's last sampled snapshot (its every series and
    bucket), a ``HealthPlane`` with the default SLOs whose ring holds the
    server's samples, then ``ticks`` ticks timed one by one (a sample,
    the SLO evaluation over the ring, the history persist when its 5 s
    gate opens; the clock advances a tick a call) and one forced persist
    timed alone."""
    from annotatedvdb_tpu_torch.obs.metrics import MetricsRegistry
    from annotatedvdb_tpu_torch.obs.slo import HealthPlane

    snap = doc["samples"][-1]["metrics"]
    reg = MetricsRegistry()
    for name, entries in snap.items():
        for e in entries:
            if e["kind"] == "counter":
                reg.counter(name, "", e["labels"]).inc(e["value"])
            elif e["kind"] == "gauge":
                reg.gauge(name, "", e["labels"]).set(e["value"])
            else:
                h = reg.histogram(name, e["edges"], "", e["labels"])
                h._counts, h._sum, h._count = list(e["counts"]), e["sum"], e["count"]
    clk = {"t": float(doc["samples"][-1]["t"])}
    tick_dir = os.path.join(WORK, "health-tick")
    plane = HealthPlane(reg, store_dir=tick_dir, worker=0, tick_s=doc["tick_s"],
                        history_s=doc["history_s"], clock=lambda: clk["t"])
    plane.ring._samples = list(doc["samples"])
    each = []
    for _ in range(ticks):
        clk["t"] += doc["tick_s"]
        t = time.perf_counter()
        assert plane.tick()
        each.append(time.perf_counter() - t)
        plane.ring._last_tick = 0.0
    t = time.perf_counter()
    assert plane.ring.persist(plane._extra(), force=True)
    persist_s = time.perf_counter() - t
    size = os.path.getsize(plane.ring.path)
    shutil.rmtree(tick_dir)
    return {"ticks": ticks, "ring_samples": len(plane.ring.samples()),
            "series": sum(len(v) for v in snap.values()),
            "tick_ms_p50": float(np.percentile(each, 50)) * 1e3,
            "tick_ms_max": max(each) * 1e3,
            "persist_ms": persist_s * 1e3, "history_bytes": size,
            "errors": plane.errors}


#: where each front end runs its health-plane tick and flight flush
HEALTH_TICK_WHERE = {
    "aio": "executor pool (4 threads, beside the panels), one in flight",
    "threaded": "inline on a request thread, time-gated on completions and probes",
    "fleet": "each worker's executor pool (4 threads), one in flight",
}


def serve_phase(torch, platform, store_dir, vcf4, kernel_ms, mix=SERVE_MIX) -> dict:
    """Phase 11: ``python -m annotatedvdb_tpu_torch serve --port 0`` on
    phase 9's store (its CADD scores and FREQ allele frequencies; no
    ranks), once per turn of :data:`SERVE_FRONTENDS`, in turns (``aio``, the
    default, with no ``--frontend`` flag; then ``--frontend threaded``;
    then ``--workers`` :data:`SERVE_FLEET_WORKERS` on the one card),
    with the brownout ladder's latency trigger off
    (``AVDB_SERVE_BROWNOUT_P99_MS=0``: the phase measures full service),
    and the jobs of :func:`serve_jobs` sent by ``mix["clients"]`` threads.
    After the traffic windows, :data:`SERVE_HELPERS` spawned processes
    (started and warmed before the first server, idle while it is timed)
    compute the host-only answers (:func:`serve_expected`, a share of the
    jobs each); every response of each turn must equal its host answer
    byte for byte.  Each server's counters start at 0 with its process
    (each worker's with its own) and are read from its shutdown summary
    (a fleet's summed over its workers): the launches as
    predicted (one ``bits_spans`` per panel, one ``stats_panel`` and one
    ``windowed_stats`` per stats batch: each has one chr22 group of more
    than the device minimums), no breaker failure and no plain version on
    the card.  Reports, per front end, p50/p99 per request kind,
    requests/s, intervals/s, the device's kernel-busy and idle shares over
    the traffic window (each kernel's phase-3 time at the serving shape,
    ``kernel_ms``, times its launches here; uploads and copies back are
    not counted, so the idle share is an upper bound), the device bytes
    held and the store load, index build and feature decode seconds."""
    import concurrent.futures
    import multiprocessing

    span = (16_000_000, 42_000_000)
    t_phase = time.perf_counter()
    jobs = serve_jobs(vcf4, span, 11, mix)
    with concurrent.futures.ProcessPoolExecutor(
            SERVE_HELPERS, mp_context=multiprocessing.get_context("spawn")) as helpers:
        warm = [helpers.submit(_warm_serve_helper) for _ in range(SERVE_HELPERS)]
        chaos_reqs = chaos_jobs(span, jobs)
        runs = {fe: _serve_traffic(platform, store_dir, mix, fe, jobs, warm,
                                   chaos_reqs if fe == "aio" else None)
                for fe in SERVE_FRONTENDS}
        tick = health_tick_timing(runs["aio"]["history"][0])
        t0 = time.perf_counter()
        parts = [f.result() for f in [
            helpers.submit(serve_expected, store_dir,
                           [j for j in jobs + chaos_reqs
                            if j[0] % SERVE_HELPERS == part], mix)
            for part in range(SERVE_HELPERS)]]
        host_answers_wall = time.perf_counter() - t0
    answers = {k: v for p in parts for k, v in p["answers"].items()}
    # the chaos window's bodies (the breaker open, half-open and closed)
    # against the host-only answers
    chaos = runs["aio"]["chaos"]
    got = chaos.pop("digests")
    chaos["bodies"] = sum(len(v) for v in got.values())
    chaos["differ"] = sum(d != answers[jid][0] for jid, v in got.items() for d in v)
    assert chaos["differ"] == 0, f"chaos: {chaos['differ']} bodies differ"
    # the aio turn's --metricsOut / --traceOut: the textfile's requests by
    # kind are the client's (traffic and chaos window), its batches the
    # trace's serve.batch spans, of which the chaos window's dump held some
    exports = runs["aio"]["exports"]
    sent = {}
    for got_ in runs["aio"]["results"].values():
        for kind, _dt, _d in got_:
            sent[kind] = sent.get(kind, 0) + 1
    for kind, *_t in chaos["timeline"]:
        sent[kind] = sent.get(kind, 0) + 1
    batch_spans = exports["trace"]["spans"].get("serve.batch", 0)
    emit("serve_exports", frontend="aio", textfile_requests=exports["requests"],
         client_requests=sent, batches=exports["batches"],
         trace_batch_spans=batch_spans, trace_events=exports["trace"]["events"],
         chaos_dump_batch_spans=chaos["trace_batch_spans"],
         bodies_differ=chaos["differ"])
    assert exports["requests"] == sent, (
        f"serve exports: textfile requests {exports['requests']}, sent {sent}")
    assert exports["batches"] == batch_spans > 0, (exports["batches"], batch_spans)
    assert 0 < chaos["trace_batch_spans"] <= batch_spans, chaos["trace_batch_spans"]
    emit("health_tick", frontend="aio", **tick)
    assert tick["errors"] == 0, tick
    out = {}
    for fe, run in runs.items():
        out[fe] = _serve_check(platform, fe, run, jobs, answers, mix, kernel_ms,
                               [p["seconds"] for p in parts], host_answers_wall,
                               time.perf_counter() - t_phase)
    return {"launches": out[SERVE_FRONTENDS[0]],
            "launches_by_frontend": out, "chaos": chaos}


def _serve_traffic(platform, store_dir, mix, frontend, jobs, warm,
                   chaos_jobs_=None) -> dict:
    """One turn's server (:func:`serve_command`), the clients' traffic
    window and the server's shutdown summary (a fleet's merged over its
    workers, with ``nvidia-smi``'s used memory read in the window)."""
    t_start = time.perf_counter()
    out_path = os.path.join(WORK, f"serve.{frontend}.out")
    err_path = os.path.join(WORK, f"serve.{frontend}.err")
    env = dict(os.environ, AVDB_SERVE_BROWNOUT_P99_MS="0", PYTHONFAULTHANDLER="1")
    if frontend == "aio":  # the chaos window's routes; nothing until armed
        env["AVDB_SERVE_CHAOS"] = "1"
    workers = SERVE_FLEET_WORKERS if frontend == "fleet" else 1
    # the aio turn writes its metrics and its batch trace at shutdown
    obs = os.path.join(WORK, f"serve.{frontend}") if frontend == "aio" else None
    extra = () if obs is None else ("--metricsOut", obs + ".prom",
                                    "--traceOut", obs + ".trace.json")
    with open(out_path, "w") as out_f, open(err_path, "w") as err_f:
        proc = subprocess.Popen(serve_command(store_dir, platform, frontend,
                                              extra=extra),
                                cwd=ROOT, env=env, stdout=out_f, stderr=err_f)
    gpu_mib = chaos = None
    try:
        banner, port, ready_s = wait_serving(proc, out_path, err_path, workers)
        for f in warm:
            f.result()
        import queue
        import threading

        q = queue.Queue()
        for job in jobs:
            q.put(job)
        results, lock = {}, threading.Lock()
        t0 = time.perf_counter()
        threads = [threading.Thread(target=_serve_client,
                                    args=(port, q, results, lock, mix))
                   for _ in range(mix["clients"])]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        traffic_s = time.perf_counter() - t0
        if platform == "cuda":
            gpu_mib = gpu_memory_used_mib()
        views = fleet_health_views(port, workers) if frontend == "fleet" else None
        if chaos_jobs_ is not None:
            chaos = chaos_serve_check(
                port, chaos_jobs_, lambda: counts_so_far(proc, err_path)["launches"],
                store_dir)
    finally:
        proc.send_signal(2)  # SIGINT: the server(s) log the run summary
        try:
            rc = proc.wait(timeout=120)
        except subprocess.TimeoutExpired:
            proc.kill()
            rc = proc.wait()
    with open(err_path) as f:
        err = f.read()
    assert rc == 0, f"serve ({frontend}) exited {rc}: {err[-2000:]}"
    summary = merge_summaries(err, workers)
    exports = None
    if obs is not None:
        series = prom_series(obs + ".prom")
        exports = {"requests": {
            k.split('"')[1]: int(v) for k, v in series.items()
            if k.startswith("avdb_query_requests_total{") and v},
            "batches": series.get("avdb_serve_batches_total"),
            "trace": trace_summary(obs + ".trace.json")}
    return {"banner": banner, "ready_s": ready_s, "traffic_s": traffic_s,
            "results": results, "summary": summary, "workers": workers,
            "gpu_memory_used_mib": gpu_mib, "fleet_views": views,
            "chaos": chaos, "exports": exports,
            "history": history_docs(store_dir, workers),
            "run_s": time.perf_counter() - t_start}


def _serve_check(platform, frontend, run, jobs, answers, mix, kernel_ms,
                 host_answers_s, host_answers_wall, phase_s) -> dict:
    """Compare one front end's responses with the host answers, emit its
    numbers and check its launches; returns the launches."""
    results, summary, traffic_s = run["results"], run["summary"], run["traffic_s"]
    wrong = [(jid, kind) for jid, kind, _p in jobs
             if [d for _k, _dt, d in results.get(jid, [])] != answers[jid]]
    lat = {}
    for got in results.values():
        for kind, dt, _d in got:
            lat.setdefault(kind, []).append(dt)
    n_req = sum(len(v) for v in lat.values())
    n_int = mix["intervals"] * (mix["panels"] + mix["stats"])
    launches = summary["launches"]
    want = {"bits_spans": mix["panels"], "stats_panel": mix["stats"],
            "windowed_stats": mix["stats"], "export_pack": 0, **MESH_IDLE}
    breaker = {"open_groups": [], "groups": {}}
    chaos = run["chaos"]
    if chaos is not None:
        # the chaos window after the traffic, read apart from it: the
        # traffic's launches are the counts just before the window, and
        # nothing launched after it; every group it opened is closed again
        assert launches == chaos["counts"]["after"], (launches, chaos["counts"])
        launches = chaos["counts"]["before"]
        assert all(g == {"state": "closed", "failures": 0}
                   for g in chaos["breaker"]["groups"].values()), chaos["breaker"]
        breaker = chaos["breaker"]
    plain_cuda = {k: v.get("cuda", 0) for k, v in summary["plain_calls"].items()}
    busy_s = sum(kernel_ms.get(k, 0.0) * n for k, n in launches.items()) / 1e3
    statuses = {}
    for got in results.values():
        for _k, _dt, (status, _n, _h) in got:
            statuses[status] = statuses.get(status, 0) + 1
    emit("serve", frontend=frontend, banner=run["banner"], ready_s=run["ready_s"],
         traffic_s=traffic_s, run_s=run["run_s"], phase_s=phase_s, requests=n_req,
         requests_per_s=n_req / traffic_s, intervals=n_int,
         intervals_per_s=n_int / traffic_s, statuses=statuses,
         latency_ms={k: {"n": len(v), "p50": float(np.percentile(v, 50)) * 1e3,
                         "p99": float(np.percentile(v, 99)) * 1e3}
                     for k, v in sorted(lat.items())},
         launches=launches, predicted_launches=want, plain_cuda_calls=plain_cuda,
         breaker=summary["breaker"], kernel_busy_s=busy_s,
         device_idle_fraction_upper=1 - busy_s / traffic_s,
         workers=run["workers"],
         launches_per_worker=summary.get("launches_per_worker"),
         requests_per_worker=summary.get("requests_per_worker"),
         gpu_memory_used_mib=run["gpu_memory_used_mib"],
         device_bytes=summary["device_bytes"], store_load_s=summary["store_load_s"],
         index_build_s=summary["index_build_s"], decode_s=summary["decode_s"],
         host_answers_s=host_answers_s, host_answers_wall_s=host_answers_wall,
         mismatches=len(wrong), mismatched=wrong[:10],
         health_ticks=[len(d["samples"]) for d in run["history"]],
         health_span_s=[float(d["samples"][-1]["t"]) - float(d["samples"][0]["t"])
                        for d in run["history"]],
         health_summary=summary.get("health_per_worker", [summary.get("health")]),
         health_tick_runs_on=HEALTH_TICK_WHERE[frontend],
         fleet_views=run["fleet_views"])
    assert not wrong, (f"serve ({frontend}): {len(wrong)} responses differ from "
                       f"the host engine's, e.g. {wrong[:5]}")
    assert summary["breaker"] == breaker, summary["breaker"]
    # the default health plane ran in every process: ticks in the ring,
    # no absorbed failure, the alert states readable from the mirrors
    for h, d in zip(summary.get("health_per_worker", [summary.get("health")]),
                    run["history"]):
        assert h["errors"] == 0 and h["samples"] == len(d["samples"]) >= 1, (h, d["t"])
    views = run["fleet_views"]
    if views is not None:
        own = sum(sum(r.values()) for r in summary["requests_per_worker"])
        assert views["workers_live"] == run["workers"], views
        assert views["requests_summed"] == own, (views["requests_summed"], own)
        assert views["alerts_workers"] == [str(i) for i in range(run["workers"])], views
        assert all(s["availability"] == "ok" for s in views["alert_states"].values()), \
            views["alert_states"]
    if platform == "cuda":
        assert launches == want, f"serve ({frontend}): launches {launches}, predicted {want}"
        if chaos is not None:
            assert chaos["launches"] == CHAOS_LAUNCHES, (
                f"chaos: the closed breaker's panels launched "
                f"{chaos['launches']}, not {CHAOS_LAUNCHES}")
        assert not any(plain_cuda.values()), \
            f"serve ({frontend}): plain versions on the card: {plain_cuda}"
    return launches


#: ``GET /export/stream`` calls of phase 12
EXPORT_STREAM_CALLS = 32


def _file_digests(out_dir) -> dict:
    """sha256 of every part and the manifest of a corpus directory."""
    import hashlib

    out = {}
    for name in sorted(os.listdir(out_dir)):
        if name.endswith(".npz") or name == "corpus.manifest.json":
            with open(os.path.join(out_dir, name), "rb") as f:
                out[name] = hashlib.file_digest(f, "sha256").hexdigest()
    return out


def run_export_cli(platform, store_dir, tag, *flags) -> dict:
    """``python -m annotatedvdb_tpu_torch export --commit --seed 7`` (the
    CLI's ``main``) of the whole store into ``WORK/corpus-<tag>``, with the
    kernel's counters reset just before and read just after, and the wall
    split by stage: the store load, ``ChromPrep.build`` (index, feature
    decode, allele dictionary), the gather's padding (on the prefetch
    thread, overlapped),
    the pack (``pack_batches``, once a part: the device round trip
    ``pack_part``, once a part, or the numpy twin, once a batch, then
    ``pack_batch``, the per-row ``bin_path`` loop, once a batch), the part
    writes and the manifest.  The corpus is hashed and removed."""
    import io

    from annotatedvdb_tpu_torch.__main__ import main as port
    from annotatedvdb_tpu_torch.export import core, writer
    from annotatedvdb_tpu_torch.ops import export_pack as P
    from annotatedvdb_tpu_torch.store import VariantStore

    out = os.path.join(WORK, f"corpus-{tag}")
    shutil.rmtree(out, ignore_errors=True)
    for counts in (P.LAUNCHES, P.CALLS):
        for name in counts:
            counts[name] = 0
    stages = {"store_load": (VariantStore, "load"),
              "prep": (core.ChromPrep, "build"), "gather_pad": (core, "_pad"),
              "pack": (core, "pack_batches"), "pack_device": (P, "pack_part"),
              "pack_twin": (P, "export_pack_host"), "pack_batch": (core, "pack_batch"),
              "write_part": (writer, "write_part"), "manifest": (writer, "write_manifest")}
    sinks = {k: [] for k in stages}
    buf = io.StringIO()
    argv = ["export", "--storeDir", store_dir, "--out", out, "--commit", "--seed", "7",
            *flags, *(["--platform", "cpu"] if platform == "cpu" else [])]
    t0 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        for key, (owner, name) in stages.items():
            stack.enter_context(timed_calls(owner, name, sinks[key]))
        stack.enter_context(contextlib.redirect_stdout(buf))
        rc = port(argv)
    wall = time.perf_counter() - t0
    assert rc == 0, f"export {tag} exited {rc}"
    summary = json.loads(buf.getvalue().strip().splitlines()[-1])
    digests = _file_digests(out)
    corpus_bytes = sum(os.path.getsize(os.path.join(out, n)) for n in digests)
    shutil.rmtree(out)
    return {"wall_s": wall, "summary": summary, "digests": digests,
            "corpus_bytes": corpus_bytes, "launches": dict(P.LAUNCHES),
            "plain_calls": dict(P.CALLS),
            "stage_seconds": {k: sum(v) for k, v in sinks.items()},
            "stage_calls": {k: len(v) for k, v in sinks.items()}}


def stream_queries(index, rng, n, cap):
    """``n`` seeded ``/export/stream`` query strings over chr22's index:
    slices of 1 kb to 500 kb (halved until at most ``cap`` rows), batch
    rows log-uniform in 8..4,096, a batch index inside the slice, ordered
    and shuffled in turns."""
    lo, hi = int(index.pos[0]), int(index.pos[-1])
    out = []
    for i in range(n):
        width = int(rng.integers(1_000, 500_000))
        start = int(rng.integers(lo, max(lo + 1, hi - width)))
        while True:
            rows = int(np.searchsorted(index.pos, start + width, side="right")
                       - np.searchsorted(index.pos, start, side="left"))
            if rows <= cap:
                break
            width //= 2
        b = int(min(4096, max(8, round(2 ** rng.uniform(3, 12)))))
        batch = int(rng.integers(0, max(1, -(-rows // b))))
        out.append(f"region=22:{start}-{start + width}&batch={batch}&batch_rows={b}"
                   f"&seed={int(rng.integers(0, 1000))}&ordered={i % 2}")
    return out


def export_phase(torch, platform, store_dir, kernel_ms) -> dict:
    """Phase 12: ``export --commit --seed 7`` of phase 9's store through the
    CLI's ``main`` (:func:`run_export_cli`), once on ``platform`` and once
    with ``--hostOnly``: the corpora must be the same bytes, the plan's
    batches ``ceil(rows / 4096)`` a chromosome (predicted from the serving
    engine's interval indexes), the kernel launched once a part the plan
    writes (those batches over the plan's batches a part), no plain version
    on the card.  Then :data:`EXPORT_STREAM_CALLS`
    calls of ``stream_payload`` on a ``QueryEngine`` on ``platform`` over
    the store (seeded slices, :func:`stream_queries`), with the counters
    reset just before: one launch a call, each body equal to the
    ``host_only`` answer, no breaker failure.  Reports the walls, rows/s,
    tokens/s, the stage split, the kernel's busy share (phase 3's part ms
    times the launches) and the calls' latencies."""
    from annotatedvdb_tpu_torch.export import stream
    from annotatedvdb_tpu_torch.ops import export_pack as P
    from annotatedvdb_tpu_torch.serve.engine import QueryEngine
    from annotatedvdb_tpu_torch.serve.resilience import DeviceBreaker
    from annotatedvdb_tpu_torch.serve.snapshot import StaticSnapshots
    from annotatedvdb_tpu_torch.store import VariantStore

    t_phase = time.perf_counter()
    engine = QueryEngine(StaticSnapshots(VariantStore.load(store_dir, readonly=True)),
                         device=platform, breaker=DeviceBreaker())
    snap = engine.snapshots.current()
    index_rows = {code: engine._interval_index(snap, code).n
                  for code in sorted(snap.store.shards)}
    index = engine._interval_index(snap, 22)
    engine._stats_features(snap, 22, index)  # the decode, outside the calls
    engine_s = time.perf_counter() - t_phase
    batches = sum(-(-n // EXPORT_BATCH_ROWS) for n in index_rows.values())
    dev = run_export_cli(platform, store_dir, platform)
    host = run_export_cli(platform, store_dir, "host", "--hostOnly")
    rows = dev["summary"]["total_rows"]
    # one launch a part the plan writes: its batches over batches_per_part
    predicted = -(-batches // dev["summary"]["batches_per_part"])
    for run in (dev, host):
        s = run["summary"]
        run["rows_per_s"] = s["rows"] / run["wall_s"]
        run["tokens_per_s"] = s["tokens"] / run["wall_s"]
    busy_s = kernel_ms * dev["launches"]["export_pack"] / 1e3
    same = dev["digests"] == host["digests"]

    queries = stream_queries(index, np.random.default_rng(12), EXPORT_STREAM_CALLS,
                             stream.STREAM_MAX_ROWS)
    for counts in (P.LAUNCHES, P.CALLS):
        for name in counts:
            counts[name] = 0
    bodies, lat = [], []
    for q in queries:
        t = time.perf_counter()
        bodies.append(stream.stream_payload(engine, stream.parse_stream_query(q)))
        lat.append(time.perf_counter() - t)
    stream_launches = dict(P.LAUNCHES)
    stream_calls = dict(P.CALLS)
    wrong = [q for q, body in zip(queries, bodies)
             if stream.stream_payload(engine, stream.parse_stream_query(q),
                                      host_only=True) != body]
    emit("export", rows=rows, index_rows=index_rows, predicted_batches=batches,
         predicted_launches=predicted,
         launches=dev["launches"], plain_calls=dev["plain_calls"],
         host_launches=host["launches"], corpora_equal=same,
         parts=dev["summary"]["n_parts"], batches=dev["summary"]["n_batches"],
         corpus_bytes=dev["corpus_bytes"], kernel_busy_s=busy_s,
         kernel_busy_share=busy_s / dev["wall_s"],
         **{f"{k}_{tag}": r[k] for tag, r in (("dev", dev), ("host", host))
            for k in ("wall_s", "rows_per_s", "tokens_per_s", "stage_seconds",
                      "stage_calls")},
         summary_dev={k: dev["summary"][k] for k in (
             "seconds", "tokens_per_sec", "device_idle_frac", "queue_stalls")},
         stream_calls=len(queries), stream_launches=stream_launches,
         stream_plain_calls=stream_calls, stream_engine_s=engine_s,
         stream_ms={"p50": float(np.percentile(lat, 50)) * 1e3,
                    "p99": float(np.percentile(lat, 99)) * 1e3,
                    "sum": sum(lat) * 1e3},
         stream_rows=sum(json.loads(b)["n_valid"] for b, _n in bodies),
         stream_mismatches=len(wrong), breaker=engine.breaker.stats(),
         phase_s=time.perf_counter() - t_phase)
    assert same, "export: the card's corpus differs from --hostOnly's"
    assert dev["summary"]["complete"] and dev["summary"]["rows"] == rows \
        == sum(index_rows.values())
    assert dev["summary"]["n_batches"] == batches, (dev["summary"]["n_batches"], batches)
    assert dev["summary"]["batches_per_part"] == EXPORT_PART_BATCHES
    assert dev["summary"]["parts_written"] == predicted
    assert not wrong, f"export/stream: {len(wrong)} bodies differ from host_only, e.g. {wrong[:3]}"
    assert engine.breaker.stats() == {"open_groups": [], "groups": {}}, engine.breaker.stats()
    assert host["launches"]["export_pack"] == 0 and not any(host["plain_calls"].values())
    if platform == "cuda":
        assert dev["launches"]["export_pack"] == predicted, \
            f"export: {dev['launches']} launches, predicted {predicted}"
        assert not dev["plain_calls"]["cuda"], f"export: plain calls {dev['plain_calls']}"
        assert stream_launches["export_pack"] == len(queries), stream_launches
        assert not stream_calls["cuda"], f"export/stream: plain calls {stream_calls}"
    return {"export": dev["launches"]["export_pack"],
            "stream": stream_launches["export_pack"], "engine": engine}


def _doctor(*argv) -> tuple:
    """``python -m annotatedvdb_tpu_torch doctor argv`` through the CLI's
    ``main`` in this process: (exit code, stdout, stderr, seconds)."""
    import io

    from annotatedvdb_tpu_torch.cli import doctor

    out, err = io.StringIO(), io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = doctor.main(list(argv))
    return rc, out.getvalue(), err.getvalue(), time.perf_counter() - t0


def doctor_phase(torch, platform, store9, store6, engine) -> dict:
    """Phase 13: ``doctor`` on stores the card wrote, through the CLI's
    ``main``.  (1) ``--deep --json`` on phase 9's store: exit 0, clean.
    (2) ``status --json`` of it: its rows and groups.  (3) ``profile``
    of it: every group's summary equal to the ``/stats/region`` body over
    the whole chromosome from ``engine`` (phase 12's card engine, the
    device minimum set to one interval: one ``stats_panel`` launch).
    (4) a copy of phase 6's card store (``store6``) with its first
    segment file truncated: exit 2, then ``--repair`` exit 1, then exit 0,
    and the repaired store loads.  (5) ``replay-rejects`` of the rejects
    file a Python-engine ``load-vcf`` of :func:`rejects_vcf`'s file
    quarantined: the malformed lines back verbatim.  ``doctor`` is host
    only: the card's allocated bytes must not move during (1)-(4)."""
    from annotatedvdb_tpu_torch.cli.load_vcf import main as load_vcf
    from annotatedvdb_tpu_torch.ops import stats as stats_ops
    from annotatedvdb_tpu_torch.store import VariantStore

    t_phase = time.perf_counter()
    cuda = platform == "cuda"
    held = torch.cuda.memory_allocated() if cuda else 0
    walls = {}
    rc, out, err, walls["fsck_deep"] = _doctor("--storeDir", store9, "--deep", "--json")
    fsck9 = json.loads(out)
    assert rc == 0 and fsck9["status"] == "clean", f"doctor: phase 9's store: {out[-2000:]}"
    rc, out, err, walls["status"] = _doctor("status", "--storeDir", store9, "--json")
    status = json.loads(out)
    assert rc == 0 and status["groups"], f"doctor status: {err[-2000:]}"
    rc, out, err, walls["profile"] = _doctor("profile", "--storeDir", store9)
    assert rc == 0, f"doctor profile: {err[-2000:]}"
    profile = json.loads(out)
    moved = (torch.cuda.memory_allocated() - held) if cuda else 0
    labels = sorted(profile["groups"])
    specs = [f"{lb}:1-{min(CHR22_LENGTH, 64_000_000 - 1)}" for lb in labels]
    before = dict(stats_ops.LAUNCHES)
    minimum, engine.stats_device_min = engine.stats_device_min, 0
    try:
        t0 = time.perf_counter()
        whole = json.loads(engine.stats_serve(specs).assemble())["results"]
        walls["stats_whole"] = time.perf_counter() - t0
    finally:
        engine.stats_device_min = minimum
    stats_launches = stats_ops.LAUNCHES["stats_panel"] - before["stats_panel"]
    same = profile_matches_stats(profile["groups"], whole, labels)

    torn = os.path.join(WORK, "store.doctor")
    shutil.rmtree(torn, ignore_errors=True)
    shutil.copytree(store6, torn)
    segs = sorted(f for f in os.listdir(torn)
                  if f.startswith("chr") and f.endswith(".npz") and ".tmp" not in f)
    seg = os.path.join(torn, segs[0])
    with open(seg, "r+b") as f:
        f.truncate(os.path.getsize(seg) // 2)
    rows6 = VariantStore.load(store6, readonly=True).n
    codes, reports = [], []
    for flags in ((), ("--repair",), ("--deep",)):
        rc, out, err, walls["fsck_torn" + "".join(flags)] = _doctor(
            "--storeDir", torn, "--json", *flags)
        codes.append(rc)
        reports.append(json.loads(out))
    repaired = reports[1]
    rows_repaired = VariantStore.load(torn).n

    vcf = os.path.join(WORK, "rejects.vcf")
    made = rejects_vcf(vcf, 2000)
    rstore = os.path.join(WORK, "store.rejects")
    shutil.rmtree(rstore, ignore_errors=True)
    with environment(AVDB_INGEST_ENGINE="python"), \
            contextlib.redirect_stdout(sys.stderr):
        rc_load = load_vcf(["--fileName", vcf, "--storeDir", rstore, "--commit",
                            "--platform", platform])
    assert rc_load == 0, f"doctor phase: load-vcf of the rejects file exited {rc_load}"
    fixed = os.path.join(WORK, "fixed.vcf")
    rc_replay, _o, replay_err, walls["replay"] = _doctor(
        "replay-rejects", "--rejects",
        os.path.join(rstore, "quarantine", "rejects.vcf.rejects.jsonl"), "--out", fixed)
    with open(fixed) as f:
        replayed = f.read()
    emit("doctor", walls_s=walls, rows=status["rows"], groups=status["groups"],
         read_amp=status["read_amp"], fsck_findings=[f["code"] for f in fsck9["findings"]],
         profile_rows=profile["rows"], profile_seconds=profile["seconds"],
         profile_equals_stats=same, stats_launches=stats_launches,
         device_bytes_moved=moved, torn_segment=segs[0], torn_exit_codes=codes,
         torn_findings=sorted({f["code"] for f in reports[0]["findings"]}),
         torn_repairs=repaired["repairs"], rows_before=rows6,
         rows_after_repair=rows_repaired, replay_exit=rc_replay,
         replay_lines=len(made["bad"]), replay_equal=replayed == "".join(made["bad"]),
         replay_message=replay_err.strip(), phase_s=time.perf_counter() - t_phase)
    assert same, "doctor profile: a group differs from the whole-chromosome /stats/region"
    assert profile["rows"] == status["rows"] == sum(g["count"] for g in whole)
    assert not moved, f"doctor: {moved} bytes allocated on the card"
    if cuda:
        assert stats_launches == len(specs), f"doctor: {stats_launches} stats launches"
    assert codes == [2, 1, 0], f"doctor: torn copy exit codes {codes}"
    assert rows_repaired < rows6, (rows_repaired, rows6)
    assert rc_replay == 0 and replayed == "".join(made["bad"]), replay_err
    return {"stats_launches": stats_launches}


# ------------------------------------------------- write path (phase 14)

#: phase 14: one upsert a window of ``UPSERT_STARTS``, ``UPSERT_ROWS`` rows
#: into chr22, half of them identities the store lacks and half rows it
#: holds, each into its own ``UPSERT_WINDOW``-bp window and read back
#: through ``UPSERT_INTERVALS`` intervals tiling that window
#: (``UPSERT_STATS_WINDOWS`` stats windows); the first ``UPSERT_BEFORE_KILL``
#: go in before the worker holding them is killed, the last one crosses the
#: flush bound (three windows until the compaction and the follower joined
#: the phase; the second was cut to keep the smoke's wall)
UPSERT_ROWS = 2048
UPSERT_BEFORE_KILL = 1
UPSERT_WINDOW = 200_000
UPSERT_INTERVALS = 64
UPSERT_STATS_WINDOWS = 4
UPSERT_WORKERS = 2
#: window starts on chr22, inside phase 4's positions
UPSERT_STARTS = (17_000_000, 20_000_000)
#: appended to a stored line's REF to make a new identity: an insertion
#: no generated line carries
UPSERT_INSERT = "TTGACCAGTC"


def window_lines(vcf, starts, window, width=49) -> list:
    """For each window ``[start, start + window)``: the (position, ref,
    first alt) of the VCF's data lines there, one a position, whose
    alleles are plain bases and fit the width with room for
    :data:`UPSERT_INSERT`."""
    bounds = [(s, s + window) for s in starts]
    out = [dict() for _ in starts]
    with open(vcf) as f:
        for ln in f:
            if ln[:1] == "#":
                continue
            chrom, pos, _vid, ref, alt_col = ln.split("\t", 5)[:5]
            if chrom != "22" or not pos.isdigit():
                continue
            p = int(pos)
            for k, (lo, hi) in enumerate(bounds):
                if lo <= p < hi and p not in out[k]:
                    alt = alt_col.split(",")[0]
                    if (alt != "." and set(ref + alt) <= set("ACGT")
                            and len(ref) + len(UPSERT_INSERT) <= width
                            and len(alt) <= width):
                        out[k][p] = (p, ref, alt)
    return [sorted(d.values()) for d in out]


def upsert_batches(lines, starts, rows=UPSERT_ROWS, window=UPSERT_WINDOW,
                   intervals=UPSERT_INTERVALS, seed=14) -> list:
    """One upsert body per window (:func:`window_lines`): ``rows / 2`` new
    identities (the stored line's REF to REF + :data:`UPSERT_INSERT`, an
    rs id, a CADD phred and an ``other_annotation``) and ``rows / 2``
    identities the store holds (with an annotation that must stay
    shadowed), shuffled; and the window's tiling intervals."""
    rng = np.random.default_rng(seed)
    out = []
    for k, (start, cand) in enumerate(zip(starts, lines)):
        assert len(cand) >= rows, f"window {start}: {len(cand)} lines"
        pick = rng.permutation(len(cand))[:rows]
        new = [cand[i] for i in pick[: rows // 2]]
        old = [cand[i] for i in pick[rows // 2:]]
        variants = [{"id": f"22:{p}:{r}:{r + UPSERT_INSERT}",
                     "ref_snp": 900_000_000 + k * rows + i,
                     "annotations": {
                         "cadd_scores": {"CADD_phred":
                                         round(float(rng.uniform(0, 40)), 3)},
                         "other_annotation": {"upsert": k}}}
                    for i, (p, r, _a) in enumerate(new)]
        variants += [{"id": f"22:{p}:{r}:{a}",
                      "annotations": {"other_annotation": {"shadowed": k}}}
                     for p, r, a in old]
        order = rng.permutation(len(variants))
        step = window // intervals
        out.append({
            "body": {"variants": [variants[i] for i in order.tolist()]},
            "new_pos": np.asarray(sorted(p for p, _r, _a in new)),
            "new_ids": [v["id"] for v in variants[: rows // 2]],
            "specs": [f"22:{start + i * step}-{start + (i + 1) * step - 1}"
                      for i in range(intervals)],
        })
    return out


def upsert_bytes(batch, width) -> int:
    """The bytes a worker's memtable adds for ``batch``'s new rows (the
    memtable's own count, on a scratch memtable with no base store)."""
    from annotatedvdb_tpu_torch.serve.engine import parse_variant_id
    from annotatedvdb_tpu_torch.store.memtable import Memtable

    parsed = []
    for v in batch["body"]["variants"]:
        if v["id"] not in batch["new_ids"]:
            continue
        code, pos, ref, alt = parse_variant_id(v["id"])
        parsed.append({"code": code, "pos": pos, "ref": ref, "alt": alt,
                       "ref_snp": v.get("ref_snp"), "ann": v.get("annotations")})
    mem = Memtable(width=width, flush_bytes=0, flush_age_s=0)
    mem.upsert(None, parsed, durable=False)
    return mem.nbytes


class _Conn:
    """One keep-alive connection (one fleet worker: read-your-writes is
    per worker) with timed JSON calls."""

    def __init__(self, port):
        import http.client

        self.c = http.client.HTTPConnection("127.0.0.1", port, timeout=300)

    def call(self, method, path, body=None) -> tuple:
        t = time.perf_counter()
        self.c.request(method, path,
                       body=None if body is None else json.dumps(body).encode())
        resp = self.c.getresponse()
        raw = resp.read()
        return resp.status, raw, time.perf_counter() - t

    def close(self):
        self.c.close()


def _region_counts(raw) -> list:
    return [e["count"] for e in json.loads(raw)["results"]]


def upsert_expected(store_dir, batches, windows=UPSERT_STATS_WINDOWS) -> dict:
    """Host-only answers over the flushed store (a CPU engine, every group
    below the device minimums): per batch the count-only ``/regions``,
    ``/regions`` with three rows an interval and ``/stats/region`` bodies,
    generation scrubbed.  Runs in a spawned helper process."""
    from annotatedvdb_tpu_torch.serve.engine import QueryEngine
    from annotatedvdb_tpu_torch.serve.snapshot import StaticSnapshots
    from annotatedvdb_tpu_torch.store import VariantStore

    t0 = time.perf_counter()
    engine = QueryEngine(StaticSnapshots(VariantStore.load(store_dir, readonly=True)),
                         device="cpu", regions_device_min=1 << 30,
                         stats_device_min=1 << 30)
    out = []
    for b in batches:
        out.append([_scrub(engine.regions_serve(b["specs"], limit=0).assemble().encode()),
                    _scrub(engine.regions_serve(b["specs"], limit=3).assemble().encode()),
                    _scrub(engine.stats_serve(b["specs"], windows=windows)
                           .assemble().encode())])
    return {"bodies": out, "seconds": time.perf_counter() - t0}


def _scrub(raw: bytes) -> bytes:
    """A body with its generation numbers masked: an overlay generation
    is remapped, a host engine's is 1."""
    import re

    return re.sub(rb'"generation":\d+', b'"generation":0', raw)


def _upsert_reads(conn, batch, want_counts, sent) -> tuple:
    """The count-only ``/regions`` and the ``/stats/region`` reads over a
    batch's window on ``conn``: both must count ``want_counts``; returns
    the ``/regions`` call's seconds and both bodies, generation masked."""
    st, raw, dt = conn.call("POST", "/regions", {"regions": batch["specs"], "limit": 0})
    assert st == 200, raw[:500]
    got = _region_counts(raw)
    assert got == want_counts, f"upsert: /regions counts {got[:8]} != {want_counts[:8]}"
    st, raw_s, _dt = conn.call("POST", "/stats/region",
                               {"regions": batch["specs"], "windows": UPSERT_STATS_WINDOWS})
    assert st == 200, raw_s[:500]
    got = [e["count"] for e in json.loads(raw_s)["results"]]
    assert got == want_counts, f"upsert: stats counts {got[:8]} != {want_counts[:8]}"
    sent["regions"] += 1
    sent["stats"] += 1
    return dt, [_scrub(raw), _scrub(raw_s)]


def _wait_for(what, test, timeout=300.0, step=0.1):
    t0 = time.perf_counter()
    while True:
        got = test()
        if got:
            return got, time.perf_counter() - t0
        assert time.perf_counter() - t0 < timeout, f"upsert: timed out waiting for {what}"
        time.sleep(step)


#: phase 14's maintenance daemon tick and the follower's tail poll (s)
MAINTAIN_TICK_S = "0.5"
FOLLOW_POLL_S = "0.2"


def batch_reads(batch) -> list:
    """A batch's count-only and three-row ``/regions`` and its
    ``/stats/region`` request (path, body): the bodies the fleet and the
    follower are held to against the host-only engine."""
    return [("/regions", {"regions": batch["specs"], "limit": 0}),
            ("/regions", {"regions": batch["specs"], "limit": 3}),
            ("/stats/region", {"regions": batch["specs"],
                               "windows": UPSERT_STATS_WINDOWS})]


def link_store(store_dir, dest) -> int:
    """A hard-linked copy of the store ``store_dir``'s manifest describes
    now: segment files are immutable, so the copy stays the flushed store
    while the maintenance daemon compacts the original and removes its
    files.  Returns the copy's bytes."""
    from annotatedvdb_tpu_torch.store.replication import manifest_segment_files

    shutil.rmtree(dest, ignore_errors=True)
    os.makedirs(dest)
    mpath = os.path.join(store_dir, "manifest.json")
    with open(mpath, "rb") as f:
        blob = f.read()
    files = manifest_segment_files(json.loads(blob))
    for name in files:
        os.link(os.path.join(store_dir, name), os.path.join(dest, name))
    with open(mpath, "rb") as f:
        assert f.read() == blob, "upsert: the store changed while it was being linked"
    with open(os.path.join(dest, "manifest.json"), "wb") as f:
        f.write(blob)
    return sum(rec["bytes"] for rec in files.values())


class _Follower:
    """Phase 14's replication follower: ``serve --follow`` (``aio``, one
    process) on an empty directory, tailing the leader fleet."""

    def __init__(self, platform, leader_port):
        self.dir = os.path.join(WORK, "follower14")
        shutil.rmtree(self.dir, ignore_errors=True)
        self.out = os.path.join(WORK, "follower14.out")
        self.err = os.path.join(WORK, "follower14.err")
        self.url = f"http://127.0.0.1:{leader_port}"
        env = dict(os.environ, AVDB_REPL_POLL_S=FOLLOW_POLL_S,
                   AVDB_SERVE_BROWNOUT_P99_MS="0", PYTHONFAULTHANDLER="1")
        self.sent = {"regions": 0, "stats": 0}
        self.t0 = time.perf_counter()
        self.t0_wall = time.time()
        with open(self.out, "w") as out_f, open(self.err, "w") as err_f:
            self.proc = subprocess.Popen(
                serve_command(self.dir, platform, "aio", extra=["--follow", self.url]),
                cwd=ROOT, env=env, stdout=out_f, stderr=err_f)
        self.conn = None

    def err_text(self) -> str:
        with open(self.err) as f:
            return f.read()

    def swaps(self) -> int:
        return self.err_text().count("snapshot swapped")

    def bootstrapped(self) -> dict:
        """Wait for the bootstrap: its seconds run from the process's start
        to its manifest mirror's write (the mirror lands last), its bytes
        are the directory's then."""
        mpath = os.path.join(self.dir, "manifest.json")
        _wait_for("the follower's bootstrap",
                  lambda: os.path.exists(mpath) or self.proc.poll() is not None,
                  step=0.05)
        assert self.proc.poll() is None, f"follower exited: {self.err_text()[-2000:]}"
        return {"bootstrap_s": os.stat(mpath).st_mtime - self.t0_wall,
                "bootstrap_bytes": sum(os.path.getsize(os.path.join(self.dir, n))
                                       for n in os.listdir(self.dir))}

    def ready(self) -> float:
        """Wait for the banner; returns the seconds since the start."""
        _banner, port, _s = wait_serving(self.proc, self.out, self.err)
        self.conn = _Conn(port)
        return time.perf_counter() - self.t0

    def lag_s(self) -> float:
        import re

        st, raw, _dt = self.conn.call("GET", "/metrics")
        assert st == 200, raw[:300]
        return float(re.search(rb"^avdb_replication_lag_seconds (\S+)$", raw,
                               re.M).group(1))

    def match(self, reqs, want, what, timeout=300.0) -> float:
        """Poll the first read of ``reqs`` until its body (generation
        masked) equals its ``want``, then each later one likewise: only
        the first polls, so a generation the follower has not yet applied
        costs no feature decode behind ``/stats/region``.  Returns the
        seconds it took."""
        t0 = time.perf_counter()
        for (path, body), w in zip(reqs, want):
            def equal(path=path, body=body, w=w):
                st, raw, _dt = self.conn.call("POST", path, body)
                self.sent["regions" if path == "/regions" else "stats"] += 1
                return st == 200 and _scrub(raw) == w

            _wait_for(f"the follower to serve {what}", equal, timeout, step=0.05)
        return time.perf_counter() - t0


def _doctor_verb(*argv) -> tuple:
    """(exit code, stdout, stderr, seconds) of the port's ``doctor``
    ``main`` run in this process."""
    import io

    from annotatedvdb_tpu_torch.cli.doctor import main as doctor_main

    out, err = io.StringIO(), io.StringIO()
    t = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = doctor_main(list(argv))
    return rc, out.getvalue(), err.getvalue(), time.perf_counter() - t


def health_doctor(store_dir, killed) -> dict:
    """Phase 14's health-plane verbs on the leader's store after its
    stop: ``doctor flight --json`` (the newest harvested black box is the
    SIGKILLed worker's, with its last requests), ``doctor slo --json``
    (its harvested history replays, beside every live mirror) and
    ``doctor trace --out`` (the daemon's ``ledger.compact`` span and its
    lifecycle events on the supervisor's ring); each exits 0.  Returns
    what the checks read and each verb's wall."""
    rc, out, err, flight_s = _doctor_verb("flight", "--storeDir", store_dir, "--json")
    assert rc == 0, f"doctor flight: {rc} {err[-2000:]}"
    boxes = json.loads(out)
    box = boxes["harvested"][0]
    kinds = sorted({e["kind"] for e in box["events"] if e["type"] == "request"})
    assert box["meta"]["worker"] == killed and box["meta"]["reason"] == "died rc=-9", \
        box["meta"]
    assert "upsert" in kinds, kinds
    rc, out, err, slo_s = _doctor_verb("slo", "--storeDir", store_dir, "--json")
    assert rc == 0, f"doctor slo: {rc} {err[-2000:]}"
    reps = json.loads(out)["replays"]
    dead = [r for r in reps if r["harvested"]]
    assert [r["worker"] for r in dead] == [killed], [r["path"] for r in reps]
    trace = os.path.join(WORK, "trace14.json")
    rc, _out, err, trace_s = _doctor_verb("trace", "--storeDir", store_dir, "--out", trace)
    assert rc == 0, f"doctor trace: {rc} {err[-2000:]}"
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    os.unlink(trace)
    compacts = [e for e in events if e["name"] == "ledger.compact"]
    lifecycle = sorted({e["args"]["detail"].split(" (")[0] for e in events
                        if e.get("ph") == "i" and e["name"] == "maintain"})
    spans = sorted({e["args"]["detail"].split(" ")[0] for e in events
                    if e.get("ph") == "i" and e["name"] == "background"})
    assert len(compacts) == 1 and "pass committed" in lifecycle, (compacts, lifecycle)
    return {"flight_s": flight_s, "slo_s": slo_s, "trace_s": trace_s,
            "harvested_boxes": len(boxes["harvested"]), "live_rings": len(boxes["rings"]),
            "killed_box_events": len(box["events"]), "killed_box_request_kinds": kinds,
            "slo_replays": len(reps), "slo_killed_ticks": dead[0]["ticks"],
            "slo_killed_alerts": {a["slo"]: a["state"] for a in dead[0]["alerts"]},
            "trace_events": len(events), "trace_compact_s": compacts[0]["dur"] / 1e6,
            "trace_maintain_events": lifecycle, "trace_background_spans": spans}


def upsert_phase(platform, store_dir, vcf, starts=UPSERT_STARTS, rows=UPSERT_ROWS,
                 workers=UPSERT_WORKERS) -> dict:
    """Phase 14: ``serve --workers 2 --upserts --maintain`` on phase 9's
    store, the memtable's flush bound (``AVDB_MEMTABLE_BYTES``) set
    between the bytes of the first :data:`UPSERT_BEFORE_KILL` upserts and
    those of all of them, the age trigger off, and the maintenance
    daemon's high watermark (``AVDB_MAINTAIN_SEGMENTS_HIGH``) one above
    the chr22 group's segment files, so the flush trips it.  Beside it,
    once the leader is ready, a follower (``serve --follow``, ``aio``, one
    process) bootstraps into an empty directory and tails it.

    (1) On one keep-alive connection (one worker): each upsert
    acknowledged with half its rows accepted and half shadowed, then a
    count-only ``/regions`` and a ``/stats/region`` over its window, both
    counting the window's stored rows plus the new ones.  (2) The
    read-after-upsert latency and the ack latency.  (3) The worker whose
    WAL holds the records is SIGKILLed; the supervisor respawns it, it
    replays the rows, and on a connection to it the new rows' point
    bodies and the reads are the ones served before the kill.  Then the
    follower (its start-up overlapped the upserts and the respawn) must
    serve the same two bodies (generation masked): the seconds from each
    ack to that, its replication lag then.  (4) The last upsert crosses
    the bound; the follower serves its rows from the WAL tail; the flush
    commits (the manifest's chr22 rows grow by every new row: the store
    is hard-linked aside at once for a spawned host-only helper; then the
    worker's WAL holds no record), and the follower re-syncs onto the
    flushed cut.  (5) The flush trips the daemon, which compacts the chr22 group
    while both workers serve: its ledger record (files, bytes, rows,
    dropped duplicates, seconds), then each worker's swap onto the
    compacted generation and the follower's re-sync onto it.  (6) Each
    window's count-only and three-row ``/regions`` and ``/stats/region``
    bodies from the fleet (fresh connections) and from the follower equal
    the host-only engine's over the flushed store (generation masked); an
    upsert to the follower answers 403 with the leader's location.
    (7) After a clean stop of both, ``doctor promote`` seals the follower,
    and ``doctor --deep`` finds both stores clean.  The workers' launches
    are read from their shutdown summaries: the killed incarnation's are
    lost, so they must equal the reads sent after the kill; the
    follower's equal the reads sent to it."""
    import concurrent.futures
    import multiprocessing
    import re
    import signal

    from annotatedvdb_tpu_torch.store.compact import segment_spans
    from annotatedvdb_tpu_torch.store.wal import count_records, is_wal_file

    assert len(starts) == UPSERT_BEFORE_KILL + 1, starts
    t_phase = time.perf_counter()
    with open(os.path.join(store_dir, "manifest.json")) as f:
        manifest = json.load(f)
    width, rows22 = int(manifest["width"]), int(manifest["stats"]["rows"]["22"])
    spans = segment_spans(store_dir)
    files22 = spans["22"]
    # the flush of chr22 alone must trip the daemon
    assert all(n <= files22 for n in spans.values()), spans
    batches = upsert_batches(window_lines(vcf, starts, UPSERT_WINDOW, width), starts,
                             rows, UPSERT_WINDOW)
    sizes = [upsert_bytes(b, width) for b in batches]
    bound = sum(sizes[:UPSERT_BEFORE_KILL]) + sizes[UPSERT_BEFORE_KILL] // 2
    env = dict(os.environ, AVDB_MEMTABLE_BYTES=str(bound), AVDB_MEMTABLE_FLUSH_S="0",
               AVDB_SERVE_BROWNOUT_P99_MS="0", PYTHONFAULTHANDLER="1",
               AVDB_MAINTAIN_SEGMENTS_HIGH=str(files22 + 1),
               AVDB_MAINTAIN_TICK_S=MAINTAIN_TICK_S)
    out_path = os.path.join(WORK, "upsert.out")
    err_path = os.path.join(WORK, "upsert.err")
    flushed = os.path.join(WORK, "flushed14")

    def err_text():
        with open(err_path) as f:
            return f.read()

    def worker_lines():
        with open(out_path) as f:
            return sum(ln.startswith("worker ") for ln in f)

    sent = {"regions": 0, "stats": 0}
    timing = {}
    follow = {"upserts": []}
    with concurrent.futures.ProcessPoolExecutor(
            1, mp_context=multiprocessing.get_context("spawn")) as helper:
        warm = helper.submit(_warm_serve_helper)
        with open(out_path, "w") as out_f, open(err_path, "w") as err_f:
            proc = subprocess.Popen(
                serve_command(store_dir, platform, "fleet", workers,
                              ["--upserts", "--maintain"]),
                cwd=ROOT, env=env, stdout=out_f, stderr=err_f)
        gpu_mib = None
        follower = None
        served_ok = False
        try:
            _banner, port, timing["ready_s"] = wait_serving(proc, out_path, err_path,
                                                            workers)
            assert f"maintain: daemon armed (high {files22 + 1} /" in err_text(), \
                err_text()[-2000:]
            follower = _Follower(platform, port)
            warm.result()
            conn = _Conn(port)
            base = []
            for b in batches:
                st, raw, _dt = conn.call("POST", "/regions",
                                         {"regions": b["specs"], "limit": 0})
                assert st == 200, raw[:500]
                base.append(_region_counts(raw))

            def want(k):
                lo = np.asarray([int(sp.split(":")[1].split("-")[0])
                                 for sp in batches[k]["specs"]])
                hi = np.asarray([int(sp.split("-")[1]) for sp in batches[k]["specs"]])
                p = batches[k]["new_pos"]
                added = (np.searchsorted(p, hi, side="right")
                         - np.searchsorted(p, lo, side="left"))
                return [int(a + b) for a, b in zip(base[k], added.tolist())]

            ack_s, read_s = [], []

            def follower_reads(k, bodies, t_commit, what):
                reqs = batch_reads(batches[k])
                follower.match([reqs[0], reqs[2]], bodies, what)
                return {"batch": k, "what": what,
                        "commit_to_serving_s": time.perf_counter() - t_commit,
                        "lag_s": follower.lag_s()}

            def upsert(conn, k):
                st, raw, dt = conn.call("POST", "/variants/upsert", batches[k]["body"])
                t_ack = time.perf_counter()
                ack = json.loads(raw)
                assert st == 200 and ack["accepted"] == rows // 2 \
                    and ack["shadowed"] == rows - rows // 2, f"upsert {k}: {st} {raw[:300]}"
                ack_s.append(dt)
                dt_read, bodies = _upsert_reads(conn, batches[k], want(k), sent)
                read_s.append(dt_read)
                return t_ack, bodies

            acked = [upsert(conn, k) for k in range(UPSERT_BEFORE_KILL)]
            # a bootstrap cut short by the kill below would end the
            # follower (as in the reference): let it land first
            follow.update(follower.bootstrapped())
            held = [f for f in os.listdir(store_dir) if is_wal_file(f)
                    and count_records(os.path.join(store_dir, f))]
            assert len(held) == 1, f"upsert: WAL files with records {held}"
            idx = int(re.match(r"serve-w(\d+)\.", held[0]).group(1))
            probes = [batches[k]["new_ids"][0] for k in range(UPSERT_BEFORE_KILL)]
            before = [conn.call("GET", f"/variant/{v}")[:2] for v in probes]
            assert all(st == 200 for st, _b in before), before
            conn.close()
            pid = int(re.findall(rf"worker {idx}: pid (\d+)", err_text())[0])
            sent = {"regions": 0, "stats": 0}  # the killed incarnation's are lost
            ready_before = worker_lines()
            # request summaries reach the flight ring within a flush
            # interval (0.25 s): the killed worker's last ones are on it
            time.sleep(0.6)
            t_kill = time.perf_counter()
            os.kill(pid, signal.SIGKILL)
            replayed = rows // 2 * UPSERT_BEFORE_KILL
            _wait_for("the respawn's replay", lambda: (
                len(re.findall(rf"worker {idx}: pid", err_text())) >= 2
                and f"wal: replayed {replayed} acknowledged" in err_text()
                and worker_lines() > ready_before))
            timing["respawn_s"] = time.perf_counter() - t_kill
            # the supervisor harvested the dead worker's black box and
            # history before the respawn truncated its ring
            harvested = {d: sorted(glob.glob(os.path.join(store_dir, d, f"*-w{idx}.{x}")))
                         for d, x in (("flight", "jsonl"), ("history", "json"))}
            assert all(len(v) == 1 for v in harvested.values()), harvested

            def on_holder():
                c = _Conn(port)
                if c.call("GET", f"/variant/{probes[0]}")[0] == 200:
                    return c
                c.close()
                return None

            conn, _s = _wait_for("a connection to the respawned worker", on_holder,
                                 timeout=60, step=0.0)
            after = [conn.call("GET", f"/variant/{v}")[:2] for v in probes]
            assert after == before, "upsert: replayed rows differ from the acked ones"
            replay_bodies = [_upsert_reads(conn, batches[k], want(k), sent)[1]
                             for k in range(UPSERT_BEFORE_KILL)]
            assert replay_bodies == [b for _t, b in acked], \
                "upsert: the respawned worker's reads differ from the acked ones"
            # the follower started with the leader; its start-up overlaps
            # the upserts and the respawn (its bodies over those windows
            # stay the same until the flush)
            follow["ready_s"] = follower.ready()
            for k, (t_ack, bodies) in enumerate(acked):
                follow["upserts"].append(follower_reads(k, bodies, t_ack, f"upsert {k}"))
            t_flush = time.perf_counter()
            swaps_before = follower.swaps()
            total_new = rows // 2 * len(batches)

            def committed():
                with open(os.path.join(store_dir, "manifest.json")) as f:
                    return json.load(f)["stats"]["rows"]["22"] == rows22 + total_new

            link = {}

            def link_at_commit():
                # the flushed store, linked aside at the flush's manifest
                # commit: the daemon's pass starts there and removes its
                # files at its end; the host-only answers are computed
                # over the copy
                try:
                    _wait_for("the flush's manifest commit", committed, step=0.02)
                    link["t"] = time.perf_counter()
                    link["bytes"] = link_store(store_dir, flushed)
                except Exception as err:  # re-raised below
                    link["err"] = err

            linker = threading.Thread(target=link_at_commit, daemon=True)
            t_ack, bodies = upsert(conn, UPSERT_BEFORE_KILL)
            linker.start()
            follow["upserts"].append(follower_reads(
                UPSERT_BEFORE_KILL, bodies, t_ack, f"upsert {UPSERT_BEFORE_KILL}"))

            def poked(test):
                # a health probe on a fresh connection each poll lets the
                # worker it lands on see the commit and start loading the
                # new generation while the flush finishes
                def probe():
                    c = _Conn(port)
                    try:
                        c.call("GET", "/healthz")
                    finally:
                        c.close()
                    return test()
                return probe

            def wal_empty():
                return not sum(count_records(os.path.join(store_dir, f))
                               for f in os.listdir(store_dir) if is_wal_file(f))

            _wait_for("the flush's manifest commit", poked(lambda: len(link) > 1))
            linker.join()
            if "err" in link:
                raise link["err"]
            t_commit, flushed_bytes = link["t"], link["bytes"]
            host = helper.submit(upsert_expected, flushed, batches)
            _wait_for("the flush's WAL truncation", poked(wal_empty))
            timing["flush_s"] = time.perf_counter() - t_flush
            conn.close()
            _wait_for("the follower's re-sync onto the flushed cut",
                      lambda: follower.swaps() > swaps_before)
            follow["flush_resync_s"] = time.perf_counter() - t_commit
            follow["upserts"].append(follower_reads(
                UPSERT_BEFORE_KILL, bodies, t_commit, "the flushed cut"))
            time.sleep(0.3)  # one snapshot TTL (250 ms)
            every = [b["new_ids"][-1] for b in batches]

            def all_serve():
                for _ in range(16):
                    c = _Conn(port)
                    try:
                        if any(c.call("GET", f"/variant/{v}")[0] != 200 for v in every):
                            return False
                    finally:
                        c.close()
                return True

            _ok, timing["all_workers_s"] = _wait_for("every worker serving the rows",
                                                     all_serve, timeout=120, step=0.2)

            # (5) the daemon's pass: committed under the live fleet, then
            # each worker's swap onto the compacted generation
            ledger = os.path.join(store_dir, "ledger.jsonl")
            swaps_follower = follower.swaps()
            _ok, timing["compact_wait_s"] = _wait_for(
                "the maintenance daemon's compaction",
                lambda: ledger_records(store_dir, "compact")
                or "maintain: pass failed" in err_text(), timeout=600, step=0.2)
            t_compacted = time.perf_counter()
            timing["flush_to_compaction_s"] = t_compacted - t_commit
            compacted = ledger_records(store_dir, "compact")
            assert len(compacted) == 1, f"upsert: compaction: {err_text()[-3000:]}"
            compacted = compacted[0]
            assert compacted["labels"] == ["22"], compacted
            spans_after = segment_spans(store_dir)
            assert spans_after["22"] == 1, spans_after
            marker = "maintain: compact: merged"
            refresh = []

            def workers_swapped():
                c = _Conn(port)
                try:
                    c.call("GET", "/healthz")
                finally:
                    c.close()
                text = err_text()
                tail = text.split(marker, 1)[1] if marker in text else ""
                n = tail.count("snapshot swapped")
                while len(refresh) < n:
                    refresh.append(time.perf_counter() - t_compacted)
                return n >= workers

            _wait_for("both workers' swap onto the compacted generation",
                      workers_swapped, timeout=600, step=0.1)
            _wait_for("the follower's re-sync onto the compacted cut",
                      lambda: follower.swaps() > swaps_follower, timeout=600)
            follow["compact_resync_s"] = time.perf_counter() - t_compacted
            # (6) every window's bodies, from the fleet and the follower
            expected = host.result()
            fleet, on_follower = [], []
            for k, b in enumerate(batches):
                c = _Conn(port)
                got = []
                for path, body in batch_reads(b):
                    st, raw, _dt = c.call("POST", path, body)
                    assert st == 200, raw[:500]
                    sent["regions" if path == "/regions" else "stats"] += 1
                    got.append(_scrub(raw))
                c.close()
                fleet.append(got)
                t = time.perf_counter()
                follower.match(batch_reads(b), expected["bodies"][k],
                               f"window {k} of the compacted cut")
                on_follower.append(time.perf_counter() - t)
            st, raw, _dt = follower.conn.call(
                "POST", "/variants/upsert", batches[0]["body"])
            follow["upsert_status"] = st
            assert st == 403 and json.loads(raw)["leader"] == follower.url, \
                f"follower upsert: {st} {raw[:300]}"
            if platform == "cuda":
                gpu_mib = gpu_memory_used_mib()
            served_ok = True
        finally:
            promoting = None
            if follower is not None:
                if follower.conn is not None:
                    follower.conn.close()
                follower.proc.send_signal(2)
                try:
                    rc_f = follower.proc.wait(timeout=120)
                except subprocess.TimeoutExpired:
                    follower.proc.kill()
                    rc_f = follower.proc.wait()
            if follower is not None and served_ok:
                # (7) doctor promote of the stopped follower, beside the
                # leader's stop
                promoting = subprocess.Popen(
                    [sys.executable, "-m", "annotatedvdb_tpu_torch", "doctor",
                     "promote", "--storeDir", follower.dir, "--json"],
                    cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                    text=True)
                t_promote = time.perf_counter()
            proc.send_signal(2)
            try:
                rc = proc.wait(timeout=120)
            except subprocess.TimeoutExpired:
                proc.kill()
                rc = proc.wait()
        # then doctor --deep of both stores, beside the host answers' helper
        t_doc = time.perf_counter()
        deep = ["doctor", "--deep", "--json", "--storeDir"]
        doc_procs = [subprocess.Popen(
            [sys.executable, "-m", "annotatedvdb_tpu_torch", *deep, store_dir],
            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)]
        try:
            promote_out, promote_err = promoting.communicate(timeout=600)
            rc_p, promote_s = promoting.returncode, time.perf_counter() - t_promote
            doc_procs.append(subprocess.Popen(
                [sys.executable, "-m", "annotatedvdb_tpu_torch", *deep, follower.dir],
                cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
            # the health plane's doctor verbs on the leader's store, in
            # this process while the two --deep runs go on
            health = health_doctor(store_dir, idx)
            docs = [p.communicate(timeout=600) for p in doc_procs]
        finally:
            for p in doc_procs + [promoting]:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        rc_docs, doctor_s = [p.returncode for p in doc_procs], time.perf_counter() - t_doc
    err = err_text()
    assert rc == 0, f"upsert fleet exited {rc}: {err[-2000:]}"
    assert rc_f == 0, f"follower exited {rc_f}: {follower.err_text()[-2000:]}"
    wrong = [(k, j) for k, (f, h) in enumerate(zip(fleet, expected["bodies"]))
             for j, (a, b) in enumerate(zip(f, h)) if a != b]
    wal_left = sorted(f for f in os.listdir(store_dir) if is_wal_file(f))
    summary = merge_summaries(err, workers)
    launches = summary["launches"]
    predicted = {"bits_spans": sent["regions"], "stats_panel": sent["stats"],
                 "windowed_stats": sent["stats"], "export_pack": 0, **MESH_IDLE}
    plain_cuda = {k: v.get("cuda", 0) for k, v in summary["plain_calls"].items()}
    f_summary = merge_summaries(follower.err_text(), 1)
    f_predicted = {"bits_spans": follower.sent["regions"],
                   "stats_panel": follower.sent["stats"],
                   "windowed_stats": follower.sent["stats"], "export_pack": 0,
                   **MESH_IDLE}
    f_plain_cuda = {k: v.get("cuda", 0) for k, v in f_summary["plain_calls"].items()}
    assert all(out.strip() for out, _e in docs), \
        f"upsert: doctor --deep printed nothing: {[e[-2000:] for _o, e in docs]}"
    doc, doc_f = (json.loads(out) for out, _e in docs)
    assert rc_p == 0, f"doctor promote: {promote_err[-2000:]}"
    promoted = json.loads(promote_out)
    emit("upsert", workers=workers, rows_per_upsert=rows, upserts=len(batches),
         accepted_per_upsert=rows // 2, memtable_bound_bytes=bound,
         memtable_bytes_per_upsert=sizes, ready_s=timing["ready_s"],
         ack_ms=[dt * 1e3 for dt in ack_s],
         read_after_upsert_ms={"n": len(read_s),
                               "p50": float(np.percentile(read_s, 50)) * 1e3,
                               "p99": float(np.percentile(read_s, 99)) * 1e3,
                               "each": [dt * 1e3 for dt in read_s]},
         killed_worker=idx, replayed_rows=replayed, respawn_s=timing["respawn_s"],
         flush_s=timing["flush_s"], all_workers_s=timing["all_workers_s"],
         flushed_store_bytes=flushed_bytes,
         host_answers_s=expected["seconds"], bodies=3 * len(batches),
         mismatches=len(wrong), wal_files_left=wal_left, launches=launches,
         predicted_launches=predicted, launches_per_worker=summary["launches_per_worker"],
         requests_per_worker=summary["requests_per_worker"],
         plain_cuda_calls=plain_cuda, device_bytes=summary["device_bytes"],
         gpu_memory_used_mib=gpu_mib, decode_s=summary["decode_s"],
         index_build_s=summary["index_build_s"], doctor_deep_s=doctor_s,
         doctor_status=doc["status"], phase_s=time.perf_counter() - t_phase)
    emit("health", killed_worker=idx,
         harvested={d: [os.path.basename(p) for p in v] for d, v in harvested.items()},
         **health)
    emit("compact", high_watermark=files22 + 1, files_at_start=files22,
         files_before=compacted["files_before"], files_after=compacted["files_after"],
         bytes_before=compacted["bytes_before"], bytes_after=compacted["bytes_after"],
         bytes_reclaimed=compacted["bytes_reclaimed"], rows=compacted["rows"],
         rows_dropped=compacted["rows_dropped"], pass_s=compacted["seconds"],
         flush_to_commit_s=timing["flush_to_compaction_s"],
         worker_refresh_s=refresh[:workers], spans_after=spans_after)
    emit("follow", bootstrap_s=follow["bootstrap_s"],
         bootstrap_bytes=follow["bootstrap_bytes"], ready_s=follow["ready_s"],
         upserts=follow["upserts"], flush_resync_s=follow["flush_resync_s"],
         compact_resync_s=follow["compact_resync_s"],
         compacted_window_match_s=on_follower, upsert_status=follow["upsert_status"],
         launches=f_summary["launches"], predicted_launches=f_predicted,
         plain_cuda_calls=f_plain_cuda, device_bytes=f_summary["device_bytes"],
         store_load_s=f_summary["store_load_s"], decode_s=f_summary["decode_s"],
         index_build_s=f_summary["index_build_s"], promote=promoted,
         promote_s=promote_s, doctor_status=doc_f["status"])
    assert not wrong, f"upsert: fleet bodies differ from the host engine's: {wrong}"
    assert not wal_left, f"upsert: WAL files left after the flush: {wal_left}"
    assert rc_docs[0] == 0 and doc["status"] == "clean", \
        f"upsert: doctor --deep: {docs[0][0][-2000:]}"
    assert rc_docs[1] == 0 and doc_f["status"] == "clean", \
        f"follower: doctor --deep after promote: {docs[1][0][-2000:]}"
    assert promoted["status"] == "promoted" and promoted["epoch"] == 1, promoted
    assert summary["breaker"] == {"open_groups": [], "groups": {}}, summary["breaker"]
    assert f_summary["breaker"] == {"open_groups": [], "groups": {}}, f_summary["breaker"]
    if platform == "cuda":
        assert launches == predicted, f"upsert: launches {launches}, predicted {predicted}"
        assert not any(plain_cuda.values()), f"upsert: plain versions on the card {plain_cuda}"
        assert f_summary["launches"] == f_predicted, \
            f"follower: launches {f_summary['launches']}, predicted {f_predicted}"
        assert not any(f_plain_cuda.values()), \
            f"follower: plain versions on the card {f_plain_cuda}"
    return {"launches": launches, "launches_follower": f_summary["launches"]}


# ---------------------------------------------- chaos (phases 6, 11, 12)

#: the crash specs phase 6 kills its card load with (``AVDB_FAULT``)
CHAOS_LOAD_SPECS = ("store.save.pre_manifest:2:kill",
                    "ledger.append:4:torn_write")

#: phase 6's chaos loads' checkpoint interval: five checkpoints over its
#: 3,125 lines
CHAOS_COMMIT_AFTER = 700

#: a killed load's process: the CLI's ``main`` with the running count of
#: both annotate entries' launches written unbuffered to a file (argv[1])
#: at each launch, so the count outlives the SIGKILL
CHAOS_LOAD_CHILD = """
import os, sys
from annotatedvdb_tpu_torch.ops import annotate_cuda
fd = os.open(sys.argv[1], os.O_WRONLY | os.O_CREAT | os.O_APPEND)
class Counted(dict):
    def __setitem__(self, key, value):
        super().__setitem__(key, value)
        os.write(fd, b"%d\\n" % sum(self.values()))
annotate_cuda.LAUNCHES = Counted(annotate_cuda.LAUNCHES)
from annotatedvdb_tpu_torch.cli.load_vcf import main
sys.exit(main(sys.argv[2:]))
"""


def store_content(store_dir) -> dict:
    """A store's rows less their provenance (``row_algorithm_id``: a
    resumed load is a second invocation): per chromosome, the shard
    compacted, its numeric columns, alleles and JSONB columns."""
    from annotatedvdb_tpu_torch.store import VariantStore

    store = VariantStore.load(store_dir)
    out = {}
    for code, shard in sorted(store.shards.items()):
        shard.compact()
        out[code] = (
            {k: v.tobytes() for k, v in sorted(shard.cols.items())
             if k != "row_algorithm_id"},
            shard.ref.tobytes(), shard.alt.tobytes(),
            json.dumps({c: list(v) for c, v in shard.annotations.items()},
                       sort_keys=True, default=str))
    return out


def durable_checkpoints(store_dir) -> int:
    """Checkpoint records in a store's ledger, a torn last line skipped
    (as the ledger's own open does)."""
    n = 0
    with open(os.path.join(store_dir, "ledger.jsonl")) as f:
        for line in f:
            with contextlib.suppress(ValueError):
                n += json.loads(line).get("type") == "checkpoint"
    return n


def chaos_load_check(platform, vcf, launches) -> dict:
    """Phase 6's crash check: ``load-vcf --commit --commitAfter``
    :data:`CHAOS_COMMIT_AFTER` of phase 6's VCF, one process per spec of
    :data:`CHAOS_LOAD_SPECS` in ``AVDB_FAULT`` on ``platform`` and one on
    the CPU, all started together: each must die by SIGKILL.  Each is
    then resumed through the CLI's ``main`` in this process; the resumed
    card store must equal the CPU's byte for byte (the same crash, the
    same resume: ledgers without time stamps, the input path masked) and,
    less ``row_algorithm_id``, an uninterrupted card load at the same
    interval.  On the card the resume launches an annotate entry once a
    chunk past the last durable checkpoint (and the warmup's packed one, as
    the uninterrupted load does); the killed process's launches come from
    its count file (both entries together).  Returns each spec's seconds and launches."""
    import signal

    from annotatedvdb_tpu_torch.cli.load_vcf import main as load_vcf

    root = os.path.join(WORK, "chaos6")
    shutil.rmtree(root, ignore_errors=True)

    def argv(d, plat):
        return ["--fileName", os.path.join(d, "in.vcf"),
                "--storeDir", os.path.join(d, "store"), "--commit",
                "--logAfter", "0", "--commitAfter", str(CHAOS_COMMIT_AFTER),
                "--platform", plat]

    def setup(name):
        d = os.path.join(root, name)
        os.makedirs(d)
        shutil.copy(vcf, os.path.join(d, "in.vcf"))
        return d

    t0 = time.perf_counter()
    runs = {(spec, plat): setup(f"{i}.{plat}")
            for i, spec in enumerate(CHAOS_LOAD_SPECS)
            for plat in dict.fromkeys((platform, "cpu"))}
    procs = {}
    for (spec, plat), d in runs.items():
        with open(os.path.join(d, "err"), "w") as err:
            procs[spec, plat] = subprocess.Popen(
                [sys.executable, "-c", CHAOS_LOAD_CHILD,
                 os.path.join(d, "launches"), *argv(d, plat)],
                cwd=ROOT, env=dict(os.environ, AVDB_FAULT=spec),
                stdout=subprocess.DEVNULL, stderr=err)
    for key, proc in procs.items():
        rc = proc.wait(timeout=600)
        with open(os.path.join(runs[key], "err")) as f:
            err = f.read()
        assert rc == -signal.SIGKILL, (
            f"chaos load {key} exited {rc}, not by SIGKILL: {err[-2000:]}")
    killed_s = time.perf_counter() - t0
    clean = setup("clean")
    before = annotate_launches(launches)
    assert load_vcf(argv(clean, platform)) == 0
    chunks = annotate_launches(launches) - before
    want = store_content(os.path.join(clean, "store"))
    out = {}
    for (spec, plat), d in runs.items():
        store = os.path.join(d, "store")
        durable = durable_checkpoints(store)
        with open(os.path.join(d, "launches")) as f:
            counts = f.read().split()
        before = annotate_launches(launches)
        t = time.perf_counter()
        assert load_vcf(argv(d, plat)) == 0, f"chaos resume {spec} on {plat}"
        rec = {"durable_checkpoints": durable, "resume_s": time.perf_counter() - t,
               "killed_launches": int(counts[-1]) if counts else 0,
               "resume_launches": annotate_launches(launches) - before}
        if plat == platform:
            assert store_content(store) == want, (
                f"chaos {spec}: the resumed store's rows differ from an "
                f"uninterrupted load's")
            if platform == "cuda":
                assert rec["resume_launches"] == chunks - durable, (
                    f"chaos {spec}: the resume launched the annotate entries "
                    f"{rec['resume_launches']} times, predicted {chunks - durable}")
        out[spec, plat] = rec
    for spec in CHAOS_LOAD_SPECS:
        dev, cpu = (store_bytes(os.path.join(runs[spec, p], "store"))
                    for p in (platform, "cpu"))
        for files, p in ((dev, platform), (cpu, "cpu")):
            files["ledger.jsonl"] = files["ledger.jsonl"].replace(
                runs[spec, p].encode(), b"<dir>")
        differ = sorted(k for k in set(dev) | set(cpu) if dev.get(k) != cpu.get(k))
        assert not differ, f"chaos {spec}: card and CPU resumed stores differ in {differ}"
    shutil.rmtree(root)
    return {"seconds": time.perf_counter() - t0, "killed_s": killed_s,
            "chunks": chunks, "commit_after": CHAOS_COMMIT_AFTER,
            "runs": {f"{spec}@{plat}": rec for (spec, plat), rec in out.items()}}


#: the fault phase 11's ``aio`` turn arms through ``POST /_chaos``, and
#: the seconds until its ttl disarms it
CHAOS_SERVE_SPEC = "engine.device_probe:prob:1.0:eio"
CHAOS_TTL_S = 1.0


#: intervals in each of the chaos window's panels: above both device
#: minimums (32 and 16).  With the breaker open the windowless stats panel
#: takes its host path, 5-8 s on phase 9's store on the H100's host:
#: about the breaker's 5 s cool-down or longer, so the open window's
#: panels are sent from threads of their own while the breaker is polled
CHAOS_INTERVALS = 64

#: the launches of the chaos window's three panels once the breaker is
#: closed again: one chr22 group each, above the device minimums
CHAOS_LAUNCHES = {"bits_spans": 1, "stats_panel": 2, "windowed_stats": 1,
                  "export_pack": 0, **MESH_IDLE}

#: seconds between the chaos window's polls of the breaker (one bulk call,
#: whose membership probe is the half-open trial, then ``/stats``)
CHAOS_POLL_S = 0.05


def chaos_jobs(span, jobs, seed=18) -> list:
    """The chaos window's requests, with job ids past the traffic's (their
    host answers come from the phase's helpers): one bulk call of the
    first :data:`CHAOS_INTERVALS` ids of the traffic's first bulk job
    (sent over and over: each of its probes fires the armed fault), one
    ``/regions`` batch (two rows an interval, ``tokenize``) and two
    ``/stats/region`` batches, without windows and with 16, of
    :data:`CHAOS_INTERVALS` gene-panel intervals."""
    rng = np.random.default_rng(seed)
    ids = next(p for _j, kind, p in jobs if kind == "bulk")[:CHAOS_INTERVALS]
    stats = serve_intervals(rng, CHAOS_INTERVALS, span)
    return [(1 << 30, "bulk", ids),
            ((1 << 30) + 1, "regions",
             {"regions": serve_intervals(rng, CHAOS_INTERVALS, span),
              "limit": 2, "tokenize": True}),
            ((1 << 30) + 2, "stats", {"regions": stats}),
            ((1 << 30) + 3, "stats", {"regions": stats, "windows": SERVE_WINDOWS})]


def counts_so_far(proc, err_path, timeout=60.0) -> dict:
    """SIGUSR1 a one-process server and return the ``counts so far``
    record it logs to stderr (its run summary as it stands)."""
    import signal

    with open(err_path) as f:
        seen = f.read().count("counts so far ")
    proc.send_signal(signal.SIGUSR1)
    t0 = time.perf_counter()
    while True:
        with open(err_path) as f:
            tail = f.read().split("counts so far ")[seen + 1:]
        if tail and "\n" in tail[0]:
            return json.loads(tail[0].split("\n", 1)[0])
        assert proc.poll() is None and time.perf_counter() - t0 < timeout, (
            f"serve logged no counts record (rc {proc.poll()})")
        time.sleep(0.02)


def chaos_serve_check(port, chaos, launches, store_dir) -> dict:
    """Phase 11's chaos window, on the ``aio`` server (started with
    ``AVDB_SERVE_CHAOS=1``) after its traffic window, over the requests
    of :func:`chaos_jobs`; ``launches()`` reads the server's kernel
    launches so far (:func:`counts_so_far`).  ``POST /_chaos`` arms
    :data:`CHAOS_SERVE_SPEC` for :data:`CHAOS_TTL_S`; the bulk call (whose
    membership probe fires the fault) until ``/stats`` shows the chr22
    breaker open; then the ``/regions`` batch and the windowless stats
    batch, each from a thread of its own (each checks the breaker once,
    at its start, and takes the host path), while the main thread polls:
    the bulk call, then ``/stats``, every :data:`CHAOS_POLL_S`, until a
    half-open probe after the ttl and the cool-down closes the breaker.
    The launches read after the open window's panels returned must equal
    those read before the arming (they ran on the host); then the three
    panels again, on the kernels (their launches are the window's
    ``launches``, measured, which the turn holds to
    :data:`CHAOS_LAUNCHES` on the card).  Then ``GET /debug/trace``, parsed,
    and the server's flight ring (``store_dir``'s ``w0.ring``): its
    breaker events give the server's own trip and re-close times, and
    the closing bulk call's record (every call carries an
    ``X-Request-Id``) its stages.  Returns the seconds (the close
    measured from the end of the tripping call's cool-down, by the client
    and by the server's events), every body's digest by job id (for the
    host answers), the timeline, the launch counts and the spans."""
    import http.client
    import itertools

    from annotatedvdb_tpu_torch.obs import flight
    from annotatedvdb_tpu_torch.serve.resilience import DeviceBreaker

    def call(method, path, body=None, rid="chaos"):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
        try:
            conn.request(method, path,
                         body=None if body is None else json.dumps(body).encode(),
                         headers={"X-Request-Id": rid})
            resp = conn.getresponse()
            return resp.status, resp.read()
        finally:
            conn.close()

    routes = {"bulk": ("POST", "/variants"), "regions": ("POST", "/regions"),
              "stats": ("POST", "/stats/region")}
    digests: dict = {}
    timeline: list = []
    seq = itertools.count()
    t0 = time.perf_counter()

    def send(job):
        jid, kind, payload = job
        method, path = routes[kind]
        rid = f"chaos-{next(seq)}"
        t_sent = time.perf_counter() - t0
        body = _digest(*call(method, path,
                             {"ids": payload} if kind == "bulk" else payload, rid))
        digests.setdefault(jid, []).append(body)
        timeline.append((kind, round(t_sent, 4), round(time.perf_counter() - t0, 4), rid))
        return time.perf_counter()

    def breaker():
        return json.loads(call("GET", "/stats")[1])["breaker"]

    bulk, panels = chaos[0], chaos[1:]
    before = launches()
    status, body = call("POST", "/_chaos", {"spec": CHAOS_SERVE_SPEC,
                                            "ttl_s": CHAOS_TTL_S})
    assert status == 200 and json.loads(body)["armed"] == CHAOS_SERVE_SPEC, body
    t_armed = time.perf_counter()
    while True:
        assert len(timeline) < 20, f"chaos: never opened: {breaker()} {timeline}"
        t_sent = time.perf_counter()
        t_trip = send(bulk)
        if 22 in breaker()["open_groups"]:
            break
    t_open = time.perf_counter()
    trip_call_s = t_trip - t_sent
    open_threads = [threading.Thread(target=send, args=(job,)) for job in panels[:2]]
    for th in open_threads:
        th.start()
    polls = 0
    while True:
        assert time.perf_counter() - t_open < 60, (
            f"chaos: never re-closed: {breaker()} {timeline}")
        time.sleep(CHAOS_POLL_S)
        t_closing = send(bulk)
        closing_rid = timeline[-1][3]
        polls += 1
        if not breaker()["open_groups"]:
            break
    t_close = time.perf_counter()
    close_epoch = time.time() - (t_close - t_closing)
    for th in open_threads:
        th.join(timeout=600)
        assert not th.is_alive(), f"chaos: an open-window panel hung: {timeline}"
    at_close = launches()
    assert at_close == before, (
        f"chaos: kernels launched while the breaker was open: {before} -> "
        f"{at_close} {timeline}")
    closed_state = breaker()
    for job in panels:
        send(job)
    after = launches()
    status, dump = call("GET", "/debug/trace")
    assert status == 200, dump[:200]
    events = json.loads(dump)["traceEvents"]
    time.sleep(0.6)  # request summaries reach the ring within 0.25 s
    ring = flight.decode_ring(flight.ring_path(store_dir, 0))["events"]
    trips = [e["t"] for e in ring if e["type"] == "event" and e["name"] == "breaker"
             and e["detail"].startswith("group 22 tripped")]
    closes = [e["t"] for e in ring if e["type"] == "event" and e["name"] == "breaker"
              and e["detail"].startswith("group 22 re-closed")]
    assert len(trips) == len(closes) == 1, f"chaos: breaker events {trips} {closes}"
    closing = [e for e in ring if e["type"] == "request" and e["trace"] == closing_rid]
    cooldown = DeviceBreaker.COOLDOWN_S
    return {"seconds": time.perf_counter() - t0, "open_s": t_open - t_armed,
            "trip_call_s": trip_call_s, "cooldown_s": cooldown,
            "poll_s": CHAOS_POLL_S, "polls": polls,
            "open_to_close_s": t_close - t_open,
            # the closing bulk call's end, less the end of the tripping
            # call's cool-down (the trip fell inside that call)
            "close_after_cooldown_s": t_closing - t_trip - cooldown,
            # the server's own breaker events (flight ring, wall clock)
            "server_open_to_close_s": closes[0] - trips[0],
            "server_close_after_cooldown_s": closes[0] - trips[0] - cooldown,
            # from the server's re-close to the end of the closing call
            "close_seen_after_s": close_epoch - closes[0],
            "closing_call": closing[0] if closing else None,
            "open_panel_s": [round(b - a, 4) for k, a, b, _r in timeline
                             if k != "bulk" and a < t_close - t0],
            "bulk_calls": sum(k == "bulk" for k, _a, _b, _r in timeline),
            "timeline": timeline,
            "digests": digests, "trace_events": len(events),
            "trace_spans": sum(e["ph"] == "X" for e in events),
            "trace_batch_spans": sum(e["ph"] == "B" and e["name"] == "serve.batch"
                                     for e in events),
            "breaker": closed_state,
            "counts": {"before": before, "at_close": at_close, "after": after},
            "launches": {k: after[k] - at_close[k] for k in after}}


#: phase 12's chaos export: killed at the second batch, one batch a part
CHAOS_EXPORT_SPEC = "export.pack:2:kill"
CHAOS_EXPORT_FLAGS = ("--seed", "7", "--batchRows", "512", "--partBytes", "1")


def chaos_export_check(platform, store_dir) -> dict:
    """Phase 12's crash check on a copy of phase 6's card store: ``export
    --commit`` killed at :data:`CHAOS_EXPORT_SPEC` in a process of its own
    (it must die by SIGKILL with only a committed prefix of parts), then
    ``--resume`` through the CLI's ``main`` here, which must write the
    corpus an uninterrupted run writes, byte for byte; the resume's
    ``export_pack`` launches (one a part it writes, on the card)."""
    import io
    import signal

    from annotatedvdb_tpu_torch.__main__ import main as port
    from annotatedvdb_tpu_torch.ops import export_pack as P

    root = os.path.join(WORK, "chaos12")
    shutil.rmtree(root, ignore_errors=True)
    store = os.path.join(root, "store")
    shutil.copytree(store_dir, store)
    plat = ["--platform", platform]

    def argv(out, *extra):
        return ["export", "--storeDir", store, "--out", os.path.join(root, out),
                "--commit", *CHAOS_EXPORT_FLAGS, *plat, *extra]

    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "annotatedvdb_tpu_torch",
                           *argv("killed")], cwd=ROOT, capture_output=True,
                          text=True, timeout=600,
                          env=dict(os.environ, AVDB_FAULT=CHAOS_EXPORT_SPEC))
    assert proc.returncode == -signal.SIGKILL, (
        f"chaos export exited {proc.returncode}, not by SIGKILL: {proc.stderr[-2000:]}")
    killed_s = time.perf_counter() - t0
    committed = sorted(os.listdir(os.path.join(root, "killed")))
    assert committed == ["part-000000.npz"], f"chaos export left {committed}"
    P.LAUNCHES["export_pack"] = 0
    t = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as buf:
        assert port(argv("killed", "--resume")) == 0
    resume_s = time.perf_counter() - t
    summary = json.loads(buf.getvalue().strip().splitlines()[-1])
    launched = P.LAUNCHES["export_pack"]
    with contextlib.redirect_stdout(io.StringIO()):
        assert port(argv("clean")) == 0
    resumed, clean = (_file_digests(os.path.join(root, d)) for d in ("killed", "clean"))
    assert resumed == clean, "chaos export: the resumed corpus differs from a clean run's"
    assert summary["resumed_parts"] == 1
    if platform == "cuda":
        assert launched == summary["parts_written"], (
            f"chaos export: {launched} export_pack launches for "
            f"{summary['parts_written']} parts")
    shutil.rmtree(root)
    return {"seconds": time.perf_counter() - t0, "killed_s": killed_s,
            "resume_s": resume_s, "parts": len(clean) - 1,
            "resumed_parts": summary["resumed_parts"],
            "parts_written": summary["parts_written"], "launches": launched}


# ------------------------------------------------------ the mesh (phase 15)

#: phase 15's one cut: the VCF's line count, 500,000 of the 1,000,000 a
#: user's file would hold at least (the smoke's 1,200 s); its shards and
#: the update inputs
MESH_LINES = 500_000
MESH_SHARDS = 4
MESH_VEP_RESULTS = 20_000
#: the CADD span: 1 Mbp over three chromosomes
MESH_CADD_SPANS = {"2": (60_000_001, 60_333_334), "7": (50_000_001, 50_333_333),
                   "X": (70_000_001, 70_333_333)}
#: the serving traffic: bulk lookups of 256 ids, /regions panels over 8
#: groups (8 intervals a group) and /stats/region calls (32 intervals)
MESH_BULKS, MESH_BULK_IDS = 32, 256
MESH_PANELS, MESH_PANEL_GROUPS, MESH_PANEL_PER_GROUP = 16, 8, 8
MESH_STATS, MESH_STATS_INTERVALS = 8, 32
MESH_LABELS = [str(c) for c in range(1, 23)] + ["X", "Y", "MT"]


def write_mesh_inputs(work, n_lines=MESH_LINES, seed=15) -> dict:
    """Phase 15's inputs under ``work/mesh``: a VCF of ``n_lines`` lines
    over chromosomes 1-22, X, Y and MT in proportion to their GRCh38
    lengths, each chromosome's lines position-sorted and the chromosomes
    in order (dbSNP-shaped lines, :func:`vcf_lines`); a VEP JSON of
    :data:`MESH_VEP_RESULTS` results over them; the CADD tables over
    :data:`MESH_CADD_SPANS`.  Returns the paths, the VEP and CADD
    predictions, the lines' per-chromosome sites and the seconds it took.
    Reads nothing of the earlier phases, so it runs in another process."""
    from annotatedvdb_tpu_torch.genome.assemblies import BUILD_LENGTHS

    t0 = time.perf_counter()
    d = os.path.join(work, "mesh")
    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(seed)
    lengths = np.asarray(BUILD_LENGTHS["grch38"], np.int64)
    counts = np.floor(n_lines * lengths / lengths.sum()).astype(np.int64)
    counts[0] += n_lines - counts.sum()
    vcf = os.path.join(d, "mesh.vcf")
    lines_by, all_lines = {}, []
    with open(vcf, "w") as fh:
        fh.write(HEADER)
        for k, (label, n) in enumerate(zip(MESH_LABELS, counts.tolist())):
            pos = np.unique(rng.integers(1, int(lengths[k]) - 100, n + n // 50 + 8))
            pos = np.sort(rng.choice(pos, n, replace=False))
            lines, _rows = vcf_lines(seed * 100 + k, n, pos.tolist())
            lines = [f"{label}\t{ln[3:]}" for ln in lines]
            fh.writelines(lines)
            lines_by[label] = lines
            all_lines += lines
    vep = os.path.join(d, "mesh.vep.json")
    want_vep, _combos = write_vep_json(vep, all_lines, MESH_VEP_RESULTS, seed, 0)
    sites = []
    for label in MESH_CADD_SPANS:
        sites += vcf_sites(lines_by[label])
    db = os.path.join(d, "cadd")
    pred = write_cadd_tables(db, sites, MESH_CADD_SPANS, seed=seed, level=1)
    # bulk ids over every chromosome: stored identities (first alt) and 1
    # in 8 with an alt the store does not hold
    ids = []
    for label, lines in lines_by.items():
        take = rng.choice(len(lines), min(len(lines), 400), replace=False)
        for i in take.tolist():
            _c, p, _v, ref, alt_col = lines[i].split("\t", 5)[:5]
            alt = alt_col.split(",")[0]
            if alt == "." or rng.random() < 0.125:
                alt = next(b for b in "ACGT" if b != ref[0])
            ids.append(f"{label}:{p}:{ref}:{alt}")
    return {"vcf": vcf, "vep": vep, "want_vep": want_vep, "cadd": db,
            "lines": int(n_lines),
            "cadd_pred": {k: v for k, v in pred.items() if k != "expected"},
            "ids": ids, "lengths": lengths.tolist(),
            "seconds": time.perf_counter() - t0}


def mesh_traffic(inp, seed=16) -> list:
    """Phase 15's requests: :data:`MESH_BULKS` bulk lookups of
    :data:`MESH_BULK_IDS` ids drawn over every chromosome,
    :data:`MESH_PANELS` ``/regions`` panels over :data:`MESH_PANEL_GROUPS`
    groups and :data:`MESH_STATS` ``/stats/region`` calls, as (path,
    body) pairs."""
    rng = np.random.default_rng(seed)
    ids, lengths = inp["ids"], inp["lengths"]
    jobs = []
    for _ in range(MESH_BULKS):
        pick = rng.choice(len(ids), MESH_BULK_IDS, replace=False)
        jobs.append(("/variants", {"ids": [ids[i] for i in pick.tolist()]}))

    def intervals(groups, per_group):
        specs = []
        for g in groups.tolist():
            width = min(300_000, lengths[g] // 2)  # MT is 16,569 bp
            for _ in range(per_group):
                s = int(rng.integers(1, lengths[g] - width))
                specs.append(f"{MESH_LABELS[g]}:{s}-{s + int(rng.integers(0, width))}")
        return specs

    for _ in range(MESH_PANELS):
        groups = rng.choice(len(MESH_LABELS), MESH_PANEL_GROUPS, replace=False)
        jobs.append(("/regions", {"regions": intervals(groups, MESH_PANEL_PER_GROUP),
                                  "limit": 5}))
    for _ in range(MESH_STATS):
        groups = rng.choice(len(MESH_LABELS), 4, replace=False)
        jobs.append(("/stats/region", {"regions": intervals(
            groups, MESH_STATS_INTERVALS // 4)}))
    return jobs


def _mesh_multihost(platform="cuda"):
    """Start a one-process world on a loopback coordinator (a child
    process: ``nccl`` on the card, ``gloo`` on the CPU) that runs the
    sharded annotate step over the four virtual shards on a seeded batch.
    Returns the child; :func:`_mesh_multihost_result` reads it."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    src = f"""
import os, sys, json
sys.path.insert(0, {ROOT!r})
os.environ.update(AVDBC_VIRTUAL_DEVICES="{MESH_SHARDS}",
                  AVDB_COORDINATOR="127.0.0.1:{port}",
                  AVDB_NUM_PROCESSES="1", AVDB_PROCESS_ID="0")
import torch, torch.distributed as dist
from annotatedvdb_tpu_torch.io.synth import synthetic_batch
from annotatedvdb_tpu_torch.parallel import (
    distributed_annotate_step, init_multihost, make_mesh, process_info)
from annotatedvdb_tpu_torch.parallel.multihost import shutdown
assert init_multihost(platform="{platform}")
mesh = make_mesh()
_a, _r, counts, dropped, n_fb = distributed_annotate_step(
    mesh, synthetic_batch(65536, width=49, seed=15))
print(json.dumps({{"counts": counts.tolist(), "dropped": int(dropped),
                  "fallback": int(n_fb), "backend": dist.get_backend(),
                  "world": list(process_info()), "shards": mesh.size,
                  "collective": mesh.distributed}}))
shutdown()
"""
    proc = subprocess.Popen([sys.executable, "-c", src], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    proc.t0 = time.perf_counter()
    return proc


def _mesh_multihost_result(proc) -> dict:
    out, err = proc.communicate(timeout=240)
    assert proc.returncode == 0, f"the one-process world failed: {err[-3000:]}"
    res = json.loads(out.strip().splitlines()[-1])
    res["seconds"] = time.perf_counter() - proc.t0
    return res


def mesh_steps(inp) -> list:
    """Phase 15's three commands on a store, in order."""
    return [("load", ["load-vcf", "--fileName", inp["vcf"], "--logAfter", "0"]),
            ("vep", ["load-vep", "--fileName", inp["vep"], "--logAfter", "0"]),
            ("cadd", ["load-cadd", "--databaseDir", inp["cadd"], "--logAfter", "0"])]


def store_digests(store_dir) -> dict:
    """sha256 of each file :func:`store_bytes` compares."""
    import hashlib

    return {k: hashlib.sha256(v).hexdigest() for k, v in store_bytes(store_dir).items()}


def mesh_chain(inp, store, workers, platform="cuda", counts=None) -> dict:
    """Phase 15's commands on ``store`` with ``--maxWorkers workers``, each
    through the CLI's ``main`` with ``--commit``: per step its wall, the
    printed lines, the store's digests after it and, with ``counts``
    ({name: launch counter dict}), each counter's launches in it."""
    import io

    from annotatedvdb_tpu_torch.__main__ import main as cli

    shutil.rmtree(store, ignore_errors=True)
    out = {}
    for step, argv in mesh_steps(inp):
        before = {k: dict(c) for k, c in (counts or {}).items()}
        buf = io.StringIO()
        t0 = time.perf_counter()
        log = os.path.join(WORK, "mesh", f"{argv[0]}-{workers}.log")
        with contextlib.redirect_stdout(buf):
            rc = cli([*argv, "--storeDir", store, "--commit", "--maxWorkers",
                      str(workers), "--platform", platform, "--logFilePath", log])
        assert rc == 0, f"{argv[0]} (--maxWorkers {workers}) exited {rc}"
        out[step] = {"wall_s": time.perf_counter() - t0,
                     "printed": buf.getvalue().strip().splitlines()[-2:],
                     "launches": {k: {n: c[n] - before[k].get(n, 0) for n in c}
                                  for k, c in (counts or {}).items()},
                     "digests": store_digests(store)}
    return out


def mesh_single_chain(inp, platform="cuda") -> dict:
    """The single-device chain, with its annotate launches (a chunk each
    and the warmup's packed one), then the host-only server's bodies for
    :func:`mesh_traffic` over its store (an ``aio`` server on the CPU, the
    latency governor off)."""
    from annotatedvdb_tpu_torch.ops import annotate_cuda
    from annotatedvdb_tpu_torch.serve.aio import build_aio_server

    if platform == "cuda":
        import torch

        from annotatedvdb_tpu_torch.models.pipeline import annotate_hash_fn, annotate_packed_fn

        annotate_hash_fn(torch.device("cuda", 0))  # their checks, uncounted
        annotate_packed_fn(torch.device("cuda", 0))
    store = os.path.join(WORK, "mesh", "store_single")
    out = mesh_chain(inp, store, 1, platform,
                     counts={"annotate_cuda": annotate_cuda.LAUNCHES})
    os.environ.update(AVDB_SERVE_MESH="0", AVDB_SERVE_BROWNOUT_P99_MS="0")
    host = build_aio_server(store_dir=store, port=0, device="cpu")
    host.start_background()
    try:
        t0 = time.perf_counter()
        out["bodies"] = [_post_body(host, path, body)
                         for path, body in mesh_traffic(inp)]
        out["host_serve_s"] = time.perf_counter() - t0
    finally:
        host.shutdown()
        host.ctx.batcher.close()
    return out


def mesh_phase_job(inp, t0, platform="cuda") -> dict:
    """Phase 15 as the second process runs it, beside phase 14:
    :func:`mesh_phase` with its single-device chain after the mesh's in
    this process.  ``t0`` is the smoke's start on the monotonic clock
    every process shares, so the lines it emits carry the smoke's
    ``t_s``."""
    global T0
    T0 = t0
    import torch

    return mesh_phase(torch, inp, platform)


def mesh_phase(torch, inp, platform="cuda", single=None) -> dict:
    """Phase 15's mesh (see the module docstring).  ``single`` is a pending
    single-device chain (a future of :func:`mesh_single_chain` another
    process runs); when None it runs here after the mesh's.  Returns the
    phase's launches of ``lookup_multi`` and ``bits_spans_stacked`` and
    its seconds."""
    from annotatedvdb_tpu_torch.io.synth import synthetic_batch
    from annotatedvdb_tpu_torch.ops import annotate_cuda, dedup
    from annotatedvdb_tpu_torch.ops import intervals as I
    from annotatedvdb_tpu_torch.parallel import mesh as meshlib
    from annotatedvdb_tpu_torch.parallel.distributed import distributed_annotate_step
    from annotatedvdb_tpu_torch.serve.aio import build_aio_server
    from annotatedvdb_tpu_torch.serve.mesh_exec import MESH_GROUP

    t_phase = time.perf_counter()
    on_card = platform == "cuda"
    if on_card:
        # the annotate kernel's one-time check (already run when phase 4
        # came first) launches outside the counted path
        from annotatedvdb_tpu_torch.models.pipeline import annotate_hash_fn

        annotate_hash_fn(torch.device("cuda", 0))
    counted = (annotate_cuda.LAUNCHES, dedup.LAUNCHES, I.LAUNCHES, dedup.CALLS,
               I.CALLS)
    for counts in counted:  # every count 0 just before the phase's path
        for name in counts:
            counts[name] = 0
    saved_env = {k: os.environ.get(k) for k in (
        meshlib.VIRTUAL_DEVICES_ENV, "AVDB_SERVE_MESH", "AVDB_SERVE_CHAOS",
        "AVDB_SERVE_BROWNOUT_P99_MS")}
    os.environ[meshlib.VIRTUAL_DEVICES_ENV] = str(MESH_SHARDS)
    meshlib.reset_global_mesh()
    stores = {tag: os.path.join(WORK, "mesh", f"store_{tag}")
              for tag in ("mesh", "single")}
    world_proc = _mesh_multihost(platform)
    try:
        mesh_run = mesh_chain(inp, stores["mesh"], MESH_SHARDS, platform, counts={
            "annotate_bin": annotate_cuda.LAUNCHES, "lookup_multi": dedup.LAUNCHES})
        single_run = (single.result() if single is not None
                      else mesh_single_chain(inp, platform))
        steps = {}
        for step, _argv in mesh_steps(inp):
            m, s1 = mesh_run[step], single_run[step]
            steps[step] = {"mesh_wall_s": m["wall_s"], "single_wall_s": s1["wall_s"],
                           "launches": m["launches"],
                           "single_annotate": annotate_launches(
                               s1["launches"]["annotate_cuda"]), "printed": m["printed"]}
            if m["digests"] != s1["digests"]:
                raise AssertionError(f"mesh {step} store differs from the "
                                     f"single-device one")
            if m["printed"] != s1["printed"]:
                raise AssertionError(f"mesh {step} printed {m['printed']}, "
                                     f"single {s1['printed']}")
        # the single-device load's warmup launches the packed entry once
        chunks = steps["load"]["single_annotate"] - (WARMUP_PACKED if on_card else 0)
        got = steps["load"]["launches"]["annotate_bin"]["annotate_bin"]
        if on_card and got != MESH_SHARDS * chunks:
            raise AssertionError(f"mesh load launched annotate_bin {got} times "
                                 f"for {chunks} chunks")
        for step in ("vep", "cadd"):
            if on_card and not steps[step]["launches"]["lookup_multi"]["lookup_multi"]:
                raise AssertionError(f"mesh {step} never launched lookup_multi")
        pred = inp["cadd_pred"]
        counters = json.loads(mesh_run["cadd"]["printed"][-2])
        if {k: counters[k] for k in ("snv", "indel", "update")} != \
                {k: pred[k] for k in ("snv", "indel", "update")}:
            raise AssertionError(f"mesh load-cadd counters {counters} against {pred}")
        emit("mesh_loads", steps=steps, seconds=time.perf_counter() - t_phase)
        # serving: the mesh server (AVDB_SERVE_MESH=1) in this process
        # against the host-only server the helper ran on the equal store
        jobs = mesh_traffic(inp)
        os.environ["AVDB_SERVE_CHAOS"] = "1"
        # full service: no analytics shed by the latency governor
        os.environ["AVDB_SERVE_BROWNOUT_P99_MS"] = "0"
        os.environ["AVDB_SERVE_MESH"] = "1"
        meshed = build_aio_server(store_dir=stores["mesh"], port=0, device=platform)
        executor = meshed.ctx.engine.mesh
        if executor is None or executor.n_devices != MESH_SHARDS:
            raise AssertionError("serve built no 4-shard MeshExecutor")
        meshed.start_background()
        # the host-only server's bodies, from the helper process
        want, host_s = single_run["bodies"], single_run["host_serve_s"]
        try:
            launches0 = (dedup.LAUNCHES["lookup_multi"],
                         I.LAUNCHES["bits_spans_stacked"])
            t0 = time.perf_counter()
            got = [_post_body(meshed, path, body) for path, body in jobs]
            mesh_s = time.perf_counter() - t0
            differ = sum(g != w for g, w in zip(got, want))
            serve_launches = {
                "lookup_multi": dedup.LAUNCHES["lookup_multi"] - launches0[0],
                "bits_spans_stacked": I.LAUNCHES["bits_spans_stacked"] - launches0[1]}
            if differ:
                raise AssertionError(f"{differ} mesh-served bodies differ from "
                                     "the host-only server's")
            if on_card and (
                    serve_launches["lookup_multi"] != MESH_BULKS * MESH_SHARDS
                    or serve_launches["bits_spans_stacked"] != MESH_PANELS * MESH_SHARDS):
                raise AssertionError(f"mesh serving launches {serve_launches}")
            # chaos: mesh.dispatch armed through POST /_chaos
            breaker = meshed.ctx.engine.breaker
            breaker.cooldown_s = 1.0
            bulk = jobs[0]
            t0 = time.perf_counter()
            status = _post_body(meshed, "/_chaos",
                                {"spec": "mesh.dispatch:prob:1.0:raise", "ttl_s": 60})
            chaos_bodies = [_post_body(meshed, *bulk)
                            for _ in range(breaker.failure_threshold)]
            opened = breaker.state(MESH_GROUP)
            _post_body(meshed, "/_chaos", {"spec": ""})
            time.sleep(1.2)
            k1 = dedup.LAUNCHES["lookup_multi"]
            chaos_bodies.append(_post_body(meshed, *bulk))
            closed = breaker.state(MESH_GROUP)
            chaos = {"armed": json.loads(status), "opened": opened, "closed": closed,
                     "bodies_differ": sum(b != want[0] for b in chaos_bodies),
                     "relaunched": dedup.LAUNCHES["lookup_multi"] - k1,
                     "seconds": time.perf_counter() - t0}
            if chaos["bodies_differ"] or opened != "open" or closed != "closed" \
                    or (on_card and chaos["relaunched"] != MESH_SHARDS):
                raise AssertionError(f"mesh chaos check failed: {chaos}")
            stats = executor.stats()
        finally:
            meshed.shutdown()
            meshed.ctx.batcher.close()
        # multi-host: the one-process world against the in-process run
        world = _mesh_multihost_result(world_proc)
        mesh = meshlib.make_mesh(MESH_SHARDS,
                                 devices=meshlib.device_pool(platform)[:1] * MESH_SHARDS)
        _a, _r, counts, dropped, n_fb = distributed_annotate_step(
            mesh, synthetic_batch(65536, width=49, seed=15))
        local = {"counts": counts.tolist(), "dropped": int(dropped), "fallback": int(n_fb)}
        backend = "nccl" if on_card else "gloo"
        if any(world[k] != local[k] for k in local) or world["backend"] != backend:
            raise AssertionError(f"nccl world {world} against in-process {local}")
    finally:
        if world_proc.poll() is None:
            world_proc.kill()
            world_proc.communicate()
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        meshlib.reset_global_mesh()
    launches = {"lookup_multi": dedup.LAUNCHES["lookup_multi"],
                "bits_spans_stacked": I.LAUNCHES["bits_spans_stacked"],
                "annotate_bin": annotate_cuda.LAUNCHES["annotate_bin"]}
    if dedup.CALLS["cuda"] or I.CALLS["cuda"]:
        raise AssertionError(f"a plain version ran on the card: {dedup.CALLS} {I.CALLS}")
    seconds = time.perf_counter() - t_phase
    emit("mesh", shards=MESH_SHARDS, lines=inp["lines"], steps=steps,
         serve_requests=len(jobs), bodies_differ=differ, host_serve_s=host_s,
         mesh_serve_s=mesh_s, serve_launches=serve_launches, executor=stats,
         chaos=chaos, multihost={"world": world, "in_process": local},
         launches=launches, inputs_seconds=inp["seconds"], seconds=seconds)
    return {"launches": launches, "seconds": seconds}


def _post_body(server, path, body) -> bytes:
    """One POST's body from an in-process server (asserting a 200)."""
    conn = _Conn(server.server_address[1])
    try:
        status, raw, _s = conn.call("POST", path, body)
    finally:
        conn.close()
    assert status == 200, f"POST {path}: {status} {raw[:300]!r}"
    return raw


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is False: this smoke needs a CUDA card")
    sys.path.insert(0, ROOT)
    try:
        from annotatedvdb_tpu_torch import native
        from annotatedvdb_tpu_torch.native import cadd as native_cadd
        from annotatedvdb_tpu_torch.native import pyfast
        from annotatedvdb_tpu_torch.native import vep as native_vep
        from annotatedvdb_tpu_torch.ops import annotate_cuda, build, hashing, pack
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
                 "pyfast": pyfast.load, "cadd_tokenizer": native_cadd.load}
    with concurrent.futures.ThreadPoolExecutor(len(libraries)) as pool:
        futures = {name: pool.submit(timed_build, load)
                   for name, load in libraries.items()}
        logs = build.build()
        native_s = {name: f.result() for name, f in futures.items()}
    emit("build", seconds=time.perf_counter() - t0, kernels=sorted(logs),
         native_seconds=native_s,
         ptxas={k: [ln for ln in v.splitlines() if "registers" in ln or "smem" in ln]
                for k, v in logs.items()})

    #: every kernel launch counter the loads' main paths read
    launches = Launches(annotate_cuda.LAUNCHES, pack.LAUNCHES)

    def reset():
        for counts in (launches, hashing.CALLS):
            for name in counts:
                counts[name] = 0

    import multiprocessing

    # one spawned worker process (this one holds the card and threads) for
    # setup that needs no card; leaving the block waits for it, so no
    # process outlives the smoke
    with concurrent.futures.ProcessPoolExecutor(
            1, mp_context=multiprocessing.get_context("spawn")) as pool:
        try:
            # depth cut to make room for phases 11 and 13 and then for
            # phase 11's fleet turn and phase 14, in the order PERF.md
            # section 4 lists: phase 8 at 25,000 / 25,000 / 12,500 lines
            # on a store of 125,000 lines (its wall was the 2.27M-row
            # store's load and saves), phase 6 at 3,125 lines and 625
            # indexed lines, phase 10 at 62,500 lines, phase 7 at 50,000
            # VEP results and 7b at 10,000
            # (the second process writes them beside phase 3's first
            # kernel checks, which read none of them)
            inputs_job = pool.submit(
                write_inputs, 2_000_000, 500_000, 3_125, 50_000,
                n8=(25_000, 25_000, 12_500), n7b=10_000, head6=625, n10=62_500,
                n8_store=125_000)
            # 3. kernels against their plain versions, and the kernel's hash
            # against the tokenizer's on the phase-4 VCF
            table = kernel_phase(torch, device)
            table.append(cadd_kernel_phase(torch, device))
            t0 = time.perf_counter()
            inputs = inputs_job.result()
            emit("inputs", genome=inputs["genome"]["seconds"],
                 genome_index_bytes=inputs["genome"]["index_bytes"],
                 waited_s=time.perf_counter() - t0,
                 **{k: v for k, v in inputs.items() if k.endswith("_seconds")})
            table.append(validate_kernel_phase(torch, device, inputs["genome"]["index"]))
            # the serving and export kernels timed in the second process
            # while this one waits (no process started for them)
            table += serve_kernel_phase(torch, device, pool)
            table.append(export_kernel_phase(torch, device, pool))
            # the packed transport's kernels: checked here, timed in the
            # second process while this one waits
            t0 = time.perf_counter()
            transport_checks, transport_worst = transport_kernel_checks(torch, device)
            packed_checks, packed_worst = annotate_packed_checks(torch, device)
            identity_checks, identity_worst = annotate_identity_checks(torch, device)
            checks_s = time.perf_counter() - t0
            transport_timing = pool.submit(transport_kernel_timing).result()
            emit("transport_kernel", checks=transport_checks, worst=transport_worst,
                 checks_s=checks_s, timing={k: v for k, v in transport_timing.items()
                                            if "packed" not in k and "identity" not in k})
            emit("packed_kernel", checks=len(packed_checks), worst=packed_worst,
                 host_fallback_rows=sum(c["host_fallback_rows"] for c in packed_checks),
                 blocks_per_sm={f"w{w}-cols{c}": annotate_cuda._library()
                                .annotate_bin_packed_blocks_per_sm(w, c)
                                for w, c in ((WIDTH, (WIDTH + 1) // 2), (192, 96))},
                 timing={k: v for k, v in transport_timing.items() if "packed" in k})
            emit("identity_kernel", checks=len(identity_checks), worst=identity_worst,
                 host_fallback_rows=sum(c["host_fallback_rows"] for c in identity_checks),
                 two_launch_checks=sum(c["equal_two_launches"] is not None
                                       for c in identity_checks),
                 blocks_per_sm={f"w{w}": annotate_cuda._library()
                                .annotate_bin_identity_blocks_per_sm(w)
                                for w in (WIDTH, 192, 255)},
                 timing={k: v for k, v in transport_timing.items() if "identity" in k})
            transport_rows = transport_kernel_rows(transport_checks, transport_timing,
                                                   packed_checks, identity_checks)
            # the mesh kernels' checks, then their timing in the second
            # process while this one waits, so no other phase shares the card
            mesh_checks = mesh_kernel_checks(torch, device)
            mesh_timing = pool.submit(mesh_kernel_timing).result()
            native_hash_check(torch, device, inputs["vcf4"])
            # 4-6. the load (counters reset inside, just before it), the
            # probed reload and the card-vs-CPU parity.  Phase 9's tables
            # are written by the second process during phase 6, which is
            # checked and not timed (it reads only the VCFs)
            cadd9 = []
            results = load_phases(
                torch, "cuda", inputs, launches=launches,
                hash_calls=hashing.CALLS,
                before_parity=lambda: cadd9.append(pool.submit(
                    write_cadd9_inputs, WORK, [inputs["vcf4"], inputs["vcf5"]],
                    CADD9_SPAN)))
            t0 = time.perf_counter()
            inputs["cadd9"] = cadd9[0].result()
            emit("inputs9", seconds=inputs["cadd9"]["seconds"],
                 waited_after_phase6_s=time.perf_counter() - t0)
            # phase 15's inputs, written by the second process meanwhile
            mesh_inputs = pool.submit(write_mesh_inputs, WORK)
            if annotate_launches(results["launches"]) != results["chunks"] + WARMUP_PACKED:
                return fail(f"the annotate entries launched "
                            f"{annotate_launches(results['launches'])} times for "
                            f"{results['chunks']} chunks and the warmup")
            if results["plain_hash_calls"].get("cuda"):
                return fail(f"the load called the plain allele_hash on the card "
                            f"{results['plain_hash_calls']['cuda']} times")
            # 7. the VEP update of phase 4's store: first the transformer's
            # hash against the kernel's, then copies of the store (two for
            # phase 7b, one without VEP sidecars for phase 9's CADD join),
            # then the counters reset just before it
            vep_hash_check(torch, device, results["vep"])
            for key in ("store_python", "store_7b", "store_cadd"):
                results[key] = f"{results['store']}.{key}"
                shutil.copytree(results["store"], results[key])
            reset()
            vep = vep_phase(torch, "cuda", results, launches=launches,
                            hash_calls=hashing.CALLS)
            # 8. the update legs on a store of phase 4's first 125,000
            # lines, loaded for them (counters reset inside, just before
            # each command)
            store8 = load_update_store(inputs["vcf8"])
            upd = update_phase(torch, "cuda", store8, inputs["updates8"],
                               launches=launches,
                               hash_calls=hashing.CALLS)
            # 9. the CADD join of the store of phases 4 and 5 (counters reset
            # inside, just before it)
            cadd = cadd_phase(torch, "cuda", results["store_cadd"], inputs["cadd9"])
            # 10. the reference genome: index-genome, load-vcf --refGenome,
            # install-schema and bin-references (counters reset inside)
            ref10 = refgenome_phase(torch, "cuda", inputs)
            # 11. the query server on phase 9's store, the host-only answers
            # computed by helper processes after its traffic window
            # (counters start at 0 with the server's process)
            served = serve_phase(torch, "cuda", results["store_cadd"], inputs["vcf4"],
                                 {row["name"]: row["ms"] for row in table[3:]})
            # 12. the corpus export of phase 9's store, on the card and
            # with --hostOnly, then /export/stream calls on a card engine
            # (counters reset inside, just before each)
            exported = export_phase(torch, "cuda", results["store_cadd"], table[6]["ms"])
            chaos_export = chaos_export_check("cuda", results["store6"])
            # 13. doctor on the card-written stores: fsck, status and
            # profile of phase 9's store (profile against phase 12's card
            # engine), a torn copy of phase 6's store repaired, and
            # replay-rejects
            doctor_phase(torch, "cuda", results["store_cadd"], results["store6"],
                         exported["engine"])
            # 14. the write path on phase 9's store, which no later phase
            # reads: serve --workers 2 --upserts --maintain and a
            # serve --follow beside it (counters start at 0 with each
            # serving process)
            # 15. the device mesh over four virtual shards of the card, in
            # the second process beside phase
            # 14 (which keeps the card mostly idle and waits on its fleet;
            # phase 15 sets its own process's counts to 0 just before it)
            t0 = time.perf_counter()
            inputs["mesh"] = mesh_inputs.result()
            emit("inputs15", seconds=inputs["mesh"]["seconds"],
                 waited_before_phase14_s=time.perf_counter() - t0)
            mesh_job = pool.submit(mesh_phase_job, inputs["mesh"], T0)
            upserted = upsert_phase("cuda", results["store_cadd"], inputs["vcf4"])
            t0 = time.perf_counter()
            meshed = mesh_job.result()
            emit("mesh_wait", waited_after_phase14_s=time.perf_counter() - t0)
            table += mesh_kernel_rows(*mesh_checks, mesh_timing)
        except AssertionError as err:
            return fail(str(err))
    left = leftovers_check()
    if left:
        return fail(f"{len(left)} processes outlived their phases: {left}")
    emit("chaos", load=results["chaos"], serve=served["chaos"], export=chaos_export,
         seconds={"load": results["chaos"]["seconds"],
                  "serve": served["chaos"]["seconds"],
                  "export": chaos_export["seconds"]})
    emit("smoke", seconds=time.perf_counter() - t_start)
    # annotate_bin: the loads' raw chunks and wide VEP stores (none on the
    # smoke's inputs), phase 10's egress windows and phase 15's mesh steps
    by_phase = {"vcf_load": results["launches"]["annotate_bin"],
                "vep_load": vep["launches"]["annotate_bin"],
                **{f"update_{name}": n["annotate_bin"] for name, n in upd.items()},
                "install_schema": ref10["egress_launches"],
                "mesh": meshed["launches"]["annotate_bin"]}
    table[0].update(launches=sum(by_phase.values()),
                    **{f"launches_{k}": n for k, n in by_phase.items()})
    table[1].update(launches=cadd["launches"])
    table[2].update(launches=ref10["launches"])
    for row in table[3:6]:
        row.update(launches=served["launches"][row["name"]],
                   **{f"launches_{fe}": n[row["name"]]
                      for fe, n in served["launches_by_frontend"].items()},
                   launches_upsert=upserted["launches"][row["name"]],
                   launches_follower=upserted["launches_follower"][row["name"]])
    table[6].update(launches=exported["export"] + exported["stream"],
                    launches_export=exported["export"],
                    launches_stream=exported["stream"])
    for row in table[7:9]:
        row.update(launches=meshed["launches"][row["name"]])
    # the transport's rows and the packed entry's: phase 4's load (its
    # warmup's call at the chunk shape included), phase 7's VEP update and
    # phase 8's inserts
    for row in transport_rows:
        name = row["name"]
        by_phase = {"vcf_load": results["launches"][name],
                    "vep_load": vep["launches"][name],
                    **{f"update_{k}": n[name] for k, n in upd.items()}}
        row.update(launches=sum(by_phase.values()),
                   **{f"launches_{k}": n for k, n in by_phase.items()})
    table += transport_rows

    print(json.dumps({"kernels": table}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
