#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA card.

Drives ``annotatedvdb_tpu_torch``'s VCF insert load on ``cuda:0`` and
checks it, phase by phase, each phase printing one JSON line:

1. device   — the card's name and power limit (``nvidia-smi``);
2. build    — compiles every kernel from ``annotatedvdb_tpu_torch/csrc``;
3. kernels  — each kernel against its plain PyTorch version on the card
              (seeded edge rows + 1,048,576 random rows, exact under the
              selection contract), and its time at the load's chunk shape
              (65,536 rows, W = 49) beside the plain version's and the
              memory bound;
4. load     — a seeded dbSNP-shaped chr22 VCF of 2,000,000 lines through
              ``python -m annotatedvdb_tpu_torch load-vcf --commit`` (the
              CLI's ``main``), with every kernel launch counter reset just
              before and read just after;
5. reload   — 500,000 lines, half of them copies of phase-4 lines, probed
              on the card (``AVDB_DEVICE_LOOKUP=always``); the duplicate
              count must be the one the generator predicts;
6. parity   — the first 50,000 lines loaded on the card and on the CPU:
              the persisted store bytes must be identical.

Then the kernel table and, as the last line,
``{"ok": true, "device": {"platform": "gpu", ...}}``.  Any failure exits
non-zero without that line.  Needs one CUDA card and the repository
checkout around this file; run as ``python3 chip_smoke.py``.
"""

from __future__ import annotations

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
    span = rng.integers(2, width, n).astype(np.int32)
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


# ---------------------------------------------------------------- phases


def kernel_phase(torch, device):
    """Phase 3: every kernel against its plain version; returns the kernel
    table rows (launches filled in after phase 4)."""
    from annotatedvdb_tpu_torch.models.pipeline import annotate_fn
    from annotatedvdb_tpu_torch.ops.annotate_cuda import (
        FIELDS,
        annotate_bin,
        annotate_bin_reference,
    )

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
            if name not in ("host_fallback", "needs_digest"):
                diff = torch.where(ok, diff, torch.zeros_like(diff))
            err = int(diff.max()) if diff.numel() else 0
            worst = max(worst, err)
            if err:
                bad.append(name)
        return worst, bad, want

    checks = []
    for label, args in (
        ("edge-w16", edge_batch(16)), ("edge-w49", edge_batch(WIDTH)),
        ("edge-w96", edge_batch(96)),
        ("random-1m-w49", random_batch(3, 1 << 20, WIDTH)),
    ):
        worst, bad, want = compare(to_dev(args))
        checks.append({"inputs": label, "rows": int(args[0].shape[0]),
                       "max_abs_err": worst, "mismatched": bad,
                       "host_fallback_rows": int(want["host_fallback"].sum())})
        if bad:
            raise AssertionError(f"annotate_bin disagrees with its plain "
                                 f"version on {label}: {bad}")
    # the annotate step's own warm-up check (kernel vs plain on a probe
    # batch) runs here, before the launch counters are reset for phase 4
    annotate_fn(device)

    # timing at the load's chunk shape; ten distinct input sets (> 50 MB
    # of L2) so each launch reads its inputs from device memory
    sets = [to_dev(random_batch(10 + i, CHUNK_ROWS, WIDTH)) for i in range(10)]

    def warm(fn):
        for args in sets[:2]:
            fn(*args)
        torch.cuda.synchronize()

    def call_ms(fn, iters):
        """Device-timeline time per call between CUDA events: the kernel
        plus any gap the host's launch overhead leaves between calls."""
        warm(fn)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(iters):
            fn(*sets[i % len(sets)])
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / iters

    def device_ms(fn, iters):
        """Summed device time of every kernel a call launches (profiler),
        per call; None when the profiler sees no device time."""
        from torch.profiler import ProfilerActivity, profile

        warm(fn)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for i in range(iters):
                fn(*sets[i % len(sets)])
            torch.cuda.synchronize()
        total_us = sum(getattr(e, "self_device_time_total", 0.0)
                       for e in prof.key_averages())
        return total_us / 1e3 / iters if total_us > 0 else None

    # in turns: plain, kernel, kernel, plain
    runs = {"plain": [], "kernel": []}
    for name, fn, iters in (
        ("plain", annotate_bin_reference, 20), ("kernel", annotate_bin, 200),
        ("kernel", annotate_bin, 200), ("plain", annotate_bin_reference, 20),
    ):
        runs[name].append({"device_ms": device_ms(fn, iters),
                           "call_ms": call_ms(fn, iters)})

    def best(name):
        dev = [r["device_ms"] for r in runs[name] if r["device_ms"] is not None]
        return min(dev) if dev else min(r["call_ms"] for r in runs[name])

    # the bound: bytes each row must move (inputs read once, outputs
    # written once) and the compare/scalar operations these inputs need
    pos, ref, alt, rl, al = (x.cpu().numpy() for x in sets[0])
    out = annotate_bin_reference(*sets[0])
    n = pos.shape[0]
    out_bytes = sum(torch.empty((), dtype=d).element_size() for _, d in FIELDS)
    nbytes = n * (2 * WIDTH + 12) + n * out_bytes
    prefix = out["prefix_len"].cpu().numpy().astype(np.int64)
    rlw = np.minimum(rl, WIDTH)
    mnv = (rl == al) & ~((rl == 1) & (al == 1))
    ops = int(n * 48 + 2 * (np.minimum(prefix + 1, WIDTH)).sum()
              + 2 * np.where(mnv, rlw, 0).sum()
              + 2 * np.maximum(np.minimum(rlw - 1, WIDTH), 0).sum())
    bytes_ms = nbytes / MEM_BYTES_PER_S * 1e3
    ops_ms = ops / INT32_OPS_PER_S * 1e3
    row = {
        "name": "annotate_bin", "route": "cuda",
        "source": "annotatedvdb_tpu_torch/csrc/annotate_bin.cu",
        "replaces": "annotatedvdb_tpu/ops/annotate_pallas.py:206",
        "launches": None,
        "max_abs_err": max(c["max_abs_err"] for c in checks),
        "ms": best("kernel"), "plain_ms": best("plain"),
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,
    }
    emit("kernels", checks=checks, rows_timed=n, width=WIDTH,
         timing_runs=runs,
         bytes=nbytes, ops=ops, bytes_ms=bytes_ms, ops_ms=ops_ms)
    return [row]


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


def load_phases(torch, platform, n4, n5, n6, launches) -> dict:
    """Phases 4-6 on ``platform`` ("cuda" on the card; "cpu" rehearses the
    same control flow at a small size).  ``launches`` is the kernel launch
    counter dict, already reset; it is read right after the phase-4 load.
    Raises AssertionError on any failed check."""
    from annotatedvdb_tpu_torch.cli.load_vcf import main as load_vcf
    from annotatedvdb_tpu_torch.loaders import VcfLoader
    from annotatedvdb_tpu_torch.runtime import resolve_device
    from annotatedvdb_tpu_torch.store import AlgorithmLedger, VariantStore

    device = resolve_device(platform)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    vcf4 = os.path.join(WORK, "chr22.first.vcf")
    vcf5 = os.path.join(WORK, "chr22.second.vcf")
    vcf6 = os.path.join(WORK, "chr22.head.vcf")
    t0 = time.perf_counter()
    lines4, rows4, dup_lines = write_phase4_vcf(vcf4, n4)
    dup5, new5 = write_phase5_vcf(vcf5, n5, lines4, rows4)
    with open(vcf4) as src, open(vcf6, "w") as dst:
        dst.write(HEADER)
        data = (ln for ln in src if not ln.startswith("#"))
        dst.writelines(next(data) for _ in range(n6))
    gen_s = time.perf_counter() - t0
    dup4 = int(rows4[dup_lines].sum())
    ins4 = int(rows4.sum())
    del lines4

    # 4. the main path: the CLI load
    store4 = os.path.join(WORK, "store")
    t0 = time.perf_counter()
    rc = load_vcf(["--fileName", vcf4, "--storeDir", store4, "--commit",
                   "--logAfter", "0", "--platform", platform])
    sync()
    wall = time.perf_counter() - t0
    launched = dict(launches)
    assert rc == 0, f"load-vcf exited {rc}"
    counters = ledger_records(store4, "finish")[-1]["counters"]
    chunks = len(ledger_records(store4, "checkpoint"))
    emit("load", lines=counters["line"], variants=counters["variant"],
         duplicates=counters["duplicates"], skipped=counters["skipped"],
         malformed=counters.get("malformed"), chunks=chunks, wall_s=wall,
         lines_per_s=counters["line"] / wall,
         variants_per_s=counters["variant"] / wall, launches=launched,
         predicted_duplicates=dup4, predicted_inserts=ins4, vcf_seconds=gen_s)
    assert chunks > 0
    assert counters["line"] == n4 and counters.get("malformed") == 1, counters
    assert (counters["duplicates"], counters["variant"]) == (dup4, ins4), (
        f"load: {counters['duplicates']} duplicates / {counters['variant']} "
        f"inserts, predicted {dup4} / {ins4}")

    # 5. reload, membership probed on the device
    os.environ["AVDB_DEVICE_LOOKUP"] = "always"
    try:
        store = VariantStore.load(store4)
        loader = VcfLoader(
            store, AlgorithmLedger(os.path.join(store4, "ledger.jsonl")),
            log=lambda *a: None, device=device,
        )
        t0 = time.perf_counter()
        c5 = loader.load_file(vcf5, commit=True,
                              persist=lambda: store.save(store4))
        store.save(store4)
        sync()
        wall5 = time.perf_counter() - t0
    finally:
        del os.environ["AVDB_DEVICE_LOOKUP"]
    cached = [s for sh in store.shards.values() for s in sh.segments
              if s._device is not None]
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

    # 6. device vs CPU, end to end
    out = {}
    for plat in (platform, "cpu"):
        d = os.path.join(WORK, f"store.{len(out)}.{plat}")
        t0 = time.perf_counter()
        rc = load_vcf(["--fileName", vcf6, "--storeDir", d, "--commit",
                       "--logAfter", "0", "--platform", plat])
        assert rc == 0, f"phase 6 load on {plat} exited {rc}"
        with open(vcf6 + ".mapping", "rb") as f:
            mapping = f.read()
        out[len(out)] = (store_bytes(d), mapping, time.perf_counter() - t0)
    (files_dev, map_dev, s_dev), (files_cpu, map_cpu, s_cpu) = out[0], out[1]
    differ = sorted(k for k in set(files_dev) | set(files_cpu)
                    if files_dev.get(k) != files_cpu.get(k))
    emit("parity", lines=n6, files=len(files_dev), differ=differ,
         mapping_equal=map_dev == map_cpu, device_s=s_dev, cpu_s=s_cpu)
    assert not differ and map_dev == map_cpu, (
        f"device and CPU stores differ in {differ or ['mapping']}")
    return {"launches": launched, "chunks": chunks}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is False: this smoke needs a CUDA card")
    sys.path.insert(0, ROOT)
    try:
        from annotatedvdb_tpu_torch.ops import annotate_cuda, build
        from annotatedvdb_tpu_torch.runtime import resolve_device
    except ImportError as err:
        return fail(f"the annotatedvdb_tpu_torch package is not beside this "
                    f"script ({err})")
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

    # 2. build: every kernel from this checkout's sources
    shutil.rmtree(build.BUILD_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    logs = build.build()
    emit("build", seconds=time.perf_counter() - t0, kernels=sorted(logs),
         ptxas={k: [ln for ln in v.splitlines() if "registers" in ln or "smem" in ln]
                for k, v in logs.items()})

    try:
        # 3. kernels against their plain versions
        table = kernel_phase(torch, device)
        # 4-6. the load, the probed reload and the card-vs-CPU parity
        for name in annotate_cuda.LAUNCHES:
            annotate_cuda.LAUNCHES[name] = 0
        results = load_phases(torch, "cuda", 2_000_000, 500_000, 50_000,
                              launches=annotate_cuda.LAUNCHES)
    except AssertionError as err:
        return fail(str(err))
    table[0]["launches"] = results["launches"]["annotate_bin"]
    if results["launches"]["annotate_bin"] < results["chunks"]:
        return fail(f"annotate_bin launched {results['launches']['annotate_bin']}"
                    f" times for {results['chunks']} chunks")

    print(json.dumps({"kernels": table}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
