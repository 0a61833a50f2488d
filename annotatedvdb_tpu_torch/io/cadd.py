"""CADD score-table ingest: streamed per-chromosome blocks for the join.

Port of ``annotatedvdb_tpu/io/cadd.py``.  The reference system reads two
tabix-indexed TSVs — ``whole_genome_SNVs.tsv.gz`` and
``gnomad.genomes.r3.0.indel.tsv.gz`` (``cadd_updater.py:21-22``) — one
htslib fetch per variant.  Here the table is streamed sequentially (the
tables are sorted by (chrom, pos), which is what makes them
tabix-indexable in the first place) and materialized into fixed-capacity,
sentinel-padded numpy blocks that feed ``ops/cadd_join.cadd_join``.

Long-allele handling: device arrays are width-truncated, so byte equality
is only exact for alleles within the width.  Any *position* that carries a
row with an over-width allele is excluded from the device arrays wholesale
and recorded in the block's ``host_rows`` side table (full strings, file
order) — the updater replays the reference's matching semantics for those
positions on the host, preserving first-match-wins order exactly.

Two scanners cut the same blocks: the C++ tokenizer (``native/cadd.py``,
the default; a failed build raises) and the Python loop, taken only under
``AVDB_NATIVE_CADD=0`` or ``engine="python"`` (the updater pins it when a
``--maxErrors`` budget needs per-line accounting).

Columns follow the CADD distribution format: ``#Chrom  Pos  Ref  Alt
RawScore  PHRED``; header lines start with ``#``.  CADD names the
mitochondrial chromosome ``MT`` where the store uses ``M``
(``cadd_updater.py:170-171`` does the same fold).
"""

from __future__ import annotations

import gzip
import os
from typing import Iterator

import numpy as np

from annotatedvdb_tpu_torch.types import (
    chromosome_code,
    decode_allele,
    encode_allele_array,
)
from annotatedvdb_tpu_torch.utils.arrays import POS_SENTINEL, next_pow2

# Canonical file names from the CADD distribution (cadd_updater.py:21-22).
CADD_SNV_FILE = "whole_genome_SNVs.tsv.gz"
CADD_INDEL_FILE = "gnomad.genomes.r3.0.indel.tsv.gz"

INDEX_SUFFIX = ".avdx.npz"


class _PlainRandomReader:
    """seek/readline over an uncompressed TSV (offsets are byte offsets)."""

    def __init__(self, path: str):
        self._fh = open(path, "rb")
        self.bytes_read = 0

    def seek(self, offset: int) -> None:
        self._fh.seek(offset)

    def tell(self) -> int:
        return self._fh.tell()

    def readline(self) -> bytes:
        line = self._fh.readline()
        self.bytes_read += len(line)
        return line

    def close(self) -> None:
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def open_random(path: str):
    """Random-access reader for a score table: BGZF (the CADD distribution
    format) or plain text.  Single-member gzip cannot be seeked — re-compress
    with :func:`annotatedvdb_tpu_torch.io.bgzf.compress_to_bgzf`."""
    from annotatedvdb_tpu_torch.io.bgzf import BgzfReader, is_bgzf

    if is_bgzf(path):
        return BgzfReader(path)
    if path.endswith(".gz"):
        raise ValueError(
            f"{path}: plain gzip is not seekable; re-compress with "
            "annotatedvdb_tpu_torch.io.bgzf.compress_to_bgzf (the real CADD "
            "distribution is already BGZF)"
        )
    return _PlainRandomReader(path)


class CaddIndex:
    """Block-offset sidecar enabling O(log n) position seeks into a score
    table — the tabix-index equivalent (``cadd_updater.py:167-184`` does one
    ``pysam`` fetch per variant; here one ``build`` pass writes
    ``<table>.avdx.npz`` and ``fetch`` binary-searches it).

    The index records (chromosome, position, virtual offset) every
    ``stride`` data lines plus at every chromosome change; a fetch seeks to
    the last entry at-or-before the wanted position and scans forward."""

    def __init__(self, chrom: np.ndarray, pos: np.ndarray,
                 voffset: np.ndarray, stride: int):
        self.chrom = chrom
        self.pos = pos
        self.voffset = voffset
        self.stride = stride
        # composite sort key for the binary search
        self._key = (chrom.astype(np.int64) << np.int64(32)) | pos.astype(
            np.int64
        )

    @staticmethod
    def path_for(table_path: str) -> str:
        return table_path + INDEX_SUFFIX

    @classmethod
    def build(cls, table_path: str, stride: int = 4096) -> "CaddIndex":
        """One sequential pass recording seek points; writes the sidecar."""
        chroms, positions, offsets = [], [], []
        with open_random(table_path) as reader:
            reader.seek(0)
            n_since, last_code, last_key = stride, None, -1
            while True:
                voff = reader.tell()
                line = reader.readline()
                if not line:
                    break
                if line.startswith(b"#"):
                    continue
                fields = line.split(b"\t", 2)
                if len(fields) < 3:
                    continue
                code = chromosome_code(fields[0].decode())
                if code == 0:
                    continue
                pos = int(fields[1])
                # the binary search + forward scan silently require sorted
                # input — refuse disorder at build time (every line is read
                # here anyway), like tabix, instead of writing {}
                # placeholders for skipped rows at update time
                key = (code << 32) | pos
                if key < last_key:
                    raise ValueError(
                        f"{table_path}: not sorted by (chromosome, position) "
                        f"at chr{code}:{pos} — sort the table (chromosomes "
                        "in 1..22,X,Y,M order) before indexing"
                    )
                last_key = key
                n_since += 1
                if code != last_code or n_since >= stride:
                    chroms.append(code)
                    positions.append(pos)
                    offsets.append(voff)
                    n_since = 0
                    last_code = code
        index = cls(
            np.array(chroms, np.int8), np.array(positions, np.int32),
            np.array(offsets, np.int64), stride,
        )
        np.savez_compressed(
            cls.path_for(table_path),
            chrom=index.chrom, pos=index.pos, voffset=index.voffset,
            stride=np.int64(stride),
            table_size=np.int64(os.path.getsize(table_path)),
        )
        return index

    @classmethod
    def load(cls, table_path: str) -> "CaddIndex | None":
        """Load the sidecar; None when absent or stale (table re-written)."""
        sidecar = cls.path_for(table_path)
        if not os.path.exists(sidecar):
            return None
        data = np.load(sidecar)
        if int(data["table_size"]) != os.path.getsize(table_path):
            return None  # table changed since indexing
        return cls(
            data["chrom"], data["pos"], data["voffset"], int(data["stride"])
        )

    def seek_point(self, chrom_code: int, pos: int) -> int:
        """Virtual offset of the last index entry STRICTLY before
        (chrom, pos) — an entry can land mid-run at a position, so seeking
        to an at-position entry could skip that site's earlier rows.  Falls
        back to the table start when nothing precedes (the forward scan's
        early break bounds the cost)."""
        key = (np.int64(chrom_code) << np.int64(32)) | np.int64(pos)
        i = int(np.searchsorted(self._key, key, side="left")) - 1
        return 0 if i < 0 else int(self.voffset[i])

    def fetch(self, reader, chrom_code: int, pos: int) -> list:
        """Score rows exactly at (chrom, pos): [(ref, alt, raw, phred), ...]
        in file order — the reference's ``match`` fetch
        (``cadd_updater.py:175-184``)."""
        reader.seek(self.seek_point(chrom_code, pos))
        return self._scan(reader, chrom_code, pos)[0]

    def fetch_sorted(self, reader, chrom_code: int, positions) -> Iterator[list]:
        """:meth:`fetch` for each of ``positions`` in turn.  Where the
        positions ascend and the index has no seek point past the line that
        ended the last scan, the scan resumes at that line instead of
        seeking back up to ``stride`` lines: the table is sorted, so the
        lines in between lie before the position.  A repeated position
        reuses its rows.  The rows, and the blocks read, are those of one
        ``fetch`` per position."""
        last, rows, resume = None, [], None
        for pos in positions:
            if pos != last:
                start = self.seek_point(chrom_code, pos)
                if last is not None and pos > last and resume is None:
                    rows = []  # the last scan reached the end of the table
                else:
                    if last is None or pos < last or start > resume:
                        resume = start
                    reader.seek(resume)
                    rows, resume = self._scan(reader, chrom_code, pos)
                last = pos
            yield rows

    @staticmethod
    def _scan(reader, chrom_code: int, pos: int) -> tuple[list, int | None]:
        """The rows at (chrom, pos) from the reader's cursor on, and the
        virtual offset of the line that ended the scan (None at the end of
        the table)."""
        out: list = []
        while True:
            voff = reader.tell()
            line = reader.readline()
            if not line:
                return out, None
            if line.startswith(b"#"):
                continue
            fields = line.rstrip(b"\n").split(b"\t")
            if len(fields) < 6:
                continue
            code = chromosome_code(fields[0].decode())
            p = int(fields[1])
            if (code == chrom_code and p > pos) or code > chrom_code:
                return out, voff
            if code == chrom_code and p == pos:
                out.append(
                    (fields[2].decode(), fields[3].decode(),
                     float(fields[4]), float(fields[5]))
                )


class CaddBlock:
    """One sentinel-padded score block (all device arrays share capacity C)."""

    def __init__(self, pos, ref, alt, raw, phred, n, max_run, host_rows):
        self.pos = pos          # [C] int32, pos-sorted, SENTINEL beyond n
        self.ref = ref          # [C, W] uint8
        self.alt = alt          # [C, W] uint8
        self.raw = raw          # [C] float64 (host gather — text-parse exact)
        self.phred = phred      # [C] float64
        self.n = n              # real device rows
        self.max_run = max_run  # longest same-position device run (probe check)
        # pos -> [(ref, alt, raw, phred), ...] in file order, for positions
        # containing an over-width allele (host replay path)
        self.host_rows: dict[int, list] = host_rows
        self._all_pos = sorted(
            set(host_rows) | set(int(p) for p in pos[:n].tolist())
        )

    @property
    def min_pos(self) -> int:
        return self._all_pos[0] if self._all_pos else POS_SENTINEL

    @property
    def max_pos(self) -> int:
        return self._all_pos[-1] if self._all_pos else 0


def _open_text(path: str):
    if path.endswith(".gz"):
        return gzip.open(path, "rt", encoding="utf-8")
    return open(path, "r", encoding="utf-8")


class CaddFileReader:
    """Streams score rows as padded per-chromosome blocks.

    ``block_rows`` is the block capacity; blocks never split a same-position
    run across a boundary (a split run could hide the matching row from the
    probe window), so the trailing run is peeled back and re-queued for the
    next block.  Blocks also never span a chromosome change.
    """

    def __init__(self, path: str, width: int, block_rows: int = 1 << 18,
                 on_reject=None, engine: str = "auto"):
        self.path = path
        self.width = width
        self.block_rows = block_rows
        #: ``on_reject(line_no, raw_line, reason)`` for malformed score rows
        #: — the quarantine hook.  Only the Python scanner sees line
        #: content; callers that need ENFORCED error accounting (an armed
        #: ``--maxErrors`` budget) pass ``engine="python"``.
        self.on_reject = on_reject
        if engine not in ("auto", "python", "native"):
            raise ValueError(f"unknown engine {engine!r}")
        self.engine = engine

    def blocks_all(self) -> Iterator[tuple[int, "CaddBlock"]]:
        """One sequential pass over the whole table, yielding
        (chromosome_code, block) — the multi-chromosome path (the
        reference system instead re-opens the tabix file per chromosome
        worker).

        Takes the native C++ tokenizer (columnar fills, no per-line Python)
        unless ``engine="python"`` or ``AVDB_NATIVE_CADD=0``; a failed
        native build raises rather than falling back.  Both scanners cut
        identical blocks (``tests/test_torch_cadd.py``)."""
        if (self.engine != "python"
                and os.environ.get("AVDB_NATIVE_CADD", "1") != "0"):
            yield from self._blocks_all_native()
            return
        yield from self._blocks_all_python()

    def _blocks_all_python(self) -> Iterator[tuple[int, "CaddBlock"]]:
        rows: list[tuple[int, str, str, float, float]] = []
        current_code = None
        reject = self.on_reject
        with _open_text(self.path) as fh:
            for line_no, line in enumerate(fh, start=1):
                if line.startswith("#"):
                    continue
                fields = line.rstrip("\n").split("\t")
                if len(fields) < 6:
                    if reject is not None and line.strip():
                        reject(line_no, line.rstrip("\n"),
                               "malformed CADD row (needs 6 tab-separated "
                               "fields: chrom pos ref alt raw phred)")
                    continue
                code = chromosome_code(fields[0])
                if code == 0:
                    continue  # non-standard contig: policy skip, not an error
                try:
                    row = (int(fields[1]), fields[2], fields[3],
                           float(fields[4]), float(fields[5]))
                except ValueError:
                    # malformed numerics: skip, like the tokenizer
                    if reject is not None:
                        reject(line_no, line.rstrip("\n"),
                               "malformed CADD row (non-numeric pos/score)")
                    continue
                if not 0 < row[0] <= 0x7FFFFFFF or not fields[2] or not fields[3]:
                    if reject is not None:
                        reject(line_no, line.rstrip("\n"),
                               "malformed CADD row (position out of range "
                               "or empty allele)")
                    continue
                if code != current_code:
                    if rows:
                        yield current_code, self._build(rows)
                        rows = []
                    current_code = code
                rows.append(row)
                if len(rows) >= self.block_rows:
                    emit, rows = self._split_on_run(rows)
                    if emit:
                        yield current_code, self._build(emit)
        if rows:
            yield current_code, self._build(rows)

    def blocks(self, chrom_code_target: int) -> Iterator["CaddBlock"]:
        """Blocks for a single chromosome (early exit once past it)."""
        seen = False
        for code, block in self.blocks_all():
            if code == chrom_code_target:
                seen = True
                yield block
            elif seen:
                break  # sorted file: past the target chromosome

    def _blocks_all_native(self) -> Iterator[tuple[int, "CaddBlock"]]:
        """Columnar streaming: concatenate native fills into a pending
        column buffer, emit blocks at chromosome changes and at capacity
        (peeling the trailing same-position run, like the Python path)."""
        from annotatedvdb_tpu_torch.native import cadd as native_cadd

        cols = ("chrom", "pos", "ref", "alt", "ref_len", "alt_len",
                "raw", "phred", "ref_str", "alt_str")
        pend: dict | None = None

        def emit_ready(pend, final: bool):
            """Yield (code, block, remainder) splits from the pending buffer."""
            while pend is not None and pend["pos"].size:
                chrom = pend["chrom"]
                n = chrom.shape[0]
                # run of the leading chromosome
                change = np.flatnonzero(chrom != chrom[0])
                b = int(change[0]) if change.size else n
                if b >= self.block_rows:
                    # >=, not >: the Python loop peels/emits the moment a
                    # chromosome's accumulated rows REACH capacity, and the
                    # two engines must segment identically (parity test)
                    cut = min(b, self.block_rows)
                    # never split a same-position run across blocks
                    last = pend["pos"][cut - 1]
                    while cut > 0 and pend["pos"][cut - 1] == last:
                        cut -= 1
                    if cut == 0:
                        # degenerate single-position run filling the whole
                        # capacity: the Python engine emits exactly
                        # block_rows rows (mid-run) — mirror it
                        cut = min(b, self.block_rows)
                elif change.size or final:
                    cut = b
                else:
                    return pend  # incomplete chromosome run: wait for more
                code = int(chrom[0])
                head = {k: pend[k][:cut] for k in cols}
                pend = (
                    {k: pend[k][cut:] for k in cols} if cut < n else None
                )
                yield code, self._build_columns(head)
            return pend

        def drain(gen):
            # the generator both yields blocks AND returns the remainder
            nonlocal pend
            while True:
                try:
                    item = next(gen)
                except StopIteration as stop:
                    pend = stop.value
                    return
                yield item

        for fill in native_cadd.scan(self.path, self.block_rows, self.width):
            if pend is None:
                pend = fill
            else:
                pend = {
                    k: np.concatenate([pend[k], fill[k]]) for k in cols
                }
            yield from drain(emit_ready(pend, final=False))
        if pend is not None and pend["pos"].size:
            yield from drain(emit_ready(pend, final=True))

    def _build_columns(self, colsd: dict) -> "CaddBlock":
        """CaddBlock from one chromosome-uniform column slice — the
        vectorized twin of :meth:`_build` (host rows = positions carrying
        any over-width allele, strings from the tokenizer's span decode)."""
        width = self.width
        pos_a = colsd["pos"]
        over = (colsd["ref_len"] > width) | (colsd["alt_len"] > width)
        if over.any():
            long_pos = np.unique(pos_a[over])
            host_mask = np.isin(pos_a, long_pos)
        else:
            host_mask = np.zeros(pos_a.shape, bool)
        host_rows: dict[int, list] = {}
        for i in np.where(host_mask)[0]:
            r = colsd["ref_str"][i]
            a = colsd["alt_str"][i]
            if r is None:
                r = decode_allele(colsd["ref"][i], int(colsd["ref_len"][i]))
            if a is None:
                a = decode_allele(colsd["alt"][i], int(colsd["alt_len"][i]))
            host_rows.setdefault(int(pos_a[i]), []).append(
                (r, a, float(colsd["raw"][i]), float(colsd["phred"][i]))
            )
        dev = ~host_mask
        n = int(dev.sum())
        cap = next_pow2(max(n, 1))
        pos = np.full((cap,), POS_SENTINEL, np.int32)
        raw = np.zeros((cap,), np.float64)
        phred = np.zeros((cap,), np.float64)
        ref = np.zeros((cap, width), np.uint8)
        alt = np.zeros((cap, width), np.uint8)
        if n:
            pos[:n] = pos_a[dev]
            raw[:n] = colsd["raw"][dev]
            phred[:n] = colsd["phred"][dev]
            ref[:n] = colsd["ref"][dev]
            alt[:n] = colsd["alt"][dev]
            runs = np.diff(np.flatnonzero(
                np.diff(pos[:n], prepend=-1, append=-2)
            ))
            max_run = int(runs.max()) if runs.size else 0
        else:
            max_run = 0
        return CaddBlock(pos, ref, alt, raw, phred, n, max_run, host_rows)

    @staticmethod
    def _split_on_run(rows):
        """Peel the trailing same-position run back into the carry-over list."""
        last_pos = rows[-1][0]
        cut = len(rows)
        while cut > 0 and rows[cut - 1][0] == last_pos:
            cut -= 1
        if cut == 0:  # entire block is one run; emit as-is (degenerate input)
            return rows, []
        return rows[:cut], rows[cut:]

    def _build(self, rows) -> CaddBlock:
        # positions carrying any over-width allele go to the host side table
        long_pos = {
            r[0] for r in rows if len(r[1]) > self.width or len(r[2]) > self.width
        }
        host_rows: dict[int, list] = {}
        device = []
        for r in rows:
            if r[0] in long_pos:
                host_rows.setdefault(r[0], []).append((r[1], r[2], r[3], r[4]))
            else:
                device.append(r)
        n = len(device)
        cap = next_pow2(max(n, 1))
        pos = np.full((cap,), POS_SENTINEL, np.int32)
        raw = np.zeros((cap,), np.float64)
        phred = np.zeros((cap,), np.float64)
        ref = np.zeros((cap, self.width), np.uint8)
        alt = np.zeros((cap, self.width), np.uint8)
        if n:
            pos[:n] = [r[0] for r in device]
            raw[:n] = [r[3] for r in device]
            phred[:n] = [r[4] for r in device]
            ref[:n], _ = encode_allele_array([r[1] for r in device], self.width)
            alt[:n], _ = encode_allele_array([r[2] for r in device], self.width)
            runs = np.diff(np.flatnonzero(np.diff(pos[:n], prepend=-1, append=-2)))
            max_run = int(runs.max()) if runs.size else 0
        else:
            max_run = 0
        return CaddBlock(pos, ref, alt, raw, phred, n, max_run, host_rows)
