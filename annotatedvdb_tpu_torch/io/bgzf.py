"""BGZF (block-gzip) random access: the htslib/tabix seek primitive.

Port of ``annotatedvdb_tpu/io/bgzf.py``; the whole module is host-only.
The reference system reaches random access into the ~80GB CADD tables
through htslib's tabix via pysam (``cadd_updater.py:9,78-81,167-184``).
The underlying mechanism is BGZF: the file is a concatenation of
independent gzip members (<=64KB uncompressed each), every member carrying
its own compressed size in a gzip extra field (``BC``), so a reader can
jump to any member boundary and inflate just that block.  A *virtual
offset* addresses ``(compressed block start << 16) | offset within the
inflated block``.

This module implements the format from the specification (SAM/BAM spec
section 4.1) — reader, virtual-offset seeks, and a writer (used by tests,
by ``chip_smoke.py``'s table generator and by re-compression tooling).
Plain ``.gz`` files produced by ordinary gzip are a single member and
cannot be seeked; ``is_bgzf`` distinguishes them.
"""

from __future__ import annotations

import struct
import zlib

#: magic of a BGZF member: gzip header with FLG.FEXTRA and the BC subfield
_BGZF_HEADER_START = b"\x1f\x8b\x08\x04"

#: the 28-byte empty terminator block every BGZF file ends with
BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000"
)

_MAX_BLOCK = 0x10000  # 64KB uncompressed per block


def is_bgzf(path: str) -> bool:
    """True when the file starts with a BGZF member (gzip + BC extra)."""
    with open(path, "rb") as fh:
        head = fh.read(18)
    if len(head) < 18 or head[:4] != _BGZF_HEADER_START:
        return False
    xlen = struct.unpack("<H", head[10:12])[0]
    # scan extra subfields for SI1='B' SI2='C'
    with open(path, "rb") as fh:
        fh.seek(12)
        extra = fh.read(xlen)
    i = 0
    while i + 4 <= len(extra):
        si1, si2, slen = extra[i], extra[i + 1], struct.unpack(
            "<H", extra[i + 2:i + 4]
        )[0]
        if si1 == 0x42 and si2 == 0x43 and slen == 2:
            return True
        i += 4 + slen
    return False


class BgzfReader:
    """Random-access reader over a BGZF file.

    ``read_block(coffset)`` inflates the member starting at compressed
    offset ``coffset`` and returns (data, next_coffset).  ``seek(voffset)``
    positions the line cursor at a virtual offset; ``readline()`` then
    streams lines across block boundaries.  A small LRU of inflated blocks
    makes pos-adjacent fetches cheap (the reference gets the same from
    htslib's block cache)."""

    def __init__(self, path: str, cache_blocks: int = 32):
        self.path = path
        self._fh = open(path, "rb")
        self._cache: dict[int, tuple[bytes, int]] = {}
        self._cache_order: list[int] = []
        self._cache_blocks = cache_blocks
        self._coffset = 0
        self._next = 0  # fresh readers stream from the first block
        self._block: bytes = b""
        self._within = 0
        #: compressed bytes actually read (tests assert subset updates
        #: touch a small fraction of the table)
        self.bytes_read = 0

    def close(self) -> None:
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- block layer --------------------------------------------------------

    def read_block(self, coffset: int) -> tuple[bytes, int]:
        """Inflate the member at compressed offset; returns (data, next)."""
        cached = self._cache.get(coffset)
        if cached is not None:
            return cached
        self._fh.seek(coffset)
        header = self._fh.read(18)
        if len(header) < 18:
            return b"", coffset  # EOF
        if header[:4] != _BGZF_HEADER_START:
            raise ValueError(
                f"{self.path}: not a BGZF member at offset {coffset} "
                "(plain gzip files cannot be seeked; re-compress with bgzip)"
            )
        xlen = struct.unpack("<H", header[10:12])[0]
        extra = header[12:18]
        if xlen > 6:
            extra += self._fh.read(xlen - 6)
        bsize = None
        i = 0
        while i + 4 <= len(extra):
            si1, si2, slen = extra[i], extra[i + 1], struct.unpack(
                "<H", extra[i + 2:i + 4]
            )[0]
            if si1 == 0x42 and si2 == 0x43 and slen == 2:
                bsize = struct.unpack("<H", extra[i + 4:i + 6])[0] + 1
                break
            i += 4 + slen
        if bsize is None:
            raise ValueError(f"{self.path}: BGZF member without BC field")
        # compressed data = total member minus header(12+xlen) and crc+isize
        cdata_len = bsize - 12 - xlen - 8
        cdata = self._fh.read(cdata_len)
        crc, isize = struct.unpack("<II", self._fh.read(8))
        data = zlib.decompress(cdata, wbits=-15)
        if len(data) != isize or (data and zlib.crc32(data) != crc):
            raise ValueError(f"{self.path}: corrupt BGZF block at {coffset}")
        self.bytes_read += bsize
        entry = (data, coffset + bsize)
        self._cache[coffset] = entry
        self._cache_order.append(coffset)
        if len(self._cache_order) > self._cache_blocks:
            del self._cache[self._cache_order.pop(0)]
        return entry

    # -- line cursor --------------------------------------------------------

    def seek(self, voffset: int) -> None:
        self._coffset = voffset >> 16
        self._within = voffset & 0xFFFF
        self._block, self._next = self.read_block(self._coffset)

    def tell(self) -> int:
        return (self._coffset << 16) | self._within

    def readline(self) -> bytes:
        """Next line at the cursor (empty bytes at EOF).  An empty inflated
        block is the BGZF terminator — treated as EOF."""
        parts: list[bytes] = []
        while True:
            if self._within < len(self._block):
                nl = self._block.find(b"\n", self._within)
                if nl != -1:
                    parts.append(self._block[self._within:nl + 1])
                    self._within = nl + 1
                    return b"".join(parts)
                parts.append(self._block[self._within:])
                self._within = len(self._block)
            data, nxt = self.read_block(self._next)
            if not data:
                return b"".join(parts)
            self._coffset, self._block, self._next = self._next, data, nxt
            self._within = 0


class BgzfWriter:
    """Minimal spec-conforming BGZF writer (tests + re-compression)."""

    def __init__(self, path: str, level: int = 6):
        self._fh = open(path, "wb")
        self._level = level
        self._buf = bytearray()

    def write(self, data: bytes) -> None:
        self._buf += data
        while len(self._buf) >= _MAX_BLOCK - 1:
            self._flush_block(bytes(self._buf[:_MAX_BLOCK - 1]))
            del self._buf[:_MAX_BLOCK - 1]

    def _flush_block(self, data: bytes) -> None:
        co = zlib.compressobj(self._level, zlib.DEFLATED, -15)
        cdata = co.compress(data) + co.flush()
        bsize = len(cdata) + 12 + 6 + 8  # header(12) + BC extra(6) + crc/isize
        if bsize > 0x10000:
            # incompressible window: deflate expanded past the 64KB member
            # limit — halve and retry (htslib caps + retries the same way)
            half = len(data) // 2
            self._flush_block(data[:half])
            self._flush_block(data[half:])
            return
        header = _BGZF_HEADER_START + b"\x00\x00\x00\x00\x00\xff" + struct.pack(
            "<H", 6
        ) + b"BC" + struct.pack("<HH", 2, bsize - 1)
        self._fh.write(header)
        self._fh.write(cdata)
        self._fh.write(struct.pack("<II", zlib.crc32(data), len(data)))

    def close(self) -> None:
        if self._buf:
            self._flush_block(bytes(self._buf))
            self._buf.clear()
        self._fh.write(BGZF_EOF)
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def compress_to_bgzf(src_path: str, dst_path: str | None = None) -> str:
    """Re-compress a text/gzip file as BGZF (the seekable format the
    random-access CADD mode requires; the real CADD distribution is
    already BGZF)."""
    import gzip

    if dst_path is None:
        base = src_path[:-3] if src_path.endswith(".gz") else src_path
        dst_path = base + ".bgz"
    opener = gzip.open if src_path.endswith(".gz") else open
    with opener(src_path, "rb") as src, BgzfWriter(dst_path) as dst:
        while True:
            chunk = src.read(1 << 20)
            if not chunk:
                break
            dst.write(chunk)
    return dst_path
