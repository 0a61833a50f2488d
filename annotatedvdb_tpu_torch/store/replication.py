"""WAL/ledger shipping replication: leader ship surface + follower tailer.

Port of ``annotatedvdb_tpu/store/replication.py``; the wire (routes,
ship document, byte ranges, cursor ledger) is the reference's, so a port
follower tails a reference leader and a reference follower a port
leader.  The original AnnotatedVDB delegates availability to Postgres
streaming replication; this store replicates itself with the pieces it
already has.  A **leader** is any ordinary serving fleet — it publishes
nothing actively.  A **follower** (``serve --follow <leader-url>``) pulls
a consistent snapshot cut and then tails the leader's write stream over
the leader's existing HTTP plane (``GET /repl/{manifest,segment,wal}``):

- **snapshot cut** — the leader's ``manifest.json`` is the commit point
  for every durable state transition, so "the manifest plus
  every segment file its ``integrity`` table references" IS a consistent
  point-in-time cut.  Bootstrap chunk-streams each referenced segment to
  ``<name>.repl.tmp``, CRC-verifies it against the manifest's own
  integrity record, renames, and only then installs the manifest mirror
  — a kill at any instant leaves attributable ``*.repl.tmp`` debris
  (``fsck`` code ``repl-tmp``) and a resumable cursor, never a torn
  store.
- **WAL tail** — acknowledged-but-unflushed upserts live in the per-worker
  WAL files.  The ship reader serves only each file's **stable prefix**
  (bytes up to the last intact CRC frame, exactly what replay would
  apply), so a rotation race or a torn tail can never ship a torn frame.
  The follower byte-mirrors those prefixes into its own store directory
  (append + fsync — the shipped rows are durable on the follower before
  they count as applied) and applies the new records through the same
  memtable/overlay machinery a leader's own replay uses, so follower
  reads are byte-identical to the leader at the applied LSN.  An LSN is
  ``(wal file, byte offset)``; the cursor ledger
  (``repl.cursor.json``) persists the mirrored fingerprint + offsets so
  bootstrap and tail are resumable.
- **ledger/flush tracking** — a leader flush/compact/load commit changes
  the manifest fingerprint; the follower re-syncs the cut (new segments
  only — segment files are immutable per stem), mirrors ``ledger.jsonl``
  (whole lines only), resets its overlay, and re-applies whatever WAL
  files survived the leader's ``discard_sealed``.  Unlike the reference,
  the port re-applies the surviving files' mirrored records from the
  local mirror (the reference's persisting tailer skips them, so rows
  tailed before a compaction vanish from its overlay until the next
  leader flush), and its re-sync unlinks the segment files the previous cut
  referenced and the new one does not (a compaction's merged-away
  segments), so a follower's directory holds the leader's store and no
  orphans.  First-wins dedup makes
  the overlap window byte-stable: rows present in both the new base cut
  and the overlay render from the base, exactly as on the leader.
- **staleness contract** — ``avdb_replication_lag_seconds`` is seconds
  since the follower last confirmed it held the leader's full stable
  stream.  ``/readyz`` answers 503 once lag exceeds
  ``AVDB_REPL_MAX_LAG_S``; upserts always answer 403 with the leader's
  location.
- **failover** — :func:`promote` seals the follower into a leader: replay
  every mirrored WAL file into segments through the memtable flush path
  (one atomic manifest commit), bump the **fencing epoch**
  (``repl_epoch`` in the manifest), and drop the cursor.  A deposed
  leader that wakes up cannot commit: the flush commit path refuses when
  the on-disk epoch has moved past the epoch the writer opened with
  (``store/memtable.py`` fence check), so a promoted store can never be
  silently overwritten by a stale writer.

Replication is host work, as in the reference: no kernel runs here.  A
follower serves its bootstrapped and tailed generation through the same
engine, and on the card the same kernels, as a leader.  Fault points:
``repl.ship`` (the leader's ship document; a follower's fetched chunk
before it lands), ``repl.apply`` (bootstrap before the manifest mirror;
tail before the overlay applies) and ``repl.promote`` (before anything
mutates; on the staged epoch manifest).
"""

from __future__ import annotations

import json
import os
import re
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
import zlib

from annotatedvdb_tpu_torch.store.wal import (
    _FRAME,
    _WAL_RE,
    MAX_RECORD_BYTES,
    is_wal_file,
)
from annotatedvdb_tpu_torch.utils import faults
from annotatedvdb_tpu_torch.utils import io as tio

#: in-flight bootstrap chunk temp suffix — a distinct namespace (like
#: ``*.flush.tmp*``) so fsck attributes a killed bootstrap's debris
#: (``repl-tmp`` finding, pruned under --repair; recovery = re-run
#: bootstrap, which refetches anything unverified)
REPL_TMP_SUFFIX = ".repl.tmp"

#: the follower's cursor ledger: mirrored manifest fingerprint, leader
#: epoch/url, per-WAL-file byte offsets.  Its presence marks a store
#: directory as a follower mid-sync; a dangling one in a non-follower
#: store is the fsck ``repl-cursor`` finding.
CURSOR_FILE = "repl.cursor.json"

#: segment container names a leader will ship (the manifest's integrity
#: stems + their two extensions); anything else is refused by the ship
#: file surface
_SEGMENT_NAME_RE = re.compile(
    r"^chr[0-9A-Za-z]+\.\d{6}\.(npz|ann\.jsonl)$"
)

LEDGER_FILE = "ledger.jsonl"


def is_repl_tmp(fname: str) -> bool:
    """Whether a store-directory entry is an in-flight (or abandoned)
    replication bootstrap chunk temp."""
    return fname.endswith(REPL_TMP_SUFFIX)


def is_repl_cursor(fname: str) -> bool:
    """Whether an entry is a follower bootstrap/tail cursor ledger."""
    return fname == CURSOR_FILE


# -- knobs (resolved once here) ----------------------------------------------


def repl_max_lag_from_env() -> float:
    """``AVDB_REPL_MAX_LAG_S``: declared staleness bound in seconds — a
    follower whose replication lag exceeds this answers 503 on
    ``/readyz`` (default 5; 0 disables the readiness gate)."""
    raw = os.environ.get("AVDB_REPL_MAX_LAG_S", "").strip()
    if not raw:
        return 5.0
    try:
        return max(float(raw), 0.0)
    except ValueError:
        raise ValueError(
            f"AVDB_REPL_MAX_LAG_S must be a number (got {raw!r})"
        ) from None


def repl_poll_from_env() -> float:
    """``AVDB_REPL_POLL_S``: follower tail poll interval in seconds
    (default 0.5; clamped to >= 0.02)."""
    raw = os.environ.get("AVDB_REPL_POLL_S", "").strip()
    if not raw:
        return 0.5
    try:
        return max(float(raw), 0.02)
    except ValueError:
        raise ValueError(
            f"AVDB_REPL_POLL_S must be a number (got {raw!r})"
        ) from None


def repl_chunk_from_env() -> int:
    """``AVDB_REPL_CHUNK_BYTES``: ship transfer chunk size (default 4m;
    ``512k``/``8m`` suffixes via the shared parser)."""
    raw = os.environ.get("AVDB_REPL_CHUNK_BYTES", "").strip().lower()
    if not raw:
        return 4 << 20
    from annotatedvdb_tpu_torch.utils.strings import parse_bytes

    try:
        return max(parse_bytes(raw), 1 << 12)
    except ValueError as err:
        raise ValueError(f"AVDB_REPL_CHUNK_BYTES: {err}") from None


def repl_timeout_from_env() -> float:
    """``AVDB_REPL_TIMEOUT_S``: per-request HTTP timeout for ship
    fetches (default 10)."""
    raw = os.environ.get("AVDB_REPL_TIMEOUT_S", "").strip()
    if not raw:
        return 10.0
    try:
        return max(float(raw), 0.1)
    except ValueError:
        raise ValueError(
            f"AVDB_REPL_TIMEOUT_S must be a number (got {raw!r})"
        ) from None


class ReplError(RuntimeError):
    """A ship/apply step failed (HTTP error, CRC mismatch, consistency
    race with a leader commit).  The follower's poll loop absorbs it and
    retries the whole cycle — every step is idempotent by design."""


# -- stable prefixes (the ship reader's torn-frame guarantee) ----------------


def stable_wal_prefix(path: str) -> tuple[int, int]:
    """``(byte_offset, records)`` of one WAL file's stable prefix: the
    header line plus every intact CRC frame, ending BEFORE the first
    torn/short/corrupt frame — byte-for-byte what replay would apply.
    Never raises; an unreadable or alien file is ``(0, 0)`` (nothing of
    it may ship)."""
    try:
        with open(path, "rb") as f:
            header = f.readline()
            try:
                head = json.loads(header)
                if not isinstance(head, dict) or head.get("wal") != 1:
                    return 0, 0
            except ValueError:
                return 0, 0
            stable = f.tell()
            n = 0
            while True:
                raw = f.read(_FRAME.size)
                if len(raw) < _FRAME.size:
                    return stable, n
                length, crc = _FRAME.unpack(raw)
                if length > MAX_RECORD_BYTES:
                    return stable, n
                blob = f.read(length)
                if len(blob) < length or zlib.crc32(blob) != crc:
                    return stable, n
                stable = f.tell()
                n += 1
    except OSError:
        return 0, 0


def stable_ledger_prefix(path: str) -> int:
    """Bytes of ``ledger.jsonl`` up to and including the last newline —
    whole records only, so a mid-append tail never ships torn."""
    try:
        with open(path, "rb") as f:
            blob = f.read()
    except OSError:
        return 0
    end = blob.rfind(b"\n")
    return end + 1 if end >= 0 else 0


def read_wal_records(path: str, lo: int, hi: int):
    """Parse the CRC frames of one locally mirrored WAL file between two
    stable-prefix offsets (``lo`` may be 0 = start of file, in which case
    the header line is skipped).  Offsets are frame boundaries by
    construction — the mirror only ever lands whole stable prefixes."""
    out = []
    with open(path, "rb") as f:
        if lo <= 0:
            f.readline()  # header
        else:
            f.seek(lo)
        while f.tell() < hi:
            raw = f.read(_FRAME.size)
            if len(raw) < _FRAME.size:
                break
            length, crc = _FRAME.unpack(raw)
            if length > MAX_RECORD_BYTES:
                break
            blob = f.read(length)
            if len(blob) < length or zlib.crc32(blob) != crc:
                break
            try:
                out.append(json.loads(blob))
            except ValueError:
                break
    return out


def wal_names(store_dir: str) -> list[str]:
    """Distinct WAL stream names (``serve-w0``, …) present in a store
    directory, sorted — a leader fleet ships every worker's stream."""
    names = set()
    try:
        entries = os.listdir(store_dir)
    except OSError:
        return []
    for fname in entries:
        m = _WAL_RE.match(fname)
        if m is not None:
            names.add(m.group("name"))
    return sorted(names)


# -- leader ship surface (used by the serve front ends' /repl routes) --------


def ship_manifest(store_dir: str) -> dict:
    """The leader's ship document: the parsed manifest (the consistent
    cut), its fingerprint, the fencing epoch, and the WAL/ledger stream
    listing with stable-prefix sizes.  One fetch gives the follower a
    consistent ``(manifest, fingerprint, epoch)`` triple; segment bytes
    are then verified against THIS manifest's own integrity records, so
    a leader commit racing the sync is detected (CRC/size mismatch or
    404) and the cycle retries."""
    faults.fire("repl.ship")
    mpath = os.path.join(store_dir, "manifest.json")
    try:
        with open(mpath, "rb") as f:
            blob = f.read()
            st = os.fstat(f.fileno())
        manifest = json.loads(blob)
    except (OSError, ValueError) as err:
        raise ReplError(f"leader manifest unreadable: {err}") from err
    if not isinstance(manifest, dict) or "shards" not in manifest:
        raise ReplError("leader manifest.json is not a store manifest")
    wal = []
    for fname in sorted(os.listdir(store_dir)):
        if not is_wal_file(fname):
            continue
        off, records = stable_wal_prefix(os.path.join(store_dir, fname))
        if off <= 0:
            continue
        wal.append({"file": fname, "bytes": off, "records": records})
    lbytes = stable_ledger_prefix(os.path.join(store_dir, LEDGER_FILE))
    doc = {
        "repl": 1,
        "fingerprint": [st.st_mtime_ns, st.st_size, st.st_ino],
        "epoch": int(manifest.get("repl_epoch", 0) or 0),
        "now": time.time(),
        "manifest": manifest,
        "wal": wal,
    }
    if lbytes > 0:
        doc["ledger"] = {"file": LEDGER_FILE, "bytes": lbytes}
    return doc


def manifest_segment_files(manifest: dict) -> dict[str, dict]:
    """``{file name: {"bytes", "crc32"}}`` for every segment container
    file the manifest's integrity table references — the byte-verifiable
    definition of the snapshot cut."""
    out: dict[str, dict] = {}
    for stem, rec in (manifest.get("integrity") or {}).items():
        if not isinstance(rec, dict):
            continue
        for key, ext in (("npz", ".npz"), ("jsonl", ".ann.jsonl")):
            sub = rec.get(key)
            if isinstance(sub, dict):
                out[stem + ext] = {
                    "bytes": int(sub.get("bytes", 0) or 0),
                    "crc32": int(sub.get("crc32", 0) or 0),
                }
    return out


def ship_file_range(store_dir: str, name: str, offset: int,
                    limit: int) -> bytes | None:
    """Raw bytes of one shippable file, clamped to its stable prefix for
    WAL/ledger streams.  Returns None for a name outside the ship
    namespace (segment containers, WAL files, ``ledger.jsonl``) — the
    route answers 404, never an arbitrary file read."""
    if os.sep in name or name.startswith(".") or "/" in name:
        return None
    path = os.path.join(store_dir, name)
    if _SEGMENT_NAME_RE.match(name):
        hi = None  # segment containers are immutable: any byte may ship
    elif is_wal_file(name):
        hi, _records = stable_wal_prefix(path)
    elif name == LEDGER_FILE:
        hi = stable_ledger_prefix(path)
    else:
        return None
    try:
        with open(path, "rb") as f:
            if hi is not None and offset >= hi:
                return b""
            f.seek(max(int(offset), 0))
            n = max(int(limit), 0)
            if hi is not None:
                n = min(n, hi - f.tell())
            return f.read(n)
    except OSError:
        return None


# -- follower ---------------------------------------------------------------


def _http_get(url: str, timeout: float) -> bytes:
    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            return resp.read()
    except (urllib.error.URLError, OSError, ValueError) as err:
        raise ReplError(f"GET {url}: {err}") from err


def _atomic_write(path: str, blob: bytes) -> None:
    tmp = os.path.join(
        os.path.dirname(path),
        f".{os.path.basename(path)}.tmp{os.getpid()}",
    )
    with tio.open(tmp, "wb") as f:
        f.write(blob)
        f.flush()
        tio.fsync(f)
    tio.replace(tmp, path)


class ReplicaTailer:
    """The follower's ship client: bootstrap + tail + apply.

    ``apply_rows(rows)`` is the overlay hook (the serve path applies to
    its in-memory memtable; :func:`promote` replays from the mirrored
    files instead); ``on_resync()`` fires after a new snapshot cut is
    installed so the serve path can refresh its base snapshot and reset
    the overlay.  The tailer owns the cursor ledger and the lag gauge;
    it never touches the event loop (the serve mode runs :meth:`run` on
    a plain daemon thread)."""

    def __init__(self, store_dir: str, leader_url: str, log=None,
                 registry=None, apply_rows=None, on_resync=None,
                 persist: bool = True, poll_s: float | None = None,
                 max_lag_s: float | None = None,
                 chunk_bytes: int | None = None,
                 timeout_s: float | None = None):
        self.store_dir = store_dir
        self.leader_url = leader_url.rstrip("/")
        self.log = log if log is not None else (lambda msg: None)
        self.apply_rows = apply_rows
        self.on_resync = on_resync
        #: only ONE process may mirror bytes into the store directory; a
        #: follower fleet's workers 1..N tail with persist=False (apply
        #: to their own overlays straight from the fetched bytes)
        self.persist = bool(persist)
        self.poll_s = repl_poll_from_env() if poll_s is None \
            else max(float(poll_s), 0.02)
        self.max_lag_s = repl_max_lag_from_env() if max_lag_s is None \
            else max(float(max_lag_s), 0.0)
        self.chunk_bytes = repl_chunk_from_env() if chunk_bytes is None \
            else max(int(chunk_bytes), 1 << 12)
        self.timeout_s = repl_timeout_from_env() if timeout_s is None \
            else max(float(timeout_s), 0.1)
        self._stop = threading.Event()
        self._thread = None
        #: mirrored leader manifest fingerprint (list, JSON-round-tripped)
        self._fingerprint = None
        self._epoch = 0
        #: per-WAL-file applied byte offset (the LSN vector)
        self._offsets: dict[str, int] = {}
        #: monotonic time the follower last held the leader's full
        #: stable stream; lag is measured from here
        self._caught_up_t = time.monotonic()
        self._caught_up_once = False
        self._m_lag = self._m_bytes = self._m_records = None
        self._m_resyncs = None
        if registry is not None:
            self._m_lag = registry.gauge(
                "avdb_replication_lag_seconds",
                "seconds since this follower last held the leader's "
                "full stable WAL/ledger stream",
            )
            self._m_bytes = registry.counter(
                "avdb_repl_ship_bytes_total",
                "bytes fetched from the leader's ship surface",
            )
            self._m_records = registry.counter(
                "avdb_repl_records_applied_total",
                "WAL records applied to this follower's overlay",
            )
            self._m_resyncs = registry.counter(
                "avdb_repl_resyncs_total",
                "snapshot-cut re-syncs (leader manifest commits mirrored)",
            )

    # -- lag / staleness contract -------------------------------------------

    def lag_s(self) -> float:
        """Seconds since the follower last confirmed it held the
        leader's full stable stream (0-ish while caught up and polling;
        grows monotonically while shipping is stalled or behind)."""
        return max(time.monotonic() - self._caught_up_t, 0.0)

    def lag_exceeded(self) -> bool:
        """Whether the declared staleness bound is breached (always
        False when the bound is disabled with 0)."""
        return bool(self.max_lag_s) and self.lag_s() > self.max_lag_s

    def _note_caught_up(self) -> None:
        self._caught_up_t = time.monotonic()
        self._caught_up_once = True
        if self._m_lag is not None:
            self._m_lag.set(0.0)

    # -- ship fetch helpers ---------------------------------------------------

    def _fetch_doc(self) -> dict:
        blob = _http_get(self.leader_url + "/repl/manifest",
                         self.timeout_s)
        if self._m_bytes is not None:
            self._m_bytes.inc(len(blob))
        try:
            doc = json.loads(blob)
        except ValueError as err:
            raise ReplError(f"ship manifest unparseable: {err}") from err
        if not isinstance(doc, dict) or doc.get("repl") != 1:
            raise ReplError("ship manifest: not a repl document")
        return doc

    def _fetch_range(self, route: str, name: str, offset: int,
                     limit: int) -> bytes:
        q = urllib.parse.urlencode(
            {"name": name, "offset": offset, "limit": limit}
        )
        blob = _http_get(f"{self.leader_url}{route}?{q}", self.timeout_s)
        if self._m_bytes is not None:
            self._m_bytes.inc(len(blob))
        return blob

    def _fetch_file(self, route: str, name: str, total: int,
                    crc32: int | None, dest_tmp: str) -> None:
        """Chunk-stream one remote file to ``dest_tmp``, verifying size
        (and CRC when given) at the end — a mismatch means the leader
        committed mid-sync; the cycle retries with a fresh cut."""
        got = 0
        with tio.open(dest_tmp, "wb") as f:
            while got < total:
                blob = self._fetch_range(
                    route, name, got, min(self.chunk_bytes, total - got)
                )
                if not blob:
                    break
                # crash point: a fetched chunk is in hand, not yet on
                # local disk — torn_write tears it (the resume-time
                # stable-prefix scan / CRC verify must catch the tear)
                faults.fire("repl.ship", f, payload=blob,
                            tear_base=f.tell())
                f.write(blob)
                got += len(blob)
            f.flush()
            tio.fsync(f)
        if got != total:
            raise ReplError(
                f"{name}: short ship ({got} of {total} bytes); "
                "leader likely committed mid-sync"
            )
        if crc32 is not None:
            with open(dest_tmp, "rb") as f:
                if zlib.crc32(f.read()) != crc32:
                    raise ReplError(f"{name}: ship CRC mismatch")

    # -- cursor ledger --------------------------------------------------------

    def _cursor_path(self) -> str:
        return os.path.join(self.store_dir, CURSOR_FILE)

    def _write_cursor(self) -> None:
        if not self.persist:
            return
        _atomic_write(self._cursor_path(), json.dumps({
            "repl_cursor": 1,
            "leader": self.leader_url,
            "fingerprint": self._fingerprint,
            "epoch": self._epoch,
            "offsets": dict(sorted(self._offsets.items())),
        }, separators=(",", ":")).encode())

    def _load_cursor(self) -> dict | None:
        try:
            with open(self._cursor_path()) as f:
                doc = json.load(f)
        except (OSError, ValueError):
            return None
        return doc if isinstance(doc, dict) \
            and doc.get("repl_cursor") == 1 else None

    # -- bootstrap ------------------------------------------------------------

    def bootstrap(self) -> dict:
        """Install (or resume installing) the leader's snapshot cut into
        the local store directory.  Idempotent and resumable: segment
        files already present with the right size+CRC are kept, partial
        ``*.repl.tmp`` fetches are refetched, and the manifest mirror is
        installed atomically LAST — the local directory is a loadable
        store from the first successful bootstrap on."""
        os.makedirs(self.store_dir, exist_ok=True)
        doc = self._fetch_doc()
        manifest = doc.get("manifest")
        if not isinstance(manifest, dict):
            raise ReplError("ship manifest: missing manifest body")
        fetched = kept = 0
        if self.persist:
            cursor = self._load_cursor()
            resumed = bool(
                cursor and cursor.get("fingerprint") == doc["fingerprint"]
            )
            for name, rec in sorted(
                manifest_segment_files(manifest).items()
            ):
                path = os.path.join(self.store_dir, name)
                if os.path.exists(path) \
                        and os.path.getsize(path) == rec["bytes"]:
                    if resumed:
                        kept += 1
                        continue  # size matched a resumed cut: trust + keep
                    with open(path, "rb") as f:
                        if zlib.crc32(f.read()) == rec["crc32"]:
                            kept += 1
                            continue
                tmp = path + REPL_TMP_SUFFIX
                self._fetch_file("/repl/segment", name, rec["bytes"],
                                 rec["crc32"], tmp)
                tio.replace(tmp, path)
                fetched += 1
        # crash point: every segment landed, the manifest mirror has not
        # — a kill here resumes cleanly (segments verify, manifest
        # refetches); the local store still serves its previous cut
        faults.fire("repl.apply")
        self._fingerprint = doc["fingerprint"]
        self._epoch = int(doc.get("epoch", 0) or 0)
        self._offsets = {}
        self._sync_ledger(doc)
        blob = json.dumps(manifest, separators=(",", ":")).encode()
        if self.persist:
            superseded = self._superseded_files(manifest)
            # replace_manifest rather than the plain cursor writer: the
            # manifest mirror is a real commit point, so under AVDB_FSYNC
            # its rename metadata must be made durable too (the segment
            # renames above share the one directory fsync)
            tio.replace_manifest(
                os.path.join(self.store_dir, "manifest.json"), blob
            )
            self._write_cursor()
            # the mirror's own gc, as the leader's compactor does after
            # its commit: files the previous cut referenced and this one
            # does not (a compaction's merged-away segments).  Serving
            # holds a loaded generation in memory, so readers pinned to
            # the previous cut never need them.  (The reference keeps
            # them, and fsck then warns segment-orphan.)
            for name in superseded:
                try:
                    tio.unlink(os.path.join(self.store_dir, name))
                except OSError:
                    pass  # fsck prunes leftovers (segment-orphan)
        self.log(
            f"repl: bootstrapped cut (epoch {self._epoch}, "
            f"{fetched} segment file(s) fetched, {kept} kept)"
        )
        return {"fetched": fetched, "kept": kept, "epoch": self._epoch}

    def _superseded_files(self, manifest: dict) -> list[str]:
        """Segment files the local (previous) cut references and
        ``manifest`` does not; none when there is no readable local
        manifest."""
        try:
            with open(os.path.join(self.store_dir, "manifest.json")) as f:
                old = json.load(f)
        except (OSError, ValueError):
            return []
        if not isinstance(old, dict):
            return []
        keep = manifest_segment_files(manifest)
        return sorted(n for n in manifest_segment_files(old)
                      if n not in keep)

    def _sync_ledger(self, doc: dict) -> None:
        """Mirror the leader's ledger stable prefix (whole lines)."""
        if not self.persist:
            return
        led = doc.get("ledger")
        if not isinstance(led, dict):
            return
        total = int(led.get("bytes", 0) or 0)
        path = os.path.join(self.store_dir, LEDGER_FILE)
        have = stable_ledger_prefix(path)
        if have >= total:
            return
        blob = self._fetch_range("/repl/wal", LEDGER_FILE, have,
                                 total - have)
        if not blob:
            return
        with tio.open(path, "r+b" if os.path.exists(path) else "wb") as f:
            f.seek(have)
            f.truncate()
            f.write(blob)
            f.flush()
            tio.fsync(f)

    # -- tail -----------------------------------------------------------------

    def resume(self) -> int:
        """Adopt a previous incarnation's cursor (fingerprint + epoch)
        and recover the LSN vector from the locally mirrored WAL files —
        the restart path.  Returns the records already durable locally
        (the serve path re-applies them into a fresh overlay).  With no
        usable cursor this is a no-op and the first :meth:`sync_once`
        bootstraps from scratch (resumable either way)."""
        cursor = self._load_cursor()
        if cursor is None:
            return 0
        self._fingerprint = cursor.get("fingerprint")
        self._epoch = int(cursor.get("epoch", 0) or 0)
        return self.resume_local()

    def resume_local(self) -> int:
        """Recover the LSN vector from the locally mirrored WAL files:
        truncate any torn tail (a kill mid-mirror) back to the local
        stable prefix and return the records already on local disk.  The
        serve path re-applies those records into a fresh overlay before
        tailing continues — restart-safe by construction."""
        recovered = 0
        self._offsets = {}
        for fname in sorted(os.listdir(self.store_dir)) \
                if os.path.isdir(self.store_dir) else []:
            if not is_wal_file(fname):
                continue
            path = os.path.join(self.store_dir, fname)
            stable, records = stable_wal_prefix(path)
            size = os.path.getsize(path)
            if self.persist and size > stable:
                with open(path, "r+b") as f:
                    f.truncate(stable)
            if stable > 0:
                self._offsets[fname] = stable
                recovered += records
        return recovered

    def local_records(self) -> list[dict]:
        """Every intact record across the mirrored WAL files, oldest
        file first — the restart/promote replay source."""
        out = []
        for fname in sorted(
            self._offsets,
            key=lambda f: (_WAL_RE.match(f).group("name"),
                           int(_WAL_RE.match(f).group("seq"))),
        ):
            path = os.path.join(self.store_dir, fname)
            out.extend(read_wal_records(path, 0, self._offsets[fname]))
        return out

    def sync_once(self) -> dict:
        """One tail cycle: fetch the ship document, re-sync the snapshot
        cut if the leader committed, mirror + apply every WAL stream's
        new stable bytes, update the cursor and the lag gauge.  Raises
        :class:`ReplError` on any ship failure (the poll loop retries)."""
        doc = self._fetch_doc()
        epoch = int(doc.get("epoch", 0) or 0)
        if epoch < self._epoch:
            raise ReplError(
                f"leader fencing epoch went backwards ({epoch} < "
                f"{self._epoch}): refusing to follow a deposed leader"
            )
        resynced = False
        if doc["fingerprint"] != self._fingerprint:
            self.bootstrap()
            resynced = True
            if self._m_resyncs is not None:
                self._m_resyncs.inc()
            # leader flush discarded sealed WAL files: drop mirrors that
            # vanished from the stream (their rows are in the new cut)
            live = {w["file"] for w in doc.get("wal") or []}
            if self.persist:
                for fname in list(wal_files(self.store_dir)):
                    if fname not in live:
                        try:
                            tio.unlink(
                                os.path.join(self.store_dir, fname)
                            )
                        except OSError:
                            pass
            self._offsets = {
                f: off for f, off in self._offsets.items() if f in live
            }
            if self.on_resync is not None:
                self.on_resync()
        applied = 0
        if resynced and self.persist:
            # the overlay was reset: the records already mirrored from the
            # surviving WAL files must apply again.  (The reference's
            # tailer restarts each stream at offset 0, finds its mirror
            # non-empty, takes that for drift and never re-applies them:
            # rows tailed before a compaction or a load vanish from the
            # follower until the leader flushes.)
            applied += self._reapply_mirrors(live)
        for entry in doc.get("wal") or []:
            fname = entry.get("file")
            total = int(entry.get("bytes", 0) or 0)
            if not isinstance(fname, str) or not is_wal_file(fname):
                continue
            have = self._offsets.get(fname, 0)
            if total <= have:
                continue
            blob = self._fetch_range("/repl/wal", fname, have,
                                     total - have)
            if not blob:
                continue
            path = os.path.join(self.store_dir, fname)
            if self.persist:
                with tio.open(path, "ab") as f:
                    if f.tell() != have:
                        # mirror drifted (manual edit, lost truncate):
                        # rebuild this stream from scratch next cycle
                        self._offsets.pop(fname, None)
                        continue
                    # crash point: shipped WAL bytes in hand, not yet
                    # durable locally — torn_write tears the mirror tail;
                    # resume_local truncates it back to a frame boundary
                    faults.fire("repl.ship", f, payload=blob,
                                tear_base=have)
                    f.write(blob)
                    f.flush()
                    tio.fsync(f)
                records = read_wal_records(path, have, have + len(blob))
            else:
                records = _parse_frames(blob, skip_header=(have == 0))
            # crash point: bytes are durable on the follower, the overlay
            # has not applied them — a restart replays the mirrored files
            # into a fresh overlay, landing on the same applied-LSN state
            faults.fire("repl.apply")
            for record in records:
                rows = record.get("rows")
                if isinstance(rows, list) and self.apply_rows is not None:
                    self.apply_rows(rows)
                applied += 1
            self._offsets[fname] = have + len(blob)
        self._write_cursor()
        if self._m_records is not None and applied:
            self._m_records.inc(applied)
        self._note_caught_up()
        return {"applied": applied, "resynced": resynced,
                "epoch": epoch}

    def _reapply_mirrors(self, live) -> int:
        """Re-apply every intact record of the mirrored WAL files in
        ``live`` (oldest stream file first) and resume each stream at its
        local stable prefix, truncating a torn tail; returns the records
        applied."""
        applied = 0
        names = sorted(
            (f for f in live if is_wal_file(f)
             and os.path.exists(os.path.join(self.store_dir, f))),
            key=lambda f: (_WAL_RE.match(f).group("name"),
                           int(_WAL_RE.match(f).group("seq"))),
        )
        for fname in names:
            path = os.path.join(self.store_dir, fname)
            stable, _records = stable_wal_prefix(path)
            if os.path.getsize(path) > stable:
                with open(path, "r+b") as f:
                    f.truncate(stable)
            if stable <= 0:
                continue
            for record in read_wal_records(path, 0, stable):
                rows = record.get("rows")
                if isinstance(rows, list) and self.apply_rows is not None:
                    self.apply_rows(rows)
                applied += 1
            self._offsets[fname] = stable
        return applied

    # -- serve-mode thread ----------------------------------------------------

    def start(self) -> None:
        """Run the tail loop on a daemon thread (the serve follower
        mode).  Ship failures are logged and retried next poll; the lag
        gauge keeps growing while the leader is unreachable, which is
        exactly the staleness signal /readyz and the SLO plane consume."""
        self._thread = threading.Thread(
            target=self._run, name="avdb-repl-tail", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                self.sync_once()
            except ReplError as err:
                self.log(f"repl: tail cycle failed ({err}); retrying")
            except Exception as err:
                self.log(f"repl: tail cycle error "
                         f"({type(err).__name__}: {err}); retrying")
            if self._m_lag is not None:
                self._m_lag.set(self.lag_s())
            self._stop.wait(self.poll_s)


def _parse_frames(blob: bytes, skip_header: bool) -> list[dict]:
    """Frames from an in-memory shipped byte range (the persist=False
    worker path)."""
    out = []
    pos = 0
    if skip_header:
        nl = blob.find(b"\n")
        if nl < 0:
            return out
        pos = nl + 1
    while pos + _FRAME.size <= len(blob):
        length, crc = _FRAME.unpack_from(blob, pos)
        pos += _FRAME.size
        if length > MAX_RECORD_BYTES or pos + length > len(blob):
            break
        chunk = blob[pos:pos + length]
        pos += length
        if zlib.crc32(chunk) != crc:
            break
        try:
            out.append(json.loads(chunk))
        except ValueError:
            break
    return out


def wal_files(store_dir: str) -> list[str]:
    """Every WAL file name in a store directory, sorted."""
    try:
        return sorted(f for f in os.listdir(store_dir) if is_wal_file(f))
    except OSError:
        return []


# -- promote (failover) ------------------------------------------------------


def promote(store_dir: str, log=None) -> dict:
    """Fail a follower over into a leader: replay every mirrored WAL
    file into ordinary store segments (one atomic manifest commit via
    the memtable flush path), bump the fencing epoch, and drop the
    cursor + WAL mirrors.  Idempotent: a kill at any step re-runs
    cleanly (replay is first-wins-idempotent; the epoch commit is one
    atomic replace).  Returns ``{"status", "epoch", "rows", ...}``."""
    log = log or (lambda msg: None)
    from annotatedvdb_tpu_torch.store.memtable import Memtable
    from annotatedvdb_tpu_torch.store.variant_store import VariantStore
    from annotatedvdb_tpu_torch.store.wal import WriteAheadLog

    mpath = os.path.join(store_dir, "manifest.json")
    try:
        with open(mpath) as f:
            manifest = json.load(f)
    except (OSError, ValueError) as err:
        raise ReplError(f"{mpath}: unreadable manifest ({err})") from err
    cursor_epoch = 0
    try:
        with open(os.path.join(store_dir, CURSOR_FILE)) as f:
            cursor_epoch = int(json.load(f).get("epoch", 0) or 0)
    except (OSError, ValueError, AttributeError):
        pass
    old_epoch = int(manifest.get("repl_epoch", 0) or 0)
    new_epoch = max(old_epoch, cursor_epoch) + 1
    # crash point #1: nothing mutated yet — a kill here leaves an intact
    # follower that simply promotes again
    faults.fire("repl.promote")
    # seal the tail: truncate any torn mirror back to its stable prefix
    # so the replay below sees exactly the applied-LSN byte stream
    rows = 0
    names = wal_names(store_dir)
    if names:
        store = VariantStore.load(store_dir, readonly=True)
        mem = Memtable(width=store.width, store_dir=store_dir, wal=None,
                       log=log)
        for name in names:
            for record in WriteAheadLog(
                store_dir, name=name, log=log
            ).replay_records():
                rowlist = record.get("rows")
                if not isinstance(rowlist, list):
                    continue
                try:
                    accepted, _shadowed, _b = mem.upsert(
                        store, rowlist, durable=False
                    )
                except (ValueError, KeyError, TypeError) as err:
                    log(f"repl: promote replay record skipped ({err})")
                    continue
                rows += accepted
        if mem.rows:
            result = mem.flush()
            if result.get("status") != "flushed":
                raise ReplError(
                    f"promote: WAL replay flush {result.get('status')} "
                    f"({result.get('reason')}); store left as follower"
                )
        # the replayed rows are committed segments now: drop the mirrors
        # (a fresh leader starts a fresh WAL interval)
        for fname in wal_files(store_dir):
            try:
                tio.unlink(os.path.join(store_dir, fname))
            except OSError:
                pass
    # fencing epoch commit: one atomic manifest replace.  Any writer that
    # opened the store under the old epoch fails its next flush commit
    # (the memtable fence check) — a deposed leader cannot commit.
    try:
        with open(mpath) as f:
            manifest = json.load(f)
    except (OSError, ValueError) as err:
        raise ReplError(f"{mpath}: unreadable manifest ({err})") from err
    manifest["repl_epoch"] = new_epoch
    # crash point #2 fires via pre_sync: the epoch bump is staged, not
    # committed — torn_write tears the tmp (the atomic replace never
    # happens, the store stays a promotable follower).  replace_manifest
    # also commits the rename metadata under AVDB_FSYNC: the epoch fence
    # must survive power loss, or a deposed leader could wake up unfenced.
    tio.replace_manifest(
        mpath, manifest,
        pre_sync=lambda f: faults.fire("repl.promote", f),
    )
    for fname in (CURSOR_FILE,):
        try:
            tio.unlink(os.path.join(store_dir, fname))
        except OSError:
            pass
    for fname in sorted(os.listdir(store_dir)):
        if is_repl_tmp(fname):
            try:
                tio.unlink(os.path.join(store_dir, fname))
            except OSError:
                pass
    log(f"repl: promoted to leader (fencing epoch {new_epoch}, "
        f"{rows} WAL row(s) replayed into segments)")
    return {"status": "promoted", "epoch": new_epoch, "rows": rows}
