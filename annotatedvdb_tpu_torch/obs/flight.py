"""Crash flight recorder: an mmap'd black box that survives SIGKILL.

Port of ``annotatedvdb_tpu/obs/flight.py``, whole, with its
``obs.flight`` fault point (per ring write, per request summary, per
harvest; every injected failure is absorbed).  The ring file is an on-disk format: the port writes the
reference's bytes for the same events and times, and either package's
``doctor flight`` reads either package's rings and harvests.

A watchdog-killed or SIGKILLed worker takes its last seconds of history
to the grave — the logs stop at the last flush, the metrics registry
dies with the process, and the postmortem starts from nothing.  This
module is the aircraft answer: every worker keeps a fixed-size mmap'd
ring of its last N request summaries and lifecycle events (brownout
level changes, breaker trips, daemon pass transitions, WAL rotations),
written with the fleet heartbeat's ``pack_into`` discipline — no file
syscalls after setup, bounded work per record, safe from the event loop.
Because the ring is a shared file mapping, the bytes survive any process
death the OS itself survives: the supervisor harvests the ring of a dead
or wedge-killed worker into ``<store>/flight/<ts>-w<idx>.jsonl`` and
``doctor flight`` renders the final minutes.

Ring layout (all little-endian, ``struct``-packed):

- header: magic ``AVDBFLT1``, version, request-slot count, event-slot
  count;
- slot: ``seq`` (1-based; 0 = never written), epoch time, kind
  (1=request, 2=lifecycle), status, CRC32, payload length, a 32-byte
  trace-id/name field, and a 160-byte JSON payload.

Request summaries and lifecycle events live in SEPARATE ring regions:
at serving QPS the request ring wraps in seconds, and the "event
timeline leading to death" (a brownout transition minutes ago, the
breaker trip that started the incident) must not be flooded out by the
very traffic it explains — rare events age on their own, much slower,
clock.

Torn-read tolerance is the ledger's torn-tail discipline at slot
granularity: the CRC covers the trace and payload bytes, so a harvest
racing a writer (or reading a slot torn by the kill itself) drops that
slot and keeps the rest — the black box never needs a lock to read.

Failure policy: observability must never take down serving: both
:meth:`FlightRecorder.request`/:meth:`FlightRecorder.event` and the
supervisor's harvest call absorb any failure (logged once, counted).
"""

from __future__ import annotations

import collections
import json
import mmap
import os
import struct
import threading
import time
import zlib

from annotatedvdb_tpu_torch.utils import faults


MAGIC = b"AVDBFLT1"
VERSION = 1

HEADER = struct.Struct("<8sIII")  # magic, version, slots, event_slots

#: one ring slot: seq, t_epoch, kind, status, crc32, payload_len,
#: trace-id/name, payload
SLOT = struct.Struct("<QdIIIH32s160s")

PAYLOAD_MAX = 160
TRACE_MAX = 32

KIND_REQUEST = 1
KIND_EVENT = 2

#: the harvested-blackbox subdirectory under a store
FLIGHT_DIR = "flight"


def flight_events_from_env() -> int:
    """``AVDB_FLIGHT_EVENTS`` — flight-ring slot count per worker
    (default 512; 0 disables the recorder)."""
    return max(int(os.environ.get("AVDB_FLIGHT_EVENTS", "") or 512), 0)


def ring_path(store_dir: str, worker: int) -> str:
    """The live ring file of worker ``worker`` under ``store_dir``."""
    return os.path.join(store_dir, FLIGHT_DIR, f"w{int(worker)}.ring")


class FlightRecorder:
    """Writer half: owns the mmap of ONE worker's ring file.

    Creation truncates/reinitializes the file — a respawned worker starts
    a fresh incarnation (the supervisor harvested the previous one on its
    death).  All writes are ``pack_into`` on the established mapping.

    **Request summaries buffer; lifecycle events write through.**  A
    per-request encode + mmap write costs ~13µs — at serving QPS that is
    a measurable slice of the event loop, and the bench's 3% overhead
    gate failed on exactly it.  ``request`` therefore appends a raw
    tuple to a bounded deque (sub-µs, thread-safe) and :meth:`flush` —
    called on the aio maintenance tick via the executor pool, time-gated
    on the threaded front end's request completions, by a per-recorder
    background thread every :data:`FLUSH_S` (a burst followed by silence
    must not strand its tail in the buffer forever), and by
    :meth:`close` — drains it to the mmap.  Serving-side flushes CAP the
    batch at :data:`FLUSH_BATCH` records: an uncapped drain is a
    multi-ms GIL burst, and the overhead gate showed exactly that burst
    landing in p99 — under sustained pressure the ring is therefore an
    honest rolling SAMPLE (~FLUSH_BATCH/FLUSH_S summaries/sec; the deque
    always holds the newest ``slots``, and :meth:`close` drains fully).
    The durability trade is explicit too: a SIGKILL loses at most the
    un-flushed tail; lifecycle events (rare, and the heart of the
    postmortem) never buffer and never sample."""

    #: serving-side flush cadence (both front ends gate on it)
    FLUSH_S = 0.25

    #: serving-side flush batch cap (records per flush): bounds the GIL
    #: burst a drain costs to a fraction of a millisecond
    FLUSH_BATCH = 32

    def __init__(self, path: str, slots: int | None = None,
                 event_slots: int | None = None, log=None):
        self.path = path
        self.slots = flight_events_from_env() if slots is None \
            else max(int(slots), 1)
        #: the lifecycle-event region: sized for RARE records (a brownout
        #: transition, a breaker trip) so the request flood can never
        #: wash the incident timeline out of the box
        self.event_slots = max(64, self.slots // 8) \
            if event_slots is None else max(int(event_slots), 1)
        self.log = log if log is not None else (lambda msg: None)
        #: serializes slot reservation + pack_into: concurrent flush()
        #: calls (the threaded front end's time-gated inline flushes can
        #: race) and write-through events must never interleave a
        #: `_seq += 1` and overwrite each other's slot.  A plain stdlib
        #: lock on purpose — obs-layer locks stay outside the serve
        #: lock-order tracer (the recorder observes INTO traced code)
        self._write_lock = threading.Lock()
        #: guarded by self._write_lock
        self._seq = 0
        #: guarded by self._write_lock
        self._seq_ev = 0
        self._errors = 0
        self._error_logged = False
        #: pending request summaries (raw, unencoded): bounded to the
        #: ring size — between flushes the deque IS the newest-N window
        self._pending: collections.deque = collections.deque(
            maxlen=self.slots
        )
        size = HEADER.size + (self.slots + self.event_slots) * SLOT.size
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        with open(path, "w+b") as f:
            f.write(b"\x00" * size)
            f.flush()
        self._f = open(path, "r+b")
        self._mm = mmap.mmap(self._f.fileno(), size)
        HEADER.pack_into(self._mm, 0, MAGIC, VERSION, self.slots,
                         self.event_slots)
        #: background flusher: the front ends' flushes are gated on
        #: request COMPLETIONS, so a traffic burst followed by silence
        #: used to leave its whole tail buffered indefinitely — a worker
        #: SIGKILLed while idle lost exactly the history the black box
        #: exists to keep.  This thread bounds the at-risk window to
        #: ~FLUSH_S regardless of traffic.
        self._closed = False
        self._flush_stop = threading.Event()
        self._flusher = threading.Thread(
            target=self._flush_loop, name="avdb-flight-flush", daemon=True
        )
        self._flusher.start()

    def _flush_loop(self) -> None:
        while not self._flush_stop.wait(self.FLUSH_S):
            if self._closed:
                return
            if self._pending:
                try:
                    self.flush(self.FLUSH_BATCH)
                except Exception:
                    # same absorb contract as _write: the black box must
                    # never take down (or noisily haunt) its process
                    return

    # -- write side ---------------------------------------------------------

    def _write(self, kind: int, status: int, name: str,
               payload: bytes, t: float | None = None) -> None:
        """One slot write; absorbs every failure (the black box must
        never take down the flight it records)."""
        try:
            # crash point: a failing ring write (or an injected EIO) must
            # cost nothing but this one record
            faults.fire("obs.flight")
            nb = name.encode("utf-8", "replace")[:TRACE_MAX]
            pb = payload[:PAYLOAD_MAX]
            with self._write_lock:
                if kind == KIND_EVENT:
                    self._seq_ev += 1
                    idx = self.slots \
                        + (self._seq_ev - 1) % self.event_slots
                    seq = self._seq_ev
                else:
                    self._seq += 1
                    idx = (self._seq - 1) % self.slots
                    seq = self._seq
                SLOT.pack_into(
                    self._mm, HEADER.size + idx * SLOT.size,
                    seq, time.time() if t is None else t, kind,
                    int(status) & 0xFFFFFFFF,
                    zlib.crc32(nb + pb), len(pb), nb, pb,
                )
        except Exception as err:
            self._errors += 1
            if not self._error_logged:
                self._error_logged = True
                self.log(f"flight: ring write failed ({type(err).__name__}:"
                         f" {err}); recording continues best-effort")

    def request(self, trace_id: str, kind: str, status: int,
                total_s: float, stages) -> None:
        """One finished request's summary: trace id, kind, status, total,
        and the stage breakdown.  Hot path: one fault-point check + one
        deque append — encode and mmap work happen at :meth:`flush`."""
        try:
            # crash point: an injected failure must cost exactly this
            # one record, never the request being recorded
            faults.fire("obs.flight")
        except Exception as err:
            self._errors += 1
            if not self._error_logged:
                self._error_logged = True
                self.log(f"flight: ring write failed ({type(err).__name__}:"
                         f" {err}); recording continues best-effort")
            return
        self._pending.append(
            (time.time(), trace_id, kind, int(status), total_s,
             tuple(stages))
        )

    def flush(self, limit: int | None = None) -> int:
        """Drain buffered request summaries to the mmap'd ring; returns
        records written.  Thread-safe against concurrent appends (deque
        pops are atomic); runs OFF the event loop (pool / request
        thread / close).  ``limit`` caps the batch (the serving-side
        callers pass :data:`FLUSH_BATCH`); None drains fully."""
        n = 0
        while limit is None or n < limit:
            try:
                t, trace_id, kind, status, total_s, stages = \
                    self._pending.popleft()
            except IndexError:
                return n
            doc = {
                "k": kind,
                "ms": round(total_s * 1000, 3),
                "st": {s: round(sec * 1000, 3) for s, sec in stages},
            }
            payload = json.dumps(doc, separators=(",", ":")).encode()
            if len(payload) > PAYLOAD_MAX:
                # trimmed to fit the fixed slot: stages drop before the
                # headline does
                doc.pop("st", None)
                payload = json.dumps(doc, separators=(",", ":")).encode()
            self._write(KIND_REQUEST, status, trace_id, payload, t=t)
            n += 1
        return n

    def event(self, name: str, detail: str) -> None:
        """One lifecycle event (brownout change, breaker trip, daemon
        pass transition, WAL rotation...).  The detail SHRINKS until the
        encoded payload fits the slot — slicing encoded JSON would cut
        mid-string and the CRC-valid-but-unparseable slot would be
        silently dropped on decode, losing exactly the events the black
        box exists to keep."""
        detail = detail[:PAYLOAD_MAX]
        payload = json.dumps({"d": detail}, separators=(",", ":")).encode()
        while len(payload) > PAYLOAD_MAX and detail:
            # escapes can inflate a char to 6 bytes: trim by the overflow
            detail = detail[:-max((len(payload) - PAYLOAD_MAX + 5) // 6, 1)]
            payload = json.dumps(
                {"d": detail}, separators=(",", ":")
            ).encode()
        self._write(KIND_EVENT, 0, name, payload)

    @property
    def errors(self) -> int:
        return self._errors

    def close(self) -> None:
        self._closed = True
        self._flush_stop.set()
        try:
            self._flusher.join(timeout=1.0)
        except RuntimeError:
            pass
        try:
            self.flush()
        except Exception:  # avdb: noqa[AVDB602] -- best-effort final drain; close must always release the mapping
            pass
        try:
            self._mm.close()
            self._f.close()
        except (OSError, ValueError):
            pass


# -- read side (harvest / doctor) -------------------------------------------


def decode_ring(path: str) -> dict:
    """Decode one ring file into ``{"slots", "event_slots", "events"}``
    — requests and lifecycle events merged in time order, torn/invalid
    slots dropped (the CRC is the judge).  Raises
    ``OSError``/``ValueError`` on a missing or foreign file."""
    with open(path, "rb") as f:
        data = f.read()
    if len(data) < HEADER.size:
        raise ValueError(f"{path}: not a flight ring (too short)")
    magic, version, slots, event_slots = HEADER.unpack_from(data, 0)
    if magic != MAGIC:
        raise ValueError(f"{path}: not a flight ring (bad magic)")
    if len(data) < HEADER.size + (slots + event_slots) * SLOT.size:
        raise ValueError(f"{path}: truncated flight ring")
    events = []
    for i in range(slots + event_slots):
        seq, t, kind, status, crc, plen, name, payload = SLOT.unpack_from(
            data, HEADER.size + i * SLOT.size
        )
        if seq == 0 or plen > PAYLOAD_MAX:
            continue
        nb = name.rstrip(b"\x00")
        pb = payload[:plen]
        if zlib.crc32(nb + pb) != crc:
            continue  # torn slot (killed mid-write): drop it, keep the rest
        try:
            doc = json.loads(pb.decode("utf-8", "replace")) if pb else {}
        except ValueError:
            continue
        ev = {
            "seq": int(seq),
            "t": float(t),
            "type": "request" if kind == KIND_REQUEST else "event",
        }
        if kind == KIND_REQUEST:
            ev["trace"] = nb.decode("utf-8", "replace")
            ev["status"] = int(status)
            ev["kind"] = doc.get("k", "?")
            ev["ms"] = doc.get("ms")
            if "st" in doc:
                ev["stages"] = doc["st"]
        else:
            ev["name"] = nb.decode("utf-8", "replace")
            ev["detail"] = doc.get("d", "")
        events.append(ev)
    # two independent ring regions, one timeline: order by wall clock,
    # seq as the tiebreak within a region's same-timestamp records
    events.sort(key=lambda e: (e["t"], e["seq"]))
    return {"slots": int(slots), "event_slots": int(event_slots),
            "events": events}


def harvest(ring_file: str, store_dir: str, worker: int, reason: str,
            log=None) -> str | None:
    """Decode a dead worker's ring into
    ``<store>/flight/<ms>-w<idx>.jsonl`` (header line + one JSON per
    event) and return the path — or None when there is nothing to
    harvest.  Raises nothing the caller must absorb beyond what the
    ``obs.flight`` fault point injects: the SUPERVISOR wraps this call
    (a failed harvest must never stall the respawn loop)."""
    log = log if log is not None else (lambda msg: None)
    # crash point: an injected failure inside the harvest must be
    # absorbed by the supervisor (serving and respawn continue)
    faults.fire("obs.flight")
    if not os.path.isfile(ring_file):
        return None
    decoded = decode_ring(ring_file)
    if not decoded["events"]:
        return None
    out_dir = os.path.join(store_dir, FLIGHT_DIR)
    os.makedirs(out_dir, exist_ok=True)
    out = os.path.join(
        out_dir, f"{int(time.time() * 1000)}-w{int(worker)}.jsonl"
    )
    tmp = out + ".tmp"
    with open(tmp, "w") as f:
        f.write(json.dumps({
            "type": "harvest", "worker": int(worker), "reason": reason,
            "t": time.time(), "ring": ring_file,
            "events": len(decoded["events"]),
        }) + "\n")
        for ev in decoded["events"]:
            f.write(json.dumps(ev, separators=(",", ":")) + "\n")
    os.replace(tmp, out)
    log(f"flight: harvested {len(decoded['events'])} event(s) from "
        f"worker {worker} ({reason}) -> {out}")
    return out


def load_harvest(path: str) -> dict:
    """One harvested ``.jsonl`` back as ``{"meta", "events"}`` —
    torn-tail tolerant like every JSONL reader here."""
    meta: dict = {}
    events: list = []
    with open(path) as f:
        for i, line in enumerate(f):
            line = line.strip()
            if not line:
                continue
            try:
                doc = json.loads(line)
            except ValueError:
                break  # torn tail: keep what parsed
            if i == 0 and doc.get("type") == "harvest":
                meta = doc
            else:
                events.append(doc)
    return {"meta": meta, "events": events}


def list_blackboxes(store_dir: str) -> dict:
    """``{"harvested": [paths newest-first], "rings": [paths]}`` under
    ``<store>/flight`` — what ``doctor flight`` has to work with."""
    d = os.path.join(store_dir, FLIGHT_DIR)
    harvested: list[str] = []
    rings: list[str] = []
    if os.path.isdir(d):
        for fname in sorted(os.listdir(d)):
            p = os.path.join(d, fname)
            if fname.endswith(".jsonl"):
                harvested.append(p)
            elif fname.endswith(".ring"):
                rings.append(p)
    harvested.sort(reverse=True)
    return {"harvested": harvested, "rings": rings}
