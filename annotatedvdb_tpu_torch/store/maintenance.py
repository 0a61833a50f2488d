"""Store status: the ``doctor status`` one-screen health report.

Trimmed port of ``annotatedvdb_tpu/store/maintenance.py``:
:func:`store_status` and the environment readers it calls (the segment
watermarks ``AVDB_MAINTAIN_SEGMENTS_HIGH`` / ``_LOW``, the disk reserve
``AVDB_STORE_DISK_RESERVE_BYTES`` and the free-space reading).  The
report reads only the manifest, the directory listing, WAL frames and the
ledger: it never loads a segment and never touches the card.  Also the
upsert path's write guard, :class:`DiskReserveGuard` (the 507 of
``POST /variants/upsert``).  The watermark-driven ``MaintenanceDaemon``
(``serve --maintain``) is not ported yet, nor is the guard's
``maintain.disk_guard`` fault point.
"""

from __future__ import annotations

import json
import os
import time

from annotatedvdb_tpu_torch.utils.locks import make_lock


def _parse_int(name: str, raw: str, default: int, minimum: int) -> int:
    if not raw:
        return default
    try:
        v = int(raw)
    except ValueError:
        raise ValueError(
            f"{name} must be an integer (got {raw!r})"
        ) from None
    return max(v, minimum)


def segments_high_from_env() -> int:
    """``AVDB_MAINTAIN_SEGMENTS_HIGH`` (default 8, floor 2): per-group
    segment-file count at which the daemon engages."""
    return _parse_int(
        "AVDB_MAINTAIN_SEGMENTS_HIGH",
        os.environ.get("AVDB_MAINTAIN_SEGMENTS_HIGH", "").strip(), 8, 2,
    )


def segments_low_from_env() -> int:
    """``AVDB_MAINTAIN_SEGMENTS_LOW`` (default 2, floor 1): the
    hysteresis exit — engaged until every group is at/below this."""
    return _parse_int(
        "AVDB_MAINTAIN_SEGMENTS_LOW",
        os.environ.get("AVDB_MAINTAIN_SEGMENTS_LOW", "").strip(), 2, 1,
    )


def disk_reserve_from_env() -> int:
    """``AVDB_STORE_DISK_RESERVE_BYTES`` (default 0 = disabled): free
    bytes under the store below which upserts shed 507.  ``512m``/``2g``
    suffixes via the shared parser — a typo'd reserve errors loudly
    instead of silently disabling the guard."""
    raw = os.environ.get("AVDB_STORE_DISK_RESERVE_BYTES", "").strip()
    if not raw or raw == "0":
        return 0
    from annotatedvdb_tpu_torch.utils.strings import parse_bytes

    try:
        return parse_bytes(raw)
    except ValueError as err:
        raise ValueError(f"AVDB_STORE_DISK_RESERVE_BYTES: {err}") from None


def free_disk_bytes(path: str) -> int:
    """Unprivileged-available bytes on the filesystem holding ``path``."""
    st = os.statvfs(path)
    return int(st.f_bavail) * int(st.f_frsize)


class DiskReserveGuard:
    """The disk-pressure write guard: ``breached()`` is True while free
    disk under the store sits below the configured reserve.

    One ``statvfs`` per TTL window (default 1 s), so the upsert path does
    not pay a syscall per request.  An unreadable reading counts as
    breached: when the guard cannot see free space it refuses writes
    rather than acknowledge rows a full disk may not hold.  State flips
    are logged once per transition."""

    TTL_S = 1.0

    def __init__(self, store_dir: str, reserve: int | None = None,
                 ttl_s: float | None = None, log=None):
        self.store_dir = store_dir
        self.reserve = (
            disk_reserve_from_env() if reserve is None
            else max(int(reserve), 0)
        )
        self.ttl_s = self.TTL_S if ttl_s is None else max(float(ttl_s), 0.0)
        self.log = log if log is not None else (lambda msg: None)
        self._lock = make_lock("store.disk_guard")
        #: guarded by self._lock
        self._cached: tuple[bool, int] = (False, -1)
        #: guarded by self._lock
        self._check_at = 0.0
        #: guarded by self._lock
        self._was_breached = False

    def state(self, force: bool = False) -> tuple[bool, int]:
        """(breached, free_bytes); ``free_bytes`` is -1 when the reading
        failed (treated as breached) or the guard is disabled."""
        if self.reserve <= 0:
            return False, -1
        now = time.monotonic()
        with self._lock:
            if not force and now < self._check_at:
                return self._cached
            self._check_at = now + self.ttl_s
        why = ""
        try:
            free = free_disk_bytes(self.store_dir)
            breached = free < self.reserve
        except Exception as err:
            free, breached = -1, True
            why = f" (free-space reading failed: {err})"
        with self._lock:
            flipped = breached != self._was_breached
            self._was_breached = breached
            self._cached = (breached, free)
        if flipped:
            if breached:
                self.log(
                    f"disk guard: free space "
                    f"{free if free >= 0 else 'unknown'} bytes below the "
                    f"{self.reserve}-byte reserve{why}; upserts answer 507 "
                    "until space is freed (reads/flushes/compaction keep "
                    "running)"
                )
            else:
                self.log("disk guard: reserve satisfied again; "
                         "upserts resume")
        return breached, free

    def breached(self) -> bool:
        return self.state()[0]


# ---------------------------------------------------------------------------
# doctor status


def store_status(store_dir: str) -> dict:
    """One-screen store health report (the ``doctor status`` verb): what
    an operator — or the soak harness — needs to assert health without
    parsing the manifest by hand."""
    from annotatedvdb_tpu_torch.store.compact import _min_stems, _normalize_groups
    from annotatedvdb_tpu_torch.store.memtable import is_flush_tmp
    from annotatedvdb_tpu_torch.store.wal import (
        count_records,
        is_wal_file,
        is_wal_tmp,
    )

    mpath = os.path.join(store_dir, "manifest.json")
    with open(mpath) as f:
        manifest = json.load(f)
    if not isinstance(manifest, dict) or "shards" not in manifest:
        raise ValueError(f"{mpath}: not a store manifest")
    stats_rows = (manifest.get("stats") or {}).get("rows") or {}
    groups = {}
    for label, glist in sorted(_normalize_groups(manifest).items()):
        stems = sum(len(g) for g in glist)
        groups[label] = {
            "segments": stems,
            "rows": stats_rows.get(label),
        }
    amps = [g["segments"] for g in groups.values()]
    high = segments_high_from_env()
    low = segments_low_from_env()

    wal_files = []
    debris = {"flush_tmp": 0, "compact_tmp": 0, "wal_tmp": 0,
              "stale_tmp": 0}
    from annotatedvdb_tpu_torch.store.compact import is_compact_tmp

    for fname in sorted(os.listdir(store_dir)):
        fp = os.path.join(store_dir, fname)
        if not os.path.isfile(fp):
            continue
        if is_wal_tmp(fname):
            debris["wal_tmp"] += 1
        elif is_wal_file(fname):
            try:
                nbytes = os.path.getsize(fp)
            except OSError:
                nbytes = 0
            wal_files.append({
                "file": fname,
                "records": count_records(fp),
                "bytes": int(nbytes),
            })
        elif is_flush_tmp(fname):
            debris["flush_tmp"] += 1
        elif is_compact_tmp(fname):
            debris["compact_tmp"] += 1
        elif fname.startswith(".") and ".tmp" in fname:
            debris["stale_tmp"] += 1

    reserve = disk_reserve_from_env()
    try:
        free = free_disk_bytes(store_dir)
    except OSError:
        free = -1
    last_compact = last_flush = None
    runs = 0
    lpath = os.path.join(store_dir, "ledger.jsonl")
    if os.path.exists(lpath):
        try:
            from annotatedvdb_tpu_torch.store.ledger import AlgorithmLedger

            ledger = AlgorithmLedger(lpath, log=lambda m: None)
            compacts = ledger.compactions()
            flushes = ledger.flushes()
            last_compact = compacts[-1] if compacts else None
            last_flush = flushes[-1] if flushes else None
            runs = len(ledger.runs())
        except (OSError, ValueError, KeyError):
            # an unreadable ledger is fsck's finding, not status's: the
            # report still carries everything the directory itself shows
            last_compact = last_flush = None
    # mesh placement: devices + groups-per-device from the manifest's
    # advisory block (written at save time under AVDB_MESH_SHAPE) or from
    # the env itself.  Resident bytes are an ESTIMATE from row counts
    # (rows x identity-cache bytes/row) — status must never touch CUDA
    # (a busy or absent card must not hang or fail the report), so it
    # reports what WOULD be resident per device against the per-device
    # share of AVDB_SERVE_HBM_BUDGET.
    placement = manifest.get("mesh_placement")
    if not isinstance(placement, dict):
        from annotatedvdb_tpu_torch.parallel.placement import placement_hint

        placement = placement_hint()
    mesh_block = None
    if placement and placement.get("devices", 0) > 1:
        n_dev = int(placement["devices"])
        width = int(manifest.get("width", 0))
        per_device_groups: dict = {}
        per_device_bytes: dict = {}
        for label, dev in (placement.get("groups") or {}).items():
            if label not in groups:
                continue
            key = str(dev)
            per_device_groups[key] = per_device_groups.get(key, 0) + 1
            rows = groups[label]["rows"] or 0
            per_device_bytes[key] = (
                per_device_bytes.get(key, 0) + rows * (16 + 2 * width)
            )
        from annotatedvdb_tpu_torch.utils.strings import parse_bytes

        budget_spec = os.environ.get("AVDB_SERVE_HBM_BUDGET", "").strip()
        budget = parse_bytes(budget_spec) if budget_spec else 0
        mesh_block = {
            "devices": n_dev,
            "groups_per_device": dict(sorted(per_device_groups.items())),
            "est_resident_bytes_per_device": dict(
                sorted(per_device_bytes.items())
            ),
            "per_device_budget_bytes": budget // n_dev if budget else 0,
        }
    return {
        "store_dir": store_dir,
        "rows": sum(
            int(g["rows"]) for g in groups.values()
            if g["rows"] is not None
        ),
        "groups": groups,
        "mesh": mesh_block,
        "read_amp": {
            "max": max(amps, default=0),
            "mean": round(sum(amps) / len(amps), 2) if amps else 0.0,
        },
        "watermarks": {
            "high": high,
            "low": low,
            "min_segments": _min_stems(),
            "over_high": sorted(
                lb for lb, g in groups.items() if g["segments"] >= high
            ),
        },
        "wal": {
            "files": len(wal_files),
            "records_pending_replay": sum(w["records"] for w in wal_files),
            "bytes": sum(w["bytes"] for w in wal_files),
            "by_file": wal_files,
        },
        "debris": debris,
        "disk": {
            "free_bytes": int(free),
            "reserve_bytes": int(reserve),
            # an UNREADABLE reading (free -1) reports breached, exactly
            # like the serving guard: when free space cannot be seen the
            # workers are refusing writes, and this report must say so
            "breached": bool(reserve > 0
                             and (free < 0 or free < reserve)),
        },
        "ledger": {
            "runs": runs,
            "last_compact": last_compact,
            "last_flush": last_flush,
        },
    }
