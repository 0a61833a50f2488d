"""Device hot-set residency for the serving read path.

Port of ``annotatedvdb_tpu/serve/residency.py::ResidencyManager`` with the
HBM budget as a CUDA memory budget.  Every segment of the serving snapshot
is marked ``residency="managed"`` (``Segment.probe`` then never uploads a
cache itself: it uses the one the manager installed, and probes on the
host, byte-identically, when there is none); each bulk/point probe window
touches the segments it overlaps, feeding an exponentially decayed
per-segment score; under an ``AVDB_SERVE_HBM_BUDGET`` (``--hbmBudget``)
byte budget the manager keeps the hottest segments' identity columns on
the engine's ``torch.device`` (uploads through ``Segment.
_ensure_device_cache``, on a worker thread by default) and drops the cold
tail's.  A segment's cost is what the port's cache really holds: pos,
ref_len and alt_len as int32, the hash as int64 and both allele rows,
unpadded.  Correctness never depends on residency.  With the mesh's
``placement`` (chromosome code -> device index) and ``devices`` (its
pool), the budget is per device: each device packs its own hottest
segments, and a segment's cache goes to its chromosome's device.
"""

from __future__ import annotations

import os
import time

from annotatedvdb_tpu_torch.utils.locks import make_lock
from annotatedvdb_tpu_torch.utils.strings import parse_bytes

#: score decay per DECAY_REF_S of elapsed time (half-life ~0.7 s)
DECAY = 0.95

#: elapsed seconds over which one DECAY factor applies
DECAY_REF_S = 0.05

#: seconds between plan passes under sustained traffic
PLAN_INTERVAL_S = 0.05

#: a challenger must beat a resident's score by this factor to displace it
HYSTERESIS = 1.1


def budget_from_env() -> int | None:
    """``AVDB_SERVE_HBM_BUDGET`` in bytes, or None when unset (unmanaged:
    the store's own upload rule)."""
    spec = os.environ.get("AVDB_SERVE_HBM_BUDGET", "").strip()
    return parse_bytes(spec) if spec else None


def device_cache_bytes(seg, width: int) -> int:
    """Bytes of the segment's device cache as ``Segment.
    _ensure_device_cache`` builds it: pos, ref_len, alt_len (4 B each),
    the hash as int64 (8 B) and the two allele rows (``width`` B each)."""
    return seg.n * (20 + 2 * int(width))


def _key_bounds(seg):
    """O(1) combined-key bounds of one segment (its first and last rows;
    rows sort by combined key), without building the full key array."""
    if seg._key is not None:
        return seg._key[0], seg._key[-1]
    from annotatedvdb_tpu_torch.store.variant_store import combined_key

    pos, h = seg.cols["pos"], seg.cols["h"]
    return (
        combined_key(pos[:1], h[:1])[0],
        combined_key(pos[-1:], h[-1:])[0],
    )


class _Entry:
    """Tracking state for one managed segment (one snapshot generation)."""

    __slots__ = ("seg", "nbytes", "score", "resident", "key_min", "key_max",
                 "device")

    def __init__(self, seg, nbytes: int, device: int | None = None):
        self.seg = seg
        self.nbytes = nbytes
        self.score = 0.0
        self.resident = False
        self.key_min, self.key_max = _key_bounds(seg)
        #: placement device index (None = the manager's device)
        self.device = device


class ResidencyManager:
    """Keeps the hot working set of serving segments on ``device`` under a
    byte budget; everything else probes from host memory.

    ``upload=None`` (default) uploads only when ``device`` is a CUDA device
    and device lookups are not ``off``; tests pass ``upload=True`` to run
    the cache lifecycle on the CPU.  ``min_rows`` filters segments below
    the device break-even (``DEVICE_SEGMENT_MIN``)."""

    def __init__(self, budget_bytes: int | None = None, registry=None,
                 log=None, upload: bool | None = None,
                 min_rows: int | None = None,
                 async_upload: bool | None = None,
                 plan_interval_s: float | None = None, device=None,
                 placement: dict | None = None, devices=None):
        import torch

        from annotatedvdb_tpu_torch.runtime import resolve_device

        if budget_bytes is None:
            budget_bytes = budget_from_env() or 0
        self.budget = max(int(budget_bytes), 0)
        self.device = resolve_device(device) \
            if not isinstance(device, torch.device) else device
        #: chromosome code -> device index (``parallel.mesh.
        #: chromosome_placement``): with a placement the budget is PER
        #: DEVICE, and a segment's cache goes to its chromosome's device;
        #: None keeps one bucket on ``device``
        self.placement = placement
        #: the devices placement indexes name (the mesh's pool)
        self._devices = tuple(devices) if devices is not None else None
        self.log = log if log is not None else (lambda msg: None)
        self._upload = upload
        self._async_upload = True if async_upload is None else bool(async_upload)
        self._uploader = None  # lazily-built single-thread executor
        if min_rows is None:
            from annotatedvdb_tpu_torch.store.variant_store import (
                DEVICE_SEGMENT_MIN,
            )

            min_rows = DEVICE_SEGMENT_MIN
        self.min_rows = int(min_rows)
        self.plan_interval_s = (
            PLAN_INTERVAL_S if plan_interval_s is None
            else max(float(plan_interval_s), 0.0)
        )
        self._lock = make_lock("serve.residency.manager")
        #: guarded by self._lock
        self._last_plan = time.monotonic()
        #: guarded by self._lock
        self._generation: int | None = None
        #: guarded by self._lock
        self._entries: dict[int, _Entry] = {}  # id(segment) -> entry
        if registry is not None:
            self._m_resident = registry.gauge(
                "avdb_serve_resident_bytes",
                "estimated bytes of serving segments HBM-resident",
            )
            self._m_evictions = registry.counter(
                "avdb_serve_residency_evictions_total",
                "segment caches evicted from HBM by the residency budget",
            )
            self._m_uploads = registry.counter(
                "avdb_serve_residency_uploads_total",
                "segment caches made HBM-resident (incl. fault-backs)",
            )
        else:
            self._m_resident = self._m_evictions = self._m_uploads = None

    # -- wiring -------------------------------------------------------------

    def _upload_enabled(self) -> bool:
        if self._upload is None:
            from annotatedvdb_tpu_torch.store.variant_store import (
                device_lookup_mode,
            )

            self._upload = (self.device.type == "cuda"
                            and device_lookup_mode() != "off")
        return self._upload

    def govern(self, snap) -> None:
        """Adopt the snapshot's segments (idempotent per generation; a
        retired generation never displaces a newer one)."""
        with self._lock:
            if (self._generation is not None
                    and snap.generation <= self._generation):
                return
        entries: dict[int, _Entry] = {}
        for code, shard in snap.store.shards.items():
            device = (self.placement.get(code)
                      if self.placement is not None else None)
            for seg in shard.segments:
                seg.residency = "managed"
                if seg.n >= self.min_rows:
                    entries[id(seg)] = _Entry(
                        seg, device_cache_bytes(seg, shard.width),
                        device=device,
                    )
        with self._lock:
            if (self._generation is not None
                    and snap.generation <= self._generation):
                return
            for e in self._entries.values():
                e.resident = False
            self._entries = entries
            self._generation = snap.generation
            candidates = len(self._entries)
        self.log(
            f"residency: governing generation {snap.generation} "
            f"({candidates} candidate segments, "
            f"budget {self.budget} bytes)"
        )

    # -- probe accounting ---------------------------------------------------

    def touch_window(self, shard, qlo, qhi, nq: int) -> None:
        """Record one probe window: every candidate segment whose key range
        overlaps [qlo, qhi] gains heat proportional to the batch size; the
        decay + rank + budget plan runs at most once per
        ``plan_interval_s``."""
        now = time.monotonic()
        with self._lock:
            touched = False
            for seg in shard.segments:
                entry = self._entries.get(id(seg))
                if (entry is None or entry.key_max < qlo
                        or entry.key_min > qhi):
                    continue
                entry.score += float(nq)
                touched = True
            if not touched:
                return
            elapsed = now - self._last_plan
            if elapsed < self.plan_interval_s:
                return
            self._last_plan = now
            plan = self._plan(
                list(self._entries.values()),
                DECAY ** (elapsed / DECAY_REF_S),
            )
        self._apply(plan)

    # -- budget enforcement -------------------------------------------------

    def _plan(self, entries: list, decay: float = 1.0) -> tuple[list, list]:
        """(to_evict, to_upload) under the budget (called under the lock;
        the transfers happen outside it)."""
        for e in entries:
            e.score *= decay
        if self.budget <= 0:
            evict = [e for e in entries if e.resident]
            for e in evict:
                e.resident = False
            return evict, []
        ranked = sorted(
            entries,
            key=lambda e: (
                -e.score * (HYSTERESIS if e.resident else 1.0), e.nbytes,
            ),
        )
        # with a placement each device's bucket packs on its own (a cold
        # device never lends its headroom to a hot one)
        want_ids = set()
        used: dict = {}
        for e in ranked:
            spent = used.get(e.device, 0)
            if e.score <= 0.0 or e.nbytes > self.budget - spent:
                continue
            want_ids.add(id(e))
            used[e.device] = spent + e.nbytes
        evict, upload = [], []
        for e in entries:
            if e.resident and id(e) not in want_ids:
                e.resident = False
                evict.append(e)
            elif not e.resident and id(e) in want_ids:
                e.resident = True
                upload.append(e)
        return evict, upload

    def _apply(self, plan: tuple[list, list]) -> None:
        evict, upload = plan
        for e in evict:
            with self._lock:
                if e.resident:
                    continue  # a newer plan re-uploaded it meanwhile
                e.seg._device = None
            if self._m_evictions is not None:
                self._m_evictions.inc()
        if upload and self._upload_enabled():
            if self._async_upload:
                with self._lock:
                    if self._uploader is None:
                        from concurrent.futures import ThreadPoolExecutor

                        self._uploader = ThreadPoolExecutor(
                            max_workers=1,
                            thread_name_prefix="avdb-residency-upload",
                        )
                self._uploader.submit(self._do_uploads, upload)
            else:
                self._do_uploads(upload)
        if self._m_resident is not None:
            self._m_resident.set(self.resident_bytes())

    def _device_for(self, index: int | None):
        """The torch device a placement index names (the manager's device
        for None or an index past the pool)."""
        if index is None or self._devices is None \
                or index >= len(self._devices):
            return self.device
        return self._devices[index]

    def _do_uploads(self, upload: list) -> None:
        for i, e in enumerate(upload):
            with self._lock:
                if not e.resident:
                    continue  # a newer plan evicted it before we got here
            try:
                e.seg._ensure_device_cache(self._device_for(e.device))
                with self._lock:
                    if not e.resident:
                        e.seg._device = None
                        continue
                if self._m_uploads is not None:
                    self._m_uploads.inc()
            except Exception as err:
                # device memory pressure: the host path keeps serving, and
                # no entry of this plan may claim bytes that never landed
                with self._lock:
                    for stale in upload[i:]:
                        stale.resident = False
                self.log(f"residency: upload failed, serving from "
                         f"host ({err})")
                break
        if self._m_resident is not None:
            self._m_resident.set(self.resident_bytes())

    # -- introspection ------------------------------------------------------

    def resident_bytes(self) -> int:
        with self._lock:
            return sum(e.nbytes for e in self._entries.values() if e.resident)

    def stats(self) -> dict:
        """Summary for ``/stats`` and tests."""
        with self._lock:
            entries = list(self._entries.values())
            out = {
                "budget_bytes": self.budget,
                "candidates": len(entries),
                "resident": sum(1 for e in entries if e.resident),
                "resident_bytes": sum(
                    e.nbytes for e in entries if e.resident
                ),
                "generation": self._generation,
            }
            if self.placement is not None:
                per_device: dict = {}
                for e in entries:
                    if e.resident:
                        key = str(e.device)
                        per_device[key] = per_device.get(key, 0) + e.nbytes
                out["per_device_bytes"] = per_device
            return out
