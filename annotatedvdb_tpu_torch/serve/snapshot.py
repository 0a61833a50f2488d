"""Snapshot isolation for the serving read path.

Port of ``annotatedvdb_tpu/serve/snapshot.py`` (``StoreSnapshot``,
``SnapshotManager``, ``StaticSnapshots``).  Loading the store pins one
manifest's segment set in memory, so a query that captured a
:class:`StoreSnapshot` keeps reading exactly that generation whatever a
concurrent loader commits.  :class:`SnapshotManager` fingerprints
``manifest.json`` (one ``stat``), loads a changed generation off-lock and
swaps the pin atomically; ``maybe_refresh`` coalesces the check to one
``stat`` per ``AVDB_SERVE_SNAPSHOT_TTL_MS`` window (default 250 ms).
Stores open ``readonly=True``.  :class:`MemtableSnapshots` overlays a live
memtable (``store/memtable.py``) on a manager: the read-your-writes half of
``serve --upserts``.  The ``snapshot.swap`` fault point fires between a
new generation's load and the swap.
"""

from __future__ import annotations

import os
import time

from annotatedvdb_tpu_torch.store import VariantStore
from annotatedvdb_tpu_torch.utils import faults
from annotatedvdb_tpu_torch.utils.locks import make_lock


def _ttl_from_env() -> float:
    """``AVDB_SERVE_SNAPSHOT_TTL_MS`` (default 250) as seconds."""
    return max(
        float(os.environ.get("AVDB_SERVE_SNAPSHOT_TTL_MS", "") or 250), 0.0
    ) / 1000.0


class StoreSnapshot:
    """One immutable pinned generation of a store (``generation`` is
    1-based and increments per swap; ``fingerprint`` is None for in-memory
    stores)."""

    __slots__ = ("store", "generation", "fingerprint")

    def __init__(self, store: VariantStore, generation: int, fingerprint):
        self.store = store
        self.generation = generation
        self.fingerprint = fingerprint


def _manifest_fingerprint(store_dir: str) -> tuple:
    """Identity of the on-disk manifest: (mtime_ns, size, inode)."""
    st = os.stat(os.path.join(store_dir, "manifest.json"))
    return (st.st_mtime_ns, st.st_size, st.st_ino)


class SnapshotManager:
    """Pins the serving store generation; swaps are atomic under a lock."""

    def __init__(self, store_dir: str, log=None, ttl_s: float | None = None):
        self.store_dir = store_dir
        self.log = log if log is not None else (lambda msg: None)
        self.ttl_s = _ttl_from_env() if ttl_s is None else max(float(ttl_s), 0.0)
        self._lock = make_lock("serve.snapshot.pin")
        fingerprint = _manifest_fingerprint(store_dir)
        store = VariantStore.load(store_dir, readonly=True)
        #: guarded by self._lock
        self._snap = StoreSnapshot(store, 1, fingerprint)
        #: guarded by self._lock
        self._swaps = 0
        #: guarded by self._lock
        self._next_check = 0.0
        #: True while a new generation loads (readiness reports not-ready)
        self.swapping = False

    def current(self) -> StoreSnapshot:
        """The pinned generation; callers keep it for their whole query."""
        with self._lock:
            return self._snap

    @property
    def swaps(self) -> int:
        with self._lock:
            return self._swaps

    def refresh_due(self) -> bool:
        """Whether the TTL window has lapsed (no stat, no side effects) —
        the aio front end's cheap in-line check before it schedules the
        real refresh off the event loop."""
        with self._lock:
            return time.monotonic() >= self._next_check

    def maybe_refresh(self) -> bool:
        """Coalesced freshness check: at most one manifest ``stat`` per TTL
        window across all request threads.  True only when this call
        performed the swap."""
        now = time.monotonic()
        with self._lock:
            if now < self._next_check:
                return False
            self._next_check = now + self.ttl_s
        return self.refresh()

    def refresh(self) -> bool:
        """Swap to the on-disk generation if it changed; True on a swap.
        The load runs off-lock; a failed load keeps the old generation
        serving (stale before down)."""
        with self._lock:
            pinned = self._snap
        try:
            fingerprint = _manifest_fingerprint(self.store_dir)
        except OSError:
            return False  # manifest mid-rename: keep serving the pin
        if fingerprint == pinned.fingerprint:
            return False
        self.swapping = True
        try:
            try:
                store = VariantStore.load(self.store_dir, readonly=True)
            except (OSError, ValueError) as err:
                self.log(f"snapshot refresh failed, keeping generation "
                         f"{pinned.generation}: {err}")
                return False
            # crash point: the new generation is fully loaded, the pin has
            # not moved — a failure here must leave the old generation
            # serving (and readiness recover: the finally clears the flag)
            faults.fire("snapshot.swap")
        finally:
            self.swapping = False
        with self._lock:
            if self._snap.fingerprint == fingerprint:
                return False  # a concurrent refresh won the race
            if self._snap is not pinned:
                return False  # the pin moved while this load ran
            self._snap = StoreSnapshot(
                store, self._snap.generation + 1, fingerprint
            )
            self._swaps += 1
            generation = self._snap.generation
        self.log(f"snapshot swapped to generation {generation} "
                 f"({store.n} rows)")
        return True


class _OverlayStore:
    """Read-only store view: the base generation's shards with the
    memtable's in-memory segments appended after them, so every read
    path's first-wins dedup resolves collisions toward the stored (older)
    row, and upserted rows render through the same ``Segment`` machinery
    loaded rows do.  The Segment objects are shared with the base store
    and the memtable; only the per-shard lists are fresh."""

    __slots__ = ("width", "readonly", "shards")

    def __init__(self, base_store, mem_segments: dict):
        from annotatedvdb_tpu_torch.store.variant_store import ChromosomeShard

        self.width = base_store.width
        self.readonly = True
        shards = {}
        for code, bshard in base_store.shards.items():
            sh = ChromosomeShard(code, self.width)
            sh.segments = list(bshard.segments) \
                + list(mem_segments.get(code, ()))
            shards[code] = sh
        for code, segs in mem_segments.items():
            if code in shards or not segs:
                continue
            sh = ChromosomeShard(code, self.width)
            sh.segments = list(segs)
            shards[code] = sh
        self.shards = shards

    @property
    def n(self) -> int:
        return sum(s.n for s in self.shards.values())


class MemtableSnapshots:
    """Snapshot provider overlaying a live memtable on a base provider.

    Until the first upsert (memtable epoch 0) this is a pass-through:
    ``current()`` returns the base provider's snapshot object unchanged,
    so read-only serving pays nothing and generation numbers are the
    base's.  From the first upsert on, every distinct (base generation,
    memtable epoch) pair maps to a fresh generation number strictly
    greater than any handed out before, so generation-keyed caches (point
    render, region LRU, interval indexes and their device copies, cursor
    walks, the brownout point cache) never serve pre-upsert bytes for a
    post-upsert view."""

    def __init__(self, base, memtable):
        self.base = base
        self.memtable = memtable
        self._lock = make_lock("serve.snapshot.overlay")
        #: guarded by self._lock
        self._last_key = None
        #: guarded by self._lock
        self._last_snap: StoreSnapshot | None = None
        #: guarded by self._lock — the remapped generation counter, kept
        #: strictly above every base generation observed
        self._gen = 0
        #: guarded by self._lock — bumps per reset_memtable swap so view
        #: keys from different memtable incarnations never collide
        self._mt_ver = 0

    def current(self) -> StoreSnapshot:
        base = self.base.current()
        with self._lock:
            mt = self.memtable
            ver = self._mt_ver
        epoch, segs, _rows, _bytes = mt.view()
        if epoch == 0 and ver == 0:
            return base  # pristine: the base's snapshot, zero overhead
        key = (base.generation, epoch, ver)
        with self._lock:
            if key == self._last_key:
                return self._last_snap
        overlay = _OverlayStore(base.store, segs)
        with self._lock:
            if key == self._last_key:  # a racing call built it first
                return self._last_snap
            self._gen = max(self._gen + 1, base.generation + 1)
            snap = StoreSnapshot(overlay, self._gen, base.fingerprint)
            self._last_key = key
            self._last_snap = snap
            return snap

    def reset_memtable(self, memtable) -> None:
        """Swap in a fresh overlay memtable — the replication follower's
        re-sync: rows now covered by a freshly installed base cut leave
        the overlay, so a long-running follower's memory stays bounded by
        one flush interval.  Generation numbers stay strictly monotone
        across the swap: once any overlay generation was handed out, even
        an epoch-0 (empty) view keeps being remapped above it."""
        with self._lock:
            self.memtable = memtable
            self._mt_ver += 1
            self._last_key = None
            self._last_snap = None

    def maybe_refresh(self) -> bool:
        return self.base.maybe_refresh()

    def refresh(self) -> bool:
        return self.base.refresh()

    def refresh_due(self) -> bool:
        return self.base.refresh_due() \
            if hasattr(self.base, "refresh_due") else False

    @property
    def swaps(self) -> int:
        return self.base.swaps

    @property
    def swapping(self) -> bool:
        return bool(getattr(self.base, "swapping", False))


class StaticSnapshots:
    """Snapshot provider over an in-memory store (tests) — one fixed
    generation, ``refresh`` is a no-op."""

    def __init__(self, store: VariantStore, generation: int = 1):
        self._snap = StoreSnapshot(store, generation, None)

    def current(self) -> StoreSnapshot:
        return self._snap

    def refresh(self) -> bool:
        return False

    def maybe_refresh(self) -> bool:
        return False

    @property
    def swaps(self) -> int:
        return 0
