"""Snapshot isolation for the serving read path.

Port of ``annotatedvdb_tpu/serve/snapshot.py`` (``StoreSnapshot``,
``SnapshotManager``, ``StaticSnapshots``).  Loading the store pins one
manifest's segment set in memory, so a query that captured a
:class:`StoreSnapshot` keeps reading exactly that generation whatever a
concurrent loader commits.  :class:`SnapshotManager` fingerprints
``manifest.json`` (one ``stat``), loads a changed generation off-lock and
swaps the pin atomically; ``maybe_refresh`` coalesces the check to one
``stat`` per ``AVDB_SERVE_SNAPSHOT_TTL_MS`` window (default 250 ms).
Stores open ``readonly=True``.  The upsert overlay (``MemtableSnapshots``,
``_OverlayStore``) and the ``snapshot.swap`` fault point are not ported.
"""

from __future__ import annotations

import os
import time

from annotatedvdb_tpu_torch.store import VariantStore
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
