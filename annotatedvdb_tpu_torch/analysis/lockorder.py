"""Dynamic lock-order / deadlock detector (the runtime half of avdb-check).

Port of ``annotatedvdb_tpu/analysis/lockorder.py``.

The static AVDB2xx family proves every *annotated* attribute is accessed
under its lock, but it cannot see the ORDER locks are taken in: thread A
acquiring ``engine.cache`` then ``snapshot.pin`` while thread B acquires
them the other way round is a deadlock that deploys fine and detonates
under production concurrency.  The serve stack holds a dozen locks
spread over eight modules; this module checks their ordering.

How it works: :func:`annotatedvdb_tpu_torch.utils.locks.make_lock` returns an
instrumented :class:`~annotatedvdb_tpu_torch.utils.locks.TracedLock` when
``AVDB_LOCK_TRACE=1``.  Every successful acquire/release reports here.
The recorder keeps

- a **per-thread stack** of currently-held lock names;
- a global **acquisition-order graph**: a directed edge ``A -> B`` the
  first time any thread acquires ``B`` while holding ``A`` (with the
  site counts, so a report names how often an ordering was exercised);
- **held-duration accounting** per lock, exported as the
  ``avdb_lock_held_seconds`` histogram through the obs metrics registry
  (long holds are the contention precursors the serve p99 cares about).

A CYCLE in the order graph is a potential deadlock: some interleaving of
the participating threads can block forever.  :meth:`LockOrderRecorder.
cycles` reports every elementary cycle; the serve battery runs under
``AVDB_LOCK_TRACE=1`` in tier-1 (``tests/test_torch_locks.py``; on the
card, ``chip_smoke.py``'s traced leg) and asserts the report stays
empty, so a lock-order inversion fails the suite, not a production
post-mortem.

Unarmed processes never construct a ``TracedLock`` and never import this
module's hot path; the recorder costs nothing unless tracing is on.
"""

from __future__ import annotations

import threading
import time

#: held-duration histogram edges (seconds): sub-µs leaf locks up to the
#: multi-second index-build / generation-load holds
HELD_SECONDS_EDGES = (
    0.000001, 0.00001, 0.0001, 0.001, 0.01, 0.1, 1.0, 10.0,
)


class LockOrderRecorder:
    """Collects acquisition-order edges and held durations.

    Thread-safe; its internal mutex is a plain ``threading.Lock`` (never
    a :class:`TracedLock` — the recorder must not observe itself), and a
    per-thread reentrancy latch makes instrumentation callbacks that
    somehow re-enter the recorder a no-op instead of a recursion.
    """

    def __init__(self, registry=None):
        self._mu = threading.Lock()
        self._tls = threading.local()
        #: guarded by self._mu
        self._edges: dict[tuple, int] = {}  # (held, acquired) -> count
        #: guarded by self._mu
        self._held: dict[str, list] = {}    # name -> [count, total_s, max_s]
        #: guarded by self._mu
        self._lock_names: set = set()
        #: obs registry carrying the per-lock held-duration histograms
        #: (lazy: only an armed process ever creates one)
        self.registry = registry
        self._hists: dict[str, object] = {}  # name -> Histogram (loop-free)

    def _hist(self, name: str):
        """The ``avdb_lock_held_seconds{lock=...}`` histogram for one lock
        (created on first release; reads are lock-free thereafter)."""
        h = self._hists.get(name)
        if h is None:
            with self._mu:
                if self.registry is None:
                    from annotatedvdb_tpu_torch.obs.metrics import MetricsRegistry

                    self.registry = MetricsRegistry()
            h = self.registry.histogram(
                "avdb_lock_held_seconds", HELD_SECONDS_EDGES,
                "time a traced lock was held (AVDB_LOCK_TRACE=1)",
                {"lock": name},
            )
            with self._mu:
                self._hists[name] = h
        return h

    # -- per-thread stack ----------------------------------------------------

    def _stack(self) -> list:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def note_acquired(self, name: str) -> None:
        """Called by :class:`TracedLock` right after a successful acquire.
        Reentrant acquires of the SAME lock never create a self-edge."""
        if getattr(self._tls, "busy", False):
            return
        self._tls.busy = True
        try:
            stack = self._stack()
            held_names = {n for n, _t in stack}
            new_edges = [
                (h, name) for h in held_names if h != name
            ]
            stack.append((name, time.perf_counter()))
            with self._mu:
                self._lock_names.add(name)
                for e in new_edges:
                    self._edges[e] = self._edges.get(e, 0) + 1
        finally:
            self._tls.busy = False

    def note_released(self, name: str) -> None:
        """Called right before the underlying release.  Pops the newest
        matching stack entry (release order may differ from acquire order
        for hand-over-hand patterns) and accounts the held duration."""
        if getattr(self._tls, "busy", False):
            return
        self._tls.busy = True
        try:
            stack = self._stack()
            for i in range(len(stack) - 1, -1, -1):
                if stack[i][0] == name:
                    _n, t0 = stack.pop(i)
                    dt = time.perf_counter() - t0
                    with self._mu:
                        ent = self._held.setdefault(name, [0, 0.0, 0.0])
                        ent[0] += 1
                        ent[1] += dt
                        if dt > ent[2]:
                            ent[2] = dt
                    self._hist(name).observe(dt)
                    return
        finally:
            self._tls.busy = False

    # -- reporting -----------------------------------------------------------

    def snapshot_edges(self) -> dict:
        with self._mu:
            return dict(self._edges)

    def cycles(self) -> list:
        """Every elementary cycle in the acquisition-order graph, each as
        the ordered list of lock names (closed: first == last is implied).
        An empty list means no interleaving of the observed orderings can
        deadlock."""
        with self._mu:
            graph: dict[str, list] = {}
            for (a, b) in self._edges:
                graph.setdefault(a, []).append(b)
                graph.setdefault(b, graph.get(b, []))
            for succs in graph.values():
                succs.sort()

        cycles: list[list] = []
        seen_keys: set = set()
        # bounded DFS per start node: elementary cycles through the start,
        # only kept when start is the smallest name in the cycle (each
        # cycle reported exactly once, in canonical rotation)
        for start in sorted(graph):
            stack = [(start, iter(graph.get(start, ())))]
            path = [start]
            on_path = {start}
            while stack:
                node, it = stack[-1]
                advanced = False
                for nxt in it:
                    if nxt == start and len(path) > 1:
                        key = tuple(path)
                        if min(path) == start and key not in seen_keys:
                            seen_keys.add(key)
                            cycles.append(list(path))
                        continue
                    if nxt in on_path or nxt < start:
                        continue
                    stack.append((nxt, iter(graph.get(nxt, ()))))
                    path.append(nxt)
                    on_path.add(nxt)
                    advanced = True
                    break
                if not advanced:
                    stack.pop()
                    on_path.discard(path.pop())
        return cycles

    def held_stats(self) -> dict:
        """{lock: {count, total_s, max_s}} — the held-duration summary."""
        with self._mu:
            return {
                name: {"count": c, "total_s": t, "max_s": m}
                for name, (c, t, m) in sorted(self._held.items())
            }

    def report(self) -> dict:
        """The full machine-readable report (serve smoke prints it)."""
        edges = self.snapshot_edges()
        with self._mu:
            locks = sorted(self._lock_names)
        return {
            "locks": locks,
            "edges": {
                f"{a} -> {b}": n for (a, b), n in sorted(edges.items())
            },
            "cycles": self.cycles(),
            "held": self.held_stats(),
        }

    def render_prometheus(self) -> str:
        """The held-duration histograms in exposition text ("" before any
        traced release) — the smoke/bench export surface."""
        if self.registry is None:
            return ""
        return self.registry.render_prometheus()

    def reset(self, registry=None) -> None:
        with self._mu:
            self._edges.clear()
            self._held.clear()
            self._lock_names.clear()
            self._hists.clear()
            self.registry = registry
        # per-thread stacks clear themselves as locks release; a reset
        # mid-hold only loses duration accounting for those holds


#: process-global recorder every TracedLock reports to (one graph per
#: process: cross-thread ordering is exactly what we are after)
RECORDER = LockOrderRecorder()
