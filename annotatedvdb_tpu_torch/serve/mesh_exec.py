"""Mesh execution for the serving read path.

Port of ``annotatedvdb_tpu/serve/mesh_exec.py``.  Single-device serving
answers a bulk lookup with one probe per chromosome group and a region
panel with one BITS call per touched group.  On a mesh both collapse to
one sharded call each:

- **bulk lookup** — the snapshot's identity columns live on the shards,
  chromosome-placed (``parallel.device_store``: each shard holds the
  groups ``chromosome_placement`` assigns it), and every drain runs
  ``parallel.distributed.distributed_serve_lookup_step``: one exchange
  routes each query to its owner, which probes its slice (one
  ``lookup_multi`` launch per shard on the card).  Row ids come back as
  host-store global ids, so rendering is the single-device path's.
- **region panels** — every group's interval index stacks into one
  ``[g_max, R]`` position array per shard, uploaded once per generation;
  a panel is one ``ops.intervals.bits_spans_stacked`` launch per shard.

Failure policy is the breaker contract: the ``mesh.dispatch`` fault point
fires before each sharded call, any failure feeds the
:class:`~annotatedvdb_tpu_torch.serve.resilience.DeviceBreaker` under the
reserved group :data:`MESH_GROUP` (0, never a chromosome) and the caller
takes the single-device path, whose answers are byte-identical (on the
card, the card's own kernels).  A kernel that fails to build raises at
construction, never inside a request.

Knobs, resolved here once: ``AVDB_SERVE_MESH`` gates the path (``auto``
engages only with more than one PHYSICAL device; virtual shards, on the
CPU or on the card, need ``1``; ``0`` disables) and ``AVDB_MESH_BULK_MIN``
is the smallest bulk that pays a mesh dispatch.
"""

from __future__ import annotations

import os
import time

import numpy as np

from annotatedvdb_tpu_torch.utils import faults
from annotatedvdb_tpu_torch.utils.arrays import POS_SENTINEL, next_pow2
from annotatedvdb_tpu_torch.utils.locks import make_lock

#: the DeviceBreaker group key for the mesh dispatch as a whole (0 is
#: never a real chromosome code)
MESH_GROUP = 0

#: the rebuild limiter's stamp of a state kind never built: its first
#: build is always allowed
NEVER_BUILT = float("-inf")


def resolve_serve_mesh() -> str:
    """``AVDB_SERVE_MESH`` as one of ``auto``/``1``/``0`` (default
    ``auto``); anything else fails loudly."""
    mode = os.environ.get("AVDB_SERVE_MESH", "").strip().lower() or "auto"
    if mode not in ("auto", "1", "0"):
        raise ValueError(
            f"AVDB_SERVE_MESH must be auto, 1, or 0, not {mode!r}"
        )
    return mode


def resolve_mesh_bulk_min(bulk_min: int | None = None) -> int:
    """Smallest bulk-lookup batch that pays a mesh dispatch (default 64;
    0 sends every batch)."""
    if bulk_min is None:
        spec = os.environ.get("AVDB_MESH_BULK_MIN", "").strip()
        if spec:
            try:
                bulk_min = int(spec)
            except ValueError:
                raise ValueError(
                    f"AVDB_MESH_BULK_MIN must be an integer, not {spec!r}"
                ) from None
        else:
            bulk_min = 64
    return max(int(bulk_min), 0)


def serve_mesh_on(device=None):
    """The mesh the serve path executes over, or None when mesh serving is
    off: the pool of ``device``'s platform (``cuda`` by default), bounded
    by ``AVDB_MESH_SHAPE``.  ``auto`` needs more than one physical device;
    ``1`` forces the mesh over virtual shards too."""
    from annotatedvdb_tpu_torch.parallel.mesh import device_pool, global_mesh

    mode = resolve_serve_mesh()
    if mode == "0":
        return None
    mesh = global_mesh(devices=device_pool(device))
    if mesh is None:
        return None
    if mode == "auto" and mesh.physical_devices <= 1:
        return None
    return mesh


def serve_mesh_executor(registry=None, breaker=None, log=None,
                        budget_bytes: int | None = None, device=None):
    """The front ends' one construction point: a :class:`MeshExecutor`
    when :func:`serve_mesh_on` resolves a mesh, else None.  ``budget_bytes``
    is the caller's PER-DEVICE resident budget (the residency manager's
    already-split share)."""
    mesh = serve_mesh_on(device)
    if mesh is None:
        return None
    return MeshExecutor(mesh, registry=registry, breaker=breaker, log=log,
                        budget_bytes=budget_bytes)


class _BulkState:
    """One generation's identity columns on the shards — or a tombstone
    (``store is None``) when they exceed the per-device budget."""

    __slots__ = ("generation", "store", "nbytes")

    def __init__(self, generation: int, store, nbytes: int):
        self.generation = generation
        self.store = store
        self.nbytes = nbytes


class _SpanState:
    """One generation's stacked interval-index positions (one ``[g_max,
    R]`` tensor per shard) and the code -> stack-row placement."""

    __slots__ = ("generation", "pos_stack", "row_of", "b_pad", "nbytes")

    def __init__(self, generation: int, pos_stack, row_of: dict,
                 b_pad: int, nbytes: int):
        self.generation = generation
        self.pos_stack = pos_stack
        self.row_of = row_of
        self.b_pad = b_pad
        self.nbytes = nbytes


class MeshExecutor:
    """Owns the serving mesh: placement, per-generation device state, the
    two sharded call sites, and the breaker/fallback policy."""

    #: minimum seconds between device-state rebuilds: a generation that
    #: churns faster (the live write path mints one per memtable epoch)
    #: serves from the byte-identical single-device path
    REBUILD_MIN_S = 2.0

    def __init__(self, mesh, registry=None, breaker=None, log=None,
                 bulk_min: int | None = None,
                 budget_bytes: int | None = None,
                 rebuild_min_s: float | None = None):
        from annotatedvdb_tpu_torch.parallel.mesh import chromosome_placement

        if mesh.distributed:
            raise ValueError("the serving mesh is process-local")
        if any(d.type == "cuda" for d in mesh.devices):
            # build (or find) both kernels now: a failed nvcc raises here,
            # never inside a request or into the breaker
            from annotatedvdb_tpu_torch.ops import dedup, intervals

            dedup._library()
            intervals._library()
        self.mesh = mesh
        self.n_devices = int(mesh.size)
        self.placement = chromosome_placement(self.n_devices)
        self.breaker = breaker
        self.log = log if log is not None else (lambda msg: None)
        self.bulk_min = resolve_mesh_bulk_min(bulk_min)
        #: per-DEVICE resident byte budget; 0/None = unmanaged
        self.budget = int(budget_bytes or 0)
        self.rebuild_min_s = (
            self.REBUILD_MIN_S if rebuild_min_s is None
            else max(float(rebuild_min_s), 0.0)
        )
        self._lock = make_lock("serve.mesh.state")
        #: serializes state BUILDS: after a swap every concurrent drain
        #: misses the generation at once; losers wait and take the
        #: winner's state
        self._build_lock = make_lock("serve.mesh.build")
        #: guarded by self._lock
        self._bulk: _BulkState | None = None
        #: guarded by self._lock
        self._spans: _SpanState | None = None
        #: guarded by self._lock — monotonic stamp of the last started
        #: build per state kind (the rebuild rate limiter's input); -inf
        #: until the first, which is never a rebuild (``time.monotonic``
        #: counts from boot, so a 0.0 stamp would hold back a young
        #: host's first build for ``rebuild_min_s``)
        self._last_build = {"bulk": NEVER_BUILT, "spans": NEVER_BUILT}
        if registry is not None:
            self._m_devices = registry.gauge(
                "avdb_mesh_devices",
                "devices in the serving mesh (0 = single-device path)",
            )
            self._m_devices.set(self.n_devices)
            self._m_groups = registry.gauge(
                "avdb_mesh_groups_placed",
                "chromosome groups placed onto mesh devices this generation",
            )
            self._m_resident = registry.gauge(
                "avdb_mesh_resident_bytes",
                "bytes of mesh-resident serving state (identity columns + "
                "interval stacks, all devices)",
            )
            self._m_dispatch = {
                kind: registry.counter(
                    "avdb_mesh_dispatch_total",
                    "sharded mesh calls issued", {"kind": kind},
                )
                for kind in ("bulk", "spans")
            }
            self._m_fallback = {
                kind: registry.counter(
                    "avdb_mesh_fallback_total",
                    "mesh calls that fell back to the single-device path",
                    {"kind": kind},
                )
                for kind in ("bulk", "spans")
            }
        else:
            self._m_devices = self._m_groups = self._m_resident = None
            self._m_dispatch = self._m_fallback = None

    # -- state builds -------------------------------------------------------

    def _resident_bytes(self) -> int:
        with self._lock:
            return sum(
                s.nbytes for s in (self._bulk, self._spans) if s is not None
            )

    def _note_resident(self) -> None:
        if self._m_resident is not None:
            self._m_resident.set(self._resident_bytes())

    def _rebuild_allowed(self, kind: str) -> bool:
        with self._lock:
            return (time.monotonic() - self._last_build[kind]
                    >= self.rebuild_min_s)

    def _stamp_build(self, kind: str) -> None:
        with self._lock:
            self._last_build[kind] = time.monotonic()

    def _state(self, kind: str, snap, build):
        """The ``kind`` state for ``snap``'s generation: the installed one,
        or a build under the build lock when the rate limit allows.  A
        drain holding a pre-swap snapshot neither overwrites a newer state
        nor spends the rebuild window."""
        attr = "_bulk" if kind == "bulk" else "_spans"

        def current():
            state = getattr(self, attr)
            if state is None:
                return False, None
            if state.generation == snap.generation:
                return True, state if _live(state) else None
            if state.generation > snap.generation:
                return True, None
            return False, None

        with self._lock:
            done, state = current()
        if done:
            return state
        if not self._rebuild_allowed(kind):
            return None
        with self._build_lock:
            with self._lock:
                done, state = current()
            if done:
                return state
            if not self._rebuild_allowed(kind):
                return None
            return build()

    def _bulk_state(self, snap) -> _BulkState | None:
        return self._state("bulk", snap, lambda: self._build_bulk_state(snap))

    def _build_bulk_state(self, snap) -> _BulkState | None:
        """The O(store) sort and upload, under the build lock."""
        from annotatedvdb_tpu_torch.parallel.device_store import (
            build_device_shard_store,
            place_store,
        )

        self._stamp_build("bulk")
        host = build_device_shard_store(snap.store, self.n_devices)
        nbytes = sum(getattr(host, f).nbytes for f in host._fields
                     if f != "n_rows")
        # ONE budget pool covers both mesh states (the same device memory)
        with self._lock:
            other = self._spans.nbytes if self._spans is not None else 0
        if self.budget and (nbytes + other) // self.n_devices > self.budget:
            self.log(
                f"mesh: generation {snap.generation} identity columns "
                f"({nbytes} bytes + {other} stack bytes / "
                f"{self.n_devices} devices) exceed the per-device "
                f"budget {self.budget}; bulk lookups stay on the "
                "single-device path"
            )
            state = _BulkState(snap.generation, None, 0)
            with self._lock:
                self._bulk = state
            self._note_resident()
            return None
        state = _BulkState(snap.generation, place_store(host, self.mesh),
                           nbytes)
        with self._lock:
            if self._bulk is not None \
                    and self._bulk.generation > state.generation:
                return None  # a newer build won while we uploaded
            self._bulk = state
        if self._m_groups is not None:
            self._m_groups.set(
                sum(1 for _c, sh in snap.store.shards.items() if sh.n)
            )
        self._note_resident()
        self.log(
            f"mesh: generation {snap.generation} placed over "
            f"{self.n_devices} devices ({nbytes} resident bytes)"
        )
        return state

    def _span_state(self, snap, index_of) -> _SpanState | None:
        return self._state("spans", snap,
                           lambda: self._build_span_state(snap, index_of))

    def _build_span_state(self, snap, index_of) -> _SpanState | None:
        """The stacked-index build and upload, under the build lock."""
        from annotatedvdb_tpu_torch.parallel.mesh import groups_per_device
        from annotatedvdb_tpu_torch.runtime import to_device

        self._stamp_build("spans")
        codes = [c for c, sh in snap.store.shards.items() if sh.n]
        per_dev = groups_per_device(self.placement, codes)
        g_max = max((len(v) for v in per_dev.values()), default=0)
        if g_max == 0:
            return None
        b_pad = self.n_devices * g_max
        indexes = {}
        r_cap = 1
        for code in codes:
            index = index_of(code)
            if index is None or index.n == 0:
                continue
            indexes[code] = index
            r_cap = max(r_cap, next_pow2(index.n))
        if not indexes:
            return None
        stack = np.full((b_pad, r_cap), POS_SENTINEL, np.int32)
        row_of: dict = {}
        for dev, dev_codes in per_dev.items():
            for k, code in enumerate(dev_codes):
                index = indexes.get(code)
                if index is None:
                    continue
                row = dev * g_max + k
                row_of[code] = row
                stack[row, : index.n] = index.pos
        nbytes = stack.nbytes
        with self._lock:
            other = self._bulk.nbytes if self._bulk is not None else 0
        if self.budget and (nbytes + other) // self.n_devices > self.budget:
            self.log(
                f"mesh: generation {snap.generation} interval stack "
                f"({nbytes} bytes + {other} identity bytes) exceeds the "
                f"per-device budget {self.budget}; panels stay on the "
                "single-device path"
            )
            state = _SpanState(snap.generation, None, {}, b_pad, 0)
            with self._lock:
                self._spans = state
            self._note_resident()
            return None
        committed = [to_device(stack[d * g_max:(d + 1) * g_max], dev)
                     for d, dev in enumerate(self.mesh.devices)]
        state = _SpanState(snap.generation, committed, row_of, b_pad, nbytes)
        with self._lock:
            if self._spans is not None \
                    and self._spans.generation > state.generation:
                return None  # a newer build won while we uploaded
            self._spans = state
        self._note_resident()
        return state

    def _drop_states(self) -> None:
        """Forget device state after a failed dispatch: the next attempt
        (after the breaker's cool-down) rebuilds cleanly."""
        with self._lock:
            self._bulk = None
            self._spans = None
            # the breaker's cool-down is the retry gate after a failure
            self._last_build = {"bulk": NEVER_BUILT, "spans": NEVER_BUILT}
        self._note_resident()

    # -- dispatch policy ----------------------------------------------------

    def _allow(self) -> bool:
        return self.breaker is None or self.breaker.allow_device(MESH_GROUP)

    def _failed(self, kind: str, exc: Exception) -> None:
        if self.breaker is None:
            # no breaker: a mesh fault fails the request (no quiet fallback)
            raise exc
        self.breaker.record_failure(MESH_GROUP, exc)
        if self._m_fallback is not None:
            self._m_fallback[kind].inc()
        self._drop_states()
        self.log(f"mesh: {kind} dispatch failed, serving single-device "
                 f"({exc})")

    def _succeeded(self, kind: str) -> None:
        if self.breaker is not None:
            self.breaker.record_success(MESH_GROUP)
        if self._m_dispatch is not None:
            self._m_dispatch[kind].inc()

    # -- bulk lookup --------------------------------------------------------

    def would_dispatch(self, snap) -> bool:
        """Cheap pre-encode gate: whether a bulk dispatch for this snapshot
        could run (breaker closed, state present or a rebuild window open,
        not tombstoned or stale).  The breaker check is the non-consuming
        one; the admission belongs to :meth:`bulk_lookup`."""
        if self.breaker is not None \
                and not self.breaker.would_allow(MESH_GROUP):
            return False
        with self._lock:
            state = self._bulk
            if state is not None:
                if state.generation == snap.generation:
                    return state.store is not None
                if state.generation > snap.generation:
                    return False
        return self._rebuild_allowed("bulk")

    def bulk_lookup(self, snap, chrom, pos, h, ref, alt, ref_len, alt_len):
        """(found [Q] bool, global row id [Q] int64) for host-hashed query
        identities, via ONE sharded call — or ``None``: the caller takes
        the single-device path (breaker open, over budget, rate-limited or
        a failed dispatch under a breaker)."""
        if not self._allow():
            return None
        state = self._bulk_state(snap)
        if state is None:
            return None
        from annotatedvdb_tpu_torch.ops.dedup import CHROM_MIX
        from annotatedvdb_tpu_torch.parallel.distributed import (
            distributed_serve_lookup_step,
        )
        from annotatedvdb_tpu_torch.parallel.mesh import pad_rows

        nq = int(np.asarray(pos).shape[0])
        m = pad_rows(next_pow2(max(nq, self.n_devices)), self.mesh)
        chrom_p = np.zeros(m, np.int8)
        chrom_p[:nq] = np.asarray(chrom, np.int8)
        pos_p = np.full(m, POS_SENTINEL, np.int32)
        pos_p[:nq] = np.asarray(pos, np.int32)
        hm_p = np.zeros(m, np.uint32)
        hm_p[:nq] = np.asarray(h, np.uint32) ^ (
            np.asarray(chrom, np.uint32) * np.uint32(CHROM_MIX)
        )
        width = np.asarray(ref).shape[1]
        ref_p = np.zeros((m, width), np.uint8)
        ref_p[:nq] = ref
        alt_p = np.zeros((m, width), np.uint8)
        alt_p[:nq] = alt
        rl_p = np.ones(m, np.int32)
        rl_p[:nq] = np.asarray(ref_len, np.int32)
        al_p = np.ones(m, np.int32)
        al_p[:nq] = np.asarray(alt_len, np.int32)
        try:
            # crash point: a device failure inside the sharded gather — the
            # breaker must absorb it on the byte-identical single-device
            # path, never wrong bytes
            faults.fire("mesh.dispatch")
            rid_out, found, store_row = distributed_serve_lookup_step(
                self.mesh, chrom_p, pos_p, hm_p, ref_p, alt_p, rl_p, al_p,
                state.store,
            )
        except Exception as exc:
            self._failed("bulk", exc)
            return None
        self._succeeded("bulk")
        out_found = np.zeros(nq, np.bool_)
        out_gid = np.full(nq, -1, np.int64)
        take = rid_out >= 0
        src = rid_out[take]
        out_found[src] = found[take]
        out_gid[src] = store_row[take]
        return out_found, out_gid

    # -- region panels ------------------------------------------------------

    def panel_spans(self, snap, queries: dict, index_of):
        """``{code: (lo, hi, level, leaf)}`` for a panel's per-group query
        arrays (``{code: (starts, ends)}``, pre-clamped), via one stacked
        BITS launch per shard — or ``None`` (single-device path).  Codes
        without an interval index are absent from the result."""
        if not queries or not self._allow():
            return None
        state = self._span_state(snap, index_of)
        if state is None:
            return None
        from annotatedvdb_tpu_torch.ops.intervals import bits_spans_stacked
        from annotatedvdb_tpu_torch.runtime import to_device

        rows = {
            code: q for code, q in queries.items() if code in state.row_of
        }
        if not rows:
            return None
        q_cap = next_pow2(max(len(q[0]) for q in rows.values()))
        starts = np.zeros((state.b_pad, q_cap), np.int32)
        ends = np.zeros((state.b_pad, q_cap), np.int32)
        for code, (q_starts, q_ends) in rows.items():
            r = state.row_of[code]
            starts[r, : len(q_starts)] = q_starts
            ends[r, : len(q_ends)] = q_ends
        g_max = state.b_pad // self.n_devices
        try:
            # crash point: the spans twin of the bulk dispatch above
            faults.fire("mesh.dispatch")
            parts = []
            for d, (dev, pos_d) in enumerate(zip(self.mesh.devices,
                                                 state.pos_stack)):
                blk = slice(d * g_max, (d + 1) * g_max)
                parts.append(bits_spans_stacked(
                    pos_d, to_device(starts[blk], dev),
                    to_device(ends[blk], dev),
                ))
            lo, hi, level, leaf = (
                np.concatenate([p[i].cpu().numpy() for p in parts])
                for i in range(4)
            )
        except Exception as exc:
            self._failed("spans", exc)
            return None
        self._succeeded("spans")
        out = {}
        for code, (q_starts, _q_ends) in rows.items():
            r = state.row_of[code]
            k = len(q_starts)
            out[code] = (lo[r, :k], hi[r, :k], level[r, :k], leaf[r, :k])
        return out

    # -- introspection ------------------------------------------------------

    def stats(self) -> dict:
        """Mesh block for ``/stats`` and ``doctor status``."""
        from annotatedvdb_tpu_torch.parallel.mesh import groups_per_device

        with self._lock:
            bulk = self._bulk
            spans = self._spans
        placed = groups_per_device(self.placement, self.placement.keys())
        return {
            "devices": self.n_devices,
            "bulk_min": self.bulk_min,
            "budget_bytes": self.budget,
            "resident_bytes": (
                (bulk.nbytes if bulk is not None else 0)
                + (spans.nbytes if spans is not None else 0)
            ),
            "generation": bulk.generation if bulk is not None else None,
            "groups_per_device": {
                str(dev): len(codes) for dev, codes in placed.items()
            },
        }


def _live(state) -> bool:
    """Whether a state holds device data (not a budget tombstone)."""
    return (state.store is not None if isinstance(state, _BulkState)
            else state.pos_stack is not None)
