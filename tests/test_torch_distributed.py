"""The port's sharded step programs and mesh kernels against the
reference's, on the CPU.

``tests/test_distributed.py``'s cases for ``annotatedvdb_tpu_torch``,
widened to every step: the annotate, insert, update and serve-lookup
steps' outputs (annotations, post-exchange row ids, flags, store rows and
counters) equal the reference's on the same seeded batches at 2, 4 and 8
shards, with the lossless default capacity and with a small one (drops
counted, the same ``n_dropped``); the exchange routes every row to its
owner; ownership tables, position blocks and exact capacities equal the
reference's; ``build_device_shard_store`` equals the reference's array
for array, both routings.  Then the mesh kernels' plain versions
(``lookup_in_sorted_multi``, ``bits_spans_stacked``,
``mark_batch_duplicates(_multi)``) against the reference's jitted kernels
and numpy twins on the smoke's edge inputs, and the ``_mesh`` surfaces
against their twins.  The reference runs on the 8 virtual CPU devices of
``tests/conftest.py``, the port on virtual CPU shards.  Exact throughout.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import pytest
import torch

from annotatedvdb_tpu.io.synth import synthetic_batch as ref_synthetic_batch
from annotatedvdb_tpu.ops import dedup as ref_dedup
from annotatedvdb_tpu.ops import intervals as ref_intervals
from annotatedvdb_tpu.ops.hashing import allele_hash_jit
from annotatedvdb_tpu.parallel import distributed as RD
from annotatedvdb_tpu.parallel import make_mesh as ref_make_mesh
from annotatedvdb_tpu.parallel.device_store import (
    build_device_shard_store as ref_build_store,
)
from annotatedvdb_tpu.store import VariantStore as RefStore

from annotatedvdb_tpu_torch.io.synth import synthetic_batch
from annotatedvdb_tpu_torch.ops import dedup, intervals
from annotatedvdb_tpu_torch.parallel import distributed as D
from annotatedvdb_tpu_torch.parallel import mesh as meshlib
from annotatedvdb_tpu_torch.parallel.device_store import (
    build_device_shard_store,
    place_store,
)
from annotatedvdb_tpu_torch.store import VariantStore

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as smoke  # noqa: E402

CPU = torch.device("cpu")
SHARDS = (2, 4, 8)


def cpu_mesh(n):
    return meshlib.make_mesh(n, devices=[CPU] * n)


def _batches(seed, n=256, width=16, dups=((10, 0, 6),)):
    """The same seeded batch from both packages' generators, with rows
    copied (``dst, src, count``) for in-batch duplicates."""
    port, ref = synthetic_batch(n, width=width, seed=seed), \
        ref_synthetic_batch(n, width=width, seed=seed)
    for b in (port, ref):
        for dst, src, count in dups:
            for f in b._fields:
                getattr(b, f)[dst:dst + count] = getattr(b, f)[src:src + count]
    for f in port._fields:
        np.testing.assert_array_equal(getattr(port, f), getattr(ref, f))
    return port, ref


def _eq(got, want, what=""):
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            _eq(got[k], want[k], f"{what}.{k}")
        return
    if hasattr(want, "_fields"):
        for f in want._fields:
            _eq(getattr(got, f), getattr(want, f), f"{what}.{f}")
        return
    if isinstance(want, tuple):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            _eq(g, w, f"{what}[{i}]")
        return
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                  err_msg=what)


def _stores(batch, rows, width):
    """The same store in both packages: ``rows`` of ``batch`` appended per
    chromosome with the reference's hash, saved once and loaded by each."""
    store = RefStore(width=width)
    sel = np.asarray(rows)
    h = np.asarray(allele_hash_jit(batch.ref[sel], batch.alt[sel],
                                   batch.ref_len[sel], batch.alt_len[sel]))
    for code in np.unique(batch.chrom[sel]):
        k = np.where(batch.chrom[sel] == code)[0]
        store.shard(int(code)).append(
            {"pos": batch.pos[sel][k], "h": h[k],
             "ref_len": batch.ref_len[sel][k], "alt_len": batch.alt_len[sel][k]},
            batch.ref[sel][k], batch.alt[sel][k],
        )
    return store


@pytest.fixture(scope="module")
def saved_store(tmp_path_factory):
    """A multi-chromosome store of 2 segments a chromosome on disk (the
    reference's writer), for the snapshot and step tests."""
    port, ref = _batches(21, n=512, width=16, dups=())
    store = _stores(ref, range(0, 200), 16)
    more = _stores(ref, range(200, 300), 16)
    for code, shard in more.shards.items():
        for seg in shard.segments:
            store.shard(code).append(
                dict(seg.cols), seg.ref, seg.alt)
    path = str(tmp_path_factory.mktemp("dist_store") / "store")
    store.save(path)
    return path, port, ref


# ---------------------------------------------------------------------------
# ownership, capacity, the exchange


def test_owner_tables_and_capacities_match_reference():
    from annotatedvdb_tpu.utils.arrays import mesh_capacity as ref_mesh_capacity

    from annotatedvdb_tpu_torch.utils.arrays import mesh_capacity

    for n in range(1, 9):
        assert D.chromosome_owner_table(n) == RD.chromosome_owner_table(n)
    n_shards, n = 8, 1 << 13
    chrom = np.full(n, 22, np.int8)
    pos = np.sort(np.random.default_rng(3).integers(1, 50_000_000, n)).astype(np.int32)
    owner = D.position_block_owner(chrom, pos, n_shards)
    np.testing.assert_array_equal(owner, RD.position_block_owner(chrom, pos, n_shards))
    counts = np.bincount(owner, minlength=n_shards)
    assert (counts > 0).all() and counts.max() <= 2 * n / n_shards
    assert D.exact_capacity(owner, n_shards) == RD.exact_capacity(owner, n_shards)
    for rows in (1, 5, 100, 1000, 4097):
        for shards in (1, 3, 6, 8, 12):
            assert mesh_capacity(rows, shards) == ref_mesh_capacity(rows, shards)
    # the on-device owner twin equals the host formula
    t = D._position_owner(torch.from_numpy(chrom), torch.from_numpy(pos), n_shards)
    np.testing.assert_array_equal(t.numpy(), owner)


@pytest.mark.parametrize("n_shards", SHARDS)
def test_reshard_routes_to_owner(n_shards):
    """After the exchange every valid row sits on its owning shard, in the
    reference's post-exchange layout; no row is lost."""
    port, _ref = _batches(7)
    capacity = port.n // n_shards  # lossless: a source may send all its rows
    mesh = cpu_mesh(n_shards)
    chrom = meshlib.shard_rows(mesh, port.chrom)
    received, valid, dropped = D.reshard_by_owner(
        mesh, [D.chromosome_owner(c, n_shards) for c in chrom],
        [(c,) for c in chrom], capacity,
    )
    assert dropped == 0
    table = np.asarray(D.chromosome_owner_table(n_shards))
    total = 0
    for shard, ((r,), ok) in enumerate(zip(received, valid)):
        assert r.shape[0] == n_shards * capacity
        chroms = r[ok].numpy()
        np.testing.assert_array_equal(table[chroms.astype(np.int32)], shard)
        total += int(ok.sum())
    assert total == port.n


# ---------------------------------------------------------------------------
# the four steps against the reference


@pytest.mark.parametrize("capacity", [None, 8], ids=["lossless", "cap8"])
@pytest.mark.parametrize("n_shards", SHARDS)
def test_annotate_step_matches_reference(n_shards, capacity):
    port, ref = _batches(11)
    got = D.distributed_annotate_step(cpu_mesh(n_shards), port, capacity=capacity)
    want = RD.distributed_annotate_step(ref_make_mesh(n_shards), ref,
                                        capacity=capacity)
    _eq(got, want, "annotate")
    if capacity is None:
        assert int(got[3]) == 0
        assert int(got[2].sum()) + int(got[4]) == port.n
    # position-block routing (the loaders' annotate fan-out)
    owner = D.position_block_owner(port.chrom, port.pos, n_shards)
    got = D.distributed_annotate_step(cpu_mesh(n_shards), port, owner=owner,
                                      capacity=capacity, with_hash=True)
    want = RD.distributed_annotate_step(ref_make_mesh(n_shards), ref,
                                        owner=owner, capacity=capacity)
    _eq(got[:5], want, "annotate/position")
    rid = got[1]
    take = rid >= 0
    h = np.asarray(allele_hash_jit(ref.ref, ref.alt, ref.ref_len, ref.alt_len))
    np.testing.assert_array_equal(got[5][take], h[rid[take]])


@pytest.mark.parametrize("capacity", [None, 8], ids=["lossless", "cap8"])
@pytest.mark.parametrize("n_shards", SHARDS)
def test_insert_step_matches_reference(n_shards, capacity):
    """Verdicts and counters with a store snapshot holding rows [20, 30)
    and [0, 8) of the batch, whose rows [10, 16) repeat [0, 6)."""
    port, ref = _batches(11)
    store = _stores(ref, list(range(20, 30)) + list(range(0, 8)), 16)
    port_store = VariantStore(width=16)
    for code, shard in store.shards.items():
        for seg in shard.segments:
            from annotatedvdb_tpu_torch.store.variant_store import Segment

            port_store.shard(code).append_segment(
                Segment.build(dict(seg.cols), seg.ref, seg.alt))
    dev = build_device_shard_store(port_store, n_shards)
    got = D.distributed_insert_step(cpu_mesh(n_shards), port, dev_store=dev,
                                    capacity=capacity)
    want = RD.distributed_insert_step(ref_make_mesh(n_shards), ref,
                                      dev_store=ref_build_store(store, n_shards),
                                      capacity=capacity)
    _eq(got, want, "insert")
    c = got[3]
    if capacity is None:
        # rows [10, 16) are batch duplicates (counted once, though their
        # identities are in the store too); [0, 8) and [20, 30) store ones
        assert int(c["n_batch_dup"]) == 6 and int(c["n_store_dup"]) == 18
        assert int(c["class_counts"].sum()) + 6 + 18 + int(c["n_fallback"]) == port.n
    assert not (got[2]["dup_batch"] & got[2]["in_store"]).any()
    # no snapshot: membership all false, dedup still runs
    got = D.distributed_insert_step(cpu_mesh(n_shards), port, capacity=capacity)
    want = RD.distributed_insert_step(ref_make_mesh(n_shards), ref,
                                      capacity=capacity)
    _eq(got, want, "insert/no-store")
    assert not got[2]["in_store"].any()


@pytest.mark.parametrize("routing", ["chrom", "position"])
@pytest.mark.parametrize("capacity", [None, 8], ids=["lossless", "cap8"])
@pytest.mark.parametrize("n_shards", SHARDS)
def test_update_step_matches_reference(saved_store, n_shards, capacity, routing):
    """Store row ids and counters for a batch half of whose rows are in
    the saved store (the other half and an over-width row miss)."""
    path, port, ref = saved_store
    q_port, q_ref = port, ref
    got = D.distributed_update_step(
        cpu_mesh(n_shards), q_port,
        build_device_shard_store(VariantStore.load(path, readonly=True),
                                 n_shards, routing=routing),
        capacity=capacity, routing=routing)
    want = RD.distributed_update_step(
        ref_make_mesh(n_shards), q_ref,
        ref_build_store(RefStore.load(path, readonly=True), n_shards,
                        routing=routing),
        capacity=capacity, routing=routing)
    _eq(got, want, "update")
    if capacity is None:
        assert int(got[3]["n_matched"]) == 300 and int(got[3]["n_dropped"]) == 0


@pytest.mark.parametrize("capacity", [None, 8], ids=["lossless", "cap8"])
@pytest.mark.parametrize("n_shards", SHARDS)
def test_serve_lookup_step_matches_reference(saved_store, n_shards, capacity):
    from annotatedvdb_tpu.ops.dedup import CHROM_MIX

    path, port, ref = saved_store
    h = np.asarray(allele_hash_jit(ref.ref, ref.alt, ref.ref_len, ref.alt_len))
    hm = h ^ (ref.chrom.astype(np.uint32) * np.uint32(CHROM_MIX))
    args = (port.chrom, port.pos, hm, port.ref, port.alt, port.ref_len,
            port.alt_len)
    dev = place_store(build_device_shard_store(
        VariantStore.load(path, readonly=True), n_shards), cpu_mesh(n_shards))
    got = D.distributed_serve_lookup_step(dev.mesh, *args, dev, capacity=capacity)
    want = RD.distributed_serve_lookup_step(
        ref_make_mesh(n_shards), *args,
        ref_build_store(RefStore.load(path, readonly=True), n_shards),
        capacity=capacity)
    _eq(got, want, "serve-lookup")


@pytest.mark.parametrize("routing", ["chrom", "position"])
@pytest.mark.parametrize("n_shards", SHARDS)
def test_device_store_matches_reference(saved_store, n_shards, routing):
    """``build_device_shard_store`` equals the reference's, array for array
    (dtypes included), from the same store directory."""
    path, _port, _ref = saved_store
    got = build_device_shard_store(VariantStore.load(path, readonly=True),
                                   n_shards, routing=routing)
    want = ref_build_store(RefStore.load(path, readonly=True), n_shards,
                           routing=routing)
    for f in want._fields:
        g, w = getattr(got, f), np.asarray(getattr(want, f))
        assert g.dtype == w.dtype, f
        np.testing.assert_array_equal(g, w, err_msg=f)
    placed = place_store(got, cpu_mesh(n_shards))
    assert len(placed) == n_shards
    np.testing.assert_array_equal(placed[1][2].numpy(), got.hm[1].astype(np.int64))


# ---------------------------------------------------------------------------
# the mesh kernels' plain versions


def _torch_cols(cols):
    out = [torch.from_numpy(np.ascontiguousarray(c)) for c in cols]
    out[2] = out[2].to(torch.int64)  # the mixed hash as non-negative int64
    return out


@pytest.mark.parametrize("width", [16, 49, 96])
def test_lookup_in_sorted_multi_plain_version_matches_reference(width):
    """The smoke's edge slices (runs of five and four equal keys, the
    cross-chromosome collision, unsigned hash order, the sentinel pad, an
    empty and an all-sentinel slice, a random slice) through the plain
    version, the reference's jitted kernel and its numpy twin."""
    for label, store, query in smoke.lookup_multi_edge_cases(width):
        found, index = dedup.lookup_in_sorted_multi(
            *_torch_cols(store), *_torch_cols(query))
        if not store[1].size:
            # the reference's kernels index a non-empty slice only (a shard
            # of a DeviceShardStore holds at least one, padded, row)
            assert not found.any() and (index == -1).all()
            continue
        twin = ref_dedup.lookup_in_sorted_multi_np(*store, *query)
        np.testing.assert_array_equal(found.numpy(), twin[0], err_msg=label)
        np.testing.assert_array_equal(index.numpy(), twin[1], err_msg=label)
        jit = ref_dedup.lookup_in_sorted_multi_jit(*store, *query)
        np.testing.assert_array_equal(found.numpy(), np.asarray(jit[0]),
                                      err_msg=label)
        np.testing.assert_array_equal(index.numpy(), np.asarray(jit[1]),
                                      err_msg=label)
        if label == "edges":
            # the fifth row of the run and the collision miss; the run of
            # four all hit
            assert found[:4].all() and not found[4]
            assert found[5:9].all() and not found[18]


def test_lookup_in_sorted_multi_refuses_other_devices():
    store, query = smoke.lookup_multi_edge_cases(16)[0][1:]
    cols = _torch_cols(store) + _torch_cols(query)
    meta = [t.to("meta") for t in cols]
    with pytest.raises(ValueError, match="unsupported device"):
        dedup.lookup_in_sorted_multi(*meta)


@pytest.mark.parametrize("case", [c[0] for c in smoke.stacked_bits_edge_cases()])
def test_bits_spans_stacked_plain_version_matches_reference(case):
    label, pos, starts, ends = next(
        c for c in smoke.stacked_bits_edge_cases() if c[0] == case)
    got = intervals.bits_spans_stacked(
        *(torch.from_numpy(np.ascontiguousarray(x)) for x in (pos, starts, ends)))
    jit = ref_intervals.bits_spans_stacked_jit(pos, starts, ends)
    twin = ref_intervals.bits_spans_stacked_host(pos, starts, ends)
    port_twin = intervals.bits_spans_stacked_host(pos, starts, ends)
    for name, g, j, t, p in zip(("lo", "hi", "level", "leaf"), got, jit,
                                twin, port_twin):
        assert g.dtype == {"level": torch.int8}.get(name, torch.int32)
        np.testing.assert_array_equal(g.numpy(), np.asarray(j), err_msg=name)
        np.testing.assert_array_equal(g.numpy(), t, err_msg=name)
        np.testing.assert_array_equal(p, t, err_msg=name)
    # row for row what the single-group search gives
    for b in range(pos.shape[0]):
        one = intervals.bits_spans_reference(
            *(torch.from_numpy(np.ascontiguousarray(x[b]))
              for x in (pos, starts, ends)))
        for g, o in zip(got, one):
            assert torch.equal(g[b], o)


@pytest.mark.parametrize("n", [1, 2, 64, 257])
def test_mark_batch_duplicates_match_reference(n):
    """The in-batch dedup (first in row order wins), with and without the
    chromosome key, against the reference's jitted kernels and twins:
    duplicated rows, equal (pos, hash) rows on two chromosomes, unique
    negative (salted) positions."""
    port, ref = _batches(31, n=max(n, 16), dups=((8, 0, 4), (12, 1, 2)))
    sl = slice(0, n)
    chrom, pos = ref.chrom[sl].copy(), ref.pos[sl].copy()
    if n > 20:
        chrom[20] = chrom[0] % 25 + 1  # row 0's identity on another chromosome
        pos[20] = pos[0]
        pos[-3:] = -1 - np.arange(3)
    h = np.array(allele_hash_jit(ref.ref[sl], ref.alt[sl], ref.ref_len[sl],
                                 ref.alt_len[sl]))
    if n > 20:
        h[20] = h[0]
    cols = (pos, h, ref.ref[sl], ref.alt[sl], ref.ref_len[sl], ref.alt_len[sl])
    t = [torch.from_numpy(np.ascontiguousarray(c)) for c in cols]
    t[1] = t[1].to(torch.int64)
    got = dedup.mark_batch_duplicates(*t).numpy()
    np.testing.assert_array_equal(got, np.asarray(ref_dedup.mark_batch_duplicates_jit(*cols)))
    np.testing.assert_array_equal(got, ref_dedup.mark_batch_duplicates_np(*cols))
    got = dedup.mark_batch_duplicates_multi(torch.from_numpy(chrom), *t).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(ref_dedup.mark_batch_duplicates_multi_jit(chrom, *cols)))
    np.testing.assert_array_equal(
        got, ref_dedup.mark_batch_duplicates_multi_np(chrom, *cols))
    # the mixed hash: the reference's value, as int64
    mixed = dedup.mix_chrom_hash(t[1], torch.from_numpy(chrom)).numpy()
    np.testing.assert_array_equal(
        mixed, np.asarray(ref_dedup.mix_chrom_hash(h, chrom)).astype(np.int64))


# ---------------------------------------------------------------------------
# the sharded surfaces (mesh_pjit) against their twins


@pytest.mark.parametrize("n_shards", SHARDS)
def test_mesh_surfaces_match_twins(n_shards):
    """``annotate_kernel_mesh``, ``allele_hash_mesh``,
    ``bin_index_kernel_mesh`` and ``mark_batch_duplicates_mesh`` over a
    row count no mesh divides (pad rows sliced away) equal the reference's
    sharded surfaces and numpy twins."""
    from annotatedvdb_tpu.ops import annotate as ref_annotate
    from annotatedvdb_tpu.ops import binindex as ref_binindex
    from annotatedvdb_tpu.ops import hashing as ref_hashing

    from annotatedvdb_tpu_torch.ops import annotate, binindex, hashing

    port, ref = _batches(41, n=203, dups=((30, 0, 9),))
    mesh, rmesh = cpu_mesh(n_shards), ref_make_mesh(n_shards)
    args = (ref.pos, ref.ref, ref.alt, ref.ref_len, ref.alt_len)
    got = annotate.annotate_kernel_mesh(*args, mesh=mesh)
    want = ref_annotate.annotate_kernel_mesh(*args, mesh=rmesh)
    twin = ref_annotate.annotate_kernel_np(*args)
    ok = ~twin["host_fallback"]
    for name in annotate.ANNOTATE_FIELDS:
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(want[name]),
                                      err_msg=name)
        np.testing.assert_array_equal(got[name].numpy()[ok],
                                      np.asarray(twin[name])[ok], err_msg=name)
    h = hashing.allele_hash_mesh(*args[1:], mesh=mesh).numpy()
    np.testing.assert_array_equal(h, np.asarray(ref_hashing.allele_hash_mesh(*args[1:], mesh=rmesh)))
    np.testing.assert_array_equal(h, ref_hashing.allele_hash_np(*args[1:]))
    ends = ref.pos + ref.ref_len
    level, leaf = binindex.bin_index_kernel_mesh(ref.pos, ends, mesh=mesh)
    rl, rf = ref_binindex.bin_index_kernel_mesh(ref.pos, ends, mesh=rmesh)
    np.testing.assert_array_equal(level.numpy(), np.asarray(rl))
    np.testing.assert_array_equal(leaf.numpy(), np.asarray(rf))
    hh = np.array(allele_hash_jit(*args[1:]))
    cols = (ref.pos, hh, *args[1:])
    dup = dedup.mark_batch_duplicates_mesh(*cols, mesh=mesh).numpy()
    np.testing.assert_array_equal(
        dup, np.asarray(ref_dedup.mark_batch_duplicates_mesh(*cols, mesh=rmesh)))
    np.testing.assert_array_equal(dup, ref_dedup.mark_batch_duplicates_np(*cols))
    assert dup.sum() == 9
