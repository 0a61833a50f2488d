"""The port's device mesh against the reference's, on the CPU.

``tests/test_mesh.py``'s battery, case by case, for
``annotatedvdb_tpu_torch``: the mesh authority (shape grammar, the device
pool and ``AVDBC_VIRTUAL_DEVICES``, sizing, placement), the serving
executor (bulk, point, region and regions bodies from a meshed engine
equal to a plain engine's and to the reference's meshed and plain
engines; the bulk gate, the budget tombstone, the generation swap, the
rebuild rate limit, the per-device budget ``build_server`` and
``build_aio_server`` hand down, the residency heat, the metrics), both
HTTP front ends with
``AVDB_SERVE_MESH=1``, the per-device residency placement, a load through
the global mesh, the ``mesh.dispatch`` fault point under the breaker,
and the plain versions of the mesh kernels (``lookup_in_sorted_multi``,
``bits_spans_stacked``, ``mark_batch_duplicates(_multi)``) and the
``_mesh`` surfaces against the reference's jitted kernels and numpy twins.

The reference runs on the 8 virtual CPU devices ``tests/conftest.py``
gives JAX; the port on 8 virtual CPU shards (an explicit pool, or
``AVDBC_VIRTUAL_DEVICES``).  Every comparison is exact.
"""

from __future__ import annotations

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from annotatedvdb_tpu.loaders.lookup import identity_hashes as ref_identity_hashes
from annotatedvdb_tpu.parallel import mesh as ref_meshlib
from annotatedvdb_tpu.serve import DeviceBreaker as RefBreaker
from annotatedvdb_tpu.serve import MeshExecutor as RefMeshExecutor
from annotatedvdb_tpu.serve import QueryEngine as RefEngine
from annotatedvdb_tpu.serve import StaticSnapshots as RefSnaps
from annotatedvdb_tpu.store import VariantStore as RefStore
from annotatedvdb_tpu.store.variant_store import RawJson as RefRawJson
from annotatedvdb_tpu.types import encode_allele_array as ref_encode

from annotatedvdb_tpu_torch.parallel import mesh as meshlib
from annotatedvdb_tpu_torch.serve import mesh_exec
from annotatedvdb_tpu_torch.serve.engine import QueryEngine
from annotatedvdb_tpu_torch.serve.mesh_exec import MeshExecutor, serve_mesh_executor
from annotatedvdb_tpu_torch.serve.resilience import DeviceBreaker
from annotatedvdb_tpu_torch.serve.snapshot import SnapshotManager, StaticSnapshots
from annotatedvdb_tpu_torch.store import VariantStore
from annotatedvdb_tpu_torch.types import NUM_CHROMOSOMES, chromosome_label

WIDTH = 8
CHROMS = (1, 8, 23)
BASES = ("A", "C", "G", "T")
CPU = torch.device("cpu")


def cpu_mesh(n: int = 8):
    return meshlib.make_mesh(n, devices=[CPU] * n)


@pytest.fixture(autouse=True)
def _fresh_mesh_cache(monkeypatch):
    for var in ("AVDB_MESH_SHAPE", "AVDB_SERVE_MESH", "AVDB_MESH_BULK_MIN",
                "AVDBC_VIRTUAL_DEVICES"):
        monkeypatch.delenv(var, raising=False)
    meshlib.reset_global_mesh()
    ref_meshlib.reset_global_mesh()
    yield
    meshlib.reset_global_mesh()
    ref_meshlib.reset_global_mesh()


# ---------------------------------------------------------------------------
# the reference's synthetic multi-chromosome store (a shadowed duplicate and
# a long-allele tail), written once with the reference's API; both packages
# serve that directory


def _append(shard, rows):
    refs = [r["ref"] for r in rows]
    alts = [r["alt"] for r in rows]
    ref, ref_len = ref_encode(refs, WIDTH)
    alt, alt_len = ref_encode(alts, WIDTH)
    h = ref_identity_hashes(WIDTH, ref, alt, ref_len, alt_len, refs, alts)
    cols = {
        "pos": np.asarray([r["pos"] for r in rows], np.int32),
        "h": h, "ref_len": ref_len, "alt_len": alt_len,
    }
    ann = {
        "cadd_scores": [
            {"CADD_phred": float(3 + (r["pos"] % 17))}
            if r["pos"] % 3 == 0 else None for r in rows
        ],
        "vep_output": [
            RefRawJson(f'{{"p":{r["pos"]}}}') if r["pos"] % 5 == 0 else None
            for r in rows
        ],
    }
    long_alleles = [
        (r["ref"], r["alt"])
        if len(r["ref"]) > WIDTH or len(r["alt"]) > WIDTH else None
        for r in rows
    ]
    shard.append(cols, ref, alt, annotations=ann, long_alleles=long_alleles)


def _build_store():
    store = RefStore(width=WIDTH)
    truth = []
    for code in CHROMS:
        shard = store.shard(code)
        for run, base in enumerate((500, 60_000)):
            rows = []
            for i in range(25):
                pos = base + 977 * i
                k = (i + run) % 4
                ref = BASES[k]
                alt = BASES[(k + 1) % 4] if i % 4 else ref + "TTG"
                if i == 20:  # long-allele tail: full-string identity
                    ref = "A" * (WIDTH + 4)
                    alt = "G"
                rows.append({"chrom": code, "pos": pos, "ref": ref,
                             "alt": alt})
            _append(shard, rows)
            truth.extend(rows)
    # a shadowed duplicate in a NEWER chr8 segment: first-wins keeps the
    # older row on every path
    dup = next(r for r in truth if r["chrom"] == 8)
    _append(store.shard(8), [dict(dup)])
    return store, truth


def _ids(truth):
    ids = [
        f"{chromosome_label(r['chrom'])}:{r['pos']}:{r['ref']}:{r['alt']}"
        for r in truth
    ]
    ids += ["1:999999999:A:T", "11:50:G:C", "8:505:T:G"]  # misses
    return ids


SPECS = ["8:1-100000", "1:400-2000", "X:59000-90000", "11:1-5000",
         "8:490-600", "1:1-60000000", "8:60000-60000"]


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """The store on disk, and a plain and a meshed engine of each package."""
    store_dir = str(tmp_path_factory.mktemp("torch_mesh") / "store")
    store, truth = _build_store()
    store.save(store_dir)
    ref_store = RefStore.load(store_dir, readonly=True)
    port_store = VariantStore.load(store_dir, readonly=True)
    ref_meshlib.reset_global_mesh()
    ref_breaker = RefBreaker()
    breaker = DeviceBreaker()
    return {
        "dir": store_dir, "truth": truth, "store": port_store,
        "ref_plain": RefEngine(RefSnaps(ref_store), region_cache_size=0),
        "ref_meshed": RefEngine(
            RefSnaps(ref_store), region_cache_size=0, breaker=ref_breaker,
            mesh=RefMeshExecutor(ref_meshlib.global_mesh(),
                                 breaker=ref_breaker, bulk_min=0),
        ),
        "plain": QueryEngine(StaticSnapshots(port_store), region_cache_size=0,
                             device="cpu"),
        "meshed": QueryEngine(
            StaticSnapshots(port_store), region_cache_size=0, breaker=breaker,
            device="cpu",
            mesh=MeshExecutor(cpu_mesh(), breaker=breaker, bulk_min=0),
        ),
    }


# ---------------------------------------------------------------------------
# mesh authority: shape grammar, the pool, sizing, placement


def test_mesh_shape_env_grammar(monkeypatch):
    for mod in (meshlib, ref_meshlib):
        monkeypatch.setenv("AVDB_MESH_SHAPE", "2x4")
        with pytest.raises(ValueError, match="device count"):
            mod.mesh_shape_from_env()
        monkeypatch.setenv("AVDB_MESH_SHAPE", "0")
        with pytest.raises(ValueError, match=">= 1"):
            mod.mesh_shape_from_env()
        monkeypatch.delenv("AVDB_MESH_SHAPE")
        assert mod.mesh_shape_from_env() is None
    monkeypatch.setenv("AVDB_MESH_SHAPE", "64")
    with pytest.raises(ValueError, match="exceeds"):
        meshlib.global_mesh(devices=[CPU] * 8)


def test_device_pool_and_virtual_devices(monkeypatch):
    """The CPU pool is one device; ``AVDBC_VIRTUAL_DEVICES=N`` makes it N
    shards over it; a malformed count raises; without a card the default
    (cuda) pool raises, never falls back to the host."""
    assert meshlib.device_pool("cpu") == (CPU,)
    monkeypatch.setenv(meshlib.VIRTUAL_DEVICES_ENV, "4")
    assert meshlib.device_pool("cpu") == (CPU,) * 4
    for bad, match in (("x", "shard count"), ("0", ">= 1")):
        monkeypatch.setenv(meshlib.VIRTUAL_DEVICES_ENV, bad)
        with pytest.raises(ValueError, match=match):
            meshlib.device_pool("cpu")
    if not torch.cuda.is_available():
        monkeypatch.setenv(meshlib.VIRTUAL_DEVICES_ENV, "4")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            meshlib.device_pool()


def test_global_mesh_sizing(monkeypatch):
    """Sized as the reference's over its 8 devices: the whole pool, then
    ``AVDB_MESH_SHAPE``, then the ``--maxWorkers`` limit; one shard is no
    mesh.  Cached per (shape, pool)."""
    monkeypatch.setenv(meshlib.VIRTUAL_DEVICES_ENV, "8")
    pool = meshlib.device_pool("cpu")
    mesh = meshlib.global_mesh(devices=pool)
    assert mesh.size == ref_meshlib.global_mesh().devices.size == 8
    assert meshlib.global_mesh(devices=pool) is mesh
    assert mesh.physical_devices == 1 and not mesh.distributed
    monkeypatch.setenv("AVDB_MESH_SHAPE", "4")
    meshlib.reset_global_mesh()
    ref_meshlib.reset_global_mesh()
    assert meshlib.global_mesh(devices=pool).size == 4
    assert ref_meshlib.global_mesh().devices.size == 4
    assert meshlib.global_mesh(limit=2, devices=pool).size == 2
    monkeypatch.setenv("AVDB_MESH_SHAPE", "1")
    meshlib.reset_global_mesh()
    assert meshlib.global_mesh(devices=pool) is None
    monkeypatch.delenv("AVDB_MESH_SHAPE")
    assert meshlib.global_mesh(devices=[CPU]) is None


def test_chromosome_placement_covers_every_code():
    from annotatedvdb_tpu_torch.parallel.distributed import chromosome_owner_table

    for n in (2, 4, 8):
        placement = meshlib.chromosome_placement(n)
        assert placement == ref_meshlib.chromosome_placement(n)
        assert set(placement) == set(range(1, NUM_CHROMOSOMES + 1))
        assert set(placement.values()) == set(range(n))
        table = chromosome_owner_table(n)
        assert all(table[code] == dev for code, dev in placement.items())
        per_dev = meshlib.groups_per_device(placement, placement.keys())
        assert per_dev == ref_meshlib.groups_per_device(placement,
                                                        placement.keys())
        assert sum(len(v) for v in per_dev.values()) == NUM_CHROMOSOMES


def test_placement_hint_single_device_is_none(monkeypatch):
    for spec in (None, "1", "4"):
        if spec is None:
            monkeypatch.delenv("AVDB_MESH_SHAPE", raising=False)
        else:
            monkeypatch.setenv("AVDB_MESH_SHAPE", spec)
        assert meshlib.placement_hint() == ref_meshlib.placement_hint()
    assert meshlib.placement_hint()["devices"] == 4


def test_manifest_placement_roundtrip(served, tmp_path, monkeypatch):
    """A store saved under ``AVDB_MESH_SHAPE=4`` carries the reference's
    ``mesh_placement`` block; the port's snapshot reads it back."""
    store = VariantStore.load(served["dir"])
    plain_dir = str(tmp_path / "plain")
    store.save(plain_dir)
    with open(plain_dir + "/manifest.json") as f:
        assert "mesh_placement" not in json.load(f)
    monkeypatch.setenv("AVDB_MESH_SHAPE", "4")
    mesh_dir = str(tmp_path / "meshed")
    store.save(mesh_dir)
    with open(mesh_dir + "/manifest.json") as f:
        block = json.load(f)["mesh_placement"]
    assert block == ref_meshlib.placement_hint()
    assert SnapshotManager(mesh_dir).current().placement == block
    assert SnapshotManager(plain_dir).current().placement is None


# ---------------------------------------------------------------------------
# knob grammar + executor gating


def test_serve_mesh_knob_grammar(monkeypatch):
    for mod in (mesh_exec,):
        monkeypatch.setenv("AVDB_SERVE_MESH", "yes")
        with pytest.raises(ValueError, match="AVDB_SERVE_MESH"):
            mod.resolve_serve_mesh()
        monkeypatch.setenv("AVDB_MESH_BULK_MIN", "many")
        with pytest.raises(ValueError, match="AVDB_MESH_BULK_MIN"):
            mod.resolve_mesh_bulk_min()
    monkeypatch.setenv(meshlib.VIRTUAL_DEVICES_ENV, "8")
    monkeypatch.setenv("AVDB_SERVE_MESH", "0")
    assert serve_mesh_executor(device="cpu") is None
    # auto over virtual shards of one device: the per-group path stays
    monkeypatch.setenv("AVDB_SERVE_MESH", "auto")
    assert serve_mesh_executor(device="cpu") is None
    # forced: the executor engages on the virtual mesh
    monkeypatch.setenv("AVDB_SERVE_MESH", "1")
    monkeypatch.setenv("AVDB_MESH_BULK_MIN", "16")
    ex = serve_mesh_executor(device="cpu")
    assert ex is not None and ex.n_devices == 8 and ex.bulk_min == 16
    # one shard: no mesh, forced or not
    monkeypatch.setenv(meshlib.VIRTUAL_DEVICES_ENV, "1")
    meshlib.reset_global_mesh()
    assert serve_mesh_executor(device="cpu") is None


# ---------------------------------------------------------------------------
# byte-identity: point / bulk / region / regions


def test_bulk_and_point_parity(served):
    ids = _ids(served["truth"])
    want = served["ref_plain"].lookup_many(ids)
    assert served["ref_meshed"].lookup_many(ids) == want
    assert served["plain"].lookup_many(ids) == want
    got = served["meshed"].lookup_many(ids)
    assert got == want
    assert sum(1 for v in want if v is not None) == len(served["truth"])
    # the sharded call actually ran (not a fallback)
    assert served["meshed"].mesh._bulk is not None
    assert served["meshed"].lookup(ids[0]) == served["ref_plain"].lookup(ids[0])
    assert served["meshed"].lookup("11:50:G:C") is None


def test_bulk_min_gates_small_batches(served):
    breaker = DeviceBreaker()
    engine = QueryEngine(
        StaticSnapshots(served["store"]), region_cache_size=0,
        breaker=breaker, device="cpu",
        mesh=MeshExecutor(cpu_mesh(), breaker=breaker, bulk_min=10_000),
    )
    ids = _ids(served["truth"])[:8]
    assert engine.lookup_many(ids) == served["ref_plain"].lookup_many(ids)
    assert engine.mesh._bulk is None  # never dispatched


def test_budget_tombstone_falls_back(served):
    engine = QueryEngine(
        StaticSnapshots(served["store"]), region_cache_size=0, device="cpu",
        mesh=MeshExecutor(cpu_mesh(), bulk_min=0, budget_bytes=16),
    )
    ids = _ids(served["truth"])
    assert engine.lookup_many(ids) == served["ref_plain"].lookup_many(ids)
    assert engine.mesh._bulk.store is None  # tombstoned, not resident


@pytest.mark.parametrize("kwargs", [
    {}, {"min_cadd": 5.0}, {"limit": 3}, {"limit": 0}, {"tokenize": True},
    {"min_cadd": 4.0, "limit": 2, "tokenize": True},
], ids=lambda k: ",".join(f"{a}={b}" for a, b in k.items()) or "plain")
def test_regions_parity(served, kwargs):
    want = served["ref_plain"].regions_serve(SPECS, **kwargs).assemble()
    assert served["ref_meshed"].regions_serve(SPECS, **kwargs).assemble() == want
    assert served["meshed"].regions_serve(SPECS, **kwargs).assemble() == want
    assert served["plain"].regions_serve(SPECS, **kwargs).assemble() == want
    assert served["meshed"].mesh._spans is not None
    for spec in SPECS:
        assert served["meshed"].region(spec) == served["ref_plain"].region(spec)


def test_parity_across_generation_swap(served, tmp_path):
    """The mesh state is generation-keyed: a loader commit rebuilds it, and
    post-swap answers stay byte-identical to the single-device path."""
    store_dir = str(tmp_path / "swap_store")
    RefStore.load(served["dir"]).save(store_dir)
    manager = SnapshotManager(store_dir)
    plain = QueryEngine(manager, region_cache_size=0, device="cpu")
    meshed = QueryEngine(
        manager, region_cache_size=0, device="cpu",
        mesh=MeshExecutor(cpu_mesh(), bulk_min=0, rebuild_min_s=0.0),
    )
    ids = _ids(served["truth"]) + ["8:777777:T:A"]
    assert meshed.lookup_many(ids) == plain.lookup_many(ids)
    gen1 = meshed.mesh._bulk.generation
    writer = RefStore.load(store_dir)
    _append(writer.shard(8), [{"chrom": 8, "pos": 777_777, "ref": "T",
                               "alt": "A"}])
    writer.save(store_dir)
    assert manager.refresh() is True
    want = plain.lookup_many(ids)
    assert meshed.lookup_many(ids) == want
    assert want[-1] is not None  # the new row resolved on both paths
    assert meshed.mesh._bulk.generation > gen1
    assert plain.regions_serve(SPECS).assemble() \
        == meshed.regions_serve(SPECS).assemble()


def test_rebuild_rate_limit_declines_churning_generations(served):
    """A generation churning faster than ``rebuild_min_s`` is not rebuilt:
    the single-device path serves until the window lapses."""
    engine = QueryEngine(
        StaticSnapshots(served["store"]), region_cache_size=0, device="cpu",
        mesh=MeshExecutor(cpu_mesh(), bulk_min=0, rebuild_min_s=3600.0),
    )
    ids = _ids(served["truth"])
    want = served["ref_plain"].lookup_many(ids)
    assert engine.lookup_many(ids) == want
    built = engine.mesh._bulk
    assert built is not None and built.generation == 1
    engine.snapshots = StaticSnapshots(served["store"], generation=2)
    assert engine.lookup_many(ids) == want  # correct bytes, no rebuild
    assert engine.mesh._bulk is built       # state untouched (declined)


def test_rebuild_rate_limit_builds_first_on_a_fresh_host(served, monkeypatch):
    """A never-built kind is always allowed its first build, also where
    the monotonic clock reads less than ``rebuild_min_s`` (a host up one
    second); a second generation inside the window is then declined."""
    monkeypatch.setattr(mesh_exec.time, "monotonic", lambda: 1.0)
    engine = QueryEngine(
        StaticSnapshots(served["store"]), region_cache_size=0, device="cpu",
        mesh=MeshExecutor(cpu_mesh(), bulk_min=0, rebuild_min_s=3600.0),
    )
    ids = _ids(served["truth"])
    want = served["ref_plain"].lookup_many(ids)
    assert engine.lookup_many(ids) == want
    built = engine.mesh._bulk
    assert built is not None and built.generation == 1
    engine.snapshots = StaticSnapshots(served["store"], generation=2)
    assert engine.lookup_many(ids) == want
    assert engine.mesh._bulk is built


def test_build_server_hands_mesh_the_per_device_budget(served, monkeypatch):
    """The mesh budget is the residency manager's already-split share,
    never the raw ``AVDB_SERVE_HBM_BUDGET``."""
    from annotatedvdb_tpu_torch.serve.aio import build_aio_server
    from annotatedvdb_tpu_torch.serve.http import build_server
    from annotatedvdb_tpu_torch.serve.residency import ResidencyManager

    monkeypatch.setenv("AVDB_SERVE_MESH", "1")
    monkeypatch.setenv(meshlib.VIRTUAL_DEVICES_ENV, "8")
    monkeypatch.setenv("AVDB_SERVE_HBM_BUDGET", "8g")  # must be ignored
    residency = ResidencyManager(1 << 20, device="cpu")
    httpd = build_server(store_dir=served["dir"], port=0,
                         residency=residency, device="cpu")
    try:
        assert httpd.ctx.engine.mesh is not None
        assert httpd.ctx.engine.mesh.budget == 1 << 20
    finally:
        httpd.server_close()
        httpd.ctx.batcher.close()
    aio = build_aio_server(store_dir=served["dir"], port=0, device="cpu")
    try:
        assert aio.ctx.engine.mesh.budget == 0
        assert aio.ctx.engine.mesh.n_devices == 8
    finally:
        aio.ctx.batcher.close()


def test_mesh_bulk_keeps_residency_warm(served):
    from annotatedvdb_tpu_torch.serve.residency import ResidencyManager

    residency = ResidencyManager(1 << 30, upload=False, min_rows=0,
                                 plan_interval_s=0.0, device="cpu")
    engine = QueryEngine(
        StaticSnapshots(served["store"]), region_cache_size=0,
        residency=residency, device="cpu",
        mesh=MeshExecutor(cpu_mesh(), bulk_min=0),
    )
    engine.lookup_many(_ids(served["truth"]))
    assert engine.mesh._bulk is not None  # the mesh path really ran
    assert residency.stats()["resident"] > 0  # touches fed the plan


# ---------------------------------------------------------------------------
# byte-identity over both HTTP front ends


def _get(port, path):
    try:
        with urllib.request.urlopen(
            f"http://127.0.0.1:{port}{path}", timeout=30
        ) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as err:
        return err.code, err.read().decode()


def _post(port, path, payload):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=json.dumps(payload).encode(), method="POST",
        headers={"Content-Type": "application/json"},
    )
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as err:
        return err.code, err.read().decode()


def _bodies(port, ids, paths):
    out = [body for _s, body in (_get(port, p) for p in paths)]
    st, bulk = _post(port, "/variants", {"ids": ids})
    assert st == 200
    out.append(bulk)
    st, regions = _post(port, "/regions", {"regions": SPECS, "limit": 5})
    assert st == 200
    out.append(regions)
    st, stats = _post(port, "/stats/region", {"regions": SPECS[:4]})
    assert st == 200
    out.append(stats)
    return out


def test_front_end_parity_mesh_vs_single_device(served, monkeypatch):
    """Each port front end with the mesh forced answers as itself without
    the mesh and as the reference's meshed servers: point, bulk, region,
    regions and stats bodies."""
    from annotatedvdb_tpu.serve.aio import build_aio_server as ref_aio
    from annotatedvdb_tpu.serve.http import build_server as ref_http

    from annotatedvdb_tpu_torch.serve.aio import build_aio_server
    from annotatedvdb_tpu_torch.serve.http import build_server

    ids = _ids(served["truth"])[:40]
    paths = (
        [f"/variant/{ids[0]}", f"/variant/{ids[-1]}"]
        + [f"/region/{s}" for s in SPECS[:4]]
        + ["/region/8:490-600?minCadd=4.0&limit=3"]
    )
    monkeypatch.setenv(meshlib.VIRTUAL_DEVICES_ENV, "8")
    monkeypatch.setenv("AVDB_MESH_BULK_MIN", "0")
    bodies = {}
    for mesh_mode in ("0", "1"):
        monkeypatch.setenv("AVDB_SERVE_MESH", mesh_mode)
        servers = {
            "threaded": build_server(store_dir=served["dir"], port=0,
                                     device="cpu"),
            "ref_threaded": ref_http(store_dir=served["dir"], port=0),
        }
        for name in ("threaded", "ref_threaded"):
            threading.Thread(target=servers[name].serve_forever,
                             daemon=True).start()
        servers["aio"] = build_aio_server(store_dir=served["dir"], port=0,
                                          device="cpu")
        servers["ref_aio"] = ref_aio(store_dir=served["dir"], port=0)
        for name in ("aio", "ref_aio"):
            servers[name].start_background()
        try:
            for name in ("threaded", "aio"):
                assert (servers[name].ctx.engine.mesh is not None) \
                    == (mesh_mode == "1")
            for name, srv in servers.items():
                bodies[(name, mesh_mode)] = _bodies(
                    srv.server_address[1], ids, paths
                )
            if mesh_mode == "1":
                for name in ("threaded", "aio"):
                    mesh = servers[name].ctx.engine.mesh
                    assert mesh._bulk is not None and mesh._spans is not None
                # /stats carries the executor's block, the reference's
                blocks = [json.loads(_get(srv.server_address[1], "/stats")[1])["mesh"]
                          for srv in servers.values()]
                assert all(b == blocks[0] for b in blocks), blocks
                assert blocks[0]["devices"] == 8 and blocks[0]["resident_bytes"] > 0
        finally:
            for name in ("threaded", "ref_threaded"):
                servers[name].shutdown()
                servers[name].server_close()
                servers[name].ctx.batcher.close()
            for name in ("aio", "ref_aio"):
                servers[name].shutdown()
                servers[name].ctx.batcher.close()
    for name in ("threaded", "aio"):
        assert bodies[(name, "1")] == bodies[(name, "0")], name
        assert bodies[(name, "1")] == bodies[("ref_" + name, "1")], name
    assert bodies[("threaded", "1")] == bodies[("aio", "1")]


# ---------------------------------------------------------------------------
# sharded load == single-device load (the deep battery is
# test_torch_distributed_load)


def test_load_parity_via_global_mesh(tmp_path, monkeypatch):
    from annotatedvdb_tpu_torch.loaders.vcf_loader import VcfLoader
    from annotatedvdb_tpu_torch.store import AlgorithmLedger

    lines = ["##fileformat=VCFv4.2",
             "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO"]
    rng = np.random.default_rng(5)
    pos = 1000
    for i in range(300):
        pos += int(rng.integers(1, 40))
        ref = BASES[int(rng.integers(0, 4))]
        alt = BASES[(BASES.index(ref) + 1 + int(rng.integers(0, 3))) % 4]
        lines.append(f"7\t{pos}\trs{i}\t{ref}\t{alt}\t.\t.\tRS={i}")
    vcf = tmp_path / "chr7.vcf"
    vcf.write_text("\n".join(lines) + "\n")

    def load(tag, mesh):
        store = VariantStore(width=16)
        ledger = AlgorithmLedger(str(tmp_path / f"ledger_{tag}.jsonl"))
        loader = VcfLoader(store, ledger, mesh=mesh, batch_size=128,
                           log=lambda *a: None, device="cpu")
        try:
            loader.load_file(str(vcf), commit=True)
        finally:
            loader.close()
        return store

    s1 = load("single", mesh=None)
    monkeypatch.setenv(meshlib.VIRTUAL_DEVICES_ENV, "8")
    monkeypatch.setenv("AVDB_MESH_SHAPE", "4")
    mesh = meshlib.global_mesh(devices=meshlib.device_pool("cpu"))
    assert mesh is not None and mesh.size == 4
    s4 = load("mesh", mesh=mesh)
    sh1, sh4 = s1.shard(7), s4.shard(7)
    sh1.compact(), sh4.compact()
    assert sh1.n == sh4.n > 0
    for col in ("pos", "h", "ref_len", "alt_len", "bin_level", "leaf_bin"):
        np.testing.assert_array_equal(sh1.cols[col], sh4.cols[col],
                                      err_msg=col)
    np.testing.assert_array_equal(sh1.ref, sh4.ref)
    np.testing.assert_array_equal(sh1.alt, sh4.alt)


# ---------------------------------------------------------------------------
# residency: per-device budgets + placed uploads


def test_residency_places_uploads_per_device_budget(served):
    from annotatedvdb_tpu_torch.serve.residency import (
        ResidencyManager,
        device_cache_bytes,
    )

    store = VariantStore.load(served["dir"], readonly=True)
    placement = meshlib.chromosome_placement(8)
    seg_bytes = max(
        device_cache_bytes(seg, WIDTH)
        for shard in store.shards.values() for seg in shard.segments
    )
    manager = ResidencyManager(
        seg_bytes,  # per device: exactly ONE segment fits on each
        upload=True, async_upload=False, min_rows=0, plan_interval_s=0.0,
        device="cpu", placement=placement, devices=[CPU] * 8,
    )
    manager.govern(StaticSnapshots(store).current())
    for code, shard in store.shards.items():
        key = shard.segments[0].key
        manager.touch_window(shard, key[0], key[-1], 100)
    stats = manager.stats()
    assert stats["resident"] >= len(CHROMS) - 1
    per_dev = stats["per_device_bytes"]
    assert per_dev and all(v <= seg_bytes for v in per_dev.values())
    assert set(per_dev) <= {str(placement[c]) for c in CHROMS}
    resident = [seg for shard in store.shards.values()
                for seg in shard.segments if seg._device is not None]
    assert resident and all(seg._device[0] == CPU for seg in resident)


# ---------------------------------------------------------------------------
# metrics + stats surfaces


def test_mesh_metrics_registered(served):
    from annotatedvdb_tpu_torch.obs.metrics import MetricsRegistry

    registry = MetricsRegistry()
    breaker = DeviceBreaker(registry=registry)
    engine = QueryEngine(
        StaticSnapshots(served["store"]), region_cache_size=0,
        breaker=breaker, device="cpu",
        mesh=MeshExecutor(cpu_mesh(), registry=registry, breaker=breaker,
                          bulk_min=0),
    )
    ids = _ids(served["truth"])
    assert engine.lookup_many(ids) == served["ref_plain"].lookup_many(ids)
    engine.regions_serve(SPECS)
    text = registry.render_prometheus()
    assert 'avdb_mesh_devices 8' in text
    assert 'avdb_mesh_dispatch_total{kind="bulk"} 1' in text
    assert 'avdb_mesh_dispatch_total{kind="spans"} 1' in text
    assert "avdb_mesh_resident_bytes" in text
    assert "avdb_mesh_groups_placed" in text
    stats = engine.mesh.stats()
    assert stats == {**served["ref_meshed"].mesh.stats(),
                     "resident_bytes": stats["resident_bytes"],
                     "generation": 1, "bulk_min": 0, "budget_bytes": 0}
    assert stats["devices"] == 8 and stats["resident_bytes"] > 0
    assert sum(stats["groups_per_device"].values()) == NUM_CHROMOSOMES


# ---------------------------------------------------------------------------
# the mesh.dispatch fault point


def _fault_engines(served, clock, cooldown_s):
    """A breaker-guarded meshed engine of each package over the store."""
    from annotatedvdb_tpu.serve import StaticSnapshots as RefStatic
    from annotatedvdb_tpu.serve.resilience import DeviceBreaker as RefDB

    out = {}
    ref_store = RefStore.load(served["dir"], readonly=True)
    for pkg in ("ref", "port"):
        if pkg == "ref":
            breaker = RefDB(cooldown_s=cooldown_s, clock=lambda: clock["t"])
            engine = RefEngine(
                RefStatic(ref_store), region_cache_size=0, breaker=breaker,
                mesh=RefMeshExecutor(ref_meshlib.global_mesh(),
                                     breaker=breaker, bulk_min=0),
            )
        else:
            breaker = DeviceBreaker(cooldown_s=cooldown_s,
                                    clock=lambda: clock["t"])
            engine = QueryEngine(
                StaticSnapshots(served["store"]), region_cache_size=0,
                breaker=breaker, device="cpu",
                mesh=MeshExecutor(cpu_mesh(), breaker=breaker, bulk_min=0),
            )
        out[pkg] = (engine, breaker)
    return out


def test_mesh_dispatch_raise_bulk_falls_back_byte_identical(served):
    """``mesh.dispatch:prob:1.0:raise`` on bulk lookups, in each package:
    every faulted bulk answers the single-device bytes, the breaker's mesh
    group opens after its threshold (no sharded attempt fires while it is
    open), and after the cool-down the half-open trial re-closes it."""
    from annotatedvdb_tpu.utils import faults as ref_faults

    from annotatedvdb_tpu_torch.utils import faults

    ids = _ids(served["truth"])
    want = served["ref_plain"].lookup_many(ids)
    clock = {"t": 0.0}
    seen = {}
    for pkg, (engine, breaker) in _fault_engines(served, clock, 5.0).items():
        fmod = ref_faults if pkg == "ref" else faults
        clock["t"] = 0.0
        assert engine.lookup_many(ids) == want  # the mesh agrees unarmed
        fmod.reset("mesh.dispatch:prob:1.0:raise")
        try:
            for _ in range(breaker.failure_threshold):
                assert engine.lookup_many(ids) == want
            assert breaker.state(mesh_exec.MESH_GROUP) == "open"
            fired = fmod.fired().get("mesh.dispatch", 0)
            assert engine.lookup_many(ids) == want
            assert fmod.fired().get("mesh.dispatch", 0) == fired
        finally:
            fmod.reset("")
        clock["t"] = 10.0
        assert engine.lookup_many(ids) == want
        seen[pkg] = (fired, breaker.state(mesh_exec.MESH_GROUP),
                     engine.mesh._bulk is not None)
    assert seen["port"] == seen["ref"] == (3, "closed", True)


def test_mesh_dispatch_eio_panel_falls_back_byte_identical(served):
    """``mesh.dispatch:1:eio`` on a region panel: the panel answers the
    single-device bytes and the next, unarmed, runs through the mesh
    again, in each package; with no breaker the port fails the call (its
    no-fallback rule) where the reference answers from the host."""
    from annotatedvdb_tpu.utils import faults as ref_faults

    from annotatedvdb_tpu_torch.utils import faults

    want = served["ref_plain"].regions_serve(SPECS).assemble()
    clock = {"t": 0.0}
    for pkg, (engine, _breaker) in _fault_engines(served, clock, 0.0).items():
        fmod = ref_faults if pkg == "ref" else faults
        assert engine.regions_serve(SPECS).assemble() == want
        fmod.reset("mesh.dispatch:1:eio")
        try:
            assert engine.regions_serve(SPECS).assemble() == want
            assert fmod.fired().get("mesh.dispatch", 0) == 1
        finally:
            fmod.reset("")
        assert engine.regions_serve(SPECS).assemble() == want
        assert engine.mesh._spans is not None
    bare = QueryEngine(
        StaticSnapshots(served["store"]), region_cache_size=0, device="cpu",
        mesh=MeshExecutor(cpu_mesh(), bulk_min=0),
    )
    faults.reset("mesh.dispatch:1:eio")
    try:
        with pytest.raises(OSError):
            bare.regions_serve(SPECS)
    finally:
        faults.reset("")
