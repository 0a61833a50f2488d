"""The VCF and VEP loads through the packed transport and the loader
options around it: the PyTorch port against the JAX package, on the CPU.

Stores are compared byte for byte (segments, sidecars, the manifest less
its ``store_uid``) with ledger records, and counters exactly:

- ``AVDB_PACK_TRANSPORT=always`` for the port (the plain inflate and pack
  on the CPU) against the reference forced the same way (its
  ``_TRANSPORT_WANTED`` latch, as ``tests/test_vcf_load.py`` forces it),
  on both engines, overlapped and serial, over a VCF with over-width
  alleles and a symbolic and a breakend allele in one chunk (that chunk
  uploads raw);
- the default (auto, off on the CPU) with the native engine, where the
  width-bucketed upload slices chunks whose longest allele is at most 8,
  16, 32 and past the store's width;
- ``store_display_attributes=True`` in both packages, with and without
  the transport;
- the VEP update through the packed identity rows (a store 49 wide) and a
  store 300 wide, which copies the three columns;
- the CLI's run records with ``warmup`` in the lifecycle.
"""

import os

import numpy as np
import pytest

from annotatedvdb_tpu.loaders import TpuVcfLoader
from annotatedvdb_tpu.ops import pack as ref_pack
from annotatedvdb_tpu.store import AlgorithmLedger, VariantStore

from annotatedvdb_tpu_torch.loaders import VcfLoader
from annotatedvdb_tpu_torch.ops import pack
from annotatedvdb_tpu_torch.store import AlgorithmLedger as TorchLedger
from annotatedvdb_tpu_torch.store import VariantStore as TorchStore
from chip_smoke import write_bucket_vcf
from test_torch_load_vcf import COUNTER_KEYS, _assert_same_store, _write_vcf

BATCH = 256


def _with_symbolic(path, n_lines=1600, seed=61):
    """``_write_vcf``'s shapes (over-width and digest-PK alleles, indels,
    duplicates, '.' alts, a malformed line), plus a symbolic ``<DEL>`` and
    a breakend allele on two neighbouring lines mid-file."""
    _write_vcf(path, n_lines=n_lines, seed=seed)
    with open(path) as f:
        lines = f.readlines()
    mid = len(lines) // 2
    pos = int(lines[mid].split("\t")[1])
    lines[mid + 1:mid + 1] = [f"1\t{pos}\t.\tA\t<DEL>\t.\t.\tRS=1\n",
                              f"1\t{pos}\t.\tA\tA[2:3000[\t.\t.\t.\n"]
    with open(path, "w") as f:
        f.writelines(lines)


def _ref_load(vcf, store_dir, mp, engine, pipeline, wanted=False, width=49, **kw):
    mp.setenv("AVDB_INGEST_ENGINE", engine)
    mp.setenv("AVDB_PIPELINE", pipeline)
    mp.setattr(ref_pack, "_TRANSPORT_WANTED", wanted)
    os.makedirs(store_dir, exist_ok=True)
    store = VariantStore(width=width)
    ledger = AlgorithmLedger(os.path.join(store_dir, "ledger.jsonl"))
    loader = TpuVcfLoader(store, ledger, batch_size=BATCH, log=lambda *a: None, **kw)
    try:
        counters = loader.load_file(vcf, commit=True,
                                    persist=lambda: store.save(store_dir))
    finally:
        loader.close()
    store.save(store_dir)
    return counters


def _port_load(vcf, store_dir, mp, engine, pipeline, mode=None, width=49, **kw):
    mp.setenv("AVDB_INGEST_ENGINE", engine)
    mp.setenv("AVDB_PIPELINE", pipeline)
    if mode is None:
        mp.delenv("AVDB_PACK_TRANSPORT", raising=False)
    else:
        mp.setenv("AVDB_PACK_TRANSPORT", mode)
    os.makedirs(store_dir, exist_ok=True)
    store = TorchStore(width=width)
    ledger = TorchLedger(os.path.join(store_dir, "ledger.jsonl"))
    loader = VcfLoader(store, ledger, batch_size=BATCH, log=lambda *a: None,
                       device="cpu", **kw)
    try:
        loader.warmup()
        counters = loader.load_file(vcf, commit=True,
                                    persist=lambda: store.save(store_dir))
    finally:
        loader.close()
    store.save(store_dir)
    return counters, loader


def _counters(c):
    return {k: c.get(k) for k in COUNTER_KEYS}


@pytest.mark.parametrize("pipeline", ["overlapped", "serial"])
@pytest.mark.parametrize("engine", ["native", "python"])
def test_packed_transport_matches_reference(tmp_path, monkeypatch, engine, pipeline):
    """Every chunk packs its outputs; every chunk but the symbolic one goes
    up nibble-packed (the tokenizer's own pack on the native engine)."""
    vcf = str(tmp_path / "t.vcf")
    _with_symbolic(vcf)
    ref_dir, port_dir = str(tmp_path / "ref"), str(tmp_path / "port")
    c_ref = _ref_load(vcf, ref_dir, monkeypatch, engine, pipeline, wanted=True)
    calls = pack.CALLS["cpu"]
    c_port, loader = _port_load(vcf, port_dir, monkeypatch, engine, pipeline,
                                mode="always")
    assert _counters(c_port) == _counters(c_ref)
    _assert_same_store(ref_dir, port_dir)
    t = loader.transport
    chunks = t["packed"]
    assert chunks > 4 and t["fields"] == 0
    assert t["raw"] == 1 and t["nibble"] == chunks - 1, t
    assert pack.CALLS["cpu"] - calls >= 2 * chunks - 1  # plain inflates and packs
    assert c_ref["variant"] > 1000 and c_ref["duplicates"] > 0


def test_bucketed_upload_matches_reference(tmp_path, monkeypatch):
    """The default on the CPU (no transport): the native engine's chunks
    upload at widths 8, 16, 32 and 49, and the store is the reference's."""
    vcf = str(tmp_path / "b.vcf")
    write_bucket_vcf(vcf)
    ref_dir, port_dir = str(tmp_path / "ref"), str(tmp_path / "port")
    c_ref = _ref_load(vcf, ref_dir, monkeypatch, "native", "overlapped")
    c_port, loader = _port_load(vcf, port_dir, monkeypatch, "native", "overlapped")
    assert _counters(c_port) == _counters(c_ref)
    _assert_same_store(ref_dir, port_dir)
    assert set(loader.transport["widths"]) == {8, 16, 32, 49}, loader.transport
    assert loader.transport["nibble"] == loader.transport["packed"] == 0
    # the Python engine carries no tokenizer hash: full width, same bytes
    py_dir = str(tmp_path / "py")
    ref_py = str(tmp_path / "ref_py")
    _ref_load(vcf, ref_py, monkeypatch, "python", "serial")
    _c, loader = _port_load(vcf, py_dir, monkeypatch, "python", "serial")
    assert set(loader.transport["widths"]) == {49}
    _assert_same_store(ref_py, py_dir)


@pytest.mark.parametrize("mode", [None, "always"], ids=["default", "always"])
def test_display_attributes_match_reference(tmp_path, monkeypatch, mode):
    """``store_display_attributes=True``: every annotate field fetched, the
    ``display_attributes`` sidecar stored as the reference stores it (the
    transport, where wanted, still uploads nibble-packed but never packs
    the outputs)."""
    vcf = str(tmp_path / "d.vcf")
    _with_symbolic(vcf, n_lines=700, seed=63)
    ref_dir, port_dir = str(tmp_path / "ref"), str(tmp_path / "port")
    c_ref = _ref_load(vcf, ref_dir, monkeypatch, "native", "overlapped",
                      wanted=mode == "always", store_display_attributes=True)
    c_port, loader = _port_load(vcf, port_dir, monkeypatch, "native", "overlapped",
                                mode=mode, store_display_attributes=True)
    assert _counters(c_port) == _counters(c_ref)
    _assert_same_store(ref_dir, port_dir)
    assert loader.transport["packed"] == 0 and loader.transport["fields"] > 0
    assert (loader.transport["nibble"] > 0) == (mode == "always")
    shard = TorchStore.load(port_dir).shard(1)
    assert all(shard.get_ann("display_attributes", i) is not None
               for i in range(0, shard.n, 97))


def test_mesh_display_attributes_match_single_device(tmp_path, monkeypatch):
    """Display attributes across four virtual CPU shards: every annotate
    field scattered back from the mesh, the single-device store's bytes."""
    from annotatedvdb_tpu_torch.parallel.mesh import Mesh

    vcf = str(tmp_path / "m.vcf")
    _write_vcf(vcf, n_lines=500, seed=64)
    one, mesh = str(tmp_path / "one"), str(tmp_path / "mesh")
    _port_load(vcf, one, monkeypatch, "python", "serial", store_display_attributes=True)
    _c, loader = _port_load(vcf, mesh, monkeypatch, "python", "serial",
                            store_display_attributes=True,
                            mesh=Mesh(["cpu"] * 4))
    assert loader.mesh is not None and loader.transport["fields"] > 0
    _assert_same_store(one, mesh)


# ------------------------------------------------------------- VEP update


def _vep_pair(tmp_path, monkeypatch, width):
    from test_torch_vep import _ref_vep, _torch_vep, _write_inputs

    vcf, vep = _write_inputs(tmp_path)
    ref_dir, port_dir = str(tmp_path / "ref"), str(tmp_path / "port")
    _ref_load(vcf, ref_dir, monkeypatch, "python", "serial", width=width)
    _port_load(vcf, port_dir, monkeypatch, "python", "serial", width=width)
    c_ref = _ref_vep(vep, ref_dir, monkeypatch, "python")[0]
    pack.ensure_transport("cpu")  # the probe's own plain packs, once
    calls = pack.CALLS["cpu"]
    c_port, loader, _store = _torch_vep(vep, port_dir, monkeypatch, "python")
    return c_ref, c_port, loader, pack.CALLS["cpu"] - calls, (ref_dir, port_dir)


@pytest.mark.parametrize("width", [49, 300])
def test_vep_identity_rows_match_reference(tmp_path, monkeypatch, width):
    """The Python VEP transform's identity batches: packed into ``[n, 6]``
    rows (one plain pack a batch on the CPU) by the identity step (its
    plain composition, once a batch) at width 49, three columns of the
    annotate step at width 300 (the prefix would not fit its byte); the
    stores are the reference's either way."""
    from annotatedvdb_tpu_torch.ops import annotate_cuda
    from test_torch_vep import _assert_same_store as same_vep_store

    steps = []
    real = annotate_cuda.annotate_bin_identity_reference

    def step(*args):
        steps.append(args[0].shape[1])
        return real(*args)

    monkeypatch.setattr(annotate_cuda, "annotate_bin_identity_reference", step)
    c_ref, c_port, loader, packs, dirs = _vep_pair(tmp_path, monkeypatch, width)
    assert {k: c_port.get(k) for k in c_ref} == c_ref
    same_vep_store(*dirs)
    assert loader.identity_batches > 0
    assert packs == (loader.identity_batches if width <= 255 else 0)
    assert steps == ([width] * loader.identity_batches if width <= 255 else [])


def test_vep_warmup_checks_the_identity_batch(tmp_path):
    """``VepLoader.warmup`` on the CPU runs the 4-row probe only."""
    from annotatedvdb_tpu_torch.conseq import ConsequenceRanker
    from annotatedvdb_tpu_torch.loaders import VepLoader

    store = TorchStore(width=49)
    loader = VepLoader(store, TorchLedger(str(tmp_path / "l.jsonl")),
                       ConsequenceRanker(), log=lambda *a: None, device="cpu")
    loader.warmup()
    assert loader.identity_batches == 0
    assert loader.identity_timer.seconds == {} and loader.identity_timer.items == {}


def test_cli_run_record_with_warmup(tmp_path, monkeypatch):
    """``load-vcf`` calls ``warmup`` inside its lifecycle: a warmup that
    raises is witnessed by an aborted run record, as the reference's."""
    from annotatedvdb_tpu_torch.cli.load_vcf import main as torch_main

    vcf = str(tmp_path / "w.vcf")
    _write_vcf(vcf, n_lines=50, seed=65)
    store_dir = str(tmp_path / "vdb")

    def broken(self):
        raise RuntimeError("warmup probe failed")

    monkeypatch.setattr(VcfLoader, "warmup", broken)
    with pytest.raises(RuntimeError, match="warmup probe failed"):
        torch_main(["--fileName", vcf, "--storeDir", store_dir, "--commit",
                    "--platform", "cpu", "--logAfter", "0"])
    import json

    with open(os.path.join(store_dir, "ledger.jsonl")) as f:
        runs = [json.loads(ln) for ln in f if '"type": "run"' in ln]
    assert runs and runs[-1]["status"] == "aborted"
    assert "warmup probe failed" in json.dumps(runs[-1])
