"""The PyTorch port stands alone: it imports without JAX, never imports the
JAX package, and runs on the card unless the caller asks for the CPU."""

import ast
import os
import subprocess
import sys

import pytest
import torch

from annotatedvdb_tpu_torch.runtime import resolve_device

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "annotatedvdb_tpu_torch")


def _port_sources():
    for dirpath, _dirs, files in os.walk(PKG):
        for name in files:
            if name.endswith(".py"):
                yield os.path.join(dirpath, name)
    yield os.path.join(ROOT, "chip_smoke.py")


def test_imports_with_jax_blocked():
    code = (
        "import sys, importlib, pkgutil\n"
        "sys.modules['jax'] = None\n"
        "import annotatedvdb_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "assert not any(m == 'annotatedvdb_tpu' or m.startswith('annotatedvdb_tpu.')\n"
        "               for m in sys.modules), 'the JAX package was imported'\n"
        "print('\\n'.join(names))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    names = set(proc.stdout.split())
    assert len(names) >= 25
    assert {f"annotatedvdb_tpu_torch.{m}" for m in VEP_SLICE} <= names
    assert {f"annotatedvdb_tpu_torch.{m}" for m in DEFAULT_VCF_SLICE} <= names
    assert {f"annotatedvdb_tpu_torch.{m}" for m in UPDATE_SLICE} <= names
    assert {f"annotatedvdb_tpu_torch.{m}" for m in CADD_SLICE} <= names
    assert {f"annotatedvdb_tpu_torch.{m}" for m in REFGENOME_SLICE} <= names
    assert {f"annotatedvdb_tpu_torch.{m}" for m in SERVE_SLICE} <= names
    assert {f"annotatedvdb_tpu_torch.{m}" for m in EXPORT_SLICE} <= names
    assert {f"annotatedvdb_tpu_torch.{m}" for m in DOCTOR_AIO_SLICE} <= names


#: the VEP update slice's modules
VEP_SLICE = ("conseq.groups", "conseq.ranker", "conseq.table", "io.vep",
             "io.prefetch", "utils.pipeline", "loaders.vep_loader",
             "cli.load_vep")

#: the modules of the VCF load's default configuration (native tokenizer,
#: overlapped executor, async store writer)
DEFAULT_VCF_SLICE = ("native", "native.vcf", "io.vcf", "io.prefetch",
                     "utils.pipeline", "utils.profiling", "store.variant_store",
                     "loaders.vcf_loader", "cli.load_vcf")


#: the VCF-driven update legs' modules (update-qc, load-snpeff-lof,
#: update-annotation)
UPDATE_SLICE = ("loaders.lookup", "loaders.update_loader", "loaders.qc_loader",
                "loaders.lof_loader", "loaders.txt_loader", "cli.update_common",
                "cli.update_qc", "cli.load_snpeff_lof",
                "cli.update_variant_annotation")


#: the CADD join (load-cadd) and the host-only store commands (undo,
#: export-vcf, split-vcf)
CADD_SLICE = ("ops.cadd_join", "io.bgzf", "io.cadd", "io.egress", "native.cadd",
              "loaders.cadd_loader", "cli.load_cadd", "cli.undo_load",
              "cli.export_variant2vcf", "cli.split_vcf_by_chr")


#: reference-genome validation (index-genome, load-vcf --refGenome), the
#: Postgres egress (install-schema) and bin-references
REFGENOME_SLICE = ("genome.refgenome", "genome.assemblies", "cli.index_genome",
                   "oracle.annotator", "oracle.binindex", "io.egress",
                   "utils.strings", "utils.retry", "sql.schema", "io.pg_egress",
                   "cli.install_schema", "cli.generate_bin_index_references")

#: the query server (serve --frontend threaded) and its kernels
SERVE_SLICE = ("ops.intervals", "ops.stats", "export.tokens", "utils.locks",
               "obs.metrics", "obs.reqtrace", "serve.snapshot",
               "serve.resilience", "serve.residency", "serve.batcher",
               "serve.engine", "serve.http", "cli.serve")

#: the corpus export (export, GET /export/stream) and its kernel
EXPORT_SLICE = ("ops.export_pack", "export.writer", "export.core",
                "export.stream", "cli.export_corpus")

#: doctor (fsck, status, profile, replay-rejects), host only, and the aio
#: front end of serve
DOCTOR_AIO_SLICE = ("store.wal", "store.memtable", "store.compact",
                    "store.replication", "parallel.placement", "store.fsck",
                    "store.maintenance", "cli.doctor", "serve.aio")

#: every command of the umbrella CLI
COMMANDS = ("load-vcf", "load-vep", "update-qc", "load-snpeff-lof",
            "update-annotation", "load-cadd", "undo", "export-vcf", "split-vcf",
            "index-genome", "install-schema", "bin-references", "serve", "export",
            "doctor")


@pytest.mark.parametrize("module", REFGENOME_SLICE)
def test_refgenome_slice_imports_without_jax(module):
    """Each module of the slice imports with JAX blocked and pulls in
    nothing of the JAX package."""
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\n"
        f"importlib.import_module('annotatedvdb_tpu_torch.{module}')\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m == 'annotatedvdb_tpu' or m.startswith('annotatedvdb_tpu.'))\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("module", SERVE_SLICE)
def test_serve_slice_imports_without_jax(module):
    """Each module of the query server imports with JAX blocked and pulls
    in nothing of the JAX package."""
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\n"
        f"importlib.import_module('annotatedvdb_tpu_torch.{module}')\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m == 'annotatedvdb_tpu' or m.startswith('annotatedvdb_tpu.'))\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("module", EXPORT_SLICE)
def test_export_slice_imports_without_jax(module):
    """Each module of the corpus export imports with JAX blocked and pulls
    in nothing of the JAX package."""
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\n"
        f"importlib.import_module('annotatedvdb_tpu_torch.{module}')\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m == 'annotatedvdb_tpu' or m.startswith('annotatedvdb_tpu.'))\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("module", DOCTOR_AIO_SLICE)
def test_doctor_and_aio_slice_imports_without_jax(module):
    """Each module of doctor and the aio front end imports with JAX blocked
    and pulls in nothing of the JAX package."""
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\n"
        f"importlib.import_module('annotatedvdb_tpu_torch.{module}')\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m == 'annotatedvdb_tpu' or m.startswith('annotatedvdb_tpu.'))\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_source_list_covers_the_serve_slice():
    """The per-file import check below walks every module of the slice."""
    sources = {os.path.relpath(p, PKG) for p in _port_sources()}
    for m in SERVE_SLICE:
        assert m.replace(".", os.sep) + ".py" in sources, m


def test_help_lists_the_twelve_commands():
    proc = subprocess.run([sys.executable, "-m", "annotatedvdb_tpu_torch", "--help"],
                          cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    listed = [ln.split()[0] for ln in proc.stdout.splitlines()[1:] if ln.strip()]
    assert listed == list(COMMANDS)


def test_source_list_covers_the_cadd_slice():
    """The per-file import check below walks every module of the slice."""
    sources = {os.path.relpath(p, PKG) for p in _port_sources()}
    for m in CADD_SLICE:
        assert m.replace(".", os.sep) + ".py" in sources, m


def test_source_list_covers_the_update_slice():
    """The per-file import check below walks every module of the slice."""
    sources = {os.path.relpath(p, PKG) for p in _port_sources()}
    for m in UPDATE_SLICE:
        assert m.replace(".", os.sep) + ".py" in sources, m


def test_source_list_covers_the_vep_slice():
    """The per-file import check below walks every module of the slice."""
    sources = {os.path.relpath(p, PKG) for p in _port_sources()}
    for m in VEP_SLICE:
        assert m.replace(".", os.sep) + ".py" in sources, m


def test_source_list_covers_the_default_vcf_slice():
    """The per-file import check below walks every module of the slice."""
    sources = {os.path.relpath(p, PKG) for p in _port_sources()}
    for m in DEFAULT_VCF_SLICE:
        path = m.replace(".", os.sep)
        assert path + ".py" in sources or os.path.join(path, "__init__.py") in sources, m


@pytest.mark.parametrize("path", sorted(_port_sources()),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_import_of_jax_package(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("annotatedvdb_tpu", "jax"), (
                f"{os.path.relpath(path, ROOT)}:{node.lineno} imports {name}"
            )


def test_resolve_device_needs_cuda_unless_cpu():
    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device() == torch.device("cuda", 0)
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device()
        with pytest.raises(RuntimeError):
            resolve_device("cuda")
    with pytest.raises(ValueError):
        resolve_device("tpu")


def test_cuda_wrapper_refuses_without_fallback():
    """A non-CPU tensor never takes the plain version: the wrapper either
    launches or raises (here: the meta device, which no kernel serves)."""
    from annotatedvdb_tpu_torch.ops.annotate_cuda import LAUNCHES, annotate_bin

    before = dict(LAUNCHES)
    t = torch.empty((4,), dtype=torch.int32, device="meta")
    a = torch.empty((4, 8), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        annotate_bin(t, a, a, t, t)
    assert LAUNCHES == before


@pytest.mark.parametrize("cls", ["QcPvcfLoader", "SnpEffLofLoader", "TextLoader"])
def test_update_loaders_default_to_cuda(cls, tmp_path):
    """Without a card an update loader refuses to start unless the caller
    asks for the CPU; it never carries on on the host."""
    import annotatedvdb_tpu_torch.loaders as loaders
    from annotatedvdb_tpu_torch.store import AlgorithmLedger, VariantStore

    args = (VariantStore(width=49), AlgorithmLedger(str(tmp_path / "l.jsonl")))
    extra = ("r4",) if cls == "QcPvcfLoader" else ()
    loader = getattr(loaders, cls)(*args, *extra, device="cpu")
    assert loader.device.type == loader.insert_loader.device.type == "cpu"
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        getattr(loaders, cls)(*args, *extra)
