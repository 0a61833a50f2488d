"""The load path's fault points, crossed between the two packages: the
reference's crash matrix (``tests/test_fault_matrix.py``: ``MATRIX`` and
the SIGKILL matrix) run through the port and through the reference under
the same ``AVDB_FAULT`` spec, on the same VCF.

For every spec the crash state on disk (store files with the manifest's
``store_uid`` masked, ledger records with ``ts`` masked, the torn ledger
tail, quarantine), the exit (the raised fault, or SIGKILL) and, after the
resume, the final store bytes must equal the reference's; the resumed
content must also equal the uninterrupted load's, as the reference's own
test requires.  In-process cases arm ``raise``/``eio`` with
``faults.reset``; ``kill``/``torn_write`` run the two CLIs as
subprocesses in their default configuration (``rc == -9``, never a clean
exit).
"""

import json
import os
import signal
import subprocess
import sys

import pytest

from annotatedvdb_tpu.config import StoreConfig
from annotatedvdb_tpu.loaders import TpuVcfLoader
from annotatedvdb_tpu.store import VariantStore as RefStore
from annotatedvdb_tpu.store.fsck import fsck as ref_fsck
from annotatedvdb_tpu.utils import faults as ref_faults

from annotatedvdb_tpu_torch.loaders import VcfLoader
from annotatedvdb_tpu_torch.store import AlgorithmLedger, VariantStore
from annotatedvdb_tpu_torch.store.fsck import fsck
from annotatedvdb_tpu_torch.utils import faults
from test_torch_faults import dir_state

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_ROWS = 2600
BATCH = 512  # ~6 chunks => ~6 checkpoints per committed load


@pytest.fixture(autouse=True)
def _disarm():
    yield
    faults.reset("")
    ref_faults.reset("")


def write_vcf(path, n=N_ROWS):
    """The reference matrix's VCF (``test_fault_matrix._write_vcf``)."""
    with open(path, "w") as f:
        f.write("##fileformat=VCFv4.2\n"
                "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n")
        for i in range(n):
            f.write(f"8\t{1000 + 3 * i}\trs{i}\tA\tG\t.\t.\tRS={i}\n")


def repair(pkg, store_dir):
    """One ``fsck --repair`` of ``pkg`` on ``store_dir``; the report with
    the directory's path masked."""
    report = (ref_fsck if pkg == "ref" else fsck)(
        store_dir, repair=True, log=lambda m: None)
    return json.loads(json.dumps(report).replace(store_dir, "<store>"))


def content(store_dir):
    """The reference matrix's content signature: every column but the
    provenance ones, with the alleles and the row count."""
    store = RefStore.load(store_dir)
    shard = store.shard(8)
    shard.compact()
    cols = {c: shard.cols[c].tobytes()
            for c in ("pos", "h", "ref_snp", "ref_len", "alt_len",
                      "bin_level", "leaf_bin")}
    return cols, shard.ref.tobytes(), shard.alt.tobytes(), store.n


def run_load(pkg, store_dir, vcf, fault=""):
    """One committing CLI-shaped load in this process (the reference's
    ``test_fault_matrix._run_load``); returns the raised exception's type
    name, or None.  An aborted loader's writer pool is stopped as a real
    crash would stop it."""
    mod = ref_faults if pkg == "ref" else faults
    mod.reset(fault)
    if pkg == "ref":
        store, ledger = StoreConfig(store_dir).open()
        loader = TpuVcfLoader(store, ledger, batch_size=BATCH,
                              log=lambda *a: None)
    else:
        os.makedirs(store_dir, exist_ok=True)
        store = (VariantStore.load(store_dir)
                 if os.path.exists(os.path.join(store_dir, "manifest.json"))
                 else VariantStore(width=49))
        ledger = AlgorithmLedger(os.path.join(store_dir, "ledger.jsonl"))
        loader = VcfLoader(store, ledger, batch_size=BATCH,
                           log=lambda *a: None, device="cpu")
    try:
        loader.load_file(vcf, commit=True, resume=True,
                         persist=lambda: store.save(store_dir))
        loader.close()
        store.save(store_dir)
        return None
    except BaseException as exc:
        pool = getattr(loader, "_writer_pool", None)
        if pool is not None:
            pool.shutdown(wait=True, cancel_futures=True)
        return type(exc).__name__ + (
            f":{exc.errno}" if isinstance(exc, OSError) else "")
    finally:
        mod.reset("")


@pytest.fixture(scope="module")
def uninterrupted(tmp_path_factory):
    """The VCF and the content of one uninterrupted load per package (the
    two must be equal, as every recovery must reproduce it)."""
    d = tmp_path_factory.mktemp("uninterrupted")
    vcf = str(d / "d.vcf")
    write_vcf(vcf)
    for pkg in ("ref", "port"):
        assert run_load(pkg, str(d / pkg), vcf) is None
    want = content(str(d / "ref"))
    assert content(str(d / "port")) == want
    assert want[3] == N_ROWS
    return vcf, want


#: the reference's in-process ``MATRIX`` (``tests/test_fault_matrix.py``)
MATRIX = [
    ("store.save.pre_manifest:2:raise", False),
    ("store.save.pre_manifest:2:raise", True),   # + fsck --repair pass
    ("store.save.mid_segment:3:raise", False),
    ("ledger.append:4:raise", False),
    ("ingest.chunk:4:raise", False),
    ("ingest.prefetch:3:raise", False),
    ("ingest.prefetch:2:eio", False),
]


@pytest.mark.parametrize("fault,run_fsck", MATRIX)
def test_crash_matrix_matches_the_reference(tmp_path, uninterrupted, fault,
                                            run_fsck, monkeypatch):
    """In-process ``raise``/``eio``.  Commits run on the process thread
    (``AVDB_ASYNC_STORE=0``, both packages): with the writer thread, how
    many queued saves land after the aborting one is timing, in either
    package, and the crash states could not be compared byte for byte."""
    monkeypatch.setenv("AVDB_ASYNC_STORE", "0")
    vcf, want = uninterrupted
    dirs = {pkg: str(tmp_path / pkg) for pkg in ("ref", "port")}
    raised = {pkg: run_load(pkg, dirs[pkg], vcf, fault) for pkg in dirs}
    assert raised["ref"] is not None, f"{fault}: never fired"
    assert raised["port"] == raised["ref"]
    assert dir_state(dirs["port"]) == dir_state(dirs["ref"])
    if run_fsck:
        assert repair("port", dirs["port"]) == repair("ref", dirs["ref"])
        assert dir_state(dirs["port"]) == dir_state(dirs["ref"])
    for pkg in dirs:
        assert run_load(pkg, dirs[pkg], vcf) is None
    assert dir_state(dirs["port"]) == dir_state(dirs["ref"])
    assert content(dirs["port"]) == want
    report = fsck(dirs["port"], deep=True, repair=True, log=lambda m: None)
    assert report["exit_code"] in (0, 1), report


def _cli(pkg, vcf, store):
    if pkg == "ref":
        head = [sys.executable, "-m", "annotatedvdb_tpu.cli.load_vcf",
                "--maxWorkers", "off"]
    else:
        head = [sys.executable, "-m", "annotatedvdb_tpu_torch", "load-vcf",
                "--platform", "cpu"]
    return head + ["--fileName", vcf, "--storeDir", store,
                   "--commitAfter", str(BATCH), "--commit"]


@pytest.mark.parametrize("fault", [
    "store.save.pre_manifest:2:kill",
    "ledger.append:4:torn_write",
    "ingest.prefetch:3:kill",
    # the run record's own append (invocation, six checkpoints, finish,
    # then the run record): the load is whole, its record is lost
    "ledger.append:9:kill",
])
def test_sigkill_matrix_matches_the_reference(tmp_path, uninterrupted, fault):
    """True process death through both CLIs: each dies by SIGKILL, leaves
    the same crash state, repairs to the same report and resumes to the
    same bytes and to the uninterrupted content."""
    vcf_src, want = uninterrupted
    env = dict(os.environ, JAX_PLATFORMS="cpu", AVDB_FAULT=fault)
    dirs, vcfs = {}, {}
    for pkg in ("ref", "port"):
        os.makedirs(tmp_path / pkg)
        vcfs[pkg] = str(tmp_path / pkg / "d.vcf")
        with open(vcf_src, "rb") as a, open(vcfs[pkg], "wb") as b:
            b.write(a.read())
        dirs[pkg] = str(tmp_path / pkg / "store")
    procs = {pkg: subprocess.Popen(_cli(pkg, vcfs[pkg], dirs[pkg]), env=env,
                                   cwd=ROOT, stdout=subprocess.DEVNULL,
                                   stderr=subprocess.PIPE, text=True)
             for pkg in dirs}
    for pkg, p in procs.items():
        _out, err = p.communicate(timeout=240)
        assert p.returncode == -signal.SIGKILL, (pkg, p.returncode,
                                                 err[-2000:])
    def state(pkg):
        return dir_state(dirs[pkg], str(tmp_path / pkg))

    crashed = state("ref")
    assert state("port") == crashed
    if crashed is not None and "manifest.json" in crashed:
        assert repair("port", dirs["port"]) == repair("ref", dirs["ref"])
        assert state("port") == state("ref")
    else:
        # the prefetch thread runs ahead of the consumer: its kill may
        # land before the first checkpoint, leaving no manifest at all
        assert fault.startswith("ingest.prefetch"), fault
    env.pop("AVDB_FAULT")
    procs = {pkg: subprocess.Popen(_cli(pkg, vcfs[pkg], dirs[pkg]), env=env,
                                   cwd=ROOT, stdout=subprocess.DEVNULL,
                                   stderr=subprocess.PIPE, text=True)
             for pkg in dirs}
    for pkg, p in procs.items():
        _out, err = p.communicate(timeout=240)
        assert p.returncode == 0, (pkg, err[-2000:])
    assert state("port") == state("ref")
    assert content(dirs["port"]) == want
