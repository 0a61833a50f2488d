"""The port's fault-injection harness (``annotatedvdb_tpu_torch/utils/
faults.py``) against the reference's: the same registry, the same grammar
with the same refusals word for word, the same seeded ``prob`` coin (two
identically armed runs, one in each package, fire on the same passes),
and the cases of ``tests/test_faults.py`` run against the port — bounded
retry, pipeline stage errors, the ledger and egress fault points.
"""

import errno
import json
import os
import re
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from annotatedvdb_tpu.utils import faults as ref_faults

from annotatedvdb_tpu_torch.store import AlgorithmLedger, VariantStore
from annotatedvdb_tpu_torch.utils import faults
from annotatedvdb_tpu_torch.utils import retry as retry_mod
from annotatedvdb_tpu_torch.utils.faults import InjectedFault
from annotatedvdb_tpu_torch.utils.pipeline import BoundedStage
from annotatedvdb_tpu_torch.utils.retry import with_backoff

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: resume-bearing ledger record types (the run records of the reference's
#: observability session are not ported)
LEDGER_TYPES = ("invocation", "checkpoint", "finish", "compact", "flush",
                "export")


@pytest.fixture(autouse=True)
def _disarm():
    yield
    faults.reset("")
    ref_faults.reset("")


# ---------------------------------------------------------------------------
# helpers shared by the tests/test_torch_faults_*.py files


class Pkg:
    """One package's modules by their shared relative path, so a fault
    scenario is written once and run against both: ``P.mod("store.wal")``
    is ``annotatedvdb_tpu.store.wal`` or ``annotatedvdb_tpu_torch.store.
    wal``; ``P.kw`` is the port's ``device="cpu"`` (the reference runs on
    CPU-JAX without the argument)."""

    def __init__(self, name: str):
        import importlib

        self.name = name
        self.root = "annotatedvdb_tpu" if name == "ref" else \
            "annotatedvdb_tpu_torch"
        self._imp = importlib.import_module
        self.faults = self.mod("utils.faults")
        self.kw = {} if name == "ref" else {"device": "cpu"}

    def mod(self, path: str):
        return self._imp(f"{self.root}.{path}")

    def __repr__(self):
        return self.name


REF, PORT = Pkg("ref"), Pkg("port")


def armed(pkg, spec, fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` with ``spec`` armed in ``pkg``: its result,
    or the name (and errno) of what it raised."""
    pkg.faults.reset(spec)
    try:
        return fn(*args, **kwargs)
    except Exception as exc:
        return "raised " + type(exc).__name__ + (
            f":{exc.errno}" if isinstance(exc, OSError) else "")
    finally:
        pkg.faults.reset("")


def ledger_state(path, mask=None):
    """(complete records of the resume-bearing types with ``ts`` masked,
    the torn tail's record type or None): a ledger's crash state.  A torn
    tail's byte length follows the float ``ts`` text, so the tail is
    compared by what it held.  ``mask``: a directory whose path is
    replaced in the records (each package works in its own copy)."""
    if not os.path.exists(path):
        return None
    with open(path, "rb") as f:
        data = f.read()
    lines = data.split(b"\n")
    tail = lines.pop()  # b"" when the file ends in a newline
    recs = []
    for line in lines:
        if mask is not None:
            line = line.replace(mask.encode(), b"<dir>")
        rec = json.loads(line)
        if rec.get("type") in LEDGER_TYPES:
            for k in ("ts", "seconds"):
                rec.pop(k, None)
            recs.append(rec)
    torn = None
    if tail:
        m = re.search(rb'"type": "(\w+)"', tail)
        torn = m.group(1).decode() if m else tail[:40]
    return recs, torn


def dir_state(d, mask=None):
    """Every file under ``d`` by normalized name (a pid in a temp name is
    masked): its bytes, a parsed manifest (or manifest temp) with its
    ``store_uid`` masked, a follower's parsed cursor with the leader
    manifest's stat fingerprint masked, and a ledger's
    :func:`ledger_state`.  None when ``d`` does not exist."""
    if not os.path.isdir(d):
        return None
    out = {}
    for root, _dirs, files in os.walk(d):
        for name in files:
            fp = os.path.join(root, name)
            rel = re.sub(r"tmp\d+", "tmp<pid>", os.path.relpath(fp, d))
            if name == "ledger.jsonl":
                out[rel] = ledger_state(fp, mask)
                continue
            with open(fp, "rb") as f:
                data = f.read()
            if "manifest.json" in name or name == "repl.cursor.json":
                try:
                    data = json.loads(data)
                except ValueError:
                    pass  # a torn temp: its bytes
                else:
                    # the store's random uid; the cursor's leader-manifest
                    # (mtime, size, inode) fingerprint
                    for key in ("store_uid", "fingerprint"):
                        if key in data:
                            data[key] = "<masked>"
            out[rel] = data
    return out


def differences(want, got, path="", out=None):
    """Where ``got`` departs from ``want``: ``[(path, want, got)]``."""
    out = [] if out is None else out
    if type(want) is not type(got):
        out.append((path, want, got))
    elif isinstance(want, dict):
        for k in sorted(set(want) | set(got), key=str):
            differences(want.get(k), got.get(k), f"{path}/{k}", out)
    elif isinstance(want, (list, tuple)):
        if len(want) != len(got):
            out.append((path + ".len", len(want), len(got)))
        for i, (a, b) in enumerate(zip(want, got)):
            differences(a, b, f"{path}[{i}]", out)
    elif want != got:
        out.append((path, want, got))
    return out


def same(per_pkg):
    """Assert the port's value equals the reference's (naming the first
    differences when not); returns it."""
    want, got = per_pkg[REF], per_pkg[PORT]
    assert got == want, [(p, repr(a)[:300], repr(b)[:300])
                         for p, a, b in differences(want, got)[:5]]
    return want


def masked(obj, *paths):
    """``obj`` through JSON with each of ``paths`` replaced by ``<dir>``
    and a pid in a temp name masked."""
    text = json.dumps(obj, sort_keys=True, default=str)
    for p in paths:
        text = text.replace(str(p), "<dir>")
    return json.loads(re.sub(r"tmp\d+", "tmp<pid>", text))


# ---------------------------------------------------------------------------
# the two harnesses side by side


def test_registries_equal_the_reference():
    assert faults.POINTS == ref_faults.POINTS
    assert len(faults.POINTS) == 34 and "mesh.dispatch" in faults.POINTS
    assert faults.WORKER_POINTS == ref_faults.WORKER_POINTS
    assert faults.DEATH_ACTIONS == ref_faults.DEATH_ACTIONS
    assert faults._ACTIONS == ref_faults._ACTIONS
    assert faults._DEFAULT_SEED == ref_faults._DEFAULT_SEED == 0xA5DB


def _refusal(mod, spec):
    try:
        mod.reset(spec)
    except ValueError as err:
        return str(err)
    finally:
        mod.reset("")
    return None


#: specs the grammar refuses, and arms the reference's death-action guard
#: refuses in-process (one word per refusal path of ``_parse`` / ``reset``)
BAD_SPECS = [
    "nope", "ingest.chunk", "ingest.chunk:x", "ingest.chunk:0",
    "ingest.chunk:-3", "ingest.chunk:1:explode", "ingest.chunk:prob",
    "ingest.chunk:prob:x", "ingest.chunk:prob:0", "ingest.chunk:prob:1.5",
    "ingest.chunk:prob:-0.5", "ingest.chunk:1:delay", "ingest.chunk:1:delay:x",
    "ingest.chunk:1:delay:-5", "ingest.chunk:1:raise:junk",
    "ingest.chunk:1:delay:5:junk", "store.save.pre_manifst:1:kill",
    "ingest.chunk:1:kill", "store.save.pre_manifest:1:kill",
    "wal.append:1:torn_write", "memtable.flush:1:kill",
    "export.commit:prob:0.5:torn_write", ":1", "serve.batch:1.5",
]


@pytest.mark.parametrize("spec", BAD_SPECS)
def test_refusals_equal_the_reference_word_for_word(spec):
    want = _refusal(ref_faults, spec)
    assert want is not None
    assert _refusal(faults, spec) == want
    assert faults.armed_point() is None


def test_every_point_and_action_arms_alike():
    for point in sorted(faults.POINTS):
        for tail in ("1", "2:raise", "3:eio", "1:delay:0", "prob:0.25",
                     "prob:1:delay:7"):
            spec = f"{point}:{tail}"
            faults.reset(spec)
            ref_faults.reset(spec)
            assert faults._ARMED == ref_faults._ARMED, spec
    for point in sorted(faults.WORKER_POINTS):
        for action in faults.DEATH_ACTIONS:
            faults.reset(f"{point}:1:{action}")
            assert faults.armed_point() == point


def _passes(mod, spec, n=96, point="ingest.chunk"):
    mod.reset(spec)
    out = []
    for _ in range(n):
        try:
            mod.fire(point)
            out.append(0)
        except OSError:
            out.append(1)
        except mod.InjectedFault:
            out.append(2)
    return out, mod.fired()


@pytest.mark.parametrize("seed", [None, "12345", "0"])
@pytest.mark.parametrize("spec", ["ingest.chunk:prob:0.5:eio",
                                  "ingest.chunk:prob:0.1",
                                  "ingest.chunk:7:eio"])
def test_prob_coin_fires_on_the_same_passes(monkeypatch, seed, spec):
    if seed is None:
        monkeypatch.delenv("AVDB_FAULT_SEED", raising=False)
    else:
        monkeypatch.setenv("AVDB_FAULT_SEED", seed)
    got = _passes(faults, spec)
    assert got == _passes(ref_faults, spec)
    assert got == _passes(faults, spec)  # reset re-seeds: a replay


def test_bad_seed_refused_alike(monkeypatch):
    monkeypatch.setenv("AVDB_FAULT_SEED", "x")
    with pytest.raises(ValueError) as a:
        faults.reset("ingest.chunk:1")
    with pytest.raises(ValueError) as b:
        ref_faults.reset("ingest.chunk:1")
    assert str(a.value) == str(b.value)


def test_environment_arms_at_import():
    """``AVDB_FAULT`` in a child's environment arms the child at import,
    death actions at any point included (the subprocess path)."""
    code = ("from annotatedvdb_tpu_torch.utils import faults; "
            "print(faults.armed_point(), faults._ARMED)")
    env = dict(os.environ, AVDB_FAULT="store.save.pre_manifest:2:kill")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[0] == "store.save.pre_manifest"
    env["AVDB_FAULT"] = "store.save.pre_manifst:2:kill"
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=60)
    assert out.returncode != 0 and "unknown injection point" in out.stderr


def test_kill_action_sigkills_the_process(tmp_path):
    """``kill`` is a real SIGKILL (no ``finally`` runs); ``torn_write``
    lands half the payload, then dies."""
    target = tmp_path / "f.bin"
    code = (
        "import sys\n"
        "from annotatedvdb_tpu_torch.utils import faults\n"
        "f = open(sys.argv[1], 'wb')\n"
        "f.write(b'head:')\n"
        "try:\n"
        "    faults.fire('wal.append', f, payload=b'0123456789')\n"
        "finally:\n"
        "    print('finally ran')\n"
    )
    env = dict(os.environ, AVDB_FAULT="wal.append:1:torn_write")
    out = subprocess.run([sys.executable, "-c", code, str(target)],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=60)
    assert out.returncode == -9 and "finally ran" not in out.stdout
    assert target.read_bytes() == b"head:01234"
    env["AVDB_FAULT"] = "wal.append:1:kill"
    out = subprocess.run([sys.executable, "-c", code, str(target)],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=60)
    assert out.returncode == -9 and "finally ran" not in out.stdout
    assert target.read_bytes() == b""  # buffered 'head:' died with it


# ---------------------------------------------------------------------------
# the cases of tests/test_faults.py, against the port


def test_unarmed_fire_is_noop():
    faults.reset("")
    for _ in range(3):
        faults.fire("store.save.pre_manifest")
    assert faults.fired() == {}


def test_nth_hit_fires_exactly_once():
    faults.reset("ingest.chunk:3:raise")
    faults.fire("ingest.chunk")
    faults.fire("ledger.append")  # different point: not counted
    faults.fire("ingest.chunk")
    with pytest.raises(InjectedFault):
        faults.fire("ingest.chunk")
    faults.fire("ingest.chunk")  # past nth: no-op again
    assert faults.fired() == {"ingest.chunk": 1}


def test_eio_action_raises_oserror():
    faults.reset("egress.flush:1:eio")
    with pytest.raises(OSError) as exc:
        faults.fire("egress.flush")
    assert exc.value.errno == errno.EIO


def test_delay_action_sleeps_and_continues():
    faults.reset("ingest.chunk:2:delay:50")
    t0 = time.perf_counter()
    faults.fire("ingest.chunk")  # hit 1: no-op
    assert time.perf_counter() - t0 < 0.04
    t0 = time.perf_counter()
    faults.fire("ingest.chunk")  # hit 2: the 50ms sleep, then continue
    assert time.perf_counter() - t0 >= 0.045
    assert faults.fired() == {"ingest.chunk": 1}
    faults.fire("ingest.chunk")
    assert faults.fired() == {"ingest.chunk": 1}


def test_prob_mode_with_delay_action():
    faults.reset("serve.batch:prob:1.0:delay:1")
    for _ in range(5):
        faults.fire("serve.batch")
    assert faults.fired() == {"serve.batch": 5}


def test_unknown_point_names_every_known_point():
    with pytest.raises(ValueError) as exc:
        faults.reset("store.save.pre_manifst:1:kill")
    msg = str(exc.value)
    assert "unknown injection point" in msg
    for point in sorted(faults.POINTS):
        assert point in msg


def test_death_actions_are_subprocess_only_in_process(monkeypatch):
    for spec in ("ingest.chunk:1:kill", "store.save.pre_manifest:1:kill",
                 "wal.append:1:torn_write", "memtable.flush:1:kill"):
        with pytest.raises(ValueError) as exc:
            faults.reset(spec)
        assert "subprocess-only" in str(exc.value)
        assert "raise, eio, delay" in str(exc.value)
        assert faults.armed_point() is None
    faults.reset("serve.accept:1:kill")
    assert faults.armed_point() == "serve.accept"
    monkeypatch.setenv("AVDB_FAULT", "store.save.pre_manifest:1:kill")
    faults.reset()  # environment arming: no rejection
    assert faults.armed_point() == "store.save.pre_manifest"


def test_with_backoff_retries_transient_then_succeeds():
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise OSError(errno.EIO, "blip")
        return "ok"

    before = retry_mod.stats["retries"]
    assert with_backoff(flaky, attempts=3, base_delay=0.001) == "ok"
    assert calls["n"] == 3
    assert retry_mod.stats["retries"] - before == 2


def test_with_backoff_absorbs_injected_eio_but_not_raise():
    faults.reset("egress.flush:1:eio")
    assert with_backoff(lambda: faults.fire("egress.flush") or "ok",
                        base_delay=0.001) == "ok"
    faults.reset("egress.flush:1:raise")
    with pytest.raises(InjectedFault):
        with_backoff(lambda: faults.fire("egress.flush"), base_delay=0.001)


def test_with_backoff_propagates_nontransient_and_gives_up():
    calls = {"n": 0}

    def broken():
        calls["n"] += 1
        raise ValueError("data error, not transient")

    with pytest.raises(ValueError):
        with_backoff(broken, attempts=5, base_delay=0.001)
    assert calls["n"] == 1

    def transient_then_data_error():
        calls["n"] += 1
        if calls["n"] == 2:
            raise OSError(errno.EIO, "blip")
        raise ValueError("data error")

    before = dict(retry_mod.stats)
    with pytest.raises(ValueError):
        with_backoff(transient_then_data_error, attempts=5, base_delay=0.001)
    assert retry_mod.stats["retries"] - before["retries"] == 1
    assert retry_mod.stats["gave_up"] == before["gave_up"]

    def always():
        raise OSError(errno.EIO, "persistent")

    with pytest.raises(OSError):
        with_backoff(always, attempts=2, base_delay=0.001)
    assert retry_mod.stats["gave_up"] - before["gave_up"] == 1


def test_stage_error_reaches_consumer_and_survives_close():
    def boom(x):
        raise RuntimeError("root cause")

    st = BoundedStage(iter([1]), fn=boom, depth=2)
    with pytest.raises(RuntimeError, match="root cause"):
        next(iter(st))
    assert isinstance(st.error, RuntimeError)
    st.close()
    st = BoundedStage(iter([1]), fn=boom, depth=2)
    for _ in range(100):
        if st.error is not None:
            break
        time.sleep(0.01)
    st.close()
    assert "root cause" in str(st.error)


def test_ledger_append_raise_and_torn_tail_match_the_reference(tmp_path):
    """The raise fires before the write (the record never lands); the
    ledger bytes after the aborted append equal the reference's."""
    from annotatedvdb_tpu.store import AlgorithmLedger as RefLedger

    out = {}
    for name, ledger_cls, mod in (("ref", RefLedger, ref_faults),
                                  ("port", AlgorithmLedger, faults)):
        path = str(tmp_path / f"{name}.jsonl")
        ledger = ledger_cls(path)
        a1 = ledger.begin("load", {"file": "f.vcf"}, commit=True)
        ledger.checkpoint(a1, "f.vcf", 100, {})
        mod.reset("ledger.append:1:raise")
        with pytest.raises(mod.InjectedFault):
            ledger.checkpoint(a1, "f.vcf", 200, {})
        mod.reset("")
        assert ledger_cls(path).last_checkpoint("f.vcf") == 100
        with open(path) as f:
            out[name] = [{k: v for k, v in json.loads(line).items()
                          if k != "ts"} for line in f]
    assert out["port"] == out["ref"]


def test_ledger_concurrent_appends_are_serialized(tmp_path):
    path = str(tmp_path / "ledger.jsonl")
    ledger = AlgorithmLedger(path)
    alg = ledger.begin("load", {"file": "f.vcf"}, commit=True)
    n = 200

    def checkpoints():
        for i in range(n):
            ledger.checkpoint(alg, "f.vcf", i + 1, {})

    def runs():
        for i in range(n):
            ledger.run({"script": "t", "i": i})

    threads = [threading.Thread(target=checkpoints),
               threading.Thread(target=runs)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    with open(path) as f:
        lines = [json.loads(line) for line in f if line.strip()]
    assert len(lines) == 1 + 2 * n
    reopened = AlgorithmLedger(path)
    assert reopened.skipped_lines == 0
    assert reopened.last_checkpoint("f.vcf") == n


@pytest.mark.parametrize("fault", ["egress.flush:1:eio", "egress.flush:2:eio",
                                   "egress.flush:1:raise"])
def test_egress_flush_matches_the_reference(tmp_path, fault):
    """An injected EIO at the COPY flush rides the bounded retry to the
    reference's bytes; a raise aborts with no torn tmp left, in both
    packages alike."""
    from annotatedvdb_tpu.io.pg_egress import export_store as ref_export
    from annotatedvdb_tpu.store import VariantStore as RefStore

    from annotatedvdb_tpu_torch.io.pg_egress import export_store

    ref_store = RefStore(width=8)
    ref_store.shard(1).append(
        {"pos": np.asarray([10, 20], np.int32),
         "h": np.asarray([7, 8], np.uint32),
         "ref_len": np.full(2, 1, np.int32),
         "alt_len": np.full(2, 1, np.int32)},
        np.full((2, 8), 65, np.uint8), np.full((2, 8), 67, np.uint8),
    )
    ref_store.save(str(tmp_path / "store"))

    def run(mod, fn, store, out):
        mod.reset(fault)
        try:
            return fn(store, out) if mod is ref_faults else \
                fn(store, out, device="cpu")
        except mod.InjectedFault as err:
            return type(err).__name__
        finally:
            mod.reset("")

    from annotatedvdb_tpu.utils import retry as ref_retry

    before = ref_retry.stats["retries"]
    want = run(ref_faults, ref_export,
               RefStore.load(str(tmp_path / "store")), str(tmp_path / "r"))
    want_retries = ref_retry.stats["retries"] - before
    before = retry_mod.stats["retries"]
    got = run(faults, export_store,
              VariantStore.load(str(tmp_path / "store")), str(tmp_path / "p"))
    assert got == want
    assert retry_mod.stats["retries"] - before == want_retries
    assert want_retries == (fault == "egress.flush:1:eio")
    for sub in ("data", "schema"):
        names = sorted(os.listdir(tmp_path / "r" / sub))
        assert sorted(os.listdir(tmp_path / "p" / sub)) == names
        for name in names:
            assert (tmp_path / "p" / sub / name).read_bytes() == \
                (tmp_path / "r" / sub / name).read_bytes(), name


def test_every_point_fires_at_as_many_sites_as_in_the_reference():
    """The count of ``faults.fire("<point>")`` sites per point, in the
    port's sources and the reference's: equal for every point but
    ``mesh.dispatch`` (the mesh is not ported)."""
    import ast

    def sites(pkg_dir):
        counts = {}
        for root, _dirs, files in os.walk(os.path.join(ROOT, pkg_dir)):
            if os.sep + "analysis" in root:
                continue
            for name in files:
                if not name.endswith(".py") or name == "faults.py":
                    continue
                with open(os.path.join(root, name)) as f:
                    tree = ast.parse(f.read())
                for node in ast.walk(tree):
                    if isinstance(node, ast.Call) and isinstance(
                            node.func, ast.Attribute) \
                            and node.func.attr == "fire" and node.args \
                            and isinstance(node.args[0], ast.Constant):
                        point = node.args[0].value
                        counts[point] = counts.get(point, 0) + 1
        return counts

    want = sites("annotatedvdb_tpu")
    got = sites("annotatedvdb_tpu_torch")
    assert want.pop("mesh.dispatch") == 2
    assert got == want
    assert set(got) == faults.POINTS - {"mesh.dispatch"}
    assert sum(got.values()) == 45
