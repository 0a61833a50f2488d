"""The crash flight recorder and the health plane's doctor verbs: the
PyTorch port against the JAX package, on the CPU.

- ``FlightRecorder`` rings fed the same requests and lifecycle events at
  the same times (``time.time`` patched to one sequence for both
  packages; the background flusher held off so the slot order is the
  callers') hold the reference's bytes, through ring wrap, payload
  trimming and multi-byte details; ``decode_ring``, ``harvest`` (file
  name and bytes), ``load_harvest`` and ``list_blackboxes`` agree.
- ``doctor flight``, ``doctor slo`` and ``doctor trace`` of both packages
  print the same reports and exit the same on one store: a store with
  harvested black boxes, live rings, harvested and live history and
  ledger compact/flush records; a store with none (exit 2); a missing
  store (exit 2).
- The crossed fleets: a port ``serve --workers 2 --upserts --maintain``
  whose worker is SIGKILLed harvests a flight box and a history file the
  reference's ``doctor flight``/``slo``/``trace`` read, and the other way
  round; each under a 150 s deadline with its process group killed.
"""

import glob
import json
import os
import re
import shutil
import signal
import subprocess
import sys
import time
import urllib.request

import numpy as np
import pytest

from annotatedvdb_tpu.cli import doctor as ref_doctor
from annotatedvdb_tpu.obs import flight as ref_flight
from annotatedvdb_tpu.obs import metrics as ref_metrics
from annotatedvdb_tpu.obs import timeseries as ref_ts
from annotatedvdb_tpu.store.ledger import AlgorithmLedger as RefLedger

from annotatedvdb_tpu_torch.cli import doctor
from annotatedvdb_tpu_torch.obs import flight

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke as smoke  # noqa: E402

PKGS = {"ref": ref_flight, "port": flight}


class _Clock:
    """A deterministic ``time.time``: each call advances 1.25 ms."""

    def __init__(self, t0):
        self.t = t0

    def __call__(self):
        self.t += 0.00125
        return self.t


def _record(mod, path, seed, slots, event_slots):
    rng = np.random.default_rng(seed)
    rec = mod.FlightRecorder(path, slots=slots, event_slots=event_slots)
    kinds = ("point", "bulk", "region", "regions", "stats", "upsert")
    stages = ("admission", "queue", "device", "render", "wal_fsync")
    for i in range(int(rng.integers(5, 3 * slots))):
        if rng.random() < 0.2:
            detail = rng.choice([
                "level 0->1 (limit)", "group 22 tripped open (RuntimeError)",
                "pass committed (5->1 files, read-amp 1)",
                "café ☃ \"quoted\" \\ back" * int(rng.integers(1, 12)),
                "x" * int(rng.integers(100, 400))])
            rec.event(str(rng.choice(["brownout", "breaker", "maintain", "wal"])),
                      str(detail))
            continue
        st = [(str(s), float(rng.exponential(0.01)))
              for s in rng.choice(stages, int(rng.integers(0, 9)))]
        rec.request("%032x" % int(rng.integers(0, 2**62)) if rng.random() < 0.9
                    else "client-id-" + "z" * int(rng.integers(0, 40)),
                    str(rng.choice(kinds)), int(rng.choice([200, 404, 429, 500, 504])),
                    float(rng.exponential(0.05)), st)
        if rng.random() < 0.3:
            rec.flush(limit=int(rng.integers(1, 5)))
    rec.close()


@pytest.mark.parametrize("seed,slots,event_slots", [
    (0, 8, 2), (1, 32, None), (2, 5, 1), (3, 64, 16)])
def test_ring_bytes_and_harvest_match_reference(tmp_path, monkeypatch, seed,
                                                slots, event_slots):
    out = {}
    for key, mod in PKGS.items():
        monkeypatch.setattr(mod.FlightRecorder, "FLUSH_S", 3600.0)
        store = str(tmp_path / key)
        path = mod.ring_path(store, seed)
        monkeypatch.setattr(time, "time", _Clock(1_700_000_000.0 + seed))
        _record(mod, path, seed, slots, event_slots)
        monkeypatch.setattr(time, "time", lambda: 1_700_000_999.5)
        harvested = mod.harvest(path, store, seed, "died rc=-9")
        monkeypatch.undo()
        with open(path, "rb") as f:
            ring = f.read()
        with open(harvested, "rb") as f:
            box = f.read()
        out[key] = (ring, mod.decode_ring(path), os.path.basename(harvested),
                    box.replace(store.encode(), b"STORE"),
                    {k: [os.path.basename(p) for p in v]
                     for k, v in mod.list_blackboxes(store).items()})
        # each package decodes the other's ring and harvest
        other = PKGS["ref" if key == "port" else "port"]
        assert other.decode_ring(path) == out[key][1]
        assert other.load_harvest(harvested) == mod.load_harvest(harvested)
    assert out["port"] == out["ref"]
    assert out["ref"][1]["events"]


def test_decode_refusals_and_empty_harvest_match_reference(tmp_path):
    cases = {"short": b"AVDB", "magic": b"NOTAFLT1" + b"\0" * 40,
             "truncated": ref_flight.HEADER.pack(ref_flight.MAGIC, 1, 4, 2)}
    for name, blob in cases.items():
        p = str(tmp_path / f"{name}.ring")
        with open(p, "wb") as f:
            f.write(blob)
        errs = []
        for mod in PKGS.values():
            with pytest.raises(ValueError) as exc:
                mod.decode_ring(p)
            errs.append(str(exc.value))
        assert errs[0] == errs[1]
    for key, mod in PKGS.items():
        store = str(tmp_path / key)
        rec = mod.FlightRecorder(mod.ring_path(store, 0), slots=4)
        rec.close()
        assert mod.harvest(mod.ring_path(store, 0), store, 0, "x") is None
        assert mod.harvest(str(tmp_path / "none.ring"), store, 0, "x") is None


@pytest.mark.parametrize("raw", ["", "0", "7", "-3", "4096"])
def test_flight_events_knob_matches_reference(monkeypatch, raw):
    monkeypatch.setenv("AVDB_FLIGHT_EVENTS", raw)
    assert flight.flight_events_from_env() == ref_flight.flight_events_from_env()


# ---------------------------------------------------------------- doctor


def _run(main, argv, capsys):
    rc = main(argv)
    cap = capsys.readouterr()
    return rc, cap.out, cap.err


def _health_store(tmp_path, monkeypatch):
    """A store with two harvested black boxes and two live rings, a
    harvested history file with an availability episode and a live
    mirror, and ledger run/compact/flush records (written by the
    reference's readers' counterparts, once)."""
    store = str(tmp_path / "store")
    os.makedirs(store)
    for seed, (slots, ev) in enumerate(((8, 2), (16, 4), (6, 2))):
        monkeypatch.setattr(ref_flight.FlightRecorder, "FLUSH_S", 3600.0)
        monkeypatch.setattr(time, "time", _Clock(1_700_000_100.0 + 50 * seed))
        _record(ref_flight, ref_flight.ring_path(store, seed), seed, slots, ev)
        if seed < 2:
            monkeypatch.setattr(time, "time", lambda s=seed: 1_700_000_500.0 + s)
            ref_flight.harvest(ref_flight.ring_path(store, seed), store, seed,
                               "died rc=-9" if seed else "wedged (watchdog SIGKILL)")
        monkeypatch.undo()
    clk = {"t": 1_700_000_000.0}
    reg = ref_metrics.MetricsRegistry()
    ring = ref_ts.TimeSeriesRing(reg, worker=1, path=ref_ts.history_path(store, 1),
                                 tick_s=1.0, history_s=600.0,
                                 clock=lambda: clk["t"])
    for step in range(12):
        reg.counter("avdb_query_requests_total", "", {"kind": "point"}).inc(100)
        if 3 <= step < 7:
            reg.counter("avdb_query_errors_total", "", {"kind": "point"}).inc(50)
        ring.sample()
        clk["t"] += 1.0
    ring.persist({"alerts": [], "firing": 0}, force=True)
    monkeypatch.setattr(time, "time", lambda: 1_700_000_700.0)
    ref_ts.harvest(ring.path, store, 1, "died rc=-9")
    monkeypatch.undo()
    ring.sample()
    ring.persist(force=True)
    ledger = RefLedger(os.path.join(store, "ledger.jsonl"))
    ledger.run({"labels": ["22"], "rows": 10, "status": "ok", "seconds": 1.5})
    ledger.compact({"labels": ["22"], "files_before": 5, "files_after": 1,
                    "seconds": 2.25})
    ledger.flush({"rows": 3, "seconds": 0.5})
    return store


VERBS = [
    ["flight"], ["flight", "--json"], ["flight", "--all", "--limit", "3"],
    ["flight", "--all", "--json"],
    ["slo"], ["slo", "--json"], ["slo", "--all"],
    ["slo", "--all", "--json", "--fast", "1", "--slow", "2", "--burn", "2"],
    ["slo", "--fast", "1", "--slow", "2", "--burn", "2"],
    ["trace"],
]


@pytest.mark.parametrize("argv", VERBS, ids=lambda a: "-".join(a).replace("--", ""))
def test_doctor_verbs_match_reference(tmp_path, monkeypatch, capsys, argv):
    store = _health_store(tmp_path, monkeypatch)
    want = _run(ref_doctor.main, [*argv, "--storeDir", store], capsys)
    got = _run(doctor.main, [*argv, "--storeDir", store], capsys)
    assert got == want
    assert want[0] == 0 and (want[1] or want[2])
    if argv == ["slo", "--all", "--json", "--fast", "1", "--slow", "2", "--burn", "2"]:
        reps = json.loads(want[1])["replays"]
        assert any(e["to"] == "firing" for r in reps for e in r["episodes"])


def test_doctor_trace_out_matches_reference(tmp_path, monkeypatch, capsys):
    store = _health_store(tmp_path, monkeypatch)
    outs = {}
    for key, main in (("ref", ref_doctor.main), ("port", doctor.main)):
        path = str(tmp_path / f"{key}.trace.json")
        rc, out, err = _run(main, ["trace", "--storeDir", store, "--out", path],
                            capsys)
        with open(path) as f:
            outs[key] = (rc, out, err.replace(path, "OUT"), f.read())
    assert outs["port"] == outs["ref"]
    doc = json.loads(outs["ref"][3])
    names = {e["name"] for e in doc["traceEvents"]}
    assert {"ledger.run", "ledger.compact", "ledger.flush"} <= names


@pytest.mark.parametrize("verb", ["flight", "slo", "trace"])
@pytest.mark.parametrize("where", ["empty", "missing"])
def test_doctor_verbs_without_data_match_reference(tmp_path, capsys, verb, where):
    store = str(tmp_path / "store")
    if where == "empty":
        os.makedirs(os.path.join(store, "flight"))
        os.makedirs(os.path.join(store, "history"))
    want = _run(ref_doctor.main, [verb, "--storeDir", store], capsys)
    got = _run(doctor.main, [verb, "--storeDir", store], capsys)
    assert got == want and want[0] == 2


# ---------------------------------------------------------------- fleets


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    return smoke.build_serve_store(str(tmp_path_factory.mktemp("flight")), "cpu")


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=20) as r:
        return r.status, r.read()


@pytest.mark.parametrize("server,reader", [("port", "ref"), ("ref", "port")])
def test_killed_worker_black_box_crosses_packages(served, tmp_path, capsys,
                                                   server, reader):
    """``serve --workers 2 --upserts --maintain`` of one package; worker 1
    answers point reads, then is SIGKILLed; the supervisor harvests its
    ring and history before the respawn, and the other package's doctor
    renders both (the killed worker's requests, its reason) and merges
    the timeline."""
    store = str(tmp_path / "s")
    shutil.copytree(served["store"], store)
    pkg = {"ref": "annotatedvdb_tpu", "port": "annotatedvdb_tpu_torch"}[server]
    cmd = [sys.executable, "-m", pkg, "serve", "--storeDir", store, "--port", "0",
           "--workers", "2", "--upserts", "--maintain"]
    if server == "port":
        cmd += ["--platform", "cpu"]
    env = dict(os.environ, JAX_PLATFORMS="cpu", AVDB_OBS_TICK_S="0.2",
               AVDB_MEMTABLE_FLUSH_S="0", AVDB_MEMTABLE_BYTES="0")
    out_path, err_path = str(tmp_path / "out"), str(tmp_path / "err")
    with open(out_path, "w") as out_f, open(err_path, "w") as err_f:
        proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=out_f,
                                stderr=err_f, start_new_session=True)
    deadline = time.monotonic() + 150

    def wait(test):
        while not test():
            assert time.monotonic() < deadline, open(err_path).read()[-3000:]
            time.sleep(0.1)

    try:
        wait(lambda: sum(ln.startswith("worker ") for ln in open(out_path)) >= 2)
        port = int(re.search(r":(\d+) with 2 workers", open(out_path).read()).group(1))
        pid = {}

        def pids():
            for m in re.finditer(r"worker (\d+): pid (\d+)", open(err_path).read()):
                pid[int(m.group(1))] = int(m.group(2))
            return len(pid) == 2

        wait(pids)
        for vid in served["ids"][:40]:
            assert _get(port, f"/variant/{vid}")[0] in (200, 404)
        # the rings flush every 0.25 s and the mirrors persist at their
        # first tick: both are on disk well inside this
        wait(lambda: all(os.path.exists(os.path.join(store, "history", f"w{i}.ts.json"))
                         for i in range(2)))
        time.sleep(1.0)
        os.kill(pid[1], signal.SIGKILL)
        wait(lambda: glob.glob(os.path.join(store, "flight", "*-w1.jsonl"))
             and glob.glob(os.path.join(store, "history", "*-w1.json")))
    finally:
        os.killpg(proc.pid, signal.SIGTERM)
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    main = {"ref": ref_doctor.main, "port": doctor.main}[reader]
    rc, out, _err = _run(main, ["flight", "--storeDir", store, "--json"], capsys)
    assert rc == 0
    [box] = json.loads(out)["harvested"]
    assert box["meta"]["worker"] == 1 and box["meta"]["reason"] == "died rc=-9"
    assert {os.path.basename(r["path"]) for r in json.loads(out)["rings"]} >= {
        "w0.ring", "w1.ring", "supervisor.ring"}
    rc, out, _err = _run(main, ["slo", "--storeDir", store, "--json"], capsys)
    assert rc == 0
    reps = json.loads(out)["replays"]
    assert [r["harvested"]["reason"] for r in reps if r["harvested"]] == ["died rc=-9"]
    assert all(r["ticks"] >= 1 for r in reps)
    rc, _out, _err = _run(main, ["trace", "--storeDir", store, "--out",
                                 str(tmp_path / "t.json")], capsys)
    assert rc == 0
    with open(tmp_path / "t.json") as f:
        tracks = [e["args"]["name"] for e in json.load(f)["traceEvents"]
                  if e["name"] == "thread_name"]
    assert any(t.endswith("-w1.jsonl") for t in tracks), tracks
    # fsck passes over flight/ and history/: nothing it reports is theirs
    # (unflushed upserts' WAL files may warn)
    rc, out, _err = _run(main, ["--storeDir", store, "--json"], capsys)
    findings = json.loads(out)["findings"]
    assert rc in (0, 1) and {f["code"] for f in findings
                             if f["level"] != "info"} <= {"wal-pending"}
