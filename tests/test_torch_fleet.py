"""The serve fleet (``serve --workers N``): the PyTorch port's supervisor
and workers, on the CPU (``--platform cpu`` forwarded to every worker).

One small store (the reference's ``tests/test_serve.py::_build_store``:
three chromosomes, shadowed duplicates, an over-width row) is served by a
two-worker fleet over SO_REUSEPORT and over the supervisor's shared
listening fd; every answer must equal the reference engine's on the same
store, and SIGTERM must drain the fleet with exit code 0 and one shutdown
record per worker.  Also: a bad ``AVDB_SERVE_WORKERS`` exits 1, workers
that die at once (a bad inherited knob, or no card) make the fleet give
up with exit code 1, the budget is split across the workers, the
wedged-worker watchdog respawns a worker whose loop is parked (SIGSTOP;
the port has no fault points), a killed upsert worker replays its WAL and
serves the acknowledged rows byte for byte, and importing the fleet
leaves ``torch`` unloaded.

Each fleet test runs under its own 60-second deadline and kills the whole
process group in a ``finally``.
"""

import json
import os
import re
import signal
import subprocess
import sys
import time
import urllib.error
import urllib.request

import pytest

from annotatedvdb_tpu.serve.engine import QueryEngine as RefEngine
from annotatedvdb_tpu.serve.snapshot import StaticSnapshots as RefStatic
from annotatedvdb_tpu.store import VariantStore as RefStore
from test_serve import _build_store, _vid

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: every fleet test's wall budget, seconds
DEADLINE_S = 60.0


@pytest.fixture(scope="module")
def fleet_store(tmp_path_factory):
    store_dir = str(tmp_path_factory.mktemp("fleet_store"))
    truth = _build_store(store_dir)
    return store_dir, truth


class _Fleet:
    """``python -m annotatedvdb_tpu_torch serve --workers N`` in its own
    process group, under a deadline; stderr goes to a file."""

    def __init__(self, store_dir, log_path, workers=2, extra=(), env=None):
        self.t_end = time.monotonic() + DEADLINE_S
        self.log_path = log_path
        self._err = open(log_path, "w")
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "annotatedvdb_tpu_torch", "serve",
             "--storeDir", store_dir, "--port", "0",
             "--workers", str(workers), "--platform", "cpu", *extra],
            cwd=ROOT, env=env if env is not None else dict(os.environ),
            stdout=subprocess.PIPE, stderr=self._err, text=True,
            start_new_session=True,
        )
        line = self.proc.stdout.readline()
        m = re.search(r"http://([\d.]+):(\d+) with (\d+) workers", line)
        if m is None:
            self.kill()
            raise AssertionError(f"no fleet address line: {line!r} "
                                 f"{open(log_path).read()}")
        self.host, self.port = m.group(1), int(m.group(2))

    def left(self) -> float:
        left = self.t_end - time.monotonic()
        assert left > 0, "fleet test ran past its deadline: " + self.stderr()
        return left

    def stderr(self) -> str:
        self._err.flush()
        with open(self.log_path) as f:
            return f.read()

    def request(self, method, path, body=None, timeout=10.0):
        req = urllib.request.Request(
            f"http://{self.host}:{self.port}{path}", method=method,
            data=json.dumps(body).encode() if body is not None else None,
        )
        try:
            with urllib.request.urlopen(
                    req, timeout=min(timeout, self.left())) as r:
                return r.status, r.read().decode()
        except urllib.error.HTTPError as err:
            return err.code, err.read().decode()

    def wait_workers(self, n):
        """Block until ``n`` worker readiness lines reached stdout."""
        import select

        ready = 0
        while ready < n:
            r, _w, _x = select.select([self.proc.stdout], [], [],
                                      min(self.left(), 1.0))
            if r:
                line = self.proc.stdout.readline()
                assert line, "fleet stdout closed: " + self.stderr()
                ready += bool(re.match(r"worker \d+ serving ", line))

    def wait_healthy(self):
        while True:
            self.left()
            try:
                if self.request("GET", "/healthz", timeout=2.0)[0] == 200:
                    return
            except OSError:
                pass
            time.sleep(0.2)

    def wait_log(self, pattern, count=1):
        while True:
            self.left()
            found = re.findall(pattern, self.stderr())
            if len(found) >= count:
                return found
            time.sleep(0.1)

    def stop(self) -> int:
        self.proc.send_signal(signal.SIGTERM)
        return self.proc.wait(timeout=self.left())

    def kill(self):
        try:
            os.killpg(self.proc.pid, signal.SIGKILL)
        except OSError:
            pass
        self.proc.wait(timeout=10)
        self.proc.stdout.close()
        self._err.close()


@pytest.mark.parametrize("extra,label", [
    ((), "reuseport-or-default"),
    (("--_forceHandoff",), "parent-accept-handoff"),
])
def test_fleet_serves_and_drains(fleet_store, tmp_path, extra, label):
    store_dir, truth = fleet_store
    ref = RefEngine(RefStatic(RefStore.load(store_dir, readonly=True)),
                    region_cache_size=0)
    fleet = _Fleet(store_dir, str(tmp_path / "err.log"), workers=2,
                   extra=extra)
    try:
        fleet.wait_workers(2)
        for row in truth[:20]:
            status, body = fleet.request("GET", f"/variant/{_vid(row)}")
            assert status == 200 and body == ref.lookup(_vid(row)), label
        status, body = fleet.request("GET", "/region/8:1-10000?limit=3")
        assert status == 200
        assert body == ref.region("8:1-10000", limit=3)
        specs = ["8:1-3000000", "3:100-130000", "X:1-5"]
        status, body = fleet.request("POST", "/regions",
                                     {"regions": specs, "limit": 4})
        assert status == 200
        assert body == ref.regions_serve(specs, limit=4).assemble()
        rc = fleet.stop()
        assert rc == 0, fleet.stderr()[-3000:]
        err = fleet.stderr()
        summaries = [json.loads(s) for s in
                     re.findall(r"run summary (\{.*\})", err)]
        assert sorted(s["worker"] for s in summaries) == [0, 1], err[-3000:]
        assert all(s["device"] == "cpu" for s in summaries)
        mode = "shared fd" if extra else "SO_REUSEPORT"
        from annotatedvdb_tpu_torch.serve.fleet import reuseport_available

        if extra or reuseport_available():
            assert f"({mode})" in err
    finally:
        fleet.kill()


def test_fleet_reuseport_detection_runs():
    from annotatedvdb_tpu_torch.serve.fleet import reuseport_available

    assert isinstance(reuseport_available(), bool)


def test_bad_workers_env_exits_cleanly(tmp_path, capsys, monkeypatch):
    """A malformed ``AVDB_SERVE_WORKERS`` exits ``serve: cannot start``
    with code 1, as in the reference."""
    from annotatedvdb_tpu.cli.serve import main as ref_main

    from annotatedvdb_tpu_torch.cli.serve import main

    monkeypatch.setenv("AVDB_SERVE_WORKERS", "two")
    assert main(["--storeDir", str(tmp_path / "missing")]) == 1
    err = capsys.readouterr().err
    assert ref_main(["--storeDir", str(tmp_path / "missing")]) == 1
    assert err == capsys.readouterr().err
    assert "bad AVDB_SERVE_WORKERS" in err


@pytest.mark.parametrize("case", ["bad-knob", "no-card"])
def test_fleet_gives_up_on_instant_death_workers(fleet_store, monkeypatch,
                                                 case):
    """A worker that can never start — a bad inherited knob, or no card
    when the fleet runs on ``cuda`` — ends the fleet with exit code 1
    after ``MAX_RAPID_DEATHS`` rapid deaths, never serving from the
    CPU."""
    import torch

    from annotatedvdb_tpu_torch.serve.fleet import ServeFleet

    store_dir, _truth = fleet_store
    if case == "bad-knob":
        monkeypatch.setenv("AVDB_SERVE_CLIENT_RATE", "abc")
        worker_args = ["--platform", "cpu"]
    else:
        if torch.cuda.is_available():
            pytest.skip("this host has a CUDA card")
        worker_args = ["--platform", "cuda"]
    monkeypatch.chdir(ROOT)
    lines: list[str] = []
    fleet = ServeFleet(store_dir, workers=1, restart_backoff_s=0.01,
                       drain_s=2.0, log=lines.append, worker_args=worker_args)
    fleet.MAX_RAPID_DEATHS = 2
    try:
        t0 = time.monotonic()
        assert fleet.run() == 1
        assert time.monotonic() - t0 < DEADLINE_S
    finally:
        for proc in fleet._procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=10)
    assert any("giving up" in ln for ln in lines), lines
    assert [p.returncode for p in fleet._procs.values()] == [1]


def test_worker_health_reads_the_live_beating_slots(tmp_path):
    """``worker_health`` aggregates the heartbeat slots of live workers
    that have beaten at least once (the fields the aio tick writes)."""
    from annotatedvdb_tpu_torch.serve.fleet import HB_SLOT, ServeFleet

    fleet = ServeFleet(str(tmp_path), workers=3)
    sleepers = [subprocess.Popen([sys.executable, "-c", "import time; time.sleep(30)"])
                for _ in range(2)]
    try:
        fleet._procs = {0: sleepers[0], 1: sleepers[1]}
        HB_SLOT.pack_into(fleet._hb_mm, 0, time.time(), 0.25, 2, 7)
        HB_SLOT.pack_into(fleet._hb_mm, 2 * HB_SLOT.size, time.time(), 0.9, 3, 9)
        # worker 1 is live but has not beaten; slot 2 has no live worker
        assert fleet.worker_health() == {"workers": 1, "brownout_max": 2,
                                         "exceed_max": 0.25, "queue_depth_max": 7}
        HB_SLOT.pack_into(fleet._hb_mm, HB_SLOT.size, time.time(), 0.5, 1, 11)
        assert fleet.worker_health() == {"workers": 2, "brownout_max": 2,
                                         "exceed_max": 0.5, "queue_depth_max": 11}
    finally:
        for p in sleepers:
            p.kill()
            p.wait(timeout=10)
        fleet._reserve.close()
        fleet._hb_mm.close()
        os.unlink(fleet._hb_path)


def test_fleet_splits_hbm_budget_across_workers(monkeypatch):
    """The budget caps one shared card: each worker gets an equal share
    (flag and environment alike), and the platform reaches every
    worker."""
    from annotatedvdb_tpu.cli.serve import _build_parser as ref_parser
    from annotatedvdb_tpu.cli.serve import _knob_args as ref_knob_args

    from annotatedvdb_tpu_torch.cli.serve import _build_parser, _knob_args

    monkeypatch.delenv("AVDB_SERVE_HBM_BUDGET", raising=False)
    monkeypatch.delenv("AVDB_SERVE_UPSERTS", raising=False)
    cases = [
        (["--storeDir", "x", "--hbmBudget", "1g"], 4, None),
        (["--storeDir", "x"], 2, "512k"),
        (["--storeDir", "x"], 2, None),
        (["--storeDir", "x", "--hbmBudget", "0"], 2, None),
        (["--storeDir", "x", "--upserts", "--maxBatch", "64",
          "--snapshotTtlMs", "100", "--clientRate", "5"], 3, "3m"),
    ]
    for argv, workers, env in cases:
        if env is None:
            monkeypatch.delenv("AVDB_SERVE_HBM_BUDGET", raising=False)
        else:
            monkeypatch.setenv("AVDB_SERVE_HBM_BUDGET", env)
        knobs = _knob_args(_build_parser().parse_args(argv), workers)
        want = ref_knob_args(ref_parser().parse_args(argv), workers)
        assert knobs[:2] == ["--platform", "cuda"]
        assert knobs[2:] == want
    args = _build_parser().parse_args(["--storeDir", "x", "--platform", "cpu",
                                       "--hbmBudget", "1g"])
    knobs = _knob_args(args, 4)
    assert knobs[:2] == ["--platform", "cpu"]
    assert knobs[knobs.index("--hbmBudget") + 1] == str((1 << 30) // 4)


def test_wedged_worker_is_killed_and_respawned(fleet_store, tmp_path):
    """A worker whose event loop stops beating (parked by SIGSTOP) is
    SIGKILLed by the watchdog and respawned; the fleet serves again."""
    store_dir, truth = fleet_store
    env = dict(os.environ, AVDB_SERVE_WEDGE_TIMEOUT_S="1")
    fleet = _Fleet(store_dir, str(tmp_path / "err.log"), workers=2, env=env)
    try:
        fleet.wait_workers(2)
        first = fleet.wait_log(r"worker 0: pid (\d+)")[0]
        os.kill(int(first), signal.SIGSTOP)
        fleet.wait_log(r"worker 0: wedged \(alive, no heartbeat")
        pids = fleet.wait_log(r"worker 0: pid (\d+)", count=2)
        assert pids[1] != first
        fleet.wait_workers(1)
        vid = _vid(truth[0])
        for _ in range(6):  # fresh connections reach both workers
            assert fleet.request("GET", f"/variant/{vid}")[0] == 200
        assert fleet.stop() == 0
    finally:
        fleet.kill()


def _conn_requests(fleet, reqs):
    """Requests on ONE keep-alive connection (one worker: read-your-writes
    is per worker)."""
    import http.client

    conn = http.client.HTTPConnection(fleet.host, fleet.port,
                                      timeout=min(10.0, fleet.left()))
    out = []
    try:
        for method, path, body in reqs:
            conn.request(method, path, body=None if body is None
                         else json.dumps(body).encode())
            resp = conn.getresponse()
            out.append((resp.status, resp.read().decode()))
    finally:
        conn.close()
    return out


def test_killed_upsert_worker_replays_its_wal(fleet_store, tmp_path):
    """A fleet worker acknowledges upserts and is SIGKILLed before any
    flush; the respawned worker replays its WAL and serves the rows byte
    for byte; a clean stop leaves the WAL with the unflushed records."""
    import shutil

    from annotatedvdb_tpu_torch.store.wal import count_records

    src, _truth = fleet_store
    store_dir = str(tmp_path / "store")
    shutil.copytree(src, store_dir)
    env = dict(os.environ, AVDB_MEMTABLE_BYTES="0", AVDB_MEMTABLE_FLUSH_S="0")
    fleet = _Fleet(store_dir, str(tmp_path / "err.log"), workers=2,
                   extra=("--upserts",), env=env)
    reads = [("GET", "/variant/8:777:A:G", None),
             ("GET", "/variant/8:778:AT:A", None)]
    try:
        fleet.wait_workers(2)
        got = _conn_requests(fleet, [("POST", "/variants/upsert", {
            "variants": [{"id": "8:777:A:G", "ref_snp": 5,
                          "annotations": {"other_annotation": {"live": 1}}},
                         {"id": "8:778:AT:A"}]})] + reads)
        (status, ack), want = got[0], got[1:]
        assert status == 200 and json.loads(ack)["accepted"] == 2, ack
        assert [s for s, _b in want] == [200, 200]
        held = [f for f in os.listdir(store_dir) if f.endswith(".wal")
                and count_records(os.path.join(store_dir, f))]
        assert len(held) == 1, held
        idx = int(re.match(r"serve-w(\d+)\.", held[0]).group(1))
        first = fleet.wait_log(rf"worker {idx}: pid (\d+)")[0]
        os.kill(int(first), signal.SIGKILL)
        fleet.wait_log(rf"worker {idx}: pid (\d+)", count=2)
        fleet.wait_log(r"wal: replayed 2 acknowledged upsert row")
        fleet.wait_workers(1)
        # the replayed worker answers the rows; its sibling has not seen
        # them (nothing was flushed) and answers 404
        seen = set()
        while 200 not in seen:
            fleet.left()
            got = _conn_requests(fleet, reads)
            seen.add(got[0][0])
            assert got[0][0] == got[1][0] in (200, 404), got
            if got[0][0] == 200:
                assert got == want
        assert fleet.stop() == 0
        wals = [f for f in os.listdir(store_dir) if f.endswith(".wal")]
        assert wals == [held[0]]
    finally:
        fleet.kill()


def test_fleet_import_leaves_torch_out():
    """The supervisor only spawns, watches and signals: importing the
    fleet and the CLI, and building a supervisor, loads no ``torch``."""
    code = (
        "import sys\n"
        "from annotatedvdb_tpu_torch.cli import serve\n"
        "from annotatedvdb_tpu_torch.serve.fleet import ServeFleet\n"
        "f = ServeFleet('.', workers=2)\n"
        "f._reserve.close()\n"
        "import os; os.unlink(f._hb_path)\n"
        "print('torch' in sys.modules)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "False"
