"""The maintenance daemon (``serve --maintain``) and the preemption-retry
policy: the PyTorch port against the JAX package, on the CPU.

Each daemon case fragments one store with the reference, copies it, and
steps both packages' daemons through the same ticks (``tick()`` is the
deterministic stepping surface): the decisions, the counters, the
engaged/disabled states and the backoffs must agree, and the stores must
stay byte-equal.  Covered: the high watermark's edge, hysteresis, the
``AVDB_COMPACT_MIN_SEGMENTS`` floor winning over the watermark,
exponential backoff on preemptions, the in-pass retry, the health pause
and its resume, an abort mid-pass through ``cancel`` when health turns
hot, the self-disable after consecutive hard failures, the metrics, the
``retry_preempted`` unit cases, the ``--maintain`` refusals and knob
errors, a daemon that fails to start (logged, the fleet serves on), and
a real one-worker fleet whose daemon compacts the store under reads.
The reference's disk-guard, heartbeat and ``doctor status`` cases are
held elsewhere (``test_torch_upsert.py``, ``test_torch_fleet.py``,
``test_torch_doctor.py``); its ``maintain.*`` fault points are crossed
in ``test_torch_faults_store.py``.
"""

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

from annotatedvdb_tpu.cli import serve as ref_serve_cli
from annotatedvdb_tpu.obs.metrics import MetricsRegistry as RefRegistry
from annotatedvdb_tpu.serve import fleet as ref_fleet
from annotatedvdb_tpu.store import VariantStore as RefStore
from annotatedvdb_tpu.store import maintenance as ref_maintenance
from annotatedvdb_tpu.store.variant_store import Segment as RefSegment
from annotatedvdb_tpu.utils import retry as ref_retry

from annotatedvdb_tpu_torch.cli import serve as serve_cli
from annotatedvdb_tpu_torch.obs.metrics import MetricsRegistry
from annotatedvdb_tpu_torch.serve import fleet
from annotatedvdb_tpu_torch.store import maintenance
from annotatedvdb_tpu_torch.utils import retry

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WIDTH = 8
PKGS = {
    "ref": (ref_maintenance, RefRegistry),
    "port": (maintenance, MetricsRegistry),
}


def _append_segments(store_dir, nseg, n=120, code=6, base=500, salt=1,
                     alt=71):
    """``nseg`` disjoint segments on one chromosome, each committed by a
    real ``save`` (one on-disk segment file per save), written by the
    reference."""
    store = RefStore.load(store_dir) if os.path.exists(
        os.path.join(store_dir, "manifest.json")) else RefStore(width=WIDTH)
    shard = store.shard(code)
    for k in range(nseg):
        cols = {
            "pos": np.arange(base + 50_000 * k, base + 50_000 * k + n,
                             dtype=np.int32),
            "h": np.arange(n, dtype=np.uint32) + salt,
            "ref_len": np.full(n, 1, np.int32),
            "alt_len": np.full(n, 1, np.int32),
        }
        shard.append_segment(RefSegment.build(
            cols, np.full((n, WIDTH), 65, np.uint8),
            np.full((n, WIDTH), alt, np.uint8),
        ))
        shard._starts_cache = None
        store.save(store_dir)


def _files(store_dir):
    out = {}
    for name in sorted(os.listdir(store_dir)):
        with open(os.path.join(store_dir, name), "rb") as f:
            blob = f.read()
        if name == "ledger.jsonl":
            blob = re.sub(rb'"(ts|seconds)": [0-9.e+-]+', rb'"\1": 0', blob)
        out[name] = blob
    return out


@pytest.fixture()
def stores(tmp_path):
    """A factory: ``stores(nseg)`` writes a fragmented store with the
    reference and returns {pkg: its copy}."""
    def make(nseg):
        ref_dir = str(tmp_path / "ref")
        _append_segments(ref_dir, nseg)
        port_dir = str(tmp_path / "port")
        shutil.copytree(ref_dir, port_dir)
        return {"ref": ref_dir, "port": port_dir}
    return make


def _daemons(dirs, **kw):
    kw.setdefault("high", 4)
    kw.setdefault("low", 2)
    kw.setdefault("tick_s", 0.05)
    kw.setdefault("cooldown_s", 0.0)
    out = {}
    for pkg, (mod, _reg) in PKGS.items():
        logs = []
        d = mod.MaintenanceDaemon(dirs[pkg], log=logs.append, **kw)
        d.logs = logs
        out[pkg] = d
    return out


def _resume_now(d) -> None:
    with d._lock:
        d._resume_at = 0.0
    d._hot_check_at = 0.0


def _stats(d):
    """The daemon's stats with the backoff rounded to whole seconds (it
    counts down on the monotonic clock between the two reads)."""
    st = dict(d.stats())
    st["backoff_s"] = round(st["backoff_s"])
    return st


def _step_both(ds, dirs, steps):
    """Run ``steps`` (callables taking a daemon, returning a value) on
    both daemons; the decisions, stats and stores must agree."""
    got = {}
    for pkg, d in ds.items():
        got[pkg] = [(step(d), _stats(d)) for step in steps]
    assert got["port"] == got["ref"]
    assert _files(dirs["port"]) == _files(dirs["ref"])
    return got["port"]


def _amp(d):
    return max(d.read_amp().values(), default=0)


def test_exactly_at_high_watermark_trips(stores):
    dirs = stores(4)
    ds = _daemons(dirs)
    seq = _step_both(ds, dirs, [lambda d: d.tick(), _amp])
    assert seq[0][0] == "pass" and seq[1][0] == 1
    assert seq[0][1]["passes"] == 1


def test_below_high_watermark_stays_idle(stores):
    dirs = stores(3)
    ds = _daemons(dirs)
    seq = _step_both(ds, dirs, [lambda d: d.tick(), _amp])
    assert [s[0] for s in seq] == ["idle", 3]


def test_hysteresis_exit_below_low_watermark(stores):
    dirs = stores(5)
    ds = _daemons(dirs)
    first = _step_both(ds, dirs, [lambda d: d.tick()])
    assert first[0][0] == "pass" and first[0][1]["engaged"] is False
    # grow both stores back to between low and high: never re-engages
    for d in dirs.values():
        _append_segments(d, 2, n=50, base=9_000_000, salt=7, alt=84)
    seq = _step_both(ds, dirs, [_amp, lambda d: d.tick()])
    assert [s[0] for s in seq] == [3, "idle"]
    assert seq[1][1]["passes"] == 1


def test_hysteresis_exit_at_exactly_the_low_watermark(tmp_path):
    """A pass that leaves the largest group at exactly the low watermark
    (a second group holds ``low`` files, below the pass's ``low + 1``
    floor) disengages: the next tick is idle, not another pass."""
    ref_dir = str(tmp_path / "ref")
    _append_segments(ref_dir, 5)
    _append_segments(ref_dir, 2, code=7, base=700, salt=3)
    port_dir = str(tmp_path / "port")
    shutil.copytree(ref_dir, port_dir)
    dirs = {"ref": ref_dir, "port": port_dir}
    ds = _daemons(dirs)
    seq = _step_both(ds, dirs, [lambda d: d.tick(), _amp, lambda d: d.tick()])
    assert [s[0] for s in seq] == ["pass", 2, "idle"]
    assert seq[0][1]["engaged"] is False


def test_compact_min_segments_floor_wins_over_watermark(stores,
                                                        monkeypatch):
    dirs = stores(5)
    monkeypatch.setenv("AVDB_COMPACT_MIN_SEGMENTS", "99")
    ds = _daemons(dirs, cooldown_s=5.0)
    seq = _step_both(ds, dirs, [lambda d: d.tick(), _amp,
                                lambda d: d.tick()])
    assert [s[0] for s in seq] == ["noop", 5, "cooldown"]
    assert seq[0][1]["engaged"] is False and seq[0][1]["backoff_s"] == 5
    seq = _step_both(ds, dirs, [lambda d: (_resume_now(d), d.tick())[1]])
    assert seq[0][0] == "noop"


def test_backoff_doubles_on_repeated_preemptions(stores, monkeypatch):
    dirs = stores(5)
    ds = _daemons(dirs, cooldown_s=10.0, retries=0)
    for d in ds.values():
        monkeypatch.setattr(d, "_compact_once", lambda: {
            "status": "aborted", "reason": "test writer"})
    seq = _step_both(ds, dirs, [
        lambda d: d.tick(), lambda d: d.tick(),
        lambda d: (_resume_now(d), d.tick())[1],
    ])
    assert [s[0] for s in seq] == ["preempted", "cooldown", "preempted"]
    assert seq[0][1]["backoff_s"] == 10 and seq[2][1]["backoff_s"] == 20
    assert seq[2][1]["preemptions"] == 2 and seq[2][1]["engaged"] is True


def test_retry_preempted_is_used_before_backoff(stores, monkeypatch):
    dirs = stores(5)
    ds = _daemons(dirs, retries=1)
    calls = {}
    for pkg, d in ds.items():
        real = d._compact_once
        calls[pkg] = 0

        def flaky(real=real, pkg=pkg):
            calls[pkg] += 1
            if calls[pkg] == 1:
                return {"status": "aborted", "reason": "racing writer"}
            return real()

        monkeypatch.setattr(d, "_compact_once", flaky)
    seq = _step_both(ds, dirs, [lambda d: d.tick()])
    assert seq[0][0] == "pass" and seq[0][1]["preemptions"] == 0
    assert calls == {"ref": 2, "port": 2}


def test_paused_when_worker_health_hot_resumes_when_calm(stores):
    dirs = stores(5)
    health = {"brownout_max": 1, "exceed_max": 0.0}
    ds = _daemons(dirs, cooldown_s=5.0, health=lambda: dict(health))
    assert _step_both(ds, dirs, [lambda d: d.tick(), _amp]) == [
        ("paused", _stats(ds["port"])), (5, _stats(ds["port"]))]
    health.update(brownout_max=0, exceed_max=0.2)
    seq = _step_both(ds, dirs, [lambda d: (_resume_now(d), d.tick())[1]])
    assert seq[0][0] == "paused" and seq[0][1]["paused"] == 2
    health.update(exceed_max=0.0)
    seq = _step_both(ds, dirs, [lambda d: (_resume_now(d), d.tick())[1],
                                _amp])
    assert [s[0] for s in seq] == ["pass", 1]


def test_health_turning_hot_aborts_a_pass_mid_run(stores, monkeypatch):
    """A real pass whose health goes hot after the pre-pass gate aborts
    between chunks through ``cancel`` (store untouched, no temps) and the
    tick reports a pause."""
    dirs = stores(5)
    ds = {}
    for pkg, (mod, _reg) in PKGS.items():
        calls = {"n": 0}

        def health(calls=calls):
            calls["n"] += 1
            return {"brownout_max": 0 if calls["n"] == 1 else 2,
                    "exceed_max": 0.0}

        d = mod.MaintenanceDaemon(dirs[pkg], health=health, high=4, low=2,
                                  cooldown_s=1.0, retries=0,
                                  log=lambda m: None)
        monkeypatch.setattr(d, "HEALTH_TTL_S", 0.0)
        ds[pkg] = d
    before = _files(dirs["port"])
    seq = _step_both(ds, dirs, [lambda d: d.tick()])
    assert seq[0][0] == "paused"
    assert seq[0][1]["paused"] == 1 and seq[0][1]["preemptions"] == 1
    assert _files(dirs["port"]) == before


def test_stop_cancels_a_pass_between_chunks(stores, monkeypatch):
    """``stop()`` sets the flag the pass's ``cancel`` observes: a pass in
    flight aborts cleanly."""
    from annotatedvdb_tpu_torch.store import compact

    dirs = stores(5)
    d = maintenance.MaintenanceDaemon(dirs["port"], high=4, low=2,
                                      cooldown_s=0.0, log=lambda m: None)
    real = compact._merge_label_to_temp

    def merge_then_stop(*a, **kw):
        d._stop.set()
        return real(*a, **kw)

    monkeypatch.setattr(compact, "_merge_label_to_temp", merge_then_stop)
    before = _files(dirs["port"])
    assert d.tick() == "preempted"
    assert _files(dirs["port"]) == before
    assert not [n for n in os.listdir(dirs["port"])
                if compact.is_compact_tmp(n)]


def test_daemon_disables_after_consecutive_hard_failures(stores,
                                                         monkeypatch):
    dirs = stores(5)
    ds = _daemons(dirs, retries=0)

    def boom():
        raise OSError("disk on fire")

    for d in ds.values():
        monkeypatch.setattr(d, "_compact_once", boom)
    n = maintenance.MaintenanceDaemon.MAX_CONSEC_FAILURES
    assert n == ref_maintenance.MaintenanceDaemon.MAX_CONSEC_FAILURES
    seq = _step_both(ds, dirs, [lambda d: (_resume_now(d), d.tick())[1]]
                     * n + [lambda d: d.tick()])
    assert [s[0] for s in seq] == ["failed"] * n + ["disabled"]
    assert seq[-1][1]["disabled"] is True and seq[-1][1]["failures"] == n
    assert ds["port"].logs == ds["ref"].logs
    assert any("DISABLED" in m for m in ds["port"].logs)


def test_tick_error_backs_off_and_never_raises(tmp_path):
    """An unreadable manifest is a tick error: logged, backed off."""
    for mod, _reg in PKGS.values():
        d = mod.MaintenanceDaemon(str(tmp_path / "none"), cooldown_s=3.0,
                                  log=lambda m: None)
        assert d.tick() == "error"
        assert d.tick() == "cooldown"
        assert round(d.stats()["backoff_s"]) == 3


def test_daemon_metrics_and_logs_match_reference(stores):
    dirs = stores(4)
    regs = {pkg: reg() for pkg, (_mod, reg) in PKGS.items()}
    ds = {}
    for pkg, (mod, _reg) in PKGS.items():
        logs = []
        ds[pkg] = mod.MaintenanceDaemon(dirs[pkg], high=4, low=2,
                                        cooldown_s=0.0, registry=regs[pkg],
                                        log=logs.append)
        ds[pkg].logs = logs
    _step_both(ds, dirs, [lambda d: d.tick()])
    text = regs["port"].render_prometheus()
    for line in ("avdb_maintain_passes_total 1",
                 "avdb_maintain_preemptions_total 0",
                 "avdb_maintain_paused_total 0",
                 "avdb_maintain_failures_total 0",
                 "avdb_compact_passes_total 1"):
        assert line in text
    # the logs agree up to the pass's own seconds
    strip = [re.sub(r"[0-9.]+s$", "", m) for m in ds["port"].logs]
    assert strip == [re.sub(r"[0-9.]+s$", "", m) for m in ds["ref"].logs]


def test_env_knobs_match_reference(monkeypatch):
    readers = ("segments_high_from_env", "segments_low_from_env",
               "tick_from_env", "cooldown_from_env",
               "maintain_enabled_from_env")
    for env in ({}, {"AVDB_MAINTAIN_SEGMENTS_HIGH": "1",
                     "AVDB_MAINTAIN_SEGMENTS_LOW": "0",
                     "AVDB_MAINTAIN_TICK_S": "0.001",
                     "AVDB_MAINTAIN_COOLDOWN_S": "-4", "AVDB_MAINTAIN": "1"},
                {"AVDB_MAINTAIN_TICK_S": "3.5", "AVDB_MAINTAIN": "false"}):
        for k in ("AVDB_MAINTAIN_SEGMENTS_HIGH", "AVDB_MAINTAIN_SEGMENTS_LOW",
                  "AVDB_MAINTAIN_TICK_S", "AVDB_MAINTAIN_COOLDOWN_S",
                  "AVDB_MAINTAIN"):
            monkeypatch.delenv(k, raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        assert [getattr(maintenance, r)() for r in readers] \
            == [getattr(ref_maintenance, r)() for r in readers]
    monkeypatch.setenv("AVDB_MAINTAIN_TICK_S", "soon")
    with pytest.raises(ValueError, match="AVDB_MAINTAIN_TICK_S"):
        maintenance.tick_from_env()


# ---------------------------------------------------------------------------
# retry_preempted


def _runner(reports):
    calls = {"n": 0}

    def run():
        calls["n"] += 1
        r = reports[min(calls["n"], len(reports)) - 1]
        if isinstance(r, Exception):
            raise r
        return r
    return run, calls


@pytest.mark.parametrize("reports,retries,want_status,want_calls", [
    ([{"status": "compacted"}], 3, "compacted", 1),
    ([{"status": "aborted", "reason": "busy"}], 2, "aborted", 3),
    ([{"status": "aborted"}, {"status": "compacted"}], 5, "compacted", 2),
    ([{"status": "noop"}], 5, "noop", 1),
])
def test_retry_preempted_matches_reference(reports, retries, want_status,
                                           want_calls):
    for fn in (retry.retry_preempted, ref_retry.retry_preempted):
        run, calls = _runner(reports)
        logs = []
        report = fn(run, retries=retries, base_delay=0.0, log=logs.append)
        assert report["status"] == want_status
        assert calls["n"] == want_calls
        assert len(logs) == want_calls - 1


def test_retry_preempted_never_retries_hard_failures_or_own_cancel():
    run, calls = _runner([OSError("hard")])
    with pytest.raises(OSError):
        retry.retry_preempted(run, retries=5)
    assert calls["n"] == 1
    run, calls = _runner([{"status": "aborted", "reason": "SIGTERM"}])
    report = retry.retry_preempted(run, retries=5, base_delay=0.0,
                                   cancel=lambda: True)
    assert report["status"] == "aborted" and calls["n"] == 1


# ---------------------------------------------------------------------------
# the serve CLI and the fleet


def _serve_rc(main, argv, capsys):
    rc = main(argv)
    return rc, capsys.readouterr().err


@pytest.mark.parametrize("argv,env", [
    (["--frontend", "threaded", "--maintain"], {}),
    (["--frontend", "threaded"], {"AVDB_MAINTAIN": "1"}),
    (["--follow", "http://127.0.0.1:9", "--maintain"], {}),
    (["--follow", "http://127.0.0.1:9", "--upserts"], {}),
    (["--follow", "http://127.0.0.1:9"], {"AVDB_SERVE_UPSERTS": "1"}),
])
def test_maintain_and_follow_refusals_match_reference(tmp_path, capsys,
                                                      monkeypatch, argv,
                                                      env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    args = ["--storeDir", str(tmp_path), "--port", "0", *argv]
    want = _serve_rc(ref_serve_cli.main, args, capsys)
    got = _serve_rc(serve_cli.main, args + ["--platform", "cpu"], capsys)
    assert got == want
    assert got[0] == 2


@pytest.mark.parametrize("knob", ["AVDB_MAINTAIN_SEGMENTS_HIGH",
                                  "AVDB_MAINTAIN_SEGMENTS_LOW",
                                  "AVDB_MAINTAIN_TICK_S",
                                  "AVDB_MAINTAIN_COOLDOWN_S"])
def test_bad_knob_fails_fleet_startup(tmp_path, capsys, monkeypatch, knob):
    monkeypatch.setenv(knob, "banana")
    with pytest.raises(ValueError, match=knob):
        fleet.ServeFleet(str(tmp_path), port=0, workers=1, maintain=True)
    with pytest.raises(ValueError, match=knob):
        ref_fleet.ServeFleet(str(tmp_path), port=0, workers=1, maintain=True)
    args = ["--storeDir", str(tmp_path), "--port", "0", "--maintain"]
    want = _serve_rc(ref_serve_cli.main, args, capsys)
    got = _serve_rc(serve_cli.main, args + ["--platform", "cpu"], capsys)
    assert got == want and got[0] == 1


def test_daemon_that_fails_to_start_is_logged_and_skipped(tmp_path,
                                                          monkeypatch):
    logs = []
    f = fleet.ServeFleet(str(tmp_path), port=0, workers=1, maintain=True,
                         log=logs.append)
    try:
        def broken(*a, **kw):
            raise RuntimeError("no thread for you")

        monkeypatch.setattr(maintenance, "MaintenanceDaemon", broken)
        assert f._start_maintenance() is None
        assert logs == ["maintain: daemon failed to start (RuntimeError: "
                        "no thread for you); fleet serves without "
                        "autonomous maintenance"]
        monkeypatch.undo()
        daemon = f._start_maintenance()
        assert daemon is not None
        daemon.stop()
        assert logs[-1].startswith("maintain: daemon armed (high 8 / low 2")
    finally:
        f._reserve.close()
        f._hb_mm.close()
        os.unlink(f._hb_path)


def _get(port, path, body=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=None if body is None else json.dumps(body).encode(),
        method="GET" if body is None else "POST")
    with urllib.request.urlopen(req, timeout=20) as r:
        return r.status, r.read()


def test_maintain_fleet_compacts_while_serving(tmp_path):
    """``serve --maintain`` (one worker) under a 120 s deadline, its
    process group killed at the end: once the worker serves a store one
    segment file below the high watermark, a loader commit trips the
    watermark; the supervisor's daemon compacts the group while the
    worker serves, the worker swaps onto the compacted generation, and
    its region bodies over the old rows are the ones it served before
    (generation masked)."""
    store_dir = str(tmp_path / "s")
    _append_segments(store_dir, 4)
    env = dict(os.environ, AVDB_MAINTAIN_SEGMENTS_HIGH="5",
               AVDB_MAINTAIN_TICK_S="0.2", AVDB_SERVE_SNAPSHOT_TTL_MS="50",
               JAX_PLATFORMS="cpu")
    err_path = str(tmp_path / "err")
    with open(err_path, "w") as err_f:
        proc = subprocess.Popen(
            [sys.executable, "-m", "annotatedvdb_tpu_torch", "serve",
             "--storeDir", store_dir, "--port", "0", "--maintain",
             "--platform", "cpu"],
            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=err_f,
            text=True, start_new_session=True)
    deadline = time.monotonic() + 120

    def wait(test):
        while not test():
            assert time.monotonic() < deadline, open(err_path).read()
            time.sleep(0.1)

    try:
        banner = proc.stdout.readline()
        port = int(re.search(r":(\d+) with 1 workers", banner).group(1))
        specs = {"regions": ["6:1-100000", "6:100000-200000"], "limit": 5}

        def regions():
            st, raw = _get(port, "/regions", specs)
            assert st == 200
            return re.sub(rb'"generation":\d+', b"", raw)

        def generation():
            try:
                return json.loads(_get(port, "/healthz")[1])["generation"]
            except OSError:
                return 0

        wait(lambda: generation() == 1)
        before = regions()
        # a loader commit far from the read windows: the fifth file
        _append_segments(store_dir, 1, n=50, base=9_000_000, salt=7,
                         alt=84)
        mpath = os.path.join(store_dir, "manifest.json")
        wait(lambda: json.load(open(mpath))["stats"]["segments"]["6"] == 1)
        # no request reaches the worker until the daemon has logged its
        # pass: the manifest commit lands before that line (gc and the
        # ledger record come between), and a request in that window
        # would swap the worker before the line the check below reads
        wait(lambda: "pass merged" in open(err_path).read())

        def swapped_after_pass():
            # the worker's swap onto the compacted generation is the first
            # one it logs after the pass (its requests poll the manifest)
            generation()
            err = open(err_path).read()
            return "snapshot swapped" in err.split("pass merged", 1)[-1] \
                and "pass merged" in err

        wait(swapped_after_pass)
        assert regions() == before
    finally:
        os.killpg(proc.pid, signal.SIGTERM)
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    err = open(err_path).read()
    assert proc.returncode == 0, err
    assert "maintain: daemon armed (high 5 / low 2" in err
    assert "maintain: pass merged 5 -> 1 segment file(s)" in err
    assert [r["type"] for r in map(json.loads, open(os.path.join(
        store_dir, "ledger.jsonl")))].count("compact") == 1
