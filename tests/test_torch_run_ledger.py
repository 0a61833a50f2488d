"""The run ledger and the loaders' telemetry flags, through the CLIs: the
PyTorch port against the JAX package, on the CPU.

Every CLI the reference wraps in an ``ObsSession`` (``load-vcf``,
``load-vep``, ``update-qc``, ``load-snpeff-lof``, ``update-annotation``,
``load-cadd`` and ``export``) runs in both packages, in a working
directory of its own with the same relative paths, the same inputs and
the same flags (the port also gets ``--platform cpu``), first to
completion and then to an abort: ``--failAt`` for ``load-vcf``, an
``AVDB_FAULT=ledger.append:N:raise`` for the others (armed through each
package's own ``faults.reset``).  Each appends one ``type: "run"`` record
to the store's ``ledger.jsonl``; the two packages' records must be equal
with exactly the clock fields masked (``ts``, ``wall_seconds``,
``throughput_per_sec``, every ``stages.*.seconds`` and every
``queue_stalls`` value): ``params``, ``config_hash`` (which hashes the
relative store path), ``counters``, ``status``, ``error_class``,
``error``, ``script`` and ``input`` compare exactly.  The ``--metricsOut``
textfiles have the same series names and labels, and every series that
is not a clock has the same value.  ``load-vcf --traceOut`` writes a
well-formed trace with a track per pipeline thread.  ``doctor status``
counts the same load runs on both stores, and ``doctor --deep`` on a
damaged copy of each prescribes the same reloads.  An ``AVDB_FAULT`` that
lands on the run record's own append costs the record and nothing else:
the load exits 0 and prints ``obs: run-ledger append failed``, in both.
"""

import json
import os
import re
import shutil
import sys

import numpy as np
import pytest

from annotatedvdb_tpu.__main__ import main as ref_cli
from annotatedvdb_tpu.store.fsck import fsck as ref_fsck
from annotatedvdb_tpu.utils import faults as ref_faults

from annotatedvdb_tpu_torch.__main__ import main as port_cli
from annotatedvdb_tpu_torch.store.fsck import fsck as port_fsck
from annotatedvdb_tpu_torch.utils import faults
from test_torch_obs import check_trace_events

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke as smoke  # noqa: E402

N_LINES = 600
BATCH = "128"
CLOCK_FIELDS = ("ts", "wall_seconds", "throughput_per_sec")
#: the clocks in the export summary, which is the export's counters
EXPORT_CLOCKS = ("seconds", "tokens_per_sec", "device_idle_frac")
#: textfile series whose values are clocks (or, for the queue high-water
#: mark, a queue_stalls value): their names and labels are compared, their
#: values are not
CLOCK_SERIES = re.compile(
    r"seconds|tokens_per_sec|idle_frac|avdb_queue_max_depth")
#: the one series that exists only where its clock is positive (a stage's
#: busy seconds for the file, which ``LoadObserver`` skips at 0): its
#: stages are held to the run record's instead
STAGE_SECONDS = "avdb_load_stage_seconds{"

#: (command, its flags after the common ones, the run record's script)
COMPLETED = [
    ("load-vcf", ["--fileName", "in.vcf", "--commitAfter", BATCH,
                  "--maxWorkers", "off"], "load-vcf"),
    ("load-vep", ["--fileName", "in.vep.json", "--maxWorkers", "off"],
     "load-vep"),
    ("update-qc", ["--fileName", "in.qc.vcf", "--version", "r4"],
     "update-qc"),
    ("load-snpeff-lof", ["--fileName", "in.snpeff.vcf"], "load-snpeff-lof"),
    ("update-annotation", ["--fileName", "in.annotation.tsv"],
     "update-variant-annotation"),
    ("load-cadd", ["--databaseDir", "cadd", "--maxWorkers", "off"],
     "load-cadd"),
    ("export", ["--out", "corpus", "--maxWorkers", "off", "--batchRows",
                "256"], "export"),
]


def _mask(rec: dict) -> dict:
    rec = {k: v for k, v in rec.items() if k not in CLOCK_FIELDS}
    if rec["script"] == "export" and rec["counters"]:
        # the export's counters are its summary, which carries clocks of
        # its own (the reference hands it to the session as is)
        rec["counters"] = {k: (None if k in EXPORT_CLOCKS else v)
                           for k, v in rec["counters"].items()}
        rec["counters"]["queue_stalls"] = {
            b: dict.fromkeys(v)
            for b, v in rec["counters"]["queue_stalls"].items()}
        # and the plan signature, which hashes the store's manifest and
        # with it the store's random ``store_uid``
        rec["counters"]["plan_sig"] = None
        rec["counters"]["parts"] = [dict(p, plan_sig=None)
                                    for p in rec["counters"]["parts"]]
    if "stages" in rec:
        rec["stages"] = {name: {k: (None if k == "seconds" else v)
                                for k, v in st.items()}
                         for name, st in rec["stages"].items()}
    if "queue_stalls" in rec:
        rec["queue_stalls"] = {b: dict.fromkeys(v)
                               for b, v in rec["queue_stalls"].items()}
    return rec


def run_records(store_dir) -> list:
    with open(os.path.join(store_dir, "ledger.jsonl")) as f:
        recs = [json.loads(line) for line in f if line.strip()]
    return [r for r in recs if r.get("type") == "run"]


def series(path) -> dict:
    """A Prometheus textfile as {series (name and labels): value}."""
    out = {}
    with open(path) as f:
        for line in f:
            if line.strip() and not line.startswith("#"):
                key, value = line.rsplit(" ", 1)
                out[key] = value.strip()
    return out


def _write_inputs(src) -> dict:
    """The seeded inputs every run reads: a chr22 VCF (and a second one
    at odd positions, the aborted load's), VEP results, the three update
    files and the two CADD tables over the VCF's span."""
    os.makedirs(src, exist_ok=True)
    rng = np.random.default_rng(19)
    pos = 16_000_000 + 2 * np.cumsum(rng.integers(1, 13, N_LINES))
    lines, _rows = smoke.vcf_lines(19, N_LINES, pos.tolist())
    with open(os.path.join(src, "in.vcf"), "w") as fh:
        fh.write(smoke.HEADER)
        fh.writelines(lines[:5])
        fh.write("22\tnot_a_pos\t.\tA\tC\t.\t.\t.\n")  # a quarantined line
        fh.writelines(lines[5:])
    abort_lines, _ = smoke.vcf_lines(20, 400, (pos[:400] + 1).tolist())
    with open(os.path.join(src, "abort.vcf"), "w") as fh:
        fh.write(smoke.HEADER)
        fh.writelines(abort_lines)
    # --failAt names a row by its metaseq id (the tokenizer's variant_id)
    fail_at = next(":".join(f[:2] + f[3:5]) for f in (
        ln.split("\t") for ln in abort_lines[300:])
        if f[4] != "." and "," not in f[4])
    smoke.write_vep_json(os.path.join(src, "in.vep.json"), lines, 240, 19, 2)
    smoke.write_update_inputs(os.path.join(src, "in"), {
        "qc": (lines, 200), "lof": (lines, 200), "tsv": (lines, 120)}, 19)
    smoke.write_cadd_tables(os.path.join(src, "cadd"),
                            smoke.vcf_sites(lines),
                            {"22": (16_000_000, int(pos[-1]) - 40)},
                            seed=19, block_rows=64)
    return {"fail_at": fail_at}


def _cli(tag, argv) -> int:
    if tag == "port":
        return port_cli([*argv, "--platform", "cpu"])
    return ref_cli(argv)


def _aborts(fail_at) -> list:
    """(command, flags, AVDB_FAULT spec or None, expected error class).
    The second ledger append is a loader's first checkpoint (or its
    finish); the export's first is its invocation record."""
    fault = "ledger.append:2:raise"
    return [
        ("load-vcf", ["--fileName", "abort.vcf", "--commitAfter", "64",
                      "--failAt", fail_at, "--maxWorkers", "off"], None,
         "RuntimeError"),
        ("load-vep", ["--fileName", "in.vep.json", "--maxWorkers", "off"],
         fault, "InjectedFault"),
        ("update-qc", ["--fileName", "in.qc.vcf", "--version", "r5"], fault,
         "InjectedFault"),
        ("load-snpeff-lof", ["--fileName", "in.snpeff.vcf",
                             "--updateExisting"], fault, "InjectedFault"),
        ("update-annotation", ["--fileName", "in.annotation.tsv",
                               "--datasource", "NIAGADS"], fault,
         "InjectedFault"),
        ("load-cadd", ["--databaseDir", "cadd", "--updateExisting",
                       "--maxWorkers", "off"], fault, "InjectedFault"),
        ("export", ["--out", "corpus2", "--maxWorkers", "off", "--batchRows",
                    "256"], "ledger.append:1:raise", "InjectedFault"),
    ]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages' runs: every command to completion, then every
    command to an abort.  Each package runs in the same absolute working
    directory (moved aside after its turn), so the paths an export records
    (``out``, and ``plan_sig``, which hashes it) are the same too.
    Returns the moved directories and what each abort raised."""
    base = tmp_path_factory.mktemp("runs")
    src = str(base / "src")
    meta = _write_inputs(src)
    work = str(base / "work")
    cwd = os.getcwd()
    dirs, raised = {}, {"ref": [], "port": []}
    try:
        for tag in ("ref", "port"):
            shutil.copytree(src, work)
            os.chdir(work)
            for cmd, flags, _script in COMPLETED:
                argv = [cmd, "--storeDir", "vdb", "--commit", *flags,
                        "--metricsOut", f"{cmd}.prom",
                        "--traceOut", f"{cmd}.trace.json"]
                assert _cli(tag, argv) == 0, (tag, cmd)
            for cmd, flags, spec, _cls in _aborts(meta["fail_at"]):
                mod = ref_faults if tag == "ref" else faults
                mod.reset(spec or "")
                try:
                    _cli(tag, [cmd, "--storeDir", "vdb", "--commit", *flags,
                               "--metricsOut", f"{cmd}.abort.prom"])
                    raised[tag].append(None)
                except Exception as exc:  # the CLI re-raises the abort
                    raised[tag].append((type(exc).__name__, str(exc)))
                finally:
                    mod.reset("")
            os.chdir(cwd)
            dirs[tag] = str(base / tag)
            os.rename(work, dirs[tag])
    finally:
        os.chdir(cwd)
    return {"dirs": dirs, "raised": raised, **meta}


def test_every_cli_appends_the_reference_run_records(runs):
    recs = {tag: run_records(os.path.join(d, "vdb"))
            for tag, d in runs["dirs"].items()}
    n = len(COMPLETED)
    assert len(recs["ref"]) == 2 * n
    assert [_mask(r) for r in recs["port"]] == [_mask(r) for r in recs["ref"]]
    port = recs["port"]
    assert [r["script"] for r in port] == [s for _c, _f, s in COMPLETED] * 2
    assert [r["status"] for r in port] == ["completed"] * n + ["aborted"] * n
    assert [r.get("error_class") for r in port[n:]] == [
        c for *_x, c in _aborts(runs["fail_at"])]
    assert port[0]["params"]["store"] == "vdb"
    assert port[0]["input"] == "in.vcf"
    assert port[0]["counters"]["rejected"] == 1
    assert "failAt variant reached" in port[n]["error"]
    assert port[n]["counters"]["variant"] > 0  # chunks before the abort
    for r in port:
        for k in ("stages", "queue_stalls"):
            for v in r.get(k, {}).values():
                assert set(v) <= {"seconds", "items", "producer_block_s",
                                  "consumer_wait_s", "max_depth"}


def test_aborts_raise_the_reference_errors(runs):
    assert runs["raised"]["port"] == runs["raised"]["ref"]
    assert [r[0] for r in runs["raised"]["port"]] == [
        c for *_x, c in _aborts(runs["fail_at"])]


@pytest.mark.parametrize("cmd", [c for c, _f, _s in COMPLETED] + [
    f"{c}.abort" for c, _f, _s in COMPLETED])
def test_metrics_textfiles_match_reference(runs, cmd):
    got = {tag: series(os.path.join(d, f"{cmd}.prom"))
           for tag, d in runs["dirs"].items()}
    names = {tag: sorted(k for k in g if not k.startswith(STAGE_SECONDS))
             for tag, g in got.items()}
    assert names["port"] == names["ref"]
    stages = {k.split('stage="')[1].split('"')[0]
              for k in got["port"] if k.startswith(STAGE_SECONDS)}
    if cmd == "load-vcf":
        rec = run_records(os.path.join(runs["dirs"]["port"], "vdb"))[0]
        assert stages and stages <= set(rec["stages"])
    plain = {k: v for k, v in got["ref"].items() if not CLOCK_SERIES.search(k)}
    assert {k: got["port"][k] for k in plain} == plain
    snaps = {}
    for tag, d in runs["dirs"].items():
        with open(os.path.join(d, f"{cmd}.prom.json")) as f:
            snaps[tag] = json.load(f)
    assert sorted(snaps["port"]) == sorted(snaps["ref"])
    if cmd == "load-vcf":
        rec = run_records(os.path.join(runs["dirs"]["port"], "vdb"))[0]
        want = rec["counters"]["variant"]
        assert got["port"]['avdb_load_variant_total{loader="load-vcf"}'] \
            == str(want)
        assert int(got["port"]['avdb_chunk_rows_count{loader="load-vcf"}']) \
            == int(got["port"]['avdb_chunks_total{loader="load-vcf"}']) >= 4
    if not cmd.endswith(".abort"):
        assert any(k.startswith("avdb_store_rows_total") for k in got["port"])


def test_load_vcf_trace_has_a_track_per_pipeline_thread(runs):
    """A track per pipeline thread, the stage spans, and one queue-depth
    sample a consumed chunk, as in the reference's trace."""
    depths = {}
    for tag, d in runs["dirs"].items():
        with open(os.path.join(d, "load-vcf.trace.json")) as f:
            doc = json.load(f)
        evs = doc["traceEvents"]
        check_trace_events(evs)
        tracks = {e["args"]["name"] for e in evs
                  if e["ph"] == "M" and e["name"] == "thread_name"}
        assert len(tracks) >= 4, (tag, tracks)
        spans = {e["name"] for e in evs if e["ph"] == "B"}
        assert {"load", "ingest", "dispatch", "annotate", "persist"} <= spans
        depths[tag] = [sorted(e["args"]) for e in evs
                       if e["ph"] == "C" and e["name"] == "queue_depth"]
    assert depths["port"] == depths["ref"] and len(depths["port"]) >= 5
    for cmd, _f, _s in COMPLETED[1:]:
        with open(os.path.join(runs["dirs"]["port"],
                               f"{cmd}.trace.json")) as f:
            check_trace_events(json.load(f)["traceEvents"])


def test_doctor_status_counts_the_same_load_runs(runs, capsys):
    counts = {}
    for tag, d in runs["dirs"].items():
        for pkg, cli in (("ref", ref_cli), ("port", port_cli)):
            assert cli(["doctor", "status", "--storeDir",
                        os.path.join(d, "vdb"), "--json"]) == 0
            report = json.loads(capsys.readouterr().out)
            counts[tag, pkg] = report["ledger"]["runs"]
    assert set(counts.values()) == {2 * len(COMPLETED)}, counts


def test_doctor_deep_prescribes_the_same_reloads(runs, tmp_path):
    """A damaged copy of each store: ``fsck --deep`` of each package
    names the same reload commands, one per loaded input, newest first."""
    hints = {}
    for tag, d in runs["dirs"].items():
        store = str(tmp_path / tag)
        shutil.copytree(os.path.join(d, "vdb"), store)
        with open(os.path.join(store, "manifest.json")) as f:
            manifest = json.load(f)
        seg = sorted(n for n in os.listdir(store)
                     if n.endswith(".seg") or n.endswith(".npz"))
        assert seg, os.listdir(store)
        with open(os.path.join(store, seg[0]), "r+b") as f:
            f.truncate(16)
        for pkg, fn in (("ref", ref_fsck), ("port", port_fsck)):
            report = fn(store, deep=True, log=lambda m: None)
            hints[tag, pkg] = [
                f["message"].replace(store, "<store>")
                for f in report["findings"] if f["code"] == "reload-hint"]
        assert manifest
    first = hints["ref", "ref"]
    assert first and all(h == first for h in hints.values()), hints
    assert any("--fileName in.vcf" in h for h in first)
    assert any("update_qc --fileName in.qc.vcf" in h and "--version r5" in h
               for h in first)


def test_a_fault_on_the_run_record_costs_only_the_record(runs, tmp_path,
                                                         capsys):
    """``AVDB_FAULT=ledger.append:N`` with N the run record's append:
    both CLIs exit 0, print ``obs: run-ledger append failed``, and leave
    the same ledger with no run record."""
    ledgers = {}
    for tag in ("ref", "port"):
        d = tmp_path / tag
        d.mkdir()
        shutil.copy(os.path.join(runs["dirs"][tag], "in.vcf"), d / "in.vcf")
        cwd = os.getcwd()
        os.chdir(d)
        mod = ref_faults if tag == "ref" else faults
        try:
            # invocation + 5 checkpoints + finish, then the run record
            mod.reset("ledger.append:8:raise")
            assert _cli(tag, ["load-vcf", "--fileName", "in.vcf",
                              "--storeDir", "vdb", "--commit",
                              "--commitAfter", BATCH, "--maxWorkers",
                              "off"]) == 0
            assert mod.fired() == {"ledger.append": 1}
        finally:
            mod.reset("")
            os.chdir(cwd)
        assert "obs: run-ledger append failed (injected fault at " \
               "ledger.append" in capsys.readouterr().err
        with open(d / "vdb" / "ledger.jsonl") as f:
            recs = [json.loads(line) for line in f]
        ledgers[tag] = [{k: v for k, v in r.items() if k != "ts"}
                        for r in recs]
    assert ledgers["port"] == ledgers["ref"]
    assert [r["type"] for r in ledgers["port"]] == (
        ["invocation"] + ["checkpoint"] * 5 + ["finish"])


class _Parsed(Exception):
    pass


def _option_strings(module) -> set:
    """The option strings of the parser ``module.main`` builds (its
    ``parse_args`` intercepted before anything runs)."""
    import argparse
    import importlib

    got = {}

    def capture(parser, *_a, **_k):
        got["parser"] = parser
        raise _Parsed

    real = argparse.ArgumentParser.parse_args
    argparse.ArgumentParser.parse_args = capture
    try:
        with pytest.raises(_Parsed):
            importlib.import_module(module).main([])
    finally:
        argparse.ArgumentParser.parse_args = real
    return {s for a in got["parser"]._actions for s in a.option_strings}


@pytest.mark.parametrize("cli", [
    "load_vcf", "load_vep", "update_qc", "load_snpeff_lof",
    "update_variant_annotation", "load_cadd", "export_corpus", "serve"])
def test_cli_option_sets_equal_the_reference(cli):
    """Each port CLI takes the reference CLI's options; the one addition
    is ``--platform`` (``cuda`` by default, ``cpu`` on request) where the
    reference pins its platform itself."""
    ref = _option_strings(f"annotatedvdb_tpu.cli.{cli}")
    port = _option_strings(f"annotatedvdb_tpu_torch.cli.{cli}")
    assert port - {"--platform"} == ref - {"--platform"}
    assert "--platform" in port
    assert {"--metricsOut", "--traceOut"} <= port
    assert ("--profile" in port) == (cli == "load_vcf")
