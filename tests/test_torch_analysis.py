"""The port's static analyser (``annotatedvdb_tpu_torch/analysis``) against
the JAX package's (``annotatedvdb_tpu/analysis``), on the CPU.

- The language-level rule families (hygiene, lock discipline, async
  safety, registry drift, front-end parity, durability, stale
  suppressions) run over the reference's own fixtures
  (``tests/data/analysis_fixtures``) in both analysers, the port's with
  the reference's layout: the same ``(code, path, line, message)`` list.
- The families whose subject is the port's own (capture safety, env
  drift, the CLI contract, the kernel/plain-version registry) run over the
  reference's fixtures respelled line for line for the port
  (``tests/data/torch_analysis_fixtures``): the same ``(code, line)``
  pairs as the reference's analyser on its originals.
- ``python -m annotatedvdb_tpu_torch.analysis`` over the port's default
  paths exits 0 within 20 s in a process that cannot import ``jax``,
  ``annotatedvdb_tpu``, ``torch`` or ``numpy``; ``--json``, ``--diff`` and
  the exit codes.
- The port's registries: ``runtime.ENV_VARS`` against the reference's
  ``config.ENV_VARS``, the CLI rule's lifecycle table against
  ``config.add_lifecycle_args``, ``ops.TWINS`` against the modules.
"""

import importlib
import json
import os
import re
import subprocess
import sys
import time

import pytest

from annotatedvdb_tpu.analysis import run_paths as ref_run_paths
from annotatedvdb_tpu.analysis.rules_cli import (
    extract_registrars as ref_extract_registrars,
)

from annotatedvdb_tpu_torch.analysis import run_paths
from annotatedvdb_tpu_torch.analysis.core import (
    LAYOUTS,
    PORT,
    REFERENCE,
    find_repo_root,
)
from annotatedvdb_tpu_torch.analysis.rules_cli import LIFECYCLE_FLAGS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_FIXTURES = os.path.join(REPO, "tests", "data", "analysis_fixtures")
FIXTURES = os.path.join(REPO, "tests", "data", "torch_analysis_fixtures")
_EXPECT_RE = re.compile(r"#\s*EXPECT:\s*([A-Z0-9,\s]+)")
REF = REFERENCE.package


def expected_pairs(path):
    """{(line, code)} from a fixture's ``# EXPECT:`` markers."""
    out = set()
    with open(path) as f:
        for i, line in enumerate(f, start=1):
            m = _EXPECT_RE.search(line)
            if m:
                out |= {(i, c.strip()) for c in m.group(1).split(",")
                        if c.strip()}
    return out


def _rows(findings):
    return [(f.code, f.path, f.line, f.message) for f in findings]


def _pairs(findings):
    return {(f.line, f.code) for f in findings}


# ---------------------------------------------------------------------------
# the language-level families on the reference's fixtures, both analysers


#: (fixture, paths scanned inside it, run_paths keywords): whole files,
#: whole trees rooted at themselves, and the single-file and audit-off
#: subsets the reference's own tests pin as silent
LANGUAGE_CASES = [
    ("hygiene_viol.py", None, {}),
    ("lock_viol.py", None, {}),
    ("async_viol.py", None, {}),
    ("registry_viol.py", None, {}),
    ("parity_tree", None, {"tree": True}),
    ("parity_tree", "serve/aio.py", {"tree": True}),
    ("durability_tree", None, {"tree": True}),
    ("durability_tree", "store/bad_writer.py", {"tree": True}),
    ("durability_tree", None, {"tree": True, "audit": False}),
    ("noqa_tree", None, {"tree": True}),
    ("noqa_tree", "pipeline.py", {"tree": True}),
]


@pytest.mark.parametrize(
    "fixture,sub,kw", LANGUAGE_CASES,
    ids=[f"{c[0]}{'-' + c[1] if c[1] else ''}"
         f"{'-noaudit' if c[2].get('audit') is False else ''}"
         for c in LANGUAGE_CASES])
def test_language_families_match_the_reference(fixture, sub, kw):
    base = os.path.join(REF_FIXTURES, fixture)
    path = os.path.join(base, sub) if sub else base
    kw = dict(kw)
    if kw.pop("tree", False):
        kw["root"] = base
    want, n_ref = ref_run_paths([path], **kw)
    got, n_port = run_paths([path], package=REF, **kw)
    assert n_port == n_ref
    assert _rows(got) == _rows(want)
    if sub is None and kw.get("audit", True):
        # the reference's own markers, where the fixture pins the whole run
        files = [path] if os.path.isfile(path) else [
            os.path.join(d, f) for d, _s, fs in os.walk(path)
            for f in fs if f.endswith(".py")]
        marked = {(os.path.abspath(p), line, code) for p in files
                  for line, code in expected_pairs(p)}
        assert marked and {(os.path.abspath(f.path), f.line, f.code)
                           for f in got} == marked


# ---------------------------------------------------------------------------
# the port's own families on the respelled fixtures


@pytest.mark.parametrize("name,loader_cli", [
    ("trace_safety_viol.py", False),
    ("env_viol.py", False),
    ("cli_viol.py", True),
])
def test_port_families_match_the_reference_on_respelled_fixtures(name,
                                                                 loader_cli):
    mine, theirs = os.path.join(FIXTURES, name), os.path.join(REF_FIXTURES, name)
    kw_port = {"loader_clis": (os.path.relpath(mine, REPO),)} \
        if loader_cli else {}
    kw_ref = {"loader_clis": (os.path.relpath(theirs, REPO),)} \
        if loader_cli else {}
    got, n = run_paths([mine], **kw_port)
    want, _n = ref_run_paths([theirs], **kw_ref)
    assert n == 1
    assert _pairs(got) == _pairs(want) == expected_pairs(theirs) \
        == expected_pairs(mine), [f.render() for f in got]


def test_twins_tree_matches_the_reference():
    mine = os.path.join(FIXTURES, "twins_tree")
    theirs = os.path.join(REF_FIXTURES, "twins_tree")
    got, n = run_paths([mine], root=mine)
    want, n_ref = ref_run_paths([theirs], root=theirs)
    assert n == n_ref == 3

    def keyed(findings, base):
        return {(os.path.relpath(f.path, base).replace(
                     "annotatedvdb_tpu_torch", REF), f.line, f.code)
                for f in findings}

    assert keyed(got, mine) == keyed(want, theirs)
    # the registry alone out of the scan: nothing is decidable
    alone, _n = run_paths(
        [os.path.join(mine, PORT.package, "ops", "kernels.py")], root=mine)
    assert [f for f in alone if f.code.startswith("AVDB9")] == []


#: capture spellings beyond the respelled fixture, each with one host call
#: in the captured body (the line of the finding)
CAPTURE_CASES = {
    "script_decorator": ("import torch\n@torch.jit.script\n"
                         "def f(x):\n    print(x)\n    return x\n", 4),
    "compile_call_decorator": ("import torch\n@torch.compile(fullgraph=True)\n"
                               "def f(x):\n    print(x)\n    return x\n", 4),
    "partial_wrap": ("import functools, torch\ndef f(x):\n    print(x)\n"
                     "    return x\ng = functools.partial(torch.compile, "
                     "mode='max-autotune')(f)\n", 3),
    "trace_wrap_nested": ("import torch\ndef build():\n    def step(x):\n"
                          "        print(x)\n        return x\n"
                          "    return torch.jit.trace(step, (1,))\n", 4),
    "cuda_graph": ("import torch\ndef step(x):\n    print(x)\n    return x\n"
                   "def run(g, x):\n    with torch.cuda.graph(g):\n"
                   "        return step(x)\n", 3),
}


@pytest.mark.parametrize("case", sorted(CAPTURE_CASES))
def test_capture_spellings(tmp_path, case):
    src, line = CAPTURE_CASES[case]
    p = tmp_path / "m.py"
    p.write_text(src)
    findings, _n = run_paths([str(p)])
    assert _pairs(findings) == {(line, "AVDB101")}, \
        [f.render() for f in findings]


def test_uncaptured_and_lookalike_calls_are_not_captures(tmp_path):
    p = tmp_path / "m.py"
    p.write_text("import re\ndef f(x):\n    print(x)\n    return x\n"
                 "pat = re.compile(f)\n")
    assert run_paths([str(p)])[0] == []


# ---------------------------------------------------------------------------
# the entry point


def _cli(*args, block=True):
    """``python -m annotatedvdb_tpu_torch.analysis ARGS`` in a fresh
    interpreter; with ``block`` the JAX package, jax, torch and numpy
    cannot be imported there."""
    code = ("import runpy, sys\n"
            + ("".join(f"sys.modules[{m!r}] = None\n" for m in
                       ("jax", "annotatedvdb_tpu", "torch", "numpy"))
               if block else "")
            + "sys.argv = ['avdb-check'] + sys.argv[1:]\n"
            + "runpy.run_module('annotatedvdb_tpu_torch.analysis', "
              "run_name='__main__')\n")
    return subprocess.run([sys.executable, "-c", code, *args],
                          capture_output=True, text=True, cwd=REPO,
                          timeout=300)


def test_default_paths_clean_fast_and_standalone():
    t0 = time.monotonic()
    p = _cli("--json")
    wall = time.monotonic() - t0
    assert p.returncode == 0, p.stdout[-4000:] + p.stderr[-2000:]
    report = json.loads(p.stdout)
    assert report["findings"] == [] and report["exit_code"] == 0
    assert report["files_scanned"] > 150
    assert wall < 20.0, f"analyzer took {wall:.1f}s (budget 20s)"


def test_fixture_exits_one_with_the_json_schema():
    p = _cli("--json", os.path.join(FIXTURES, "trace_safety_viol.py"))
    assert p.returncode == 1, p.stderr
    report = json.loads(p.stdout)
    assert report["version"] == 1 and report["files_scanned"] == 1
    assert report["exit_code"] == 1 and report["findings"]
    for f in report["findings"]:
        assert set(f) == {"code", "path", "line", "message", "hint"}
        assert re.fullmatch(r"AVDB\d{3,4}", f["code"]) and f["hint"]


@pytest.mark.parametrize("args,rc,err", [
    (("--diff", "HEAD", "--json"), 0, ""),
    (("--diff", "no-such-rev-zzz"), 2, "failed"),
    (("--diff", "HEAD", "annotatedvdb_tpu_torch"), 2, "exclusive"),
    (("no/such/path.py",), 2, "no such path"),
])
def test_diff_mode_and_usage_errors(args, rc, err):
    p = _cli(*args, block=False)
    assert p.returncode == rc, p.stdout + p.stderr
    assert err in p.stderr
    if rc == 0:
        assert json.loads(p.stdout)["findings"] == []


def test_repo_root_is_found_by_package():
    here = os.path.join(REPO, "tests", "data")
    assert find_repo_root(here) == find_repo_root(here, REF) == REPO
    tree = os.path.join(FIXTURES, "twins_tree")
    assert find_repo_root(os.path.join(tree, "tests")) == tree
    assert set(LAYOUTS) == {PORT.package, REF}


# ---------------------------------------------------------------------------
# the port's registries against the reference's


#: the reference's variables the port never reads (runtime.py says why)
NOT_READ = {
    "AVDB_BENCH_E2E_RUNS", "AVDB_BENCH_EXPORT_ROWS",
    "AVDB_BENCH_RETRY_REASON", "AVDB_BENCH_ROWS", "AVDB_BENCH_VEP_RUNS",
    "AVDB_CRASH_TEST", "AVDB_SCALE_TEST", "AVDB_JAX_PLATFORM",
    "AVDB_JAX_PLATFORM_SOURCE", "AVDB_PROFILE", "AVDB_TPU_MARKER",
    "AVDB_TPU_MARKER_TTL_S", "AVDB_TPU_PROBE_TIMEOUT_S",
}


def test_env_registry_is_the_references_less_what_the_port_never_reads():
    from annotatedvdb_tpu.config import ENV_VARS as REF_ENV
    from annotatedvdb_tpu_torch.runtime import ENV_VARS

    own = {k for k in ENV_VARS if k.startswith("AVDBC_")}
    assert own == {"AVDBC_VIRTUAL_DEVICES"}
    assert set(ENV_VARS) - own == set(REF_ENV) - NOT_READ
    assert len(ENV_VARS) == 70
    assert all(ENV_VARS[k] == REF_ENV[k] for k in set(ENV_VARS) - own)


def test_lifecycle_table_is_the_reference_registrar():
    import ast

    with open(os.path.join(REPO, REF, "config.py")) as f:
        table = ref_extract_registrars(ast.parse(f.read()))["add_lifecycle_args"]
    keys = ("action", "default", "type")
    assert {flag: {k: v for k, v in spec.items() if k in keys}
            for flag, spec in table.items()} == LIFECYCLE_FLAGS


def test_twins_registry_names_every_wrapper_and_its_plain_version():
    from annotatedvdb_tpu_torch.ops import TWINS

    assert len(TWINS) == 14
    for wrapper, plain in TWINS.items():
        for dotted in (wrapper, plain):
            mod, attr = dotted.rsplit(".", 1)
            module = importlib.import_module(f"{PORT.package}.{mod}")
            assert callable(getattr(module, attr)), dotted
        assert plain == wrapper + "_reference"
