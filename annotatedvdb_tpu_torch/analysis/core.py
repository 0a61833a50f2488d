"""Engine for the project-native static analysis suite (``avdb-check``).

Port of ``annotatedvdb_tpu/analysis/core.py``.  The engine is the
reference's; what it cross-references is a :class:`Layout`: the port's
own registries (``runtime.ENV_VARS``, ``utils/faults.POINTS``,
``ops.TWINS``, the loader CLIs, the flag registrars, the fault-matrix
tests) by default, or the JAX
package's layout (:data:`REFERENCE`), under which the language-level
rule families judge the reference's fixture trees exactly as the
reference's analyser does.

Many of the system's invariants exist only as convention: fault points and
metric names are bare string literals at their call sites, lock-guarded
state is guarded by nothing but code review, and captured device code must
stay free of host side effects.  This package turns each of those
conventions into an AST-level rule with an error code, a one-line fix
hint, and a suppression escape hatch, so drift fails tier-1 instead of
surfacing later as a heisenbug.

Architecture: every analyzed file is parsed once into a :class:`FileContext`
(AST + raw source + per-line ``noqa`` suppressions).  Rules come in two
shapes:

- **per-file** rules (``check(ctx)``) — everything decidable from one
  module (trace-safety, lock-discipline, hygiene);
- **project** rules (``collect(ctx, facts)`` + ``finalize(facts, project)``)
  — cross-file registries (fault points vs ``faults.POINTS``, metric-name
  uniqueness, env-var declarations, the loader-CLI flag contract).

Suppression: ``# avdb: noqa[CODE]`` (comma list allowed) on the flagged
line silences that code there; ``# avdb: noqa`` silences every code on the
line.  Policy (README "Static analysis & code health"): a suppression in
committed code carries a reason after ``--``, e.g.
``# avdb: noqa[AVDB602] -- probe teardown, error surfaced by caller``.

No dependencies beyond the stdlib — the analyzer must run anywhere the
repo's tests run.
"""

from __future__ import annotations

import ast
import glob
import io
import os
import re
import tokenize
from dataclasses import dataclass, field

#: directories never analyzed, by bare name (__pycache__/.git are noise)
SKIP_DIRS = frozenset({"__pycache__", ".git", "node_modules"})

#: directories skipped only at their canonical location: tests/data holds
#: fixture files that contain violations ON PURPOSE.  Matching the bare
#: name anywhere would silently exempt a future package `data/` module
#: from every rule.
_FIXTURE_DATA_PARENT = "tests"

_NOQA_RE = re.compile(
    r"#\s*avdb:\s*noqa(?:\[(?P<codes>[A-Z0-9,\s]+)\])?", re.IGNORECASE
)


@dataclass(frozen=True)
class Finding:
    """One rule violation at a file:line."""

    code: str        # e.g. "AVDB101"
    path: str        # path as given (repo-relative when invoked that way)
    line: int        # 1-based
    message: str     # what is wrong, with the offending name inline
    hint: str        # the one-line fix hint for this rule family

    def render(self) -> str:
        return f"{self.path}:{self.line}: {self.code} {self.message}\n" \
               f"    hint: {self.hint}"

    def as_dict(self) -> dict:
        return {
            "code": self.code, "path": self.path, "line": self.line,
            "message": self.message, "hint": self.hint,
        }


class FileContext:
    """One parsed source file: AST, raw lines, and noqa suppressions."""

    def __init__(self, path: str, source: str):
        self.path = path
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=path)
        #: every node of the tree in ``ast.walk`` order, walked once for
        #: all the rules that scan the whole module
        self.nodes = list(ast.walk(self.tree))
        #: {line_number: set of suppressed codes} — None = all codes.
        #: Collected from COMMENT tokens only (not raw line scans): a noqa
        #: spelled inside a docstring or string literal — this module's own
        #: docstring, the analyzer's fixture strings — is prose, not a
        #: suppression, and must neither suppress nor trip the AVDB604
        #: stale-suppression audit.
        self.noqa: dict[int, set[str] | None] = {}
        if "noqa" in source:
            try:
                for tok in tokenize.generate_tokens(
                    io.StringIO(source).readline
                ):
                    if tok.type != tokenize.COMMENT:
                        continue
                    m = _NOQA_RE.search(tok.string)
                    if not m:
                        continue
                    codes = m.group("codes")
                    if codes:
                        self.noqa[tok.start[0]] = {
                            c.strip().upper()
                            for c in codes.split(",") if c.strip()
                        }
                    else:
                        self.noqa[tok.start[0]] = None  # blanket: every code
            except (tokenize.TokenError, IndentationError):
                pass  # unparseable tail: ast.parse above already raised

    def suppressed(self, line: int, code: str) -> bool:
        if line not in self.noqa:
            return False
        codes = self.noqa[line]
        if codes is None:
            # A blanket noqa covers every code EXCEPT the stale-suppression
            # audit: a suppression must not self-certify.  Silencing a
            # deliberate AVDB604 fixture takes an explicit [AVDB604].
            return code != "AVDB604"
        return code in codes


@dataclass
class ProjectFacts:
    """Cross-file facts accumulated by project rules during the file pass."""

    #: [(path, line, point_literal)] — faults.fire("<point>") call sites
    fault_fires: list = field(default_factory=list)
    #: {name_or_prefix: [MetricReg]} — see rules_registry.MetricReg
    metric_regs: dict = field(default_factory=dict)
    #: [(path, line, var_name)] — AVDB_* environment reads
    env_reads: list = field(default_factory=list)
    #: {var_name} — env vars written (tests arming fixtures); never flagged
    env_writes: set = field(default_factory=set)
    #: {path: FileContext} for files project rules revisit (CLI contract)
    contexts: dict = field(default_factory=dict)
    #: {loader_cli_rel_path: (scanned_path, flag_table, parser_line)} —
    #: the CLI-contract rule's extraction per loader CLI
    cli_tables: dict = field(default_factory=dict)
    #: True when the scan covers the package itself (its env registry
    #: module scanned):
    #: only then do the project-AUDIT codes fire (AVDB302/305/402 —
    #: "registry entry missing from tests/README" is only decidable
    #: against the package, not a fixture subset)
    full_registry_scan: bool = False
    #: True when the scan also covers tests/ — AVDB403 ("declared env var
    #: never read") additionally needs the test tree, where the
    #: AVDB_SCALE_TEST-class gates are read
    tree_scan: bool = False
    #: {front_end_path: {"literals": {value: first_line},
    #:                   "refs": set_of_names}} — the two serve front
    #: ends' parity facts (rules_parity)
    parity: dict = field(default_factory=dict)
    #: [(path, line, "module.attr")] — kernel wrappers discovered under
    #: ops/ and genome/ (rules_twins)
    ops_kernels: list = field(default_factory=list)
    #: True when ops/__init__.py was scanned: only then are the TWINS
    #: audit codes decidable (same gating idea as full_registry_scan)
    twins_scan: bool = False
    #: the scanned ops/__init__.py path (registry findings anchor there)
    twins_registry_path: str = ""
    #: True when store/fsck.py was scanned: only then are the tmp-family
    #: cross-reference codes (AVDB1002/1003) decidable — a --diff subset
    #: must not judge the attribution table it did not scan
    fsck_scan: bool = False
    #: fsck finding-code literals collected from store/fsck.py's note()
    #: calls ("flush-tmp", "compact-tmp", ...)
    fsck_codes: set = field(default_factory=set)
    #: the scanned store/fsck.py path (cross-reference findings anchor)
    fsck_path: str = ""
    #: [(path, line, family)] — writer tmp-suffix families discovered in
    #: store/ string literals (".flush.tmp" -> "flush")
    tmp_suffixes: list = field(default_factory=list)


@dataclass(frozen=True)
class Layout:
    """Where one package keeps the registries the project rules read.
    Paths are relative to the package directory unless named otherwise."""

    package: str                   # the package directory at the repo root
    env_module: str                # module holding the ENV_VARS literal
    registrar_modules: tuple       # modules whose flag registrars are read
    fault_matrix: tuple            # root-relative globs of the fault tests
    env_prefixes: tuple = ("AVDB_",)  # environment names the env rules judge

    def rel(self, *parts: str) -> str:
        """A package path as the findings spell it (``/``-separated)."""
        return "/".join((self.package, *parts))

    @property
    def fault_matrix_label(self) -> str:
        return " / ".join(self.fault_matrix)


#: the loader/export CLIs bound by the shared flag contract (the same
#: modules, package-relative, in both packages)
_CLIS = (
    "cli/load_vcf.py",
    "cli/load_vep.py",
    "cli/load_cadd.py",
    "cli/load_snpeff_lof.py",
    "cli/update_qc.py",
    "cli/update_variant_annotation.py",
    "cli/export_corpus.py",
)

#: the port: ``runtime.py`` stands in for the reference's ``config.py``;
#: the update CLIs take their flags from ``cli/update_common.py``; the
#: fault points are crossed against the reference in
#: ``tests/test_torch_faults*.py``, the fleet's (``serve.wedge``) in
#: ``test_torch_fleet.py`` and the mesh's in ``test_torch_mesh.py``
PORT = Layout(
    package="annotatedvdb_tpu_torch",
    env_module="runtime.py",
    registrar_modules=("obs/session.py", "cli/update_common.py"),
    fault_matrix=("tests/test_torch_faults*.py", "tests/test_torch_fleet.py",
                  "tests/test_torch_mesh.py"),
    env_prefixes=("AVDB_", "AVDBC_"),
)

#: the JAX package's layout: its fixture trees are judged under it
REFERENCE = Layout(
    package="annotatedvdb_tpu",
    env_module="config.py",
    registrar_modules=("config.py", "obs/session.py"),
    fault_matrix=("tests/test_fault_matrix.py",),
)

LAYOUTS = {layout.package: layout for layout in (PORT, REFERENCE)}

#: the package this analyser judges by default
PACKAGE = PORT.package


@dataclass
class Project:
    """Resolved project layout handed to ``finalize`` hooks."""

    root: str                      # repo root (directory holding this pkg)
    readme: str                    # README.md text ("" when absent)
    fault_points: frozenset        # parsed faults.POINTS literal
    fault_matrix_src: str          # the fault-matrix tests' text
    env_declared: dict             # parsed ENV_VARS literal
    loader_clis: tuple             # module paths of the loader CLIs
    flag_registrars: dict          # {helper_name: {flag: spec}}
    twins: dict = field(default_factory=dict)  # parsed ops.TWINS literal
    layout: Layout = PORT          # where the registries above came from


def _read(path: str) -> str:
    try:
        with open(path, encoding="utf-8") as f:
            return f.read()
    except OSError:
        return ""


def find_repo_root(start: str, package: str = PACKAGE) -> str:
    """Nearest ancestor of ``start`` containing ``<package>/``."""
    d = os.path.abspath(start)
    if os.path.isfile(d):
        d = os.path.dirname(d)
    d0 = d
    while True:
        if os.path.isdir(os.path.join(d, package)):
            return d
        parent = os.path.dirname(d)
        if parent == d:
            return d0  # no package found: the scan's own directory
        d = parent


def _literal_assignment(tree: ast.AST, name: str):
    """Value of a module-level ``NAME = <literal>`` assignment, or None."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign):
            targets = [t.id for t in node.targets if isinstance(t, ast.Name)]
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            targets = (
                [node.target.id] if isinstance(node.target, ast.Name) else []
            )
        else:
            continue
        if name in targets:
            value = node.value
            # unwrap one constructor call: frozenset({...}), tuple([...])
            if isinstance(value, ast.Call) \
                    and isinstance(value.func, ast.Name) \
                    and value.func.id in {"frozenset", "set", "tuple",
                                          "list", "dict"} \
                    and len(value.args) == 1:
                value = value.args[0]
            try:
                return ast.literal_eval(value)
            except ValueError:
                return None
    return None


#: the port's loader/export CLIs (repo-relative)
LOADER_CLIS = tuple(PORT.rel(c) for c in _CLIS)


def load_project(root: str, loader_clis: tuple | None = None,
                 package: str = PACKAGE) -> Project:
    """Parse the project-level registries the cross-file rules check
    against.  Missing pieces degrade to empty registries — the analyzer
    must stay runnable on a partial tree (fixture dirs in tests)."""
    from annotatedvdb_tpu_torch.analysis.rules_cli import extract_registrars

    layout = LAYOUTS[package]
    pkg = os.path.join(root, package)
    faults_src = _read(os.path.join(pkg, "utils", "faults.py"))
    config_src = _read(os.path.join(pkg, layout.env_module))
    points: frozenset = frozenset()
    env_declared: dict = {}
    if faults_src:
        val = _literal_assignment(ast.parse(faults_src), "POINTS")
        if val:
            points = frozenset(val)
    if config_src:
        val = _literal_assignment(ast.parse(config_src), "ENV_VARS")
        if isinstance(val, dict):
            env_declared = val
    registrars = extract_registrars(*(
        ast.parse(src) for src in (
            _read(os.path.join(pkg, rel)) for rel in layout.registrar_modules
        ) if src
    ))
    twins: dict = {}
    ops_src = _read(os.path.join(pkg, "ops", "__init__.py"))
    if ops_src:
        val = _literal_assignment(ast.parse(ops_src), "TWINS")
        if isinstance(val, dict):
            twins = val
    matrix = sorted({p for pattern in layout.fault_matrix
                     for p in glob.glob(os.path.join(root, pattern))})
    return Project(
        root=root,
        readme=_read(os.path.join(root, "README.md")),
        fault_points=points,
        fault_matrix_src="\n".join(_read(p) for p in matrix),
        env_declared=env_declared,
        loader_clis=(
            loader_clis if loader_clis is not None
            else tuple(layout.rel(c) for c in _CLIS)
        ),
        flag_registrars=registrars,
        twins=twins,
        layout=layout,
    )


def iter_python_files(paths) -> list[str]:
    """Expand files/directories into a sorted list of ``.py`` files,
    skipping :data:`SKIP_DIRS` (fixtures live under a ``data`` dir)."""
    out: list[str] = []
    for p in paths:
        if os.path.isfile(p):
            if p.endswith(".py"):
                out.append(p)
            continue
        for dirpath, dirnames, filenames in os.walk(p):
            base = os.path.basename(os.path.normpath(dirpath))
            dirnames[:] = sorted(
                d for d in dirnames
                if d not in SKIP_DIRS
                and not (d == "data" and base == _FIXTURE_DATA_PARENT)
            )
            for fn in sorted(filenames):
                if fn.endswith(".py"):
                    out.append(os.path.join(dirpath, fn))
    return out


def run_paths(paths, root: str | None = None,
              loader_clis: tuple | None = None,
              audit: bool = True,
              package: str = PACKAGE) -> tuple[list[Finding], int]:
    """Analyze ``paths``; returns ``(findings, files_scanned)``.

    ``root`` overrides repo-root discovery (fixture tests point it at a
    synthetic tree); ``loader_clis`` overrides the CLI-contract file list
    the same way; ``package`` names the :class:`Layout` whose registries
    the project rules read (``annotatedvdb_tpu`` judges a tree laid out
    as the JAX package).  ``audit=False`` (the ``--diff`` mode) keeps per-file
    and call-site codes but disables the whole-project audits
    (AVDB302/305/4xx-audit/9xx): a partial scan that happens to include
    ``config.py`` or ``ops/__init__.py`` must not judge the files it did
    NOT scan.
    """
    from annotatedvdb_tpu_torch.analysis import (
        rules_async,
        rules_cli,
        rules_durability,
        rules_env,
        rules_hygiene,
        rules_locks,
        rules_parity,
        rules_registry,
        rules_trace,
        rules_twins,
    )

    files = iter_python_files(paths)
    if root is None:
        root = find_repo_root(files[0] if files else os.getcwd(), package)
    project = load_project(root, loader_clis=loader_clis, package=package)
    facts = ProjectFacts()
    norm = [f.replace("\\", "/") for f in files]
    registry = project.layout.rel(project.layout.env_module)
    facts.full_registry_scan = audit and any(
        f.endswith(registry) for f in norm
    )
    facts.tree_scan = facts.full_registry_scan and any(
        "/tests/" in f or f.startswith("tests/") for f in norm
    )
    findings: list[Finding] = []

    per_file = (
        rules_trace.check,
        rules_locks.check,
        rules_hygiene.check,
        rules_async.check,
        rules_durability.check,
    )
    collectors = (
        rules_registry.collect,
        rules_env.collect,
        rules_cli.collect,
        rules_parity.collect,
        rules_twins.collect,
        rules_durability.collect,
    )
    finalizers = (
        rules_registry.finalize,
        rules_env.finalize,
        rules_cli.finalize,
        rules_parity.finalize,
        rules_twins.finalize,
        rules_durability.finalize,
    )

    scanned: list[tuple[str, FileContext]] = []
    for path in files:
        source = _read(path)
        try:
            ctx = FileContext(path, source)
        except SyntaxError as err:
            findings.append(Finding(
                "AVDB001", path, err.lineno or 1,
                f"file does not parse: {err.msg}",
                "fix the syntax error (nothing else was checked here)",
            ))
            continue
        scanned.append((path, ctx))
        for rule in per_file:
            findings.extend(rule(ctx))
        for coll in collectors:
            coll(ctx, facts, project)
    if not audit:
        facts.twins_scan = False  # collectors set them; --diff disables
        facts.fsck_scan = False
    for fin in finalizers:
        findings.extend(fin(facts, project))

    # AVDB604 — stale-suppression audit: runs against the findings that
    # WOULD fire (pre-suppression), so it sees exactly what each noqa
    # comment is suppressing.  Tree-gated like the other whole-project
    # audits: on a --diff subset, a noqa for a cross-file code is not
    # decidable (its code may fire only on a full scan).
    if facts.tree_scan:
        findings.extend(
            rules_hygiene.audit_noqa(scanned, findings, root)
        )

    # apply per-line suppressions.  Project-level findings carry
    # repo-RELATIVE paths (e.g. "annotatedvdb_tpu_torch/runtime.py") while the
    # scan may have been invoked with absolute paths, so the lookup is
    # keyed by absolute path on both sides — a noqa must work the same
    # under `avdb_check .` and `avdb_check /abs/tree`.
    ctx_by_abs: dict[str, FileContext | None] = {
        os.path.abspath(path): ctx
        for path, ctx in facts.contexts.items()
    }
    kept: list[Finding] = []
    for f in findings:
        # per-file findings carry the SCAN path verbatim (a facts.contexts
        # key, possibly cwd-relative); project-level findings carry
        # root-RELATIVE paths.  Try the scan path first, then anchor on
        # root — `avdb_check fixture_tree --root fixture_tree` from the
        # repo root must resolve both kinds.
        abs_path = os.path.abspath(f.path)
        if abs_path not in ctx_by_abs and not os.path.isabs(f.path):
            abs_path = os.path.abspath(os.path.join(root, f.path))
        if abs_path not in ctx_by_abs:
            try:
                ctx_by_abs[abs_path] = (
                    FileContext(abs_path, _read(abs_path))
                    if abs_path.endswith(".py") and os.path.isfile(abs_path)
                    else None
                )
            except SyntaxError:
                ctx_by_abs[abs_path] = None
        ctx = ctx_by_abs[abs_path]
        if ctx is not None and ctx.suppressed(f.line, f.code):
            continue
        kept.append(f)
    kept.sort(key=lambda f: (f.path, f.line, f.code))
    return kept, len(files)
