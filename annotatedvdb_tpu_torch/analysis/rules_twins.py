"""AVDB9xx — kernel/plain-version contract: every kernel has a proven twin.

Port of ``annotatedvdb_tpu/analysis/rules_twins.py``.  The reference
registers each jitted device kernel against its numpy host twin; the
port's device kernels are hand-written CUDA, each reached through one
wrapper, and each wrapper has a plain torch version (``<name>_reference``)
that the CPU runs and the card's tests hold the kernel against.  The
breaker's host path, every CPU run and every parity test rest on that
pairing.

``ops.TWINS`` (``annotatedvdb_tpu_torch/ops/__init__.py``) is the
canonical registry, the ``faults.POINTS`` pattern: a dict literal mapping
each kernel wrapper to its plain version, both as package-relative dotted
names (``"ops.intervals.bits_spans": "ops.intervals.bits_spans_reference"``).

A kernel wrapper is a module-level function under ``ops/`` or ``genome/``
whose body calls a ``<name>_launch`` entry point of the loaded ctypes
library (``_library().bits_spans_launch(...)``).

Codes:

- **AVDB901** — a kernel wrapper not registered in ``ops.TWINS``;
- **AVDB902** — a ``TWINS`` entry that does not resolve: its key names no
  discovered wrapper, or its value names no function defined in the tree
  (a stale registry silently un-guards the kernel it meant to cover);
- **AVDB903** — a registered pair whose two names never appear TOGETHER,
  as whole words, in any single test file: nothing proves the kernel
  agrees with its plain version (the parity test is the contract).

Audit codes gate on ``ops/__init__.py`` being in the scan (fixture
subsets stay judgeable against their own tree via ``run_paths(root=)``),
and AVDB903 additionally needs the test tree scanned.
"""

from __future__ import annotations

import ast
import re

from annotatedvdb_tpu_torch.analysis.core import (
    FileContext,
    Finding,
    Project,
    ProjectFacts,
)

HINT_901 = ("register the wrapper in ops.TWINS with its plain version "
            "and add a test referencing both")
HINT_902 = ("fix the dotted name (package-relative, e.g. "
            "'ops.intervals.bits_spans_reference') or delete the stale "
            "entry")
HINT_903 = ("add a test that drives the kernel and its plain version "
            "together and compares the answers byte-for-byte")

#: the package directories whose modules hold kernel wrappers
WRAPPER_DIRS = ("ops", "genome")

#: the suffix of a ctypes library's kernel entry points
_LAUNCH_SUFFIX = "_launch"


def _launches(fn: ast.AST) -> bool:
    """Whether ``fn``'s body calls a ``<name>_launch`` attribute."""
    return any(
        isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
        and n.func.attr.endswith(_LAUNCH_SUFFIX)
        for n in ast.walk(fn)
    )


def _module_key(path: str) -> str | None:
    """``.../annotatedvdb_tpu_torch/ops/intervals.py`` -> ``ops.intervals``
    (``genome/refgenome.py`` -> ``genome.refgenome``; fixture trees under
    a different root resolve the same way)."""
    p = path.replace("\\", "/")
    if not p.endswith(".py"):
        return None
    for d in WRAPPER_DIRS:
        if f"/{d}/" not in p and not p.startswith(f"{d}/"):
            continue
        tail = p.rsplit(f"{d}/", 1)[1]
        if "/" in tail:
            return None  # no nested packages
        stem = tail[:-3]
        return d if stem == "__init__" else f"{d}.{stem}"
    return None


def collect(ctx: FileContext, facts: ProjectFacts, project: Project) -> None:
    mod = _module_key(ctx.path)
    if mod is None:
        return
    if mod == "ops":
        facts.twins_scan = True
        facts.twins_registry_path = ctx.path
        return
    for stmt in ctx.tree.body:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and _launches(stmt):
            facts.ops_kernels.append(
                (ctx.path, stmt.lineno, f"{mod}.{stmt.name}")
            )


def _defines(source: str, attr: str) -> bool:
    """Whether ``source`` defines ``attr`` at some top-ish level (def or
    assignment) — textual, deliberately cheap."""
    for line in source.splitlines():
        s = line.strip()
        if s.startswith(f"def {attr}(") or s.startswith(f"def {attr} ("):
            return True
        if s.startswith(f"{attr} =") or s.startswith(f"{attr}="):
            return True
        if s.startswith(f"async def {attr}("):
            return True
    return False


def _resolve_value(value: str, project: Project, facts: ProjectFacts) -> bool:
    """A twin value ``pkg.mod.attr`` resolves when the module file exists
    (under the scan or the project root) and defines ``attr``."""
    import os

    if "." not in value:
        return False
    mod_path, attr = value.rsplit(".", 1)
    rel = mod_path.replace(".", "/") + ".py"
    # prefer a scanned context (fixture trees); fall back to the root
    for path, ctx in facts.contexts.items():
        if path.replace("\\", "/").endswith(rel):
            return _defines(ctx.source, attr)
    full = os.path.join(project.root, project.layout.package, rel)
    try:
        with open(full, encoding="utf-8") as f:
            return _defines(f.read(), attr)
    except OSError:
        return False


def finalize(facts: ProjectFacts, project: Project) -> list[Finding]:
    findings: list[Finding] = []
    if not facts.twins_scan:
        return findings  # partial scan: nothing is decidable
    twins = {
        str(k): str(v) for k, v in project.twins.items()
    }
    registry_path = (
        facts.twins_registry_path
        or project.layout.rel("ops", "__init__.py")
    )

    def _is_test_file(path: str) -> bool:
        import os

        if path == registry_path:
            return False  # the registry lists every pair; never a proof
        try:
            p = os.path.relpath(path, project.root).replace("\\", "/")
        except ValueError:
            p = path.replace("\\", "/")
        return p.startswith("tests/") or "/tests/" in p \
            or p.rsplit("/", 1)[-1].startswith("test_")

    # AVDB903 is decidable only when the scan included test files at all
    tests_present = any(_is_test_file(p) for p in facts.contexts)

    def _registry_line(kernel: str, twin: str) -> int:
        """Anchor a registry finding at ITS entry: locate the (unique)
        kernel key first, then the twin value on that line or the next
        (entries wrap) — a twin shared by two kernels must not anchor
        every finding at the first kernel's entry."""
        ctx = facts.contexts.get(registry_path)
        if ctx is None:
            return 1
        for i, line in enumerate(ctx.lines, start=1):
            if f'"{kernel}"' in line:
                for j in (i, i + 1):
                    if j - 1 < len(ctx.lines) and twin in ctx.lines[j - 1]:
                        return j
                return i
        return 1

    # -- AVDB901: unregistered kernel wrappers ------------------------------
    discovered = {}
    for path, line, name in facts.ops_kernels:
        discovered[name] = (path, line)
        if name not in twins:
            findings.append(Finding(
                "AVDB901", path, line,
                f"kernel wrapper {name!r} is not registered in ops.TWINS "
                f"(no declared plain version)",
                HINT_901,
            ))

    # -- AVDB902: stale registry entries ------------------------------------
    for kernel, twin in sorted(twins.items()):
        if kernel not in discovered:
            findings.append(Finding(
                "AVDB902", registry_path, _registry_line(kernel, twin),
                f"ops.TWINS entry {kernel!r} names no kernel wrapper "
                f"discovered under {'/ or '.join(WRAPPER_DIRS)}/",
                HINT_902,
            ))
            continue
        if not _resolve_value(twin, project, facts):
            findings.append(Finding(
                "AVDB902", registry_path, _registry_line(kernel, twin),
                f"ops.TWINS twin {twin!r} (for {kernel!r}) does not "
                f"resolve to a function in the tree",
                HINT_902,
            ))
            continue
        # -- AVDB903: pair must co-appear in one test file ------------------
        if not tests_present:
            continue
        # whole words: a wrapper's name is a prefix of its plain version's
        k_word = re.compile(rf"\b{re.escape(kernel.rsplit('.', 1)[1])}\b")
        t_word = re.compile(rf"\b{re.escape(twin.rsplit('.', 1)[1])}\b")
        covered = False
        for path, ctx in facts.contexts.items():
            if not _is_test_file(path):
                continue
            if k_word.search(ctx.source) and t_word.search(ctx.source):
                covered = True
                break
        if not covered:
            findings.append(Finding(
                "AVDB903", registry_path, _registry_line(kernel, twin),
                f"twin pair {kernel!r} <-> {twin!r} is never exercised "
                f"together by any test file (no parity proof)",
                HINT_903,
            ))
    return findings
