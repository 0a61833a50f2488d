"""AVDB4xx — env-var drift: every ``AVDB_*`` knob is declared and documented.

Port of ``annotatedvdb_tpu/analysis/rules_env.py``.  The port's registry
is ``runtime.ENV_VARS`` (the reference's is ``config.ENV_VARS``), and its
own ``AVDBC_*`` knobs are judged beside the reference's ``AVDB_*`` ones
(:attr:`Layout.env_prefixes`); findings name the registry of the layout
in use.

The runtime surface of this repo is its ``AVDB_*`` environment variables
(pipeline mode, ingest engine, verify level, fault arming, …).  An
undeclared variable is invisible to operators; a documented-but-dead one is
a trap.  ``config.ENV_VARS`` is the canonical registry (name → one-line
docstring); README's environment table must cover it.

Codes:

- **AVDB401** — code reads an ``AVDB_*`` variable not declared in
  ``config.ENV_VARS``;
- **AVDB402** — a declared variable is missing from README;
- **AVDB403** — a declared variable is never read anywhere in the scanned
  tree (stale declaration — delete it or the dead code kept it alive).

Reads are collected from ``os.environ.get/[...]``/``os.getenv`` (any
import alias whose chain ends in ``environ``/``getenv``).  WRITES are not
flagged: tests arm fixtures by assignment, which is the variable's job.
"""

from __future__ import annotations

import ast
import os

from annotatedvdb_tpu_torch.analysis.core import (
    FileContext,
    Finding,
    Project,
    ProjectFacts,
)

HINT_401 = ("declare the variable in the ENV_VARS registry with a "
            "one-line docstring (and add it to README's environment table)")
HINT_402 = "add the variable to README's environment-variable table"
HINT_403 = ("delete the stale ENV_VARS entry, or wire the variable back "
            "up where it was meant to be read")


def _chain(node: ast.AST) -> list[str] | None:
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return parts[::-1]
    return None


def _avdb_const(node: ast.AST, prefixes: tuple) -> str | None:
    if isinstance(node, ast.Constant) and isinstance(node.value, str) \
            and node.value.startswith(prefixes):
        return node.value
    return None


def collect(ctx: FileContext, facts: ProjectFacts, project: Project) -> None:
    prefixes = project.layout.env_prefixes
    for node in ctx.nodes:
        if isinstance(node, ast.Call):
            chain = _chain(node.func)
            if not chain:
                continue
            # os.environ.get("X") / os.getenv("X") / environ.get("X")
            is_env_get = (
                (chain[-1] == "get" and len(chain) >= 2
                 and chain[-2] == "environ")
                or chain[-1] == "getenv"
            )
            if is_env_get and node.args:
                var = _avdb_const(node.args[0], prefixes)
                if var:
                    facts.env_reads.append((ctx.path, node.lineno, var))
            # environ.pop("X", ...) in tests: a write-side operation
            if chain[-1] in {"pop", "setdefault"} and len(chain) >= 2 \
                    and chain[-2] == "environ" and node.args:
                var = _avdb_const(node.args[0], prefixes)
                if var:
                    facts.env_writes.add(var)
        elif isinstance(node, ast.Subscript):
            chain = _chain(node.value)
            if chain and chain[-1] == "environ":
                var = _avdb_const(node.slice, prefixes)
                if var:
                    # a Subscript in Store context is a write (monkeypatch /
                    # subprocess env assembly); Load is a read
                    if isinstance(node.ctx, ast.Load):
                        facts.env_reads.append(
                            (ctx.path, node.lineno, var)
                        )
                    else:
                        facts.env_writes.add(var)


def finalize(facts: ProjectFacts, project: Project) -> list[Finding]:
    findings: list[Finding] = []
    declared = project.env_declared
    if not declared:
        return findings  # partial tree (fixtures): nothing to judge against
    layout = project.layout
    registry_name = f"{layout.env_module[:-3]}.ENV_VARS"
    registry_path = layout.rel(layout.env_module)
    read_names = {var for _p, _l, var in facts.env_reads}
    read_names |= facts.env_writes
    for path, line, var in facts.env_reads:
        if var not in declared:
            findings.append(Finding(
                "AVDB401", path, line,
                f"environment variable {var} read but not declared in "
                f"{registry_name}",
                HINT_401,
            ))
    if not facts.full_registry_scan:
        return findings  # partial scan: only call-site codes are decidable
    for var in sorted(declared):
        if project.readme and var not in project.readme:
            findings.append(Finding(
                "AVDB402", registry_path,
                _decl_line(project, var),
                f"declared environment variable {var} is not documented "
                f"in README.md",
                HINT_402,
            ))
        if var not in read_names and facts.tree_scan:
            # decidable only when tests/ was scanned too: the
            # AVDB_SCALE_TEST-class gates are read from the test tree
            findings.append(Finding(
                "AVDB403", registry_path,
                _decl_line(project, var),
                f"declared environment variable {var} is never read in "
                f"the scanned tree",
                HINT_403,
            ))
    return findings


def _decl_line(project: Project, var: str) -> int:
    layout = project.layout
    try:
        with open(os.path.join(project.root, layout.package,
                               layout.env_module), encoding="utf-8") as f:
            for i, line in enumerate(f, start=1):
                if f'"{var}"' in line:
                    return i
    except OSError:
        pass
    return 1
