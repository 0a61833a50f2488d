"""AVDB5xx — CLI-contract: the loader CLIs share one flag surface.

Port of ``annotatedvdb_tpu/analysis/rules_cli.py``.

Ops tooling (run ledgers, quarantine replay, dashboards) assumes every
loader CLI accepts ``--commit``/``--test``/``--logFilePath``/``--maxErrors``
/``--metricsOut``/``--traceOut``/``--logAfter`` with identical spellings
and defaults.  This rule statically extracts each CLI's effective flag
table by walking its ``argparse`` setup — direct ``add_argument`` calls
plus the shared registrars of the layout's registrar modules (functions
named ``add_*``, and parser factories named ``*_parser`` such as the
port's ``cli/update_common.update_parser``), nested registrar calls
resolved transitively.

The canonical spelling of each shared flag is the reference's registrar
table: ``config.add_lifecycle_args`` and ``obs.add_obs_args`` where the
layout has them; the port adds the lifecycle flags inline in each CLI,
so :data:`LIFECYCLE_FLAGS` carries ``add_lifecycle_args``'s table as a
literal.

Codes:

- **AVDB501** — a loader CLI is missing a shared flag;
- **AVDB502** — a loader CLI defines a shared flag with a different
  ``default``/``action``/``type`` than the canonical registrar.
"""

from __future__ import annotations

import ast

from annotatedvdb_tpu_torch.analysis.core import (
    FileContext,
    Finding,
    Project,
    ProjectFacts,
)

HINT_501 = ("add the shared flag with the canonical spelling (the "
            "lifecycle table, obs.add_obs_args) to the CLI's parser")
HINT_502 = ("match the canonical spelling/default from the registrar, or "
            "move the flag into the shared registrar if the change is "
            "intentional for every loader")

#: the flags every loader CLI must expose (the ops-tooling contract)
SHARED_FLAGS = ("--commit", "--test", "--logFilePath", "--maxErrors",
                "--metricsOut", "--traceOut", "--logAfter")

#: the spec keys compared against the canonical registrar definition
_COMPARED_KEYS = ("action", "default", "type")

#: the reference's ``config.add_lifecycle_args`` table (spec values as
#: ``ast.unparse`` renders them): the canonical lifecycle flags where the
#: layout has no such registrar
LIFECYCLE_FLAGS = {
    "--commit": {"action": "'store_true'"},
    "--test": {"action": "'store_true'"},
    "--logAfter": {"type": "int", "default": "None"},
    "--logFilePath": {"default": "None"},
    "--maxErrors": {"type": "int", "default": "-1"},
}


def _is_registrar(name: str) -> bool:
    return name.startswith("add_") or name.endswith("_parser")


def _flag_spec(call: ast.Call) -> tuple[str, dict] | None:
    """(flag, spec) from one ``add_argument`` call; None for positionals."""
    if not call.args:
        return None
    first = call.args[0]
    if not (isinstance(first, ast.Constant) and isinstance(first.value, str)
            and first.value.startswith("--")):
        return None
    spec = {"line": call.lineno}
    for kw in call.keywords:
        if kw.arg in _COMPARED_KEYS + ("required", "dest"):
            spec[kw.arg] = ast.unparse(kw.value)
    return first.value, spec


def extract_registrars(*trees: ast.Module) -> dict:
    """{helper_name: {flag: spec}} for every module-level registrar
    (``add_*`` helper or ``*_parser`` factory) of ``trees`` that registers
    argparse flags; nested helper calls resolve after the first pass,
    across the modules (the port's ``update_parser`` calls
    ``obs.add_obs_args``)."""
    raw: dict[str, dict] = {}
    calls_nested: dict[str, list] = {}
    for node in (n for tree in trees for n in tree.body):
        if not (isinstance(node, ast.FunctionDef)
                and _is_registrar(node.name)):
            continue
        flags: dict[str, dict] = {}
        nested: list[str] = []
        for sub in ast.walk(node):
            if not isinstance(sub, ast.Call):
                continue
            if isinstance(sub.func, ast.Attribute) \
                    and sub.func.attr == "add_argument":
                fs = _flag_spec(sub)
                if fs:
                    flags[fs[0]] = fs[1]
            elif isinstance(sub.func, ast.Name) \
                    and _is_registrar(sub.func.id):
                nested.append(sub.func.id)
        raw[node.name] = flags
        calls_nested[node.name] = nested
    # resolve one level of nesting per iteration (tiny graphs; no cycles)
    for _ in range(4):
        changed = False
        for name, nested in calls_nested.items():
            for callee in nested:
                for flag, spec in raw.get(callee, {}).items():
                    if flag not in raw[name]:
                        raw[name][flag] = spec
                        changed = True
        if not changed:
            break
    return raw


def _cli_flags(ctx: FileContext, registrars: dict) -> tuple[dict, int]:
    """(effective flag table, parser-creation line) for one CLI module."""
    flags: dict[str, dict] = {}
    parser_line = 1
    for node in ctx.nodes:
        if not isinstance(node, ast.Call):
            continue
        if isinstance(node.func, ast.Attribute):
            if node.func.attr == "ArgumentParser":
                parser_line = node.lineno
            elif node.func.attr == "add_argument":
                fs = _flag_spec(node)
                if fs:
                    spec = dict(fs[1], line=node.lineno, local=True)
                    flags[fs[0]] = spec
        elif isinstance(node.func, ast.Name) \
                and node.func.id in registrars:
            for flag, spec in registrars[node.func.id].items():
                flags.setdefault(flag, dict(spec, via=node.func.id))
    return flags, parser_line


def collect(ctx: FileContext, facts: ProjectFacts, project: Project) -> None:
    norm = ctx.path.replace("\\", "/")
    for rel in project.loader_clis:
        if norm.endswith(rel):
            facts.contexts[ctx.path] = ctx
            facts.cli_tables[rel] = (
                ctx.path, *_cli_flags(ctx, project.flag_registrars)
            )
            return


#: the registrars whose tables are canonical
_CANONICAL_HELPERS = ("add_lifecycle_args", "add_obs_args", "add_load_args")


def _canonical(project: Project, flag: str) -> dict | None:
    for helper in _CANONICAL_HELPERS:
        spec = project.flag_registrars.get(helper, {}).get(flag)
        if spec is not None:
            return spec
    return LIFECYCLE_FLAGS.get(flag)


def finalize(facts: ProjectFacts, project: Project) -> list[Finding]:
    findings: list[Finding] = []
    tables = facts.cli_tables
    for rel in project.loader_clis:
        if rel not in tables:
            continue  # partial scan: judge only what was scanned
        path, flags, parser_line = tables[rel]
        for flag in SHARED_FLAGS:
            canon = _canonical(project, flag)
            if flag not in flags:
                findings.append(Finding(
                    "AVDB501", path, parser_line,
                    f"loader CLI is missing shared flag {flag}",
                    HINT_501,
                ))
                continue
            spec = flags[flag]
            if canon is None or spec.get("via") in _CANONICAL_HELPERS:
                continue  # flag came from a canonical registrar itself
            line = spec["line"] if spec.get("local") else parser_line
            for key in _COMPARED_KEYS:
                if spec.get(key) != canon.get(key):
                    findings.append(Finding(
                        "AVDB502", path, line,
                        f"shared flag {flag} drifts from the registrar: "
                        f"{key}={spec.get(key)!r} vs canonical "
                        f"{canon.get(key)!r}",
                        HINT_502,
                    ))
    return findings
