"""AVDB3xx — registry-drift: fault points and metric names are registries,

Port of ``annotatedvdb_tpu/analysis/rules_registry.py``.
not string literals.

A typo'd fault point used to arm silently and never fire; a metric name
registered twice with different kinds/labels poisons the Prometheus export;
a README metric reference that no code emits misleads the operator reading
a dashboard.  These are all cross-file facts, so this rule collects during
the file pass and judges at finalize time.

Codes:

- **AVDB301** — ``faults.fire("<point>")`` literal not in ``faults.POINTS``;
- **AVDB302** — a ``faults.POINTS`` entry with no fault-matrix coverage
  (``tests/test_torch_faults_*.py`` for the port; every point must be
  crash-tested, not just declared);
- **AVDB303** — one ``avdb_*`` metric name registered as two different
  kinds (counter vs gauge vs histogram);
- **AVDB304** — one ``avdb_*`` metric name registered with inconsistent
  label KEY sets across call sites (labels whose keys cannot be statically
  read are skipped, not guessed);
- **AVDB305** — README references an ``avdb_*`` metric no code registers.
  Only metric-SHAPED tokens are checked (ending in a conventional unit
  suffix like ``_total``/``_seconds``/``_rows``/``_depth``, or a
  trailing-underscore family prefix) so tool names like ``avdb_check``
  never false-positive; ``_bucket``/``_sum``/``_count`` exposition
  suffixes resolve to their histogram.
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass

from annotatedvdb_tpu_torch.analysis.core import (
    FileContext,
    Finding,
    Project,
    ProjectFacts,
)

HINT_301 = ("register the point in faults.POINTS (utils/faults.py) and add "
            "a fault-matrix test case, or fix the typo")
HINT_302 = "add a fault-matrix test case for this point"
HINT_303 = "pick one metric kind per name; rename one of the two series"
HINT_304 = ("use one label key set per metric name (Prometheus series of "
            "one name must share a schema)")
HINT_305 = ("register the metric (obs/) or fix the README reference; "
            "document families with a trailing-underscore prefix")

_METRIC_METHODS = {"counter", "gauge", "histogram"}
_README_METRIC_RE = re.compile(r"\bavdb_[a-z0-9_]+")

#: README tokens are judged as metrics only when they END in one of the
#: exposition/unit suffixes every real series here uses — ``avdb_check``
#: (the tool), ``avdb_parse_vcf_chunk`` (a C symbol) etc. stay exempt
_METRIC_SUFFIXES = ("_total", "_seconds", "_rows", "_chunks", "_depth",
                    "_bucket", "_sum", "_count")


@dataclass(frozen=True)
class MetricReg:
    """One static metric registration site."""

    name: str              # literal name, or literal PREFIX for f-strings
    is_prefix: bool        # True when the name came from an f-string
    kind: str              # counter | gauge | histogram
    label_keys: tuple | None  # sorted keys, or None when not statically known
    path: str
    line: int


def _str_const(node: ast.AST) -> str | None:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def _name_of(node: ast.AST) -> tuple[str, bool] | None:
    """(name, is_prefix) for a literal or f-string metric name arg."""
    s = _str_const(node)
    if s is not None:
        return s, False
    if isinstance(node, ast.JoinedStr) and node.values:
        head = node.values[0]
        s = _str_const(head)
        if s:
            return s, True
    return None


def _label_keys(node: ast.AST | None) -> tuple | None:
    """Sorted label keys when the labels arg is a dict literal with literal
    keys; None (= unknown, skip) otherwise."""
    if node is None:
        return ()
    if isinstance(node, ast.Dict):
        keys = []
        for k in node.keys:
            s = _str_const(k) if k is not None else None
            if s is None:
                return None
            keys.append(s)
        return tuple(sorted(keys))
    if isinstance(node, ast.Constant) and node.value is None:
        return ()
    return None


def collect(ctx: FileContext, facts: ProjectFacts, project: Project) -> None:
    facts.contexts[ctx.path] = ctx
    in_faults_module = ctx.path.replace("\\", "/").endswith(
        "utils/faults.py"
    )
    for node in ctx.nodes:
        if not isinstance(node, ast.Call):
            continue
        func = node.func
        if not isinstance(func, ast.Attribute):
            continue
        # faults.fire("<point>", ...) — any base whose attr is fire/
        # maybe_fire, rooted at a name ending in "faults" (handles both
        # `faults.fire` and `_faults.fire` import aliases)
        if func.attr in {"fire", "maybe_fire"} \
                and isinstance(func.value, ast.Name) \
                and func.value.id.lstrip("_") == "faults" \
                and not in_faults_module and node.args:
            point = _str_const(node.args[0])
            if point is not None:
                facts.fault_fires.append((ctx.path, node.lineno, point))
            continue
        # <registry>.counter/gauge/histogram("avdb_...", ...)
        if func.attr in _METRIC_METHODS and node.args:
            named = _name_of(node.args[0])
            if named is None:
                continue
            name, is_prefix = named
            if not name.startswith("avdb_"):
                continue
            kind = func.attr
            labels_node = None
            # counter/gauge: (name, help="", labels=None)
            # histogram:     (name, edges, help="", labels=None)
            label_pos = 3 if kind == "histogram" else 2
            if len(node.args) > label_pos:
                labels_node = node.args[label_pos]
            for kw in node.keywords:
                if kw.arg == "labels":
                    labels_node = kw.value
            reg = MetricReg(
                name=name, is_prefix=is_prefix, kind=kind,
                label_keys=_label_keys(labels_node),
                path=ctx.path, line=node.lineno,
            )
            facts.metric_regs.setdefault(name, []).append(reg)


def finalize(facts: ProjectFacts, project: Project) -> list[Finding]:
    findings: list[Finding] = []

    # -- fault points -------------------------------------------------------
    if project.fault_points:
        for path, line, point in facts.fault_fires:
            if point not in project.fault_points:
                findings.append(Finding(
                    "AVDB301", path, line,
                    f"fault point {point!r} is not registered in "
                    f"faults.POINTS",
                    HINT_301,
                ))
        matrix = project.fault_matrix_src
        if matrix and facts.full_registry_scan:
            for point in sorted(project.fault_points):
                if point not in matrix:
                    findings.append(Finding(
                        "AVDB302",
                        project.layout.rel("utils", "faults.py"), 1,
                        f"registered fault point {point!r} has no "
                        f"{project.layout.fault_matrix_label} coverage",
                        HINT_302,
                    ))

    # -- metric name/kind/label consistency ---------------------------------
    for name, regs in sorted(facts.metric_regs.items()):
        ordered = sorted(regs, key=lambda r: (r.path, r.line))
        kinds = {r.kind for r in ordered}
        if len(kinds) > 1:
            # report at the last site whose kind differs from the first
            # registration (the established one)
            first_kind = ordered[0].kind
            worst = [r for r in ordered if r.kind != first_kind][-1]
            findings.append(Finding(
                "AVDB303", worst.path, worst.line,
                f"metric {name!r} registered as multiple kinds: "
                f"{', '.join(sorted(kinds))}",
                HINT_303,
            ))
            continue  # one finding per root cause: labels differ trivially
        known = [r for r in ordered if r.label_keys is not None]
        keysets = {r.label_keys for r in known}
        if len(keysets) > 1:
            first_keys = known[0].label_keys
            worst = [r for r in known if r.label_keys != first_keys][-1]
            rendered = " vs ".join(
                "{" + ", ".join(ks) + "}" for ks in sorted(keysets)
            )
            findings.append(Finding(
                "AVDB304", worst.path, worst.line,
                f"metric {name!r} registered with inconsistent label "
                f"keys: {rendered}",
                HINT_304,
            ))

    # -- README metric references -------------------------------------------
    if project.readme and facts.metric_regs and facts.full_registry_scan:
        exact = {n for n, rs in facts.metric_regs.items()
                 if not all(r.is_prefix for r in rs)}
        prefixes = {n for n, rs in facts.metric_regs.items()
                    if any(r.is_prefix for r in rs)}
        for tok in sorted(set(_README_METRIC_RE.findall(project.readme))):
            if not tok.endswith("_") \
                    and not tok.endswith(_METRIC_SUFFIXES):
                continue  # not metric-shaped: a tool/symbol name
            if tok.endswith("_"):  # documented family prefix
                if any(e.startswith(tok) for e in exact) \
                        or any(p.startswith(tok) or tok.startswith(p)
                               for p in prefixes):
                    continue
            else:
                base = re.sub(r"_(bucket|sum|count)$", "", tok)
                if tok in exact or base in exact:
                    continue
                if any(tok.startswith(p) for p in prefixes):
                    continue
            findings.append(Finding(
                "AVDB305", "README.md", _readme_line(project.readme, tok),
                f"README references metric {tok!r} which no code "
                f"registers",
                HINT_305,
            ))
    return findings


def _readme_line(text: str, token: str) -> int:
    for i, line in enumerate(text.splitlines(), start=1):
        if token in line:
            return i
    return 1
