"""AVDB8xx — cross-surface parity: the two serve front ends must not fork.

Port of ``annotatedvdb_tpu/analysis/rules_parity.py``.

``serve/http.py`` (threaded) and ``serve/aio.py`` (event loop) answer the
same routes with byte-identical bodies — a contract the parity test suite
pins at runtime and review enforced by convention: body/param
parsing, knob resolution, and payload shaping live ONCE, in shared
helpers (``parse_region_params``, ``parse_regions_body``,
``healthz_payload``/``stats_payload``/``readyz_payload``,
``point_preflight``, the shared response-message constants), and each
front end only renders.  This family catches the drift shapes that
slipped through before the runtime suite could see them:

- **AVDB801** — a response-shaping string literal duplicated across BOTH
  front-end files.  Two copies of ``"deadline exhausted at admission"``
  parse today and fork the first time one side is edited; the literal
  belongs in ``http.py`` (the reference front end) with ``aio.py``
  importing it.  Metric registration strings (names/help text passed to
  ``counter``/``gauge``/``histogram``) are exempt — same-series
  registration is deliberate.
- **AVDB802** — the same ``AVDB_SERVE_*`` environment variable read
  directly in both front-end files: knob resolution must go through one
  shared resolver (the ``batcher.resolve_batch_knobs`` convention), or
  the two surfaces drift the moment one default changes.
- **AVDB803** — a shared single-source helper referenced by one front
  end but not the other: the asymmetric side has re-implemented (or
  dropped) the shared path.  Judged over :data:`SHARED_HELPERS`; a
  helper neither file references is silent (not yet adopted ≠ forked).

The pair is identified by path suffix (``serve/http.py`` /
``serve/aio.py``), so the fixture tree under ``tests/data`` drives the
same code the real front ends do.  All three codes are decidable only
when BOTH files are in the scan (a single-file scan stays silent).
"""

from __future__ import annotations

import ast

from annotatedvdb_tpu_torch.analysis.core import (
    FileContext,
    Finding,
    Project,
    ProjectFacts,
)

HINT_801 = ("hoist the literal into serve/http.py (module constant) and "
            "import it from serve/aio.py — response shaping lives once")
HINT_802 = ("resolve the knob in ONE shared helper (the "
            "batcher.resolve_batch_knobs convention) and call it from "
            "both front ends")
HINT_803 = ("route this surface through the shared helper on both front "
            "ends (parse/knob/payload logic lives once; front ends only "
            "render)")

#: the single-source helpers both front ends must resolve shared
#: surfaces through (referencing = calling OR importing OR defining)
SHARED_HELPERS = frozenset({
    "parse_region_params",
    "parse_regions_body",
    "parse_stats_body",
    "STATS_BODY_ERROR",
    "parse_upsert_body",
    "upsert_execute",
    "healthz_payload",
    "stats_payload",
    "readyz_payload",
    "point_preflight",
    "REGIONS_BODY_ERROR",
    # the request-observability plane: trace-id resolution/echo,
    # the /metrics (+?fleet=1) body, the chaos gate, and the
    # /debug/trace dump all live once in http.py
    "resolve_trace_id",
    "TRACE_HEADER",
    "metrics_payload",
    "debug_trace_payload",
    "chaos_enabled_from_env",
    # the health plane: the /alerts and /metrics/history bodies
    # live once in http.py — both front ends only render
    "alerts_payload",
    "metrics_history_payload",
})

#: literals shorter than this are grammar fragments (JSON keys, header
#: names), not response shaping
MIN_LITERAL_LEN = 16

_METRIC_METHODS = {"counter", "gauge", "histogram"}

_HTTP_SUFFIX = "serve/http.py"
_AIO_SUFFIX = "serve/aio.py"


def _front_end(path: str) -> str | None:
    p = path.replace("\\", "/")
    if p.endswith(_HTTP_SUFFIX):
        return "http"
    if p.endswith(_AIO_SUFFIX):
        return "aio"
    return None


def _docstring_values(tree: ast.Module) -> set:
    """String constants that are docstrings (module/class/function)."""
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)):
            body = getattr(node, "body", [])
            if body and isinstance(body[0], ast.Expr) \
                    and isinstance(body[0].value, ast.Constant) \
                    and isinstance(body[0].value.value, str):
                out.add(body[0].value.value)
    return out


def _metric_arg_values(tree: ast.Module) -> set:
    """String constants appearing inside metric registration calls —
    duplicated series names/help text across the front ends is the
    same-series case, not a fork."""
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute) \
                and node.func.attr in _METRIC_METHODS:
            for sub in ast.walk(node):
                if isinstance(sub, ast.Constant) \
                        and isinstance(sub.value, str):
                    out.add(sub.value)
    return out


def collect(ctx: FileContext, facts: ProjectFacts, project: Project) -> None:
    side = _front_end(ctx.path)
    if side is None:
        return
    exempt = _docstring_values(ctx.tree) | _metric_arg_values(ctx.tree)
    literals: dict[str, int] = {}
    refs: set = set()
    for node in ctx.nodes:
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            v = node.value
            if len(v) >= MIN_LITERAL_LEN and v not in exempt \
                    and not v.startswith("AVDB_") \
                    and v not in literals:
                # AVDB_* name literals are env reads — AVDB802's surface
                literals[v] = node.lineno
        elif isinstance(node, ast.Name):
            refs.add(node.id)
        elif isinstance(node, ast.Attribute):
            refs.add(node.attr)
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            for alias in node.names:
                refs.add(alias.asname or alias.name.split(".")[-1])
    facts.parity[ctx.path] = {
        "side": side, "literals": literals, "refs": refs,
    }


def finalize(facts: ProjectFacts, project: Project) -> list[Finding]:
    sides = {info["side"]: (path, info)
             for path, info in sorted(facts.parity.items())}
    if set(sides) != {"http", "aio"}:
        return []  # single-file scan: parity is undecidable
    http_path, http = sides["http"]
    aio_path, aio = sides["aio"]
    findings: list[Finding] = []

    # -- AVDB801: duplicated response-shaping literals ----------------------
    for value in sorted(set(http["literals"]) & set(aio["literals"])):
        findings.append(Finding(
            "AVDB801", aio_path, aio["literals"][value],
            f"response-shaping literal {value!r} duplicated across both "
            f"front ends (also at {http_path}:{http['literals'][value]})",
            HINT_801,
        ))

    # -- AVDB802: duplicated AVDB_SERVE_* env reads -------------------------
    reads: dict[str, dict] = {}
    for path, line, var in facts.env_reads:
        side = _front_end(path)
        if side is not None and var.startswith("AVDB_SERVE_") \
                and path in facts.parity:
            reads.setdefault(var, {})[side] = (path, line)
    for var in sorted(reads):
        if set(reads[var]) == {"http", "aio"}:
            path, line = reads[var]["aio"]
            o_path, o_line = reads[var]["http"]
            findings.append(Finding(
                "AVDB802", path, line,
                f"env knob {var} read directly in both front ends "
                f"(also at {o_path}:{o_line}) — resolution must be "
                f"shared",
                HINT_802,
            ))

    # -- AVDB803: shared-helper asymmetry -----------------------------------
    for helper in sorted(SHARED_HELPERS):
        in_http = helper in http["refs"]
        in_aio = helper in aio["refs"]
        if in_http == in_aio:
            continue  # both (good) or neither (not yet adopted)
        path = aio_path if in_http else http_path
        other = "threaded front end" if in_http else "aio front end"
        findings.append(Finding(
            "AVDB803", path, 1,
            f"shared helper {helper!r} is used by the {other} but not "
            f"here — the surface it owns has forked",
            HINT_803,
        ))
    return findings
