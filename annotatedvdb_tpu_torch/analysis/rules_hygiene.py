"""AVDB6xx — hygiene: the failure-swallowing patterns this repo has banned.

Port of ``annotatedvdb_tpu/analysis/rules_hygiene.py``.

The robustness spine made "errors must surface with their root
cause" a design rule — ``BoundedStage`` preserves the first in-flight stage
error, the run ledger witnesses aborts.  A bare ``except:`` or an
``except Exception: pass`` anywhere upstream silently defeats all of it,
and a mutable default argument is shared state across calls in a codebase
that runs loaders repeatedly in one process.

Codes:

- **AVDB601** — bare ``except:`` (catches SystemExit/KeyboardInterrupt);
- **AVDB602** — ``except Exception``/``except BaseException`` whose body
  is only ``pass``/``...`` (silent swallow; log-and-continue is fine);
- **AVDB603** — mutable default argument (list/dict/set display or
  constructor call);
- **AVDB604** — stale suppression: an ``# avdb: noqa[CODE]`` comment whose
  code no longer fires at that line (the rule was fixed, the code moved,
  or the suppression was always wrong).  A suppression that silences
  nothing is worse than dead code — it silently re-arms if the violation
  ever comes back, with nobody reviewing it.  Whole-tree-gated
  (:func:`audit_noqa` runs from ``core.run_paths`` only on full scans).
"""

from __future__ import annotations

import ast
import os

from annotatedvdb_tpu_torch.analysis.core import FileContext, Finding

HINT_601 = ("catch a concrete exception type, or `except Exception` with "
            "a log line; bare except swallows KeyboardInterrupt/SystemExit")
HINT_602 = ("log the swallowed error (even at debug level) or narrow the "
            "type; silent Exception-pass hides root causes the run ledger "
            "exists to witness")
HINT_603 = "default to None and create the list/dict/set inside the body"
HINT_604 = ("delete the stale suppression (or narrow its code list to the "
            "codes that still fire on this line)")

_BROAD = {"Exception", "BaseException"}
_MUTABLE_CALLS = {"list", "dict", "set", "defaultdict", "OrderedDict"}


def _is_swallow_body(body) -> bool:
    for stmt in body:
        if isinstance(stmt, ast.Pass):
            continue
        if isinstance(stmt, ast.Expr) and isinstance(stmt.value, ast.Constant):
            continue  # docstring or `...`
        return False
    return True


def _is_mutable_default(node: ast.AST) -> bool:
    if isinstance(node, (ast.List, ast.Dict, ast.Set)):
        return True
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
            and node.func.id in _MUTABLE_CALLS:
        return True
    return False


def check(ctx: FileContext) -> list[Finding]:
    findings: list[Finding] = []
    for node in ctx.nodes:
        if isinstance(node, ast.ExceptHandler):
            if node.type is None:
                findings.append(Finding(
                    "AVDB601", ctx.path, node.lineno,
                    "bare `except:`",
                    HINT_601,
                ))
            else:
                names = []
                t = node.type
                elems = t.elts if isinstance(t, ast.Tuple) else [t]
                for e in elems:
                    if isinstance(e, ast.Name):
                        names.append(e.id)
                if any(n in _BROAD for n in names) \
                        and _is_swallow_body(node.body):
                    findings.append(Finding(
                        "AVDB602", ctx.path, node.lineno,
                        f"`except {'/'.join(names)}` silently swallows "
                        f"the error (body is pass/...)",
                        HINT_602,
                    ))
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            defaults = list(node.args.defaults) + [
                d for d in node.args.kw_defaults if d is not None
            ]
            for d in defaults:
                if _is_mutable_default(d):
                    findings.append(Finding(
                        "AVDB603", ctx.path, d.lineno,
                        f"mutable default argument in {node.name!r}",
                        HINT_603,
                    ))
    return findings


def audit_noqa(scanned, findings, root: str) -> list[Finding]:
    """AVDB604 — flag every noqa comment that suppresses nothing.

    ``scanned`` is the run's ``[(path, FileContext)]`` list; ``findings``
    is every finding raised so far, PRE-suppression — exactly the set the
    noqa comments are about to filter.  Called by ``core.run_paths`` only
    on whole-tree scans (a partial scan cannot decide whether a cross-file
    code would fire).  The emitted findings flow through the normal
    suppression pass, so ``# avdb: noqa[AVDB604]`` can silence a
    deliberate fixture; AVDB604 itself is never counted as stale (it
    fires only because of the comment that names it).
    """
    scanned_abs = {os.path.abspath(path) for path, _ctx in scanned}
    fired: dict[tuple[str, int], set] = {}
    for f in findings:
        # same two-kinds resolution as core.run_paths' suppression pass:
        # per-file findings carry the scan path, project findings a
        # root-relative one
        abs_path = os.path.abspath(f.path)
        if abs_path not in scanned_abs and not os.path.isabs(f.path):
            abs_path = os.path.abspath(os.path.join(root, f.path))
        fired.setdefault(
            (abs_path, f.line), set()
        ).add(f.code)

    out: list[Finding] = []
    for path, ctx in scanned:
        abs_path = os.path.abspath(path)
        for line, codes in sorted(ctx.noqa.items()):
            fired_here = fired.get((abs_path, line), set())
            if codes is None:
                if not fired_here:
                    out.append(Finding(
                        "AVDB604", path, line,
                        "blanket `# avdb: noqa` suppresses nothing on "
                        "this line",
                        HINT_604,
                    ))
                continue
            stale = sorted(
                c for c in codes
                if c != "AVDB604" and c not in fired_here
            )
            for code in stale:
                out.append(Finding(
                    "AVDB604", path, line,
                    f"stale suppression: {code} does not fire on this "
                    f"line",
                    HINT_604,
                ))
    return out
