"""AVDB2xx — lock-discipline: annotated attributes stay under their lock.

Port of ``annotatedvdb_tpu/analysis/rules_locks.py``.

The executor/telemetry classes (``BoundedStage``, ``MetricsRegistry``,
``Tracer``, ``AlgorithmLedger``) are mutated from multiple pipeline threads.
Their guarded state is declared in source with a structured comment::

    #: guarded by self._lock
    self._events = []

(or trailing on the assignment line).  This rule is a lightweight static
race detector: inside the declaring class, every OTHER method's read/write
of a guarded attribute must sit lexically inside a ``with self.<lock>:``
block.  ``__init__`` is exempt (no concurrency exists before construction
completes); so is the line the annotation itself sits on.

Codes:

- **AVDB201** — guarded attribute accessed outside ``with self.<lock>:``;
- **AVDB202** — a ``guarded by self.X`` annotation that cannot take
  effect: it names a lock attribute the class never assigns, or it binds
  to no ``self.Y`` assignment on its own line or the next few lines (a
  stale/typo'd/floating annotation would silently disable the rule, so it
  is itself an error).

The check is lexical, not a happens-before analysis: a method that is only
ever called while the lock is held must either take the (re-entrant) lock
itself or carry a ``# avdb: noqa[AVDB201] -- <why>``.
"""

from __future__ import annotations

import ast
import re

from annotatedvdb_tpu_torch.analysis.core import FileContext, Finding

HINT_201 = ("wrap the access in `with self.<lock>:` (use RLock for "
            "helper methods called under the lock) or justify with "
            "# avdb: noqa[AVDB201] -- <why>")
HINT_202 = ("assign the lock in __init__ (threading.Lock()/RLock()) or "
            "fix the annotation's lock name")

_GUARD_RE = re.compile(r"#:\s*guarded by self\.(\w+)")
#: a `self.X =` binding line: plain, annotated (`self.x: int = ...`), or
#: augmented (`self.x += ...`) assignment — never `==` comparison
_SELF_ATTR_RE = re.compile(
    r"self\.(\w+)\s*(?::[^=]+)?(?:[-+*/@&|^%]|//|>>|<<)?=(?!=)"
)


def _guarded_attrs(ctx: FileContext, cls: ast.ClassDef) -> tuple[dict, list]:
    """``({attr: (lock_name, annotation_line)}, unbound)`` from guard
    comments in the class's source span.  The annotation binds to a
    ``self.X =`` (or augmented) assignment on the same line or the nearest
    following line (within 3 lines, so a multi-line comment block above
    the assignment still binds).  Annotations that bind to nothing are
    returned in ``unbound`` — a silently dropped annotation would disable
    the rule while the author believes the attribute is checked."""
    out: dict[str, tuple] = {}
    unbound: list[tuple] = []
    end = cls.end_lineno or len(ctx.lines)
    for i in range(cls.lineno, end + 1):
        line = ctx.lines[i - 1] if i - 1 < len(ctx.lines) else ""
        m = _GUARD_RE.search(line)
        if not m:
            continue
        lock = m.group(1)
        for j in range(i, min(i + 4, end + 1)):
            cand = ctx.lines[j - 1] if j - 1 < len(ctx.lines) else ""
            am = _SELF_ATTR_RE.search(cand)
            if am:
                out[am.group(1)] = (lock, i)
                break
        else:
            unbound.append((lock, i))
    return out, unbound


def _class_assigns(cls: ast.ClassDef) -> set[str]:
    """Every ``self.X`` ever assigned anywhere in the class body."""
    names: set[str] = set()
    for node in ast.walk(cls):
        if isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            targets = (
                node.targets if isinstance(node, ast.Assign)
                else [node.target]
            )
            for t in targets:
                if isinstance(t, ast.Attribute) \
                        and isinstance(t.value, ast.Name) \
                        and t.value.id == "self":
                    names.add(t.attr)
    return names


def _with_locks(node: ast.With) -> set[str]:
    """Lock attribute names this ``with`` acquires (``with self._lock:``)."""
    locks: set[str] = set()
    for item in node.items:
        e = item.context_expr
        if isinstance(e, ast.Attribute) and isinstance(e.value, ast.Name) \
                and e.value.id == "self":
            locks.add(e.attr)
    return locks


def _check_method(ctx: FileContext, method: ast.FunctionDef,
                  guarded: dict) -> list[Finding]:
    findings: list[Finding] = []

    def visit(node: ast.AST, held: frozenset) -> None:
        if isinstance(node, ast.With):
            held = held | _with_locks(node)
        elif isinstance(node, ast.Attribute):
            if isinstance(node.value, ast.Name) and node.value.id == "self" \
                    and node.attr in guarded:
                lock, _ln = guarded[node.attr]
                if lock not in held:
                    findings.append(Finding(
                        "AVDB201", ctx.path, node.lineno,
                        f"guarded attribute self.{node.attr} accessed "
                        f"outside `with self.{lock}:` in "
                        f"{method.name!r}",
                        HINT_201,
                    ))
        for child in ast.iter_child_nodes(node):
            visit(child, held)

    for stmt in method.body:
        visit(stmt, frozenset())
    return findings


def check(ctx: FileContext) -> list[Finding]:
    findings: list[Finding] = []
    for cls in [n for n in ctx.nodes
                if isinstance(n, ast.ClassDef)]:
        guarded, unbound = _guarded_attrs(ctx, cls)
        for lock, ann_line in unbound:
            findings.append(Finding(
                "AVDB202", ctx.path, ann_line,
                f"`guarded by self.{lock}` annotation binds to no "
                f"`self.X =` assignment within 3 lines — the rule is "
                f"silently disabled for whatever it meant to guard",
                HINT_202,
            ))
        if not guarded:
            continue
        assigned = _class_assigns(cls)
        for attr, (lock, ann_line) in guarded.items():
            if lock not in assigned:
                findings.append(Finding(
                    "AVDB202", ctx.path, ann_line,
                    f"annotation guards self.{attr} with self.{lock}, but "
                    f"{cls.name} never assigns self.{lock}",
                    HINT_202,
                ))
        # methods other than __init__ (and only direct methods — a nested
        # class gets its own pass)
        for method in cls.body:
            if not isinstance(method, (ast.FunctionDef,
                                       ast.AsyncFunctionDef)):
                continue
            if method.name == "__init__":
                continue
            findings.extend(_check_method(ctx, method, guarded))
    return findings
