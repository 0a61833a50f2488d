"""AVDB1xx — capture-safety: captured torch code must stay host-pure.

Port of ``annotatedvdb_tpu/analysis/rules_trace.py``.  The reference
judges the functions JAX traces (``jax.jit``, ``pjit``, ``shard_map``);
the port has none of those, and judges the functions torch captures:

- ``torch.compile`` — as a decorator (``@torch.compile``,
  ``@torch.compile(...)``, ``@functools.partial(torch.compile, ...)``) or
  a wrap (``f_c = torch.compile(f)``, ``torch.compile(...)(f)``,
  ``functools.partial(torch.compile, ...)(f)``);
- ``torch.jit.script`` and ``torch.jit.trace``, as decorators or wraps;
- every function called by name inside a ``with torch.cuda.graph(...)``
  block (the capture records the calls' kernels once and replays them).

A host side effect in captured code (a ``print``, a metrics call, an env
read, a fault hook) runs once, at capture, and never on the replays; a
Python ``if``/``while`` on a tensor argument is decided once, at capture,
from the example values (or breaks the graph).  Both are statically
visible.

Codes:

- **AVDB101** — host side effect (print/open/logging/metrics/faults/env/
  time/global) inside a captured function;
- **AVDB102** — ``if``/``while``/``assert`` whose condition reads a
  captured parameter directly (``.shape``/``.ndim``/``.dtype``/
  ``.size``/``.dim``/``.device`` reads and ``len()`` are static under
  capture and exempt, as are parameters annotated with a Python scalar
  type — ``bool``/``int``/``float``/``str`` — on which the capture
  specializes).
"""

from __future__ import annotations

import ast

from annotatedvdb_tpu_torch.analysis.core import FileContext, Finding

HINT_101 = ("hoist the host call out of the captured function (do it at "
            "the call site, per chunk), outside the compiled region")
HINT_102 = ("branch with torch.where, or make the parameter a Python "
            "scalar the capture specializes on (annotate it bool/int/str)")

#: dotted-name endings that capture a function (``torch.compile``,
#: ``torch.jit.script``, ``torch.jit.trace``)
_CAPTURE_TAILS = (("torch", "compile"), ("jit", "script"), ("jit", "trace"))

#: the ``with`` context whose body a CUDA graph captures
_GRAPH_TAIL = ("cuda", "graph")

#: bare-name calls that are host side effects inside a capture
_HOST_CALLS = {"print", "input", "breakpoint", "open", "exec", "eval"}

#: attribute-chain roots that are host side effects inside a capture
#: (``torch.rand`` is fine — its chain root is "torch"; stdlib random is not)
_HOST_ROOTS = {"os", "logging", "faults", "random", "time", "socket",
               "subprocess", "shutil"}

#: method names that are metric/fault emissions regardless of the base
#: object (``counter.inc``, ``hist.observe``, ``faults.maybe_fire``)
_HOST_METHODS = {"maybe_fire", "inc", "dec", "observe"}

#: attribute reads on a captured value that stay static under capture
_STATIC_ATTRS = {"shape", "ndim", "dtype", "size", "dim", "device"}

#: parameter annotations the capture specializes on (guarded constants)
_STATIC_TYPES = {"bool", "int", "float", "str"}

_DEFS = (ast.FunctionDef, ast.AsyncFunctionDef)


def _dotted(node: ast.AST) -> list[str] | None:
    """``a.b.c`` -> ["a", "b", "c"]; None for non-name chains."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return parts[::-1]
    return None


def _ends_with(node: ast.AST, tails) -> bool:
    chain = _dotted(node)
    return bool(chain) and any(tuple(chain[-len(t):]) == t for t in tails)


def _is_capture(node: ast.AST) -> bool:
    """``torch.compile`` / ``torch.jit.script`` / ``torch.jit.trace``."""
    return _ends_with(node, _CAPTURE_TAILS)


def _capture_call_of(node: ast.AST) -> bool:
    """A call that returns a capturing decorator: ``torch.compile(...)``
    with no function argument, or ``partial(torch.compile, ...)``."""
    if not isinstance(node, ast.Call):
        return False
    if _is_capture(node.func):
        return not node.args
    return _ends_with(node.func, (("partial",),)) and bool(node.args) \
        and _is_capture(node.args[0])


def _static_params(fn: ast.FunctionDef) -> set[str]:
    args = fn.args.posonlyargs + fn.args.args + fn.args.kwonlyargs
    return {a.arg for a in args
            if isinstance(a.annotation, ast.Name)
            and a.annotation.id in _STATIC_TYPES}


def _iter_scope_stmts(body):
    """Statements lexically in this scope: descends into compound-statement
    blocks but never into nested function/class bodies."""
    for s in body:
        yield s
        if isinstance(s, _DEFS + (ast.ClassDef,)):
            continue
        for attr in ("body", "orelse", "finalbody"):
            yield from _iter_scope_stmts(getattr(s, attr, None) or [])
        for h in getattr(s, "handlers", None) or []:
            yield from _iter_scope_stmts(h.body)


def _iter_scope_exprs(body):
    """All AST nodes in this scope's statements, stopping at nested
    function/class bodies (their decorators ARE yielded)."""
    for s in _iter_scope_stmts(body):
        if isinstance(s, _DEFS + (ast.ClassDef,)):
            for dec in s.decorator_list:
                yield from ast.walk(dec)
            continue
        stack = [s]
        while stack:
            n = stack.pop()
            yield n
            for c in ast.iter_child_nodes(n):
                if isinstance(c, _DEFS + (ast.ClassDef,)):
                    for dec in c.decorator_list:
                        yield from ast.walk(dec)
                    continue
                stack.append(c)


def find_captured_functions(tree: ast.Module) -> list:
    """Every function this module captures via decorator, wrap, or a call
    inside a ``torch.cuda.graph`` block."""
    captured: dict[int, ast.AST] = {}

    def resolve(name: str, env_stack) -> ast.AST | None:
        for env in reversed(env_stack):
            if name in env:
                return env[name]
        return None

    def mark(name: str, env_stack) -> None:
        target = resolve(name, env_stack)
        if isinstance(target, _DEFS):
            captured[id(target)] = target

    def handle_decorators(fn) -> None:
        for dec in fn.decorator_list:
            if _is_capture(dec) or _capture_call_of(dec):
                captured[id(fn)] = fn

    def handle_call(call: ast.Call, env_stack) -> None:
        if _is_capture(call.func):
            # torch.compile(f, ...) / torch.jit.script(f) / .trace(f, x)
            if call.args and isinstance(call.args[0], ast.Name):
                mark(call.args[0].id, env_stack)
        elif _ends_with(call.func, (("partial",),)) and len(call.args) > 1 \
                and _is_capture(call.args[0]) \
                and isinstance(call.args[1], ast.Name):
            # partial(torch.compile, f, ...)
            mark(call.args[1].id, env_stack)
        elif _capture_call_of(call.func) and call.args \
                and isinstance(call.args[0], ast.Name):
            # torch.compile(...)(f) / partial(torch.compile, ...)(f)
            mark(call.args[0].id, env_stack)

    def handle_graph(node: ast.With, env_stack) -> None:
        if not any(isinstance(i.context_expr, ast.Call)
                   and _ends_with(i.context_expr.func, (_GRAPH_TAIL,))
                   for i in node.items):
            return
        for stmt in node.body:
            for sub in ast.walk(stmt):
                if isinstance(sub, ast.Call) \
                        and isinstance(sub.func, ast.Name):
                    mark(sub.func.id, env_stack)

    def process_scope(body, env_stack) -> None:
        env = {
            s.name: s for s in _iter_scope_stmts(body)
            if isinstance(s, _DEFS)
        }
        stack2 = env_stack + [env]
        for node in _iter_scope_exprs(body):
            if isinstance(node, ast.Call):
                handle_call(node, stack2)
            elif isinstance(node, ast.With):
                handle_graph(node, stack2)
        for s in _iter_scope_stmts(body):
            if isinstance(s, _DEFS):
                handle_decorators(s)
                process_scope(s.body, stack2)
            elif isinstance(s, ast.ClassDef):
                process_scope(s.body, stack2)

    process_scope(tree.body, [])
    return list(captured.values())


def _check_captured_body(ctx: FileContext,
                         fn: ast.FunctionDef) -> list[Finding]:
    findings: list[Finding] = []
    params = {
        a.arg
        for a in (fn.args.posonlyargs + fn.args.args + fn.args.kwonlyargs)
    } - _static_params(fn) - {"self"}

    parents: dict[int, ast.AST] = {}
    for node in ast.walk(fn):
        for child in ast.iter_child_nodes(node):
            parents[id(child)] = node

    def captured_names_in(test: ast.AST) -> list[str]:
        hits = []
        for node in ast.walk(test):
            if not (isinstance(node, ast.Name) and node.id in params):
                continue
            parent = parents.get(id(node))
            if isinstance(parent, ast.Attribute) \
                    and parent.attr in _STATIC_ATTRS:
                continue
            if isinstance(parent, ast.Call) \
                    and isinstance(parent.func, ast.Name) \
                    and parent.func.id in {"len", "isinstance", "type"}:
                continue
            hits.append(node.id)
        return hits

    for node in ast.walk(fn):
        if isinstance(node, ast.Call):
            chain = _dotted(node.func)
            bad = None
            if isinstance(node.func, ast.Name) \
                    and node.func.id in _HOST_CALLS:
                bad = node.func.id
            elif chain and chain[0] in _HOST_ROOTS:
                bad = ".".join(chain)
            elif chain and len(chain) >= 2 and chain[-1] in _HOST_METHODS:
                bad = ".".join(chain)
            elif chain and len(chain) >= 3 and chain[0] == "sys" \
                    and chain[1] in {"stdout", "stderr"}:
                bad = ".".join(chain)
            if bad is not None:
                findings.append(Finding(
                    "AVDB101", ctx.path, node.lineno,
                    f"host side effect {bad}() inside captured function "
                    f"{fn.name!r}",
                    HINT_101,
                ))
        elif isinstance(node, ast.Subscript):
            chain = _dotted(node.value)
            if chain and chain[-2:] == ["os", "environ"] or \
                    (chain and chain == ["environ"]):
                findings.append(Finding(
                    "AVDB101", ctx.path, node.lineno,
                    f"os.environ access inside captured function "
                    f"{fn.name!r}",
                    HINT_101,
                ))
        elif isinstance(node, ast.Global):
            findings.append(Finding(
                "AVDB101", ctx.path, node.lineno,
                f"global statement inside captured function {fn.name!r}",
                HINT_101,
            ))
        elif isinstance(node, (ast.If, ast.While, ast.Assert)):
            names = captured_names_in(node.test)
            if names:
                findings.append(Finding(
                    "AVDB102", ctx.path, node.lineno,
                    f"Python branch on captured value(s) "
                    f"{', '.join(sorted(set(names)))} inside captured "
                    f"function {fn.name!r}",
                    HINT_102,
                ))
    return findings


#: words one of which every capture spelling above contains: a module
#: without any captures nothing, and its AST walk is skipped
_CAPTURE_WORDS = ("compile", "jit", "graph")


def check(ctx: FileContext) -> list[Finding]:
    findings: list[Finding] = []
    if not any(w in ctx.source for w in _CAPTURE_WORDS):
        return findings
    for fn in find_captured_functions(ctx.tree):
        findings.extend(_check_captured_body(ctx, fn))
    return findings
