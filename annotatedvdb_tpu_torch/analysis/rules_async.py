"""AVDB7xx — async-safety: the event loop must never block.

Port of ``annotatedvdb_tpu/analysis/rules_async.py``.

The aio front end serves every connection from ONE thread; a single
blocking call on the loop stalls every in-flight request at once (and, in
a fleet, stops the heartbeat the wedged-worker watchdog reads — a 30ms
file open under load is indistinguishable from a wedge precursor).  This
family catches such calls statically.

Codes:

- **AVDB701** — a blocking call from the curated blocklist inside an
  ``async def`` body, or inside a sync function an async function calls
  *intra-module* (transitively: ``async _main -> _start_tick -> open()``
  is exactly the shape that shipped).  The blocklist: ``time.sleep``,
  ``open()``, blocking socket ops (``accept``/``recv``/``recvfrom``/
  ``connect``/``sendall``, ``socket.create_connection``/``getaddrinfo``),
  ``subprocess.*``, ``urllib`` requests, blocking filesystem ``os.*``
  calls, ``concurrent.futures`` ``.result()``/``.acquire()``, and a
  plain ``with <lock>:`` (a sync-lock acquire parks the loop whenever
  the holder is off-loop).  Blocking work belongs on the executor
  (``loop.run_in_executor`` — passing the function as an argument is
  not a call, so routed work is exempt by construction) or behind a
  ``# avdb: noqa[AVDB701] -- reason``.
- **AVDB702** — ``await`` while a sync lock is held (``with <lock>:``
  enclosing an ``await``): the loop suspends the coroutine with the lock
  held, and any OTHER thread touching that lock now blocks for an
  unbounded number of scheduler turns — the cross-thread half of a
  lock-order inversion the dynamic detector (``analysis/lockorder``)
  sees only when it fires.

Nested function definitions are NOT part of the enclosing async context
(callbacks run wherever their executor runs), and only calls that
statically resolve — ``name(...)`` to a module-level function,
``self.name(...)`` to a method of the same class — are followed;
cross-module and attribute-of-attribute calls are out of scope (kept
tractable; the parity/lock families cover those surfaces).
"""

from __future__ import annotations

import ast

from annotatedvdb_tpu_torch.analysis.core import FileContext, Finding

HINT_701 = ("route the blocking work through loop.run_in_executor (or a "
            "thread), or justify with # avdb: noqa[AVDB701] -- reason")
HINT_702 = ("release the sync lock before awaiting (snapshot under the "
            "lock, await outside), or use an asyncio.Lock")

#: bare-name calls that block wherever they run
_BLOCKING_BARE = {"open", "input", "breakpoint"}

#: (root, attr) dotted calls that block; attr None = every attr
_BLOCKING_ROOTS = {
    "subprocess": None,
    "time": {"sleep"},
    "socket": {"create_connection", "getaddrinfo", "gethostbyname"},
    "os": {"stat", "fsync", "remove", "unlink", "rename", "replace",
           "makedirs", "listdir", "scandir", "sendfile"},
    "shutil": None,
    "urllib": None,
    "requests": None,
}

#: method names that are blocking regardless of the receiver: socket ops
#: and concurrent.futures Future/Lock primitives.  ``.result()`` on an
#: asyncio future inside async code should be ``await`` anyway.
_BLOCKING_METHODS = {"accept", "recv", "recvfrom", "sendall", "connect",
                     "result", "acquire"}

_DEFS = (ast.FunctionDef, ast.AsyncFunctionDef)


def _dotted(node: ast.AST) -> list | None:
    parts: list = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return parts[::-1]
    return None


def _is_lockish(expr: ast.AST) -> str | None:
    """The lock-ish name a ``with`` item acquires, or None.  Matches any
    terminal name containing "lock"/"mutex" (``self._lock``,
    ``cache_lock``, ``self.mu`` does not match — naming IS the contract
    here, same as the ``#: guarded by`` convention)."""
    name = None
    if isinstance(expr, ast.Attribute):
        name = expr.attr
    elif isinstance(expr, ast.Name):
        name = expr.id
    elif isinstance(expr, ast.Call):
        # with lock.acquire_timeout(...) etc: judge the method's receiver
        return None
    if name is not None and ("lock" in name.lower()
                             or "mutex" in name.lower()):
        return name
    return None


def _scope_nodes(fn: ast.AST):
    """All nodes lexically in ``fn``'s own body, never descending into
    nested function/class definitions (callbacks are not this context)."""
    stack = [c for c in ast.iter_child_nodes(fn)
             if not isinstance(c, _DEFS + (ast.ClassDef, ast.Lambda))]
    while stack:
        n = stack.pop()
        yield n
        for c in ast.iter_child_nodes(n):
            if isinstance(c, _DEFS + (ast.ClassDef, ast.Lambda)):
                continue
            stack.append(c)


def _blocking_calls(fn: ast.AST):
    """[(node, rendered_name)] blocklist hits lexically inside ``fn``."""
    hits = []
    for node in _scope_nodes(fn):
        if isinstance(node, ast.Call):
            func = node.func
            if isinstance(func, ast.Name) and func.id in _BLOCKING_BARE:
                hits.append((node, func.id))
                continue
            chain = _dotted(func)
            if not chain:
                continue
            if chain[0] in _BLOCKING_ROOTS and len(chain) >= 2:
                attrs = _BLOCKING_ROOTS[chain[0]]
                if attrs is None or chain[-1] in attrs:
                    hits.append((node, ".".join(chain)))
                    continue
            if len(chain) >= 2 and chain[-1] in _BLOCKING_METHODS:
                hits.append((node, ".".join(chain)))
        elif isinstance(node, ast.With):
            for item in node.items:
                lock = _is_lockish(item.context_expr)
                if lock is not None:
                    hits.append((node, f"with {lock}:"))
    return hits


def _awaits_under_lock(fn: ast.AsyncFunctionDef):
    """[(await_node, lock_name)] — awaits lexically inside a sync
    ``with <lock>:`` block of this async function."""
    out = []

    def visit(node: ast.AST, held: tuple):
        if isinstance(node, _DEFS + (ast.ClassDef, ast.Lambda)) \
                and node is not fn:
            return
        if isinstance(node, ast.With):
            locks = [
                _is_lockish(i.context_expr) for i in node.items
            ]
            held = held + tuple(n for n in locks if n)
        elif isinstance(node, ast.Await) and held:
            out.append((node, held[-1]))
        for child in ast.iter_child_nodes(node):
            visit(child, held)

    visit(fn, ())
    return out


def _local_callees(fn: ast.AST, module_funcs: dict, methods: dict) -> set:
    """Function defs this scope calls that resolve intra-module:
    ``name(...)`` to a module-level def, ``self.name(...)`` to a method
    of the enclosing class (``methods``)."""
    out = set()
    for node in _scope_nodes(fn):
        if not isinstance(node, ast.Call):
            continue
        func = node.func
        if isinstance(func, ast.Name) and func.id in module_funcs:
            out.add(module_funcs[func.id])
        elif isinstance(func, ast.Attribute) \
                and isinstance(func.value, ast.Name) \
                and func.value.id == "self" and func.attr in methods:
            out.add(methods[func.attr])
    return out


def check(ctx: FileContext) -> list[Finding]:
    if "async def" not in ctx.source:
        return []  # no coroutine: no event-loop context to judge
    tree = ctx.tree
    module_funcs = {
        s.name: s for s in tree.body if isinstance(s, _DEFS)
    }
    class_methods: dict[int, dict] = {}
    owner: dict[int, ast.ClassDef] = {}
    for cls in [n for n in ctx.nodes if isinstance(n, ast.ClassDef)]:
        table = {
            s.name: s for s in cls.body if isinstance(s, _DEFS)
        }
        class_methods[id(cls)] = table
        for m in table.values():
            owner[id(m)] = cls

    findings: list[Finding] = []
    reported: set = set()

    def methods_for(fn) -> dict:
        cls = owner.get(id(fn))
        return class_methods.get(id(cls), {}) if cls is not None else {}

    roots = [n for n in ctx.nodes
             if isinstance(n, ast.AsyncFunctionDef)]
    for root in roots:
        # transitive intra-module closure of the async context
        closure = [root]
        seen = {id(root)}
        i = 0
        while i < len(closure):
            fn = closure[i]
            i += 1
            for callee in _local_callees(fn, module_funcs,
                                         methods_for(fn)):
                if id(callee) not in seen \
                        and not isinstance(callee, ast.AsyncFunctionDef):
                    seen.add(id(callee))
                    closure.append(callee)
        for fn in closure:
            for node, name in _blocking_calls(fn):
                key = (node.lineno, name)
                if key in reported:
                    continue
                reported.add(key)
                where = (
                    f"async function {root.name!r}" if fn is root
                    else f"{fn.name!r} (reached from async "
                         f"{root.name!r})"
                )
                findings.append(Finding(
                    "AVDB701", ctx.path, node.lineno,
                    f"blocking call {name} on the event loop in {where}",
                    HINT_701,
                ))
        for node, lock in _awaits_under_lock(root):
            key = (node.lineno, "await", lock)
            if key in reported:
                continue
            reported.add(key)
            findings.append(Finding(
                "AVDB702", ctx.path, node.lineno,
                f"await while sync lock {lock!r} is held in async "
                f"function {root.name!r}",
                HINT_702,
            ))
    return findings
