"""AVDB10xx — durability-protocol rules: the store's commit discipline,

Port of ``annotatedvdb_tpu/analysis/rules_durability.py``.
machine-checked.

Every store writer — save(), memtable flush, WAL append/rotate,
compaction, replication shipping, promotion, fsck repair — follows the
same tmp -> fsync -> rename -> manifest-commit protocol, and until now
followed it purely by convention, policed only by hand-written
fault-matrix tests.  These rules make the protocol's shape structural,
the way AVDB3xx made the fault-point registry structural.  The runtime
complement (what the executed interleaving actually did) is the
``AVDB_IO_TRACE`` sanitizer in :mod:`annotatedvdb_tpu_torch.analysis.iotrace`.

Codes (scoped to ``store/`` modules; fixture trees drive the same rules
through the path-suffix convention rules_parity established):

- **AVDB1001** — an ``os.replace``/``os.rename`` whose SOURCE was opened
  for writing in the same function must fsync that file object between
  the open and the rename (or write through the blessed ``_CrcWriter``/
  ``replace_manifest`` machinery).  Renames of files produced elsewhere
  are undecidable per-function and stay silent — the dynamic sanitizer
  owns them.
- **AVDB1002** — a tmp-suffix string literal a writer creates
  (``.flush.tmp``, ``.compact.tmp``, ...) must be attributed by a
  ``store/fsck.py`` finding code named ``<family>-tmp`` — crash debris
  an fsck cannot name is debris an operator cannot triage.
  Cross-referenced against the scanned fsck source the way AVDB302
  cross-references ``faults.POINTS``; gated off when ``store/fsck.py``
  is not in the scan set (``--diff`` partial scans).
- **AVDB1003** — the same tmp family must have a
  ``tests/data/corrupt_store`` fixture file, so the fsck test tree
  actually exercises the attribution.  Same gating as AVDB1002.
- **AVDB1004** — every function performing a manifest replace must
  contain a ``faults.fire`` crash point: a commit point without an
  injectable crash is a commit point the matrix cannot test.
- **AVDB1005** — WAL ack ordering.  (a) ``WriteAheadLog.append`` must
  fsync, and no value may return before the fsync — returning IS the
  durability promise the 200 rides; (b) a serve front-end function that
  calls ``.upsert(...)`` must not build a 200 response before that call.
"""

from __future__ import annotations

import ast
import os
import re

from annotatedvdb_tpu_torch.analysis.core import (
    FileContext,
    Finding,
    Project,
    ProjectFacts,
)

HINT_1001 = ("fsync the written file object before renaming it into "
             "place (or route the commit through utils.io.replace_"
             "manifest / a _CrcWriter-backed writer)")
HINT_1002 = ("add a `<family>-tmp` finding code to store/fsck.py's "
             "directory scan so this crash debris is attributed")
HINT_1003 = ("add a fixture file carrying this tmp suffix to "
             "tests/data/corrupt_store so fsck's attribution is "
             "exercised by the fixture tree")
HINT_1004 = ("add a faults.fire crash point to this commit function and "
             "a fault-matrix test case (an uninjectable commit point is an "
             "untestable one)")
HINT_1005 = ("order the durable call before the ack: fsync before any "
             "value-return in WAL append; `.upsert(...)` before any "
             "200-building return in a front end")

#: module names the traced-I/O wrappers are imported under
_IO_WRAPPER_BASES = frozenset({"tio", "io"})

_TMP_FAMILY_RE = re.compile(r"\.([a-z]+)\.tmp")

#: write-open mode characters (`open(path, "r+b")` counts: it can dirty
#: an existing durable file)
_WRITE_MODE = frozenset("wax+")


def _is_store_file(path: str) -> bool:
    norm = path.replace("\\", "/")
    return "/store/" in norm or norm.startswith("store/")


def _is_front_end(path: str) -> bool:
    norm = path.replace("\\", "/")
    return norm.endswith("serve/http.py") or norm.endswith("serve/aio.py")


def _is_fsck_file(path: str) -> bool:
    return path.replace("\\", "/").endswith("store/fsck.py")


def _attr_call(node: ast.Call) -> tuple[str, str] | None:
    """("base", "attr") for a ``base.attr(...)`` call on a plain Name."""
    f = node.func
    if isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name):
        return f.value.id, f.attr
    return None


def _is_open_call(node: ast.Call) -> bool:
    f = node.func
    if isinstance(f, ast.Name) and f.id == "open":
        return True
    ba = _attr_call(node)
    return ba is not None and ba[1] == "open" \
        and ba[0].lstrip("_") in _IO_WRAPPER_BASES | {"builtins"}


def _is_rename_call(node: ast.Call) -> bool:
    ba = _attr_call(node)
    return ba is not None and ba[1] in {"rename", "replace"} \
        and ba[0].lstrip("_") in _IO_WRAPPER_BASES | {"os"}


def _is_fsync_call(node: ast.Call) -> bool:
    ba = _attr_call(node)
    if ba is not None and ba[1] == "fsync" \
            and ba[0].lstrip("_") in _IO_WRAPPER_BASES | {"os"}:
        return True
    return isinstance(node.func, ast.Name) and node.func.id == "fsync"


def _is_fire_call(node: ast.Call) -> bool:
    ba = _attr_call(node)
    return ba is not None and ba[1] in {"fire", "maybe_fire"} \
        and ba[0].lstrip("_") == "faults"


def _fsync_target(node: ast.Call) -> str | None:
    """The file-object Name an fsync call targets: ``fsync(f)``,
    ``fsync(f.fileno())`` and ``os.fsync(f.fileno())`` all yield "f"."""
    if not node.args:
        return None
    arg = node.args[0]
    if isinstance(arg, ast.Name):
        return arg.id
    if isinstance(arg, ast.Call) and isinstance(arg.func, ast.Attribute) \
            and arg.func.attr == "fileno" \
            and isinstance(arg.func.value, ast.Name):
        return arg.func.value.id
    return None


def _write_mode(node: ast.Call) -> bool:
    if len(node.args) < 2:
        return False
    mode = node.args[1]
    return isinstance(mode, ast.Constant) and isinstance(mode.value, str) \
        and bool(_WRITE_MODE & set(mode.value))


def _mentions_manifest(node: ast.AST) -> bool:
    for sub in ast.walk(node):
        if isinstance(sub, ast.Constant) and isinstance(sub.value, str) \
                and "manifest.json" in sub.value:
            return True
    return False


def _check_function(func: ast.AST, ctx: FileContext,
                    findings: list, seen: set) -> None:
    """AVDB1001 + AVDB1004 over one function body (nested defs are walked
    as part of their parent AND on their own; ``seen`` dedupes)."""
    # -- gather sites --------------------------------------------------------
    opens: list = []    # (path_name, file_name, line)
    fsyncs: list = []   # (target_name, line)
    renames: list = []  # (src_name or None, node)
    assigns: dict = {}  # name -> value AST (function-local)
    has_fire = False
    uses_crc = False
    manifest_calls: list = []  # lines of manifest-replace calls

    body_walk = [n for stmt in getattr(func, "body", [])
                 for n in ast.walk(stmt)]
    for node in body_walk:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            assigns[node.targets[0].id] = node.value
        if isinstance(node, ast.withitem) \
                and isinstance(node.context_expr, ast.Call) \
                and _is_open_call(node.context_expr) \
                and _write_mode(node.context_expr) \
                and node.context_expr.args \
                and isinstance(node.context_expr.args[0], ast.Name) \
                and isinstance(node.optional_vars, ast.Name):
            opens.append((
                node.context_expr.args[0].id,
                node.optional_vars.id,
                node.context_expr.lineno,
            ))
        if not isinstance(node, ast.Call):
            continue
        if isinstance(node.func, ast.Name) and node.func.id == "_CrcWriter":
            uses_crc = True
        if _is_fire_call(node):
            has_fire = True
        if _is_fsync_call(node):
            target = _fsync_target(node)
            if target is not None:
                fsyncs.append((target, node.lineno))
        if _is_rename_call(node) and len(node.args) >= 2:
            src = node.args[0]
            renames.append((
                src.id if isinstance(src, ast.Name) else None, node,
            ))
            if _mentions_manifest(node.args[1]) or (
                isinstance(node.args[1], ast.Name)
                and node.args[1].id in assigns
                and _mentions_manifest(assigns[node.args[1].id])
            ):
                manifest_calls.append(node.lineno)
        ba = _attr_call(node)
        callee = ba[1] if ba is not None else (
            node.func.id if isinstance(node.func, ast.Name) else None
        )
        if callee in {"replace_manifest", "_atomic_write"}:
            if callee == "replace_manifest" or any(
                _mentions_manifest(a) for a in node.args
            ):
                manifest_calls.append(node.lineno)

    # -- AVDB1001: rename of a locally-written file needs its fsync ----------
    for src_name, node in renames:
        if src_name is None:
            continue
        prior = [o for o in opens
                 if o[0] == src_name and o[2] < node.lineno]
        if not prior:
            continue  # source written elsewhere: the dynamic layer's job
        _path_name, file_name, open_line = prior[-1]
        synced = uses_crc or any(
            t == file_name and open_line < line < node.lineno
            for t, line in fsyncs
        )
        if not synced and ("AVDB1001", node.lineno) not in seen:
            seen.add(("AVDB1001", node.lineno))
            findings.append(Finding(
                "AVDB1001", ctx.path, node.lineno,
                f"rename of {src_name!r} (opened for writing as "
                f"{file_name!r} at line {open_line}) is not preceded by "
                f"an fsync of that file",
                HINT_1001,
            ))

    # -- AVDB1004: a manifest replace needs an injectable crash point --------
    if manifest_calls and not has_fire:
        line = min(manifest_calls)
        if ("AVDB1004", line) not in seen:
            seen.add(("AVDB1004", line))
            findings.append(Finding(
                "AVDB1004", ctx.path, line,
                f"function {getattr(func, 'name', '<module>')!r} replaces "
                f"the manifest but contains no faults.fire crash point",
                HINT_1004,
            ))


def check(ctx: FileContext) -> list[Finding]:
    findings: list[Finding] = []
    seen: set = set()

    if _is_store_file(ctx.path):
        for node in ctx.nodes:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                _check_function(node, ctx, findings, seen)
            # -- AVDB1005a: WAL append must fsync before any value-return
            if isinstance(node, ast.ClassDef) \
                    and "WriteAheadLog" in node.name:
                for item in node.body:
                    if isinstance(item, ast.FunctionDef) \
                            and item.name == "append":
                        findings.extend(_check_wal_append(item, ctx))

    if _is_front_end(ctx.path):
        for node in ctx.nodes:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                findings.extend(_check_ack_order(node, ctx))

    return findings


def _check_wal_append(func: ast.FunctionDef, ctx: FileContext) -> list:
    findings: list = []
    fsync_lines = [
        n.lineno for n in ast.walk(func)
        if isinstance(n, ast.Call) and _is_fsync_call(n)
    ]
    returns = [
        n for n in ast.walk(func)
        if isinstance(n, ast.Return) and n.value is not None
    ]
    if not fsync_lines:
        findings.append(Finding(
            "AVDB1005", ctx.path, func.lineno,
            "WriteAheadLog.append never fsyncs — returning is the "
            "durability promise the ack rides",
            HINT_1005,
        ))
        return findings
    first_fsync = min(fsync_lines)
    for ret in returns:
        if ret.lineno < first_fsync:
            findings.append(Finding(
                "AVDB1005", ctx.path, ret.lineno,
                f"WAL append returns a value at line {ret.lineno}, "
                f"before the fsync at line {first_fsync} — an ack "
                f"could outrun durability",
                HINT_1005,
            ))
    return findings


def _check_ack_order(func: ast.AST, ctx: FileContext) -> list:
    findings: list = []
    upsert_lines = [
        n.lineno for n in ast.walk(func)
        if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
        and n.func.attr == "upsert"
    ]
    if not upsert_lines:
        return findings
    first_upsert = min(upsert_lines)
    for node in ast.walk(func):
        if not (isinstance(node, ast.Return)
                and isinstance(node.value, ast.Tuple)
                and node.value.elts):
            continue
        status = node.value.elts[0]
        if isinstance(status, ast.Constant) and status.value == 200 \
                and node.lineno < first_upsert:
            findings.append(Finding(
                "AVDB1005", ctx.path, node.lineno,
                f"200 response built at line {node.lineno}, before the "
                f"durable `.upsert(...)` call at line {first_upsert} — "
                f"the ack would not ride the WAL fsync",
                HINT_1005,
            ))
    return findings


# ---------------------------------------------------------------------------
# AVDB1002/1003 — tmp-suffix families cross-referenced against fsck and
# the corrupt_store fixture tree (project rule: collect + finalize)


def collect(ctx: FileContext, facts: ProjectFacts, project: Project) -> None:
    if not _is_store_file(ctx.path):
        return
    if _is_fsck_file(ctx.path):
        facts.fsck_scan = True
        facts.fsck_path = ctx.path
        for node in ctx.nodes:
            if isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Name) \
                    and node.func.id == "note" and len(node.args) >= 2 \
                    and isinstance(node.args[1], ast.Constant) \
                    and isinstance(node.args[1].value, str):
                facts.fsck_codes.add(node.args[1].value)
    # f-string pieces are not writer-created suffixes (`.manifest.tmp{pid}`
    # is the helper's own dot-tmp, attributed as generic stale-tmp debris)
    joined: set = set()
    for node in ctx.nodes:
        if isinstance(node, ast.JoinedStr):
            for part in node.values:
                joined.add(id(part))
    for node in ctx.nodes:
        if not (isinstance(node, ast.Constant)
                and isinstance(node.value, str)
                and id(node) not in joined):
            continue
        m = _TMP_FAMILY_RE.search(node.value)
        if m:
            facts.tmp_suffixes.append(
                (ctx.path, node.lineno, m.group(1))
            )


def finalize(facts: ProjectFacts, project: Project) -> list[Finding]:
    findings: list[Finding] = []
    if not facts.fsck_scan:
        return findings  # fsck not scanned (--diff subset): undecidable
    fixture_dir = os.path.join(
        project.root, "tests", "data", "corrupt_store"
    )
    try:
        fixture_names = os.listdir(fixture_dir)
    except OSError:
        fixture_names = []
    reported: set = set()
    for path, line, family in sorted(facts.tmp_suffixes,
                                     key=lambda t: (t[2], t[0], t[1])):
        if family in reported:
            continue
        reported.add(family)
        if f"{family}-tmp" not in facts.fsck_codes:
            findings.append(Finding(
                "AVDB1002", path, line,
                f"tmp suffix family '.{family}.tmp' is not attributed by "
                f"a '{family}-tmp' fsck finding code",
                HINT_1002,
            ))
        if not any(f".{family}.tmp" in name for name in fixture_names):
            findings.append(Finding(
                "AVDB1003", path, line,
                f"tmp suffix family '.{family}.tmp' has no "
                f"tests/data/corrupt_store fixture file",
                HINT_1003,
            ))
    return findings
