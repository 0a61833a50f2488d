"""``python -m annotatedvdb_tpu_torch.analysis`` — the port's static
analysis entry point (the counterpart of the reference's
``tools/avdb_check.py``).

Runs the ten AVDB rule families over the port's tree.  See README
"Static analysis & code health" for the rule catalog and the
suppression policy (``# avdb: noqa[CODE] -- reason``).

Usage:
    python -m annotatedvdb_tpu_torch.analysis [--json] [--diff REV] [paths...]

Default paths, relative to the repo root: the ``annotatedvdb_tpu_torch``
package, ``tests/test_torch_*.py``, ``chip_smoke.py`` and
``chip_annotate_variants.py``.  ``--diff REV`` analyzes only the ``.py``
files among those changed since ``REV`` (tracked changes + untracked
files), with the whole-project audit codes off.  Exit codes: 0 = clean,
1 = findings, 2 = usage/internal error.
"""

from __future__ import annotations

import argparse
import fnmatch
import glob
import json
import os
import subprocess
import sys

from annotatedvdb_tpu_torch.analysis import run_paths
from annotatedvdb_tpu_torch.analysis.core import PACKAGE, find_repo_root

#: the default scan, as root-relative paths or globs
DEFAULT_PATHS = (PACKAGE, "tests/test_torch_*.py", "chip_smoke.py",
                 "chip_annotate_variants.py")


def _in_scope(rel: str) -> bool:
    return any(rel == p or rel.startswith(p + "/") or fnmatch.fnmatch(rel, p)
               for p in DEFAULT_PATHS)


def default_paths(root: str) -> list:
    """The existing files and directories of :data:`DEFAULT_PATHS`."""
    out = []
    for p in DEFAULT_PATHS:
        out.extend(sorted(glob.glob(os.path.join(root, p))))
    return out


def changed_files(root: str, rev: str) -> list:
    """Repo-absolute ``.py`` paths changed since ``rev`` (the tracked diff
    plus untracked files) inside the default scan's scope."""
    rels: list = []
    for cmd in (
        ["git", "diff", "--name-only", rev],
        ["git", "ls-files", "--others", "--exclude-standard"],
    ):
        p = subprocess.run(cmd, capture_output=True, text=True, cwd=root)
        if p.returncode != 0:
            raise RuntimeError(
                f"`{' '.join(cmd)}` failed: {p.stderr.strip() or 'rc=' + str(p.returncode)}"
            )
        rels.extend(line.strip() for line in p.stdout.splitlines())
    out = set()
    for rel in rels:
        norm = rel.replace("\\", "/")
        full = os.path.join(root, rel)
        if norm.endswith(".py") and _in_scope(norm) and os.path.isfile(full):
            out.add(full)
    return sorted(out)


def _report(n_files: int, findings: list, exit_code: int) -> str:
    return json.dumps({
        "version": 1, "files_scanned": n_files,
        "findings": [f.as_dict() for f in findings], "exit_code": exit_code,
    }, indent=1, sort_keys=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m annotatedvdb_tpu_torch.analysis",
        description="avdb-check over the PyTorch port's tree")
    ap.add_argument("paths", nargs="*",
                    help="files/directories to analyze "
                         f"(default: {' '.join(DEFAULT_PATHS)})")
    ap.add_argument("--json", action="store_true",
                    help="emit the machine-readable report on stdout")
    ap.add_argument("--diff", metavar="REV", default=None,
                    help="analyze only .py files changed since REV "
                         "(tracked diff + untracked; audits off)")
    ap.add_argument("--loaderCli", action="append", default=None,
                    metavar="PATH",
                    help="override the CLI-contract file list (repeatable)")
    args = ap.parse_args(argv)

    root = find_repo_root(os.path.dirname(os.path.abspath(__file__)))
    if args.diff is not None:
        if args.paths:
            print("avdb-check: --diff and explicit paths are exclusive",
                  file=sys.stderr)
            return 2
        try:
            paths = changed_files(root, args.diff)
        except RuntimeError as err:
            print(f"avdb-check: {err}", file=sys.stderr)
            return 2
        if not paths:
            if args.json:
                print(_report(0, [], 0))
            else:
                print(f"avdb-check: no python files changed since "
                      f"{args.diff}", file=sys.stderr)
            return 0
    else:
        paths = args.paths or default_paths(root)
        missing = [p for p in paths if not os.path.exists(p)]
        if missing:
            print(f"avdb-check: no such path: {', '.join(missing)}",
                  file=sys.stderr)
            return 2
    try:
        findings, n_files = run_paths(
            paths,
            loader_clis=tuple(args.loaderCli) if args.loaderCli else None,
            audit=args.diff is None,
        )
    except Exception as err:  # internal analyzer error, not a finding
        print(f"avdb-check: internal error: {err!r}", file=sys.stderr)
        return 2
    exit_code = 1 if findings else 0
    if args.json:
        print(_report(n_files, findings, exit_code))
    else:
        for f in findings:
            print(f.render())
        print(f"avdb-check: {n_files} file(s), {len(findings)} finding(s)",
              file=sys.stderr)
    return exit_code


if __name__ == "__main__":
    raise SystemExit(main())
