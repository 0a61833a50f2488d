"""Replication name rules.

Trimmed host copy of ``annotatedvdb_tpu/store/replication.py``: the two
names a follower leaves in a store directory (a bootstrap chunk temp and
the tail cursor), which ``doctor``'s fsck attributes.  Replication itself
(``serve --follow``, ``doctor promote``) is not ported yet.
"""

from __future__ import annotations

#: in-flight bootstrap chunk temp suffix
REPL_TMP_SUFFIX = ".repl.tmp"

#: the follower's cursor ledger; its presence marks a follower mid-sync
CURSOR_FILE = "repl.cursor.json"


def is_repl_tmp(fname: str) -> bool:
    """Whether a store-directory entry is an in-flight (or abandoned)
    replication bootstrap chunk temp."""
    return fname.endswith(REPL_TMP_SUFFIX)


def is_repl_cursor(fname: str) -> bool:
    """Whether an entry is a follower bootstrap/tail cursor ledger."""
    return fname == CURSOR_FILE
