"""Project-native static analysis (``avdb-check``) and the runtime
tracers behind ``AVDB_IO_TRACE`` and ``AVDB_LOCK_TRACE``.

Port of ``annotatedvdb_tpu/analysis/``.  Rule families (each pinned
against the reference's fixtures, or the port's respellings of them, in
``tests/test_torch_analysis.py``; the catalog is README "Static analysis
& code health"):

==========  ============================================================
AVDB001     file does not parse (nothing else checked there)
AVDB1xx     capture-safety: host side effects / data-dependent branches
            in ``torch.compile``/``torch.jit`` code and CUDA-graph
            captures (``rules_trace``)
AVDB2xx     lock-discipline: ``#: guarded by self._lock`` attributes
            accessed outside their lock (``rules_locks``)
AVDB3xx     registry-drift: fault points vs ``faults.POINTS``; metric
            name/kind/label consistency; README refs (``rules_registry``)
AVDB4xx     env-var drift: ``AVDB_*``/``AVDBC_*`` reads vs
            ``runtime.ENV_VARS`` vs README (``rules_env``)
AVDB5xx     CLI-contract: the loader CLIs' shared flag set (``rules_cli``)
AVDB6xx     hygiene: bare except, silent Exception-pass, mutable default
            args, stale noqa suppressions (``rules_hygiene``)
AVDB7xx     async-safety: blocking calls on the event loop, await under a
            sync lock (``rules_async``)
AVDB8xx     cross-front-end parity between ``serve/http.py`` and
            ``serve/aio.py`` (``rules_parity``)
AVDB9xx     kernel/plain-version contract: ``*_launch`` wrappers vs the
            ``ops.TWINS`` registry and its tests (``rules_twins``)
AVDB10xx    durability protocol: fsync-before-rename, tmp-family
            attribution vs ``store/fsck.py`` and the corrupt_store
            fixtures, manifest-commit crash points, WAL/HTTP ack
            ordering (``rules_durability``)
==========  ============================================================

Entry point: ``python -m annotatedvdb_tpu_torch.analysis [--json] [--diff
REV] [paths...]`` — exit codes 0 (clean) / 1 (findings) / 2 (usage or
internal error).  Suppress a finding with ``# avdb: noqa[CODE] -- reason``.

The dynamic half: :mod:`~annotatedvdb_tpu_torch.analysis.lockorder`, the
lock-order/deadlock detector behind ``AVDB_LOCK_TRACE=1`` (see
``utils.locks.make_lock``), and
:mod:`~annotatedvdb_tpu_torch.analysis.iotrace`, the crash-consistency
sanitizer behind ``AVDB_IO_TRACE=1`` (see ``utils.io``).

Everything here is stdlib only: the analyser imports neither ``torch``
nor the rest of the package.
"""

from annotatedvdb_tpu_torch.analysis.core import (  # noqa: F401 (public API)
    LOADER_CLIS,
    Finding,
    iter_python_files,
    run_paths,
)

__all__ = ["Finding", "LOADER_CLIS", "iter_python_files", "run_paths"]
