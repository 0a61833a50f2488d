"""Store fsck: detect and repair torn, missing or orphaned segment state.

Port of ``annotatedvdb_tpu/store/fsck.py`` (``fsck``, ``_report``), the
``doctor`` default verb.  The store's crash story is "atomic manifest
swap, at most one checkpoint behind"; this module proves a directory is
in that state and restores it when it is not:

- **detect**: unreadable/missing manifest, segment files that are missing,
  size-mismatched (torn) or crc-mismatched (``deep=True``) against the
  manifest's write-time integrity records, orphaned segment/tmp files from
  crashed saves, the temps of killed compaction, flush, WAL-rotation,
  replication-bootstrap and export passes, WAL files pending replay,
  foreign files squatting in the directory, torn ledger lines, and
  dangling ``undo_intent`` records (a crash mid-undo);
- **repair** (opt-in): prune orphans and stale tmp files, rewrite the
  manifest without backing groups whose files are damaged (rolling the
  affected shard back to its last consistent rows), heal the ledger, and
  re-canonicalize via a load+save round trip;
- **prescribe**: when rows were (or may have been) lost, print the
  re-load / re-undo command that restores them.

Reports, finding codes and messages are the reference's byte for byte,
so the prescriptions name the reference's commands as it prints them.
Host only: the store loads here never touch the card.  The
``fsck.repair`` fault point fires on the staged rolled-back manifest.

Exit codes: 0 = clean, 1 = warnings or successfully repaired, 2 = errors
remain.
"""

from __future__ import annotations

import json
import os
import re

from annotatedvdb_tpu_torch.utils import faults
from annotatedvdb_tpu_torch.utils import io as tio

SEGMENT_RE = re.compile(
    r"^chr(?P<label>[0-9A-Za-z_]+)\.(?P<sid>\d{6})\.(npz|ann\.jsonl)$"
)


class Finding:
    """One fsck observation.  ``level``: info < warn < error < fatal."""

    __slots__ = ("level", "code", "message")

    def __init__(self, level: str, code: str, message: str):
        self.level = level
        self.code = code
        self.message = message

    def as_dict(self) -> dict:
        return {"level": self.level, "code": self.code,
                "message": self.message}

    def __repr__(self):
        return f"[{self.level}] {self.code}: {self.message}"


def _crc32_file(path: str) -> int:
    from annotatedvdb_tpu_torch.store.variant_store import crc32_file

    return crc32_file(path)


def _load_commands(store_dir: str, ledger) -> list[str]:
    """Best-effort re-load prescriptions from the run ledger: the exact
    CLI invocations (newest first, deduplicated by input) whose re-run
    would restore rows lost from this store.  Loaders with extra REQUIRED
    flags get them back from the run record's params (an incomplete
    command would strand the operator at an argparse error)."""
    cmds: list[str] = []
    seen: set[str] = set()
    if ledger is None:
        return cmds
    script_to_cli = {
        "load-vcf": "load_vcf", "load-vep": "load_vep",
        "load-cadd": "load_cadd", "update-qc": "update_qc",
        "load-snpeff-lof": "load_snpeff_lof",
        "update-variant-annotation": "update_variant_annotation",
    }
    for rec in reversed(ledger.runs()):
        inp = rec.get("input")
        script = rec.get("script")
        if not inp or not script or inp in seen:
            continue
        seen.add(inp)
        params = rec.get("params") or {}
        extras = ""
        if script == "update-qc" and params.get("version"):
            extras = f" --version {params['version']}"
        elif script == "load-cadd" and params.get("database"):
            extras = f" --databaseDir {params['database']}"
        cli = script_to_cli.get(script, script.replace("-", "_"))
        cmds.append(
            f"python -m annotatedvdb_tpu.cli.{cli} "
            f"--fileName {inp} --storeDir {store_dir}{extras} --commit"
        )
    return cmds


def fsck(store_dir: str, deep: bool = False, repair: bool = False,
         log=print) -> dict:
    """Check (and optionally repair) one store directory.

    Returns ``{"status": "clean"|"repaired"|"unrecoverable",
    "exit_code": 0|1|2, "findings": [...], "repairs": [...]}``.
    """
    findings: list[Finding] = []
    repairs: list[str] = []

    def note(level: str, code: str, message: str) -> None:
        f = Finding(level, code, message)
        findings.append(f)
        log(repr(f))

    def did(action: str) -> None:
        repairs.append(action)
        log(f"[repair] {action}")

    mpath = os.path.join(store_dir, "manifest.json")
    manifest = None
    if not os.path.isdir(store_dir):
        note("fatal", "no-store", f"{store_dir}: not a directory")
        return _report(findings, repairs)
    try:
        with open(mpath) as f:
            manifest = json.load(f)
        if not isinstance(manifest, dict) or "shards" not in manifest:
            raise ValueError("manifest is not a store manifest object")
    except FileNotFoundError:
        note("fatal", "manifest-missing",
             f"{mpath}: absent — not a store, or the first save never "
             "completed; nothing to repair (reload from source inputs)")
        manifest = None
    except (ValueError, OSError) as err:
        note("fatal", "manifest-corrupt",
             f"{mpath}: unreadable ({err}); the atomic-rename save should "
             "make this impossible short of byte damage to the file itself "
             "— reload from source inputs")
        manifest = None

    # ---- ledger (readable even when the manifest is gone) ------------------
    ledger = None
    lpath = os.path.join(store_dir, "ledger.jsonl")
    if os.path.exists(lpath):
        from annotatedvdb_tpu_torch.store.ledger import AlgorithmLedger

        try:
            ledger = AlgorithmLedger(lpath, log=lambda m: None)
        except Exception as err:
            note("error", "ledger-unreadable", f"{lpath}: {err}")
        if ledger is not None and ledger.skipped_lines:
            note("warn", "ledger-torn",
                 f"{lpath}: {ledger.skipped_lines} torn/unparseable "
                 "line(s) skipped (a crashed append; the affected "
                 "checkpoint never became durable — resume replays from "
                 "the previous one)")
            if repair:
                # any append heals; force one benign no-op rewrite now
                ledger._heal_before_append = True
                ledger.run({"script": "store-fsck", "note": "ledger heal"})
                did(f"rewrote {lpath} without its torn line(s)")
        if ledger is not None:
            for alg_id in ledger.pending_undo_intents():
                note("warn", "undo-intent-dangling",
                     f"undo of algorithm {alg_id} was started but never "
                     "recorded complete (crash mid-undo?); the store may "
                     "hold a partial delete — re-run `python -m "
                     f"annotatedvdb_tpu.cli.undo_load --storeDir {store_dir} "
                     f"--algId {alg_id} --commit` (idempotent) to finish it")

    if manifest is None:
        return _report(findings, repairs)

    # ---- referenced segment files vs the directory -------------------------
    integrity = manifest.get("integrity") or {}
    referenced: dict[str, tuple[str, int]] = {}  # stem -> (label, group idx)
    damaged: set[tuple[str, int]] = set()        # (label, group idx)
    for label, groups in manifest["shards"].items():
        norm = [[g] for g in groups] if manifest.get("format") == 2 else groups
        for gi, group in enumerate(norm):
            for sid in group:
                stem = f"chr{label}.{sid:06d}"
                referenced[stem] = (label, gi)
                rec = integrity.get(stem) or {}
                for ext, key in ((".npz", "npz"), (".ann.jsonl", "jsonl")):
                    fp = os.path.join(store_dir, stem + ext)
                    if not os.path.exists(fp):
                        note("error", "segment-missing",
                             f"{fp}: referenced by the manifest but absent")
                        damaged.add((label, gi))
                        continue
                    want = rec.get(key)
                    if want is None:
                        continue
                    size = os.path.getsize(fp)
                    if size != want["bytes"]:
                        note("error", "segment-torn",
                             f"{fp}: {size} bytes on disk, integrity record "
                             f"says {want['bytes']} (torn write)")
                        damaged.add((label, gi))
                    elif deep and _crc32_file(fp) != want["crc32"]:
                        note("error", "segment-bitrot",
                             f"{fp}: crc32 mismatch vs integrity record "
                             "(bit rot or partial overwrite)")
                        damaged.add((label, gi))

    # ---- directory scan: orphans, stale tmp, foreign files -----------------
    from annotatedvdb_tpu_torch.export.writer import is_export_tmp
    from annotatedvdb_tpu_torch.store.compact import is_compact_tmp
    from annotatedvdb_tpu_torch.store.memtable import is_flush_tmp
    from annotatedvdb_tpu_torch.store.replication import (
        is_repl_cursor,
        is_repl_tmp,
    )
    from annotatedvdb_tpu_torch.store.wal import is_wal_file, is_wal_tmp

    for fname in sorted(os.listdir(store_dir)):
        fp = os.path.join(store_dir, fname)
        if not os.path.isfile(fp):
            continue
        if is_export_tmp(fname):
            # export staging debris (a killed `avdb export` into this
            # directory): parts commit tmp -> fsync -> rename and the
            # corpus manifest commits last, so nothing references these —
            # checked BEFORE the generic dot-prefix branch (the manifest
            # temp is dot-prefixed) and never attributed foreign-file
            note("warn", "export-tmp",
                 f"{fp}: abandoned corpus-export temp from a killed "
                 "`avdb export` (resume prunes it and re-stages the part)")
            if repair:
                tio.unlink(fp)
                did(f"removed {fp} (export --resume re-stages it)")
            continue
        if fname.startswith(".") and ".tmp" in fname:
            note("warn", "stale-tmp",
                 f"{fp}: leftover tmp file from a crashed save")
            if repair:
                tio.unlink(fp)
                did(f"removed {fp}")
            continue
        if is_repl_tmp(fname):
            # a replication bootstrap killed mid-chunk-stream: the rename
            # (and CRC verify) never happened, so nothing references it —
            # the non-destructive recovery is re-running bootstrap
            # (serve --follow refetches anything unverified)
            note("warn", "repl-tmp",
                 f"{fp}: in-flight replication bootstrap chunk temp from "
                 "a killed ship transfer; re-run bootstrap (serve "
                 "--follow) to refetch it")
            if repair:
                tio.unlink(fp)
                did(f"removed {fp} (bootstrap refetches it)")
            continue
        if is_repl_cursor(fname):
            # a follower's tail cursor left behind (the store is being
            # inspected outside its follower, or a promote was killed
            # before the cursor drop): pruning loses only resume hints —
            # re-running bootstrap rebuilds it from the local mirrors
            note("warn", "repl-cursor",
                 f"{fp}: dangling replication bootstrap cursor — this "
                 "store was (or is) a follower; re-run bootstrap (serve "
                 "--follow) to resume, or promote to seal it as a leader")
            if repair:
                tio.unlink(fp)
                did(f"removed {fp} (re-run bootstrap to rebuild it)")
            continue
        if is_wal_tmp(fname):
            # a killed WAL rotation (memtable flush start): the rename
            # never happened, so no record in it was ever acknowledged
            note("warn", "wal-tmp",
                 f"{fp}: abandoned write-ahead-log rotation temp from a "
                 "killed memtable flush (nothing in it was acknowledged)")
            if repair:
                tio.unlink(fp)
                did(f"removed {fp}")
            continue
        if is_wal_file(fname):
            # the live write path's durability file: it may hold
            # ACKNOWLEDGED upserts that have not flushed to segments yet —
            # the right recovery is a serve-worker restart (which replays
            # it), not deletion; --repair prunes it only as the explicit
            # destructive choice, and says what is lost
            note("warn", "wal-pending",
                 f"{fp}: upsert write-ahead log — may hold acknowledged "
                 "writes not yet flushed to store segments; restart the "
                 "serve worker with upserts enabled to replay it, or "
                 "--repair prunes it (unflushed acknowledged upserts in "
                 "it are LOST)")
            if repair:
                tio.unlink(fp)
                did(f"removed {fp} (unreplayed upserts dropped)")
            continue
        if is_flush_tmp(fname):
            # a memtable flush killed before its rename step: the
            # manifest never referenced these and the WAL still covers
            # every acknowledged row — pruning is safe
            note("warn", "flush-tmp",
                 f"{fp}: abandoned memtable-flush temp from a killed "
                 "flush pass (the WAL still covers its rows)")
            if repair:
                tio.unlink(fp)
                did(f"removed {fp}")
            continue
        if is_compact_tmp(fname):
            # an online-compaction pass (store/compact.py) that was killed
            # mid-merge: its temps are ours, never a foreign segment — the
            # manifested store never referenced them, so pruning is safe
            note("warn", "compact-tmp",
                 f"{fp}: abandoned compaction temp from a killed "
                 "`doctor compact` pass")
            if repair:
                tio.unlink(fp)
                did(f"removed {fp}")
            continue
        m = SEGMENT_RE.match(fname)
        if m is not None:
            stem = fname[: -len(".npz")] if fname.endswith(".npz") \
                else fname[: -len(".ann.jsonl")]
            if stem not in referenced:
                note("warn", "segment-orphan",
                     f"{fp}: segment file not referenced by the manifest "
                     "(a checkpoint that never committed, or another "
                     "store's leavings)")
                if repair:
                    tio.unlink(fp)
                    did(f"removed {fp}")
            continue
        if fname.endswith(".npz") or fname.endswith(".ann.jsonl"):
            # matches our extensions but not our naming: not ours to delete
            note("warn", "foreign-file",
                 f"{fp}: segment-like file with a foreign name — not "
                 "created by this store; inspect/remove manually")

    # ---- repair: roll damaged groups back out of the manifest --------------
    if damaged and repair:
        dropped: list[str] = []
        fmt2 = manifest.get("format") == 2  # resolved BEFORE the loop: the
        # format flip below must not leave later shards' groups flat
        for label, groups in list(manifest["shards"].items()):
            norm = [[g] for g in groups] if fmt2 else groups
            keep = [g for gi, g in enumerate(norm)
                    if (label, gi) not in damaged]
            dropped.extend(
                f"chr{label} group {g}" for gi, g in enumerate(norm)
                if (label, gi) in damaged
            )
            if keep:
                manifest["shards"][label] = keep  # normalized group lists
            else:
                del manifest["shards"][label]
        manifest["format"] = 3  # every surviving shard was normalized above
        # crash point: the rolled-back manifest is staged, not committed —
        # a death here leaves the damaged-but-diagnosed store for the next
        # fsck run to repair again (repair is idempotent).  replace_manifest
        # also fsyncs the directory under AVDB_FSYNC: a repair that doesn't
        # survive power loss would resurrect the damage it just rolled back.
        tio.replace_manifest(
            mpath, manifest,
            pre_sync=lambda f: faults.fire("fsck.repair", f),
        )
        did(f"dropped damaged backing group(s): {', '.join(dropped)} "
            "(shard rolled back to its last consistent rows)")
        # canonicalize: a load+save round trip revalidates backing-group
        # reassembly, recomputes the stats block, and prunes the files of
        # the dropped groups
        try:
            from annotatedvdb_tpu_torch.store.variant_store import VariantStore

            store = VariantStore.load(store_dir)
            store.save(store_dir)
            did(f"store reloads cleanly after repair ({store.n} rows)")
            # the damage findings above were real but are now RESOLVED:
            # downgrade them so the exit-code contract holds (1 = repaired,
            # 2 = errors remain) — rows lost stay visible as warnings +
            # reload hints
            for f in findings:
                if f.code in ("segment-torn", "segment-missing",
                              "segment-bitrot") and f.level == "error":
                    f.level = "warn"
        except Exception as err:
            note("error", "repair-failed",
                 f"store still does not load after rollback: {err}")
        for cmd in _load_commands(store_dir, ledger):
            note("info", "reload-hint",
                 f"rows from the dropped group(s) are LOST from this store; "
                 f"re-load them (idempotent) with: {cmd}")
    elif damaged:
        note("error", "repair-available",
             f"{len(damaged)} damaged backing group(s); re-run with "
             "--repair to roll the affected shard(s) back to their last "
             "consistent state")
        for cmd in _load_commands(store_dir, ledger):
            note("info", "reload-hint",
                 f"after repair, restore lost rows with: {cmd}")
    elif manifest is not None and not damaged:
        # verify the store actually loads (catches inconsistencies the
        # per-file checks cannot see, e.g. backing groups that fail to
        # reassemble); size/crc were already checked above, so skip the
        # duplicate verification pass inside load
        try:
            from annotatedvdb_tpu_torch.store.variant_store import VariantStore

            env = os.environ.get("AVDB_VERIFY")
            os.environ["AVDB_VERIFY"] = "off"
            try:
                store = VariantStore.load(store_dir)
            finally:
                if env is None:
                    os.environ.pop("AVDB_VERIFY", None)
                else:
                    os.environ["AVDB_VERIFY"] = env
            note("info", "loads-ok",
                 f"store loads cleanly: {store.n} rows across "
                 f"{len(store.shards)} shard(s)")
        except Exception as err:
            note("error", "load-failed", f"store does not load: {err}")

    return _report(findings, repairs)


def _report(findings: list[Finding], repairs: list[str]) -> dict:
    has_fatal = any(f.level == "fatal" for f in findings)
    has_error = any(f.level == "error" for f in findings)
    has_warn = any(f.level == "warn" for f in findings)
    if has_fatal or has_error:
        status, code = "unrecoverable", 2
    elif repairs or has_warn:
        status, code = "repaired" if repairs else "warnings", 1
    else:
        status, code = "clean", 0
    return {
        "status": status,
        "exit_code": code,
        "findings": [f.as_dict() for f in findings],
        "repairs": list(repairs),
    }
