"""CLI: undo a load by algorithm-invocation id.

Port of ``annotatedvdb_tpu/cli/undo_load.py`` (the reference's
``Load/bin/undo_variant_load.py``): a columnar mask delete of every row
stamped with the invocation's id instead of a chunked SQL DELETE.  Host
only, with no device and no platform pin.  The default is a dry run; with
``--commit`` the ledger records an ``undo_intent`` before the store is
saved and the ``undo`` after it, so a crash between the two stays visible
(``AlgorithmLedger.pending_undo_intents``).

Usage:  python -m annotatedvdb_tpu_torch undo --storeDir ./vdb --algId 3 --commit
"""

from __future__ import annotations

import argparse
import os
import sys

from annotatedvdb_tpu_torch.store import AlgorithmLedger, VariantStore


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="undo a variant load")
    parser.add_argument("--storeDir", required=True)
    parser.add_argument("--algId", type=int, required=True)
    parser.add_argument("--commit", action="store_true")
    args = parser.parse_args(argv)

    store = VariantStore.load(args.storeDir)
    removed = store.delete_by_algorithm(args.algId)
    if args.commit:
        # intent BEFORE the save: a crash between the store mutation and
        # the completing `undo` record is then detectable (a dangling
        # intent says re-run this idempotent undo) instead of silently
        # leaving store and ledger inconsistent
        ledger = AlgorithmLedger(os.path.join(args.storeDir, "ledger.jsonl"))
        ledger.undo_intent(args.algId)
        store.save(args.storeDir)
        ledger.undo(args.algId, removed)
        print(f"COMMITTED: removed {removed} rows for algorithm {args.algId}",
              file=sys.stderr)
    else:
        print(f"ROLLING BACK (dry run): would remove {removed} rows",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
