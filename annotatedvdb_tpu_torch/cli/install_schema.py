"""CLI: install the Postgres-compatible schema / export a store to Postgres
(``Load/bin/installAnnotatedVDBSchema`` equivalent).

Port of ``annotatedvdb_tpu/cli/install_schema.py``, with the same flags,
outputs and printed lines.  Writes the generated DDL (and, with
``--storeDir``, a full data dump of a store) to a directory, and can
replay it through ``psql -v ON_ERROR_STOP=1`` the way the reference's
installer does (``installAnnotatedVDBSchema:49-74``).  Database
credentials ride the standard PG* environment variables.

One deviation: the reference pins the CPU here.  The port's entry points
run on the card, so this one takes ``--platform`` (``cuda``, the default,
or ``cpu``) like the loaders; only ``--storeDir``'s recompute of display
attributes the store does not hold uses the device (one ``annotate_bin``
launch per 65,536-row window that lacks them).  Schema-only runs need no
device.

Usage:
    python -m annotatedvdb_tpu_torch install-schema --outputDir ./pg
    python -m annotatedvdb_tpu_torch install-schema --outputDir ./pg \\
        --storeDir ./vdb [--platform cpu]    # also dump data + load.sql
    python -m annotatedvdb_tpu_torch install-schema --outputDir ./pg --run
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess

from annotatedvdb_tpu_torch.runtime import PLATFORMS
from annotatedvdb_tpu_torch.sql.schema import full_schema


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--outputDir", required=True,
                    help="directory for schema/ (and data/ + load.sql)")
    ap.add_argument("--storeDir", help="store to dump as COPY data")
    ap.add_argument("--ledgerFile", help="ledger JSONL for AlgorithmInvocation "
                                         "rows (default: <storeDir>/ledger.jsonl)")
    ap.add_argument("--run", action="store_true",
                    help="execute through psql (PG* env vars for credentials)")
    ap.add_argument("--platform", default="cuda", choices=PLATFORMS,
                    help="device of --storeDir's display-attribute recompute: "
                         "cuda (default; an error when no card is present) "
                         "or cpu")
    args = ap.parse_args(argv)

    os.makedirs(args.outputDir, exist_ok=True)
    if args.storeDir:
        from annotatedvdb_tpu_torch.io.pg_egress import export_store
        from annotatedvdb_tpu_torch.runtime import resolve_device
        from annotatedvdb_tpu_torch.store import AlgorithmLedger, VariantStore

        device = resolve_device(args.platform)
        store = VariantStore.load(args.storeDir)
        ledger_path = args.ledgerFile or os.path.join(
            args.storeDir, "ledger.jsonl"
        )
        ledger = (
            AlgorithmLedger(ledger_path) if os.path.exists(ledger_path) else None
        )
        counts = export_store(store, args.outputDir, ledger, device=device)
        total = sum(counts.values())
        print(f"exported {total} rows over {len(counts)} chromosomes "
              f"to {args.outputDir}")
    else:
        schema_dir = os.path.join(args.outputDir, "schema")
        os.makedirs(schema_dir, exist_ok=True)
        for name, sql in full_schema():
            with open(os.path.join(schema_dir, f"{name}.sql"), "w") as f:
                f.write(sql)
        print(f"schema SQL written to {schema_dir}")

    if args.run:
        if shutil.which("psql") is None:
            ap.error("--run requires psql on PATH")
        load = os.path.join(args.outputDir, "load.sql")
        if os.path.exists(load):
            cmd = ["psql", "-v", "ON_ERROR_STOP=1", "-f", "load.sql"]
            subprocess.run(cmd, check=True, cwd=args.outputDir)
        else:
            for name, _ in full_schema():
                subprocess.run(
                    ["psql", "-v", "ON_ERROR_STOP=1", "-f",
                     os.path.join("schema", f"{name}.sql")],
                    check=True, cwd=args.outputDir,
                )
        print("psql install complete")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
