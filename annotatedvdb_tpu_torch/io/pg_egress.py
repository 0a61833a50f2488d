"""Postgres data egress: dump a VariantStore as COPY streams + load script.

Port of ``annotatedvdb_tpu/io/pg_egress.py``.  Together with
:mod:`annotatedvdb_tpu_torch.sql.schema` it writes a directory a plain
``psql`` can replay into a database whose ``AnnotatedVDB.Variant``
content matches what the reference's loaders would have produced.  Rows
stream in Postgres COPY text format (tab delimiter, ``\\N`` NULL, standard
escape rules) so arbitrary JSON payloads survive verbatim.

Display attributes the loader did not store are recomputed per
``EGRESS_WINDOW`` rows through the loaders' device step
(``models/pipeline.py::annotate_hash_fn``): one ``annotate_bin`` launch on
the card per window that has rows lacking them (the allele hash it also
returns is not used), the plain version on the CPU.  The reference's
``egress.flush`` fault point (``utils/faults``) is not ported; the
tmp-and-rename write with its bounded retry of transient I/O errors is.
"""

from __future__ import annotations

import json
import os

import numpy as np

from annotatedvdb_tpu_torch.oracle.binindex import closed_form_path
from annotatedvdb_tpu_torch.sql.schema import SCHEMA, full_schema
from annotatedvdb_tpu_torch.store import AlgorithmLedger, VariantStore
from annotatedvdb_tpu_torch.store.variant_store import JSONB_COLUMNS, jsonb_dumps
from annotatedvdb_tpu_torch.types import chromosome_label

#: Variant column order for COPY (matches create_variant_table_sql)
VARIANT_COPY_COLUMNS = [
    "chromosome", "record_primary_key", "position", "is_multi_allelic",
    "is_adsp_variant", "ref_snp_id", "metaseq_id", "bin_index",
    *JSONB_COLUMNS, "row_algorithm_id",
]

_ESCAPES = {
    "\\": "\\\\", "\t": "\\t", "\n": "\\n", "\r": "\\r",
    "\b": "\\b", "\f": "\\f", "\v": "\\v",
}


def pg_escape(value) -> str:
    """One COPY text-format field; None -> ``\\N``."""
    if value is None:
        return "\\N"
    if value is True:
        return "t"
    if value is False:
        return "f"
    s = value if isinstance(value, str) else str(value)
    if any(c in s for c in "\\\t\n\r\b\f\v"):
        s = "".join(_ESCAPES.get(c, c) for c in s)
    return s


def computed_display_attributes(shard, window: np.ndarray, device) -> list:
    """Display-attribute dicts for the given (compacted) shard rows,
    recomputed from the stored identity columns by one device step on
    ``device`` — the loader's default is to derive them at egress instead
    of materializing per-row dicts for every variant."""
    import torch

    from annotatedvdb_tpu_torch.io import egress
    from annotatedvdb_tpu_torch.models.pipeline import annotate_hash_fn
    from annotatedvdb_tpu_torch.runtime import to_device
    from annotatedvdb_tpu_torch.types import AnnotatedBatch, VariantBatch

    shard.compact()  # window ids are global; a single segment makes them local
    seg = shard.segments[0]
    batch = VariantBatch(
        np.full(window.shape, shard.chrom_code, np.int8),
        seg.cols["pos"][window],
        seg.ref[window], seg.alt[window],
        seg.cols["ref_len"][window], seg.cols["alt_len"][window],
    )
    device = torch.device(device)
    ann, _hash = annotate_hash_fn(device)(
        *(to_device(x, device) for x in batch))
    ann = AnnotatedBatch(*(x.cpu().numpy() for x in ann))
    refs, alts = egress.decode_alleles(batch)
    refs, alts = refs.astype(object), alts.astype(object)
    for j in np.where(ann.host_fallback)[0]:
        refs[j], alts[j] = shard.alleles(int(window[j]))
    return egress.display_attributes(batch, ann, refs, alts)


def shard_rows(shard, device):
    """Yield COPY-ordered value tuples for every row of one shard."""
    from annotatedvdb_tpu_torch.io.egress import EGRESS_WINDOW, shard_strings

    shard.compact()  # position-sorted global ids + flat column views
    label = chromosome_label(shard.chrom_code)
    pref = "chr" + label
    ref_snp = shard.cols["ref_snp"]
    adsp = shard.cols["is_adsp_variant"]
    multi = shard.cols["is_multi_allelic"]
    lvl = shard.cols["bin_level"]
    leaf = shard.cols["leaf_bin"]
    alg = shard.cols["row_algorithm_id"]
    pos = shard.cols["pos"]
    anns = shard.annotations
    display_col = anns["display_attributes"]
    # windowed: string columns AND recomputed display attributes are
    # assembled vectorized per EGRESS_WINDOW rows, never whole-shard
    for lo in range(0, shard.n, EGRESS_WINDOW):
        hi = min(lo + EGRESS_WINDOW, shard.n)
        _refs, _alts, mseq_col, pk_col = shard_strings(shard, lo, hi)
        display = [display_col[i] for i in range(lo, hi)]
        missing = np.where(np.array([d is None for d in display]))[0]
        if missing.size:
            computed = computed_display_attributes(shard, missing + lo, device)
            for j, d in zip(missing, computed):
                display[j] = d
        for j in range(hi - lo):
            i = lo + j
            rs = f"rs{int(ref_snp[i])}" if ref_snp[i] >= 0 else None
            values = [
                pref,
                pk_col[j],
                int(pos[i]),
                bool(multi[i]),
                None if adsp[i] < 0 else bool(adsp[i]),
                rs,
                mseq_col[j],
                closed_form_path(pref, int(lvl[i]), int(leaf[i])),
            ]
            for col in JSONB_COLUMNS:
                ann = (
                    display[j] if col == "display_attributes"
                    else anns[col][i]
                )
                # raw-text values splice verbatim (jsonb_dumps)
                values.append(None if ann is None else jsonb_dumps(ann))
            values.append(int(alg[i]))
            yield values


def export_store(store: VariantStore, out_dir: str,
                 ledger: AlgorithmLedger | None = None, device=None) -> dict:
    """Write schema SQL, per-chromosome COPY data, and ``load.sql``; the
    display recompute runs on ``device`` (``cuda:0`` by default, or
    ``"cpu"``).  Returns per-chromosome row counts."""
    from annotatedvdb_tpu_torch.runtime import resolve_device
    from annotatedvdb_tpu_torch.utils.retry import is_transient_io, with_backoff

    device = resolve_device(device)
    schema_dir = os.path.join(out_dir, "schema")
    data_dir = os.path.join(out_dir, "data")
    os.makedirs(schema_dir, exist_ok=True)
    os.makedirs(data_dir, exist_ok=True)

    for name, sql in full_schema():
        with open(os.path.join(schema_dir, f"{name}.sql"), "w") as f:
            f.write(sql)

    def _write_copy(fname: str, row_iter_factory) -> None:
        """One COPY file, written tmp+rename with bounded retry: a
        transient I/O error (NFS blip, EIO) re-generates and re-writes the
        whole file — the row iterators are pure functions of the store, so
        the retry is idempotent — and a torn write can never be mistaken
        for a complete COPY stream by the psql replay."""
        target = os.path.join(data_dir, fname)
        tmp = os.path.join(data_dir, f".{fname}.tmp{os.getpid()}")

        def attempt():
            with open(tmp, "w") as f:
                for values in row_iter_factory():
                    f.write("\t".join(pg_escape(v) for v in values) + "\n")
                f.flush()
            os.replace(tmp, target)

        try:
            with_backoff(attempt, retryable=is_transient_io)
        except BaseException:
            # an aborted export must not strand its half-written tmp: the
            # export dir is not a store, so nothing else ever reaps it
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    counts: dict[str, int] = {}
    copy_files = []
    for code in sorted(store.shards):
        shard = store.shards[code]
        label = chromosome_label(code)
        fname = f"variant_chr{label}.copy"
        _write_copy(fname, lambda shard=shard: shard_rows(shard, device))
        counts[label] = shard.n
        copy_files.append(fname)

    inv_file = None
    if ledger is not None:
        inv_file = "algorithm_invocation.copy"
        _write_copy(inv_file, lambda: (
            (inv["alg_id"], inv.get("script"),
             json.dumps(inv.get("params", {})),
             bool(inv.get("commit_mode")))
            for inv in ledger.invocations()
        ))

    cols = ", ".join(VARIANT_COPY_COLUMNS)
    with open(os.path.join(out_dir, "load.sql"), "w") as f:
        f.write("-- generated by annotatedvdb_tpu: psql -v ON_ERROR_STOP=1 -f load.sql\n")
        for name, _ in full_schema():
            f.write(f"\\i schema/{name}.sql\n")
        f.write(f"SELECT {SCHEMA}.alter_variant_autovacuum(false);\n")
        f.write(f"ALTER TABLE {SCHEMA}.Variant DISABLE TRIGGER variant_set_bin_index;\n")
        for fname in copy_files:
            f.write(
                f"\\copy {SCHEMA}.Variant ({cols}) FROM 'data/{fname}'\n"
            )
        if inv_file:
            f.write(
                f"\\copy {SCHEMA}.AlgorithmInvocation (algorithm_invocation_id, "
                f"script_name, script_parameters, commit_mode) FROM 'data/{inv_file}'\n"
            )
            f.write(
                f"SELECT setval(pg_get_serial_sequence('{SCHEMA}.AlgorithmInvocation', "
                "'algorithm_invocation_id'), "
                f"(SELECT COALESCE(MAX(algorithm_invocation_id), 1) "
                f"FROM {SCHEMA}.AlgorithmInvocation));\n"
            )
        f.write(f"ALTER TABLE {SCHEMA}.Variant ENABLE TRIGGER variant_set_bin_index;\n")
        f.write(f"SELECT {SCHEMA}.alter_variant_autovacuum(true);\n")
        f.write("ANALYZE;\n")
    return counts
