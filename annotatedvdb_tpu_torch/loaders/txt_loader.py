"""Tab-delimited annotation loads: header-driven column updates/inserts.

Port of ``annotatedvdb_tpu/loaders/txt_loader.py`` (``TpuTextLoader`` is
:class:`TextLoader` here; reference ``txt_variant_loader.py`` +
``update_variant_annotation.py``): a TSV whose header names Variant-table
columns, keyed by a ``variant`` column holding a metaseq id, refSNP id or
record primary key.  Update fields are ``header ∩ UPDATABLE_FIELDS``
(``txt_variant_loader.py:94-115``); JSONB columns update with jsonb_merge
semantics, scalars assign (``:118-152``); known variants update, novel
metaseq-identified variants insert (``:214-256``).

Batch-shaped: rows resolve per batch through one vectorized lookup per
chromosome (``loaders/lookup.py``; the batch's chunk has no tokenizer
hash, so its hash is one device step) or one ``np.isin`` scan per shard
for refSNP keys; novel rows re-chunk through the :class:`VcfLoader` insert
path synchronously.
"""

from __future__ import annotations

import csv
import json
import re
import time

import numpy as np

from annotatedvdb_tpu_torch.io.vcf import VcfChunk, rs_number
from annotatedvdb_tpu_torch.loaders.lookup import chunk_lookup
from annotatedvdb_tpu_torch.loaders.vcf_loader import VcfLoader
from annotatedvdb_tpu_torch.runtime import resolve_device
from annotatedvdb_tpu_torch.store import AlgorithmLedger, VariantStore
from annotatedvdb_tpu_torch.store.variant_store import JSONB_COLUMNS
from annotatedvdb_tpu_torch.types import VariantBatch, chromosome_code
from annotatedvdb_tpu_torch.utils.profiling import bulk_load_gc
from annotatedvdb_tpu_torch.utils.strings import to_numeric

#: the ledger's ``script`` label: the reference's literal, so stores
#: written by either package carry one provenance vocabulary
LEDGER_SCRIPT = "TpuTextLoader.load_file"

#: Variant-table columns a TSV header may target
#: (``variant_loader.py:63-69`` ALLOWABLE_COPY_FIELDS minus the identity
#: and bookkeeping fields the loader owns)
UPDATABLE_FIELDS = [
    "is_multi_allelic", "is_adsp_variant", "ref_snp_id",
] + JSONB_COLUMNS

#: id flavors accepted in the ``variant`` column
VARIANT_ID_TYPES = ["METASEQ", "PRIMARY_KEY", "REFSNP"]

_ALLELE_RE = re.compile(r"^[ACGTUN-]+$", re.IGNORECASE)


def parse_variant_id(variant_id: str, id_type: str):
    """Split a ``variant`` column value into its identity parts.

    Returns ``(chrom_code, pos, ref, alt, rs)`` where ``ref``/``alt`` are
    None for refSNP and digest-PK ids (``txt_variant_loader.py:160-186``)."""
    if id_type == "REFSNP":
        return None, None, None, None, variant_id
    parts = variant_id.split(":")
    if len(parts) < 2:
        raise ValueError(f"unparseable variant id: {variant_id!r}")
    code = chromosome_code(parts[0])
    if code == 0:
        # non-standard contigs are skipped the way VCF ingest skips them
        raise ValueError(f"unplaceable chromosome {parts[0]!r}: {variant_id!r}")
    pos = int(parts[1])
    ref = alt = rs = None
    if len(parts) >= 4 and _ALLELE_RE.match(parts[2]) and _ALLELE_RE.match(parts[3]):
        ref, alt = parts[2].upper(), parts[3].upper()
        if len(parts) >= 5:
            rs = parts[4]
    elif len(parts) >= 4:
        # digest-form primary key chr:pos:<VRS digest>[:rs]
        rs = parts[3]
    if id_type == "METASEQ" and ref is None:
        raise ValueError(f"metaseq id without alleles: {variant_id!r}")
    return code, pos, ref, alt, rs


def coerce_update_value(field: str, value):
    """TSV cell -> store value; 'NULL' and '' mean no value
    (``txt_variant_loader.py:199-203``)."""
    if value is None or value in ("NULL", ""):
        return None
    if field in JSONB_COLUMNS:
        if isinstance(value, str):
            try:
                return json.loads(value)
            except json.JSONDecodeError as err:
                raise ValueError(
                    f"column {field}: invalid JSON {value!r}: {err}"
                ) from err
        return value
    if field in ("is_adsp_variant", "is_multi_allelic"):
        v = str(value).strip().lower()
        return 1 if v in ("true", "t", "1") else 0
    if field == "ref_snp_id":
        return str(value)
    return to_numeric(value)


class TextLoader:
    """Update/insert variants from a column-named tab-delimited file, on
    ``device`` (``cuda:0`` by default; ``"cpu"`` runs the plain versions)."""

    def __init__(
        self,
        store: VariantStore,
        ledger: AlgorithmLedger,
        variant_id_type: str = "METASEQ",
        datasource: str | None = None,
        update_existing: bool = True,
        skip_existing: bool = False,
        batch_size: int = 1 << 15,
        log=print,
        log_after: int | None = None,
        quarantine=None,
        max_errors: int = -1,
        device=None,
    ):
        from annotatedvdb_tpu_torch.utils.logging import ProgressCadence
        from annotatedvdb_tpu_torch.utils.profiling import StageTimer
        from annotatedvdb_tpu_torch.utils.quarantine import ErrorBudget

        if variant_id_type not in VARIANT_ID_TYPES:
            raise ValueError(f"variant_id_type must be one of {VARIANT_ID_TYPES}")
        self.device = resolve_device(device)
        # the sink's meta header is bound once the TSV header is read, so a
        # replayed rejects file reconstructs a loadable TSV
        self.quarantine = quarantine
        self._budget = (
            quarantine.budget if quarantine is not None
            else ErrorBudget(max_errors)
        )
        self._fieldnames: list[str] | None = None
        self.store = store
        self.ledger = ledger
        self.variant_id_type = variant_id_type
        self.datasource = datasource.lower() if datasource else None
        self.update_existing = update_existing
        self.skip_existing = skip_existing
        self.batch_size = batch_size
        self.log = log
        self._cadence = ProgressCadence(log, log_after)
        #: apply / persist busy seconds + load wall
        self.timer = StageTimer()
        #: chunk-granularity metrics hook (ObsSession.attach)
        self.obs = None
        #: membership probes by path ("device" / "host"), observability only
        self.probe_stats: dict[str, int] = {}
        self.insert_loader = VcfLoader(
            store, ledger, datasource=datasource, skip_existing=False, log=log,
            device=self.device,
        )
        self.update_fields: list[str] = []
        self.counters = {
            "line": 0, "variant": 0, "update": 0, "skipped": 0,
            "duplicates": 0, "not_found": 0, "inserted": 0,
        }

    #: metric label / run-ledger script name (obs.ObsSession)
    obs_name = "update-variant-annotation"

    @property
    def is_adsp(self) -> bool:
        return self.datasource == "adsp"

    # ------------------------------------------------------------------

    @bulk_load_gc()
    def load_file(self, path: str, commit: bool = False, test: bool = False,
                  persist=None) -> dict:
        alg_id = self.ledger.begin(
            LEDGER_SCRIPT,
            {"file": path, "id_type": self.variant_id_type, "test": test},
            commit,
        )
        # the CLI always resumes after the last committed checkpoint
        resume_line = self.ledger.last_checkpoint(path)
        if resume_line:
            self.log(f"resuming {path} after committed line {resume_line}")

        def flush(pending) -> None:
            t0 = time.perf_counter() if self.obs is not None else 0.0
            with self.timer.stage("apply", items=len(pending)):
                self._apply_batch(pending, alg_id, commit)
            if commit:
                with self.timer.stage("persist"):
                    if persist is not None:
                        persist()
                    self.ledger.checkpoint(
                        alg_id, path, pending[-1][0], dict(self.counters)
                    )
            if self.obs is not None:
                self.obs.chunk(
                    len(pending), seconds=time.perf_counter() - t0
                )

        try:
            with self.timer.wall(), open(path, newline="") as fh:
                self._read(fh, path, resume_line, test, flush)
        finally:
            self.insert_loader.close()
        self.ledger.finish(alg_id, dict(self.counters))
        self._cadence.finish(
            self.counters["line"], self.counters, self.timer.summary()
        )
        self.counters["alg_id"] = alg_id
        return dict(self.counters)

    def _read(self, fh, path, resume_line, test, flush) -> None:
        reader = csv.DictReader(fh, delimiter="\t")
        if reader.fieldnames is None or "variant" not in reader.fieldnames:
            raise ValueError(f"{path}: no 'variant' column in header")
        self.update_fields = [
            f for f in reader.fieldnames if f in UPDATABLE_FIELDS
        ]
        self._fieldnames = list(reader.fieldnames)
        if self.quarantine is not None:
            self.quarantine.set_header("\t".join(self._fieldnames))
        pending: list[tuple[int, dict]] = []
        for line_no, row in enumerate(reader, start=2):  # 1 = header
            self.counters["line"] += 1
            if resume_line and line_no <= resume_line:
                self.counters["skipped"] += 1
                continue
            pending.append((line_no, row))
            self._cadence.maybe_log(self.counters["line"], self.counters)
            if len(pending) >= self.batch_size:
                flush(pending)
                pending = []
                if test:
                    self.log("test mode: stopping after first batch")
                    break
        if pending:
            flush(pending)

    # ------------------------------------------------------------------

    def _raw_line(self, row: dict) -> str:
        """The TSV line for quarantine: the cells tab-joined in header
        order (DictReader consumed the original text)."""
        fields = self._fieldnames or list(row.keys())
        return "\t".join(
            "" if row.get(f) is None else str(row.get(f)) for f in fields
        )

    def _reject(self, line_no: int, row: dict, reason: str) -> None:
        self.counters["rejected"] = self.counters.get("rejected", 0) + 1
        self.counters["skipped"] += 1
        self.log(f"line {line_no}: {reason}; quarantined")
        if self.quarantine is not None:
            self.quarantine.reject(line_no, self._raw_line(row), reason)
        else:
            self._budget.add(1, context=f"line {line_no}: {reason}")

    def _apply_batch(self, pending: list, alg_id: int, commit: bool) -> None:
        parsed = []  # (line_no, row, code, pos, ref, alt, rs, coerced)
        for line_no, row in pending:
            self.counters["variant"] += 1
            try:
                code, pos, ref, alt, rs = parse_variant_id(
                    row["variant"], self.variant_id_type
                )
                # coerce every update cell up front: a bad JSON cell then
                # quarantines its row instead of aborting a half-applied
                # batch
                coerced = {
                    f: coerce_update_value(f, row.get(f))
                    for f in self.update_fields
                }
            except ValueError as err:
                self._reject(line_no, row, str(err))
                continue
            parsed.append((line_no, row, code, pos, ref, alt, rs, coerced))

        rs_index = (
            self._build_rs_index(parsed)
            if self.variant_id_type == "REFSNP" else None
        )
        meta_index = (
            self._build_meta_index(parsed)
            if self.variant_id_type != "REFSNP" else None
        )

        novel = []
        digest_cache: dict = {}  # per-batch materialized digest columns
        for j, entry in enumerate(parsed):
            found_at = self._lookup_entry(j, entry, rs_index, meta_index,
                                          digest_cache)
            if found_at is None:
                if self.variant_id_type == "METASEQ":
                    novel.append(entry)
                else:
                    self.counters["not_found"] += 1
                continue
            self.counters["duplicates"] += 1
            if self.skip_existing or not self.update_existing:
                self.counters["skipped"] += 1
                continue
            self._apply_update(found_at, entry[7], alg_id, commit)

        if novel:
            self._insert_novel(novel, alg_id, commit)

    def _build_rs_index(self, parsed: list) -> dict:
        """rs number -> (shard, row) for every rs id in the batch: one
        vectorized membership pass per shard."""
        wanted = np.unique(
            [n for n in (rs_number(e[6]) for e in parsed) if n >= 0]
        ).astype(np.int64)
        index: dict[int, tuple] = {}
        if wanted.size == 0:
            return index
        for shard in self.store.shards.values():
            rs_col = shard.column("ref_snp")
            hits = np.where(np.isin(rs_col, wanted))[0]
            for i in hits:
                index.setdefault(int(rs_col[i]), (shard, int(i)))
        return index

    def _build_meta_index(self, parsed: list) -> dict:
        """parsed-list position -> (shard, row) for allele-form ids, through
        the shared identity rule (one device step for the batch's hash)."""
        items = [(j, e) for j, e in enumerate(parsed) if e[4] is not None]
        index: dict[int, tuple] = {}
        if not items:
            return index
        chunk = _chunk_from_rows([e for _, e in items], self.store.width)
        for _code, shard, sel, found, idx in chunk_lookup(
                self.store, chunk, device=self.device, stats=self.probe_stats):
            if shard is None:
                continue
            for k, row in enumerate(sel):
                if found[k]:
                    index[items[int(row)][0]] = (shard, int(idx[k]))
        return index

    def _lookup_entry(self, j: int, entry, rs_index: dict | None,
                      meta_index: dict | None, digest_cache: dict):
        """Locate one batch entry in the store; returns (shard, row) or None."""
        _, _, code, pos, ref, _, rs = entry[:7]
        if self.variant_id_type == "REFSNP":
            return rs_index.get(rs_number(rs)) if rs_index else None
        if ref is not None:
            return meta_index.get(j) if meta_index else None
        if code not in self.store.shards:
            return None
        # digest-form PK: linear scan of the digest tail, matched on the
        # digest segment + position, never on the raw chromosome token
        # (input 'chr1'/'MT' against stored '1'/'M')
        shard = self.store.shards[code]
        pk_parts = entry[1]["variant"].split(":")
        if len(pk_parts) < 3:
            return None
        variant_digest = pk_parts[2]
        if code not in digest_cache:  # materialize columns once per batch
            digest_cache[code] = (
                shard.column("pos"), shard.object_column("_digest_pk")
            )
        pos_col, pk_col = digest_cache[code]
        for i, pk in enumerate(pk_col):
            if pk is not None and pos_col[i] == pos \
                    and pk.split(":")[2] == variant_digest:
                return shard, i
        return None

    def _apply_update(self, found_at, coerced: dict, alg_id: int,
                      commit: bool, count: bool = True):
        """Apply one row's pre-coerced update values."""
        shard, i = found_at
        if count:
            self.counters["update"] += 1
        if not commit:
            return
        one = np.array([i])
        for f in self.update_fields:
            value = coerced.get(f)
            if value is None:
                continue
            if f in JSONB_COLUMNS:
                shard.update_annotation(one, f, [value])
            elif f == "ref_snp_id":
                shard.set_col("ref_snp", one, rs_number(value))
            else:
                shard.set_col(f, one, value)
        if self.is_adsp:
            shard.set_col("is_adsp_variant", one, 1)
        shard.set_col("row_algorithm_id", one, alg_id)

    def _insert_novel(self, novel: list, alg_id: int, commit: bool) -> None:
        """Insert metaseq-identified rows through the VCF insert path, then
        apply the TSV's values to the fresh rows, looked up after the
        append (global row ids shift with it).  These rows count only as
        'inserted', never also as 'update'."""
        chunk = _chunk_from_rows(novel, self.store.width)
        before = self.insert_loader.counters["variant"]
        self.insert_loader._load_chunk(chunk, alg_id, commit, 0, None)
        self.counters["inserted"] += (
            self.insert_loader.counters["variant"] - before
        )
        if not commit:
            return
        meta_index = self._build_meta_index(novel)
        for j, entry in enumerate(novel):
            found_at = meta_index.get(j)
            if found_at is not None:
                self._apply_update(found_at, entry[7], alg_id, commit, count=False)


def _chunk_from_rows(novel: list, width: int) -> VcfChunk:
    """A chunk of parsed TSV entries (no tokenizer hash, no rs numbers:
    the insert path derives both)."""
    rows = [(e[2], e[3], e[4], e[5]) for e in novel]  # code,pos,ref,alt
    batch = VariantBatch.from_tuples(rows, width=width)
    batch = batch._replace(chrom=np.array([r[0] for r in rows], np.int8))
    n = len(rows)
    return VcfChunk(
        batch=batch,
        refs=[e[4] for e in novel],
        alts=[e[5] for e in novel],
        ref_snp=[
            e[6] or (e[1].get("ref_snp_id") if e[1].get("ref_snp_id")
                     not in (None, "", "NULL") else None)
            for e in novel
        ],
        variant_id=[e[1]["variant"] for e in novel],
        is_multi_allelic=np.zeros(n, bool),
        frequencies=[None] * n,
        rs_position=[None] * n,
        info=[{}] * n,
        line_number=np.array([e[0] for e in novel], np.int64),
        qual=[None] * n,
        filter=[None] * n,
        format=[None] * n,
        counters={},
    )
