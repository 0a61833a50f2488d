"""ADSP QC pVCF updates: ``adsp_qc`` JSONB + ``is_adsp_variant`` flag.

Port of ``annotatedvdb_tpu/loaders/qc_loader.py`` (reference
``Load/bin/update_from_qc_pvcf_file.py``): per variant of an ADSP QC pVCF,
look up the store; known variants get ``adsp_qc[release] = {info, filter,
qual, format}`` merged in and ``is_adsp_variant`` set from ``FILTER ==
'PASS'`` (NULL otherwise, not false, ``:139``); rows whose ``adsp_qc``
already holds this release are skipped unless ``--updateExistingValues``;
QC payloads holding ``Infinity`` or ``NaN`` abort the load (``:141-145``);
novel variants are inserted (``:34-72``).

The stored INFO text depends on the ingest engine, as in the reference:
the native engine's raw INFO span becomes :func:`info_to_json`'s compact
text, the Python engine's parsed dict ``json.dumps``' spaced text.  Both
decode to the same values.
"""

from __future__ import annotations

import json

import numpy as np

from annotatedvdb_tpu_torch.io.vcf import info_to_json
from annotatedvdb_tpu_torch.loaders.update_loader import (
    UpdateLoader,
    UpdateStrategy,
)
from annotatedvdb_tpu_torch.store import AlgorithmLedger, VariantStore
from annotatedvdb_tpu_torch.store.variant_store import RawJson


def _nonfinite(variant_id) -> ValueError:
    return ValueError(f"Infinity/NaN found among QC scores for {variant_id}")


class QcPvcfStrategy(UpdateStrategy):
    """The ``generate_update_values`` analog
    (``update_from_qc_pvcf_file.py:117-149``)."""

    insert_novel = True
    jsonb_columns = ("adsp_qc",)

    def __init__(self, version: str, update_existing: bool = False):
        # one canonical release key: the reference checks version.lower()
        # (update_from_qc_pvcf_file.py:48); mixed case would defeat the
        # already-loaded check
        self.version = version.lower()
        self.update_existing = update_existing

    def values(self, row: dict, existing: dict | None):
        if existing is not None and not self.update_existing:
            stored = existing.get("adsp_qc")
            if stored is not None and self.version in stored:
                return False, {}, {}
        qc_values = {
            self.version: {
                "info": row["info"],
                "filter": row["filter"],
                "qual": row["qual"],
                "format": row["format"],
            }
        }
        try:
            json.dumps(qc_values, allow_nan=False)
        except ValueError:
            raise _nonfinite(row["variant_id"]) from None
        # PASS -> true; anything else leaves the flag NULL, not false
        adsp_flag = 1 if row["filter"] == "PASS" else -1
        return True, {"is_adsp_variant": adsp_flag}, {"adsp_qc": qc_values}

    def values_batch(self, chunk, rows, existing):
        """The found rows' payloads as RawJson text (no per-row dict
        trees), row for row the values of :meth:`values`; ``json.dumps``
        with ``allow_nan=False`` doubles as the Infinity/NaN abort."""
        n = int(rows.size)
        do = np.ones(n, bool)
        flags = np.zeros(n, np.int8)
        vals: list = [None] * n
        stored_col = existing.get("adsp_qc")
        check = not self.update_existing
        dumps = json.dumps
        filters = chunk.filter
        infos = chunk.info
        info_raws = chunk.info_raw
        quals = chunk.qual
        formats = chunk.format
        version = dumps(self.version)  # pre-quoted (a constant)

        def jstr(v):
            if v is None:
                return "null"
            if (v.isascii() and v.isprintable()
                    and '"' not in v and "\\" not in v):
                return f'"{v}"'
            return dumps(v)

        for j in range(n):
            i = int(rows[j])
            if check:
                stored = stored_col[j]
                if stored is not None and self.version in stored:
                    do[j] = False
                    continue
            filt = filters[i]
            try:
                if info_raws is not None:
                    raw = info_raws[i]
                    info_txt = info_to_json(raw) if raw is not None else "{}"
                else:  # the Python engine: the parsed dict's exact text
                    info_txt = dumps(infos[i], allow_nan=False)
            except ValueError:
                raise _nonfinite(chunk.variant_id[i]) from None
            vals[j] = RawJson(
                f'{{{version}:{{"info":{info_txt},"filter":{jstr(filt)},'
                f'"qual":{jstr(quals[i])},"format":{jstr(formats[i])}}}}}'
            )
            flags[j] = 1 if filt == "PASS" else -1
        return do, {"is_adsp_variant": flags}, {"adsp_qc": vals}


class QcPvcfLoader(UpdateLoader):
    """The update loader with the QC strategy (``update-qc``)."""

    #: metric label / run-ledger script name (obs.ObsSession)
    obs_name = "update-qc"

    def __init__(self, store: VariantStore, ledger: AlgorithmLedger,
                 version: str, update_existing: bool = False, **kw):
        super().__init__(
            store, ledger,
            QcPvcfStrategy(version, update_existing=update_existing),
            datasource=kw.pop("datasource", None), **kw,
        )
