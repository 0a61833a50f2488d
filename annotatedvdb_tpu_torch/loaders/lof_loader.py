"""SnpEff loss-of-function updates: ``LOF=`` / ``NMD=`` -> ``loss_of_function``.

Port of ``annotatedvdb_tpu/loaders/lof_loader.py`` (reference
``Load/bin/load_snpeff_lof.py``): parses SnpEff annotation strings
``LOF=(gene|geneId|numTranscripts|fraction)`` (``:112-134``), builds
``{'LOF': [...], 'NMD': [...]}`` update values per known variant
(``:136-173``) and never inserts novel variants.  Lines without ``LOF=``
or ``NMD=`` are skipped before any lookup (``:264-266``).  Rows with a
stored ``loss_of_function`` value are skipped unless
``update_existing=True``; updates merge with jsonb_merge semantics.
"""

from __future__ import annotations

import numpy as np

from annotatedvdb_tpu_torch.loaders.update_loader import (
    UpdateLoader,
    UpdateStrategy,
)
from annotatedvdb_tpu_torch.store import AlgorithmLedger, VariantStore


def parse_lof_string(value) -> list | None:
    """Parse a SnpEff LOF/NMD annotation value into record dicts.

    ``(SFI1|ENSG00000198089|30|0.17),(…)`` ->
    ``[{gene_symbol, gene_id, num_transcripts,
    fraction_affected_transcripts}, …]``.  Values not in the 4-field form
    (e.g. a bare ``;LOF;`` flag) yield None rather than aborting a load."""
    if value is None or value is True:
        return None
    records = []
    for annotation in str(value).split(","):
        parts = annotation.replace("(", "").replace(")", "").split("|")
        if len(parts) < 4:
            return None
        try:
            records.append({
                "gene_symbol": parts[0],
                "gene_id": parts[1],
                "num_transcripts": int(parts[2]),
                "fraction_affected_transcripts": float(parts[3]),
            })
        except ValueError:
            return None
    return records


class SnpEffLofStrategy(UpdateStrategy):
    """The ``generate_update_values`` analog (``load_snpeff_lof.py:136-173``)."""

    insert_novel = False
    jsonb_columns = ("loss_of_function",)

    def __init__(self, update_existing: bool = False):
        self.update_existing = update_existing

    def prefilter(self, chunk):
        """Skip LOF/NMD-less lines before the store lookup: a substring
        screen on the raw INFO text (a false positive reaches ``values``,
        which rejects it with the same counter)."""
        n = chunk.batch.n
        out = np.zeros(n, bool)
        raws = chunk.info_raw
        if raws is not None:
            for i in range(n):
                raw = raws[i]
                out[i] = raw is not None and ("LOF=" in raw or "NMD=" in raw)
        else:
            infos = chunk.info
            for i in range(n):
                info = infos[i]
                out[i] = "LOF" in info or "NMD" in info
        return out

    def values(self, row: dict, existing: dict | None):
        info = row["info"]
        lof = parse_lof_string(info.get("LOF"))
        nmd = parse_lof_string(info.get("NMD"))
        if lof is None and nmd is None:
            return False, {}, {}
        if existing is not None:
            stored = existing.get("loss_of_function")
            if stored is not None and not self.update_existing:
                return False, {}, {}
        update_values = {}
        if lof is not None:
            update_values["LOF"] = lof
        if nmd is not None:
            update_values["NMD"] = nmd
        return True, {}, {"loss_of_function": update_values}


class SnpEffLofLoader(UpdateLoader):
    """Update-only SnpEff LoF/NMD loader (``load-snpeff-lof``)."""

    #: metric label / run-ledger script name (obs.ObsSession)
    obs_name = "load-snpeff-lof"

    def __init__(self, store: VariantStore, ledger: AlgorithmLedger,
                 update_existing: bool = False, **kw):
        super().__init__(
            store, ledger, SnpEffLofStrategy(update_existing=update_existing),
            **kw,
        )
