"""ADSP consequence ranking service (host side).

Host copy of ``annotatedvdb_tpu/conseq/ranker.py``, which re-implements the
reference's ``ConsequenceParser``
(``Util/lib/python/parsers/adsp_consequence_parser.py``): a combo -> rank
table loaded from a TSV, order-insensitive combo matching with memoization,
and the learn-on-miss **dynamic re-rank** — when a novel combo appears, all
combos are split into the four ADSP groups, each group's combos are ordered
by an alphabetized per-term rank encoding and a three-key sort, and the whole
table is renumbered (``adsp_consequence_parser.py:233-320``).

This mutable, rare-path logic stays on the host.  Batched lookups go
through the :class:`~annotatedvdb_tpu_torch.conseq.table.RankTable`
snapshot, rebuilt after any re-rank.

``int_to_alpha`` is base-26 digits with 'a' = 0 (0->a, 26->ba), and group
indexes / rank values are 0-based — the external-helper semantics
reconstructed from the reference's published rank expectation.
"""

from __future__ import annotations

import csv
import os
from datetime import date

from annotatedvdb_tpu_torch.conseq.groups import ConseqGroup

#: The shipped ADSP consequence-ranking seed: the 294-combo table the
#: reference distributes (``Load/data/custom_consequence_ranking.txt`` —
#: header ``consequence adsp_ranking adsp_impact ensembl_ranking
#: ensembl_impact genomicsdb_consequence``), reproduced as package data so
#: default rankings match the published ADSP ranking out of the box.
DEFAULT_RANKING_FILE = os.path.join(
    os.path.dirname(os.path.dirname(__file__)),
    "data", "adsp_consequence_ranking.txt",
)


def int_to_alpha(n: int) -> str:
    """0 -> 'a', 25 -> 'z', 26 -> 'ba' (base-26 digits, lowercase).

    Matches the reference's external helper as reconstructed from the
    published expectation (``test_conseq_parser.py:23-27``): re-ranking the
    pre-2022 ranking table must give
    ``splice_acceptor_variant,splice_donor_variant,3_prime_UTR_variant,
    intron_variant`` rank 5 — which holds exactly for 0-based group
    indexes, 0-based rank values, and this digit encoding (see
    ``tests/test_conseq.py::test_reference_rank_parity``)."""
    out = []
    while True:
        n, rem = divmod(n, 26)
        out.append(chr(ord("a") + rem))
        if n == 0:
            break
    return "".join(reversed(out))


def alphabetize_combo(terms) -> str:
    """Canonical comma-string for a combo: terms sorted alphabetically
    (unique keys for the rank map)."""
    if isinstance(terms, str):
        terms = terms.split(",")
    return ",".join(sorted(terms))


class ConsequenceRanker:
    def __init__(
        self,
        ranking_file: str | None = None,
        save_on_add: bool = False,
        rank_on_load: bool | None = None,
    ):
        """``ranking_file`` is a TSV with a ``consequence`` column (quoted
        comma combos) and optional ``rank`` column (load order = rank when
        absent); None loads the shipped ADSP 294-combo seed
        (:data:`DEFAULT_RANKING_FILE`) — first-time use of the seed re-ranks
        on load, matching the reference loaders' ``rankOnLoad=True``
        (``load_vep_result.py`` initialize flow)."""
        if ranking_file is None:
            ranking_file = DEFAULT_RANKING_FILE
            if rank_on_load is None:
                rank_on_load = True
        self.ranking_file = ranking_file
        self.save_on_add = save_on_add
        self.added: list[str] = []
        self._match_memo: dict[str, int] = {}
        self.version = 0
        # fail loudly on a bad path — silently falling back to the seed
        # table would change every stored rank
        self.rankings = self._parse_file(ranking_file)
        self._rebuild_canonical()
        if rank_on_load:
            self._rerank()

    #: metadata columns of the shipped 6-column schema, preserved verbatim
    #: through re-ranks and written back by :meth:`save`
    EXTRA_COLUMNS = (
        "adsp_impact", "ensembl_ranking", "ensembl_impact",
        "genomicsdb_consequence",
    )

    @staticmethod
    def _to_numeric(value: str):
        """``to_numeric`` semantics: int when integral, float otherwise —
        the seed's legacy fractional ranks (2.5, 2.6) keep their order."""
        f = float(value)
        i = int(f)
        return i if i == f else f

    def _parse_file(self, path: str) -> dict:
        """csv.DictReader parse (combos are quoted comma-strings in the
        shipped table, ``adsp_consequence_parser.py:105-126`` semantics):
        an explicit rank column (``rank`` or the 6-column schema's
        ``adsp_ranking``) wins; otherwise load order is rank.  The schema's
        metadata columns (impact classes, Ensembl ranks) are retained per
        combo so a save round-trips the full table."""
        out = {}
        self._extra: dict[str, dict] = {}
        with open(path, newline="") as fh:
            reader = csv.DictReader(fh, delimiter="\t")
            fields = reader.fieldnames or ()
            rank_col = (
                "rank" if "rank" in fields
                else "adsp_ranking" if "adsp_ranking" in fields
                else None
            )
            rank = 1
            for row in reader:
                combo = alphabetize_combo(row["consequence"])
                if rank_col is not None:
                    cell = (row[rank_col] or "").strip()
                    if not cell:
                        # fail fast: silently assigning the load-order
                        # counter here would tie this combo with a genuine
                        # low-rank combo and ship scrambled severities
                        raise ValueError(
                            f"{path}: blank {rank_col} for combo "
                            f"{row['consequence']!r}"
                        )
                    out[combo] = self._to_numeric(cell)
                else:
                    out[combo] = rank
                    rank += 1
                extra = {
                    c: row[c] for c in self.EXTRA_COLUMNS
                    if c in fields and (row[c] or "") != ""
                }
                if extra:
                    self._extra[combo] = extra
        return out

    def save(self, path: str | None = None) -> str:
        """Versioned save in the seed's 6-column schema (header
        ``consequence adsp_ranking adsp_impact ensembl_ranking
        ensembl_impact genomicsdb_consequence`` —
        ``Load/data/custom_consequence_ranking.txt``), so a saved table can
        be diffed against the seed and re-consumed by tooling that expects
        the shipped format.  Metadata columns are preserved from the loaded
        file; novel (learned) combos leave them blank.  Rows are written in
        rank order, so readers that derive rank from load order (the
        reference's no-rank-column path) agree with ``adsp_ranking``.
        Saves of the shipped default seed land in the working directory,
        never inside the package data directory (which may be read-only)."""
        if path is None:
            base = os.path.splitext(self.ranking_file or "consequence_ranking.txt")[0]
            if self.ranking_file == DEFAULT_RANKING_FILE:
                base = os.path.basename(base)
            path = f"{base}_{date.today().strftime('%m-%d-%Y')}.txt"
        if os.path.exists(path):
            path = os.path.splitext(path)[0] + f"_v{len(self.added)}.txt"
        extra = getattr(self, "_extra", {})
        with open(path, "w", newline="") as fh:
            writer = csv.writer(
                fh, delimiter="\t", quoting=csv.QUOTE_MINIMAL,
                lineterminator="\n",
            )
            writer.writerow(("consequence",) + ("adsp_ranking",) + self.EXTRA_COLUMNS)
            for combo, rank in self.rankings.items():
                meta = extra.get(alphabetize_combo(combo), {})
                writer.writerow(
                    [combo, rank]
                    + [meta.get(c, "") for c in self.EXTRA_COLUMNS]
                )
        return path

    # ---- matching ---------------------------------------------------------
    # Table keys carry the re-rank's internal term order (the reference's
    # keys do too, which is why it matches via is_equivalent_list scans,
    # adsp_consequence_parser.py:182-186); here an order-insensitive
    # canonical index replaces the O(table) scan.

    def _rebuild_canonical(self) -> None:
        self._canonical = {alphabetize_combo(k): k for k in self.rankings}

    def rank_of(self, combo: str, fail_on_error: bool = False):
        key = self._canonical.get(alphabetize_combo(combo))
        if key is not None:
            return self.rankings[key]
        if fail_on_error:
            raise IndexError(f"Consequence {combo} not found in ADSP rankings.")
        return None

    def find_matching_consequence(self, terms, fail_on_missing: bool = False) -> int:
        """Order-insensitive combo match; learns novel combos by re-ranking
        the whole table (``adsp_consequence_parser.py:169-200``)."""
        if isinstance(terms, str):
            terms = terms.split(",")
        canon = alphabetize_combo(terms)
        if canon not in self._match_memo:
            rank = self.rank_of(canon)
            if rank is None:
                if fail_on_missing:
                    raise IndexError(
                        f"Consequence combination {','.join(terms)} not found "
                        "in ADSP rankings."
                    )
                self._add_and_rerank(terms)
                rank = self.rank_of(canon, fail_on_error=True)
            self._match_memo[canon] = rank
        return self._match_memo[canon]

    def _add_and_rerank(self, terms) -> None:
        canon = alphabetize_combo(terms)
        if canon in self._canonical:
            raise IndexError(
                f"Attempted to add consequence combination {canon}, but already "
                "in ADSP rankings."
            )
        # validate BEFORE mutating: an unknown VEP term must fail cleanly,
        # not leave a poison combo that breaks every later re-rank
        ConseqGroup.validate_terms([canon])
        self.added.append(canon)
        self.rankings[canon] = 0  # placeholder; renumbered by the re-rank
        self._rerank()
        if self.save_on_add and self.ranking_file:
            self.save()

    # ---- the four-group re-rank ------------------------------------------

    def _rerank(self) -> None:
        combos = list(self.rankings.keys())
        ordered = []
        for grp in ConseqGroup:
            require_subset = grp is ConseqGroup.MODIFIER
            members = grp.members(combos, require_subset)
            if members:
                ordered += self._sort_group(members, grp)
        # 0-based rank values (list_to_indexed_dict semantics); a combo in
        # several groups keeps its LAST position (dict overwrite), matching
        # the reference's indexed-dict conversion
        self.rankings = {c: i for i, c in enumerate(ordered)}
        self._rebuild_canonical()
        self._match_memo.clear()
        self.version += 1

    @staticmethod
    def _sort_group(combos: list, grp: ConseqGroup) -> list:
        """Order one group's combos: per-combo alphabetized rank-index string,
        then the reference's three-key sort (alpha asc, length desc, first
        char asc) (``adsp_consequence_parser.py:281-320``)."""
        grp_dict = (
            grp.indexed_dict()
            if grp is ConseqGroup.MODIFIER
            else ConseqGroup.HIGH_IMPACT.indexed_dict()
        )
        ref_dict = ConseqGroup.complete_indexed_dict()

        indexed = []
        for combo in combos:
            terms = combo.split(",")
            member = [t for t in terms if t in grp_dict]
            nonmember = [t for t in terms if t not in grp_dict]
            indexes = [grp_dict[t] for t in member] + [ref_dict[t] for t in nonmember]
            alpha = sorted(int_to_alpha(x) for x in indexes)
            # combo terms ordered by their rank indexes ('internal sort')
            by_rank = [
                t for t, _ in sorted(
                    zip(member + nonmember, indexes), key=lambda kv: kv[1]
                )
            ]
            indexed.append(("".join(alpha), by_rank))

        indexed.sort(key=lambda x: x[0])
        indexed.sort(key=lambda x: len(x[0]), reverse=True)
        indexed.sort(key=lambda x: x[0][0])
        return [",".join(terms) for _, terms in indexed]
