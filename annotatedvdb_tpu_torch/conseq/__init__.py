from .groups import ConseqGroup, ALL_TERMS, CODING_CONSEQUENCES, is_coding_consequence
from .ranker import ConsequenceRanker
from .table import RankTable

__all__ = [
    "ConseqGroup",
    "ALL_TERMS",
    "CODING_CONSEQUENCES",
    "is_coding_consequence",
    "ConsequenceRanker",
    "RankTable",
]
