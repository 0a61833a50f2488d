from .ledger import AlgorithmLedger
from .variant_store import ChromosomeShard, Segment, StoreCorruptError, VariantStore

__all__ = [
    "AlgorithmLedger", "ChromosomeShard", "Segment", "StoreCorruptError",
    "VariantStore",
]
