"""The variant store, its ledger and the store-side writers.

The names below resolve lazily (PEP 562): the serve fleet's supervisor
reads ``store.maintenance`` and must not import ``torch``, which
``variant_store`` does.
"""

__all__ = [
    "AlgorithmLedger", "ChromosomeShard", "Segment", "StoreCorruptError",
    "VariantStore",
]


def __getattr__(name):
    if name == "AlgorithmLedger":
        from .ledger import AlgorithmLedger

        return AlgorithmLedger
    if name in __all__:
        from . import variant_store

        return getattr(variant_store, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
