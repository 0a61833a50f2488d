"""String/NULL conventions shared with the reference output format.

The reference imports these helpers from its external ``GenomicsDBData.Util`` /
``niagads`` packages (SURVEY.md §1 "Critical external-dependency note") — they
are in-scope capabilities, re-implemented here from their observed call-site
behavior."""

from __future__ import annotations

import json
from typing import Any


def xstr(value: Any, null_str: str = "", false_as_null: bool = False) -> str:
    """Stringify with NULL conventions: None -> ``null_str``; dict/list ->
    JSON; booleans honor ``false_as_null``.  Call-site behavior: metaseq id
    assembly (``variant_annotator.py:126``)."""
    if value is None:
        return null_str
    if isinstance(value, bool):
        if not value and false_as_null:
            return null_str
        return str(value)
    if isinstance(value, (dict, list)):
        return json.dumps(value)
    return str(value)


def truncate(value: str, length: int) -> str:
    """Hard truncation to ``length`` chars (display-allele truncation,
    ``variant_annotator.py:8-10``)."""
    return value[:length] if value is not None else value


def to_numeric(value):
    """str -> int/float when it parses cleanly, else unchanged (INFO-field
    coercion, ``vcf_parser.py`` convert_str2numeric_values call sites)."""
    if not isinstance(value, str):
        return value
    try:
        return int(value)
    except ValueError:
        pass
    try:
        return float(value)
    except ValueError:
        return value


def deep_update(base: dict, patch: dict) -> dict:
    """Recursive dict merge, patch wins; mirrors the server-side
    ``jsonb_merge()`` the reference leans on (``vep_variant_loader.py:227``)."""
    for key, value in patch.items():
        if isinstance(value, dict) and isinstance(base.get(key), dict):
            deep_update(base[key], value)
        else:
            base[key] = value
    return base


def parse_bytes(spec: str) -> int:
    """``"512m"``/``"2g"``/``"65536"`` -> bytes (k/m/g suffixes, base 1024);
    malformed input raises."""
    s = spec.strip().lower()
    mult = 1
    if s and s[-1] in "kmg":
        mult = {"k": 1 << 10, "m": 1 << 20, "g": 1 << 30}[s[-1]]
        s = s[:-1]
    try:
        n = int(float(s) * mult)
    except ValueError:
        raise ValueError(
            f"bad byte size {spec!r}: expected <int>[k|m|g]"
        ) from None
    if n < 0:
        raise ValueError(f"bad byte size {spec!r}: must be >= 0")
    return n
