"""String/NULL conventions shared with the reference output format.

The reference imports these helpers from its external ``GenomicsDBData.Util`` /
``niagads`` packages (SURVEY.md §1 "Critical external-dependency note") — they
are in-scope capabilities, re-implemented here from their observed call-site
behavior."""

from __future__ import annotations


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
