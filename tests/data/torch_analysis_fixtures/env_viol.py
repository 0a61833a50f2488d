"""Fixture: env-var drift violations (AVDB401), the port's.

``# EXPECT: <CODE>`` markers pin the expected findings.  Resolution is
against the port's REAL ``runtime.ENV_VARS`` registry; writes are never flagged.
"""
import os


def read_vars():
    a = os.environ.get("AVDBC_VIRTUAL_DEVICES")  # declared: clean
    b = os.getenv("AVDB_TOTALLY_UNDECLARED")  # EXPECT: AVDB401
    c = os.environ["AVDBC_ALSO_UNDECLARED"]   # EXPECT: AVDB401
    return a, b, c


def write_vars():
    # writes arm fixtures/tests — the variable's job, never a finding
    os.environ["AVDB_SOME_WRITE_ONLY"] = "1"
