"""Fixture: CLI-contract violations (AVDB501/AVDB502), the port's.

tests/test_torch_analysis.py runs the port's analyzer with ``loader_clis``
pointed at THIS file, which adds the lifecycle flags inline as the port's
CLIs do: two shared flags are missing and one drifts from the table.
"""
import argparse


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)  # EXPECT: AVDB501, AVDB501
    ap.add_argument("--fileName", required=True)
    ap.add_argument("--commit", action="store_true")
    ap.add_argument("--test", action="store_true")
    ap.add_argument("--logAfter", type=int, default=None)
    ap.add_argument("--logFilePath", default=None)
    ap.add_argument("--maxErrors", type=int, default=0)  # EXPECT: AVDB502
    # --metricsOut / --traceOut are MISSING -> the two AVDB501s above
    return ap.parse_args(argv)
