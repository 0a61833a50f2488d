"""Fixture parity "test" for the port's twins tree: names good_kernel
together with good_kernel_reference, so that pair (and only that pair)
counts as proven for AVDB903.  Not collected by pytest (no test_ prefix) —
the analyzer only needs the names to co-occur in a file under tests/."""

PAIR = ("good_kernel", "good_kernel_reference")
