"""Fixture ops registry for the AVDB9xx twin-contract rules (the port's)."""

TWINS: dict = {
    # clean: a launch wrapper, its plain version resolves, both named in tests/
    "ops.kernels.good_kernel": "ops.kernels.good_kernel_reference",
    # resolvable pair with NO test referencing both
    "ops.kernels.untested_kernel":
        "ops.kernels.untested_kernel_reference",     # EXPECT: AVDB903
    # stale: no such kernel wrapper under ops/
    "ops.kernels.ghost_kernel":
        "ops.kernels.ghost_kernel_reference",        # EXPECT: AVDB902
    # stale the other way: the wrapper exists, its plain version does not
    "ops.kernels.orphan_kernel":
        "ops.kernels.no_such_twin",           # EXPECT: AVDB902
}
