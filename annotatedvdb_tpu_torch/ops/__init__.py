"""The port's device functions: plain torch versions and the wrappers of
the hand-written CUDA kernels (``csrc/``).

:data:`TWINS` registers each kernel wrapper (a module-level function that
calls a ``<name>_launch`` entry point of its ctypes library) against its
plain torch version, the counterpart of the reference's
``annotatedvdb_tpu/ops/__init__.py::TWINS``.  On the CPU every wrapper
runs its plain version; on the card the tests hold the kernel against it.
``python -m annotatedvdb_tpu_torch.analysis`` checks the registry
(AVDB9xx): every wrapper registered, every name resolving, every pair
named together in one ``tests/test_torch_*.py`` file.
"""

#: {kernel wrapper: its plain version}, both package-relative dotted names
TWINS: dict = {
    "ops.annotate_cuda.annotate_bin": "ops.annotate_cuda.annotate_bin_reference",
    "ops.annotate_cuda.annotate_bin_packed":
        "ops.annotate_cuda.annotate_bin_packed_reference",
    "ops.annotate_cuda.annotate_bin_identity":
        "ops.annotate_cuda.annotate_bin_identity_reference",
    "ops.cadd_join.cadd_join": "ops.cadd_join.cadd_join_reference",
    "ops.dedup.lookup_in_sorted_multi":
        "ops.dedup.lookup_in_sorted_multi_reference",
    "ops.export_pack.export_pack": "ops.export_pack.export_pack_reference",
    "ops.intervals.bits_spans": "ops.intervals.bits_spans_reference",
    "ops.intervals.bits_spans_stacked":
        "ops.intervals.bits_spans_stacked_reference",
    "ops.pack.pack_outputs": "ops.pack.pack_outputs_reference",
    "ops.pack.pack_vep_outputs": "ops.pack.pack_vep_outputs_reference",
    "ops.pack.inflate_alleles": "ops.pack.inflate_alleles_reference",
    "ops.stats.stats_panel": "ops.stats.stats_panel_reference",
    "ops.stats.windowed_stats": "ops.stats.windowed_stats_reference",
    "genome.refgenome.validate_ref": "genome.refgenome.validate_ref_reference",
}
