from annotatedvdb_tpu_torch.genome.refgenome import ReferenceGenome  # noqa: F401
