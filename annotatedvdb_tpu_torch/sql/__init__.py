from annotatedvdb_tpu_torch.sql.schema import full_schema  # noqa: F401
