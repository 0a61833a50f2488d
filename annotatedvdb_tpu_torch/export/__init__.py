"""The corpus export: the store as shuffled, fixed-shape token batches.

Port of ``annotatedvdb_tpu/export``:

- :mod:`~annotatedvdb_tpu_torch.export.tokens` — the region token layout
  shared with the serving ``tokenize`` output;
- :mod:`~annotatedvdb_tpu_torch.export.writer` — byte-deterministic part
  and manifest writers and the ``is_export_tmp`` debris predicate;
- :mod:`~annotatedvdb_tpu_torch.export.core` — the planner and the batch
  materializer over the prefetch spine and the ``export_pack`` kernel
  (``export`` CLI);
- :mod:`~annotatedvdb_tpu_torch.export.stream` — the ``GET
  /export/stream`` payload builder.

Only the names of the first two are re-exported here: the serve engine
imports ``export.tokens`` on its module path, and ``export.core`` imports
the serve engine.
"""

from annotatedvdb_tpu_torch.export.tokens import (  # noqa: F401
    TOKEN_FIELDS,
    bin_path,
    build_region_tokens,
)
from annotatedvdb_tpu_torch.export.writer import (  # noqa: F401
    MANIFEST_NAME,
    is_export_tmp,
    part_name,
)

__all__ = [
    "TOKEN_FIELDS",
    "bin_path",
    "build_region_tokens",
    "MANIFEST_NAME",
    "is_export_tmp",
    "part_name",
]
