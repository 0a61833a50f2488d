"""The query server: engine, batcher, residency, resilience and the
thread-per-connection HTTP front end (``python -m annotatedvdb_tpu_torch
serve --frontend threaded``)."""
