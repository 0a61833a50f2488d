"""Multi-device layout.  Only the manifest-only placement hint
(:mod:`.placement`) is ported; the mesh itself is not."""
