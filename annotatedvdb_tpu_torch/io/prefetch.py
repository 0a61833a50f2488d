"""Block prefetch: the VEP load's reader on its own thread.

Port of the sequential (untagged) mode of
``annotatedvdb_tpu/io/prefetch.py::ChunkPrefetcher``.  A background thread
pulls blocks from the source iterator at most ``depth`` ahead of the
consumer (a bounded queue, so memory stays O(depth) blocks however far the
reader outruns the transform), and the seconds it spends reading land on
the caller's :class:`~annotatedvdb_tpu_torch.utils.profiling.StageTimer`
as ``ingest`` (busy time on the reader's thread, not consumer wall).
Blocks come out in source order: VEP updates depend on it.  The reference's
shuffled (tagged) scheduling and its ``AVDB_INGEST_*`` knobs are not
ported.
"""

from __future__ import annotations

from annotatedvdb_tpu_torch.utils.pipeline import BoundedStage

_DONE = object()


class ChunkPrefetcher:
    """Bounded background prefetch over a block iterator: at most ``DEPTH``
    blocks sit unconsumed before the reader blocks.  Callers that stop
    early must :meth:`close`."""

    DEPTH = 2

    def __init__(self, source, timer):
        self._stage = BoundedStage(self._timed(iter(source), timer),
                                   depth=self.DEPTH, name="vep-ingest")

    @staticmethod
    def _timed(it, timer):
        """The reader thread's generator: each pull is timed as
        ``ingest``."""
        while True:
            with timer.stage("ingest"):
                block = next(it, _DONE)
            if block is _DONE:
                return
            yield block

    def __iter__(self):
        return self

    def __next__(self):
        return next(self._stage)

    @property
    def stats(self):
        return self._stage.stats

    def close(self) -> bool:
        return self._stage.close()
