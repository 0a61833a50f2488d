"""Chunked async ingest prefetch: the front stage of both loaders.

Port of ``annotatedvdb_tpu/io/prefetch.py``.  A background thread reads,
decompresses and tokenizes chunks (or, for the VEP load, cuts blocks)
AHEAD of the pipeline, bounded by a small queue so memory stays O(depth)
chunks however far the scanner outruns the consumer.  Three knobs shape
it, all loudly validated (a typo'd knob fails the entry point, never
silently falls back):

- ``AVDB_INGEST_CHUNK_ROWS``     — rows per ingest chunk (overrides the
  loader's ``batch_size`` for the scan);
- ``AVDB_INGEST_PREFETCH_DEPTH`` — chunks the scanner may run ahead
  (queue bound = backpressure distance);
- ``AVDB_INGEST_SHUFFLE_SEED``   — arms *shuffled chunk scheduling*:
  chunks leave the prefetcher in a seeded random order (disjoint blocks
  of ``max(2, depth)`` chunks, each permuted).  The VCF loader's
  :class:`~annotatedvdb_tpu_torch.utils.pipeline.Resequencer` restores
  source order before any order-bearing work, so a shuffled schedule
  still writes a byte-identical store.

:class:`ChunkPrefetcher` wraps any chunk iterator.  In *tagged* mode it
yields ``(seq, chunk)`` pairs (seq = source position, the resequencer's
key); untagged it yields chunks in source order — the VEP load's block
reader rides that mode.  Either way scan seconds land on the caller's
``StageTimer`` as ``ingest``, busy time on the prefetch thread.
"""

from __future__ import annotations

import os
import random

from annotatedvdb_tpu_torch.utils.pipeline import BoundedStage

_DONE = object()


def _knob_int(name: str, raw, default, minimum: int):
    """One loudly-validated integer knob: unset/empty -> default, anything
    unparsable or out of range raises (never a silent fallback)."""
    raw = (raw or "").strip()
    if not raw:
        return default
    try:
        value = int(raw)
    except ValueError:
        raise ValueError(
            f"{name} must be an integer, not {raw!r}"
        ) from None
    if value < minimum:
        raise ValueError(f"{name} must be >= {minimum}, not {value}")
    return value


def ingest_chunk_rows(default: int | None = None) -> int | None:
    """``AVDB_INGEST_CHUNK_ROWS``: rows per ingest chunk, or ``default``
    (the loader's ``batch_size``) when unset."""
    return _knob_int(
        "AVDB_INGEST_CHUNK_ROWS",
        os.environ.get("AVDB_INGEST_CHUNK_ROWS"), default, 1,
    )


def ingest_prefetch_depth(default: int = 2) -> int:
    """``AVDB_INGEST_PREFETCH_DEPTH``: chunks the scanner may run ahead of
    the consumer (the bounded-queue depth of every stage)."""
    return _knob_int(
        "AVDB_INGEST_PREFETCH_DEPTH",
        os.environ.get("AVDB_INGEST_PREFETCH_DEPTH"), default, 1,
    )


def ingest_shuffle_seed() -> int | None:
    """``AVDB_INGEST_SHUFFLE_SEED``: arms shuffled chunk scheduling with
    this seed; ``None`` (unset/empty) keeps strict source order."""
    return _knob_int(
        "AVDB_INGEST_SHUFFLE_SEED",
        os.environ.get("AVDB_INGEST_SHUFFLE_SEED"), None, 0,
    )


class ChunkPrefetcher:
    """Bounded background prefetch over a chunk iterator.

    ``source`` is consumed on a daemon thread (a
    :class:`~annotatedvdb_tpu_torch.utils.pipeline.BoundedStage`); at most
    ``depth`` scheduled chunks sit unconsumed before the scan blocks.
    ``tagged=True`` yields ``(seq, chunk)``; with a ``shuffle_seed`` the
    emission order permutes disjoint ``max(2, depth)``-chunk blocks
    (``random.Random(seed)``, so a fixed seed replays the same schedule).
    Untagged mode never shuffles.  ``timer`` attributes scan seconds to its
    ``ingest`` stage ON the prefetch thread.  Callers that stop early must
    :meth:`close`.
    """

    def __init__(self, source, *, timer, depth: int | None = None,
                 shuffle_seed: int | None = None, tagged: bool = False,
                 name: str = "ingest-prefetch"):
        self.depth_limit = ingest_prefetch_depth() if depth is None else depth
        if self.depth_limit < 1:
            raise ValueError(
                f"prefetch depth must be >= 1, not {self.depth_limit}"
            )
        self.shuffle_seed = shuffle_seed
        self.tagged = tagged
        if shuffle_seed is not None and not tagged:
            raise ValueError(
                "shuffled scheduling requires tagged=True (consumers need "
                "the seq to restore order)"
            )
        self._stage = BoundedStage(
            self._schedule(iter(source), timer),
            depth=self.depth_limit, name=name,
        )

    def _schedule(self, it, timer):
        """The prefetch-thread generator: pull + (optionally) block-shuffle.

        Armed shuffling permutes DISJOINT consecutive blocks of
        ``max(2, depth)`` chunks, so a chunk is emitted at most
        ``block - 1`` positions from home: the resequencer's held set is
        hard-bounded at O(depth) chunks."""
        rng = (random.Random(self.shuffle_seed)
               if self.shuffle_seed is not None else None)
        block: list = []
        win = max(2, self.depth_limit) if rng is not None else 1
        seq = 0
        while True:
            with timer.stage("ingest"):
                chunk = next(it, _DONE)
            if chunk is _DONE:
                break
            block.append((seq, chunk))
            seq += 1
            if len(block) >= win:
                yield from self._emit(block, rng)
        yield from self._emit(block, rng)

    def _emit(self, block: list, rng):
        if rng is not None and len(block) > 1:
            rng.shuffle(block)
        for seq, chunk in block:
            yield (seq, chunk) if self.tagged else chunk
        block.clear()

    def __iter__(self):
        return self

    def __next__(self):
        return next(self._stage)

    @property
    def stats(self):
        return self._stage.stats

    @property
    def error(self):
        return self._stage.error

    def close(self, timeout: float = 10.0) -> bool:
        return self._stage.close(timeout)
