"""The port's store membership probe against the JAX package's.

``ops.dedup.lookup_in_sorted`` (plain torch) versus ``lookup_in_sorted_np``
on a seeded (pos, hash)-sorted store with multi-allelic runs, forced
(pos, hash) collisions between distinct identities, absent queries and
pad-sentinel rows.  Exact comparison (tolerance 0)."""

import numpy as np
import pytest
import torch

from annotatedvdb_tpu.ops.dedup import lookup_in_sorted_np

from annotatedvdb_tpu_torch.ops.dedup import lookup_in_sorted

SENTINEL = np.iinfo(np.int32).max


def _store_and_queries(seed: int, m: int = 3000, n: int = 2000, w: int = 8):
    rng = np.random.default_rng(seed)
    # multi-allelic runs: ~1/3 of positions repeat 2-4 times
    pos = np.sort(rng.integers(1, 200_000, m)).astype(np.int32)
    pos[1::3] = pos[0::3][: pos[1::3].size]
    pos = np.sort(pos)
    h = rng.integers(0, 2**32, m, dtype=np.uint64).astype(np.uint32)
    # forced collisions: runs of 3 rows with equal (pos, hash) and
    # different bytes (the probe confirms up to 4 rows of a run)
    for i in range(9, 60, 10):
        h[i + 1:i + 3] = h[i]
        pos[i + 1:i + 3] = pos[i]
    ref = rng.integers(65, 70, (m, w)).astype(np.uint8)
    alt = rng.integers(65, 70, (m, w)).astype(np.uint8)
    rl = rng.integers(1, w + 1, m).astype(np.int32)
    al = rng.integers(1, w + 1, m).astype(np.int32)
    order = np.lexsort((h, pos))
    store = [x[order] for x in (pos, h, ref, alt, rl, al)]
    # queries: half present rows (collision rows included), half altered
    pick = rng.integers(0, m, n)
    key = store[0].astype(np.uint64) << np.uint64(32) | store[1]
    collided = np.flatnonzero(np.r_[False, key[1:] == key[:-1]]
                              | np.r_[key[1:] == key[:-1], False])
    assert collided.size >= 12
    pick[:12] = collided[:12]
    q = [x[pick].copy() for x in store]
    flip = rng.random(n) < 0.5
    flip[:12] = False
    q[2][flip, 0] ^= 1           # same key, different bytes: absent
    q[0][-5:] = SENTINEL         # pad rows never match
    q[0][-10:-5] += 1            # shifted position: absent
    return store, q


def _torch(xs):
    out = []
    for x in xs:
        t = torch.from_numpy(np.ascontiguousarray(x))
        out.append(t.to(torch.int64) if x.dtype == np.uint32 else t)
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_lookup_in_sorted_matches_numpy_twin(seed):
    store, q = _store_and_queries(seed)
    want_found, want_index = lookup_in_sorted_np(*store, *q)
    found, index = lookup_in_sorted(*_torch(store), *_torch(q))
    assert found.dtype == torch.bool and index.dtype == torch.int32
    np.testing.assert_array_equal(found.numpy(), want_found)
    np.testing.assert_array_equal(index.numpy(), want_index)
    assert want_found[:12].all()     # the collision rows resolve by bytes
    assert not want_found[-5:].any()
