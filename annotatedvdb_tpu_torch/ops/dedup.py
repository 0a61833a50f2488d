"""Within-batch duplicate detection and batch-vs-store membership.

Port of ``annotatedvdb_tpu/ops/dedup.py``:

- :func:`lookup_in_sorted`, the store membership join of
  ``Segment._probe_device``: ``searchsorted`` of the query positions into
  the store's position-sorted column, a lower bound on the hash inside
  each equal-position run (runs are multi-allelic sites), then a 4-probe
  full-byte confirmation over the short run of equal ``(pos, hash)`` keys;
- :func:`lookup_in_sorted_multi`, the same probe of a mesh shard's
  multi-chromosome slice sorted by ``(pos, chromosome-mixed hash)``
  (:func:`mix_chrom_hash`), confirming the chromosome byte too.  On CUDA
  tensors it launches the hand-written ``csrc/lookup_multi.cu`` (a thread
  per query); on CPU tensors it computes
  :func:`lookup_in_sorted_multi_reference`.  There is no fallback between
  the two;
- :func:`mark_batch_duplicates` and :func:`mark_batch_duplicates_multi`,
  the within-batch identity sort of the mesh insert step (the
  single-device insert path dedups on the host), and
  :func:`mark_batch_duplicates_mesh`, its sharded surface.

torch has no multi-key sort and partial uint32 support: hashes are int64
tensors holding uint32 values (``ops/hashing.py``), so every comparison
orders exactly as the reference's uint32 compare, and the lexicographic
sorts are chained stable sorts, least significant key first.
"""

from __future__ import annotations

import ctypes

import torch

#: golden-ratio odd constant decorrelating chromosomes in the mixed hash
#: (the per-shard membership slices hold several chromosomes in ONE
#: (pos, mixed-hash)-sorted run — see ``parallel.device_store``)
CHROM_MIX = 0x9E3779B9

_MASK32 = 0xFFFFFFFF

#: kernel launches by wrapper name — incremented only where the kernel is
#: launched, so a run can show that its main path went through the kernel
LAUNCHES = {"lookup_multi": 0}

#: calls of :func:`lookup_in_sorted_multi_reference` by device type, so a
#: run can show that its card path never took the plain version
CALLS = {"cpu": 0, "cuda": 0}

_lib = None


def lookup_in_sorted(
    store_pos, store_h, store_ref, store_alt, store_rlen, store_alen,
    pos, h, ref, alt, ref_len, alt_len,
):
    """Membership of query rows in a ``(pos, hash)``-sorted store slice.

    Returns (found [N] bool, store_index [N] int32; -1 when absent).  All
    tensors lie on one device; ``store_pos``/``pos`` are int32,
    ``store_h``/``h`` int64, the allele matrices uint8 ``[M, W]``/``[N, W]``."""
    m = store_pos.shape[0]
    lo = torch.searchsorted(store_pos, pos, right=False).to(torch.int32)
    hi = torch.searchsorted(store_pos, pos, right=True).to(torch.int32)

    # lower_bound of h in store_h[lo:hi) — 32 halvings cover any run length
    l, r = lo, hi
    for _ in range(32):
        active = l < r
        mid = (l + r) >> 1
        less = store_h[torch.clamp(mid, 0, m - 1).long()] < h
        l = torch.where(active & less, mid + 1, l)
        r = torch.where(active & ~less, mid, r)

    found = torch.zeros(pos.shape, dtype=torch.bool, device=pos.device)
    index = torch.full(pos.shape, -1, dtype=torch.int32, device=pos.device)
    for k in range(4):
        i = torch.clamp(l + k, 0, m - 1)
        il = i.long()
        cand = (
            (l + k < hi)
            & (store_pos[il] == pos)
            & (store_h[il] == h)
            & (store_rlen[il] == ref_len)
            & (store_alen[il] == alt_len)
            & (store_ref[il] == ref).all(dim=1)
            & (store_alt[il] == alt).all(dim=1)
        )
        take = cand & ~found
        found = found | cand
        index = torch.where(take, i, index)
    return found, index


def _lex_order(keys) -> torch.Tensor:
    """Row order sorting ``keys`` lexicographically, first key most
    significant, ties in row order: chained stable sorts, least
    significant key first."""
    n = keys[0].shape[0]
    order = torch.arange(n, device=keys[0].device)
    for key in reversed(keys):
        _, o = torch.sort(key[order], stable=True)
        order = order[o]
    return order


def _dup_flags(keys, ref, alt, ref_len, alt_len) -> torch.Tensor:
    """Rows whose identity equals an earlier row's (in row order): sort on
    ``keys`` and the row index, then compare neighbours' keys, lengths and
    allele bytes; the first of a run wins."""
    n = keys[0].shape[0]
    out = torch.zeros((n,), dtype=torch.bool, device=keys[0].device)
    if n == 0:
        return out
    idx = _lex_order(keys)
    ks = [k[idx] for k in keys]
    ref_s, alt_s = ref[idx], alt[idx]
    rlen_s, alen_s = ref_len[idx], alt_len[idx]
    same = torch.ones((n - 1,), dtype=torch.bool, device=out.device)
    for k in ks:
        same &= k[1:] == k[:-1]
    same &= (rlen_s[1:] == rlen_s[:-1]) & (alen_s[1:] == alen_s[:-1])
    same &= (ref_s[1:] == ref_s[:-1]).all(dim=1)
    same &= (alt_s[1:] == alt_s[:-1]).all(dim=1)
    dup_sorted = torch.cat([torch.zeros((1,), dtype=torch.bool,
                                        device=out.device), same])
    out[idx] = dup_sorted
    return out


def mark_batch_duplicates(pos, h, ref, alt, ref_len, alt_len) -> torch.Tensor:
    """Flag rows that duplicate an earlier row in the batch ([N] bool, in
    row order): the first occurrence in file order wins, as the
    reference's skip-duplicates policy.  ``h`` holds uint32 values (int64
    or the int32 bits are both accepted)."""
    return _dup_flags((pos.to(torch.int64), _u32(h)), ref, alt, ref_len, alt_len)


def mark_batch_duplicates_multi(chrom, pos, h, ref, alt, ref_len,
                                alt_len) -> torch.Tensor:
    """Chromosome-aware :func:`mark_batch_duplicates` for mesh shards that
    own several chromosomes: the chromosome leads the identity sort, so
    equal ``(pos, hash)`` rows of different chromosomes never compare as
    duplicates."""
    return _dup_flags(
        (chrom.to(torch.int64), pos.to(torch.int64), _u32(h)),
        ref, alt, ref_len, alt_len,
    )


def _u32(h: torch.Tensor) -> torch.Tensor:
    """uint32 hash values as non-negative int64 (from int64 values or the
    kernel's int32 bits)."""
    return h.to(torch.int64) & _MASK32


def mix_chrom_hash(h, chrom) -> torch.Tensor:
    """Chromosome-salted identity hash for multi-chromosome sorted runs
    (int64 holding the uint32 value)."""
    return (_u32(h) ^ ((chrom.to(torch.int64) * CHROM_MIX) & _MASK32)) & _MASK32


def lookup_in_sorted_multi_reference(
    store_chrom, store_pos, store_hm, store_ref, store_alt,
    store_rlen, store_alen,
    chrom, pos, hm, ref, alt, ref_len, alt_len,
):
    """Plain-torch membership in a multi-chromosome shard slice sorted by
    ``(pos, mixed hash)``: the two-level search of :func:`lookup_in_sorted`,
    with the chromosome byte confirmed too, so a cross-chromosome
    ``(pos, mixed-hash)`` collision cannot hit.  Returns (found [N] bool,
    index [N] int32; -1 when absent)."""
    kind = pos.device.type
    CALLS[kind] = CALLS.get(kind, 0) + 1
    m = store_pos.shape[0]
    hm = hm.to(torch.int64)
    store_hm = store_hm.to(torch.int64)
    lo = torch.searchsorted(store_pos, pos, right=False).to(torch.int32)
    hi = torch.searchsorted(store_pos, pos, right=True).to(torch.int32)
    l, r = lo, hi
    for _ in range(32):
        active = l < r
        mid = (l + r) >> 1
        less = store_hm[torch.clamp(mid, 0, max(m - 1, 0)).long()] < hm \
            if m else torch.zeros_like(active)
        l = torch.where(active & less, mid + 1, l)
        r = torch.where(active & ~less, mid, r)
    found = torch.zeros(pos.shape, dtype=torch.bool, device=pos.device)
    index = torch.full(pos.shape, -1, dtype=torch.int32, device=pos.device)
    if m == 0:
        return found, index
    for k in range(4):
        i = torch.clamp(l + k, 0, m - 1)
        il = i.long()
        cand = (
            (l + k < hi)
            & (store_pos[il] == pos)
            & (store_hm[il] == hm)
            & (store_chrom[il] == chrom)
            & (store_rlen[il] == ref_len)
            & (store_alen[il] == alt_len)
            & (store_ref[il] == ref).all(dim=1)
            & (store_alt[il] == alt).all(dim=1)
        )
        take = cand & ~found
        found = found | cand
        index = torch.where(take, i, index)
    return found, index


def _library() -> ctypes.CDLL:
    """The kernel's library with its C interface declared (built at first
    use)."""
    global _lib
    if _lib is None:
        from annotatedvdb_tpu_torch.ops.build import load

        lib = load("lookup_multi")
        lib.lookup_multi_launch.argtypes = (
            [ctypes.c_void_p] * 7 + [ctypes.c_int] + [ctypes.c_void_p] * 7
            + [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 3
        )
        lib.lookup_multi_launch.restype = ctypes.c_int
        _lib = lib
    return _lib


#: (dtype, ndim) of the store columns and the query columns, in order
_COLUMNS = (
    ("chrom", torch.int8, 1), ("pos", torch.int32, 1),
    ("hm", torch.int64, 1), ("ref", torch.uint8, 2), ("alt", torch.uint8, 2),
    ("ref_len", torch.int32, 1), ("alt_len", torch.int32, 1),
)


def _check_multi(store, query) -> None:
    dev = store[1].device
    for side, cols in (("store", store), ("query", query)):
        n = cols[1].shape[0]
        for (name, dtype, ndim), t in zip(_COLUMNS, cols):
            if t.device != dev:
                raise ValueError(
                    f"lookup_in_sorted_multi: {side} {name} is on {t.device}, "
                    f"store pos on {dev}"
                )
            if t.dtype != dtype:
                raise TypeError(
                    f"lookup_in_sorted_multi: {side} {name} must be {dtype}, "
                    f"not {t.dtype}"
                )
            if t.dim() != ndim or t.shape[0] != n or not t.is_contiguous():
                raise ValueError(
                    f"lookup_in_sorted_multi: {side} {name} must be a "
                    f"contiguous {ndim}-D tensor of {n} rows"
                )
        if n >= 2**31 - 1:
            raise ValueError("lookup_in_sorted_multi: too many rows")
    if store[3].shape[1] != query[3].shape[1] or any(
            c[4].shape[1] != c[3].shape[1] for c in (store, query)):
        raise ValueError("lookup_in_sorted_multi: allele widths disagree")


def lookup_in_sorted_multi(
    store_chrom, store_pos, store_hm, store_ref, store_alt,
    store_rlen, store_alen,
    chrom, pos, hm, ref, alt, ref_len, alt_len,
):
    """Membership of query identities in a mesh shard's multi-chromosome
    slice sorted by ``(pos, mixed hash)``: (found [N] bool, index [N]
    int32; -1 when absent).  Columns: chrom int8, pos int32, hm int64
    (uint32 values), ref/alt uint8 ``[., W]``, lengths int32.

    CPU tensors take :func:`lookup_in_sorted_multi_reference`; CUDA
    tensors launch the kernel once on the current stream (no
    synchronisation) or raise."""
    store = (store_chrom, store_pos, store_hm, store_ref, store_alt,
             store_rlen, store_alen)
    query = (chrom, pos, hm, ref, alt, ref_len, alt_len)
    if store_pos.device.type == "cpu":
        return lookup_in_sorted_multi_reference(*store, *query)
    if store_pos.device.type != "cuda":
        raise ValueError(
            f"lookup_in_sorted_multi: unsupported device {store_pos.device}"
        )
    _check_multi(store, query)
    n = pos.shape[0]
    dev = pos.device
    found = torch.empty((n,), dtype=torch.bool, device=dev)
    index = torch.empty((n,), dtype=torch.int32, device=dev)
    if n == 0:
        return found, index
    rc = _library().lookup_multi_launch(
        *(t.data_ptr() for t in store), store_pos.shape[0],
        *(t.data_ptr() for t in query), n, ref.shape[1],
        found.data_ptr(), index.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(
            f"lookup_in_sorted_multi: kernel launch failed (cudaError {rc})"
        )
    LAUNCHES["lookup_multi"] += 1
    return found, index


def mark_batch_duplicates_mesh(pos, h, ref, alt, ref_len, alt_len, mesh=None):
    """The sharded surface of :func:`mark_batch_duplicates` ([N] bool, in
    row order, on the first shard's device).  The reference's identity
    sort is one global program over the batch, so this runs the plain sort
    once on the mesh's first device (the pool's first without a mesh).
    The reference's pad rows carry unique negative positions, never equal
    a row and are sliced away, so they are not made here."""
    from annotatedvdb_tpu_torch.parallel.mesh import _tensor, device_pool, global_mesh

    if mesh is None:
        mesh = global_mesh()
    dev = mesh.devices[0] if mesh is not None else device_pool()[0]
    return mark_batch_duplicates(
        *(_tensor(a, dev) for a in (pos, h, ref, alt, ref_len, alt_len))
    )
