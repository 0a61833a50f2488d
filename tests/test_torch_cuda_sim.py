"""The port's CUDA sources run on the CPU through ``tests/cuda_sim.h``.

``csrc/export_pack.cu``, ``csrc/bits_spans.cu`` (both of its entry points:
one group and a stack of groups), ``csrc/lookup_multi.cu``,
``csrc/pack.cu`` (three entry points, three launches) and
``csrc/annotate_bin.cu`` (two entry points; its PTX helpers for TMA bulk
copies, mbarriers and byte permutes replaced by the header's emulations,
its dynamic shared memory by a buffer of the launch's size) are compiled with
``g++ -std=c++20`` against the header, which maps the CUDA surface they
use onto C++ threads (one ``std::thread`` per CUDA thread, blocks one
after another, warp ballots through a per-warp buffer between barriers),
after each ``kernel<<<grid, block, smem, stream>>>(args)`` launch is
rewritten into ``sim_launch(grid, block, kernel, args)``.  The real
sources, index arithmetic, vector and scalar paths, grid-stride loops
and k-ary ballot searches included, are then called through their C entry
points on numpy buffers and held exactly, on small edge inputs, against
the pack's numpy twin ``export_pack_host`` and the plain versions
``bits_spans_reference``, ``bits_spans_stacked_reference`` and
``lookup_in_sorted_multi_reference`` on CPU tensors, and the transport's
inflate and packs against ``inflate_alleles_reference``,
``pack_outputs_reference`` and ``pack_vep_outputs_reference``, and the
annotate kernel's two entries against ``annotate_bin_reference`` (the
selection contract) and ``annotate_bin_packed_reference``
(``packed_mismatches``) over ragged tiles, unaligned bases and several
tiles a block.  The
simulated card has 3 SMs of 2 blocks, so the pack's grid strides.  This
is no timing and no proof that ``nvcc`` accepts the source: the card runs
the same comparisons (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
Needs ``g++`` (as the native tokenizer's tests do); skips without it.
"""

import ctypes
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from annotatedvdb_tpu_torch.models.pipeline import packed_mismatches
from annotatedvdb_tpu_torch.ops import annotate_cuda as AC
from annotatedvdb_tpu_torch.ops import dedup as DD
from annotatedvdb_tpu_torch.ops import export_pack as P
from annotatedvdb_tpu_torch.ops import intervals as I
from annotatedvdb_tpu_torch.ops import pack as PK
from annotatedvdb_tpu_torch.ops.build import CSRC_DIR

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
HEADER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "cuda_sim.h")
#: the card faults on a misaligned access where the CPU would not: the
#: sanitizer reports one on stderr here (read by :func:`no_misaligned`)
UBSAN = ("-fsanitize=alignment",)
LAUNCH = re.compile(r"([A-Za-z_]\w*(?:<[^<>]*>)?)\s*<<<(.*?)>>>\s*\((.*?)\);", re.S)


def sim_source(text: str, launches: int = 1) -> str:
    """A kernel source with the header in place of the CUDA runtime and its
    ``launches`` launches rewritten for the simulator."""
    def launch(m):
        grid, block = (x.strip() for x in m.group(2).split(",")[:2])
        return f"sim_launch(dim3({grid}), dim3({block}), {m.group(1)}, {m.group(3)});"

    text = text.replace("#include <cuda_runtime.h>", f'#include "{HEADER}"')
    out, n = LAUNCH.subn(launch, text)
    assert n == launches, f"expected {launches} launches, found {n}"
    return out


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    """Both kernels built for the simulator, with their C interfaces."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernel sources for the CPU")
    work = tmp_path_factory.mktemp("cuda_sim")
    out = {}
    for name in ("export_pack", "bits_spans", "lookup_multi", "pack"):
        with open(os.path.join(CSRC_DIR, f"{name}.cu")) as f:
            src = work / f"{name}.cpp"
            src.write_text(sim_source(f.read(), launches=3 if name == "pack" else 1))
        so = work / f"lib{name}.so"
        proc = subprocess.run([gxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread", *UBSAN,
                               "-o", str(so), str(src)], capture_output=True, text=True)
        assert proc.returncode == 0, proc.stderr[-4000:]
        out[name] = ctypes.CDLL(str(so))
    vp, i = ctypes.c_void_p, ctypes.c_int
    out["export_pack"].export_pack_launch.argtypes = [vp, vp, i, i, vp, vp]
    out["bits_spans"].bits_spans_launch.argtypes = [vp, i, vp, vp, i] + [vp] * 5
    out["bits_spans"].bits_spans_stacked_launch.argtypes = (
        [vp, i, i, vp, vp, i] + [vp] * 5)
    out["lookup_multi"].lookup_multi_launch.argtypes = (
        [vp] * 7 + [i] + [vp] * 7 + [i, i] + [vp] * 3)
    out["pack"].inflate_alleles_launch.argtypes = [vp, vp, i, i, i, vp, vp, vp]
    out["pack"].pack_outputs_launch.argtypes = [vp, vp, vp, i, vp, vp, vp, i, vp, vp]
    out["pack"].pack_vep_outputs_launch.argtypes = [vp, vp, i, vp, i, vp, vp]
    return out


def no_misaligned(capfd) -> None:
    """Fail on any sanitizer report the kernel calls wrote to stderr."""
    err = capfd.readouterr().err
    assert "runtime error" not in err, err[-3000:]


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


def _buffer(n: int, dtype, offset: int) -> np.ndarray:
    """``n`` zeroed items of ``dtype`` starting ``offset`` bytes past a
    64-byte boundary."""
    size = np.dtype(dtype).itemsize
    raw = np.zeros(n * size + 64 + offset, np.uint8)
    start = (-raw.ctypes.data) % 64 + offset
    return raw[start:start + n * size].view(dtype)


# ------------------------------------------------------------ export_pack


def _pack_host(batches, counts) -> np.ndarray:
    """The twin's outputs of each batch, in the kernel's byte layout."""
    parts = []
    for cols, n in zip(batches, counts):
        valid, level, *ints = P.export_pack_host(*cols, np.int32(n))
        parts += [np.stack(ints).astype(np.int32).view(np.uint8).ravel(),
                  valid.view(np.uint8), level.view(np.uint8)]
    return np.concatenate(parts)


def _pack_sim(lib, batches, counts, offset) -> np.ndarray:
    """The kernel's buffer for a stack of batches, the columns ``offset``
    int32 elements past 16-byte alignment (a view into a larger tensor),
    the output aligned (the wrapper allocates it)."""
    nb, b = len(batches), batches[0][0].shape[0]
    cols = _buffer(nb * len(P.COLUMNS) * b, np.int32, 4 * offset)
    cols[:] = np.stack([np.stack(c) for c in batches]).ravel()
    out = _buffer(nb * P.PACKED_ROW_BYTES * b, np.uint8, 0)
    out[:] = 0xAB
    nv = P.clamped_counts(counts, nb, b)
    rc = lib.export_pack_launch(_ptr(cols), _ptr(nv), nb, b, _ptr(out), None)
    assert rc == 0
    return out


@pytest.mark.parametrize("nb,b,offset", [
    (1, 0, 0),      # the edge rows (B = 195, not a multiple of 4)
    (1, 64, 0), (2, 64, 0), (37, 64, 0),
    (3, 36, 0),     # B = 4 mod 8: every other batch's output unaligned
    (2, 37, 0),     # B not a multiple of 4
    (4, 64, 1),     # columns at an unaligned address
    (4, 64, 2), (3, 37, 3),
    (2, 4097, 0),   # more groups than the simulated grid: it strides
], ids=lambda v: str(v))
def test_export_pack_source_matches_twin(libs, capfd, nb, b, offset):
    """Stacks of batches at every per-batch ``n_valid`` case of the smoke
    (``export_stack_counts``), byte for byte against the twin."""
    from chip_smoke import (
        export_edge_columns,
        export_random_columns,
        export_stack_counts,
        export_store_columns,
    )

    if b == 0:
        batches = [export_edge_columns()]
    else:
        batches = [(export_store_columns if k % 2 else export_random_columns)(100 + k, b)
                   for k in range(nb)]
    b = batches[0][0].shape[0]
    for counts in export_stack_counts(nb, b):
        got = _pack_sim(libs["export_pack"], batches, counts, offset)
        no_misaligned(capfd)
        np.testing.assert_array_equal(got, _pack_host(batches, counts))


def test_export_pack_refuses_misaligned_pointers(libs):
    """Columns off 4-byte alignment or an output at an odd address are
    refused before any launch (cudaErrorInvalidValue)."""
    cols = _buffer(7 * 16 + 1, np.int32, 0)
    nv = np.asarray([16], np.int32)
    out = _buffer(30 * 16 + 2, np.uint8, 0)
    launch = libs["export_pack"].export_pack_launch
    assert launch(_ptr(cols) + 2, _ptr(nv), 1, 16, _ptr(out), None) == 1
    assert launch(_ptr(cols), _ptr(nv), 1, 16, _ptr(out) + 1, None) == 1
    assert launch(_ptr(cols), _ptr(nv), 1, 16, _ptr(out) + 2, None) == 0


# ------------------------------------------------------------- bits_spans


def _spans_sim(lib, pos, starts, ends):
    q = starts.shape[0]
    lo, hi, leaf = (np.full(q, -7, np.int32) for _ in range(3))
    level = np.full(q, -7, np.int8)
    pos = np.ascontiguousarray(pos, np.int32)
    rc = lib.bits_spans_launch(_ptr(pos), pos.shape[0], _ptr(starts), _ptr(ends), q,
                               _ptr(lo), _ptr(hi), _ptr(level), _ptr(leaf), None)
    assert rc == 0
    return lo, hi, level, leaf


#: the labels of ``chip_smoke.bits_edge_cases``, one test each
BITS_CASES = ("runs", "k0", "k1", "k2", "k15", "k16", "k17", "k31", "k32", "k33",
              "k63", "k64", "k65", "sentinel-padded", "serving-k")


@pytest.fixture(scope="module")
def bits_cases():
    from chip_smoke import bits_edge_cases

    cases = {c[0]: c[1:] for c in bits_edge_cases()}
    assert tuple(cases) == BITS_CASES
    return cases


@pytest.mark.parametrize("label", BITS_CASES)
def test_bits_spans_source_matches_plain_version(libs, bits_cases, capfd, label):
    """The smoke's search edge cases (``bits_edge_cases``: long runs across
    the rounds' splitters, K = 0 to 65 and not a power of two, the
    sentinel tail, queries before and after the rows, Q not a multiple of
    8), exactly against the plain version on CPU tensors."""
    pos, starts, ends = bits_cases[label]
    got = _spans_sim(libs["bits_spans"], pos, starts, ends)
    no_misaligned(capfd)
    want = I.bits_spans_reference(*(torch.from_numpy(np.ascontiguousarray(x))
                                    for x in (pos, starts, ends)))
    for name, g, w in zip(("lo", "hi", "level", "leaf"), got, want):
        np.testing.assert_array_equal(g, w.numpy(), err_msg=f"{label}: {name}")


def _stacked_sim(lib, pos, starts, ends):
    b, q = starts.shape
    lo, hi, leaf = (np.full((b, q), -7, np.int32) for _ in range(3))
    level = np.full((b, q), -7, np.int8)
    pos = np.ascontiguousarray(pos, np.int32)
    starts = np.ascontiguousarray(starts, np.int32)
    ends = np.ascontiguousarray(ends, np.int32)
    rc = lib.bits_spans_stacked_launch(
        _ptr(pos), b, pos.shape[1], _ptr(starts), _ptr(ends), q,
        _ptr(lo), _ptr(hi), _ptr(level), _ptr(leaf), None)
    assert rc == 0
    return lo, hi, level, leaf


#: the labels of ``chip_smoke.stacked_bits_edge_cases``
STACKED_CASES = ("one-group", "padded", "one-row", "below-first", "all-pad",
                 "few-real", "end-before-start", "phase-shape/100")


@pytest.fixture(scope="module")
def stacked_cases():
    from chip_smoke import stacked_bits_edge_cases

    cases = {c[0]: c[1:] for c in stacked_bits_edge_cases()}
    assert tuple(cases) == STACKED_CASES
    return cases


@pytest.mark.parametrize("label", STACKED_CASES)
def test_bits_spans_stacked_source_matches_plain_version(libs, stacked_cases,
                                                         capfd, label):
    """The stacked entry point (a warp per (group, query)) on the smoke's
    stacks — an all-sentinel group, zero-padded queries (leaf -1), one row
    a group, Q not a multiple of 8, queries below and at a group's first
    row, all-sentinel stacks, groups of fewer real rows than their pad,
    ``end < start`` — exactly against the plain version."""
    pos, starts, ends = stacked_cases[label]
    got = _stacked_sim(libs["bits_spans"], pos, starts, ends)
    no_misaligned(capfd)
    want = I.bits_spans_stacked_reference(
        *(torch.from_numpy(np.ascontiguousarray(x)) for x in (pos, starts, ends)))
    for name, g, w in zip(("lo", "hi", "level", "leaf"), got, want):
        np.testing.assert_array_equal(g, w.numpy(), err_msg=f"{label}: {name}")


def test_bits_spans_refuses_misaligned_pointers(libs):
    """Both entry points refuse a base off 4-byte alignment before any
    launch (cudaErrorInvalidValue), as the pack's does."""
    pos = _buffer(9, np.int32, 0)
    q = _buffer(9, np.int32, 0)
    out = [_buffer(9, np.int32, 0) for _ in range(3)]
    level = _buffer(9, np.int8, 0)
    lib = libs["bits_spans"]
    args = [_ptr(q), _ptr(q), 8, _ptr(out[0]), _ptr(out[1]), _ptr(level),
            _ptr(out[2]), None]
    assert lib.bits_spans_launch(_ptr(pos) + 2, 8, *args) == 1
    assert lib.bits_spans_stacked_launch(_ptr(pos) + 2, 1, 8, *args) == 1
    assert lib.bits_spans_stacked_launch(_ptr(pos), 1, 8, _ptr(q) + 1,
                                         *args[1:]) == 1
    assert lib.bits_spans_stacked_launch(_ptr(pos), 1, 8, *args) == 0


# ----------------------------------------------------------- lookup_multi


def _lookup_sim(lib, store, query, offset=0):
    """The kernel's (found, index) for the smoke's columns; ``offset``
    bytes of misalignment on the allele matrices (a view into a larger
    buffer: the kernel reads them byte by byte)."""
    def place(a, off=0):
        a = np.ascontiguousarray(a)
        buf = _buffer(a.size, a.dtype, off)
        buf[:] = a.ravel()
        return buf

    s = [place(c.astype(np.int64) if k == 2 else c, offset if k in (3, 4) else 0)
         for k, c in enumerate(store)]
    q = [place(c.astype(np.int64) if k == 2 else c, offset if k in (3, 4) else 0)
         for k, c in enumerate(query)]
    n = query[1].shape[0]
    found = np.full(n, 7, np.uint8)
    index = np.full(n, -7, np.int32)
    rc = lib.lookup_multi_launch(*(_ptr(c) for c in s), store[1].shape[0],
                                 *(_ptr(c) for c in q), n, query[3].shape[1],
                                 _ptr(found), _ptr(index), None)
    assert rc == 0
    return found.astype(bool), index


#: allele widths around the confirming groups' strides and a warp's 32
LOOKUP_WIDTHS = [1, 16, 31, 32, 33, 49, 65, 96]


@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "alleles+1"])
@pytest.mark.parametrize("width", LOOKUP_WIDTHS)
def test_lookup_multi_source_matches_plain_version(libs, capfd, width, offset):
    """The smoke's edge slices (``lookup_multi_edge_cases``: runs of five
    and four equal keys, the cross-chromosome collision, unsigned hash
    order, the sentinel pad, an empty and an all-sentinel slice, warps
    mixing queries with 0, 1 and 4 pending candidates, hits on rows that
    start off a 4-byte boundary, a random slice) exactly against the plain
    version on CPU tensors, at widths below, at and past a warp's 32
    lanes, with the allele matrices aligned and one byte off."""
    from chip_smoke import lookup_multi_edge_cases

    cases = lookup_multi_edge_cases(width)
    assert {"mixed-warp", "off-word"} <= {c[0] for c in cases}
    for label, store, query in cases:
        got = _lookup_sim(libs["lookup_multi"], store, query, offset)
        no_misaligned(capfd)
        if label == "off-word" and (width % 4 or offset):
            assert any((j * width + offset) % 4 for j in got[1] if j >= 0)
        cols = [torch.from_numpy(np.ascontiguousarray(c)) for c in store + query]
        cols[2], cols[9] = cols[2].to(torch.int64), cols[9].to(torch.int64)
        want = DD.lookup_in_sorted_multi_reference(*cols)
        np.testing.assert_array_equal(got[0], want[0].numpy(), err_msg=label)
        np.testing.assert_array_equal(got[1], want[1].numpy(), err_msg=label)


def test_lookup_multi_refuses_misaligned_pointers(libs):
    """An int32 or int64 column off its alignment, or a negative size, is
    refused before any launch."""
    from chip_smoke import lookup_multi_edge_cases

    _label, store, query = lookup_multi_edge_cases(16)[0]
    lib = libs["lookup_multi"]
    s = [np.ascontiguousarray(c.astype(np.int64) if k == 2 else c)
         for k, c in enumerate(store)]
    q = [np.ascontiguousarray(c.astype(np.int64) if k == 2 else c)
         for k, c in enumerate(query)]
    n, m, w = q[1].shape[0], s[1].shape[0], q[3].shape[1]
    found = np.zeros(n, np.uint8)
    index = _buffer(n + 1, np.int32, 0)
    hm = _buffer(m + 1, np.int64, 0)
    hm[:m] = s[2]
    ptrs = [_ptr(c) for c in s]

    def launch(store_ptrs, m_=m, idx=_ptr(index)):
        return lib.lookup_multi_launch(*store_ptrs, m_, *(_ptr(c) for c in q),
                                       n, w, _ptr(found), idx, None)

    assert launch(ptrs[:2] + [_ptr(hm) + 4] + ptrs[3:]) == 1
    assert launch(ptrs, idx=_ptr(index) + 2) == 1
    assert launch(ptrs, m_=-1) == 1
    assert launch(ptrs) == 0


# ------------------------------------------------------------------- pack


def _inflate_sim(lib, ref_packed, alt_packed, width, offset):
    """The kernel's ``(ref, alt)``: the packed matrices ``offset`` bytes and
    the outputs ``offset + 1`` bytes past 64-byte alignment."""
    n, cols = ref_packed.shape
    rp, ap = (_buffer(n * cols, np.uint8, offset) for _ in range(2))
    rp[:], ap[:] = ref_packed.ravel(), alt_packed.ravel()
    ro, ao = (_buffer(n * width, np.uint8, offset + 1) for _ in range(2))
    ro[:], ao[:] = 0xAB, 0xCD
    rc = lib.inflate_alleles_launch(_ptr(rp), _ptr(ap), n, cols, width,
                                    _ptr(ro), _ptr(ao), None)
    assert rc == 0
    return ro.reshape(n, width), ao.reshape(n, width)


@pytest.mark.parametrize("offset", [0, 1, 3], ids=lambda v: f"base+{v}")
@pytest.mark.parametrize("width", [1, 2, 7, 8, 16, 49, 96])
def test_inflate_source_matches_plain_version(libs, capfd, width, offset):
    """Every one of the 256 packed byte values in every column (codes 14 and
    15 decode to 0), odd widths (the last high nibble dropped), more packed
    columns than the width needs, and bases off alignment, exactly against
    the plain version."""
    from chip_smoke import pack_inflate_cases

    for label, rp, ap, w in pack_inflate_cases(width):
        got = _inflate_sim(libs["pack"], rp, ap, w, offset)
        no_misaligned(capfd)
        want = PK.inflate_alleles_reference(torch.from_numpy(rp), torch.from_numpy(ap), w)
        for g, x in zip(got, want):
            np.testing.assert_array_equal(g, x.numpy(), err_msg=label)


def _pack_cols_sim(cols, offset):
    """Each column copied ``offset`` bytes past 64-byte alignment when it is
    a byte column (4-byte columns stay aligned, as torch allocates them)."""
    out = []
    for c in cols:
        if c is None:
            out.append(None)
            continue
        c = np.ascontiguousarray(c)
        buf = _buffer(c.shape[0], c.dtype, 0 if c.itemsize == 4 else offset)
        buf[:] = c
        out.append(buf)
    return out


@pytest.mark.parametrize("offset", [0, 1], ids=lambda v: f"base+{v}")
def test_pack_outputs_source_matches_plain_version(libs, capfd, offset):
    """The smoke's edge rows (hash 0 and 0xFFFFFFFF, int32 ends of the leaf,
    levels of 255 and above and negative as int32, int8 levels as the
    kernel gives them, every flag combination, a null ``dup``) and random
    rows at n = 1, 7 and 1,000 (the simulated grid strides), the output at
    an odd address, exactly against the plain version."""
    from chip_smoke import pack_outputs_cases

    lib = libs["pack"]
    for label, cols in pack_outputs_cases():
        h, dup, level, leaf, nd, hf = _pack_cols_sim(cols, offset)
        n = h.shape[0]
        out = _buffer(n * 10, np.uint8, 1)
        out[:] = 0xAB
        rc = lib.pack_outputs_launch(
            _ptr(h), None if dup is None else _ptr(dup), _ptr(level), level.itemsize,
            _ptr(leaf), _ptr(nd), _ptr(hf), n, _ptr(out), None)
        assert rc == 0
        no_misaligned(capfd)
        want = PK.pack_outputs_reference(*(None if c is None else torch.from_numpy(
            np.ascontiguousarray(c)) for c in cols))
        np.testing.assert_array_equal(out.reshape(n, 10), want.numpy(), err_msg=label)


@pytest.mark.parametrize("offset", [0, 1], ids=lambda v: f"base+{v}")
def test_pack_vep_outputs_source_matches_plain_version(libs, capfd, offset):
    """The VEP row on the same cases: prefix lengths of 255 and above as
    int32, int8 prefixes, every flag, exactly against the plain version."""
    from chip_smoke import pack_outputs_cases

    lib = libs["pack"]
    for label, (h, _dup, level, _leaf, _nd, hf) in pack_outputs_cases():
        hs, ps, fs = _pack_cols_sim((h, level, hf), offset)
        n = hs.shape[0]
        out = _buffer(n * 6, np.uint8, 3)
        rc = lib.pack_vep_outputs_launch(_ptr(hs), _ptr(ps), ps.itemsize, _ptr(fs), n,
                                         _ptr(out), None)
        assert rc == 0
        no_misaligned(capfd)
        want = PK.pack_vep_outputs_reference(*(torch.from_numpy(np.ascontiguousarray(c))
                                              for c in (h, level, hf)))
        np.testing.assert_array_equal(out.reshape(n, 6), want.numpy(), err_msg=label)


def test_pack_refuses_bad_arguments(libs):
    """Word columns off 4-byte alignment, a level width other than 1 or 4,
    and too few packed columns for the width are refused before any
    launch (cudaErrorInvalidValue)."""
    lib = libs["pack"]
    w32 = _buffer(9, np.int32, 0)
    b8 = _buffer(9, np.uint8, 0)
    out = _buffer(90, np.uint8, 0)
    args = [_ptr(b8), _ptr(w32), 4, _ptr(w32), _ptr(b8), _ptr(b8), 8, _ptr(out), None]
    assert lib.pack_outputs_launch(_ptr(w32), *args) == 0
    assert lib.pack_outputs_launch(_ptr(w32) + 2, *args) == 1
    assert lib.pack_outputs_launch(_ptr(w32), _ptr(b8), _ptr(w32) + 1, 4,
                                   *args[3:]) == 1
    assert lib.pack_outputs_launch(_ptr(w32), _ptr(b8), _ptr(b8), 2, *args[3:]) == 1
    assert lib.pack_vep_outputs_launch(_ptr(w32) + 1, _ptr(b8), 1, _ptr(b8), 8,
                                       _ptr(out), None) == 1
    assert lib.inflate_alleles_launch(_ptr(b8), _ptr(b8), 1, 3, 7, _ptr(out),
                                      _ptr(out), None) == 1
    assert lib.inflate_alleles_launch(_ptr(b8), _ptr(b8), 1, 4, 7, _ptr(out),
                                      _ptr(out), None) == 0


# ------------------------------------------------------------ annotate_bin

#: csrc/annotate_bin.cu's PTX helpers, by name, and the bodies that
#: emulate them on the CPU (the fences in its kernels drop out)
PTX_HELPERS = {
    "smem_addr": "return 0;",
    "mbar_init": "(void)count; sim_mbar_init(bar);",
    "mbar_arrive_expect_tx": "sim_mbar_expect(bar, bytes);",
    "mbar_wait": "sim_mbar_wait(bar, parity);",
    "bulk_copy": "sim_bulk_copy(dst, src, bytes, bar);",
    "prmt": "return sim_prmt(a, b, sel);",
}
#: a launch with dynamic shared memory: its size sizes the simulator's
SMEM_LAUNCH = re.compile(r"(\w+)<<<([^,]+),\s*([^,]+),\s*((?:[^,()]|\([^()]*\))+),"
                         r"\s*(static_cast<cudaStream_t>\(stream\))>>>\((\w+)\);")


def annotate_sim_source(text: str) -> str:
    """``csrc/annotate_bin.cu`` for the simulator: each PTX helper's body
    replaced by its emulation, the fences dropped, the dynamic shared
    memory the simulator's buffer sized at each launch."""
    for name, body in PTX_HELPERS.items():
        m = re.search(r"__device__ __forceinline__ [^\n]*\b%s\(" % name, text)
        assert m, f"annotate_bin.cu has no helper {name}"
        start = text.index("{", m.end())
        depth, end = 0, start
        for end in range(start, len(text)):
            depth += {"{": 1, "}": -1}.get(text[end], 0)
            if depth == 0:
                break
        text = text[:start] + "{\n  " + body + "\n}" + text[end + 1:]
    text, fences = re.subn(r'asm volatile\("fence[^;]*;\\n" ::: "memory"\);', "", text)
    assert fences == 4, fences  # two a kernel: after the barriers' init, before a refill
    assert "asm" not in re.sub(r"//[^\n]*", "", text), "an unemulated PTX statement"
    text = text.replace("extern __shared__ __align__(128) uint8_t smem[];",
                        "uint8_t* smem = sim_dynamic_smem;")
    text, n = SMEM_LAUNCH.subn(
        lambda m: f"sim_dynamic_smem_alloc({m.group(4)}); "
                  f"{m.group(1)}<<<{m.group(2)}, {m.group(3)}, 0, {m.group(5)}>>>({m.group(6)});",
        text)
    assert n == 2, n
    return sim_source(text, launches=2)


@pytest.fixture(scope="module")
def annotate_lib(tmp_path_factory):
    """``csrc/annotate_bin.cu`` built for the simulator, both entries
    declared."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernel sources for the CPU")
    work = tmp_path_factory.mktemp("cuda_sim_annotate")
    src = work / "annotate_bin.cpp"
    with open(os.path.join(CSRC_DIR, "annotate_bin.cu")) as f:
        src.write_text(annotate_sim_source(f.read()))
    so = work / "libannotate_bin.so"
    proc = subprocess.run([gxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread", *UBSAN,
                           "-o", str(so), str(src)], capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr[-4000:]
    lib = ctypes.CDLL(str(so))
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.annotate_bin_launch.argtypes = [vp] * 5 + [i, i, vp, vp]
    lib.annotate_bin_packed_launch.argtypes = [vp] * 5 + [i, i, i, vp, vp]
    return lib


def _placed(x: np.ndarray, offset: int) -> np.ndarray:
    buf = _buffer(x.size, x.dtype, offset * x.itemsize).reshape(x.shape)
    buf[...] = x
    return buf


def _annotate_packed_sim(lib, case, width, offsets, out_offset):
    """The packed entry's ``[n, 10]`` rows, each input ``offsets`` elements
    and the output ``out_offset`` bytes past 64-byte alignment."""
    args = [_placed(np.ascontiguousarray(x), off) for x, off in zip(case, offsets)]
    n, cols = args[1].shape
    out = _buffer(n * 10, np.uint8, out_offset)
    out[:] = 0xAB
    rc = lib.annotate_bin_packed_launch(*(_ptr(a) for a in args), n, cols, width,
                                        _ptr(out), None)
    assert rc == 0
    return out.reshape(n, 10)


@pytest.mark.parametrize("extra_cols", [0, 3], ids=["cols", "cols+3"])
@pytest.mark.parametrize("width", [1, 7, 8, 49, 96, 192])
def test_annotate_packed_source_matches_plain_version(annotate_lib, capfd, width,
                                                      extra_cols):
    """The packed entry on ``chip_smoke.annotate_packed_cases`` (every packed
    byte value, codes 14 and 15, over-width and SNV rows, edge rows) at 1,
    129 and 257 rows and all 536 (five tiles on the simulated card's six
    block slots, then a block walking several tiles at 2,000 rows), the
    packed matrices 3 and 7 bytes off alignment and the output aligned or
    not (16-byte or byte stores): the plain composition's rows under the
    selection contract, and the same rows from every placement."""
    from chip_smoke import annotate_packed_cases

    case = annotate_packed_cases(width, extra_cols)
    for n in (1, 129, 257, None):
        cut = [x[:n] for x in case]
        want = AC.annotate_bin_packed_reference(*(torch.from_numpy(x) for x in cut), width)
        outs = [_annotate_packed_sim(annotate_lib, cut, width, offsets, out_off)
                for offsets, out_off in (((0, 0, 0, 0, 0), 0), ((1, 3, 7, 1, 1), 0),
                                         ((0, 5, 2, 0, 0), 3))]
        no_misaligned(capfd)
        assert packed_mismatches(want, torch.from_numpy(outs[0].copy())) == [], (n,)
        for got in outs[1:]:
            np.testing.assert_array_equal(got, outs[0])
    if width == 49:
        big = [np.concatenate([x] * 4)[:2000] for x in case]
        want = AC.annotate_bin_packed_reference(*(torch.from_numpy(x) for x in big), width)
        got = _annotate_packed_sim(annotate_lib, big, width, (1, 3, 7, 1, 1), 0)
        no_misaligned(capfd)
        assert packed_mismatches(want, torch.from_numpy(got.copy())) == []


@pytest.mark.parametrize("width", [1, 8, 49, 192])
def test_annotate_fields_source_matches_plain_version(annotate_lib, capfd, width):
    """The first entry on the smoke's edge rows and 300 random rows, ref and
    alt off alignment: the 13 fields in the kernel's layout against
    ``annotate_bin_reference`` under the selection contract."""
    from chip_smoke import edge_batch, random_batch

    words = [name for name, dtype in AC.FIELDS if dtype == torch.int32]
    small = [name for name, dtype in AC.FIELDS if dtype != torch.int32]
    for batch in (edge_batch(width), random_batch(width, 300, width)):
        args = [_placed(np.ascontiguousarray(x), off)
                for x, off in zip(batch, (0, 3, 5, 0, 0))]
        n = args[0].shape[0]
        out = _buffer(n * AC.ROW_BYTES, np.uint8, 0)
        rc = annotate_lib.annotate_bin_launch(*(_ptr(a) for a in args), n, width,
                                              _ptr(out), None)
        assert rc == 0
        no_misaligned(capfd)
        want = AC.annotate_bin_reference(*(torch.from_numpy(np.ascontiguousarray(x))
                                           for x in batch))
        ok = ~want["host_fallback"].numpy()
        w32 = out[:4 * len(words) * n].view(np.int32).reshape(len(words), n)
        b8 = out[4 * len(words) * n:].reshape(len(small), n)
        for name, dtype in AC.FIELDS:
            got = (w32[words.index(name)] if name in words
                   else b8[small.index(name)].view(np.int8 if dtype == torch.int8 else np.uint8))
            ref = want[name].numpy().astype(got.dtype)
            rows = slice(None) if name in AC.EVERY_ROW else ok
            np.testing.assert_array_equal(got[rows], ref[rows], err_msg=name)


def test_annotate_source_refuses_bad_arguments(annotate_lib):
    """Too few or too many packed columns, a width outside 1..192 and no
    rows are refused before any launch (cudaErrorInvalidValue)."""
    lib = annotate_lib
    i32 = _buffer(8, np.int32, 0)
    packed = _buffer(8 * 193, np.uint8, 0)
    out = _buffer(80, np.uint8, 0)
    ptrs = [_ptr(i32), _ptr(packed), _ptr(packed), _ptr(i32), _ptr(i32)]
    assert lib.annotate_bin_packed_launch(*ptrs, 8, 25, 49, _ptr(out), None) == 0
    for n, cols, w in ((8, 24, 49), (8, 193, 192), (8, 97, 193), (8, 1, 0), (0, 25, 49)):
        assert lib.annotate_bin_packed_launch(*ptrs, n, cols, w, _ptr(out), None) == 1, (n, cols, w)
    assert lib.annotate_bin_launch(*ptrs, 8, 193, _ptr(out), None) == 1
