"""The port's CUDA sources run on the CPU through ``tests/cuda_sim.h``.

``csrc/export_pack.cu`` and ``csrc/bits_spans.cu`` are compiled with
``g++ -std=c++20`` against the header, which maps the CUDA surface they
use onto C++ threads (one ``std::thread`` per CUDA thread, blocks one
after another, warp ballots through a per-warp buffer between barriers),
after each ``kernel<<<grid, block, smem, stream>>>(args)`` launch is
rewritten into ``sim_launch(grid, block, kernel, args)``.  The real
sources, index arithmetic, vector and scalar paths, grid-stride loops
and k-ary ballot searches included, are then called through their C entry
points on numpy buffers and held exactly, on small edge inputs, against
the pack's numpy twin ``export_pack_host`` and the plain version
``bits_spans_reference`` on CPU tensors.  The
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

from annotatedvdb_tpu_torch.ops import export_pack as P
from annotatedvdb_tpu_torch.ops import intervals as I
from annotatedvdb_tpu_torch.ops.build import CSRC_DIR

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
HEADER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "cuda_sim.h")
#: the card faults on a misaligned access where the CPU would not: the
#: sanitizer reports one on stderr here (read by :func:`no_misaligned`)
UBSAN = ("-fsanitize=alignment",)
LAUNCH = re.compile(r"([A-Za-z_]\w*(?:<[^<>]*>)?)\s*<<<(.*?)>>>\s*\((.*?)\);", re.S)


def sim_source(text: str) -> str:
    """A kernel source with the header in place of the CUDA runtime and its
    launches rewritten for the simulator."""
    def launch(m):
        grid, block = (x.strip() for x in m.group(2).split(",")[:2])
        return f"sim_launch(dim3({grid}), dim3({block}), {m.group(1)}, {m.group(3)});"

    text = text.replace("#include <cuda_runtime.h>", f'#include "{HEADER}"')
    out, n = LAUNCH.subn(launch, text)
    assert n == 1, f"expected one launch, found {n}"
    return out


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    """Both kernels built for the simulator, with their C interfaces."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernel sources for the CPU")
    work = tmp_path_factory.mktemp("cuda_sim")
    out = {}
    for name in ("export_pack", "bits_spans"):
        with open(os.path.join(CSRC_DIR, f"{name}.cu")) as f:
            src = work / f"{name}.cpp"
            src.write_text(sim_source(f.read()))
        so = work / f"lib{name}.so"
        proc = subprocess.run([gxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread", *UBSAN,
                               "-o", str(so), str(src)], capture_output=True, text=True)
        assert proc.returncode == 0, proc.stderr[-4000:]
        out[name] = ctypes.CDLL(str(so))
    vp, i = ctypes.c_void_p, ctypes.c_int
    out["export_pack"].export_pack_launch.argtypes = [vp, vp, i, i, vp, vp]
    out["bits_spans"].bits_spans_launch.argtypes = [vp, i, vp, vp, i] + [vp] * 5
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
