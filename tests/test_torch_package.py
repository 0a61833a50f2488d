"""The PyTorch port stands alone: it imports without JAX, never imports the
JAX package, and runs on the card unless the caller asks for the CPU."""

import ast
import os
import subprocess
import sys

import pytest
import torch

from annotatedvdb_tpu_torch.runtime import resolve_device

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "annotatedvdb_tpu_torch")


def _port_sources():
    for dirpath, _dirs, files in os.walk(PKG):
        for name in files:
            if name.endswith(".py"):
                yield os.path.join(dirpath, name)
    yield os.path.join(ROOT, "chip_smoke.py")


def test_imports_with_jax_blocked():
    code = (
        "import sys, importlib, pkgutil\n"
        "sys.modules['jax'] = None\n"
        "import annotatedvdb_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "assert not any(m == 'annotatedvdb_tpu' or m.startswith('annotatedvdb_tpu.')\n"
        "               for m in sys.modules), 'the JAX package was imported'\n"
        "print(len(names))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 25


@pytest.mark.parametrize("path", sorted(_port_sources()),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_import_of_jax_package(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("annotatedvdb_tpu", "jax"), (
                f"{os.path.relpath(path, ROOT)}:{node.lineno} imports {name}"
            )


def test_resolve_device_needs_cuda_unless_cpu():
    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device() == torch.device("cuda", 0)
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device()
        with pytest.raises(RuntimeError):
            resolve_device("cuda")
    with pytest.raises(ValueError):
        resolve_device("tpu")


def test_cuda_wrapper_refuses_without_fallback():
    """A non-CPU tensor never takes the plain version: the wrapper either
    launches or raises (here: the meta device, which no kernel serves)."""
    from annotatedvdb_tpu_torch.ops.annotate_cuda import LAUNCHES, annotate_bin

    before = dict(LAUNCHES)
    t = torch.empty((4,), dtype=torch.int32, device="meta")
    a = torch.empty((4, 8), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        annotate_bin(t, a, a, t, t)
    assert LAUNCHES == before
