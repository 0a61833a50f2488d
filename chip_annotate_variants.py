#!/usr/bin/env python3
"""``annotate_bin``'s first entry from two sources, timed in turns on one card.

Builds ``build/variants/annotate_bin_prior.cu`` (an earlier
``csrc/annotate_bin.cu``, written there beforehand, for example with
``git show <commit>:annotatedvdb_tpu_torch/csrc/annotate_bin.cu``) and the
checkout's ``csrc/annotate_bin.cu`` with the port's ``nvcc`` flags, holds
their 13-field outputs equal byte for byte on every input set, then times
``annotate_bin_launch`` of each at the VCF load's chunk (65,536 rows, ten
input sets) and at 1,048,576 rows (two sets), W = 49, in turns (prior,
current, current, prior): ``torch.profiler`` device ms of
``annotate_bin_kernel`` a call, and CUDA-event ms a call.  Prints the
card's name and power limit, then one JSON object.  Needs one CUDA card;
run from the repository root as ``python3 chip_annotate_variants.py``.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
VARIANTS = os.path.join(ROOT, "build", "variants")


def main() -> int:
    import numpy as np
    import torch

    sys.path.insert(0, ROOT)
    from annotatedvdb_tpu_torch.ops.annotate_cuda import ROW_BYTES
    from annotatedvdb_tpu_torch.ops.build import CSRC_DIR, NVCC_FLAGS, _nvcc
    from chip_smoke import BIG_ROWS, CHUNK_ROWS, WIDTH, call_ms, device_profile, random_batch

    if not torch.cuda.is_available():
        print("chip_annotate_variants: needs a CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    sources = {"prior": os.path.join(VARIANTS, "annotate_bin_prior.cu"),
               "current": os.path.join(CSRC_DIR, "annotate_bin.cu")}
    os.makedirs(VARIANTS, exist_ok=True)
    procs = {}
    for tag, src in sources.items():
        so = os.path.join(VARIANTS, f"libannotate_bin_{tag}.so")
        procs[tag] = (so, subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", so, src],
                                           stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT, text=True))
    libs, ptxas = {}, {}
    for tag, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            print(f"chip_annotate_variants: {tag} failed to build:\n{log}", file=sys.stderr)
            return 1
        ptxas[tag] = [ln.strip() for ln in log.splitlines() if "registers" in ln]
        lib = ctypes.CDLL(so)
        lib.annotate_bin_launch.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 2)
        lib.annotate_bin_launch.restype = ctypes.c_int
        libs[tag] = lib
    device = torch.device("cuda", 0)

    def entry(lib):
        def run(pos, ref, alt, rl, al):
            n, w = ref.shape
            out = torch.empty((n * ROW_BYTES,), dtype=torch.uint8, device=device)
            rc = lib.annotate_bin_launch(
                pos.data_ptr(), ref.data_ptr(), alt.data_ptr(), rl.data_ptr(),
                al.data_ptr(), n, w, out.data_ptr(),
                torch.cuda.current_stream(device).cuda_stream)
            if rc != 0:
                raise RuntimeError(f"annotate_bin_launch failed (cudaError {rc})")
            return out
        return run

    fns = {tag: entry(lib) for tag, lib in libs.items()}
    out = {"ptxas": ptxas}
    for key, rows, n_sets, iters in (("chunk", CHUNK_ROWS, 10, 200),
                                     ("1m", BIG_ROWS, 2, 50)):
        sets = [[torch.from_numpy(np.ascontiguousarray(x)).to(device)
                 for x in random_batch(10 + i, rows, WIDTH)] for i in range(n_sets)]
        for args in sets:
            if not torch.equal(fns["prior"](*args), fns["current"](*args)):
                print(f"chip_annotate_variants: outputs differ at {key}", file=sys.stderr)
                return 1
        runs = []
        for tag in ("prior", "current", "current", "prior"):
            prof = device_profile(torch, fns[tag], sets, iters)
            ms = None if prof is None else prof["kernels"].get("annotate_bin_kernel", {}).get("ms")
            runs.append({"source": tag, "device_ms": ms,
                         "call_ms": call_ms(torch, fns[tag], sets, iters)})
        out[key] = {"rows": rows, "runs": runs, **{
            f"{tag}_ms": min((r["device_ms"] or r["call_ms"]) for r in runs
                             if r["source"] == tag) for tag in ("prior", "current")}}
        out[key]["current_over_prior"] = out[key]["current_ms"] / out[key]["prior_ms"]
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
