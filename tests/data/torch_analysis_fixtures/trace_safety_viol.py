"""Fixture: capture-safety violations (AVDB101/AVDB102), the port's.

The reference's ``trace_safety_viol.py`` respelled line for line in the
torch capture spellings; tests/test_torch_analysis.py asserts the port's
analyzer reports the reference's (code, line) pairs for this file.  This
file is never imported — the analyzer is purely static.
"""
import functools
import os

import torch
from annotatedvdb_tpu_torch.utils import faults


@torch.compile
def decorated_kernel(x, y):
    print("tracing", x)                       # EXPECT: AVDB101
    faults.fire("ingest.chunk")               # EXPECT: AVDB101
    flag = os.environ.get("AVDB_PIPELINE")    # EXPECT: AVDB101
    del flag
    if x > 0:                                 # EXPECT: AVDB102
        return x + y
    return x - y


def wrapped_kernel(x):
    counter.inc(1)                            # EXPECT: AVDB101
    return x * 2


wrapped_kernel_script = torch.jit.script(wrapped_kernel)


def sharded_step(block):
    if block:                                 # EXPECT: AVDB102
        return block
    return block * 0


sharded = torch.jit.trace(sharded_step, (example,))


@functools.partial(torch.compile, dynamic=False)
def static_ok(x, mode: bool):
    if mode:          # specialized scalar: allowed
        return x + 1
    if x:                                     # EXPECT: AVDB102
        return x
    return x - 1


def shape_read_ok(x):
    if x.shape[0] > 8:  # static under capture: allowed
        return x
    return x * 2


shape_read_ok_c = torch.compile(dynamic=True)(shape_read_ok)


def host_helper(x):   # NOT captured: none of this is flagged
    print("fine here")
    if x:
        return os.environ.get("AVDB_PIPELINE")
    return None


counter = None
example = None
graph = None


def graph_step(x):    # captured by the CUDA graph below: a clean body
    if x.dim() > 1:
        return x.sum(dim=1)
    return x * 2


with torch.cuda.graph(graph):
    replayed = graph_step(example)
