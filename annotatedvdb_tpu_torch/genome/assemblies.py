"""Chromosome lengths of the supported genome builds.

Host copy of what the port reads from
``annotatedvdb_tpu/genome/assemblies.py``: the per-chromosome lengths
behind the loader's out-of-bounds counter, and the shipped length-map
files (``data/grch38_chr_map.txt``, ``data/hg19_chr_map.txt``, copies of
the reference's, ``chrN<TAB>length``) that ``bin-references`` reads.
Lengths are the standard public assembly values (GRCh38 primary assembly /
GRCh37-hg19), indexed by chromosome code (1..22, X=23, Y=24, M=25).
"""

from __future__ import annotations

import os

import numpy as np

_DATA_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)), "data")

#: build name (case-insensitive) -> shipped asset file
BUILD_FILES = {
    "grch38": "grch38_chr_map.txt",
    "hg38": "grch38_chr_map.txt",
    "grch37": "hg19_chr_map.txt",
    "hg19": "hg19_chr_map.txt",
}


def build_map_path(build: str) -> str:
    """Path of the shipped length-map file for a build name (raises for
    unknown builds)."""
    key = build.lower()
    if key not in BUILD_FILES:
        raise ValueError(
            f"unknown genome build {build!r}: expected one of "
            f"{sorted(set(BUILD_FILES))} or a chr-map file path"
        )
    return os.path.join(_DATA_DIR, BUILD_FILES[key])

_GRCH38 = (
    248956422, 242193529, 198295559, 190214555, 181538259, 170805979,
    159345973, 145138636, 138394717, 133797422, 135086622, 133275309,
    114364328, 107043718, 101991189, 90338345, 83257441, 80373285,
    58617616, 64444167, 46709983, 50818468, 156040895, 57227415, 16569,
)
_GRCH37 = (
    249250621, 243199373, 198022430, 191154276, 180915260, 171115067,
    159138663, 146364022, 141213431, 135534747, 135006516, 133851895,
    115169878, 107349540, 102531392, 90354753, 81195210, 78077248,
    59128983, 63025520, 48129895, 51304566, 155270560, 59373566, 16569,
)

#: build name (case-insensitive) -> lengths by code 1..25
BUILD_LENGTHS = {
    "grch38": _GRCH38, "hg38": _GRCH38,
    "grch37": _GRCH37, "hg19": _GRCH37,
}


def length_table(build: str = "GRCh38") -> np.ndarray:
    """[26] int64 chromosome-length array indexed by chromosome code
    (index 0 = max int: pad rows never flag as out of bounds)."""
    table = np.full((26,), np.iinfo(np.int64).max, np.int64)
    table[1:] = BUILD_LENGTHS[build.lower()]
    return table
