"""Corpus part and manifest writers: byte-deterministic, crash-safe shards.

Port of ``annotatedvdb_tpu/export/writer.py``.  A corpus directory is
``part-<n>.npz`` files plus one ``corpus.manifest.json`` describing them:
the token layout, the per-chromosome allele dictionaries, the shuffle seed
and a sha256 per part, so a trainer needs nothing but the directory.

**Byte determinism.**  ``np.savez`` embeds zip member timestamps, so parts
use the store's flat sequential container instead: one JSON header line
naming the arrays, then each array as a raw ``.npy`` stream
(``np.lib.format.write_array``).  :func:`read_part` sniffs the leading
byte (``{``) like the segment reader.

**Durability.**  Every part lands tmp -> fsync -> atomic rename, and the
manifest commits last through ``utils.io.replace_manifest``, so a kill at
any instant leaves a committed prefix of the corpus or prunable
``*.export.tmp*`` debris, never a torn part.  Not ported: the reference's
``export.commit`` fault points (``faults.fire`` on the staged temps) and
its ``AVDB_IO_TRACE`` file wrapper; a kill mid-commit is tested through the
reference's own fault point.
"""

from __future__ import annotations

import hashlib
import io
import json
import os

import numpy as np

from annotatedvdb_tpu_torch.utils import io as tio

#: the corpus directory's self-description (committed last, atomically)
MANIFEST_NAME = "corpus.manifest.json"

#: marker every part-staging temp carries (``part-<n>.npz.export.tmp<pid>``)
EXPORT_TMP_MARKER = ".export.tmp"


def part_name(n: int) -> str:
    """Committed shard file name for part ordinal ``n`` (zero-based)."""
    return f"part-{n:06d}.npz"


def is_export_tmp(fname: str) -> bool:
    """True for export scratch debris: a part-staging temp
    (``part-*.npz.export.tmp<pid>``) or an abandoned manifest temp
    (``.corpus.manifest.json.tmp<pid>``)."""
    return EXPORT_TMP_MARKER in fname or (MANIFEST_NAME + ".tmp") in fname


def prune_debris(out_dir: str) -> list[str]:
    """Unlink abandoned export temps in ``out_dir`` (resume's first act: a
    kill mid-part strands exactly one).  Returns the pruned names."""
    pruned = []
    for fname in sorted(os.listdir(out_dir)):
        fp = os.path.join(out_dir, fname)
        if os.path.isfile(fp) and is_export_tmp(fname):
            tio.unlink(fp)
            pruned.append(fname)
    return pruned


def write_part(out_dir: str, n: int, arrays: dict) -> dict:
    """Commit one corpus part atomically; returns its ledger record body
    (``{"part": n, "file": ..., "sha256": ..., "bytes": ...}``).
    ``arrays`` maps name -> ndarray, written in the given order."""
    final = os.path.join(out_dir, part_name(n))
    tmp = final + EXPORT_TMP_MARKER + str(os.getpid())
    digest = hashlib.sha256()
    header = (json.dumps({"corpus": 1, "names": list(arrays)}) + "\n").encode()
    total = len(header)
    with open(tmp, "wb", buffering=1 << 20) as f:
        f.write(header)
        digest.update(header)
        for name in arrays:
            buf = _npy_bytes(np.ascontiguousarray(arrays[name]))
            f.write(buf)
            digest.update(buf)
            total += len(buf)
        f.flush()
        # unconditional: the rename below lands a durable name
        tio.fsync(f)
    tio.replace(tmp, final)
    if tio.fsync_wanted():
        tio.fsync_dir(out_dir)
    return {"part": n, "file": part_name(n), "sha256": digest.hexdigest(),
            "bytes": total}


def _npy_bytes(arr) -> bytes:
    """The exact ``.npy`` stream ``write_array`` produces for ``arr``, built
    once and both written and hashed, so the manifest digest is the
    committed file's bytes by construction."""
    buf = io.BytesIO()
    np.lib.format.write_array(buf, arr, allow_pickle=False)
    return buf.getvalue()


def read_part(path: str) -> dict:
    """Load one committed part back into ``{name: ndarray}``; anything but
    the flat container is refused as corrupt."""
    with open(path, "rb") as f:
        lead = f.read(1)
        if lead != b"{":
            raise ValueError(
                f"{path}: not a flat-container corpus part "
                f"(leading byte {lead!r})"
            )
        header = json.loads(lead + f.readline())
        if header.get("corpus") != 1:
            raise ValueError(f"{path}: unknown corpus container version")
        return {
            name: np.lib.format.read_array(f, allow_pickle=False)
            for name in header["names"]
        }


def write_manifest(out_dir: str, doc: dict) -> None:
    """Atomic manifest commit (dot-prefixed temp, fsync, rename)."""
    tio.replace_manifest(os.path.join(out_dir, MANIFEST_NAME), doc)


def read_manifest(out_dir: str) -> dict | None:
    """The committed manifest, or None when the directory has none yet."""
    path = os.path.join(out_dir, MANIFEST_NAME)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)
