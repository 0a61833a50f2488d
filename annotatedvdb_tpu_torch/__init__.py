"""annotatedvdb_tpu_torch — the PyTorch/CUDA port of ``annotatedvdb_tpu``.

The same chromosome-sharded variant store, VCF insert load and VEP
annotation update, run with PyTorch on an NVIDIA H100 instead of JAX on a
TPU.  The layout mirrors the JAX package so each module's counterpart sits
under the same path:

- ``runtime``   : device resolution (``cuda:0`` unless the caller asks for cpu)
- ``types``     : core batch tuples (``VariantBatch``, ``AnnotatedBatch``) and enums
- ``ops``       : plain-torch kernels (bin index, annotate, hash, store probe)
                  and the hand-written CUDA annotate+bin kernel
                  (``ops/annotate_cuda.py`` + ``csrc/annotate_bin.cu``)
- ``models``    : the loaders' device step and its device selection
- ``oracle``    : scalar golden model for the host-fallback tail
- ``conseq``    : ADSP consequence ranking and its batched rank table
- ``io``        : VCF ingest (Python tokenizer), egress strings, VEP JSON
                  parsing and the block prefetcher
- ``store``     : the variant store (same on-disk format, update half
                  included) and the ledger
- ``loaders``   : the serial VCF insert loader and the VEP update loader
- ``cli``       : ``python -m annotatedvdb_tpu_torch load-vcf|load-vep``

The package imports ``torch`` and ``numpy`` only; it never imports ``jax``
or the JAX package.  Kernels are compiled on first CUDA use, never at
import.
"""

__version__ = "0.1.0"
