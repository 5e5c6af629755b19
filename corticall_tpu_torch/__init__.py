"""corticall_tpu_torch — the PyTorch + CUDA port of corticall_tpu.

The JAX package (`corticall_tpu`) stays the reference.  This package runs the
linked DNM pipeline (Build → Join → Thread → FindROIs → prefilters →
Partition → Trim → Call → FilterCalls) with its device work — Partition's
jump-table build and walk, the Call stage's banded Smith-Waterman pre-score
and Tesserae mosaic-alignment DP — as hand-written CUDA kernels for Hopper
(`csrc/*.cu`, built with nvcc at first use and bound with ctypes).

It reuses the framework-free host code of `corticall_tpu` (graph, I/O,
traversal, caller logic, native C++ core) and never imports jax.

Layout, mirroring the JAX package:
    device.py                   device choice, require_cuda()
    ops/_kernels.py             nvcc build + ctypes binding of csrc/*.cu
    ops/kmer.py                 packed k-mer bit primitives (plain torch)
    ops/placement.py            host hashing + cuckoo placement (numpy)
    ops/jump.py                 jump table build + walk: twins + wrappers
    ops/sw_device.py            banded and full-matrix SW: twins + wrappers
    ops/tesserae_torch.py       Tesserae DP: plain twin + kernel wrapper
    models/contig_aligner.py    batched whole-contig aligner (label_targets)
    caller/call.py              Caller using the SW and Tesserae kernels
    commands/core.py            Partition (native / host / jump-table routes)
    pipeline.py                 run_pipeline
"""

__version__ = "0.1.0"
