"""corticall_tpu_torch — the PyTorch + CUDA port of corticall_tpu.

The JAX package (`corticall_tpu`) stays the reference.  This package runs the
linked DNM pipeline (Build → Join → Thread → FindROIs → prefilters →
Partition → Trim → Call → FilterCalls) with its device work — Partition's
jump-table build and walk, the Call stage's banded Smith-Waterman pre-score
and Tesserae mosaic-alignment DP — as hand-written CUDA kernels for Hopper
(`csrc/*.cu`, built with nvcc at first use and bound with ctypes).

It stands alone: the framework-free host code it runs (k-mer math, graph,
I/O, traversal, the caller's logic, simulate/evaluate, and the C++ core in
csrc/host/, built with g++ into build/native/) is its own copy of the JAX
package's, under the same relative paths.  It imports neither jax nor
corticall_tpu.

Layout, mirroring the JAX package (host copies: kmer, graph, fixtures,
native, build, evaluation, simulate, io/, ops/walk_np, traversal/, utils/,
models/{sw,tesserae,reference_index}, caller/{variants,filter}):
    device.py                   device choice, require_cuda()
    ops/_kernels.py             nvcc build + ctypes binding of csrc/*.cu
    ops/kmer.py                 packed k-mer bit primitives (plain torch)
    ops/placement.py            host hashing + cuckoo placement (numpy)
    ops/jump.py                 jump table build + walk: twins + wrappers
    ops/sw_device.py            banded and full-matrix SW: twins + wrappers
    ops/tesserae_torch.py       Tesserae DP: plain twin + kernel wrapper
    models/contig_aligner.py    batched whole-contig aligner (label_targets)
    caller/call.py              Caller using the SW and Tesserae kernels
    commands/core.py            graph algebra, FindROIs, prefilters, Partition
    pipeline.py                 Pipeline runner, run_pipeline
    demo.py                     the smoke run's simulated cross and scoring
    tools/tesserae_probe.py     barrier and ablation probes of the Tesserae kernel
"""

__version__ = "0.1.0"
