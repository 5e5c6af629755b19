#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (corticall_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, one JSON line each (progress goes to stderr):

1. environment: GPU name and power limit (nvidia-smi), torch and CUDA
   versions, and whether the native C++ core loads (probed in a child
   process, so an incompatible library is reported, not a crash);
2. build: nvcc compiles corticall_tpu_torch/csrc/*.cu for sm_90a;
3. kernels against their plain PyTorch twins on the card: banded SW at the
   production pre-score shape (B=256, Q=4096, S=8192, band 512), at
   B=1024, Q=512, S=1024, band 64 and at the trio's widest pre-score batch
   (B=8, Q=336, S=464, band 512); Tesserae on 8 recombinant sections of
   2-16 targets of 500-4000 bp and one of 80 targets of 200-300 bp (past
   the JAX package's 63-target word; its path also held against the host
   oracle), with the cluster each ran on; then the kernel's wide form on
   three sections past the register form's 131,072 cells that the budget
   gate sends to the device (256 targets of 512 bases with a 500 bp query,
   600 targets of 150-256 bases, and the gate's largest, 16,384 x 64
   bases), each beside its bound.  Outputs must be bit-identical;
   the times are CUDA-event kernel times and synchronized host times of the
   twin, beside each kernel's bound;
4. the main path: a 2 Mbp / 2-chromosome / 20-DNM trio (the port's
   demo.simulate_cross, 20x reads of 150 bp) through the flagship demo's
   reads mode (demo.reads_pipeline, which run_reads_pipeline runs:
   corticall_tpu_torch.pipeline.run_pipeline and the scoring), with every
   kernel launch counted, the target counts of the sections Call aligned,
   and the calls scored against the simulation truth (demo.evaluate's
   k-mer Venn);
5. every SW batch and Tesserae section that the pipeline sent to a kernel,
   replayed through the plain twin on the card (any difference fails), and
   the kernels timed at those shapes; and the Tesserae delete state's FMA
   term, ldel + leps * (j - 1) rounded once, of the kernel's device function
   against the twin's at every j of the widest section;
6. jump_vs_plain: the jump table of bench.py's graph (demo.build_bench_graph,
   a copy) at k=47 and 21M bases
   (about the flagship trio's 23.7M records), built by the kernels and by
   the plain twin, compared row for row and bucket for bucket, stage 0 and
   each compose pass held against the twin's state on their own; 262,144
   walks of at most 2,000 steps (bench.py's BENCH_WALKS, BENCH_STEPS_JUMP)
   through the walk kernel and the plain twin, every output compared, the
   kernel timed alone and through walk_jumps beside its bound, and the walks
   materialized on the host (walk_forward_jumps), in Partition's batches of
   forward and reverse walks and in one call; the contigs of 16,384 of them
   against the native C++ walker's; and a sweep of the native walker against
   the device route at 1k-64k seeds;
7. partition_device: the port's Partition on phase 4's graph, ROIs and
   links with the linked and the unlinked jump-table routes forced, each
   against the native route's partitions, with the jump kernels' launches
   counted; then every table and walk those runs built on the card replayed
   through the plain twins (buckets, rows and every walk output compared),
   the kernels' times at these shapes going to the kernels line;
8. sw_full_vs_plain: sw_full against its plain twin at B=1024, Q=512,
   S=1024, full and band 64, and at B=128, Q=512, S=8192, full and band 63,
   with the kernel each call took (sw_device.sw_full_form), and
   banded_sw_pallas (the banded kernel under the JAX package's name)
   against the banded twin;
9. walk_table_vs_plain: on phase 6's graph, the walk table of colour 0
   (phase 6's placement with the edge byte as payload) and a DeviceGraph;
   find_records of every record and as many mutated k-mers (ctk_ht_lookup
   over the probe table DeviceGraph built, the launch timed between its own
   events) and 262,144 walks of at most 256 steps (bench.py's BENCH_WALKS,
   BENCH_STEPS) through walk_forward_spec (ctk_spec_walk), launches
   counted; both kernels against their twins bit for bit, timed beside
   their bounds, with the walk's steps/s and bucket rows/s beside the
   lookup's random sectors/s, the rows its second probes read, and the walk
   kernel's registers, spills, resident lanes and waves; the probe table's
   build (ms, bytes, against the host's build), ctk_ht_lookup at 1, 2, 4
   and 8 lanes a query over key and tag entries, and ctk_spec_walk on each
   of its two paths (the table's rows as vectors, and a copy of the table
   off their alignment, read a word at a time), each launch into buffers
   filled with poison and held against the twin;
10. build_device: build_graph_from_reads with use_device=True on each trio
   sample of phase 4 and count_kmers_device on phase 6's 21 Mbp genome,
   each against the native route (identical graphs and counts), launches
   counted, with the seconds of each route and the device route's parts
   (encode, transfer, windows, sort, reduce, merge, the counter's own host
   work, and for a sample the invariant fence and the graph; a sample's
   parts within 5% of its seconds), and every ctk_count_windows and
   ctk_segment_reduce launch of the path between its own events; then
   ctk_count_windows against its twin on the kid's first chunk's bytes
   (into poisoned buffers: no row past its count), with its registers,
   spills and shared memory, ctk_segment_reduce on the chunk's sorted rows,
   and ctk_segment_reduce on the path's largest merge;
11. link_walk_vs_plain: LinkedWalker (the linked device walker) on phase
   4's graph, ROIs and threaded links: the sorted ROI k-mers walked both
   ways at Partition's 2,000-step cap against the native linked walker
   walked as Partition walks it (no contig of a walk without overflow may
   differ, once decoded by the host's seen rule), then 262,144 record
   k-mers x 2,000 steps through ctk_link_walk against its plain twin, on
   every lane within the twin's 60 s budget, timed beside the bound; the
   ROI walks' bound too, the needy share of both (the walk steps whose
   store a warp steps, from the twin's trace), and the launch shape,
   registers and occupancy of both launches;
12. mesh_vs_plain: the hash-sharded graph (corticall_tpu_torch.parallel
   .mesh) on four shards, all on the card: on phase 6's graph, the sharded
   walk of phase 9's 262,144 seeds x 256 steps (the exchange's bytes and ms
   a step) and one sharded step of 262,144 queries all owned by shard 3; on
   phase 4's trio, the sharded linked walks of the sorted ROI k-mers at
   2,000 steps; then the walks again with every kernel call held against
   its plain twin (the linked walks' calls of their first 128 steps and of
   every 16th after), the walk against the single-device walk of phase 9
   (every lane's stream, and the first 16,384 decoded by replay_walk on
   both sides), the skewed step against the host's, the linked walks'
   streams against LinkedWalker's, sharded FindROIs against FindROIs,
   and sharded_call on two Callers against phase 4's calls.vcf, byte for
   byte; ctk_route, ctk_shard_answer, ctk_shard_walk_step and ctk_link_step
   (one launch a step over the four shards) timed at a call of those runs
   beside their bounds, ctk_link_step also at the linked step with the most
   needy walks, and each kernel's path_ms: the walk run and the linked walks
   once more, every launch between its own CUDA events;
13. cross: corticall_tpu_torch.pipeline.run_cross_pipeline over phase 4's
   parents' reads and references with one progeny, kid2 (simulated from the
   same parents with seeds of its own), the three builds on the device
   count (CORTICALL_DEVICE_BUILD=1 for the phase only): the shared and
   per-child seconds, the launches of the SW, Tesserae and count kernels
   (each above 0), the parents' graphs written once in the shared workdir
   with phase 4's bytes, and kid2's calls against its own truth;
14. cli: the command line (corticall_tpu_torch.commands.cli.main, in this
   process) over kid2's stage files: Build on the device count and Clean
   against the stage's graph, Partition against core.partition on the same
   files, AlignContigs against align_contigs, Call against the stage's VCF
   and accounting bytes, FilterCalls' records against the stage's, each
   command's seconds and the kernels' launches in Build, AlignContigs and
   Call; and `python -m corticall_tpu_torch AlignContigs` in a subprocess,
   the same TSV;
15. mesh_across_processes: the hash-sharded graph across two worker
   processes on the card (corticall_tpu_torch/tools/dryrun_multihost.py's
   workers, a torch.distributed group over gloo: NCCL cannot put two ranks
   on one card), four shards each: phase 4's trio graph written as a .ctx,
   each worker loading its byte range and sending the records to their
   owners (every owned shard held against ShardedGraph.from_graph's), then
   its block of a sharded walk of 262,144 trio record k-mers x 256 steps,
   FindROIs and the linked ROI walks of phase 12, every output bit-identical
   to phase 12's single-process mesh; the backend, each part's seconds, the
   bytes exchanged and the sharding kernels' launches summed over the
   workers;
16. haplotype_flow: the flagship demo's haplotype mode
   (demo.run_haplotype_flow) on phase 4's cross, Call on the card, with the
   SW and Tesserae launches counted.

Then one JSON line with each kernel's route, source, launches, error,
times and bound (fifteen kernels), the nvidia-smi line, and the result line.
Any failure raises: the run exits non-zero and prints no result, as it does
without a CUDA device or outside the repository.  Neither jax nor the JAX
package (corticall_tpu) is ever imported.  About 12-15 minutes on one H100,
most of it host work (graph simulation and builds, the placements, the
plain twins).
"""

import glob
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time
from unittest import mock

sys.modules["jax"] = None          # the port must run without jax
sys.modules["corticall_tpu"] = None  # and without the JAX package
REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from corticall_tpu_torch.device import require_cuda  # noqa: E402
from corticall_tpu_torch.models import tesserae as tz  # noqa: E402
from corticall_tpu_torch.ops import _kernels  # noqa: E402
from corticall_tpu_torch.ops import build_device as bdv  # noqa: E402
from corticall_tpu_torch.ops import cuckoo as ck  # noqa: E402
from corticall_tpu_torch.ops import hashtable as ht  # noqa: E402
from corticall_tpu_torch.ops import jump as tj  # noqa: E402
from corticall_tpu_torch.ops import kmer as tk  # noqa: E402
from corticall_tpu_torch.ops import sharding as sh  # noqa: E402
from corticall_tpu_torch.ops import sw_device as tsw  # noqa: E402
from corticall_tpu_torch.ops import tesserae_torch as tt  # noqa: E402

# the production pre-score shape, a many-window narrow-band shape, and the
# widest of the 2 Mbp trio's pre-score batches
SW_SHAPES = [(256, 4096, 8192, 512), (1024, 512, 1024, 64), (8, 336, 464, 512)]
TESSERAE_TARGETS = [2, 3, 4, 6, 8, 11, 16, 16]
WIDE_TARGETS = 80                            # a section past the int32 word's 63
CALLER_PARAMS = (0.35, 0.90, 6e-4, 1e-3)     # Caller's del_, eps, rho, term
PF_MBP, PF_CHROMS, PF_DNMS, PF_K = 2.0, 2, 20, 47
PF_DIVERGENCE, PF_COVERAGE, PF_READLEN, PF_ERR = 0.003, 20.0, 150, 0.002
PF_MAX_WALK = 2000
JUMP_K, JUMP_BASES = 47, 21_000_000          # bench.build_bench_graph's args
JUMP_SEEDS, JUMP_STEPS = 262_144, 2000       # BENCH_WALKS, BENCH_STEPS_JUMP
NATIVE_SEEDS = 16_384                        # BENCH_NATIVE_SEEDS
SPEC_STEPS = 256                             # BENCH_STEPS: the single-step walk's cap
SWEEP_SEEDS = (1024, 4096, 16384, 65536)
# (B, Q, S, band): the full matrix and band 64 (the banded kernel) at the
# earlier smoke shape, the longest subject full and at an odd band (the masked
# full-matrix kernel)
SW_FULL_CASES = [(1024, 512, 1024, None), (1024, 512, 1024, 64),
                 (128, 512, 8192, None), (128, 512, 8192, 63)]

# The least time the card could take for a kernel's work: the larger of its
# bytes (each input read once, each output written once) over the HBM rate
# and its operations over the float32 rate outside the tensor cores, both the
# published peaks of one H100 SXM at 700 W.  Operations a cell, counted from
# the kernels' inner loops: SW ~12 (substitution select, diagonal add, two
# gap maxima of two adds each, the H maximum, the prefix-scan step); Tesserae
# ~40 a cell and column (three local candidates, two recombination compares,
# emissions, the delete scan, the argmax and the traceback code).  The jump
# kernels count their bytes, which bound them, each input byte once and each
# output byte once: stage 0 its words, edges, flags and rows out, and the
# distinct buckets that its landing lookups must read (`probed_buckets`); a
# compose pass its rows in and out; a walk its seeds and outputs, the
# distinct buckets of its seed lookups and the distinct rows its lanes read.
HBM_BYTES_PER_S = 3.35e12
# the banded SW kernel's operations are int32 (DPX); the data sheet gives no
# int32 rate, so they count against the float32 one, like the others
FP32_OPS_PER_S = 67e12
SW_OPS_PER_CELL = 12
TESSERAE_OPS_PER_CELL = 40
JUMP_ROW_BYTES = 16                          # a wide row, as the walk reads it
# one five-step warp-shuffle max-scan on this card, 74-75 ns
# (corticall_tpu_torch/tools/tesserae_probe.py barriers, NVIDIA H100 80GB
# HBM3 at 700 W): a banded SW window's Q rows are a chain of such scans
SHFL_SCAN_MS = 75e-6


def bound_ms(nbytes: float, ops: float = 0.0):
    """(least time in ms, "bytes" or "operations") for the work."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / FP32_OPS_PER_S * 1e3
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


def bound_fields(bound) -> dict:
    return {"bound_ms": round(bound[0], 6), "bound_by": bound[1]}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def sw_bound(q, s, cells):
    return bound_ms(nbytes(q, s) + 3 * 4 * q.shape[0], SW_OPS_PER_CELL * cells)


def sw_band_cells(batch, qlen, slen, band) -> int:
    """Cells of a banded SW batch inside the subject: row i scores columns
    [i - band/2, i + band/2) of [0, slen)."""
    i = np.arange(qlen)
    per_row = np.minimum(slen, i + band // 2) - np.maximum(0, i - band // 2)
    return batch * int(np.maximum(per_row, 0).sum())


def sw_bound_fields(q, s, band) -> dict:
    """The banded kernel's bound on its in-subject cells, with the band's
    cell count and the row-chain floor (Q rows, one shuffle scan each)."""
    (batch, qlen), slen = q.shape, s.shape[1]
    cells = sw_band_cells(batch, qlen, slen, band)
    return {**bound_fields(sw_bound(q, s, cells)), "cells": cells,
            "band_cells": batch * qlen * band,
            "row_chain_floor_ms": round(qlen * SHFL_SCAN_MS, 6)}


def sw_full_bound_fields(q, s, band) -> dict:
    """sw_full's bound on the cells its contract scores: every cell of the
    full matrix, or with a band b the in-band cells, columns [i - b//2,
    i + b//2) of row i inside the subject (the banded twin's at band
    2 * (b // 2)), whichever kernel computes them."""
    (batch, qlen), slen = q.shape, s.shape[1]
    cells = (batch * qlen * slen if band is None
             else sw_band_cells(batch, qlen, slen, 2 * (band // 2)))
    return {**bound_fields(sw_bound(q, s, cells)), "cells": cells}


def tesserae_bound(args):
    """Bound of one section: its inputs, its cells and columns, its path."""
    q, t, valid, (scal, lsm, lsi) = args
    cap = q.shape[0] + t.shape[1] + 5
    io = nbytes(q, t, valid, scal, lsm, lsi) + 4 * (2 + 3 * cap)
    return bound_ms(io, TESSERAE_OPS_PER_CELL * q.shape[0] * t.shape[0] * (t.shape[1] + 1))


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", file=sys.stderr, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def native_probe() -> dict:
    """Load the native core in a child process: a library built for another
    CPU may die with SIGILL, which must be reported, not crash this run."""
    code = ("import sys; sys.path.insert(0, %r); "
            "from corticall_tpu_torch import native; print(native.available())" % REPO)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=600)
    return {"returncode": proc.returncode,
            "available": proc.returncode == 0 and proc.stdout.strip() == "True",
            "stderr": proc.stderr.strip()[-400:]}


def sw_pairs(rng, batch, qlen, slen, band):
    """Subject rows and queries copied from them near the band's diagonal,
    with 3% substitutions, one indel a row, ragged ends (code 4) and one
    all-pad query."""
    s = rng.integers(0, 4, (batch, slen)).astype(np.int32)
    off = rng.integers(0, band // 4, batch)
    q = np.take_along_axis(s, off[:, None] + np.arange(qlen)[None, :], 1).copy()
    mut = rng.random(q.shape) < 0.03
    q[mut] = (q[mut] + rng.integers(1, 4, int(mut.sum()))) % 4
    for b in range(batch):
        p = int(rng.integers(qlen // 4, 3 * qlen // 4))
        n = int(rng.integers(1, 8))
        if b % 2:
            q[b, p:qlen - n] = q[b, p + n:].copy()
        else:
            q[b, p + n:] = q[b, p:qlen - n].copy()
            q[b, p:p + n] = rng.integers(0, 4, n)
        q[b, int(rng.integers(qlen // 2, qlen + 1)):] = 4
        s[b, int(rng.integers(qlen, slen + 1)):] = 4
    q[-1] = 4
    return q, s


def mutate(rng, seq, rate):
    m = rng.random(len(seq)) < rate
    out = seq.copy()
    out[m] = (out[m] + rng.integers(1, 4, int(m.sum()))) % 4
    return out


def tesserae_sections(rng):
    """Recombinant sections: mutated copies of one haplotype as targets, the
    query a mosaic of three of them with 0.5% substitutions."""
    lut = np.frombuffer(b"ACGT", np.uint8)
    out = []
    for s_count in TESSERAE_TARGETS:
        n = int(rng.integers(500, 4001))
        base = rng.integers(0, 4, n)
        copies = [mutate(rng, base, 0.02) for _ in range(s_count)]
        cut = sorted(int(x) for x in rng.integers(n // 5, 4 * n // 5, 2))
        pick = rng.integers(0, s_count, 3)
        query = np.concatenate([copies[pick[0]][:cut[0]],
                                copies[pick[1]][cut[0]:cut[1]],
                                copies[pick[2]][cut[1]:]])
        query = mutate(rng, query, 0.005)
        targets = {}
        for i, c in enumerate(copies):
            a, b = int(rng.integers(0, 40)), n - int(rng.integers(0, 40))
            targets[f"t{i}"] = lut[c[a:b]].tobytes().decode()
        out.append((lut[query].tobytes().decode(), targets))
    return out


def wide_section(rng):
    """WIDE_TARGETS unrelated targets of 200-300 bases; the query a mosaic
    of targets 63, 0 and the last, with 0.5% substitutions."""
    lut = np.frombuffer(b"ACGT", np.uint8)
    seqs = [rng.integers(0, 4, int(rng.integers(200, 301))) for _ in range(WIDE_TARGETS)]
    query = mutate(rng, np.concatenate([seqs[63][:90], seqs[0][90:170],
                                        seqs[-1][170:200]]), 0.005)
    return (lut[query].tobytes().decode(),
            {f"t{i}": lut[c].tobytes().decode() for i, c in enumerate(seqs)})


def wide_form_sections(rng):
    """Sections past the register form that TesseraeDevice's budget gate
    sends to the device: 256 targets of 512 bases with a 500 bp query, 600
    targets of 150-256 bases with a 256 bp query, and the gate's largest,
    16,384 targets of 64 bases with a 64 bp query; each query a mosaic of
    two or three targets with 0.5% substitutions."""
    lut = np.frombuffer(b"ACGT", np.uint8)
    out = []
    for s_count, lens, qlen in ((256, (512, 512), 500), (600, (150, 256), 256),
                                (16_384, (64, 64), 64)):
        seqs = [rng.integers(0, 4, int(rng.integers(lens[0], lens[1] + 1)))
                for _ in range(s_count)]
        pick = rng.choice(s_count, 3, replace=False)
        for i in pick:
            seqs[i] = rng.integers(0, 4, lens[1])
        cut = sorted(int(x) for x in rng.integers(qlen // 5, 4 * qlen // 5, 2))
        query = mutate(rng, np.concatenate([seqs[pick[0]][:cut[0]],
                                            seqs[pick[1]][cut[0]:cut[1]],
                                            seqs[pick[2]][cut[1]:qlen]]), 0.005)
        out.append((lut[query].tobytes().decode(),
                    {f"t{i}": lut[c].tobytes().decode() for i, c in enumerate(seqs)}))
    return out


def event_ms(fn, reps):
    """Mean CUDA-event time of fn() over reps launches, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def host_ms(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, out


def sw_diff(got, want, name="sw_banded") -> float:
    """Max |score| difference; raises unless all three outputs are
    bit-identical."""
    g_s, g_q, g_e = (x.cpu().numpy() for x in got)
    w_s, w_q, w_e = (x.cpu().numpy() for x in want)
    if not (np.array_equal(g_s.view(np.int32), w_s.view(np.int32))
            and np.array_equal(g_q, w_q) and np.array_equal(g_e, w_e)):
        bad = int(np.sum((g_s != w_s) | (g_q != w_q) | (g_e != w_e)))
        raise AssertionError(f"{name} disagrees with its plain twin in {bad} rows")
    return float(np.max(np.abs(g_s - w_s))) if len(g_s) else 0.0


def same(got: torch.Tensor, want: torch.Tensor, what: str) -> float:
    """The largest absolute difference of two integer tensors of one shape;
    raises unless it is 0."""
    if got.shape != want.shape:
        raise AssertionError(f"{what}: shape {tuple(got.shape)}, its plain twin's "
                             f"{tuple(want.shape)}")
    diff = (got.to(torch.int64) - want.to(torch.int64)).abs()
    err = float(diff.max()) if diff.numel() else 0.0
    if err:
        raise AssertionError(f"{what} disagrees with its plain twin "
                             f"({int((diff != 0).sum())} entries, max {err})")
    return err


def host_buckets(kmers: np.ndarray, nb: int, entry: np.ndarray,
                 payload: np.ndarray | None = None) -> torch.Tensor:
    """The bucket array of a placement (entry = 2 * bucket + position a
    key), scattered on the host; tags carry `payload` (default: the record
    ids)."""
    n, w = kmers.shape
    out = np.zeros((nb * 2, w + 1), dtype=np.uint32)
    out[entry, :-1] = kmers
    pay = np.arange(n, dtype=np.uint32) if payload is None else payload.astype(np.uint32)
    out[entry, -1] = pay | np.uint32(1 << 31)
    return torch.from_numpy(out.view(np.int32)).view(nb, 2, w + 1)


def probed_buckets(buckets, canon) -> torch.Tensor:
    """Bucket ids that two-choice lookups of canonical keys (int64 [B, W])
    must read: each key's primary bucket, and its second bucket where the
    primary does not hold the key."""
    nb, _, e = buckets.shape
    w = e - 1
    h = tk.hash_words(canon)
    first = h & (nb - 1)
    ent = tk.from_bits32(buckets[first])                   # [B, 2, W+1]
    held = ((ent[..., w] >= 1 << 31) & (ent[..., :w] == canon[:, None, :]).all(-1)).any(-1)
    second = tk.mix32(h[~held] ^ tj.GOLDEN) & (nb - 1)
    return torch.cat([first, second])


def bucket_bytes(buckets, ids) -> int:
    """Bytes of the distinct buckets among `ids` (at most the whole array)."""
    return int(torch.unique(ids).numel()) * buckets.shape[1] * buckets.shape[2] * 4


def landing_buckets(kd, ed, buckets, k) -> torch.Tensor:
    """Bucket ids stage 0's landing lookups must read: those of the rows with
    exactly one successor, in both orientations."""
    words, e = tk.from_bits32(kd), ed.to(torch.int64)
    ids = []
    for d in (0, 1):
        cur = words if d == 0 else tk.revcomp_words(words, k)
        mask = (e & 0xF) if d == 0 else (e >> 4)
        single = tk.popcount4(mask) == 1
        nxt = tk.shift_append(cur[single], tk.lowest_set_base(mask[single]), k)
        ids.append(probed_buckets(buckets, tk.canonicalize_words(nxt, k)[0]))
    return torch.cat(ids)


def check_table(kd, ed, fd, buckets, k, rows) -> dict:
    """Stage 0 and each compose pass re-run by their kernels, each from the
    previous kernel's rows, and held against the plain twins' state (narrow
    rows decoded by `widen_rows`); the table's rows against the plain build;
    raises on any difference.  Returns the times (ms) and bounds."""
    n2 = rows.shape[0]
    src = torch.empty((n2, 2), dtype=torch.int32, device=rows.device)
    stage0_ms = event_ms(lambda: tj.stage0_kernel(kd, ed, fd, buckets, k, src), 3)
    stage0_plain_ms, state = host_ms(lambda: tj.stage0_plain(kd, ed, fd, buckets, k))
    stage0_err = same(tj.widen_rows(src, 0), tj.pack_rows(*state), "jump_stage0")
    landing = bucket_bytes(buckets, landing_buckets(kd, ed, buckets, k))
    stage0_bound = bound_ms(nbytes(kd, ed, fd, src) + landing)
    passes, compose_err = [], 0.0
    for p in range(tj.COMPOSE_PASSES):
        dst = torch.empty((n2, 2 if p < tj.NARROW_PASSES else 4), dtype=torch.int32,
                          device=rows.device)
        ms = event_ms(lambda: tj.compose_kernel(src, dst, p), 3)
        plain_ms, state = host_ms(lambda: tj.jump_compose(*state))
        got = dst if dst.shape[1] == 4 else tj.widen_rows(dst, p + 1)
        compose_err = max(compose_err, same(got, tj.pack_rows(*state),
                                            f"jump_compose pass {p + 1}"))
        passes.append({"ms": round(ms, 4), "plain_ms": round(plain_ms, 2),
                       "row_bytes": [src.shape[1] * 4, dst.shape[1] * 4],
                       **bound_fields(bound_ms(nbytes(src, dst)))})
        src = dst
    del state
    compose_err = max(compose_err, same(src, rows, "jump table rows, the kernels' pass by pass"))
    rows_plain_ms, plain_rows = host_ms(lambda: tj.jump_rows_plain(kd, ed, fd, buckets, k))
    compose_err = max(compose_err, same(rows, plain_rows, "jump table rows"))
    return {"stage0_ms": round(stage0_ms, 4), "stage0_plain_ms": round(stage0_plain_ms, 2),
            "stage0_err": stage0_err, "compose_err": compose_err,
            "stage0_bound": bound_fields(stage0_bound), "landing_bucket_bytes": landing,
            "compose_ms": round(sum(p["ms"] for p in passes), 4),
            "compose_plain_ms": round(sum(p["plain_ms"] for p in passes), 2),
            "compose_bound": {"bound_ms": round(sum(p["bound_ms"] for p in passes), 6),
                              "bound_by": "bytes"},
            "compose_passes": passes, "rows_plain_ms": round(rows_plain_ms, 2)}


def check_walk(buckets, rows, seeds, k, num_steps, got) -> tuple[float, float]:
    """A walk kernel's outputs `got` against the plain seed lookup and walk
    on the same inputs; raises on any difference.  Returns the plain twin's
    time (ms, after a warm-up) and the largest difference."""
    def plain_walk():
        start = tj.seed_rows(buckets, tk.from_bits32(seeds), k)
        return tj.jump_walk(rows, start, num_steps)
    plain_walk()
    plain_ms, want = host_ms(plain_walk)
    errs = [same(got[0], tk.to_bits32(want[0]), "jump_walk packed bases"),
            same(got[1], want[1].to(torch.int32), "jump_walk steps")]
    for name, a, b in zip(("cycled", "touched", "ends_junction"), got[2:], want[2:]):
        errs.append(same(a, b, f"jump_walk {name}"))
    errs.append(same((got[1] >= num_steps) & ~got[2], (want[1] >= num_steps) & ~want[2],
                     "jump_walk saturated"))
    return plain_ms, max(errs)


def walk_bound(buckets, rows, seeds, k, num_steps, got):
    """Bound of one walk: its seeds and outputs, the distinct buckets its
    seed lookups must read and the distinct 16-byte rows its lanes read (from
    the plain walk on the same inputs)."""
    words = tk.from_bits32(seeds)
    visited = []
    tj.jump_walk(rows, tj.seed_rows(buckets, words, k), num_steps, visited)
    rows_read = int(torch.unique(torch.cat(visited)).numel()) if visited else 0
    seed_buckets = bucket_bytes(buckets, probed_buckets(buckets,
                                                        tk.canonicalize_words(words, k)[0]))
    return bound_ms(nbytes(seeds, *got) + seed_buckets + rows_read * JUMP_ROW_BYTES)


def walk_kernel_ms(buckets, rows, seeds, k, num_steps, reps=3) -> float:
    """CUDA-event time of the walk kernel alone, into outputs allocated
    once."""
    b = seeds.shape[0]
    out = torch.empty((b, 2 * tj.walk_pitch(num_steps)), dtype=torch.int32,
                      device=seeds.device)
    lanes = torch.empty(7 * b, dtype=torch.uint8, device=seeds.device)
    return event_ms(lambda: tj.walk_kernel(buckets, rows, seeds, k, num_steps, out, lanes),
                    reps)


def partition_walks_ms(walk, fwd, rev, chunk) -> list:
    """Host times (ms) of the walks that Partition's device routes make for
    these seeds (commands/core._partition_links and _partition_unlinked): a
    batch of `chunk` seeds at a time, the forward walks, then the reverse
    ones, each call's arrays alive until the next batch's call of the same
    direction replaces them.  `walk(seeds)` materializes one call."""
    times, f, r = [], None, None
    for lo in range(0, len(fwd), chunk):
        ms, f = host_ms(lambda: walk(fwd[lo:lo + chunk]))
        times.append(ms)
        ms, r = host_ms(lambda: walk(rev[lo:lo + chunk]))
        times.append(ms)
    del f, r
    return times


def tesserae_diff(got, want) -> float:
    """|max_r| difference; raises unless cells, n and max_r's bits agree."""
    (g_r, g_cells, g_n), (w_r, w_cells, w_n) = got, want
    g_n, w_n = int(g_n), int(w_n)
    g_r, w_r = np.float32(g_r.item()), np.float32(w_r.item())
    if g_n != w_n or not np.array_equal(g_cells[:g_n].cpu().numpy(),
                                        w_cells[:w_n].cpu().numpy()):
        raise AssertionError("tesserae kernel's traceback disagrees with its plain twin")
    if g_r.view(np.int32) != w_r.view(np.int32):
        raise AssertionError(f"tesserae max_r {g_r!r} != plain {w_r!r}")
    return float(abs(g_r - w_r))


def oracle_check(query, targets, dev) -> list:
    """The device class's path of a section against the host oracle's
    (models/tesserae.py, float64): the same segments, llk within 1e-4
    relative; raises otherwise.  Returns the path's target names."""
    host = tz.Tesserae(*CALLER_PARAMS)
    want = host.align(query, targets)
    device = tt.TesseraeDevice(*CALLER_PARAMS, device=dev)
    if device.align(query, targets) != want or \
            abs(device.llk - host.llk) > 1e-4 * abs(host.llk):
        raise AssertionError(f"{len(targets)} targets: the device path differs from the oracle's")
    return [seg[0] for seg in want[1:]]


def run_main_path(dev, mbp):
    """Simulate the trio and run the port's flagship demo in reads mode
    (demo.reads_pipeline, what run_reads_pipeline runs) with every kernel
    launch counted and every kernel input recorded; the demo scores the
    calls."""
    from corticall_tpu_torch.demo import reads_pipeline, simulate_cross

    t0 = time.perf_counter()
    mom, dad, res = simulate_cross(mbp, PF_CHROMS, PF_DNMS, PF_K, PF_DIVERGENCE)
    simulate_s = time.perf_counter() - t0
    log(f"simulated the cross in {simulate_s:.1f} s")

    sw_sent, ts_sent, section_targets = [], [], []
    sw_kernel, ts_kernel = tsw.sw_banded, tt.tesserae_fused
    align = tt.TesseraeDevice.align

    def align_recorded(self, query, targets):
        section_targets.append(len(targets))
        return align(self, query, targets)

    def sw_recorded(q, s, band=128):
        out = sw_kernel(q, s, band)
        sw_sent.append(((q, s, band), out))
        return out

    def ts_recorded(*args):
        out = ts_kernel(*args)
        ts_sent.append((args, out))
        return out

    tsw.sw_banded, tt.tesserae_fused = sw_recorded, ts_recorded
    tt.TesseraeDevice.align = align_recorded
    stages = {}
    tsw.LAUNCHES = tt.LAUNCHES = tt.WIDE_LAUNCHES = 0
    try:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as wd:
            demo, run = reads_pipeline(res, mom, dad, res["truth_vcf"], PF_K, PF_COVERAGE,
                                         PF_READLEN, PF_ERR, wd, stages, device=dev,
                                         log=lambda *a: log(" ".join(map(str, a))))
            torch.cuda.synchronize()
            with open(os.path.join(wd, "calls.vcf"), "rb") as f:
                calls_vcf = f.read()
            # the parents' graphs, for phase 13's cross to be held against
            clean_sha = {s: sha256(os.path.join(wd, f"{s}.clean.ctx")) for s in ("mom", "dad")}
        launches = {"sw_banded": tsw.LAUNCHES, "tesserae": tt.LAUNCHES,
                    "tesserae_wide": tt.WIDE_LAUNCHES}
    finally:
        tsw.sw_banded, tt.tesserae_fused = sw_kernel, ts_kernel
        tt.TesseraeDevice.align = align
    return {"out": run["result"], "res": res, "ev": run["ev"], "launches": launches,
            "reads": run["reads"], "sw_sent": sw_sent, "ts_sent": ts_sent,
            "section_targets": section_targets, "demo": demo,
            "simulate_s": simulate_s + stages["simulate_reads_s"], "refs": run["refs"],
            "calls_vcf": calls_vcf, "pipeline_s": run["pipeline_s"], "parents": (mom, dad),
            "clean_sha": clean_sha}


def check_main_path(mp) -> None:
    if not mp["launches"]["sw_banded"] or not mp["launches"]["tesserae"]:
        raise AssertionError(f"a kernel of the main path never launched: {mp['launches']}")
    if not mp["out"]["variants"]:
        raise AssertionError("the pipeline made no calls")
    if mp["ev"]["kmer_venn"]["tp"] < 1:
        raise AssertionError(f"no call matches the truth: {mp['ev']['kmer_venn']}")


def replay(mp) -> dict:
    """Every SW batch and Tesserae section the pipeline sent to a kernel,
    through the plain twin on the same device; raises on any difference.
    Times each kernel and twin at those shapes (CUDA events for the kernel,
    the host clock for the twin) and sums their bounds."""
    t0 = time.perf_counter()
    sw_err = ts_err = 0.0
    sw = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "bound_by": "operations",
          "row_chain_floor_ms": 0.0, "shapes": []}
    for (q, s, band), got in mp["sw_sent"]:
        p_ms, want = host_ms(lambda: tsw.banded_sw_scores(q, s, band))
        sw_err = max(sw_err, sw_diff(got, want))
        k_ms = event_ms(lambda: tsw.sw_banded(q, s, band), 3)
        bf = sw_bound_fields(q, s, band)
        sw["ms"] += k_ms
        sw["plain_ms"] += p_ms
        sw["bound_ms"] += bf["bound_ms"]
        sw["bound_by"] = bf["bound_by"]
        sw["row_chain_floor_ms"] += bf["row_chain_floor_ms"]
        sw["shapes"].append([int(q.shape[0]), int(q.shape[1]), int(s.shape[1]), band,
                             round(k_ms, 4)])
    ts = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "bound_by": "operations",
          "clusters": {}}
    for args, got in mp["ts_sent"]:
        p_ms, want = host_ms(lambda: tt.tesserae_full(*args))
        ts_err = max(ts_err, tesserae_diff(got, want))
        ts["ms"] += event_ms(lambda: tt.tesserae_fused(*args), 1)
        ts["plain_ms"] += p_ms
        b_ms, ts["bound_by"] = tesserae_bound(args)
        ts["bound_ms"] += b_ms
        wide, _, cluster, _ = tt.launch_config(args[1].shape[0], args[1].shape[1] + 1)
        form = f"wide {cluster}" if wide else cluster
        ts["clusters"][form] = ts["clusters"].get(form, 0) + 1
    # the delete state's FMA term (ldel + leps * (j - 1), rounded once) of the
    # kernel's device function against the twin's, every j of the widest section
    widest = max(int(a[1].shape[1]) + 1 for a, _ in mp["ts_sent"])
    params = mp["ts_sent"][0][0][3]
    on_card = tt.delete_term_on_card(params, widest).cpu()
    plain = tt.delete_term(params[0][0].cpu(), params[0][1].cpu(), widest)[0]
    if not torch.equal(on_card.view(torch.int32), plain.view(torch.int32)):
        raise AssertionError("the kernel's delete term differs from the twin's")
    ts["delete_term_j"] = widest
    return {"sw_err": sw_err, "ts_err": ts_err, "sw_batches": len(mp["sw_sent"]),
            "sw_windows": sum(int(a[0].shape[0]) for a, _ in mp["sw_sent"]),
            "tesserae_sections": len(mp["ts_sent"]), "sw": sw, "tesserae": ts,
            "seconds": time.perf_counter() - t0}



def jump_phase(dev):
    """Phase 6: the jump table and walk at bench.py's graph, kernels against
    the plain twins, and the device route against the native walker.
    Returns (the phase's fields, what phases 9 and 10 reuse: the graph, its
    genome, the placement and the walk seeds)."""
    from corticall_tpu_torch import kmer as km
    from corticall_tpu_torch import native as nat
    from corticall_tpu_torch.commands import core as tcore
    from corticall_tpu_torch.demo import build_bench_graph
    from corticall_tpu_torch.ops import walk_np as wnp

    t0 = time.perf_counter()
    g, genome = build_bench_graph(JUMP_K, JUMP_BASES)
    graph_s = time.perf_counter() - t0
    k, n = JUMP_K, g.num_records
    log(f"bench graph: {n} records in {graph_s:.1f} s")
    edges = np.ascontiguousarray(g.edges[:, 0])
    flags = np.random.default_rng(5).random(n) < 0.01
    torch.cuda.reset_peak_memory_stats(dev)

    # build: host placement + one scatter, then the device passes
    t0 = time.perf_counter()
    nb, bucket_of, pos_of = tj.place(g.kmers)
    entry = bucket_of * 2 + pos_of
    place_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    buckets, kd = tj.scatter_buckets(g.kmers, nb, entry, dev)
    torch.cuda.synchronize()
    scatter_s = time.perf_counter() - t0
    same(buckets.cpu(), host_buckets(g.kmers, nb, entry), "jump table buckets")
    del bucket_of, pos_of
    ed = torch.from_numpy(edges).to(dev)
    fd = torch.from_numpy(flags).to(dev)
    rows = tj.jump_rows(kd, ed, fd, buckets, k)
    times = check_table(kd, ed, fd, buckets, k, rows)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    again = tj.jump_rows(kd, ed, fd, buckets, k)      # timed warm
    torch.cuda.synchronize()
    passes_s = time.perf_counter() - t0
    same(again, rows, "jump table rows, built twice")
    del again
    log(f"jump table: placement {place_s:.2f} s, scatter {scatter_s * 1e3:.1f} ms, "
        f"device passes {passes_s * 1e3:.1f} ms")

    # walk: 262,144 seeds, 2,000-step cap
    rng = np.random.default_rng(11)
    starts = rng.integers(0, len(genome) - k, size=JUMP_SEEDS)
    seed_strs = [genome[i:i + k] for i in starts]
    seeds = km.pack_codes(km.strings_to_codes(seed_strs), k)
    st = tj.words_tensor(seeds, dev)
    got = tj.walk_jumps(buckets, rows, st, k, JUMP_STEPS)
    walk_ms = event_ms(lambda: tj.walk_jumps(buckets, rows, st, k, JUMP_STEPS), 3)
    walk_alone_ms = walk_kernel_ms(buckets, rows, st, k, JUMP_STEPS)
    walk_plain_ms, walk_err = check_walk(buckets, rows, st, k, JUMP_STEPS, got)
    walk_bound_ms = walk_bound(buckets, rows, st, k, JUMP_STEPS, got)
    steps_total = int(got[1].sum())
    # what Partition pays for these seeds: its batches of forward and reverse
    # walks, the run's first calls of walk_forward_jumps (each new pinned
    # buffer size is allocated, later ones reuse freed buffers)
    rev = km.pack_codes(km.strings_to_codes([km.revcomp(s) for s in seed_strs]), k)
    part_ms = partition_walks_ms(
        lambda sd: tj.walk_forward_jumps(buckets, rows, sd, k, JUMP_STEPS), seeds, rev,
        tcore.CHUNK)
    del rev
    # one call of all the seeds: the first allocates pinned buffers of its
    # size, the second reuses them from torch's caching host allocator
    mat_first_ms, walked = host_ms(lambda: tj.walk_forward_jumps(buckets, rows, seeds, k,
                                                                 JUMP_STEPS))
    del walked
    mat_ms, walked = host_ms(lambda: tj.walk_forward_jumps(buckets, rows, seeds, k,
                                                           JUMP_STEPS))
    peak = torch.cuda.max_memory_allocated(dev)
    log(f"jump walk: kernel {walk_alone_ms:.3f} ms ({walk_ms:.3f} with the wrapper), "
        f"plain {walk_plain_ms:.1f} ms")

    # the native walker: rate, and the same contigs for 16,384 seeds
    t0 = time.perf_counter()
    wt = nat.WalkTableNative(g.kmers, edges, k)
    native_build_s = time.perf_counter() - t0
    wt.walk(seeds[:64], JUMP_STEPS)
    t0 = time.perf_counter()
    nat_bases, nat_cycled, nat_steps = wt.walk(seeds[:NATIVE_SEEDS], JUMP_STEPS)
    native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    want_ext = [wnp.replay_walk(s, nat_bases[:, i], bool(nat_cycled[i]), JUMP_STEPS)
                for i, s in enumerate(seed_strs[:NATIVE_SEEDS])]
    native_replay_s = time.perf_counter() - t0
    packed, cycled, steps, sat = (x[:NATIVE_SEEDS] for x in walked[:4])
    t0 = time.perf_counter()
    got_ext = wnp.jump_extensions_batch(seed_strs[:NATIVE_SEEDS], packed, steps,
                                        cycled, sat, JUMP_STEPS)
    device_decode_s = time.perf_counter() - t0
    if got_ext != want_ext:
        bad = sum(a != b for a, b in zip(got_ext, want_ext))
        raise AssertionError(f"jump walk contigs differ from the native walker's in {bad} lanes")
    del walked, nat_bases

    # seed-count sweep: walks only (the host replays cost the same on both)
    build_s = place_s + scatter_s + passes_s
    sweep = []
    for count in SWEEP_SEEDS:
        t0 = time.perf_counter()
        wt.walk(seeds[:count], JUMP_STEPS)
        nat_s = time.perf_counter() - t0
        dev_s, _ = host_ms(lambda: tj.walk_forward_jumps(buckets, rows, seeds[:count],
                                                         k, JUMP_STEPS))
        dev_s /= 1e3
        sweep.append({"seeds": count, "native_s": round(nat_s, 4),
                      "device_s": round(dev_s, 4),
                      "native_with_build_s": round(nat_s + native_build_s, 3),
                      "device_with_build_s": round(dev_s + build_s, 3)})
    out = {
        "records": n, "graph_s": round(graph_s, 2), "place_s": round(place_s, 3),
        "scatter_s": round(scatter_s, 4),
        "device_passes_s": round(passes_s, 4), **times,
        "rows_bytes": rows.numel() * 4, "buckets_bytes": buckets.numel() * 4,
        "seeds": JUMP_SEEDS, "max_steps": JUMP_STEPS, "steps": steps_total,
        "walk_ms": round(walk_ms, 4), "walk_kernel_ms": round(walk_alone_ms, 4),
        "walk_bound": bound_fields(walk_bound_ms),
        "walk_steps_per_s": round(steps_total / walk_ms * 1e3),
        "walk_plain_ms": round(walk_plain_ms, 2), "walk_err": walk_err,
        "materialized_ms": round(mat_ms, 2), "materialized_first_ms": round(mat_first_ms, 2),
        "materialized_steps_per_s": round(steps_total / mat_ms * 1e3),
        "partition_walks": {"chunk": tcore.CHUNK, "calls": len(part_ms),
                            "calls_ms": [round(x, 3) for x in part_ms],
                            "first_batch_ms": round(sum(part_ms[:2]), 3),
                            "total_ms": round(sum(part_ms), 3)},
        "native_build_s": round(native_build_s, 3),
        "native_steps_per_s": round(int(nat_steps.sum()) / native_s),
        "native_seeds": NATIVE_SEEDS, "contigs_identical": True,
        "native_replay_s": round(native_replay_s, 3),
        "device_decode_s": round(device_decode_s, 3),
        "max_memory_allocated": torch.cuda.max_memory_allocated(dev),
        "walk_peak_memory": peak, "sweep": sweep}
    del rows, buckets, kd, ed, fd, st, got, wt
    torch.cuda.empty_cache()
    return out, {"g": g, "genome": genome, "nb": nb, "entry": entry, "seeds": seeds,
                 "seed_strs": seed_strs}


def partition_phase(dev, out) -> dict:
    """Phase 7: the port's Partition with each jump-table route forced,
    against the native routes, on the main path's graph, ROIs and links;
    then every table and walk those routes built on the card, replayed
    through the plain twins."""
    from corticall_tpu_torch.commands import core as tcore

    graph, rois, links = out["graph"], out["rois"], out["links"]
    runs, parts = {}, {}
    keys = ("walk_kernel", "link_replays", "link_junctions_resolved",
            "device_steps", "jump_table_build_s", "device_walk_s")
    tables, walks = [], []
    rows_wrapper, walk_wrapper = tj.jump_rows, tj.walk_jumps

    def rows_recorded(*args):
        rows = rows_wrapper(*args)
        tables.append((args, rows))
        return rows

    def walk_recorded(*args):
        got = walk_wrapper(*args)
        walks.append((args, got))
        return got

    def run(name, **kw):
        stats = {}
        for key in tj.LAUNCHES:
            tj.LAUNCHES[key] = 0
        t0 = time.perf_counter()
        parts[name] = tcore.partition(graph, rois, max_walk=PF_MAX_WALK,
                                      stats=stats, device=dev, **kw)
        torch.cuda.synchronize()
        runs[name] = {"seconds": round(time.perf_counter() - t0, 3),
                      "partitions": len(parts[name]), "launches": dict(tj.LAUNCHES),
                      **{key: stats[key] for key in keys if key in stats}}
        log(f"partition {name}: {runs[name]}")

    run("linked_native", links=links)
    run("unlinked_host")
    old = (tcore.NATIVE_LINK_THRESHOLD, tcore.SMALL_BATCH)
    tcore.NATIVE_LINK_THRESHOLD = tcore.SMALL_BATCH = -1
    tj.jump_rows, tj.walk_jumps = rows_recorded, walk_recorded
    try:
        run("linked_device", links=links)
        run("unlinked_device")
    finally:
        tcore.NATIVE_LINK_THRESHOLD, tcore.SMALL_BATCH = old
        tj.jump_rows, tj.walk_jumps = rows_wrapper, walk_wrapper
    if parts["linked_device"] != parts["linked_native"]:
        raise AssertionError("the linked device route's partitions differ from the native route's")
    if parts["unlinked_device"] != parts["unlinked_host"]:
        raise AssertionError("the unlinked device route's partitions differ from the host route's")
    for name in ("linked_device", "unlinked_device"):
        if runs[name].get("walk_kernel") != "jump_table":
            raise AssertionError(f"{name} did not take the jump-table route: {runs[name]}")
        if not all(runs[name]["launches"].values()):
            raise AssertionError(f"a jump kernel never launched in {name}: {runs[name]}")
    if runs["linked_native"].get("walk_kernel") != "native_links":
        raise AssertionError(f"the default linked route is not native: {runs['linked_native']}")
    launches = {key: runs["linked_device"]["launches"][key]
                + runs["unlinked_device"]["launches"][key] for key in tj.LAUNCHES}

    # replay: buckets against the host scatter, rows against the plain
    # build, every walk against the plain seed lookup and walk
    t0 = time.perf_counter()
    nb, bucket_of, pos_of = tj.place(graph.kmers)
    want_buckets = host_buckets(graph.kmers, nb, bucket_of * 2 + pos_of)
    times, errs = {}, {"stage0_err": 0.0, "compose_err": 0.0, "walk_err": 0.0}
    for (kd, ed, fd, buckets, k), rows in tables:
        same(buckets.cpu(), want_buckets, "jump table buckets")
        times = check_table(kd, ed, fd, buckets, k, rows)
        for key in ("stage0_err", "compose_err"):
            errs[key] = max(errs[key], times[key])
    walk_plain_ms = walk_ms = walk_alone_ms = 0.0
    walk_bound_ms = (0.0, "bytes")
    lanes = 0
    for args, got in walks:
        plain_ms, err = check_walk(*args, got)
        errs["walk_err"] = max(errs["walk_err"], err)
        if args[2].shape[0] >= lanes:
            lanes = args[2].shape[0]
            walk_plain_ms = plain_ms
            walk_ms = event_ms(lambda: tj.walk_jumps(*args), 3)
            walk_alone_ms = walk_kernel_ms(*args)
            walk_bound_ms = walk_bound(*args, got)
    replay = {"tables": len(tables), "walks": len(walks), "identical": True,
              "walk_lanes": lanes, "walk_ms": round(walk_ms, 4),
              "walk_kernel_ms": round(walk_alone_ms, 4),
              "walk_plain_ms": round(walk_plain_ms, 2),
              "walk_bound": bound_fields(walk_bound_ms), **times, **errs,
              "seconds": round(time.perf_counter() - t0, 2)}
    log(f"partition replay: {replay}")
    return {"seeds": rois.num_records, "records": graph.num_records,
            "identical": True, "runs": runs, "launches": launches, "replay": replay}


def sw_full_phase(dev, rng) -> dict:
    """Phase 8: sw_full (full and band-masked, in the form sw_full_form
    picks) and banded_sw_pallas against their plain twins."""
    tsw.FULL_LAUNCHES = 0
    cases, got = [], []
    for batch, qlen, slen, band in SW_FULL_CASES:
        q, s = sw_pairs(rng, batch, qlen, slen, 64)
        qt, st = torch.from_numpy(q).to(dev), torch.from_numpy(s).to(dev)
        cases.append((qt, st, band))
        got.append(tsw.sw_full(qt, st, band))
    torch.cuda.synchronize()
    launches = tsw.FULL_LAUNCHES
    if launches != len(SW_FULL_CASES):
        raise AssertionError(f"sw_full launched {launches} times for {len(SW_FULL_CASES)} calls")
    err, shapes = 0.0, []
    for (qt, st, band), out in zip(cases, got):
        (batch, qlen), slen = qt.shape, st.shape[1]
        want = tsw.sw_full_scores(qt, st, band)         # doubles as warm-up
        err = max(err, sw_diff(out, want, "sw_full"))
        k_ms = event_ms(lambda: tsw.sw_full(qt, st, band), 5)
        p_ms, _ = host_ms(lambda: tsw.sw_full_scores(qt, st, band))
        entry, kernel_band = tsw.sw_full_form(band)
        if entry == "ctk_sw_banded":
            bf = sw_bound_fields(qt, st, kernel_band)
            config = {"cells_a_lane": tsw.sw_kernel_config(qlen, slen, kernel_band)}
        else:
            bf = sw_full_bound_fields(qt, st, band)
            config = dict(zip(("cells_a_lane", "warps"), tsw.sw_full_config(slen)))
        shapes.append({"batch": batch, "q": qlen, "s": slen, "band": band,
                       "route": entry, **config,
                       "kernel_ms": round(k_ms, 4), "plain_ms": round(p_ms, 2),
                       "us_a_row": round(k_ms / qlen * 1e3, 4),
                       "kernel_gcups": round(bf["cells"] / k_ms / 1e6, 3), **bf})
        log(f"sw_full {batch}x{qlen}x{slen} band {band} ({entry}): kernel {k_ms:.3f} ms, "
            f"plain {p_ms:.1f} ms")
    qt, st, _ = cases[0]
    banded_err = sw_diff(tsw.banded_sw_pallas(qt, st, 64),
                         tsw.banded_sw_scores(qt, st, 64), "banded_sw_pallas")
    return {"launches": launches, "err": err, "shapes": shapes,
            "banded_sw_pallas_err": banded_err}


# the C entry points that phases 9 and 10 time at every launch of their paths
LOOKUP_ENTRY = {"ht_lookup": "ctk_ht_lookup"}
COUNT_ENTRY = {"count_windows": "ctk_count_windows", "segment_reduce": "ctk_segment_reduce"}
LOOKUP_ABLATION = (1, 2, 4, 8)               # lanes a query in phase 9's ablation


def probed_slots(slots, queries, found, max_probe: int):
    """(bool [M]: the slots that linear-probe lookups of `queries` (int32
    [B, W]) read, int64 [B]: the slots each query probes), given their
    answers `found` (record index or -1): a query probes from its hash to
    the slot holding its record or the first empty slot, at most max_probe
    slots."""
    m = slots.shape[0]
    h = tk.hash_words(tk.from_bits32(queries)) & (m - 1)
    read = torch.zeros(m, dtype=torch.bool, device=slots.device)
    probes = torch.zeros(h.shape[0], dtype=torch.int64, device=slots.device)
    live = torch.arange(h.shape[0], device=slots.device)
    for p in range(max_probe):
        if not live.numel():
            break
        slot = (h[live] + p) & (m - 1)
        read[slot] = True
        probes[live] += 1
        held = slots[slot]
        live = live[(held >= 0) & (held != found[live])]
    return read, probes


def lookup_sectors(queries, probes, m: int, group: int, entry_bytes: int) -> int:
    """The 32-byte sectors ctk_ht_lookup's key entries cost the queries at
    `group` lanes a query: a query's rounds are its probes, from its home
    slot's offset within an aligned round of `group` entries, in rounds of
    `group`; a round reads group * entry_bytes aligned bytes (a sector at
    least).  A model of the kernel's reads replayed on the host, not a
    count from the card's memory counters."""
    skip = (tk.hash_words(tk.from_bits32(queries)) & (m - 1)) % group
    rounds = torch.div(skip + probes + group - 1, group, rounding_mode="floor")
    return int(rounds.sum()) * max(1, group * entry_bytes // 32)


def word_path_table(buckets: torch.Tensor) -> torch.Tensor:
    """A copy of a walk table 4 bytes off its rows' vector alignment, which
    ctk_spec_walk reads a word at a time (the path of every table whose
    rows are not 2-entry vectors)."""
    flat = torch.empty(buckets.numel() + 1, dtype=buckets.dtype, device=buckets.device)
    table = flat[1:].view(buckets.shape)
    table.copy_(buckets)
    return table


def poison(bufs):
    """ctk_spec_walk's output buffers (bases, cycled, steps) filled with
    values no launch writes (0x5A, 7, -9), so that a byte it leaves
    unwritten shows; returns them."""
    bases, cycled, steps = bufs
    bases.fill_(0x5A)
    cycled.view(torch.uint8).fill_(7)
    steps.fill_(-9)
    return bufs


def spec_reads(buckets, seeds, k: int, bases) -> tuple[torch.Tensor, int, int]:
    """(bool [NB]: the bucket rows walk_forward_spec's active lanes read,
    the count of active lane iterations, and of those that read a second
    bucket), replayed from the bases the walk emitted: a lane reads its
    k-mer's h1 bucket, or h2 on the iteration after a miss there; each
    emitted base moves it on, and a -1 that is not such a miss ends it."""
    nb, _, e = buckets.shape
    w = e - 1
    table = tk.from_bits32(buckets)
    cur = tk.from_bits32(seeds).clone()
    probe = torch.zeros(cur.shape[0], dtype=torch.bool, device=cur.device)
    active = torch.ones_like(probe)
    read = torch.zeros(nb, dtype=torch.bool, device=cur.device)
    iterations = second = 0
    for row in bases:
        lanes = active.nonzero().squeeze(1)
        if not lanes.numel():
            break
        canon, _ = tk.canonicalize_words(cur[lanes], k)
        h = tk.hash_words(canon)
        lane_probe = probe[lanes]
        idx = torch.where(lane_probe, tk.mix32(h ^ tj.GOLDEN), h) & (nb - 1)
        read[idx] = True
        iterations += lanes.numel()
        second += int(lane_probe.sum())
        ent = table[idx]
        held = ((ent[..., w] >= 1 << 31) & (ent[..., :w] == canon[:, None, :]).all(-1)).any(-1)
        base = row[lanes].to(torch.int64)
        moved = base >= 0
        cur[lanes[moved]] = tk.shift_append(cur[lanes[moved]], base[moved], k)
        stall = ~held & ~lane_probe
        probe[lanes] = stall
        active[lanes] = moved | stall
    return read, iterations, second


def walk_table_phase(dev, ctx) -> dict:
    """Phase 9: DeviceGraph and the walk table on phase 6's graph.  The walk
    table of colour 0 is phase 6's placement with the edge byte as payload;
    the path (launches counted) looks up every record and as many mutated
    k-mers through find_records and walks bench.py's 262,144 seeds through
    walk_forward_spec; then both kernels against their plain twins, timed
    beside their bounds, the probe table's build, and ctk_ht_lookup's
    ablation of lanes a query and entry form."""
    from corticall_tpu_torch.device import DeviceGraph

    g, k, nb, entry = ctx["g"], JUMP_K, ctx["nb"], ctx["entry"]
    n = g.num_records
    edges = np.ascontiguousarray(g.edges[:, 0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    buckets, _ = tj.scatter_buckets(g.kmers, nb, entry, dev, payload=edges)
    torch.cuda.synchronize()
    scatter_s = time.perf_counter() - t0
    same(buckets.cpu(), host_buckets(g.kmers, nb, entry, edges), "walk table buckets")
    t0 = time.perf_counter()
    dg = DeviceGraph.from_arrays(k, g.kmers, g.coverages, g.edges, device=dev)
    torch.cuda.synchronize()
    graph_s = time.perf_counter() - t0
    # the probe table, built once a graph (from_arrays): built again on its
    # own, timed, and held against the host's build
    table_ms, table = host_ms(lambda: ht.probe_table(dg.slots, dg.kmers))
    same(table, dg.probe, "the probe table, built twice")
    del table
    same(dg.probe.cpu(), ht.probe_table(dg.slots.cpu(), dg.kmers.cpu()), "the probe table")
    miss = g.kmers.copy()
    miss[:, -1] ^= np.uint32(1)
    queries = tk.words_tensor(np.concatenate([g.kmers, miss]), dev)
    seeds = tk.words_tensor(ctx["seeds"], dev)
    del miss

    # the path: the table's lookups (the launch between its own events) and
    # the walks, launches counted
    ht.LAUNCHES["ht_lookup"] = ck.LAUNCHES["spec_walk"] = 0
    timers, late, restore = entry_timers(entries=LOOKUP_ENTRY)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        rec = dg.find_records(queries)
    finally:
        restore()
    walked = ck.walk_forward_spec(buckets, seeds, k, SPEC_STEPS)
    torch.cuda.synchronize()
    path_s = time.perf_counter() - t0
    lookup_path = {"path_ms": round(sum(t() for t in timers["ht_lookup"]), 4),
                   "late": late["ht_lookup"]}
    launches = {"ht_lookup": ht.LAUNCHES["ht_lookup"], "spec_walk": ck.LAUNCHES["spec_walk"]}
    if not all(launches.values()):
        raise AssertionError(f"a walk-table kernel never launched: {launches}")
    if not torch.equal(rec[:n], torch.arange(n, dtype=torch.int32, device=dev)):
        raise AssertionError("find_records missed a record of the graph")

    # ht_lookup against its twin; its bound: the queries and results, the
    # distinct slots the probes read and the distinct key rows they compared
    out = torch.empty_like(rec)
    lookup_ms = event_ms(lambda: ht.lookup_kernel(dg.probe, dg.kmers, queries, dg.max_probe,
                                                  out), 3)
    lookup_err = same(out, rec, "ht_lookup, launched again")
    lookup_plain_ms, want = host_ms(lambda: ht.lookup_plain(dg.slots, dg.kmers, queries,
                                                            dg.max_probe))
    lookup_err = max(lookup_err, same(rec, want, "ht_lookup"))
    # the ablation: lanes a query and the entry form, each against the twin
    ablation = []
    tables = {"key": dg.probe, "tag": ht.probe_table(dg.slots, dg.kmers, "tag")}
    for form, table in tables.items():
        for group in LOOKUP_ABLATION:
            ms = event_ms(lambda: ht.lookup_kernel(table, dg.kmers, queries, dg.max_probe, out,
                                                   group), 3)
            ablation.append({"form": form, "group": group, "ms": round(ms, 4),
                             "table_bytes": nbytes(table),
                             "err": same(out, want, f"ht_lookup, {form} entries, {group} lanes")})
    del want, tables
    slots_read, probes = probed_slots(dg.slots, queries, rec, dg.max_probe)
    sectors = lookup_sectors(queries, probes, dg.slots.shape[0], ht.LOOKUP_GROUP,
                             4 * ht.entry_words(queries.shape[1], ht.PROBE_FORM))
    del probes
    rows_read = int((slots_read & (dg.slots >= 0)).sum())
    slots_read = int(slots_read.sum())
    lookup_bound = bound_ms(nbytes(queries, rec) + slots_read * 4
                            + rows_read * dg.kmers.shape[1] * 4)

    # ctk_spec_walk against its twin; its bound: seeds and outputs and the
    # distinct bucket rows the active lanes read; then each of its paths,
    # into poisoned buffers, with what each launch keeps resident
    bufs = tuple(torch.empty_like(x) for x in walked)
    spec_ms = event_ms(lambda: ck.spec_walk_kernel(buckets, seeds, k, SPEC_STEPS, *bufs), 3)
    spec_plain_ms, want = host_ms(lambda: ck.spec_walk_plain(buckets, seeds, k, SPEC_STEPS))
    spec_err = 0.0
    for name, a, b, c in zip(("bases", "cycled", "steps"), walked, bufs, want):
        spec_err = max(spec_err, same(a, c, f"spec_walk {name}"),
                       same(b, c, f"spec_walk {name}, launched again"))
    spec_paths = []
    for table in (buckets, word_path_table(buckets)):
        info = ck.kernel_info(table, seeds.shape[0])
        poison(bufs)
        ms = event_ms(lambda: ck.spec_walk_kernel(table, seeds, k, SPEC_STEPS, *bufs), 3)
        err = max(same(b, c, f"spec_walk {name}, {info['path']} path")
                  for name, b, c in zip(("bases", "cycled", "steps"), bufs, want))
        spec_paths.append({"ms": round(ms, 4), "err": err, **info})
    del want
    rows_visited, active_iterations, second_probes = spec_reads(buckets, seeds, k, walked[0])
    rows_visited = int(rows_visited.sum())
    row_bytes = buckets.shape[1] * buckets.shape[2] * 4
    spec_bound = bound_ms(nbytes(seeds, *walked) + rows_visited * row_bytes)
    steps_total = int(walked[2].sum())
    log(f"walk table: lookup {lookup_ms:.3f} ms, spec walk {spec_ms:.3f} ms")
    result = {
        "records": n, "queries": queries.shape[0], "found": int((rec >= 0).sum()),
        "max_probe": dg.max_probe, "slots": dg.slots.numel(),
        "walk_table_scatter_s": round(scatter_s, 4), "device_graph_s": round(graph_s, 2),
        "path_s": round(path_s, 4), "launches": launches,
        "probe_table_ms": round(table_ms, 3), "probe_table_bytes": nbytes(dg.probe),
        "probe_form": ht.PROBE_FORM, "lookup_group": ht.LOOKUP_GROUP,
        "lookup_ms": round(lookup_ms, 4), "lookup_path": lookup_path,
        "lookup_ablation": ablation, "lookup_plain_ms": round(lookup_plain_ms, 2),
        "lookup_bound": bound_fields(lookup_bound), "lookup_slots_read": slots_read,
        "lookup_key_rows_read": rows_read, "lookup_err": lookup_err,
        "lookups_per_s": round(queries.shape[0] / lookup_ms * 1e3),
        "lookup_sectors": sectors, "lookup_sectors_per_s": round(sectors / lookup_ms * 1e3),
        "seeds": seeds.shape[0], "max_steps": SPEC_STEPS, "iterations": ck.spec_iters(SPEC_STEPS),
        "steps": steps_total, "active_iterations": active_iterations,
        "cycled": int(walked[1].sum()), "bucket_rows_read": rows_visited,
        "spec_ms": round(spec_ms, 4), "spec_plain_ms": round(spec_plain_ms, 2),
        "spec_bound": bound_fields(spec_bound), "spec_err": spec_err,
        "spec_steps_per_s": round(steps_total / spec_ms * 1e3),
        "spec_rows_per_s": round(active_iterations / spec_ms * 1e3),
        "second_probe_rows": second_probes, "spec_kernel": spec_paths[0],
        "spec_paths": spec_paths}
    del dg, buckets, queries, seeds, rec, walked, bufs, out
    torch.cuda.empty_cache()
    return result


# the device count's parts, timed by wrapping the module functions it calls
# (ops/build_device.py; in corticall_tpu_torch/build.py the fence and, in
# its graph module, the graph)
COUNT_PARTS = {"encode": "encode", "upload": "transfer", "count_windows": "windows",
               "sort_order": "sort", "segment_reduce": "reduce"}
FENCE_PARTS = ("expected_kmer_instances", "_verify_count_invariants")
GRAPH_PARTS = ("rev4", "from_arrays")


def timed_parts(fn, graph: bool = True):
    """fn() with the device route's parts timed on the host clock, each ended
    by a synchronize: encode (joining the reads, their bytes), transfer,
    windows (the count kernel's launch and its count read), the sorts and
    the reductions of the chunks, the accumulator merges (concatenation,
    sort and reduction), finish (the table's copy back to numpy and its
    filter), counter (the rest of count_kmers_device: the counter's loop
    over the reads), and with
    `graph` (a build_graph_from_reads call) fence (expected_kmer_instances
    and _verify_count_invariants) and graph (the edge bytes and
    from_arrays).  A part's seconds exclude the parts it calls.  Returns
    (fn's result, {part: seconds}); raises if a part never ran, as when
    DeviceCounter no longer calls a wrapped name."""
    from corticall_tpu_torch import build as tbd

    sites = [(bdv, name, part) for name, part in COUNT_PARTS.items()]
    sites.append((bdv, "count_kmers_device", "counter"))
    if graph:
        sites += [(tbd, name, "fence") for name in FENCE_PARTS]
        sites += [(tbd.gr, name, "graph") for name in GRAPH_PARTS]
    parts = {part: 0.0 for *_, part in sites}
    parts["merge"] = parts["finish"] = 0.0
    calls = dict.fromkeys(parts, 0)
    originals = [(mod, name, getattr(mod, name)) for mod, name, _ in sites]
    merge, finish = bdv.DeviceCounter._merge, bdv.DeviceCounter.finish
    depth, inner = [0], []          # merges entered; the enclosing parts' nested seconds

    def clocked(part, f, *a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        inner.append(0.0)
        try:
            out = f(*a, **kw)
            torch.cuda.synchronize()
        finally:
            nested = inner.pop()
        dt = time.perf_counter() - t0
        parts[part] += dt - nested
        if inner:
            inner[-1] += dt
        calls[part] += 1
        return out

    def wrap(f, part):
        def run(*a, **kw):
            return f(*a, **kw) if depth[0] else clocked(part, f, *a, **kw)
        return run

    def merge_timed(self, *a):
        depth[0] += 1
        try:
            return clocked("merge", merge, self, *a)
        finally:
            depth[0] -= 1

    def finish_timed(self):
        return clocked("finish", finish, self)

    for (mod, name, f), (*_, part) in zip(originals, sites):
        setattr(mod, name, wrap(f, part))
    bdv.DeviceCounter._merge, bdv.DeviceCounter.finish = merge_timed, finish_timed
    try:
        out = fn()
    finally:
        for mod, name, f in originals:
            setattr(mod, name, f)
        bdv.DeviceCounter._merge, bdv.DeviceCounter.finish = merge, finish
    idle = [part for part, c in calls.items() if not c]
    if idle:
        raise AssertionError(f"timed_parts: the device route never ran {idle}")
    return out, {key: round(v, 4) for key, v in parts.items()}


def parts_share(parts: dict, seconds: float) -> float:
    """The parts' sum over the route's seconds; phase 10 holds it within 5%
    of 1 for a sample, so that the parts account for the route."""
    return round(sum(parts.values()) / seconds, 4)


def first_chunk(reads, k: int) -> str:
    """The first chunk DeviceCounter joins from a read set."""
    out, pending = [], 0
    for r in reads:
        if len(r) < k:
            continue
        if pending + len(r) + k > bdv.CHUNK_BASES:
            break
        out.append(r)
        pending += len(r) + k
    return ("N" * k).join(out)


def same_graph(got, want, what: str) -> None:
    for name in ("kmers", "coverages", "edges"):
        if not np.array_equal(getattr(got, name), getattr(want, name)):
            raise AssertionError(f"{what}: the device build's {name} differ from the native build's")


def build_phase(dev, reads, genome) -> dict:
    """Phase 10: the device graph build.  The path (launches counted, each
    ctk_count_windows and ctk_segment_reduce launch timed between its own
    events behind a short spin: their path_ms): build_graph_from_reads with
    use_device=True for each trio sample of phase 4, and count_kmers_device
    on phase 6's genome, each against the native route, the device route's
    parts timed (timed_parts; a sample's within 5% of its seconds); then
    ctk_count_windows against its twin on the kid's first chunk's bytes,
    into poisoned buffers, ctk_segment_reduce on the chunk's sorted rows,
    and ctk_segment_reduce on the path's largest merge (a trio sample's:
    the genome is one chunk)."""
    from corticall_tpu_torch import build as tbd
    from corticall_tpu_torch import native as nat

    k = PF_K
    bdv.count_kmers_device([genome[:5000]], k, device=dev)     # first use of torch.sort
    for key in bdv.LAUNCHES:
        bdv.LAUNCHES[key] = 0
    # every count kernel launch of the path between its own events, and a
    # copy of the inputs of the path's largest merge
    timers, late, restore = entry_timers(entries=COUNT_ENTRY)
    merge = {"rows": 0, "args": None}
    real_merge, real_reduce = bdv.DeviceCounter._merge, bdv.reduce_kernel
    merging = [False]

    def merge_flagged(self, *a):
        merging[0] = True
        try:
            return real_merge(self, *a)
        finally:
            merging[0] = False

    def reduce_kept(keys, cov, masks, *out):
        if merging[0] and keys.shape[0] > merge["rows"]:
            merge.update(rows=keys.shape[0], args=(keys.clone(), cov.clone(), masks.clone()))
        return real_reduce(keys, cov, masks, *out)

    bdv.DeviceCounter._merge, bdv.reduce_kernel = merge_flagged, reduce_kept
    try:
        samples = {}
        for s, rs in reads.items():
            t0 = time.perf_counter()
            native = tbd.build_graph_from_reads(rs, k, s, use_device=False)
            native_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            got, parts = timed_parts(lambda: tbd.build_graph_from_reads(
                rs, k, s, use_device=True, device=dev))
            device_s = time.perf_counter() - t0
            same_graph(got, native, f"sample {s}")
            share = parts_share(parts, device_s)
            if abs(share - 1) > 0.05:
                raise AssertionError(f"sample {s}: the device route's parts sum to {share} of "
                                     f"its {device_s:.3f} s {parts}")
            samples[s] = {"reads": len(rs), "bases": sum(map(len, rs)),
                          "records": got.num_records, "native_s": round(native_s, 3),
                          "device_s": round(device_s, 3), "device_parts_s": parts,
                          "parts_share": share}
            log(f"build {s}: native {native_s:.2f} s, device {device_s:.2f} s {parts}")
        t0 = time.perf_counter()
        want = nat.count_kmers_native([genome], k)
        native_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        got, parts = timed_parts(lambda: bdv.count_kmers_device([genome], k, device=dev),
                                 graph=False)
        device_s = time.perf_counter() - t0
    finally:
        bdv.DeviceCounter._merge, bdv.reduce_kernel = real_merge, real_reduce
        restore()
    for name, a, b in zip(("kmers", "coverage", "in", "out"), got, want):
        if not np.array_equal(a, b):
            raise AssertionError(f"the genome's device count: {name} differ from the native count")
    launches = dict(bdv.LAUNCHES)
    if not all(launches.values()):
        raise AssertionError(f"a count kernel never launched: {launches}")
    torch.cuda.synchronize()
    paths = {name: {"launches": len(timers[name]),
                    "path_ms": round(sum(t() for t in timers[name]), 4),
                    "launch_ms": [round(t(), 4) for t in timers[name]], "late": late[name]}
             for name in COUNT_ENTRY}
    if paths["count_windows"]["launches"] != launches["count_windows"]:
        raise AssertionError(f"count_windows: {launches['count_windows']} launches counted, "
                             f"{paths['count_windows']['launches']} timed")
    genome_row = {"bases": len(genome), "records": len(got[0]), "native_s": round(native_s, 3),
                  "device_s": round(device_s, 3), "device_parts_s": parts,
                  "parts_share": parts_share(parts, device_s)}
    log(f"count of the genome: native {native_s:.2f} s, device {device_s:.2f} s {parts}")
    del got, want

    # ctk_count_windows against its twin on the kid's first chunk, into
    # poisoned buffers with room for every window
    data = bdv.encode([first_chunk(reads["kid"], k)], k)
    n, w = len(data), tk.words(k)
    bases = bdv.upload(data, dev)
    keys = torch.full((n - k + 1, w), 0x5A5A5A5A, dtype=torch.int32, device=dev)
    masks = torch.full((n - k + 1,), 0x5A, dtype=torch.uint8, device=dev)
    count = torch.full((1,), -7, dtype=torch.int32, device=dev)
    windows_ms = event_ms(lambda: bdv.count_kernel(bases, 0, n, k, keys, masks, count), 3)
    windows_plain_ms, want = host_ms(lambda: bdv.count_windows_plain(bases, 0, n, k))
    m = int(count.item())
    if m != want[0].shape[0]:
        raise AssertionError(f"count_windows: {m} rows, the twin {want[0].shape[0]}")
    windows_err = max(same(keys[:m], want[0], "count_windows keys"),
                      same(masks[:m], want[1], "count_windows masks"))
    if not ((keys[m:] == 0x5A5A5A5A).all() and (masks[m:] == 0x5A).all()):
        raise AssertionError("count_windows wrote a row past its count")
    del want
    sk, sm = keys[:m], masks[:m]
    windows_bound = bound_ms(nbytes(bases, sk, sm, count))
    info = bdv.count_kernel_info(k)
    sort_ms = event_ms(lambda: bdv.sort_order(sk), 3)
    order = bdv.sort_order(sk)
    sk, sm = sk[order], sm[order]
    cov = torch.ones(m, dtype=torch.int32, device=dev)
    del keys, masks, order
    out = (torch.empty_like(sk), torch.empty_like(cov), torch.empty_like(sm))
    reduce_ms = event_ms(lambda: bdv.reduce_kernel(sk, cov, sm, *out, count), 3)
    reduce_plain_ms, want = host_ms(lambda: bdv.reduce_plain(sk, cov, sm))
    nu = int(count.item())
    reduce_err = max(same(a[:nu], b, f"segment_reduce {name}")
                     for name, a, b in zip(("keys", "coverage", "masks"), out, want))
    reduce_bound = bound_ms(nbytes(sk, cov, sm, count) + sum(nbytes(x[:nu]) for x in out))
    chunk = {"bases": n, "windows": m, "unique": nu,
             "windows_ms": round(windows_ms, 4), "windows_plain_ms": round(windows_plain_ms, 2),
             "windows_bound": bound_fields(windows_bound), "windows_err": windows_err,
             "windows_kernel": info,
             "sort_ms": round(sort_ms, 4), "reduce_err": reduce_err,
             "reduce_ms": round(reduce_ms, 4), "reduce_plain_ms": round(reduce_plain_ms, 2),
             "reduce_bound": bound_fields(reduce_bound)}
    log(f"count kernels on a chunk: {chunk}")
    del bases, sk, sm, cov, out, want

    # ctk_segment_reduce on the path's largest merge (sorted as the merge sorts)
    mk, mc, mm = merge["args"]
    mout = (torch.empty_like(mk), torch.empty_like(mc), torch.empty_like(mm))
    merge_ms = event_ms(lambda: bdv.reduce_kernel(mk, mc, mm, *mout, count), 3)
    merge_plain_ms, want = host_ms(lambda: bdv.reduce_plain(mk, mc, mm))
    nu = int(count.item())
    merge_row = {"rows": int(mk.shape[0]), "unique": nu, "ms": round(merge_ms, 4),
                 "plain_ms": round(merge_plain_ms, 2),
                 "err": max(same(a[:nu], b, f"segment_reduce on a merge, {name}")
                            for name, a, b in zip(("keys", "coverage", "masks"), mout, want)),
                 "bound": bound_fields(bound_ms(nbytes(mk, mc, mm, count)
                                                + sum(nbytes(x[:nu]) for x in mout)))}
    log(f"segment_reduce on the largest merge: {merge_row}")
    del mk, mc, mm, mout, want, merge
    torch.cuda.empty_cache()
    return {"k": k, "samples": samples, "genome": genome_row, "launches": launches,
            "identical": True, "chunk": chunk, "count_path": paths["count_windows"],
            "reduce_path": paths["segment_reduce"], "merge": merge_row}


LINK_SEEDS = 262_144                         # BENCH_WALKS
LINK_DECODE_SEEDS = 16_384                   # ROI seeds decoded in Python, at most
LINK_TWIN_BUDGET_S = 60.0                    # the twin's lanes: every one, within this
LINK_TWIN_CHUNK = 131_072                    # lanes a twin call (its steps are launch-bound)
LINK_POOL_ROW_BYTES = 13                     # choices 8, length 4, orientation 1
# 32-bit integer operations of linked walk steps, counted from the functions
# the walk computes (ops/kmer.py, ops/cuckoo.py, ops/walk_links.py), one an
# elementwise operation on a 32-bit value; link_step_ops charges each part
# only at the steps whose data need it
LINK_RECORD_OPS = 5          # a record of the k-mer's first MAX_ADD: index, j < cnt,
                             # orientation, 2 ANDs
LINK_FREE_OPS = 2            # a store slot at a step that adds records: free, its rank
LINK_GATED_OPS = 3           # a gated record: its rank, the overflow test and OR
LINK_FILL_OPS = 7            # an element filled: 2 choice words, length, position, age,
                             # sequence, valid
LINK_AGE_OPS = 5             # a valid element after a step past the seed: new_paths (2), the age's
                             # add and select, store_active (the seed step: store_active only)
LINK_JUNCTION_OPS = 10       # a junction past the seed: rep_char, rep_words, choice, have_choice,
                             # choice_ok (3), take_choice, bump, the junction count
LINK_JUNCTION_ELEMENT_OPS = 32   # a valid element there: exhausted, live, the masked age and max,
                                 # is_oldest (2), _char_at (6), first_oldest (2), agree (3),
                                 # same_list (4), the masked sequence and max (2), latest (2),
                                 # keep (5), position and valid (2)


def link_kmer_ops(w: int, bs: int) -> int:
    """A walk step's k-mer work at W words and bucket size BS: the canonical
    form (revcomp_words 22 a word: complement, reverse_pairs32's 18, the
    realignment's 3; the top word's mask; lex_less 5 a word; the select a
    word), hash_words (10 a word, the final mix32's 8) and the second bucket
    (mix32 of h ^ GOLDEN, both masks: 11), lookup_payload (each slot of both
    buckets: W key compares, W - 1 ANDs, the tag, the AND, the max), the
    record, its edge byte, successors, CSR count and counters (30), and
    shift_append with the emission (4 a word, 9)."""
    return (28 * w + 1) + (10 * w + 19) + 2 * bs * (2 * w + 2) + 30 + (4 * w + 9)


def link_step_ops(kmer_ops: int, first, cnt, gated, before, after, succ):
    """Operations of walk steps, one entry a step (int64 tensors; `first` a
    bool one): the k-mer's work, its `cnt` records (at most MAX_ADD) gated,
    store_add where `gated` of them face the walk's way, the junction choice
    at a step past the seed whose k-mer has `succ` > 1 successors, over the
    valid elements after the add, and the ageing over those after the step.
    `before` / `after` are the store's valid elements before and after the
    step; -1 (not known) charges no element work."""
    from corticall_tpu_torch.ops import walk_links as wl

    known = after >= 0
    before = before.clamp(min=0)
    filled = torch.where(known, torch.minimum(gated, wl.CAP - before), 0)
    held = torch.where(known, before + filled, 0)
    add = torch.where(gated > 0, LINK_FREE_OPS * wl.CAP + LINK_GATED_OPS * gated
                      + LINK_FILL_OPS * filled, 0)
    choose = torch.where(~first & (succ > 1), LINK_JUNCTION_OPS
                         + LINK_JUNCTION_ELEMENT_OPS * held, 0)
    age = torch.where(first, 1, LINK_AGE_OPS) * after.clamp(min=0)
    return kmer_ops + LINK_RECORD_OPS * cnt + add + choose + age


def link_walk_reads(tables, seeds, k: int, emitted, sizes=None) -> dict:
    """What ctk_link_walk read, replayed from the bases it emitted (int8
    [T, B]): a walk looks up its k-mer each step until the step that does
    not advance (both candidate buckets of the cuckoo table), and of a
    record it finds, the edge byte, the two CSR offsets and up to MAX_ADD
    rows of the link pool.  Returns the distinct bucket rows, records,
    offsets and pool rows, the walk steps (lookups), and int8 [T, B]
    successor counts of the k-mer each step left (0 where none was looked
    up).  Given `sizes`, the twin's store sizes (int8 [T, B], -1 where not
    known), it also counts the steps' operations (link_step_ops)."""
    from corticall_tpu_torch.ops import walk_links as wl

    buckets, edges, link_off = tables[:3]
    nb = buckets.shape[0]
    n = edges.shape[0]
    dev = seeds.device
    cur = tk.from_bits32(seeds).clone()
    off = link_off.to(torch.int64)
    fw = torch.zeros(tables[5].shape[0] + 1, dtype=torch.int64, device=dev)
    fw[1:] = tables[5].to(torch.int64).cumsum(0)
    kmer_ops = link_kmer_ops(cur.shape[1], buckets.shape[1])
    lanes = torch.arange(cur.shape[0], device=dev)
    rows = torch.zeros(nb, dtype=torch.bool, device=dev)
    recs = torch.zeros(n, dtype=torch.bool, device=dev)
    succ = torch.zeros(emitted.shape, dtype=torch.int8, device=dev)
    walk_steps = ops = 0
    for t in range(emitted.shape[0]):
        if not lanes.numel():
            break
        canon, flipped = tk.canonicalize_words(cur[lanes], k)
        h = tk.hash_words(canon)
        rows[h & (nb - 1)] = True
        rows[tk.mix32(h ^ tj.GOLDEN) & (nb - 1)] = True
        rec = tk.from_bits32(ck.lookup_payload(buckets, tk.to_bits32(canon))) - 1
        found = rec >= 0
        recs[rec[found]] = True
        r = rec.clamp(min=0)
        e = edges[r].to(torch.int64)
        mask = torch.where(flipped, e >> 4, e & 0xF)
        nsucc = torch.where(found, tk.popcount4(mask), 0)
        succ[t, lanes] = nsucc.to(torch.int8)
        walk_steps += lanes.numel()
        if sizes is not None:
            o = torch.where(found, off[r], 0)
            cnt = torch.where(found, off[r + 1] - o, 0).clamp(max=wl.MAX_ADD)
            nfw = fw[o + cnt] - fw[o]
            after = sizes[t, lanes].to(torch.int64)
            before = sizes[t - 1, lanes].to(torch.int64) if t else torch.zeros_like(after)
            ops += int(link_step_ops(kmer_ops, torch.full_like(found, t == 0), cnt,
                                     torch.where(flipped, cnt - nfw, nfw), before, after,
                                     nsucc).sum())
        v = emitted[t, lanes].to(torch.int64)
        moved = v >= 0
        cur[lanes[moved]] = tk.shift_append(cur[lanes[moved]], v[moved] & 3, k)
        lanes = lanes[moved]
    pool_rows = int((off[1:] - off[:-1]).clamp(max=wl.MAX_ADD)[recs].sum())
    offsets = torch.zeros(n + 1, dtype=torch.bool, device=dev)
    offsets[:-1] |= recs
    offsets[1:] |= recs
    out = {"bucket_rows": int(rows.sum()), "records": int(recs.sum()),
           "offsets": int(offsets.sum()), "pool_rows": pool_rows, "walk_steps": walk_steps,
           "successors": succ}
    if sizes is not None:
        out["ops"] = ops
    return out


def link_walk_bound(tables, seeds, outputs, reads):
    """The walk's bound: seeds in, the [B, T] stream and the per-walk outputs
    out, and the distinct bucket rows, edge bytes, offsets and pool rows
    read; its operations as link_walk_reads counted them."""
    buckets = tables[0]
    row_bytes = buckets.shape[1] * buckets.shape[2] * 4
    moved = (nbytes(seeds, *outputs) + reads["bucket_rows"] * row_bytes + reads["records"]
             + reads["offsets"] * 4 + reads["pool_rows"] * LINK_POOL_ROW_BYTES)
    return bound_ms(moved, reads["ops"])


class NeedyTally:
    """A twin trace (walk_links_forward_plain's `trace`) that counts, on
    the device, the active walk steps and the needy ones (the steps whose
    store the kernels step by a warp)."""

    def __init__(self, dev):
        self.active = torch.zeros((), dtype=torch.int64, device=dev)
        self.needy = torch.zeros((), dtype=torch.int64, device=dev)

    def __call__(self, t, rec):
        self.active += rec["active"].sum()
        self.needy += rec["needy"].sum()

    def fields(self) -> dict:
        active, needy = int(self.active), int(self.needy)
        return {"walk_steps": active, "needy_steps": needy,
                "needy_share": round(needy / max(active, 1), 5)}


def link_walk_phase(dev, out) -> dict:
    """Phase 11: the linked device walker on phase 4's graph, ROIs and links
    (the trio's threaded links).  The path (launches counted): LinkedWalker
    over the sorted ROI k-mers, both directions, then walk_links_forward from
    LINK_SEEDS record k-mers (record i * 17 % N), raw outputs.  The ROI
    walks against their plain twin bit for bit, and their contigs against
    the native walker walked as Partition walks it; the bulk walks' kernel
    against its plain twin bit for bit, on every lane when the twin
    fits LINK_TWIN_BUDGET_S, else on a stated prefix (the lanes are
    independent: the twin runs LINK_TWIN_CHUNK lanes a call, and a call
    starts only when the last one's time still fits the budget); kernel and
    twin timed beside the bound, whose operations are counted with the
    twin's store sizes (link_walk_reads)."""
    from corticall_tpu_torch import kmer as km, native as nat
    from corticall_tpu_torch.ops import walk_links as wl

    t_phase = time.perf_counter()
    graph, rois, links = out["graph"], out["rois"], out["links"]
    k, n = graph.kmer_size, graph.num_records
    child = graph.color_for_sample(rois.sample_name(0))
    cks = sorted(rois.kmer_string(i) for i in range(rois.num_records))
    decoded = cks[:LINK_DECODE_SEEDS]
    t0 = time.perf_counter()
    walker = wl.LinkedWalker(graph, [child], links, device=dev)
    torch.cuda.synchronize()
    walker_s = time.perf_counter() - t0
    bulk = tk.words_tensor(graph.kmers[np.arange(LINK_SEEDS, dtype=np.int64) * 17 % n], dev)

    # the path: the walker's contigs and the bulk walks, launches counted
    wl.LAUNCHES["link_walk"] = 0
    assemble_ms, (contigs, overflow, junctions) = host_ms(
        lambda: walker.assemble(decoded, PF_MAX_WALK))
    bulk_ms, got = host_ms(lambda: wl.walk_links_forward(*walker.args, bulk, k, JUMP_STEPS))
    launches = wl.LAUNCHES["link_walk"]
    if not launches:
        raise AssertionError("ctk_link_walk never launched")

    # the ROI walks against their twin, and against the native walker as
    # Partition walks them
    walk_ms, (rows, roi_ov, steps, roi_jn, rc) = host_ms(
        lambda: walker.walk(decoded, PF_MAX_WALK))
    words = km.pack_codes(km.strings_to_codes(decoded + rc, k), k)
    roi_words = tk.words_tensor(words, dev)
    emitted = torch.from_numpy(rows.T.copy()).to(dev)
    roi_sizes = torch.full((PF_MAX_WALK, roi_words.shape[0]), -1, dtype=torch.int8, device=dev)
    roi_needy = NeedyTally(dev)
    roi_plain_ms, want = host_ms(lambda: wl.walk_links_forward_plain(
        *walker.args, roi_words, k, PF_MAX_WALK, store_sizes=roi_sizes, trace=roi_needy))
    roi_err = max(same(a.to(dev), w, f"link_walk ROI {name}") for name, a, w in zip(
        ("emitted", "overflow", "steps", "junctions"),
        (emitted, *(torch.from_numpy(x) for x in (roi_ov, steps, roi_jn))), want))
    del want
    t0 = time.perf_counter()
    native = nat.LinksWalkerNative(graph, [child], links)
    fwd, _ = native.walk(decoded, PF_MAX_WALK)
    back, _ = native.walk(rc, PF_MAX_WALK)
    native_s = time.perf_counter() - t0
    want = [(km.revcomp(b) if b else "") + s + f for s, f, b in zip(decoded, fwd, back)]
    roi_reads = link_walk_reads(walker.args, roi_words, k, emitted, roi_sizes)
    succ = roi_reads.pop("successors").T.cpu().numpy()
    roi_bound = link_walk_bound(walker.args, roi_words, (emitted, *(torch.from_numpy(x).to(dev)
                                for x in (roi_ov, steps, roi_jn))), roi_reads)
    del roi_sizes
    b = len(decoded)
    mismatches = seen_rule = 0
    for i, seed in enumerate(decoded):
        if overflow[i]:
            continue
        f = wl.decode_host_walk(seed, rows[i].tolist(), succ[i], PF_MAX_WALK)
        bk = wl.decode_host_walk(rc[i], rows[b + i].tolist(), succ[b + i], PF_MAX_WALK)
        if (km.revcomp(bk) if bk else "") + seed + f != want[i]:
            mismatches += 1
        elif contigs[i] != want[i]:
            seen_rule += 1
    if mismatches:
        raise AssertionError(f"{mismatches} linked walks without overflow differ from the "
                             "native walker's")
    roi_kernel_ms = event_ms(lambda: wl.walk_links_forward(*walker.args, roi_words, k,
                                                           PF_MAX_WALK), 3)

    # the bulk walks: the kernel alone, then the twin on every lane or a prefix
    out_bufs = (torch.empty((LINK_SEEDS, wl.emit_pitch(JUMP_STEPS)), dtype=torch.int8,
                            device=dev),
                torch.empty(LINK_SEEDS, dtype=torch.uint8, device=dev),
                torch.empty(LINK_SEEDS, dtype=torch.int32, device=dev),
                torch.empty(LINK_SEEDS, dtype=torch.int32, device=dev))
    kernel_ms = event_ms(lambda: wl.link_walk_kernel(*walker.args, bulk, k, JUMP_STEPS,
                                                     *out_bufs), 3)
    err = same(out_bufs[0][:, :JUMP_STEPS].t(), got[0], "link_walk, launched again")
    sizes = torch.full((JUMP_STEPS, LINK_SEEDS), -1, dtype=torch.int8, device=dev)
    bulk_needy = NeedyTally(dev)
    twin_lanes, plain_ms, chunk_ms = 0, 0.0, 0.0
    while twin_lanes < LINK_SEEDS and plain_ms + chunk_ms <= LINK_TWIN_BUDGET_S * 1e3:
        lo, hi = twin_lanes, min(twin_lanes + LINK_TWIN_CHUNK, LINK_SEEDS)
        chunk_ms, want = host_ms(lambda: wl.walk_links_forward_plain(
            *walker.args, bulk[lo:hi], k, JUMP_STEPS, store_sizes=sizes[:, lo:hi],
            trace=bulk_needy))
        for name, a, w in zip(("emitted", "overflow", "steps", "junctions"), got, want):
            lanes = a[:, lo:hi] if name == "emitted" else a[lo:hi]
            err = max(err, same(lanes, w, f"link_walk {name}"))
        del want
        twin_lanes, plain_ms = hi, plain_ms + chunk_ms
    reads = link_walk_reads(walker.args, bulk, k, got[0], sizes)
    del reads["successors"], sizes
    bound = link_walk_bound(walker.args, bulk, got, reads)
    total_steps = int(got[2].sum())
    w = bulk.shape[1]
    shapes = {"bulk": wl.kernel_info("link_walk", w, LINK_SEEDS, walker.args[0]),
              "roi": wl.kernel_info("link_walk", w, roi_words.shape[0], walker.args[0])}
    log(f"link walk: kernel {kernel_ms:.3f} ms, twin {plain_ms:.0f} ms on {twin_lanes} lanes, "
        f"{shapes}")
    result = {
        "records": n, "roi_seeds": len(cks), "decoded_seeds": b,
        "decode_note": (f"the first {b} of {len(cks)} ROI seeds decoded" if len(cks) > b
                        else "every ROI seed decoded"),
        "walker_build_s": round(walker_s, 3), "truncated_links": walker.truncated,
        "link_pool_rows": int(walker.args[4].shape[0]), "launches": launches,
        "overflows": int(overflow.sum()), "junctions_resolved": int(junctions.sum()),
        "roi_steps": int(steps.sum()), "mismatches": mismatches,
        "decode_seen_rule_contigs": seen_rule,
        "assemble_s": round(assemble_ms / 1e3, 4), "walk_s": round(walk_ms / 1e3, 4),
        "decode_s": round((assemble_ms - walk_ms) / 1e3, 4),
        "roi_kernel_ms": round(roi_kernel_ms, 4), "roi_plain_ms": round(roi_plain_ms, 1),
        "roi_err": roi_err, "native_s": round(native_s, 4),
        "roi_reads": roi_reads, "roi_bound": bound_fields(roi_bound),
        "roi_needy": roi_needy.fields(), "bulk_needy": bulk_needy.fields(),
        "bulk_needy_note": ("every lane" if twin_lanes == LINK_SEEDS
                            else f"the first {twin_lanes} lanes (the twin's)"),
        "kernel_shapes": shapes,
        "lanes": LINK_SEEDS, "max_steps": JUMP_STEPS, "bulk_call_ms": round(bulk_ms, 3),
        "steps": total_steps, "bulk_overflows": int(got[1].sum()),
        "bulk_junctions": int(got[3].sum()), "kernel_ms": round(kernel_ms, 4),
        "steps_per_s": round(total_steps / kernel_ms * 1e3), "twin_lanes": twin_lanes,
        "twin_note": ("every lane" if twin_lanes == LINK_SEEDS
                      else f"the first {twin_lanes} lanes (the twin's budget)"),
        "plain_ms": round(plain_ms, 1),
        "ops_per_step": round(reads["ops"] / reads["walk_steps"], 2),
        "ops_note": ("store sizes from the twin on every lane" if twin_lanes == LINK_SEEDS
                     else f"no store work charged past lane {twin_lanes}"),
        "max_abs_err": max(err, roi_err), "bound": bound_fields(bound), "reads": reads,
        "seconds": round(time.perf_counter() - t_phase, 2)}
    del walker, bulk, got, out_bufs, emitted, roi_words
    torch.cuda.empty_cache()
    return result


# ---- phase 12: the hash-sharded graph on a mesh of shards on the card -------

MESH_SHARDS = 4                               # shards of the sharded graph, all on the card
MESH_CALL_SHARDS = 2                          # sharded_call's Callers, both on the card
MESH_SKEW_SHARD = 3                           # test_mesh.py:136's owner of every skewed query
MESH_REPLAY_SEEDS = 16_384                    # walks decoded by replay_walk on both sides
# the linked walks' calls held against their twins: every call of the first
# MESH_LINK_CHECK_STEPS steps, then every MESH_LINK_CHECK_EVERY-th step (a
# twin's step costs ~3 ms a shard, launch-bound, so every call of the 2,000
# steps took 90 s on an H100)
MESH_LINK_CHECK_STEPS, MESH_LINK_CHECK_EVERY = 128, 16
QUEUE_SPIN_CYCLES = 2_000_000                 # ~1 ms of spinning ahead of a timed launch
# 32-bit integer operations a query or walk, counted from the functions the
# kernels compute (ops/kmer.py, ops/sharding.py), as link_kmer_ops counts
# them: the canonical form 28 a word + 1; the routing hash (hash_words 10 a
# word + 8, the salt, mix32 8, the modulo) 10 a word + 18; the owner count
# and the slot 6; the answer's hash and second bucket 10 a word + 19, each
# entry of both buckets 2 a word + 2, the edge byte 2 a colour, a link row
# 4; the walk step's successor, shift_append, cycle test, Brent state and
# emission 8 a word + 25.
ROUTE_OPS = (38, 25)                          # (a word, a query)
ANSWER_OPS = (10, 19)
WALK_STEP_OPS = (8, 25)


PATH_SPIN_CYCLES = 1_000_000                  # ~0.5 ms of spin ahead of a launch path_ms times
# each sharding wrapper's C entry point (ops/_kernels.py), where path_ms times its launches
PATH_ENTRIES = {"route": "ctk_route", "shard_answer": "ctk_shard_answer",
                "shard_walk_step": "ctk_shard_walk_step", "link_step": "ctk_link_step"}


def link_steps_plain(states, routes, backs, k: int, step: int) -> None:
    """The twin of one link_step call: link_step_plain shard by shard."""
    for state, route, back in zip(states, routes, backs):
        sh.link_step_plain(state, route, back, k, step)


# each sharding wrapper's plain twin, by the wrapper's name
MESH_TWINS = {"route": sh.route_plain, "shard_answer": sh.card_answer_plain,
              "shard_walk_step": sh.shard_walk_step_plain, "link_step": link_steps_plain}


def queued_ms(fn, reps: int) -> float:
    """Mean device time of fn()'s launches, each run queued behind a spin
    so that the host's launch overhead falls outside the events."""
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(QUEUE_SPIN_CYCLES)
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(stop)
    return total / reps


def mesh_clone(x, stream: bool = True):
    """A copy of a sharding wrapper's argument: tensors, routes and walk
    states (`stream=False`: a state's stream left unwritten, for a twin
    that writes one row of it)."""
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, sh.Route):
        return sh.Route(*(t.clone() for t in x))
    if isinstance(x, (sh.WalkState, sh.LinkState)):
        return type(x)(**{f: (v.clone() if stream or f != "stream" else torch.empty_like(v))
                          for f, v in vars(x).items()})
    if isinstance(x, list):
        return [mesh_clone(v, stream) for v in x]
    return x


def kernel_vs_twin(name, args, got, before, want) -> float:
    """A sharding wrapper's call against its twin's on a copy of its
    inputs (raising on any difference): a route's every field (its send
    buffer's routed rows), the answers' rows up to the routed total, a
    step's every state field and its stream row (`args` and `before`: the
    inputs the kernel and the twin updated)."""
    if name == "route":
        total = int(want.offsets[-1])
        return max(same(a[:total] if what == "send" else a, b[:total] if what == "send" else b,
                        f"route {what}") for what, a, b in zip(sh.Route._fields, got, want))
    if name == "shard_answer":
        total = int(args[1][-1])
        return same(got[:total], want[:total], "shard_answer")
    step = args[4]
    pairs = zip(args[0], before[0]) if name == "link_step" else [(args[0], before[0])]
    return max((same(getattr(a, f)[step] if f == "stream" else getattr(a, f),
                     getattr(b, f)[step] if f == "stream" else getattr(b, f), f"{name} {f}")
                for a, b in pairs for f in vars(a)), default=0.0)


def checked(fn, keep=lambda name, i, args: False, compare=lambda name, i: True):
    """fn() with each of the four sharding wrappers replaced by one that
    launches its kernel (the wrapper as it was) and, on the kernel's i-th
    call where `compare(name, i)`, runs its plain twin on a copy of the
    same inputs, raising on any difference (kernel_vs_twin).  Returns (fn's
    result, the largest difference and the calls compared of each kernel,
    and a copy of the inputs of the first call of each that `keep(name, i,
    args)` accepts)."""
    real = {name: getattr(sh, name) for name in MESH_TWINS}
    errs, calls, kept = dict.fromkeys(real, 0.0), dict.fromkeys(real, 0), {}
    seen = dict.fromkeys(real, 0)

    def wrap(name):
        def run(*args):
            if name not in kept and keep(name, seen[name], args):
                kept[name] = tuple(mesh_clone(a) for a in args)
            seen[name] += 1
            if not compare(name, seen[name] - 1):
                return real[name](*args)
            before = tuple(mesh_clone(a, stream=False) for a in args)
            got = real[name](*args)
            want = MESH_TWINS[name](*before)
            errs[name] = max(errs[name], kernel_vs_twin(name, args, got, before, want))
            calls[name] += 1
            return got
        return run

    for name in real:
        setattr(sh, name, wrap(name))
    try:
        out = fn()
    finally:
        for name, f in real.items():
            setattr(sh, name, f)
    return out, errs, calls, kept


def entry_timers(kernels=None, entries=None):
    """Each C entry point of `entries` ({name: entry}; the sharding kernels'
    PATH_ENTRIES by default) in the library of `kernels` (an ops._kernels
    module; this package's by default) replaced by one that runs it queued
    behind a PATH_SPIN_CYCLES spin, between two CUDA events, so that the
    wrapper's host work falls outside them; a call whose launch was queued
    only after the device had passed its start event (the host was late:
    the events then hold idle time too) is counted as late.  Returns ({name: [a function giving a call's ms once
    the device has passed it]}, {name: late calls}, a function that puts
    the entry points back)."""
    entries = PATH_ENTRIES if entries is None else entries
    lib = (kernels or _kernels).library()
    timers = {name: [] for name in entries}
    late = dict.fromkeys(entries, 0)
    saved = {entry: getattr(lib, entry) for entry in entries.values()}

    def timed(name, fn):
        def run(*args):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(PATH_SPIN_CYCLES)
            start.record()
            err = fn(*args)
            late[name] += start.query()
            stop.record()
            timers[name].append(lambda: start.elapsed_time(stop))
            return err
        return run

    for name, entry in entries.items():
        setattr(lib, entry, timed(name, saved[entry]))

    def restore():
        for entry, fn in saved.items():
            setattr(lib, entry, fn)
    return timers, late, restore


def path_sums(timers, late, before) -> dict:
    """entry_timers' records as {name: {"launches", "path_ms", "late"}}
    (launches: the LAUNCHES counted since `before`)."""
    torch.cuda.synchronize()
    return {name: {"launches": sh.LAUNCHES[name] - before[name],
                   "path_ms": round(sum(t() for t in timers[name]), 4), "late": late[name]}
            for name in PATH_ENTRIES}


def path_timed(fn):
    """fn() with every launch of the four sharding kernels timed on its own
    (entry_timers; Python's collector off meanwhile, so that its pauses do
    not make the host late), and a copy of the inputs of the linked step's
    call with the most needy walks (needy_walks).  Returns (fn's result,
    path_sums', {"needy_walks", "step", "args"})."""
    import gc

    most = {"needy_walks": -1, "step": None, "args": None}
    before = dict(sh.LAUNCHES)
    timers, late, restore = entry_timers()
    real = sh.link_step

    def link_step(*args):
        needy = sum(int(needy_walks(*a).sum()) for a in zip(*args[:3]))
        if needy > most["needy_walks"]:
            most.update(needy_walks=needy, step=args[4], args=tuple(mesh_clone(a) for a in args))
        return real(*args)

    sh.link_step = link_step
    gc.disable()
    try:
        out = fn()
    finally:
        gc.enable()
        sh.link_step = real
        restore()
    return out, path_sums(timers, late, before), most


def exchange_timed(fn):
    """fn() with each sharded exchange (mesh.routed_exchange: the route and
    the owners' answers; on one card no copy and no host read) timed on the
    host clock between synchronizes.  Returns (fn's result, {"calls",
    "bytes": the routed queries' words and their answer rows, "seconds"})."""
    from corticall_tpu_torch.parallel import mesh as pm

    stats = {"calls": 0, "bytes": 0, "seconds": 0.0}
    real = pm.routed_exchange

    def timed(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        routes, backs, routed = real(*args, **kw)
        torch.cuda.synchronize()
        stats["seconds"] += time.perf_counter() - t0
        stats["calls"] += 1
        rows = int(routed.sum())
        stats["bytes"] += rows * 4 * (routes[0].send.shape[1] + backs[0].shape[1])
        return routes, backs, routed

    pm.routed_exchange = timed
    try:
        out = fn()
    finally:
        pm.routed_exchange = real
    return out, stats


def host_timed(module, name: str, fn):
    """fn() with module.name's calls timed on the host clock: (fn's
    result, their seconds)."""
    real, total = getattr(module, name), [0.0]

    def timed(*args, **kw):
        t0 = time.perf_counter()
        out = real(*args, **kw)
        total[0] += time.perf_counter() - t0
        return out

    setattr(module, name, timed)
    try:
        return fn(), total[0]
    finally:
        setattr(module, name, real)


def exchange_fields(stats) -> dict:
    """exchange_timed's stats as phase 12 reports them."""
    steps = max(stats["calls"], 1)
    return {"steps": stats["calls"], "bytes": stats["bytes"],
            "ms": round(stats["seconds"] * 1e3, 3),
            "ms_a_step": round(stats["seconds"] * 1e3 / steps, 4),
            "bytes_a_step": stats["bytes"] // steps}


def route_bound(cur, active, k: int, n: int, batches, route):
    """ctk_route's bound, as (bytes, operations): the queries (and their
    active flags) in; the routed queries' words, each query's slot, owner
    and flag, the askers' counts and the owners' offsets out; ROUTE_OPS a
    query."""
    w, routed = cur.shape[1], int(route.offsets[-1])
    moved = (nbytes(cur, route.slot, route.owner, route.flipped, route.counts, route.offsets)
             + (0 if active is None else nbytes(active)) + routed * w * 4)
    return moved, cur.shape[0] * (ROUTE_OPS[0] * w + ROUTE_OPS[1])


def answer_bound(recv, offsets, buckets, edges, colors, links, ans):
    """ctk_shard_answer's bound, as (bytes, operations), summed over the
    owners' blocks: the queries in, the answers out, the distinct buckets
    their lookups read (both candidates), the colours' edge bytes of the
    distinct records found, and with the link CSR their offsets and pool
    rows (at most MAX_ADD a record); ANSWER_OPS a query, the entries'
    compares, the colours' ORs and the rows' copies."""
    off = offsets.tolist()
    moved = ops = nbytes(offsets)
    for j, (lo, hi) in enumerate(zip(off, off[1:])):
        q, a = recv[lo:hi], ans[lo:hi]
        (r, w), (nb, bs, _) = q.shape, buckets[j].shape
        h = tk.hash_words(tk.from_bits32(q))
        ids = torch.cat([h & (nb - 1), tk.mix32(h ^ tj.GOLDEN) & (nb - 1)])
        rec = a[:, sh.ANS_REC].to(torch.int64)
        hit = torch.unique(rec[rec >= 0])
        moved += nbytes(q, a) + bucket_bytes(buckets[j], ids) + hit.numel() * len(colors)
        ops += r * (ANSWER_OPS[0] * w + ANSWER_OPS[1] + 2 * bs * (2 * w + 2) + 2 * len(colors))
        if links is not None:
            lo_t = links[j][0].to(torch.int64)
            rows = int((lo_t[hit + 1] - lo_t[hit]).clamp(max=sh.MAX_ADD).sum())
            moved += hit.numel() * 8 + rows * LINK_POOL_ROW_BYTES
            ops += r * 4 * sh.MAX_ADD
    return moved, ops


def changed_bytes(before, after) -> int:
    """The bytes of `after` whose elements differ from `before`'s: what a
    step that updates a tensor in place must write."""
    return int((before != after).sum()) * after.element_size()


def walk_step_bound(before, after, route, back, cycle_check: bool = True):
    """ctk_shard_walk_step's bound, as (bytes, operations), from the state
    before and after the step: every walk's active flag in; each live
    walk's words, route flag and slot, answer row and (with the cycle test)
    saved words, power and lam in; each advancing walk's steps in; every
    state element the step changed out (cur, steps and lam where a walk
    advances, saved and power where it teleports, cycled where a cycle is
    found, active where a walk stops), and the stream row out;
    WALK_STEP_OPS a live walk."""
    live = int(before.active.to(torch.bool).sum())
    advanced = int((after.steps != before.steps).sum())
    b, w = before.cur.shape
    walk_in = w * 4 + 1 + 4 + back.shape[1] * 4 + ((w + 2) * 4 if cycle_check else 0)
    moved = (nbytes(before.active) + live * walk_in + advanced * 4 + b
             + sum(changed_bytes(getattr(before, f), getattr(after, f))
                   for f in ("cur", "active", "saved", "power", "lam", "cycled", "steps")))
    return moved, live * (WALK_STEP_OPS[0] * w + WALK_STEP_OPS[1])


def needy_walks(state, route, back):
    """The walks of a shard whose linked step is needy (bool [B]), from
    the state's bits and each live walk's returned answer."""
    live = state.active.to(torch.bool)
    got = sh._answers(route, back, live)
    edge = got[:, sh.ANS_EDGE]
    succ = tk.popcount4(torch.where(route.flipped.to(torch.bool), edge >> 4, edge & 0xF))
    bits = state.bits.to(torch.int64)
    return live & ((got[:, sh.ANS_CNT] > 0) | ((bits & sh.STORE_PENDING) != 0)
                   | ((succ > 1) & ((bits & sh.STORE_NONEMPTY) != 0)))


def link_step_bound(befores, afters, routes, backs, step: int):
    """ctk_link_step's bound over the shards of one call, as (bytes,
    operations), from each state before and after the step: every walk's
    active flag and slot in; each routed walk's record count in (an
    inactive one only takes its overflow); each live walk's words, route
    flag, edge byte and store bits in, and its junction count where it
    takes a choice; each needy walk's (needy_walks) first min(count,
    MAX_ADD) link rows, its store's valid flags and the other fields of its
    valid elements in; every element of the state, bits and stores that the
    step changed out, and the stream row out.  The live walks' operations
    by link_step_ops (the shift and emission for the k-mer's work: the
    lookup is the answer's), with each walk's records, gated records, store
    sizes before and after and successors read from these inputs and
    outputs."""
    moved = ops = 0
    for before, after, route, back in zip(befores, afters, routes, backs):
        live = before.active.to(torch.bool)
        routed = route.slot >= 0
        b, w = before.cur.shape
        count = back[route.slot[routed].to(torch.int64), sh.ANS_CNT].to(torch.int64)
        got = back[route.slot[live].to(torch.int64)].to(torch.int64)
        cnt = got[:, sh.ANS_CNT].clamp(max=sh.MAX_ADD)
        needy = needy_walks(before, route, back)
        valid = before.store[needy][:, 6] != 0
        moved += (nbytes(before.active, route.slot) + count.numel() * 4
                  + int(live.sum()) * (w * 4 + 1 + 4 + 1) + int(needy.sum()) * sh.CAP * 4
                  + int(cnt.sum()) * (sh.JW + 2) * 4
                  + int(valid.sum()) * (sh.STORE_FIELDS - 1) * 4
                  + changed_bytes(before.junctions, after.junctions) + b
                  + sum(changed_bytes(getattr(before, f), getattr(after, f))
                        for f in ("cur", "active", "overflow", "junctions", "store", "bits")))
        flipped = route.flipped[live].to(torch.bool)
        take = torch.arange(sh.MAX_ADD, device=got.device)[None, :] < cnt[:, None]
        gated = (take & ((got[:, sh.ANS_FW:sh.LINK_ANSWER] != 0) == ~flipped[:, None])).sum(1)
        edge = got[:, sh.ANS_EDGE]
        succ = tk.popcount4(torch.where(flipped, edge >> 4, edge & 0xF))
        sizes = [s.store[live][:, 6].to(torch.int64).sum(1) for s in (before, after)]
        ops += int(link_step_ops(4 * w + 9, torch.full_like(cnt, step == 0, dtype=torch.bool),
                                 cnt, gated, *sizes, succ).sum())
    return moved, ops


def mesh_kernel_rows(kept, errs) -> dict:
    """Each kernel at the inputs `checked` kept: its time (queued_ms, on
    fresh copies), its twin's (host clock), its bound and, for ctk_route,
    the library's packing (a stable argsort of the owners, the queries not
    routed last, and a bincount)."""
    rows = {}
    for name, args in kept.items():
        copies = iter([tuple(mesh_clone(a) for a in args) for _ in range(5)])
        ms = queued_ms(lambda: getattr(sh, name)(*next(copies)), 3)
        fresh = tuple(mesh_clone(a) for a in args)
        plain_ms, out = host_ms(lambda: MESH_TWINS[name](*fresh))
        launched = next(copies)
        err = kernel_vs_twin(name, launched, getattr(sh, name)(*launched), fresh, out)
        library = None
        if name == "route":
            bound = route_bound(*args, out)
            n = args[3]
            key = out.owner.to(torch.int64)
            if args[1] is not None:
                key = torch.where(args[1].to(torch.bool), key, n)
            library = queued_ms(lambda: (torch.argsort(key, stable=True),
                                         torch.bincount(key, minlength=n + 1)), 3)
            shape = {"queries": int(args[0].shape[0]), "routed": int(out.offsets[-1]),
                     "shards": n, "askers": int(out.counts.shape[0])}
        elif name == "shard_answer":
            bound = answer_bound(*args, out)
            shape = {"queries": int(args[1][-1]), "owners": len(args[2]),
                     "answer_words": int(out.shape[1])}
        elif name == "shard_walk_step":
            bound = walk_step_bound(args[0], fresh[0], *args[1:3], *args[5:])
            shape = {"walks": int(args[0].cur.shape[0]), "step": args[4]}
        else:
            bound = link_step_bound(args[0], fresh[0], *args[1:3], args[4])
            shape = {"walks": sum(int(st.cur.shape[0]) for st in args[0]),
                     "states": len(args[0]), "step": args[4],
                     "needy_walks": sum(int(needy_walks(*a).sum()) for a in zip(*args[:3]))}
        rows[name] = {"ms": round(ms, 5), "plain_ms": round(plain_ms, 3),
                      **bound_fields(bound_ms(*bound)), "bytes": bound[0], "ops": bound[1],
                      "library_ms": None if library is None else round(library, 5),
                      "max_abs_err": max(errs.get(name, 0.0), err), **shape}
    return rows


def compact_stream(bases: torch.Tensor, num_steps: int) -> torch.Tensor:
    """A walk_forward_spec stream (int8 [T, B], -1 at a stall and after the
    walk's end) as the sharded walk writes it: each lane's bases in order,
    then -1, in [num_steps, B]."""
    valid = bases >= 0
    row = valid.to(torch.int64).cumsum(0) - 1
    col = torch.arange(bases.shape[1], device=bases.device).expand_as(bases)
    out = torch.full((num_steps, bases.shape[1]), -1, dtype=torch.int8, device=bases.device)
    out[row[valid], col[valid]] = bases[valid]
    return out


def plain_step(g, queries: np.ndarray, colors, k: int):
    """make_sharded_walk_step's oracle on the host (test_mesh.py:136's):
    every query's record by the graph's own search, the combined edge byte,
    and the single-successor advance; (cur uint32 [B, W], advanced bool
    [B])."""
    words = torch.from_numpy(queries.astype(np.int64))
    canon, flipped = tk.canonicalize_words(words, k)
    rec = torch.from_numpy(g.find_records(canon.numpy().astype(np.uint32)))
    found = rec >= 0
    edge = torch.from_numpy(np.bitwise_or.reduce(g.edges[:, list(colors)], axis=1).astype(np.int64))
    e = torch.where(found, edge[rec.clamp(min=0)], 0)
    next_mask = torch.where(flipped, e >> 4, e & 0xF)
    advance = (tk.popcount4(next_mask) == 1) & found
    nxt = tk.shift_append(words, tk.lowest_set_base(next_mask), k)
    return (torch.where(advance[:, None], nxt, words).numpy().astype(np.uint32),
            advance.numpy())


def mesh_phase(dev, out, bench, mp, ref=None) -> dict:
    """Phase 12: the hash-sharded graph (parallel/mesh.py) on MESH_SHARDS
    shards, all on the card.  The path (launches counted): on phase 6's
    graph, make_sharded_walk_run over phase 6's seeds x SPEC_STEPS (phase
    9's walks) and one make_sharded_walk_step of skewed queries (every one
    owned by MESH_SKEW_SHARD); on phase 4's trio, sharded_assemble_links
    over the sorted ROI k-mers at Partition's max_walk.  A step of either is
    three launches on the card: ctk_route, ctk_shard_answer, then the walk
    or linked step.  Then: the walk run and the linked walks again with
    their exchanges timed (exchange_timed), equal to the path's;
    once more with every kernel call held against its twin on the same inputs
    (`checked`), equal to the path's, and against the single-device walk
    (walk_forward_spec on phase 9's walk table): every lane's stream with
    the stalls taken out, and MESH_REPLAY_SEEDS lanes decoded by
    replay_walk on both sides; the skewed step against the host's step and
    checked; the linked walks both ways again, checked on the calls of
    their first MESH_LINK_CHECK_STEPS steps and every
    MESH_LINK_CHECK_EVERY-th after, their streams equal to LinkedWalker's,
    their contigs, overflow and junctions equal to LinkedWalker.assemble's;
    sharded FindROIs against the host's FindROIs; and sharded_call on
    MESH_CALL_SHARDS Callers, whose VCF must be phase 4's calls.vcf byte for
    byte.  Each kernel is timed at a call of the checked runs: ctk_route
    and ctk_shard_answer at step 1 of the linked walks (the size most of
    their launches run at) and at step 0 of the walk run.  `ref`, when
    given, takes what the cross-process phase is held to (trio_reference)."""
    from corticall_tpu_torch import kmer as km
    from corticall_tpu_torch.caller.call import Caller
    from corticall_tpu_torch.commands import core as tcore
    from corticall_tpu_torch.ops import walk_links as wl
    from corticall_tpu_torch.ops import walk_np as wnp
    from corticall_tpu_torch.parallel import mesh as pm

    t_phase = time.perf_counter()
    g, k = bench["g"], JUMP_K
    mesh = pm.ShardMesh([dev] * MESH_SHARDS)
    t0 = time.perf_counter()
    sg = pm.ShardedGraph.from_graph(g, mesh)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    log(f"sharded graph: {MESH_SHARDS} shards of {sg.counts.tolist()} records in {build_s:.1f} s")
    seeds, ones = bench["seeds"], np.ones(len(bench["seeds"]), dtype=bool)
    skew = sg.records[MESH_SKEW_SHARD][:len(seeds) // MESH_SHARDS]
    skewed = np.tile(g.kmers[skew], (MESH_SHARDS, 1))
    graph, rois, links = out["graph"], out["rois"], out["links"]
    child = graph.color_for_sample(rois.sample_name(0))
    parents = [graph.color_for_sample(p) for p in ("mom", "dad")]
    t0 = time.perf_counter()
    sgt = pm.ShardedGraph.from_graph(graph, mesh)
    slt = pm.ShardedLinks.from_graph(graph, links, sgt)
    torch.cuda.synchronize()
    trio_build_s = time.perf_counter() - t0
    cks = sorted(rois.kmer_string(i) for i in range(rois.num_records))
    walk = pm.make_sharded_walk_run(mesh, sg, [0], k, SPEC_STEPS)
    step = pm.make_sharded_walk_step(mesh, sg, [0], k)
    walk(seeds[:MESH_SHARDS], ones[:MESH_SHARDS])              # first use

    # the path, launches counted
    for key in sh.LAUNCHES:
        sh.LAUNCHES[key] = 0
    t0 = time.perf_counter()
    walked = walk(seeds, ones)
    torch.cuda.synchronize()
    walk_s = time.perf_counter() - t0
    walk_launches = dict(sh.LAUNCHES)
    cur, advanced, live = step(skewed, np.ones(len(skewed), dtype=bool))
    t0 = time.perf_counter()
    (contigs, overflow, junctions), links_decode_s = host_timed(
        wl, "decode_linked_walk",
        lambda: pm.sharded_assemble_links(mesh, sgt, slt, [child], cks, PF_MAX_WALK))
    torch.cuda.synchronize()
    links_s = time.perf_counter() - t0
    launches = dict(sh.LAUNCHES)
    if not all(launches.values()):
        raise AssertionError(f"a sharding kernel never launched: {launches}")
    if not launches["route"] == launches["shard_answer"] == (
            launches["shard_walk_step"] + launches["link_step"]):
        raise AssertionError(f"a step on the card is not three launches: {launches}")

    # the exchange alone: the walk and the linked walks again, each exchange
    # between synchronizes (so walk_s and links_s above have none of them)
    rerun, exchange = exchange_timed(lambda: walk(seeds, ones))
    for name, a, b in zip(("bases", "cycled", "steps"), rerun, walked):
        same(a, b, f"the sharded walk's {name}, run with its exchange timed")
    del rerun
    (relinked, _, _), link_exchange = exchange_timed(lambda: pm.sharded_assemble_links(
        mesh, sgt, slt, [child], cks, PF_MAX_WALK))
    if relinked != contigs:
        raise AssertionError("the linked walks run with their exchanges timed differ")

    # the walk run: every kernel call against its twin; then the single-device
    # walk: every lane's stream (its stalls taken out), cycle flag and steps,
    # and the first MESH_REPLAY_SEEDS lanes' extensions through replay_walk
    t0 = time.perf_counter()
    again, errs, calls, kept = checked(lambda: walk(seeds, ones),
                                       lambda name, i, args: i == 0)
    checked_s = time.perf_counter() - t0
    for name, a, b in zip(("bases", "cycled", "steps"), again, walked):
        same(a, b, f"the sharded walk's {name}, run again")
    edges = np.ascontiguousarray(g.edges[:, 0])
    table, _ = tj.scatter_buckets(g.kmers, bench["nb"], bench["entry"], dev, payload=edges)
    spec = ck.walk_forward_spec(table, tk.words_tensor(seeds, dev), k, SPEC_STEPS)
    del table
    for name, a, b in zip(("bases", "cycled", "steps"), walked,
                          (compact_stream(spec[0], SPEC_STEPS), *spec[1:])):
        same(a, b, f"the sharded walk's {name} against the single-device walk's")
    t0 = time.perf_counter()
    strs, r = bench["seed_strs"][:MESH_REPLAY_SEEDS], MESH_REPLAY_SEEDS
    got_ext = wnp.batch_replay_exts(strs, walked[0][:, :r].t().cpu().numpy(),
                                    walked[1][:r].cpu().numpy(), SPEC_STEPS)
    want_ext = wnp.batch_replay_exts(strs, spec[0][:, :r].t().cpu().numpy(),
                                     spec[1][:r].cpu().numpy(), SPEC_STEPS)
    replay_s = time.perf_counter() - t0
    if got_ext != want_ext:
        bad = sum(a != b for a, b in zip(got_ext, want_ext))
        raise AssertionError(f"{bad} sharded walks differ from the single-device walk")
    steps_total = int(walked[2].sum())
    del spec, got_ext, want_ext

    # the skewed step against the host's
    want_cur, want_adv = plain_step(g, skewed, [0], k)
    if not (np.array_equal(cur.cpu().numpy().view(np.uint32), want_cur)
            and np.array_equal(advanced.cpu().numpy(), want_adv) and live == want_adv.sum()):
        raise AssertionError("the skewed sharded step differs from the host's step")
    (_, _, skew_live), skew_errs, _, _ = checked(
        lambda: step(skewed, np.ones(len(skewed), dtype=bool)))
    errs = {name: max(errs[name], skew_errs[name]) for name in errs}

    # the linked walks: checked both ways, against LinkedWalker
    walker = wl.LinkedWalker(graph, [child], links, device=dev)
    rows, w_ov, _, w_jn, rc = walker.walk(cks, PF_MAX_WALK)
    both = cks + rc
    both = km.pack_codes(km.strings_to_codes(both + both[:(-len(both)) % MESH_SHARDS]),
                         graph.kmer_size)
    run_links = pm.make_sharded_linked_walk_run(mesh, sgt, slt, [child], graph.kmer_size,
                                                PF_MAX_WALK)
    t0 = time.perf_counter()
    linked, link_errs, link_calls, link_kept = checked(
        lambda: run_links(both, np.ones(len(both), dtype=bool)),
        lambda name, i, args: i == 1,
        lambda name, i: i < MESH_LINK_CHECK_STEPS or i % MESH_LINK_CHECK_EVERY == 0)
    link_checked_s = time.perf_counter() - t0
    errs = {name: max(errs[name], link_errs[name]) for name in errs}
    b2 = len(rows)
    for name, a, b in zip(("emitted", "overflow", "junctions"),
                          (linked[0][:, :b2], linked[1][:b2], linked[2][:b2]),
                          (torch.from_numpy(rows).t(), torch.from_numpy(w_ov),
                           torch.from_numpy(w_jn))):
        same(a.cpu(), b, f"the sharded linked walk's {name} against LinkedWalker")
    want_contigs, want_ov, want_jn = walker.assemble(cks, PF_MAX_WALK)
    if [contigs[s] for s in cks] != list(want_contigs) or \
            not np.array_equal(overflow, want_ov) or int(junctions.sum()) != int(want_jn.sum()):
        raise AssertionError("sharded_assemble_links differs from LinkedWalker.assemble")
    del walker

    # FindROIs and Call
    got_rois = pm.sharded_find_rois_kmers(mesh, sgt, child, parents)
    want_rois = tcore.find_rois(graph, rois.sample_name(0), ["mom", "dad"])
    if not np.array_equal(km.words_to_bytes_be(got_rois, graph.kmer_size),
                          np.sort(km.words_to_bytes_be(want_rois.kmers, graph.kmer_size))):
        raise AssertionError("sharded FindROIs differs from the host's FindROIs")
    call_mesh = pm.ShardMesh([dev] * MESH_CALL_SHARDS)
    parts, refs = out["partitions"], mp["refs"]
    caller = Caller(graph, rois, parts, backgrounds=["mom", "dad"], references=refs,
                    links=links, device=dev)
    caller.call = lambda: pm.sharded_call(call_mesh, graph, rois, parts, ["mom", "dad"], refs,
                                          {"links": links})
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_call_") as wd:
        variants, _ = caller.write_outputs(os.path.join(wd, "calls.vcf"),
                                           os.path.join(wd, "accounting.txt"))
        vcf = open(os.path.join(wd, "calls.vcf"), "rb").read()
    call_s = time.perf_counter() - t0
    if vcf != mp["calls_vcf"]:
        raise AssertionError("sharded_call's VCF differs from phase 4's calls.vcf")

    # every launch of the walk run and the linked walks again, each timed on
    # its own (path_ms), keeping the linked step with the most needy walks
    t0 = time.perf_counter()
    (timed_walk, (timed_contigs, _, _)), path, most = path_timed(lambda: (
        walk(seeds, ones), pm.sharded_assemble_links(mesh, sgt, slt, [child], cks, PF_MAX_WALK)))
    path_s = time.perf_counter() - t0
    for name, a, b in zip(("bases", "cycled", "steps"), timed_walk, walked):
        same(a, b, f"the sharded walk's {name}, run with its launches timed")
    if timed_contigs != contigs:
        raise AssertionError("the linked walks run with their launches timed differ")
    del timed_walk

    if ref is not None:
        ref.update(trio_reference(mesh, sgt, graph, child, parents, both, linked, b2))

    walk_rows, link_rows = mesh_kernel_rows(kept, errs), mesh_kernel_rows(link_kept, errs)
    kernels = {"route": {**link_rows["route"], "walk_step0": walk_rows["route"]},
               "shard_answer": {**link_rows["shard_answer"],
                                "walk_step0": walk_rows["shard_answer"]},
               "shard_walk_step": walk_rows["shard_walk_step"],
               "link_step": link_rows["link_step"]}
    for name, row in kernels.items():
        row.update(path_ms=path[name]["path_ms"], path_launches=path[name]["launches"],
                   path_late=path[name]["late"])
    kernels["link_step"]["most_needy"] = mesh_kernel_rows({"link_step": most["args"]},
                                                          errs)["link_step"]
    log(f"mesh: walk {walk_s * 1e3:.1f} ms, exchange {exchange['seconds'] * 1e3:.1f} ms, "
        f"kernels {kernels}")
    result = {
        "shards": MESH_SHARDS, "devices": [str(d) for d in mesh.devices],
        "records": g.num_records, "shard_records": sg.counts.tolist(),
        "sharded_build_s": round(build_s, 2), "trio_records": graph.num_records,
        "trio_sharded_build_s": round(trio_build_s, 2),
        "seeds": len(seeds), "max_steps": SPEC_STEPS, "steps": steps_total,
        "cycled": int(walked[1].sum()), "walk_s": round(walk_s, 4),
        "walk_steps_per_s": round(steps_total / walk_s),
        "exchange": exchange_fields(exchange), "link_exchange": exchange_fields(link_exchange),
        "walk_launches": walk_launches, "launches": launches,
        "checked_s": round(checked_s, 2), "checked_calls": calls,
        "single_device_identical": True, "replayed_seeds": len(strs),
        "replay_s": round(replay_s, 2),
        "skewed_queries": len(skewed), "skewed_owner": MESH_SKEW_SHARD,
        "skewed_advanced": live, "skewed_checked_live": skew_live,
        "roi_seeds": len(cks), "links_s": round(links_s, 3),
        "links_decode_s": round(links_decode_s, 3),
        "link_checked_s": round(link_checked_s, 2), "link_checked_calls": link_calls,
        "overflows": int(overflow.sum()), "junctions": int(junctions.sum()),
        "linked_identical": True, "rois": len(got_rois), "rois_identical": True,
        "call_shards": MESH_CALL_SHARDS, "calls": len(variants), "call_s": round(call_s, 2),
        "vcf_identical": True, "kernels": kernels, "path_s": round(path_s, 2),
        "path_note": ("path_ms: every launch of the walk run and the linked walks, each "
                      "between CUDA events behind a spin"),
        "seconds": round(time.perf_counter() - t_phase, 2)}
    del sg, sgt, slt, walked, again, linked, kept, link_kept, most
    torch.cuda.empty_cache()
    return result


def trio_reference(mesh, sgt, graph, child: int, parents: list, both, linked, b2: int) -> dict:
    """What phase 15 is held to, from phase 12's single-process mesh on the
    trio: the sharded walk of MESH_TRIO_SEEDS record k-mers (record i * 17
    mod N, phase 11's) x SPEC_STEPS in the child's colour (bases, cycled,
    steps), FindROIs (the ROI records in the graph's order and the count),
    and the linked walks' seeds and streams (emitted, overflow and junctions
    of the first b2 walks), all on the host."""
    from corticall_tpu_torch.parallel import mesh as pm

    n = graph.num_records
    seeds = graph.kmers[(np.arange(MESH_TRIO_SEEDS, dtype=np.int64) * 17) % n]
    walk = pm.make_sharded_walk_run(mesh, sgt, [child], graph.kmer_size, SPEC_STEPS)
    bases, cycled, steps = walk(seeds, np.ones(len(seeds), dtype=bool))
    masks, total = pm.make_sharded_find_rois(mesh, sgt, child, parents)()
    roi = np.sort(np.concatenate([rec[m.cpu().numpy()] for rec, m in zip(sgt.records, masks)]))
    return {"walk_seeds": seeds, "walk_bases": bases.cpu().numpy(),
            "walk_cycled": cycled.cpu().numpy(), "walk_steps": steps.cpu().numpy(),
            "roi_records": roi, "roi_total": total, "linked_seeds": both,
            "linked_emitted": linked[0][:, :b2].cpu().numpy(),
            "linked_overflow": linked[1][:b2].cpu().numpy(),
            "linked_junctions": linked[2][:b2].cpu().numpy()}


# ---- phase 15: the sharded graph across processes ---------------------------

MESH_PROCESSES = 2                            # worker processes, both on the card
MESH_PROCESS_SHARDS = 4                       # shards a process: 8 global shards
MESH_PROCESS_TIMEOUT_S = 300                  # the workers' limit, then the phase fails
MESH_TRIO_SEEDS = LINK_SEEDS                  # the trio walk's seeds: phase 11's record k-mers


def process_mesh_phase(dev, out, ref) -> dict:
    """Phase 15: the hash-sharded graph across MESH_PROCESSES processes
    (corticall_tpu_torch/tools/dryrun_multihost.py's workers, a
    torch.distributed group: gloo, since NCCL cannot put two ranks on the
    one card), MESH_PROCESS_SHARDS shards each.  Phase 4's trio graph is
    written as a .ctx and its links as .ctp files; each worker loads its
    byte range, sends the records to their owners and walks its block of
    phase 12's trio walk (MESH_TRIO_SEEDS x SPEC_STEPS), runs FindROIs and
    its block of phase 12's linked ROI walks (both ways, PF_MAX_WALK steps).
    Every output must equal phase 12's single-process mesh's bit for bit
    (trio_reference), every sharding kernel must have launched in the
    workers (their counts reset at their start), and a worker's failure or
    timeout fails the phase."""
    from corticall_tpu_torch.io import ctx as ctxio, links as lkio
    from corticall_tpu_torch.tools import dryrun_multihost as dm

    t_phase = time.perf_counter()
    graph, links = out["graph"], out["links"]
    child = graph.color_for_sample(out["rois"].sample_name(0))
    parents = [graph.color_for_sample(p) for p in ("mom", "dad")]
    shards = MESH_PROCESSES * MESH_PROCESS_SHARDS
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_") as wd:
        t0 = time.perf_counter()
        ctx_path = os.path.join(wd, "trio.ctx")
        ctxio.write_ctx(ctx_path, graph.data)
        link_paths = []
        for i, ld in enumerate(links):
            link_paths.append(os.path.join(wd, f"trio_{i}.ctp"))
            lkio.write_links(link_paths[-1], ld)
        seeds = {}
        for name in ("walk_seeds", "linked_seeds"):
            words = np.asarray(ref[name], dtype=np.uint32)
            pad = (-len(words)) % shards
            seeds[name] = os.path.join(wd, f"{name}.npy")
            np.save(seeds[name], np.concatenate([words, np.repeat(words[:1], pad, axis=0)]))
        write_s = time.perf_counter() - t0
        spec = {"ctx": ctx_path, "links": link_paths, "shards": shards,
                "walk": {"seeds": seeds["walk_seeds"], "colors": [child], "steps": SPEC_STEPS},
                "rois": {"child": child, "parents": parents},
                "linked": {"seeds": seeds["linked_seeds"], "colors": [child],
                           "steps": PF_MAX_WALK},
                "check_shards": True, "out": os.path.join(wd, "result.npz")}
        t0 = time.perf_counter()
        workers = dm.run_workers(spec, MESH_PROCESSES, dev.type, wd,
                                 timeout=MESH_PROCESS_TIMEOUT_S)
        workers_s = time.perf_counter() - t0
        got = dm.gather(spec)
    b, b2 = len(ref["walk_seeds"]), ref["linked_emitted"].shape[1]
    for name, a, want in (
            ("walk bases", got["walk_bases"][:, :b], ref["walk_bases"]),
            ("walk cycled", got["walk_cycled"][:b], ref["walk_cycled"]),
            ("walk steps", got["walk_steps"][:b], ref["walk_steps"]),
            ("ROI records", got["roi_records"], ref["roi_records"]),
            ("linked emitted", got["linked_emitted"][:, :b2], ref["linked_emitted"]),
            ("linked overflow", got["linked_overflow"][:b2], ref["linked_overflow"]),
            ("linked junctions", got["linked_junctions"][:b2], ref["linked_junctions"])):
        if a.shape != want.shape or not np.array_equal(a, want):
            raise AssertionError(f"the cross-process mesh's {name} differ from phase 12's")
    if int(got["roi_total"]) != ref["roi_total"]:
        raise AssertionError("the cross-process FindROIs count differs from phase 12's")
    if not all(w["shards_identical"] for w in workers):
        raise AssertionError("an owned shard differs from ShardedGraph.from_graph's")
    launches = {name: sum(w["launches"][name] for w in workers) for name in sh.LAUNCHES}
    if dev.type == "cuda":
        if not all(launches.values()):
            raise AssertionError(f"a sharding kernel never launched in the workers: {launches}")
        if launches["route"] != launches["shard_walk_step"] + launches["link_step"]:
            raise AssertionError(f"a worker's step is not one route a step: {launches}")
    parts = sorted({part for w in workers for part in w["seconds"]})
    fields = {
        "processes": MESH_PROCESSES, "global_shards": shards,
        "shards_a_process": MESH_PROCESS_SHARDS, "backend": workers[0]["backend"],
        "devices": [w["device"] for w in workers],
        "records": graph.num_records,
        "byte_range_records": [w["records_read"] for w in workers],
        "owned_records": [w["records_owned"] for w in workers],
        "walk_seeds": b, "max_steps": SPEC_STEPS, "steps": int(got["walk_steps"][:b].sum()),
        "rois": int(got["roi_total"]), "linked_walks": b2, "linked_max_steps": PF_MAX_WALK,
        "seconds": {part: max(w["seconds"].get(part, 0.0) for w in workers) for part in parts},
        "bytes": {"load": sum(w["load_exchange"]["bytes"] for w in workers),
                  "walk": sum(w["walk_exchange_bytes"] for w in workers),
                  "linked": sum(w["linked_exchange_bytes"] for w in workers),
                  "all": sum(w["exchange"]["bytes"] for w in workers)},
        "collectives": sum(w["exchange"]["collectives"] for w in workers),
        "launches": launches, "shards_identical": True, "identical_to_phase_12": True,
        "write_s": round(write_s, 2), "workers_s": round(workers_s, 2),
        "phase_s": round(time.perf_counter() - t_phase, 2)}
    log(f"mesh across processes: {fields['backend']}, {workers_s:.1f} s, {fields['bytes']}, "
        f"launches {launches}")
    return fields


# ---- phases 13-14: the cross and the command line ---------------------------

KID2_SEEDS = (17, 19)                         # kid2's simulation and reads (phase 4's kid: 7, 11)
PATH_KERNELS = ("sw_banded", "tesserae", "count_windows", "segment_reduce")
# `python -m corticall_tpu_torch`, as phase 14's subprocess runs it
CLI_COMMAND = [sys.executable, "-m", "corticall_tpu_torch"]


def sha256(path) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def reset_launches() -> None:
    tsw.LAUNCHES = tt.LAUNCHES = 0
    for key in bdv.LAUNCHES:
        bdv.LAUNCHES[key] = 0


def read_launches() -> dict:
    return {"sw_banded": tsw.LAUNCHES, "tesserae": tt.LAUNCHES, **bdv.LAUNCHES}


def device_build():
    """CORTICALL_DEVICE_BUILD=1 for a block only."""
    return mock.patch.dict(os.environ, CORTICALL_DEVICE_BUILD="1")


def cross_phase(dev, mp, wd) -> tuple[dict, dict]:
    """Phase 13: run_cross_pipeline over phase 4's parents' reads and
    references with one progeny, kid2 (simulated from the same parents with
    seeds of its own), into `wd`, the builds on the device count
    (CORTICALL_DEVICE_BUILD=1 for the phase only), launches counted.  The
    parents' graphs must be written once, in the shared workdir only, with
    the bytes of phase 4's native builds; kid2 must have calls and a true
    positive against its own truth.  Returns the phase's fields and kid2's
    reads and simulation, for phase 14."""
    from corticall_tpu_torch import simulate as sim
    from corticall_tpu_torch.demo import evaluate
    from corticall_tpu_torch.pipeline import run_cross_pipeline

    mom, dad = mp["parents"]
    res = sim.simulate_haploid_child(mom, dad, parents=("mom", "dad"), mu=2.0,
                                     num_variants=PF_DNMS, k=PF_K, seed=KID2_SEEDS[0])
    reads = sim.simulate_reads(list(res["child"].values()), PF_COVERAGE, PF_READLEN, PF_ERR,
                               seed=KID2_SEEDS[1])
    reset_launches()
    t0 = time.perf_counter()
    with device_build():
        out = run_cross_pipeline(wd, {s: mp["reads"][s] for s in ("mom", "dad")},
                                 {"kid2": reads}, ["mom", "dad"], references=mp["refs"],
                                 k=PF_K, min_coverage=2, max_walk=PF_MAX_WALK, resume=False,
                                 device=dev, log=lambda *a: log(" ".join(map(str, a))))
    torch.cuda.synchronize()
    cross_s = time.perf_counter() - t0
    launches = read_launches()
    kid = out["per_sample"]["kid2"]
    hashes = {s: sha256(os.path.join(wd, f"{s}.clean.ctx")) for s in ("mom", "dad")}
    with open(os.path.join(wd, "state.json")) as f:
        shared_stages = list(json.load(f)["stages"])
    with open(os.path.join(wd, "kid2", "state.json")) as f:
        kid_stages = list(json.load(f)["stages"])
    ev = evaluate(kid["variants"], res["truth_vcf"], mom, dad, PF_K, recombs=res.get("recombs"))
    fields = {
        "progeny": out["progeny"], "cross_s": round(cross_s, 2),
        "shared_parent_build_s": out["shared_parent_build_s"],
        "kid2_wallclock_s": kid["wallclock_s"], "total_s": out["total_s"],
        "kid2_stage_s": kid["stages"], "shared_stages": shared_stages,
        "parents": out["parents"], "parent_graphs_equal_phase_4": hashes == mp["clean_sha"],
        "launches": launches, "calls": len(kid["variants"]),
        "calls_after_filter": len(kid["filtered_variants"]),
        "partition_route": kid["stats"]["partition"].get("walk_kernel"),
        "kmer_venn": ev["kmer_venn"], "strict_recovered": ev["strict_recovered"],
        "truth": len(res["truth_vcf"])}
    if any(not launches[name] for name in PATH_KERNELS):
        raise AssertionError(f"a kernel of the cross never launched: {launches}")
    if hashes != mp["clean_sha"]:
        raise AssertionError(f"the cross's parent graphs differ from phase 4's: {hashes}")
    if shared_stages != ["build_clean_mom", "build_clean_dad"] or \
            any(s.startswith("build_clean_") and s != "build_clean_kid2" for s in kid_stages) or \
            any(os.path.exists(os.path.join(wd, "kid2", f"{s}.clean.ctx")) for s in ("mom", "dad")):
        raise AssertionError(f"the parents were not built once in the shared workdir: "
                             f"{shared_stages}, {kid_stages}")
    if not kid["variants"] or ev["kmer_venn"]["tp"] < 1:
        raise AssertionError(f"kid2: {len(kid['variants'])} calls, {ev['kmer_venn']}")
    if not out["shared_parent_build_s"] > 0 or not kid["wallclock_s"] > 0:
        raise AssertionError(f"the cross's seconds: {fields}")
    return fields, {"reads": reads, "res": res}


def alignment_tsv(out) -> str:
    """align_contigs' placements as AlignContigs writes them."""
    rows = ["#contig\treference\tchrom\tstart\tend\tstrand\tscore\tmapq\tnm\tcigar\n"]
    for qn in out:
        for a in out[qn]:
            rows.append("\t".join([qn, getattr(a, "reference", "?"), a.contig, str(a.start),
                                   str(a.end), "-" if a.negative else "+", f"{a.score:g}",
                                   str(a.mapq), str(a.nm), a.cigar]) + "\n")
    return "".join(rows)


def vcf_parts(path) -> tuple[list, list]:
    with open(path) as f:
        lines = f.read().splitlines()
    return [ln for ln in lines if ln.startswith("#")], [ln for ln in lines if not ln.startswith("#")]


def cli_phase(dev, mp, cross, wd) -> dict:
    """Phase 14: the command line over kid2's stage files in phase 13's
    workdir, through corticall_tpu_torch.commands.cli.main in this process
    (so that the launches can be counted): Build (the device count) and
    Clean of kid2's reads as FASTA against the stage's kid2.clean.ctx;
    Partition (the CLI's defaults: max_walk 20,000) against core.partition
    on the same loaded files; AlignContigs against align_contigs; Call, with
    the links in the order run_pipeline hands them to its Caller, against
    the stage's calls.vcf and accounting.txt, byte for byte; FilterCalls'
    records against the stage's calls.filtered.vcf (the header lines that
    differ are listed); and AlignContigs again as `python -m
    corticall_tpu_torch` in a subprocess, the same TSV."""
    from corticall_tpu_torch import graph as gr
    from corticall_tpu_torch.commands import cli, core
    from corticall_tpu_torch.io import fasta as faio, links as lkio
    from corticall_tpu_torch.models.contig_aligner import align_contigs
    from corticall_tpu_torch.models.reference_index import IndexedReference

    kd, cd = os.path.join(wd, "kid2"), os.path.join(wd, "cli")
    os.makedirs(cd)
    stage = {name: os.path.join(kd, name) for name in os.listdir(kd)}
    head = [] if dev.type == "cuda" else ["--device", str(dev)]
    refs = {}
    for s, seqs in zip(("mom", "dad"), mp["parents"]):
        refs[s] = os.path.join(cd, f"{s}.fa")
        faio.write_fasta(refs[s], seqs)
    ref_args = [a for s, p in refs.items() for a in ("-R", f"{s}:{p}")]
    reads_fa = os.path.join(cd, "kid2_reads.fa")
    faio.write_fasta(reads_fa, {f"r{i}": r for i, r in enumerate(cross["reads"])})
    seconds, launches, checks = {}, {}, {}

    def run(name, *argv):
        reset_launches()
        t0 = time.perf_counter()
        code = cli.main([*head, name, *argv])
        torch.cuda.synchronize()
        seconds[name] = round(time.perf_counter() - t0, 3)
        launches[name] = read_launches()
        if code != 0:
            raise AssertionError(f"{name} exited {code}")
        return os.path.join(cd, f"{name}.out")

    def same_bytes(what, got, want):
        with open(got, "rb") as f, open(want, "rb") as g:
            checks[what] = f.read() == g.read()
        if not checks[what]:
            raise AssertionError(f"{what}: the command's bytes differ from {want}")

    with device_build():
        built = run("Build", "-1", reads_fa, "-k", str(PF_K), "-s", "kid2",
                    "-o", os.path.join(cd, "Build.out"))
    if not launches["Build"]["count_windows"] or not launches["Build"]["segment_reduce"]:
        raise AssertionError(f"Build did not run the count kernels: {launches['Build']}")
    same_bytes("clean", run("Clean", "-g", built, "-o", os.path.join(cd, "Clean.out")),
               stage["kid2.clean.ctx"])

    links = sorted(glob.glob(os.path.join(kd, "*.ctp.bgz")))
    parts = run("Partition", "-g", stage["joined.ctx"], "-r", stage["rois.filtered.ctx"],
                *[a for p in links for a in ("-l", p)], "-o", os.path.join(cd, "Partition.out"))
    t0 = time.perf_counter()
    want = core.partition(gr.CortexGraph.load(stage["joined.ctx"]),
                          gr.CortexGraph.load(stage["rois.filtered.ctx"]),
                          [lkio.read_links(p) for p in links], False, device=dev)
    seconds["partition_in_process"] = round(time.perf_counter() - t0, 3)
    with open(parts) as f:
        checks["partition"] = f.read() == "".join(f">{h}\n{c}\n" for h, c in want)
    if not checks["partition"]:
        raise AssertionError("Partition differs from core.partition on the same files")

    tsv = run("AlignContigs", "-c", stage["partitions.trimmed.fa"], *ref_args,
              "-o", os.path.join(cd, "AlignContigs.out"))
    t0 = time.perf_counter()
    placed = align_contigs(dict(faio.read_fasta(stage["partitions.trimmed.fa"])),
                           {s: IndexedReference(dict(faio.read_fasta(p)))
                            for s, p in refs.items()}, band=512, stats={}, device=dev)
    torch.cuda.synchronize()
    seconds["align_contigs_in_process"] = round(time.perf_counter() - t0, 3)
    with open(tsv) as f:
        aligned = f.read()
    checks["align_contigs"] = aligned == alignment_tsv(placed)
    if not checks["align_contigs"]:
        raise AssertionError("AlignContigs differs from align_contigs")

    order = [f"{s}.ctp.bgz" for s in ("kid2", "mom", "dad")] + \
        [f"ref_{s}.ctp.bgz" for s in ("mom", "dad")]
    vcf = run("Call", "-g", stage["joined.ctx"], "-r", stage["rois.filtered.ctx"],
              "-p", stage["partitions.trimmed.fa"], "-b", "mom", "-b", "dad", *ref_args,
              *[a for name in order for a in ("-l", stage[name])],
              "-o", os.path.join(cd, "Call.out"), "-ao", os.path.join(cd, "accounting.txt"))
    same_bytes("calls_vcf", vcf, stage["calls.vcf"])
    same_bytes("accounting", os.path.join(cd, "accounting.txt"), stage["accounting.txt"])

    filtered = run("FilterCalls", "-v", vcf, *ref_args, "-o", os.path.join(cd, "FilterCalls.out"))
    (got_head, got_rec), (want_head, want_rec) = vcf_parts(filtered), \
        vcf_parts(stage["calls.filtered.vcf"])
    checks["filter_calls_records"] = got_rec == want_rec
    if not checks["filter_calls_records"]:
        raise AssertionError("FilterCalls' records differ from the stage's")
    header_diff = {"cli_only": [ln for ln in got_head if ln not in want_head],
                   "stage_only": [ln for ln in want_head if ln not in got_head]}

    sub_tsv = os.path.join(cd, "subprocess.tsv")
    t0 = time.perf_counter()
    proc = subprocess.run([*CLI_COMMAND, *head, "AlignContigs", "-c",
                           stage["partitions.trimmed.fa"], *ref_args, "-o", sub_tsv],
                          capture_output=True, text=True, timeout=900, cwd=REPO)
    seconds["subprocess_align_contigs"] = round(time.perf_counter() - t0, 3)
    if proc.returncode != 0:
        raise AssertionError(f"python -m corticall_tpu_torch exited {proc.returncode}: "
                             f"{proc.stderr[-2000:]}")
    with open(sub_tsv) as f:
        checks["subprocess_align_contigs"] = f.read() == aligned
    if not checks["subprocess_align_contigs"]:
        raise AssertionError("the subprocess's TSV differs from the in-process run's")

    for name in ("AlignContigs", "Call"):
        if not launches[name]["sw_banded"] or (name == "Call" and not launches[name]["tesserae"]):
            raise AssertionError(f"{name} did not run its kernels: {launches[name]}")
    return {"seconds": seconds, "launches": {n: launches[n] for n in ("Build", "AlignContigs",
                                                                      "Call")},
            "checks": checks, "filter_calls_header_diff": header_diff,
            "partitions": len(want), "alignments": aligned.count("\n") - 1,
            "calls": len(vcf_parts(vcf)[1]), "filtered_calls": len(got_rec),
            "subprocess_exit": proc.returncode}


def haplotype_phase(dev, mp) -> dict:
    """Phase 16: the demo's haplotype mode (demo.run_haplotype_flow) on
    phase 4's simulated cross: whole-haplotype graphs, FindROIs, Partition
    without links, Call on the card.  The SW and Tesserae counts are set to
    0 just before it and read just after; the phase raises unless Tesserae
    launched and calls were made."""
    from corticall_tpu_torch.demo import run_haplotype_flow

    mom, dad = mp["parents"]
    res = mp["res"]
    stages = {}
    tsw.LAUNCHES = tt.LAUNCHES = tt.WIDE_LAUNCHES = 0
    t0 = time.perf_counter()
    out = run_haplotype_flow(res, mom, dad, res["truth_vcf"], PF_K, stages, device=dev)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {"sw_banded": tsw.LAUNCHES, "tesserae": tt.LAUNCHES,
                "tesserae_wide": tt.WIDE_LAUNCHES}
    if not launches["tesserae"] or not out["calls"]:
        raise AssertionError(f"the haplotype flow made {out['calls']} calls with "
                             f"{launches} launches")
    return {"seconds": round(seconds, 2), "stage_s": stages, "launches": launches, **out}


def main() -> int:
    dev = require_cuda()
    t_all = time.perf_counter()

    # ---- 1. environment ----------------------------------------------------
    smi = nvidia_smi()
    native = native_probe()
    emit("environment", nvidia_smi=smi, device=torch.cuda.get_device_name(0),
         device_count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, python=sys.version.split()[0],
         native_core=native)
    if not native["available"]:
        raise RuntimeError(f"the native C++ core does not load here: {native}")

    # ---- 2. build ----------------------------------------------------------
    built = _kernels.build(ptxas_verbose=True)
    _kernels.library()
    ptxas = [ln.strip() for ln in built["log"].splitlines()
             if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    emit("build", seconds=round(built["seconds"], 3),
         library=os.path.relpath(built["path"], REPO), ptxas=ptxas)

    # ---- 3. kernels against the plain twins at the smoke shapes ------------
    rng = np.random.default_rng(20260)
    sw_err, sw_times = 0.0, []
    for batch, qlen, slen, band in SW_SHAPES:
        q, s = sw_pairs(rng, batch, qlen, slen, band)
        qt, st = torch.from_numpy(q).to(dev), torch.from_numpy(s).to(dev)
        got = tsw.sw_banded(qt, st, band)
        torch.cuda.synchronize()
        want = tsw.banded_sw_scores(qt, st, band)     # doubles as warm-up
        sw_err = max(sw_err, sw_diff(got, want))
        k_ms = event_ms(lambda: tsw.sw_banded(qt, st, band), 5)
        p_ms, _ = host_ms(lambda: tsw.banded_sw_scores(qt, st, band))
        bf = sw_bound_fields(qt, st, band)
        sw_times.append({"batch": batch, "q": qlen, "s": slen, "band": band,
                         "cells_a_lane": tsw.sw_kernel_config(qlen, slen, band),
                         "kernel_ms": round(k_ms, 4), "plain_ms": round(p_ms, 2),
                         "kernel_gcups": round(bf["cells"] / k_ms / 1e6, 3), **bf})
        log(f"sw {batch}x{qlen}x{slen} band {band}: kernel {k_ms:.3f} ms, "
            f"plain {p_ms:.1f} ms")
    emit("sw_banded_vs_plain", bit_identical=True, max_abs_err=sw_err,
         shapes=sw_times)

    sections = tesserae_sections(rng) + [wide_section(rng)]
    ts_err, ts_rows = 0.0, []
    small = min(range(len(sections)), key=lambda i: len(sections[i][0]))
    warm = tt.section_inputs(sections[small][0], list(sections[small][1].values()),
                             CALLER_PARAMS, dev)
    tt.tesserae_fused(*warm)
    tt.tesserae_full(*warm)
    for query, targets in sections:
        args = tt.section_inputs(query, list(targets.values()), CALLER_PARAMS, dev)
        k_ms = event_ms(lambda: tt.tesserae_fused(*args), 3)
        got = tt.tesserae_fused(*args)
        p_ms, want = host_ms(lambda: tt.tesserae_full(*args))
        ts_err = max(ts_err, tesserae_diff(got, want))
        per, cluster, threads = tt.kernel_config(args[1].shape[0], args[1].shape[1] + 1)
        row = {"targets": len(targets), "query": len(query),
               "width": args[1].shape[1] + 1, "kernel_ms": round(k_ms, 3),
               "plain_ms": round(p_ms, 1), "path_cells": int(got[2]),
               "cluster": cluster, "threads": threads, "cells_per_thread": per,
               **bound_fields(tesserae_bound(args))}
        if len(targets) > tz.INT32_TARGETS:
            row["oracle_path"] = oracle_check(query, targets, dev)
        ts_rows.append(row)
        log(f"tesserae S={len(targets)} L={len(query)}: kernel {k_ms:.2f} ms, "
            f"plain {p_ms:.0f} ms")
    # the wide form, on sections the register form cannot hold
    wide_rows = []
    for query, targets in wide_form_sections(rng):
        args = tt.section_inputs(query, list(targets.values()), CALLER_PARAMS, dev)
        s_count, width = args[1].shape[0], args[1].shape[1] + 1
        wide, per, cluster, threads = tt.launch_config(s_count, width)
        gate = tt.section_bytes(len(query), [len(t) for t in targets.values()])
        if not wide or gate > tt.TesseraeDevice.HBM_BUDGET_BYTES:
            raise AssertionError(f"{s_count} x {width}: not a wide section the gate admits")
        before = tt.WIDE_LAUNCHES
        got = tt.tesserae_fused(*args)
        torch.cuda.synchronize()
        if tt.WIDE_LAUNCHES != before + 1:
            raise AssertionError("the wide section did not take the wide form")
        p_ms, want = host_ms(lambda: tt.tesserae_full(*args))
        ts_err = max(ts_err, tesserae_diff(got, want))
        del want
        k_ms = event_ms(lambda: tt.tesserae_fused(*args), 3)
        wide_rows.append({"targets": s_count, "query": len(query), "width": width,
                          "cells": s_count * width, "kernel_ms": round(k_ms, 3),
                          "us_per_column": round(k_ms * 1e3 / len(query), 3),
                          "plain_ms": round(p_ms, 1), "path_cells": int(got[2]),
                          "cluster": cluster, "threads": threads, "cells_per_thread": per,
                          "gate_bytes": gate, **bound_fields(tesserae_bound(args))})
        log(f"tesserae wide S={s_count} W={width} L={len(query)}: kernel {k_ms:.2f} ms, "
            f"plain {p_ms:.0f} ms")
    emit("tesserae_vs_plain", identical=True, max_abs_err=ts_err, sections=ts_rows,
         wide_form=wide_rows)

    # ---- 4. the main path --------------------------------------------------
    mp = run_main_path(dev, PF_MBP)
    out, res, ev, launches = mp["out"], mp["res"], mp["ev"], mp["launches"]
    stats = out["stats"]
    call = stats["call"]
    sizes = mp["section_targets"]
    emit("main_path", genome_mbp=PF_MBP, chromosomes=PF_CHROMS, dnms=PF_DNMS,
         k=PF_K, simulate_s=round(mp["simulate_s"], 2),
         pipeline_s=round(mp["pipeline_s"], 2),
         stage_s=out["stages"], graph_records=out["graph"].num_records,
         rois=out["rois"].num_records, partitions=len(out["partitions"]),
         walk_kernel=stats["partition"].get("walk_kernel"),
         calls=len(out["variants"]),
         calls_after_filter=len(out["filtered_variants"]),
         contig_aligner=call["contig_aligner"], tesserae=call.get("tesserae"),
         call_breakdown=call["call_breakdown"], launches=launches,
         tesserae_sections=len(sizes), largest_section_targets=max(sizes, default=0),
         sections_over_63_targets=sum(n > tz.INT32_TARGETS for n in sizes),
         kmer_venn=ev["kmer_venn"], strict_recovered=ev["strict_recovered"],
         truth=len(res["truth_vcf"]),
         demo={key: v for key, v in mp["demo"].items() if key != "stages"})
    check_main_path(mp)

    # ---- 5. what the pipeline sent to the kernels, through the twins -------
    rp = replay(mp)
    sw_err, ts_err = max(sw_err, rp["sw_err"]), max(ts_err, rp["ts_err"])
    emit("main_path_replay", sw_batches=rp["sw_batches"],
         sw_windows=rp["sw_windows"], tesserae_sections=rp["tesserae_sections"],
         identical=True, seconds=round(rp["seconds"], 2),
         sw={key: (round(v, 5) if isinstance(v, float) else v) for key, v in rp["sw"].items()},
         tesserae={key: (round(v, 5) if isinstance(v, float) else v)
                   for key, v in rp["tesserae"].items()})

    # ---- 6. the jump table and walk at bench.py's graph -------------------
    jp, bench = jump_phase(dev)
    emit("jump_vs_plain", identical=True, **jp)

    # ---- 7. Partition's device routes on the main path's inputs -----------
    pp = partition_phase(dev, out)
    emit("partition_device", **pp)

    # ---- 8. the full-matrix SW kernel --------------------------------------
    sp = sw_full_phase(dev, rng)
    emit("sw_full_vs_plain", bit_identical=True, max_abs_err=sp["err"],
         launches=sp["launches"], shapes=sp["shapes"],
         banded_sw_pallas_identical=True)

    # ---- 9. DeviceGraph and the walk table at bench.py's graph ------------
    wp = walk_table_phase(dev, bench)
    emit("walk_table_vs_plain", identical=True, **wp)

    # ---- 10. the device graph build on the trio's reads and the genome ----
    bp = build_phase(dev, mp["reads"], bench["genome"])
    emit("build_device", **bp)

    # ---- 11. the linked device walker on the trio's graph and links ------
    lp = link_walk_phase(dev, out)
    emit("link_walk_vs_plain", identical=True, **lp)

    # ---- 12. the hash-sharded graph on four shards of the card -------------
    trio_ref = {}
    hp = mesh_phase(dev, out, bench, mp, trio_ref)
    emit("mesh_vs_plain", identical=True, **hp)
    del bench

    # ---- 13-14. the cross, then the command line over its stage files ----
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cross_") as wd:
        xp, kid2 = cross_phase(dev, mp, wd)
        emit("cross", **xp)
        emit("cli", **cli_phase(dev, mp, kid2, wd))

    # ---- 15. the sharded graph across two processes on the card ----------
    xp_mesh = process_mesh_phase(dev, out, trio_ref)
    emit("mesh_across_processes", identical=True, **xp_mesh)
    del trio_ref

    # ---- 16. the demo's haplotype mode on the main path's cross ---------
    emit("haplotype_flow", **haplotype_phase(dev, mp))

    prod, full, rp_sw, rp_ts = sw_times[0], sp["shapes"][0], rp["sw"], rp["tesserae"]
    replayed, chunk = pp["replay"], bp["chunk"]
    # no single PyTorch call computes any of these functions (banded or
    # full Smith-Waterman, the Tesserae HMM, a cuckoo jump table, a
    # linear-probe lookup, the speculative cuckoo walk, the window
    # extraction, a keyed sum-and-OR reduction, a LinkStore walk or step, a
    # cuckoo lookup with its payload gather, a Brent walk step):
    # library_ms is null for each but the route's packing by owner, timed as
    # a stable argsort of the owners and a bincount
    print(json.dumps({"kernels": [
        {"name": "sw_banded", "route": "cuda",
         "source": "corticall_tpu_torch/csrc/sw_banded.cu",
         "replaces": "corticall_tpu/ops/sw_device.py:366",
         "launches": launches["sw_banded"], "max_abs_err": sw_err,
         "ms": prod["kernel_ms"], "plain_ms": prod["plain_ms"],
         "bound_ms": prod["bound_ms"], "bound_by": prod["bound_by"], "library_ms": None,
         "main_path_ms": round(rp_sw["ms"], 4), "main_path_plain_ms": round(rp_sw["plain_ms"], 2),
         "main_path_bound_ms": round(rp_sw["bound_ms"], 5)},
        {"name": "tesserae", "route": "cuda",
         "source": "corticall_tpu_torch/csrc/tesserae.cu",
         "replaces": "corticall_tpu/ops/tesserae_jax.py:200",
         "launches": launches["tesserae"], "max_abs_err": ts_err,
         "ms": round(sum(r["kernel_ms"] for r in ts_rows), 3),
         "plain_ms": round(sum(r["plain_ms"] for r in ts_rows), 1),
         "bound_ms": round(sum(r["bound_ms"] for r in ts_rows), 6),
         "bound_by": ts_rows[0]["bound_by"], "library_ms": None,
         "main_path_ms": round(rp_ts["ms"], 3), "main_path_plain_ms": round(rp_ts["plain_ms"], 1),
         "main_path_bound_ms": round(rp_ts["bound_ms"], 5),
         "wide_form": {"sections": len(wide_rows),
                       "ms": round(sum(r["kernel_ms"] for r in wide_rows), 3),
                       "plain_ms": round(sum(r["plain_ms"] for r in wide_rows), 1),
                       "bound_ms": round(sum(r["bound_ms"] for r in wide_rows), 6),
                       "main_path_launches": launches["tesserae_wide"]}},
        {"name": "jump_walk", "route": "cuda",
         "source": "corticall_tpu_torch/csrc/jump.cu",
         "replaces": "corticall_tpu/ops/cuckoo.py:1096",
         "launches": pp["launches"]["jump_walk"], "max_abs_err": replayed["walk_err"],
         "ms": replayed["walk_kernel_ms"], "plain_ms": replayed["walk_plain_ms"],
         **replayed["walk_bound"], "library_ms": None},
        {"name": "jump_stage0", "route": "cuda",
         "source": "corticall_tpu_torch/csrc/jump.cu",
         "replaces": "corticall_tpu/ops/cuckoo.py:757",
         "launches": pp["launches"]["jump_stage0"], "max_abs_err": replayed["stage0_err"],
         "ms": replayed["stage0_ms"], "plain_ms": replayed["stage0_plain_ms"],
         **replayed["stage0_bound"], "library_ms": None},
        {"name": "jump_compose", "route": "cuda",
         "source": "corticall_tpu_torch/csrc/jump.cu",
         "replaces": "corticall_tpu/ops/cuckoo.py:805",
         "launches": pp["launches"]["jump_compose"], "max_abs_err": replayed["compose_err"],
         "ms": replayed["compose_ms"], "plain_ms": replayed["compose_plain_ms"],
         **replayed["compose_bound"], "library_ms": None,
         "pass_ms": [p["ms"] for p in replayed["compose_passes"]]},
        {"name": "sw_full", "route": "cuda",
         "source": "corticall_tpu_torch/csrc/sw_banded.cu",
         "replaces": "corticall_tpu/ops/sw_device.py:236",
         "launches": sp["launches"], "max_abs_err": sp["err"],
         "ms": full["kernel_ms"], "plain_ms": full["plain_ms"],
         "bound_ms": full["bound_ms"], "bound_by": full["bound_by"], "library_ms": None},
        {"name": "ht_lookup", "route": "cuda",
         "source": "corticall_tpu_torch/csrc/walk_table.cu",
         "replaces": "corticall_tpu/ops/hashtable.py:131",
         "launches": wp["launches"]["ht_lookup"], "max_abs_err": wp["lookup_err"],
         "ms": wp["lookup_ms"], "plain_ms": wp["lookup_plain_ms"], **wp["lookup_bound"],
         "library_ms": None, "path_ms": wp["lookup_path"]["path_ms"],
         "probe_table_ms": wp["probe_table_ms"]},
        {"name": "spec_walk", "route": "cuda",
         "source": "corticall_tpu_torch/csrc/walk_table.cu",
         "replaces": "corticall_tpu/ops/cuckoo.py:306",
         "launches": wp["launches"]["spec_walk"], "max_abs_err": wp["spec_err"],
         "ms": wp["spec_ms"], "plain_ms": wp["spec_plain_ms"], **wp["spec_bound"],
         "library_ms": None, "path": wp["spec_kernel"]["path"],
         "rows_per_s": wp["spec_rows_per_s"]},
        {"name": "count_windows", "route": "cuda",
         "source": "corticall_tpu_torch/csrc/count.cu",
         "replaces": "corticall_tpu/ops/build_device.py:73",
         "launches": bp["launches"]["count_windows"], "max_abs_err": chunk["windows_err"],
         "ms": chunk["windows_ms"], "plain_ms": chunk["windows_plain_ms"],
         **chunk["windows_bound"], "library_ms": None, "path_ms": bp["count_path"]["path_ms"]},
        {"name": "segment_reduce", "route": "cuda",
         "source": "corticall_tpu_torch/csrc/count.cu",
         "replaces": "corticall_tpu/ops/build_device.py:139",
         "launches": bp["launches"]["segment_reduce"],
         "max_abs_err": max(chunk["reduce_err"], bp["merge"]["err"]),
         "ms": chunk["reduce_ms"], "plain_ms": chunk["reduce_plain_ms"],
         **chunk["reduce_bound"], "library_ms": None, "path_ms": bp["reduce_path"]["path_ms"],
         "merge_ms": bp["merge"]["ms"]},
        {"name": "link_walk", "route": "cuda",
         "source": "corticall_tpu_torch/csrc/walk_links.cu",
         "replaces": "corticall_tpu/ops/walk_links.py:199",
         "launches": lp["launches"], "max_abs_err": lp["max_abs_err"],
         "ms": lp["kernel_ms"], "plain_ms": lp["plain_ms"], **lp["bound"],
         "library_ms": None, "plain_lanes": lp["twin_lanes"]},
        *({"name": name, "route": "cuda", "source": source,
           "replaces": f"corticall_tpu/parallel/mesh.py:{line}",
           "launches": hp["launches"][name], **hp["kernels"][name],
           "process_mesh_launches": xp_mesh["launches"][name]}
          for name, source, line in (
              ("route", "corticall_tpu_torch/csrc/shard.cu", 111),
              ("shard_answer", "corticall_tpu_torch/csrc/shard.cu", 182),
              ("shard_walk_step", "corticall_tpu_torch/csrc/shard.cu", 420),
              ("link_step", "corticall_tpu_torch/csrc/walk_links.cu", 306))),
    ]}), flush=True)
    log(f"total {time.perf_counter() - t_all:.1f} s")
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
