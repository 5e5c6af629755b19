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
   oracle), with the cluster each ran on.  Outputs must be bit-identical;
   the times are CUDA-event kernel times and synchronized host times of the
   twin, beside each kernel's bound;
4. the main path: a 2 Mbp / 2-chromosome / 20-DNM trio (the port's
   demo.make_cross, 20x reads of 150 bp) through corticall_tpu_torch
   .pipeline.run_pipeline, with every kernel launch counted, the target
   counts of the sections Call aligned, and the calls scored against the
   simulation truth (demo.evaluate's k-mer Venn);
5. every SW batch and Tesserae section that the pipeline sent to a kernel,
   replayed through the plain twin on the card (any difference fails), and
   the kernels timed at those shapes;
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
   against the banded twin.

Then one JSON line with each kernel's route, source, launches, error,
times and bound, the nvidia-smi line, and the result line.  Any failure
raises: the run exits non-zero and prints no result, as it does without a
CUDA device or outside the repository.  Neither jax nor the JAX package
(corticall_tpu) is ever imported.  About 6 minutes on one H100, most of it
host work (graph simulation and builds, the placement).
"""

import json
import os
import subprocess
import sys
import tempfile
import time

sys.modules["jax"] = None          # the port must run without jax
sys.modules["corticall_tpu"] = None  # and without the JAX package
REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from corticall_tpu_torch.device import require_cuda  # noqa: E402
from corticall_tpu_torch.models import tesserae as tz  # noqa: E402
from corticall_tpu_torch.ops import _kernels  # noqa: E402
from corticall_tpu_torch.ops import jump as tj  # noqa: E402
from corticall_tpu_torch.ops import kmer as tk  # noqa: E402
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
    """0.0 when two integer tensors are equal; raises otherwise."""
    if got.shape != want.shape or not torch.equal(got, want):
        bad = int((got != want).sum()) if got.shape == want.shape else -1
        raise AssertionError(f"{what} disagrees with its plain twin ({bad} entries)")
    return 0.0


def host_buckets(kmers: np.ndarray, nb: int, entry: np.ndarray) -> torch.Tensor:
    """The bucket array of a placement (entry = 2 * bucket + position a
    key), scattered on the host."""
    n, w = kmers.shape
    out = np.zeros((nb * 2, w + 1), dtype=np.uint32)
    out[entry, :-1] = kmers
    out[entry, -1] = np.arange(n, dtype=np.uint32) | np.uint32(1 << 31)
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
    same(tj.widen_rows(src, 0), tj.pack_rows(*state), "jump_stage0")
    landing = bucket_bytes(buckets, landing_buckets(kd, ed, buckets, k))
    stage0_bound = bound_ms(nbytes(kd, ed, fd, src) + landing)
    passes = []
    for p in range(tj.COMPOSE_PASSES):
        dst = torch.empty((n2, 2 if p < tj.NARROW_PASSES else 4), dtype=torch.int32,
                          device=rows.device)
        ms = event_ms(lambda: tj.compose_kernel(src, dst, p), 3)
        plain_ms, state = host_ms(lambda: tj.jump_compose(*state))
        got = dst if dst.shape[1] == 4 else tj.widen_rows(dst, p + 1)
        same(got, tj.pack_rows(*state), f"jump_compose pass {p + 1}")
        passes.append({"ms": round(ms, 4), "plain_ms": round(plain_ms, 2),
                       "row_bytes": [src.shape[1] * 4, dst.shape[1] * 4],
                       **bound_fields(bound_ms(nbytes(src, dst)))})
        src = dst
    del state
    same(src, rows, "jump table rows, the kernels' pass by pass")
    rows_plain_ms, plain_rows = host_ms(lambda: tj.jump_rows_plain(kd, ed, fd, buckets, k))
    same(rows, plain_rows, "jump table rows")
    return {"stage0_ms": round(stage0_ms, 4), "stage0_plain_ms": round(stage0_plain_ms, 2),
            "stage0_bound": bound_fields(stage0_bound), "landing_bucket_bytes": landing,
            "compose_ms": round(sum(p["ms"] for p in passes), 4),
            "compose_plain_ms": round(sum(p["plain_ms"] for p in passes), 2),
            "compose_bound": {"bound_ms": round(sum(p["bound_ms"] for p in passes), 6),
                              "bound_by": "bytes"},
            "compose_passes": passes, "rows_plain_ms": round(rows_plain_ms, 2)}


def check_walk(buckets, rows, seeds, k, num_steps, got) -> float:
    """A walk kernel's outputs `got` against the plain seed lookup and walk
    on the same inputs; raises on any difference.  Returns the plain twin's
    time (ms, after a warm-up)."""
    def plain_walk():
        start = tj.seed_rows(buckets, tk.from_bits32(seeds), k)
        return tj.jump_walk(rows, start, num_steps)
    plain_walk()
    plain_ms, want = host_ms(plain_walk)
    same(got[0], tk.to_bits32(want[0]), "jump_walk packed bases")
    same(got[1], want[1].to(torch.int32), "jump_walk steps")
    for name, a, b in zip(("cycled", "touched", "ends_junction"), got[2:], want[2:]):
        same(a, b, f"jump_walk {name}")
    same((got[1] >= num_steps) & ~got[2], (want[1] >= num_steps) & ~want[2],
         "jump_walk saturated")
    return plain_ms


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
    """Simulate the trio, run the port's pipeline with every kernel launch
    counted and every kernel input recorded, and score the calls."""
    from corticall_tpu_torch import simulate as sim
    from corticall_tpu_torch.demo import evaluate, make_cross
    from corticall_tpu_torch.models.reference_index import IndexedReference
    from corticall_tpu_torch.pipeline import run_pipeline

    t0 = time.perf_counter()
    prng = np.random.default_rng(42)
    mom, dad = make_cross(prng, mbp, PF_CHROMS, PF_DIVERGENCE)
    res = sim.simulate_haploid_child(mom, dad, parents=("mom", "dad"), mu=2.0,
                                     num_variants=PF_DNMS, k=PF_K, seed=7)
    reads = {
        "kid": sim.simulate_reads(list(res["child"].values()), PF_COVERAGE,
                                  PF_READLEN, PF_ERR, seed=11),
        "mom": sim.simulate_reads(list(mom.values()), PF_COVERAGE, PF_READLEN,
                                  PF_ERR, seed=12),
        "dad": sim.simulate_reads(list(dad.values()), PF_COVERAGE, PF_READLEN,
                                  PF_ERR, seed=13),
    }
    refs = {"mom": IndexedReference(mom), "dad": IndexedReference(dad)}
    simulate_s = time.perf_counter() - t0
    log(f"simulated the trio in {simulate_s:.1f} s")

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
    tsw.LAUNCHES = tt.LAUNCHES = 0
    try:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as wd:
            t0 = time.perf_counter()
            out = run_pipeline(wd, reads, child="kid", parents=["mom", "dad"],
                               references=refs, k=PF_K, min_coverage=2,
                               max_walk=PF_MAX_WALK, resume=False, device=dev,
                               log=lambda *a: log(" ".join(map(str, a))))
            torch.cuda.synchronize()
            pipeline_s = time.perf_counter() - t0
        launches = {"sw_banded": tsw.LAUNCHES, "tesserae": tt.LAUNCHES}
    finally:
        tsw.sw_banded, tt.tesserae_fused = sw_kernel, ts_kernel
        tt.TesseraeDevice.align = align
    ev = evaluate(out["variants"], res["truth_vcf"], mom, dad, PF_K,
                  recombs=res.get("recombs"))
    return {"out": out, "res": res, "ev": ev, "launches": launches,
            "sw_sent": sw_sent, "ts_sent": ts_sent, "section_targets": section_targets,
            "simulate_s": simulate_s,
            "pipeline_s": pipeline_s}


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
        cluster = tt.kernel_config(args[1].shape[0], args[1].shape[1] + 1)[1]
        ts["clusters"][cluster] = ts["clusters"].get(cluster, 0) + 1
    return {"sw_err": sw_err, "ts_err": ts_err, "sw_batches": len(mp["sw_sent"]),
            "sw_windows": sum(int(a[0].shape[0]) for a, _ in mp["sw_sent"]),
            "tesserae_sections": len(mp["ts_sent"]), "sw": sw, "tesserae": ts,
            "seconds": time.perf_counter() - t0}



def jump_phase(dev) -> dict:
    """Phase 6: the jump table and walk at bench.py's graph, kernels against
    the plain twins, and the device route against the native walker."""
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
    del bucket_of, pos_of, entry
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
    walk_plain_ms = check_walk(buckets, rows, st, k, JUMP_STEPS, got)
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
        "walk_plain_ms": round(walk_plain_ms, 2),
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
    del rows, buckets, kd, ed, fd, st, got, g, genome, wt
    torch.cuda.empty_cache()
    return out


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
    times = {}
    for (kd, ed, fd, buckets, k), rows in tables:
        same(buckets.cpu(), want_buckets, "jump table buckets")
        times = check_table(kd, ed, fd, buckets, k, rows)
    walk_plain_ms = walk_ms = walk_alone_ms = 0.0
    walk_bound_ms = (0.0, "bytes")
    lanes = 0
    for args, got in walks:
        plain_ms = check_walk(*args, got)
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
              "walk_bound": bound_fields(walk_bound_ms), **times,
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
    emit("tesserae_vs_plain", identical=True, max_abs_err=ts_err, sections=ts_rows)

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
         truth=len(res["truth_vcf"]))
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
    jp = jump_phase(dev)
    emit("jump_vs_plain", identical=True, **jp)

    # ---- 7. Partition's device routes on the main path's inputs -----------
    pp = partition_phase(dev, out)
    emit("partition_device", **pp)

    # ---- 8. the full-matrix SW kernel --------------------------------------
    sp = sw_full_phase(dev, rng)
    emit("sw_full_vs_plain", bit_identical=True, max_abs_err=sp["err"],
         launches=sp["launches"], shapes=sp["shapes"],
         banded_sw_pallas_identical=True)

    prod, full, rp_sw, rp_ts = sw_times[0], sp["shapes"][0], rp["sw"], rp["tesserae"]
    replayed = pp["replay"]
    # no single PyTorch call computes any of these functions (banded or
    # full Smith-Waterman, the Tesserae HMM, a cuckoo jump table): library_ms
    # is null for each
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
         "main_path_bound_ms": round(rp_ts["bound_ms"], 5)},
        {"name": "jump_walk", "route": "cuda",
         "source": "corticall_tpu_torch/csrc/jump.cu",
         "replaces": "corticall_tpu/ops/cuckoo.py:1096",
         "launches": pp["launches"]["jump_walk"], "max_abs_err": 0.0,
         "ms": replayed["walk_kernel_ms"], "plain_ms": replayed["walk_plain_ms"],
         **replayed["walk_bound"], "library_ms": None},
        {"name": "jump_stage0", "route": "cuda",
         "source": "corticall_tpu_torch/csrc/jump.cu",
         "replaces": "corticall_tpu/ops/cuckoo.py:757",
         "launches": pp["launches"]["jump_stage0"], "max_abs_err": 0.0,
         "ms": replayed["stage0_ms"], "plain_ms": replayed["stage0_plain_ms"],
         **replayed["stage0_bound"], "library_ms": None},
        {"name": "jump_compose", "route": "cuda",
         "source": "corticall_tpu_torch/csrc/jump.cu",
         "replaces": "corticall_tpu/ops/cuckoo.py:805",
         "launches": pp["launches"]["jump_compose"], "max_abs_err": 0.0,
         "ms": replayed["compose_ms"], "plain_ms": replayed["compose_plain_ms"],
         **replayed["compose_bound"], "library_ms": None,
         "pass_ms": [p["ms"] for p in replayed["compose_passes"]]},
        {"name": "sw_full", "route": "cuda",
         "source": "corticall_tpu_torch/csrc/sw_banded.cu",
         "replaces": "corticall_tpu/ops/sw_device.py:236",
         "launches": sp["launches"], "max_abs_err": sp["err"],
         "ms": full["kernel_ms"], "plain_ms": full["plain_ms"],
         "bound_ms": full["bound_ms"], "bound_by": full["bound_by"], "library_ms": None},
    ]}), flush=True)
    log(f"total {time.perf_counter() - t_all:.1f} s")
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
