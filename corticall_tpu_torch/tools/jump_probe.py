#!/usr/bin/env python3
"""Times of the jump-table kernels (csrc/jump.cu) on one GPU.

    python3 corticall_tpu_torch/tools/jump_probe.py [--repo DIR] [--ablate]

On bench.py's graph (demo.build_bench_graph(47, 21_000_000), 21,003,902
records) and on a 2M-record one (demo.build_bench_graph(47, 2_000_000)):
the mean CUDA-event time of stage 0, of each compose pass (each from the
previous pass's rows, in the row format the version writes), of a whole
build (`jump_rows`), and of the walk (at most 2,000 steps, as chip_smoke.py's
phase 6) at 262,144 seeds and at 1,406 (the lanes of chip_smoke.py's phase
7): the kernel alone, the whole `walk_jumps` call, and on the host clock
`walk_forward_jumps` (the walks materialized as numpy arrays, after one
warm-up call), each beside its bound (chip_smoke.py's rules).  Before
those, on the host clock, the walk_forward_jumps calls that Partition's
device routes make for the 262,144 seeds (chip_smoke.partition_walks_ms:
batches of commands/core.CHUNK seeds, forward then reverse), so that a
version's first turn shows what the first batches pay.  Every kernel's
rows and walk steps are checked against the plain build's, so a version
that computes something else fails.

--repo DIR also times the package of another checkout (for example the
parent commit unpacked with `git archive`), loaded beside this one under
another name, on the same inputs: the two in turns, other, this, this,
other.

--ablate also times this checkout's csrc/jump.cu rebuilt with one lever at a
time taken out (the second bucket read only on a miss; the vector bucket
loads; the lookup only for one-successor rows), into the git-ignored
build/probe/, and the walk kernel storing each lane's four-jump sector
straight from its registers as two 16-byte vectors ("unstaged sector
stores") instead of through the warp's shared-memory staging, or capped
at 32 registers by 16 blocks a SM ("register cap").  The variant
without the one-successor rule computes other rows (time only).

JSON lines on stdout, then the card's name and power limit.
"""

import argparse
import ctypes
import importlib
import importlib.util
import inspect
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, HERE)
sys.modules["jax"] = None

GRAPHS = [(47, 21_000_000), (47, 2_000_000)]      # (k, bases): ~21M and ~2M records
SEEDS, STEPS = 262_144, 2000
PHASE7_LANES = 1406                          # the forced Partition routes' widest walk
REPS = 10

# variant -> [(text of csrc/jump.cu, its replacement)]
_BOTH_BUCKETS = [("""    if (want[c] && !present[c]) {
      load_bucket<W>(buckets, mix32(h[c] ^ kGolden) & nb_mask, ent[c]);
      present[c] = match_bucket<W>(ent[c], key[c], payload[c]);
""", """    if (want[c]) {
      load_bucket<W>(buckets, mix32(h[c] ^ kGolden) & nb_mask, ent[c]);
      present[c] = match_bucket<W>(ent[c], key[c], payload[c]) || present[c];
""")]
_SCALAR = [("""  if constexpr (kWords % 4 == 0) {
#pragma unroll
    for (int j = 0; j < kWords / 4; ++j) {""", """#pragma unroll
  for (int j = 0; j < kWords; ++j) ent[j] = __ldg(p + j);
  if constexpr (false) {
#pragma unroll
    for (int j = 0; j < kWords / 4; ++j) {"""),
           ("""  } else {
#pragma unroll
    for (int j = 0; j < kWords / 2; ++j) {""", """  } else if constexpr (false) {
#pragma unroll
    for (int j = 0; j < kWords / 2; ++j) {""")]
_ALL_ROWS = [("lookup<W, 2>(buckets, nb_mask, canon, single, pay, present);",
              "const bool every[2] = {true, true};\n"
              "  lookup<W, 2>(buckets, nb_mask, canon, every, pay, present);")]
_UNSTAGED = [("""    __syncwarp();  // the warp's reads of the previous group are done
    stage[threadIdx.x][0] = make_uint4(x[0].x, x[0].y, x[1].x, x[1].y);
    stage[threadIdx.x][1] = make_uint4(x[2].x, x[2].y, x[3].x, x[3].y);
    __syncwarp();
#pragma unroll
    for (int part = 0; part < 2; ++part) {
      const int src = part * 16 + (wl >> 1);  // the warp lane whose sector this lane halves
      const int dst = lane - wl + src;
      if (dst < batch)
        reinterpret_cast<uint4*>(out + (size_t)dst * pitch + t)[wl & 1] =
            stage[warp0 + src][wl & 1];
    }
""", """    if (lane < batch) {
      uint4* p = reinterpret_cast<uint4*>(out + (size_t)lane * pitch + t);
      p[0] = make_uint4(x[0].x, x[0].y, x[1].x, x[1].y);
      p[1] = make_uint4(x[2].x, x[2].y, x[3].x, x[3].y);
    }
""")]
_REGISTER_CAP = [("__launch_bounds__(128)\njump_walk_kernel",
                  "__launch_bounds__(128, 16)\njump_walk_kernel")]
ABLATIONS = {"both buckets always": _BOTH_BUCKETS,
             "scalar bucket loads": _SCALAR, "lookup every orientation": _ALL_ROWS,
             "unstaged sector stores": _UNSTAGED, "register cap": _REGISTER_CAP}


def load_jump(repo: str):
    """The ops.jump module of `repo`'s corticall_tpu_torch; another
    checkout's package is loaded under the name `other_corticall_tpu_torch`."""
    if os.path.abspath(repo) == HERE:
        return importlib.import_module("corticall_tpu_torch.ops.jump")
    alias = "other_corticall_tpu_torch"
    pkg_dir = os.path.join(repo, "corticall_tpu_torch")
    spec = importlib.util.spec_from_file_location(
        alias, os.path.join(pkg_dir, "__init__.py"), submodule_search_locations=[pkg_dir])
    pkg = importlib.util.module_from_spec(spec)
    sys.modules[alias] = pkg
    spec.loader.exec_module(pkg)
    return importlib.import_module(f"{alias}.ops.jump")


class Version:
    """One build of the jump kernels: a package's wrappers (`tj`), or this
    checkout's wrappers over an ablated library (`lib`)."""

    def __init__(self, name, tj, lib=None):
        self.name, self.tj = name, tj
        self.lib = lib or tj._kernels.library()
        self.narrow = getattr(tj, "NARROW_PASSES", 0)
        # the parent's walk wrote zero-filled [T, B, 2] jumps and four outputs
        self.lane_major = "lanes" in inspect.signature(tj.walk_kernel).parameters

    def _swap(self):
        # wrappers of this checkout over the ablated library
        kern = self.tj._kernels
        saved = kern._lib
        kern._lib = self.lib
        return kern, saved

    def call(self, fn, *args):
        kern, saved = self._swap()
        try:
            return fn(*args)
        finally:
            kern._lib = saved

    def row_width(self, stage):
        """Width (int32 words) of the rows a stage writes: 0 for stage 0,
        p for compose pass p."""
        return 2 if stage <= self.narrow and self.narrow else 4

    def walk_buffers(self, b, dev):
        """The walk kernel's outputs for b lanes, allocated once (zero-filled,
        as the parent's kernel needs)."""
        import torch
        iters = self.tj.jump_iters(STEPS)
        if not self.lane_major:
            return (torch.zeros((iters, b, 2), dtype=torch.int32, device=dev),
                    torch.zeros(b, dtype=torch.int32, device=dev),
                    torch.zeros((3, b), dtype=torch.bool, device=dev))
        return (torch.empty((b, 2 * self.tj.walk_pitch(STEPS)), dtype=torch.int32, device=dev),
                torch.empty(7 * b, dtype=torch.uint8, device=dev))

    def walk(self, buckets, rows, seeds, k, bufs):
        """One walk kernel launch; returns the lanes' steps."""
        self.call(self.tj.walk_kernel, buckets, rows, seeds, k, STEPS, *bufs)
        return self.tj.lane_views(bufs[1], seeds.shape[0])[0] if self.lane_major else bufs[1]


def ablated_versions(tj):
    """This checkout's jump.cu with one lever out a variant, each built with
    its own nvcc into build/probe/ and loaded with this checkout's argtypes."""
    kern = tj._kernels
    out_dir = os.path.join(HERE, "build", "probe")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(kern.CSRC_DIR, "jump.cu")) as f:
        original = f.read()
    helper = os.path.join(kern.CSRC_DIR, "sw_banded.cu")    # ctk_error_string
    procs, libs = [], []
    for index, edits in enumerate(ABLATIONS.values()):
        src = original
        for old, new in edits:
            if old not in src:
                raise RuntimeError(f"jump.cu no longer has {old!r}")
            src = src.replace(old, new)
        path = os.path.join(out_dir, f"jump_ablate{index}.cu")
        with open(path, "w") as f:
            f.write(src)
        libs.append(os.path.join(out_dir, f"jump_ablate{index}.so"))
        procs.append(subprocess.Popen([kern._nvcc(), *kern.NVCC_FLAGS, "-shared", "-o",
                                       libs[-1], path, helper]))
    if any(p.wait() for p in procs):
        raise RuntimeError("nvcc failed")
    versions = []
    for name, path in zip(ABLATIONS, libs):
        lib = ctypes.CDLL(path)
        for fn_name in ("ctk_jump_stage0", "ctk_jump_compose", "ctk_jump_walk",
                        "ctk_copy_rows_to_host"):
            fn = getattr(lib, fn_name)
            argtypes = kern._SIGNATURES[fn_name]
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        lib.ctk_error_string.argtypes = [ctypes.c_int]
        lib.ctk_error_string.restype = ctypes.c_char_p
        versions.append(Version(name, tj, lib))
    return versions


def time_version(cs, v, case, turn):
    """One version's times on one graph; raises when its rows differ."""
    import torch
    tj = v.tj
    kd, ed, fd, buckets, k, want_rows, st = (case[key] for key in
                                             ("kd", "ed", "fd", "buckets", "k", "rows", "seeds"))
    n2 = 2 * kd.shape[0]
    dev = kd.device
    check = v.name != "lookup every orientation"

    def rows_like(width):
        return torch.empty((n2, width), dtype=torch.int32, device=dev)

    src = rows_like(v.row_width(0))
    stage0_ms = cs.event_ms(lambda: v.call(tj.stage0_kernel, kd, ed, fd, buckets, k, src),
                            REPS)
    stage0_bound = cs.bound_ms(cs.nbytes(kd, ed, fd, src) + case["landing_bytes"])
    passes = []
    for p in range(tj.COMPOSE_PASSES):
        dst = rows_like(v.row_width(p + 1))
        stage = (p,) if v.narrow else ()          # the parent's passes are all wide
        ms = cs.event_ms(lambda: v.call(tj.compose_kernel, src, dst, *stage), REPS)
        passes.append({"ms": round(ms, 5), "row_bytes": [src.shape[1] * 4, dst.shape[1] * 4],
                       "bound_ms": round(cs.bound_ms(cs.nbytes(src, dst))[0], 6)})
        src = dst
    if check:
        cs.same(src, want_rows, f"{v.name}: rows pass by pass")
    build_ms = cs.event_ms(lambda: v.call(tj.jump_rows, kd, ed, fd, buckets, k), REPS)
    if check:
        cs.same(v.call(tj.jump_rows, kd, ed, fd, buckets, k), want_rows, f"{v.name}: rows")
    from corticall_tpu_torch.commands.core import CHUNK
    partition_ms = cs.partition_walks_ms(
        lambda sd: v.call(tj.walk_forward_jumps, buckets, want_rows, sd, k, STEPS),
        case["seeds_np"], case["rev_np"], CHUNK)
    walks = []
    for lanes in (SEEDS, PHASE7_LANES):
        seeds = st[:lanes]
        bufs = v.walk_buffers(lanes, dev)
        walk_ms = cs.event_ms(lambda: v.walk(buckets, want_rows, seeds, k, bufs), REPS)
        cs.same(v.walk(buckets, want_rows, seeds, k, bufs), case["walk_steps"][:lanes],
                f"{v.name}: walk steps")
        del bufs
        row = {"lanes": lanes, "kernel_ms": round(walk_ms, 5),
               "bound_ms": case["walk_bound_ms"][lanes]}
        row["walk_jumps_ms"] = round(cs.event_ms(
            lambda: v.call(tj.walk_jumps, buckets, want_rows, seeds, k, STEPS), REPS), 5)
        host = case["seeds_np"][:lanes]
        v.call(tj.walk_forward_jumps, buckets, want_rows, host, k, STEPS)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        v.call(tj.walk_forward_jumps, buckets, want_rows, host, k, STEPS)
        row["materialized_ms"] = round((time.perf_counter() - t0) * 1e3, 3)
        walks.append(row)
    return {"version": v.name, "turn": turn, "records": kd.shape[0],
            "stage0_ms": round(stage0_ms, 5), "stage0_bound_ms": round(stage0_bound[0], 6),
            "compose_passes": passes,
            "compose_ms": round(sum(p["ms"] for p in passes), 5),
            "compose_bound_ms": round(sum(p["bound_ms"] for p in passes), 6),
            "build_ms": round(build_ms, 5), "walk": walks,
            "partition_walks_ms": [round(x, 3) for x in partition_ms],
            "partition_walks_total_ms": round(sum(partition_ms), 3)}


def make_case(cs, tj, k, bases, dev):
    """The graph's table inputs on the card, the plain build's rows, the
    walk's seeds and the bounds' data-dependent byte counts."""
    import numpy as np
    import torch
    from corticall_tpu_torch import kmer as km
    from corticall_tpu_torch.demo import build_bench_graph
    g, genome = build_bench_graph(k, bases)
    n = g.num_records
    buckets, kd = tj.build_buckets(g.kmers, dev)
    ed = torch.from_numpy(np.ascontiguousarray(g.edges[:, 0])).to(dev)
    fd = torch.from_numpy(np.random.default_rng(5).random(n) < 0.01).to(dev)
    rows = tj.jump_rows_plain(kd, ed, fd, buckets, k)
    rng = np.random.default_rng(11)
    starts = rng.integers(0, len(genome) - k, size=SEEDS)
    strs = [genome[i:i + k] for i in starts]
    seeds = km.pack_codes(km.strings_to_codes(strs), k)
    rev = km.pack_codes(km.strings_to_codes([km.revcomp(s) for s in strs]), k)
    st = tj.words_tensor(seeds, dev)
    got = tj.walk_jumps(buckets, rows, st, k, STEPS)
    cs.check_walk(buckets, rows, st, k, STEPS, got)
    landing = cs.bucket_bytes(buckets, cs.landing_buckets(kd, ed, buckets, k))
    walk_bound = {lanes: round(cs.walk_bound(buckets, rows, st[:lanes], k, STEPS,
                                             [x[:lanes] for x in got])[0], 6)
                  for lanes in (SEEDS, PHASE7_LANES)}
    print(json.dumps({"graph": {"k": k, "bases": bases, "records": n,
                                "buckets": buckets.shape[0], "landing_bucket_bytes": landing,
                                "seeds": SEEDS, "walk_steps": int(got[1].sum())}}), flush=True)
    return {"kd": kd, "ed": ed, "fd": fd, "buckets": buckets, "k": k, "rows": rows,
            "seeds": st, "seeds_np": seeds, "rev_np": rev, "walk_steps": got[1],
            "landing_bytes": landing,
            "walk_bound_ms": walk_bound}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--repo", help="another checkout whose kernels are timed in turns")
    ap.add_argument("--ablate", action="store_true")
    args = ap.parse_args()

    import torch

    import chip_smoke as cs
    from corticall_tpu_torch.device import require_cuda

    dev = require_cuda()
    this = Version(".", load_jump(HERE))
    order = [this, this]
    if args.repo:
        other = Version(os.path.relpath(os.path.abspath(args.repo), HERE),
                        load_jump(os.path.abspath(args.repo)))
        order = [other, this, this, other]
    if args.ablate:
        order += [this] + ablated_versions(this.tj)
    for k, bases in GRAPHS:
        case = make_case(cs, this.tj, k, bases, dev)
        for turn, v in enumerate(order):
            print(json.dumps({"bases": bases, **time_version(cs, v, case, turn)}), flush=True)
        del case
        torch.cuda.empty_cache()
    print(cs.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
