#!/usr/bin/env python3
"""Times of the jump-table kernels (csrc/jump.cu) on one GPU.

    python3 corticall_tpu_torch/tools/jump_probe.py [--repo DIR] [--ablate]

On bench.py's graph (demo.build_bench_graph(47, 21_000_000), 21,003,902
records) and on a 2M-record one (demo.build_bench_graph(47, 2_000_000)):
the mean CUDA-event time of stage 0, of each compose pass (each from the
previous pass's rows, in the row format the version writes), of a whole
build (`jump_rows`) and of the walk kernel alone (262,144 seeds, at most
2,000 steps, as chip_smoke.py's phase 6), each beside its bound
(chip_smoke.py's rules).  Every kernel's rows are checked against the plain
build's, so a version that computes something else fails.

--repo DIR also times the package of another checkout (for example the
parent commit unpacked with `git archive`), loaded beside this one under
another name, on the same inputs: the two in turns, other, this, this,
other.

--ablate also times this checkout's csrc/jump.cu rebuilt with one lever at a
time taken out (the second bucket read only on a miss; the vector bucket
loads; the lookup only for one-successor rows), into the git-ignored
build/probe/.  The variant without the one-successor rule
computes other rows (time only).

JSON lines on stdout, then the card's name and power limit.
"""

import argparse
import ctypes
import importlib
import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, HERE)
sys.modules["jax"] = None

GRAPHS = [(47, 21_000_000), (47, 2_000_000)]      # (k, bases): ~21M and ~2M records
SEEDS, STEPS = 262_144, 2000
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
ABLATIONS = {"both buckets always": _BOTH_BUCKETS,
             "scalar bucket loads": _SCALAR, "lookup every orientation": _ALL_ROWS}


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

    def walk(self, buckets, rows, seeds, k, out, steps, flags):
        err = self.lib.ctk_jump_walk(
            rows.data_ptr(), buckets.data_ptr(), buckets.shape[0], seeds.shape[1], k,
            seeds.data_ptr(), seeds.shape[0], STEPS, out.shape[0], out.data_ptr(),
            steps.data_ptr(), flags[0].data_ptr(), flags[1].data_ptr(), flags[2].data_ptr(),
            self.tj._kernels.stream(seeds.device))
        self.tj._kernels.check(err, "jump_walk")


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
        for fn_name in ("ctk_jump_stage0", "ctk_jump_compose", "ctk_jump_walk"):
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
    iters = tj.jump_iters(STEPS)
    out = torch.zeros((iters, st.shape[0], 2), dtype=torch.int32, device=dev)
    steps = torch.zeros(st.shape[0], dtype=torch.int32, device=dev)
    flags = torch.zeros((3, st.shape[0]), dtype=torch.bool, device=dev)
    walk_ms = cs.event_ms(lambda: v.walk(buckets, want_rows, st, k, out, steps, flags), REPS)
    cs.same(steps, case["walk_steps"], f"{v.name}: walk steps")
    return {"version": v.name, "turn": turn, "records": kd.shape[0],
            "stage0_ms": round(stage0_ms, 5), "stage0_bound_ms": round(stage0_bound[0], 6),
            "compose_passes": passes,
            "compose_ms": round(sum(p["ms"] for p in passes), 5),
            "compose_bound_ms": round(sum(p["bound_ms"] for p in passes), 6),
            "build_ms": round(build_ms, 5), "walk_ms": round(walk_ms, 5),
            "walk_bound_ms": case["walk_bound_ms"]}


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
    seeds = km.pack_codes(km.strings_to_codes([genome[i:i + k] for i in starts]), k)
    st = tj.words_tensor(seeds, dev)
    got = tj.walk_jumps(buckets, rows, st, k, STEPS)
    cs.check_walk(buckets, rows, st, k, STEPS, got)
    landing = cs.bucket_bytes(buckets, cs.landing_buckets(kd, ed, buckets, k))
    walk_bound = cs.walk_bound(buckets, rows, st, k, STEPS, got)[0]
    print(json.dumps({"graph": {"k": k, "bases": bases, "records": n,
                                "buckets": buckets.shape[0], "landing_bucket_bytes": landing,
                                "seeds": SEEDS, "walk_steps": int(got[1].sum())}}), flush=True)
    return {"kd": kd, "ed": ed, "fd": fd, "buckets": buckets, "k": k, "rows": rows,
            "seeds": st, "walk_steps": got[1], "landing_bytes": landing,
            "walk_bound_ms": round(walk_bound, 6)}


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
