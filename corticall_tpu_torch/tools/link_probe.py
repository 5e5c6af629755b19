#!/usr/bin/env python3
"""Times of the linked kernels (csrc/walk_links.cu) on one GPU.

    python3 corticall_tpu_torch/tools/link_probe.py [--repo DIR] [--ablate]
    python3 corticall_tpu_torch/tools/link_probe.py --inputs-only --device cpu \\
        --mbp 0.05 --bulk 256

Inputs, made as chip_smoke.py's phases 4 and 11 make theirs: the trio of
demo.make_cross at --mbp Mbp (2 chromosomes, 20 DNMs, k = 47, 20x 150 bp
reads), each sample's graph built and cleaned, the three joined, the three
samples' reads threaded into links; the ROI seeds are FindROIs' k-mers,
sorted (phase 11 walks those left after the prefilters), both ways; the
bulk seeds are --bulk record k-mers (record i * 17 mod N).  Timed, each on
the same card and inputs (CUDA events, the mean of REPS launches):
- ctk_link_walk (`link_walk_kernel`) over the bulk seeds and over the ROI
  seeds, at 2,000 steps;
- the linked ROI walks over the four shards of a ShardMesh on the card
  (sharded_assemble_links), on the host clock (`links_s`), then again with
  each launch of the four sharding kernels timed on its own
  (chip_smoke.entry_timers: `links_path`, each kernel's launches and
  path_ms);
- the single-successor walk of the bulk seeds over the same shards,
  WALK_STEPS steps (make_sharded_walk_run, phase 12's shape on this
  graph), on the host clock: a first run (`walk_first_ms`) and a second
  (`walk_ms`); then again with each launch of its kernels timed on its own
  (`walk_path`: each kernel's launches and path_ms), and ctk_shard_walk_step
  alone at the run's first step, every walk live, queued behind a spin
  (`walk_step_ms`), its state against the twin's, and the same launch over
  its first FLOOR_WALKS walks only (`walk_step_floor_ms`: what a launch
  costs with almost no work, the floor of this way of timing);
- ctk_link_step over the four shards' walks at that run's step with the
  most needy walks (chip_smoke.needy_walks), each run queued behind a spin
  (chip_smoke.queued_ms): this checkout's one launch over the card's
  walks, a checkout whose link_step takes one shard as its launches one a
  shard, back to back.
Every version's outputs are held equal to this checkout's.

--repo DIR also times the package of another checkout (for example the
parent commit unpacked with `git archive`), loaded beside this one under
another name, on the same inputs: the two in turns, other, this, this,
other.  --ablate also times this checkout's csrc/walk_links.cu with the walk
kernel capped at 12 blocks an SM (40 registers a thread, 48 warps an SM,
spilling), and ctk_shard_walk_step of its csrc/shard.cu with a walk's
answer read as one 8-byte vector (ANSWER_VECTOR; the sharded walk's answer
rows are 2 aligned words), in turns with this one at the walk's first
step; each rebuilt into the git-ignored build/probe/.  --inputs-only builds the inputs (on
--device, the card by default), prints their sizes as one JSON line and
stops.

JSON lines on stdout, then the card's name and power limit.
"""

import argparse
import ctypes
import dataclasses
import gc
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

STEPS = 2000                                  # Partition's max_walk, chip_smoke's JUMP_STEPS
WALK_STEPS = 256                              # the sharded walk's steps (chip_smoke's SPEC_STEPS)
SHARDS = 4
REPS = 5
FLOOR_WALKS = 256                             # one block of ctk_shard_walk_step
# the walk kernel's register cap, taken from 8 blocks an SM (64 registers) to 12 (40)
REGISTER_CAP = ("__launch_bounds__(128, 8)\nlink_walk_kernel",
                "__launch_bounds__(128, 12)\nlink_walk_kernel")
# the walk step's answer read as one 8-byte vector, not two words
ANSWER_VECTOR = ("    const int* a = back + (size_t)s * a_cols;\n"
                 "    const int rec = __ldg(a + kAnsRec);\n"
                 "    const uint32_t edge = (uint32_t)__ldg(a + kAnsEdge);\n",
                 "    const int2 a = __ldg(reinterpret_cast<const int2*>(back) + s);\n"
                 "    const int rec = a.x;\n"
                 "    const uint32_t edge = (uint32_t)a.y;\n")


def load_package(repo: str):
    """(ops.walk_links, ops.sharding, parallel.mesh) of `repo`'s
    corticall_tpu_torch; another checkout's package is loaded under the
    name `other_corticall_tpu_torch`."""
    if os.path.abspath(repo) == HERE:
        name = "corticall_tpu_torch"
    else:
        name = "other_corticall_tpu_torch"
        pkg_dir = os.path.join(repo, "corticall_tpu_torch")
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(pkg_dir, "__init__.py"), submodule_search_locations=[pkg_dir])
        pkg = importlib.util.module_from_spec(spec)
        sys.modules[name] = pkg
        spec.loader.exec_module(pkg)
    return tuple(importlib.import_module(f"{name}.{m}")
                 for m in ("ops.walk_links", "ops.sharding", "parallel.mesh"))


class Version:
    """One build of the linked kernels: a package's wrappers, or this
    checkout's wrappers over another library (`lib`)."""

    def __init__(self, name, modules, lib=None):
        self.name = name
        self.wl, self.sh, self.pm = modules
        self.lib = lib
        # a link_step of one shard a call: the checkouts before the launch a device
        self.per_shard = "state" in inspect.signature(self.sh.link_step).parameters

    def call(self, fn, *args):
        if self.lib is None:
            return fn(*args)
        kern = self.wl._kernels
        saved, kern._lib = kern._lib, self.lib
        try:
            return fn(*args)
        finally:
            kern._lib = saved

    def walk(self, tables, seeds, k):
        """One ctk_link_walk launch: (stream [B, pitch], overflow, steps,
        junctions)."""
        import torch
        b, dev = seeds.shape[0], seeds.device
        bufs = (torch.empty((b, self.wl.emit_pitch(STEPS)), dtype=torch.int8, device=dev),
                torch.empty(b, dtype=torch.uint8, device=dev),
                torch.empty(b, dtype=torch.int32, device=dev),
                torch.empty(b, dtype=torch.int32, device=dev))
        self.call(self.wl.link_walk_kernel, *tables, seeds, k, STEPS, *bufs)
        return bufs

    def states(self, captured):
        """This version's copy of a captured step's shard states and routes."""
        states, routes, backs, k, step = captured
        names = [f.name for f in dataclasses.fields(self.sh.LinkState)]
        return ([self.sh.LinkState(**{f: getattr(st, f).clone() for f in names})
                 for st in states],
                [self.sh.Route(**{f: getattr(r, f).clone() for f in self.sh.Route._fields})
                 for r in routes],
                [b.clone() for b in backs], k, step)

    def step(self, states, routes, backs, k, step):
        if self.per_shard:
            for args in zip(states, routes, backs):
                self.call(self.sh.link_step, *args, k, step)
        else:
            self.call(self.sh.link_step, states, routes, backs, k, step)


def ablated_version(this: Version, source: str, edit, entries, name: str) -> Version:
    """This checkout's wrappers over csrc/`source` with one `edit` (its text,
    the replacement), built with its own nvcc into build/probe/ and its
    `entries` loaded with this checkout's argtypes."""
    kern = this.wl._kernels
    out_dir = os.path.join(HERE, "build", "probe")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(kern.CSRC_DIR, source)) as f:
        src = f.read()
    if src.count(edit[0]) != 1:
        raise RuntimeError(f"{source} no longer has {edit[0]!r} once")
    stem = os.path.splitext(source)[0] + "_ablate"
    src_path = os.path.join(out_dir, stem + ".cu")
    with open(src_path, "w") as f:
        f.write(src.replace(*edit))
    path = os.path.join(out_dir, stem + ".so")
    cmd = [kern._nvcc(), *kern.NVCC_FLAGS, "-I", kern.CSRC_DIR, "-shared", "-o", path, src_path,
           os.path.join(kern.CSRC_DIR, "sw_banded.cu")]            # ctk_error_string
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(path)
    for entry in entries:
        fn = getattr(lib, entry)
        fn.argtypes = list(kern._SIGNATURES[entry])
        fn.restype = ctypes.c_int
    lib.ctk_error_string.argtypes = [ctypes.c_int]
    lib.ctk_error_string.restype = ctypes.c_char_p
    return Version(name, (this.wl, this.sh, this.pm), lib)


def make_inputs(cs, mbp: float, bulk: int, dev) -> dict:
    """The trio's joined graph, links and sorted FindROIs k-mers, the
    walker's tables on `dev`, the ROI seeds both ways and the bulk seeds."""
    import numpy as np
    from corticall_tpu_torch import build as bd, kmer as km, simulate as sim
    from corticall_tpu_torch.commands import core
    from corticall_tpu_torch.demo import make_cross
    from corticall_tpu_torch.io import links as lkio
    from corticall_tpu_torch.ops import kmer as tk, walk_links as wl

    prng = np.random.default_rng(42)
    mom, dad = make_cross(prng, mbp, cs.PF_CHROMS, cs.PF_DIVERGENCE)
    res = sim.simulate_haploid_child(mom, dad, parents=("mom", "dad"), mu=2.0,
                                     num_variants=cs.PF_DNMS, k=cs.PF_K, seed=7)
    haps = {"kid": list(res["child"].values()), "mom": list(mom.values()),
            "dad": list(dad.values())}
    reads = {s: sim.simulate_reads(h, cs.PF_COVERAGE, cs.PF_READLEN, cs.PF_ERR, seed=seed)
             for (s, h), seed in zip(haps.items(), (11, 12, 13))}
    graphs = [bd.clean_graph(bd.build_graph_from_reads(reads[s], cs.PF_K, s, use_device=False),
                             min_coverage=2) for s in reads]
    graph = core.join(graphs)
    links = [lkio.merge_prefix_links(bd.thread_reads(graph, reads[s], s)) for s in reads]
    rois = core.find_rois(graph, "kid", ["mom", "dad"])
    cks = sorted(rois.kmer_string(i) for i in range(rois.num_records))
    k, n = graph.kmer_size, graph.num_records
    walker = wl.LinkedWalker(graph, [graph.color_for_sample("kid")], links, device=dev)
    roi = km.pack_codes(km.strings_to_codes(cks + [km.revcomp(s) for s in cks], k), k)
    return {"graph": graph, "links": links, "cks": cks, "k": k, "tables": walker.args,
            "roi": tk.words_tensor(roi, dev),
            "bulk": tk.words_tensor(graph.kmers[np.arange(bulk, dtype=np.int64) * 17 % n], dev),
            "sizes": {"records": n, "roi_kmers": len(cks), "roi_walks": 2 * len(cks),
                      "bulk_walks": bulk, "link_pool_rows": int(walker.args[4].shape[0]),
                      "device": str(dev)}}


def sharded(this: Version, inputs, dev):
    """The trio's graph and links over SHARDS shards on the card: (mesh,
    sharded graph, sharded links, the walk colour)."""
    mesh = this.pm.ShardMesh([dev] * SHARDS)
    graph = inputs["graph"]
    sg = this.pm.ShardedGraph.from_graph(graph, mesh)
    sl = this.pm.ShardedLinks.from_graph(graph, inputs["links"], sg)
    return mesh, sg, sl, graph.color_for_sample("kid")


def linked_walks(v: Version, mesh_args, inputs):
    """The ROI seeds' linked walks both ways over the shards, by v's mesh
    module: sharded_assemble_links's (contigs, overflow, junctions)."""
    mesh, sg, sl, colour = mesh_args
    return v.pm.sharded_assemble_links(mesh, sg, sl, [colour], inputs["cks"], STEPS)


def sharded_walk(v: Version, mesh_args, inputs):
    """The bulk seeds' single-successor walks over the shards, by v's mesh
    module: make_sharded_walk_run's (bases, cycled, steps)."""
    import torch
    mesh, sg, _, colour = mesh_args
    seeds = inputs["bulk"]
    return v.pm.make_sharded_walk_run(mesh, sg, [colour], inputs["k"], WALK_STEPS)(
        seeds, torch.ones(seeds.shape[0], dtype=torch.bool, device=seeds.device))


def clone(x):
    """A copy of a sharding wrapper's argument: tensors, walk states,
    routes and lists of them."""
    import torch
    if isinstance(x, torch.Tensor):
        return x.clone()
    if dataclasses.is_dataclass(x):
        return type(x)(**{f.name: clone(getattr(x, f.name)) for f in dataclasses.fields(x)})
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(clone(t) for t in x))
    if isinstance(x, (tuple, list)):
        return type(x)(clone(t) for t in x)
    return x


def first_walk_step(v: Version, mesh_args, inputs):
    """A copy of the inputs of the first shard_walk_step call of the bulk
    seeds' sharded walk, by v's modules."""
    real, kept = v.sh.shard_walk_step, []

    def keep(*args):
        if not kept:
            kept.append(clone(args))
        return real(*args)

    v.sh.shard_walk_step = keep
    try:
        sharded_walk(v, mesh_args, inputs)
    finally:
        v.sh.shard_walk_step = real
    return kept[0]


def head_walks(args, n: int):
    """A shard_walk_step call's arguments cut to its first n walks (views of
    the state and route; the answers whole)."""
    state, route, *rest = args
    state = dataclasses.replace(state, **{
        f.name: getattr(state, f.name)[:, :n] if f.name == "stream"
        else getattr(state, f.name)[:n] for f in dataclasses.fields(state)})
    return (state, route._replace(slot=route.slot[:n], owner=route.owner[:n],
                                  flipped=route.flipped[:n]), *rest)


def timed_path(cs, v: Version, fn) -> dict:
    """fn() with each launch of the four sharding kernels of v's library
    timed on its own (chip_smoke.entry_timers): each launched kernel's
    launches, late launches and path_ms."""
    import torch
    timers, late, restore = cs.entry_timers(v.wl._kernels)
    gc.disable()
    try:
        fn()
    finally:
        gc.enable()
        restore()
    torch.cuda.synchronize()
    return {name: {"launches": len(ts), "late": late[name],
                   "path_ms": round(sum(t() for t in ts), 4)}
            for name, ts in timers.items() if ts}


def time_walk_step(cs, v: Version, args) -> dict:
    """ctk_shard_walk_step of v's library alone on a copy of a captured
    call's `args`, queued behind a spin (`walk_step_ms`), and over its first
    FLOOR_WALKS walks only (`walk_step_floor_ms`); its state held against
    the twin's."""
    def step(*a):
        v.call(v.sh.shard_walk_step, *a)

    copies = iter([clone(args) for _ in range(REPS + 2)])
    row = {"walk_step_ms": round(cs.queued_ms(lambda: step(*next(copies)), REPS), 5)}
    got, twin = next(copies), clone(args)
    step(*got)
    v.sh.shard_walk_step_plain(*twin)
    row["walk_step_walks"] = int(got[0].cur.shape[0])
    heads = iter([head_walks(clone(args), FLOOR_WALKS) for _ in range(REPS + 1)])
    row["walk_step_floor_ms"] = round(cs.queued_ms(lambda: step(*next(heads)), REPS), 5)
    for f in ("cur", "active", "saved", "power", "lam", "cycled", "steps", "stream"):
        cs.same(getattr(got[0], f), getattr(twin[0], f), f"{v.name}: shard_walk_step {f}")
    return row


def time_version(cs, v: Version, inputs, want, captured, mesh_args, turn) -> dict:
    """One version's times, and the host seconds of its sharded linked
    walks (`links_s`); raises where its outputs differ from `want`."""
    import numpy as np
    import torch
    k, tables = inputs["k"], inputs["tables"]
    row = {"version": v.name, "turn": turn}
    if hasattr(v.wl, "kernel_info"):          # the bulk launch's registers and local memory
        row["bulk_shape"] = v.call(v.wl.kernel_info, "link_walk", tables[0].shape[2] - 1,
                                   inputs["bulk"].shape[0], tables[0])
    for name in ("bulk", "roi"):
        seeds = inputs[name]
        row[f"{name}_walk_ms"] = round(cs.event_ms(lambda: v.walk(tables, seeds, k), REPS), 4)
        got = v.walk(tables, seeds, k)
        for what, a, b in zip(("stream", "overflow", "steps", "junctions"), got, want[name]):
            cs.same(a[:, :STEPS] if what == "stream" else a, b, f"{v.name}: {name} {what}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    contigs, overflow, junctions = linked_walks(v, mesh_args, inputs)
    torch.cuda.synchronize()
    row["links_s"] = round(time.perf_counter() - t0, 3)
    if contigs != want["contigs"] or not np.array_equal(overflow, want["overflow"]):
        raise AssertionError(f"{v.name}: the sharded linked walks differ")
    for name in ("walk_first_ms", "walk_ms"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        walked = sharded_walk(v, mesh_args, inputs)
        torch.cuda.synchronize()
        row[name] = round((time.perf_counter() - t0) * 1e3, 3)
        for what, a, b in zip(("bases", "cycled", "steps"), walked, want["walk"]):
            cs.same(a, b, f"{v.name}: the sharded walk's {what}")
    if v.lib is None:
        # the same walks, each launch of the four sharding kernels timed on its own
        row["links_path"] = timed_path(cs, v, lambda: linked_walks(v, mesh_args, inputs))
        row["walk_path"] = timed_path(cs, v, lambda: sharded_walk(v, mesh_args, inputs))
        row.update(time_walk_step(cs, v, first_walk_step(v, mesh_args, inputs)))
    copies = iter([v.states(captured) for _ in range(REPS + 2)])
    row["link_step_ms"] = round(cs.queued_ms(lambda: v.step(*next(copies)), REPS), 5)
    states = next(copies)
    v.step(*states)
    torch.cuda.synchronize()
    for got, ref in zip(states[0], want["step"]):
        for f in ("cur", "active", "overflow", "junctions", "store", "stream"):
            cs.same(getattr(got, f), getattr(ref, f), f"{v.name}: link_step {f}")
    return row


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--repo", help="another checkout whose kernels are timed in turns")
    ap.add_argument("--ablate", action="store_true")
    ap.add_argument("--mbp", type=float, default=2.0, help="the trio's genome (chip_smoke: 2)")
    ap.add_argument("--bulk", type=int, default=262_144, help="bulk walks (chip_smoke: 262,144)")
    ap.add_argument("--device", help="where --inputs-only builds (default: the card)")
    ap.add_argument("--inputs-only", action="store_true")
    args = ap.parse_args()

    import torch

    import chip_smoke as cs
    from corticall_tpu_torch.device import require_cuda, resolve

    if args.inputs_only:
        inputs = make_inputs(cs, args.mbp, args.bulk, resolve(args.device))
        print(json.dumps({"inputs": inputs["sizes"]}), flush=True)
        return 0
    dev = require_cuda()
    this = Version(".", load_package(HERE))
    order = [this, this]
    if args.repo:
        other = Version(os.path.relpath(os.path.abspath(args.repo), HERE),
                        load_package(os.path.abspath(args.repo)))
        order = [other, this, this, other]
    if args.ablate:
        order += [ablated_version(this, "walk_links.cu", REGISTER_CAP,
                                  ("ctk_link_walk", "ctk_link_step", "ctk_link_kernel_info"),
                                  "register cap: 12 blocks an SM")]
        vector = ablated_version(this, "shard.cu", ANSWER_VECTOR, ("ctk_shard_walk_step",),
                                 "walk step: the answer as one vector")
    inputs = make_inputs(cs, args.mbp, args.bulk, dev)
    k = inputs["k"]
    want = {name: this.walk(inputs["tables"], inputs[name], k) for name in ("bulk", "roi")}
    want = {name: (got[0][:, :STEPS], *got[1:]) for name, got in want.items()}
    mesh_args = sharded(this, inputs, dev)
    want["walk"] = sharded_walk(this, mesh_args, inputs)
    (want["contigs"], want["overflow"], _), path, most = cs.path_timed(
        lambda: linked_walks(this, mesh_args, inputs))
    ref = this.states(most["args"])
    this.step(*ref)
    want["step"] = ref[0]
    w = inputs["tables"][0].shape[2] - 1
    print(json.dumps({"inputs": inputs["sizes"], "steps": STEPS,
                      "bulk_steps": int(want["bulk"][2].sum()),
                      "roi_steps": int(want["roi"][2].sum()),
                      "link_step": {"step": most["step"], "needy_walks": most["needy_walks"],
                                    "walks": sum(int(s.cur.shape[0]) for s in ref[0]),
                                    "shards": SHARDS},
                      "linked_walks_path": path,
                      "kernel_shapes": {
                          "bulk": this.wl.kernel_info("link_walk", w, args.bulk,
                                                      inputs["tables"][0]),
                          "roi": this.wl.kernel_info("link_walk", w, inputs["roi"].shape[0],
                                                     inputs["tables"][0])}}), flush=True)
    for turn, v in enumerate(order):
        print(json.dumps(time_version(cs, v, inputs, want, most["args"], mesh_args, turn)),
              flush=True)
        torch.cuda.empty_cache()
    if args.ablate:
        first = first_walk_step(this, mesh_args, inputs)
        for turn, v in enumerate((this, vector, vector, this)):
            print(json.dumps({"kernel": "shard_walk_step", "version": v.name, "turn": turn,
                              **time_walk_step(cs, v, first)}), flush=True)
    print(cs.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
