#!/usr/bin/env python3
"""Probes of the Tesserae kernel's column loop on one GPU.

    python3 corticall_tpu_torch/tools/tesserae_probe.py barriers
    python3 corticall_tpu_torch/tools/tesserae_probe.py ablate
    python3 corticall_tpu_torch/tools/tesserae_probe.py turns DIR

barriers: the cost of one iteration of __syncthreads(), cluster.sync()
(release/acquire), a relaxed cluster barrier and a five-step warp-shuffle
scan, at cluster shapes the register form uses (clock64 cycles and
CUDA-event ns); then, at the wide form's grids (clusters x CTAs x threads),
its grid barrier (cluster barrier, one release add a cluster, each CTA's
thread 0 spinning on the count, __syncthreads) and a column's whole
synchronization (the grid barrier, a second cluster barrier and the edge
handed to the next cluster under a release store), with csrc/tesserae.cu's
own device functions.

ablate: csrc/tesserae.cu rebuilt with parts of its column loop compiled out
(the outputs are then wrong: time only), in microseconds a query column, on
the smoke run's largest section and on a synthetic 16 x 64 section, each at
a few (cells a thread, cluster, threads) shapes, and the wide form on
chip_smoke.py's three wide sections at its default grid.  Each variant runs
in its own process, since an ablated kernel may fault.  Then the wide
form's shapes, from csrc/tesserae.cu rewritten to instantiate them too: C in
(4, 8, 16) cells a thread, clusters of 2, 4 or 8 CTAs of 128 or 256 threads,
each with its registers, spills and the clusters the card holds, on the
three wide sections (a grid that does not co-reside is reported, not
launched).

turns DIR: tesserae_fused of this checkout and of the checkout at DIR (its
package loaded beside this one, each calling its own kernels through its own
wrapper), timed in turns (DIR, this, this, DIR) on chip_smoke.py's phase-3
sections: each turn the sum of the register-form sections' CUDA-event times
(3 launches each) and each wide section's time.

JSON lines on stdout, then the card's name and power limit.  Builds go to
the git-ignored build/probe/.
"""

import ctypes
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, REPO)
sys.modules["jax"] = None

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from corticall_tpu_torch.ops import _kernels, tesserae_torch as tt  # noqa: E402

OUT = os.path.join(REPO, "build", "probe")

BARRIERS_CU = r"""
#include "tesserae.cu"

template <int MODE>
__global__ void probe(int iters, float* out, long long* cycles) {
  cg::cluster_group cluster = cg::this_cluster();
  float x = threadIdx.x;
  const long long t0 = clock64();
  for (int it = 0; it < iters; ++it) {
    if (MODE == 0) __syncthreads();
    if (MODE == 1) cluster.sync();
    if (MODE == 2) {
      asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
      asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
    }
    if (MODE == 3)
      for (int d = 1; d < 32; d <<= 1) x = fmaxf(x, __shfl_up_sync(0xffffffffu, x, d));
    if (MODE == 4) x += 1.0f;
  }
  if (threadIdx.x == 0 && blockIdx.x == 0) {
    *out = x;
    *cycles = clock64() - t0;
  }
}

template <int MODE>
int launch_probe(int iters, int cluster, int threads, float* out, long long* cycles, cudaStream_t s) {
  if (cluster > 8)
    cudaFuncSetAttribute(probe<MODE>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, probe<MODE>, iters, out, cycles);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

// the wide form's synchronization at a grid of `gridDim.x / K` clusters:
// MODE 0 its grid barrier, MODE 1 a whole column's (the grid barrier, a
// second cluster barrier and the edge handed to the next cluster); count
// is the barrier's word, `base` its value when the launch starts
template <int MODE>
__global__ void grid_probe(int iters, unsigned* count, int4* edge, unsigned base,
                           long long* cycles) {
  cg::cluster_group cluster = cg::this_cluster();
  const int K = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int G = (int)gridDim.x / K, cid = (int)blockIdx.x / K;
  const long long t0 = clock64();
  for (int it = 1; it <= iters; ++it) {
    cluster_barrier(threadIdx.x < 32);
    if (rank == 0 && threadIdx.x == 0) red_release_add(count, 1u);
    if (threadIdx.x == 0) spin_until(count, base + (unsigned)it * (unsigned)G);
    __syncthreads();
    if (MODE == 1) {
      const unsigned tag = base / (unsigned)G + (unsigned)it;
      if (rank == K - 1 && threadIdx.x == blockDim.x - 1 && cid + 1 < G) {
        edge[cid].x = it;
        st_release(reinterpret_cast<unsigned*>(&edge[cid].w), tag);
      }
      cluster_barrier(threadIdx.x >= blockDim.x - 32);
      if (rank == 0 && threadIdx.x == 0 && cid > 0)
        spin_until(reinterpret_cast<const unsigned*>(&edge[cid - 1].w), tag);
    }
  }
  if (threadIdx.x == 0 && blockIdx.x == 0) *cycles = clock64() - t0;
}

extern "C" int probe_grid(int mode, int iters, int clusters, int cluster, int threads,
                          unsigned* count, int4* edge, unsigned base, long long* cycles,
                          cudaStream_t s) {
  void (*fn)(int, unsigned*, int4*, unsigned, long long*) =
      mode ? grid_probe<1> : grid_probe<0>;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters * cluster, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int most = 0;
  if (cudaOccupancyMaxActiveClusters(&most, fn, &cfg) != cudaSuccess || clusters > most)
    return (int)cudaErrorCooperativeLaunchTooLarge;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, fn, iters, count, edge, base, cycles);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

extern "C" int probe_barrier(int mode, int iters, int cluster, int threads, float* out,
                             long long* cycles, cudaStream_t s) {
  switch (mode) {
    case 0: return launch_probe<0>(iters, cluster, threads, out, cycles, s);
    case 1: return launch_probe<1>(iters, cluster, threads, out, cycles, s);
    case 2: return launch_probe<2>(iters, cluster, threads, out, cycles, s);
    case 3: return launch_probe<3>(iters, cluster, threads, out, cycles, s);
    default: return launch_probe<4>(iters, cluster, threads, out, cycles, s);
  }
}
"""

BARRIER_MODES = ["__syncthreads", "cluster.sync", "cluster barrier, relaxed arrive",
                 "5-step shuffle scan", "loop alone"]
BARRIER_SHAPES = [(1, 32), (1, 512), (2, 256), (8, 256), (16, 448)]
GRID_MODES = ["grid barrier", "column synchronization"]
# (clusters, CTAs a cluster, threads a CTA): grids of the wide form's
# clusters from 1 to 65 (5 on the two smaller wide sections, 33 on the gate's
# largest), and the gate's largest at 16 cells a thread in clusters of 4 and 2
GRID_SHAPES = [(1, 8, 256), (5, 8, 256), (17, 8, 256), (33, 8, 256), (65, 8, 256),
               (65, 4, 256), (130, 2, 256)]

# (exact line of csrc/tesserae.cu, replacement): each hook compiles a part of
# the column loop (both forms: one kernel template) out under its macro.  The
# hooks apply from the cluster barrier to the kernels' dispatch
# (ABLATE_SPAN), where each line is unique.
ABLATE_SPAN = ("__device__ __forceinline__ void cluster_barrier(bool publishes) {\n",
               "// the kernel of each form for `cells` a thread")
HOOKS = [
    ("  for (int col = 1; col <= L; ++col) {\n",
     "  for (int col = 1; col <= L; ++col) {\n#ifdef ABL_EMPTY\n    if (col > 0) continue;\n#endif\n"),
    ("    const int qc = q[col - 1];\n",
     "#ifdef ABL_NOQ\n    const int qc = col & 3;\n#else\n    const int qc = q[col - 1];\n#endif\n"),
    ("      store_codes<C>(codes + (size_t)col * npad + f0, w);\n",
     "#ifndef ABL_NOSTORE\n      store_codes<C>(codes + (size_t)col * npad + f0, w);\n#endif\n"),
    ("    if (lead) rec[col] = rec_word(best, W);\n",
     "#ifndef ABL_NOSTORE\n    if (lead) rec[col] = rec_word(best, W);\n#endif\n"),
    ("  if (y.warp == 0) {\n    const Seg<T> x",
     "#ifdef ABL_NOEXCH\n  if (false) {\n#else\n  if (y.warp == 0) {\n#endif\n    const Seg<T> x"),
    ("  if (y.lane < y.K) {\n",
     "#ifdef ABL_NOEXCH\n  if (false) {\n#else\n  if (y.lane < y.K) {\n#endif\n"),
    ("    int bi = 0x7fffffff;\n",
     "    int bi = 0x7fffffff;\n#ifdef ABL_NOCOMPUTE\n    ncells = 0;\n#endif\n"),
    ("  if (lead) walk_path(codes, npad, rec, L, S, W, best, max_r, out, cap);\n",
     "#ifndef ABL_NOTB\n"
     "  if (lead) walk_path(codes, npad, rec, L, S, W, best, max_r, out, cap);\n"
     "#endif\n"),
    ("__device__ __forceinline__ void cluster_barrier(bool publishes) {\n",
     "__device__ __forceinline__ void cluster_barrier(bool publishes) {\n"
     "#ifdef ABL_NOBAR\n  return;\n#endif\n"),
    ("__device__ __forceinline__ void spin_until(const unsigned* p, unsigned target) {\n",
     "__device__ __forceinline__ void spin_until(const unsigned* p, unsigned target) {\n"
     "#ifdef ABL_NOBAR\n  return;\n#endif\n"),
    ("    const int per = (gr.G + 31) >> 5;\n",
     "#ifdef ABL_NOEXCH\n    const int per = 0;\n#else\n    const int per = (gr.G + 31) >> 5;\n#endif\n"),
]
ABLATIONS = {
    "kernel": [],
    "no arithmetic, no traceback": ["ABL_NOCOMPUTE", "ABL_NOTB"],
    "no cross-warp/CTA exchange, no traceback": ["ABL_NOEXCH", "ABL_NOTB"],
    "no barriers, no traceback": ["ABL_NOBAR", "ABL_NOTB"],
    "no traceback stores, no traceback": ["ABL_NOSTORE", "ABL_NOTB"],
    "all of the above and no query load": ["ABL_NOCOMPUTE", "ABL_NOEXCH", "ABL_NOBAR",
                                           "ABL_NOSTORE", "ABL_NOTB", "ABL_NOQ"],
    "empty column loop": ["ABL_EMPTY", "ABL_NOTB"],
}


def nvcc_shared(src: str, lib: str, defines=(), include=None) -> subprocess.Popen:
    return subprocess.Popen([_kernels._nvcc(), *_kernels.NVCC_FLAGS,
                             *[f"-D{d}" for d in defines],
                             *([f"-I{include}"] if include else []), "-shared", "-o", lib, src])


def barriers() -> None:
    os.makedirs(OUT, exist_ok=True)
    src, lib_path = os.path.join(OUT, "barriers.cu"), os.path.join(OUT, "barriers.so")
    with open(src, "w") as f:
        f.write(BARRIERS_CU)
    if nvcc_shared(src, lib_path, include=_kernels.CSRC_DIR).wait():
        raise RuntimeError("nvcc failed")
    lib = ctypes.CDLL(lib_path)
    lib.probe_barrier.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 3
    lib.probe_barrier.restype = ctypes.c_int
    lib.probe_grid.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2 + [
        ctypes.c_uint] + [ctypes.c_void_p] * 2
    lib.probe_grid.restype = ctypes.c_int
    out = torch.zeros(1, device="cuda")
    cycles = torch.zeros(1, dtype=torch.int64, device="cuda")
    stream = _kernels.stream(torch.device("cuda"))
    iters = 20000
    for mode, name in enumerate(GRID_MODES):
        for clusters, cluster, threads in GRID_SHAPES:
            count = torch.zeros(4, dtype=torch.int32, device="cuda")
            edge = torch.zeros((clusters, 4), dtype=torch.int32, device="cuda")
            grid_iters = 2000
            done = [0]

            def run():
                err = lib.probe_grid(mode, grid_iters, clusters, cluster, threads,
                                     count.data_ptr(), edge.data_ptr(),
                                     done[0] * grid_iters * clusters, cycles.data_ptr(), stream)
                _kernels.check(err, name)
                done[0] += 1
            try:
                ms = cs.event_ms(run, 3)
            except RuntimeError as exc:       # a grid that does not co-reside
                print(json.dumps({"probe": name, "clusters": clusters, "cluster": cluster,
                                  "threads": threads, "refused": str(exc)}), flush=True)
                continue
            print(json.dumps({"probe": name, "clusters": clusters, "cluster": cluster,
                              "threads": threads, "ns": round(ms * 1e6 / grid_iters, 1),
                              "cycles": round(int(cycles.item()) / grid_iters, 1)}), flush=True)
    for mode, name in enumerate(BARRIER_MODES):
        for cluster, threads in BARRIER_SHAPES:
            def run():
                _kernels.check(lib.probe_barrier(mode, iters, cluster, threads, out.data_ptr(),
                                                 cycles.data_ptr(), stream), name)
            ms = cs.event_ms(run, 3)
            print(json.dumps({"probe": name, "cluster": cluster, "threads": threads,
                              "ns": round(ms * 1e6 / iters, 2),
                              "cycles": round(int(cycles.item()) / iters, 1)}), flush=True)


def rewritten_source(hooks, name: str, span=None) -> str:
    """csrc/tesserae.cu with each hook's line (unique within `span`, or the
    whole file) replaced, written to build/probe/`name`."""
    with open(os.path.join(_kernels.CSRC_DIR, "tesserae.cu")) as f:
        src = f.read()
    a, b = (src.index(span[0]), src.index(span[1])) if span else (0, len(src))
    part = src[a:b]
    for line, hooked in hooks:
        if part.count(line) != 1:
            raise RuntimeError(f"tesserae.cu no longer has the hook line {line!r}")
        part = part.replace(line, hooked)
    path = os.path.join(OUT, name)
    with open(path, "w") as f:
        f.write(src[:a] + part + src[b:])
    return path


def phase3_sections(dev):
    """chip_smoke.py's phase-3 Tesserae sections on `dev`, from its seed and
    its stream of draws: the register form's (tesserae_sections and
    wide_section) and the wide form's (wide_form_sections), as
    tesserae_fused's arguments."""
    rng = np.random.default_rng(20260)
    for batch, qlen, slen, band in cs.SW_SHAPES:
        cs.sw_pairs(rng, batch, qlen, slen, band)
    register = cs.tesserae_sections(rng) + [cs.wide_section(rng)]
    wide = cs.wide_form_sections(rng)
    return ([tt.section_inputs(q, list(t.values()), cs.CALLER_PARAMS, dev) for q, t in register],
            [tt.section_inputs(q, list(t.values()), cs.CALLER_PARAMS, dev) for q, t in wide])


def ablation_cases(dev):
    register, _ = phase3_sections(dev)
    big = register[-2]                                  # the largest recombinant section
    syn_q = "".join(np.random.default_rng(1).choice(list("ACGT"), 2000))
    syn = tt.section_inputs(syn_q, [syn_q[i:i + 63] for i in range(16)], cs.CALLER_PARAMS, dev)
    yield "smoke S=16", big, tt.kernel_config(16, big[1].shape[1] + 1)
    for config in [(4, 1, 256), (1, 16, 64), (16, 2, 32)]:
        yield "synthetic S=16 W=64", syn, config


def bind(lib):
    """Set the argument types of the Tesserae entry points `lib` has."""
    for name, argtypes in _kernels._SIGNATURES.items():
        if name.startswith("ctk_tesserae") and hasattr(lib, name):
            getattr(lib, name).argtypes = list(argtypes)
            getattr(lib, name).restype = ctypes.c_int
    return lib


def ablate_one(index: int) -> None:
    """One variant's timings (run in a process of its own): the register
    form's cases through the entry point, then the wide sections through
    tesserae_fused over the variant's library."""
    name = list(ABLATIONS)[index]
    lib = bind(ctypes.CDLL(os.path.join(OUT, f"tesserae_ablate{index}.so")))
    dev = torch.device("cuda")
    for label, (q, t, valid, (scal, lsm, lsi)), config in ablation_cases(dev):
        l1, (s_count, w1) = q.shape[0], t.shape
        width, cap = w1 + 1, q.shape[0] + w1 + 5
        npad = -(-s_count * width // 16) * 16
        prm = torch.cat([scal, lsm.reshape(-1), lsi]).contiguous()
        vmask = valid.to(torch.uint8).contiguous()
        codes = torch.zeros((l1 + 1, npad), dtype=torch.uint8, device=dev)
        rec = torch.zeros(l1 + 1, dtype=torch.int64, device=dev)
        out = torch.zeros(2 + 3 * cap, dtype=torch.int32, device=dev)

        def run():
            _kernels.check(lib.ctk_tesserae(
                q.data_ptr(), t.data_ptr(), vmask.data_ptr(), prm.data_ptr(), l1, s_count,
                width, *config, codes.data_ptr(), npad, rec.data_ptr(), out.data_ptr(), cap,
                _kernels.stream(dev)), name)
        ms = cs.event_ms(run, 3)
        print(json.dumps({"variant": name, "section": label, "L": l1, "config": list(config),
                          "us_per_column": round(ms * 1e3 / l1, 3)}), flush=True)
    real = _kernels.library
    _kernels.library = lambda: lib
    try:
        for args in phase3_sections(dev)[1]:
            s_count, width = args[1].shape[0], args[1].shape[1] + 1
            row = {"variant": name, "section": f"wide {s_count} x {width}",
                   "L": args[0].shape[0], "config": list(tt.wide_config(s_count, width))}
            if "ABL_EMPTY" in ABLATIONS[name]:
                # without the loop's arrivals the walker's wait never opens:
                # its spin must trap (the launch fails) rather than hang
                t0 = time.perf_counter()
                try:
                    tt.tesserae_fused(*args)
                    torch.cuda.synchronize()
                    row["trapped"] = False
                except (RuntimeError, getattr(torch, "AcceleratorError", RuntimeError)) as exc:
                    row.update(trapped=True, error=str(exc).splitlines()[0],
                               seconds=round(time.perf_counter() - t0, 2))
                print(json.dumps(row), flush=True)
                return
            ms = cs.event_ms(lambda: tt.tesserae_fused(*args), 3)
            print(json.dumps({**row, "us_per_column": round(ms * 1e3 / args[0].shape[0], 3)}),
                  flush=True)
    finally:
        _kernels.library = real


# the wide form's kernel at 4 and 8 cells a thread beside its own 16, each
# under the register cap of its CTAs an SM (3, 4, 6 at 16, 8, 4 cells: 80,
# 64, 40 registers), from csrc/tesserae.cu rewritten to instantiate them
WIDE_CELL_CHOICES = (4, 8, 16)
SHAPE_HOOKS = [
    ("GRID ? kWideBlocks : 1)", "GRID ? (C >= 16 ? kWideBlocks : C >= 8 ? 4 : 6) : 1)"),
    ("  if (cells != kWideCells) return nullptr;\n"
     "  return tesserae_kernel<float, kWideCells, true>;\n",
     "  switch (cells) {\n"
     "    case 4: return tesserae_kernel<float, 4, true>;\n"
     "    case 8: return tesserae_kernel<float, 8, true>;\n"
     "    case 16: return tesserae_kernel<float, 16, true>;\n"
     "    default: return nullptr;\n"
     "  }\n"),
]
WIDE_SHAPES = [(c, k, t) for c in WIDE_CELL_CHOICES for k in (2, 4, 8) for t in (128, 256)]


def ablate_wide() -> None:
    """The wide form at each shape of WIDE_SHAPES on the three wide
    sections, over the library built with SHAPE_HOOKS, each launch's path
    and max_r held against the default shape's (itself held against the
    twin by chip_smoke.py and the cuda tests), with its registers, spills
    and the clusters the card holds."""
    dev = torch.device("cuda")
    lib = bind(ctypes.CDLL(os.path.join(OUT, "tesserae_shapes.so")))
    real = _kernels.library
    _kernels.library = lambda: lib
    tt._WIDE_INFO.clear()
    try:
        for args in phase3_sections(dev)[1]:
            s_count, width = args[1].shape[0], args[1].shape[1] + 1
            want = [x.cpu() for x in tt.tesserae_fused(*args)]
            for per, cluster, threads in WIDE_SHAPES:
                need = -(-(s_count * width) // per)
                clusters = -(-need // (cluster * threads))
                info = tt.wide_kernel_info(dev, per, cluster, threads)
                row = {"probe": "wide shape", "section": f"{s_count} x {width}",
                       "L": args[0].shape[0], "cells_per_thread": per, "clusters": clusters,
                       "ctas_per_cluster": cluster, "threads": threads, **info}
                if clusters > info["max_clusters"]:
                    print(json.dumps({**row, "co_resides": False}), flush=True)
                    continue
                config = (per, clusters, cluster, threads)
                got = [x.cpu() for x in tt.tesserae_fused(*args, config=config, wide=True)]
                n = int(want[2])
                if int(got[2]) != n or not torch.equal(got[1][:n], want[1][:n]) or \
                        got[0].view(torch.int32) != want[0].view(torch.int32):
                    raise AssertionError(f"wide shape {config} disagrees with the default's")
                ms = cs.event_ms(lambda: tt.tesserae_fused(*args, config=config, wide=True), 3)
                print(json.dumps({**row, "co_resides": True, "ms": round(ms, 4),
                                  "us_per_column": round(ms * 1e3 / args[0].shape[0], 3)}),
                      flush=True)
    finally:
        _kernels.library = real
        tt._WIDE_INFO.clear()


def ablate() -> None:
    os.makedirs(OUT, exist_ok=True)
    src = rewritten_source(HOOKS, "tesserae_ablate.cu", ABLATE_SPAN)
    procs = [nvcc_shared(src, os.path.join(OUT, f"tesserae_ablate{i}.so"), defines)
             for i, defines in enumerate(ABLATIONS.values())]
    procs.append(nvcc_shared(rewritten_source(SHAPE_HOOKS, "tesserae_shapes.cu"),
                             os.path.join(OUT, "tesserae_shapes.so")))
    if any(p.wait() for p in procs):
        raise RuntimeError("nvcc failed")
    for index in range(len(ABLATIONS)):
        proc = subprocess.run([sys.executable, __file__, "ablate-one", str(index)])
        if proc.returncode:
            print(json.dumps({"variant": list(ABLATIONS)[index], "failed": proc.returncode}))
    ablate_wide()


def load_tesserae(repo: str):
    """The ops.tesserae_torch module of `repo`'s corticall_tpu_torch; another
    checkout's package is loaded under the name `other_corticall_tpu_torch`,
    with its own kernel library."""
    if os.path.abspath(repo) == REPO:
        return tt
    alias = "other_corticall_tpu_torch"
    pkg_dir = os.path.join(os.path.abspath(repo), "corticall_tpu_torch")
    spec = importlib.util.spec_from_file_location(
        alias, os.path.join(pkg_dir, "__init__.py"), submodule_search_locations=[pkg_dir])
    pkg = importlib.util.module_from_spec(spec)
    sys.modules[alias] = pkg
    spec.loader.exec_module(pkg)
    return importlib.import_module(f"{alias}.ops.tesserae_torch")


def turns(other: str) -> None:
    """This checkout's tesserae_fused and `other`'s, in turns, on the
    phase-3 sections (see the module docstring)."""
    theirs = load_tesserae(other)
    dev = torch.device("cuda")
    register, wide = phase3_sections(dev)
    for mod in (theirs, tt):
        mod.tesserae_fused(*register[0])                # build and load
    for turn, (label, mod) in enumerate([(other, theirs), (".", tt), (".", tt),
                                         (other, theirs)]):
        ms = [cs.event_ms(lambda: mod.tesserae_fused(*args), 3) for args in register]
        wide_ms = [cs.event_ms(lambda: mod.tesserae_fused(*args), 3) for args in wide]
        print(json.dumps({"turn": turn, "repo": label, "sections": len(register),
                          "ms": round(sum(ms), 3), "section_ms": [round(x, 3) for x in ms],
                          "wide_ms": [round(x, 3) for x in wide_ms],
                          "wide_us_per_column": [round(x * 1e3 / a[0].shape[0], 3)
                                                 for x, a in zip(wide_ms, wide)]}),
              flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("tesserae_probe needs a CUDA device")
    what = sys.argv[1] if len(sys.argv) > 1 else ""
    if what == "barriers":
        barriers()
    elif what == "ablate":
        ablate()
    elif what == "ablate-one":
        ablate_one(int(sys.argv[2]))
        return 0
    elif what == "turns":
        turns(sys.argv[2])
    else:
        raise SystemExit(__doc__)
    print(cs.nvidia_smi())
    return 0


if __name__ == "__main__":
    sys.exit(main())
