#!/usr/bin/env python3
"""Probes of the Tesserae kernel's column loop on one GPU.

    python3 corticall_tpu_torch/tools/tesserae_probe.py barriers
    python3 corticall_tpu_torch/tools/tesserae_probe.py ablate

barriers: the cost of one iteration of __syncthreads(), cluster.sync()
(release/acquire), a relaxed cluster barrier and a five-step warp-shuffle
scan, at cluster shapes the kernel uses (clock64 cycles and CUDA-event ns).

ablate: csrc/tesserae.cu rebuilt with parts of its column loop compiled out
(the outputs are then wrong: time only), in microseconds a query column, on
the smoke run's largest section and on a synthetic 16 x 64 section, each at
a few (cells a thread, cluster, threads) shapes.  Each variant runs in its
own process, since an ablated kernel may fault.

JSON lines on stdout, then the card's name and power limit.  Builds go to
the git-ignored build/probe/.
"""

import ctypes
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
#include <cooperative_groups.h>
#include <cuda_runtime.h>
namespace cg = cooperative_groups;

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
int launch(int iters, int cluster, int threads, float* out, long long* cycles, cudaStream_t s) {
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

extern "C" int probe_barrier(int mode, int iters, int cluster, int threads, float* out,
                             long long* cycles, cudaStream_t s) {
  switch (mode) {
    case 0: return launch<0>(iters, cluster, threads, out, cycles, s);
    case 1: return launch<1>(iters, cluster, threads, out, cycles, s);
    case 2: return launch<2>(iters, cluster, threads, out, cycles, s);
    case 3: return launch<3>(iters, cluster, threads, out, cycles, s);
    default: return launch<4>(iters, cluster, threads, out, cycles, s);
  }
}
"""

BARRIER_MODES = ["__syncthreads", "cluster.sync", "cluster barrier, relaxed arrive",
                 "5-step shuffle scan", "loop alone"]
BARRIER_SHAPES = [(1, 32), (1, 512), (2, 256), (8, 256), (16, 448)]

# (exact line of csrc/tesserae.cu, replacement): each hook compiles a part of
# the column loop out under its macro
HOOKS = [
    ("  for (int col = 1; col <= L; ++col) {\n",
     "  for (int col = 1; col <= L; ++col) {\n#ifdef ABL_EMPTY\n    if (col > 0) continue;\n#endif\n"),
    ("    const int qc = q[col - 1];\n",
     "#ifdef ABL_NOQ\n    const int qc = col & 3;\n#else\n    const int qc = q[col - 1];\n#endif\n"),
    ("      store_codes<C>(codes + (size_t)col * npad + f0, w);\n",
     "#ifndef ABL_NOSTORE\n      store_codes<C>(codes + (size_t)col * npad + f0, w);\n#endif\n"),
    ("    if (rank == 0 && tid == 0) {\n      const int two_w",
     "#ifndef ABL_NOSTORE\n    if (rank == 0 && tid == 0) {\n#else\n    if (false) {\n#endif\n"
     "      const int two_w"),
    ("    if (warp == 0) {\n      const Seg x",
     "#ifdef ABL_NOEXCH\n    if (false) {\n#else\n    if (warp == 0) {\n#endif\n      const Seg x"),
    ("      if (lane < K) {\n",
     "#ifdef ABL_NOEXCH\n      if (false) {\n#else\n      if (lane < K) {\n#endif\n"),
    ("    int bi = 0x7fffffff;\n",
     "    int bi = 0x7fffffff;\n#ifdef ABL_NOCOMPUTE\n    ncells = 0;\n#endif\n"),
    ("  if (rank == 0 && tid == 0) {\n    const int two_w = 2 * W;\n    const int who",
     "#ifdef ABL_NOTB\n  if (false) {\n#else\n  if (rank == 0 && tid == 0) {\n#endif\n"
     "    const int two_w = 2 * W;\n    const int who"),
    ("__device__ __forceinline__ void cluster_barrier(bool publishes) {\n",
     "__device__ __forceinline__ void cluster_barrier(bool publishes) {\n"
     "#ifdef ABL_NOBAR\n  return;\n#endif\n"),
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


def nvcc_shared(src: str, lib: str, defines=()) -> subprocess.Popen:
    return subprocess.Popen([_kernels._nvcc(), *_kernels.NVCC_FLAGS,
                             *[f"-D{d}" for d in defines], "-shared", "-o", lib, src])


def barriers() -> None:
    os.makedirs(OUT, exist_ok=True)
    src, lib_path = os.path.join(OUT, "barriers.cu"), os.path.join(OUT, "barriers.so")
    with open(src, "w") as f:
        f.write(BARRIERS_CU)
    if nvcc_shared(src, lib_path).wait():
        raise RuntimeError("nvcc failed")
    lib = ctypes.CDLL(lib_path)
    lib.probe_barrier.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 3
    lib.probe_barrier.restype = ctypes.c_int
    out = torch.zeros(1, device="cuda")
    cycles = torch.zeros(1, dtype=torch.int64, device="cuda")
    stream = _kernels.stream(torch.device("cuda"))
    iters = 20000
    for mode, name in enumerate(BARRIER_MODES):
        for cluster, threads in BARRIER_SHAPES:
            def run():
                _kernels.check(lib.probe_barrier(mode, iters, cluster, threads, out.data_ptr(),
                                                 cycles.data_ptr(), stream), name)
            ms = cs.event_ms(run, 3)
            print(json.dumps({"probe": name, "cluster": cluster, "threads": threads,
                              "ns": round(ms * 1e6 / iters, 2),
                              "cycles": round(int(cycles.item()) / iters, 1)}), flush=True)


def ablated_source() -> str:
    with open(os.path.join(_kernels.CSRC_DIR, "tesserae.cu")) as f:
        src = f.read()
    for line, hooked in HOOKS:
        if src.count(line) != 1:
            raise RuntimeError(f"tesserae.cu no longer has the hook line {line!r}")
        src = src.replace(line, hooked)
    path = os.path.join(OUT, "tesserae_ablate.cu")
    with open(path, "w") as f:
        f.write(src)
    return path


def ablation_cases(dev):
    rng = np.random.default_rng(20260)
    for batch, qlen, slen, band in cs.SW_SHAPES:      # the smoke run's stream
        cs.sw_pairs(rng, batch, qlen, slen, band)
    query, targets = cs.tesserae_sections(rng)[-1]
    big = tt.section_inputs(query, list(targets.values()), cs.CALLER_PARAMS, dev)
    syn_q = "".join(np.random.default_rng(1).choice(list("ACGT"), 2000))
    syn = tt.section_inputs(syn_q, [syn_q[i:i + 63] for i in range(16)], cs.CALLER_PARAMS, dev)
    yield "smoke S=16", big, tt.kernel_config(16, big[1].shape[1] + 1)
    for config in [(4, 1, 256), (1, 16, 64), (16, 2, 32)]:
        yield "synthetic S=16 W=64", syn, config


def ablate_one(index: int) -> None:
    """One variant's timings (run in a process of its own)."""
    name = list(ABLATIONS)[index]
    lib = ctypes.CDLL(os.path.join(OUT, f"tesserae_ablate{index}.so"))
    lib.ctk_tesserae.argtypes = list(_kernels._SIGNATURES["ctk_tesserae"])
    lib.ctk_tesserae.restype = ctypes.c_int
    dev = torch.device("cuda")
    for label, (q, t, valid, (scal, lsm, lsi)), config in ablation_cases(dev):
        l1, (s_count, w1) = q.shape[0], t.shape
        width, cap = w1 + 1, q.shape[0] + w1 + 5
        npad = -(-s_count * width // 16) * 16
        prm = torch.cat([scal, lsm.reshape(-1), lsi]).contiguous()
        vmask = valid.to(torch.uint8).contiguous()
        codes = torch.zeros((l1 + 1, npad), dtype=torch.uint8, device=dev)
        rec = torch.zeros(l1 + 1, dtype=torch.int32, device=dev)
        out = torch.zeros(2 + 3 * cap, dtype=torch.int32, device=dev)

        def run():
            _kernels.check(lib.ctk_tesserae(
                q.data_ptr(), t.data_ptr(), vmask.data_ptr(), prm.data_ptr(), l1, s_count,
                width, *config, codes.data_ptr(), npad, rec.data_ptr(), out.data_ptr(), cap,
                _kernels.stream(dev)), name)
        ms = cs.event_ms(run, 3)
        print(json.dumps({"variant": name, "section": label, "L": l1, "config": list(config),
                          "us_per_column": round(ms * 1e3 / l1, 3)}), flush=True)


def ablate() -> None:
    os.makedirs(OUT, exist_ok=True)
    src = ablated_source()
    procs = [nvcc_shared(src, os.path.join(OUT, f"tesserae_ablate{i}.so"), defines)
             for i, defines in enumerate(ABLATIONS.values())]
    if any(p.wait() for p in procs):
        raise RuntimeError("nvcc failed")
    for index in range(len(ABLATIONS)):
        proc = subprocess.run([sys.executable, __file__, "ablate-one", str(index)])
        if proc.returncode:
            print(json.dumps({"variant": list(ABLATIONS)[index], "failed": proc.returncode}))


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
    else:
        raise SystemExit(__doc__)
    print(cs.nvidia_smi())
    return 0


if __name__ == "__main__":
    sys.exit(main())
