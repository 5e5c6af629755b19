"""Build and bind the port's CUDA kernels (`corticall_tpu_torch/csrc/*.cu`,
which share the k-mer primitives of `csrc/kmer.cuh`).

At first use nvcc compiles every source to an object, one nvcc process a
source, all started together, and links the objects into one shared library
with a plain C interface, under `build/kernels/` at the repository root, named
by a hash of the sources and flags; ctypes loads it.  Each C entry point
launches on the stream it is given and returns `cudaGetLastError()`; `check`
turns a non-zero code into an exception.  Nothing here is imported or built until a wrapper is
called on a CUDA tensor.

`--fmad=false` is part of the contract: the kernels must round exactly like
their plain PyTorch twins, and a contracted multiply-add rounds once where the
twin rounds twice.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import time

import torch

from ..utils.profiling import span

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-Xcompiler", "-fPIC")

_P, _I, _U, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_longlong
# entry point -> argtypes (every pointer and the stream are c_void_p)
_SIGNATURES = {
    "ctk_sw_banded": (_P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P),
    "ctk_sw_full": (_P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P),
    "ctk_tesserae": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _I, _P, _P, _I, _P),
    "ctk_tesserae_wide": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _I, _P, _P, _P, _I,
                          _P),
    "ctk_tesserae_wide_scratch": (_I,),
    "ctk_tesserae_wide_info": (_I, _I, _I, _P),
    "ctk_tesserae_f64": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _I, _P, _P, _I, _P),
    "ctk_tesserae_f64_info": (_I, _P),
    "ctk_tesserae_delete_term": (_P, _I, _P, _P),
    "ctk_jump_stage0": (_P, _P, _P, _P, _I, _I, _I, _I, _P, _P),
    "ctk_jump_compose": (_P, _P, _I, _I, _I, _P),
    "ctk_jump_walk": (_P, _P, _I, _I, _I, _P, _I, _I, _I, _I, _P, _P, _P),
    "ctk_copy_rows_to_host": (_P, _I, _P, _I, _I, _I, _P),
    "ctk_count_windows": (_P, _L, _L, _L, _I, _I, _P, _P, _P, _P, _I, _U, _P),
    "ctk_count_windows_info": (_I, _P),
    "ctk_segment_reduce": (_P, _P, _P, _I, _I, _P, _P, _P, _P, _P, _I, _U, _P),
    "ctk_ht_lookup": (_P, _I, _I, _P, _I, _P, _I, _I, _I, _P, _P),
    "ctk_spec_walk": (_P, _I, _I, _I, _I, _P, _I, _I, _I, _P, _P, _P, _P),
    "ctk_spec_walk_info": (_P, _I, _I, _P),
    "ctk_link_walk": (_P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _I, _P, _I, _I, _I, _P, _P, _P, _P,
                      _P, _P),
    "ctk_link_step": (_P, _I, _I, _I, _I, _P),
    "ctk_link_kernel_info": (_I, _I, _I, _P, _I, _P),
    "ctk_route": (_P, _I, _I, _I, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P),
    "ctk_shard_answer": (_P, _I, _P, _I, _I, _P, _I, _I, _I, _U, _P, _I, _P),
    "ctk_shard_walk_step": (_P, _I, _I, _I, _P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _I, _P, _P),
}

_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found on PATH, in CUDA_HOME or /usr/local/cuda")
    return path


def sources() -> list:
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources() + sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh"))):
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libcorticall_kernels_{h.hexdigest()[:16]}.so")


def build(ptxas_verbose: bool = False) -> dict:
    """Compile csrc/*.cu unless the library for these sources exists (always
    when `ptxas_verbose`, whose log lists each kernel's registers, shared
    memory and spills).  Returns {"path", "seconds", "log"}; raises with
    nvcc's output when a compile or the link fails."""
    path = library_path()
    if os.path.exists(path) and not ptxas_verbose:
        return {"path": path, "seconds": 0.0, "log": ""}
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    verbose = ("-Xptxas", "-v") if ptxas_verbose else ()
    tag = str(os.getpid())
    t0 = time.perf_counter()
    objs = [os.path.join(BUILD_DIR, f"{os.path.basename(src)}.{tag}.o")
            for src in sources()]
    tmp = f"{path}.{tag}.tmp"
    try:
        procs = []
        for src, obj in zip(sources(), objs):
            cmd = [nvcc, *NVCC_FLAGS, *verbose, "-c", "-o", obj, src]
            procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.STDOUT, text=True)))
        log, failed = [], []
        for cmd, proc in procs:
            out, _ = proc.communicate()
            log.append(out)
            if proc.returncode != 0:
                failed.append(f"{' '.join(cmd)}\n{out}")
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed with code {proc.returncode}:\n"
                               f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, path)
    finally:
        for leftover in (*objs, tmp):
            if os.path.exists(leftover):
                os.remove(leftover)
    return {"path": path, "seconds": time.perf_counter() - t0,
            "log": "".join(log) + proc.stdout + proc.stderr}


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        with span("kernels.build"):
            lib = ctypes.CDLL(build()["path"])
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            lib.ctk_error_string.argtypes = [ctypes.c_int]
            lib.ctk_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def check(err: int, what: str) -> None:
    """Raise when a launch reported a CUDA error."""
    if err:
        msg = library().ctk_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err}: {msg}")


def stream(device: torch.device) -> int:
    """PyTorch's current stream on `device`, as the int ctypes passes on."""
    return torch.cuda.current_stream(device).cuda_stream
