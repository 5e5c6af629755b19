#!/usr/bin/env python3
"""Times of the banded SW kernel (csrc/sw_banded.cu) on one GPU.

    python3 corticall_tpu_torch/tools/sw_probe.py [--repo DIR] [--sweep]
    python3 corticall_tpu_torch/tools/sw_probe.py --ablate
    python3 corticall_tpu_torch/tools/sw_probe.py --full [--repo DIR]

At the smoke shapes (B=256, Q=4096, S=8192, band 512; B=1024, Q=512,
S=1024, band 64) and the 2 Mbp trio's four pre-score batches (band 512),
each on chip_smoke.sw_pairs' inputs: the mean CUDA-event time of a launch,
the time a query row (ms / Q), and the bytes and operations bound.  --repo
times the package of another checkout (for example the parent commit
unpacked with `git archive`) on the same inputs, so that two versions can
be compared in one call, in turns.  --sweep also times the two smallest
cells a lane that cover each shape (this checkout's kernel only).

--full: sw_full (the full-matrix contract) at FULL_SHAPES instead, in the
form sw_device.sw_full_form picks, beside the bound on the cells the
contract scores (chip_smoke.sw_full_bound_fields: every cell, or the
in-band ones).

--ablate: csrc/sw_banded.cu rebuilt with parts of its row compiled out (the
outputs are then wrong: time only), in microseconds a query row at three
shapes: the warp-shuffle scan, the best-cell tracking, the per-row loads,
the lane-edge shuffles, and all of them.  Builds go to the git-ignored
build/probe/.

JSON lines on stdout, then the card's name and power limit.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

ABLATE_SHAPES = [(1024, 512, 1024, 64), (8, 336, 464, 512), (256, 4096, 8192, 512)]
# variant -> [(text of csrc/sw_banded.cu, its replacement)]
_SCAN = ("""  for (int d = 1; d < 32; d <<= 1) tot = max(tot, __shfl_up_sync(kFull, tot, d));
  const int carry = __shfl_up_sync(kFull, tot, 1);
""", "  const int carry = tot;\n")
_BEST = ("""    if (out > bv[k]) {
      bv[k] = out;
      br[k] = row;
    }
""", "    bv[k] = max(bv[k], out);\n")
_LOADS = ("""      const int qn = i + 1 < qlen ? qb[i + 1] : 4;
      const int cn = code_selector(sb[base_of(i + 1, half, maxbase) + n - 1]);
""", """      const int qn = (qc + 1) & 3;
      const int cn = newcode ^ 1;
""")
_EDGE = [(f"__shfl_{d}_sync(kFull, {x}, 1)", x) for d, x in
         (("down", "h[0]"), ("down", "f[0]"), ("down", "sc[0]"), ("up", "h[C - 1]"))]
ABLATIONS = {"kernel": [], "no scan": [_SCAN], "no best tracking": [_BEST],
             "no per-row loads": [_LOADS], "no lane-edge shuffles": _EDGE,
             "none of these": [_SCAN, _BEST, _LOADS, *_EDGE]}
# (B, Q, S, band) of sw_full: chip_smoke.py's phase 8, and subjects of 2-5 tiles
FULL_SHAPES = [(1024, 512, 1024, None), (1024, 512, 1024, 64), (128, 512, 8192, None),
               (128, 512, 8192, 63), (256, 512, 2048, None), (256, 512, 4500, None)]
SHAPES = [(256, 4096, 8192, 512), (1024, 512, 1024, 64),
          (8, 248, 376, 512), (32, 80, 208, 512), (64, 80, 208, 512),
          (8, 336, 464, 512)]


def ablate(tsw, cs, dev) -> None:
    """Time csrc/sw_banded.cu with parts of the row compiled out."""
    import numpy as np
    import torch
    from corticall_tpu_torch.ops import _kernels

    out_dir = os.path.join(HERE, "build", "probe")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(_kernels.CSRC_DIR, "sw_banded.cu")) as f:
        original = f.read()
    procs, libs = [], []
    for index, edits in enumerate(ABLATIONS.values()):
        src = original
        for old, new in edits:
            if src.count(old) != 1:
                raise RuntimeError(f"sw_banded.cu no longer has {old!r}")
            src = src.replace(old, new)
        path = os.path.join(out_dir, f"sw_ablate{index}.cu")
        with open(path, "w") as f:
            f.write(src)
        libs.append(os.path.join(out_dir, f"sw_ablate{index}.so"))
        procs.append(subprocess.Popen([_kernels._nvcc(), *_kernels.NVCC_FLAGS,
                                       "-shared", "-o", libs[-1], path]))
    if any(p.wait() for p in procs):
        raise RuntimeError("nvcc failed")
    rng = np.random.default_rng(20260)
    cases = []
    for batch, qlen, slen, band in ABLATE_SHAPES:
        q, s = (torch.from_numpy(x).to(dev) for x in cs.sw_pairs(rng, batch, qlen, slen, band))
        cases.append((q, s, band, tsw.sw_kernel_config(qlen, slen, band)))
    stream = _kernels.stream(dev)
    for name, lib_path in zip(ABLATIONS, libs):
        fn = ctypes.CDLL(lib_path).ctk_sw_banded
        fn.argtypes = list(_kernels._SIGNATURES["ctk_sw_banded"])
        fn.restype = ctypes.c_int
        for q, s, band, cells in cases:
            (batch, qlen), slen = q.shape, s.shape[1]
            outs = [torch.empty(batch, dtype=t, device=dev)
                    for t in (torch.float32, torch.int32, torch.int32)]

            def run():
                _kernels.check(fn(q.data_ptr(), s.data_ptr(), batch, qlen, slen, band, cells,
                                  *(o.data_ptr() for o in outs), stream), name)
            ms = cs.event_ms(run, 5)
            print(json.dumps({"variant": name, "batch": batch, "q": qlen, "s": slen,
                              "band": band, "cells_a_lane": cells, "ms": round(ms, 5),
                              "us_a_row": round(ms / qlen * 1e3, 5)}), flush=True)


def full(tsw, cs, dev, repo) -> None:
    """Time sw_full at FULL_SHAPES."""
    import numpy as np
    import torch

    rng = np.random.default_rng(20261)
    for batch, qlen, slen, band in FULL_SHAPES:
        q, s = cs.sw_pairs(rng, batch, qlen, slen, 64)
        qt, st = torch.from_numpy(q).to(dev), torch.from_numpy(s).to(dev)

        def run():
            return tsw.sw_full(qt, st, band)
        cs.sw_diff(run(), tsw.sw_full_scores(qt, st, band), "sw_full")
        ms = cs.event_ms(run, 5)
        form = getattr(tsw, "sw_full_form", None)
        print(json.dumps({"repo": repo, "form": form(band)[0] if form else None,
                          "batch": batch, "q": qlen, "s": slen, "band": band,
                          "ms": round(ms, 5), "us_a_row": round(ms / qlen * 1e3, 5),
                          **cs.sw_full_bound_fields(qt, st, band)}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--repo", default=HERE, help="checkout whose package is timed")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--ablate", action="store_true")
    ap.add_argument("--full", action="store_true")
    args = ap.parse_args()
    repo = os.path.abspath(args.repo)
    sys.modules["jax"] = None
    # the package from `repo`, chip_smoke.py's helpers from this checkout
    sys.path.insert(0, repo)
    import corticall_tpu_torch.ops.sw_device as tsw
    from corticall_tpu_torch.device import require_cuda
    sys.path.insert(0, HERE)

    import numpy as np
    import torch

    import chip_smoke as cs

    dev = require_cuda()
    if args.ablate:
        ablate(tsw, cs, dev)
        print(cs.nvidia_smi(), flush=True)
        return 0
    if args.full:
        full(tsw, cs, dev, os.path.relpath(repo, HERE) if repo != HERE else ".")
        print(cs.nvidia_smi(), flush=True)
        return 0
    rng = np.random.default_rng(20260)
    for batch, qlen, slen, band in SHAPES:
        q, s = cs.sw_pairs(rng, batch, qlen, slen, band)
        qt, st = torch.from_numpy(q).to(dev), torch.from_numpy(s).to(dev)
        want = tsw.banded_sw_scores(qt, st, band)
        reps = 20 if batch * qlen < 100_000 else 5
        forced = [None]
        if args.sweep:
            forced += [c for c in tsw.SW_CELLS if 32 * c >= min(band, slen)][:2]
        for cells in forced:
            run = ((lambda: tsw.sw_banded(qt, st, band)) if cells is None
                   else (lambda: tsw._launch("ctk_sw_banded", qt, st, band, cells)[0]))
            cs.sw_diff(run(), want)
            ms = cs.event_ms(run, reps)
            row = {"repo": os.path.relpath(repo, HERE) if repo != HERE else ".",
                   "batch": batch, "q": qlen, "s": slen, "band": band,
                   "cells_a_lane": cells,
                   "ms": round(ms, 5), "us_a_row": round(ms / qlen * 1e3, 5),
                   **cs.sw_bound_fields(qt, st, band)}
            print(json.dumps(row), flush=True)
    print(cs.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
