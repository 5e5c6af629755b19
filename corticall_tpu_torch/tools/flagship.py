#!/usr/bin/env python3
"""The flagship P. falciparum trio through the port's demo on one GPU, with
what Call sent to Tesserae recorded.

    python3 corticall_tpu_torch/tools/flagship.py OUT_DIR

Runs corticall_tpu_torch.demo.main, the demo that `python -m
corticall_tpu_torch.demo` runs, with its PF_* environment (the defaults: 21
Mbp, 14 chromosomes, 40 DNMs, k = 47, reads mode) and PF_DUMP defaulting to
OUT_DIR/detail.json, and writes into OUT_DIR:

- result.json: the demo's JSON line, the card's name and power limit, the
  pipeline's Call statistics (call_breakdown, the Tesserae section counts),
  Partition's route, the kernels' launches (ctk_sw_banded, ctk_tesserae and
  its wide form), every Tesserae section's targets, cells, route (the
  register form, the wide form or the host oracle) and seconds, and the
  host's peak memory;
- sections.json.gz: every section as Call built it (partition index and
  name, query, target names and sequences) with the path and llk the port
  returned, for holding the port to the JAX package's TesseraeDevice (up
  to 63 targets) or to the widened host oracle (64 or more) on the CPU;
- pipeline.log: the pipeline's progress lines.

Needs a CUDA device, and imports neither jax nor the JAX package.
"""

import contextlib
import gzip
import io
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, REPO)
sys.modules["jax"] = None
sys.modules["corticall_tpu"] = None

import torch  # noqa: E402

from corticall_tpu_torch import demo, pipeline  # noqa: E402
from corticall_tpu_torch.caller.call import Caller  # noqa: E402
from corticall_tpu_torch.device import require_cuda  # noqa: E402
from corticall_tpu_torch.ops import sw_device as tsw  # noqa: E402
from corticall_tpu_torch.ops import tesserae_torch as tt  # noqa: E402
from corticall_tpu_torch.utils.progress import peak_memory_mb  # noqa: E402


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def section_route(query: str, seqs: list, budget: int) -> str:
    """"host" (the budget gate's numpy oracle), "wide" or "register"."""
    if tt.section_bytes(len(query), [len(t) for t in seqs]) > budget:
        return "host"
    return "wide" if tt.launch_config(len(seqs), max(map(len, seqs)) + 1)[0] else "register"


@contextlib.contextmanager
def recorded(sections: list, runs: list):
    """Record every TesseraeDevice section (with the partition Call was on)
    and run_pipeline's result while the demo runs."""
    align, load_walk, run_pipeline = (tt.TesseraeDevice.align, Caller.load_child_walk,
                                      pipeline.run_pipeline)
    partition = {"index": -1, "name": None}

    def load_walk_recorded(self, seq):
        partition["index"] += 1
        rseqs = [(h, s) for h, s in self.partitions
                 if self.partition_names is None or h.split(" ")[0] in self.partition_names]
        partition["name"] = rseqs[partition["index"]][0].split(" ")[0]
        return load_walk(self, seq)

    def align_recorded(self, query, targets):
        seqs = list(targets.values())
        route = section_route(query, seqs, self.HBM_BUDGET_BYTES)
        if route != "host":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = align(self, query, targets)
        torch.cuda.synchronize()
        sections.append({
            "partition": partition["index"], "partition_name": partition["name"],
            "query": query, "names": list(targets), "targets": seqs,
            "route": route, "cells": len(seqs) * (max(map(len, seqs)) + 1),
            "seconds": time.perf_counter() - t0, "llk": self.llk,
            "path": [list(seg) for seg in path]})
        return path

    def run_pipeline_recorded(*args, **kwargs):
        runs.append(run_pipeline(*args, **kwargs))
        return runs[-1]

    tt.TesseraeDevice.align = align_recorded
    Caller.load_child_walk = load_walk_recorded
    pipeline.run_pipeline = run_pipeline_recorded
    try:
        yield
    finally:
        tt.TesseraeDevice.align = align
        Caller.load_child_walk = load_walk
        pipeline.run_pipeline = run_pipeline


def main() -> int:
    if len(sys.argv) != 2:
        raise SystemExit(__doc__)
    out_dir = os.path.abspath(sys.argv[1])
    os.makedirs(out_dir, exist_ok=True)
    dev = require_cuda()
    smi = nvidia_smi()
    os.environ.setdefault("PF_DUMP", os.path.join(out_dir, "detail.json"))
    sections, runs = [], []
    tsw.LAUNCHES = tt.LAUNCHES = tt.WIDE_LAUNCHES = 0
    line = io.StringIO()
    t0 = time.perf_counter()
    with open(os.path.join(out_dir, "pipeline.log"), "w") as logf, \
            contextlib.redirect_stderr(logf), recorded(sections, runs), \
            contextlib.redirect_stdout(line):
        demo.main(device=dev)
    wall_s = time.perf_counter() - t0
    out = json.loads(line.getvalue().strip().splitlines()[-1])
    launches = {"sw_banded": tsw.LAUNCHES, "tesserae": tt.LAUNCHES,
                "tesserae_wide": tt.WIDE_LAUNCHES}
    stats = runs[-1]["stats"]
    by_route = {}
    for s in sections:
        r = by_route.setdefault(s["route"], {"sections": 0, "seconds": 0.0})
        r["sections"] += 1
        r["seconds"] += s["seconds"]
    largest = max(sections, key=lambda s: (len(s["names"]), s["cells"]), default=None)
    widest = max(sections, key=lambda s: s["cells"], default=None)
    result = {
        "demo": out, "nvidia_smi": smi, "device": torch.cuda.get_device_name(0),
        "wall_s": wall_s, "peak_host_memory_mb": peak_memory_mb(),
        "call": stats.get("call", {}), "partition": stats.get("partition", {}),
        "launches": launches, "sections_by_route": by_route,
        "largest_section": largest and {k: largest[k] for k in ("partition", "route", "cells")}
        | {"targets": len(largest["names"]), "query": len(largest["query"])},
        "widest_section": widest and {k: widest[k] for k in ("partition", "route", "cells")}
        | {"targets": len(widest["names"]), "query": len(widest["query"])},
        "sections_over_63_targets": sum(len(s["names"]) > 63 for s in sections),
        "sections_over_register_cells": sum(s["cells"] > tt.MAX_CELLS for s in sections),
        "sections": [{k: s[k] for k in ("partition", "route", "cells", "seconds")}
                     | {"targets": len(s["names"]), "query": len(s["query"])}
                     for s in sections],
    }
    with open(os.path.join(out_dir, "result.json"), "w") as f:
        json.dump(result, f, indent=1, default=str)
    with gzip.open(os.path.join(out_dir, "sections.json.gz"), "wt") as f:
        json.dump(sections, f)
    print(json.dumps(out))
    print(json.dumps({k: result[k] for k in ("launches", "sections_by_route", "largest_section",
                                              "widest_section", "sections_over_63_targets",
                                              "sections_over_register_cells", "wall_s",
                                              "peak_host_memory_mb")}, default=str))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
