"""The traced window: torch.profiler around the benchmark's own calls, read
back from its Chrome trace.

`Trace` holds the device operations (kernels, copies, fills) that ran inside
the window, which the benchmark marks with the annotation `bench.window`, and
the host operations beside them.  It gives the union of device activity
(`busy_s`), time by operation name, and the idle gaps with what the host was
doing in each.  The trace file is written to the temporary directory and
deleted once read.
"""

from __future__ import annotations

import json
import os
import tempfile
from collections import defaultdict

import numpy as np
import torch

WINDOW = "bench.window"
DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
HOST_CATS = {"cpu_op", "cuda_runtime", "cuda_driver"}


def start():
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    return prof


def finish(prof) -> "Trace":
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.stop()
    fd, path = tempfile.mkstemp(suffix=".json", prefix="bench_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return Trace(events)


class Trace:
    def __init__(self, events: list):
        spans = [e for e in events if e.get("ph") == "X" and "dur" in e]
        win = [e for e in spans if e.get("name") == WINDOW and e.get("cat") == "user_annotation"]
        if not win:
            raise RuntimeError(f"the trace holds no {WINDOW} annotation")
        self.t0 = float(win[0]["ts"])
        self.t1 = self.t0 + float(win[0]["dur"])
        self.window_s = (self.t1 - self.t0) * 1e-6

        def inside(e):
            return float(e["ts"]) < self.t1 and float(e["ts"]) + float(e["dur"]) > self.t0

        self.device = [(e["name"], e["cat"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                       for e in spans if e.get("cat") in DEVICE_CATS and inside(e)]
        self.host = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
                           for e in spans if e.get("cat") in HOST_CATS and inside(e))
        ivs = sorted((max(a, self.t0), min(b, self.t1)) for _, _, a, b in self.device)
        merged = []
        for a, b in ivs:
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        self.busy = merged
        self.busy_s = sum(b - a for a, b in merged) * 1e-6

    def seconds(self, match) -> float:
        """Summed seconds of the device operations whose name satisfies
        `match` (a predicate)."""
        return sum(b - a for name, _, a, b in self.device if match(name)) * 1e-6

    def device_ops(self, top: int = 10) -> list:
        by = defaultdict(float)
        for name, _, a, b in self.device:
            by[name] += (b - a) * 1e-6
        return sorted(([n, s] for n, s in by.items()), key=lambda x: -x[1])[:top]

    def idle_gaps(self, top: int = 10) -> list:
        """Idle time between device operations inside the window, by the
        innermost host operation under each gap's midpoint ("host:python"
        where none is)."""
        edges = [self.t0] + [x for iv in self.busy for x in iv] + [self.t1]
        starts = np.array([h[0] for h in self.host])
        by = defaultdict(float)
        for a, b in zip(edges[0::2], edges[1::2]):
            if b <= a:
                continue
            mid = 0.5 * (a + b)
            name, best = "host:python", None
            i = int(np.searchsorted(starts, mid, side="right"))
            for s, e, n in reversed(self.host[max(0, i - 256):i]):
                if e >= mid and (best is None or e - s < best):
                    name, best = n, e - s
            by[name] += (b - a) * 1e-6
        return sorted(([n, s] for n, s in by.items()), key=lambda x: -x[1])[:top]
