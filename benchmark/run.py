"""Run one cell of the benchmark of corticall_tpu_torch once.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell is the entry of BENCHMARK.json's
`workloads` of that name: its configuration (the file BENCHMARK.json names)
and its traffic mix (benchmark/traffic/<traffic>.json), whose `kind` names
the driver (benchmark/traffic/<kind>.py) that makes the inputs from the seed,
sets the program up, serves one request at a time and judges what the
program returned against the plain reference.  Metrics are read by
benchmark/metrics/<metric>.py, one reader a metric (a metric named
`<base>.<part>` without a file of its own by <base>.py): with --trace 0 the
cell's end-to-end metrics, with --trace 1 its per-layer metrics from a
torch.profiler trace of the window.

Set-up (imports, the card, inputs, the program's tables and kernels, warm-up)
is timed from the start of this process; then requests run back to back, one
caller, for --seconds and on to the end of the driver's turn of distinct
requests (its state's `cycle`, 1 where it has none), so that every run
serves whole turns; then the program's state is freed and the reference
judges a sample drawn from the seed.  The last line of standard output is
one JSON object; the numbers compared and their limits end standard error.
Without a CUDA card, or with fewer than the cell asks for, it exits with 3
and prints no result; it never falls back to the CPU.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from collections import Counter  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmark.lib import trace as btrace  # noqa: E402

# top-level module names that must not be loaded: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "corticall_tpu")


@dataclass
class Run:
    """What a metric reader reads."""
    setup_s: float
    window_s: float
    latencies_s: np.ndarray
    counts: dict
    timers: dict = field(default_factory=dict)
    trace: btrace.Trace | None = None


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str):
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def resolve_cell(root: str, workload: str) -> dict:
    """The cell's manifest entry, configuration, traffic mix and driver
    module, found by name from BENCHMARK.json at `root`."""
    manifest = load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    configs = {c["name"]: c for c in manifest["configs"]}
    config = load_json(os.path.join(root, configs[cell["config"]]["file"]))
    mix = load_json(os.path.join(root, "benchmark", "traffic", cell["traffic"] + ".json"))
    driver = load_module(os.path.join(root, "benchmark", "traffic", mix["kind"] + ".py"),
                         f"bench_traffic_{mix['kind']}")
    return {"manifest": manifest, "cell": cell, "config": config, "mix": mix, "driver": driver}


def cell_metrics(manifest: dict, workload: str, traced: bool) -> list:
    """The metric entries a run of the cell reports: end-to-end ones untraced,
    per-layer ones traced; an entry with a `workloads` list only in those."""
    key = "per_layer" if traced else "end_to_end"
    return [m for m in manifest[key] if workload in m.get("workloads", [workload])]


def reader_path(root: str, name: str) -> str:
    """benchmark/metrics/<name>.py, or <base>.py for a `<base>.<part>` name
    that has no file of its own."""
    folder = os.path.join(root, "benchmark", "metrics")
    own = os.path.join(folder, name + ".py")
    return own if os.path.exists(own) else os.path.join(folder, name.split(".")[0] + ".py")


def read_metrics(root: str, entries: list, run: Run) -> dict:
    out = {}
    for m in entries:
        reader = load_module(reader_path(root, m["name"]),
                             "bench_metric_" + m["name"].replace(".", "_").replace("-", "_"))
        value = reader.read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def forbidden_loaded() -> list:
    return sorted({n.split(".")[0] for n in list(sys.modules)
                   if n.split(".")[0] in FORBIDDEN and sys.modules[n] is not None})


def power_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else out.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi: {e}"


def run_cell(root: str, workload: str, seed: int, seconds: float, traced: bool,
             device: str = "cuda", t_start: float | None = None) -> dict:
    """One run of a cell; returns the result object (its `compared` last).
    `device` "cpu" drives the program's CPU route, for the tests."""
    found = resolve_cell(root, workload)
    driver, manifest = found["driver"], found["manifest"]
    dev = torch.device(device)
    state = driver.setup(found["config"], found["mix"], seed, dev, traced)
    setup_s = time.perf_counter() - (T0 if t_start is None else t_start)

    latencies, counts = [], Counter()
    attempted = failed = 0
    gc.collect()
    gc.freeze()                 # set-up's objects out of the collector's way in the window
    prof = btrace.start() if traced else None
    cycle = int(getattr(state, "cycle", 1))
    t_win = time.perf_counter()
    deadline = t_win + seconds
    with torch.profiler.record_function(btrace.WINDOW):
        while time.perf_counter() < deadline or attempted % cycle:
            attempted += 1
            try:
                dt, c = driver.request(state, attempted - 1)
            except Exception:                 # a failed request is counted, and shown once
                if not failed:
                    traceback.print_exc()
                failed += 1
                continue
            latencies.append(dt)
            counts.update(c)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    window_s = time.perf_counter() - t_win
    trace = btrace.finish(prof) if traced else None
    found_forbidden = forbidden_loaded()

    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    driver.release(state)
    t_check = time.perf_counter()
    compared = driver.check(state, dev)
    parts = ", ".join(f"{k} {v:.3f}" for k, v in state.timers.items())
    print(f"benchmark: set-up {setup_s:.3f} s ({parts}), window {window_s:.3f} s, "
          f"{attempted} requests, check {time.perf_counter() - t_check:.3f} s", file=sys.stderr)
    if latencies:
        lat = np.asarray(latencies) * 1e3
        half = len(lat) // 2
        print(f"benchmark: latency ms p50 {np.median(lat):.4f} p95 {np.percentile(lat, 95):.4f} "
              f"mean {lat.mean():.4f} max {lat.max():.4f}; mean of the window's halves "
              f"{lat[:half].mean():.4f} {lat[half:].mean():.4f}", file=sys.stderr)
    print(f"benchmark: counts {json.dumps(dict(counts))}", file=sys.stderr)
    found_forbidden = sorted(set(found_forbidden) | set(forbidden_loaded()))
    if found_forbidden:
        raise RuntimeError(f"forbidden modules loaded: {', '.join(found_forbidden)}")

    run = Run(setup_s, window_s, np.asarray(latencies), dict(counts), state.timers, trace)
    metrics = read_metrics(root, cell_metrics(manifest, workload, traced), run)
    correct = failed == 0 and attempted > 0 and all(v <= lim for v, lim in compared.values())
    result = {"correct": bool(correct), "attempted": attempted, "failed": failed,
              "metrics": metrics,
              "device": {"platform": "gpu" if dev.type == "cuda" else dev.type,
                         "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                                  else "cpu"),
                         "count": int(found["cell"]["chips"]), "memory_peak_bytes": int(peak)}}
    if trace is not None:
        result["device"]["busy_s"] = trace.busy_s
        result["device"]["window_s"] = trace.window_s
        result["breakdown"] = {"device_ops": trace.device_ops(), "idle_gaps": trace.idle_gaps()}
    result["compared"] = {n: {"value": float(v), "limit": float(lim)}
                          for n, (v, lim) in compared.items()}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    torch.set_num_threads(1)            # one process, one host thread for PyTorch's own ops
    cells = {w["name"]: w for w in load_json(os.path.join(ROOT, "BENCHMARK.json"))["workloads"]}
    chips = int(cells[args.workload]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: {args.workload} needs {chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible",
              file=sys.stderr)
        return 3
    print(f"benchmark: {power_line()}; {torch.cuda.get_device_name(0)} x "
          f"{torch.cuda.device_count()}", file=sys.stderr, flush=True)
    result = run_cell(ROOT, args.workload, args.seed, args.seconds, bool(args.trace))
    for name, c in result["compared"].items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
