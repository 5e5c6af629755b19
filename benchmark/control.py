"""The control of a cell: the numbers a run compares, with the program
replaced by the plain reference made wrong the way a later change might make
it (benchmark/traffic/<kind>.py `control`): Tesserae in bfloat16 for the
configuration's float32, walks that go on through junctions.  A limit is
set between the program's readings over a dozen seeds and the smallest of
the control's.

    python3 benchmark/control.py --workload <name> --seeds <n> [<n> ...] [--calls N]

prints one JSON line a seed.  `--calls` is the number of requests whose
answers a run keeps (a run's `attempted`).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402

from benchmark import run  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--calls", type=int, default=2000)
    args = ap.parse_args(argv)
    found = run.resolve_cell(ROOT, args.workload)
    dev = torch.device("cuda")
    for seed in args.seeds:
        t0 = time.perf_counter()
        readings = found["driver"].control(found["config"], found["mix"], seed, dev, args.calls)
        print(json.dumps({"workload": args.workload, "seed": seed, "control": readings,
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
