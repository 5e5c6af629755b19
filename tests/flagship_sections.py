#!/usr/bin/env python3
"""Hold a flagship run's Tesserae sections and calls to the JAX package on the
CPU.

    JAX_PLATFORMS=cpu python3 tests/flagship_sections.py OUT_DIR [--workers N]

OUT_DIR is what corticall_tpu_torch/tools/flagship.py wrote on the card:
sections.json.gz (every section Call aligned, with the path and llk the
port's TesseraeDevice returned) and detail.json (the demo's PF_DUMP).

- A section of up to 63 targets on the device: the JAX package's
  TesseraeDevice on the CPU (XLA) must give the same path, llk within 1e-6
  relative (both float32).
- 64 or more targets: the JAX package's int32 traceback word breaks there, so
  the reference is the port's widened host oracle (models/tesserae.py,
  float64): the same path, llk within 1e-4 relative.
- A section over the budget gate (the exact form on the card or the host
  oracle, where the JAX package runs its host oracle): the JAX package's
  host oracle, path and llk equal.

Then the calls of detail.json against the JAX record DEMO_r05_run3_detail.json:
the calls only one of them has, each with the partitions whose sections
differ.  One JSON line a differing section or call, then a summary line.
"""

import argparse
import gzip
import json
import os
import sys
from concurrent.futures import ProcessPoolExecutor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
RECORD = os.path.join(REPO, "DEMO_r05_run3_detail.json")
CALLER_PARAMS = (0.35, 0.90, 6e-4, 1e-3)     # the Caller's del_, eps, rho, term


def check(section: dict) -> dict:
    """The section's reference path and llk against the port's."""
    from corticall_tpu.models import tesserae as tz
    from corticall_tpu.ops import tesserae_jax as tj
    from corticall_tpu_torch.models import tesserae as ptz

    targets = dict(zip(section["names"], section["targets"]))
    if section["route"] in ("exact", "host"):
        ref, tol, what = tz.Tesserae(*CALLER_PARAMS), 0.0, "jax_host_oracle"
    elif len(targets) <= ptz.INT32_TARGETS:
        ref, tol, what = tj.TesseraeDevice(*CALLER_PARAMS), 1e-6, "jax_device_cpu"
    else:
        ref, tol, what = ptz.Tesserae(*CALLER_PARAMS), 1e-4, "widened_oracle"

    def norm(path):
        return [[seg[0], seg[1], list(seg[2])] for seg in path]
    same_path = norm(ref.align(section["query"], targets)) == norm(section["path"])
    llk_ok = abs(section["llk"] - ref.llk) <= tol * abs(ref.llk)
    return {"partition": section["partition"], "partition_name": section["partition_name"],
            "targets": len(targets), "cells": section["cells"], "route": section["route"],
            "reference": what, "same_path": same_path, "llk_ok": llk_ok,
            "llk": section["llk"], "reference_llk": ref.llk}


def calls_key(call: dict) -> tuple:
    return (call["chrom"], call["pos"], tuple(call["alleles"]), call.get("background"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("out_dir")
    ap.add_argument("--workers", type=int, default=4)
    args = ap.parse_args()
    with gzip.open(os.path.join(args.out_dir, "sections.json.gz"), "rt") as f:
        sections = json.load(f)
    with ProcessPoolExecutor(args.workers) as pool:
        results = list(pool.map(check, sections, chunksize=1))
    differ = [r for r in results if not (r["same_path"] and r["llk_ok"])]
    for r in differ:
        print(json.dumps({"section_differs": r}))
    bad_partitions = sorted({r["partition_name"] for r in differ})

    with open(os.path.join(args.out_dir, "detail.json")) as f:
        ours = json.load(f)["calls"]
    with open(RECORD) as f:
        record = json.load(f)["calls"]
    mine, theirs = {calls_key(c) for c in ours}, {calls_key(c) for c in record}
    for c in ours:
        if calls_key(c) not in theirs:
            print(json.dumps({"call_only_in_port": c}))
    for c in record:
        if calls_key(c) not in mine:
            print(json.dumps({"call_only_in_record": c}))
    by_ref = {}
    for r in results:
        by_ref[r["reference"]] = by_ref.get(r["reference"], 0) + 1
    print(json.dumps({
        "sections": len(results), "by_reference": by_ref, "sections_differ": len(differ),
        "partitions_with_differing_sections": bad_partitions,
        "calls": len(ours), "record_calls": len(record),
        "calls_only_in_port": len(mine - theirs), "calls_only_in_record": len(theirs - mine)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
