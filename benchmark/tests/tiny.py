"""Tiny cells for the CPU tests: the flagship's shapes at a toy scale, in a
copy of the benchmark folder with a BENCHMARK.json of their own."""

from __future__ import annotations

import copy
import json
import os
import shutil

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CONFIG = {"name": "tiny_k47", "k": 47, "genome_mbp": 0.06, "chromosomes": 3,
          "colours": ["child", "mother", "father"], "dnms": 6, "parental_divergence": 0.003,
          "repeat_units": 4, "repeat_copies": 6, "repeat_len": 75, "at_share": 0.806,
          "genome_sequence": "synthetic", "read_coverage": 0,
          "read_error_rate": 0.0, "dnm_mix": [0.5, 0.25, 0.25], "max_indel": 10,
          "max_query": 160}
SECTIONS = {"kind": "sections",
            "record": os.path.join(ROOT, "benchmark", "tests", "tiny_sections.csv"),
            "jitter": 10, "hmm": [0.35, 0.90, 0.0006, 0.001], "check_sections": 4,
            "limits": {"paths_wrong": 0, "llk_gap": 1e-6}}
WALKS = {"kind": "bulk_walks", "seeds_per_call": 512, "max_walk": 300, "batches": 2,
         "check_lanes_per_call": 16, "limits": {"lanes_wrong": 0}}


def config(k: int = 47) -> dict:
    c = copy.deepcopy(CONFIG)
    c["k"], c["name"] = k, f"tiny_k{k}"
    return c


def make_root(tmp: str) -> str:
    """A checkout-like root in `tmp`: the benchmark folder copied, the tiny
    configurations and mixes added, and a BENCHMARK.json of tiny cells."""
    root = os.path.join(tmp, "root")
    shutil.copytree(os.path.join(ROOT, "benchmark"), os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = os.path.join(root, "benchmark")
    for k in (47, 31):
        with open(os.path.join(bench, "configs", f"tiny_k{k}.json"), "w") as f:
            json.dump(config(k), f)
    for name, mix in (("tiny_sections", SECTIONS), ("tiny_walks", WALKS)):
        with open(os.path.join(bench, "traffic", name + ".json"), "w") as f:
            json.dump(mix, f)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        manifest = json.load(f)
    manifest["configs"] = [{"name": f"tiny_k{k}", "source": "tests", "reduced": [],
                            "file": f"benchmark/configs/tiny_k{k}.json", "why": "tests"}
                           for k in (47, 31)]
    manifest["workloads"] = [
        {"name": "tiny_sections", "config": "tiny_k47", "traffic": "tiny_sections", "chips": 1,
         "why": "tests"},
        {"name": "tiny_walks", "config": "tiny_k47", "traffic": "tiny_walks", "chips": 1,
         "why": "tests"},
        {"name": "tiny31_walks", "config": "tiny_k31", "traffic": "tiny_walks", "chips": 1,
         "why": "tests"}]
    for group in ("end_to_end", "per_layer"):
        for m in manifest[group]:
            if "workloads" in m:
                m["workloads"] = [w.replace("pf47_", "tiny_").replace("pf31_", "tiny31_")
                                  for w in m["workloads"]]
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(manifest, f)
    return root
