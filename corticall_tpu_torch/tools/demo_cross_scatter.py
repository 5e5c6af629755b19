#!/usr/bin/env python3
"""The cross on the port: N progeny over parent graphs built once.

    python3 corticall_tpu_torch/tools/demo_cross_scatter.py [--device cpu]

The counterpart of tools/demo_cross_scatter.py (the reference's production
unit, ProcessPfCross.wdl:41-209): corticall_tpu_torch.pipeline
.run_cross_pipeline over demo.make_cross's parents at P. falciparum-like
scale, every progeny sample through the full pipeline on `--device`
(default: the CUDA card; cpu runs the kernels' plain twins).  Prints one
JSON line with the same keys as the JAX package's tool: the shared and
per-child seconds, each sample's calls and its recovery of its own truth.

Env: CS_MBP (default 2), CS_CHROMS (2), CS_PROGENY (4), CS_DNMS (6 a child),
CS_K (47), CS_COVERAGE (20), CS_WORKDIR (default: a new directory under the
system's temporary directory).
"""
import argparse
import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import numpy as np  # noqa: E402

from corticall_tpu_torch import simulate as sim  # noqa: E402
from corticall_tpu_torch.demo import evaluate, make_cross  # noqa: E402
from corticall_tpu_torch.models.reference_index import IndexedReference  # noqa: E402
from corticall_tpu_torch.pipeline import run_cross_pipeline  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="the kernels' device (default: the CUDA card)")
    args = ap.parse_args(argv)
    mbp = float(os.environ.get("CS_MBP", "2"))
    n_chroms = int(os.environ.get("CS_CHROMS", "2"))
    n_prog = int(os.environ.get("CS_PROGENY", "4"))
    n_dnms = int(os.environ.get("CS_DNMS", "6"))
    k = int(os.environ.get("CS_K", "47"))
    coverage = float(os.environ.get("CS_COVERAGE", "20"))
    workdir = os.environ.get("CS_WORKDIR") or tempfile.mkdtemp(prefix="cross_scatter_")

    rng = np.random.default_rng(42)
    mom, dad = make_cross(rng, mbp, n_chroms, 0.003)
    progeny_reads, truths, recombs = {}, {}, {}
    for i in range(n_prog):
        res = sim.simulate_haploid_child(
            mom, dad, parents=("mom", "dad"), mu=2.0,
            num_variants=n_dnms, k=k, seed=100 + i)
        name = f"kid{i}"
        truths[name] = res["truth_vcf"]
        recombs[name] = res.get("recombs")
        progeny_reads[name] = sim.simulate_reads(
            list(res["child"].values()), coverage, 150, 0.002, seed=200 + i)
    parent_reads = {
        "mom": sim.simulate_reads(list(mom.values()), coverage, 150, 0.002,
                                  seed=301),
        "dad": sim.simulate_reads(list(dad.values()), coverage, 150, 0.002,
                                  seed=302),
    }
    refs = {"mom": IndexedReference(mom), "dad": IndexedReference(dad)}

    out = run_cross_pipeline(workdir, parent_reads, progeny_reads,
                             ["mom", "dad"], references=refs, k=k,
                             min_coverage=2, max_walk=2000, device=args.device,
                             log=lambda *a: print(*a, file=sys.stderr))

    samples = {}
    for name, res in out["per_sample"].items():
        ev = evaluate(res["variants"], truths[name], mom, dad, k,
                      recombs=recombs[name])
        samples[name] = {
            "wallclock_s": res["wallclock_s"],
            "rois": res["rois"].num_records,
            "partitions": len(res["partitions"]),
            "calls": len(res["variants"]),
            "calls_after_fdr_filter": len(res.get("filtered_variants") or []),
            "injected": len(truths[name]),
            "strict_recovered": ev["strict_recovered"],
            "kmer_venn": ev["kmer_venn"],
        }

    per_child_total = sum(s["wallclock_s"] for s in samples.values())
    print(json.dumps({
        "metric": "cross_scatter_shared_parents",
        "genome_mbp": mbp, "k": k, "progeny": n_prog,
        "coverage": coverage,
        "shared_parent_build_s": out["shared_parent_build_s"],
        "per_child_total_s": round(per_child_total, 2),
        "total_s": out["total_s"],
        "reuse_saving_s": round(out["shared_parent_build_s"] * (n_prog - 1),
                                2),
        "note": ("parents built once and reused by every child; without the "
                 "scatter each child would pay the shared_parent_build_s "
                 "again (reuse_saving_s = (N-1) x shared build)"),
        "samples": samples,
    }))


if __name__ == "__main__":
    main()
