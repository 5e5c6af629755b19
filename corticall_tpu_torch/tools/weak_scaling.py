#!/usr/bin/env python3
"""Weak-scaling sweep of the sharded walk across processes, the twin of the
JAX package's tools/weak_scaling.py.

    python3 corticall_tpu_torch/tools/weak_scaling.py OUT.json [--device cpu]
        [--shards 1,2,4,8] [--bases-per-shard 200000] [--batch-per-shard 4096]
        [--steps 256] [--repeats 3]

The genome and the walk batch per shard stay fixed (k = 31, seed 42: a
random genome of bases-per-shard x n bases, batch-per-shard x n seeds drawn
from it) while the mesh grows over the given shard counts.  Each point is a
fresh process group of n ranks with one shard each
(dryrun_multihost.run_workers): every rank loads its byte range of the
point's .ctx, sends its records to their owners, walks its block of the
seeds once, then `repeats` times timed.  A point's rate is the group's walk
steps over the slowest rank's seconds; efficiency is a point's steps/s a
shard over the one-shard point's.  Writes the JSON to OUT.json and prints
each row.

Without --device cpu every rank runs on the cards (rank r on card r mod the
card count).  Every point takes the backend of the largest
(mesh.choose_backend), so that the points differ only in their ranks: on
one card that is gloo, the exchange staged through pinned host buffers, and
the sweep measures the exchange's overhead as the group grows, not an
interconnect.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, HERE)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from corticall_tpu_torch.tools import dryrun_multihost as dm  # noqa: E402

K = 31


def point(n: int, args, backend: str, workdir: str) -> dict:
    """One point of the sweep: n ranks, one shard each."""
    from corticall_tpu_torch import fixtures, kmer as km
    from corticall_tpu_torch.io import ctx as ctxio

    rng = np.random.default_rng(42)
    genome = "".join(rng.choice(list("ACGT"), args.bases_per_shard * n))
    g = fixtures.build_graph({"kid": [genome]}, K)
    ctx_path = os.path.join(workdir, f"ws_{n}.ctx")
    ctxio.write_ctx(ctx_path, g.data)
    b = args.batch_per_shard * n
    starts = rng.integers(0, len(genome) - K, size=b)
    seeds_path = os.path.join(workdir, f"ws_{n}_seeds.npy")
    seeds = [genome[i:i + K] for i in starts]
    np.save(seeds_path, km.pack_codes(km.strings_to_codes(seeds), K))
    spec = {"ctx": ctx_path, "links": [], "shards": n,
            "walk": {"seeds": seeds_path, "colors": [0], "steps": args.steps,
                     "repeats": args.repeats},
            "backend": backend, "out": os.path.join(workdir, f"ws_{n}.npz")}
    workers = dm.run_workers(spec, n, args.device, workdir)
    steps = sum(w["walk_repeat_steps"] for w in workers)
    seconds = max(w["seconds"]["walk_repeats"] for w in workers)
    return {"shards": n, "processes": n, "backend": workers[0]["backend"],
            "devices": sorted({w["device"] for w in workers}), "records": g.num_records,
            "batch": b, "max_steps": args.steps, "repeats": args.repeats,
            "walk_steps": steps, "walk_s": round(seconds, 4),
            "steps_per_s": round(steps / seconds),
            "steps_per_s_per_shard": round(steps / seconds / n),
            "exchange_bytes_per_rank": [w["walk_exchange_bytes"] for w in workers],
            "launches": {name: sum(w["launches"][name] for w in workers)
                         for name in workers[0]["launches"]}}


def sweep(args) -> dict:
    from corticall_tpu_torch.parallel import mesh as pm

    backend = pm.choose_backend(args.device, max(args.shards))
    rows = []
    with tempfile.TemporaryDirectory(prefix="weak_scaling_") as wd:
        for n in args.shards:
            row = point(n, args, backend, wd)
            rows.append(row)
            print(json.dumps(row), flush=True)
    base = rows[0]["steps_per_s_per_shard"]
    for row in rows:
        row["efficiency"] = round(row["steps_per_s_per_shard"] / base, 3)
    out = {"metric": "sharded_walk_weak_scaling_across_processes",
           "device": args.device, "backend": backend,
           "host_cpus": os.cpu_count(),
           "per_shard": {"bases": args.bases_per_shard, "batch": args.batch_per_shard,
                         "steps": args.steps},
           "rows": rows}
    if args.device == "cuda":
        out["card"] = torch.cuda.get_device_name(0)
        out["cards"] = torch.cuda.device_count()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("out", help="where the JSON goes")
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda")
    ap.add_argument("--shards", type=lambda v: [int(x) for x in v.split(",")],
                    default=[1, 2, 4, 8])
    ap.add_argument("--bases-per-shard", type=int, default=200_000)
    ap.add_argument("--batch-per-shard", type=int, default=4096)
    ap.add_argument("--steps", type=int, default=256)
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args(argv)
    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("weak_scaling: no CUDA device; pass --device cpu")
        from corticall_tpu_torch.ops import _kernels
        _kernels.build()               # once, before the workers load it
    out = sweep(args)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({"wrote": args.out, "efficiency": [r["efficiency"] for r in out["rows"]]}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
