#!/usr/bin/env python3
"""The hash-sharded graph across processes (torch.distributed): a launcher
and N workers, the twin of the JAX package's tools/dryrun_multihost.py.

    python3 corticall_tpu_torch/tools/dryrun_multihost.py [--processes 2]
        [--shards 8] [--device cpu]

The launcher builds the JAX dry run's fixture (seed 77, k = 17: a 6,000-base
genome, the child with a 60-base repeat inserted twice and a 10-base tail,
its links threaded from two 1,100-base stretches), writes it as a .ctx and
a .ctp.bgz, computes the oracles (the host numpy walker's contigs of 64
seeds x 256 steps, FindROIs, LinkedWalker's linked contigs of the ROI
k-mers) and spawns the workers.  Each worker joins a process group
(tcp://localhost, nccl when every rank has a card of its own, gloo
otherwise), builds a ShardMesh across the processes (the global shards in
equal blocks, this rank's on its device), loads only its byte range of the
.ctx and sends each record to its owner (ShardedGraph.from_ctx_range),
holds each owned shard against ShardedGraph.from_graph's on the whole file,
and runs FindROIs, the seeds' contigs (sharded_assemble) and the ROI
k-mers' linked contigs (sharded_assemble_links) over the global mesh, each
rank walking its block of every batch and all-gathering the streams.  Rank
0 writes the outputs; the launcher checks them against the oracles.
Prints one JSON line.

`--device cpu` runs every worker on the CPU (gloo); without it the workers
run on the cards (rank r on card r mod the card count; two ranks on one
card take gloo, as NCCL cannot put two ranks on one device).  A worker's
failure or timeout fails the run.  `run_workers` and `gather` serve any
spec: its raw runs (`walk`, `linked`: packed seeds in a .npy, each rank its
block, the streams all-gathered) serve chip_smoke.py's cross-process phase
on the 2 Mbp trio and tools/weak_scaling.py.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, HERE)

import numpy as np  # noqa: E402
import torch  # noqa: E402

K = 17
NUM_STEPS = 256
SEED_COUNT = 64
WORKER_TIMEOUT_S = 300


# ---------------------------------------------------------------------------
# the launcher's side
# ---------------------------------------------------------------------------

def fixture(workdir: str, shards: int, device) -> tuple:
    """tools/dryrun_multihost.py's fixture and oracles in the port: (the
    workers' spec, the oracles)."""
    from corticall_tpu_torch import fixtures, kmer as km
    from corticall_tpu_torch.commands import core
    from corticall_tpu_torch.io import ctx as ctxio, links as lkio
    from corticall_tpu_torch.ops import walk_np as wnp
    from corticall_tpu_torch.ops.walk_links import LinkedWalker

    rng = np.random.default_rng(77)
    genome = "".join(rng.choice(list("ACGT"), 6000))
    rep = "".join(rng.choice(list("ACGT"), 60))
    child = (genome[:2000] + rep + genome[2000:4000] + rep + genome[4000:]
             + "TGACGTAGGC")
    g = fixtures.build_graph({"kid": [child], "mom": [genome], "dad": [genome]}, K)
    ctx_path = os.path.join(workdir, "mh_graph.ctx")
    ctxio.write_ctx(ctx_path, g.data)
    links = lkio.build_links(g, {"kid": [child[1500:2600], child[3500:4600]]}, "kid")
    links_path = os.path.join(workdir, "mh_links.ctp.bgz")
    lkio.write_links_indexed(links_path, links, source="kid")

    starts = rng.integers(0, len(child) - K, size=SEED_COUNT)
    seeds = [child[i:i + K] for i in starts]
    rc = [km.revcomp(s) for s in seeds]
    bases, cycled, _ = wnp.walk_forward_np(g, [0], km.strings_to_codes(seeds), NUM_STEPS)
    rbases, rcycled, _ = wnp.walk_forward_np(g, [0], km.strings_to_codes(rc), NUM_STEPS)
    contigs = {}
    for i, s in enumerate(seeds):
        fwd = wnp.replay_walk(s, bases.T[i], bool(cycled[i]), NUM_STEPS)
        back = wnp.replay_walk(rc[i], rbases.T[i], bool(rcycled[i]), NUM_STEPS)
        contigs[s] = (km.revcomp(back) if back else "") + s + fwd
    rois = core.find_rois(g, "kid", ["mom", "dad"])
    roi_strs = sorted(rois.kmer_string(i) for i in range(rois.num_records))
    lw = LinkedWalker(g, [0], [links], device=device)
    linked, _, ljn = lw.assemble(roi_strs, num_steps=NUM_STEPS)
    oracles = {"contigs": contigs, "rois": roi_strs, "linked": dict(zip(roi_strs, linked)),
               "linked_junctions": int(ljn.sum()), "seeds": seeds}

    spec = {"ctx": ctx_path, "links": [links_path], "shards": shards,
            "assemble": {"seeds": seeds, "rois": roi_strs, "colors": [0], "steps": NUM_STEPS},
            "rois": {"child": 0, "parents": [1, 2]},
            "check_shards": True, "out": os.path.join(workdir, "mh_result.npz")}
    return spec, oracles


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


# the command that starts a worker; run_workers appends its arguments
WORKER_COMMAND = [sys.executable, "-u", os.path.abspath(__file__)]


def run_workers(spec: dict, processes: int, device: str, workdir: str,
                timeout: float = WORKER_TIMEOUT_S) -> list:
    """Write `spec` and run `processes` workers over it on `device` ("cpu"
    or "cuda"), their output in files under `workdir`; each worker's JSON
    line, in rank order.  A worker that exits with an error, or workers
    that outlive `timeout` seconds, fail the run at once: every worker is
    stopped and RuntimeError names the failure, with the worker's error
    output."""
    spec = {**spec, "device": device}
    tag = f"{os.getpid()}_{time.monotonic_ns()}"
    spec_path = os.path.join(workdir, f"mh_spec_{tag}.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    port = free_port()
    logs = [(os.path.join(workdir, f"mh_worker{rank}_{tag}.out"),
             os.path.join(workdir, f"mh_worker{rank}_{tag}.err")) for rank in range(processes)]
    procs = []
    try:
        for rank, (out_path, err_path) in enumerate(logs):
            with open(out_path, "w") as fo, open(err_path, "w") as fe:
                procs.append(subprocess.Popen(
                    [*WORKER_COMMAND, "worker", str(rank), str(processes), str(port),
                     spec_path], stdout=fo, stderr=fe, cwd=HERE))
        deadline = time.monotonic() + timeout
        failure = None
        while failure is None:
            codes = [p.poll() for p in procs]
            bad = [rank for rank, rc in enumerate(codes) if rc not in (None, 0)]
            if bad:
                with open(logs[bad[0]][1]) as f:
                    failure = (f"worker {bad[0]} failed (exit {codes[bad[0]]}):\n"
                               f"{f.read()[-4000:]}")
            elif all(rc == 0 for rc in codes):
                break
            elif time.monotonic() > deadline:
                failure = f"the workers did not finish within {timeout:.0f} s"
            else:
                time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    if failure:
        raise RuntimeError(failure)
    results = []
    for out_path, _ in logs:
        with open(out_path) as f:
            results.append(json.loads(f.read().strip().splitlines()[-1]))
    return results


def gather(spec: dict) -> dict:
    """Rank 0's all-gathered outputs (numpy arrays by name)."""
    with np.load(spec["out"]) as z:
        return {name: z[name] for name in z.files}


def assembled(spec: dict) -> dict:
    """Rank 0's assembled contigs (spec["assemble"])."""
    with open(spec["out"] + ".json") as f:
        return json.load(f)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def decode(out: dict, assembled: dict, oracles: dict) -> dict:
    """The workers' contigs, ROI k-mers and linked contigs, each against
    its oracle (as the JAX dry run checks them)."""
    from corticall_tpu_torch import kmer as km

    check(assembled["contigs"] == oracles["contigs"],
          "the sharded contigs differ from the host walker's")
    roi_strs = oracles["rois"]
    got_rois = sorted(km.words_row_to_string(row, K) for row in out["roi_kmers"].view(np.uint32))
    check(got_rois == roi_strs and int(out["roi_total"]) == len(roi_strs),
          "sharded FindROIs differs from FindROIs")
    check(not assembled["linked_overflow"], "link-store overflow in the dry run's fixture")
    check(assembled["linked"] == oracles["linked"],
          "the sharded linked contigs differ from LinkedWalker's")
    check(assembled["linked_junctions"] == oracles["linked_junctions"],
          "the linked walks' junctions differ")
    return {"contigs": assembled["contigs"], "rois": got_rois, "linked": assembled["linked"],
            "junctions": assembled["linked_junctions"]}


def dryrun(processes: int, shards: int, device: str, workdir: str | None = None) -> dict:
    """The fixture, the workers and the checks: the launcher's JSON, with
    the decoded contigs, ROI k-mers and linked contigs.  The fixture's
    files go to `workdir` (default: a temporary directory, removed)."""
    with tempfile.TemporaryDirectory(prefix="mh_dryrun_") as tmp:
        wd = workdir or tmp
        oracle_dev = "cpu" if device == "cpu" else None
        spec, oracles = fixture(wd, shards, oracle_dev)
        t0 = time.perf_counter()
        workers = run_workers(spec, processes, device, wd)
        seconds = time.perf_counter() - t0
        got = decode(gather(spec), assembled(spec), oracles)
    return {"metric": "multihost_dryrun", "processes": processes, "global_shards": shards,
            "backend": workers[0]["backend"], "devices": [w["device"] for w in workers],
            "per_process_byte_range_records": [w["records_read"] for w in workers],
            "owned_records": [w["records_owned"] for w in workers],
            "shards_identical": all(w["shards_identical"] for w in workers),
            "contigs_identical": len(got["contigs"]), "rois": len(got["rois"]),
            "linked_identical": len(got["linked"]), "link_junctions": got["junctions"],
            "exchange_bytes": sum(w["exchange"]["bytes"] for w in workers),
            "launches": {name: sum(w["launches"][name] for w in workers)
                         for name in workers[0]["launches"]},
            "workers_s": round(seconds, 2), "ok": True,
            "contigs": got["contigs"], "roi_kmers": got["rois"], "linked": got["linked"]}


# ---------------------------------------------------------------------------
# a worker
# ---------------------------------------------------------------------------

def _same_shards(sg, want) -> bool:
    """Every owned shard of `sg` equals `want`'s bit for bit."""
    for name in ("kmers", "edges", "coverages", "buckets"):
        for a, b in zip(getattr(sg, name), getattr(want, name)):
            if a.shape != b.shape or not torch.equal(a.cpu(), b.cpu()):
                return False
    return (all(np.array_equal(a, b) for a, b in zip(sg.records, want.records))
            and np.array_equal(sg.counts, want.counts))


def worker(rank: int, world: int, port: int, spec_path: str) -> dict:
    """One rank of the dry run (see the module docstring); returns its
    JSON fields.  Rank 0 writes the all-gathered outputs to spec["out"]."""
    import torch.distributed as dist

    from corticall_tpu_torch import graph as gr
    from corticall_tpu_torch.io import ctx as ctxio, links as lkio
    from corticall_tpu_torch.ops import kmer as tk
    from corticall_tpu_torch.ops import sharding as sh
    from corticall_tpu_torch.parallel import mesh as pm

    with open(spec_path) as f:
        spec = json.load(f)
    if spec["device"] == "cpu":
        device = torch.device("cpu")
        torch.set_num_threads(1)      # the ranks share the host's cores
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("dryrun_multihost: no CUDA device; pass --device cpu")
        device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    seconds = {}
    t0 = time.perf_counter()
    backend = pm.init_process_mesh(rank, world, f"tcp://localhost:{port}", device,
                                   spec.get("backend"))
    mesh = pm.ShardMesh.across(spec["shards"], device)
    seconds["init"] = time.perf_counter() - t0
    for key in sh.LAUNCHES:
        sh.LAUNCHES[key] = 0
    out = {}
    try:
        t0 = time.perf_counter()
        sg = pm.ShardedGraph.from_ctx_range(spec["ctx"], mesh)
        if device.type == "cuda":
            torch.cuda.synchronize()
        seconds["load"] = time.perf_counter() - t0
        load_stats = dict(mesh.stats)
        total = ctxio.ctx_num_records(spec["ctx"])
        k = sg.kmer_size
        full = None
        same = None
        if spec.get("check_shards") or spec.get("linked") or spec.get("assemble"):
            t0 = time.perf_counter()
            full = gr.CortexGraph(ctxio.read_ctx(spec["ctx"]))
            seconds["full_load"] = time.perf_counter() - t0
        if spec.get("check_shards"):
            same = _same_shards(sg, pm.ShardedGraph.from_graph(full, mesh))
            if not same:
                raise AssertionError(f"rank {rank}: an owned shard differs from from_graph's")

        def local_rows(path):
            words = np.load(path)
            per = words.shape[0] // world
            return words[rank * per:(rank + 1) * per]

        if spec.get("walk"):
            w = spec["walk"]
            seeds = local_rows(w["seeds"])
            run = pm.make_sharded_walk_run(mesh, sg, w["colors"], k, w["steps"])
            before = dict(mesh.stats)
            t0 = time.perf_counter()
            bases, cycled, steps = run(seeds, np.ones(len(seeds), dtype=bool))
            if device.type == "cuda":
                torch.cuda.synchronize()
            seconds["walk"] = time.perf_counter() - t0
            out["walk_exchange_bytes"] = mesh.stats["bytes"] - before["bytes"]
            out.update(walk_bases=mesh.all_gather(bases, dim=1),
                       walk_cycled=mesh.all_gather(cycled), walk_steps=mesh.all_gather(steps))
            repeats = w.get("repeats", 0)
            if repeats:
                dist.barrier()
                t0 = time.perf_counter()
                for _ in range(repeats):
                    steps = run(seeds, np.ones(len(seeds), dtype=bool))[2]
                if device.type == "cuda":
                    torch.cuda.synchronize()
                seconds["walk_repeats"] = time.perf_counter() - t0
                out["walk_repeat_steps"] = repeats * int(steps.sum())
        if spec.get("rois"):
            r = spec["rois"]
            t0 = time.perf_counter()
            masks, roi_total = pm.make_sharded_find_rois(mesh, sg, r["child"], r["parents"])()
            seconds["rois"] = time.perf_counter() - t0
            recs = np.concatenate([rec[m.cpu().numpy()] for rec, m in zip(sg.records, masks)])
            kmers = np.concatenate([km_s[m].cpu().numpy() for km_s, m in zip(sg.kmers, masks)])
            # every rank's ROI records (their counts differ: gathered as objects)
            parts = [None] * world
            dist.all_gather_object(parts, (recs, kmers))
            recs = np.concatenate([p[0] for p in parts])
            order = np.argsort(recs, kind="stable")
            out.update(roi_records=torch.from_numpy(recs[order]),
                       roi_kmers=torch.from_numpy(np.concatenate([p[1] for p in parts])[order]),
                       roi_total=torch.tensor(roi_total))
        if spec.get("linked"):
            lk = spec["linked"]
            t0 = time.perf_counter()
            links = [lkio.open_links(p) for p in spec["links"]]
            sl = pm.ShardedLinks.from_graph(full, links, sg)
            seconds["links_build"] = time.perf_counter() - t0
            seeds = local_rows(lk["seeds"])
            run = pm.make_sharded_linked_walk_run(mesh, sg, sl, lk["colors"], k, lk["steps"])
            before = dict(mesh.stats)
            t0 = time.perf_counter()
            emitted, overflow, junctions = run(seeds, np.ones(len(seeds), dtype=bool))
            if device.type == "cuda":
                torch.cuda.synchronize()
            seconds["links"] = time.perf_counter() - t0
            out["linked_exchange_bytes"] = mesh.stats["bytes"] - before["bytes"]
            out.update(linked_emitted=mesh.all_gather(emitted, dim=1),
                       linked_overflow=mesh.all_gather(overflow),
                       linked_junctions=mesh.all_gather(junctions))
        contigs = None
        if spec.get("assemble"):
            a = spec["assemble"]
            t0 = time.perf_counter()
            links = [lkio.open_links(p) for p in spec["links"]]
            sl = pm.ShardedLinks.from_graph(full, links, sg)
            walked = pm.sharded_assemble(mesh, sg, a["colors"], a["seeds"], a["steps"])
            linked, overflow, junctions = pm.sharded_assemble_links(
                mesh, sg, sl, a["colors"], a["rois"], a["steps"])
            seconds["assemble"] = time.perf_counter() - t0
            contigs = {"contigs": walked, "linked": linked,
                       "linked_overflow": bool(overflow.any()),
                       "linked_junctions": int(junctions.sum())}
        if rank == 0:
            np.savez(spec["out"], **{name: x.cpu().numpy() for name, x in out.items()
                                     if isinstance(x, torch.Tensor)})
            if contigs is not None:
                with open(spec["out"] + ".json", "w") as f:
                    json.dump(contigs, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return {"worker": rank, "backend": backend, "device": str(device),
            "shards": mesh.shards, "records_total": int(total),
            "records_read": int((rank + 1) * total // world - rank * total // world),
            "records_owned": int(sum(len(r) for r in sg.records)),
            "shards_identical": same, "seconds": {n: round(v, 3) for n, v in seconds.items()},
            "load_exchange": load_stats, "exchange": dict(mesh.stats),
            "walk_exchange_bytes": out.get("walk_exchange_bytes"),
            "walk_repeat_steps": out.get("walk_repeat_steps"),
            "linked_exchange_bytes": out.get("linked_exchange_bytes"),
            "launches": dict(sh.LAUNCHES), "words": tk.words(k)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--processes", type=int, default=2)
    ap.add_argument("--shards", type=int, default=8, help="global shards")
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda",
                    help="where the workers' shards live (default: the cards)")
    args = ap.parse_args(argv)
    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("dryrun_multihost: no CUDA device; pass --device cpu")
        from corticall_tpu_torch.ops import _kernels
        _kernels.build()               # once, before the workers load it
    res = dryrun(args.processes, args.shards, args.device)
    print(json.dumps({key: v for key, v in res.items()
                      if key not in ("contigs", "roi_kmers", "linked")}), flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "worker":
        print(json.dumps(worker(int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]),
                                sys.argv[5])), flush=True)
    else:
        sys.exit(main())
