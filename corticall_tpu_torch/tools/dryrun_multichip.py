#!/usr/bin/env python3
"""Every sharded path of the hash-sharded graph on an n-shard mesh, checked
against the single-device port.

    python3 corticall_tpu_torch/tools/dryrun_multichip.py --shards N [--cpu]

The counterpart of __graft_entry__.dryrun_multichip (the JAX package's dry
run on an n-device mesh), on the same toy trio (k = 17, a 2,440-base genome
with a 40-base repeat, the child with 6 substitutions and its links
threaded from its haplotype): one data-parallel frontier step against a
DeviceGraph step; sharded FindROIs against FindROIs; sharded walks to
completion against the single-device contigs; linked walks against
LinkedWalker; and the partition-sharded Call's VCF against one Caller's,
byte for byte.  On the cards it also times the sharded walk over 256 * N
seeds x 256 steps: a smoke figure on a toy graph of ~2,400 records, which
says that the path runs, not how fast it walks a real graph (chip_smoke.py
phase 12 times that).

The shards go round-robin over the visible CUDA cards (several shards may
share one); without a card it fails, unless --cpu puts every shard, and the
single-device paths, on the CPU (the plain twins).  Prints one JSON line
with the shard devices; exits non-zero on any difference.
"""

import argparse
import json
import os
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, HERE)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from corticall_tpu_torch import fixtures, kmer as km  # noqa: E402
from corticall_tpu_torch.caller.call import Caller  # noqa: E402
from corticall_tpu_torch.caller.variants import write_vcf  # noqa: E402
from corticall_tpu_torch.commands import core  # noqa: E402
from corticall_tpu_torch.device import DeviceGraph  # noqa: E402
from corticall_tpu_torch.io import links as lkio  # noqa: E402
from corticall_tpu_torch.models.reference_index import IndexedReference  # noqa: E402
from corticall_tpu_torch.ops import kmer as tk  # noqa: E402
from corticall_tpu_torch.ops.walk_links import LinkedWalker  # noqa: E402
from corticall_tpu_torch.parallel import mesh as pm  # noqa: E402

K, STEPS = 17, 256


def toy_trio():
    """__graft_entry__.dryrun_multichip's trio: (graph, links, genome)."""
    rng = np.random.default_rng(1)
    core_seq = "".join(rng.choice(list("ACGT"), 2400))
    genome = core_seq[:1200] + core_seq[300:340] + core_seq[1200:]
    child = list(genome)
    for pos in rng.integers(K, len(child) - K, size=6):
        child[pos] = "ACGT"[(ord(child[pos]) + 1) % 4]
    child = "".join(child)
    g = fixtures.build_graph({"kid": [child], "mom": [genome], "dad": [genome]}, K)
    return g, lkio.build_links(g, {"kid": [child]}, "kid"), genome


def single_step(g, cur: np.ndarray, colors, dev):
    """One frontier step on a DeviceGraph: (cur uint32 [B, W], advanced)."""
    dg = DeviceGraph.from_graph(g, device=dev)
    words = tk.from_bits32(tk.words_tensor(cur, dev))
    canon, flipped = tk.canonicalize_words(words, K)
    rec = dg.find_records(tk.to_bits32(canon)).to(torch.int64)
    e = torch.where(rec >= 0, dg.combined_edges(colors)[rec.clamp(min=0)].to(torch.int64), 0)
    next_mask = torch.where(flipped, e >> 4, e & 0xF)
    advance = (tk.popcount4(next_mask) == 1) & (rec >= 0)
    nxt = tk.shift_append(words, tk.lowest_set_base(next_mask), K)
    out = torch.where(advance[:, None], nxt, words)
    return out.cpu().numpy().astype(np.uint32), advance.cpu().numpy()


def vcf_bytes(variants, sd) -> bytes:
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "calls.vcf")
        write_vcf(path, variants, sd)
        with open(path, "rb") as f:
            return f.read()


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def dryrun(n: int, cpu: bool) -> dict:
    mesh = pm.ShardMesh(["cpu"] * n if cpu else None, num_shards=n)
    dev = mesh.devices[0]
    g, links, genome = toy_trio()
    sg = pm.ShardedGraph.from_graph(g, mesh)

    # 1. one data-parallel frontier step
    b = 16 * n
    cur = g.kmers[np.linspace(0, g.num_records - 1, b).astype(np.int64)]
    got_cur, advanced, live = pm.make_sharded_walk_step(mesh, sg, [0, 1, 2], K)(
        cur, np.ones(b, dtype=bool))
    want_cur, want_adv = single_step(g, cur, [0, 1, 2], dev)
    check(np.array_equal(got_cur.cpu().numpy().view(np.uint32), want_cur)
          and np.array_equal(advanced.cpu().numpy(), want_adv) and live == want_adv.sum(),
          "the sharded step differs from the DeviceGraph step")

    # 2. sharded FindROIs == FindROIs
    rois = core.find_rois(g, "kid", ["mom", "dad"])
    got_rois = pm.sharded_find_rois_kmers(mesh, sg, 0, [1, 2])
    check(np.array_equal(km.words_to_bytes_be(got_rois, K),
                         np.sort(km.words_to_bytes_be(rois.kmers, K))),
          "sharded FindROIs differs from FindROIs")

    # 3. walks to completion: the single-device contigs
    cks = sorted(rois.kmer_string(i) for i in range(rois.num_records))
    want = core._batched_contigs(g, 0, cks, STEPS)
    got = pm.sharded_assemble(mesh, sg, [0], cks, STEPS)
    check(all(got[s] == want[s] for s in cks), "sharded contigs differ")

    # 4. link-assisted walks: LinkedWalker's contigs
    sl = pm.ShardedLinks.from_graph(g, [links], sg)
    lcontigs, overflow, junctions = pm.sharded_assemble_links(mesh, sg, sl, [0], cks, STEPS)
    lwant, lov, ljn = LinkedWalker(g, [0], [links], device=dev).assemble(cks, STEPS)
    check([lcontigs[s] for s in cks] == list(lwant) and np.array_equal(overflow, lov)
          and np.array_equal(junctions, ljn), "sharded linked contigs differ")

    # 5. Call sharded by partition: one Caller's VCF, byte for byte
    refs = {p: IndexedReference({"chr1": genome}) for p in ("mom", "dad")}
    parts = core.partition(g, rois, max_walk=STEPS)
    single = Caller(g, rois, parts, backgrounds=["mom", "dad"], references=refs, device=dev)
    want_vars, _ = single.call()
    got_vars, _ = pm.sharded_call(mesh, g, rois, parts, ["mom", "dad"], refs)
    sd = single.sequence_dictionary()
    check(len(want_vars) > 0 and vcf_bytes(want_vars, sd) == vcf_bytes(got_vars, sd),
          "the sharded Call's VCF differs from one Caller's")

    out = {"dryrun_multichip": n, "devices": [str(d) for d in mesh.devices],
           "shard_records": sg.counts.tolist(), "step_live": live, "rois": len(got_rois),
           "contigs": len(cks), "linked_junctions": int(junctions.sum()),
           "linked_overflow": int(overflow.sum()), "calls": len(want_vars),
           "vcf_identical": True}
    if dev.type == "cuda":
        out.update(walk_rate(mesh, sg, g))
    return out


def walk_rate(mesh, sg, g) -> dict:
    """The sharded walk's rate on the cards: 256 seeds a shard x 256
    steps on the toy graph, the second of two runs (a smoke figure, not a
    throughput)."""
    run = pm.make_sharded_walk_run(mesh, sg, [0], K, STEPS)
    bb = 256 * mesh.size
    seeds = g.kmers[(np.arange(bb) * 37) % g.num_records]
    ones = np.ones(bb, dtype=bool)
    run(seeds, ones)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = run(seeds, ones)
    torch.cuda.synchronize()
    walk_s = time.perf_counter() - t0
    steps = int(out[2].sum())
    return {"walks": bb, "walk_steps": steps, "walk_s": round(walk_s, 4),
            "walk_steps_per_s": round(steps / walk_s)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shards", type=int, required=True)
    ap.add_argument("--cpu", action="store_true",
                    help="every shard and the single-device paths on the CPU")
    args = ap.parse_args(argv)
    print(json.dumps(dryrun(args.shards, args.cpu)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
