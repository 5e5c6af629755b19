"""Linked walks: contig extraction over the child's linked graph, one caller.

Set-up draws the configuration's trio from the seed, builds the joined graph
of its three genomes on the device (benchmark/lib/graph.py) and threads the
child's reads into links (benchmark/lib/links.py: `link_read_coverage`
times the genome in `read_length`-base reads), written as a McCortex
.ctp.gz in a temporary directory.  The program reads that file with its own
reader (io/links.read_links) and builds its walker from the records' sorted
canonical words and the child colour's edge bytes,
`LinkedWalker.from_records(k, kmers, edges, [links], "child")` (timed as
`link_table_build_s`).  Each request is one call of
`walker.walk_words(seeds, max_walk)` on a batch of walk-oriented seeds
drawn over the child's records in both orientations
(bulk_walks.draw_seeds); the batches are drawn once and served in turn,
whole turns a window (`cycle`).  A request's latency runs from the seed
words handed over to the host arrays returned.  Of every call two lanes are
kept: one drawn uniformly, one among the seeds whose first max_walk bases
pass a k-mer that holds links facing them (the generator knows them from
the genome).  After the window the plain reference
(benchmark/reference/linked_walks.py) walks each kept lane again from the
child's genome and the links file, and every output of the lane is
compared exactly.

The program's entries are looked for before any input is made: a program
without them fails at once.
"""

from __future__ import annotations

import os
import shutil
import sys
import tempfile
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from benchmark.counts import link_bounds
from benchmark.lib import genome, graph as bgraph, links as blinks
from benchmark.reference import linked_walks as ref
from benchmark.traffic.bulk_walks import draw_seeds
from corticall_tpu_torch.io import links as lkio
from corticall_tpu_torch.ops import walk_links

SAMPLE = "child"
ENTRIES = ("from_records", "walk_words")


@dataclass
class State:
    k: int
    cap: int
    trio: genome.Trio
    graph: tuple | None                # (records, child edge bytes) until the walker is built
    batches: list                      # uint32 [B, W] seeds a batch
    origin: list                       # (chrom, strand, q) int64 [B] a batch
    lanes: np.ndarray                  # int64 [R, 2]: the lanes kept of call i, row i % R
    limit: int
    folder: str                        # the links file's temporary directory
    link_counts: dict
    bound_records: object = None       # link_bounds.Records, traced runs only
    walker: object = None
    kept: list = field(default_factory=list)
    bound_ms: list = field(default_factory=list)
    timers: dict = field(default_factory=dict)

    @property
    def cycle(self) -> int:
        return len(self.batches)

    @property
    def ctp(self) -> str:
        return os.path.join(self.folder, f"{SAMPLE}.ctp.gz")


def require_entries() -> None:
    """RuntimeError where the program lacks the linked walker's record and
    word entries."""
    missing = [n for n in ENTRIES if not hasattr(walk_links.LinkedWalker, n)]
    if missing:
        raise RuntimeError("corticall_tpu_torch.ops.walk_links.LinkedWalker has no "
                           f"{', '.join(missing)}: this program cannot run the cell")


def bound_records(g: bgraph.Graph, links: blinks.ReadLinks, k: int) -> link_bounds.Records:
    """The graph's records with the child's edge bytes and each record's
    link counts (at most MAX_ADD, and the forward ones among those), for
    the bound."""
    zeros = torch.zeros(g.kmers.shape[0], dtype=torch.int64, device=g.kmers.device)
    records = link_bounds.Records(g.kmers, g.edges[:, 0], zeros, zeros.clone())
    keys = list(links.records)
    if keys:
        rows = records.find(ref.pack_kmers(keys, k).to(g.kmers.device))
        for key, row in zip(keys, rows.tolist()):
            if row >= 0:
                recs = links.records[key]
                records.counts[row] = min(len(recs), link_bounds.MAX_ADD)
                records.forward[row] = sum(1 for fw, _, _ in recs[:link_bounds.MAX_ADD] if fw)
    return records


def make_inputs(config: dict, mix: dict, seed: int, device, traced: bool = False) -> State:
    """The cell's inputs for `seed`, without the program: the trio, the
    links file, the seed batches and their origins, the lanes kept of each
    call; the graph's records and child edge bytes (uint32 [N, W], uint8
    [N]) in `state.graph`."""
    k, cap = int(config["k"]), int(mix["max_walk"])
    t0 = time.perf_counter()
    trio = genome.make_trio(config, seed)
    timers = {"genome_s": time.perf_counter() - t0}
    t0 = time.perf_counter()
    g = bgraph.build_graph(trio, device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(np.random.default_rng([seed, 7]).integers(1 << 62)))
    batches, origin = [], []
    for _ in range(int(mix["batches"])):
        words, where = draw_seeds(g, trio, int(mix["seeds_per_call"]), gen)
        batches.append(bgraph.to_uint32(words))
        origin.append(where)
    timers["graph_and_seeds_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    read_len = int(config["read_length"])
    reads = blinks.draw_reads(trio.child, float(config["link_read_coverage"]), read_len, seed)
    links = blinks.thread(trio.child, k, reads, read_len, device)
    folder = tempfile.mkdtemp(prefix="bench_links_")
    blinks.write_ctp(os.path.join(folder, f"{SAMPLE}.ctp.gz"), links, SAMPLE,
                     int(g.kmers.shape[0]))
    timers["reads_and_links_s"] = time.perf_counter() - t0
    rng = np.random.default_rng([seed, 11])
    rows = 512 * len(batches)                      # row i serves batch i % len(batches)
    lanes = np.empty((rows, 2), dtype=np.int64)
    lanes[:, 0] = rng.integers(0, int(mix["seeds_per_call"]), rows)
    for b, where in enumerate(origin):
        linked = np.nonzero(blinks.passes_links(links, where, cap))[0]
        pool = linked if linked.size else np.arange(len(where[0]))
        lanes[b::len(batches), 1] = pool[rng.integers(0, pool.size, rows // len(batches))]
    records = bound_records(g, links, k) if traced else None
    state = State(k, cap, trio, (bgraph.to_uint32(g.kmers), g.edges[:, 0].cpu().numpy()),
                  batches, origin, lanes, int(mix["limits"]["lanes_wrong"]), folder,
                  links.counts(), bound_records=records, timers=timers)
    del g, links
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return state


def setup(config: dict, mix: dict, seed: int, device, traced: bool) -> State:
    require_entries()
    state = make_inputs(config, mix, seed, device, traced)
    kmers, edges = state.graph
    state.graph = None
    print(f"linked walks: {state.link_counts}", file=sys.stderr)
    t0 = time.perf_counter()
    links = lkio.read_links(state.ctp)
    state.timers["read_links_s"] = time.perf_counter() - t0
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    state.walker = walk_links.LinkedWalker.from_records(state.k, kmers, edges, [links], SAMPLE,
                                                        device=device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    state.timers["link_table_build_s"] = time.perf_counter() - t0
    del kmers, edges, links
    # warm-up: every batch once (the first call loads the kernels)
    t0 = time.perf_counter()
    for seeds in state.batches:
        out = state.walker.walk_words(seeds, state.cap)
        if traced:
            state.bound_ms.append(walk_bound_ms(state, seeds, out))
        del out
    state.timers["warmup_s"] = time.perf_counter() - t0
    if traced:
        state.bound_records = None
    return state


def walk_bound_ms(state: State, seeds: np.ndarray, out) -> float:
    """The frozen bound of one call on this batch (benchmark/counts)."""
    dev = state.bound_records.kmers.device
    s64 = torch.from_numpy(seeds.astype(np.int64)).to(dev)
    emitted = torch.from_numpy(np.ascontiguousarray(out[0])).to(dev)
    steps = torch.from_numpy(out[2].astype(np.int64)).to(dev)
    bucket_size = state.walker.args[0].shape[1]
    return link_bounds.link_walk_bound(state.bound_records, s64, emitted, steps, state.k,
                                       bucket_size)[0]


def request(state: State, i: int):
    b = i % len(state.batches)
    stats = dict(state.walker.stats)
    t0 = time.perf_counter()
    out = state.walker.walk_words(state.batches[b], state.cap)
    dt = time.perf_counter() - t0
    lanes = state.lanes[i % len(state.lanes)]
    state.kept.append((b, lanes, *(x[lanes].copy() for x in out)))
    counts = {"walk_calls": 1, "walk_bases": int(out[2].sum(dtype=np.int64))}
    for name in ("junctions_resolved", "overflow_lanes"):
        counts[name] = state.walker.stats[name] - stats[name]
    if state.bound_ms:
        counts["link_walk_bound_ms"] = state.bound_ms[b]
    return dt, counts


def release(state: State) -> None:
    state.walker = None
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def check(state: State, device) -> dict:
    """{"lanes_wrong": (count, limit)}: kept lanes whose outputs differ from
    the reference's, and seeds that are not the child's k-mer where they
    were drawn (a fault of the generator, counted the same)."""
    try:
        if not state.kept:
            return {"lanes_wrong": (0, state.limit)}
        b_of = np.concatenate([np.full(len(x[1]), x[0]) for x in state.kept])
        lane = np.concatenate([x[1] for x in state.kept])
        got = [np.concatenate([x[2 + j] for x in state.kept]) for j in range(4)]
        child = ref.LinkedChild(state.trio.child, state.k, ref.read_ctp(state.ctp), device)
        return {"lanes_wrong": (count_wrong(state, child, b_of, lane, got), state.limit)}
    finally:
        shutil.rmtree(state.folder, ignore_errors=True)


def _starts(state: State, child, b_of, lane) -> np.ndarray:
    cg = child.graph
    return cg.position(*(np.stack([o[j] for o in state.origin])[b_of, lane] for j in range(3)))


def count_wrong(state: State, child, b_of, lane, got) -> int:
    """Lanes (batch b_of, lane) whose outputs `got` (walk_words' four
    arrays, those lanes' rows) are not what the reference gives."""
    idx = _starts(state, child, b_of, lane)
    seeds = np.stack([state.batches[b][i] for b, i in zip(b_of, lane)]).astype(np.int64)
    bad = (child.graph.seed_words(idx) != seeds).any(axis=1)
    want = child.walk(child.graph.gid[idx], state.cap)
    emitted, overflow, steps, junctions = got
    if emitted.shape != want[0].shape:
        return len(lane)
    wrong = (bad | (emitted != want[0]).any(axis=1) | (overflow != want[1])
             | (steps != want[2]) | (junctions != want[3]))
    return int(wrong.sum())


def control(config: dict, mix: dict, seed: int, device, calls: int) -> dict:
    """The number a run compares, with the reference walked as if the link
    set were empty in the program's place, on the lanes that `calls` calls
    keep."""
    state = make_inputs(config, mix, seed, device)
    state.graph = None
    try:
        i = np.arange(calls)
        b_of = np.repeat(i % len(state.batches), state.lanes.shape[1])
        lane = state.lanes[i % len(state.lanes)].reshape(-1)
        child = ref.LinkedChild(state.trio.child, state.k, ref.read_ctp(state.ctp), device)
        got = child.walk(child.graph.gid[_starts(state, child, b_of, lane)], state.cap,
                         use_links=False)
        return {"lanes_wrong": count_wrong(state, child, b_of, lane, list(got))}
    finally:
        shutil.rmtree(state.folder, ignore_errors=True)
