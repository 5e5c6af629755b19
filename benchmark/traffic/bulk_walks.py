"""Bulk walks: Partition's device walk entry at a bulk batch, one caller.

Set-up draws the configuration's trio from the seed, builds the joined graph
of its three genomes on the device (benchmark/lib/graph.py), and hands the
program what commands/core._jump_table hands it: the records' canonical
words and the child colour's edge bytes, from which
`ops.jump.build_jump_table` builds the jump table (timed as
`jump_table_build_s`).  Each request is one call of
`ops.jump.walk_forward_jumps(jt.buckets, jt.rows, seeds, k, max_walk)`, as
commands/core._jump_walks makes it, on a batch of seeds drawn from the seed
over the child's records in both orientations; the batches are drawn once
and served in turn, whole turns a window (`cycle`).  A request's latency runs from the seeds handed over to
the host arrays returned.  Of every call a few lanes, drawn from the seed,
are kept; after the window the plain reference (benchmark/reference/walks.py)
works each kept lane out again from the child's genome and every output of
the lane is compared.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from benchmark.counts import bounds
from benchmark.lib import genome, graph as bgraph
from benchmark.reference import walks as ref
from corticall_tpu_torch.ops import jump

OUTPUTS = ("packed", "cycled", "steps", "saturated", "touched", "ends_junction")


@dataclass
class State:
    k: int
    cap: int
    trio: genome.Trio
    graph: tuple | None                # (records, child edge bytes) until the table is built
    batches: list                      # uint32 [B, W] seeds a batch
    origin: list                       # (chrom, strand, q) int64 [B] a batch
    lanes: np.ndarray                  # int64 [R, L]: the lanes kept of call i, row i % R
    limit: int
    table: object = None
    kept: list = field(default_factory=list)
    bound_ms: list = field(default_factory=list)
    timers: dict = field(default_factory=dict)

    @property
    def cycle(self) -> int:
        return len(self.batches)


def draw_seeds(g: bgraph.Graph, trio: genome.Trio, n: int, gen: torch.Generator):
    """n walk-oriented seeds over the child's records, both orientations:
    (words int64 [n, W] on the device, (chrom, strand, q) on the host: the
    oriented chromosome and position where the seed occurs)."""
    k = g.k
    child = torch.nonzero(g.present[:, 0]).squeeze(1)
    rec = child[torch.randint(child.shape[0], (n,), generator=gen, device=child.device)]
    orient = torch.randint(2, (n,), generator=gen, device=child.device).bool()
    canon = g.kmers[rec]
    words = torch.where(orient[:, None], bgraph.revcomp_words(canon, k), canon)
    # the seed is the forward strand's k-mer at p when its orientation is the
    # occurrence's (canonical = forward, or reverse complement = forward)
    chrom, p = g.child_chrom[rec], g.child_pos[rec]
    strand = (orient != g.child_flip[rec]).to(torch.int64)
    n_pos = torch.tensor([len(c) - k + 1 for c in trio.child], device=child.device)[chrom]
    q = torch.where(strand == 1, n_pos - 1 - p, p)
    return words, tuple(x.cpu().numpy() for x in (chrom, strand, q))


def make_inputs(config: dict, mix: dict, seed: int, device) -> State:
    """The cell's inputs for `seed`, without the program: the trio, the seed
    batches and their origins, the lanes kept of each call; the graph's
    records and child edge bytes (uint32 [N, W], uint8 [N]) in
    `state.graph`."""
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
    records = (bgraph.to_uint32(g.kmers), g.edges[:, 0].cpu().numpy())
    del g
    if device.type == "cuda":
        torch.cuda.empty_cache()
    timers["graph_and_seeds_s"] = time.perf_counter() - t0
    rng = np.random.default_rng([seed, 11])
    lanes = np.sort(rng.integers(0, int(mix["seeds_per_call"]),
                                 (4096, int(mix["check_lanes_per_call"]))), axis=1)
    return State(k, cap, trio, records, batches, origin, lanes,
                 int(mix["limits"]["lanes_wrong"]), timers=timers)


def setup(config: dict, mix: dict, seed: int, device, traced: bool) -> State:
    state = make_inputs(config, mix, seed, device)
    kmers, edges = state.graph
    state.graph = None
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    state.table = jump.build_jump_table(kmers, edges, state.k, device=device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    state.timers["jump_table_build_s"] = time.perf_counter() - t0
    # warm-up: every batch once (the first call loads the kernels)
    t0 = time.perf_counter()
    for seeds in state.batches:
        out = jump.walk_forward_jumps(state.table.buckets, state.table.rows, seeds, state.k,
                                      state.cap)
        if traced:
            state.bound_ms.append(walk_bound_ms(state, seeds, out))
        del out
    state.timers["warmup_s"] = time.perf_counter() - t0
    return state


def walk_bound_ms(state: State, seeds: np.ndarray, out) -> float:
    """The frozen bound of one call on this batch (benchmark/counts)."""
    dev = state.table.rows.device
    s64 = torch.from_numpy(seeds.astype(np.int64)).to(dev)
    packed = torch.from_numpy(out[0].astype(np.int64)).to(dev)
    steps = torch.from_numpy(out[2].astype(np.int64)).to(dev)
    rows = bounds.walk_rows_read(s64, packed, steps, state.k, state.cap)
    nbytes = bounds.seed_bucket_bytes(state.table.buckets, s64, state.k)
    return bounds.walk_bound(seeds.nbytes, bounds.walk_out_bytes(seeds.shape[0], state.cap),
                             nbytes, rows)[0]


def request(state: State, i: int):
    b = i % len(state.batches)
    t0 = time.perf_counter()
    out = jump.walk_forward_jumps(state.table.buckets, state.table.rows, state.batches[b],
                                  state.k, state.cap)
    dt = time.perf_counter() - t0
    lanes = state.lanes[i % len(state.lanes)]
    state.kept.append((b, lanes, *(x[lanes].copy() for x in out)))
    counts = {"walk_calls": 1, "walk_bases": int(out[2].sum(dtype=np.int64))}
    if state.bound_ms:
        counts["walk_bound_ms"] = state.bound_ms[b]
    return dt, counts


def release(state: State) -> None:
    state.table = None
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def check(state: State, device) -> dict:
    """{"lanes_wrong": (count, limit)}: kept lanes whose outputs differ from
    the reference's, and seeds that are not the child's k-mer where they
    were drawn (a fault of the generator, counted the same)."""
    if not state.kept:
        return {"lanes_wrong": (0, state.limit)}
    b_of = np.concatenate([np.full(len(x[1]), x[0]) for x in state.kept])
    lane = np.concatenate([x[1] for x in state.kept])
    got = [np.concatenate([x[2 + j] for x in state.kept]) for j in range(len(OUTPUTS))]
    return {"lanes_wrong": (count_wrong(state, b_of, lane, got, device), state.limit)}


def control_outputs(state: State, b_of, lane, device) -> list:
    """The control in the program's place: the reference's walks with the
    junction rule broken (a junction walked through by one of its edges),
    as walk_forward_jumps' six arrays for lanes (b_of, lane)."""
    cg = ref.ChildGraph(state.trio.child, state.k, device)
    idx = cg.position(*(np.stack([o[j] for o in state.origin])[b_of, lane] for j in range(3)))
    bases, d, deg_d, _ = ref.walk(cg, cg.gid[idx], state.cap, stop_at_junctions=False)
    packed, steps, cycled, saturated, touched, endj = ref.expected(bases, d, deg_d, state.cap)
    return [packed, cycled, steps, saturated, touched, endj]


def count_wrong(state: State, b_of, lane, got, device) -> int:
    """Lanes (batch b_of, lane) whose outputs `got` (walk_forward_jumps'
    six arrays, those lanes' rows) are not what the reference gives."""
    cg = ref.ChildGraph(state.trio.child, state.k, device)
    idx = cg.position(*(np.stack([o[j] for o in state.origin])[b_of, lane] for j in range(3)))
    seeds = np.stack([state.batches[b][i] for b, i in zip(b_of, lane)]).astype(np.int64)
    bad = (cg.seed_words(idx) != seeds).any(axis=1)
    bases, d, deg_d, cyclic = ref.walk(cg, cg.gid[idx], state.cap)
    want = ref.expected(bases, d, deg_d, state.cap)
    packed, cycled, steps, saturated, touched, endj = got
    w_packed, w_steps, w_cyc, w_sat, w_touch, w_endj = want
    if packed.shape[1] != w_packed.shape[1]:
        return len(lane)
    strict = ((packed != w_packed).any(axis=1) | (steps != w_steps) | (cycled != w_cyc)
              | (saturated != w_sat) | (touched != w_touch) | (endj != w_endj))
    # a lane whose walk cycles: its bases up to its steps, and the walk ended
    # by the cycle or at the cap
    prefix = ref.expected(bases, steps.astype(np.int64), deg_d, state.cap)[0]
    loose = ((packed != prefix).any(axis=1) | (steps > state.cap)
             | ~(cycled | (steps == state.cap)) | touched
             | (saturated != ((steps >= state.cap) & ~cycled)))
    wrong = bad | np.where(cyclic, loose, strict)
    return int(wrong.sum())


def control(config: dict, mix: dict, seed: int, device, calls: int) -> dict:
    """The number a run compares, with the control's walks (control_outputs)
    in the program's place on the lanes that `calls` calls keep."""
    state = make_inputs(config, mix, seed, device)
    state.graph = None
    i = np.arange(calls)
    b_of = np.repeat(i % len(state.batches), state.lanes.shape[1])
    lane = state.lanes[i % len(state.lanes)].reshape(-1)
    got = control_outputs(state, b_of, lane, device)
    return {"lanes_wrong": count_wrong(state, b_of, lane, got, device)}
