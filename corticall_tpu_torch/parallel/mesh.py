"""The hash-sharded graph on a mesh of shard devices, driven from one process.

Counterpart of corticall_tpu/parallel/mesh.py, which runs single-controller
over a jax.sharding.Mesh through shard_map (checked there on a virtual
8-device CPU mesh).  Here a `ShardMesh` is an ordered list of torch devices,
one a shard, repeats allowed: four shards may share one card, as JAX's
virtual devices share the host.

- Records are sharded by the routing hash of their canonical k-mer
  (`routing_hash(canonical) % n`); each shard holds its records, in the
  graph's order, and a cuckoo table over them (payload = shard-local record
  + 1), all shards at one bucket count (mesh.py:46-86).
- Walks are data-parallel over the shards: the seeds split into n
  contiguous blocks, as P("shards") splits them, and the shards that share
  a device walk as one batch there (their blocks in mesh order).  Each step
  routes every walk's k-mer to its owner and packs a device's queries into
  one owner-major buffer (`sh.route`, one launch a device), answers them
  (`sh.shard_answer`, one launch a device over the owners it holds) and
  steps the walks, each taking its answer by its slot (`sh.shard_walk_step`
  or `sh.link_step`, one launch a device).  When every shard sits on one
  device the exchange never leaves it: three launches a step, and the
  owners read their queries from the send buffer in place.  When the shards
  span devices, the host reads each device's owner offsets once a step and
  copies each owner's block there and its answers back (`Tensor.to`).  The
  loop ends once no walk was routed; it learns that END_TEST_LAG steps late
  from a total copied to the host behind an event, so that the test never
  waits for the step just launched, and the steps it runs past the end
  change nothing (no walk is live), as the JAX scan emits -1 to the end.
- FindROIs scans each shard's coverages and sums the counts; Call runs one
  `Caller` a shard over round-robin partitions and merges in partition
  order.

Not ported: the capacity-bounded exchange rounds (`_lookup_cap`, `pmax`,
the `q_pad` guard, `pcast`), which exist for XLA's static shapes, and the
module-level run caches keyed by `id(sg)` (:353, :465), which keep every
sharded graph alive.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

import numpy as np
import torch

from .. import kmer as km
from ..ops import cuckoo as ck
from ..ops import kmer as tk
from ..ops import sharding as sh
from ..ops import walk_links as wl
from ..ops.sharding import routing_hash, routing_hash_np  # noqa: F401  (mesh.py:36, :41)
from ..ops.walk_np import replay_walk

AXIS = "shards"
END_TEST_LAG = 2         # steps between a step and the host's test of its routed total


class ShardMesh:
    """An ordered list of shard devices, one a shard; repeats allowed.
    `devices=None`: `num_shards` shards (default: one a card) round-robin
    over the visible CUDA cards, RuntimeError without one."""

    def __init__(self, devices=None, num_shards: int | None = None):
        if devices is None:
            if not torch.cuda.is_available():
                raise RuntimeError("ShardMesh: no CUDA device is available; pass devices, "
                                   "e.g. ['cpu'] * n")
            cards = torch.cuda.device_count()
            devices = [f"cuda:{i % cards}" for i in range(num_shards or cards)]
        self.devices = [self._indexed(torch.device(d)) for d in devices]
        if not self.devices or (num_shards is not None and num_shards != len(self.devices)):
            raise ValueError(f"ShardMesh: {len(self.devices)} devices for {num_shards} shards")

    @staticmethod
    def _indexed(dev: torch.device) -> torch.device:
        if dev.type == "cuda" and dev.index is None:
            return torch.device("cuda", torch.cuda.current_device())
        return dev

    @property
    def size(self) -> int:
        return len(self.devices)

    def groups(self) -> list:
        """Each device once, in the order of its first shard, with the
        shards it holds: [(device, [shard, ...])]."""
        held: dict = {}
        for s, dev in enumerate(self.devices):
            held.setdefault(dev, []).append(s)
        return list(held.items())

    def __repr__(self) -> str:
        return f"ShardMesh({[str(d) for d in self.devices]})"


def shard_of(kmers: np.ndarray, num_shards: int) -> np.ndarray:
    """Owning shard of each canonical k-mer (uint32 [N, W]) -> int64 [N]."""
    return (routing_hash_np(kmers) % np.uint32(num_shards)).astype(np.int64)


@dataclass
class ShardedGraph:
    """Each shard's records (in the graph's order) and cuckoo table on its
    device: kmers and coverages as int32 bit patterns, edges uint8, buckets
    int32 [NB, BS, W+1] (the JAX package's uint32 [NB, BS*(W+1)] rows,
    reshaped).  `records[s]` maps shard s's records to the graph's."""
    kmer_size: int
    mesh: ShardMesh
    kmers: list
    edges: list
    coverages: list
    buckets: list
    records: list
    counts: np.ndarray

    @property
    def num_shards(self) -> int:
        return self.mesh.size

    @classmethod
    def from_graph(cls, g, mesh: ShardMesh) -> "ShardedGraph":
        n = mesh.size
        shard = shard_of(g.kmers, n)
        counts = np.bincount(shard, minlength=n)
        nb = 4                               # one bucket count for every shard (mesh.py:68-70)
        while nb * ck.BUCKET_SIZE * 0.5 < max(int(counts.max()), 1):
            nb *= 2
        kmers, edges, covs, buckets, records = [], [], [], [], []
        for s, dev in enumerate(mesh.devices):
            sel = np.nonzero(shard == s)[0]
            words = np.ascontiguousarray(g.kmers[sel])
            records.append(sel)
            kmers.append(tk.words_tensor(words, dev))
            edges.append(torch.from_numpy(np.ascontiguousarray(g.edges[sel])).to(dev))
            covs.append(tk.words_tensor(g.coverages[sel], dev))
            buckets.append(ck.build_cuckoo(words, np.arange(len(sel), dtype=np.uint32) + 1,
                                           num_buckets=nb, device=dev).buckets)
        return cls(g.kmer_size, mesh, kmers, edges, covs, buckets, records, counts)


@dataclass
class ShardedLinks:
    """Each shard's link CSR over its records (the LinkArrays of
    ops/walk_links.py, hash-sharded with the records, mesh.py:220-261):
    offsets int32 [N_s + 1], choices int32 [P_s, JW], lengths int32 [P_s],
    forward uint8 [P_s], P_s >= 1 (a zero row when the shard has none)."""
    offsets: list
    choices: list
    lengths: list
    forward: list
    truncated: int

    def csr(self, s: int) -> tuple:
        return self.offsets[s], self.choices[s], self.lengths[s], self.forward[s]

    @classmethod
    def from_graph(cls, g, links_list, sg: ShardedGraph) -> "ShardedLinks":
        la = wl.build_link_arrays(g, links_list)
        out = ([], [], [], [])
        for sel, dev in zip(sg.records, sg.mesh.devices):
            lo = la.offsets[sel].astype(np.int64)
            cnt = la.offsets[sel + 1].astype(np.int64) - lo
            offs = np.zeros(len(sel) + 1, dtype=np.int64)
            np.cumsum(cnt, out=offs[1:])
            rows = np.repeat(lo - offs[:-1], cnt) + np.arange(offs[-1])
            p = max(len(rows), 1)
            choices = np.zeros((p, wl.JW), dtype=np.uint32)
            lengths = np.zeros(p, dtype=np.int32)
            forward = np.zeros(p, dtype=np.uint8)
            choices[:len(rows)] = la.choices[rows]
            lengths[:len(rows)] = la.lengths[rows]
            forward[:len(rows)] = la.forward[rows]
            for acc, x in zip(out, (torch.from_numpy(offs.astype(np.int32)),
                                    tk.words_tensor(choices, "cpu"), torch.from_numpy(lengths),
                                    torch.from_numpy(forward))):
                acc.append(x.to(dev))
        return cls(*out, la.truncated)


# ---------------------------------------------------------------------------
# the exchange
# ---------------------------------------------------------------------------

def routed_exchange(mesh: ShardMesh, sg: ShardedGraph, cur: list, colors, links=None,
                    active=None):
    """Route each device's walk-oriented k-mers to their owners, answer them
    there and bring the answers back (_routed_exchange, mesh.py:100).  `cur`
    holds one int32 [B_g, W] tensor a device of mesh.groups(), its shards'
    queries one shard after another, as many each, `active` their uint8
    flags (None: route every query).
    Returns (each device's Route; its answers, int32 [R_g, A], the answer to
    its query i at row slot[i]; the routed total, int32 [1])."""
    n, k = mesh.size, sg.kmer_size
    groups = mesh.groups()
    routes = [sh.route(c, a, k, n, [c.shape[0] // len(held)] * len(held))
              for c, a, (_, held) in zip(cur, active or [None] * len(groups), groups)]
    if len(groups) > 1:
        return _exchange_across(mesh, sg, routes, colors, links)
    r = routes[0]
    ans = sh.shard_answer(r.send, r.offsets, sg.buckets, sg.edges, colors,
                          None if links is None else [links.csr(t) for t in range(n)])
    return routes, [ans], r.offsets[n:]


def _exchange_across(mesh: ShardMesh, sg: ShardedGraph, routes: list, colors, links):
    """The exchange of shards on several devices: the host reads each
    device's owner offsets once, copies each owner's block of every
    device's send buffer to the owner's device (its received buffer holds
    its owners' blocks in turn), answers them there (one shard_answer a
    device) and copies the answers back into each asker device's send
    order."""
    n = mesh.size
    groups = mesh.groups()
    offs = [r.offsets.cpu().tolist() for r in routes]
    where = {}                                        # (owner, asker device) -> answer rows
    answers = []
    for d, (dev, owners) in enumerate(groups):
        blocks, starts, rows = [], [0], 0
        for t in owners:
            for c, r in enumerate(routes):
                lo, hi = offs[c][t], offs[c][t + 1]
                where[t, c] = (d, rows)
                blocks.append(r.send[lo:hi].to(dev))
                rows += hi - lo
            starts.append(rows)
        answers.append(sh.shard_answer(
            torch.cat(blocks), torch.tensor(starts, dtype=torch.int32).to(dev),
            [sg.buckets[t] for t in owners], [sg.edges[t] for t in owners], colors,
            None if links is None else [links.csr(t) for t in owners]))
    backs = []
    for c, (dev, _) in enumerate(groups):
        parts = []
        for t in range(n):
            d, row = where[t, c]
            parts.append(answers[d][row:row + offs[c][t + 1] - offs[c][t]].to(dev))
        backs.append(torch.cat(parts))
    return routes, backs, torch.tensor([sum(o[n] for o in offs)], dtype=torch.int32)


class _EndTest:
    """The walk loop's end test, END_TEST_LAG steps behind the device:
    each step's routed total is copied to pinned host memory without
    blocking, behind an event, and the host reads the total of the step
    that lies END_TEST_LAG steps back."""

    def __init__(self):
        self.lag, self.seen = END_TEST_LAG, 0
        self.host = self.events = None

    def ended(self, routed: torch.Tensor) -> bool:
        """Record this step's total; whether the step END_TEST_LAG back
        routed nothing."""
        on_card = routed.device.type == "cuda"
        if self.host is None:
            self.host = torch.empty(self.lag + 1, dtype=torch.int32, pin_memory=on_card)
            self.events = [torch.cuda.Event() if on_card else None for _ in self.host]
        i = self.seen % (self.lag + 1)
        self.host[i:i + 1].copy_(routed, non_blocking=on_card)
        if on_card:
            self.events[i].record(torch.cuda.current_stream(routed.device))
        self.seen += 1
        if self.seen <= self.lag:
            return False
        j = (self.seen - 1 - self.lag) % (self.lag + 1)
        if self.events[j] is not None:
            self.events[j].synchronize()
        return int(self.host[j]) == 0


def _tensor(x) -> torch.Tensor:
    """Tensors as they are; numpy uint32 as int32 bits, bool as uint8."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.uint8) if x.dtype == torch.bool else x
    a = np.ascontiguousarray(x)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    elif a.dtype == np.bool_:
        a = a.view(np.uint8)
    return torch.from_numpy(a.copy())


def _split(mesh: ShardMesh, x) -> list:
    """Rows split over the shards as P("shards") splits them, n contiguous
    blocks, gathered a device: the blocks of its shards in mesh order, on
    it (one tensor a device of mesh.groups())."""
    x = _tensor(x)
    n = mesh.size
    if x.shape[0] % n:
        raise ValueError(f"{x.shape[0]} rows do not split over {n} shards")
    per = x.shape[0] // n
    groups = mesh.groups()
    if len(groups) == 1:
        return [x.to(groups[0][0])]
    return [torch.cat([x[s * per:(s + 1) * per] for s in held]).to(dev) for dev, held in groups]


def _gather(mesh: ShardMesh, parts: list, dim: int = 0) -> torch.Tensor:
    """The inverse of _split: each device's part cut into its shards'
    blocks, concatenated in mesh order on the first shard's device."""
    groups = mesh.groups()
    first = mesh.devices[0]
    if len(groups) == 1:
        return parts[0].to(first)
    blocks = {}
    for part, (_, held) in zip(parts, groups):
        for s, block in zip(held, part.chunk(len(held), dim)):
            blocks[s] = block.to(first)
    return torch.cat([blocks[s] for s in range(mesh.size)], dim=dim)


def _lookup(mesh, sg, queries, colors, links=None):
    routes, backs, _ = routed_exchange(mesh, sg, _split(mesh, queries), colors, links)
    answers = [bk[r.slot.to(torch.int64)] for r, bk in zip(routes, backs)]
    return _gather(mesh, answers), _gather(mesh, [r.owner for r in routes])


def sharded_lookup_fn(mesh: ShardMesh, sg: ShardedGraph, colors):
    """f(canonical queries [B, W]) -> (idx int32 [B], the shard-local record
    or -1; owner int32 [B]; edge uint8 [B], the OR of the colours' edge
    bytes) with B split over the shards (mesh.py:169 with the walks'
    payload)."""
    def f(queries):
        ans, owner = _lookup(mesh, sg, queries, list(colors))
        return ans[:, sh.ANS_REC], owner, ans[:, sh.ANS_EDGE].to(torch.uint8)
    return f


def sharded_lookup_tree_fn(mesh: ShardMesh, sg: ShardedGraph, sl: ShardedLinks, colors):
    """f(canonical queries [B, W]) -> the linked walk's payload (mesh.py:199
    with :278-292): (edge uint8 [B]; the first MAX_ADD link rows' choices
    int32 [B, MAX_ADD, JW], lengths int32 [B, MAX_ADD] and forward bool
    [B, MAX_ADD], zero past the record's count; count int32 [B])."""
    def f(queries):
        ans, _ = _lookup(mesh, sg, queries, list(colors), sl)
        b = ans.shape[0]
        return (ans[:, sh.ANS_EDGE].to(torch.uint8),
                ans[:, sh.ANS_CHOICES:sh.ANS_LEN].reshape(b, wl.MAX_ADD, wl.JW),
                ans[:, sh.ANS_LEN:sh.ANS_FW], ans[:, sh.ANS_FW:sh.LINK_ANSWER] != 0,
                ans[:, sh.ANS_CNT])
    return f


# ---------------------------------------------------------------------------
# walks
# ---------------------------------------------------------------------------

def _walk(mesh, sg, seeds, active, colors, num_steps: int, links=None,
          cycle_check: bool = True) -> list:
    """The walk states of each device of mesh.groups() after the steps (its
    shards' walks as one batch): single-successor walks, or linked walks
    given the links (every walk is routed at the seed step, so that one
    inactive from the start still takes its k-mer's record-count overflow,
    as the JAX scan gives it).  A step is a route, an answer and a walk or
    linked step a device, with no host read when the mesh has one device;
    the loop stops END_TEST_LAG steps after the first step that routed no
    walk (_EndTest), the steps between changing nothing."""
    k = sg.kmer_size
    colors = list(colors)
    state = sh.WalkState if links is None else sh.LinkState
    states = [state.start(s, a, num_steps)
              for s, a in zip(_split(mesh, seeds), _split(mesh, active))]
    end = _EndTest()
    for step in range(num_steps):
        route_all = links is not None and step == 0
        routes, backs, routed = routed_exchange(
            mesh, sg, [st.cur for st in states], colors, links,
            None if route_all else [st.active for st in states])
        for st, r, bk in zip(states, routes, backs):
            if links is None:
                sh.shard_walk_step(st, r, bk, k, step, cycle_check)
            else:
                sh.link_step([st], [r], [bk], k, step)
        if end.ended(routed):
            break                  # no live walk: the rest of every stream is -1
    return states


def make_sharded_walk_step(mesh: ShardMesh, sg: ShardedGraph, colors, k: int):
    """One data-parallel frontier step over the sharded graph (mesh.py:548):
    fn(cur [B, W], active [B]) -> (cur int32 [B, W], advanced bool [B], the
    count of walks that advanced)."""
    if k != sg.kmer_size:
        raise ValueError(f"k = {k}, the graph's is {sg.kmer_size}")

    def run(cur, active):
        states = _walk(mesh, sg, cur, active, colors, 1, cycle_check=False)
        advanced = _gather(mesh, [st.active for st in states]).to(torch.bool)
        return _gather(mesh, [st.cur for st in states]), advanced, int(advanced.sum())

    return run


def make_sharded_walk_run(mesh: ShardMesh, sg: ShardedGraph, colors, k: int,
                          num_steps: int):
    """Multi-step walks over the sharded graph (mesh.py:391): single-
    successor advance, Brent cycle flags, -1 after a walk ends.
    fn(seeds [B, W], active [B]) -> (bases int8 [num_steps, B], cycled bool
    [B], steps int32 [B]); decode with ops.walk_np.replay_walk."""
    if k != sg.kmer_size:
        raise ValueError(f"k = {k}, the graph's is {sg.kmer_size}")

    def run(seeds, active):
        states = _walk(mesh, sg, seeds, active, colors, num_steps)
        return (_gather(mesh, [st.stream for st in states], dim=1),
                _gather(mesh, [st.cycled for st in states]).to(torch.bool),
                _gather(mesh, [st.steps for st in states]))

    return run


def make_sharded_linked_walk_run(mesh: ShardMesh, sg: ShardedGraph, sl: ShardedLinks,
                                 colors, k: int, num_steps: int):
    """Multi-step link-assisted walks over the sharded graph (mesh.py:263):
    a LinkStore a walk, the edge byte and the link rows of each step routed
    from their owning shards.  fn(seeds [B, W], active [B]) -> (emitted int8
    [num_steps, B], overflow bool [B], junctions int32 [B]); decode with
    ops.walk_links.decode_linked_walk."""
    if k != sg.kmer_size:
        raise ValueError(f"k = {k}, the graph's is {sg.kmer_size}")

    def run(seeds, active):
        states = _walk(mesh, sg, seeds, active, colors, num_steps, links=sl)
        return (_gather(mesh, [st.stream for st in states], dim=1),
                _gather(mesh, [st.overflow for st in states]).to(torch.bool),
                _gather(mesh, [st.junctions for st in states]))

    return run


def _both_ways(mesh: ShardMesh, run, seeds: list, k: int):
    """run() over the seeds and over their reverse complements, each batch
    padded to a multiple of the shard count with its first seed (mesh.py
    :483-484): ((outputs of the forward batch), (of the reverse), the
    reverse complements), each output cut to the seeds as numpy."""
    rc = [km.revcomp(s) for s in seeds]

    def batch(strs):
        padded = strs + [strs[0]] * ((-len(strs)) % mesh.size)
        out = run(km.pack_codes(km.strings_to_codes(padded), k),
                  np.ones(len(padded), dtype=bool))
        rows = out[0].t().cpu().numpy()[:len(strs)]
        return (rows, *(x.cpu().numpy()[:len(strs)] for x in out[1:]))

    return batch(seeds), batch(rc), rc


def sharded_assemble(mesh: ShardMesh, sg: ShardedGraph, colors, seeds: list,
                     max_steps: int) -> dict:
    """Bidirectional contigs of seed k-mer strings walked across the mesh
    (mesh.py:463; the sharded twin of commands.core._batched_contigs):
    {seed: contig}."""
    if not seeds:
        return {}
    k = sg.kmer_size
    run = make_sharded_walk_run(mesh, sg, colors, k, max_steps)
    (fb, fc, _), (rb, rcy, _), rc = _both_ways(mesh, run, list(seeds), k)
    out = {}
    for i, s in enumerate(seeds):
        fwd = replay_walk(s, fb[i], bool(fc[i]), max_steps)
        back = replay_walk(rc[i], rb[i], bool(rcy[i]), max_steps)
        out[s] = (km.revcomp(back) if back else "") + s + fwd
    return out


def sharded_assemble_links(mesh: ShardMesh, sg: ShardedGraph, sl: ShardedLinks, colors,
                           seeds: list, max_steps: int):
    """Bidirectional link-assisted contigs walked across the mesh (mesh.py
    :351; the sharded twin of LinkedWalker.assemble): (contigs {seed:
    contig}, overflow bool [B], junctions int32 [B])."""
    if not seeds:
        return {}, np.zeros(0, bool), np.zeros(0, np.int32)
    k = sg.kmer_size
    run = make_sharded_linked_walk_run(mesh, sg, sl, colors, k, max_steps)
    (fe, fo, fj), (re_, ro, rj), rc = _both_ways(mesh, run, list(seeds), k)
    contigs = {}
    for i, s in enumerate(seeds):
        fwd = wl.decode_linked_walk(s, fe[i], max_steps)
        back = wl.decode_linked_walk(rc[i], re_[i], max_steps)
        contigs[s] = (km.revcomp(back) if back else "") + s + fwd
    return contigs, fo | ro, fj + rj


# ---------------------------------------------------------------------------
# FindROIs and Call
# ---------------------------------------------------------------------------

def make_sharded_find_rois(mesh: ShardMesh, sg: ShardedGraph, child_color: int,
                           parent_colors: list):
    """Sharded FindROIs scan (mesh.py:502; FindROIs.java:72-82: novel iff
    the child's coverage is > 0 and every parent's is 0): fn() -> (a bool
    mask of each shard's records, the total)."""
    parents = list(parent_colors)

    def run():
        masks = []
        for covs in sg.coverages:
            mask = covs[:, child_color] != 0
            for p in parents:
                mask &= covs[:, p] == 0
            masks.append(mask)
        return masks, sum(int(m.sum()) for m in masks)

    return run


def sharded_find_rois_kmers(mesh: ShardMesh, sg: ShardedGraph, child_color: int,
                            parent_colors: list) -> np.ndarray:
    """ROI k-mers (canonical uint32 words, lexicographically sorted, the
    order FindROIs writes records in) from the sharded scan (mesh.py:533)."""
    masks, _ = make_sharded_find_rois(mesh, sg, child_color, parent_colors)()
    kmers = np.concatenate([km_s[m].cpu().numpy().view(np.uint32)
                            for km_s, m in zip(sg.kmers, masks)])
    order = np.argsort(km.words_to_bytes_be(kmers, sg.kmer_size), kind="stable")
    return kmers[order]


def sharded_call(mesh: ShardMesh, graph, rois, partitions: list, backgrounds, references,
                 caller_opts: dict | None = None):
    """Partition-parallel Call over the mesh (mesh.py:598): partitions
    round-robin over the shards, a `Caller` a shard on its device (the
    current CUDA device while it runs, as jax.default_device is there), the
    shards' calls re-inserted in the partitions' order into one
    VariantSorterSet (first insert wins on comparator ties), so that the
    result equals one Caller's.  Returns (variants, the ROI k-mer set).  A
    call whose PARTITION_NAME names no partition of its shard raises (the
    JAX package sorts it last, by a sentinel)."""
    from ..caller.call import Caller
    from ..caller.variants import VariantSorterSet

    n = mesh.size
    opts = dict(caller_opts or {})
    tagged = []
    for i, dev in enumerate(mesh.devices):
        sub = [(gi, partitions[gi]) for gi in range(i, len(partitions), n)]
        if not sub:
            continue
        with torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext():
            vs, _ = Caller(graph, rois, [p for _, p in sub], backgrounds=list(backgrounds),
                           references=references, device=dev, **opts).call()
        order = {p[0].split(" ")[0]: gi for gi, p in sub}
        for j, v in enumerate(vs):
            name = v.get_attr("PARTITION_NAME", "")
            if name not in order:
                raise RuntimeError(f"sharded_call: a call of partition {name!r}, which shard "
                                   f"{i} was not given")
            tagged.append((order[name], j, v))
    tagged.sort(key=lambda t: (t[0], t[1]))
    mc = Caller(graph, rois, partitions, backgrounds=list(backgrounds), references=references,
                device=mesh.devices[0], **opts)
    svcs = VariantSorterSet({name: i for i, (name, _) in enumerate(mc.sequence_dictionary())})
    for _, _, v in tagged:
        svcs.add(v)
    return svcs.to_list(), mc.load_rois()
