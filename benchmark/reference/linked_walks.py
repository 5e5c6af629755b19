"""Plain reference of the linked walk: what LinkedWalker.walk_words must
return for a seed, worked out from the child's genome and the links file.

The graph is the child colour's, from its chromosomes
(reference/walks.ChildGraph: an oriented k-mer's out-edges and the group
after its one out-edge), with the group after each out-edge of a junction
taken from the genome's positions.  The links are parsed from the .ctp.gz
that set-up wrote, here with their own few lines.  A walk runs one lane at a
time with a store of link elements, as McCortex's LinkStore
(LinkStore.java:14-159) runs it and the port's walker states it
(corticall_tpu_torch/ops/walk_links.py's module docstring):
- arriving at a k-mer adds its records that face the walk's way, each
  element at position 0 and age 0;
- at a junction the oldest live elements must agree on their next choice,
  and the latest element of the chosen list gives the base; without an
  agreed choice, or with a choice that is no out-edge, the walk stops;
- consuming a choice advances the elements that agree and have choices
  left, and expires the rest;
- ages bump once at a junction and once at a step whose store holds an
  element of age 0;
- the seed step follows the out-degree only and consults no store (its
  arrivals stay at age 0).

The port's kept quirks, each a departure from McCortex (ROADMAP §1), are
followed here:
- at most MAX_ADD = 16 records of a k-mer are looked at, the first in file
  order; a k-mer with more sets the overflow flag;
- the store holds CAP = 32 elements: a record goes to the free slot of its
  rank among the arriving records, and one that finds no slot is lost and
  sets the overflow flag;
- records of more than MAX_J = 32 choices are dropped when the links are
  loaded, without a flag;
- the elements of "one list" are those whose choices pack to the same
  2-bit words (same_list): "AC" and "ACA" are one list (A is 0), where
  McCortex keeps two;
- the oldest and the latest are the first slot among equals (argmax).
A step whose store is empty at a k-mer without records is the plain walk's
step: one out-edge, or stop.

Returns per lane what walk_words returns: the emitted row (base | 8 while
the store holds an element, -1 after the walk ended), the overflow flag, the
steps and the junctions a link choice resolved.  Imports nothing of the
program.
"""

from __future__ import annotations

import gzip

import numpy as np
import torch

from benchmark.reference import walks

MAX_ADD = 16
CAP = 32
MAX_J = 32
CODE = {"A": 0, "C": 1, "G": 2, "T": 3}
_POP = np.array([bin(x).count("1") for x in range(16)], dtype=np.int64)
_COMP = str.maketrans("ACGT", "TGCA")


def read_ctp(path: str) -> dict:
    """{k-mer string: [(forward, choices)]} of a McCortex .ctp.gz, records
    in file order: past the JSON header, `<kmer> <n>` lines each followed
    by n lines `F|R <n> <coverages> <choices>`."""
    with gzip.open(path, "rt") as f:
        lines = f.read().splitlines()
    i, depth = 0, 0
    while True:                                   # the header: to its closing brace
        depth += lines[i].count("{") - lines[i].count("}")
        i += 1
        if depth == 0 and i > 1:
            break
    out = {}
    while i < len(lines):
        head = lines[i].split()
        i += 1
        if not head:
            continue
        recs = []
        for line in lines[i:i + int(head[1])]:
            part = line.split()
            recs.append((part[0] == "F", part[3]))
        i += int(head[1])
        out[head[0]] = recs
    return out


def pack_kmers(kmers: list, k: int) -> torch.Tensor:
    """int64 [n, W] words of k-mer strings, the first base highest."""
    w = (k + 15) // 16
    out = torch.zeros((len(kmers), w), dtype=torch.int64)
    for r, s in enumerate(kmers):
        for i, ch in enumerate(s):
            p = 2 * (k - 1 - i)
            out[r, w - 1 - p // 32] |= CODE[ch] << (p % 32)
    return out


def _words_of(choices: str) -> int:
    """The choices packed 2 bits a choice, the first lowest: the words the
    port compares."""
    return sum(CODE[c] << (2 * j) for j, c in enumerate(choices))


class LinkedChild:
    """The child graph with its links, for walking lanes."""

    def __init__(self, chroms: list, k: int, links: dict, device):
        self.k = k
        cg = walks.ChildGraph(chroms, k, device)
        self.graph = cg
        n_groups = cg.outmask.shape[0]
        # a junction's successors by base: from each position whose group
        # has several out-edges, the next position's group
        seqs = []
        for c in chroms:
            seqs.append(c)
            seqs.append((3 - c[::-1]).astype(np.uint8))
        self.branch = {}
        for s, st in zip(seqs, cg.start):
            n = len(s) - k + 1
            g = cg.gid[st:st + n]
            at = np.nonzero(_POP[cg.outmask[g[:-1]]] > 1)[0]
            for p, b, g1 in zip(at, s[at + k], g[at + 1]):
                self.branch[(int(g[p]), int(b))] = int(g1)
        # each link k-mer's two oriented groups: the records there, and
        # whether the group is the canonical k-mer's reverse complement
        gw = torch.zeros((n_groups, cg.words.shape[1]), dtype=torch.int64,
                         device=cg.words.device)
        gw[torch.from_numpy(cg.gid).to(cg.words.device)] = cg.words
        self.records = {}
        keys = [s for s in links if len(s) == k]
        rcs = [s.translate(_COMP)[::-1] for s in keys]
        canon = [min(s, r) for s, r in zip(keys, rcs)]
        for flipped, oriented in ((False, canon), (True, [s.translate(_COMP)[::-1]
                                                         for s in canon])):
            if not oriented:
                continue
            q = pack_kmers(oriented, k).to(gw.device)
            g = _find(gw, q)
            for key, gi in zip(keys, g.tolist()):
                if gi >= 0:
                    recs = [(fw, ch) for fw, ch in links[key] if len(ch) <= MAX_J]
                    if recs:
                        prev = self.records.get(gi, (flipped, []))[1]
                        self.records[gi] = (flipped, prev + recs)
        self.linked = np.zeros(n_groups, dtype=bool)
        self.linked[list(self.records)] = True

    def walk(self, start: np.ndarray, num_steps: int, use_links: bool = True):
        """Lanes from oriented groups `start`: (emitted int8 [n, T], overflow
        bool [n], steps int32 [n], junctions int32 [n]).  use_links False
        walks as if the link set were empty: the control."""
        cg = self.graph
        n = start.shape[0]
        g = start.astype(np.int64).copy()
        emitted = np.full((n, num_steps), -1, dtype=np.int8)
        overflow = np.zeros(n, dtype=bool)
        steps = np.zeros(n, dtype=np.int32)
        junctions = np.zeros(n, dtype=np.int32)
        stores = [[None] * CAP for _ in range(n)]
        nonempty = np.zeros(n, dtype=bool)
        active = np.ones(n, dtype=bool)
        linked = self.linked if use_links else np.zeros_like(self.linked)
        for t in range(num_steps):
            lanes = np.nonzero(active)[0]
            if not lanes.size:
                break
            gl = g[lanes]
            busy = linked[gl] | nonempty[lanes]
            # the plain step: one out-edge, or stop
            idle = lanes[~busy]
            one = _POP[cg.outmask[g[idle]]] == 1
            go = idle[one]
            emitted[go, t] = cg.succ_base[g[go]]
            g[go] = cg.succ[g[go]]
            active[idle[~one]] = False
            for i in lanes[busy]:
                flipped, recs = self.records.get(int(g[i]), (False, []))
                base, took, overflow[i] = _store_step(
                    stores[i], recs, flipped, int(cg.outmask[g[i]]), t, overflow[i])
                if base < 0:
                    active[i] = False
                    continue
                nonempty[i] = any(stores[i])
                emitted[i, t] = base | (8 if nonempty[i] else 0)
                junctions[i] += took
                g[i] = (self.branch[(int(g[i]), base)] if took else int(cg.succ[g[i]]))
        steps[:] = (emitted >= 0).sum(axis=1)
        return emitted, overflow, steps, junctions


def _find(sorted_words: torch.Tensor, q: torch.Tensor) -> np.ndarray:
    """Row of each query in lexicographically sorted unique rows, or -1."""
    n = sorted_words.shape[0]
    lo = torch.zeros(q.shape[0], dtype=torch.int64, device=q.device)
    hi = torch.full_like(lo, n)
    for _ in range(max(n, 1).bit_length() + 1):
        mid = torch.clamp((lo + hi) // 2, max=n - 1)
        row = sorted_words[mid]
        less = torch.zeros_like(lo, dtype=torch.bool)
        decided = torch.zeros_like(less)
        for j in range(q.shape[1]):
            less |= ~decided & (row[:, j] < q[:, j])
            decided |= row[:, j] != q[:, j]
        open_ = lo < hi
        lo = torch.where(open_ & less, mid + 1, lo)
        hi = torch.where(open_ & ~less, mid, hi)
    at = torch.clamp(lo, max=n - 1)
    hit = (lo < n) & (sorted_words[at] == q).all(dim=1)
    return torch.where(hit, lo, -1).cpu().numpy()


def _store_step(store: list, recs: list, flipped: bool, outmask: int, t: int,
                overflow: bool):
    """One step of an active walk at a k-mer with records `recs` ([(forward,
    choices)], file order) seen from the walk's orientation (`flipped`:
    the walk holds the reverse complement of the keyed k-mer) and out-edges
    `outmask`.  `store` is CAP slots, each None or [choices, position, age,
    sequence], changed in place.  Returns (base or -1 where the walk stops,
    1 where a link choice took a junction, the overflow flag)."""
    first = t == 0
    # arrival: the first MAX_ADD records, those facing the walk, into the
    # free slots by rank
    facing = [j for j, (fw, _) in enumerate(recs[:MAX_ADD]) if fw != flipped]
    free = [s for s in range(CAP) if store[s] is None]
    for j, s in zip(facing, free):
        store[s] = [recs[j][1], 0, 0, t * MAX_ADD + j]
    overflow = overflow or len(facing) > len(free) or len(recs) > MAX_ADD
    # the junction's choice from the oldest elements
    live = [s for s in range(CAP) if store[s] is not None and store[s][1] < len(store[s][0])]
    char = {s: store[s][0][store[s][1]] for s in live}
    choice = None
    if live:
        oldest_age = max(store[s][2] for s in live)
        oldest = [s for s in live if store[s][2] == oldest_age]
        rep = oldest[0]
        if all(char[s] == char[rep] for s in oldest):
            words = _words_of(store[rep][0])
            same = [s for s in range(CAP) if store[s] is not None
                    and _words_of(store[s][0]) == words]
            latest = max(same, key=lambda s: (store[s][3], -s))
            choice = CODE[char[latest]]
    degree = _POP[outmask]
    junction = degree > 1
    took = junction and not first and choice is not None and (outmask >> choice) & 1
    if degree == 1:
        base = int(np.log2(outmask))
    elif took:
        base = choice
    else:
        base = -1
    if took:
        letter = "ACGT"[choice]
        for s in range(CAP):
            el = store[s]
            if el is not None:
                keep = el[0][el[1]] == letter and el[1] + 1 < len(el[0])
                if keep:
                    el[1] += 1
                else:
                    store[s] = None
    if not first:
        bump = int(junction) + int(any(el is not None and el[2] == 0 for el in store))
        for el in store:
            if el is not None:
                el[2] += bump
    return base, int(bool(took)), overflow
