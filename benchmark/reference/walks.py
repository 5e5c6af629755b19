"""Plain reference of the bulk walk: what walk_forward_jumps must return for
a seed, worked out from the child's genome.

The child colour's de Bruijn graph is taken over oriented k-mers: the
out-edges of an oriented k-mer x are the bases b such that x + b occurs on
either strand of a child chromosome.  A walk from a seed appends the base of
the one out-edge while there is exactly one, and stops at the first k-mer
with none (a dead end) or with several (a junction), or at the cap.  Walk
results are reported in jump slots of 32 bases (the table's rows): a lane
reads a row after 0, 32, 64, ... bases, so `ends_junction` is whether the run
of the last row read ends at a junction: a stop within the cap, or a
junction fewer than 32 bases past the last row start before the cap.  The
oriented k-mers are grouped by sorting on the device (plain PyTorch); the
walks run on the host.  Imports nothing of the program.
"""

from __future__ import annotations

import numpy as np
import torch

JUMP = 32
_POP = np.array([bin(x).count("1") for x in range(16)], dtype=np.int64)


def _words(codes: torch.Tensor, k: int) -> torch.Tensor:
    """int64 [n-k+1, W] words of every k-mer, the first base highest,
    right-aligned in 32-bit words."""
    n, w = codes.shape[0] - k + 1, (k + 15) // 16
    c = codes.to(torch.int64)
    out = torch.zeros((n, w), dtype=torch.int64, device=codes.device)
    for i in range(k):
        p = 2 * (k - 1 - i)
        out[:, w - 1 - p // 32] |= c[i:i + n] << (p % 32)
    return out


class ChildGraph:
    """The child's oriented k-mers, grouped: `outmask[g]` (bit b: base b
    follows), `succ[g]` and `succ_base[g]` (the group after the one
    out-edge, and its base), and the group of
    each position of each oriented chromosome (2 c + strand, strand 1 the
    reverse complement)."""

    def __init__(self, chroms: list, k: int, device):
        self.k = k
        seqs = []
        for c in chroms:
            seqs.append(c)
            seqs.append((3 - c[::-1]).astype(np.uint8))
        words, nxt, self.start = [], [], []
        total = 0
        for s in seqs:
            codes = torch.from_numpy(np.ascontiguousarray(s)).to(device)
            wd = _words(codes, k)
            n = wd.shape[0]
            nb = torch.full((n,), -1, dtype=torch.int64, device=device)
            nb[:n - 1] = codes[k:].to(torch.int64)
            words.append(wd)
            nxt.append(nb)
            self.start.append(total)
            total += n
        words = torch.cat(words)
        nxt = torch.cat(nxt)
        order = torch.arange(total, device=device)
        for j in range(words.shape[1] - 1, -1, -1):
            order = order[torch.sort(words[order, j], stable=True).indices]
        srt = words[order]
        new = torch.ones(total, dtype=torch.int64, device=device)
        new[1:] = (srt[1:] != srt[:-1]).any(dim=1).to(torch.int64)
        gid = torch.empty(total, dtype=torch.int64, device=device)
        gid[order] = torch.cumsum(new, 0) - 1
        del srt, order, new
        n_groups = int(gid.max()) + 1
        has = nxt >= 0
        outmask = torch.zeros(n_groups, dtype=torch.int64, device=device)
        for b in range(4):
            one = torch.zeros(n_groups, dtype=torch.int64, device=device)
            one.scatter_reduce_(0, gid[has], (nxt[has] == b).to(torch.int64), reduce="amax")
            outmask |= one << b
        # the next position's group and the base that leads there (a
        # position with a next base is never the last of its sequence); of
        # a junction's successors, the one of the highest group
        pos = torch.nonzero(has).squeeze(1)
        key = torch.full((n_groups,), -1, dtype=torch.int64, device=device)
        key.scatter_reduce_(0, gid[pos], 4 * gid[pos + 1] + nxt[pos], reduce="amax")
        self.words = words
        self.gid = gid.cpu().numpy()
        self.outmask = outmask.cpu().numpy()
        key = key.cpu().numpy()
        self.succ, self.succ_base = key >> 2, key & 3

    def position(self, chrom: np.ndarray, strand: np.ndarray, q: np.ndarray) -> np.ndarray:
        return np.asarray(self.start)[2 * chrom + strand] + q

    def seed_words(self, index: np.ndarray) -> np.ndarray:
        return self.words[torch.from_numpy(index).to(self.words.device)].cpu().numpy()


def walk(graph: ChildGraph, start: np.ndarray, cap: int, stop_at_junctions: bool = True):
    """Walk lanes from groups `start` for cap + 32 bases.  Returns (bases
    uint8 [n, cap + 32], d int64 [n]: the steps to the first k-mer with an
    out-degree other than one (cap + 33 when none), deg_d [n]: its
    out-degree, cyclic bool [n]: a k-mer repeats within the first min(d,
    cap) + 1).  `stop_at_junctions` False walks on through a junction by
    one of its edges: the control's broken guarantee."""
    n, horizon = start.shape[0], cap + JUMP
    g = start.astype(np.int64).copy()
    bases = np.zeros((n, horizon), dtype=np.uint8)
    d = np.full(n, horizon + 1, dtype=np.int64)
    deg_d = np.zeros(n, dtype=np.int64)
    seen = np.empty((n, cap + 1), dtype=np.int64)
    for j in range(horizon + 1):
        m = graph.outmask[g]
        deg = _POP[m]
        stop = deg == 0 if not stop_at_junctions else deg != 1
        newly = (d > horizon) & stop
        d[newly], deg_d[newly] = j, deg[newly]
        if j <= cap:
            seen[:, j] = np.where(d >= j, g, -1 - j)
        if j == horizon:
            break
        live = d > horizon
        bases[live, j] = graph.succ_base[g[live]]
        g = np.where(live, graph.succ[g], g)
    srt = np.sort(seen, axis=1)
    cyclic = ((srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] >= 0)).any(axis=1)
    return bases, d, deg_d, cyclic


def expected(bases, d, deg_d, cap: int):
    """walk_forward_jumps' outputs for lanes that do not cycle: (packed
    uint32 [n, 2T], steps int32, cycled, saturated, touched, ends_junction)
    with T = ceil(cap / 32) + 2 jump slots."""
    n = bases.shape[0]
    slots = -(-cap // JUMP) + 2
    steps = np.minimum(d, cap)
    b = np.zeros((n, slots * JUMP), dtype=np.uint64)
    b[:, :bases.shape[1]] = bases[:, :slots * JUMP]
    b[np.arange(slots * JUMP)[None, :] >= steps[:, None]] = 0
    shifts = (62 - 2 * np.arange(JUMP)).astype(np.uint64)
    val = (b.reshape(n, slots, JUMP) << shifts).sum(axis=2, dtype=np.uint64)
    packed = np.empty((n, 2 * slots), dtype=np.uint32)
    packed[:, 0::2] = (val >> np.uint64(32)).astype(np.uint32)
    packed[:, 1::2] = (val & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    last_row = JUMP * ((cap - 1) // JUMP)
    endj = (deg_d >= 2) & (d < last_row + JUMP)
    zeros = np.zeros(n, dtype=bool)
    return packed, steps.astype(np.int32), zeros, steps >= cap, zeros.copy(), endj
