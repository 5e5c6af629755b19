"""The least time one H100 could take for a ctk_link_walk call: frozen here.

The bound is benchmark/counts/bounds.bound_ms of the call's bytes and
operations, worked out on the device from the seeds and the bases the walks
emitted, with the benchmark's own graph and links (it reads nothing of the
program but the shape of its table's buckets):
- bytes: the seeds in; out, 3 bits a walk step (a base and the store bit)
  and the three fields a lane (overflow a byte, steps and junctions 4 each);
  for each distinct k-mer the walks looked up (each a record: a walk moves
  from a record by the graph's edges), one bucket row of the table, its
  edge byte and the CSR offsets around it (4 bytes each, each offset once);
  the link-pool rows (13 bytes: choices 8, length 4, orientation 1) of the
  link-carrying ones, at most MAX_ADD a record;
- operations: `link_step_ops` for every step a walk looked its k-mer up,
  with no store state charged (`before` and `after` -1).
A walk looks its k-mer up at each step while it is active: its steps and,
where it stopped before the cap, once more.  The operation counts are
copies of chip_smoke.py's (LINK_*_OPS, link_kmer_ops, link_step_ops).
"""

from __future__ import annotations

import torch

from benchmark.counts.bounds import bound_ms

MAX_ADD = 16                 # link records of a k-mer that a walk looks at
CAP = 32                     # link elements a walk's store holds
LINK_POOL_ROW_BYTES = 13     # choices 8, length 4, orientation 1
LANE_OUT_BYTES = 1 + 4 + 4   # overflow, steps, junctions
M32 = 0xFFFFFFFF
# 32-bit integer operations of linked walk steps, one an elementwise
# operation on a 32-bit value; link_step_ops charges each part only at the
# steps whose data need it
LINK_RECORD_OPS = 5          # a record of the k-mer's first MAX_ADD: index, j < cnt,
                             # orientation, 2 ANDs
LINK_FREE_OPS = 2            # a store slot at a step that adds records: free, its rank
LINK_GATED_OPS = 3           # a gated record: its rank, the overflow test and OR
LINK_FILL_OPS = 7            # an element filled: 2 choice words, length, position, age,
                             # sequence, valid
LINK_AGE_OPS = 5             # a valid element after a step past the seed
LINK_JUNCTION_OPS = 10       # a junction past the seed
LINK_JUNCTION_ELEMENT_OPS = 32   # a valid element there


def link_kmer_ops(w: int, bs: int) -> int:
    """A walk step's k-mer work at W words and bucket size BS: the canonical
    form, the hash and the second bucket, the lookup over both buckets' BS
    slots, the record's edge byte, successors, CSR count and counters, and
    shift_append with the emission."""
    return (28 * w + 1) + (10 * w + 19) + 2 * bs * (2 * w + 2) + 30 + (4 * w + 9)


def link_step_ops(kmer_ops: int, first, cnt, gated, before, after, succ):
    """Operations of walk steps, one entry a step (int64 tensors; `first` a
    bool one): the k-mer's work, its `cnt` records (at most MAX_ADD) gated,
    store_add where `gated` of them face the walk's way, the junction choice
    at a step past the seed whose k-mer has `succ` > 1 successors, over the
    valid elements after the add, and the ageing over those after the step.
    `before` / `after` are the store's valid elements before and after the
    step; -1 (not known) charges no element work."""
    known = after >= 0
    before = before.clamp(min=0)
    filled = torch.where(known, torch.minimum(gated, CAP - before), 0)
    held = torch.where(known, before + filled, 0)
    add = torch.where(gated > 0, LINK_FREE_OPS * CAP + LINK_GATED_OPS * gated
                      + LINK_FILL_OPS * filled, 0)
    choose = torch.where(~first & (succ > 1), LINK_JUNCTION_OPS
                         + LINK_JUNCTION_ELEMENT_OPS * held, 0)
    age = torch.where(first, 1, LINK_AGE_OPS) * after.clamp(min=0)
    return kmer_ops + LINK_RECORD_OPS * cnt + add + choose + age


class Records:
    """The benchmark's graph and links as the bound reads them: the child's
    records (sorted canonical words int64 [N, W]), their child edge bytes,
    and a record's link count (int64 [N], at most MAX_ADD) and forward ones
    among those."""

    def __init__(self, kmers: torch.Tensor, edges: torch.Tensor, counts: torch.Tensor,
                 forward: torch.Tensor):
        self.kmers = kmers
        self.edges = edges.to(torch.int64)
        self.counts = counts.clamp(max=MAX_ADD)
        self.forward = forward
        # rows are found by a key of their first two words where it fits
        # 63 bits (odd k), else the first, then a scan over equal keys
        self.two = kmers.shape[1] > 1 and bool((kmers[:, 0] < 1 << 31).all())
        self.key = self.keys(kmers)
        if kmers.shape[0] > 1:
            runs = torch.unique_consecutive(self.key, return_counts=True)[1]
            self.widest = int(runs.max())
        else:
            self.widest = 1

    def keys(self, words: torch.Tensor) -> torch.Tensor:
        return words[:, 0] << 32 | words[:, 1] if self.two else words[:, 0].contiguous()

    def find(self, canon: torch.Tensor) -> torch.Tensor:
        """Record of each canonical k-mer (int64 [B, W]), or -1."""
        n = self.kmers.shape[0]
        lo = torch.searchsorted(self.key, self.keys(canon))
        rec = torch.full_like(lo, -1)
        for d in range(self.widest):
            at = torch.clamp(lo + d, max=n - 1)
            hit = (lo + d < n) & (self.kmers[at] == canon).all(dim=1)
            rec = torch.where(hit & (rec < 0), at, rec)
        return rec


def _roll(fwd: torch.Tensor, rc: torch.Tensor, base: torch.Tensor, k: int):
    """The k-mer after appending `base` (int64 [B]) to each, and its reverse
    complement, from a k-mer's words and its reverse complement's."""
    w = fwd.shape[1]
    top = 2 * k - 32 * (w - 1)                     # bits of the first word
    nf, nr = torch.empty_like(fwd), torch.empty_like(rc)
    for j in range(w):
        low = fwd[:, j + 1] >> 30 if j + 1 < w else base
        nf[:, j] = ((fwd[:, j] << 2) | low) & M32
        high = (rc[:, j - 1] & 3) << 30 if j else (3 - base) << (top - 2)
        nr[:, j] = (rc[:, j] >> 2) | high
    nf[:, 0] &= (1 << top) - 1
    return nf, nr


def _less(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    less = torch.zeros(a.shape[0], dtype=torch.bool, device=a.device)
    decided = torch.zeros_like(less)
    for j in range(a.shape[1]):
        less |= ~decided & (a[:, j] < b[:, j])
        decided |= a[:, j] != b[:, j]
    return less


def _revcomp(words: torch.Tensor, k: int) -> torch.Tensor:
    w = words.shape[1]
    out = torch.zeros_like(words)
    for i in range(k):
        p = 2 * (k - 1 - i)
        code = (words[:, w - 1 - p // 32] >> (p % 32)) & 3
        q = 2 * i
        out[:, w - 1 - q // 32] |= (3 - code) << (q % 32)
    return out


def link_walk_reads(records: Records, seeds: torch.Tensor, emitted: torch.Tensor, k: int,
                    bucket_size: int) -> dict:
    """What the walks' lookups touched and the operations of their steps,
    replayed from the seeds (int64 [B, W], walk-oriented) and the emitted
    bases (int8 [B, T], -1 after a walk ended): the distinct k-mers looked up
    (`kmers`; each is a record, since a walk moves by the graph's edges from
    a record), the distinct CSR offsets around them (`offsets`), their
    link-pool rows (`pool_rows`), the lookups (`walk_steps`) and the
    operations (`ops`).  Every lane steps together, a stopped one masked, so
    that a step waits on nothing."""
    dev = seeds.device
    n = records.kmers.shape[0]
    fwd = seeds.clone()
    rc = _revcomp(seeds, k)
    kmer_ops = link_kmer_ops(seeds.shape[1], bucket_size)
    alive = torch.ones(seeds.shape[0], dtype=torch.bool, device=dev)
    seen = torch.zeros(n, dtype=torch.int32, device=dev)
    missed = torch.zeros((), dtype=torch.int64, device=dev)
    ops = torch.zeros((), dtype=torch.int64, device=dev)
    walk_steps = torch.zeros((), dtype=torch.int64, device=dev)
    none = torch.full((seeds.shape[0],), -1, dtype=torch.int64, device=dev)
    for t in range(emitted.shape[1]):
        if t % 64 == 0 and not bool(alive.any()):
            break
        flipped = _less(rc, fwd)
        rec = records.find(torch.where(flipped[:, None], rc, fwd))
        found = rec >= 0
        r = rec.clamp(min=0)
        seen.scatter_reduce_(0, r, (alive & found).to(torch.int32), reduce="amax")
        missed += (alive & ~found).sum()
        e = torch.where(found, records.edges[r], 0)
        succ = torch.where(flipped, e >> 4, e & 0xF)
        succ = sum((succ >> b) & 1 for b in range(4))
        cnt = torch.where(found, records.counts[r], 0)
        nfw = torch.where(found, records.forward[r], 0)
        gated = torch.where(flipped, cnt - nfw, nfw)
        step = link_step_ops(kmer_ops, torch.full_like(found, t == 0), cnt, gated, none, none,
                             succ)
        ops += torch.where(alive, step, 0).sum()
        walk_steps += alive.sum()
        v = emitted[:, t].to(torch.int64)
        alive = alive & (v >= 0)
        fwd, rc = _roll(fwd, rc, v & 3, k)
    if int(missed):
        raise ValueError(f"{int(missed)} lookups of k-mers that are no record")
    seen = seen.bool()
    offsets = torch.zeros(n + 1, dtype=torch.bool, device=dev)
    offsets[:-1] |= seen
    offsets[1:] |= seen
    return {"kmers": int(seen.sum()), "offsets": int(offsets.sum()),
            "pool_rows": int(records.counts[seen].sum()), "walk_steps": int(walk_steps),
            "ops": int(ops)}


def link_walk_bound(records: Records, seeds: torch.Tensor, emitted: torch.Tensor,
                    steps: torch.Tensor, k: int, bucket_size: int):
    """(least time in ms, "bytes" or "operations") of one ctk_link_walk call
    on `seeds` that emitted `emitted` and walked `steps` (int64 [B]), over a
    table of `bucket_size`-entry buckets."""
    reads = link_walk_reads(records, seeds, emitted, k, bucket_size)
    w = seeds.shape[1]
    row_bytes = bucket_size * (w + 1) * 4
    nbytes = (4 * seeds.numel() + (3 * int(steps.sum()) + 7) // 8
              + LANE_OUT_BYTES * seeds.shape[0] + reads["kmers"] * (row_bytes + 1)
              + 4 * reads["offsets"]
              + LINK_POOL_ROW_BYTES * reads["pool_rows"])
    return bound_ms(nbytes, reads["ops"])
