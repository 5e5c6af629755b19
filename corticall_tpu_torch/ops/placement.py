"""Host hashing and two-choice cuckoo placement (numpy).

Copies of corticall_tpu/ops/hashtable.py::_np_mix32 / np_hash_words and
corticall_tpu/ops/cuckoo.py::_np_h2 / _place: `place` is the jump and walk
tables' placement (load 0.5, 2-entry buckets, primary bucket first),
`place_cuckoo` all of _place's paths.  Those modules import jax at
module level and the port never imports jax, so it carries these copies; the
CPU tests hold them bit for bit against the originals.  The device lookups
(ops/kmer.hash_words, csrc/jump.cu) hash with the same bits, so a key is
found in the bucket this placement put it in.
"""

from __future__ import annotations

import numpy as np

GOLDEN = 0x9E3779B9


def np_mix32(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.uint32)
    x ^= x >> np.uint32(16)
    x *= np.uint32(0x7FEB352D)
    x ^= x >> np.uint32(15)
    x *= np.uint32(0x846CA68B)
    x ^= x >> np.uint32(16)
    return x


def np_hash_words(words: np.ndarray) -> np.ndarray:
    """uint32[..., W] -> uint32[...]; the bits of ops/kmer.hash_words."""
    h = np.full(words.shape[:-1], 0x811C9DC5, dtype=np.uint32)
    for i in range(words.shape[-1]):
        h = np_mix32(h ^ words[..., i].astype(np.uint32)) * np.uint32(0x01000193)
    return np_mix32(h)


def np_h2(h: np.ndarray) -> np.ndarray:
    """Second bucket hash."""
    return np_mix32(h ^ np.uint32(GOLDEN))


LOAD_FACTOR = 0.5            # keys a slot, at most: the bucket count doubles until met
BUCKET_SIZE = 2              # entries a bucket


def place(kmers: np.ndarray):
    """The jump and walk tables' cuckoo placement, place_cuckoo(kmers, 0.5,
    None, 2, True): -> (nb, bucket_of int64[N], pos_of int32[N])."""
    return place_cuckoo(kmers, LOAD_FACTOR, None, BUCKET_SIZE, True)[:3]


def place_cuckoo(kmers: np.ndarray, load_factor: float, num_buckets: int | None,
                 bucket_size: int, primary_bias: bool):
    """cuckoo._place with all of its paths: -> (nb, bucket_of int64[N],
    pos_of int32[N], h1 int64[N]).  Batched greedy rounds, then a serial
    eviction walk (default_rng(0)) for the keys both of whose buckets are
    full.  num_buckets (a power of two) fixes the table size, as shard tables
    need; primary_bias tries a key's h1 bucket first, else a key goes to the
    emptier of its two buckets."""
    n, _ = kmers.shape
    if num_buckets is not None:
        nb = num_buckets
        assert nb & (nb - 1) == 0 and nb * bucket_size >= n
    else:
        nb = 4
        while nb * bucket_size * load_factor < max(n, 1):
            nb *= 2
    mask = np.uint32(nb - 1)

    h = np_hash_words(kmers)
    h1 = (h & mask).astype(np.int64)
    h2 = (np_h2(h) & mask).astype(np.int64)

    counts = np.zeros(nb, dtype=np.int32)
    bucket_of = np.full(n, -1, dtype=np.int64)
    pos_of = np.full(n, -1, dtype=np.int32)

    pending = np.arange(n, dtype=np.int64)
    while pending.size:
        c1 = counts[h1[pending]]
        if primary_bias:
            t = np.where(c1 < bucket_size, h1[pending], h2[pending])
        else:
            t = np.where(counts[h2[pending]] < c1, h2[pending], h1[pending])
        cap = bucket_size - counts[t]
        # rank pending keys within each proposed bucket; the first `cap` win
        order = np.argsort(t, kind="stable")
        ts = t[order]
        first = np.ones(len(ts), dtype=bool)
        first[1:] = ts[1:] != ts[:-1]
        grp_start = np.maximum.accumulate(np.where(first, np.arange(len(ts)), 0))
        rank = np.arange(len(ts)) - grp_start
        winner = np.zeros(len(t), dtype=bool)
        winner[order] = rank < cap[order]
        if not winner.any():
            break                     # both buckets full for every pending key
        wk_keys = pending[winner]
        wt = t[winner]
        wr = np.zeros(len(t), dtype=np.int64)
        wr[order] = rank
        bucket_of[wk_keys] = wt
        pos_of[wk_keys] = (counts[wt] + wr[winner]).astype(np.int32)
        np.add.at(counts, wt, 1)
        pending = pending[~winner]

    # serial eviction walk for the stragglers, over a (bucket, pos) -> key
    # occupancy array so that this phase costs O(stragglers)
    if pending.size:
        occ = np.full((nb, bucket_size), -1, dtype=np.int64)
        placed = np.nonzero(bucket_of >= 0)[0]
        occ[bucket_of[placed], pos_of[placed]] = placed
        rng = np.random.default_rng(0)
        for ki in pending:
            key = int(ki)
            b = int(h1[key])
            for _ in range(10000):
                c = int(counts[b])
                if c < bucket_size:
                    occ[b, c] = key
                    bucket_of[key] = b
                    pos_of[key] = c
                    counts[b] += 1
                    break
                vp = int(rng.integers(0, bucket_size))
                victim = int(occ[b, vp])
                occ[b, vp] = key
                bucket_of[key] = b
                pos_of[key] = vp
                key = victim
                b = int(h2[key]) if int(h1[key]) == b else int(h1[key])
            else:
                raise RuntimeError("cuckoo build failed; lower load_factor")

    return nb, bucket_of, pos_of, h1
