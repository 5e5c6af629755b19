"""Open-addressing k-mer hash table: host build (numpy), device lookup.

Counterpart of corticall_tpu/ops/hashtable.py (`build`, `HashTable`,
`lookup`), the table behind `DeviceGraph.find_records`.  The build is a numpy
copy: linear-probe insertion of all N canonical k-mers at once, in batched
rounds (each round claims free slots for every unplaced k-mer; losers probe
the next slot), a power-of-two table at load factor 0.7; `max_probe` is the
true longest probe.  The hash is ops/placement.np_hash_words on the host and
ops/kmer.hash_words (csrc/kmer.cuh) on the device, the same bits.

`lookup` runs the plain twin for CPU tensors and `ctk_ht_lookup`
(csrc/walk_table.cu) for CUDA tensors.  Words are uint32 bit patterns in int32
tensors.  Not ported: `HashTable.build_entries`, `build_walk_entries` and
`lookup_fused`, used only by the JAX package's tests and its superseded
`ops/walk.py` (ROADMAP "Do not port").
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from . import _kernels
from . import kmer as tk
from .placement import np_hash_words

# kernel launches (plain integers; chip_smoke.py resets and reads them)
LAUNCHES = {"ht_lookup": 0}


@dataclass
class HashTable:
    """slots: int32[M] record index or -1 (empty); the keys are the graph's
    k-mers array."""
    slots: np.ndarray
    max_probe: int
    table_bits: int

    @property
    def size(self) -> int:
        return self.slots.shape[0]


def build(kmers: np.ndarray, load_factor: float = 0.7,
          table_size: int | None = None) -> HashTable:
    """kmers: uint32[N, W] canonical packed k-mers (unique).  table_size, if
    given, must be a power of two > N (shard tables at a common size)."""
    n = kmers.shape[0]
    if table_size is not None:
        m = table_size
        assert m & (m - 1) == 0 and m > n
    else:
        m = 16
        while m * load_factor < max(n, 1):
            m *= 2
    mask = np.uint32(m - 1)

    slots = np.full(m, -1, dtype=np.int32)
    h = np_hash_words(kmers) & mask
    pending = np.arange(n, dtype=np.int64)
    cur = h.astype(np.uint32)
    probe = 0
    while pending.size:
        s = cur[pending]
        free = slots[s] == -1
        # the first pending k-mer targeting each free slot wins this round
        order = np.argsort(s, kind="stable")
        s_sorted = s[order]
        first_of_slot = np.ones(len(s_sorted), dtype=bool)
        first_of_slot[1:] = s_sorted[1:] != s_sorted[:-1]
        winner = np.zeros(len(s), dtype=bool)
        winner[order] = first_of_slot & free[order]
        slots[s[winner]] = pending[winner].astype(np.int32)
        pending = pending[~winner]
        cur[pending] = (cur[pending] + np.uint32(1)) & mask
        probe += 1
        if probe > m:
            raise RuntimeError("hash table build failed to converge")
    return HashTable(slots=slots, max_probe=max(probe, 1), table_bits=int(m).bit_length() - 1)


def lookup_plain(slots: torch.Tensor, keys: torch.Tensor, queries: torch.Tensor,
                 max_probe: int) -> torch.Tensor:
    """Plain twin of hashtable.lookup: probes in lockstep until every query
    met its key or an empty slot, or max_probe probes."""
    m = slots.shape[0]
    q = tk.from_bits32(queries)
    kw = tk.from_bits32(keys)
    h = tk.hash_words(q) & (m - 1)
    found = torch.full((q.shape[0],), -1, dtype=torch.int64, device=q.device)
    resolved = torch.zeros(q.shape[0], dtype=torch.bool, device=q.device)
    for p in range(max_probe):
        if bool(resolved.all()):
            break
        slot = (h + p) & (m - 1)
        idx = slots[slot].to(torch.int64)
        empty = idx < 0
        match = ~empty & (kw[idx.clamp(min=0)] == q).all(dim=-1) if kw.shape[0] else \
            torch.zeros_like(empty)
        found = torch.where(~resolved & match, idx, found)
        resolved = resolved | match | empty
    return found.to(torch.int32)


def lookup(slots: torch.Tensor, keys: torch.Tensor, queries: torch.Tensor,
           max_probe: int) -> torch.Tensor:
    """slots int32 [M], keys int32 [N, W] (the canonical k-mers in record
    order), queries int32 [B, W] canonical k-mers -> int32 [B] record indices
    (-1: a miss).  The plain twin for CPU tensors; one `ctk_ht_lookup`
    launch for CUDA tensors."""
    m = slots.shape[0]
    if slots.dim() != 1 or slots.dtype != torch.int32 or m & (m - 1) or m == 0:
        raise ValueError("slots must be int32 [M], M a power of two")
    if keys.dtype != torch.int32 or queries.dtype != torch.int32 or keys.dim() != 2 or \
            queries.dim() != 2 or keys.shape[1] != queries.shape[1] or not 1 <= keys.shape[1] <= 4:
        raise ValueError("keys and queries must be int32 [N, W] and [B, W], W <= 4")
    if max_probe < 0 or not slots.device == keys.device == queries.device:
        raise ValueError("max_probe must be >= 0 and all tensors on one device")
    if slots.device.type == "cpu":
        return lookup_plain(slots, keys, queries, max_probe)
    if slots.device.type != "cuda":
        raise ValueError(f"unsupported device {slots.device}")
    out = torch.empty(queries.shape[0], dtype=torch.int32, device=queries.device)
    if queries.shape[0]:
        lookup_kernel(slots.contiguous(), keys.contiguous(), queries.contiguous(), max_probe, out)
    return out


def lookup_kernel(slots, keys, queries, max_probe: int, out) -> None:
    """One `ctk_ht_lookup` launch on checked, contiguous card tensors."""
    err = _kernels.library().ctk_ht_lookup(
        slots.data_ptr(), slots.shape[0], keys.data_ptr(), keys.shape[1], queries.data_ptr(),
        queries.shape[0], max_probe, out.data_ptr(), _kernels.stream(queries.device))
    _kernels.check(err, "ht_lookup")
    LAUNCHES["ht_lookup"] += 1
