"""Open-addressing k-mer hash table: host build (numpy), device lookup.

Counterpart of corticall_tpu/ops/hashtable.py (`build`, `HashTable`,
`lookup`), the table behind `DeviceGraph.find_records`.  The build is a numpy
copy: linear-probe insertion of all N canonical k-mers at once, in batched
rounds (each round claims free slots for every unplaced k-mer; losers probe
the next slot), a power-of-two table at load factor 0.7; `max_probe` is the
true longest probe.  The hash is ops/placement.np_hash_words on the host and
ops/kmer.hash_words (csrc/kmer.cuh) on the device, the same bits.

`lookup` runs the plain twin for CPU tensors and `ctk_ht_lookup`
(csrc/walk_table.cu) for CUDA tensors.  The kernel reads an interleaved probe
table built once a graph from the slots (`probe_table`): key entries, as
`HashTable.build_entries` builds the JAX package's (a slot's key words and
record index + 1, padded to 16 or 32 bytes), or tag entries (record index + 1
and a 32-bit hash tag of the key, 8 bytes, a tag match confirmed against the
key) -- `PROBE_FORM` -- with `LOOKUP_GROUP` lanes a query, a round of that
many consecutive entries at once; `lookup_rounds_plain` is that probe step
for step, and its answers are `lookup`'s.  Words are uint32 bit patterns in
int32 tensors.  Not ported: `build_walk_entries` and `lookup_fused` (which
rounds the probe count up, so it can answer past `max_probe`), used only by
the JAX package's tests and its superseded `ops/walk.py` (ROADMAP "Do not
port").
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from . import _kernels
from . import kmer as tk
from .placement import GOLDEN, np_hash_words

# kernel launches (plain integers; chip_smoke.py resets and reads them)
LAUNCHES = {"ht_lookup": 0}

# ctk_ht_lookup's lanes a query, and the probe table's entry form: "key"
# (key words and record + 1) or "tag" (record + 1 and a 32-bit hash tag,
# confirmed against the record's key).  Key entries at two lanes a query are
# the fastest on 42M queries in random order; tags (half the memory) win only
# when the queries come in record order, so that the confirming key reads
# are sequential, as in chip_smoke.py's phase 9 (tools/table_probe.py; the
# phase times the others too)
LOOKUP_GROUP = 2
PROBE_FORM = "key"
GROUPS = (1, 2, 4, 8)


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


def entry_words(w: int, form: str = PROBE_FORM) -> int:
    """Words an entry of the probe table: 2 for tags; key entries padded to
    16 bytes (W <= 3) or 32 (W = 4)."""
    if form not in ("key", "tag"):
        raise ValueError(f"unknown probe table form {form!r}")
    return 2 if form == "tag" else (4 if w <= 3 else 8)


def probe_table(slots: torch.Tensor, keys: torch.Tensor, form: str = PROBE_FORM) -> torch.Tensor:
    """The interleaved probe table of a slot table, int32 [M, E] on the
    slots' device: entry s of the key form is (keys[slots[s]]..., slots[s] +
    1, zeros), the JAX package's `HashTable.build_entries` padded to E
    words; of the tag form (slots[s] + 1, mix32(hash ^ GOLDEN) of its key).
    0 in the record column marks an empty slot.  Built once a graph
    (DeviceGraph.from_arrays)."""
    m, w = slots.shape[0], keys.shape[1]
    table = torch.zeros((m, entry_words(w, form)), dtype=torch.int32, device=slots.device)
    occ = (slots >= 0).nonzero().squeeze(1)
    rec = slots[occ].to(torch.int64)
    if form == "key":
        table[occ, :w] = keys[rec]
        table[occ, w] = (rec + 1).to(torch.int32)
    else:
        table[occ, 0] = (rec + 1).to(torch.int32)
        h = tk.hash_words(tk.from_bits32(keys[rec]))
        table[occ, 1] = tk.to_bits32(tk.mix32(h ^ GOLDEN))
    return table


def lookup_rounds_plain(table: torch.Tensor, keys: torch.Tensor, queries: torch.Tensor,
                        max_probe: int, group: int) -> torch.Tensor:
    """ctk_ht_lookup's probe step for step: rounds of `group` consecutive
    entries aligned on `group`, the first holding the home slot hash & (M -
    1), the lanes before it and at probe index >= max_probe masked, the
    first slot of a round in probe order that holds the key or is empty
    answering (its record, or -1); -1 once the probes run out.  Gives
    `lookup`'s answers."""
    m, e = table.shape
    w = queries.shape[1]
    tag_form = e == 2
    q = tk.from_bits32(queries)
    h = tk.hash_words(q)
    tags = tk.mix32(h ^ GOLDEN)
    t, kw = tk.from_bits32(table), tk.from_bits32(keys)
    out = torch.full((q.shape[0],), -1, dtype=torch.int32, device=q.device)
    live = torch.arange(q.shape[0], device=q.device)
    lanes = torch.arange(group, device=q.device)
    skip = h & (group - 1)
    for p0 in range(0, max_probe + group, group):
        if not live.numel():
            break
        p = p0 + lanes - skip[live, None]                           # [L, G] probe indices
        ent = t[(h[live, None] + p) & (m - 1)]                      # [L, G, E]
        held = ent[..., 0] if tag_form else ent[..., w]
        rec = held - 1
        if tag_form:
            match = (held != 0) & (ent[..., 1] == tags[live, None])
            match &= (kw[rec.clamp(min=0)] == q[live, None, :]).all(-1) if kw.shape[0] else False
        else:
            match = (held != 0) & (ent[..., :w] == q[live, None, :]).all(-1)
        resolves = ((held == 0) | match) & (p >= 0) & (p < max_probe)
        hit = resolves.any(1)
        first = resolves.to(torch.int8).argmax(1, keepdim=True)     # the first resolving lane
        out[live[hit]] = rec.gather(1, first).squeeze(1)[hit].to(torch.int32)
        live = live[~hit]
    return out


def lookup(slots: torch.Tensor, keys: torch.Tensor, queries: torch.Tensor,
           max_probe: int, table: torch.Tensor | None = None) -> torch.Tensor:
    """slots int32 [M], keys int32 [N, W] (the canonical k-mers in record
    order), queries int32 [B, W] canonical k-mers -> int32 [B] record indices
    (-1: a miss).  The plain twin for CPU tensors; one `ctk_ht_lookup`
    launch over `table` (probe_table(slots, keys)) for CUDA tensors.  A
    caller without the table gets one built at each call, which costs more
    than the lookup: DeviceGraph keeps its own."""
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
    if table is None:
        table = probe_table(slots, keys)
    if table.dtype != torch.int32 or table.device != slots.device or table.shape[0] != m or \
            table.shape[1] not in (2, entry_words(keys.shape[1], "key")):
        raise ValueError("table must be the slots' probe table (probe_table)")
    out = torch.empty(queries.shape[0], dtype=torch.int32, device=queries.device)
    if queries.shape[0]:
        lookup_kernel(table.contiguous(), keys.contiguous(), queries.contiguous(), max_probe, out)
    return out


def lookup_kernel(table, keys, queries, max_probe: int, out, group: int = LOOKUP_GROUP) -> None:
    """One `ctk_ht_lookup` launch on checked, contiguous card tensors: the
    probe table, the records' keys (read by the tag form), the queries,
    `group` lanes a query."""
    if group not in GROUPS:
        raise ValueError(f"group must be one of {GROUPS}")
    err = _kernels.library().ctk_ht_lookup(
        table.data_ptr(), table.shape[0], table.shape[1], keys.data_ptr(), keys.shape[1],
        queries.data_ptr(), queries.shape[0], max_probe, group, out.data_ptr(),
        _kernels.stream(queries.device))
    _kernels.check(err, "ht_lookup")
    LAUNCHES["ht_lookup"] += 1
