"""The least time one H100 could take for a kernel's work: frozen here.

A copy of chip_smoke.py's bound arithmetic (`bound_ms`, `tesserae_bound`,
`walk_bound`, `probed_buckets`), so that a kernel's roofline share reads the
same work whatever implements it.  The bound is the larger of the bytes over
the HBM rate and the operations over the float32 rate outside the tensor
cores, both the published peaks of one H100 SXM at 700 W; each input byte is
counted once and each output byte once.  Tesserae counts ~40 operations a
cell and query column; the jump walk counts its bytes: its seeds and
outputs, the distinct buckets its seed lookups must read and the distinct
16-byte rows its lanes read.  The seed lookup's hash is the jump table's
(corticall_tpu_torch/ops/placement.py), copied here.
"""

from __future__ import annotations

import torch

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
TESSERAE_OPS_PER_CELL = 40
JUMP_ROW_BYTES = 16
JUMP_MAX = 32                       # bases a jump row holds
GOLDEN = 0x9E3779B9
M32 = 0xFFFFFFFF


def bound_ms(nbytes: float, ops: float = 0.0):
    """(least time in ms, "bytes" or "operations") for the work."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / FP32_OPS_PER_S * 1e3
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


def tesserae_bound(query_len: int, n_targets: int, longest_target: int):
    """Bound of one section of a query against targets padded to the
    longest: its inputs (query and target codes int32, the validity mask a
    byte a cell, the 9 + 25 + 5 float32 parameters), its path out (2 + 3 cap
    int32, cap = L + longest + 5) and its cells and columns."""
    cap = query_len + longest_target + 5
    io = (4 * query_len + 5 * n_targets * longest_target + 4 * (9 + 25 + 5)
          + 4 * (2 + 3 * cap))
    return bound_ms(io, TESSERAE_OPS_PER_CELL * query_len * n_targets * (longest_target + 1))


def walk_bound(seed_bytes: int, out_bytes: int, seed_bucket_bytes: int, rows_read: int):
    return bound_ms(seed_bytes + out_bytes + seed_bucket_bytes + rows_read * JUMP_ROW_BYTES)


def walk_out_bytes(lanes: int, num_steps: int) -> int:
    """The walk's outputs as its contract gives them: int32 [B, 2T] packed
    jump slots (T = ceil(steps / 32) + 2), int32 steps, three byte flags."""
    t = -(-num_steps // JUMP_MAX) + 2
    return lanes * (4 * 2 * t + 4 + 3)


# --- the seed lookups' buckets ----------------------------------------------

def _mix32(x: torch.Tensor) -> torch.Tensor:
    x = x & M32
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & M32
    x = x ^ (x >> 15)
    x = (x * 0x846CA68B) & M32
    return x ^ (x >> 16)


def _hash_words(words: torch.Tensor) -> torch.Tensor:
    """int64 [B, W] words -> int64 [B] 32-bit hash."""
    h = torch.full(words.shape[:1], 0x811C9DC5, dtype=torch.int64, device=words.device)
    for i in range(words.shape[1]):
        h = (_mix32(h ^ words[:, i]) * 0x01000193) & M32
    return _mix32(h)


def _canonical(words: torch.Tensor, k: int) -> torch.Tensor:
    w = words.shape[1]
    codes = [(words[:, w - 1 - (2 * (k - 1 - i)) // 32] >> ((2 * (k - 1 - i)) % 32)) & 3
             for i in range(k)]
    rc = torch.zeros_like(words)
    for i in range(k):
        p = 2 * (k - 1 - i)
        rc[:, w - 1 - p // 32] |= (3 - codes[k - 1 - i]) << (p % 32)
    less = torch.zeros(words.shape[0], dtype=torch.bool, device=words.device)
    decided = torch.zeros_like(less)
    for j in range(w):
        less |= ~decided & (rc[:, j] < words[:, j])
        decided |= rc[:, j] != words[:, j]
    return torch.where(less[:, None], rc, words)


def seed_bucket_bytes(buckets: torch.Tensor, seeds: torch.Tensor, k: int) -> int:
    """Bytes of the distinct buckets that two-choice lookups of the seeds
    (int64 [B, W] words, walk-oriented) must read: each canonical key's
    primary bucket, and its second where the primary does not hold it.
    buckets: int32 [NB, 2, W+1] (key words..., tag with bit 31 set)."""
    nb, per, e = buckets.shape
    w = e - 1
    canon = _canonical(seeds, k)
    h = _hash_words(canon)
    first = h & (nb - 1)
    ent = buckets[first].to(torch.int64) & M32                 # [B, 2, W+1]
    held = ((ent[..., w] >= 1 << 31) & (ent[..., :w] == canon[:, None, :]).all(-1)).any(-1)
    second = _mix32(h[~held] ^ GOLDEN) & (nb - 1)
    return int(torch.unique(torch.cat([first, second])).numel()) * per * e * 4


# --- the rows the walk reads -------------------------------------------------

def walk_rows_read(seeds: torch.Tensor, packed: torch.Tensor, steps: torch.Tensor,
                   k: int, num_steps: int) -> int:
    """Distinct jump rows that walks read, from the walks' bases: a lane
    reads the row of the oriented k-mer after 0, 32, 64, ... of its bases,
    through min(steps, cap - 1) // 32.  seeds int64 [B, W] words; packed
    int64 [B, 2T] uint32 words, (hi, lo) a slot of 32 bases, the first base
    highest; steps int64 [B].  For k <= 64: the k-mer after 32 t bases is
    the low 2k bits of slots t - 2 and t - 1 of the seed's slots (its 128
    bits, right-aligned, as slots -2 and -1) and the walk's."""
    b, w = seeds.shape
    seed128 = torch.cat([seeds.new_zeros(b, 4 - w), seeds], dim=1)
    stream = torch.cat([seed128, packed], dim=1)
    n_rows = (num_steps - 1) // JUMP_MAX + 1
    kmers = stream[:, :2 * n_rows + 2].unfold(1, 4, 2)[..., 4 - w:].clone()  # [B, n_rows, W]
    kmers[..., 0] &= (1 << (2 * k - 32 * (w - 1))) - 1
    read = torch.arange(n_rows, device=seeds.device)[None, :] <= \
        (torch.clamp(steps, max=num_steps - 1) // JUMP_MAX)[:, None]
    rows = kmers[read]
    if rows.shape[0] == 0:
        return 0
    order = torch.arange(rows.shape[0], device=rows.device)
    for j in range(w - 1, -1, -1):
        order = order[torch.sort(rows[order, j], stable=True).indices]
    srt = rows[order]
    return 1 + int((srt[1:] != srt[:-1]).any(dim=1).sum())
