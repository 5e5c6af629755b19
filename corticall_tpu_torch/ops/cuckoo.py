"""Bucketized two-choice (cuckoo) k-mer tables and the speculative
single-step walk.

Counterpart of the non-jump part of corticall_tpu/ops/cuckoo.py that
DeviceGraph and the checkpointed walks use: `CuckooTable`, `build_cuckoo`
(:144), `build_walk_table` (:180), `lookup_payload` (:190), `spec_iters`
(:248) and `walk_forward_spec` (:306, with `_spec_step_fn` :256 and
`_spec_init` :298).  A table is int32 [NB, BS, W+1] (uint32 bit patterns):
BS entries a bucket, each (key words..., tag), tag = 0x80000000 | payload for
an occupied entry, 0 for an empty one; the JAX package's uint32
[NB, BS*(W+1)] rows hold the same bits.  W = ceil(k/16) <= 4, so k <= 63.

The host places the keys (ops/placement.place_cuckoo, a copy of
cuckoo._place) and one scatter on the device writes the entries
(ops/jump.scatter_buckets).  The walk table is the jump table's placement
(load 0.5, 2-entry buckets, primary bucket first) with the combined edge
byte as payload.  `walk_forward_spec` runs the plain twin for CPU tensors and
`ctk_spec_walk` (csrc/walk_table.cu) for CUDA tensors.  `lookup_payload` is
plain PyTorch on both (one fixed gather and compares); its kernel waits for
the modules that put it on a path (ROADMAP §1 items 5, 6).

Not ported: the RunTable family, `walk_forward_cuckoo`,
`walk_forward_spec_chunked` and `_spec_chunk(_device)` (ROADMAP "Do not
port"); the jump table is ops/jump.py.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve
from . import _kernels
from . import kmer as tk
from .jump import lookup_payload_tag, scatter_buckets
from .placement import GOLDEN, place_cuckoo

BUCKET_SIZE = 4

# kernel launches (plain integers; chip_smoke.py resets and reads them)
LAUNCHES = {"spec_walk": 0}


@dataclass
class CuckooTable:
    """buckets: int32 [NB, bucket_size, W+1] on the table's device."""
    buckets: torch.Tensor
    nb_bits: int
    words: int
    bucket_size: int = BUCKET_SIZE
    primary_fraction: float = 0.0  # keys resident in their h1 bucket

    @property
    def num_buckets(self) -> int:
        return self.buckets.shape[0]


def build_cuckoo(kmers: np.ndarray, payload: np.ndarray, load_factor: float = 0.5,
                 num_buckets: int | None = None, bucket_size: int = BUCKET_SIZE,
                 primary_bias: bool = False, device=None) -> CuckooTable:
    """kmers: uint32[N, W] unique canonical k-mers; payload: uint[N] (< 2^31),
    e.g. the combined edge byte.  num_buckets (a power of two) fixes the
    table size; primary_bias puts a key in its h1 bucket whenever that has
    room.  The table lives on `device` (default: the CUDA card, and
    RuntimeError without one)."""
    device = resolve(device)
    return cuckoo_table(kmers, payload, place_cuckoo(kmers, load_factor, num_buckets,
                                                     bucket_size, primary_bias),
                        bucket_size, device)


def cuckoo_table(kmers: np.ndarray, payload: np.ndarray, placement: tuple, bucket_size: int,
                 device: torch.device) -> CuckooTable:
    """The table of a host placement (place_cuckoo's (nb, bucket_of, pos_of,
    h1) at `bucket_size`), written on `device` by one scatter."""
    nb, bucket_of, pos_of, h1 = placement
    buckets, _ = scatter_buckets(kmers, nb, bucket_of * bucket_size + pos_of, device,
                                 payload=payload, bucket_size=bucket_size)
    return CuckooTable(buckets=buckets, nb_bits=int(nb).bit_length() - 1, words=kmers.shape[1],
                       bucket_size=bucket_size,
                       primary_fraction=float((bucket_of == h1).mean()) if len(h1) else 1.0)


def build_walk_table(kmers: np.ndarray, edges: np.ndarray, load_factor: float = 0.5,
                     device=None) -> CuckooTable:
    """The walk table: 2-entry buckets placed primary-first, the combined
    edge byte as payload, so that the speculative first probe of
    walk_forward_spec finds most keys in one bucket row."""
    return build_cuckoo(kmers, edges, load_factor=load_factor, bucket_size=2,
                        primary_bias=True, device=device)


def lookup_payload(buckets: torch.Tensor, canon: torch.Tensor) -> torch.Tensor:
    """Canonical k-mers int32 [B, W] -> int32 [B] payloads (0: a miss), by
    one gather of both candidate buckets and compares, for tables of any
    bucket size."""
    return tk.to_bits32(lookup_payload_tag(buckets, tk.from_bits32(canon))[0])


def spec_iters(num_steps: int) -> int:
    """Iterations of walk_forward_spec: the emitted steps plus slack for the
    speculative second-probe stalls (25% + 32)."""
    return num_steps + num_steps // 4 + 32


def spec_walk_plain(buckets: torch.Tensor, seeds: torch.Tensor, k: int, num_steps: int):
    """Plain twin of cuckoo.walk_forward_spec on seeds int32 [B, W]: (bases
    int8 [T, B], cycled bool [B], steps int32 [B])."""
    nb, bs, e = buckets.shape
    w = e - 1
    table = tk.from_bits32(buckets)
    cur = tk.from_bits32(seeds)
    b = cur.shape[0]
    dev = cur.device
    saved = cur.clone()
    probe = torch.zeros(b, dtype=torch.bool, device=dev)
    active = torch.ones_like(probe)
    cycled = torch.zeros_like(probe)
    emitcnt = torch.zeros(b, dtype=torch.int64, device=dev)
    power = torch.ones_like(emitcnt)
    lam = torch.zeros_like(emitcnt)
    iters = spec_iters(num_steps)
    bases = torch.full((iters, b), -1, dtype=torch.int8, device=dev)
    for t in range(iters):
        canon, flipped = tk.canonicalize_words(cur, k)
        h = tk.hash_words(canon)
        idx = torch.where(probe, tk.mix32(h ^ GOLDEN), h) & (nb - 1)
        rows = table[idx]                                   # [B, BS, W+1]
        tag = rows[..., w]
        match = (tag >= 1 << 31) & (rows[..., :w] == canon[:, None, :]).all(-1)
        found = match.any(dim=1)
        pay = torch.where(match, tag & 0x7FFFFFFF, 0).amax(dim=1)
        next_mask = torch.where(flipped, pay >> 4, pay & 0xF)
        base = tk.lowest_set_base(next_mask)
        nxt = tk.shift_append(cur, base, k)

        single = found & (tk.popcount4(next_mask) == 1)
        is_cycle = (nxt == saved).all(dim=-1) & single & active
        advance = active & single & ~is_cycle & (emitcnt < num_steps)
        stall = active & ~found & ~probe
        bases[t] = torch.where(advance, base, -1).to(torch.int8)

        teleport = (power == lam) & advance
        saved = torch.where(teleport[:, None], nxt, saved)
        power = torch.where(teleport, power * 2, power)
        lam = torch.where(teleport, 0, lam)
        lam = torch.where(advance, lam + 1, lam)
        cur = torch.where(advance[:, None], nxt, cur)
        emitcnt = emitcnt + advance.to(torch.int64)
        cycled = cycled | is_cycle
        probe, active = stall, advance | stall
        if not bool(active.any()):
            break                    # every lane has ended: the rest stays -1
    return bases, cycled, emitcnt.to(torch.int32)


def _check_spec(buckets: torch.Tensor, seeds: torch.Tensor, k: int, num_steps: int) -> None:
    w = tk.words(k)
    if not 1 <= k <= 63 or seeds.dtype != torch.int32 or seeds.dim() != 2 or seeds.shape[1] != w:
        raise ValueError(f"seeds must be int32 [B, {w}] words, 1 <= k <= 63")
    nb = buckets.shape[0] if buckets.dim() == 3 else 0
    if buckets.dtype != torch.int32 or buckets.dim() != 3 or buckets.shape[2] != w + 1 or \
            nb == 0 or nb & (nb - 1):
        raise ValueError(f"buckets must be int32 [NB, BS, {w + 1}], NB a power of two")
    if num_steps < 0 or seeds.device != buckets.device:
        raise ValueError("num_steps must be >= 0 and the tensors on one device")


def walk_forward_spec(buckets: torch.Tensor, seeds: torch.Tensor, k: int, num_steps: int):
    """Walks of at most num_steps bases from walk-oriented seeds (int32
    [B, W] bit patterns) over a walk table: (bases int8 [T, B] with -1 on
    stalls and after a lane ends, T = spec_iters(num_steps); cycled bool
    [B]; steps int32 [B]).  The plain twin for CPU tensors; one
    `ctk_spec_walk` launch for CUDA tensors."""
    _check_spec(buckets, seeds, k, num_steps)
    if seeds.device.type == "cpu":
        return spec_walk_plain(buckets, seeds, k, num_steps)
    if seeds.device.type != "cuda":
        raise ValueError(f"unsupported device {seeds.device}")
    b, dev = seeds.shape[0], seeds.device
    bases = torch.empty((spec_iters(num_steps), b), dtype=torch.int8, device=dev)
    cycled = torch.empty(b, dtype=torch.bool, device=dev)
    steps = torch.empty(b, dtype=torch.int32, device=dev)
    if b:
        spec_walk_kernel(buckets.contiguous(), seeds.contiguous(), k, num_steps, bases, cycled,
                         steps)
    return bases, cycled, steps


def spec_walk_kernel(buckets, seeds, k: int, num_steps: int, bases, cycled, steps) -> None:
    """One `ctk_spec_walk` launch on checked, contiguous card tensors:
    bases int8 [T, B] (every byte written), cycled bool [B], steps int32 [B].
    A table of 2-entry rows aligned for their vectors is read a row as
    vectors, any other a word at a time."""
    nb, bs, _ = buckets.shape
    err = _kernels.library().ctk_spec_walk(
        buckets.data_ptr(), nb, bs, seeds.shape[1], k, seeds.data_ptr(), seeds.shape[0],
        num_steps, bases.shape[0], bases.data_ptr(), cycled.data_ptr(), steps.data_ptr(),
        _kernels.stream(seeds.device))
    _kernels.check(err, "spec_walk")
    LAUNCHES["spec_walk"] += 1


def kernel_info(buckets, batch: int) -> dict:
    """How a `ctk_spec_walk` launch of `batch` walks over the card table
    `buckets` runs on its card: the path its rows take ("vector" or
    "words"), threads a block, registers and local (spilled) bytes a thread,
    blocks resident an SM, walks a thread, the lanes the card holds at once
    and the waves the batch takes."""
    import ctypes

    out = (ctypes.c_int * 7)()
    _, bs, e = buckets.shape
    with torch.cuda.device(buckets.device):
        err = _kernels.library().ctk_spec_walk_info(buckets.data_ptr(), bs, e - 1, out)
    _kernels.check(err, "spec_walk_info")
    threads, regs, blocks, local, walks, sms, vec = out
    resident = threads * blocks * sms * walks
    return {"path": "vector" if vec else "words", "threads": threads, "registers": regs,
            "local_bytes": local, "blocks_per_sm": blocks, "walks_per_thread": walks,
            "resident_lanes": resident, "waves": -(-batch // resident) if resident else None}
