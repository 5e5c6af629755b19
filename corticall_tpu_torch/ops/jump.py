"""Jump-table build and walk: plain PyTorch twins + CUDA kernel wrappers.

Counterpart of the jump section of corticall_tpu/ops/cuckoo.py (lines
649-1152), the walk that Partition's device routes run.  Each k-mer i gets
two rows, 2*i + d for orientation d (0 = canonical, 1 = reverse
complement), each (hi, lo, next_row, meta): up to JUMP_MAX bases of the
unitig run from that row, linearly packed big-endian in the 64-bit pair
(hi, lo), the row where a full run lands (or JUMP_END), and meta = run
length (bits 0-5) | ends at a junction (bit 29) | a flagged k-mer on the run
(bit 30) | cycle closed by the builder (bit 31).  The seed lookup uses a
two-choice cuckoo table of 2-entry buckets, each entry (key words..., tag),
tag = 0x80000000 | record id.

Layout: `rows` int32 [2N, 4] and `buckets` int32 [NB, 2, W+1], both holding
the uint32 bit patterns that the kernels read; so 49 <= k <= 63 (W = 4)
works, which the JAX package's flat 3-word entries cannot hold.  The JAX
package's TPU workarounds are not carried over: no 128-lane tile packing, no
power-of-two row or lane padding, no chunked landing lookup.

Each stage has a plain twin (`jump_stage0`, `jump_compose`, `pack_rows`,
`seed_rows`, `jump_walk`) on words held in int64 (ops/kmer.py), run for CPU
tensors; CUDA tensors launch csrc/jump.cu (`ctk_jump_stage0`,
`ctk_jump_compose`, `ctk_jump_walk`) or raise.  On the card, stage 0 and the
first NARROW_PASSES doubling passes write narrow rows int32 [2N, 2] (runs of
at most NARROW_MAX bases, 8 bytes a row; `narrow_rows` / `widen_rows` are the
plain encode and decode), and the last pass the [2N, 4] rows above.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from . import _kernels
from ..device import resolve
from . import kmer as tk
from .kmer import words_tensor
from .placement import GOLDEN, place

JUMP_MAX = 32                 # bases a row: a power of two, 64 bits of (hi, lo)
JUMP_END = 0xFFFFFFFF         # next_row of a run that ends the walk
_TAG = 0x80000000
COMPOSE_PASSES = 5           # log2(JUMP_MAX) doubling passes after stage 0
NARROW_MAX = 16              # bases a narrow row holds: the 32 bits of its first word
NARROW_PASSES = 4            # passes whose runs fit a narrow row (2^4 = NARROW_MAX)
NARROW_ENDED = 0x7FFFFF80    # a narrow row's link: the run ended; row ids stay below it

# kernel launches (plain integers; chip_smoke.py resets and reads them)
LAUNCHES = {"jump_walk": 0, "jump_stage0": 0, "jump_compose": 0}


@dataclass
class JumpTable:
    """rows int32 [2N, 4], buckets int32 [NB, 2, W+1] (uint32 bit patterns),
    on the device the table was built on."""
    rows: torch.Tensor
    buckets: torch.Tensor


def jump_iters(num_steps: int) -> int:
    """Jumps a walk of at most num_steps bases needs: every non-final jump
    emits exactly JUMP_MAX bases, plus one final partial jump (and one
    spare), as corticall_tpu/ops/cuckoo.py::jump_iters."""
    return -(-num_steps // JUMP_MAX) + 2


# ---------------------------------------------------------------------------
# cuckoo buckets (host placement, one scatter on the device)
# ---------------------------------------------------------------------------

def build_buckets(kmers: np.ndarray, device):
    """-> (buckets int32 [NB, 2, W+1], kmer words as an int32 tensor on
    `device`).  The placement is the host's (ops/placement.place)."""
    nb, bucket_of, pos_of = place(kmers)
    return scatter_buckets(kmers, nb, bucket_of * 2 + pos_of, device)


def scatter_buckets(kmers: np.ndarray, nb: int, entry: np.ndarray, device,
                    payload: np.ndarray | None = None, bucket_size: int = 2):
    """The bucket array int32 [NB, bucket_size, W+1] from a placement (entry
    = bucket_size * bucket + position a key): one index_put_ of the (key
    words..., tag) entries on `device`, tag = 0x80000000 | payload (< 2^31;
    default: the record ids, the jump table's)."""
    n, w = kmers.shape
    kd = words_tensor(kmers, device)
    pay = (torch.arange(n, dtype=torch.int64) if payload is None
           else torch.from_numpy(np.asarray(payload, dtype=np.int64))).to(kd.device)
    tag = tk.to_bits32(pay | _TAG)
    idx = torch.from_numpy(np.asarray(entry, dtype=np.int64)).to(kd.device)
    buckets = torch.zeros((nb * bucket_size, w + 1), dtype=torch.int32, device=kd.device)
    buckets.index_put_((idx,), torch.cat([kd, tag[:, None]], dim=1))
    return buckets.view(nb, bucket_size, w + 1), kd


def lookup_payload_tag(buckets: torch.Tensor, canon: torch.Tensor):
    """(payload int64[B], present bool[B]) of canonical words int64 [B, W]:
    both candidate buckets, both entries, tag bit 31 = occupied."""
    nb, _, e = buckets.shape
    w = e - 1
    h = tk.hash_words(canon)
    idx = torch.stack([h & (nb - 1), tk.mix32(h ^ GOLDEN) & (nb - 1)])
    ent = tk.from_bits32(buckets[idx])                       # [2, B, 2, W+1]
    tag = ent[..., w]
    match = (tag >= _TAG) & (ent[..., :w] == canon[None, :, None, :]).all(-1)
    payload = torch.where(match, tag & 0x7FFFFFFF, 0).amax(dim=2).amax(dim=0)
    return payload, match.any(dim=2).any(dim=0)


# ---------------------------------------------------------------------------
# build: plain twins
# ---------------------------------------------------------------------------

def jump_stage0(kmers: torch.Tensor, edges: torch.Tensor, flags: torch.Tensor,
                buckets: torch.Tensor, k: int, d: int):
    """Single-step successor of every k-mer in orientation d (twin of
    cuckoo.py::_jump_stage0).  kmers int64 [N, W], edges int64 [N] (the
    walk colour's edge byte), flags bool [N].  Returns (hi, lo, length, cyc,
    flag, endj, ptr) per row."""
    n = kmers.shape[0]
    cur = kmers if d == 0 else tk.revcomp_words(kmers, k)
    next_mask = (edges & 0xF) if d == 0 else (edges >> 4)
    nm = tk.popcount4(next_mask)
    base = tk.lowest_set_base(next_mask)
    nxt = tk.shift_append(cur, base, k)
    single = nm == 1
    canon, fl2 = tk.canonicalize_words(nxt, k)
    pay, present = lookup_payload_tag(buckets, canon)
    dest = 2 * pay + fl2.to(torch.int64)
    own = 2 * torch.arange(n, dtype=torch.int64, device=kmers.device) + d
    self_loop = single & present & (dest == own)
    length = (single & ~self_loop).to(torch.int64)
    ptr = torch.where(single & present & ~self_loop, dest, JUMP_END)
    hi = torch.where(length > 0, base << 30, 0)
    # endj: the k-mer is a junction (out-degree >= 2) in this orientation
    return hi, torch.zeros_like(hi), length, self_loop, flags.clone(), nm >= 2, ptr


def _pair_shr(hi: torch.Tensor, lo: torch.Tensor, s: torch.Tensor):
    """(hi, lo) >> s for the 64-bit value in two 32-bit halves, s in [0, 64)."""
    big = s >= 32
    sm = torch.where(big, s - 32, s)
    carry = torch.where(sm > 0, (hi << (32 - sm)) & tk.M32, 0)
    lo2 = torch.where(big, hi >> sm, (lo >> sm) | carry)
    hi2 = torch.where(big, 0, hi >> sm)
    return hi2, lo2


def jump_compose(hi, lo, length, cyc, flag, endj, ptr):
    """One pointer-doubling pass (twin of cuckoo.py::_jump_compose): a row
    whose full run has a live pointer appends its destination's run."""
    own = torch.arange(hi.shape[0], dtype=torch.int64, device=hi.device)
    live = ptr != JUMP_END
    d = torch.where(live, ptr, 0)
    shi, slo = _pair_shr(hi[d], lo[d], 2 * length)
    bptr = ptr[d]
    nhi = torch.where(live, hi | shi, hi)
    nlo = torch.where(live, lo | slo, lo)
    nlen = torch.where(live, length + length[d], length)
    nflag = flag | (live & flag[d])
    nendj = torch.where(live, endj[d], endj)          # the stop cause is d's
    # a cycle closed inside the composed run: the chain came back to this row
    ncyc = torch.where(live, cyc[d] | (bptr == own), cyc)
    nptr = torch.where(ncyc, JUMP_END, torch.where(live, bptr, ptr))
    return nhi, nlo, nlen, ncyc, nflag, nendj, nptr


def pack_rows(hi, lo, length, cyc, flag, endj, ptr) -> torch.Tensor:
    """-> int32 [2N, 4] rows (twin of cuckoo.py::_jump_pack_rows)."""
    meta = (length | (endj.to(torch.int64) << 29) | (flag.to(torch.int64) << 30)
            | (cyc.to(torch.int64) << 31))
    return tk.to_bits32(torch.stack([hi, lo, ptr, meta], dim=1))


def narrow_rows(hi, lo, length, cyc, flag, endj, ptr, stage: int) -> torch.Tensor:
    """-> int32 [2N, 2] narrow rows (bases, link) of the state after `stage`
    (0: stage 0, p: compose pass p <= NARROW_PASSES), the format
    `ctk_jump_stage0` and the first NARROW_PASSES compose passes write.
    bases = the run's bases as a wide row's hi; link = flag << 31 | next_row
    for a live row, whose run is full (2^stage bases) with no junction and no
    cycle (cuckoo.py::_jump_compose's invariant: next_row != END <=> the run
    is full and continuing), else flag << 31 | NARROW_ENDED | cyc << 6 |
    endj << 5 | length."""
    live = ptr != JUMP_END
    full = 1 << stage
    if (not 0 <= stage <= NARROW_PASSES or hi.shape[0] > NARROW_ENDED
            or bool((lo != 0).any()) or bool((length > full).any())
            or bool((live & ((length != full) | endj | cyc)).any())):
        raise ValueError(f"not the rows of stage {stage} of at most {NARROW_MAX} bases")
    link = torch.where(live, ptr, NARROW_ENDED | (cyc.to(torch.int64) << 6)
                       | (endj.to(torch.int64) << 5) | length)
    return tk.to_bits32(torch.stack([hi, (flag.to(torch.int64) << 31) | link], dim=1))


def widen_rows(narrow: torch.Tensor, stage: int) -> torch.Tensor:
    """Narrow rows int32 [2N, 2] of `stage` -> the int32 [2N, 4] rows that
    `pack_rows` gives for the same state."""
    bases, link = tk.from_bits32(narrow).unbind(1)
    ended = (link & NARROW_ENDED) == NARROW_ENDED
    ptr = torch.where(ended, JUMP_END, link & 0x7FFFFFFF)
    length = torch.where(ended, link & 0x1F, 1 << stage)
    meta = (length | (torch.where(ended, (link >> 5) & 1, 0) << 29) | ((link >> 31) << 30)
            | (torch.where(ended, (link >> 6) & 1, 0) << 31))
    return tk.to_bits32(torch.stack([bases, torch.zeros_like(bases), ptr, meta], dim=1))


def stage0_plain(kd: torch.Tensor, edges: torch.Tensor, flags: torch.Tensor,
                 buckets: torch.Tensor, k: int):
    """Stage 0 in both orientations, interleaved to rows 2*i + d (the
    unpacked state of what `ctk_jump_stage0` writes)."""
    words = tk.from_bits32(kd)
    e = edges.to(torch.int64)
    fwd = jump_stage0(words, e, flags, buckets, k, 0)
    rev = jump_stage0(words, e, flags, buckets, k, 1)
    return tuple(torch.stack([a, b], dim=1).reshape(-1) for a, b in zip(fwd, rev))


def jump_rows_plain(kd: torch.Tensor, edges: torch.Tensor, flags: torch.Tensor,
                    buckets: torch.Tensor, k: int) -> torch.Tensor:
    """Stage 0, the doubling passes and the packing, in plain PyTorch."""
    state = stage0_plain(kd, edges, flags, buckets, k)
    for _ in range(COMPOSE_PASSES):
        state = jump_compose(*state)
    return pack_rows(*state)


# ---------------------------------------------------------------------------
# build: wrappers
# ---------------------------------------------------------------------------

def _check_table_inputs(kd, edges, flags, buckets, k):
    n, w = kd.shape
    if kd.dtype != torch.int32 or buckets.dtype != torch.int32:
        raise TypeError("k-mer words and buckets must be int32 bit patterns")
    if edges.dtype != torch.uint8 or flags.dtype != torch.bool:
        raise TypeError("edges must be uint8 and flags bool")
    if edges.shape != (n,) or flags.shape != (n,):
        raise ValueError("edges and flags must have one entry a k-mer")
    if w != tk.words(k) or not 1 <= k <= 63:
        raise ValueError(f"k={k} needs {tk.words(k)} words a k-mer, got {w}")
    if buckets.dim() != 3 or buckets.shape[1:] != (2, w + 1):
        raise ValueError("buckets must be [NB, 2, W+1]")
    nb = buckets.shape[0]
    if nb & (nb - 1):
        raise ValueError("the bucket count must be a power of two")
    devs = {kd.device, edges.device, flags.device, buckets.device}
    if len(devs) != 1:
        raise ValueError("all table inputs must be on one device")


def _check_rows(rows: torch.Tensor, n2: int, width: int) -> None:
    if rows.shape != (n2, width) or rows.dtype != torch.int32 or not rows.is_contiguous():
        raise ValueError(f"rows must be contiguous int32 [{n2}, {width}]")
    if rows.data_ptr() % 16:
        raise ValueError("rows must be 16-byte aligned")
    if n2 > NARROW_ENDED:
        raise ValueError(f"a jump table holds at most {NARROW_ENDED} rows")


def stage0_kernel(kd: torch.Tensor, edges: torch.Tensor, flags: torch.Tensor,
                  buckets: torch.Tensor, k: int, rows: torch.Tensor) -> None:
    """One `ctk_jump_stage0` launch: narrow stage-0 rows of both
    orientations into `rows` (int32 [2N, 2], on the card)."""
    n, w = kd.shape
    _check_rows(rows, 2 * n, 2)
    if buckets.data_ptr() % 16:
        raise ValueError("buckets must be 16-byte aligned")
    err = _kernels.library().ctk_jump_stage0(
        kd.data_ptr(), edges.data_ptr(), flags.data_ptr(), buckets.data_ptr(),
        buckets.shape[0], n, w, k, rows.data_ptr(), _kernels.stream(kd.device))
    _kernels.check(err, "jump_stage0")
    LAUNCHES["jump_stage0"] += 1


def compose_kernel(src: torch.Tensor, dst: torch.Tensor, stage: int) -> None:
    """One `ctk_jump_compose` launch: the doubling pass from the narrow rows
    of `stage` (int32 [2N, 2], on the card) into `dst`: the narrow rows of
    stage + 1 (stage < NARROW_PASSES) or the wide rows int32 [2N, 4]."""
    n2 = src.shape[0]
    _check_rows(src, n2, 2)
    out_wide = dst.dim() == 2 and dst.shape[1] == 4
    _check_rows(dst, n2, 4 if out_wide else 2)
    if not 0 <= stage <= NARROW_PASSES or (stage == NARROW_PASSES and not out_wide):
        raise ValueError(f"stage {stage}: a narrow row holds at most {NARROW_MAX} bases")
    err = _kernels.library().ctk_jump_compose(
        src.data_ptr(), dst.data_ptr(), n2, stage, int(out_wide), _kernels.stream(src.device))
    _kernels.check(err, "jump_compose")
    LAUNCHES["jump_compose"] += 1


def jump_rows(kd: torch.Tensor, edges: torch.Tensor, flags: torch.Tensor,
              buckets: torch.Tensor, k: int) -> torch.Tensor:
    """Rows int32 [2N, 4] of the jump table: the plain twins for CPU
    tensors; for CUDA tensors one `ctk_jump_stage0` launch and five
    `ctk_jump_compose` launches (the last one's rows are the table).  Stage 0
    and the first NARROW_PASSES passes ping-pong between two narrow buffers;
    the last pass widens into the table."""
    _check_table_inputs(kd, edges, flags, buckets, k)
    if kd.device.type == "cpu":
        return jump_rows_plain(kd, edges, flags, buckets, k)
    if kd.device.type != "cuda":
        raise ValueError(f"unsupported device {kd.device}")
    kd, edges, flags, buckets = (t.contiguous() for t in (kd, edges, flags, buckets))
    n2 = 2 * kd.shape[0]
    rows = torch.empty((n2, 4), dtype=torch.int32, device=kd.device)
    if n2 == 0:
        return rows
    narrow = torch.empty((2, n2, 2), dtype=torch.int32, device=kd.device)
    stage0_kernel(kd, edges, flags, buckets, k, narrow[0])
    for stage in range(COMPOSE_PASSES):
        dst = narrow[(stage + 1) % 2] if stage < NARROW_PASSES else rows
        compose_kernel(narrow[stage % 2], dst, stage)
    return rows


def build_jump_table(kmers: np.ndarray, edges: np.ndarray, k: int,
                     flags: np.ndarray | None = None, device=None) -> JumpTable:
    """Jump table of a graph colour (twin of cuckoo.py::build_jump_table).
    kmers uint32 [N, W] (the graph's canonical words), edges uint8 [N] (the
    walk colour's edge bytes), flags bool [N] (a per-k-mer attribute, e.g.
    "carries link records", ORed along runs and walks into `touched`).
    The table lives on `device` (default: the CUDA card, and RuntimeError
    without one; "cpu" runs the plain twins)."""
    device = resolve(device)
    n = kmers.shape[0]
    buckets, kd = build_buckets(kmers, device)
    ed = torch.from_numpy(np.ascontiguousarray(edges, dtype=np.uint8)).to(device)
    fl = np.zeros(n, dtype=bool) if flags is None else np.asarray(flags, dtype=bool)
    fd = torch.from_numpy(np.ascontiguousarray(fl)).to(device)
    rows = jump_rows(kd, ed, fd, buckets, k)
    return JumpTable(rows=rows, buckets=buckets)


# ---------------------------------------------------------------------------
# walk
# ---------------------------------------------------------------------------

def seed_rows(buckets: torch.Tensor, seeds: torch.Tensor, k: int) -> torch.Tensor:
    """Row id of each walk-oriented seed (int64 [B, W] words): 2*record +
    flipped, or -1 when the seed is not in the graph (twin of
    cuckoo.py::_jump_seed_rows)."""
    canon, flipped = tk.canonicalize_words(seeds, k)
    payload, present = lookup_payload_tag(buckets, canon)
    return torch.where(present, 2 * payload + flipped.to(torch.int64), -1)


def _keep_mask(keep: torch.Tensor) -> torch.Tensor:
    """The top `keep` bits of a 32-bit word, keep in [0, 32]."""
    full = torch.full_like(keep, tk.M32)
    return torch.where(keep >= 32, full,
                       torch.where(keep > 0,
                                   (full << (32 - keep).clamp(0, 32)) & tk.M32, 0))


def jump_walk(rows: torch.Tensor, start: torch.Tensor, num_steps: int,
              visited: list | None = None):
    """Plain twin of cuckoo.py::_jump_walk: jump_iters(num_steps) pointer
    jumps over a batch of lanes from row ids `start` (int64, -1 =
    inactive), Brent cycle detection at jump stride.  Returns (packed int64
    [B, 2T] words (e_hi, e_lo) a jump, steps, cycled, touched, endj).  A
    `visited` list receives the ids of the rows the active lanes read, a
    tensor a jump."""
    table = tk.from_bits32(rows)
    iters = jump_iters(num_steps)
    b = start.shape[0]
    dev = start.device
    row, active, saved = start.clone(), start >= 0, start.clone()
    emitcnt = torch.zeros(b, dtype=torch.int64, device=dev)
    power = torch.ones_like(emitcnt)
    lam = torch.zeros_like(emitcnt)
    cycled = torch.zeros(b, dtype=torch.bool, device=dev)
    touched, endj = torch.zeros_like(cycled), torch.zeros_like(cycled)
    out = torch.zeros((b, iters, 2), dtype=torch.int64, device=dev)
    for t in range(iters):
        hi, lo, ptr, meta = table[row.clamp(min=0)].unbind(1)
        if visited is not None:
            visited.append(row[active])
        run_len = meta & 0x3F
        run_cyc = (meta >> 31) != 0
        touched = touched | (active & (((meta >> 30) & 1) != 0))
        # the lane's stop cause is the endj bit of the last row it read
        endj = torch.where(active, ((meta >> 29) & 1) != 0, endj)

        m = torch.minimum(run_len, num_steps - emitcnt)
        emit = active & (m > 0)
        mm = torch.where(emit, m, 0)
        has_next = emit & (m == run_len) & (ptr != JUMP_END) & ~run_cyc
        is_cycle = has_next & (ptr == saved)
        ends_cycle = ((emit & run_cyc & (m == run_len))
                      | (active & run_cyc & (run_len == 0)))
        advance = has_next & ~is_cycle & (emitcnt + mm < num_steps)

        # keep the first mm bases only (the cap may clamp the final jump)
        keep = 2 * mm
        out[:, t, 0] = torch.where(emit, hi & _keep_mask(keep.clamp(max=32)), 0)
        out[:, t, 1] = torch.where(emit, lo & _keep_mask((keep - 32).clamp(min=0)), 0)

        teleport = (power == lam) & advance
        saved = torch.where(teleport, ptr, saved)
        power = torch.where(teleport, power * 2, power)
        lam = torch.where(teleport, 0, lam)
        lam = torch.where(advance, lam + 1, lam)
        row = torch.where(advance, ptr, row)
        emitcnt = emitcnt + mm
        cycled = cycled | is_cycle | ends_cycle
        active = advance
    return out.reshape(b, 2 * iters), emitcnt, cycled, touched, endj


def _check_walk(buckets: torch.Tensor, rows: torch.Tensor, seeds: torch.Tensor,
                k: int, num_steps: int) -> None:
    w = tk.words(k)
    if seeds.dtype != torch.int32 or seeds.dim() != 2 or seeds.shape[1] != w:
        raise ValueError(f"seeds must be int32 [B, {w}] words")
    if rows.dtype != torch.int32 or rows.dim() != 2 or rows.shape[1] != 4:
        raise ValueError("rows must be int32 [2N, 4]")
    if buckets.dim() != 3 or buckets.shape[1:] != (2, w + 1):
        raise ValueError("buckets must be [NB, 2, W+1]")
    if num_steps < 0 or not seeds.device == rows.device == buckets.device:
        raise ValueError("num_steps must be >= 0 and all tensors on one device")
    if seeds.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {seeds.device}")


def lane_views(lanes: torch.Tensor, b: int):
    """(steps int32[B], cycled, touched, endj bool[B]): views of the byte
    buffer `ctk_jump_walk` writes its per-lane results to (int32 steps, then
    the three flags a byte each), on the card or in a host copy."""
    flags = lanes[4 * b:].view(3, b).view(torch.bool)
    return lanes[:4 * b].view(torch.int32), flags[0], flags[1], flags[2]


def walk_pitch(num_steps: int) -> int:
    """Jump slots a lane row of the walk kernel's output holds: the
    jump_iters(num_steps) of the [B, 2T] contract rounded up to a multiple of
    4 (32 bytes, one DRAM sector)."""
    return -(-jump_iters(num_steps) // 4) * 4


def walk_jumps(buckets: torch.Tensor, rows: torch.Tensor, seeds: torch.Tensor,
               k: int, num_steps: int):
    """Seed lookup + jump walk of walk-oriented seeds (int32 [B, W] bit
    patterns).  Returns (packed int32 [B, 2T] bit patterns, steps int32[B],
    cycled, touched, endj bool[B]): the plain twins for CPU tensors; for CUDA
    tensors one `ctk_jump_walk` launch into fresh buffers, nothing
    zero-filled (the kernel writes every jump slot and every lane's
    results), `packed` a strided view of its rows of walk_pitch(num_steps)
    slots and the rest views of its lane buffer (lane_views)."""
    _check_walk(buckets, rows, seeds, k, num_steps)
    if seeds.device.type == "cpu":
        start = seed_rows(buckets, tk.from_bits32(seeds), k)
        packed, steps, cycled, touched, endj = jump_walk(rows, start, num_steps)
        return tk.to_bits32(packed), steps.to(torch.int32), cycled, touched, endj
    b = seeds.shape[0]
    seeds, rows, buckets = seeds.contiguous(), rows.contiguous(), buckets.contiguous()
    if rows.data_ptr() % 16 or buckets.data_ptr() % 16:
        raise ValueError("rows and buckets must be 16-byte aligned")
    out = torch.empty((b, 2 * walk_pitch(num_steps)), dtype=torch.int32, device=seeds.device)
    lanes = torch.empty(7 * b, dtype=torch.uint8, device=seeds.device)
    if b:
        walk_kernel(buckets, rows, seeds, k, num_steps, out, lanes)
    return (out[:, :2 * jump_iters(num_steps)], *lane_views(lanes, b))


def walk_kernel(buckets: torch.Tensor, rows: torch.Tensor, seeds: torch.Tensor,
                k: int, num_steps: int, out: torch.Tensor, lanes: torch.Tensor) -> None:
    """One `ctk_jump_walk` launch on checked, contiguous card tensors.  out
    int32 [B, 2P] holds P jump slots a lane, a multiple of 4 and at least
    jump_iters(num_steps); the kernel writes every one (zeros past the
    contract's).  lanes: uint8 [7B] (see lane_views)."""
    b = seeds.shape[0]
    if out.dim() != 2 or out.shape[0] != b or out.shape[1] % 8 or not out.is_contiguous() or \
            out.dtype != torch.int32 or out.shape[1] < 2 * jump_iters(num_steps) or \
            lanes.shape != (7 * b,) or lanes.dtype != torch.uint8:
        raise ValueError("out must be contiguous int32 [B, 2P], P a multiple of 4 and at least "
                         "jump_iters(num_steps), and lanes uint8 [7B]")
    err = _kernels.library().ctk_jump_walk(
        rows.data_ptr(), buckets.data_ptr(), buckets.shape[0], seeds.shape[1], k,
        seeds.data_ptr(), b, num_steps, jump_iters(num_steps), out.shape[1] // 2, out.data_ptr(),
        lanes.data_ptr(), _kernels.stream(seeds.device))
    _kernels.check(err, "jump_walk")
    LAUNCHES["jump_walk"] += 1


def walk_forward_jumps(buckets: torch.Tensor, rows: torch.Tensor,
                       seeds: np.ndarray, k: int, num_steps: int):
    """The walk entry point, as corticall_tpu/ops/cuckoo.py::
    walk_forward_jumps: seeds uint32 [B, W] walk-oriented words ->
    (packed uint32 [B, 2T], cycled bool[B], steps int32[B], saturated
    bool[B], touched bool[B], ends_junction bool[B]) as numpy arrays.
    `saturated` marks lanes still walking when `steps` hit the cap: the
    jump-stride Brent may not have closed their cycle yet.  On the card
    walk_jumps' results are copied into fresh pinned host memory,
    asynchronously on the current stream (the jump slots by one pitched 2-D
    copy that drops the rows' padding), with one synchronize; the arrays are
    views that keep their host tensors alive."""
    card, *lane = walk_jumps(buckets, rows, words_tensor(seeds, rows.device), k, num_steps)
    packed = card
    if card.device.type == "cuda":
        b, width = card.shape
        packed = torch.empty((b, width), dtype=torch.int32, pin_memory=True)
        _kernels.check(_kernels.library().ctk_copy_rows_to_host(
            packed.data_ptr(), 4 * width, card.data_ptr(), 4 * card.stride(0), 4 * width, b,
            _kernels.stream(card.device)), "copy_rows_to_host")
        lane = [torch.empty(x.shape, dtype=x.dtype, pin_memory=True).copy_(x, non_blocking=True)
                for x in lane]
        torch.cuda.current_stream(card.device).synchronize()
    steps, cycled, touched, endj = (x.numpy() for x in lane)
    saturated = (steps >= num_steps) & ~cycled
    return (packed.numpy().view(np.uint32), cycled, steps, saturated, touched, endj)
