"""The hash-sharded graph's device steps: routing, the owners' answers, the
walk step and the linked step, each a CUDA kernel with a plain PyTorch twin.

Counterpart of the XLA device code of corticall_tpu/parallel/mesh.py:
  route           <- kmer_jax.canonicalize_words (:310, :422, :574) and the
                     routing half of _routed_exchange (:111-118): each
                     query's owner, routing_hash(canonical) % n, and its
                     place in a send buffer packed by owner;
  shard_answer    <- the local answer of sharded_lookup_fn /
                     sharded_lookup_tree_fn (:180-185, :205-209):
                     cuckoo.lookup_payload (corticall_tpu/ops/cuckoo.py:190)
                     and the payload gathers (:278-292, :407-413, :559-565);
  shard_walk_step <- the walk step of :419-438 and :568-583, with the unsort
                     of the returned answers (:163-165);
  link_step       <- one step of :300-325, walk_links.store_add and
                     store_advance on the routed payload, for every shard
                     of one device in one call.
The capacity-bounded exchange rounds of _routed_exchange (`_lookup_cap`, the
`pmax` of the rounds, the `q_pad` clamp guard, `pcast`) exist for XLA's
static shapes and are not ported: each owner gets exactly its queries.

The exchange works a device at a time.  A device's queries are those of
the shards it holds (its askers), one shard after another; `route` packs
them all into one send buffer, owner-major: owner t's block,
send[offsets[t]:offsets[t + 1]], holds the queries sent to t in the
queries' order, so asker after asker (the order of a stable sort by owner,
JAX's argsort within each asker).  `shard_answer` answers the owners of a
device at once, each from its own block of a received buffer (on one
device, the send buffer itself), into an answer buffer of the same rows:
a query's answer is row slot[query] wherever it was answered.

Answers are int32 rows [R, A]: the shard-local record (-1: a miss), the
combined edge byte (the OR over the walk colours; 0 on a miss), and with the
link CSR also the record's link count, then its first MAX_ADD link rows
(choice words, lengths, forward flags); rows past min(count, MAX_ADD) are
zero (the JAX payload carries the pool rows clamped to its end there, which
store_add never reads).

Each wrapper runs its twin for CPU tensors and launches its kernel
(csrc/shard.cu; ctk_link_step in csrc/walk_links.cu) for CUDA tensors, with
their card as the current device (a shard may sit on any card), and counts
the launch in LAUNCHES.  The step wrappers update the walk state in
place and write row `step` of the emission stream; `link_step` takes the
shards of one device together and steps them in one launch (its twin,
`link_step_plain`, one shard a call).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from . import _kernels
from . import cuckoo as ck
from . import kmer as tk
from .placement import GOLDEN, np_hash_words, np_mix32
from .walk_links import (CAP, JW, MAX_ADD, STORE_FIELDS, store_add, store_advance,
                         store_flags)

MAX_SHARDS = 64          # the route kernel's per-owner tables live in shared memory

# answer columns (the kernels' copy: csrc/shard_answer.cuh)
ANS_REC, ANS_EDGE, ANS_CNT = 0, 1, 2
ANS_CHOICES = 3                          # MAX_ADD rows of JW words
ANS_LEN = ANS_CHOICES + MAX_ADD * JW
ANS_FW = ANS_LEN + MAX_ADD
WALK_ANSWER = 2
LINK_ANSWER = ANS_FW + MAX_ADD

STORE_NONEMPTY, STORE_PENDING = 1, 2     # LinkState.bits (csrc/link_store.cuh)

# kernel launches (plain integers; chip_smoke.py resets and reads them)
LAUNCHES = {"route": 0, "shard_answer": 0, "shard_walk_step": 0, "link_step": 0}


def routing_hash_np(words: np.ndarray) -> np.ndarray:
    """Shard-routing hash of uint32 [..., W] words (a stream apart from the
    table hash: re-mixed), mesh.py:36."""
    return np_mix32(np_hash_words(words) ^ np.uint32(GOLDEN))


def routing_hash(words: torch.Tensor) -> torch.Tensor:
    """routing_hash_np on words held in int64 (mesh.py:41)."""
    return tk.mix32(tk.hash_words(words) ^ GOLDEN)


class Route(NamedTuple):
    """A device's route of its askers' queries (B of them, asker after
    asker, over n owners)."""
    send: torch.Tensor     # int32 [B, W]: the routed queries' canonical words, owner-major
    slot: torch.Tensor     # int32 [B]: each query's row in send (and in the answers), -1: not routed
    owner: torch.Tensor    # int32 [B]: routing_hash(canonical) % n
    flipped: torch.Tensor  # uint8 [B]: the canonical form is the reverse complement
    counts: torch.Tensor   # int32 [askers, n]: each asker's routed queries of each owner
    offsets: torch.Tensor  # int32 [n + 1]: owner t's block of send; offsets[n], the routed total


@dataclass
class WalkState:
    """A shard's single-successor walks (mesh.py:419-438): int32 words and
    counters, uint8 flags, the int8 [T, B] emission stream."""
    cur: torch.Tensor
    active: torch.Tensor
    saved: torch.Tensor
    power: torch.Tensor
    lam: torch.Tensor
    cycled: torch.Tensor
    steps: torch.Tensor
    stream: torch.Tensor

    @classmethod
    def start(cls, seeds: torch.Tensor, active: torch.Tensor, num_steps: int) -> "WalkState":
        b, dev = seeds.shape[0], seeds.device
        zeros = torch.zeros(b, dtype=torch.int32, device=dev)
        return cls(seeds.clone(), active.to(torch.uint8).clone(), seeds.clone(), zeros + 1,
                   zeros.clone(), torch.zeros(b, dtype=torch.uint8, device=dev), zeros.clone(),
                   torch.full((num_steps, b), -1, dtype=torch.int8, device=dev))


@dataclass
class LinkState:
    """A shard's linked walks (mesh.py:300-325): the walks' words, flags and
    junction counts, each walk's LinkStore as int32 [B, STORE_FIELDS, CAP]
    (element-minor: one field of one walk is 128 contiguous bytes), the
    store's bits (uint8 [B]: STORE_NONEMPTY, a valid element; STORE_PENDING,
    a valid element of age 0; the kernel reads them in place of the store
    on the steps that cannot change it), and the int8 [T, B] emission
    stream."""
    cur: torch.Tensor
    active: torch.Tensor
    overflow: torch.Tensor
    junctions: torch.Tensor
    store: torch.Tensor
    bits: torch.Tensor
    stream: torch.Tensor

    @classmethod
    def start(cls, seeds: torch.Tensor, active: torch.Tensor, num_steps: int) -> "LinkState":
        b, dev = seeds.shape[0], seeds.device
        return cls(seeds.clone(), active.to(torch.uint8).clone(),
                   torch.zeros(b, dtype=torch.uint8, device=dev),
                   torch.zeros(b, dtype=torch.int32, device=dev),
                   torch.zeros((b, STORE_FIELDS, CAP), dtype=torch.int32, device=dev),
                   torch.zeros(b, dtype=torch.uint8, device=dev),
                   torch.full((num_steps, b), -1, dtype=torch.int8, device=dev))


def _check_device(what: str, *tensors) -> torch.device:
    devices = {t.device for t in tensors if t is not None}
    if len(devices) != 1:
        raise ValueError(f"{what}: the tensors must lie on one device, not {devices}")
    dev = devices.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {dev}")
    return dev


# ---------------------------------------------------------------------------
# route
# ---------------------------------------------------------------------------

ROUTE_TILE = 256         # queries a tile of ctk_route (csrc/shard.cu kRouteThreads)
_BARRIERS: dict = {}     # card -> ctk_route's grid-barrier words (zero, and left so)


def _batches(b: int, batches) -> list:
    batches = [b] if batches is None else [int(x) for x in batches]
    if not 1 <= len(batches) <= MAX_SHARDS or min(batches) < 0 or sum(batches) != b:
        raise ValueError(f"the askers' counts {batches} do not split {b} queries "
                         f"(1 to {MAX_SHARDS} askers)")
    return batches


def route_plain(cur: torch.Tensor, active, k: int, n: int, batches=None) -> Route:
    """Twin of ctk_route: canonical form, owner, and the send buffer packed
    by a stable sort of the routed queries by owner; `active` (uint8 [B],
    or None for every query) picks the queries to send, `batches` the
    askers' counts (default: one asker)."""
    b = cur.shape[0]
    batches = _batches(b, batches)
    canon, flipped = tk.canonicalize_words(tk.from_bits32(cur), k)
    owner = routing_hash(canon) % n
    live = (torch.ones(b, dtype=torch.bool, device=cur.device) if active is None
            else active.to(torch.bool))
    order = torch.argsort(torch.where(live, owner, n), stable=True)
    routed = int(live.sum())
    slot = torch.full((b,), -1, dtype=torch.int32, device=cur.device)
    slot[order[:routed]] = torch.arange(routed, dtype=torch.int32, device=cur.device)
    send = torch.zeros_like(cur)
    send[:routed] = tk.to_bits32(canon[order[:routed]])
    asker = torch.repeat_interleave(torch.arange(len(batches), device=cur.device),
                                    torch.tensor(batches, device=cur.device), output_size=b)
    counts = torch.bincount((asker * n + owner)[live], minlength=len(batches) * n)
    offsets = torch.zeros(n + 1, dtype=torch.int64, device=cur.device)
    offsets[1:] = torch.cumsum(counts.reshape(-1, n).sum(0), 0)
    return Route(send, slot, owner.to(torch.int32), flipped.to(torch.uint8),
                 counts.reshape(-1, n).to(torch.int32), offsets.to(torch.int32))


def route(cur: torch.Tensor, active, k: int, n: int, batches=None) -> Route:
    """A device's walk-oriented k-mers int32 [B, W], its askers' queries one
    asker after another (`batches`: their counts; default one asker), ->
    their Route over n shards: the twin for CPU tensors, one ctk_route
    launch for CUDA ones."""
    w = tk.words(k)
    if cur.dtype != torch.int32 or cur.dim() != 2 or cur.shape[1] != w or not 1 <= k <= 63:
        raise ValueError(f"queries must be int32 [B, {w}] words, 1 <= k <= 63")
    if not 1 <= n <= MAX_SHARDS:
        raise ValueError(f"1 <= shards <= {MAX_SHARDS}")
    if active is not None and (active.dtype != torch.uint8 or active.shape != cur.shape[:1]):
        raise ValueError("active must be uint8 [B]")
    batches = _batches(cur.shape[0], batches)
    dev = _check_device("route", cur, active)
    if dev.type == "cpu":
        return route_plain(cur, active, k, n, batches)
    b = cur.shape[0]
    out = Route(torch.empty_like(cur), torch.empty(b, dtype=torch.int32, device=dev),
                torch.empty(b, dtype=torch.int32, device=dev),
                torch.empty(b, dtype=torch.uint8, device=dev),
                torch.empty((len(batches), n), dtype=torch.int32, device=dev),
                torch.empty(n + 1, dtype=torch.int32, device=dev))
    route_kernel(cur.contiguous(), None if active is None else active.contiguous(), k, n,
                 batches, out)
    return out


def route_kernel(cur, active, k: int, n: int, batches: list, out: Route) -> None:
    """One ctk_route launch on checked, contiguous card tensors, writing
    `out` (a cooperative launch: its blocks meet at grid barriers, whose
    words this card keeps in _BARRIERS)."""
    dev = cur.device
    if dev not in _BARRIERS:
        _BARRIERS[dev] = torch.zeros(2, dtype=torch.int32, device=dev)
    tiles = sum(-(-x // ROUTE_TILE) for x in batches)
    scratch = torch.empty(n * (tiles + 1), dtype=torch.int32, device=dev)
    counts = (ctypes.c_int * len(batches))(*batches)
    with torch.cuda.device(dev):
        err = _kernels.library().ctk_route(
            cur.data_ptr(), cur.shape[1], k, n, None if active is None else active.data_ptr(),
            ctypes.addressof(counts), len(batches), out.owner.data_ptr(),
            out.flipped.data_ptr(), out.slot.data_ptr(), out.send.data_ptr(),
            out.counts.data_ptr(), out.offsets.data_ptr(), scratch.data_ptr(),
            _BARRIERS[dev].data_ptr(), _kernels.stream(dev))
    _kernels.check(err, "route")
    LAUNCHES["route"] += 1


# ---------------------------------------------------------------------------
# the shard's answer
# ---------------------------------------------------------------------------

def shard_answer_plain(recv, buckets, edges, colors, links=None) -> torch.Tensor:
    """One owner's answers: canonical queries int32 [R, W] it received ->
    int32 answer rows [R, A] (see the module docstring); card_answer_plain
    runs it on each owner's block."""
    r = recv.shape[0]
    dev = recv.device
    rec = tk.from_bits32(ck.lookup_payload(buckets, recv)) - 1
    found = rec >= 0
    hit = rec[found]
    edge = torch.zeros(r, dtype=torch.int64, device=dev)
    e = edges[hit].to(torch.int64)
    for c in colors:
        edge[found] |= e[:, c]
    cols = [rec, edge]
    if links is not None:
        offsets, choices, lengths, forward = links
        off = torch.zeros(r, dtype=torch.int64, device=dev)
        cnt = torch.zeros(r, dtype=torch.int64, device=dev)
        off[found] = offsets[hit].to(torch.int64)
        cnt[found] = offsets[hit + 1].to(torch.int64) - off[found]
        jj = torch.arange(MAX_ADD, device=dev)
        take = jj < cnt.clamp(max=MAX_ADD)[:, None]                       # [R, MAX_ADD]
        src = (off[:, None] + jj).clamp(max=lengths.shape[0] - 1)[take]
        ch = torch.zeros((r, MAX_ADD, JW), dtype=torch.int64, device=dev)
        ln = torch.zeros((r, MAX_ADD), dtype=torch.int64, device=dev)
        fw = torch.zeros((r, MAX_ADD), dtype=torch.int64, device=dev)
        ch[take] = tk.from_bits32(choices[src])
        ln[take] = lengths[src].to(torch.int64)
        fw[take] = forward[src].to(torch.int64)
        cols += [cnt, ch.reshape(r, MAX_ADD * JW), ln, fw]
    cols = [c[:, None] if c.dim() == 1 else c for c in cols]
    return tk.to_bits32(torch.cat(cols, dim=1))


def card_answer_plain(recv, offsets, buckets, edges, colors, links=None) -> torch.Tensor:
    """Twin of ctk_shard_answer: the answers of several owners of one
    device to the queries they received, owner j's block
    recv[offsets[j]:offsets[j + 1]] by shard_answer_plain on its tables;
    rows past offsets[-1] zero."""
    cols = WALK_ANSWER if links is None else LINK_ANSWER
    ans = torch.zeros((recv.shape[0], cols), dtype=torch.int32, device=recv.device)
    off = offsets.tolist()
    for j, (lo, hi) in enumerate(zip(off, off[1:])):
        if hi > lo:
            ans[lo:hi] = shard_answer_plain(recv[lo:hi], buckets[j], edges[j], colors,
                                            None if links is None else links[j])
    return ans


def _color_mask(colors, num_colors: int) -> int:
    mask = 0
    for c in colors:
        if not 0 <= c < num_colors or c >= 32:
            raise ValueError(f"colour {c} outside the graph's {num_colors} (at most 32)")
        mask |= 1 << c
    return mask


def shard_answer(recv, offsets, buckets, edges, colors, links=None) -> torch.Tensor:
    """The answers of a device's owners to the canonical queries they
    received: recv int32 [R, W], owner j's block recv[offsets[j]:offsets[j +
    1]] (offsets int32 [m + 1] on the device, offsets[m] <= R, read there by
    the kernel); each owner's buckets int32 [NB, BS, W+1] (payload = its
    record + 1, one shape for all), edges uint8 [N_j, C], the walk colours,
    and optionally each owner's link CSR (offsets int32 [N_j + 1], choices
    int32 [P, JW], lengths int32 [P], forward uint8 [P], P >= 1).  Returns
    int32 [R, A], row i answering recv row i; rows past offsets[m] are left
    unwritten (zero in the twin).  The twin for CPU tensors, one
    ctk_shard_answer launch for CUDA ones."""
    m = len(buckets)
    if not 1 <= m <= MAX_SHARDS or len(edges) != m or (links is not None and len(links) != m):
        raise ValueError(f"one to {MAX_SHARDS} owners, each with buckets, edges (and links)")
    shape = buckets[0].shape
    w = shape[2] - 1 if len(shape) == 3 else 0
    nb = shape[0]
    if any(b.dtype != torch.int32 or b.shape != shape for b in buckets) or len(shape) != 3 \
            or not 1 <= w <= 4 or nb & (nb - 1):
        raise ValueError("buckets must be int32 [NB, BS, W+1], NB a power of two, one shape "
                         "for every owner")
    if recv.dtype != torch.int32 or recv.dim() != 2 or recv.shape[1] != w:
        raise ValueError(f"queries must be int32 [R, {w}]")
    if offsets.dtype != torch.int32 or tuple(offsets.shape) != (m + 1,):
        raise ValueError(f"offsets must be int32 [{m + 1}]")
    num_colors = edges[0].shape[1] if edges[0].dim() == 2 else 0
    if any(e.dtype != torch.uint8 or e.dim() != 2 or e.shape[1] != num_colors for e in edges):
        raise ValueError("edges must be uint8 [N, C], one C for every owner")
    mask = _color_mask(colors, num_colors)
    for j, csr in enumerate(links or ()):
        lo, choices, lengths, forward = csr
        p = lengths.shape[0]
        if lo.dtype != torch.int32 or tuple(lo.shape) != (edges[j].shape[0] + 1,) or \
                p < 1 or choices.dtype != torch.int32 or tuple(choices.shape) != (p, JW) or \
                lengths.dtype != torch.int32 or forward.dtype != torch.uint8 or \
                tuple(forward.shape) != (p,):
            raise ValueError("the link CSR must be int32 [N+1], int32 [P, JW], int32 [P], "
                             "uint8 [P], P >= 1")
    dev = _check_device("shard_answer", recv, offsets, *buckets, *edges,
                        *(t for csr in links or () for t in csr))
    if dev.type == "cpu":
        return card_answer_plain(recv, offsets, buckets, edges, colors, links)
    ans = torch.empty((recv.shape[0], WALK_ANSWER if links is None else LINK_ANSWER),
                      dtype=torch.int32, device=dev)
    if recv.shape[0]:
        shard_answer_kernel(recv.contiguous(), offsets.contiguous(),
                            [b.contiguous() for b in buckets], [e.contiguous() for e in edges],
                            mask, None if links is None else
                            [tuple(x.contiguous() for x in csr) for csr in links], ans)
    return ans


# ctk_shard_answer's owner descriptor (csrc/shard.cu::AnswerOwner)
ANSWER_OWNER_FIELDS = ("buckets", "edges", "link_off", "link_choices", "link_len", "link_fw")


class AnswerOwner(ctypes.Structure):
    _fields_ = [*((f, ctypes.c_void_p) for f in ANSWER_OWNER_FIELDS), ("num_links", ctypes.c_int)]


def shard_answer_kernel(recv, offsets, buckets: list, edges: list, color_mask: int, links,
                        ans) -> None:
    """One ctk_shard_answer launch on checked, contiguous card tensors: a
    table of owner descriptors passed by value."""
    table = (AnswerOwner * len(buckets))()
    for j, d in enumerate(table):
        d.buckets, d.edges = buckets[j].data_ptr(), edges[j].data_ptr()
        if links is not None:
            lo, ch, ln, fw = links[j]
            d.link_off, d.link_choices, d.link_len, d.link_fw = (
                lo.data_ptr(), ch.data_ptr(), ln.data_ptr(), fw.data_ptr())
            d.num_links = ln.shape[0]
    nb, bs, _ = buckets[0].shape
    with torch.cuda.device(recv.device):
        err = _kernels.library().ctk_shard_answer(
            ctypes.addressof(table), len(buckets), recv.data_ptr(), recv.shape[0],
            recv.shape[1], offsets.data_ptr(), nb, bs, edges[0].shape[1], color_mask,
            ans.data_ptr(), ans.shape[1], _kernels.stream(recv.device))
    _kernels.check(err, "shard_answer")
    LAUNCHES["shard_answer"] += 1


def _answers(route: Route, back: torch.Tensor, live: torch.Tensor) -> torch.Tensor:
    """The answer row of each live walk (zeros elsewhere), from the answers
    by slot (the unsort)."""
    got = torch.zeros((live.shape[0], back.shape[1]), dtype=torch.int64, device=back.device)
    got[live] = back[route.slot[live].to(torch.int64)].to(torch.int64)
    return got


# ---------------------------------------------------------------------------
# the walk step
# ---------------------------------------------------------------------------

def shard_walk_step_plain(state: WalkState, route: Route, back, k: int, step: int,
                          cycle_check: bool = True) -> None:
    """Twin of ctk_shard_walk_step: one single-successor step of every walk
    from its returned answer (edge byte, record), with Brent's cycle test
    when `cycle_check` (mesh.py:419-438), else the plain advance of
    make_sharded_walk_step (:568-583); updates `state` in place and writes
    row `step` of its stream."""
    live = state.active.to(torch.bool)
    got = _answers(route, back, live)
    e = got[:, ANS_EDGE] & 0xFF
    flipped = route.flipped.to(torch.bool)
    next_mask = torch.where(flipped, e >> 4, e & 0xF)
    base = tk.lowest_set_base(next_mask)
    cur = tk.from_bits32(state.cur)
    nxt = tk.shift_append(cur, base, k)
    single = (tk.popcount4(next_mask) == 1) & (got[:, ANS_REC] >= 0) & live
    if cycle_check:
        is_cycle = (nxt == tk.from_bits32(state.saved)).all(-1) & single
    else:
        is_cycle = torch.zeros_like(single)
    advance = single & ~is_cycle
    if cycle_check:
        power, lam = state.power.to(torch.int64), state.lam.to(torch.int64)
        teleport = (power == lam) & advance
        state.saved.copy_(torch.where(teleport[:, None], tk.to_bits32(nxt), state.saved))
        state.power.copy_(torch.where(teleport, power * 2, power))
        lam = torch.where(teleport, 0, lam)
        state.lam.copy_(torch.where(advance, lam + 1, lam))
        state.cycled |= is_cycle.to(torch.uint8)
    state.cur.copy_(tk.to_bits32(torch.where(advance[:, None], nxt, cur)))
    state.steps += advance.to(torch.int32)
    state.active.copy_(advance.to(torch.uint8))
    state.stream[step] = torch.where(advance, base, -1).to(torch.int8)


def _check_step(what: str, cur, active, route: Route, back, k: int, step: int, stream,
                answer_cols: int) -> torch.device:
    b = cur.shape[0]
    if cur.dtype != torch.int32 or cur.dim() != 2 or cur.shape[1] != tk.words(k) or \
            active.dtype != torch.uint8 or active.shape != (b,):
        raise ValueError(f"{what}: cur must be int32 [B, W] words and active uint8 [B]")
    if route.slot.shape != (b,) or route.flipped.shape != (b,) or back.dtype != torch.int32 \
            or back.dim() != 2 or back.shape[1] < answer_cols:
        raise ValueError(f"{what}: the route and the answers do not fit the walks")
    if not 0 <= step < stream.shape[0] or stream.dtype != torch.int8 or \
            stream.shape[1:] != (b,):
        raise ValueError(f"{what}: step {step} outside the int8 [T, B] stream")
    return _check_device(what, cur, active, route.slot, route.flipped, back, stream)


def shard_walk_step(state: WalkState, route: Route, back, k: int, step: int,
                    cycle_check: bool = True) -> None:
    """One step of a shard's walks (or of every walk of a device's shards,
    as one state) from the answers to its route (int32 [R, A], walk i's at
    row slot[i]): the twin for CPU tensors, one ctk_shard_walk_step launch
    for CUDA ones.  Updates `state` in place."""
    dev = _check_step("shard_walk_step", state.cur, state.active, route, back, k, step,
                      state.stream, WALK_ANSWER)
    if dev.type == "cpu":
        shard_walk_step_plain(state, route, back, k, step, cycle_check)
    elif state.cur.shape[0]:
        shard_walk_step_kernel(state, route, back.contiguous(), k, step, cycle_check)


def shard_walk_step_kernel(state: WalkState, route: Route, back, k: int, step: int,
                           cycle_check: bool) -> None:
    """One ctk_shard_walk_step launch on checked card tensors."""
    with torch.cuda.device(state.cur.device):
        err = _kernels.library().ctk_shard_walk_step(
            state.cur.data_ptr(), state.cur.shape[0], state.cur.shape[1], k,
            state.active.data_ptr(), route.flipped.data_ptr(), route.slot.data_ptr(),
            back.data_ptr(), back.shape[1], state.saved.data_ptr(), state.power.data_ptr(),
            state.lam.data_ptr(), state.cycled.data_ptr(), state.steps.data_ptr(),
            int(cycle_check), state.stream[step].data_ptr(), _kernels.stream(state.cur.device))
    _kernels.check(err, "shard_walk_step")
    LAUNCHES["shard_walk_step"] += 1


# ---------------------------------------------------------------------------
# the linked step
# ---------------------------------------------------------------------------

def link_step_plain(state: LinkState, route: Route, back, k: int, step: int) -> None:
    """Twin of ctk_link_step for one shard: store_add, then store_advance
    (ops/walk_links.py) on each walk's returned payload, at step `step`
    (the seed step is 0, and the insertion counter is MAX_ADD * step, as in
    every walk of the JAX scan); a walk routed while inactive only takes its
    k-mer's record-count overflow, as store_add does.  Updates `state` in
    place, its bits derived from the store after the step, and writes row
    `step` of its stream."""
    live = state.active.to(torch.bool)
    routed = route.slot >= 0
    got = _answers(route, back, routed)
    b = live.shape[0]
    st = state.store.to(torch.int64)
    el_choices = torch.stack([st[:, 0] & tk.M32, st[:, 1] & tk.M32], dim=-1)
    rch = (got[:, ANS_CHOICES:ANS_LEN] & tk.M32).reshape(b, MAX_ADD, JW)
    flipped = route.flipped.to(torch.bool)
    seq_counter = torch.full((b,), MAX_ADD * step, dtype=torch.int64, device=live.device)
    (el_choices, el_len, el_pos, el_age, el_valid, el_seq, _, overflow) = store_add(
        el_choices, st[:, 2], st[:, 3], st[:, 4], st[:, 6] != 0, st[:, 5], seq_counter,
        state.overflow.to(torch.bool), live, flipped, rch, got[:, ANS_LEN:ANS_FW],
        got[:, ANS_FW:LINK_ANSWER] != 0, got[:, ANS_CNT])
    cur, advance, el_pos, el_valid, el_age, emitted, take_choice = store_advance(
        tk.from_bits32(state.cur), live, el_choices, el_len, el_pos, el_age, el_valid,
        el_seq, got[:, ANS_EDGE] & 0xFF, flipped, step == 0, k)
    fields = (tk.to_bits32(el_choices[..., 0]), tk.to_bits32(el_choices[..., 1]), el_len,
              el_pos, el_age, el_seq, el_valid)
    state.store.copy_(torch.stack([f.to(torch.int32) for f in fields], dim=1))
    nonempty, pending = store_flags(el_valid, el_age)
    state.bits.copy_(nonempty.to(torch.uint8) * STORE_NONEMPTY
                     + pending.to(torch.uint8) * STORE_PENDING)
    state.cur.copy_(tk.to_bits32(cur))
    state.overflow.copy_(overflow.to(torch.uint8))
    state.junctions += take_choice.to(torch.int32)
    state.active.copy_(advance.to(torch.uint8))
    state.stream[step] = emitted.to(torch.int8)


def link_step(states: list, routes: list, backs: list, k: int, step: int) -> None:
    """One linked step of the walks of several shards on one device, each
    from the answers to its route (int32 [R, LINK_ANSWER], walk i's at row
    slot[i]): the twin shard by shard for CPU tensors, one ctk_link_step
    launch over them all for CUDA ones.  Updates each state in place."""
    if not len(states) == len(routes) == len(backs):
        raise ValueError("link_step: one route and one answer block a state")
    devices = set()
    for state, route, back in zip(states, routes, backs):
        devices.add(_check_step("link_step", state.cur, state.active, route, back, k, step,
                                state.stream, LINK_ANSWER))
        b = state.cur.shape[0]
        if state.store.shape != (b, STORE_FIELDS, CAP) or state.store.dtype != torch.int32 \
                or state.bits.shape != (b,) or state.bits.dtype != torch.uint8:
            raise ValueError(f"link_step: the store must be int32 [B, {STORE_FIELDS}, {CAP}] "
                             "and its bits uint8 [B]")
    if len(devices) > 1:
        raise ValueError(f"link_step: the shards must lie on one device, not {devices}")
    if not devices:
        return
    if devices.pop().type == "cpu":
        for state, route, back in zip(states, routes, backs):
            link_step_plain(state, route, back, k, step)
    elif any(state.cur.shape[0] for state in states):
        link_step_kernel(states, routes, [bk.contiguous() for bk in backs], k, step)


# ctk_link_step's shard descriptor (csrc/walk_links.cu::LinkShard)
LINK_SHARD_FIELDS = ("cur", "active", "bits", "flipped", "slot", "back", "store", "overflow",
                     "junctions", "row")


class LinkShard(ctypes.Structure):
    _fields_ = [*((f, ctypes.c_void_p) for f in LINK_SHARD_FIELDS),
                ("batch", ctypes.c_int), ("a_cols", ctypes.c_int), ("warp0", ctypes.c_int)]


def link_step_kernel(states: list, routes: list, backs: list, k: int, step: int) -> None:
    """One ctk_link_step call over checked card tensors of one card: a
    table of shard descriptors passed by value, one launch for up to 32
    shards."""
    table = (LinkShard * len(states))()
    for d, state, route, back in zip(table, states, routes, backs):
        for f, t in zip(LINK_SHARD_FIELDS, (state.cur, state.active, state.bits, route.flipped,
                                            route.slot, back, state.store, state.overflow,
                                            state.junctions, state.stream[step])):
            setattr(d, f, t.data_ptr())
        d.batch, d.a_cols, d.warp0 = state.cur.shape[0], back.shape[1], 0
    dev = states[0].cur.device
    with torch.cuda.device(dev):
        err = _kernels.library().ctk_link_step(ctypes.addressof(table), len(states),
                                               tk.words(k), k, step, _kernels.stream(dev))
    _kernels.check(err, "link_step")
    LAUNCHES["link_step"] += 1
