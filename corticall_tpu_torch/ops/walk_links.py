"""Batched link-assisted walks: McCortex link-following on the device.

Counterpart of corticall_tpu/ops/walk_links.py: `LinkArrays` and
`build_link_arrays` (:44, :54), `store_add` (:97), `store_advance` (:135),
`_char_at` (:192), `walk_links_forward` (:199), `decode_linked_walk` (:281),
`LinkedWalker` (:311) and `assemble_batch_links` (:385).

Each walk carries a LinkStore of CAP = 32 link elements (two choice words,
length, position, age, insertion sequence, valid), and every step runs the
host store's semantics (traversal/linkstore.py):
  1. arriving at a k-mer appends its link records (orientation-gated), at
     most MAX_ADD, each into the free slot of equal rank;
  2. at a junction the oldest live elements must agree on the next choice;
     the emitted char comes from the latest element of the chosen junction
     list (LinkStore.java:92-144);
  3. consuming a choice advances matching elements and expires the rest;
  4. ages bump once a junction and once a step that added elements.
The seed step follows the degree only and consults no store.  A capacity
overflow sets a per-walk flag, for callers to replay on the host.

A step of an active walk is needy (`needy_steps`) when its k-mer has link
records, or it is a junction and the store holds an element, or an element
of age 0 is pending (filled at the seed step); any other step leaves the
store and the overflow as they are and emits base | 8 * non-empty, or -1 at
a dead end or a junction.

`walk_links_forward` runs `walk_links_forward_plain` (PyTorch, one step at a
time, uint32 words held in int64) for CPU tensors and one `ctk_link_walk`
launch (csrc/walk_links.cu: a thread a walk with the cuckoo lookup fused,
and the warp on a walk's store only at its needy steps) for CUDA tensors.
The k-mer table is the cuckoo table of ops/cuckoo.py with payload record +
1; W = ceil(k/16) <= 4, so k <= 63.
Both also take the JAX package's arrays as numpy (uint32 [NB, BS*(W+1)]
buckets, the LinkArrays fields, uint32 seeds).

`LinkedWalker` holds the tables on a device.  It is built from a
`CortexGraph`, or from a graph's records as Partition's callers hold them
(`from_records`: the sorted canonical words, the walked colours' edge
bytes, the links files), and walks seed words (`walk_words`, host arrays
out) or seed strings both ways (`walk`, `assemble`).  Its spans
(utils/profiling): `links.table` (`.place`, `.pack`, `.upload`) around the
build, `links.walk` (`.upload`, `.launch`, `.copy`, `.wait`) around a walk.

A reverse walk equals a forward walk from the reverse complement, so one
kernel serves both directions of `assemble`.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import kmer as km
from ..device import resolve
from ..utils.profiling import span
from . import _kernels
from . import cuckoo as ck
from . import kmer as tk

CAP = 32                 # active link elements a walk
MAX_J = 32               # junction choices a link record
JW = (MAX_J + 15) // 16  # uint32 words a choice string
MAX_ADD = 16             # link records appended a k-mer arrival
STORE_FIELDS = 7         # a store element in the kernels: ch0, ch1, len, pos, age, seq, valid

# kernel launches, and walk_words' pinned copies to the host (plain integers;
# chip_smoke.py resets and reads them)
LAUNCHES = {"link_walk": 0, "link_walk_copy": 0}

_CODE = np.full(256, 255, dtype=np.uint8)
_CODE[np.frombuffer(b"ACGT", dtype=np.uint8)] = np.arange(4, dtype=np.uint8)


@dataclass
class LinkArrays:
    """CSR link pool over graph records (host numpy)."""
    offsets: np.ndarray    # int32[N+1]
    choices: np.ndarray    # uint32[P, JW] (choice j in bits 2*(j%16) of word j//16)
    lengths: np.ndarray    # int32[P]
    forward: np.ndarray    # bool[P]
    truncated: int = 0     # records dropped for exceeding MAX_J


def build_link_arrays(graph, links_list) -> LinkArrays:
    """Pack the links files' records into CSR arrays in graph record order:
    the files of the graph's samples, each record's links in file order;
    records of more than MAX_J choices are dropped and counted."""
    return build_link_arrays_records(graph.kmer_size, graph.kmers, links_list,
                                     graph.sample_names)


def build_link_arrays_records(k: int, kmers: np.ndarray, links_list, samples) -> LinkArrays:
    """build_link_arrays on a graph's records: kmers uint32 [N, W], the
    canonical words sorted as a .ctx holds them, and the links files of the
    sample name `samples` (or of any name in a collection of them).  The
    link k-mers of every file are found by one search over the records'
    key bytes (graph.find_records' search); a record's links keep file
    order, and records of more than MAX_J choices at a k-mer of the graph
    are dropped and counted."""
    samples = {samples} if isinstance(samples, str) else set(samples)
    files = []
    for lm in links_list:
        if lm.sample_name not in samples:
            continue
        recs = lm.records       # read once: LinksRandomAccess.records scans the whole file
        if recs:
            files.append(recs)
    keys = [key for recs in files for key in recs]
    n = kmers.shape[0]
    found = np.full(len(keys), -1, dtype=np.int64)
    if keys and n:
        canon, _ = km.canonicalize_codes(km.strings_to_codes([s.upper() for s in keys]))
        wanted = km.words_to_bytes_be(km.pack_codes(canon, k), k)
        table = km.words_to_bytes_be(np.ascontiguousarray(kmers, dtype=np.uint32), k)
        idx = np.minimum(np.searchsorted(table, wanted), n - 1)
        found = np.where(table[idx] == wanted, idx, -1)
    rec_of, choice_strs, forward = [], [], []
    truncated = 0
    keyed = iter(found)
    for recs in files:
        for key in recs:
            rec = next(keyed)
            if rec < 0:
                continue
            for jr in recs[key]:
                if len(jr.choices) > MAX_J:
                    truncated += 1
                    continue
                rec_of.append(int(rec))
                choice_strs.append(jr.choices)
                forward.append(bool(jr.forward))

    rec_of = np.asarray(rec_of, dtype=np.int64)
    order = np.argsort(rec_of, kind="stable")       # file order within a record
    offsets = np.zeros(n + 1, dtype=np.int32)
    offsets[1:] = np.cumsum(np.bincount(rec_of, minlength=n))
    lengths_all = np.asarray([len(c) for c in choice_strs], dtype=np.int32)
    p = max(len(rec_of), 1)
    choices = np.zeros((p, JW), dtype=np.uint32)
    lengths = np.zeros(p, dtype=np.int32)
    fw = np.zeros(p, dtype=bool)
    if len(rec_of):
        codes = _CODE[np.frombuffer("".join(choice_strs).encode(), dtype=np.uint8)]
        if (codes == 255).any():
            raise ValueError("a link choice is not one of ACGT")
        row = np.repeat(np.arange(len(rec_of)), lengths_all)
        j = np.arange(len(codes)) - np.repeat(np.cumsum(lengths_all) - lengths_all, lengths_all)
        words = np.zeros((len(rec_of), JW), dtype=np.uint32)
        np.bitwise_or.at(words, (row, j // 16),
                         codes.astype(np.uint32) << (2 * (j % 16)).astype(np.uint32))
        choices[:len(rec_of)] = words[order]
        lengths[:len(rec_of)] = lengths_all[order]
        fw[:len(rec_of)] = np.asarray(forward, dtype=bool)[order]
    return LinkArrays(offsets, choices, lengths, fw, truncated)


# ---------------------------------------------------------------------------
# plain twins (uint32 words and every counter held in int64)
# ---------------------------------------------------------------------------

def _char_at(choices: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """choices [..., JW], pos [...] -> the 2-bit code at pos."""
    word = torch.gather(choices, -1, (pos // 16)[..., None]).squeeze(-1)
    return (word >> (2 * (pos % 16))) & 3


def _first_max(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Index of the first maximum along dim (jnp.argmax's rule)."""
    return torch.argmax(x.to(torch.int64), dim=dim)


def store_add(el_choices, el_len, el_pos, el_age, el_valid, el_seq,
              seq_counter, overflow, active, flipped,
              rec_choices, rec_len, rec_fw, rec_cnt):
    """Append the current k-mer's link records (pre-gathered [B, MAX_ADD(,
    JW)] blocks) to each walk's elements: record j goes to the free slot of
    equal rank among the gated records.  Returns (el_choices, el_len,
    el_pos, el_age, el_valid, el_seq, seq_counter, overflow)."""
    b, ma = rec_len.shape
    jj = torch.arange(ma, device=rec_len.device).expand(b, ma)
    gate = (jj < rec_cnt.clamp(max=MAX_ADD)[:, None]) & active[:, None] \
        & (rec_fw == ~flipped[:, None])
    rank_add = gate.to(torch.int64).cumsum(1) - 1
    free = ~el_valid
    rank_free = free.to(torch.int64).cumsum(1) - 1
    num_free = free.to(torch.int64).sum(1)
    assign = (free[:, :, None] & gate[:, None, :]
              & (rank_free[:, :, None] == rank_add[:, None, :]))
    filled = assign.any(2)
    j_for_slot = _first_max(assign, 2)
    ch_sel = torch.gather(rec_choices, 1, j_for_slot[:, :, None].expand(-1, -1, JW))
    ln_sel = torch.gather(rec_len, 1, j_for_slot)
    el_choices = torch.where(filled[..., None], ch_sel, el_choices)
    el_len = torch.where(filled, ln_sel, el_len)
    el_pos = torch.where(filled, 0, el_pos)
    el_age = torch.where(filled, 0, el_age)
    el_seq = torch.where(filled, seq_counter[:, None] + j_for_slot, el_seq)
    el_valid = el_valid | filled
    overflow = overflow | (gate & (rank_add >= num_free[:, None])).any(1)
    seq_counter = seq_counter + MAX_ADD
    overflow = overflow | (rec_cnt > MAX_ADD)
    return (el_choices, el_len, el_pos, el_age, el_valid, el_seq,
            seq_counter, overflow)


def store_advance(cur, active, el_choices, el_len, el_pos, el_age, el_valid,
                  el_seq, edge, flipped, is_first: bool, k: int):
    """Successor choice, junction consume and ageing.  Returns (cur,
    active, el_pos, el_valid, el_age, emitted, take_choice); emitted is
    base | store_active << 3 where the walk advanced, else -1."""
    next_mask = torch.where(flipped, edge >> 4, edge & 0xF)
    n = tk.popcount4(next_mask)
    single_base = tk.lowest_set_base(next_mask)

    exhausted = el_pos >= el_len
    live = el_valid & ~exhausted
    oldest_age = torch.where(live, el_age, -1).amax(1)
    is_oldest = live & (el_age == oldest_age[:, None]) & (oldest_age[:, None] >= 0)
    chars = _char_at(el_choices, el_pos)
    any_oldest = is_oldest.any(1)
    first_oldest = _first_max(is_oldest, 1)
    rep_char = torch.gather(chars, 1, first_oldest[:, None])[:, 0]
    agree = (~is_oldest | (chars == rep_char[:, None])).all(1)

    rep_words = torch.gather(el_choices, 1,
                             first_oldest[:, None, None].expand(-1, 1, JW))[:, 0, :]
    same_list = el_valid & (el_choices == rep_words[:, None, :]).all(-1)
    latest = _first_max(torch.where(same_list, el_seq, -1), 1)
    choice = torch.gather(chars, 1, latest[:, None])[:, 0]

    have_choice = any_oldest & agree
    choice_ok = have_choice & (((next_mask >> choice) & 1) != 0)

    junction = n > 1
    take_single = active & (n == 1)
    take_choice = active & junction & choice_ok & (not is_first)
    base = torch.where(junction, choice, single_base)
    advance = take_single | take_choice

    consumed = take_choice
    keep = el_valid & (chars == choice[:, None]) & (el_pos + 1 < el_len)
    el_pos = torch.where(consumed[:, None] & keep, el_pos + 1, el_pos)
    el_valid = torch.where(consumed[:, None], keep, el_valid)

    bump = (consumed | (active & junction & (not is_first))).to(torch.int64)
    new_paths = (el_valid & (el_age == 0)).any(1)
    bump = bump + (active & new_paths & (not is_first)).to(torch.int64)
    el_age = torch.where(el_valid, el_age + bump[:, None], el_age)

    store_active = el_valid.any(1)
    cur = torch.where(advance[:, None], tk.shift_append(cur, base, k), cur)
    emitted = torch.where(advance, base | torch.where(store_active, 8, 0), -1)
    return cur, advance, el_pos, el_valid, el_age, emitted, take_choice


def needy_steps(active, cnt, edge, flipped, el_valid, el_age):
    """The walks whose step must run the LinkStore (bool [B]): active, and
    their k-mer has link records (`cnt` > 0), or it is a junction (more than
    one successor of the combined `edge` byte in the walk's orientation,
    `flipped`) and the store holds a valid element, or a valid element has
    age 0.  `el_valid` / `el_age` [B, CAP] are the store before the step.
    Every other step leaves the store and the overflow as they are
    (tests/test_torch_link_needy.py)."""
    nonempty, pending = store_flags(el_valid, el_age)
    next_mask = torch.where(flipped, edge >> 4, edge & 0xF)
    junction = tk.popcount4(next_mask) > 1
    return active & ((cnt > 0) | (junction & nonempty) | pending)


def store_flags(el_valid, el_age):
    """(non-empty, pending) of each walk's store [B, CAP]: a valid element,
    and a valid element of age 0 (the kernels' kNonEmpty and kPending)."""
    return el_valid.any(1), (el_valid & (el_age == 0)).any(1)


def walk_links_forward_plain(buckets, edges, link_off, link_choices, link_len, link_fw,
                             seeds, k: int, num_steps: int, store_sizes=None, trace=None):
    """Plain twin of walk_links.walk_links_forward on the kernel's tensors
    (see `walk_links_forward`): (emitted int8 [T, B], overflow bool [B],
    steps int32 [B], junctions int32 [B]).  `store_sizes`, an int8 [T, B]
    tensor if given, receives each walk's valid elements after each step it
    ran (rows after the last step are left as they were).  `trace`, if
    given, is called after each step t as trace(t, rec) with a dict of that
    step's tensors: active (before the step), needy (`needy_steps`), cnt,
    edge, flipped, the store before and after (tuples of el_choices, el_len,
    el_pos, el_age, el_valid, el_seq), overflow before and after, emitted
    and take_choice."""
    dev = seeds.device
    cur = tk.from_bits32(seeds)
    b = cur.shape[0]
    edges64 = edges.to(torch.int64)
    off_all = link_off.to(torch.int64)
    pool_ch = tk.from_bits32(link_choices)
    pool_len = link_len.to(torch.int64)
    pool_fw = link_fw.to(torch.bool)
    jj = torch.arange(MAX_ADD, device=dev)

    z = torch.zeros((b, CAP), dtype=torch.int64, device=dev)
    el_choices = torch.zeros((b, CAP, JW), dtype=torch.int64, device=dev)
    el_len, el_pos, el_age, el_seq = z, z, z, z
    el_valid = torch.zeros((b, CAP), dtype=torch.bool, device=dev)
    active = torch.ones(b, dtype=torch.bool, device=dev)
    overflow = torch.zeros(b, dtype=torch.bool, device=dev)
    seq_counter = torch.zeros(b, dtype=torch.int64, device=dev)
    junctions = torch.zeros(b, dtype=torch.int64, device=dev)
    emitted = torch.full((num_steps, b), -1, dtype=torch.int8, device=dev)
    for t in range(num_steps):
        canon, flipped = tk.canonicalize_words(cur, k)
        rec = tk.from_bits32(ck.lookup_payload(buckets, tk.to_bits32(canon))) - 1
        found = rec >= 0
        r = rec.clamp(min=0)
        edge = torch.where(found, edges64[r], 0)
        off = torch.where(found, off_all[r], 0)
        cnt = torch.where(found, off_all[r + 1] - off, 0)
        idx = (off[:, None] + jj).clamp(max=pool_len.shape[0] - 1)
        before = (el_choices, el_len, el_pos, el_age, el_valid, el_seq, overflow, active)
        (el_choices, el_len, el_pos, el_age, el_valid, el_seq, seq_counter,
         overflow) = store_add(el_choices, el_len, el_pos, el_age, el_valid, el_seq,
                               seq_counter, overflow, active, flipped,
                               pool_ch[idx], pool_len[idx], pool_fw[idx], cnt)
        cur, active, el_pos, el_valid, el_age, emit, take_choice = store_advance(
            cur, active, el_choices, el_len, el_pos, el_age, el_valid, el_seq,
            edge, flipped, t == 0, k)
        emitted[t] = emit.to(torch.int8)
        junctions += take_choice.to(torch.int64)
        if trace is not None:
            trace(t, {"active": before[7],
                      "needy": needy_steps(before[7], cnt, edge, flipped, before[4], before[3]),
                      "cnt": cnt, "edge": edge, "flipped": flipped, "store_before": before[:6],
                      "store_after": (el_choices, el_len, el_pos, el_age, el_valid, el_seq),
                      "overflow_before": before[6], "overflow_after": overflow,
                      "emitted": emit, "take_choice": take_choice})
        if store_sizes is not None:
            store_sizes[t] = el_valid.sum(1).to(torch.int8)
        if not bool(active.any()):
            break        # a stopped walk stays on its k-mer and adds nothing more
    steps = (emitted >= 0).sum(0).to(torch.int32)
    return emitted, overflow, steps, junctions.to(torch.int32)


# ---------------------------------------------------------------------------
# the entry point and the kernel's launch
# ---------------------------------------------------------------------------

def _tensor(x, dev: torch.device) -> torch.Tensor:
    """A tensor as it is; a numpy array as the kernel's type on `dev`:
    uint32 as int32 bits, bool as uint8."""
    if isinstance(x, torch.Tensor):
        return x
    a = np.ascontiguousarray(x)
    if not a.flags.writeable:
        a = a.copy()
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    elif a.dtype == np.bool_:
        a = a.view(np.uint8)
    return torch.from_numpy(a).to(dev)


def _device(arrays, device) -> torch.device:
    """`device` if given, else the first tensor's device, else the CUDA card
    (RuntimeError without one)."""
    if device is not None:
        return torch.device(device)
    for x in arrays:
        if isinstance(x, torch.Tensor):
            return x.device
    return resolve()


def link_tables(buckets, edges, link_off, link_choices, link_len, link_fw, k: int,
                dev: torch.device) -> tuple:
    """The walk's tables as the kernel's tensors: buckets int32 [NB, BS, W+1]
    (the JAX package's uint32 [NB, BS*(W+1)] rows are reshaped), edges uint8
    [N], link_off int32 [N+1], link_choices int32 [P, JW], link_len int32
    [P], link_fw uint8 [P].  Tensors keep their device; numpy arrays go to
    `dev`."""
    out = [_tensor(x, dev) for x in (buckets, edges, link_off, link_choices, link_len, link_fw)]
    if out[0].dim() == 2:
        out[0] = out[0].view(out[0].shape[0], -1, tk.words(k) + 1)
    if out[5].dtype == torch.bool:
        out[5] = out[5].view(torch.uint8)
    return tuple(out)


def _check_walk(buckets, edges, link_off, link_choices, link_len, link_fw, seeds, k: int,
                num_steps: int) -> None:
    w = tk.words(k)
    if not 1 <= k <= 63 or seeds.dtype != torch.int32 or seeds.dim() != 2 or seeds.shape[1] != w:
        raise ValueError(f"seeds must be int32 [B, {w}] words, 1 <= k <= 63")
    nb = buckets.shape[0] if buckets.dim() == 3 else 0
    if buckets.dtype != torch.int32 or buckets.dim() != 3 or buckets.shape[2] != w + 1 or \
            nb == 0 or nb & (nb - 1):
        raise ValueError(f"buckets must be int32 [NB, BS, {w + 1}], NB a power of two")
    n, p = edges.shape[0], link_len.shape[0]
    if edges.dtype != torch.uint8 or edges.dim() != 1 or link_off.dtype != torch.int32 or \
            tuple(link_off.shape) != (n + 1,):
        raise ValueError("edges must be uint8 [N] and link_off int32 [N+1]")
    if p < 1 or link_choices.dtype != torch.int32 or tuple(link_choices.shape) != (p, JW) or \
            link_len.dtype != torch.int32 or link_fw.dtype != torch.uint8 or \
            tuple(link_fw.shape) != (p,):
        raise ValueError(f"the link pool must be int32 [P, {JW}], int32 [P], uint8 [P], P >= 1")
    devices = {x.device for x in (buckets, edges, link_off, link_choices, link_len, link_fw,
                                  seeds)}
    if num_steps < 0 or len(devices) != 1:
        raise ValueError("num_steps must be >= 0 and the tensors on one device")


def emit_pitch(num_steps: int) -> int:
    """Bytes a walk's row of the kernel's [B, pitch] stream: num_steps
    rounded up to whole 32-byte sectors."""
    return (num_steps + 31) // 32 * 32


def walk_links_forward(buckets, edges, link_off, link_choices, link_len, link_fw, seeds,
                       k: int, num_steps: int, device=None):
    """Forward walks with link following from walk-oriented seeds.

    buckets: the cuckoo table (payload = record index + 1); edges: the
    combined edge byte a record; link_*: the LinkArrays fields; seeds: [B, W]
    words (types as `link_tables` gives them, or the JAX package's numpy
    arrays).  Numpy arrays go to `device`, else to the tensors' device, else
    to the CUDA card (RuntimeError without one).  Returns (emitted
    int8 [T, B]: base | store_active << 3, or -1 once the walk ended;
    overflow bool [B]; steps int32 [B]; junctions int32 [B], the junction
    advances a link choice resolved).  The plain twin for CPU tensors; one
    `ctk_link_walk` launch for CUDA tensors, whose emitted is the [T, B]
    view of a walk-major [B, pitch] stream."""
    dev = _device((buckets, edges, link_off, link_choices, link_len, link_fw, seeds), device)
    args = (*link_tables(buckets, edges, link_off, link_choices, link_len, link_fw, k, dev),
            _tensor(seeds, dev))
    _check_walk(*args, k, num_steps)
    dev = args[-1].device
    if dev.type == "cpu":
        return walk_links_forward_plain(*args, k, num_steps)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    b = args[-1].shape[0]
    stream = torch.empty((b, emit_pitch(num_steps)), dtype=torch.int8, device=dev)
    overflow = torch.empty(b, dtype=torch.uint8, device=dev)
    steps = torch.empty(b, dtype=torch.int32, device=dev)
    junctions = torch.empty(b, dtype=torch.int32, device=dev)
    if b:
        link_walk_kernel(*(x.contiguous() for x in args), k, num_steps, stream, overflow, steps,
                         junctions)
    return stream[:, :num_steps].t(), overflow.view(torch.bool), steps, junctions


def link_walk_kernel(buckets, edges, link_off, link_choices, link_len, link_fw, seeds, k: int,
                     num_steps: int, stream, overflow, steps, junctions) -> None:
    """One `ctk_link_walk` launch on checked, contiguous card tensors:
    stream int8 [B, pitch] (every byte written), overflow uint8 [B], steps
    and junctions int32 [B].  The walks' stores are scratch, int32 [B,
    STORE_FIELDS, CAP] (896 bytes a walk), allocated here and not zeroed:
    the kernel reads a store only after writing it."""
    nb, bs, _ = buckets.shape
    stores = torch.empty((seeds.shape[0], STORE_FIELDS, CAP), dtype=torch.int32,
                         device=seeds.device)
    err = _kernels.library().ctk_link_walk(
        buckets.data_ptr(), nb, bs, seeds.shape[1], k, edges.data_ptr(), link_off.data_ptr(),
        link_choices.data_ptr(), link_len.data_ptr(), link_fw.data_ptr(), link_len.shape[0],
        seeds.data_ptr(), seeds.shape[0], num_steps, stream.shape[1], stores.data_ptr(),
        stream.data_ptr(), overflow.data_ptr(), steps.data_ptr(), junctions.data_ptr(),
        _kernels.stream(seeds.device))
    _kernels.check(err, "link_walk")
    LAUNCHES["link_walk"] += 1


def _to_pinned(rows: torch.Tensor, lane: list) -> tuple:
    """Enqueue the copies of a card walk's outputs into fresh pinned host
    tensors on the current stream, and return those tensors (valid once the
    stream is synchronized): rows, the [B, T] view of the kernel's [B,
    pitch] stream, by one `ctk_copy_rows_to_host` (a pitched 2-D copy that
    drops the rows' padding), each lane array by a non-blocking copy."""
    b, t = rows.shape
    host = torch.empty((b, t), dtype=rows.dtype, pin_memory=True)
    if host.numel():
        if rows.stride(1) != 1 or rows.stride(0) < t:
            raise ValueError("rows must be a view of whole rows of a row-major stream")
        _kernels.check(_kernels.library().ctk_copy_rows_to_host(
            host.data_ptr(), t, rows.data_ptr(), rows.stride(0), t, b,
            _kernels.stream(rows.device)), "copy_rows_to_host")
    LAUNCHES["link_walk_copy"] += 1
    return (host, *(torch.empty(x.shape, dtype=x.dtype, pin_memory=True).copy_(
        x, non_blocking=True) for x in lane))


def kernel_info(which: str, w: int, batch: int, buckets=None) -> dict:
    """How a launch of `batch` walks at W = w runs on the current card:
    ctk_link_walk ("link_walk", on the card table `buckets`, whose bucket
    size and alignment choose its lookup) or ctk_link_step ("link_step"):
    {"threads" a block, "registers" a thread, "blocks_per_sm" resident,
    "warps_per_sm", "local_bytes" a thread}."""
    import ctypes

    out = (ctypes.c_int * 4)()
    bs = buckets.shape[1] if buckets is not None else 0
    ptr = buckets.data_ptr() if buckets is not None else None
    err = _kernels.library().ctk_link_kernel_info(("link_walk", "link_step").index(which), w, bs,
                                                  ptr, batch, out)
    _kernels.check(err, "link_kernel_info")
    threads, regs, blocks, local = out
    return {"threads": threads, "registers": regs, "blocks_per_sm": blocks,
            "warps_per_sm": blocks * threads // 32, "local_bytes": local}


# ---------------------------------------------------------------------------
# decoding and the walker
# ---------------------------------------------------------------------------

def decode_linked_walk(seed: str, emitted, max_branch_length: int = 75000) -> str:
    """Emitted stream -> extension string with the reference's seen-set rule.

    Each emitted value is -1 (walk ended) or base | (store_active << 3).
    The reference permits revisits while the store is active
    (TraversalEngine.java:262); the device records every advance, and we stop
    where Java would: at the first revisited k-mer reached while inactive.
    """
    out = []
    seen: set = set()
    cur = seed
    for v in emitted:
        v = int(v)
        if v < 0:
            break
        base = "ACGT"[v & 3]
        store_active = bool(v & 8)
        nxt = cur[1:] + base
        if nxt in seen and not store_active:
            break
        seen.add(nxt)
        out.append(base)
        cur = nxt
        if len(out) >= max_branch_length:
            break
    return "".join(out)


def decode_host_walk(seed: str, emitted, successors, max_branch_length: int = 75000) -> str:
    """Emitted stream -> extension string with the host engine's seen rule
    (TraversalEngine.next), for holding the device walk against the host
    walkers: a revisit stops an inactive walk only when it is reached from a
    k-mer of one successor, only such k-mers join the seen set, and the seed
    step's successor (seek's) joins it neither.  successors[t] is the
    successor count of the k-mer step t left.  decode_linked_walk, the JAX
    package's rule, checks and records every advance."""
    out = []
    seen: set = set()
    cur = seed
    for t, v in enumerate(emitted):
        v = int(v)
        if v < 0:
            break
        nxt = cur[1:] + "ACGT"[v & 3]
        if t > 0 and successors[t] == 1:
            if nxt in seen and not v & 8:
                break
            seen.add(nxt)
        out.append(nxt[-1])
        cur = nxt
        if len(out) >= max_branch_length:
            break
    return "".join(out)


class LinkedWalker:
    """The cuckoo table and the link CSR on a device, built once, then any
    number of walks.  `device` is the CUDA card by default (RuntimeError
    without one); "cpu" runs the plain twin.

    `stats` counts, from the arrays the walks return: `walks`, `steps`,
    `junctions_resolved` (junction advances a link choice took) and
    `overflow_lanes`; and, from the pack, `link_records` (pool rows) and
    `truncated` (records dropped past MAX_J)."""

    def __init__(self, graph, colors, links_list, device=None):
        edges = np.bitwise_or.reduce(graph.edges[:, list(colors)], axis=1)
        self._build(graph.kmer_size, graph.kmers, edges, links_list, graph.sample_names,
                    device)

    @classmethod
    def from_records(cls, k: int, kmers, edges, links_list, sample_name,
                     device=None) -> "LinkedWalker":
        """A walker over a graph's records, as Partition's callers hold them:
        kmers uint32 [N, W] (the canonical words, sorted as a .ctx holds
        them), edges uint8 [N] (the walked colours' edge bytes), the links
        files (io/links.LinksData or LinksRandomAccess) of the sample name
        `sample_name` (or of any name in a collection of them)."""
        walker = cls.__new__(cls)
        walker._build(k, kmers, edges, links_list, sample_name, device)
        return walker

    @classmethod
    def from_arrays(cls, k: int, buckets, edges, offsets, choices, lengths, forward,
                    truncated: int = 0, device=None) -> "LinkedWalker":
        """A walker over given arrays: the JAX package's (np.asarray of its
        LinkedWalker.args) or the port's own."""
        walker = cls.__new__(cls)
        walker._bind(k, (buckets, edges, offsets, choices, lengths, forward), truncated,
                     resolve(device))
        return walker

    def _build(self, k: int, kmers, edges, links_list, samples, device) -> None:
        """The cuckoo table (payload record + 1) placed on the host, the link
        CSR packed, both uploaded."""
        dev = resolve(device)
        kmers = np.ascontiguousarray(kmers, dtype=np.uint32)
        with span("links.table"):
            with span("links.table.place"):
                placement = ck.place_cuckoo(kmers, 0.5, None, ck.BUCKET_SIZE, False)
            with span("links.table.pack") as sp:
                la = build_link_arrays_records(k, kmers, links_list, samples)
                if sp:
                    sp.set(records=int(la.offsets[-1]), truncated=la.truncated)
            with span("links.table.upload") as sp:
                table = ck.cuckoo_table(kmers, np.arange(kmers.shape[0], dtype=np.uint32) + 1,
                                        placement, ck.BUCKET_SIZE, dev)
                self._bind(k, (table.buckets, edges, la.offsets, la.choices, la.lengths,
                               la.forward), la.truncated, dev)
                if sp:
                    sp.set(bytes=sum(x.nbytes for x in self.args))

    def _bind(self, k: int, arrays: tuple, truncated: int, dev: torch.device) -> None:
        self.k = k
        self.device = dev
        self.truncated = truncated
        self.args = link_tables(*arrays, k, dev)
        self.stats = {"walks": 0, "steps": 0, "junctions_resolved": 0, "overflow_lanes": 0,
                      "link_records": int(self.args[2][-1]), "truncated": truncated}

    def walk_words(self, words, num_steps: int):
        """Forward walks from walk-oriented seed words (uint32 [B, W]
        numpy, or the kernels' int32 tensor), walked as given: (emitted
        int8 [B, T] as numpy, base | store_active << 3 or -1 once the walk
        ended; overflow bool [B]; steps int32 [B]; junctions int32 [B]).  On
        the card the outputs are copied into fresh pinned host memory,
        asynchronously on the current stream (the stream's rows by one
        pitched 2-D copy that drops their padding), with one synchronize;
        the arrays are views that keep their host tensors alive, so a later
        call does not overwrite them."""
        with span("links.walk", walks=len(words)):
            with span("links.walk.upload", bytes=words.nbytes):
                seeds = _tensor(words, self.device)
            with span("links.walk.launch"):
                emitted, *lane = walk_links_forward(*self.args, seeds, self.k, num_steps,
                                                    device=self.device)
            rows = emitted.t()
            card = rows.device.type == "cuda"
            with span("links.walk.copy") as sp:
                host = _to_pinned(rows, lane) if card else (rows, *lane)
                if sp:
                    sp.set(bytes=sum(x.nbytes for x in host))
            if card:
                with span("links.walk.wait"):
                    torch.cuda.current_stream(rows.device).synchronize()
            out = tuple(x.numpy() for x in host)
        st = self.stats
        st["walks"] += out[2].shape[0]
        st["steps"] += int(out[2].sum(dtype=np.int64))
        st["junctions_resolved"] += int(out[3].sum(dtype=np.int64))
        st["overflow_lanes"] += int(out[1].sum())
        return out

    def walk(self, seeds: list, num_steps: int):
        """Forward walks then reverse walks of the seed strings, in one call:
        (emitted rows int8 [2B, T] as numpy, overflow bool [2B], steps int32
        [2B], junctions int32 [2B], the reverse complements)."""
        k = self.k
        rc_strs = [km.revcomp(s) for s in seeds]
        words = km.pack_codes(km.strings_to_codes(list(seeds) + rc_strs, k), k)
        return (*self.walk_words(words, num_steps), rc_strs)

    def walk_split(self, seeds: list, num_steps: int = 1024, max_branch: int | None = None):
        """Per-direction link-assisted extensions: (fwd_exts, back_exts,
        overflow bool [B], junctions int32 [B]).  num_steps sets the device
        walk length; max_branch bounds the decoded extension
        (TraversalEngineConfiguration.maxBranchLength semantics)."""
        b = len(seeds)
        mb = max_branch if max_branch is not None else num_steps
        rows, ov, steps, jn, rc_strs = self.walk(seeds, num_steps)
        fwd = [decode_linked_walk(s, rows[i, :steps[i]].tolist(), mb)
               for i, s in enumerate(seeds)]
        back = [decode_linked_walk(s, rows[b + i, :steps[b + i]].tolist(), mb)
                for i, s in enumerate(rc_strs)]
        return fwd, back, ov[:b] | ov[b:], (jn[:b] + jn[b:]).astype(np.int32)

    def assemble(self, seeds: list, num_steps: int = 1024):
        """Bidirectional link-assisted contigs (TraversalEngine.assemble with
        links): (contigs, overflow bool [B], junctions int32 [B])."""
        fwd, back, overflow, junctions = self.walk_split(seeds, num_steps)
        contigs = [(km.revcomp(bk) if bk else "") + s + f for s, f, bk in zip(seeds, fwd, back)]
        return contigs, overflow, junctions


def assemble_batch_links(graph, colors, links_list, seeds: list, num_steps: int = 1024,
                         device=None):
    """One-shot convenience wrapper over LinkedWalker: (contigs, overflow)."""
    walker = LinkedWalker(graph, colors, links_list, device=device)
    contigs, overflow, _ = walker.assemble(seeds, num_steps)
    return contigs, overflow
