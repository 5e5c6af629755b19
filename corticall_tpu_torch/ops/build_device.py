"""The device graph build: read bytes -> the sorted unique canonical k-mer
table with coverage and edge masks.

Counterpart of corticall_tpu/ops/build_device.py, the device route of
`build.build_graph_from_reads` (use_device=True, or CORTICALL_DEVICE_BUILD=1).
The host joins reads with k-long 'N' separators into chunks of at most
`chunk_bases` bases (a sequence longer than a chunk is cut into overlapping
pieces, each owning one interval of windows, so each window is counted by
exactly one piece and edge masks see the true neighbours through the
overlap), and uploads each piece's bytes as they are.  On the device:

- `count_windows`: the piece's valid windows, in stream order, as their
  canonical k-mers and in/out edge masks (`ctk_count_windows` on the card:
  the bytes packed in shared memory, the windows compacted by decoupled
  look-back, one launch and one read of its count; `count_windows_plain` on
  the CPU);
- the rows sorted by `torch.sort` in the unsigned order of their words
  (`sort_order`, the order of the host's `words_to_bytes_be` keys);
- `segment_reduce`: each run of equal keys becomes one row, coverage summed
  as uint32 (wrapping, as XLA's segment_sum does) and masks ORed
  (`ctk_segment_reduce` on the card: one pass over tiles of 2,048 rows with
  decoupled look-back, its scratch kept on the card between launches,
  `reduce_scratch`; `reduce_plain` on the CPU; `reduce_tiles_plain` is the
  kernel's tile decomposition and look-back step for step);
- chunks merge into an on-device accumulator by concatenate, sort, reduce.

Only the final table crosses back to the host; it equals build.count_kmers
and the native core's bit for bit.  Words are uint32 bit patterns in int32
tensors; masks a byte a row, in << 4 | out.  Not carried over from the JAX
package: packing a piece on the host (2 bits a base and two bitmaps,
`_count_piece`, corticall_tpu/ops/build_device.py:216-232), which spared its
rig's slow host-to-device link and cost the port over half of a sample's
device seconds (PERF.md); padding a chunk's stream to `chunk_bases` and the
accumulator to a power of two (shapes fixed for its compiler): a chunk
processes exactly its bases and a merge exactly its rows.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kmer as km
from ..device import resolve
from . import _kernels
from . import kmer as tk
from .kmer import words_tensor

SENT = -1                    # an invalid window's key words (all ones as int32)
CHUNK_BASES = 1 << 25        # stream bases a chunk holds, separators included

# kernel launches (plain integers; chip_smoke.py resets and reads them)
LAUNCHES = {"count_windows": 0, "segment_reduce": 0}

COUNT_TILE = 4096            # ctk_count_windows' windows a tile (csrc/count.cu kCountTile)
REDUCE_TILE_ROWS = 2048      # ctk_segment_reduce's rows a tile (csrc/count.cu kTileRows)
EPOCH_LIMIT = 1 << 22        # their status words' epoch field holds 1 .. EPOCH_LIMIT - 1

# per device: [int64 scratch, the last launch's epoch] (count_scratch, reduce_scratch)
_COUNT_SCRATCH: dict = {}
_REDUCE_SCRATCH: dict = {}
# per device: [a pinned uint8 buffer, the event of the last copy out of it] (upload)
_STAGING: dict = {}

# a byte's base code: ACGT and acgt 0..3, any other byte 255 (kmer._CODE_OF)
_CODES = torch.from_numpy(km._CODE_OF.copy())


def pack_stream(codes: np.ndarray) -> np.ndarray:
    """uint8 base codes (values 0..3) -> uint32 words, base p at bits
    (30 - 2*(p % 16)) of word p//16."""
    n = len(codes)
    npad = -(-n // 16) * 16
    c = np.zeros(npad, dtype=np.uint32)
    c[:n] = codes
    c = c.reshape(-1, 16)
    shifts = (30 - 2 * np.arange(16, dtype=np.uint32)).astype(np.uint32)
    return (c << shifts[None, :]).astype(np.uint32).sum(axis=1, dtype=np.uint32)


def pack_bits(bits: np.ndarray) -> np.ndarray:
    """bool[n] -> uint32 words, bit i at bit (i % 32) of word i//32."""
    b = np.packbits(bits, bitorder="little")
    pad = -(-len(bits) // 32) * 4
    return np.pad(b, (0, pad - len(b))).view(np.uint32)


# ---------------------------------------------------------------------------
# windows
# ---------------------------------------------------------------------------

def _bit(words: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return ((words[idx >> 5] >> (idx & 31)) & 1) != 0


def windows_plain(stream, valid, own, k: int, n: int):
    """Plain twin of `_extract_windows` (corticall_tpu/ops/build_device.py:73)
    on the first n stream bases: (keys int32 [n, W], masks uint8 [n]).
    Validity by a cumsum of the invalid bases, as there."""
    w = tk.words(k)
    dev = stream.device
    s, vw, ow = (tk.from_bits32(x) for x in (stream, valid, own))
    i = torch.arange(n, dtype=torch.int64, device=dev)
    bad = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                     torch.cumsum((~_bit(vw, i)).to(torch.int64), 0)])
    ik = torch.clamp(i + k, max=n)
    ok = ((bad[ik] - bad[i]) == 0) & (i + k <= n) & _bit(ow, i)

    r = (2 * i) & 31
    last = s.shape[0] - 1
    regs = []
    for j in range(w):
        q = (2 * i + 32 * j) >> 5
        hi, lo = s[q.clamp(max=last)], s[(q + 1).clamp(max=last)]
        regs.append(torch.where(r > 0, ((hi << r) & tk.M32) | (lo >> ((32 - r) & 31)), hi))
    sh = 32 * w - 2 * k
    if sh:
        regs = [(regs[j] >> sh) | (((regs[j - 1] << (32 - sh)) & tk.M32) if j else 0)
                for j in range(w)]
    regs[0] = regs[0] & tk.top_word_mask(k)
    canon, flipped = tk.canonicalize_words(torch.stack(regs, dim=1), k)

    prev_i, next_i = (i - 1).clamp(min=0), (i + k).clamp(max=max(n - 1, 0))
    has_prev = ok & _bit(vw, prev_i) & (i > 0)
    has_next = ok & _bit(vw, next_i) & (i + k < n)
    prev_b = (s[prev_i >> 4] >> (30 - 2 * (prev_i & 15))) & 3
    next_b = (s[next_i >> 4] >> (30 - 2 * (next_i & 15))) & 3
    fwd = ~flipped
    one = torch.ones_like(prev_b)
    in_m = (torch.where(fwd & has_prev, one << prev_b, 0)
            | torch.where(flipped & has_next, one << (3 - next_b), 0))
    out_m = (torch.where(fwd & has_next, one << next_b, 0)
             | torch.where(flipped & has_prev, one << (3 - prev_b), 0))
    keys = torch.where(ok[:, None], tk.to_bits32(canon), SENT)
    return keys, torch.where(ok, (in_m << 4) | out_m, 0).to(torch.uint8)


def count_windows_plain(bases: torch.Tensor, own_lo: int, own_hi: int, k: int):
    """Plain twin of `ctk_count_windows`: the JAX package's host packing
    (codes by `kmer._CODE_OF`, an invalid base as 3 in the stream;
    `pack_stream`, `pack_bits`) and `windows_plain` over the piece's bytes
    with the owned windows [own_lo, own_hi), the invalid windows' rows
    dropped: (keys int32 [m, W], masks uint8 [m]) in stream order."""
    dev = bases.device
    codes = _CODES.to(dev)[bases.long()].cpu().numpy()
    n = len(codes)
    own = np.zeros(n, dtype=bool)
    own[own_lo:own_hi] = True
    stream, valid, own_w = (words_tensor(x, dev) for x in (
        pack_stream(np.minimum(codes, 3)), pack_bits(codes <= 3), pack_bits(own)))
    keys, masks = windows_plain(stream, valid, own_w, k, n)
    live = (keys != SENT).any(dim=1)
    return keys[live], masks[live]


def count_windows(bases: torch.Tensor, own_lo: int, own_hi: int, k: int):
    """A piece's valid windows (owned: own_lo <= i < own_hi; i + k <= n; k
    valid bases) in stream order, from its bytes (uint8 [n]): (keys int32
    [m, W], masks uint8 [m]).  The plain twin for a CPU tensor; for a CUDA
    tensor one `ctk_count_windows` launch and one read of its count."""
    if bases.dtype != torch.uint8 or bases.dim() != 1:
        raise TypeError("bases must be a uint8 tensor [n]")
    if not bases.is_contiguous():
        raise ValueError("bases must be contiguous")
    n = bases.shape[0]
    if not 0 <= own_lo <= own_hi <= n:
        raise ValueError(f"owned windows [{own_lo}, {own_hi}) outside the piece's {n}")
    if not 1 <= k <= 63:
        raise ValueError(f"k={k} outside 1..63")
    if bases.device.type == "cpu":
        return count_windows_plain(bases, own_lo, own_hi, k)
    if bases.device.type != "cuda":
        raise ValueError(f"unsupported device {bases.device}")
    rows = max(0, min(own_hi, n - k + 1) - own_lo)        # room for every owned window
    keys = torch.empty((rows, tk.words(k)), dtype=torch.int32, device=bases.device)
    masks = torch.empty(rows, dtype=torch.uint8, device=bases.device)
    if n == 0:
        return keys, masks
    count = torch.empty(1, dtype=torch.int32, device=bases.device)
    count_kernel(aligned(bases), own_lo, own_hi, k, keys, masks, count)
    m = int(count.item())
    return keys[:m], masks[:m]


def count_kernel(bases, own_lo: int, own_hi: int, k: int, keys, masks, count) -> None:
    """One `ctk_count_windows` launch on a checked, contiguous, 16-byte
    aligned card tensor of n >= 1 bytes: its valid windows into the first
    `count` rows of keys int32 [rows, W] and masks uint8 [rows] (16-byte
    aligned, room for every owned window), its scratch the device's
    (`count_scratch`)."""
    n = bases.shape[0]
    scratch, tiles, epoch = count_scratch(bases.device, n)
    err = _kernels.library().ctk_count_windows(
        bases.data_ptr(), n, own_lo, own_hi, keys.shape[1], k, keys.data_ptr(),
        masks.data_ptr(), count.data_ptr(), scratch.data_ptr(), tiles, epoch,
        _kernels.stream(bases.device))
    _kernels.check(err, "count_windows")
    LAUNCHES["count_windows"] += 1


def count_kernel_info(k: int, lib=None) -> dict:
    """How a `ctk_count_windows` launch at k runs on the current card (of
    `lib`, default this package's kernels): threads a block, registers and
    local (spilled) bytes a thread, blocks resident an SM, dynamic shared
    bytes a block, windows a tile, the card's SMs."""
    import ctypes

    out = (ctypes.c_int * 7)()
    err = (lib or _kernels.library()).ctk_count_windows_info(tk.words(k), out)
    _kernels.check(err, "count_windows_info")
    return dict(zip(("threads", "registers", "blocks_per_sm", "local_bytes", "shared_bytes",
                     "tile_windows", "sms"), out))


def encode(reads, k: int) -> bytes:
    """A piece's bytes: its reads joined by k-long 'N' separators (every
    window across a join is invalid; one read is its own bytes), as the JAX
    package's packing reads them."""
    return ("N" * k).join(reads).encode()


def upload(data: bytes, device: torch.device) -> torch.Tensor:
    """A piece's bytes as a uint8 tensor on `device`: to a card through a
    pinned buffer reused piece after piece (grown when a piece outgrows it),
    copied without blocking the host; on the CPU a copy."""
    src = np.frombuffer(data, dtype=np.uint8)
    if device.type != "cuda":
        return torch.from_numpy(src.copy()).to(device)
    n = len(src)
    entry = _STAGING.get(device)
    if entry is None or entry[0].numel() < n:
        entry = [torch.empty(max(n, 1), dtype=torch.uint8, pin_memory=True), None]
        _STAGING[device] = entry
    elif entry[1] is not None:
        entry[1].synchronize()                         # its last copy has left it
    entry[0][:n].numpy()[:] = src
    out = torch.empty(n, dtype=torch.uint8, device=device)
    out.copy_(entry[0][:n], non_blocking=True)
    entry[1] = torch.cuda.Event()
    entry[1].record(torch.cuda.current_stream(device))
    return out


# ---------------------------------------------------------------------------
# sort + segment reduction
# ---------------------------------------------------------------------------

def sort_order(keys: torch.Tensor) -> torch.Tensor:
    """The permutation that sorts int32 [m, W] rows in the unsigned order of
    their words: stable torch.sort passes over int64 keys of two words each,
    least significant first; (a, b) -> (a - 2^31) * 2^32 + b keeps the
    unsigned order of a and b in signed int64."""
    u = tk.from_bits32(keys)
    w = u.shape[1]
    parts = [(u[:, j] - (1 << 31)) * (1 << 32) + u[:, j + 1] if j + 1 < w else u[:, j]
             for j in range(0, w, 2)]
    order = None
    for part in reversed(parts):
        idx = torch.sort(part if order is None else part[order], stable=True).indices
        order = idx if order is None else order[idx]
    if order is None:
        order = torch.arange(keys.shape[0], device=keys.device)
    return order


def reduce_plain(keys: torch.Tensor, cov: torch.Tensor, masks: torch.Tensor):
    """Plain twin of `_sort_reduce`'s segment sums and per-bit maxima
    (corticall_tpu/ops/build_device.py:149-163) over sorted rows: (unique
    keys int32 [n, W], coverage int32 [n] as uint32 sums, masks uint8 [n])."""
    m = keys.shape[0]
    if m == 0:
        return keys, cov, masks
    u = tk.from_bits32(keys)
    head = torch.ones(m, dtype=torch.bool, device=keys.device)
    head[1:] = (u[1:] != u[:-1]).any(dim=1)
    seg = torch.cumsum(head.to(torch.int64), 0) - 1
    n = int(seg[-1]) + 1
    ucov = torch.zeros(n, dtype=torch.int64, device=keys.device)
    ucov.index_add_(0, seg, tk.from_bits32(cov))
    mk = masks.to(torch.int64)
    umask = torch.zeros(n, dtype=torch.int64, device=keys.device)
    for b in range(8):
        bit = torch.zeros(n, dtype=torch.int64, device=keys.device)
        umask |= bit.scatter_reduce_(0, seg, (mk >> b) & 1, "amax") << b
    return keys[head], tk.to_bits32(ucov & tk.M32), umask.to(torch.uint8)


def segment_reduce(keys: torch.Tensor, cov: torch.Tensor, masks: torch.Tensor):
    """Runs of equal rows of sorted keys (int32 [m, W]) -> (unique keys,
    coverage sums int32 (uint32 bits), ORed masks uint8): the plain twin for
    CPU tensors, one `ctk_segment_reduce` launch for CUDA tensors (whose
    unique-row count is read back to size the result)."""
    m = keys.shape[0]
    if keys.dim() != 2 or keys.dtype != torch.int32 or not 1 <= keys.shape[1] <= 4:
        raise ValueError("keys must be int32 [m, W], 1 <= W <= 4")
    if cov.shape != (m,) or cov.dtype != torch.int32 or masks.shape != (m,) or \
            masks.dtype != torch.uint8:
        raise ValueError("cov must be int32 [m] and masks uint8 [m]")
    if not keys.device == cov.device == masks.device:
        raise ValueError("keys, cov and masks must be on one device")
    if keys.device.type == "cpu":
        return reduce_plain(keys, cov, masks)
    if keys.device.type != "cuda":
        raise ValueError(f"unsupported device {keys.device}")
    if m == 0:
        return keys, cov, masks
    out = (torch.empty_like(keys), torch.empty_like(cov), torch.empty_like(masks))
    count = torch.empty(1, dtype=torch.int32, device=keys.device)
    reduce_kernel(*(aligned(x.contiguous()) for x in (keys, cov, masks)), *out, count)
    n = int(count.item())
    return tuple(x[:n] for x in out)


def reduce_tiles_plain(keys: torch.Tensor, cov: torch.Tensor, masks: torch.Tensor,
                       tile_rows: int = REDUCE_TILE_ROWS, order=None):
    """ctk_segment_reduce's algorithm step for step on sorted rows, with
    reduce_plain's results.  Each tile finds its heads (first rows of runs,
    read against the row before the tile) and tails (last rows, against the
    row after) and publishes its aggregate: its heads, and the (sum, OR) of
    its trailing open run -- as A, or as P (an inclusive prefix) for tile
    0's words and for the carry of a tile that holds a head.  Then the tiles,
    in `order` (default: tile order), look back through A words to the
    nearest P for the heads before them and the carry of the run they
    continue, and publish P.  A tail's run value is its rows in the tile,
    plus the carry when the run began in an earlier tile; a tile writes its
    tails from row (heads before it) - (1 if it continues a run), in order
    (asserted here)."""
    m, w = keys.shape
    if m == 0:
        return keys, cov, masks
    u, c, mk = tk.from_bits32(keys), tk.from_bits32(cov).tolist(), masks.tolist()
    diff = (u[1:] != u[:-1]).any(dim=1).tolist()
    head, tail = [True] + diff, diff + [True]
    spans = [range(t, min(m, t + tile_rows)) for t in range(0, m, tile_rows)]

    def run(lo: int, hi: int) -> tuple:
        """The (sum, OR) of rows [lo, hi), the sum wrapping as uint32."""
        o = 0
        for x in mk[lo:hi]:
            o |= x
        return sum(c[lo:hi]) & tk.M32, o

    heads_st, carry_st = [], []               # [flag, value] a tile
    for t, rows in enumerate(spans):
        hs = [r for r in rows if head[r]]
        heads_st.append(["P" if t == 0 else "A", len(hs)])
        carry_st.append(["P" if t == 0 or hs else "A", run(hs[-1] if hs else rows.start,
                                                            rows.stop)])

    def look_back(status, t, add):
        acc, j = None, t - 1
        while True:
            acc = status[j][1] if acc is None else add(acc, status[j][1])
            if status[j][0] == "P":
                return acc
            j -= 1

    before, carry = [0] * len(spans), [(0, 0)] * len(spans)
    for t in (range(len(spans)) if order is None else order):
        if t == 0:
            continue
        before[t] = look_back(heads_st, t, lambda a, b: a + b)
        carry[t] = look_back(carry_st, t, lambda a, b: ((a[0] + b[0]) & tk.M32, a[1] | b[1]))
        heads_st[t] = ["P", before[t] + heads_st[t][1]]
        if carry_st[t][0] == "A":
            carry_st[t] = ["P", ((carry[t][0] + carry_st[t][1][0]) & tk.M32,
                                 carry[t][1] | carry_st[t][1][1])]

    rows_out, sums, ors = [], [], []
    for t, rows in enumerate(spans):
        # the tile's first output row: (heads before it) - (1 if it continues a run)
        assert len(rows_out) == before[t] - (not head[rows.start])
        s0, o0 = carry[t]                     # the run open at the tile's start
        for r in rows:
            if head[r]:
                s0, o0 = 0, 0
            s0, o0 = (s0 + c[r]) & tk.M32, o0 | mk[r]
            if tail[r]:
                rows_out.append(r)
                sums.append(s0)
                ors.append(o0)
    assert len(rows_out) == heads_st[-1][1]
    dev = keys.device
    return (keys[torch.tensor(rows_out, dtype=torch.int64, device=dev)],
            tk.to_bits32(torch.tensor(sums, dtype=torch.int64, device=dev)),
            torch.tensor(ors, dtype=torch.uint8, device=dev))


def _scratch(table: dict, device: torch.device, tiles: int, words: int):
    """A kernel's look-back scratch on `device`, kept between launches: two
    uint32 counters (back at 0 after every launch) and `words` status words
    a tile, grown (zeroed) to `tiles` tiles; and the epoch of the next
    launch, which makes words of earlier launches read as unwritten.  When
    the epochs run out the statuses are zeroed and the count starts again.
    Launches on one device share it, so they must be ordered on one stream.
    Returns (the int64 scratch, the tiles it holds, the epoch)."""
    entry = table.get(device)
    if entry is None or entry[0].numel() < 2 + words * tiles:
        have = 0 if entry is None else (entry[0].numel() - 2) // words
        entry = [torch.zeros(2 + words * max(tiles, 2 * have), dtype=torch.int64,
                             device=device), 0]
        table[device] = entry
    entry[1] += 1
    if entry[1] == EPOCH_LIMIT:
        entry[0].zero_()
        entry[1] = 1
    return entry[0], (entry[0].numel() - 2) // words, entry[1]


def count_scratch(device: torch.device, n: int):
    """ctk_count_windows' scratch (_scratch): one status word a tile of
    COUNT_TILE windows, for a piece of n bytes."""
    return _scratch(_COUNT_SCRATCH, device, -(-n // COUNT_TILE), 1)


def reduce_scratch(device: torch.device, m: int):
    """ctk_segment_reduce's scratch (_scratch): two status words a tile of
    REDUCE_TILE_ROWS rows, for m rows."""
    return _scratch(_REDUCE_SCRATCH, device, -(-m // REDUCE_TILE_ROWS), 2)


def aligned(x: torch.Tensor) -> torch.Tensor:
    """x, or a copy of it that starts on a 16-byte boundary (the count kernels
    read their inputs in 16-byte pieces)."""
    return x if x.data_ptr() % 16 == 0 else x.clone()


def reduce_kernel(keys, cov, masks, out_keys, out_cov, out_masks, count) -> None:
    """One `ctk_segment_reduce` launch on checked, contiguous card tensors
    that start on 16-byte boundaries: the unique rows into the first `count`
    rows of the outputs (room for m rows each), its scratch the device's
    (`reduce_scratch`)."""
    m = keys.shape[0]
    scratch, tiles, epoch = reduce_scratch(keys.device, m)
    err = _kernels.library().ctk_segment_reduce(
        keys.data_ptr(), cov.data_ptr(), masks.data_ptr(), m, keys.shape[1],
        out_keys.data_ptr(), out_cov.data_ptr(), out_masks.data_ptr(), count.data_ptr(),
        scratch.data_ptr(), tiles, epoch, _kernels.stream(keys.device))
    _kernels.check(err, "segment_reduce")
    LAUNCHES["segment_reduce"] += 1


def sort_reduce(keys: torch.Tensor, cov: torch.Tensor, masks: torch.Tensor):
    """Sort rows by key, then reduce the runs of equal keys."""
    order = sort_order(keys)
    return segment_reduce(keys[order], cov[order], masks[order])


# ---------------------------------------------------------------------------
# the counter
# ---------------------------------------------------------------------------

class DeviceCounter:
    """Streaming k-mer counter with an accumulator on `device` (default: the
    CUDA card, and RuntimeError without one; "cpu" runs the plain twins)."""

    def __init__(self, k: int, chunk_bases: int = CHUNK_BASES, device=None):
        self.k = k
        self.w = tk.words(k)
        self.chunk_bases = chunk_bases
        self.device = resolve(device)
        self.acc = None
        self._reads: list = []
        self._pending = 0

    def add(self, seq: str) -> None:
        k, c = self.k, self.chunk_bases
        if len(seq) < k:
            return
        if len(seq) + k >= c:
            self._flush_reads()
            # long sequence: overlapping pieces, explicit window ownership
            stride = c - 2 * k
            for a in range(0, len(seq), stride):
                lo = max(0, a - 1)
                o0 = a - lo
                o1 = min(a + stride, len(seq) - k + 1) - lo
                if o1 > o0:
                    self._count_piece(encode([seq[lo:a + c - k]], k), o0, o1)
                if a + stride >= len(seq) - k + 1:
                    break
            return
        if self._pending + len(seq) + k > c:
            self._flush_reads()
        self._reads.append(seq)
        self._pending += len(seq) + k

    def _flush_reads(self) -> None:
        if not self._reads:
            return
        data = encode(self._reads, self.k)
        self._reads, self._pending = [], 0
        self._count_piece(data)

    def _count_piece(self, data: bytes, own_lo: int = 0, own_hi: int | None = None) -> None:
        """Count a piece's windows [own_lo, own_hi) (default: all of them)."""
        if len(data) > self.chunk_bases:
            raise ValueError("piece exceeds chunk_bases")
        keys, masks = count_windows(upload(data, self.device), own_lo,
                                    len(data) if own_hi is None else own_hi, self.k)
        cov = torch.ones(keys.shape[0], dtype=torch.int32, device=self.device)
        self._merge(*sort_reduce(keys, cov, masks))

    def _merge(self, keys, cov, masks) -> None:
        if self.acc is None:
            self.acc = (keys, cov, masks)
            return
        self.acc = sort_reduce(*(torch.cat([a, b]) for a, b in zip(self.acc, (keys, cov, masks))))

    def finish(self):
        """-> (kmers uint32[N, W], cov uint32[N], in uint8[N], out uint8[N])
        as numpy arrays, sorted unique canonical; rows whose coverage wrapped
        to 0 dropped, as the JAX package's finish does."""
        self._flush_reads()
        if self.acc is None:
            return (np.zeros((0, self.w), np.uint32), np.zeros(0, np.uint32),
                    np.zeros(0, np.uint8), np.zeros(0, np.uint8))
        keys, cov, masks = (x.cpu().numpy() for x in self.acc)
        keys, cov = keys.view(np.uint32), cov.view(np.uint32)
        real = cov > 0
        return keys[real], cov[real], masks[real] >> 4, masks[real] & 15


def count_kmers_device(sequences, k: int, chunk_bases: int = CHUNK_BASES, device=None):
    """Device twin of build.count_kmers: the same outputs, bit for bit."""
    c = DeviceCounter(k, chunk_bases, device)
    for seq in sequences:
        c.add(seq)
    return c.finish()
