"""Numpy twin of the batched walk kernel for small batches.

The device kernel (ops/cuckoo.py::walk_forward_cuckoo) pays a one-time XLA
compile that is only worth it for large frontiers; for small batches
(Partition's few thousand ROI walks) this vectorized numpy walk produces the
IDENTICAL output stream — same emitted bases, Brent cycle flags, and step
counts — with zero compile cost, using the graph's sorted-key lookup
(searchsorted) instead of a hash table.  Same reference semantics
(TraversalEngine.java:241-279 single-successor walk).
"""

from __future__ import annotations

import numpy as np

from .. import graph as gr
from .. import kmer as km

_POP4 = np.array([bin(i).count("1") for i in range(16)], dtype=np.int8)
_LOW4 = np.array([(i & -i).bit_length() - 1 if i else 0 for i in range(16)],
                 dtype=np.int8)


def walk_forward_np(graph: gr.CortexGraph, colors, seed_codes: np.ndarray,
                    num_steps: int):
    """seed_codes: uint8[B, k] walk-orientation kmer codes.

    Returns (bases int8[T, B], cycled bool[B], steps int32[B]) — bit-identical
    to walk_forward_cuckoo on the same graph/colors/seeds.
    """
    b, k = seed_codes.shape
    cols = list(colors)
    edges = graph.edges[:, cols[0]].copy()
    for c in cols[1:]:
        edges |= graph.edges[:, c]

    cur = seed_codes.astype(np.uint8)
    active = np.ones(b, dtype=bool)
    saved = cur.copy()
    power = np.ones(b, dtype=np.int32)
    lam = np.zeros(b, dtype=np.int32)
    bases = np.full((num_steps, b), -1, dtype=np.int8)
    cycles = np.zeros(b, dtype=bool)

    for t in range(num_steps):
        if not active.any():
            break
        canon, flipped = km.canonicalize_codes(cur)
        idx = graph.find_records(km.pack_codes(canon, k))
        e = np.where(idx >= 0, edges[np.maximum(idx, 0)], 0).astype(np.uint8)
        next_mask = np.where(flipped, e >> 4, e & 0xF).astype(np.int64)
        n = _POP4[next_mask]
        base = _LOW4[next_mask]
        nxt = np.concatenate([cur[:, 1:], base[:, None].astype(np.uint8)],
                             axis=1)

        single = n == 1
        is_cycle = (nxt == saved).all(axis=1) & single & active
        advance = active & single & ~is_cycle
        bases[t] = np.where(advance, base, -1).astype(np.int8)
        cycles |= is_cycle

        teleport = (power == lam) & advance
        saved = np.where(teleport[:, None], nxt, saved)
        power = np.where(teleport, power * 2, power)
        lam = np.where(teleport, 0, lam)
        lam = np.where(advance, lam + 1, lam)

        cur = np.where(advance[:, None], nxt, cur)
        active = advance

    steps = (bases >= 0).sum(axis=0).astype(np.int32)
    return bases, cycles, steps


def decode_runs(w0: np.ndarray, w1: np.ndarray) -> np.ndarray:
    """Unpack one walk's run-word columns (uint32[T] each, from
    cuckoo.walk_forward_runs) into an int8 base-code array in emission order.
    word0 bits 29..24 = run length m; bases are big-endian 2-bit fields —
    b0..b11 in word0 bits 23..0, b12..b23 in word1 bits 23..0."""
    w0 = np.asarray(w0, dtype=np.uint64)
    w1 = np.asarray(w1, dtype=np.uint64)
    m = ((w0 >> 24) & 0x3F).astype(np.int64)
    # 48-bit field per iteration, b0 at bits 47..46
    f = ((w0 & 0xFFFFFF) << 24) | (w1 & 0xFFFFFF)
    total = int(m.sum())
    starts = np.concatenate([[0], np.cumsum(m)[:-1]])
    t_idx = np.repeat(np.arange(len(m)), m)
    j_idx = np.arange(total) - starts[t_idx]            # 0..m-1 within run
    out = ((f[t_idx] >> (46 - 2 * j_idx).astype(np.uint64)) & 0x3).astype(np.int8)
    return out


_JUMP_FIELD_SHIFTS = (30 - 2 * np.arange(16)).astype(np.uint32)


def decode_jump_packed(words: np.ndarray, steps: int) -> np.ndarray:
    """One lane's jump-walk emission (cuckoo.walk_forward_jumps packed
    row: [h0, l0, h1, l1, ...], base p of each word at bits 30-2p) ->
    int8[steps] base codes."""
    w = np.asarray(words, dtype=np.uint32)
    fields = (w[:, None] >> _JUMP_FIELD_SHIFTS[None, :]) & 3
    return fields.reshape(-1).astype(np.int8)[:steps]


def replay_jump_walk(seed: str, words: np.ndarray, steps: int,
                     max_branch_length: int = 75000) -> str:
    """Exact walk extension from a jump-kernel packed recording (seen-set
    replay — see replay_run_walk)."""
    return replay_walk(seed, decode_jump_packed(words, steps), True,
                       max_branch_length)


_BASE_LUT = np.frombuffer(b"ACGT", dtype=np.uint8)


_REVISIT_POWERS: dict = {}

_ROLL_M = 0x9E3779B97F4A7C15
_ROLL_MINV = pow(_ROLL_M, -1, 1 << 64)       # M is odd -> invertible mod 2^64
_ROLL_CACHE: dict = {}


def _roll_powers(n: int):
    """(M^i, M^-i) uint64-wraparound arrays of length >= n, cached by
    power-of-two size."""
    cap = 1 << max(10, (n - 1).bit_length())
    pw = _ROLL_CACHE.get(cap)
    if pw is None:
        m = np.full(cap, np.uint64(_ROLL_M))
        m[0] = 1
        mi = np.full(cap, np.uint64(_ROLL_MINV & ((1 << 64) - 1)))
        mi[0] = 1
        pw = (np.cumprod(m, dtype=np.uint64), np.cumprod(mi, dtype=np.uint64))
        _ROLL_CACHE[cap] = pw
    return pw


def rolling_window_hashes(codes: np.ndarray, k: int):
    """(h_fwd uint64[n-k+1], h_rc uint64[n-k+1]) for every k-window of a
    base-code array, O(n): h_fwd[i] equals the polynomial hash
    sum_j codes[i+j]*M^j (the _has_revisit/_kmer_hash_codes function) and
    h_rc[i] the same for the window's reverse complement — with NO [N, k]
    window materialization (h[i] = (P[i+k]-P[i]) * M^-i over the prefix sum
    P of codes[j]*M^j; all uint64 wraparound)."""
    n = len(codes)
    if n < k:
        z = np.zeros(0, np.uint64)
        return z, z
    pw, ipw = _roll_powers(n + 1)

    def fwd_hashes(c):
        s = c.astype(np.uint64) * pw[:n]
        P = np.zeros(n + 1, np.uint64)
        np.cumsum(s, out=P[1:])
        return (P[k:] - P[:-k]) * ipw[:n - k + 1]

    hf = fwd_hashes(codes)
    cr = (3 - codes)[::-1]
    hr_rev = fwd_hashes(cr)
    return hf, hr_rev[::-1].copy()


def _path_offsets(paths: list):
    sizes = np.fromiter((len(p) for p in paths), np.int64, len(paths))
    starts = np.zeros(len(paths) + 1, np.int64)
    np.cumsum(sizes, out=starts[1:])
    return starts


_PATH_BATCH_BASES = 8 << 20


def _path_batches(paths: list, budget: int = _PATH_BATCH_BASES):
    """Yield (lo, hi) index ranges whose total base count stays under
    `budget`, so the rolling-hash power arrays stay ~64 MB instead of
    scaling with the whole input (flagship chains total ~10^8 bases)."""
    lo, acc = 0, 0
    for i, p in enumerate(paths):
        if acc and acc + len(p) > budget:
            yield lo, i
            lo, acc = i, 0
        acc += len(p)
    if lo < len(paths):
        yield lo, len(paths)


def batch_revisit(seeds: list, exts: list) -> np.ndarray:
    """Vectorized _has_revisit over many (seed, ext) paths: ONE rolling-hash
    pass over the concatenation (no [N, k] window materialization, the old
    per-path cost), then a cache-friendly per-path uniqueness check on the
    hash slices.  Identical outcome (same hash function, same test)."""
    out = np.zeros(len(seeds), bool)
    if not seeds:
        return out
    from .. import kmer as km
    k = len(seeds[0])
    paths = [s + e for s, e in zip(seeds, exts)]
    for blo, bhi in _path_batches(paths):
        batch = paths[blo:bhi]
        starts = _path_offsets(batch)
        codes = km.string_to_codes_permissive("".join(batch))
        if len(codes) < k:
            continue
        hf, _ = rolling_window_hashes(codes, k)
        for i in range(len(batch)):
            lo, hi = starts[i], starts[i + 1] - (k - 1)
            if hi <= lo:
                continue
            h = hf[lo:hi]
            if len(np.unique(h)) != len(h):
                out[blo + i] = True
    return out


def batch_replay_exts(seeds: list, bases2d: np.ndarray, cycled: np.ndarray,
                      max_branch: int) -> list:
    """replay_walk for every lane at once: vectorized decode, batched
    revisit gate for cap-saturated lanes, per-kmer dict replay only where
    genuinely needed (cycled, or capped with an actual cursor revisit) —
    the per-lane python was the dominant flagship Call/prefilter cost."""
    valid = bases2d >= 0
    lens = valid.sum(axis=1)
    flat = _BASE_LUT[bases2d[valid]]
    bounds = np.zeros(len(seeds) + 1, np.int64)
    np.cumsum(lens, out=bounds[1:])
    blob = flat.tobytes()
    exts = [blob[bounds[i]:bounds[i + 1]].decode()
            for i in range(len(seeds))]
    need_dict = np.asarray(cycled, bool).copy()
    capped = ~need_dict & (lens >= max_branch)
    idxs = np.nonzero(capped)[0]
    if len(idxs):
        rev = batch_revisit([seeds[i] for i in idxs],
                            [exts[i] for i in idxs])
        need_dict[idxs[rev]] = True
    for i in np.nonzero(need_dict)[0]:
        exts[i] = replay_walk(seeds[i], bases2d[i], bool(cycled[i]),
                              max_branch)
    return exts


def batch_dedup_extensions(seeds: list, exts: list,
                           max_branch_length: int = 75000) -> list:
    """dedup_extension for many (seed, ext) pairs with ONE batched revisit
    gate; only paths with an actual revisit pay the dict replay."""
    nonempty = [i for i, e in enumerate(exts) if e]
    out = list(exts)
    if not nonempty:
        return out
    rev = batch_revisit([seeds[i] for i in nonempty],
                        [exts[i] for i in nonempty])
    from .. import kmer as km
    for j in np.nonzero(rev)[0]:
        i = nonempty[j]
        codes = km.string_to_codes_permissive(exts[i]).astype(np.int8)
        out[i] = replay_walk(seeds[i], codes, True, max_branch_length)
    return out


def batch_link_touch(paths: list, k: int,
                     link_keys: np.ndarray) -> np.ndarray:
    """bool[len(paths)]: does any k-window of each path carry link records?
    One rolling-hash pass; membership tested for BOTH orientations' hashes
    (hash(canonical) always equals one of them; the extra orientation can
    only add a collision false positive, which just routes one more chain
    to the exact linked replay)."""
    from .. import kmer as km
    touched = np.zeros(len(paths), bool)
    if not paths:
        return touched

    def member(h):
        pos = np.minimum(np.searchsorted(link_keys, h), len(link_keys) - 1)
        return link_keys[pos] == h

    for blo, bhi in _path_batches(paths):
        batch = paths[blo:bhi]
        starts = _path_offsets(batch)
        codes = km.string_to_codes_permissive("".join(batch))
        if len(codes) < k:
            continue
        hf, hr = rolling_window_hashes(codes, k)
        # windows spanning a path boundary are invalid: the k-1 slots
        # before each boundary
        bad = (starts[1:, None] - np.arange(k - 1, 0, -1)[None, :]).ravel()
        bad = bad[(bad >= 0) & (bad < len(hf))]
        ok = np.ones(len(hf), bool)
        ok[bad] = False
        hit = np.zeros(len(hf), bool)
        hit[ok] = member(hf[ok]) | member(hr[ok])
        w = np.nonzero(hit)[0]
        pid = np.searchsorted(starts, w, side="right") - 1
        touched[blo + np.unique(pid)] = True
    return touched


def _has_revisit(seed: str, codes: np.ndarray, k: int) -> bool:
    """True when the walk-oriented kmer cursor revisits any position along
    seed+ext — the only case where the raw recording differs from the
    seen-set oracle.  Vectorized polynomial hash over all windows; a hash
    collision only costs a spurious dict replay (safe)."""
    from .. import kmer as km
    seed_codes = km.string_to_codes_permissive(seed)
    path = np.concatenate([seed_codes, codes.astype(np.uint8)])
    wins = km.kmerize_codes(path, k)
    p = _REVISIT_POWERS.get(k)
    if p is None:
        mult = np.uint64(0x9E3779B97F4A7C15)
        p = np.empty(k, np.uint64)
        p[0] = 1
        for i in range(1, k):
            p[i:i + 1] = p[i - 1:i] * mult
        _REVISIT_POWERS[k] = p
    h = (wins.astype(np.uint64) * p[None, :]).sum(axis=1, dtype=np.uint64)
    return len(np.unique(h)) != len(h)


def jump_extensions_batch(seeds: list, packed: np.ndarray, steps: np.ndarray,
                          cycled: np.ndarray, saturated: np.ndarray,
                          max_branch_length: int = 75000) -> list:
    """All lanes' extensions from one walk_forward_jumps result, decoded in
    one vectorized pass.  Linear recordings convert straight to strings.
    Saturated (cap-length) lanes are almost always genuinely linear — a
    vectorized revisit check proves it; only lanes with an actual cursor
    revisit (true cycles) pay the per-kmer seen-set replay."""
    w = np.asarray(packed, dtype=np.uint32)
    out = []
    # decode in bounded lane blocks: the [B, 2T, 16] expansion at the
    # production chunk (65536 lanes x max_walk 20000) would be a ~1.3 GB
    # uint8 transient (with a >5 GB uint32 intermediate) — blocks keep the
    # peak under ~100 MB with identical output (ADVICE r04)
    block = max(1, (16 << 20) // max(w.shape[1] * 16, 1))
    for lo in range(0, len(seeds), block):
        wb = w[lo:lo + block]
        fields = ((wb[:, :, None] >> _JUMP_FIELD_SHIFTS[None, None, :]) & 3
                  ).astype(np.uint8)
        flat = fields.reshape(wb.shape[0], -1)
        for j, seed in enumerate(seeds[lo:lo + block]):
            i = lo + j
            n = int(steps[i])
            codes = flat[j, :n]
            if cycled[i] or (saturated[i]
                             and _has_revisit(seed, codes, len(seed))):
                out.append(replay_walk(seed, codes.astype(np.int8), True,
                                       max_branch_length))
            else:
                out.append(_BASE_LUT[codes].tobytes().decode())
    return out


def replay_run_walk(seed: str, w0: np.ndarray, w1: np.ndarray,
                    max_branch_length: int = 75000) -> str:
    """Exact walk extension from a run-kernel recording.

    The run kernel's recorded path always covers at least one full lap of any
    cycle (jump-granularity Brent + builder-flagged short cycles, see
    cuckoo.walk_forward_runs), but its stopping point differs from the
    single-step kernel's; applying the reference's seen-set rule to the
    recorded successor map (replay_walk's cycled path) yields the oracle
    answer in every case — including capped walks with undetected revisits."""
    bases = decode_runs(w0, w1)
    return replay_walk(seed, bases, True, max_branch_length)


def dedup_extension(seed: str, ext: str,
                    max_branch_length: int = 75000) -> str:
    """Apply the reference seen-set rule to an extension assembled across
    multiple growing-round chunks (commands/core._batched_contigs): each
    chunk replays with only its own seen state, so a cycle longer than one
    chunk can contribute up to an extra lap before Brent catches it.  One
    final whole-extension replay restores the host-oracle answer."""
    if not ext:
        return ext
    codes = km.string_to_codes_permissive(ext).astype(np.int8)
    if not _has_revisit(seed, codes, len(seed)):
        return ext
    return replay_walk(seed, codes, True, max_branch_length)


def replay_walk(seed: str, bases: np.ndarray, cycled: bool,
                max_branch_length: int = 75000) -> str:
    """Rebuild the walked extension with the reference's exact stopping rule.

    Without links the single-successor function is deterministic per kmer, so
    the device recording (which may overshoot around a cycle before Brent
    detection, or stop slightly early) fully determines the successor map; we
    replay the reference's seen-set semantics (TraversalEngine.java:241-279:
    emit the cursor kmer, then stop when the *following* kmer was already
    stepped onto — the seed and first step are never in the seen set) over
    that map.  Returns the extension string appended after the seed.
    """
    k = len(seed)
    arr = np.asarray(bases)
    lut = np.frombuffer(b"ACGT", dtype=np.uint8)
    codes = arr[arr >= 0]
    ext = lut[codes].tobytes().decode()
    if not cycled:
        # cap-saturated recordings may hide an undetected revisit (kernel
        # Brent's power-of-two windows can miss a cycle of length L until
        # ~2^ceil(log2 L)+L steps; ADVICE r03 / jump-cycle audit) — but the
        # expensive per-kmer seen-set replay only matters when a revisit
        # actually exists, so a vectorized hash-uniqueness check gates it
        # (every chunk-capped walk paying the dict replay cost the r4
        # flagship prefilter 9x its r3 wall-clock before this gate).
        if len(ext) < max_branch_length:
            return ext
        if not _has_revisit(seed, codes, k):
            return ext

    # successor map from the recorded path (covers the full cycle: Brent's
    # anchor sits on the cycle for >= one full lap before detection)
    seq = seed + ext
    succ: dict[str, str] = {}
    for i in range(len(seq) - k):
        succ.setdefault(seq[i:i + k], seq[i + k])

    out = []
    seen: set[str] = set()
    nxt = seed[1:] + succ[seed] if seed in succ else None
    while nxt is not None and len(out) < max_branch_length:
        out.append(nxt[-1])
        b = succ.get(nxt)
        f = nxt[1:] + b if b is not None else None
        if f is not None and f not in seen:
            seen.add(f)
            nxt = f
        else:
            nxt = None
    return "".join(out)
