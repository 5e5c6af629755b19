"""The trio's joined de Bruijn graph, built on the device from the genomes.

The graph stands in for the cleaned graph that Partition and Call read: its
records are every distinct canonical k-mer of the three genomes, and each
colour's edge byte is the Cortex byte (low nibble: the bases that follow the
canonical k-mer; high nibble: the bases that precede it, complemented and
bit-reversed, as corticall_tpu_torch/build.py writes it) over that colour's
genome, both strands.  K-mers are W = ceil(k / 16) words of 32 bits,
right-aligned, the first base the most significant (kmer.pack_codes), held
in int64 tensors here.  Built with sorts and scatters on the device in
seconds.  Nothing here imports the program.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


def n_words(k: int) -> int:
    return (k + 15) // 16


def kmer_words(codes: torch.Tensor, k: int):
    """(forward, reverse complement) words int64 [n-k+1, W] of every k-mer
    of a uint8 code sequence on the device; row p is the k-mer at p and its
    reverse complement."""
    n = codes.shape[0] - k + 1
    w = n_words(k)
    c = codes.to(torch.int64)
    fwd = torch.zeros((n, w), dtype=torch.int64, device=codes.device)
    rc = torch.zeros_like(fwd)
    for i in range(k):
        p = 2 * (k - 1 - i)
        fwd[:, w - 1 - p // 32] |= c[i:i + n] << (p % 32)
        q = 2 * i
        rc[:, w - 1 - q // 32] |= (3 - c[i:i + n]) << (q % 32)
    return fwd, rc


def unpack(words: torch.Tensor, k: int) -> torch.Tensor:
    """int64 [B, W] words -> int64 [B, k] base codes."""
    w = words.shape[1]
    cols = []
    for i in range(k):
        p = 2 * (k - 1 - i)
        cols.append((words[:, w - 1 - p // 32] >> (p % 32)) & 3)
    return torch.stack(cols, dim=1)


def pack(codes: torch.Tensor, k: int) -> torch.Tensor:
    """int64 [B, k] base codes -> int64 [B, W] words."""
    w = n_words(k)
    out = torch.zeros((codes.shape[0], w), dtype=torch.int64, device=codes.device)
    for i in range(k):
        p = 2 * (k - 1 - i)
        out[:, w - 1 - p // 32] |= codes[:, i] << (p % 32)
    return out


def revcomp_words(words: torch.Tensor, k: int) -> torch.Tensor:
    return pack(3 - unpack(words, k).flip(1), k)


def lex_less(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a < b row by row, words compared from the first."""
    less = torch.zeros(a.shape[0], dtype=torch.bool, device=a.device)
    decided = torch.zeros_like(less)
    for j in range(a.shape[1]):
        less |= ~decided & (a[:, j] < b[:, j])
        decided |= a[:, j] != b[:, j]
    return less


def lex_order(words: torch.Tensor) -> torch.Tensor:
    """Stable lexicographic order of int64 [M, W] rows (non-negative words)."""
    order = torch.arange(words.shape[0], device=words.device)
    for j in range(words.shape[1] - 1, -1, -1):
        order = order[torch.sort(words[order, j], stable=True).indices]
    return order


def group_ids(sorted_words: torch.Tensor) -> torch.Tensor:
    """Group id of each row of lexicographically sorted rows: equal rows
    share one, ids ascending from 0."""
    new = torch.ones(sorted_words.shape[0], dtype=torch.int64, device=sorted_words.device)
    if sorted_words.shape[0] > 1:
        new[1:] = (sorted_words[1:] != sorted_words[:-1]).any(dim=1).to(torch.int64)
    return torch.cumsum(new, 0) - 1


def or_bits(ids: torch.Tensor, bits: torch.Tensor, n: int) -> torch.Tensor:
    """Bitwise OR of uint8 `bits` by group id -> uint8 [n]."""
    out = torch.zeros(n, dtype=torch.int64, device=ids.device)
    b64 = bits.to(torch.int64)
    for bit in range(8):
        one = torch.zeros(n, dtype=torch.int64, device=ids.device)
        one.scatter_reduce_(0, ids, (b64 >> bit) & 1, reduce="amax")
        out |= one << bit
    return out.to(torch.uint8)


def to_uint32(words: torch.Tensor) -> np.ndarray:
    """int64 words holding uint32 values -> numpy uint32 (host)."""
    bits = torch.where(words >= 1 << 31, words - (1 << 32), words).to(torch.int32)
    return bits.cpu().numpy().view(np.uint32)


@dataclass
class Graph:
    k: int
    kmers: torch.Tensor        # int64 [N, W] canonical records, sorted
    edges: torch.Tensor        # uint8 [N, C], colours in Trio.genomes() order
    present: torch.Tensor      # bool [N, C]
    # a child occurrence of each record the child holds: its chromosome,
    # its position and whether the canonical k-mer is the reverse strand's
    child_chrom: torch.Tensor  # int64 [N] (-1: not in the child)
    child_pos: torch.Tensor    # int64 [N]
    child_flip: torch.Tensor   # bool [N]


def build_graph(trio, device) -> Graph:
    """The joined graph of the trio's three genomes on `device`."""
    k = trio.k
    canon, ebyte, colour, chrom, pos, flip = [], [], [], [], [], []
    for ci, (_, chroms) in enumerate(trio.genomes()):
        for cc, seq in enumerate(chroms):
            codes = torch.from_numpy(seq).to(device)
            fwd, rc = kmer_words(codes, k)
            n = fwd.shape[0]
            flipped = lex_less(rc, fwd)
            c64 = codes.to(torch.int64)
            succ = torch.full((n,), -1, dtype=torch.int64, device=device)
            pred = torch.full((n,), -1, dtype=torch.int64, device=device)
            succ[:n - 1] = c64[k:]
            pred[1:] = c64[:n - 1]
            # the canonical orientation's next and previous bases
            out_b = torch.where(flipped, torch.where(pred >= 0, 3 - pred, -1), succ)
            in_b = torch.where(flipped, torch.where(succ >= 0, 3 - succ, -1), pred)
            e = torch.where(out_b >= 0, 1 << out_b.clamp(min=0), 0) | \
                torch.where(in_b >= 0, 1 << (7 - in_b.clamp(min=0)), 0)
            canon.append(torch.where(flipped[:, None], rc, fwd))
            ebyte.append(e.to(torch.uint8))
            colour.append(torch.full((n,), ci, dtype=torch.int64, device=device))
            chrom.append(torch.full((n,), cc, dtype=torch.int64, device=device))
            pos.append(torch.arange(n, dtype=torch.int64, device=device))
            flip.append(flipped)
            del fwd, rc, codes
    canon = torch.cat(canon)
    order = lex_order(canon)
    ids = torch.empty_like(order)
    ids[order] = group_ids(canon[order])
    n_rec = int(ids.max()) + 1 if ids.numel() else 0
    kmers = torch.zeros((n_rec, canon.shape[1]), dtype=torch.int64, device=device)
    kmers[ids] = canon
    del canon, order
    colour = torch.cat(colour)
    ebyte = torch.cat(ebyte)
    n_col = len(trio.genomes())
    edges = torch.stack([or_bits(ids[colour == c], ebyte[colour == c], n_rec)
                         for c in range(n_col)], dim=1)
    present = torch.zeros((n_rec, n_col), dtype=torch.bool, device=device)
    present[ids, colour] = True
    # the first child occurrence (child occurrences come first in `ids`)
    first = torch.full((n_rec,), ids.shape[0], dtype=torch.int64, device=device)
    first.scatter_reduce_(0, ids, torch.arange(ids.shape[0], device=device), reduce="amin")
    in_child = present[:, 0]
    first = torch.where(in_child, first, 0)
    chrom, pos, flip = torch.cat(chrom), torch.cat(pos), torch.cat(flip)
    return Graph(k, kmers, edges, present,
                 torch.where(in_child, chrom[first], -1), pos[first], flip[first])
