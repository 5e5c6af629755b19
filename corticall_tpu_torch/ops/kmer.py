"""Packed k-mer bit primitives in plain PyTorch.

Counterpart of corticall_tpu/ops/kmer_jax.py.  Words are 2-bit packed k-mers,
W = ceil(k/16) words, right-aligned, word 0 most significant (the layout of
corticall_tpu/kmer.py).  Each uint32 word is held in an int64 tensor: torch's
CPU build has no shifts, compares or adds on uint32, and int64 holds every
uint32 value and every intermediate below exactly.  Results are masked back
to 32 bits, so they equal kmer_jax's bit for bit.  The CUDA kernels
(csrc/jump.cu) fuse these primitives and work on uint32 directly.
"""

from __future__ import annotations

import numpy as np
import torch

M32 = 0xFFFFFFFF
_M33, _M0F, _MFF = 0x33333333, 0x0F0F0F0F, 0x00FF00FF


def words(k: int) -> int:
    return (k + 15) // 16


def top_word_mask(k: int) -> int:
    """Mask of the (partially filled) most significant word."""
    used = 2 * k - 32 * (words(k) - 1)
    return M32 if used >= 32 else (1 << used) - 1


def _word_mask(k: int, like: torch.Tensor) -> torch.Tensor:
    """[W] mask: the top word's, then all ones."""
    m = torch.full((like.shape[-1],), M32, dtype=torch.int64, device=like.device)
    m[0] = top_word_mask(k)
    return m


def mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for x < 2^32, without int64 overflow."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & M32


def reverse_pairs32(x: torch.Tensor) -> torch.Tensor:
    """Reverse the sixteen 2-bit groups within each 32-bit word."""
    x = ((x & _M33) << 2) | ((x >> 2) & _M33)
    x = ((x & _M0F) << 4) | ((x >> 4) & _M0F)
    x = ((x & _MFF) << 8) | ((x >> 8) & _MFF)
    return ((x << 16) & M32) | (x >> 16)


def revcomp_words(w: torch.Tensor, k: int) -> torch.Tensor:
    """Reverse complement: complement every code, reverse the base order,
    realign right, mask the top word."""
    nw = w.shape[-1]
    rev = reverse_pairs32(~w & M32).flip(-1)
    s = 32 * nw - 2 * k
    if s:
        carry = torch.cat([torch.zeros_like(rev[..., :1]), rev[..., :-1]], dim=-1)
        rev = (rev >> s) | ((carry << (32 - s)) & M32)
    return rev & _word_mask(k, w)


def lex_less(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a < b as big-to-little word tuples."""
    lt = torch.zeros(a.shape[:-1], dtype=torch.bool, device=a.device)
    decided = torch.zeros_like(lt)
    for i in range(a.shape[-1]):
        ai, bi = a[..., i], b[..., i]
        lt = lt | (~decided & (ai < bi))
        decided = decided | (ai != bi)
    return lt


def canonicalize_words(w: torch.Tensor, k: int):
    """(canonical words, flipped): the lexically lower orientation."""
    rc = revcomp_words(w, k)
    flipped = lex_less(rc, w)
    return torch.where(flipped[..., None], rc, w), flipped


def shift_append(w: torch.Tensor, base: torch.Tensor, k: int) -> torch.Tensor:
    """Next k-mer: drop the first base, append `base` at the end."""
    carry = torch.cat([w[..., 1:], torch.zeros_like(w[..., :1])], dim=-1)
    out = ((w << 2) & M32) | (carry >> 30)
    out[..., -1] |= base.to(torch.int64)
    return out & _word_mask(k, w)


def shift_prepend(w: torch.Tensor, base: torch.Tensor, k: int) -> torch.Tensor:
    """Previous k-mer: drop the last base, prepend `base` at the front."""
    carry = torch.cat([torch.zeros_like(w[..., :1]), w[..., :-1]], dim=-1)
    out = (w >> 2) | ((carry << 30) & M32)
    p = 2 * (k - 1)
    out[..., w.shape[-1] - 1 - p // 32] |= base.to(torch.int64) << (p % 32)
    return out


def first_base(w: torch.Tensor, k: int) -> torch.Tensor:
    """Code of the first (5'-most) base."""
    p = 2 * (k - 1)
    return (w[..., w.shape[-1] - 1 - p // 32] >> (p % 32)) & 3


def last_base(w: torch.Tensor) -> torch.Tensor:
    return w[..., -1] & 3


def mix32(x: torch.Tensor) -> torch.Tensor:
    """Murmur3-style finalizer on 32-bit values."""
    x = x ^ (x >> 16)
    x = mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def hash_words(w: torch.Tensor) -> torch.Tensor:
    """[..., W] words -> [...] 32-bit hash (word-order sensitive)."""
    h = torch.full(w.shape[:-1], 0x811C9DC5, dtype=torch.int64, device=w.device)
    for i in range(w.shape[-1]):
        h = mul32(mix32(h ^ w[..., i]), 0x01000193)
    return mix32(h)


def popcount4(mask: torch.Tensor) -> torch.Tensor:
    """Population count of a 4-bit base mask."""
    m = mask.to(torch.int64)
    return (m & 1) + ((m >> 1) & 1) + ((m >> 2) & 1) + ((m >> 3) & 1)


def lowest_set_base(mask: torch.Tensor) -> torch.Tensor:
    """Index (0-3) of the lowest set bit of a base mask; 3 for an empty mask,
    as kmer_jax gives."""
    m = mask.to(torch.int64)
    return torch.where((m & 1) != 0, 0,
                       torch.where((m & 2) != 0, 1,
                                   torch.where((m & 4) != 0, 2, 3)))


def to_bits32(x: torch.Tensor) -> torch.Tensor:
    """int64 holding uint32 values -> int32 with the same 32 bits."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def from_bits32(x: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> int64 holding the uint32 values."""
    return x.to(torch.int64) & M32


def words_tensor(words: np.ndarray, device) -> torch.Tensor:
    """uint32 numpy array (k-mer words, coverages) -> int32 tensor of the
    same bits on `device`: the kernels' view."""
    arr = np.ascontiguousarray(words, dtype=np.uint32).view(np.int32)
    return torch.from_numpy(arr).to(device)
