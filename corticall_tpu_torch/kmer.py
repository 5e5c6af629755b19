"""K-mer primitives: 2-bit codes, packed words, canonicalization.

Replaces the reference's string-based k-mer types (CanonicalKmer.java:13-54,
CortexBinaryKmer, CortexByteKmer, SequenceUtils.java:61-243) with vectorized
numpy operations over arrays of k-mers.

Representations
---------------
codes : uint8[..., k]      base codes A=0 C=1 G=2 T=3 (ASCII order == code order,
                           so lexicographic string comparison == numeric comparison)
words : uint32[..., W]     W = ceil(k/16), 16 bases per 32-bit word, right-aligned:
                           base i (0-based from the 5' end) sits at bit offset
                           2*(k-1-i) of the W*32-bit big-endian-ordered number
                           (words[..., 0] is most significant).  Numeric tuple
                           order == lexicographic order.  uint32 lanes are the
                           TPU-native integer width (VPU lanes are 32-bit);
                           the on-disk format's uint64 containers are converted
                           at the I/O boundary only.

The .ctx on-disk container (docs/ctx_spec.md Table 5-6) is uint64 big-endian,
right-aligned — identical bit layout, wider words; conversion is a reshape.
"""

from __future__ import annotations

import numpy as np

_CODE_OF = np.full(256, 255, dtype=np.uint8)
for _i, _b in enumerate(b"ACGT"):
    _CODE_OF[_b] = _i
    _CODE_OF[ord(chr(_b).lower())] = _i
_BASE_OF = np.frombuffer(b"ACGT", dtype=np.uint8)

COMP = 3  # complement of code b is b ^ 3  (A<->T, C<->G)


def words_per_kmer(k: int) -> int:
    return (k + 15) // 16


def containers_per_kmer(k: int) -> int:
    """uint64 containers per kmer in the .ctx format (CortexRecord.java:309-311)."""
    return (k + 31) // 32


# ---------------------------------------------------------------------------
# string <-> codes
# ---------------------------------------------------------------------------

def string_to_codes(s: str | bytes) -> np.ndarray:
    """One k-mer string -> uint8[k] codes."""
    if isinstance(s, str):
        s = s.encode()
    a = np.frombuffer(s, dtype=np.uint8)
    codes = _CODE_OF[a]
    if (codes == 255).any():
        raise ValueError(f"invalid nucleotide in {s!r}")
    return codes


def strings_to_codes(seqs, k: int | None = None) -> np.ndarray:
    """List of equal-length strings -> uint8[N, k]."""
    if len(seqs) == 0:
        return np.zeros((0, k or 0), dtype=np.uint8)
    buf = b"".join(s.encode() if isinstance(s, str) else bytes(s) for s in seqs)
    a = np.frombuffer(buf, dtype=np.uint8).reshape(len(seqs), -1)
    codes = _CODE_OF[a]
    if (codes == 255).any():
        raise ValueError("invalid nucleotide")
    return codes


def string_to_codes_permissive(s: str | bytes) -> np.ndarray:
    """Codes with non-ACGT bases mapped to 4 (no exception)."""
    if isinstance(s, str):
        s = s.encode()
    a = np.frombuffer(s, dtype=np.uint8)
    codes = _CODE_OF[a].copy()
    codes[codes == 255] = 4
    return codes


def codes_to_string(codes: np.ndarray) -> str:
    return _BASE_OF[codes].tobytes().decode()


def codes_to_strings(codes: np.ndarray) -> list[str]:
    if codes.size == 0:
        return []
    flat = _BASE_OF[codes].tobytes()
    k = codes.shape[-1]
    return [flat[i * k:(i + 1) * k].decode() for i in range(codes.shape[0])]


# ---------------------------------------------------------------------------
# sequence ops on codes
# ---------------------------------------------------------------------------

def revcomp_codes(codes: np.ndarray) -> np.ndarray:
    return codes[..., ::-1] ^ COMP


def kmerize_codes(seq_codes: np.ndarray, k: int) -> np.ndarray:
    """uint8[L] sequence -> uint8[L-k+1, k] sliding windows (no copy)."""
    return np.lib.stride_tricks.sliding_window_view(seq_codes, k)


def canonicalize_codes(codes: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Alphanumerically-lowest orientation (SequenceUtils.java:206-243).

    Returns (canonical_codes uint8[N,k], flipped bool[N]) where flipped marks
    k-mers whose canonical orientation differs from the supplied one.
    """
    single = codes.ndim == 1
    if single:
        codes = codes[None]
    rc = revcomp_codes(codes)
    neq = codes != rc
    has_diff = neq.any(axis=-1)
    first = np.argmax(neq, axis=-1)
    idx = np.arange(codes.shape[0])
    flipped = has_diff & (codes[idx, first] > rc[idx, first])
    canon = np.where(flipped[:, None], rc, codes)
    if single:
        return canon[0], flipped[0]
    return canon, flipped


# ---------------------------------------------------------------------------
# codes <-> packed uint32 words
# ---------------------------------------------------------------------------

def pack_codes(codes: np.ndarray, k: int | None = None) -> np.ndarray:
    """uint8[N, k] -> uint32[N, W], right-aligned big-to-little word order."""
    single = codes.ndim == 1
    if single:
        codes = codes[None]
    n, kk = codes.shape
    k = k or kk
    w = words_per_kmer(k)
    words = np.zeros((n, w), dtype=np.uint32)
    for i in range(k):
        p = 2 * (k - 1 - i)
        words[:, w - 1 - p // 32] |= codes[:, i].astype(np.uint32) << np.uint32(p % 32)
    return words[0] if single else words


def unpack_words(words: np.ndarray, k: int) -> np.ndarray:
    """uint32[N, W] -> uint8[N, k]."""
    single = words.ndim == 1
    if single:
        words = words[None]
    n, w = words.shape
    codes = np.empty((n, k), dtype=np.uint8)
    for i in range(k):
        p = 2 * (k - 1 - i)
        codes[:, i] = (words[:, w - 1 - p // 32] >> np.uint32(p % 32)) & 3
    return codes[0] if single else codes


def words_to_bytes_be(words: np.ndarray, k: int) -> np.ndarray:
    """uint32[N, W] -> big-endian key bytes |S(8*S) (NOT the on-disk layout).

    These byte strings compare lexicographically in the same order as the
    packed numbers (== kmer string order), making them directly usable as
    np.searchsorted / np.unique keys.  For file I/O use words_to_disk.
    """
    single = words.ndim == 1
    if single:
        words = words[None]
    n, w = words.shape
    s = containers_per_kmer(k)
    full = np.zeros((n, 2 * s), dtype=np.uint32)
    full[:, 2 * s - w:] = words
    be = full.astype(">u4")
    return be.view(f"|S{8 * s}").reshape(n)[0] if single else be.view(f"|S{8 * s}").reshape(n)


_CODE_INT = {"A": 0, "C": 1, "G": 2, "T": 3}
_ORD_OF_CODE = [ord("A"), ord("C"), ord("G"), ord("T")]


def kmer_key_bytes(s: str, k: int) -> bytes:
    """Scalar fast path: kmer string -> the words_to_bytes_be key, via pure
    Python int packing (~40x faster than the numpy path for one kmer — the
    per-call array overhead dominates single-record lookups in host walks).
    Raises KeyError on non-ACGT."""
    v = 0
    for ch in s:
        v = (v << 2) | _CODE_INT[ch]
    # numpy S-dtype values drop trailing NULs; strip to compare equal with
    # elements of a words_to_bytes_be array (ordering is unaffected)
    return v.to_bytes(8 * containers_per_kmer(k), "big").rstrip(b"\x00")


def words_row_to_string(row: np.ndarray, k: int) -> str:
    """Scalar fast path: one uint32[W] packed kmer -> string."""
    v = 0
    for x in row.tolist():
        v = (v << 32) | x
    out = bytearray(k)
    for j in range(k - 1, -1, -1):
        out[j] = _ORD_OF_CODE[v & 3]
        v >>= 2
    return out.decode()


def bytes_be_to_words(raw: np.ndarray, k: int) -> np.ndarray:
    """|S(8*S)[N] (or uint8[N, 8*S]) big-endian containers -> uint32[N, W]."""
    s = containers_per_kmer(k)
    w = words_per_kmer(k)
    u8 = np.frombuffer(np.ascontiguousarray(raw), dtype=np.uint8).reshape(-1, 8 * s)
    full = u8.view(">u4").astype(np.uint32).reshape(-1, 2 * s)
    return full[:, 2 * s - w:]


def words_to_disk(words: np.ndarray, k: int) -> np.ndarray:
    """uint32[N, W] -> the .ctx on-disk container bytes, as |S(8*S).

    On disk each uint64 container holds its slice of the right-aligned 2-bit
    value in LITTLE-endian byte order, containers ordered most-significant
    first.  (The spec text says "big-endian" but the reference writer
    byteswaps the right-aligned value before a big-endian write —
    CortexRecord.java:313-334 + CortexGraphWriter.java:112-117 — which nets
    out to little-endian container bytes; verified against
    testdata/two_short_contigs.ctx.)
    """
    single = words.ndim == 1
    if single:
        words = words[None]
    n, w = words.shape
    s = containers_per_kmer(k)
    full = np.zeros((n, 2 * s), dtype=np.uint32)
    full[:, 2 * s - w:] = words
    u64 = (full[:, 0::2].astype(np.uint64) << np.uint64(32)) | full[:, 1::2].astype(np.uint64)
    le = u64.astype("<u8")
    out = le.view(f"|S{8 * s}").reshape(n)
    return out[0] if single else out


def disk_to_words(raw: np.ndarray, k: int) -> np.ndarray:
    """|S(8*S)[N] on-disk container bytes -> uint32[N, W]."""
    s = containers_per_kmer(k)
    w = words_per_kmer(k)
    u8 = np.frombuffer(np.ascontiguousarray(raw), dtype=np.uint8).reshape(-1, 8 * s)
    u64 = u8.view("<u8").astype(np.uint64).reshape(-1, s)
    full = np.empty((u64.shape[0], 2 * s), dtype=np.uint32)
    full[:, 0::2] = (u64 >> np.uint64(32)).astype(np.uint32)
    full[:, 1::2] = (u64 & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    return full[:, 2 * s - w:]


# ---------------------------------------------------------------------------
# convenience single-kmer helpers (host/test use)
# ---------------------------------------------------------------------------

def canonical_kmer(s: str) -> tuple[str, bool]:
    """(canonical string, flipped) — CanonicalKmer semantics."""
    canon, flipped = canonicalize_codes(string_to_codes(s))
    return codes_to_string(canon), bool(flipped)


_COMP_TABLE = str.maketrans("ACGTacgt", "TGCAtgca")


def revcomp(s: str) -> str:
    """Reverse complement; non-ACGT characters pass through unchanged
    (SequenceUtils.complement maps N->N and leaves unknowns as-is,
    SequenceUtils.java:61-86)."""
    return s.translate(_COMP_TABLE)[::-1]
