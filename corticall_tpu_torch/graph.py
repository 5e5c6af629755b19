"""Host-side multi-color de Bruijn graph over .ctx struct-of-arrays.

Replaces the reference's CortexGraph (mmap + per-kmer binary search + LRU
cache, CortexGraph.java:151-317) and CortexRecord edge accessors
(CortexRecord.java:117-289) with vectorized numpy over the whole record set.
Device-resident lookup lives in ops/hashtable.py; this module is the host
source of truth and the correctness oracle.

Edge byte layout (docs/ctx_spec.md Table 5-6, edges are stored in the
*canonical* orientation of the kmer):

    bit 7..4 : in-edges,  bit (7-b) set  <=> base b precedes the canonical kmer
    bit 3..0 : out-edges, bit b set      <=> base b follows the canonical kmer

For a kmer seen in walk orientation (flipped == walk string != canonical):

    fwd  : prev basemask = rev4(hi nibble), next basemask = lo nibble
    flip : prev basemask = rev4(lo nibble), next basemask = hi nibble

where rev4 reverses a 4-bit mask (base complement b -> 3-b reverses bit order).
"""

from __future__ import annotations

import numpy as np

from . import kmer as km
from .io import ctx as ctxio

_REV4 = np.array([int(f"{i:04b}"[::-1], 2) for i in range(16)], dtype=np.uint8)


def rev4(m):
    """Reverse the low 4 bits of each element (complement map on base masks)."""
    return _REV4[m]


def edges_to_masks(edges: np.ndarray, flipped) -> tuple[np.ndarray, np.ndarray]:
    """(prev_basemask, next_basemask) for records viewed in walk orientation.

    edges: uint8[...], flipped: bool[...] broadcastable.
    Bit b of a basemask = base b (A=0,C=1,G=2,T=3) is a neighbor.
    """
    hi = edges >> 4
    lo = edges & 0xF
    prev_mask = np.where(flipped, _REV4[lo], _REV4[hi])
    next_mask = np.where(flipped, hi, lo)
    return prev_mask, next_mask


def masks_to_edge_byte(in_basemask: int, out_basemask: int) -> int:
    """Inverse of edges_to_masks for the canonical orientation."""
    return (int(_REV4[in_basemask]) << 4) | int(out_basemask)


_EDGE_CHARS_LO = b"acgt"
_EDGE_CHARS_UP = b"ACGT"


def edge_byte_to_string(e: int) -> str:
    """Render one edge byte as the reference's 8-char display string
    (CortexRecord.java:117-140): positions 0-3 in-edges 'acgt', 4-7 out 'ACGT'."""
    hi, lo = e >> 4, e & 0xF
    s = bytearray(b"........")
    for b in range(4):
        if hi & (1 << (3 - b)):
            s[b] = _EDGE_CHARS_LO[b]
        if lo & (1 << b):
            s[b + 4] = _EDGE_CHARS_UP[b]
    return s.decode()


class CortexGraph:
    """Multi-color graph with O(log N) host lookup (sorted arrays + searchsorted).

    Mirrors the DeBruijnGraph interface surface of the reference
    (utils/io/graph/DeBruijnGraph.java:1-54) that the traversal engine and
    commands actually use.
    """

    def __init__(self, data: ctxio.CtxData, path=None):
        self.data = data
        self.path = path

    # -- construction ------------------------------------------------------
    @classmethod
    def load(cls, path) -> "CortexGraph":
        return cls(ctxio.read_ctx(path), path=path)

    def save(self, path) -> None:
        ctxio.write_ctx(path, self.data)

    # -- header ------------------------------------------------------------
    @property
    def header(self) -> ctxio.CtxHeader:
        return self.data.header

    @property
    def kmer_size(self) -> int:
        return self.data.header.kmer_size

    @property
    def num_colors(self) -> int:
        return self.data.header.num_colors

    @property
    def num_records(self) -> int:
        return self.data.num_records

    def sample_name(self, color: int) -> str:
        return self.data.header.colors[color].sample_name

    @property
    def sample_names(self) -> list[str]:
        return self.data.header.sample_names

    def color_for_sample(self, name: str) -> int:
        try:
            return self.data.header.sample_names.index(name)
        except ValueError:
            raise ValueError(
                f"sample {name!r} not in graph (samples: "
                f"{', '.join(self.data.header.sample_names)})") from None

    def colors_for_samples(self, names) -> list[int]:
        return [self.color_for_sample(n) for n in names]

    # -- record access -----------------------------------------------------
    @property
    def kmers(self) -> np.ndarray:
        return self.data.kmers

    @property
    def coverages(self) -> np.ndarray:
        return self.data.coverages

    @property
    def edges(self) -> np.ndarray:
        return self.data.edges

    def find_record(self, kmer) -> int:
        """Index of the record for a kmer (any orientation), or -1.

        Accepts a string, bytes, or uint8[k] codes.  Equivalent of
        CortexGraph.findRecord (binary search, CortexGraph.java:272-317) —
        here a numpy searchsorted over the raw big-endian key bytes.
        """
        if isinstance(kmer, str):
            # scalar fast path: canonical min == string min (code order is
            # ASCII order), pure-int packing, memoized per canonical string
            if len(kmer) != self.kmer_size:
                raise ValueError(
                    f"kmer length {len(kmer)} != graph kmer size {self.kmer_size}")
            kmer = kmer.upper()
            rc = km.revcomp(kmer)
            return self._find_canonical(kmer if kmer <= rc else rc)
        else:
            if isinstance(kmer, bytes):
                codes = km.string_to_codes(kmer)
            else:
                codes = np.asarray(kmer, dtype=np.uint8)
            if codes.shape[-1] != self.kmer_size:
                raise ValueError(
                    f"kmer length {codes.shape[-1]} != graph kmer size {self.kmer_size}"
                )
            canon, _ = km.canonicalize_codes(codes)
            key = km.words_to_bytes_be(km.pack_codes(canon), self.kmer_size)
        i = int(np.searchsorted(self.data.kmer_bytes, key))
        if i < self.num_records and self.data.kmer_bytes[i] == key:
            return i
        return -1

    def find_record_oriented(self, kmer: str) -> tuple[int, bool]:
        """(record index or -1, flipped) — one canonicalization, memoized."""
        kmer = kmer.upper()
        rc = km.revcomp(kmer)
        flipped = kmer > rc
        return self._find_canonical(rc if flipped else kmer), flipped

    def _find_canonical(self, canon_s: str) -> int:
        cache = self.__dict__.setdefault("_find_cache", {})
        r = cache.get(canon_s)
        if r is None:
            try:
                key = km.kmer_key_bytes(canon_s, self.kmer_size)
            except KeyError:
                raise ValueError(f"invalid nucleotide in {canon_s!r}")
            i = int(np.searchsorted(self.data.kmer_bytes, key))
            r = i if (i < self.num_records
                      and self.data.kmer_bytes[i] == key) else -1
            if len(cache) > 4_000_000:
                cache.clear()
            cache[canon_s] = r
        return r

    def find_records(self, canon_words: np.ndarray) -> np.ndarray:
        """Vectorized lookup: uint32[N, W] *canonical* packed kmers -> int64[N] (-1 miss)."""
        keys = km.words_to_bytes_be(canon_words, self.kmer_size)
        idx = np.searchsorted(self.data.kmer_bytes, keys)
        idx = np.minimum(idx, self.num_records - 1) if self.num_records else idx * 0
        if self.num_records == 0:
            return np.full(len(keys), -1)
        hit = self.data.kmer_bytes[idx] == keys
        return np.where(hit, idx, -1)

    def kmer_string(self, i: int) -> str:
        return km.words_row_to_string(self.data.kmers[i], self.kmer_size)

    def record_string(self, i: int, colors=None) -> str:
        """The reference's record display format: 'KMER cov.. edges..'
        (CortexRecord.java:166-194), the golden-test currency."""
        cs = range(self.num_colors) if colors is None else colors
        parts = [self.kmer_string(i)]
        parts += [str(int(self.data.coverages[i, c])) for c in cs]
        parts += [edge_byte_to_string(int(self.data.edges[i, c])) for c in cs]
        return " ".join(parts)

    def record_strings(self) -> list[str]:
        return [self.record_string(i) for i in range(self.num_records)]

    # -- degree / neighbor helpers (single record, host) -------------------
    def in_degree(self, i: int, color: int) -> int:
        return bin(int(self.data.edges[i, color]) >> 4).count("1")

    def out_degree(self, i: int, color: int) -> int:
        return bin(int(self.data.edges[i, color]) & 0xF).count("1")

    def coverage(self, i: int, color: int) -> int:
        return int(self.data.coverages[i, color])


def from_arrays(sample_names, kmer_size: int, kmers: np.ndarray, coverages: np.ndarray,
                edges: np.ndarray) -> CortexGraph:
    """Build a CortexGraph from already-sorted SoA arrays."""
    header = ctxio.CtxHeader.make(sample_names, kmer_size)
    kmer_bytes = km.words_to_bytes_be(kmers, kmer_size)
    return CortexGraph(ctxio.CtxData(header, kmers, coverages, edges, kmer_bytes))


def sort_records(kmers: np.ndarray, coverages: np.ndarray, edges: np.ndarray, kmer_size: int):
    """Sort SoA records by canonical kmer (the .ctx on-disk order)."""
    keys = km.words_to_bytes_be(kmers, kmer_size)
    order = np.argsort(keys, kind="stable")
    return kmers[order], coverages[order], edges[order]
