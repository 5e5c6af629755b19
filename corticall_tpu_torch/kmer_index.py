"""Kmer -> BAM chunk index (commands/index/alignedbam/: IndexBam, KmerIndex,
QueryIndex, PrintIndex).

Binary sidecar `.k{N}index` next to a BAM: "KMERINDEX" magic, int32 k, int32
kmerBits (big-endian), then sorted records of (binary kmer in the .ctx
container layout, int64 chunk start, int64 chunk end) — virtual offsets into
the BAM.  Enables read retrieval by kmer.
"""

from __future__ import annotations

import struct

import numpy as np

from . import kmer as km
from .io import bam as bamio

MAGIC = b"KMERINDEX"


def index_path(bam_path: str, k: int) -> str:
    import re
    return re.sub(r"\.bam$", f".k{k}index", str(bam_path))


def index_bam(bam_path, k: int) -> str:
    """Build the kmer index for a BAM (IndexBam.java)."""
    reader = bamio.BamReader(bam_path)
    table: dict[str, set] = {}
    for vo_start, vo_end, rec in reader:
        seq = rec["seq"].upper()
        for i in range(len(seq) - k + 1):
            sk = seq[i:i + k]
            if any(c not in "ACGT" for c in sk):
                continue
            ck = min(sk, km.revcomp(sk))
            table.setdefault(ck, set()).add((vo_start, vo_end))

    out = index_path(bam_path, k)
    with open(out, "wb") as f:
        f.write(MAGIC)
        f.write(struct.pack(">ii", k, km.containers_per_kmer(k)))
        for ck in sorted(table):
            words = km.pack_codes(km.string_to_codes(ck))
            disk = km.words_to_disk(words[None, :], k).tobytes()
            for start, end in sorted(table[ck]):
                f.write(disk)
                f.write(struct.pack(">qq", start, end))
    return out


class KmerIndexFile:
    def __init__(self, bam_path, k: int):
        self.bam_path = str(bam_path)
        self.k = k
        path = index_path(bam_path, k)
        with open(path, "rb") as f:
            if f.read(9) != MAGIC:
                raise ValueError(f"not a kmer index: {path}")
            ksize, kbits = struct.unpack(">ii", f.read(8))
            if ksize != k:
                raise ValueError(f"index is for k={ksize}, requested {k}")
            body = f.read()
        s = 8 * kbits
        rec = np.dtype([("kmer", f"|S{s}"), ("start", ">i8"), ("end", ">i8")])
        self.records = np.frombuffer(body, dtype=rec)
        words = km.disk_to_words(self.records["kmer"], k)
        self.keys = km.words_to_bytes_be(words, k)

    def __len__(self) -> int:
        return len(self.records)

    def find(self, kmer_str: str) -> list:
        """[(chunk_start, chunk_end)] virtual-offset pairs for a kmer."""
        canon, _ = km.canonical_kmer(kmer_str)
        key = km.words_to_bytes_be(km.pack_codes(km.string_to_codes(canon)), self.k)
        lo = int(np.searchsorted(self.keys, key, side="left"))
        hi = int(np.searchsorted(self.keys, key, side="right"))
        return [(int(self.records["start"][i]), int(self.records["end"][i]))
                for i in range(lo, hi)]

    def query_reads(self, kmer_str: str) -> list:
        """Fetch the BAM records containing a kmer (QueryIndex.java)."""
        reader = bamio.BamReader(self.bam_path)
        return [reader.record_at(start) for start, _ in self.find(kmer_str)]
