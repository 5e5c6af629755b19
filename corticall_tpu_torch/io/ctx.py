"""Cortex graph (.ctx) v6 binary format reader/writer.

Implements docs/ctx_spec.md exactly (the authoritative spec shipped with the
reference).  Parity targets: CortexGraph.java:66-168 (header parse),
CortexRecord.java:291-334 (kmer codec), CortexGraphWriter.java:31-138 (writer,
including the hard-coded 16-byte long-double error-rate field that makes our
output diff-identical to McCortex's).

Unlike the reference (one record object per row, LRU-cached), records are
parsed in bulk into struct-of-arrays numpy tensors ready for device upload.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

import numpy as np

from .. import kmer as km

_MAGIC = b"CORTEX"

# McCortex hard-codes a 0.01 error rate as a 16-byte x87 long double; the
# reference writes these exact bytes for diff-compatibility
# (CortexGraphWriter.java:69-77) and we do the same.
_ERROR_RATE_BYTES = bytes(
    [0, 0xD8, 0xA3, 0x70, 0x3D, 0x0A, 0xD7, 0xA3, 0xF8, 0x3F, 0, 0, 0, 0, 0, 0]
)


@dataclass
class CtxColor:
    sample_name: str = ""
    mean_read_length: int = 0
    total_sequence: int = 0
    tip_clipping_applied: bool = False
    low_covg_supernodes_removed: bool = False
    low_covg_kmers_removed: bool = False
    cleaned_against_graph: bool = False
    low_cov_supernodes_threshold: int = 0
    low_cov_kmer_threshold: int = 0
    cleaned_against_graph_name: str = ""


@dataclass
class CtxHeader:
    version: int = 6
    kmer_size: int = 0
    kmer_containers: int = 0  # uint64 containers per kmer ("kmerBits" in the reference)
    colors: list[CtxColor] = field(default_factory=list)

    @property
    def num_colors(self) -> int:
        return len(self.colors)

    @property
    def record_size(self) -> int:
        return 8 * self.kmer_containers + 5 * self.num_colors

    @property
    def sample_names(self) -> list[str]:
        return [c.sample_name for c in self.colors]

    @staticmethod
    def make(sample_names, kmer_size: int) -> "CtxHeader":
        return CtxHeader(
            version=6,
            kmer_size=kmer_size,
            kmer_containers=km.containers_per_kmer(kmer_size),
            colors=[CtxColor(sample_name=s) for s in sample_names],
        )


@dataclass
class CtxData:
    """Parsed .ctx body as struct-of-arrays (records sorted by canonical kmer)."""

    header: CtxHeader
    kmers: np.ndarray       # uint32[N, W] packed canonical kmers (see kmer.py)
    coverages: np.ndarray   # uint32[N, C]
    edges: np.ndarray       # uint8[N, C]
    kmer_bytes: np.ndarray  # |S(8*S)[N] raw big-endian container bytes (searchsorted key)

    @property
    def num_records(self) -> int:
        return self.kmers.shape[0]


def _read_exact(f, n: int) -> bytes:
    b = f.read(n)
    if len(b) != n:
        raise ValueError("truncated .ctx file")
    return b


def read_header(f) -> CtxHeader:
    if _read_exact(f, 6) != _MAGIC:
        raise ValueError("not a Cortex graph (missing CORTEX signature)")
    version, kmer_size, kmer_containers, num_colors = struct.unpack(
        "<IIII", _read_exact(f, 16)
    )
    if version != 6:
        raise ValueError(f"unsupported .ctx version {version}")
    h = CtxHeader(version, kmer_size, kmer_containers, [CtxColor() for _ in range(num_colors)])
    mrl = struct.unpack(f"<{num_colors}I", _read_exact(f, 4 * num_colors))
    tot = struct.unpack(f"<{num_colors}Q", _read_exact(f, 8 * num_colors))
    for c, color in enumerate(h.colors):
        color.mean_read_length = mrl[c]
        color.total_sequence = tot[c]
    for color in h.colors:
        (ln,) = struct.unpack("<I", _read_exact(f, 4))
        name = _read_exact(f, ln)
        color.sample_name = name.split(b"\x00")[0].decode()
    _read_exact(f, 16 * num_colors)  # error rates (long doubles), unused
    for color in h.colors:
        tip, sup, kmr, cln = struct.unpack("<????", _read_exact(f, 4))
        st, kt, ln = struct.unpack("<III", _read_exact(f, 12))
        gname = _read_exact(f, ln)
        color.tip_clipping_applied = tip
        color.low_covg_supernodes_removed = sup
        color.low_covg_kmers_removed = kmr
        color.cleaned_against_graph = cln
        color.low_cov_supernodes_threshold = st
        color.low_cov_kmer_threshold = kt
        color.cleaned_against_graph_name = gname.split(b"\x00")[0].decode()
    if _read_exact(f, 6) != _MAGIC:
        raise ValueError("missing CORTEX header trailer")
    return h


def record_dtype(header: CtxHeader) -> np.dtype:
    s, c = header.kmer_containers, header.num_colors
    return np.dtype(
        [("kmer", f"|S{8 * s}"), ("cov", "<u4", (c,)), ("edges", "u1", (c,))]
    )


def read_ctx(path) -> CtxData:
    with open(path, "rb") as f:
        header = read_header(f)
        body = f.read()
    dt = record_dtype(header)
    if len(body) % dt.itemsize != 0:
        raise ValueError("corrupt .ctx: body size not a multiple of record size")
    recs = np.frombuffer(body, dtype=dt)
    kmers = km.disk_to_words(recs["kmer"], header.kmer_size)
    kmer_bytes = km.words_to_bytes_be(kmers, header.kmer_size)
    cov = recs["cov"].astype(np.uint32).reshape(-1, header.num_colors)
    edges = recs["edges"].reshape(-1, header.num_colors).copy()
    return CtxData(header, kmers, cov, edges, kmer_bytes)


def ctx_num_records(path) -> int:
    """Record count from the file size — no record bytes touched."""
    import os as _os
    with open(path, "rb") as f:
        header = read_header(f)
        body = _os.fstat(f.fileno()).st_size - f.tell()
    dt = record_dtype(header)
    if body % dt.itemsize != 0:
        raise ValueError("corrupt .ctx: body size not a multiple of record size")
    return body // dt.itemsize


def read_ctx_range(path, start: int, count: int) -> CtxData:
    """Byte-range read of records [start, start+count) — the per-host loading
    primitive for multi-host sharding (SURVEY §2.4 comm-backend row: no host
    materializes the whole graph; each seeks straight to its slice).  The
    record section is fixed-stride (8*containers + 5*colors bytes per record,
    CortexGraph.java:148), so the slice is one seek + one read."""
    with open(path, "rb") as f:
        header = read_header(f)
        dt = record_dtype(header)
        f.seek(start * dt.itemsize, 1)
        body = f.read(count * dt.itemsize)
    if len(body) != count * dt.itemsize:
        raise ValueError("read_ctx_range past end of record section")
    recs = np.frombuffer(body, dtype=dt)
    kmers = km.disk_to_words(recs["kmer"], header.kmer_size)
    kmer_bytes = km.words_to_bytes_be(kmers, header.kmer_size)
    cov = recs["cov"].astype(np.uint32).reshape(-1, header.num_colors)
    edges = recs["edges"].reshape(-1, header.num_colors).copy()
    return CtxData(header, kmers, cov, edges, kmer_bytes)


def header_bytes(header: CtxHeader) -> bytes:
    out = [_MAGIC]
    out.append(
        struct.pack(
            "<IIII",
            header.version,
            header.kmer_size,
            header.kmer_containers,
            header.num_colors,
        )
    )
    for c in header.colors:
        out.append(struct.pack("<I", c.mean_read_length))
    for c in header.colors:
        out.append(struct.pack("<Q", c.total_sequence))
    for c in header.colors:
        name = c.sample_name.encode()
        out.append(struct.pack("<I", len(name)) + name)
    for _ in header.colors:
        out.append(_ERROR_RATE_BYTES)
    for c in header.colors:
        out.append(
            struct.pack(
                "<????",
                c.tip_clipping_applied,
                c.low_covg_supernodes_removed,
                c.low_covg_kmers_removed,
                c.cleaned_against_graph,
            )
        )
        gname = c.cleaned_against_graph_name.encode()
        out.append(struct.pack("<III", c.low_cov_supernodes_threshold, c.low_cov_kmer_threshold, len(gname)))
        out.append(gname)
    out.append(_MAGIC)
    return b"".join(out)


def records_bytes(header: CtxHeader, kmers: np.ndarray, coverages: np.ndarray, edges: np.ndarray) -> bytes:
    """Serialize SoA arrays to the record section (records must be pre-sorted)."""
    n = kmers.shape[0]
    dt = record_dtype(header)
    recs = np.zeros(n, dtype=dt)
    recs["kmer"] = km.words_to_disk(kmers, header.kmer_size)
    recs["cov"] = coverages.reshape(n, header.num_colors)
    recs["edges"] = edges.reshape(n, header.num_colors)
    return recs.tobytes()


def write_ctx(path, data: CtxData) -> None:
    with open(path, "wb") as f:
        f.write(header_bytes(data.header))
        f.write(records_bytes(data.header, data.kmers, data.coverages, data.edges))
