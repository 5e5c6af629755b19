"""Minimal BAM reading over our BGZF layer (htsjdk stand-in for the
kmer->read index, commands/index/alignedbam/).

Parses headers and alignment records sequentially while tracking virtual
offsets, and fetches single records at a virtual offset.
"""

from __future__ import annotations

import struct

from . import bgzf

_SEQ_CODES = "=ACMGRSVTWYHKDBN"


class _BgzfStream:
    """Sequential reader over BGZF blocks with virtual-offset tracking."""

    def __init__(self, path):
        self.r = bgzf.BgzfReader(path)
        self.coffset = 0
        self.uoffset = 0
        self._payload, self._bsize = self.r._read_block(0)
        self.r._block_cache[0] = self._payload
        self.r._block_sizes[0] = self._bsize

    def tell(self) -> int:
        return (self.coffset << 16) | self.uoffset

    def read(self, n: int) -> bytes:
        out = bytearray()
        while len(out) < n:
            if self.uoffset >= len(self._payload):
                self.coffset += self._bsize
                self.uoffset = 0
                payload, bsize = self.r._read_block(self.coffset)
                if bsize == 0 or not payload:
                    break
                self.r._block_cache[self.coffset] = payload
                self.r._block_sizes[self.coffset] = bsize
                self._payload, self._bsize = payload, bsize
            take = min(n - len(out), len(self._payload) - self.uoffset)
            out.extend(self._payload[self.uoffset:self.uoffset + take])
            self.uoffset += take
        return bytes(out)


def _parse_record(data: bytes, refs: list) -> dict:
    (ref_id, pos, l_read_name, mapq, _bin, n_cigar, flag, l_seq,
     _next_ref, _next_pos, _tlen) = struct.unpack("<iiBBHHHiiii", data[:32])
    off = 32
    name = data[off:off + l_read_name - 1].decode()
    off += l_read_name
    off += 4 * n_cigar
    nbytes = (l_seq + 1) // 2
    seq_raw = data[off:off + nbytes]
    seq = []
    for i in range(l_seq):
        b = seq_raw[i // 2]
        code = (b >> 4) if i % 2 == 0 else (b & 0xF)
        seq.append(_SEQ_CODES[code])
    return {
        "name": name, "flag": flag, "ref": refs[ref_id] if ref_id >= 0 else "*",
        "pos": pos + 1, "mapq": mapq, "seq": "".join(seq),
    }


class BamReader:
    def __init__(self, path):
        self.path = str(path)
        self._stream = _BgzfStream(self.path)
        magic = self._stream.read(4)
        if magic != b"BAM\x01":
            raise ValueError(f"not a BAM file: {path}")
        (l_text,) = struct.unpack("<i", self._stream.read(4))
        self.header_text = self._stream.read(l_text).decode(errors="replace")
        (n_ref,) = struct.unpack("<i", self._stream.read(4))
        self.refs = []
        for _ in range(n_ref):
            (l_name,) = struct.unpack("<i", self._stream.read(4))
            name = self._stream.read(l_name)[:-1].decode()
            (l_ref,) = struct.unpack("<i", self._stream.read(4))
            self.refs.append(name)
        self._random = bgzf.BgzfReader(self.path)

    def __iter__(self):
        """Yield (virtual_offset_start, virtual_offset_end, record)."""
        while True:
            vo = self._stream.tell()
            raw = self._stream.read(4)
            if len(raw) < 4:
                return
            (block_size,) = struct.unpack("<i", raw)
            data = self._stream.read(block_size)
            if len(data) < block_size:
                return
            yield vo, self._stream.tell(), _parse_record(data, self.refs)

    def record_at(self, virtual_offset: int) -> dict:
        raw = self._random.read_at(virtual_offset, 4)
        (block_size,) = struct.unpack("<i", raw)
        data = self._random.read_at(_advance(virtual_offset, 4, self._random),
                                    block_size)
        return _parse_record(data, self.refs)


def _advance(vo: int, n: int, reader: bgzf.BgzfReader) -> int:
    """Virtual offset n payload bytes past vo."""
    coffset = vo >> 16
    uoffset = (vo & 0xFFFF) + n
    while True:
        if coffset not in reader._block_cache:
            payload, bsize = reader._read_block(coffset)
            reader._block_cache[coffset] = payload
            reader._block_sizes[coffset] = bsize
        plen = len(reader._block_cache[coffset])
        if uoffset < plen or plen == 0:
            return (coffset << 16) | uoffset
        uoffset -= plen
        coffset += reader._block_sizes[coffset]


def write_bam(path, refs: list, records: list) -> None:
    """Write a minimal unaligned/aligned BAM (testing + CollectReads output).

    refs: [(name, length)]; records: dicts with name, seq, optional flag/ref/pos.
    """
    w = bgzf.BgzfWriter(path)
    header_text = "@HD\tVN:1.6\n" + "".join(
        f"@SQ\tSN:{n}\tLN:{l}\n" for n, l in refs)
    w.write(b"BAM\x01")
    w.write(struct.pack("<i", len(header_text)))
    w.write(header_text.encode())
    w.write(struct.pack("<i", len(refs)))
    for name, length in refs:
        w.write(struct.pack("<i", len(name) + 1))
        w.write(name.encode() + b"\x00")
        w.write(struct.pack("<i", length))
    ref_ids = {n: i for i, (n, _) in enumerate(refs)}
    for rec in records:
        name = rec["name"].encode() + b"\x00"
        seq = rec["seq"]
        nbytes = (len(seq) + 1) // 2
        packed = bytearray(nbytes)
        for i, c in enumerate(seq):
            code = _SEQ_CODES.index(c) if c in _SEQ_CODES else 15
            packed[i // 2] |= code << (4 if i % 2 == 0 else 0)
        qual = b"\xff" * len(seq)
        ref_id = ref_ids.get(rec.get("ref", "*"), -1)
        pos = rec.get("pos", 0) - 1
        body = struct.pack("<iiBBHHHiiii", ref_id, pos, len(name),
                           rec.get("mapq", 0), 0, 0, rec.get("flag", 4),
                           len(seq), -1, -1, 0)
        body += name + bytes(packed) + qual
        w.write(struct.pack("<i", len(body)))
        w.write(body)
    w.close()
