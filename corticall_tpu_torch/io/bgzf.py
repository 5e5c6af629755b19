"""BGZF (blocked gzip) reader/writer with virtual offsets.

Equivalent of htsjdk's BlockCompressedInput/OutputStream as used by the links
random-access path (CortexLinksRandomAccess.java, IndexLinks.java).  Virtual
offset = (compressed_block_offset << 16) | offset_within_block.
"""

from __future__ import annotations

import struct
import zlib

_BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000")

_MAX_BLOCK = 65280  # uncompressed bytes per block (htsjdk default payload)


class BgzfWriter:
    def __init__(self, path, compresslevel: int = 6):
        self.f = open(path, "wb")
        self.buf = bytearray()
        self.coffset = 0
        self.level = compresslevel

    def tell(self) -> int:
        """Virtual offset of the next byte to be written."""
        return (self.coffset << 16) | len(self.buf)

    def write(self, data: bytes) -> None:
        if isinstance(data, str):
            data = data.encode()
        self.buf.extend(data)
        while len(self.buf) >= _MAX_BLOCK:
            self._flush_block(self.buf[:_MAX_BLOCK])
            del self.buf[:_MAX_BLOCK]

    def _flush_block(self, payload: bytes) -> None:
        co = zlib.compressobj(self.level, zlib.DEFLATED, -15)
        comp = co.compress(bytes(payload)) + co.flush()
        bsize = len(comp) + 25 + 1  # header(12) + XLEN extra(6) + data + crc(4) + isize(4)
        header = struct.pack(
            "<BBBBIBBHBBHH",
            0x1F, 0x8B, 8, 4,        # gzip magic, deflate, FEXTRA
            0, 0, 0xFF,              # mtime, xfl, os
            6,                       # XLEN
            66, 67, 2,               # 'B','C', SLEN=2
            bsize - 1)
        crc = zlib.crc32(bytes(payload)) & 0xFFFFFFFF
        block = header + comp + struct.pack("<II", crc, len(payload))
        self.f.write(block)
        self.coffset += len(block)

    def close(self) -> None:
        if self.buf:
            self._flush_block(bytes(self.buf))
            self.buf.clear()
        self.f.write(_BGZF_EOF)
        self.f.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


class BgzfReader:
    def __init__(self, path):
        self.f = open(path, "rb")
        self._block_cache: dict[int, bytes] = {}
        self._block_sizes: dict[int, int] = {}

    def _read_block(self, coffset: int) -> tuple[bytes, int]:
        """-> (uncompressed payload, compressed block length)."""
        self.f.seek(coffset)
        header = self.f.read(18)
        if len(header) < 18:
            return b"", 0
        xlen = struct.unpack("<H", header[10:12])[0]
        # find BSIZE in the extra field
        extra = header[12:18] + self.f.read(max(0, xlen - 6))
        bsize = None
        i = 0
        while i + 4 <= len(extra):
            si1, si2, slen = extra[i], extra[i + 1], struct.unpack("<H", extra[i + 2:i + 4])[0]
            if si1 == 66 and si2 == 67:
                bsize = struct.unpack("<H", extra[i + 4:i + 6])[0] + 1
                break
            i += 4 + slen
        if bsize is None:
            raise ValueError("not a BGZF block (missing BC extra field)")
        data_len = bsize - 12 - xlen - 8
        self.f.seek(coffset + 12 + xlen)
        comp = self.f.read(data_len)
        payload = zlib.decompress(comp, -15)
        return payload, bsize

    def read_at(self, virtual_offset: int, n: int) -> bytes:
        coffset = virtual_offset >> 16
        uoffset = virtual_offset & 0xFFFF
        out = bytearray()
        while len(out) < n:
            if coffset not in self._block_cache:
                payload, bsize = self._read_block(coffset)
                if bsize == 0:
                    break
                self._block_cache[coffset] = payload
                self._block_sizes[coffset] = bsize
            payload = self._block_cache[coffset]
            if not payload:          # EOF block
                break
            chunk = payload[uoffset:uoffset + (n - len(out))]
            out.extend(chunk)
            coffset += self._block_sizes[coffset]
            uoffset = 0
        return bytes(out)

    def close(self):
        self.f.close()
