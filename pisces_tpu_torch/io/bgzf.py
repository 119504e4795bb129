"""BGZF block codec in Python (CPython's zlib).

The reference routes every BAM/gz byte through a native zlib wrapper
(src/lib/Common.IO/FileCompression.cs:10-35, BgzfCommon.cs). This module is
the streaming codec of the Python read flow and the BAM writer; the
threaded deflater of large buffers is io/native.bgzf_compress_parallel,
which cuts blocks at the same 0xFF00-byte boundaries.
"""
from __future__ import annotations

import struct
import zlib
from typing import Iterator, Tuple

BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000")


def iter_blocks(data: bytes, start: int = 0) -> Iterator[Tuple[int, int, bytes]]:
    """Yield (file_offset, block_length, inflated_bytes) per BGZF block,
    optionally starting at a block boundary `start` (e.g. from a .bai
    virtual offset's coffset)."""
    off = start
    n = len(data)
    while off < n:
        if data[off:off + 2] != b"\x1f\x8b":
            raise ValueError(f"bad gzip magic at offset {off}")
        xlen = struct.unpack_from("<H", data, off + 10)[0]
        extra = data[off + 12: off + 12 + xlen]
        bsize = None
        p = 0
        while p + 4 <= len(extra):
            si1, si2, slen = extra[p], extra[p + 1], struct.unpack_from("<H", extra, p + 2)[0]
            if si1 == 66 and si2 == 67 and slen == 2:
                bsize = struct.unpack_from("<H", extra, p + 4)[0] + 1
                break
            p += 4 + slen
        if bsize is None:
            raise ValueError(f"missing BGZF BC subfield at offset {off}")
        cdata_start = off + 12 + xlen
        cdata_len = bsize - xlen - 19
        inflated = zlib.decompress(data[cdata_start:cdata_start + cdata_len], -15)
        yield off, bsize, inflated
        off += bsize


def decompress(data: bytes) -> bytes:
    """Inflate an entire BGZF byte string."""
    return b"".join(chunk for _, _, chunk in iter_blocks(data))


def _block(chunk: bytes, level: int) -> bytes:
    """One BGZF block holding `chunk` (at most 0xFF00 bytes)."""
    co = zlib.compressobj(level, zlib.DEFLATED, -15)
    cdata = co.compress(chunk) + co.flush()
    return (b"\x1f\x8b\x08\x04\x00\x00\x00\x00\x00\xff"
            + struct.pack("<H", 6) + b"BC"
            + struct.pack("<HH", 2, len(cdata) + 25)
            + cdata
            + struct.pack("<II", zlib.crc32(chunk), len(chunk)))


class BgzfWriter:
    """Streaming BGZF deflater (0xFF00-byte payload per block) exposing
    virtual offsets ((block file offset << 16) | offset within block), so
    a caller can build a .bai while writing (the BamWriter + BamIndex
    coupling of the reference's Alignment.IO)."""

    def __init__(self, fileobj, level: int = 6):
        self._f = fileobj
        self._level = level
        self._buf = bytearray()
        self._file_off = 0

    def tell_virtual(self) -> int:
        return (self._file_off << 16) | len(self._buf)

    def _flush_block(self, chunk: bytes) -> None:
        block = _block(chunk, self._level)
        self._f.write(block)
        self._file_off += len(block)

    def write(self, data: bytes) -> None:
        self._buf.extend(data)
        while len(self._buf) >= 0xFF00:
            self._flush_block(bytes(self._buf[:0xFF00]))
            del self._buf[:0xFF00]

    def close(self) -> None:
        if self._buf:
            self._flush_block(bytes(self._buf))
            self._buf.clear()
        self._f.write(BGZF_EOF)
        self._file_off += len(BGZF_EOF)


def compress_with_offsets(data: bytes, level: int = 6):
    """Deflate `data` into BGZF blocks of 0xFF00 bytes each plus the EOF
    block. Returns (compressed bytes, int64 file offset of each block and
    of the EOF block): a byte at uncompressed offset u has the virtual
    offset (offsets[u // 0xFF00] << 16) | (u % 0xFF00), the contract of
    io/native.bgzf_compress_parallel."""
    import numpy as np
    out = []
    offsets = [0]
    for i in range(0, len(data), 0xFF00):
        out.append(_block(data[i:i + 0xFF00], level))
        offsets.append(offsets[-1] + len(out[-1]))
    out.append(BGZF_EOF)
    return b"".join(out), np.array(offsets, dtype=np.int64)
