"""LZ4 frame and LZ4s block framing (a copy of qatzip_tpu/formats/lz4_fmt.py).

Matches the reference byte layout exactly (src/qatzip_internal.h:110-133 and
src/qatzip_lz4.c:62-231):

  frame header (15B): magic 0x184D2204 (u32 LE), FLG, BD, content size
                      (u64 LE, always present), header checksum byte
  FLG: version=01, block-indep=0, block-cksum=0, content-size=1,
       content-cksum=1, dict-id=0  -> 0x4C
  BD:  smallest max-block-size code covering the frame's largest block
       (code 4 = 64KB -> 0x40 for default sessions, matching the
       reference byte-for-byte; 5/6/7 for hw_buff_sz up to 4MB)
  block header (4B):  u32 LE block size; bit31 set => stored (uncompressed)
  frame footer (8B):  endmark 0x00000000 (u32) + XXH32 content checksum (u32)
"""
from __future__ import annotations

import struct
from typing import NamedTuple

from qatzip_tpu_torch.utils import checksum as _ck

LZ4_MAGIC = 0x184D2204
LZ4_MAGIC_SKIPPABLE = 0x184D2A50
LZ4_VERSION = 0x1
LZ4_MAGIC_SIZE = 4
LZ4_FD_SIZE = 11
LZ4_HEADER_SIZE = LZ4_MAGIC_SIZE + LZ4_FD_SIZE       # 15
LZ4_CHECKSUM_SIZE = 4
LZ4_ENDMARK_SIZE = 4
LZ4_FOOTER_SIZE = LZ4_CHECKSUM_SIZE + LZ4_ENDMARK_SIZE  # 8
LZ4_BLK_HEADER_SIZE = 4
LZ4_STOREDBLOCK_FLAG = 0x80000000
LZ4_MAX_BLK_SIZE_CODE = 0x4  # 64KB

_FLG = ((LZ4_VERSION & 0x3) << 6) | (0 << 5) | (0 << 4) | (1 << 3) | (1 << 2) | 0
# BD is derived per frame from the largest block it carries (_bd_for)


class LZ4FrameHeader(NamedTuple):
    content_size: int
    flg: int
    bd: int


def _bd_for(max_block: int) -> int:
    """BD byte with the smallest max-block-size code covering ``max_block``
    (codes 4..7 = 64KB/256KB/1MB/4MB).  The reference hardcodes code 4
    because its LZ4 frames always carry <=64KB blocks; sessions here allow
    hw_buff_sz beyond 64KB, and a frame whose blocks exceed the declared
    BD limit is rejected by conforming decoders (incl. our own streaming
    walker)."""
    for code, size in ((4, 64 << 10), (5, 256 << 10), (6, 1 << 20),
                       (7, 4 << 20)):
        if max_block <= size:
            return (code & 0x7) << 4
    return (7 & 0x7) << 4


def gen_lz4_frame_header(content_size: int,
                         max_block: int | None = None) -> bytes:
    """qzLZ4HeaderGen (reference src/qatzip_lz4.c:104-133).  ``max_block``
    is the largest block the frame will carry (defaults to content_size:
    single-chunk frames emit one block of the whole chunk)."""
    bd = _bd_for(content_size if max_block is None else max_block)
    body = struct.pack("<BBQ", _FLG, bd, content_size)
    hc = (_ck.xxh32(body, 0) >> 8) & 0xFF
    return struct.pack("<I", LZ4_MAGIC) + body + bytes([hc])


def gen_lz4_frame_footer(content_xxh32: int) -> bytes:
    """Endmark + content checksum (reference src/qatzip_lz4.c:134-144)."""
    return struct.pack("<II", 0, content_xxh32 & 0xFFFFFFFF)


def gen_lz4_block_header(block_size: int, stored: bool = False) -> bytes:
    sz = block_size | (LZ4_STOREDBLOCK_FLAG if stored else 0)
    return struct.pack("<I", sz)


def parse_lz4_frame_header(buf, off: int = 0, strict: bool = False):
    """Parse an LZ4 frame header.

    Returns (header_len, LZ4FrameHeader) or raises ValueError.  When strict,
    only the exact QATzip flag layout is accepted (qzVerifyLZ4FrameHeader,
    reference src/qatzip_lz4.c:62-102); otherwise any valid v1 frame header is
    parsed (content size optional, dict-id optional).
    """
    if len(buf) - off < 7:
        raise ValueError("lz4 frame header truncated")
    (magic,) = struct.unpack_from("<I", buf, off)
    if (magic & 0xFFFFFFF0) == LZ4_MAGIC_SKIPPABLE:
        raise ValueError("lz4 skippable frame")
    if magic != LZ4_MAGIC:
        raise ValueError(f"unknown lz4 magic 0x{magic:08x}")
    flg = buf[off + 4]
    bd = buf[off + 5]
    if (flg >> 6) & 0x3 != LZ4_VERSION:
        raise ValueError("unknown lz4 frame version")
    if strict and (flg & 0x1 or (flg >> 4) & 0x1 or not (flg >> 2) & 0x1
                   or not (flg >> 3) & 0x1):
        raise ValueError("unsupported lz4 frame flags for HW path")
    pos = off + 6
    need = 7 + (8 if (flg >> 3) & 0x1 else 0) + (4 if flg & 0x1 else 0)
    if len(buf) - off < need:
        raise ValueError("lz4 frame header truncated")
    content_size = -1
    if (flg >> 3) & 0x1:  # content size present
        (content_size,) = struct.unpack_from("<Q", buf, pos)
        pos += 8
    if flg & 0x1:  # dict id present
        pos += 4
    pos += 1  # header checksum
    return pos - off, LZ4FrameHeader(content_size, flg, bd)


def find_lz4_footer(buf, off: int, avail: int) -> int | None:
    """Walk block headers to the endmark (reference src/qatzip_lz4.c:145-180).

    ``off`` points at the frame header.  Returns the absolute offset of the
    8-byte footer (endmark+checksum), or None if the frame is truncated.
    """
    if avail < LZ4_HEADER_SIZE + LZ4_BLK_HEADER_SIZE + LZ4_FOOTER_SIZE:
        return None
    hlen, _ = parse_lz4_frame_header(buf, off)
    pos = off + hlen
    end = off + avail
    while pos + 4 <= end:
        (word,) = struct.unpack_from("<I", buf, pos)
        if word == 0:  # endmark
            return pos
        block_sz = word & 0x7FFFFFFF
        pos += LZ4_BLK_HEADER_SIZE + block_sz
    return None
