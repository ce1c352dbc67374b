"""QATzip's gzip-ext framing, written and read without the program.

A frozen copy of the layout in ``qatzip_tpu_torch/formats/gzip_fmt.py``
(QATzip ``src/qatzip_gzip.c:86-160``).  Every chunk is one gzip member:

  header (24 B): 1f 8b 08, FLG 0x04 (FEXTRA), mtime 0, XFL 0, OS 255,
                 XLEN 12, then the extra field 'Q' 'Z', 8 (u16 LE),
                 src_sz (u32 LE), dest_sz (u32 LE)
  payload:       dest_sz bytes of raw deflate
  footer (8 B):  CRC-32 of the chunk (u32 LE), ISIZE (u32 LE)
"""
from __future__ import annotations

import struct
import zlib

HEADER = 24
FOOTER = 8
_HEAD = struct.Struct("<BBBBIBBHBBHII")


def header(src_sz: int, dest_sz: int) -> bytes:
    return _HEAD.pack(0x1F, 0x8B, 8, 0x04, 0, 0, 255, 12, ord("Q"),
                      ord("Z"), 8, src_sz, dest_sz)


def member(chunk: bytes, payload: bytes) -> bytes:
    """One gzip-ext member of ``chunk`` compressed as ``payload``."""
    return (header(len(chunk), len(payload)) + payload
            + struct.pack("<II", zlib.crc32(chunk), len(chunk) & 0xFFFFFFFF))


def deflate_l1(chunk: bytes) -> bytes:
    """``chunk`` as one raw deflate stream by zlib at level 1 (the
    reference software path's output)."""
    co = zlib.compressobj(1, zlib.DEFLATED, -15)
    return co.compress(chunk) + co.flush()


def write(chunks) -> bytes:
    """A gzip-ext stream of ``chunks``, each a zlib level-1 member."""
    return b"".join(member(c, deflate_l1(c)) for c in chunks)


class FormatError(ValueError):
    """The stream breaks the gzip-ext layout or one of its checks."""


def read(stream) -> bytes:
    """Decode a gzip-ext stream member by member with zlib, checking each
    header field, that each payload is exactly one whole deflate stream of
    ``src_sz`` bytes, and each CRC-32 and ISIZE.  Returns the bytes."""
    buf = memoryview(stream)
    out = []
    pos = 0
    k = 0
    while pos < len(buf):
        if len(buf) - pos < HEADER + FOOTER:
            raise FormatError(f"member {k}: truncated at byte {pos}")
        (id1, id2, cm, flg, _mtime, xfl, os_b, xlen, s1, s2, x2len, src_sz,
         dest_sz) = _HEAD.unpack_from(buf, pos)
        if (id1, id2, cm, flg, xlen, s1, s2, x2len) != (
                0x1F, 0x8B, 8, 0x04, 12, ord("Q"), ord("Z"), 8):
            raise FormatError(f"member {k}: not a gzip-ext header")
        if os_b != 255 or xfl not in (0, 2, 4):
            raise FormatError(f"member {k}: XFL {xfl} OS {os_b}")
        body = pos + HEADER
        end = body + dest_sz
        if end + FOOTER > len(buf):
            raise FormatError(f"member {k}: payload runs past the stream")
        do = zlib.decompressobj(-15)
        try:
            data = do.decompress(buf[body:end]) + do.flush()
        except zlib.error as exc:
            raise FormatError(f"member {k}: {exc}") from exc
        if not do.eof or do.unused_data:
            raise FormatError(f"member {k}: payload is not one whole deflate "
                              "stream of dest_sz bytes")
        crc, isize = struct.unpack_from("<II", buf, end)
        if len(data) != src_sz or isize != src_sz & 0xFFFFFFFF:
            raise FormatError(f"member {k}: {len(data)} bytes, src_sz "
                              f"{src_sz}, ISIZE {isize}")
        if crc != zlib.crc32(data):
            raise FormatError(f"member {k}: CRC-32 mismatch")
        out.append(data)
        pos = end + FOOTER
        k += 1
    return b"".join(out)
