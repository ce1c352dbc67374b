"""RFC1950 zlib framing (reference src/qatzip_gzip.c:263-344); a copy of
qatzip_tpu/formats/zlib_fmt.py.

Header: CMF=0x78, FLG chosen so (CMF*256+FLG) % 31 == 0; the reference always
emits FLG=0x9C on generation and accepts any valid FLG on parse.
Footer: Adler-32 of the uncompressed data, big-endian.
"""
from __future__ import annotations

import struct

STD_ZLIB_HEADER_SIZE = 2
STD_ZLIB_FOOTER_SIZE = 4

ZLIB_HEADER_CMF = 0x78
ZLIB_HEADER_FLG_LOW = 0x01
ZLIB_HEADER_FLG_FAST = 0x5E
ZLIB_HEADER_FLG_DEFAULT = 0x9C
ZLIB_HEADER_FLG_BEST = 0xDA


def gen_zlib_header(level: int | None = None) -> bytes:
    """The reference HW path always writes 0x78 0x9C (src/qatzip_gzip.c:263-271)."""
    return bytes([ZLIB_HEADER_CMF, ZLIB_HEADER_FLG_DEFAULT])


def gen_zlib_footer(adler32: int) -> bytes:
    """Big-endian Adler32 (reference src/qatzip_gzip.c:273-281)."""
    return struct.pack(">I", adler32 & 0xFFFFFFFF)


def parse_zlib_footer(buf, off: int = 0) -> int:
    (adler,) = struct.unpack_from(">I", buf, off)
    return adler


def verify_zlib_header(buf, off: int = 0) -> bool:
    """qzVerifyZlibHeader (reference src/qatzip_gzip.c:304-344)."""
    if len(buf) - off < STD_ZLIB_HEADER_SIZE:
        return False
    cmf, flg = buf[off], buf[off + 1]
    if (cmf & 0x0F) != 8:        # CM must be deflate
        return False
    if (cmf >> 4) > 7:           # CINFO window size
        return False
    if (flg & 0x20) >> 5 != 0:   # FDICT unsupported
        return False
    return (cmf * 256 + flg) % 31 == 0
