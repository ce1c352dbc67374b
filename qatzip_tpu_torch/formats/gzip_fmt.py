"""RFC1952 gzip and QATzip gzipext framing (a copy of
qatzip_tpu/formats/gzip_fmt.py).

Byte layouts follow the reference structs (src/qatzip_internal.h:422-460) and
generators (src/qatzip_gzip.c:86-160):

  std gzip header (10B):  1f 8b 08 flag mtime[4] xfl os
  gzipext header (24B):   std header with FLG=0x04 (FEXTRA), mtime=0, xfl=0,
                          os=255, then x_len=12, extra field:
                          'Q' 'Z' x2_len=8 src_sz(u32 LE) dest_sz(u32 LE)
  std gzip footer (8B):   crc32(u32 LE) isize(u32 LE)
"""
from __future__ import annotations

import struct
from typing import NamedTuple

STD_GZIP_HEADER_SIZE = 10
STD_GZIP_FOOTER_SIZE = 8
GZIPEXT_HEADER_SIZE = 24  # 10 + 2 (x_len) + 12 (extra field)

_GZ_ID1 = 0x1F
_GZ_ID2 = 0x8B
_GZ_CM_DEFLATE = 8


class GzipExtHeader(NamedTuple):
    src_sz: int   # uncompressed chunk size
    dest_sz: int  # compressed deflate payload size (no header/footer)


def gen_std_gzip_header(mtime: int = 0, os_byte: int = 255) -> bytes:
    """Standard gzip member header, FLG=0 (reference src/qatzip_gzip.c:119-137)."""
    return struct.pack("<BBBBIBB", _GZ_ID1, _GZ_ID2, _GZ_CM_DEFLATE, 0x00,
                       mtime & 0xFFFFFFFF, 0, os_byte)


def gen_gzipext_header(src_sz: int, dest_sz: int) -> bytes:
    """QATzip extended gzip header (reference src/qatzip_gzip.c:86-117)."""
    return (
        struct.pack("<BBBBIBB", _GZ_ID1, _GZ_ID2, _GZ_CM_DEFLATE, 0x04, 0, 0, 255)
        + struct.pack("<H", 12)                      # x_len = sizeof(extra)
        + b"QZ"
        + struct.pack("<H", 8)                       # x2_len = sizeof(qz_e)
        + struct.pack("<II", src_sz, dest_sz)
    )


def gen_std_gzip_footer(crc32: int, isize: int) -> bytes:
    """crc32 + input size mod 2^32 (reference src/qatzip_gzip.c:228-236)."""
    return struct.pack("<II", crc32 & 0xFFFFFFFF, isize & 0xFFFFFFFF)


def parse_std_gzip_footer(buf: bytes | memoryview, off: int = 0) -> tuple[int, int]:
    crc32, isize = struct.unpack_from("<II", buf, off)
    return crc32, isize


def is_std_gzip_header(buf, off: int = 0) -> bool:
    """True if bytes at ``off`` look like a plain (FLG=0) gzip member header."""
    if len(buf) - off < STD_GZIP_HEADER_SIZE:
        return False
    return (buf[off] == _GZ_ID1 and buf[off + 1] == _GZ_ID2
            and buf[off + 2] == _GZ_CM_DEFLATE and buf[off + 3] == 0x00)


def parse_gzipext_header(buf: bytes | memoryview, off: int = 0) -> GzipExtHeader | None:
    """Parse + validate a gzipext header; None if it isn't one.

    Validation matches qzGzipHeaderExt (reference src/qatzip_gzip.c:237-268):
    id bytes, CM, FLG=0x04, xfl in {0,2,4}, os=255, x_len=12, 'QZ', x2_len=8.
    """
    if len(buf) - off < GZIPEXT_HEADER_SIZE:
        return None
    (id1, id2, cm, flag, _mtime, xfl, os_b, x_len, st1, st2, x2_len, src_sz,
     dest_sz) = struct.unpack_from("<BBBBIBBHBBHII", buf, off)
    if (id1 != _GZ_ID1 or id2 != _GZ_ID2 or cm != _GZ_CM_DEFLATE or flag != 0x04
            or xfl not in (0, 2, 4) or os_b != 255 or x_len != 12
            or st1 != ord("Q") or st2 != ord("Z") or x2_len != 8):
        return None
    return GzipExtHeader(src_sz, dest_sz)


def parse_any_gzip_header(buf, off: int = 0) -> tuple[int, int] | None:
    """Parse a generic RFC1952 header (any FLG combination).

    Returns (header_len, isize_hint=-1) or None if invalid.  Used for the SW
    interop path: gzip files produced by other tools may carry FNAME/FCOMMENT/
    FHCRC fields which QAT cannot process (forces SW in the reference).
    """
    n = len(buf)
    if n - off < STD_GZIP_HEADER_SIZE:
        return None
    if buf[off] != _GZ_ID1 or buf[off + 1] != _GZ_ID2 or buf[off + 2] != _GZ_CM_DEFLATE:
        return None
    flg = buf[off + 3]
    if flg & 0xE0:  # RFC1952 reserved FLG bits must be zero
        return None
    pos = off + STD_GZIP_HEADER_SIZE
    if flg & 0x04:  # FEXTRA
        if n - pos < 2:
            return None
        (xlen,) = struct.unpack_from("<H", buf, pos)
        pos += 2 + xlen
    if flg & 0x08:  # FNAME
        end = bytes(buf[pos:]).find(b"\x00")
        if end < 0:
            return None
        pos += end + 1
    if flg & 0x10:  # FCOMMENT
        end = bytes(buf[pos:]).find(b"\x00")
        if end < 0:
            return None
        pos += end + 1
    if flg & 0x02:  # FHCRC
        pos += 2
    if pos > n:
        return None
    return pos - off, -1


def find_std_gzip_footer(buf, off: int, avail: int) -> int:
    """Locate the footer of the std-gzip member starting at ``off``.

    Mirrors findStdGzipFooter (reference src/qatzip_gzip.c:244-262): scan for
    the next plain gzip header and back off by the footer size; if none found,
    the footer is the last 8 bytes of the available window.  Returns the
    absolute offset of the 8-byte footer.
    """
    scan = off + STD_GZIP_HEADER_SIZE + STD_GZIP_FOOTER_SIZE
    end = off + avail
    while scan + STD_GZIP_HEADER_SIZE <= end:
        if is_std_gzip_header(buf, scan):
            return scan - STD_GZIP_FOOTER_SIZE
        scan += 1
    return end - STD_GZIP_FOOTER_SIZE
