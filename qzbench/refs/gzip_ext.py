"""The plain reference of the gzip-ext configurations.

``make`` writes the compressed input of a decompress cell: each chunk as
one raw deflate stream by Python's zlib at level 1 (the software path's
output), framed as gzip-ext.  ``read`` is the check of a compress cell's
output: it walks the members, inflates each with zlib and checks each
header, CRC-32 and ISIZE (qzbench/gzipext.py).  ``control`` is the
reference in the program's place with one guarantee broken, for the test
that the check fails it: every chunk's CRC-32 left out (0), or, for
decompress, the last chunk's bytes left out.
"""
from __future__ import annotations

import struct
from concurrent.futures import ThreadPoolExecutor

from qzbench import gzipext


def make(original: bytes, chunk: int, device=None) -> bytes:
    parts = [original[i:i + chunk] for i in range(0, len(original), chunk)]
    # zlib releases the GIL: a few threads, stopped on return
    with ThreadPoolExecutor(4) as pool:
        payloads = list(pool.map(gzipext.deflate_l1, parts))
    return b"".join(gzipext.member(c, p) for c, p in zip(parts, payloads))


def read(stream, device=None) -> bytes:
    return gzipext.read(stream)


def control(original: bytes, chunk: int, direction: str,
            device=None) -> bytes:
    if direction == "decompress":
        cut = (len(original) - 1) // chunk * chunk
        return original[:cut]
    out = bytearray(make(original, chunk))
    pos = 0
    while pos < len(out):
        dest_sz = struct.unpack_from("<I", out, pos + 20)[0]
        crc = pos + gzipext.HEADER + dest_sz
        out[crc:crc + 4] = bytes(4)
        pos = crc + gzipext.FOOTER
    return bytes(out)
