"""DEFLATE constant tables (RFC1951) as numpy arrays: the part of
qatzip_tpu/ops/deflate_tables.py the port's decoders reach, namely the
length and distance code bases and extra bits, the static Huffman code of
BTYPE=01 and canonical codes.  The code-length code's symbol order lives
with the header parse, native/qzheaders.cpp.
"""
from __future__ import annotations

import numpy as np

MIN_MATCH = 3
MAX_MATCH = 258
WINDOW_SIZE = 32768
EOB = 256
NUM_LITLEN = 286
NUM_DIST = 30

# length codes 257-285 and distance codes 0-29: base value and extra bits
_LENGTH_BASE = [3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 15, 17, 19, 23, 27, 31, 35,
                43, 51, 59, 67, 83, 99, 115, 131, 163, 195, 227, 258]
_LENGTH_EXTRA = [0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3,
                 4, 4, 4, 4, 5, 5, 5, 5, 0]
_DIST_BASE = [1, 2, 3, 4, 5, 7, 9, 13, 17, 25, 33, 49, 65, 97, 129, 193, 257,
              385, 513, 769, 1025, 1537, 2049, 3073, 4097, 6145, 8193, 12289,
              16385, 24577]
_DIST_EXTRA = [0, 0, 0, 0, 1, 1, 2, 2, 3, 3, 4, 4, 5, 5, 6, 6, 7, 7, 8, 8, 9,
               9, 10, 10, 11, 11, 12, 12, 13, 13]

# ---------------------------------------------------------------------------
# Static Huffman code (RFC1951 3.2.6)
# ---------------------------------------------------------------------------


def _canonical_codes(lengths: np.ndarray) -> np.ndarray:
    """Canonical Huffman code values from code lengths."""
    max_len = int(lengths.max()) if lengths.size else 0
    bl_count = np.bincount(lengths, minlength=max_len + 1)
    bl_count[0] = 0
    next_code = np.zeros(max_len + 2, dtype=np.int64)
    code = 0
    for bits in range(1, max_len + 1):
        code = (code + bl_count[bits - 1]) << 1
        next_code[bits] = code
    out = np.zeros_like(lengths)
    nc = next_code.copy()
    for sym in range(len(lengths)):
        l = lengths[sym]
        if l:
            out[sym] = nc[l]
            nc[l] += 1
    return out


def bit_reverse(values: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """Reverse the low `lengths` bits of each value (deflate emits Huffman
    codes MSB-first while the bitstream packs LSB-first)."""
    out = np.zeros_like(values)
    for i in range(len(values)):
        v, l = int(values[i]), int(lengths[i])
        r = 0
        for _ in range(l):
            r = (r << 1) | (v & 1)
            v >>= 1
        out[i] = r
    return out


def _build_static_tables():
    litlen_lengths = np.zeros(288, dtype=np.int32)
    litlen_lengths[0:144] = 8
    litlen_lengths[144:256] = 9
    litlen_lengths[256:280] = 7
    litlen_lengths[280:288] = 8
    litlen_codes = _canonical_codes(litlen_lengths)
    dist_lengths = np.full(30, 5, dtype=np.int32)
    dist_codes = _canonical_codes(dist_lengths)
    return (litlen_lengths, bit_reverse(litlen_codes, litlen_lengths),
            dist_lengths, bit_reverse(dist_codes, dist_lengths))


(STATIC_LITLEN_LEN, STATIC_LITLEN_CODE_REV,
 STATIC_DIST_LEN, STATIC_DIST_CODE_REV) = _build_static_tables()

canonical_codes = _canonical_codes
