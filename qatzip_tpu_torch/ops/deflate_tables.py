"""DEFLATE constant tables (RFC1951) as numpy arrays: the part of
qatzip_tpu/ops/deflate_tables.py the port's inflate reaches, namely the
static Huffman code of BTYPE=01, canonical codes and the code-length-code
symbol order.
"""
from __future__ import annotations

import numpy as np

MIN_MATCH = 3
MAX_MATCH = 258
WINDOW_SIZE = 32768
EOB = 256
NUM_LITLEN = 286
NUM_DIST = 30
NUM_CLCODES = 19

# order in which code-length-code lengths are transmitted (RFC1951 3.2.7)
CLCODE_ORDER = np.array([16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13,
                         2, 14, 1, 15], dtype=np.int32)

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
