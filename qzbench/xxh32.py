"""XXH32 in plain Python and NumPy (the algorithm of xxHash's spec:
https://github.com/Cyan4973/xxHash/blob/dev/doc/xxhash_spec.md).

``xxh32`` hashes one buffer with Python integers; ``xxh32_rows`` hashes
many buffers of one length at once, the four lanes of every row advanced
together by NumPy's wrapping uint32 arithmetic.
"""
from __future__ import annotations

import numpy as np

P1, P2, P3, P4, P5 = (0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D, 0x27D4EB2F,
                      0x165667B1)
_M = 0xFFFFFFFF


def _rotl(v: int, r: int) -> int:
    return ((v << r) | (v >> (32 - r))) & _M


def _tail(h: int, data, start: int, n: int) -> int:
    """The spec's steps 4-6: length, trailing words and bytes, avalanche."""
    h = (h + n) & _M
    p = start
    while p + 4 <= n:
        w = int.from_bytes(data[p:p + 4], "little")
        h = _rotl((h + w * P3) & _M, 17) * P4 & _M
        p += 4
    while p < n:
        h = _rotl((h + data[p] * P5) & _M, 11) * P1 & _M
        p += 1
    h ^= h >> 15
    h = h * P2 & _M
    h ^= h >> 13
    h = h * P3 & _M
    h ^= h >> 16
    return h


def xxh32(data, seed: int = 0) -> int:
    """XXH32 of ``data`` (any bytes-like object)."""
    data = bytes(data)
    n = len(data)
    if n < 16:
        return _tail((seed + P5) & _M, data, 0, n)
    v = [(seed + P1 + P2) & _M, (seed + P2) & _M, seed & _M,
         (seed - P1) & _M]
    stripes = n // 16
    words = np.frombuffer(data, "<u4", stripes * 4).reshape(stripes, 4)
    acc = xxh32_lanes(words[None], v)[0]
    h = (_rotl(int(acc[0]), 1) + _rotl(int(acc[1]), 7)
         + _rotl(int(acc[2]), 12) + _rotl(int(acc[3]), 18)) & _M
    return _tail(h, data, stripes * 16, n)


def xxh32_lanes(words: np.ndarray, v) -> np.ndarray:
    """The spec's stripe loop for rows of little-endian words [R, S, 4]
    from the start values ``v`` of the four lanes; returns [R, 4]."""
    rows, stripes = words.shape[:2]
    acc = np.empty((rows, 4), np.uint32)
    acc[:] = np.asarray(v, np.uint32)
    # every word times P2 at once, then the stripes in order: the lane
    # recurrence is the only sequential part
    wp = np.ascontiguousarray(
        (words.astype(np.uint32) * np.uint32(P2)).transpose(1, 0, 2))
    lo = np.empty_like(acc)
    p1 = np.uint32(P1)
    for s in range(stripes):
        acc += wp[s]
        np.right_shift(acc, 19, out=lo)
        acc <<= 13
        acc |= lo
        acc *= p1
    return acc


def xxh32_rows(rows: np.ndarray, seed: int = 0) -> list[int]:
    """XXH32 of each row of a uint8 array [R, n]."""
    r, n = rows.shape
    if n < 16 or r == 0:
        return [xxh32(row.tobytes(), seed) for row in rows]
    stripes = n // 16
    words = np.ascontiguousarray(rows[:, :stripes * 16]).view("<u4")
    acc = xxh32_lanes(words.reshape(r, stripes, 4),
                      [(seed + P1 + P2) & _M, (seed + P2) & _M, seed & _M,
                       (seed - P1) & _M])
    out = []
    for i in range(r):
        a = [int(x) for x in acc[i]]
        h = (_rotl(a[0], 1) + _rotl(a[1], 7) + _rotl(a[2], 12)
             + _rotl(a[3], 18)) & _M
        out.append(_tail(h, rows[i].tobytes(), stripes * 16, n))
    return out
