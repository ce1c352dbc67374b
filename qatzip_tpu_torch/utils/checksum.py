"""Checksum helpers of the port (a copy of the part of
qatzip_tpu/utils/checksum.py it reaches): crc32/adler32 combination across
independent chunks, and XXH32.

The engine compresses chunks independently and combines their checksums
in submission order, mirroring the reference's crc32_combine use (src/qatzip.c:1707-1714).
"""
from __future__ import annotations

import functools
import zlib

try:  # native C++ combine (qatzip_tpu_torch/native); optional
    from qatzip_tpu_torch.native import qzcore as _native
except Exception:  # pragma: no cover - native build optional
    _native = None

_CRC_POLY = 0xEDB88320  # reflected CRC-32 (gzip)
_ADLER_MOD = 65521


def _gf2_matrix_times(mat: list[int], vec: int) -> int:
    s = 0
    i = 0
    while vec:
        if vec & 1:
            s ^= mat[i]
        vec >>= 1
        i += 1
    return s


def _gf2_matrix_square(mat: list[int]) -> list[int]:
    return [_gf2_matrix_times(mat, mat[n]) for n in range(32)]


def crc32_combine(crc1: int, crc2: int, len2: int) -> int:
    """zlib-compatible crc32_combine (GF(2) matrix exponentiation)."""
    if len2 <= 0:
        return crc1 & 0xFFFFFFFF
    if _native is not None:
        return _native.crc32_combine(crc1, crc2, len2)
    crc1 &= 0xFFFFFFFF
    crc2 &= 0xFFFFFFFF
    crc1 = _gf2_matrix_times(_crc_len_operator(len2), crc1)
    return (crc1 ^ crc2) & 0xFFFFFFFF


@functools.lru_cache(maxsize=64)
def _crc_len_operator(len2: int) -> tuple[int, ...]:
    """Combined GF(2) operator advancing a CRC past len2 zero bytes
    (memoized: chunk lengths repeat at hw_buff_sz granularity)."""
    odd = [0] * 32
    odd[0] = _CRC_POLY
    row = 1
    for n in range(1, 32):
        odd[n] = row
        row <<= 1
    even = _gf2_matrix_square(odd)
    odd = _gf2_matrix_square(even)
    # identity operator
    op = [1 << n for n in range(32)]
    while True:
        even = _gf2_matrix_square(odd)
        if len2 & 1:
            op = [_gf2_matrix_times(even, op[n]) for n in range(32)]
        len2 >>= 1
        if len2 == 0:
            break
        odd = _gf2_matrix_square(even)
        if len2 & 1:
            op = [_gf2_matrix_times(odd, op[n]) for n in range(32)]
        len2 >>= 1
        if len2 == 0:
            break
    return tuple(op)


def adler32_combine(adler1: int, adler2: int, len2: int) -> int:
    """zlib-compatible adler32_combine."""
    if len2 < 0:
        return 0xFFFFFFFF
    rem = len2 % _ADLER_MOD
    sum1 = adler1 & 0xFFFF
    sum2 = (rem * sum1) % _ADLER_MOD
    sum1 += (adler2 & 0xFFFF) + _ADLER_MOD - 1
    sum2 += ((adler1 >> 16) & 0xFFFF) + ((adler2 >> 16) & 0xFFFF) + _ADLER_MOD - rem
    if sum1 >= _ADLER_MOD:
        sum1 -= _ADLER_MOD
    if sum1 >= _ADLER_MOD:
        sum1 -= _ADLER_MOD
    if sum2 >= 2 * _ADLER_MOD:
        sum2 -= 2 * _ADLER_MOD
    if sum2 >= _ADLER_MOD:
        sum2 -= _ADLER_MOD
    return (sum1 | (sum2 << 16)) & 0xFFFFFFFF


def crc32(data, value: int = 0) -> int:
    return zlib.crc32(data, value) & 0xFFFFFFFF


def adler32(data, value: int = 1) -> int:
    return zlib.adler32(data, value) & 0xFFFFFFFF


def xxh32(data, seed: int = 0) -> int:
    """XXH32 via the vendored native implementation (the reference vendors
    src/xxhash.c with XXH_NAMESPACE=QATZIP_); falls back to the pip
    `xxhash` wheel when the native library is unavailable."""
    try:
        from qatzip_tpu_torch.native import qzcore as _native

        return _native.xxh32(bytes(data), seed)
    except Exception:
        import xxhash as _xx

        return _xx.xxh32(bytes(data), seed).intdigest()
