"""Checksum helpers of the port (a copy of qatzip_tpu/utils/checksum.py):
crc32/adler32 combination across independent chunks, XXH32/XXH64, and the
session-configurable CRC32/CRC64.

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


def xxh32_each(parts, seed: int = 0) -> list[int]:
    """XXH32 of each of ``parts`` (a request's chunks): one native call for
    all of them, else :func:`xxh32` a part."""
    try:
        from qatzip_tpu_torch.native import qzcore as _native
    except Exception:
        return [xxh32(p, seed) for p in parts]
    return _native.xxh32_rows(parts, seed)


class XXH32State:
    """Incremental XXH32 (RFC-less spec; same mandated constants as the
    reference's vendored src/xxhash.c).  Used by the streaming LZ4-frame
    decompressor to fold the content checksum without buffering the whole
    frame output."""

    _P1, _P2, _P3 = 0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D
    _P4, _P5 = 0x27D4EB2F, 0x165667B1
    _M = 0xFFFFFFFF

    def __init__(self, seed: int = 0):
        s = seed & self._M
        self._acc = [(s + self._P1 + self._P2) & self._M,
                     (s + self._P2) & self._M, s,
                     (s - self._P1) & self._M]
        self._seed = s
        self._buf = bytearray()
        self._total = 0

    @staticmethod
    def _rotl(v: int, r: int) -> int:
        return ((v << r) | (v >> (32 - r))) & 0xFFFFFFFF

    def _round(self, acc: int, lane: int) -> int:
        acc = (acc + lane * self._P2) & self._M
        return (self._rotl(acc, 13) * self._P1) & self._M

    def update(self, data) -> "XXH32State":
        data = bytes(data)
        self._total += len(data)
        self._buf += data
        n = len(self._buf) - (len(self._buf) & 15)
        if n:
            import struct as _st

            a = self._acc
            for (l0, l1, l2, l3) in _st.iter_unpack("<IIII",
                                                    bytes(self._buf[:n])):
                a[0] = self._round(a[0], l0)
                a[1] = self._round(a[1], l1)
                a[2] = self._round(a[2], l2)
                a[3] = self._round(a[3], l3)
            del self._buf[:n]
        return self

    def digest(self) -> int:
        import struct as _st

        if self._total >= 16:
            h = (self._rotl(self._acc[0], 1) + self._rotl(self._acc[1], 7)
                 + self._rotl(self._acc[2], 12)
                 + self._rotl(self._acc[3], 18)) & self._M
        else:
            h = (self._seed + self._P5) & self._M
        h = (h + self._total) & self._M
        buf = bytes(self._buf)
        i = 0
        while i + 4 <= len(buf):
            (lane,) = _st.unpack_from("<I", buf, i)
            h = (h + lane * self._P3) & self._M
            h = (self._rotl(h, 17) * self._P4) & self._M
            i += 4
        while i < len(buf):
            h = (h + buf[i] * self._P5) & self._M
            h = (self._rotl(h, 11) * self._P1) & self._M
            i += 1
        h ^= h >> 15
        h = (h * self._P2) & self._M
        h ^= h >> 13
        h = (h * self._P3) & self._M
        h ^= h >> 16
        return h


def xxh64(data, seed: int = 0) -> int:
    try:
        from qatzip_tpu_torch.native import qzcore as _native

        return _native.xxh64(bytes(data), seed)
    except Exception:
        import xxhash as _xx

        return _xx.xxh64(bytes(data), seed).intdigest()


# ---------------------------------------------------------------------------
# Session-configurable CRC32/CRC64 (reference QzCrc32Config_T /
# QzCrc64Config_T, include/qatzip.h:753-787)
# ---------------------------------------------------------------------------
import dataclasses as _dc


@_dc.dataclass
class Crc64Config:
    """Session CRC64 configuration; defaults to ECMA-182 Normal
    (reference include/qatzip.h:753-765)."""

    polynomial: int = 0x42F0E1EBA9EA3693
    initial_value: int = 0
    reflect_in: int = 0
    reflect_out: int = 0
    xor_out: int = 0


@_dc.dataclass
class Crc32Config:
    """Session CRC32 configuration; defaults to the gzip CRC-32
    (reflected 0x04C11DB7, init/xor 0xFFFFFFFF)."""

    polynomial: int = 0x04C11DB7
    initial_value: int = 0xFFFFFFFF
    reflect_in: int = 1
    reflect_out: int = 1
    xor_out: int = 0xFFFFFFFF


def _reflect(v: int, bits: int) -> int:
    r = 0
    for _ in range(bits):
        r = (r << 1) | (v & 1)
        v >>= 1
    return r


@functools.lru_cache(maxsize=8)
def _crc_table(poly: int, width: int, reflect_in: int) -> tuple[int, ...]:
    mask = (1 << width) - 1
    tab = []
    if reflect_in:
        rp = _reflect(poly & mask, width)
        for b in range(256):
            crc = b
            for _ in range(8):
                crc = (crc >> 1) ^ (rp if crc & 1 else 0)
            tab.append(crc)
    else:
        top = 1 << (width - 1)
        for b in range(256):
            crc = b << (width - 8)
            for _ in range(8):
                crc = ((crc << 1) ^ poly) & mask if crc & top else (crc << 1) & mask
            tab.append(crc)
    return tuple(tab)


def crc_generic(data, poly: int, init: int, width: int, reflect_in: int,
                reflect_out: int, xor_out: int) -> int:
    """Rocksoft-model CRC of any width 8..64."""
    data = bytes(data)
    if _native is not None:
        return _native.crc_generic(data, poly, init, width,
                                   bool(reflect_in), bool(reflect_out),
                                   xor_out)
    mask = (1 << width) - 1
    tab = _crc_table(poly, width, int(bool(reflect_in)))
    if reflect_in:
        crc = _reflect(init & mask, width)
        for byte in data:
            crc = (crc >> 8) ^ tab[(crc ^ byte) & 0xFF]
        if not reflect_out:
            crc = _reflect(crc, width)
    else:
        crc = init & mask
        for byte in data:
            crc = ((crc << 8) & mask) ^ tab[((crc >> (width - 8)) ^ byte) & 0xFF]
        if reflect_out:
            crc = _reflect(crc, width)
    return (crc ^ xor_out) & mask


def crc_continue(data, running: int, poly: int, width: int, reflect_in: int,
                 reflect_out: int, xor_out: int) -> int:
    """Continue a Rocksoft-model CRC across buffers: ``running`` is a value
    previously returned by :func:`crc_generic` with the same config."""
    mask = (1 << width) - 1
    state = (running ^ xor_out) & mask
    if bool(reflect_in) != bool(reflect_out):
        state = _reflect(state, width)
    init = _reflect(state, width) if reflect_in else state
    return crc_generic(data, poly, init, width, reflect_in, reflect_out,
                       xor_out)


def crc64_update(data, running: int, config: Crc64Config | None = None,
                 first: bool = False) -> int:
    cfg = config or Crc64Config()
    if first:
        return crc64(data, cfg)
    return crc_continue(data, running, cfg.polynomial, 64, cfg.reflect_in,
                        cfg.reflect_out, cfg.xor_out)


def crc32_update(data, running: int, config: Crc32Config | None = None,
                 first: bool = False) -> int:
    cfg = config or Crc32Config()
    if first:
        return crc32_configured(data, cfg)
    return crc_continue(data, running, cfg.polynomial, 32, cfg.reflect_in,
                        cfg.reflect_out, cfg.xor_out)


def crc64(data, config: Crc64Config | None = None) -> int:
    cfg = config or Crc64Config()
    return crc_generic(data, cfg.polynomial, cfg.initial_value, 64,
                       cfg.reflect_in, cfg.reflect_out, cfg.xor_out)


def crc32_configured(data, config: Crc32Config | None = None) -> int:
    cfg = config or Crc32Config()
    return crc_generic(data, cfg.polynomial, cfg.initial_value, 32,
                       cfg.reflect_in, cfg.reflect_out, cfg.xor_out)
