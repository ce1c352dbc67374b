"""Per-chunk output framing: wraps backend payloads into wire formats (a
copy of qatzip_tpu/engine/framing.py).

Analog of outputHeaderGen/outputFooterGen dispatch (reference
src/qatzip_utils.c:888-995): every hw_buff_sz chunk becomes a standalone
member of its wire format, so members concatenate in block order.
"""
from __future__ import annotations

from qatzip_tpu_torch.constants import DataFormatInternal
from qatzip_tpu_torch.formats import gzip_fmt, lz4_fmt, zlib_fmt


def header_sz(fmt: DataFormatInternal) -> int:
    return {
        DataFormatInternal.DEFLATE_4B: 4,
        DataFormatInternal.DEFLATE_GZIP: gzip_fmt.STD_GZIP_HEADER_SIZE,
        DataFormatInternal.DEFLATE_GZIP_EXT: gzip_fmt.GZIPEXT_HEADER_SIZE,
        DataFormatInternal.DEFLATE_RAW: 0,
        DataFormatInternal.DEFLATE_ZLIB: zlib_fmt.STD_ZLIB_HEADER_SIZE,
        DataFormatInternal.LZ4_FH: lz4_fmt.LZ4_HEADER_SIZE,
        DataFormatInternal.LZ4S_BK: lz4_fmt.LZ4_BLK_HEADER_SIZE,
    }[fmt]


def footer_sz(fmt: DataFormatInternal) -> int:
    return {
        DataFormatInternal.DEFLATE_4B: 0,
        DataFormatInternal.DEFLATE_GZIP: gzip_fmt.STD_GZIP_FOOTER_SIZE,
        DataFormatInternal.DEFLATE_GZIP_EXT: gzip_fmt.STD_GZIP_FOOTER_SIZE,
        DataFormatInternal.DEFLATE_RAW: 0,
        DataFormatInternal.DEFLATE_ZLIB: zlib_fmt.STD_ZLIB_FOOTER_SIZE,
        DataFormatInternal.LZ4_FH: lz4_fmt.LZ4_FOOTER_SIZE,
        DataFormatInternal.LZ4S_BK: 0,
    }[fmt]


def frame_chunk(fmt: DataFormatInternal, payload: bytes, consumed: int,
                checksum: int) -> bytes:
    """Wrap one compressed chunk payload into a complete format member.

    For LZ4_FH the payload already contains the block header(s)+data section;
    for LZ4S_BK the payload is the bare LZ4s block.
    """
    if fmt == DataFormatInternal.DEFLATE_4B:
        return len(payload).to_bytes(4, "little") + payload
    if fmt == DataFormatInternal.DEFLATE_GZIP:
        return (gzip_fmt.gen_std_gzip_header() + payload
                + gzip_fmt.gen_std_gzip_footer(checksum, consumed))
    if fmt == DataFormatInternal.DEFLATE_GZIP_EXT:
        return (gzip_fmt.gen_gzipext_header(consumed, len(payload)) + payload
                + gzip_fmt.gen_std_gzip_footer(checksum, consumed))
    if fmt == DataFormatInternal.DEFLATE_RAW:
        return payload
    if fmt == DataFormatInternal.DEFLATE_ZLIB:
        return (zlib_fmt.gen_zlib_header() + payload
                + zlib_fmt.gen_zlib_footer(checksum))
    if fmt == DataFormatInternal.LZ4_FH:
        return (lz4_fmt.gen_lz4_frame_header(consumed) + payload
                + lz4_fmt.gen_lz4_frame_footer(checksum))
    if fmt == DataFormatInternal.LZ4S_BK:
        return len(payload).to_bytes(4, "little") + payload
    raise ValueError(f"unknown format {fmt}")
