"""The reference's wire-format suite (tests/test_formats.py) against the
port's copies of the framing and checksum helpers.

Each generator and parser of ``qatzip_tpu_torch.formats``,
``engine/lz4_block.py`` and ``utils/checksum.py`` gives the reference's
bytes and values on the same input, and the reference suite's own checks.
"""
import struct
import zlib

import xxhash

import qatzip_tpu
import qatzip_tpu_torch as qt
from qatzip_tpu.engine import lz4_block as ref_lz4_block
from qatzip_tpu.formats import gzip_fmt as ref_gzip_fmt
from qatzip_tpu.formats import lz4_fmt as ref_lz4_fmt
from qatzip_tpu.formats import zlib_fmt as ref_zlib_fmt
from qatzip_tpu.utils import checksum as ref_ck
from qatzip_tpu_torch.constants import QzDataFormat
from qatzip_tpu_torch.engine import lz4_block
from qatzip_tpu_torch.formats import gzip_fmt, lz4_fmt, zlib_fmt
from qatzip_tpu_torch.utils import checksum as ck
from tests.torch_conformance import engine_on  # noqa: F401 (fixture)


def test_gzipext_header_layout():
    h = gzip_fmt.gen_gzipext_header(0x11223344, 0x55667788)
    assert h == ref_gzip_fmt.gen_gzipext_header(0x11223344, 0x55667788)
    assert len(h) == gzip_fmt.GZIPEXT_HEADER_SIZE == 24
    assert h[:4] == b"\x1f\x8b\x08\x04"
    assert h[8] == 0 and h[9] == 255
    assert h[10:12] == struct.pack("<H", 12)
    assert h[12:14] == b"QZ"
    parsed = gzip_fmt.parse_gzipext_header(h)
    assert parsed.src_sz == 0x11223344 and parsed.dest_sz == 0x55667788


def test_std_gzip_header_footer():
    h = gzip_fmt.gen_std_gzip_header()
    assert h == ref_gzip_fmt.gen_std_gzip_header()
    assert len(h) == 10 and h[:4] == b"\x1f\x8b\x08\x00"
    f = gzip_fmt.gen_std_gzip_footer(0xDEADBEEF, 12345)
    assert f == ref_gzip_fmt.gen_std_gzip_footer(0xDEADBEEF, 12345)
    assert gzip_fmt.parse_std_gzip_footer(f) == (0xDEADBEEF, 12345)


def test_zlib_header_valid():
    h = zlib_fmt.gen_zlib_header()
    assert h == ref_zlib_fmt.gen_zlib_header()
    assert zlib_fmt.verify_zlib_header(h)
    assert (h[0] * 256 + h[1]) % 31 == 0


def test_lz4_frame_header_checksum():
    h = lz4_fmt.gen_lz4_frame_header(65536)
    assert h == ref_lz4_fmt.gen_lz4_frame_header(65536)
    assert len(h) == 15
    (magic,) = struct.unpack_from("<I", h, 0)
    assert magic == lz4_fmt.LZ4_MAGIC
    assert h[4] == 0x4C and h[5] == 0x40
    assert h[14] == (xxhash.xxh32(h[4:14], 0).intdigest() >> 8) & 0xFF
    hlen, hdr = lz4_fmt.parse_lz4_frame_header(h, strict=True)
    assert hlen == 15 and hdr.content_size == 65536


def test_lz4_footer_walk():
    payload = lz4_block.lz4_block_compress(
        b"hello world, hello world, hello!" * 10)
    frame = (lz4_fmt.gen_lz4_frame_header(320)
             + lz4_fmt.gen_lz4_block_header(len(payload)) + payload
             + lz4_fmt.gen_lz4_frame_footer(0x12345678))
    foot = lz4_fmt.find_lz4_footer(frame, 0, len(frame))
    assert foot == ref_lz4_fmt.find_lz4_footer(frame, 0, len(frame))
    assert foot == len(frame) - 8
    assert struct.unpack_from("<II", frame, foot) == (0, 0x12345678)


def test_lz4_block_codec_roundtrip():
    for data in (b"", b"a", b"abcabcabcabcabcabcabcabc" * 100,
                 bytes(range(256)) * 300):
        blk = lz4_block.lz4_block_compress(data)
        assert blk == ref_lz4_block.lz4_block_compress(data)
        assert lz4_block.lz4_block_decompress(blk, 1 << 20) == data


def test_lz4s_sequences_decode():
    data = b"the quick brown fox " * 500
    for mm in (3, 4):
        blk = lz4_block.lz4s_block_compress(data, mini_match=mm)
        assert blk == ref_lz4_block.lz4s_block_compress(data, mini_match=mm)
        assert lz4_block.lz4s_block_decompress(blk, 1 << 20,
                                               mini_match=mm) == data
        seqs = lz4_block.lz4s_decode_sequences(blk, mini_match=mm)
        assert seqs == ref_lz4_block.lz4s_decode_sequences(blk,
                                                           mini_match=mm)
        assert sum(s[1] + s[3] for s in seqs) == len(data)


def test_crc32_combine_matches_zlib():
    a, b = b"hello compression", b" world of accelerators"
    c1, c2 = zlib.crc32(a), zlib.crc32(b)
    assert ck.crc32_combine(c1, c2, len(b)) == zlib.crc32(a + b) == \
        ref_ck.crc32_combine(c1, c2, len(b))


def test_adler32_combine_matches_zlib():
    a, b = b"x" * 10000, b"adler combine check" * 57
    c1, c2 = zlib.adler32(a), zlib.adler32(b)
    assert ck.adler32_combine(c1, c2, len(b)) == zlib.adler32(a + b) == \
        ref_ck.adler32_combine(c1, c2, len(b))


def test_find_std_gzip_footer_scan(engine_on):
    import torch

    engine_on(torch.device("cpu"))
    data1 = b"abc" * 1000
    data2 = b"xyz" * 800
    fmt = QzDataFormat.QZ_DEFLATE_GZIP
    comp = (qt.compress(data1, "deflate", fmt=fmt)
            + qt.compress(data2, "deflate", fmt=fmt))
    assert comp == (qatzip_tpu.compress(data1, "deflate", fmt=fmt)
                    + qatzip_tpu.compress(data2, "deflate", fmt=fmt))
    foot = gzip_fmt.find_std_gzip_footer(comp, 0, len(comp))
    assert foot == ref_gzip_fmt.find_std_gzip_footer(comp, 0, len(comp))
    assert gzip_fmt.parse_std_gzip_footer(comp, foot)[1] == len(data1)
