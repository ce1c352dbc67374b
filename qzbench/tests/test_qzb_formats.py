"""The frozen formats: gzip-ext against the standard library, the plain
LZ4 compressor and decoder on round trips and hand-made frames, XXH32 on
known values, and (a test may do this, the reference may not) the plain
LZ4 against the program's own CPU LZ4 code."""
import gzip
import struct
import zlib

import numpy as np
import pytest

from qzbench import corpus, gzipext, lz4plain, xxh32

DATA = corpus.build(11, 0, 5 * 65536 + 777)
CHUNKS = [DATA[i:i + 65536] for i in range(0, len(DATA), 65536)]


def test_gzipext_members_read_by_stdlib_gzip():
    stream = gzipext.write(CHUNKS)
    assert gzip.decompress(stream) == DATA
    assert gzipext.read(stream) == DATA


def test_gzipext_reader_checks_crc_size_and_layout():
    stream = bytearray(gzipext.write(CHUNKS[:2]))
    ok = bytes(stream)
    dest = struct.unpack_from("<I", stream, 20)[0]
    # the CRC, ISIZE, FLG, XLEN and src_sz fields
    for at in (24 + dest, 24 + dest + 4, 3, 12, 16):
        bad = bytearray(ok)
        bad[at] ^= 1
        with pytest.raises(gzipext.FormatError):
            gzipext.read(bytes(bad))
    with pytest.raises(gzipext.FormatError):
        gzipext.read(ok[:-3])
    # a payload of two deflate streams is not one member's payload
    two = gzipext.deflate_l1(b"ab")
    with pytest.raises(gzipext.FormatError):
        gzipext.read(gzipext.header(2, len(two) + 1) + two + b"\x03"
                     + struct.pack("<II", zlib.crc32(b"ab"), 2))


@pytest.mark.parametrize("data,seed,want", [
    (b"", 0, 0x02CC5D05), (b"a", 0, 0x550D7456), (b"abc", 0, 0x32D153FF),
    (b"Nobody inspects the spammish repetition", 0, 0xE2293B2F),
    (bytes(range(256)) * 3, 0, 0xCDB946B1), (b"abc", 1, 0xAA3DA8FF)])
def test_xxh32_known_values(data, seed, want):
    assert xxh32.xxh32(data, seed) == want


def test_xxh32_rows_equal_one_at_a_time():
    rows = np.frombuffer(DATA[:8 * 1000], np.uint8).reshape(8, 1000)
    assert xxh32.xxh32_rows(rows) == [xxh32.xxh32(r.tobytes()) for r in rows]


def test_lz4_round_trip_and_end_rules():
    cases = CHUNKS + [b"", b"x", b"abcd" * 3, bytes(12), bytes(13),
                      bytes(65536), b"ab" * 32768]
    blocks = lz4plain.compress_blocks(cases)
    for c, b in zip(cases, blocks):
        if b is None:
            continue
        assert len(b) < len(c)
        out, sizes = lz4plain.decode_blocks(b, [0], [len(b)], [0], [0],
                                            len(c))
        assert out.tobytes() == c and sizes[0] == len(c)
    # zeros and repeats compress; a 12-byte block cannot, 13 can
    assert blocks[-1] is not None and blocks[-2] is not None
    assert blocks[cases.index(bytes(12))] is None
    assert blocks[cases.index(bytes(13))] is not None


def _frame(content, block, flg=0x4C, stored=False, bsum=False):
    desc = struct.pack("<BBQ", flg, 0x40, len(content))
    head = struct.pack("<I", lz4plain.MAGIC) + desc + bytes(
        [xxh32.xxh32(desc) >> 8 & 0xFF])
    word = len(block) | (lz4plain.STORED if stored else 0)
    body = struct.pack("<I", word) + block
    if bsum:
        body += struct.pack("<I", xxh32.xxh32(block))
    return head + body + struct.pack("<II", 0, xxh32.xxh32(content))


def test_lz4_hand_made_frames():
    # literals only; an overlapping match of offset 1 with extensions
    lit = _frame(b"hello", b"\x50hello")
    assert lz4plain.read_frames(lit) == b"hello"
    run = b"a" + b"a" * 300 + b"bcdef"
    blk = bytes([0x1F]) + b"a" + b"\x01\x00" + bytes([255, 300 - 4 - 15 - 255])
    blk += bytes([0x50]) + b"bcdef"
    assert lz4plain.read_frames(_frame(run, blk)) == run
    # a stored block, and block checksums
    assert lz4plain.read_frames(_frame(b"raw", b"raw", stored=True)) == b"raw"
    assert lz4plain.read_frames(_frame(run, blk, flg=0x5C, bsum=True)) == run


@pytest.mark.parametrize("fault", ["header", "content", "offset0",
                                   "past_start", "ends_on_match", "size"])
def test_lz4_reader_refuses(fault):
    run = b"a" * 40 + b"bcdef"
    blk = bytes([0x1F]) + b"a" + b"\x01\x00" + bytes([40 - 1 - 4 - 15])
    blk += bytes([0x50]) + b"bcdef"
    good = _frame(run, blk)
    assert lz4plain.read_frames(good) == run
    bad = bytearray(good)
    if fault == "header":
        bad[14] ^= 1
    elif fault == "content":
        bad[-1] ^= 1
    elif fault == "offset0":
        bad = _frame(run, blk.replace(b"\x01\x00", b"\x00\x00", 1))
    elif fault == "past_start":
        bad = _frame(run, blk.replace(b"\x01\x00", b"\x02\x00", 1))
    elif fault == "ends_on_match":
        bad = _frame(b"a" * 40, blk[:5])
    else:
        bad = _frame(run + b"x", blk)
    with pytest.raises(lz4plain.FormatError):
        lz4plain.read_frames(bytes(bad))


def test_lz4_plain_against_the_program_cpu_code():
    from qatzip_tpu_torch.engine.lz4_block import (lz4_block_compress,
                                                    lz4_block_decompress)

    blocks = lz4plain.compress_blocks(CHUNKS)
    for c, b in zip(CHUNKS, blocks):
        if b is not None:
            assert lz4_block_decompress(b, 1 << 17) == c
    theirs = [lz4_block_compress(c) for c in CHUNKS[:3]]
    base = np.cumsum([0] + [len(c) for c in CHUNKS[:3]])
    starts = np.cumsum([0] + [len(b) for b in theirs])
    out, _ = lz4plain.decode_blocks(b"".join(theirs), starts[:-1],
                                    starts[1:], base[:-1], base[:-1],
                                    int(base[-1]))
    assert out.tobytes() == b"".join(CHUNKS[:3])
