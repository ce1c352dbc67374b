"""The reference's LZ4 interop suite (tests/test_lz4_interop.py) against the
port.

XXH32/XXH64 of the port against the ``xxhash`` library and the reference;
hand-assembled golden LZ4 frames (stored and compressed blocks, several
blocks, no content size) read by the port with the device route forced in
both packages, the port's engine on ``torch.device("cpu")`` (the block
decoder's plain version), with the reference's output; and the port's
emitted frames checked against the frame grammar with real xxhash,
byte-equal to the reference's.
"""
import struct

import pytest
import torch
import xxhash

import qatzip_tpu
import qatzip_tpu_torch as qt
from qatzip_tpu.utils import checksum as ref_ck
from qatzip_tpu_torch.engine import lz4_block
from qatzip_tpu_torch.utils import checksum as ck
from tests.torch_conformance import (  # noqa: F401 (fixtures)
    both, engine_on, port_engine, route, same)

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _engine(engine_on):
    engine_on(torch.device("cpu"))


# ---------------------------------------------------------------------------
# XXH32/64 against the xxhash library and the reference
# ---------------------------------------------------------------------------
def test_xxh32_matches_reference_library(corpus_factory):
    for n in list(range(0, 33)) + [63, 64, 65, 127, 1000, 4096]:
        data = corpus_factory(n, "random")
        for seed in (0, 1, 0xDEADBEEF):
            want = xxhash.xxh32_intdigest(data, seed)
            assert ck.xxh32(data, seed) == ref_ck.xxh32(data, seed) == want


def test_xxh32_each_is_xxh32_of_each_part(corpus_factory):
    """The LZ4 decompress's chunk checksums, hashed in one hold of the
    interpreter lock, are each part's XXH32, whatever buffer holds it."""
    parts = [corpus_factory(n, "random") for n in (0, 1, 15, 16, 17, 4096,
                                                   65536)]
    parts += [bytearray(parts[5]), memoryview(parts[6])[3:]]
    want = [xxhash.xxh32_intdigest(bytes(p), 9) for p in parts]
    assert ck.xxh32_each(parts, 9) == want
    assert ck.xxh32_each([]) == []


def test_xxh64_matches_reference_library(corpus_factory):
    for n in (0, 1, 31, 32, 33, 1000):
        data = corpus_factory(n, "random")
        want = xxhash.xxh64_intdigest(data, 7)
        assert ck.xxh64(data, 7) == ref_ck.xxh64(data, 7) == want


# ---------------------------------------------------------------------------
# Golden frames hand-assembled from the LZ4 frame spec
# ---------------------------------------------------------------------------
def _golden_frame(payload_blocks, content: bytes, content_size: bool = True):
    flg = 0x40 | 0x04
    if content_size:
        flg |= 0x08
    desc = bytes([flg, 0x70])
    if content_size:
        desc += struct.pack("<Q", len(content))
    hc = (xxhash.xxh32_intdigest(desc, 0) >> 8) & 0xFF
    out = struct.pack("<I", 0x184D2204) + desc + bytes([hc])
    for raw, is_compressed in payload_blocks:
        size = len(raw) | (0 if is_compressed else 0x80000000)
        out += struct.pack("<I", size) + raw
    out += struct.pack("<I", 0)
    out += struct.pack("<I", xxhash.xxh32_intdigest(content, 0))
    return out


def _read_on_device(port_engine, frame: bytes, content: bytes, **kw):
    """The frame read with the device route forced in both packages."""
    with route(device=True):
        out = both(lambda qz: qz.decompress(frame, "lz4", **kw))
    assert out == (content, content)


def test_golden_stored_block_frame(port_engine):
    content = b"hello lz4 frame world"
    _read_on_device(port_engine, _golden_frame([(content, False)], content),
                    content)


def test_golden_compressed_block_frame(port_engine):
    content = b"abcde" + b"abcdeabc" + b"XYZWQ"
    block = (bytes([0x54]) + b"abcde" + struct.pack("<H", 5)
             + bytes([0x50]) + b"XYZWQ")
    _read_on_device(port_engine, _golden_frame([(block, True)], content),
                    content)


def test_golden_multi_block_frame(port_engine, corpus_factory):
    a = corpus_factory(1000, "text")
    b = corpus_factory(500, "random")
    _read_on_device(port_engine, _golden_frame([(a, False), (b, False)],
                                               a + b), a + b)


def test_golden_no_content_size_frame(port_engine):
    content = b"sizeless"
    _read_on_device(port_engine,
                    _golden_frame([(content, False)], content,
                                  content_size=False), content,
                    hw_buff_sz=64 * 1024)


# ---------------------------------------------------------------------------
# Structural validation of the port's frames (spec grammar + real xxhash)
# ---------------------------------------------------------------------------
def _walk_blocks(frame: bytes, off: int):
    while True:
        (size,) = struct.unpack_from("<I", frame, off)
        off += 4
        if size == 0:
            return off
        stored = bool(size & 0x80000000)
        size &= 0x7FFFFFFF
        yield frame[off:off + size], stored
        off += size


def test_our_frame_structure_and_checksums(corpus_factory):
    data = corpus_factory(200_000, "text")
    stream, ref = qt.compress(data, "lz4", level=1), \
        qatzip_tpu.compress(data, "lz4", level=1)
    assert stream == ref
    out = bytearray()
    pos = nframes = 0
    while pos < len(stream):
        assert stream[pos:pos + 4] == struct.pack("<I", 0x184D2204)
        flg = stream[pos + 4]
        assert (flg >> 6) == 0b01
        has_csize, has_cck = bool(flg & 0x08), bool(flg & 0x04)
        desc_len = 2 + (8 if has_csize else 0)
        desc = stream[pos + 4:pos + 4 + desc_len]
        assert stream[pos + 4 + desc_len] == \
            (xxhash.xxh32_intdigest(desc, 0) >> 8) & 0xFF
        csize = (struct.unpack_from("<Q", stream, pos + 6)[0] if has_csize
                 else None)
        fout = bytearray()
        gen = _walk_blocks(stream, pos + 4 + desc_len + 1)
        while True:
            try:
                blk, stored = next(gen)
            except StopIteration as stop:
                end = stop.value
                break
            fout += blk if stored else lz4_block.lz4_block_decompress(
                blk, 1 << 22)
        if csize is not None:
            assert csize == len(fout)
        if has_cck:
            (cck,) = struct.unpack_from("<I", stream, end)
            assert cck == xxhash.xxh32_intdigest(bytes(fout), 0)
            end += 4
        out += fout
        pos = end
        nframes += 1
    assert bytes(out) == data
    assert nframes == (len(data) + 65535) // 65536


def test_our_frame_round_trip_all_sizes(corpus_factory):
    for n in (0, 1, 11, 12, 13, 65536, 65537):
        data = corpus_factory(n, "text")
        ref, port = both(lambda qz: qz.compress(data, "lz4"))
        assert port == ref
        assert qt.decompress(port, "lz4") == data


def test_session_xxh32_is_whole_stream_digest(corpus_factory):
    data = corpus_factory(200_000, "text")
    want = xxhash.xxh32_intdigest(data, 0)

    def run(qz):
        p = qz.QzSessionParamsLZ4()
        sess, dsess = qz.QzSession(), qz.QzSession()
        assert qz.qz_setup_session_lz4(sess, p) == qt.QZ_OK
        assert qz.qz_setup_session_lz4(dsess, p) == qt.QZ_OK
        res = qz.qz_compress_crc(sess, data)
        back = qz.qz_decompress_crc(dsess, res.data)
        assert res.rc == back.rc == qt.QZ_OK and back.data == data
        assert res.crc == back.crc == want
        return res, back

    (r1, r2), (p1, p2) = both(run)
    same(r1, p1)
    same(r2, p2)
