"""The port's streaming API against the reference's, on the same inputs.

The cases of tests/test_stream.py, run through both packages with the
device route forced (the port's engine on ``torch.device("cpu")``, the
kernels' plain versions): produced bytes, stream checksums, counters and
return codes must be equal.  Stream compress runs the device match finder
on every buffer it fills; stream decompress inflates on the device for
4B only (the other deflate formats inflate incrementally with zlib on the
host, LZ4 frames walk on the host), and fails no lane over.
"""
import contextlib
import gzip
import struct
import zlib

import pytest
import torch
import xxhash

import qatzip_tpu
import qatzip_tpu_torch as qt
from qatzip_tpu import constants as C
from qatzip_tpu import stream as ref_stream
from qatzip_tpu.constants import QzDataFormat
from qatzip_tpu_torch import stream as port_stream
from qatzip_tpu_torch.engine import lz4_block
from qatzip_tpu_torch.utils import checksum as ck
from tests.test_torch_api_ext import device_only, port  # noqa: F401

torch.set_num_threads(1)

HW_BUFF = 16 << 10
PKGS = {"ref": (qatzip_tpu, ref_stream), "port": (qt, port_stream)}


def deflate_sess(qz, fmt=QzDataFormat.QZ_DEFLATE_GZIP_EXT,
                 strm_buff_sz=HW_BUFF, hw_buff_sz=HW_BUFF):
    sess = qz.QzSession()
    p = qz.QzSessionParamsDeflate()
    p.data_fmt = fmt
    p.common_params.strm_buff_sz = strm_buff_sz
    p.common_params.hw_buff_sz = hw_buff_sz
    assert qz.qz_setup_session_deflate(sess, p) == C.QZ_OK
    return sess


def lz4_sess(qz, hw_buff_sz=HW_BUFF):
    sess = qz.QzSession()
    p = qz.QzSessionParamsLZ4()
    p.common_params.hw_buff_sz = hw_buff_sz
    assert qz.qz_setup_session_lz4(sess, p) == C.QZ_OK
    return sess


def feed(fn, sess, S, strm, data, step, bound=None):
    """Every piece of ``data`` through ``fn``; the produced bytes."""
    out = bytearray()
    for i in range(0, max(len(data), 1), step):
        rc, produced = fn(sess, strm, data[i:i + step],
                          last=1 if i + step >= len(data) else 0)
        assert rc == C.QZ_OK
        out += produced
        if bound is not None:
            assert len(strm.comp_in) <= bound
    rc, tail = S.qz_end_stream(sess, strm)
    assert rc == C.QZ_OK
    return bytes(out + tail)


def state(strm) -> tuple:
    return (strm.in_sz, strm.out_sz, strm.crc_32, strm.pending_in,
            strm.ended)


@pytest.mark.parametrize("fmt", [QzDataFormat.QZ_DEFLATE_GZIP_EXT,
                                 QzDataFormat.QZ_DEFLATE_GZIP,
                                 QzDataFormat.QZ_DEFLATE_4B])
def test_compress_stream_piecemeal_equals_reference(corpus_factory, port,
                                                    fmt):
    data = corpus_factory(100_000)
    out = {}
    for name, (qz, S) in PKGS.items():
        sess, strm = deflate_sess(qz, fmt), S.QzStream()
        with (device_only(port) if name == "port"
              else contextlib.nullcontext()):
            out[name] = (feed(S.qz_compress_stream, sess, S, strm, data,
                              7321), state(strm))
    assert out["port"] == out["ref"]
    assert out["port"][1][0] == len(data)
    if fmt != QzDataFormat.QZ_DEFLATE_4B:
        assert gzip.decompress(out["port"][0]) == data


def test_decompress_stream_4b_on_the_device_equals_reference(corpus_factory,
                                                              port):
    """4B members are decoded whole as they complete, through the engine's
    device inflate; the carry never exceeds one member."""
    data = corpus_factory(50_000)
    comp = qatzip_tpu.compress(data, fmt=QzDataFormat.QZ_DEFLATE_4B,
                               hw_buff_sz=HW_BUFF, sw_only=True)
    out = {}
    for name, (qz, S) in PKGS.items():
        sess, strm = deflate_sess(qz, QzDataFormat.QZ_DEFLATE_4B), S.QzStream()
        with (device_only(port) if name == "port"
              else contextlib.nullcontext()):
            out[name] = (feed(S.qz_decompress_stream, sess, S, strm, comp,
                              1009, bound=4 + HW_BUFF + 1024), state(strm))
    assert out["port"] == out["ref"]
    assert out["port"][0] == data and out["port"][1][2] == zlib.crc32(data)


@pytest.mark.parametrize("fmt,step", [
    (QzDataFormat.QZ_DEFLATE_GZIP_EXT, 1013),
    (QzDataFormat.QZ_DEFLATE_GZIP, 4096),
    (QzDataFormat.QZ_DEFLATE_RAW, 777),
])
def test_decompress_stream_incremental_equals_reference(corpus_factory, port,
                                                        fmt, step):
    """The deflate formats inflate incrementally on the host: the carry
    stays below a piece, the output and checksum equal the reference's."""
    data = corpus_factory(150_000)
    comp = qatzip_tpu.compress(data, fmt=fmt, hw_buff_sz=64 << 10,
                               sw_only=True)
    out = {}
    for name, (qz, S) in PKGS.items():
        sess, strm = deflate_sess(qz, fmt), S.QzStream()
        out[name] = (feed(S.qz_decompress_stream, sess, S, strm, comp, step,
                          bound=step), state(strm),
                     qz.qz_get_deflate_end_of_stream(sess))
    assert out["port"] == out["ref"]
    assert out["port"][0] == data and out["port"][1][2] == zlib.crc32(data)


def test_zlib_stream_round_trip_equals_reference(corpus_factory, port):
    data = corpus_factory(60_000)
    out = {}
    for name, (qz, S) in PKGS.items():
        sess = qz.QzSession()
        p = qz.QzSessionParamsDeflateExt(zlib_format=1)
        p.deflate_params.common_params.hw_buff_sz = HW_BUFF
        p.deflate_params.common_params.strm_buff_sz = HW_BUFF
        assert qz.qz_setup_session_deflate_ext(sess, p) == C.QZ_OK
        comp = feed(S.qz_compress_stream, sess, S, S.QzStream(), data, 5000)
        strm = S.QzStream()
        back = feed(S.qz_decompress_stream, sess, S, strm, comp, 3000)
        out[name] = (comp, back, state(strm))
    assert out["port"] == out["ref"]
    assert out["port"][1] == data
    assert out["port"][2][2] == zlib.adler32(data)


def test_stream_edge_cases_equal_reference(corpus_factory, port):
    """An empty stream, a drain limit on the pending output, an LZ4 session
    (not a stream compress format) and calls after the end."""
    data = corpus_factory(50_000)
    out = {}
    for name, (qz, S) in PKGS.items():
        sess, strm = deflate_sess(qz), S.QzStream()
        empty = S.qz_compress_stream(sess, strm, b"", last=1)
        empty += S.qz_end_stream(sess, strm)
        after_end = S.qz_compress_stream(sess, strm, b"x", last=1)
        strm = S.QzStream()
        rc, first = S.qz_compress_stream(sess, strm, data, last=1, max_out=10)
        pending = strm.pending_out_sz
        rest = bytearray(first)
        while strm.pending_out_sz:
            rest += S.qz_end_stream(sess, strm)[1]
        lz4 = S.qz_compress_stream(lz4_sess(qz), S.QzStream(), b"data",
                                   last=1)
        bad = (S.qz_compress_stream(None, S.QzStream(), b"x")[0],
               S.qz_decompress_stream(sess, object(), b"x")[0])
        out[name] = (empty, after_end, rc, len(first), pending, bytes(rest),
                     lz4, bad)
    assert out["port"] == out["ref"]
    assert gzip.decompress(out["port"][0][1] + out["port"][0][3]) == b""
    assert out["port"][6][0] == C.QZ_UNSUPPORTED_FMT
    assert gzip.decompress(out["port"][5]) == data


def test_decompress_stream_truncation_detected_as_reference(corpus_factory,
                                                            port):
    data = corpus_factory(20_000)
    out = {}
    for name, (qz, S) in PKGS.items():
        rcs = []
        for fmt, sess in ((QzDataFormat.QZ_DEFLATE_GZIP_EXT, None),
                          (QzDataFormat.QZ_DEFLATE_4B, None),
                          (None, lz4_sess(qz))):
            if sess is None:
                sess = deflate_sess(qz, fmt)
            comp = qz.qz_compress(sess, data).data
            rcs.append(S.qz_decompress_stream(sess, S.QzStream(),
                                              comp[:len(comp) - 5],
                                              last=1)[0])
        out[name] = rcs
    assert out["port"] == out["ref"] == [C.QZ_DATA_ERROR] * 3


# ---------------------------------------------------------------------------
# LZ4 frames: the incremental walk and XXH32
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("step", [997, 1])
def test_decompress_stream_lz4_piecemeal_equals_reference(corpus_factory,
                                                          port, step):
    """The frame walk examines each byte once: the carry stays below a
    block plus a piece; the stream digest is the XXH32 of the output.  The
    port compresses on the device (select kernel's plain version) to the
    reference's bytes."""
    data = corpus_factory(60_000 if step > 1 else 12_000)
    comp = {}
    with device_only(port):
        comp["port"] = qt.qz_compress(lz4_sess(qt), data).data
    comp["ref"] = qatzip_tpu.qz_compress(lz4_sess(qatzip_tpu), data).data
    assert comp["port"] == comp["ref"]
    out = {}
    for name, (qz, S) in PKGS.items():
        sess, strm = lz4_sess(qz), S.QzStream()
        out[name] = (feed(S.qz_decompress_stream, sess, S, strm,
                          comp["port"], step, bound=65536 + 4 + step),
                     state(strm), qz.qz_get_deflate_end_of_stream(sess))
    assert out["port"] == out["ref"]
    assert out["port"][0] == data and out["port"][1][2] == ck.xxh32(data)
    assert out["port"][2]


def test_decompress_stream_lz4_catenated_frames_equal_reference(
        corpus_factory, port):
    d1, d2 = corpus_factory(70_000), corpus_factory(50_000, "random")
    comp = b"".join(qatzip_tpu.compress(d, "lz4", hw_buff_sz=HW_BUFF,
                                        sw_only=True) for d in (d1, d2))
    out = {}
    for name, (qz, S) in PKGS.items():
        strm = S.QzStream()
        out[name] = (feed(S.qz_decompress_stream, lz4_sess(qz), S, strm,
                          comp, 1333), state(strm))
    assert out["port"] == out["ref"]
    assert out["port"][0] == d1 + d2
    assert out["port"][1][2] == ck.xxh32(d1 + d2)


@pytest.mark.parametrize("hw_buff_sz", [128 << 10, 512 << 10])
def test_decompress_stream_lz4_large_blocks_equal_reference(corpus_factory,
                                                            port, hw_buff_sz):
    """Frames of blocks above 64 KB declare their block-size code, so the
    walk takes them."""
    data = corpus_factory(200_000)
    out = {}
    for name, (qz, S) in PKGS.items():
        comp = qz.compress(data, "lz4", hw_buff_sz=hw_buff_sz, sw_only=True)
        strm = S.QzStream()
        out[name] = (comp, feed(S.qz_decompress_stream,
                                lz4_sess(qz, hw_buff_sz), S, strm, comp,
                                4096), state(strm))
    assert out["port"] == out["ref"]
    assert out["port"][1] == data


def test_lz4_block_decompress_prefix_history():
    """Linked blocks: match offsets reach into the prior block's output."""
    prefix = b"ABCDEFGHIJKLMNOP"
    blk = bytes([0x04]) + (16).to_bytes(2, "little") + bytes([0x40]) + b"tail"
    out = lz4_block.lz4_block_decompress(blk, 1 << 20, prefix=prefix)
    assert out == b"ABCDEFGH" + b"tail"


def test_decompress_stream_lz4_linked_blocks_equal_reference(port):
    """A hand-built frame with FLG block-indep=0 whose second block copies
    bytes of the first: the history carry of the walk."""
    part1 = b"0123456789ABCDEF" * 2
    blk2 = bytes([0x08]) + struct.pack("<H", 32) + bytes([0x20]) + b"XY"
    expect = part1 + part1[:12] + b"XY"
    flg = (1 << 6) | (1 << 2)
    body = bytes([flg, 4 << 4])
    hc = (xxhash.xxh32_intdigest(body, 0) >> 8) & 0xFF
    frame = (struct.pack("<I", 0x184D2204) + body + bytes([hc])
             + struct.pack("<I", 0x80000000 | len(part1)) + part1
             + struct.pack("<I", len(blk2)) + blk2 + struct.pack("<I", 0)
             + struct.pack("<I", xxhash.xxh32_intdigest(expect, 0)))
    out = {}
    for name, (qz, S) in PKGS.items():
        strm = S.QzStream()
        out[name] = (S.qz_decompress_stream(lz4_sess(qz), strm, frame,
                                            last=1), state(strm))
    assert out["port"] == out["ref"]
    assert out["port"][0] == (C.QZ_OK, expect)
