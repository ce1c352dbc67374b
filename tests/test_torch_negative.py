"""The reference's negative-path matrix (tests/test_negative.py) against the
port.

Corrupt headers, blocks and footers, truncation, destination buffers too
small both ways, the sticky software latch on an oversized chunk, SW-L9
compress read on the device route and invalid session parameters: each
case runs in both packages on the same input, and the port's code and
output equal the reference's.  The device-route cases start the port's
engine on ``torch.device("cpu")`` and check that the port took that route.
"""
import pytest
import torch

from qatzip_tpu import constants as C
from qatzip_tpu.constants import QzDataFormat
from tests.torch_conformance import (  # noqa: F401 (fixtures)
    both, engine_on, port_engine, route, same)

torch.set_num_threads(1)

CPU = torch.device("cpu")
GZIP = QzDataFormat.QZ_DEFLATE_GZIP
GZ_EXT = QzDataFormat.QZ_DEFLATE_GZIP_EXT


@pytest.fixture(autouse=True)
def _engine(engine_on):
    """The port's engine on the CPU device (the route stays the software
    one unless a case forces the device's)."""
    engine_on(CPU)


def _deflate_sess(qz, fmt=GZIP, hw_buff_sz=64 * 1024, level=1):
    sess = qz.QzSession()
    p = qz.QzSessionParamsDeflate()
    p.common_params.comp_lvl = level
    p.common_params.hw_buff_sz = hw_buff_sz
    p.data_fmt = fmt
    assert qz.qz_setup_session_deflate(sess, p) == C.QZ_OK
    return sess


def _compressed(data, fmt=GZIP, **kw):
    """The stream in both packages: equal bytes."""
    ref, port = both(lambda qz: qz.qz_compress(_deflate_sess(qz, fmt, **kw),
                                               data))
    same(ref, port)
    assert port.rc == C.QZ_OK
    return port.data


def _decompress(comp, fmt=GZIP, **kw):
    """Decompress in both packages; returns the port's result, equal to the
    reference's."""
    ref, port = both(lambda qz: qz.qz_decompress(
        _deflate_sess(qz, fmt), comp, **kw))
    return same(ref, port)


# ---------------------------------------------------------------------------
# Corrupt gzip header
# ---------------------------------------------------------------------------
def test_bad_gzip_magic(corpus_factory):
    comp = bytearray(_compressed(corpus_factory(65536, "random")))
    comp[0] = 0x00
    assert _decompress(bytes(comp)).rc == C.QZ_DATA_ERROR


def test_bad_gzip_method_byte(corpus_factory):
    comp = bytearray(_compressed(corpus_factory(4096, "text")))
    comp[2] = 0x07
    assert _decompress(bytes(comp)).rc == C.QZ_DATA_ERROR


def test_reserved_flg_bits_rejected(corpus_factory):
    comp = bytearray(_compressed(corpus_factory(4096, "text")))
    comp[3] |= 0xE0
    assert _decompress(bytes(comp)).rc == C.QZ_DATA_ERROR


# ---------------------------------------------------------------------------
# Corrupt deflate block data, software and device routes
# ---------------------------------------------------------------------------
def _corrupt_payload(comp: bytes) -> bytes:
    out = bytearray(comp)
    mid = len(out) // 2
    for i in range(mid, mid + 8):
        out[i] ^= 0xA5
    return bytes(out)


def test_corrupt_deflate_block_sw(corpus_factory):
    comp = _corrupt_payload(_compressed(corpus_factory(65536, "text")))
    assert _decompress(comp).rc == C.QZ_DATA_ERROR


def test_corrupt_deflate_block_device_path(port_engine, corpus_factory):
    """The corrupted lane still decodes, to 65533 bytes: the member's size
    and CRC checks refuse it with the reference's code, never wrong
    bytes."""
    comp = _corrupt_payload(_compressed(corpus_factory(65536, "text"),
                                        fmt=GZ_EXT))
    with route(device=True):
        res = _decompress(comp, fmt=GZ_EXT)
    assert res.rc == C.QZ_DATA_ERROR


def _refusable(algorithm: str, data: bytes) -> bytes:
    """``data`` compressed at 16 KB chunks with one chunk the device fails
    over and the host decoder refuses: a deflate member's first block
    turned to the reserved type 3, or an LZ4 block's tail zeroed."""
    import struct

    from qatzip_tpu_torch.formats import gzip_fmt, lz4_fmt

    if algorithm == "deflate":
        buf = bytearray(_compressed(data, fmt=GZ_EXT, hw_buff_sz=16 << 10))
        ext = gzip_fmt.parse_gzipext_header(buf, 0)
        second = gzip_fmt.GZIPEXT_HEADER_SIZE + ext.dest_sz + 8
        buf[second + gzip_fmt.GZIPEXT_HEADER_SIZE] |= 0x06
        return bytes(buf)
    import qatzip_tpu_torch as qt

    buf = bytearray(qt.compress(data, "lz4", hw_buff_sz=16 << 10,
                                sw_only=True))
    hlen, _ = lz4_fmt.parse_lz4_frame_header(buf, 0)
    (size,) = struct.unpack_from("<I", buf, hlen)
    assert not size & 0x80000000
    end = hlen + 4 + size
    buf[end - 16:end] = bytes(16)
    return bytes(buf)


@pytest.mark.parametrize("algorithm", ["deflate", "lz4"])
def test_refused_chunk_ends_the_request_without_a_rerun(
        port_engine, corpus_factory, algorithm):
    """A chunk the device fails over that the host decoder then refuses.
    The reference reruns the whole batch on the CPU, which refuses it
    again: QZ_DATA_ERROR with the software mask.  The port ends the request
    at that chunk with the same QZ_DATA_ERROR and output, and no CPU rerun:
    no mask, no software request, no health failure (a deliberate
    divergence, ROADMAP queue 3)."""
    from qatzip_tpu_torch.engine.health import health
    from qatzip_tpu_torch.ops import deflate_decode as dd
    from qatzip_tpu_torch.ops import lz4_decode as ld
    from tests.torch_conformance import refused

    comp = _refusable(algorithm, corpus_factory(65536, "text"))
    sw0, fails0 = port_engine.sw_requests, health.total_failures
    moved0 = dd.failover_lanes + ld.failover_blocks

    def run(qz):
        if algorithm == "deflate":
            return qz.qz_decompress(_deflate_sess(qz, GZ_EXT, 16 << 10),
                                    comp)
        sess = qz.QzSession()
        assert qz.qz_setup_session_lz4(sess, qz.QzSessionParamsLZ4()) == 0
        return qz.qz_decompress(sess, comp)

    ref, port = both(run)
    assert refused(ref, port)
    same(ref, port, refused_ok=True)
    assert dd.failover_lanes + ld.failover_blocks > moved0
    assert (port_engine.sw_requests, health.total_failures) == (sw0, fails0)


# ---------------------------------------------------------------------------
# Oversized chunk: sticky software decompress
# ---------------------------------------------------------------------------
def test_oversized_chunk_sticky_sw_decompress(corpus_factory):
    data = corpus_factory(128 * 1024, "text")
    comp = _compressed(data, fmt=GZ_EXT, hw_buff_sz=128 * 1024)
    small = _compressed(corpus_factory(1000, "text"), fmt=GZ_EXT)

    def run(qz):
        sess = _deflate_sess(qz, GZ_EXT, hw_buff_sz=64 * 1024)
        assert not sess.force_sw
        res = qz.qz_decompress(sess, comp)
        assert res.rc == C.QZ_OK and res.data == data
        assert sess.force_sw, "oversized chunk must latch the session"
        assert res.ext_rc & C.QZ_SW_EXECUTION_MASK
        res2 = qz.qz_decompress(sess, small)
        assert res2.rc == C.QZ_OK
        assert res2.ext_rc & C.QZ_SW_EXECUTION_MASK
        return res, res2

    (r1, r2), (p1, p2) = both(run)
    same(r1, p1)
    same(r2, p2)


# ---------------------------------------------------------------------------
# Destination buffer overflow
# ---------------------------------------------------------------------------
def test_compress_dest_buffer_too_small(corpus_factory):
    data = corpus_factory(65536, "random")
    ref, port = both(lambda qz: qz.qz_compress(_deflate_sess(qz), data,
                                               dest_limit=100))
    assert same(ref, port).rc == C.QZ_BUF_ERROR


def test_decompress_dest_buffer_too_small(corpus_factory):
    comp = _compressed(corpus_factory(65536, "text"))
    assert _decompress(comp, dest_limit=1000).rc == C.QZ_BUF_ERROR


# ---------------------------------------------------------------------------
# Checksum corruption per format
# ---------------------------------------------------------------------------
def test_wrong_gzip_footer_crc(corpus_factory):
    comp = bytearray(_compressed(corpus_factory(30000, "text")))
    comp[-8] ^= 0xFF
    assert _decompress(bytes(comp)).rc == C.QZ_DATA_ERROR


def test_wrong_gzip_footer_isize(corpus_factory):
    comp = bytearray(_compressed(corpus_factory(30000, "text")))
    comp[-1] ^= 0x55
    assert _decompress(bytes(comp)).rc == C.QZ_DATA_ERROR


def _zlib_sess(qz):
    sess = qz.QzSession()
    p = qz.QzSessionParamsDeflateExt()
    p.zlib_format = 1
    assert qz.qz_setup_session_deflate_ext(sess, p) == C.QZ_OK
    return sess


def test_wrong_zlib_adler(corpus_factory):
    data = corpus_factory(30000, "text")
    ref, port = both(lambda qz: qz.qz_compress(_zlib_sess(qz), data))
    same(ref, port)
    comp = bytearray(port.data)
    comp[-1] ^= 0xFF
    ref, port = both(lambda qz: qz.qz_decompress(_zlib_sess(qz),
                                                 bytes(comp)))
    assert same(ref, port).rc == C.QZ_DATA_ERROR


def _lz4_sess(qz):
    sess = qz.QzSession()
    assert qz.qz_setup_session_lz4(sess, qz.QzSessionParamsLZ4()) == C.QZ_OK
    return sess


def test_wrong_lz4_content_checksum(corpus_factory):
    data = corpus_factory(30000, "text")
    ref, port = both(lambda qz: qz.qz_compress(_lz4_sess(qz), data))
    same(ref, port)
    comp = bytearray(port.data)
    comp[-2] ^= 0xFF
    ref, port = both(lambda qz: qz.qz_decompress(_lz4_sess(qz), bytes(comp)))
    assert same(ref, port).rc == C.QZ_DATA_ERROR


# ---------------------------------------------------------------------------
# Truncation
# ---------------------------------------------------------------------------
def test_truncated_single_member(corpus_factory):
    comp = _compressed(corpus_factory(30000, "text"))
    assert _decompress(comp[: len(comp) - 4]).rc == C.QZ_DATA_ERROR


def test_truncated_second_member_partial_success(corpus_factory):
    d1 = corpus_factory(30000, "text")
    d2 = corpus_factory(30000, "random")
    m1 = _compressed(d1)
    m2 = _compressed(d2)
    res = _decompress(m1 + m2[: len(m2) - 6])
    assert res.rc == C.QZ_OK
    assert res.data == d1
    assert res.consumed == len(m1)


# ---------------------------------------------------------------------------
# SW-L9 compress, device-route decompress
# ---------------------------------------------------------------------------
def test_sw_l9_compress_device_decompress(port_engine, corpus_factory):
    data = corpus_factory(65536, "text")
    comp = _compressed(data, fmt=GZ_EXT, level=9)
    with route(device=True):
        res = _decompress(comp, fmt=GZ_EXT)
    assert res.rc == C.QZ_OK and res.data == data


# ---------------------------------------------------------------------------
# Invalid session parameters
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mutate", [
    lambda p: setattr(p.common_params, "comp_lvl", 0),
    lambda p: setattr(p.common_params, "comp_lvl", 13),
    lambda p: setattr(p.common_params, "hw_buff_sz", 999),
    lambda p: setattr(p.common_params, "hw_buff_sz", 1 << 30),
    lambda p: setattr(p.common_params, "direction", 42),
])
def test_invalid_session_params(mutate):
    def run(qz):
        sess = qz.QzSession()
        p = qz.QzSessionParamsDeflate()
        mutate(p)
        return qz.qz_setup_session_deflate(sess, p)

    assert both(run) == (C.QZ_PARAMS, C.QZ_PARAMS)
