"""The reference's API suite (tests/test_api.py) against the port.

Round trips across the format matrix at sizes 0-200000, interop with the
system gzip/zlib, status codes, accounting, the empty-input and bound
contracts and partial output at member boundaries.  Every case runs in
both packages on the same input: the port's compressed bytes, codes,
totals and output equal the reference's.  The port's engine runs on
``torch.device("cpu")``; the routing is the reference's (the software
route without a calibration record), and the device-forced case checks
that the port took the device route.
"""
import gzip as pygzip
import zlib

import pytest
import torch

import qatzip_tpu
import qatzip_tpu_torch as qt
from qatzip_tpu import constants as C
from qatzip_tpu.constants import QzDataFormat
from tests.torch_conformance import (  # noqa: F401 (fixtures)
    both, engine_on, port_engine, route, same)

torch.set_num_threads(1)

CPU = torch.device("cpu")
ALL_DEFLATE_FMTS = [QzDataFormat.QZ_DEFLATE_4B, QzDataFormat.QZ_DEFLATE_GZIP,
                    QzDataFormat.QZ_DEFLATE_GZIP_EXT,
                    QzDataFormat.QZ_DEFLATE_RAW]
GZ_EXT = QzDataFormat.QZ_DEFLATE_GZIP_EXT


@pytest.fixture(autouse=True)
def _engine(engine_on):
    engine_on(CPU)


def _round_trip(data, algorithm, **kw):
    """Compress in both packages (equal bytes), then decompress in the
    port; returns the stream."""
    ref, port = both(lambda qz: qz.compress(data, algorithm, **kw))
    assert port == ref
    kw.pop("level", None)
    assert qt.decompress(port, algorithm, **kw) == data
    return port


@pytest.mark.parametrize("fmt", ALL_DEFLATE_FMTS)
@pytest.mark.parametrize("size", [0, 1, 100, 4096, 65536, 200_000])
def test_deflate_roundtrip_formats(corpus_factory, fmt, size):
    _round_trip(corpus_factory(size), "deflate", fmt=fmt)


@pytest.mark.parametrize("size", [0, 1, 1000, 65536, 150_000])
def test_lz4_roundtrip(corpus_factory, size):
    _round_trip(corpus_factory(size), "lz4")


@pytest.mark.parametrize("mini_match", [3, 4])
def test_lz4s_roundtrip(corpus_factory, mini_match):
    data = corpus_factory(100_000)

    def run(qz):
        p = qz.QzSessionParamsLZ4S(lz4s_mini_match=mini_match)
        sess, sess2 = qz.QzSession(), qz.QzSession()
        assert qz.qz_setup_session_lz4s(sess, p) == C.QZ_OK
        assert qz.qz_setup_session_lz4s(sess2, p) == C.QZ_OK
        res = qz.qz_compress(sess, data)
        back = qz.qz_decompress(sess2, res.data)
        assert res.rc == back.rc == C.QZ_OK and back.data == data
        return res, back

    (r1, r2), (p1, p2) = both(run)
    same(r1, p1)
    same(r2, p2)


def test_zlib_roundtrip(corpus_factory):
    data = corpus_factory(100_000)
    _round_trip(data, "zlib")
    small = data[:30_000]
    assert zlib.decompress(_round_trip(small, "zlib")) == small


def test_gzip_interop_with_system_gzip(corpus_factory):
    data = corpus_factory(200_000)
    comp = _round_trip(data, "deflate", fmt=QzDataFormat.QZ_DEFLATE_GZIP)
    assert pygzip.decompress(comp) == data
    foreign = pygzip.compress(data)
    assert both(lambda qz: qz.decompress(
        foreign, "deflate", fmt=QzDataFormat.QZ_DEFLATE_GZIP)) == (data, data)


def test_gzipext_interop_with_system_gzip(corpus_factory):
    data = corpus_factory(200_000)
    assert pygzip.decompress(_round_trip(data, "deflate", fmt=GZ_EXT)) == data


def test_empty_input_compressed_size():
    comp = _round_trip(b"", "deflate", fmt=GZ_EXT)
    assert len(comp) == C.QZ_COMPRESSED_SZ_OF_EMPTY_FILE


def test_max_compressed_length_bound(corpus_factory):
    for size in (1, 1000, 65536, 300_000):
        data = corpus_factory(size, "random")
        bound = qt.qz_max_compressed_length(size)
        assert bound == qatzip_tpu.qz_max_compressed_length(size)
        comp = _round_trip(data, "deflate", fmt=GZ_EXT)
        assert len(comp) <= bound
    assert qt.qz_max_compressed_length(0) == C.QZ_COMPRESSED_SZ_OF_EMPTY_FILE


def test_compression_size_not_worse_than_reference_sw(corpus_factory):
    data = corpus_factory(256 * 1024)
    ref, port = both(lambda qz: qz.compress(data, "deflate", fmt=GZ_EXT,
                                            level=1, sw_only=True))
    assert port == ref
    co = zlib.compressobj(1, zlib.DEFLATED, -15)
    ref_payload = len(co.compress(data) + co.flush())
    chunks = (len(data) + 65535) // 65536
    assert len(port) <= ref_payload + chunks * 32 + 1024


def test_device_path_ratio_tracking(port_engine, corpus_factory):
    """The device route's size stays within zlib L1 with a flush a chunk
    (the reference's contract), at 16 KB chunks (the reference: its default
    64 KB; the plain inflate on the CPU costs ~1 ms a step)."""
    data = corpus_factory(256 * 1024)
    hw = 16384
    with route(device=True):
        comp = _round_trip(data, "deflate", fmt=GZ_EXT, level=1,
                           hw_buff_sz=hw)
    chunks = (len(data) + hw - 1) // hw
    ref_payload = 0
    for i in range(0, len(data), hw):
        co = zlib.compressobj(1, zlib.DEFLATED, -15)
        ref_payload += len(co.compress(data[i:i + hw]) + co.flush())
    assert len(comp) <= ref_payload + chunks * 32 + 64


def test_default_routing_protected_without_calibration(corpus_factory,
                                                       monkeypatch):
    """No calibration record and no QATZIP_TPU_DEVICE: the software route,
    in both packages, even with a device engine up."""
    monkeypatch.delenv("QATZIP_TPU_DEVICE", raising=False)
    data = corpus_factory(128 * 1024)
    hw0 = qatzip_tpu.engine.core._engine.hw_requests
    with route(device=False):
        _round_trip(data, "deflate", fmt=GZ_EXT)
    assert qatzip_tpu.engine.core._engine.hw_requests == hw0


def _deflate_sess(qz):
    sess = qz.QzSession()
    assert qz.qz_setup_session_deflate(sess) == C.QZ_OK
    return sess


def test_session_crc_reporting(corpus_factory):
    data = corpus_factory(150_000)

    def run(qz):
        res = qz.qz_compress_crc(_deflate_sess(qz), data)
        back = qz.qz_decompress_crc(_deflate_sess(qz), res.data)
        assert res.rc == back.rc == C.QZ_OK
        assert res.crc == back.crc == zlib.crc32(data) & 0xFFFFFFFF
        return res, back

    (r1, r2), (p1, p2) = both(run)
    same(r1, p1)
    same(r2, p2)


def test_total_in_out_accounting(corpus_factory):
    data = corpus_factory(100_000)

    def run(qz):
        sess = _deflate_sess(qz)
        res = qz.qz_compress(sess, data)
        assert (sess.total_in, sess.total_out) == (len(data), len(res.data))
        dsess = _deflate_sess(qz)
        assert qz.qz_decompress(dsess, res.data).rc == C.QZ_OK
        return res, (sess.total_in, sess.total_out, dsess.total_in,
                     dsess.total_out)

    (r, ref_tot), (p, port_tot) = both(run)
    same(r, p)
    assert port_tot == ref_tot


def test_invalid_params_rejected():
    def run(qz):
        sess = qz.QzSession()
        out = []
        p = qz.QzSessionParamsDeflate()
        p.common_params.hw_buff_sz = 3000
        out.append(qz.qz_setup_session_deflate(sess, p))
        p = qz.QzSessionParamsDeflate()
        p.common_params.comp_lvl = 42
        out.append(qz.qz_setup_session_deflate(sess, p))
        p = qz.QzSessionParamsLZ4S()
        p.lz4s_mini_match = 7
        out.append(qz.qz_setup_session_lz4s(sess, p))
        return out

    assert both(run) == ([C.QZ_PARAMS] * 3, [C.QZ_PARAMS] * 3)


def test_corrupted_gzip_data_error(corpus_factory):
    data = corpus_factory(50_000)
    comp = bytearray(_round_trip(data, "deflate", fmt=GZ_EXT))
    comp[40] ^= 0xFF
    ref, port = both(lambda qz: qz.qz_decompress(_deflate_sess(qz),
                                                 bytes(comp)))
    assert same(ref, port).rc == C.QZ_DATA_ERROR


def test_unknown_gzip_header_data_error():
    ref, port = both(lambda qz: qz.qz_decompress(_deflate_sess(qz),
                                                 b"\x00\x01\x02\x03" * 10))
    assert same(ref, port).rc == C.QZ_DATA_ERROR


def test_buf_error_when_dest_too_small(corpus_factory):
    data = corpus_factory(100_000)
    ref, port = both(lambda qz: qz.qz_compress(_deflate_sess(qz), data,
                                               dest_limit=10))
    assert same(ref, port).rc == C.QZ_BUF_ERROR


def test_partial_output_at_member_boundary(corpus_factory):
    data = corpus_factory(256 * 1024, "random")

    def run(qz):
        full = qz.qz_compress(_deflate_sess(qz), data)
        return qz.qz_compress(_deflate_sess(qz), data,
                              dest_limit=len(full.data) // 2)

    ref, port = both(run)
    res = same(ref, port)
    assert res.rc == C.QZ_OK
    assert 0 < res.consumed < len(data)
    assert res.consumed % (64 * 1024) == 0
    assert qt.decompress(res.data, "deflate") == data[:res.consumed]


def test_mixed_gzip_and_gzipext_members(corpus_factory):
    a = corpus_factory(70_000)
    b = corpus_factory(30_000, "iterative")
    mixed = (_round_trip(a, "deflate", fmt=GZ_EXT)
             + _round_trip(b, "deflate", fmt=QzDataFormat.QZ_DEFLATE_GZIP))
    assert both(lambda qz: qz.decompress(
        mixed, "deflate", fmt=QzDataFormat.QZ_DEFLATE_GZIP)) == (a + b, a + b)


def test_status_reporting():
    ref, port = both(lambda qz: qz.qz_get_status())
    assert port.algo_sw == ref.algo_sw and port.algo_sw["deflate"]
    assert isinstance(port.qat_hw_count, int)


def test_levels_sweep(corpus_factory):
    data = corpus_factory(120_000)
    sizes = {}
    for lvl in range(1, 10):
        comp = _round_trip(data, "deflate",
                           fmt=QzDataFormat.QZ_DEFLATE_GZIP, level=lvl)
        sizes[lvl] = len(comp)
    assert sizes[9] <= sizes[1]
