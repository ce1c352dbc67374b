"""The reference's device-decode suite (tests/test_device_decode.py) against
the port.

``deflate_decode.inflate_batch`` of the port, on ``torch.device("cpu")``
(the lockstep inflate's plain version), against the reference's
``inflate_batch`` on the same payloads: the same lanes fail over to the CPU
(``failover_lanes`` counts them) and every other lane's bytes, end flag and
checksum are equal, and equal zlib's.  The API cases run with the device
route forced in both packages and check that the port took it.
"""
import gzip
import zlib

import numpy as np
import pytest
import torch

import qatzip_tpu
import qatzip_tpu_torch as qt
from qatzip_tpu.constants import QzDataFormat
from qatzip_tpu.ops import deflate_decode as ref_dd
from qatzip_tpu_torch.ops import deflate_decode as dd
from tests.torch_conformance import (  # noqa: F401 (fixtures)
    both, engine_on, port_engine, route)

torch.set_num_threads(1)

CPU = torch.device("cpu")


def _raw(data: bytes, level: int = 6) -> bytes:
    co = zlib.compressobj(level, zlib.DEFLATED, -15)
    return co.compress(data) + co.flush()


def _inflate(payloads, hints, kind=None):
    """The port's inflate_batch held to the reference's on the same
    payloads; returns the port's results."""
    lanes0 = dd.failover_lanes
    port = dd.inflate_batch(payloads, hints, CPU, kind=kind)
    ref = ref_dd.inflate_batch(payloads, hints, kind=kind)
    assert [r is None for r in port] == [r is None for r in ref]
    assert port == ref
    assert dd.failover_lanes - lanes0 == port.count(None)
    return port


@pytest.mark.parametrize("kind", ["text", "random", "constant", "iterative"])
@pytest.mark.parametrize("size", [1, 1000, 65536])
def test_inflate_batch_bit_exact(corpus_factory, kind, size):
    data = corpus_factory(size, kind)
    for level in (1, 9):
        res = _inflate([_raw(data, level)], [len(data)], kind="crc32")
        assert res[0] is not None, "kernel flagged a valid stream"
        assert res[0][:2] == (data, True)
        assert res[0][2] == zlib.crc32(data) & 0xFFFFFFFF


def test_inflate_stored_blocks(corpus_factory):
    data = corpus_factory(3000, "random")
    res = _inflate([_raw(data, 0)], [len(data)])
    assert res[0] is not None and res[0][0] == data


def test_inflate_multi_block_with_history(corpus_factory):
    """Full-flush block boundaries; back-references cross them through the
    32 KB window carried between rounds."""
    data = corpus_factory(50000, "text")
    co = zlib.compressobj(6, zlib.DEFLATED, -15)
    payload = (co.compress(data[:20000]) + co.flush(zlib.Z_FULL_FLUSH)
               + co.compress(data[20000:]) + co.flush())
    res = _inflate([payload], [len(data)])
    assert res[0] is not None and res[0][0] == data


def test_inflate_empty_stream():
    res = _inflate([_raw(b"")], [0], kind="adler32")
    assert res[0] == (b"", True, 1)


def test_inflate_mixed_batch(corpus_factory):
    datas = [corpus_factory(s, k) for s, k in
             [(100, "text"), (65536, "constant"), (5000, "random"),
              (1, "text")]]
    res = _inflate([_raw(d, 1) for d in datas], [len(d) for d in datas])
    for d, r in zip(datas, res):
        assert r is not None and r[0] == d


def test_inflate_corrupt_stream_flags_error(corpus_factory):
    """A corrupted stream comes back as None (the CPU-fallback signal) in
    both packages, or, where it still decodes, with zlib's bytes."""
    data = corpus_factory(20000, "text")
    payload = bytearray(_raw(data, 6))
    payload[len(payload) // 2] ^= 0xFF
    res = _inflate([bytes(payload)], [len(data)])
    if res[0] is not None:
        try:
            want = zlib.decompressobj(-15).decompress(bytes(payload))
        except zlib.error:
            pytest.fail("kernel accepted a stream zlib rejects")
        assert res[0][0] == want


def test_public_api_device_decompress(port_engine, corpus_factory):
    """CPU-compressed gzip-ext members decoded on the device route (16 KB
    chunks: the reference's default 64 KB costs the plain inflate four
    times the steps a lane)."""
    data = corpus_factory(200_000, "text")
    comp = qatzip_tpu.compress(data, "deflate", fmt=QzDataFormat.
                               QZ_DEFLATE_GZIP_EXT, level=1, sw_only=True,
                               hw_buff_sz=16384)
    with route(device=True):
        out = both(lambda qz: qz.decompress(comp, "deflate",
                                            hw_buff_sz=16384))
    assert out == (data, data)


def test_device_encode_device_decode_roundtrip(port_engine, corpus_factory):
    """Device-route compress read back on the device route; the stream
    equals the reference's and gzip reads it."""
    data = corpus_factory(150_000, "text")
    with route(device=True):
        ref, port = both(lambda qz: qz.compress(
            data, "deflate", fmt=QzDataFormat.QZ_DEFLATE_GZIP_EXT, level=1,
            hw_buff_sz=16384))
        assert port == ref
        assert qt.decompress(port, "deflate", hw_buff_sz=16384) == data
    assert gzip.decompress(port) == data


def test_inflate_large_literal_stream_rejected_not_corrupted():
    """A ~512 KB literal-heavy stream is beyond a lane's stream budget: both
    packages hand it back for the CPU path."""
    rng = np.random.default_rng(7)
    data = rng.integers(0, 256, size=512 * 1024, dtype=np.uint8).tobytes()
    res = _inflate([_raw(data, 1)], [len(data)])
    assert res[0] is None or res[0][0] == data


def test_inflate_batch_over_eight_streams(corpus_factory):
    datas = [corpus_factory(2000 + 97 * i, "text") for i in range(11)]
    res = _inflate([_raw(d, 6) for d in datas], [len(d) for d in datas])
    for d, r in zip(datas, res):
        assert r is not None and r[0] == d
