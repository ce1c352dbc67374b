"""The reference's boundary sweep (tests/test_sweep.py) against the port.

Every length of the reference's ranges, three corpora, compress,
decompress and compare, in both packages: the port's compressed bytes and
its output equal the reference's.  The device-forced sweep starts the
port's engine on ``torch.device("cpu")`` and checks the route each
request took: the device's for every decompress and for every compress of
at least the sessions' 1 KB input threshold (below it both packages
compress on the software route, so a second case sends the same lengths
straight into the device codec).
"""
import gzip
import random

import numpy as np
import pytest
import torch

import qatzip_tpu
import qatzip_tpu_torch as qt
from qatzip_tpu.constants import QzDataFormat
from qatzip_tpu.native import qzcore as ref_native
from qatzip_tpu_torch.native import qzcore as native
# the module pytest loaded as conftest (importing it as tests.conftest would
# run it again, after a jax backend exists)
from conftest import make_corpus
from tests.torch_conformance import (  # noqa: F401 (fixtures)
    both, engine_on, port_engine, route)

torch.set_num_threads(1)

CPU = torch.device("cpu")


@pytest.mark.parametrize("kind", ["iterative", "random", "constant"])
@pytest.mark.parametrize("fmt", [QzDataFormat.QZ_DEFLATE_GZIP_EXT,
                                 QzDataFormat.QZ_DEFLATE_4B])
def test_boundary_sweep_deflate(engine_on, kind, fmt):
    engine_on(CPU)
    r = random.Random(1234)
    lengths = list(range(0, 132)) + list(range(1000, 70000, 7321))
    with route(device=False):
        for n in lengths:
            data = make_corpus(r, n, kind)
            ref, port = both(lambda qz: qz.compress(data, "deflate", fmt=fmt,
                                                    hw_buff_sz=4096))
            assert port == ref, (kind, n)
            assert qt.decompress(port, "deflate", fmt=fmt,
                                 hw_buff_sz=4096) == data, (kind, n)


@pytest.mark.parametrize("kind", ["iterative", "random", "constant"])
def test_boundary_sweep_lz4(engine_on, kind):
    engine_on(CPU)
    r = random.Random(99)
    lengths = list(range(0, 100, 7)) + list(range(500, 40000, 4999))
    with route(device=False):
        for n in lengths:
            data = make_corpus(r, n, kind)
            ref, port = both(lambda qz: qz.compress(data, "lz4",
                                                    hw_buff_sz=16384))
            assert port == ref, (kind, n)
            assert qt.decompress(port, "lz4", hw_buff_sz=16384) == data


def test_device_forced_boundary_sweep(port_engine, corpus_factory):
    """Lengths 0-13, 255/256, 4095-4097, 8191 and 12288 through the API with
    the device route forced: the reference's bytes, exact round trips,
    gzip-interoperable."""
    lengths = [0, 1, 2, 3, 4, 5, 11, 12, 13, 255, 256, 4095, 4096, 4097,
               8191, 12288]
    for kind in ("text", "random", "constant"):
        for n in lengths:
            data = corpus_factory(n, kind)
            # a request below the session's input_sz_thrshold (1 KB)
            # compresses on the software route in both packages
            with route(device=n >= 1024):
                ref, port = both(lambda qz: qz.compress(
                    data, "deflate", fmt=QzDataFormat.QZ_DEFLATE_GZIP,
                    level=1, hw_buff_sz=4096))
            assert port == ref, (kind, n)
            with route(device=True):
                assert qt.decompress(port, "deflate",
                                     hw_buff_sz=4096) == data, (kind, n)
            if n:
                assert gzip.decompress(port) == data, (kind, n)


@pytest.mark.parametrize("kind", ["text", "random", "constant"])
def test_device_codec_boundary_lengths(corpus_factory, kind):
    """The same lengths straight into the device codec, below the API's
    threshold too (one chunk each, an empty request as one empty chunk, the
    last a 12288-byte request in 4 KB chunks): the match finder and select's plain versions on rows shorter
    than the 3-gram and on chunk tails give the reference codec's bytes."""
    from qatzip_tpu.ops import device_codecs as ref_dc
    from qatzip_tpu_torch.ops import device_codecs as dc

    params = []
    for qz in (qatzip_tpu, qt):
        sess = qz.QzSession()
        p = qz.QzSessionParamsDeflate()
        p.common_params.comp_lvl = 1
        p.common_params.hw_buff_sz = 4096
        assert qz.qz_setup_session_deflate(sess, p) == 0
        params.append(sess.params)
    for n in [0, 1, 2, 3, 4, 5, 11, 12, 13, 255, 256, 4095, 4096, 12288]:
        data = corpus_factory(n, kind)
        chunks = [data[i:i + 4096] for i in range(0, n, 4096)] or [b""]
        ref = ref_dc.DeflateDeviceCodec().compress_chunks(chunks, params[0])
        port = dc.DeflateDeviceCodec().compress_chunks(chunks, params[1],
                                                       CPU)
        assert [(c.payload, c.checksum, c.consumed) for c in port] == \
            [(c.payload, c.checksum, c.consumed) for c in ref], (kind, n)


def test_native_deflate_64k_bitpack_sweep():
    """64 KB chunks across data classes at L1/L2 through the port's native
    codec: the reference's bytes, read by zlib."""
    import zlib

    rng = np.random.default_rng(20260821)
    words = [rng.integers(97, 123, rng.integers(2, 12), dtype=np.uint8)
             for _ in range(512)]
    for rep in range(12):
        kind = rep % 3
        if kind == 0:
            idx = (rng.random(20000) ** 3 * len(words)).astype(int)
            parts = []
            for i in idx:
                parts.append(words[i])
                parts.append(np.array([32], np.uint8))
            data = np.concatenate(parts)[:65536].tobytes()
        elif kind == 1:
            raw = rng.integers(0, 256, 65536, dtype=np.int64)
            data = ((raw * raw) // 256 % 256).astype(np.uint8).tobytes()
        else:
            rows = [f"{i},{(i * 31) % 1013},item-{i % 50:04d}\n".encode()
                    for i in range(4000)]
            data = (b"".join(rows) * 3)[:65536]
        for lvl in (1, 2):
            payload = native.deflate_compress(data, lvl)
            assert payload == ref_native.deflate_compress(data, lvl)
            assert zlib.decompress(payload, -15) == data, (rep, kind, lvl)
